// K8: stride-1 ResNet Bottleneck blocks (the emotion net's layer1/layer2
// tails), NHWC.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/
// bottleneck_pallas.py:218 (bottleneck_chain, its pallas_call at :259,
// used by emotion_apply_fused_l12). Function of one block, BatchNorm
// folded on the host (scales into the weights, shifts as f32 biases):
//   t1 = relu(x @ W1 + b1)            1x1, C -> P
//   t2 = relu(conv3x3(t1) @ W2 + b2)  3x3 pad 1, P -> P
//   y  = relu(t2 @ W3 + b3 + x)       1x1, P -> C, plus the residual
// The TPU kernel's masked sublane tap slices, ones-column biases and
// guard rows are Mosaic artefacts and are not carried over.
//
// Bound of the function on the H100: at K = 512 faces, layer1's two
// blocks (56x56, C = 256, P = 64) are ~447 GFLOP and layer2's three
// (28x28, C = 512, P = 128) ~671 GFLOP; in bf16 on the tensor cores
// (989 TFLOP/s) that is 0.45 and 0.68 ms, against x read and y written
// once per block (1.64 GB and 0.82 GB, 0.49 and 0.25 ms at 3.35 TB/s):
// 1.169 ms for both chains, layer1 bound by bytes, layer2 by operations.
//
// Design (bf16): unfused, three launches per block of one implicit-GEMM
// template, conv_gemm_bf16<BN, TAPS, RES>:
//   out[m, o] = relu(sum_{tap, k} A_tap[m, k] W[tap, o, k] + b[o]
//                    (+ res[m, o]))
// m runs over the flattened pixels (image, y, x); A_tap[m, :] is the
// input pixel shifted by the tap (dy - 1, dx - 1), zero outside the image.
//   conv1: x -> t1, 1 tap, K = C, N = P;
//   conv2: t1 -> t2, 9 taps, K = P, N = P;
//   conv3: t2 -> y, 1 tap, K = P, N = C, the residual x in the epilogue.
// t1 and t2 go through device memory in bf16 ([N, H, W, P] scratch from
// the wrapper). A thread block (8 warps) owns a 128 x BN output tile (BN
// = 64 where the output has 64 channels, else 128; warps 4 x 2 or 2 x 4,
// each a 32 x 32 or 64 x 32 tile of m16n8k16 products) and walks K in
// chunks of 32 channels of one tap (C and P are multiples of 32, so every
// row of A has one source address per chunk) through a 4-stage cp.async
// ring of 16-byte copies: A rows of shifted pixels (zero-filled with
// src-size 0 off the image and past the ragged M edge, never reading
// outside the tensor) and B rows of the weights, packed on the host as
// [tap][N][K] with K contiguous (ops/bottleneck.pack_gemm_weights), so
// that both load by ldmatrix.x4 from rows of an 80-byte pitch (eight rows
// in distinct bank groups). mma.sync.m16n8k16 bf16 with f32 sums; the
// epilogue stays in registers: f32 bias, the residual read as bf16x2,
// ReLU, then 4-byte bf16x2 stores, masked at the M edge.
//
// The unfused design's own floor (K = 512 faces; bytes at 3.35 TB/s,
// operations at the 989 TFLOP/s peak; per block):
//   layer1 (M = 1,605,632): conv1 1.03 GB / 52.6 GFLOP -> 0.31 ms (bytes)
//                           conv2 0.41 GB / 118.4 GFLOP -> 0.12 ms (both)
//                           conv3 1.85 GB / 52.6 GFLOP -> 0.55 ms (bytes)
//   layer2 (M = 401,408):   conv1 0.51 GB / 52.6 GFLOP -> 0.15 ms (bytes)
//                           conv2 0.21 GB / 118.4 GFLOP -> 0.12 ms (ops)
//                           conv3 0.92 GB / 52.6 GFLOP -> 0.28 ms (bytes)
// ~3.3 GB a layer1 block and ~1.6 GB a layer2 block: 3.6 ms for both
// chains at the peaks, ~5 ms at the ~350 TFLOP/s an mma.sync GEMM reaches,
// against the 1.169 ms bound of the fused function: t1 and t2 are written
// and read again, and conv3 re-reads x for the residual. The chain is
// unfused for now because two fused designs (one launch per block, conv1
// recomputed over a one-row halo into a padded shared-memory t1, three
// warp decompositions) lost to cuDNN on this card; fusing conv1 into
// conv2, or conv2 into conv3, on this GEMM is the next step.
//
// f32 (the card-vs-CPU check): three plain CUDA-core launches per block
// (conv1, conv2, conv3 + residual), with t1 and t2 in device memory and
// the weights as fold_block gives them ([tap][in][out]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "launch.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- bf16: one implicit-GEMM template, one launch per convolution ---------

constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 128;        // output pixels per tile
constexpr int kBK = 32;         // channels per K chunk (one tap)
constexpr int kLds = kBK + 8;   // shared row pitch: 80 bytes
constexpr int kStages = 4;      // cp.async ring depth

template <int BN>
struct Tile {
  static constexpr int WM = BN == 128 ? 2 : 4;  // warps along M
  static constexpr int WN = 8 / WM;             // warps along N
  static constexpr int TM = kBM / WM;           // a warp's rows
  static constexpr int TN = BN / WN;            // a warp's columns
  static constexpr int MF = TM / 16, NF = TN / 8;
  static constexpr int kStageA = kBM * kLds;    // elements
  static constexpr int kStageB = BN * kLds;
  static constexpr int kSmem = kStages * (kStageA + kStageB) * 2;  // bytes
  static_assert(WM * WN == 8 && NF % 2 == 0 && BN % 64 == 0, "tiles");
};

template <int BN, int TAPS, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_bf16(const bf16* __restrict__ a,      // [M, K] pixels
               const bf16* __restrict__ wt,     // [TAPS][N][K]
               const float* __restrict__ bias,  // [N]
               const bf16* __restrict__ res,    // [M, N] (RES)
               bf16* __restrict__ out,          // [M, N]
               long long m_total, int k, int n, int h, int w) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);
  bf16* sb = sa + kStages * T::kStageA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = n / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;

  // this thread's copies: 16-byte segment ``seg`` of A rows row0 and
  // row0 + 64 and of B rows row0 (+ 64)
  const int seg = tid % 4, row0 = tid / 4;
  long long am[2];
  int ay[2], ax[2];
  bool aok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    am[i] = m0 + row0 + 64 * i;
    aok[i] = am[i] < m_total;
    ax[i] = (int)(am[i] % w);
    ay[i] = (int)((am[i] / w) % h);
  }
  const int kpt = k / kBK;  // chunks per tap
  const int chunks = TAPS * kpt;

  auto load = [&](int c, int stage) {
    const int tap = c / kpt;
    const int k0 = (c - tap * kpt) * kBK + seg * 8;
    const int dy = TAPS == 9 ? tap / 3 - 1 : 0;
    const int dx = TAPS == 9 ? tap % 3 - 1 : 0;
    bf16* da = sa + stage * T::kStageA + row0 * kLds + seg * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool ok = aok[i];
      if (TAPS > 1)
        ok = ok && (unsigned)(ay[i] + dy) < (unsigned)h &&
             (unsigned)(ax[i] + dx) < (unsigned)w;
      const bf16* src =
          ok ? a + (size_t)(am[i] + (long long)dy * w + dx) * k + k0 : a;
      cp_async16_zfill(da + i * 64 * kLds, src, ok);
    }
    bf16* db = sb + stage * T::kStageB + row0 * kLds + seg * 8;
#pragma unroll
    for (int i = 0; i < BN / 64; ++i)
      cp_async16(db + i * 64 * kLds,
                 wt + ((size_t)tap * n + n0 + row0 + 64 * i) * k + k0);
  };

  float acc[T::MF][T::NF][4];
#pragma unroll
  for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < T::NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  const int wm = warp / T::WN, wn = warp % T::WN;
  // this lane's ldmatrix rows (see mma.cuh)
  const int a_row = wm * T::TM + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_row = wn * T::TN + 8 * (lane >> 4) + (lane & 7);
  const bf16* a_lane = sa + a_row * kLds + 8 * (lane >> 4);
  const bf16* b_lane = sb + b_row * kLds + 8 * ((lane >> 3) & 1);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();               // and every warp is done with c - 1
    const int next = c + kStages - 1;
    if (next < chunks) load(next, next % kStages);
    cp_async_commit();
    const int stage = c % kStages;
    const bf16* as = a_lane + stage * T::kStageA;
    const bf16* bs = b_lane + stage * T::kStageB;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned af[T::MF][4], bfr[T::NF / 2][4];
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf)
        ldsm_x4(af[mf], as + mf * 16 * kLds + ks);
#pragma unroll
      for (int j = 0; j < T::NF / 2; ++j)
        ldsm_x4(bfr[j], bs + j * 16 * kLds + ks);
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < T::NF; ++nf)
          mma_bf16(acc[mf][nf], af[mf], bfr[nf / 2][(nf & 1) * 2],
                   bfr[nf / 2][(nf & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue in registers: bias, residual, ReLU, bf16x2 stores
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int nf = 0; nf < T::NF; ++nf) {
    const int col = n0 + wn * T::TN + nf * 8 + 2 * tq;
    const float bias0 = __ldg(bias + col), bias1 = __ldg(bias + col + 1);
#pragma unroll
    for (int mf = 0; mf < T::MF; ++mf)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long m = m0 + wm * T::TM + mf * 16 + gq + 8 * hh;
        if (m >= m_total) continue;
        float v0 = acc[mf][nf][2 * hh] + bias0;
        float v1 = acc[mf][nf][2 * hh + 1] + bias1;
        const size_t at = (size_t)m * n + col;
        if (RES) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(res + at);
          v0 += __low2float(r);
          v1 += __high2float(r);
        }
        *reinterpret_cast<unsigned*>(out + at) =
            pack2f(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
  }
}

template <int BN, int TAPS, bool RES>
int launch_conv(const bf16* a, const bf16* wt, const float* bias,
                const bf16* res, bf16* out, long long m, int k, int n, int h,
                int w, cudaStream_t stream) {
  auto kern = conv_gemm_bf16<BN, TAPS, RES>;
  constexpr int smem = Tile<BN>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (m + kBM - 1) / kBM * (n / BN);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)tiles, kThreads, smem, stream>>>(a, wt, bias, res, out,
                                                    m, k, n, h, w);
  return (int)cudaGetLastError();
}

// conv1, conv2, conv3 of one block; counts each launch in *launches
int run_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
             const float* b2, const bf16* w3, const float* b3, bf16* y,
             bf16* t1, bf16* t2, int n, int h, int w, int c, int p,
             cudaStream_t st, int* launches) {
  if (p % 64 != 0 || c % 128 != 0) return (int)cudaErrorInvalidValue;
  const long long m = (long long)n * h * w;
  const bool wide = p % 128 == 0;
  int e = wide ? launch_conv<128, 1, false>(x, w1, b1, nullptr, t1, m, c, p,
                                            h, w, st)
               : launch_conv<64, 1, false>(x, w1, b1, nullptr, t1, m, c, p,
                                           h, w, st);
  if (e != 0) return e;
  ++*launches;
  e = wide ? launch_conv<128, 9, false>(t1, w2, b2, nullptr, t2, m, p, p, h,
                                        w, st)
           : launch_conv<64, 9, false>(t1, w2, b2, nullptr, t2, m, p, p, h,
                                       w, st);
  if (e != 0) return e;
  ++*launches;
  e = launch_conv<128, 1, true>(t2, w3, b3, x, y, m, p, c, h, w, st);
  if (e == 0) ++*launches;
  return e;
}

// ---- f32: plain CUDA-core launches ----------------------------------------

// y[m, o] = relu(sum_k x[m, k] w[k, o] + b[o] (+ res[m, o]))
__global__ void pointwise_f32(const float* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ b,
                              const float* __restrict__ res,
                              float* __restrict__ y, long long m, int k,
                              int nout) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * nout) return;
  const long long row = i / nout;
  const int o = (int)(i % nout);
  float acc = b[o];
  const float* xr = x + row * k;
  for (int c = 0; c < k; ++c) acc += xr[c] * w[(size_t)c * nout + o];
  if (res) acc += res[i];
  y[i] = fmaxf(acc, 0.f);
}

// y = relu(conv3x3 pad 1 (x) + b), x/y [N, H, W, P], w [9][P][P]
__global__ void conv3x3_f32(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const float* __restrict__ b,
                            float* __restrict__ y, int n, int h, int wd,
                            int p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * h * wd * p) return;
  const int o = (int)(i % p);
  long long pix = i / p;
  const int xx = (int)(pix % wd);
  const int yy = (int)((pix / wd) % h);
  const long long img = pix / ((long long)wd * h);
  float acc = b[o];
  for (int tap = 0; tap < 9; ++tap) {
    const int sy = yy + tap / 3 - 1, sx = xx + tap % 3 - 1;
    if (sy < 0 || sy >= h || sx < 0 || sx >= wd) continue;
    const float* xp = x + ((img * h + sy) * wd + sx) * p;
    const float* wp = w + (size_t)tap * p * p + o;
    for (int c = 0; c < p; ++c) acc += xp[c] * wp[(size_t)c * p];
  }
  y[i] = fmaxf(acc, 0.f);
}

int run_f32(const float* x, const float* w1, const float* b1,
            const float* w2, const float* b2, const float* w3,
            const float* b3, float* y, float* t1, float* t2, int n, int h,
            int w, int c, int p, cudaStream_t st) {
  const long long m = (long long)n * h * w;
  const int th = 256;
  pointwise_f32<<<(unsigned)((m * p + th - 1) / th), th, 0, st>>>(
      x, w1, b1, nullptr, t1, m, c, p);
  conv3x3_f32<<<(unsigned)((m * p + th - 1) / th), th, 0, st>>>(
      t1, w2, b2, t2, n, h, w, p);
  pointwise_f32<<<(unsigned)((m * c + th - 1) / th), th, 0, st>>>(
      t2, w3, b3, x, y, m, p, c);
  return (int)cudaGetLastError();
}

}  // namespace

// One Bottleneck block, x/y [N, H, W, C] NHWC (C = 4P), t1, t2 [N, H, W, P]
// scratch, all in the activation dtype; biases f32. bf16 (P a multiple of
// 64, C of 128): weights packed [tap][out][in] (w1 [1, P, C], w2 [9, P, P],
// w3 [1, C, P]), three launches of conv_gemm_bf16. f32: weights [tap][in]
// [out] (w1 [C, P], w2 [9, P, P], w3 [P, C]), three CUDA-core launches.
// Launches on `stream` without synchronising; writes the number of
// kernels launched to *launches and returns the first CUDA error.
extern "C" int vn_bottleneck_block(const void* x, const void* w1,
                                   const float* b1, const void* w2,
                                   const float* b2, const void* w3,
                                   const float* b3, void* y, void* t1,
                                   void* t2, int n, int h, int w, int c,
                                   int p, int is_bf16, void* stream,
                                   int* launches) {
  *launches = 0;
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  int e = vn_set_device_of(y);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return run_bf16((const bf16*)x, (const bf16*)w1, b1, (const bf16*)w2, b2,
                    (const bf16*)w3, b3, (bf16*)y, (bf16*)t1, (bf16*)t2, n,
                    h, w, c, p, st, launches);
  e = run_f32((const float*)x, (const float*)w1, b1, (const float*)w2, b2,
              (const float*)w3, b3, (float*)y, (float*)t1, (float*)t2, n, h,
              w, c, p, st);
  if (e == 0) *launches = 3;
  return e;
}
