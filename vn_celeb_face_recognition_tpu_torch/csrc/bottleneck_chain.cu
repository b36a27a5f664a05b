// K8: stride-1 ResNet Bottleneck blocks (the emotion net's layer1/layer2
// tails), NHWC.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/
// bottleneck_pallas.py (bottleneck_chain, used by
// emotion_apply_fused_l12). Function of one block, BatchNorm folded on
// the host (scales into the weights, shifts as f32 biases):
//   t1 = relu(x @ W1 + b1)            1x1, C -> P
//   t2 = relu(conv3x3(t1) @ W2 + b2)  3x3 pad 1, P -> P
//   y  = relu(t2 @ W3 + b3 + x)       1x1, P -> C, plus the residual
// The TPU kernel's masked sublane tap slices, ones-column biases and
// guard rows are Mosaic artefacts and are not carried over.
//
// Bound on the H100: at K = 512 faces, layer1's two blocks (56x56,
// C = 256, P = 64) are ~447 GFLOP and layer2's three (28x28, C = 512,
// P = 128) ~671 GFLOP; in bf16 on the tensor cores (989 TFLOP/s) that is
// 0.45 and 0.68 ms, against 1.64 GB and 0.82 GB of bf16 activations read
// and written once per block (0.49 and 0.25 ms at 3.35 TB/s): bound by
// operations, about equally by bytes for layer1.
//
// Design (bf16): one launch per block of the chain, fused. A thread block
// (16 warps) owns R = 4 rows of one image. Conv1 runs on R + 2 rows (a
// one-row halo each side; rows outside the image are zero) into shared
// memory, laid out [R + 2][WT + 2][P] with a zero column each side, so
// every 3x3 tap of a 16-pixel run of one row is one strided shared-memory
// matrix: conv2 is 9 accumulated GEMMs read straight from conv1's output.
// Conv2's output stays in shared memory; conv3, the bias, the residual
// (re-read from x) and the ReLU finish in registers and write y. Rows are
// padded to WT (a multiple of 16) pixels; the padding pixels are computed
// and dropped. Matrix products are WMMA bf16 16x16x16 (mma.sync) with f32
// accumulation. Every B operand (a 64-row chunk of W1, one tap of W2, a
// column block of W3) is staged in shared memory once per thread block
// and shared by its warps. The chain ping-pongs two buffers, because a
// block's conv1 reads its neighbours' halo rows of x.
//
// f32 (the card-vs-CPU check): three plain CUDA-core launches per block
// (conv1, conv2, conv3 + residual), with t1 and t2 in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;

template <int C, int P, int WT, int R>
struct Cfg {
  static constexpr int kKC = 64;            // conv1 K chunk staged in smem
  static constexpr int kLDX = kKC + 16;     // its row stride (elements)
  static constexpr int kLDP = P + 16;       // t1 / t2 row stride
  static constexpr int kWP = WT + 2;        // t1 columns incl. zero pads
  static constexpr int kM1 = (R + 2) * WT;  // conv1 pixels (halo rows)
  static constexpr int kM2 = R * WT;        // conv2 / conv3 pixels
  static constexpr int kXs = kM1 * kLDX;
  static constexpr int kT2 = kM2 * kLDP;
  static constexpr int kBuf0 = kXs > kT2 ? kXs : kT2;  // xs, later t2
  static constexpr int kT1 = (R + 2) * kWP * kLDP;
  // conv3 output columns per pass: 64 accumulator tiles per pass
  static constexpr int kNTP = 64 / (kM2 / 16);
  static constexpr int kLDB3 = kNTP * 16 + 16;
  // staged B: [KC][LDP] (conv1), [P][LDP] (conv2), [P][LDB3] (conv3)
  static constexpr int kB = (P > kKC ? P : kKC) *
                            (kLDP > kLDB3 ? kLDP : kLDB3);
  static constexpr size_t kScratchOff =
      ((size_t)(kBuf0 + kT1 + kB) * sizeof(bf16) + 127) / 128 * 128;
  static constexpr size_t kBytes =
      kScratchOff + sizeof(float) * kWarps * 256;
  static_assert(WT % 16 == 0 && P % 16 == 0 && C % kKC == 0, "tiles");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Copy ``rows`` rows of COLS bf16 (a multiple of 8) from global memory,
// row stride ``src_ld``, into shared memory with row stride ``dst_ld``.
template <int COLS>
__device__ __forceinline__ void stage_rows(bf16* dst, int dst_ld,
                                           const bf16* src, int src_ld,
                                           int rows) {
  constexpr int kVec = COLS / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, v = i % kVec;
    *reinterpret_cast<uint4*>(dst + r * dst_ld + v * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * src_ld + v * 8);
  }
}

template <int C, int P, int WT, int R>
__global__ void __launch_bounds__(kThreads, 1)
bottleneck_block_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w1,
                        const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const float* __restrict__ b2,
                        const bf16* __restrict__ w3,
                        const float* __restrict__ b3,
                        bf16* __restrict__ y, int h, int w) {
  using G = Cfg<C, P, WT, R>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [M1][LDX]
  bf16* t2 = xs;                                  // [M2][LDP] after conv1
  bf16* t1 = xs + G::kBuf0;                       // [R+2][WP][LDP]
  bf16* bs = t1 + G::kT1;                         // staged B operand
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scr = reinterpret_cast<float*>(smem_raw + G::kScratchOff) +
               warp * 256;  // this warp's 16x16 f32 epilogue tile

  const int n = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const bf16* ximg = x + (size_t)n * h * w * C;

  // ---- conv1 over R + 2 rows: [M1, C] @ [C, P] ------------------------
  {
    constexpr int NT = P / 16, MG = kWarps / NT;
    constexpr int FR = (G::kM1 / 16) / MG;
    static_assert(kWarps % NT == 0 && (G::kM1 / 16) % MG == 0, "conv1");
    const int nt = warp % NT, mg = warp / NT;
    FragC acc[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int kc = 0; kc < C; kc += G::kKC) {
      __syncthreads();
      for (int i = threadIdx.x; i < G::kM1 * (G::kKC / 8); i += kThreads) {
        const int m = i / (G::kKC / 8), s = i % (G::kKC / 8);
        const int ir = r0 - 1 + m / WT, col = m % WT;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ir >= 0 && ir < h && col < w)
          v = *reinterpret_cast<const uint4*>(
              ximg + ((size_t)ir * w + col) * C + kc + s * 8);
        *reinterpret_cast<uint4*>(xs + m * G::kLDX + s * 8) = v;
      }
      stage_rows<P>(bs, G::kLDP, w1 + (size_t)kc * P, P, G::kKC);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < G::kKC; kk += 16) {
        FragB b;
        wmma::load_matrix_sync(b, bs + kk * G::kLDP + nt * 16, G::kLDP);
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          FragA a;
          wmma::load_matrix_sync(
              a, xs + ((mg * FR + f) * 16) * G::kLDX + kk, G::kLDX);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    // bias + ReLU -> t1 (zero for pixels outside the image: conv2's
    // padding)
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      wmma::store_matrix_sync(scr, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      const int m0 = (mg * FR + f) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + e / 16, o = nt * 16 + e % 16;
        const int row = m / WT, col = m % WT;
        const int ir = r0 - 1 + row;
        const bool ok = ir >= 0 && ir < h && col < w;
        const float v = ok ? fmaxf(scr[e] + __ldg(b1 + o), 0.f) : 0.f;
        t1[(row * G::kWP + col + 1) * G::kLDP + o] = __float2bfloat16(v);
      }
      __syncwarp();
    }
    // the zero columns left and right of every row
    for (int i = threadIdx.x; i < (R + 2) * 2 * P; i += kThreads) {
      const int o = i % P, side = (i / P) % 2, row = i / (2 * P);
      t1[(row * G::kWP + side * (WT + 1)) * G::kLDP + o] =
          __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  // ---- conv2: 9 taps of [M2, P] @ [P, P], A read from t1 ---------------
  {
    constexpr int NT = P / 16, MG = kWarps / NT;
    constexpr int FR = (G::kM2 / 16) / MG;
    static_assert((G::kM2 / 16) % MG == 0, "conv2");
    const int nt = warp % NT, mg = warp / NT;
    FragC acc[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) wmma::fill_fragment(acc[f], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      __syncthreads();
      stage_rows<P>(bs, G::kLDP, w2 + (size_t)tap * P * P, P, P);
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < P; kk += 16) {
        FragB b;
        wmma::load_matrix_sync(b, bs + kk * G::kLDP + nt * 16, G::kLDP);
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          const int m0 = (mg * FR + f) * 16;
          const int row = m0 / WT, c0 = m0 % WT;
          FragA a;
          wmma::load_matrix_sync(
              a, t1 + ((row + dy) * G::kWP + c0 + dx) * G::kLDP + kk,
              G::kLDP);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      wmma::store_matrix_sync(scr, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      const int m0 = (mg * FR + f) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int o = nt * 16 + e % 16;
        const float v = fmaxf(scr[e] + __ldg(b2 + o), 0.f);
        t2[(m0 + e / 16) * G::kLDP + o] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- conv3 + bias + residual + ReLU: [M2, P] @ [P, C] -> y -----------
  {
    constexpr int MT = G::kM2 / 16;
    constexpr int NTP = G::kNTP;  // output column tiles per pass
    constexpr int MG = kWarps / NTP, FR = MT / MG;
    static_assert(64 % MT == 0 && kWarps % NTP == 0 && MT % MG == 0 &&
                      (C / 16) % NTP == 0,
                  "conv3");
    const int mg = warp / NTP;
    bf16* yimg = y + (size_t)n * h * w * C;
    for (int pass = 0; pass < (C / 16) / NTP; ++pass) {
      const int nt = pass * NTP + warp % NTP;
      __syncthreads();
      stage_rows<NTP * 16>(bs, G::kLDB3, w3 + pass * NTP * 16, C, P);
      __syncthreads();
      FragC acc[FR];
#pragma unroll
      for (int f = 0; f < FR; ++f) wmma::fill_fragment(acc[f], 0.f);
#pragma unroll
      for (int kk = 0; kk < P; kk += 16) {
        FragB b;
        wmma::load_matrix_sync(b, bs + kk * G::kLDB3 + (warp % NTP) * 16,
                               G::kLDB3);
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          FragA a;
          wmma::load_matrix_sync(
              a, t2 + ((mg * FR + f) * 16) * G::kLDP + kk, G::kLDP);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < FR; ++f) {
        wmma::store_matrix_sync(scr, acc[f], 16, wmma::mem_row_major);
        __syncwarp();
        const int m0 = (mg * FR + f) * 16;
        for (int e = lane; e < 256; e += 32) {
          const int m = m0 + e / 16, o = nt * 16 + e % 16;
          const int ir = r0 + m / WT, col = m % WT;
          if (ir < h && col < w) {
            const size_t at = ((size_t)ir * w + col) * C + o;
            const float v = scr[e] + __ldg(b3 + o) +
                            __bfloat162float(ximg[at]);
            yimg[at] = __float2bfloat16(fmaxf(v, 0.f));
          }
        }
        __syncwarp();
      }
    }
  }
}

template <int C, int P, int WT>
int launch_fused(const bf16* x, const bf16* w1, const float* b1,
                 const bf16* w2, const float* b2, const bf16* w3,
                 const float* b3, bf16* y, int n, int h, int w,
                 cudaStream_t stream) {
  constexpr int R = 4;
  using G = Cfg<C, P, WT, R>;
  auto kern = bottleneck_block_kernel<C, P, WT, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((h + R - 1) / R, n);
  kern<<<grid, kThreads, G::kBytes, stream>>>(x, w1, b1, w2, b2, w3, b3,
                                              y, h, w);
  return (int)cudaGetLastError();
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

// One Bottleneck block, x/y [N, H, W, C] NHWC (C = 4P), weights w1
// [C, P], w2 [9, P, P], w3 [P, C] in the activation dtype, biases f32.
// bf16: the fused kernel (C, P, W) in {(256, 64, <= 64), (512, 128,
// <= 32)}, one launch; t1/t2 unused. f32: t1, t2 [N, H, W, P] scratch,
// three launches. Launches on `stream` without synchronising; writes the
// number of kernels launched to *launches and returns the first CUDA
// error.
extern "C" int vn_bottleneck_block(const void* x, const void* w1,
                                   const float* b1, const void* w2,
                                   const float* b2, const void* w3,
                                   const float* b3, void* y, void* t1,
                                   void* t2, int n, int h, int w, int c,
                                   int p, int is_bf16, void* stream,
                                   int* launches) {
  *launches = 0;
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  if (n > 65535) return (int)cudaErrorInvalidConfiguration;
  int e = vn_set_device_of(y);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *xb = (const bf16*)x, *w1b = (const bf16*)w1,
             *w2b = (const bf16*)w2, *w3b = (const bf16*)w3;
  if (!is_bf16)
    e = run_f32((const float*)x, (const float*)w1, b1, (const float*)w2, b2,
                (const float*)w3, b3, (float*)y, (float*)t1, (float*)t2, n,
                h, w, c, p, st);
  else if (c == 256 && p == 64 && w <= 64)
    e = launch_fused<256, 64, 64>(xb, w1b, b1, w2b, b2, w3b, b3, (bf16*)y,
                                  n, h, w, st);
  else if (c == 512 && p == 128 && w <= 32)
    e = launch_fused<512, 128, 32>(xb, w1b, b1, w2b, b2, w3b, b3, (bf16*)y,
                                   n, h, w, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e == 0) *launches = is_bf16 ? 1 : 3;
  return e;
}
