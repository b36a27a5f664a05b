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
// f32 (3xTF32; the dtype of every shipped config: the production script's
// flags run the emotion tails in f32, CLI path b, 64 faces a chunk):
// conv_gemm_tf32x3<BN, TAPS, RES>, the same three launches a block, tiles,
// warps, 4-stage cp.async ring, zero fill and register epilogue as
// conv_gemm_bf16, and the same packed [tap][N][K] weights in f32.
// - Bound at CLI b's tails (64 faces; l1 2 blocks at 56x56, l2 3 at
//   28x28): 139.7 GFLOP and 1.44 GB (x read and y written once a block).
//   Their floor for f32-accurate work is 0.847 ms, 3 x 139.7 GFLOP of TF32
//   products at 495 TFLOP/s (the bytes take 0.43 ms at 3.35 TB/s); at the
//   67 TFLOP/s f32 peak of the CUDA cores it would be 2.09 ms.
// - What held the old design back: one thread per output element, each
//   reading its whole input row and a strided weight column from device
//   memory, on the CUDA cores: 20.53 ms a CLI b chunk (chip_smoke.py's
//   cli-profile: the 1x1 grid 9.70 ms in 10 launches, the 3x3 grid 10.83
//   ms in 5), 7.84 + 12.86 ms for l1 + l2 in the grids probe
//   (tools/torch_f32_grids_probe.py), 10% of the f32-peak bound.
// - What this design does: the GEMM on the tensor cores in 3xTF32
//   (mma.cuh): a K chunk is 16 f32 channels of one tap (64 bytes a row,
//   the bf16 chunk's bytes, so the ring, the 80-byte pitch and the
//   ldmatrix.x4 lane addresses carry over; eight rows fall in distinct
//   bank groups); each k8 step splits the warp's B fragments once and each
//   A fragment as it is loaded into tf32 hi and lo, and issues lo_a hi_b,
//   hi_a lo_b, hi_a hi_b as three m16n8k8 products, summed from zero and
//   added to the f32 sums on the CUDA cores (mma_tf32x3_add): mma.sync
//   rounds its sums toward zero, and summed straight into the running
//   sums the chains drifted to 3.1e-4 of a max|ref| of 15 (l2).
// - Measured (NVIDIA H100 80GB HBM3, 700 W; the grids probe, 64 faces):
//   l1 1.436-1.442 ms, l2 1.741-1.758 ms of device time, 38.9 and 48.2
//   TFLOP/s, 27% of the 3xTF32 floor; cuDNN in f32 (TF32 off) 3.79 and
//   3.57 ms; max abs err 7.3e-6 and 1.5e-5 against it.
// - -Xptxas -v (sm_90a): 128 registers a thread, the __launch_bounds__
//   (256, 2) cap, kept so that two blocks share an SM as in bf16; the
//   BN = 128 tiles hold 64 sums, 16 split B and 8 split A registers and
//   spill 40 (conv1), 32 (conv2) and 84 bytes (conv3 + residual), the BN
//   = 64 ones 0 and 8. Shared memory as bf16: 81,920 bytes (BN 128) and
//   61,440 (BN 64) a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <type_traits>

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

// ---- f32: the same implicit GEMM on the tensor cores in 3xTF32 ---------

constexpr int kBK32 = 16;           // f32 channels per K chunk (64 bytes)
constexpr int kLds32 = kBK32 + 4;   // shared row pitch: 80 bytes
static_assert(kBK32 * 4 == kBK * 2 && kLds32 * 4 == kLds * 2,
              "the f32 tiles take the bf16 tiles' bytes");

template <int BN, int TAPS, bool RES>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_tf32x3(const float* __restrict__ a,     // [M, K] pixels
                 const float* __restrict__ wt,    // [TAPS][N][K]
                 const float* __restrict__ bias,  // [N]
                 const float* __restrict__ res,   // [M, N] (RES)
                 float* __restrict__ out,         // [M, N]
                 long long m_total, int k, int n, int h, int w) {
  using T = Tile<BN>;
  constexpr int kStageA = kBM * kLds32, kStageB = BN * kLds32;  // floats
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sa = reinterpret_cast<float*>(smem_raw);
  float* sb = sa + kStages * kStageA;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = n / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;

  // this thread's copies: 16-byte segment ``seg`` of A rows row0 and
  // row0 + 64 and of B rows row0 (+ 64), as in conv_gemm_bf16
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
  const int kpt = k / kBK32;  // chunks per tap
  const int chunks = TAPS * kpt;

  auto load = [&](int c, int stage) {
    const int tap = c / kpt;
    const int k0 = (c - tap * kpt) * kBK32 + seg * 4;
    const int dy = TAPS == 9 ? tap / 3 - 1 : 0;
    const int dx = TAPS == 9 ? tap % 3 - 1 : 0;
    float* da = sa + stage * kStageA + row0 * kLds32 + seg * 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool ok = aok[i];
      if (TAPS > 1)
        ok = ok && (unsigned)(ay[i] + dy) < (unsigned)h &&
             (unsigned)(ax[i] + dx) < (unsigned)w;
      const float* src =
          ok ? a + (size_t)(am[i] + (long long)dy * w + dx) * k + k0 : a;
      cp_async16_zfill(da + i * 64 * kLds32, src, ok);
    }
    float* db = sb + stage * kStageB + row0 * kLds32 + seg * 4;
#pragma unroll
    for (int i = 0; i < BN / 64; ++i)
      cp_async16(db + i * 64 * kLds32,
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
  // this lane's ldmatrix rows (see mma.cuh, 3xTF32)
  const int a_row = wm * T::TM + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int b_row = wn * T::TN + 8 * (lane >> 4) + (lane & 7);
  const float* a_lane = sa + a_row * kLds32 + 4 * (lane >> 4);
  const float* b_lane = sb + b_row * kLds32 + 4 * ((lane >> 3) & 1);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();               // and every warp is done with c - 1
    const int next = c + kStages - 1;
    if (next < chunks) load(next, next % kStages);
    cp_async_commit();
    const int stage = c % kStages;
    const float* as = a_lane + stage * kStageA;
    const float* bs = b_lane + stage * kStageB;
#pragma unroll
    for (int ks = 0; ks < kBK32; ks += 8) {
      // B split once a k8 step for all of the warp's n8 tiles, A one m16
      // tile at a time: 64 or 32 sums + 16 + 8 operand registers
      unsigned bh[T::NF][2], bl[T::NF][2];
#pragma unroll
      for (int j = 0; j < T::NF / 2; ++j) {
        unsigned r[4];
        ldsm_x4(r, bs + j * 16 * kLds32 + ks);
        split_n<2>(r, bh[2 * j], bl[2 * j]);
        split_n<2>(r + 2, bh[2 * j + 1], bl[2 * j + 1]);
      }
#pragma unroll
      for (int mf = 0; mf < T::MF; ++mf) {
        unsigned r[4], ah[4], al[4];
        ldsm_x4(r, as + mf * 16 * kLds32 + ks);
        split_n<4>(r, ah, al);
#pragma unroll
        for (int nf = 0; nf < T::NF; ++nf)
          mma_tf32x3_add(acc[mf][nf], ah, al, bh[nf], bl[nf]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue in registers: bias, residual, ReLU, float2 stores
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
          const float2 r = *reinterpret_cast<const float2*>(res + at);
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<float2*>(out + at) =
            make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
  }
}

// ---- launches ---------------------------------------------------------------

template <typename E, int BN, int TAPS, bool RES>
int launch_conv(const E* a, const E* wt, const float* bias, const E* res,
                E* out, long long m, int k, int n, int h, int w,
                cudaStream_t stream) {
  void (*kern)(const E*, const E*, const float*, const E*, E*, long long,
               int, int, int, int);
  if constexpr (std::is_same_v<E, bf16>)
    kern = conv_gemm_bf16<BN, TAPS, RES>;
  else
    kern = conv_gemm_tf32x3<BN, TAPS, RES>;
  constexpr int smem = Tile<BN>::kSmem;  // the same bytes in both types
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (m + kBM - 1) / kBM * (n / BN);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)tiles, kThreads, smem, stream>>>(a, wt, bias, res, out,
                                                    m, k, n, h, w);
  return (int)cudaGetLastError();
}

// conv1, conv2, conv3 of one block in bf16 (E = bf16) or 3xTF32 (E =
// float); counts each launch in *launches
template <typename E>
int run_block(const E* x, const E* w1, const float* b1, const E* w2,
              const float* b2, const E* w3, const float* b3, E* y, E* t1,
              E* t2, int n, int h, int w, int c, int p, cudaStream_t st,
              int* launches) {
  if (p % 64 != 0 || c % 128 != 0) return (int)cudaErrorInvalidValue;
  const long long m = (long long)n * h * w;
  const bool wide = p % 128 == 0;
  int e = wide ? launch_conv<E, 128, 1, false>(x, w1, b1, nullptr, t1, m, c,
                                               p, h, w, st)
               : launch_conv<E, 64, 1, false>(x, w1, b1, nullptr, t1, m, c,
                                              p, h, w, st);
  if (e != 0) return e;
  ++*launches;
  e = wide ? launch_conv<E, 128, 9, false>(t1, w2, b2, nullptr, t2, m, p, p,
                                           h, w, st)
           : launch_conv<E, 64, 9, false>(t1, w2, b2, nullptr, t2, m, p, p,
                                          h, w, st);
  if (e != 0) return e;
  ++*launches;
  e = launch_conv<E, 128, 1, true>(t2, w3, b3, x, y, m, p, c, h, w, st);
  if (e == 0) ++*launches;
  return e;
}

}  // namespace

// One Bottleneck block, x/y [N, H, W, C] NHWC (C = 4P), t1, t2 [N, H, W, P]
// scratch, all in the activation dtype (bf16 or f32); biases f32. P a
// multiple of 64, C of 128; weights packed [tap][out][in] (w1 [1, P, C],
// w2 [9, P, P], w3 [1, C, P]): three launches of conv_gemm_bf16 or of
// conv_gemm_tf32x3. Launches on `stream` without synchronising; writes the
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
  int e = vn_set_device_of(y);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return run_block((const bf16*)x, (const bf16*)w1, b1, (const bf16*)w2,
                     b2, (const bf16*)w3, b3, (bf16*)y, (bf16*)t1,
                     (bf16*)t2, n, h, w, c, p, st, launches);
  return run_block((const float*)x, (const float*)w1, b1, (const float*)w2,
                   b2, (const float*)w3, b3, (float*)y, (float*)t1,
                   (float*)t2, n, h, w, c, p, st, launches);
}
