// K5: the MTCNN RNet/ONet trunk on batched face crops.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/
// crops_net_pallas.py:239 (crop_net_trunk, used by rnet_apply_fused and
// onet_apply_fused), in both its dtypes. Function, per normalised crop [S, S, 3] (NHWC):
// conv1 3x3 valid (3 -> C1) + bias + PReLU, max pool 3x3/2 in torch's
// ceil mode, conv2 3x3 valid (C1 -> C2) + bias + PReLU:
//   RNet: [N, 24, 24, 3] -> 22 -> 11 -> [N, 9, 9, 48]   (C1 28, C2 48)
//   ONet: [N, 48, 48, 3] -> 46 -> 23 -> [N, 21, 21, 64] (C1 32, C2 64)
// The TPU kernel's space-to-depth packing and subposition matrix A1 are
// not carried over.
//
// Bound on the H100 (bf16): per crop the trunk is ~2.7 MFLOP (RNet) and
// ~20 MFLOP (ONet) against 3.5 KB / 14 KB of bf16 in and 7.8 KB / 56 KB
// out. At the stock line's 32,768 RNet and 16,384 ONet crops a chunk is
// 0.41 TFLOP (0.42 ms at the bf16 tensor-core peak) against 1.5 GB
// (0.45 ms at 3.35 TB/s): bytes and operations about equally.
//
// bf16 (every line: MTCNN(dtype=torch.bfloat16)), on the tensor cores
// with mma.sync.m16n8k16 (bf16 in, f32 accumulate):
// - Persistent blocks of 8 warps, as many as fit the card (two per SM),
//   each looping over groups of G crops (ONet 1, RNet 4); the next
//   group's crops arrive by cp.async while conv2 runs. The packed
//   bf16 weights load into shared memory once per block: w1 as a
//   [32][27 -> 32] B operand, w2 as a K-major [C2][9 * 32] B operand
//   (ONet 36 KB), conv2's bias and the PReLU slopes in f32. RNet's
//   C1 = 28 is padded to 32 with zero weights, so every k16 step is 16
//   contiguous channels.
// - conv1 is a GEMM over positions x (tap, ci), K = 27 padded to 32, its
//   A fragments gathered from the staged crop; column 27 of A is ones and
//   column 27 of w1 the bias, so the sum carries the bias. It runs in
//   bands of R = 2 pooled rows: a band computes the conv rows its pool
//   windows cover that the band before did not (the ceil-mode edge: the
//   last pooled row and column see two conv rows, RNet 22 -> 11, ONet
//   46 -> 23) into a ring of 2R + 1 rows, applies PReLU in f32 and rounds
//   to bf16 (rounding is monotone, so pooling the rounded values equals
//   rounding the f32 pool), then pools the band into the resident NHWC
//   pooled map [G][P][P][32] with an 80-byte pixel pitch (ldmatrix rows
//   of 8 neighbouring pixels fall in 8 distinct 16-byte bank groups).
// - conv2 is an implicit GEMM: M = G x P2 x P2 output positions (ONet
//   441, RNet 4 x 81, in m16 tiles), N = C2, K = 9 taps x 32 channels. Each
//   k16 step's A fragment is one ldmatrix.x4 whose rows are pooled pixels
//   (tap offset + 16 channels); B fragments are ldmatrix.x4 of the
//   resident w2 rows (pitch 296 bf16, also conflict-free). A warp owns an
//   (m16 tile, NT x 8 channels) item.
// - Epilogue: bias, then PReLU in f32, round to bf16, stage the 16
//   positions in shared memory (over the band buffer) and store them as
//   16-byte rows of the NHWC [N, P2, P2, C2] output.
// Occupancy: shared memory ONet 111,952 B, RNet 112,192 B a block, so two
// blocks (16 warps) fit an SM. -Xptxas -v (sm_90a): 128 registers a
// thread (the __launch_bounds__(256, 2) cap), with 36 bytes (ONet) and
// 4 bytes (RNet) of spills.
//
// f32 (3xTF32; the dtype of every shipped config: demo_video
// --fused_engine runs MTCNN in f32, CLI path a, 16,384 RNet + 8,192 ONet
// crops a chunk run), crop_net_trunk_tf32x3<S, C2, G, R, MT, NT>:
// - Bound at CLI a's crops: 207.2 GFLOP (RNet 44.1, ONet 163.1) and 1.52
//   GB of f32 crops in and features out (0.45 ms at 3.35 TB/s). The floor
//   for f32-accurate work is 1.256 ms (RNet 0.267, ONet 0.989), 3 x the
//   operations as TF32 products at 495 TFLOP/s; at the 67 TFLOP/s f32 peak
//   of the CUDA cores it would be 3.093 ms.
// - What held the old design back (one block per crop on the CUDA cores):
//   ~153 KB of shared memory for ONet, so one 512-thread block an SM; it
//   restaged conv2's 74 KB of weights from L2 for every crop; each group
//   of 16 FMAs cost 5 shared loads. 10.65 ms of device time a CLI a chunk
//   (chip_smoke.py's cli-profile), RNet 2.26-2.34 + ONet 8.16-8.21 ms in
//   tools/torch_k5_probe.py.
// - What this design does: the bf16 grid's structure in f32 on the tensor
//   cores. Persistent blocks load the packed f32 weights once (w1 split
//   into tf32 hi and lo in shared memory once, as the B operand of every
//   conv1 tile) and stage the next group's crops by cp.async during
//   conv2. conv1 is a GEMM over positions x (tap, ci), K = 27 + a ones
//   column for the bias, padded to 32 (4 k8 steps), in bands of R = 2
//   pooled rows into a ring of 5 conv rows (PReLU in f32), pooled (3x3/2,
//   ceil mode) into the resident NHWC pooled map, 36 floats a pixel (9
//   16-byte units, so ldmatrix rows of eight neighbours fall in distinct
//   bank groups). conv2 is an implicit GEMM, M = positions, N = C2, K = 9
//   taps x 32 channels, in items of MT m16 x NT n8 tiles (ONet 2 x 4, RNet
//   1 x 2: the fastest without large spills in the probe), A and B split
//   as they are loaded (mma.cuh); a tap's products are summed from zero
//   on the tensor cores and added to the sums on the CUDA cores (their
//   sums round toward zero; summed straight in, ONet's error was 1.8e-5
//   against 8.3e-6, for 9% less time). Epilogue: bias + PReLU in f32,
//   float2 stores (a quad writes 32 bytes).
// - Shared memory: ONet 221,552 B, RNet (G = 4) 226,496 B, so one block of
//   16 warps an SM. Accepted: at the 128-register cap an SM runs 512
//   threads either way, so two blocks of 8 warps would add no warps, only
//   a second copy of the weights; blocks of 8 and 12 warps measured 8% and
//   2% slower on ONet (the probe). -Xptxas -v (sm_90a): 128 registers a
//   thread (__launch_bounds__(512, 1)), spills ONet 60 bytes stored / 92
//   loaded, RNet 24 / 36.
// - Measured (NVIDIA H100 80GB HBM3, 700 W; the probe and the grids
//   probe): RNet 1.379-1.397 ms, ONet 3.440-3.453 ms of device time (32
//   and 47 TFLOP/s; 19% and 29% of the floor), a call 1.50 + 3.56 ms;
//   cuDNN in f32 (TF32 off) 6.49 + 15.42 ms; max abs err 5.7e-6 and
//   8.6e-6 against it (max|ref| 5.0 and 5.5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "launch.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : v * a;
}

constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// ---------------------------------------------------------------------
// bf16: persistent blocks on the tensor cores
// ---------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int C1P = 32;        // conv1 channels, padded
constexpr int K1P = 40;        // w1 row pitch (27 taps x ci -> 32, + 8)
constexpr int K2 = 9 * C1P;    // conv2 depth
constexpr int K2P = K2 + 8;    // w2 row pitch
constexpr int PIX = C1P + 8;   // pooled pixel pitch

// the packed bf16 buffer: w1 [32][K1P] bf16 (conv1's bias in column 27,
// against a column of ones in A), w2 [C2][K2P] bf16, then f32 a1[32],
// b2[C2], a2[C2] (ops/crops_net.pack_trunk_weights_mma)
template <int C2>
struct Packed {
  static constexpr int kW1Bytes = C1P * K1P * 2;
  static constexpr int kW2Bytes = C2 * K2P * 2;
  static constexpr int kParBytes = (C1P + 2 * C2) * 4;
  static constexpr int kBytes = kW1Bytes + kW2Bytes + kParBytes;
  static_assert(kW1Bytes % 16 == 0 && kW2Bytes % 16 == 0 &&
                kParBytes % 16 == 0, "16-byte copies");
};

template <int S, int C2, int G, int R, int NT>
struct Mma {
  static constexpr int H1 = S - 2;
  static constexpr int P = (H1 - 2) / 2 + 1;
  static constexpr int P2 = P - 2;
  static constexpr int BR = 2 * R + 1;
  static constexpr int NG = C2 / (8 * NT);       // channel groups
  static constexpr int OUTP = NT * 8 + 8;        // output staging pitch
  static constexpr int kCropBytes = round16(G * S * S * 3 * 2);
  static constexpr int kBandBytes = G * BR * H1 * C1P * 2;
  static constexpr int kStageBytes = kWarps * 16 * OUTP * 2;
  static constexpr int kRegionA = kCropBytes + kBandBytes;
  static constexpr int kPooledBytes = round16(G * P * P * PIX * 2);
  static constexpr int kSmemBytes =
      Packed<C2>::kBytes + kPooledBytes + kRegionA;
  static_assert(C2 % (8 * NT) == 0 && NT % 2 == 0, "channel groups");
  static_assert(kStageBytes <= kBandBytes, "the staging reuses the band");
  static_assert((S * S * 3 * 2) % 16 == 0, "16-byte crop copies");
  static_assert((OUTP * 2) % 16 == 0, "16-byte staged rows");
};

template <int S, int C2, int G, int R, int NT>
__global__ void __launch_bounds__(kThreads, 2)
crop_net_trunk_mma(const bf16* __restrict__ crops,
                   const uint8_t* __restrict__ weights,
                   bf16* __restrict__ out, int n) {
  using L = Mma<S, C2, G, R, NT>;
  using W = Packed<C2>;
  constexpr int H1 = L::H1, P = L::P, P2 = L::P2;
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  const bf16* w1s = reinterpret_cast<const bf16*>(smem);
  const bf16* w2s = reinterpret_cast<const bf16*>(smem + W::kW1Bytes);
  const float* a1s =
      reinterpret_cast<const float*>(smem + W::kW1Bytes + W::kW2Bytes);
  const float* b2s = a1s + C1P;
  const float* a2s = b2s + C2;
  bf16* pooled = reinterpret_cast<bf16*>(smem + W::kBytes);
  uint8_t* region = smem + W::kBytes + L::kPooledBytes;
  bf16* crop = reinterpret_cast<bf16*>(region);
  bf16* band = reinterpret_cast<bf16*>(region + L::kCropBytes);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // conv2's output staging reuses the band buffer, so the next group's
  // crops can land in the crop buffer while conv2 runs
  bf16* stage = band + warp * 16 * L::OUTP;

  // the packed weights, once per block
  for (int i = tid; i < W::kBytes / 16; i += kThreads)
    smem_u4[i] = __ldg(reinterpret_cast<const uint4*>(weights) + i);
  __syncthreads();

  const int gq = lane / 4, tq = lane % 4;  // mma fragment row / column pair
  // conv1 B fragments, loop-invariant: [n-tile][k-step][2]
  unsigned b1f[4][2][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b1f[j][ks][h] = *reinterpret_cast<const unsigned*>(
            w1s + (j * 8 + gq) * K1P + ks * 16 + h * 8 + 2 * tq);
  // conv1 A columns of this lane: k = ks*16 + {2t, 2t+1, 2t+8, 2t+9} ->
  // crop offset of (tap, ci) relative to the position; k = 27 is the
  // column of ones that meets the bias (-2), k > 27 padding (-1)
  int koff[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = ks * 16 + 2 * tq + (q & 1) + 8 * (q >> 1);
      const int tap = k / 3, ci = k % 3;
      koff[ks][q] = k < 27 ? ((tap / 3) * S + tap % 3) * 3 + ci
                           : (k == 27 ? -2 : -1);
    }
  // conv1's PReLU slopes of this lane's channels j*8 + 2t (+1)
  float a1r[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) a1r[j][e] = a1s[j * 8 + 2 * tq + e];

  const int groups = (n + G - 1) / G;
  // a group's crops are contiguous in device memory: cp.async them
  auto fetch = [&](int grp) {
    if (grp < groups) {
      const int c = grp * G, count = min(G, n - c);
      const char* src =
          reinterpret_cast<const char*>(crops + (size_t)c * S * S * 3);
      for (int i = tid; i < count * S * S * 3 * 2 / 16; i += kThreads)
        cp_async16(reinterpret_cast<uint4*>(crop) + i, src + 16 * i);
    }
    cp_async_commit();
  };
  fetch(blockIdx.x);
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int c0 = grp * G;
    const int gv = min(G, n - c0);
    cp_async_wait_all();
    __syncthreads();

    // ---- conv1 + PReLU band by band, pooled into the resident map ----
    // a band pools R rows; its conv rows live in a ring of BR = 2R + 1
    // rows a crop (row y in slot y % BR), and the row two bands share is
    // computed once
    for (int py0 = 0; py0 < P; py0 += R) {
      const int py1 = min(py0 + R, P);
      const int first = py0 == 0 ? 0 : 2 * py0 + 1;
      const int nrows = min(2 * py1, H1 - 1) - first + 1;
      const int m1 = gv * nrows * H1;
      for (int mt = warp; mt * 16 < m1; mt += kWarps) {
        int base[2], dst[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = min(mt * 16 + gq + 8 * h, m1 - 1);
          const int q = m / H1, x = m - q * H1;
          const int g = G == 1 ? 0 : q / nrows;
          const int y = first + q - g * nrows;
          base[h] = (g * S * S + y * S + x) * 3;
          dst[h] = ((g * L::BR + y % L::BR) * H1 + x) * C1P;
        }
        float acc[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          bf16 v[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v[h][q] = koff[ks][q] >= 0
                            ? crop[base[h] + koff[ks][q]]
                            : __float2bfloat16(koff[ks][q] == -2 ? 1.f : 0.f);
          // a0a1 (row g, k 2t..), a2a3 (row g+8), a4a5 (row g, k 2t+8..),
          // a6a7 (row g+8, k 2t+8..)
          const unsigned a[4] = {pack2(v[0][0], v[0][1]),
                                 pack2(v[1][0], v[1][1]),
                                 pack2(v[0][2], v[0][3]),
                                 pack2(v[1][2], v[1][3])};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[j], a, b1f[j][ks][0], b1f[j][ks][1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (mt * 16 + gq + 8 * h >= m1) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<unsigned*>(band + dst[h] + j * 8 + 2 * tq) =
                pack2f(prelu(acc[j][2 * h], a1r[j][0]),
                       prelu(acc[j][2 * h + 1], a1r[j][1]));
        }
      }
      __syncthreads();
      // ceil-mode 3x3/2 pool, 8 channels (16 bytes) a thread; the max of
      // bf16 values is exact in bf16 (__hmax2 drops NaN, as fmaxf)
      const int nb = py1 - py0;
      for (int i = tid; i < gv * nb * P * (C1P / 8); i += kThreads) {
        const int cq = i % (C1P / 8);
        const int px = (i / (C1P / 8)) % P;
        const int q = i / (C1P / 8 * P);
        const int g = G == 1 ? 0 : (nb == R ? q / R : q / nb);
        const int py = py0 + q - g * nb;
        const bf16* gband = band + g * L::BR * H1 * C1P + 8 * cq;
        const int ny = min(3, H1 - 2 * py), nx = min(3, H1 - 2 * px);
        uint4 m = *reinterpret_cast<const uint4*>(
            gband + ((2 * py) % L::BR * H1 + 2 * px) * C1P);
        __nv_bfloat162* mh = reinterpret_cast<__nv_bfloat162*>(&m);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const bf16* row = gband + (2 * py + dy) % L::BR * H1 * C1P;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            if (dy >= ny || dx >= nx) continue;  // the ceil-mode edge
            uint4 v = *reinterpret_cast<const uint4*>(
                row + (2 * px + dx) * C1P);
            const __nv_bfloat162* vh =
                reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int e = 0; e < 4; ++e) mh[e] = __hmax2(mh[e], vh[e]);
          }
        }
        *reinterpret_cast<uint4*>(pooled + ((g * P + py) * P + px) * PIX +
                                  8 * cq) = m;
      }
      __syncthreads();
    }

    // ---- conv2 + PReLU: implicit GEMM over the pooled map ----
    fetch(grp + gridDim.x);  // the crop buffer is free until the next group
    const int m2 = gv * P2 * P2;
    const int items = (m2 + 15) / 16 * L::NG;
    for (int it = warp; it < items; it += kWarps) {
      const int mt = it / L::NG, ng = it % L::NG;
      // this lane's ldmatrix row of A: position -> pooled pixel
      const int am = min(mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), m2 - 1);
      const int ag = am / (P2 * P2), arem = am % (P2 * P2);
      const bf16* arow =
          pooled + (ag * P * P + (arem / P2) * P + arem % P2) * PIX +
          8 * (lane >> 4);
      // and of B: w2 row (output channel) and k offset
      const bf16* brow =
          w2s + (ng * NT * 8 + 8 * (lane >> 4) + (lane & 7)) * K2P +
          8 * ((lane >> 3) & 1);
      float acc[NT][4] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const bf16* ap = arow + ((tap / 3) * P + tap % 3) * PIX;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned a[4];
          ldsm_x4(a, ap + h * 16);
          const int k0 = tap * C1P + h * 16;
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            unsigned b[4];
            ldsm_x4(b, brow + j * 8 * K2P + k0);
            mma_bf16(acc[j], a, b[0], b[1]);
            mma_bf16(acc[j + 1], a, b[2], b[3]);
          }
        }
      }
      // epilogue: bias + PReLU in f32, bf16, staged, 16-byte rows out
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int cl = j * 8 + 2 * tq, c = ng * NT * 8 + cl;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float lo = prelu(acc[j][2 * h] + b2s[c], a2s[c]);
          const float hi = prelu(acc[j][2 * h + 1] + b2s[c + 1], a2s[c + 1]);
          *reinterpret_cast<unsigned*>(stage + (gq + 8 * h) * L::OUTP + cl) =
              pack2f(lo, hi);
        }
      }
      __syncwarp();
      bf16* dst = out + ((size_t)c0 * P2 * P2 + mt * 16) * C2 + ng * NT * 8;
      for (int i = lane; i < 16 * NT; i += 32) {
        const int r = i / NT, q = i % NT;
        if (mt * 16 + r < m2)
          *reinterpret_cast<uint4*>(dst + (size_t)r * C2 + q * 8) =
              *reinterpret_cast<const uint4*>(stage + r * L::OUTP + q * 8);
      }
      __syncwarp();
    }
    __syncthreads();  // the next group's conv1 overwrites the staging rows
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------
// f32: persistent blocks on the tensor cores in 3xTF32
// ---------------------------------------------------------------------

constexpr int kTfWarps = 16;
constexpr int kTfThreads = 32 * kTfWarps;
constexpr int K1T = C1P + 4;   // w1 row pitch, floats (9 16-byte units)
constexpr int K2T = K2 + 4;    // w2 row pitch, floats (73 units)
constexpr int PIXT = C1P + 4;  // band and pooled pixel pitch (9 units)

// the packed f32 buffer: w1 [32][K1T] (conv1's bias in column 27, against
// a column of ones in A), w2 [C2][K2T], then a1[32], b2[C2], a2[C2]
// (ops/crops_net.pack_trunk_weights_tf32x3). In shared memory w1 is held
// split, its hi half in place and its lo half after the buffer.
template <int C2>
struct PackedTf {
  static constexpr int kW1Bytes = C1P * K1T * 4;
  static constexpr int kW2Bytes = C2 * K2T * 4;
  static constexpr int kParBytes = (C1P + 2 * C2) * 4;
  static constexpr int kBytes = kW1Bytes + kW2Bytes + kParBytes;
  static constexpr int kSmemBytes = kBytes + kW1Bytes;  // + w1's lo half
  static_assert(kW1Bytes % 16 == 0 && kW2Bytes % 16 == 0 &&
                kParBytes % 16 == 0, "16-byte copies");
};

// S crop side, C2 conv2 channels, G crops a group, R pooled rows a conv1
// band, conv2 items of MT m16 tiles x NT n8 tiles
template <int S, int C2, int G, int R, int MT, int NT>
struct Tf {
  static constexpr int H1 = S - 2;
  static constexpr int P = (H1 - 2) / 2 + 1;
  static constexpr int P2 = P - 2;
  static constexpr int BR = 2 * R + 1;
  static constexpr int NG = C2 / (8 * NT);       // channel groups
  static constexpr int kPooledBytes = G * P * P * PIXT * 4;
  static constexpr int kCropBytes = G * S * S * 3 * 4;
  static constexpr int kBandBytes = G * BR * H1 * PIXT * 4;
  static constexpr int kSmemBytes = PackedTf<C2>::kSmemBytes +
                                    kPooledBytes + kCropBytes + kBandBytes;
  static_assert(C2 % (8 * NT) == 0 && NT % 2 == 0, "channel groups");
  static_assert(kCropBytes % 16 == 0, "16-byte crop copies");
  static_assert(kSmemBytes <= 232448, "one block an SM");
};

template <int S, int C2, int G, int R, int MT, int NT>
__global__ void __launch_bounds__(kTfThreads, 1)
crop_net_trunk_tf32x3(const float* __restrict__ crops,
                      const float* __restrict__ weights,
                      float* __restrict__ out, int n) {
  using L = Tf<S, C2, G, R, MT, NT>;
  using W = PackedTf<C2>;
  constexpr int H1 = L::H1, P = L::P, P2 = L::P2;
  extern __shared__ uint4 smem_u4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_u4);
  float* w1h = reinterpret_cast<float*>(smem);
  const float* w2s = reinterpret_cast<const float*>(smem + W::kW1Bytes);
  const float* a1s =
      reinterpret_cast<const float*>(smem + W::kW1Bytes + W::kW2Bytes);
  const float* b2s = a1s + C1P;
  const float* a2s = b2s + C2;
  float* w1l = reinterpret_cast<float*>(smem + W::kBytes);
  float* pooled = reinterpret_cast<float*>(smem + W::kSmemBytes);
  float* crop = pooled + G * P * P * PIXT;
  float* band = crop + G * S * S * 3;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the packed weights, once per block; w1 split into hi (in place) and lo
  for (int i = tid; i < W::kBytes / 16; i += kTfThreads)
    smem_u4[i] = __ldg(reinterpret_cast<const uint4*>(weights) + i);
  __syncthreads();
  for (int i = tid; i < C1P * K1T; i += kTfThreads) {
    unsigned hi, lo;
    split_tf32(__float_as_uint(w1h[i]), hi, lo);
    w1h[i] = __uint_as_float(hi);
    w1l[i] = __uint_as_float(lo);
  }
  __syncthreads();

  const int gq = lane / 4, tq = lane % 4;  // mma fragment row / column
  // conv1 A columns of this lane: k = ks*8 + tq (+4) -> crop offset of
  // (tap, ci) relative to the position; k = 27 is the column of ones that
  // meets the bias (-2), k > 27 padding (-1)
  int koff[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ks * 8 + tq + 4 * h;
      const int tap = k / 3, ci = k % 3;
      koff[ks][h] = k < 27 ? ((tap / 3) * S + tap % 3) * 3 + ci
                           : (k == 27 ? -2 : -1);
    }
  // conv1's PReLU slopes of this lane's channels j*8 + 2t (+1)
  float a1r[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) a1r[j][e] = a1s[j * 8 + 2 * tq + e];
  // this lane's ldmatrix row of w1 (B: n rows, k columns), hi and lo
  const int b1off =
      (8 * (lane >> 4) + (lane & 7)) * K1T + 4 * ((lane >> 3) & 1);

  const int groups = (n + G - 1) / G;
  // a group's crops are contiguous in device memory: cp.async them
  auto fetch = [&](int grp) {
    if (grp < groups) {
      const int c = grp * G, count = min(G, n - c);
      const char* src =
          reinterpret_cast<const char*>(crops + (size_t)c * S * S * 3);
      for (int i = tid; i < count * S * S * 3 * 4 / 16; i += kTfThreads)
        cp_async16(reinterpret_cast<uint4*>(crop) + i, src + 16 * i);
    }
    cp_async_commit();
  };
  fetch(blockIdx.x);
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int c0 = grp * G;
    const int gv = min(G, n - c0);
    cp_async_wait_all();
    __syncthreads();

    // ---- conv1 + PReLU band by band, pooled into the resident map ----
    // (the ring of conv rows as on the bf16 path, kept in f32)
    for (int py0 = 0; py0 < P; py0 += R) {
      const int py1 = min(py0 + R, P);
      const int first = py0 == 0 ? 0 : 2 * py0 + 1;
      const int nrows = min(2 * py1, H1 - 1) - first + 1;
      const int m1 = gv * nrows * H1;
      for (int mt = warp; mt * 16 < m1; mt += kTfWarps) {
        int base[2], dst[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = min(mt * 16 + gq + 8 * h, m1 - 1);
          const int q = m / H1, x = m - q * H1;
          const int g = G == 1 ? 0 : q / nrows;
          const int y = first + q - g * nrows;
          base[h] = (g * S * S + y * S + x) * 3;
          dst[h] = ((g * L::BR + y % L::BR) * H1 + x) * PIXT;
        }
        float acc[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          // a0 (row g, k t), a1 (row g+8, k t), a2 (row g, k t+4),
          // a3 (row g+8, k t+4)
          unsigned v[4], ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ko = koff[ks][q >> 1];
            v[q] = __float_as_uint(ko >= 0 ? crop[base[q & 1] + ko]
                                           : (ko == -2 ? 1.f : 0.f));
          }
          split_n<4>(v, ah, al);
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            unsigned bh[4], bl[4];
            const int at = b1off + jp * 16 * K1T + ks * 8;
            ldsm_x4(bh, w1h + at);
            ldsm_x4(bl, w1l + at);
            mma_tf32x3(acc[2 * jp], ah, al, bh, bl);
            mma_tf32x3(acc[2 * jp + 1], ah, al, bh + 2, bl + 2);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (mt * 16 + gq + 8 * h >= m1) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(band + dst[h] + j * 8 + 2 * tq) =
                make_float2(prelu(acc[j][2 * h], a1r[j][0]),
                            prelu(acc[j][2 * h + 1], a1r[j][1]));
        }
      }
      __syncthreads();
      // ceil-mode 3x3/2 pool, 4 channels (16 bytes) a thread
      const int nb = py1 - py0;
      for (int i = tid; i < gv * nb * P * (C1P / 4); i += kTfThreads) {
        const int cq = i % (C1P / 4);
        const int px = (i / (C1P / 4)) % P;
        const int q = i / (C1P / 4 * P);
        const int g = G == 1 ? 0 : q / nb;
        const int py = py0 + q - g * nb;
        const float* gband = band + g * L::BR * H1 * PIXT + 4 * cq;
        const int ny = min(3, H1 - 2 * py), nx = min(3, H1 - 2 * px);
        float4 m = *reinterpret_cast<const float4*>(
            gband + ((2 * py) % L::BR * H1 + 2 * px) * PIXT);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* row = gband + (2 * py + dy) % L::BR * H1 * PIXT;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            if (dy >= ny || dx >= nx) continue;  // the ceil-mode edge
            const float4 v = *reinterpret_cast<const float4*>(
                row + (2 * px + dx) * PIXT);
            m = make_float4(fmaxf(m.x, v.x), fmaxf(m.y, v.y),
                            fmaxf(m.z, v.z), fmaxf(m.w, v.w));
          }
        }
        *reinterpret_cast<float4*>(pooled + ((g * P + py) * P + px) * PIXT +
                                   4 * cq) = m;
      }
      __syncthreads();
    }

    // ---- conv2 + PReLU: implicit GEMM over the pooled map ----
    fetch(grp + gridDim.x);  // the crop buffer is free until the next group
    const int m2 = gv * P2 * P2;
    const int items = (m2 + 16 * MT - 1) / (16 * MT) * L::NG;
    for (int it = warp; it < items; it += kTfWarps) {
      const int mt0 = it / L::NG * MT, ng = it % L::NG;
      // this lane's ldmatrix rows of A: position -> pooled pixel
      const float* arow[MT];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int am = min((mt0 + mi) * 16 + (lane & 7) +
                               8 * ((lane >> 3) & 1), m2 - 1);
        const int ag = am / (P2 * P2), arem = am % (P2 * P2);
        arow[mi] = pooled +
                   (ag * P * P + (arem / P2) * P + arem % P2) * PIXT +
                   4 * (lane >> 4);
      }
      // and of B: w2 row (output channel) and k offset
      const float* brow =
          w2s + (ng * NT * 8 + 8 * (lane >> 4) + (lane & 7)) * K2T +
          4 * ((lane >> 3) & 1);
      float acc[MT][NT][4] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        // a tap's 32 channels summed from zero on the tensor cores, then
        // added to acc on the CUDA cores (mma_tf32x3_add, mma.cuh)
        float t[MT][NT][4] = {};
        const int toff = ((tap / 3) * P + tap % 3) * PIXT;
#pragma unroll
        for (int q = 0; q < C1P / 8; ++q) {
          unsigned ah[MT][4], al[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            unsigned r[4];
            ldsm_x4(r, arow[mi] + toff + q * 8);
            split_n<4>(r, ah[mi], al[mi]);
          }
          const int k0 = tap * C1P + q * 8;
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            unsigned b[4], bh[4], bl[4];
            ldsm_x4(b, brow + j * 8 * K2T + k0);
            split_n<4>(b, bh, bl);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              mma_tf32x3(t[mi][j], ah[mi], al[mi], bh, bl);
              mma_tf32x3(t[mi][j + 1], ah[mi], al[mi], bh + 2, bl + 2);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] += t[mi][j][e];
      }
      // epilogue: bias + PReLU, float2 stores (a quad writes 32 bytes)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        float* dst = out + ((size_t)c0 * P2 * P2 + (mt0 + mi) * 16) * C2 +
                     ng * NT * 8;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int cl = j * 8 + 2 * tq, c = ng * NT * 8 + cl;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = gq + 8 * h;
            if ((mt0 + mi) * 16 + r >= m2) continue;
            *reinterpret_cast<float2*>(dst + (size_t)r * C2 + cl) =
                make_float2(
                    prelu(acc[mi][j][2 * h] + b2s[c], a2s[c]),
                    prelu(acc[mi][j][2 * h + 1] + b2s[c + 1], a2s[c + 1]));
          }
        }
      }
    }
    __syncthreads();  // the next group's conv1 overwrites the band rows
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------

// one launch of a persistent grid: as many blocks as fit the card, at most
// one a group of crops
template <typename In, typename Wt>
int launch_persistent(void (*kern)(const In*, const Wt*, In*, int),
                      int threads, int smem, int groups, const void* crops,
                      const void* weights, void* out, int n,
                      cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = std::min(groups, std::max(per_sm, 1) * sms);
  kern<<<grid, threads, smem, stream>>>(static_cast<const In*>(crops),
                                        static_cast<const Wt*>(weights),
                                        static_cast<In*>(out), n);
  return (int)cudaGetLastError();
}

template <int S, int C2, int G, int R, int NT>
int launch_mma(const void* crops, const void* weights, void* out, int n,
               cudaStream_t stream) {
  return launch_persistent(crop_net_trunk_mma<S, C2, G, R, NT>, kThreads,
                           Mma<S, C2, G, R, NT>::kSmemBytes, (n + G - 1) / G,
                           crops, weights, out, n, stream);
}

template <int S, int C2, int G, int R, int MT, int NT>
int launch_tf32x3(const void* crops, const void* weights, void* out, int n,
                  cudaStream_t stream) {
  return launch_persistent(crop_net_trunk_tf32x3<S, C2, G, R, MT, NT>,
                           kTfThreads, Tf<S, C2, G, R, MT, NT>::kSmemBytes,
                           (n + G - 1) / G, crops, weights, out, n, stream);
}

}  // namespace

// crops [n, S, S, 3] normalised, f32 or (bf16 = 1) bf16, and the packed
// weights of ops/crops_net.pack_trunk_weights_tf32x3 (f32) or
// pack_trunk_weights_mma (bf16) -> out [n, P2, P2, C2] in the crops' type;
// net 0 is RNet (S 24), 1 is ONet (S 48). One launch on `stream`, no
// synchronisation; returns cudaGetLastError().
extern "C" int vn_crop_net_trunk(const void* crops, const void* weights,
                                 void* out, int n, int net, int bf16_path,
                                 void* stream) {
  if (n <= 0) return 0;
  if (net != 0 && net != 1) return (int)cudaErrorInvalidValue;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  // (S, C2, crops per group, pooled rows per band, [m-tiles and] n-tiles
  // per conv2 item): ops/crops_net.py specs
  if (bf16_path)
    return net == 0 ? launch_mma<24, 48, 4, 2, 6>(crops, weights, out, n, st)
                    : launch_mma<48, 64, 1, 2, 4>(crops, weights, out, n, st);
  return net == 0
             ? launch_tf32x3<24, 48, 4, 2, 1, 2>(crops, weights, out, n, st)
             : launch_tf32x3<48, 64, 1, 2, 2, 4>(crops, weights, out, n, st);
}
