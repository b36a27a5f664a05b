// K5: the MTCNN RNet/ONet trunk on batched face crops.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/
// crops_net_pallas.py (crop_net_trunk, used by rnet_apply_fused and
// onet_apply_fused). Function, per normalised crop [S, S, 3] (NHWC):
// conv1 3x3 valid (3 -> C1) + bias + PReLU, max pool 3x3/2 in torch's
// ceil mode, conv2 3x3 valid (C1 -> C2) + bias + PReLU:
//   RNet: [N, 24, 24, 3] -> 22 -> 11 -> [N, 9, 9, 48]   (C1 28, C2 48)
//   ONet: [N, 48, 48, 3] -> 46 -> 23 -> [N, 21, 21, 64] (C1 32, C2 64)
// The TPU kernel's space-to-depth packing and subposition matrix A1 are
// not carried over.
//
// Bound on the H100: per crop the trunk is ~2.7 MFLOP (RNet) and
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
// f32 (the card-vs-CPU gates and the 1e-4 check) stays on the CUDA cores
// with f32 sums, one block per crop: the crop is staged channel-planar,
// conv1 runs in bands of pooled rows into the resident pooled map
// [C1][P][P], and conv2's weights then replace the crop and band buffers
// (ONet in f32 needs 153 KB of shared memory).

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

constexpr int round4(int v) { return (v + 3) / 4 * 4; }
constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// ---------------------------------------------------------------------
// f32: one block per crop on the CUDA cores
// ---------------------------------------------------------------------

template <int S, int C1, int C2, int R, int THREADS>
struct Trunk {
  static constexpr int H1 = S - 2;             // conv1 side
  static constexpr int P = (H1 - 2) / 2 + 1;   // ceil-mode pooled side
  static constexpr int P2 = P - 2;             // conv2 side
  static constexpr int BR = 2 * R + 1 < H1 ? 2 * R + 1 : H1;  // band rows
  static constexpr int kCrop = round4(3 * S * S);
  static constexpr int kBand = round4(BR * C1 * H1);
  static constexpr int kW2 = 9 * C1 * C2;
  static constexpr int kRegionA = kCrop + kBand > kW2 ? kCrop + kBand : kW2;
  static constexpr int kPooled = round4(C1 * P * P);
  // packed weights: w1 [27][C1], b1, a1, w2 [9][C1][C2], b2, a2
  static constexpr int kW1 = 27 * C1;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kRegionA + kPooled + kW1 + 2 * C1 + 2 * C2);
  static_assert(C1 % 4 == 0 && C2 % 16 == 0, "channel blocking");
};

template <int S, int C1, int C2, int R, int THREADS>
__global__ void __launch_bounds__(THREADS)
crop_net_trunk_f32(const float* __restrict__ crops,
                   const float* __restrict__ weights,
                   float* __restrict__ out) {
  using G = Trunk<S, C1, C2, R, THREADS>;
  constexpr int H1 = G::H1, P = G::P, P2 = G::P2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* crop = smem;                       // [3][S][S]
  float* band = smem + G::kCrop;            // [BR][C1][H1]
  float* w2s = smem;                        // [9][C1][C2], after conv1
  float* pooled = smem + G::kRegionA;       // [C1][P][P]
  float* w1s = pooled + G::kPooled;         // [27][C1]
  float* b1s = w1s + G::kW1;
  float* a1s = b1s + C1;
  float* b2s = a1s + C1;
  float* a2s = b2s + C2;

  const int tid = threadIdx.x;
  const size_t n = blockIdx.x;
  const float* src = crops + n * S * S * 3;
  for (int i = tid; i < S * S * 3; i += THREADS) {
    const int c = i % 3, p = i / 3;
    crop[c * S * S + p] = src[i];
  }
  for (int i = tid; i < G::kW1 + 2 * C1; i += THREADS) w1s[i] = weights[i];
  const float* w2g = weights + G::kW1 + 2 * C1;
  for (int i = tid; i < 2 * C2; i += THREADS) b2s[i] = w2g[G::kW2 + i];
  __syncthreads();

  // ---- conv1 + PReLU in bands, each pooled into the resident map ----
  for (int py0 = 0; py0 < P; py0 += R) {
    const int py1 = py0 + R < P ? py0 + R : P;
    const int r0 = 2 * py0;
    const int r1 = 2 * (py1 - 1) + 2 < H1 - 1 ? 2 * (py1 - 1) + 2 : H1 - 1;
    const int rows = r1 - r0 + 1;
    for (int i = tid; i < rows * H1; i += THREADS) {
      const int rr = i / H1, x = i % H1;
      const int y = r0 + rr;
      float acc[C1];
#pragma unroll
      for (int c = 0; c < C1; ++c) acc[c] = b1s[c];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) {
            const float v = crop[ci * S * S + (y + ky) * S + x + kx];
            const float4* w = reinterpret_cast<const float4*>(
                w1s + ((ky * 3 + kx) * 3 + ci) * C1);
#pragma unroll
            for (int c4 = 0; c4 < C1 / 4; ++c4) {
              const float4 wv = w[c4];
              acc[4 * c4] += v * wv.x;
              acc[4 * c4 + 1] += v * wv.y;
              acc[4 * c4 + 2] += v * wv.z;
              acc[4 * c4 + 3] += v * wv.w;
            }
          }
      float* dst = band + rr * C1 * H1 + x;
#pragma unroll
      for (int c = 0; c < C1; ++c) dst[c * H1] = prelu(acc[c], a1s[c]);
    }
    __syncthreads();
    for (int i = tid; i < C1 * (py1 - py0) * P; i += THREADS) {
      const int px = i % P;
      const int py = py0 + (i / P) % (py1 - py0);
      const int c = i / (P * (py1 - py0));
      float m = -INFINITY;
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
        const int y = 2 * py + sy;
        if (y >= H1) break;
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) {
          const int x = 2 * px + sx;
          if (x >= H1) break;
          m = fmaxf(m, band[(y - r0) * C1 * H1 + c * H1 + x]);
        }
      }
      pooled[(c * P + py) * P + px] = m;
    }
    __syncthreads();
  }

  // ---- conv2 + PReLU: the weights replace the crop and band buffers ----
  for (int i = tid; i < G::kW2 / 4; i += THREADS)
    reinterpret_cast<float4*>(w2s)[i] =
        __ldg(reinterpret_cast<const float4*>(w2g) + i);
  __syncthreads();
  constexpr int kPos = P2 * P2;
  float* dst = out + n * kPos * C2;
  for (int i = tid; i < kPos * (C2 / 16); i += THREADS) {
    const int pos = i % kPos, cb = i / kPos;
    const int y = pos / P2, x = pos % P2;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = b2s[cb * 16 + j];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* pin = pooled + (y + ky) * P + x + kx;
        const float* wt = w2s + (ky * 3 + kx) * C1 * C2 + cb * 16;
#pragma unroll 4
        for (int ci = 0; ci < C1; ++ci) {
          const float v = pin[ci * P * P];
          const float4* w = reinterpret_cast<const float4*>(wt + ci * C2);
#pragma unroll
          for (int j4 = 0; j4 < 4; ++j4) {
            const float4 wv = w[j4];
            acc[4 * j4] += v * wv.x;
            acc[4 * j4 + 1] += v * wv.y;
            acc[4 * j4 + 2] += v * wv.z;
            acc[4 * j4 + 3] += v * wv.w;
          }
        }
      }
    float4* o = reinterpret_cast<float4*>(dst + (size_t)pos * C2 + cb * 16);
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4)
      o[j4] = make_float4(prelu(acc[4 * j4], a2s[cb * 16 + 4 * j4]),
                          prelu(acc[4 * j4 + 1], a2s[cb * 16 + 4 * j4 + 1]),
                          prelu(acc[4 * j4 + 2], a2s[cb * 16 + 4 * j4 + 2]),
                          prelu(acc[4 * j4 + 3], a2s[cb * 16 + 4 * j4 + 3]));
  }
}

template <int S, int C1, int C2, int R, int THREADS>
int launch_f32(const void* crops, const void* weights, void* out, int n,
               cudaStream_t stream) {
  using G = Trunk<S, C1, C2, R, THREADS>;
  auto kern = crop_net_trunk_f32<S, C1, C2, R, THREADS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<n, THREADS, G::kSmemBytes, stream>>>(
      static_cast<const float*>(crops), static_cast<const float*>(weights),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

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

template <int S, int C2, int G, int R, int NT>
int launch_mma(const void* crops, const void* weights, void* out, int n,
               cudaStream_t stream) {
  using L = Mma<S, C2, G, R, NT>;
  auto kern = crop_net_trunk_mma<S, C2, G, R, NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    L::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int groups = (n + G - 1) / G;
  const int grid = std::min(groups, std::max(per_sm, 1) * sms);
  kern<<<grid, kThreads, L::kSmemBytes, stream>>>(
      static_cast<const bf16*>(crops), static_cast<const uint8_t*>(weights),
      static_cast<bf16*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

// crops [n, S, S, 3] normalised, f32 or (bf16 = 1) bf16, and weights: f32
// (27*C1 + 2*C1 + 9*C1*C2 + 2*C2 values, ops/crops_net.pack_trunk_weights)
// or, on the bf16 path, the packed buffer of
// ops/crops_net.pack_trunk_weights_mma -> out [n, P2, P2, C2] in the
// crops' type; net 0 is RNet (S 24), 1 is ONet (S 48). One launch on
// `stream`, no synchronisation; returns cudaGetLastError().
extern "C" int vn_crop_net_trunk(const void* crops, const void* weights,
                                 void* out, int n, int net, int bf16_path,
                                 void* stream) {
  if (n <= 0) return 0;
  if (net != 0 && net != 1) return (int)cudaErrorInvalidValue;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  // (S, C2, crops per group, pooled rows per band, n-tiles per item) and
  // (S, C1, C2, pooled rows per band, threads): ops/crops_net.py specs
  if (bf16_path)
    return net == 0 ? launch_mma<24, 48, 4, 2, 6>(crops, weights, out, n, st)
                    : launch_mma<48, 64, 1, 2, 4>(crops, weights, out, n, st);
  return net == 0
             ? launch_f32<24, 28, 48, 11, 256>(crops, weights, out, n, st)
             : launch_f32<48, 32, 64, 4, 512>(crops, weights, out, n, st);
}
