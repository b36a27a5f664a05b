// K2: MTCNN stage 1 (PNet) on every pyramid level of every frame, one
// launch.
//
// Replaces the TPU kernel
// vn_celeb_face_recognition_tpu/ops/pyramid_pnet_pallas.py
// (pyramid_pnet / _pnet_kernel). As there, the area-resize pyramid stays
// outside the kernel (plain matmuls); the kernel takes every level of
// every frame packed into one f32 buffer and runs, per output tile:
// normalise (x - 127.5) * 0.0078125; conv 3x3 3->10 + PReLU + 2x2/2
// ceil-mode max pool; conv 3x3 10->16 + PReLU; conv 3x3 16->32 + PReLU;
// the 1x1 heads giving p(face) = sigmoid(l1 - l0) and 4 box offsets.
// It computes in f32 whatever the detector's compute dtype.
//
// Bound on the H100: latency and on-chip bandwidth, not FLOPs or device
// memory. A 64-frame 640x640 chunk is ~11 GFLOP of useful work over
// ~37 MB of level input, spread over 8 levels from 154 to 14 px;
// per-level cuDNN convolutions with 10-32 channels make 5 passes over
// device memory per level and dozens of small launches.
//
// Design: one block of 256 threads per 16x16 tile of PNet output cells,
// all levels and frames in one 1-D grid (a small device table maps a
// block to its level, frame and tile). Activations never reach device
// memory: the block stages its 42x42x3 input tile in shared memory,
// writes conv1+PReLU+pool (20x20x10) and conv2 (18x18x16, reusing the
// input buffer) to shared memory, and keeps conv3 in registers; the heads
// are reduced across channel groups through shared memory.
// Weights: conv1 and every bias, slope and head weight (584 floats) sit
// in constant memory, which broadcasts a weight read by a whole warp;
// conv2 and conv3 (6048 floats, too many for the constant cache) are
// copied per block into shared memory as [ci][ky][kx][co], so a thread
// reads 8 output channels' weights with two 16-byte loads. conv2 and
// conv3 are register-tiled: a thread computes 3 or 4 neighbouring
// pixels x 8 channels, reusing each loaded input and weight several
// times. Pool positions past the conv1 edge of an odd-sided level are
// excluded (-inf), as torch's ceil-mode pool does.

#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kIn = 2 * kTile + 10;  // 42 input rows/cols
constexpr int kPool = kTile + 4;     // 20 pooled rows/cols
constexpr int kC2 = kTile + 2;       // 18 conv2 rows/cols
constexpr int kThreads = kTile * kTile;

// packed weight layout, 6632 floats (ops/pyramid_pnet.pack_weights)
constexpr int kW1 = 0;      // conv1 [10, 3, 3, 3] (OIHW)
constexpr int kB1 = 270;    // [10]
constexpr int kA1 = 280;    // [10]
constexpr int kB2 = 290;    // [16]
constexpr int kA2 = 306;    // [16]
constexpr int kB3 = 322;    // [32]
constexpr int kA3 = 354;    // [32]
constexpr int kW41 = 386;   // [2, 32]
constexpr int kB41 = 450;   // [2]
constexpr int kW42 = 452;   // [4, 32]
constexpr int kB42 = 580;   // [4]
constexpr int kNConst = 584;  // the part held in constant memory
constexpr int kW2 = 0;        // conv2 [10, 3, 3, 16] (I, H, W, O) in s_w
constexpr int kW3 = 1440;     // conv3 [16, 3, 3, 32] (I, H, W, O) in s_w
constexpr int kNShared = 6048;
constexpr int kNW = kNConst + kNShared;

// shared memory (floats): region A = input tile + pool map, later the
// conv2 map and the head partial sums; then the conv2/conv3 weights
constexpr int kInSize = 3 * kIn * kIn;          // 5292
constexpr int kPoolSize = 10 * kPool * kPool;   // 4000
constexpr int kRegionA = kInSize + kPoolSize;   // 9292 (multiple of 4)
constexpr int kSmemBytes = (kRegionA + kNShared) * 4;  // 61360

// level table row: oh, ow, hc, wc, tiles_x, first tile, input offset,
// output cell offset
constexpr int kTab = 8;

__constant__ float c_w[kNConst];

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : v * a;
}

__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__global__ void __launch_bounds__(kThreads)
pnet_chain_kernel(const float* __restrict__ levels,
                  const int* __restrict__ table, int n_levels,
                  const float* __restrict__ w_shared,
                  float* __restrict__ probs, float* __restrict__ reg) {
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;               // input tile, then conv2 output
  float* s_pool = smem + kInSize;
  float* s_w = smem + kRegionA;

  const int t = blockIdx.x;
  int l = 0;
  while (l + 1 < n_levels && table[(l + 1) * kTab + 5] <= t) ++l;
  const int* row = table + l * kTab;
  const int oh = row[0], ow = row[1], hc = row[2], wc = row[3];
  const int tiles_x = row[4];
  const int tiles_y = (hc + kTile - 1) / kTile;
  const int local = t - row[5];
  const int per_img = tiles_x * tiles_y;
  const int b = local / per_img;
  const int r = local - b * per_img;
  const int cy0 = (r / tiles_x) * kTile;  // first output cell of the tile
  const int cx0 = (r % tiles_x) * kTile;
  const int iy0 = 2 * cy0, ix0 = 2 * cx0;  // first input pixel

  {
    const float4* src = reinterpret_cast<const float4*>(w_shared);
    float4* dst = reinterpret_cast<float4*>(s_w);
    for (int i = threadIdx.x; i < kNShared / 4; i += kThreads)
      dst[i] = __ldg(src + i);
  }
  const float* img = levels + (size_t)row[6] + (size_t)b * 3 * oh * ow;
  for (int i = threadIdx.x; i < kInSize; i += kThreads) {
    const int c = i / (kIn * kIn);
    const int rem = i - c * kIn * kIn;
    const int y = rem / kIn, x = rem - (rem / kIn) * kIn;
    const int gy = iy0 + y, gx = ix0 + x;
    float v = 0.f;  // the reference zero-pads the normalised level
    if (gy < oh && gx < ow)
      v = (__ldg(img + ((size_t)c * oh + gy) * ow + gx) - 127.5f) *
          0.0078125f;
    s_in[i] = v;
  }
  __syncthreads();

  // conv1 + PReLU + ceil-mode 2x2/2 max pool, one pooled cell per thread
  const int h1 = oh - 2, w1 = ow - 2;  // conv1 output size
  for (int p = threadIdx.x; p < kPool * kPool; p += kThreads) {
    const int py = p / kPool, px = p - (p / kPool) * kPool;
    float best[10];
#pragma unroll
    for (int co = 0; co < 10; ++co) best[co] = -INFINITY;
    bool any = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ly = 2 * py + (q >> 1), lx = 2 * px + (q & 1);
      if (iy0 + ly >= h1 || ix0 + lx >= w1) continue;  // past the edge
      any = true;
      float acc[10];
#pragma unroll
      for (int co = 0; co < 10; ++co) acc[co] = c_w[kB1 + co];
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float v = s_in[(ci * kIn + ly + ky) * kIn + lx + kx];
#pragma unroll
            for (int co = 0; co < 10; ++co)
              acc[co] += c_w[kW1 + ((co * 3 + ci) * 3 + ky) * 3 + kx] * v;
          }
#pragma unroll
      for (int co = 0; co < 10; ++co)
        best[co] = fmaxf(best[co], prelu(acc[co], c_w[kA1 + co]));
    }
    // a pooled cell with no valid position lies outside the level and is
    // never read by a valid output cell; store 0 rather than -inf
#pragma unroll
    for (int co = 0; co < 10; ++co)
      s_pool[(co * kPool + py) * kPool + px] = any ? best[co] : 0.f;
  }
  __syncthreads();

  // conv2 + PReLU into the (now free) input buffer: a thread computes 3
  // neighbouring pixels x 8 channels; warps 0-3 take channels 0-7,
  // warps 4-7 channels 8-15 (108 pixel groups each)
  float* s_c2 = s_in;
  {
    const int cg = threadIdx.x >> 7;
    const int pg = threadIdx.x & 127;
    if (pg < kC2 * kC2 / 3) {
      const int y = pg / (kC2 / 3), x0 = (pg % (kC2 / 3)) * 3;
      float acc[3][8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float bias = c_w[kB2 + cg * 8 + c];
#pragma unroll
        for (int p = 0; p < 3; ++p) acc[p][c] = bias;
      }
#pragma unroll 2
      for (int ci = 0; ci < 10; ++ci)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float* src = s_pool + (ci * kPool + y + ky) * kPool + x0;
          float in[5];
#pragma unroll
          for (int j = 0; j < 5; ++j) in[j] = src[j];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            float w[8];
            load8(s_w + kW2 + ((ci * 3 + ky) * 3 + kx) * 16 + cg * 8, w);
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[p][c] += in[p + kx] * w[c];
          }
        }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int co = cg * 8 + c;
        const float a = c_w[kA2 + co];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          s_c2[(co * kC2 + y) * kC2 + x0 + p] = prelu(acc[p][c], a);
      }
    }
  }
  __syncthreads();

  // conv3 + PReLU: a thread computes 4 neighbouring cells x 8 channels;
  // warps 2g and 2g+1 take channels 8g..8g+7
  const int cg = threadIdx.x >> 6;
  const int pg = threadIdx.x & 63;
  const int y = pg >> 2, x0 = (pg & 3) * 4;
  float acc[4][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float bias = c_w[kB3 + cg * 8 + c];
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[p][c] = bias;
  }
#pragma unroll 2
  for (int ci = 0; ci < 16; ++ci)
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const float* src = s_c2 + (ci * kC2 + y + ky) * kC2 + x0;
      float in[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) in[j] = src[j];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float w[8];
        load8(s_w + kW3 + ((ci * 3 + ky) * 3 + kx) * 32 + cg * 8, w);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[p][c] += in[p + kx] * w[c];
      }
    }

  // heads, partial sums over this thread's 8 channels
  float part[4][6];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 6; ++j) part[p][j] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int co = cg * 8 + c;
    const float a = c_w[kA3 + co];
    const float h0 = c_w[kW41 + co], h1w = c_w[kW41 + 32 + co];
    float hr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) hr[j] = c_w[kW42 + j * 32 + co];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float v = prelu(acc[p][c], a);
      part[p][0] += h0 * v;
      part[p][1] += h1w * v;
#pragma unroll
      for (int j = 0; j < 4; ++j) part[p][2 + j] += hr[j] * v;
    }
  }
  __syncthreads();  // every conv3 read of s_c2 is done
  float* s_part = smem;  // [6 outputs][4 channel groups][256 cells]
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      s_part[(j * 4 + cg) * kThreads + y * kTile + x0 + p] = part[p][j];
  __syncthreads();

  // one output cell per thread: add the channel groups, write
  const int oy = threadIdx.x / kTile, ox = threadIdx.x % kTile;
  const int gy = cy0 + oy, gx = cx0 + ox;
  if (gy >= hc || gx >= wc) return;
  float o[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = j < 2 ? c_w[kB41 + j] : c_w[kB42 + j - 2];
#pragma unroll
    for (int g = 0; g < 4; ++g) s += s_part[(j * 4 + g) * kThreads + threadIdx.x];
    o[j] = s;
  }
  const size_t cell = (size_t)row[7] + (size_t)b * hc * wc +
                      (size_t)gy * wc + gx;
  probs[cell] = 1.f / (1.f + expf(o[0] - o[1]));  // softmax(.)[1]
#pragma unroll
  for (int j = 0; j < 4; ++j) reg[cell * 4 + j] = o[2 + j];
}

}  // namespace

// levels: every level's [B, 3, oh, ow] raw (0-255) planes, packed;
// table: [n_levels, 8] int32 on the device (see kTab); weights: [6632] f32
// on the device in pack_weights order (16-byte aligned); probs:
// [sum B*hc*wc] f32; reg: [sum B*hc*wc, 4] f32.
// The first 584 weights are copied into constant memory on `stream`, so
// calls on one stream are ordered; calls on two streams at once must not
// overlap. Launches without synchronising; returns cudaGetLastError().
extern "C" int vn_pnet_chain(const float* levels, const int* table,
                             const float* weights, float* probs, float* reg,
                             int n_levels, int n_tiles, void* stream) {
  if (n_tiles <= 0) return 0;
  int e = vn_set_device_of(probs);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t ce = cudaFuncSetAttribute(
      pnet_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (ce != cudaSuccess) return (int)ce;
  ce = cudaMemcpyToSymbolAsync(c_w, weights, sizeof(float) * kNConst, 0,
                               cudaMemcpyDeviceToDevice, st);
  if (ce != cudaSuccess) return (int)ce;
  pnet_chain_kernel<<<n_tiles, kThreads, kSmemBytes, st>>>(
      levels, table, n_levels, weights + kNConst, probs, reg);
  return (int)cudaGetLastError();
}

static_assert(kNW == 6632, "PNet has 6632 weights");
static_assert(kRegionA % 4 == 0 && kNConst % 4 == 0, "16-byte alignment");
static_assert(6 * 4 * kThreads <= kRegionA, "head partials fit region A");
static_assert(16 * kC2 * kC2 <= kInSize, "conv2 map fits the input buffer");
