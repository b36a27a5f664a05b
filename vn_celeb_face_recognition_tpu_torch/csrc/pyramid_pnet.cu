// K2: the area-resize pyramid and MTCNN stage 1 (PNet) on every level of
// every frame, one launch, read from the chunk's integral image.
//
// Replaces the TPU kernel
// vn_celeb_face_recognition_tpu/ops/pyramid_pnet_pallas.py
// (pyramid_pnet: its phase_pyramid feed and _pnet_kernel). Function:
// frames [B, H, W, 3] -> per pyramid level (oh, ow) the PNet maps
// p(face) [B, hc, wc] and box offsets [B, hc, wc, 4], in the detector's
// compute dtype. A level pixel is the mean of one integer rectangle of
// the frame, rows [floor(o*H/oh), ceil((o+1)*H/oh)) and the same for the
// columns (torch's adaptive_avg_pool2d, ops/image._area_weights): the
// kernel reads it as four corners of the chunk's int32 integral image
// (K4 builds it once per chunk; modulo 2^32, the corner difference taken
// in uint32 is the true sum) divided by the window's area with one f32
// division, normalises it, (x - 127.5) * 0.0078125, and runs per output
// tile: conv 3x3 3->10 + PReLU + 2x2/2 ceil-mode max pool; conv 3x3
// 10->16 + PReLU; conv 3x3 16->32 + PReLU; the 1x1 heads giving
// p(face) = sigmoid(l1 - l0) and 4 box offsets. No level is ever written
// to device memory.
//
// Two grids, one launch either way:
// * pnet_frames_mma (bf16 detectors): the normalised level pixel, conv1 +
//   PReLU + pool and conv2 + PReLU are rounded to bf16, as the JAX kernel
//   at dtype=bf16 rounds its GEMM operands; conv1 (K = 27 as 9 taps x 4
//   channels, padded to 48, N = 10 padded to 16, its f32 weights split
//   into bf16 hi + lo: two products), conv2 (K = 90 padded to 96, N = 16)
//   and conv3 (K = 144, N = 32) run as implicit GEMMs on
//   mma.sync.m16n8k16 with f32 sums; the bias, PReLU, the pool (in
//   registers: a lane holds the four sub-positions of its pool cell), the
//   heads and the softmax stay f32 on the CUDA cores.
// * pnet_frames_f32 (f32 detectors): every step in f32 FMAs on the CUDA
//   cores, register-tiled (3-4 pixels x 8 channels a thread).
//
// Bound on the H100: the bf16 grid by bytes (the integral image read
// once, 20 B written per output cell: ~0.24 ms for the stock line's 128
// frames, 11 levels from 385 px, against ~0.13 ms of bf16 FLOPs); the f32
// grid by operations (~2.0 ms of f32 FLOPs there).
//
// Design: one block of 256 threads per 16x16 tile of PNet output cells,
// all levels and frames in one 1-D grid ordered frame-major (every tile
// of frame b before frame b + 1), so one frame's integral image (4.9 MB
// at 640x640) stays in the 50 MB L2 while its tiles read it. The block
// computes the windows of its 42 level rows and columns with integer
// arithmetic, stages the 42x42x3 normalised tile in shared memory (12
// corner reads a pixel), writes conv1 + PReLU + pool (20x20x10) and conv2
// (18x18x16, over the dead input tile) to shared memory, and keeps conv3
// in registers. The level table and the 584 small parameters (conv1,
// every bias, slope and head weight) travel in the kernel's parameters
// (constant bank, broadcast to a warp); the convolutions' weights are
// staged per block in shared memory: f32 [ci][ky][kx][co] for the f32
// grid, bf16 K-major rows [co][k] for ldmatrix in the bf16 grid (with a
// copy of the small parameters, read there at lane-dependent channels). Pool positions past
// the conv1 edge of an odd-sided level are excluded (-inf), as torch's
// ceil-mode pool does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "launch.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 16;
constexpr int kIn = 2 * kTile + 10;  // 42 input rows/cols
constexpr int kPool = kTile + 4;     // 20 pooled rows/cols
constexpr int kC2 = kTile + 2;       // 18 conv2 rows/cols
constexpr int kThreads = kTile * kTile;
constexpr int kMaxLevels = 32;
constexpr int kTab = 8;  // level table row, see Params

// the small parameters (ops/pyramid_pnet.pack_weights[:584])
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
constexpr int kNConst = 584;
// f32 grid: conv2 [10, 3, 3, 16] and conv3 [16, 3, 3, 32] (I, H, W, O)
constexpr int kW2 = 0;
constexpr int kW3 = 1440;
constexpr int kNShared = 6048;
// bf16 grid, one byte buffer: conv1's weights split into bf16 hi and lo
// rows [16][kK1P] over k = (ky*3 + kx)*4 + ci (ci 3 and k >= 36 zero),
// w2 rows [16][kK2P] bf16 over k = (ky*3 + kx)*10 + ci (90 used), w3
// rows [32][kK3P] bf16 over k = (ky*3 + kx)*16 + ci (pads zero), then the
// 584 small parameters in f32, which the epilogues read at lane-dependent
// channels (from shared memory: the constant bank would serialise them)
constexpr int kK1 = 48, kK1P = 56, kK2 = 96, kK2P = 104, kK3 = 144,
              kK3P = 152;
constexpr int kMmaW1 = 16 * kK1P;  // bf16 elements, each of hi and lo
constexpr int kMmaW2 = 16 * kK2P, kMmaW3 = 32 * kK3P;
constexpr int kMmaWBytes =
    (2 * kMmaW1 + kMmaW2 + kMmaW3) * 2 + kNConst * 4;  // 18976
constexpr int kC2P = 24;  // conv2 map pitch a position (bf16): 48 bytes
constexpr int kM2 = kC2 * kC2;          // 324 conv2 positions
constexpr int kM2Tiles = (kM2 + 15) / 16;  // 21

// shared memory: the window table, then per grid
constexpr int kWinBytes = 4 * kIn * 4;          // 672
constexpr int kInSize = 3 * kIn * kIn;          // 5292 floats
constexpr int kPoolSize = 10 * kPool * kPool;   // 4000
constexpr int kSmemF32 = kWinBytes + (kInSize + kPoolSize + kNShared) * 4;
constexpr int kPoolBf16Bytes = kPool * kPool * 10 * 2;  // 8000
constexpr int kIn16Bytes = kIn * kIn * 4 * 2;       // bf16 [pos][4]: 14112
constexpr int kC2Bytes = kC2 * kC2 * kC2P * 2;      // 15552
constexpr int kRegionMma = kC2Bytes > kIn16Bytes ? kC2Bytes : kIn16Bytes;
constexpr int kSmemMma = kWinBytes + kMmaWBytes + kRegionMma +
                         kPoolBf16Bytes;

// Level table row: oh, ow, hc, wc, tiles_x, first tile within a frame,
// first output cell of the level ([B, hc, wc] blocks, level after level),
// unused.
struct Params {
  float cw[kNConst];
  int lv[kMaxLevels][kTab];
  int n_levels, tiles_per_frame, h, w;
};

struct Tile {
  int b, l, cy0, cx0;
};

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : v * a;
}

__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// this block's frame, level and first output cell (frame-major order)
__device__ __forceinline__ Tile locate(const Params& p) {
  Tile t;
  const int i = blockIdx.x;
  t.b = i / p.tiles_per_frame;
  const int r = i - t.b * p.tiles_per_frame;
  int l = 0;
  while (l + 1 < p.n_levels && p.lv[l + 1][5] <= r) ++l;
  t.l = l;
  const int local = r - p.lv[l][5], tiles_x = p.lv[l][4];
  t.cy0 = (local / tiles_x) * kTile;
  t.cx0 = (local % tiles_x) * kTile;
  return t;
}

// The tile's 42x42x3 normalised level pixels, each from four corners of
// the frame's integral image (zero outside the level), into s_in: f32
// [c][y][x], or with kMma bf16 [y*42 + x][4] (rounded; channel 3 zero).
// Ends with a barrier.
// the normalised level pixel (y, x) of the tile, channel c: the mean of
// its window, four corners of the integral image `im` (one frame, `row`
// entries a row), their difference modulo 2^32 and one f32 division
__device__ __forceinline__ float level_pixel(const uint32_t* __restrict__ im,
                                            size_t row, const int* s_win,
                                            int y, int x, int c) {
  const int y0 = s_win[y], y1 = s_win[kIn + y];
  const int x0 = s_win[2 * kIn + x], x1 = s_win[3 * kIn + x];
  const uint32_t* r0 = im + (size_t)y0 * row + c;
  const uint32_t* r1 = im + (size_t)y1 * row + c;
  const uint32_t sum = __ldg(r1 + x1 * 3) - __ldg(r0 + x1 * 3) -
                       __ldg(r1 + x0 * 3) + __ldg(r0 + x0 * 3);
  const float mean = __fdiv_rn(__int2float_rn((int)sum),
                               __int2float_rn((y1 - y0) * (x1 - x0)));
  return __fmul_rn(__fsub_rn(mean, 127.5f), 0.0078125f);
}

template <bool kMma>
__device__ __forceinline__ void stage_tile(const Params& p, const Tile& t,
                                           const int32_t* __restrict__ integ,
                                           int* s_win, void* s_in) {
  const int oh = p.lv[t.l][0], ow = p.lv[t.l][1];
  const int iy0 = 2 * t.cy0, ix0 = 2 * t.cx0;
  // windows [p0, p1) of the tile's rows and [q0, q1) of its columns:
  // s_win = p0[42], p1[42], q0[42], q1[42]
  if (threadIdx.x < 2 * kIn) {
    const bool col = threadIdx.x >= kIn;
    const int i = col ? threadIdx.x - kIn : threadIdx.x;
    const unsigned o = (unsigned)((col ? ix0 : iy0) + i);
    const unsigned in = col ? p.w : p.h, out = col ? ow : oh;
    unsigned a = 0, e = 0;
    if (o < out) {
      a = o * in / out;
      e = ((o + 1) * in + out - 1) / out;  // ceil
      e = min(max(e, a + 1), in);
    }
    s_win[(col ? 2 : 0) * kIn + i] = (int)a;
    s_win[(col ? 3 : 1) * kIn + i] = (int)e;
  }
  __syncthreads();
  const size_t row = (size_t)(p.w + 1) * 3;
  const uint32_t* im = reinterpret_cast<const uint32_t*>(integ) +
                       (size_t)t.b * (p.h + 1) * row;
  // a pixel a thread, its twelve corner loads in flight together
  for (int pix = threadIdx.x; pix < kIn * kIn; pix += kThreads) {
    const int y = pix / kIn, x = pix - y * kIn;
    const bool in = iy0 + y < oh && ix0 + x < ow;
    float v[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c] = in ? level_pixel(im, row, s_win, y, x, c) : 0.f;
    if (kMma) {
      bf16* dst = reinterpret_cast<bf16*>(s_in) + pix * 4;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[c] = __float2bfloat16_rn(v[c]);
      dst[3] = __float2bfloat16_rn(0.f);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        reinterpret_cast<float*>(s_in)[(c * kIn + y) * kIn + x] = v[c];
    }
  }
  __syncthreads();
}

// conv1 + PReLU + ceil-mode 2x2/2 max pool, one pooled cell per thread,
// f32, into f32 [co][y][x]. Ends with a barrier.
__device__ __forceinline__ void conv1_pool(const Params& p, const Tile& t,
                                           const float* s_in, float* pool) {
  const int h1 = p.lv[t.l][0] - 2, w1 = p.lv[t.l][1] - 2;  // conv1 size
  const int iy0 = 2 * t.cy0, ix0 = 2 * t.cx0;
  for (int q0 = threadIdx.x; q0 < kPool * kPool; q0 += kThreads) {
    const int py = q0 / kPool, px = q0 - (q0 / kPool) * kPool;
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
      for (int co = 0; co < 10; ++co) acc[co] = p.cw[kB1 + co];
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float v = s_in[(ci * kIn + ly + ky) * kIn + lx + kx];
#pragma unroll
            for (int co = 0; co < 10; ++co)
              acc[co] += p.cw[kW1 + ((co * 3 + ci) * 3 + ky) * 3 + kx] * v;
          }
#pragma unroll
      for (int co = 0; co < 10; ++co)
        best[co] = fmaxf(best[co], prelu(acc[co], p.cw[kA1 + co]));
    }
    // a pooled cell with no valid position lies outside the level and is
    // never read by a valid output cell; store 0 rather than -inf
#pragma unroll
    for (int co = 0; co < 10; ++co)
      pool[(co * kPool + py) * kPool + px] = any ? best[co] : 0.f;
  }
  __syncthreads();
}

// conv1 + PReLU + ceil-mode 2x2/2 max pool on the tensor cores, into the
// bf16 pool map [pos][10]: an implicit GEMM, K = (ky*3 + kx)*4 + ci (36,
// padded to 48), N = 10 (padded to 16), B split into bf16 hi + lo rows (so
// the products keep conv1's f32 weights: A is exact in bf16). The M rows
// are ordered so that a lane pools in its registers: group g of 8 pool
// cells is two m16 tiles, T = 0 with rows r (sub-position (0, 0) of cell
// 8g + r) and r + 8 (sub-position (0, 1)), T = 1 with (1, 0) and (1, 1).
// Ends with a barrier.
__device__ __forceinline__ void conv1_pool_mma(const Params& p,
                                               const Tile& t,
                                               const bf16* s_in,
                                               const bf16* s_w1,
                                               const float* s_cw,
                                               bf16* pool) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int h1 = p.lv[t.l][0] - 2, w1 = p.lv[t.l][1] - 2;  // conv1 size
  const int iy0 = 2 * t.cy0, ix0 = 2 * t.cx0;
  // this lane's A columns k = s*16 + 2t (+8): s_in offset of (tap, ci)
  // from a position's first channel; -1 past the 9 taps
  int koff[3][2];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      const int k = s * 16 + 2 * tq + 8 * hk, tap = k / 4;
      koff[s][hk] = tap < 9 ? ((tap / 3) * kIn + tap % 3) * 4 + k % 4 : -1;
    }
  float bias[2][2], slope[2][2];  // channels j*8 + 2t + e
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = min(j * 8 + 2 * tq + e, 9);
      bias[j][e] = s_cw[kB1 + c];
      slope[j][e] = s_cw[kA1 + c];
    }
  const bf16* brow =
      s_w1 + (8 * (lane >> 4) + (lane & 7)) * kK1P + 8 * ((lane >> 3) & 1);
  for (int g = warp; g < kPool * kPool / 8; g += kThreads / 32) {
    const int cell = 8 * g + gq, py = cell / kPool, px = cell % kPool;
    float acc[2][2][4] = {};  // [T][n-tile][fragment]
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      unsigned bh[4], bl[4];
      ldsm_x4(bh, brow + s * 16);
      ldsm_x4(bl, brow + kMmaW1 + s * 16);
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        unsigned a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int off = koff[s][q >> 1];
          const int pos = (2 * py + tt) * kIn + 2 * px + (q & 1);
          a[q] = off >= 0 ? *reinterpret_cast<const unsigned*>(
                                s_in + pos * 4 + off)
                          : 0u;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[tt][j], a, bh[2 * j], bh[2 * j + 1]);
          mma_bf16(acc[tt][j], a, bl[2 * j], bl[2 * j + 1]);
        }
      }
    }
    // bias + PReLU, then the max over the sub-positions inside the conv1
    // map (a pooled cell with none lies outside the level and is never
    // read by a valid output cell: 0 rather than -inf)
    bool ok[2][2];
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ok[tt][h] = iy0 + 2 * py + tt < h1 && ix0 + 2 * px + h < w1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float best[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        best[e] = -INFINITY;
#pragma unroll
        for (int tt = 0; tt < 2; ++tt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (ok[tt][h])
              best[e] = fmaxf(best[e], prelu(acc[tt][j][2 * h + e] +
                                                 bias[j][e],
                                             slope[j][e]));
      }
      const int c = j * 8 + 2 * tq;
      if (c < 10)
        *reinterpret_cast<unsigned*>(pool + cell * 10 + c) =
            ok[0][0] ? pack2f(best[0], best[1]) : 0u;
    }
  }
  __syncthreads();
}

// the index of the tile's output cell (y, x) in probs, or -1 when it lies
// outside the level
__device__ __forceinline__ long long cell_index(const Params& p,
                                                const Tile& t, int y, int x) {
  const int hc = p.lv[t.l][2], wc = p.lv[t.l][3];
  const int gy = t.cy0 + y, gx = t.cx0 + x;
  if (gy >= hc || gx >= wc) return -1;
  return (long long)p.lv[t.l][6] + (long long)t.b * hc * wc +
         (long long)gy * wc + gx;
}

__global__ void __launch_bounds__(kThreads)
pnet_frames_f32(const __grid_constant__ Params p,
                const int32_t* __restrict__ integ,
                const float* __restrict__ w_shared,
                float* __restrict__ probs, float* __restrict__ reg) {
  extern __shared__ __align__(16) float smem[];
  int* s_win = reinterpret_cast<int*>(smem);
  float* s_in = smem + kWinBytes / 4;  // input tile, then conv2 output
  float* s_pool = s_in + kInSize;
  float* s_w = s_pool + kPoolSize;
  const Tile t = locate(p);
  {
    const float4* src = reinterpret_cast<const float4*>(w_shared);
    float4* dst = reinterpret_cast<float4*>(s_w);
    for (int i = threadIdx.x; i < kNShared / 4; i += kThreads)
      dst[i] = __ldg(src + i);
  }
  stage_tile<false>(p, t, integ, s_win, s_in);
  conv1_pool(p, t, s_in, s_pool);

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
        const float bias = p.cw[kB2 + cg * 8 + c];
#pragma unroll
        for (int q = 0; q < 3; ++q) acc[q][c] = bias;
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
            for (int q = 0; q < 3; ++q)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[q][c] += in[q + kx] * w[c];
          }
        }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int co = cg * 8 + c;
        const float a = p.cw[kA2 + co];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          s_c2[(co * kC2 + y) * kC2 + x0 + q] = prelu(acc[q][c], a);
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
    const float bias = p.cw[kB3 + cg * 8 + c];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q][c] = bias;
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
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[q][c] += in[q + kx] * w[c];
      }
    }

  // heads, partial sums over this thread's 8 channels
  float part[4][6];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 6; ++j) part[q][j] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int co = cg * 8 + c;
    const float a = p.cw[kA3 + co];
    const float h0 = p.cw[kW41 + co], h1w = p.cw[kW41 + 32 + co];
    float hr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) hr[j] = p.cw[kW42 + j * 32 + co];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = prelu(acc[q][c], a);
      part[q][0] += h0 * v;
      part[q][1] += h1w * v;
#pragma unroll
      for (int j = 0; j < 4; ++j) part[q][2 + j] += hr[j] * v;
    }
  }
  __syncthreads();  // every conv3 read of s_c2 is done
  float* s_part = s_in;  // [6 outputs][4 channel groups][256 cells]
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      s_part[(j * 4 + cg) * kThreads + y * kTile + x0 + q] = part[q][j];
  __syncthreads();

  // one output cell per thread: add the channel groups, write
  float o[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = j < 2 ? p.cw[kB41 + j] : p.cw[kB42 + j - 2];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      s += s_part[(j * 4 + g) * kThreads + threadIdx.x];
    o[j] = s;
  }
  const long long cell =
      cell_index(p, t, threadIdx.x / kTile, threadIdx.x % kTile);
  if (cell < 0) return;
  probs[cell] = 1.f / (1.f + expf(o[0] - o[1]));  // softmax(.)[1]
#pragma unroll
  for (int j = 0; j < 4; ++j) reg[cell * 4 + j] = o[2 + j];
}

__global__ void __launch_bounds__(kThreads, 4)
pnet_frames_mma(const __grid_constant__ Params p,
                const int32_t* __restrict__ integ,
                const uint4* __restrict__ w_mma, float* __restrict__ probs,
                float* __restrict__ reg) {
  extern __shared__ __align__(16) uint8_t smem_b[];
  int* s_win = reinterpret_cast<int*>(smem_b);
  bf16* s_w1 = reinterpret_cast<bf16*>(smem_b + kWinBytes);  // hi, lo
  bf16* s_w2 = s_w1 + 2 * kMmaW1;
  bf16* s_w3 = s_w2 + kMmaW2;
  const float* s_cw = reinterpret_cast<const float*>(s_w3 + kMmaW3);
  bf16* s_in = reinterpret_cast<bf16*>(smem_b + kWinBytes + kMmaWBytes);
  bf16* s_c2 = s_in;  // the conv2 map, after conv1
  bf16* s_pool = reinterpret_cast<bf16*>(smem_b + kWinBytes + kMmaWBytes +
                                         kRegionMma);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma fragment row / column pair

  for (int i = tid; i < kMmaWBytes / 16; i += kThreads)
    cp_async16(reinterpret_cast<uint4*>(s_w1) + i, w_mma + i);
  cp_async_commit();
  const Tile t = locate(p);
  stage_tile<true>(p, t, integ, s_win, s_in);
  cp_async_wait_all();
  __syncthreads();
  conv1_pool_mma(p, t, s_in, s_w1, s_cw, s_pool);

  // ---- conv2 + PReLU: implicit GEMM, M = 324 positions (y*18 + x),
  // K = (ky*3 + kx)*10 + ci (90, padded to 96), N = 16 ----
  {
    // this lane's A columns k = s*16 + 2t (+8): pool-map offset of (tap,
    // ci) from a position's first channel; -1 in the padding
    int koff[6][2];
#pragma unroll
    for (int s = 0; s < 6; ++s)
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        const int k = s * 16 + 2 * tq + 8 * hk;
        const int tap = k / 10, ci = k % 10;
        koff[s][hk] = k < 90 ? ((tap / 3) * kPool + tap % 3) * 10 + ci : -1;
      }
    float b2r[2][2], a2r[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        b2r[j][e] = s_cw[kB2 + j * 8 + 2 * tq + e];
        a2r[j][e] = s_cw[kA2 + j * 8 + 2 * tq + e];
      }
    const bf16* brow =
        s_w2 + (8 * (lane >> 4) + (lane & 7)) * kK2P + 8 * ((lane >> 3) & 1);
    for (int mt = warp; mt < kM2Tiles; mt += kThreads / 32) {
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(mt * 16 + gq + 8 * h, kM2 - 1);
        base[h] = ((m / kC2) * kPool + m % kC2) * 10;
      }
      float acc[2][4] = {};
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        unsigned a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int off = koff[s][q >> 1];
          a[q] = off >= 0 ? *reinterpret_cast<const unsigned*>(
                                s_pool + base[q & 1] + off)
                          : 0u;
        }
        unsigned b[4];
        ldsm_x4(b, brow + s * 16);
        mma_bf16(acc[0], a, b[0], b[1]);
        mma_bf16(acc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + gq + 8 * h;
        if (m >= kM2) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<unsigned*>(s_c2 + m * kC2P + j * 8 + 2 * tq) =
              pack2f(prelu(acc[j][2 * h] + b2r[j][0], a2r[j][0]),
                     prelu(acc[j][2 * h + 1] + b2r[j][1], a2r[j][1]));
      }
    }
  }
  __syncthreads();

  // ---- conv3 + PReLU: implicit GEMM, M = 256 cells (an m16 tile is one
  // output row), K = (ky*3 + kx)*16 + ci = 144 (a k16 step is one tap),
  // N = 32; warp w takes output rows 2w and 2w + 1, one at a time ----
  const int ax = (lane & 7) + 8 * ((lane >> 3) & 1);  // ldmatrix row
  const bf16* brow =
      s_w3 + (8 * (lane >> 4) + (lane & 7)) * kK3P + 8 * ((lane >> 3) & 1);
  for (int i = 0; i < 2; ++i) {
    const int y = 2 * warp + i;
    float acc[4][4] = {};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      unsigned b[2][4], a[4];
      ldsm_x4(b[0], brow + tap * 16);
      ldsm_x4(b[1], brow + 16 * kK3P + tap * 16);
      ldsm_x4(a, s_c2 + ((y + ky) * kC2 + ax + kx) * kC2P + 8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[j], a, b[j >> 1][2 * (j & 1)],
                 b[j >> 1][2 * (j & 1) + 1]);
    }
    // epilogue: bias + PReLU, the heads over this lane's 8 channels
    // (j*8 + 2t, +1: each parameter pair one 8-byte load, for both rows),
    // summed over the quad; lane t writes box offset t
    float o[2][6] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j * 8 + 2 * tq;
      const float2 bb = *reinterpret_cast<const float2*>(s_cw + kB3 + c);
      const float2 aa = *reinterpret_cast<const float2*>(s_cw + kA3 + c);
      float2 wh[6];
#pragma unroll
      for (int r = 0; r < 6; ++r)
        wh[r] = *reinterpret_cast<const float2*>(
            s_cw + (r < 2 ? kW41 + r * 32 : kW42 + (r - 2) * 32) + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = prelu(acc[j][2 * h] + bb.x, aa.x);
        const float v1 = prelu(acc[j][2 * h + 1] + bb.y, aa.y);
#pragma unroll
        for (int r = 0; r < 6; ++r) o[h][r] += wh[r].x * v0 + wh[r].y * v1;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        o[h][r] += __shfl_xor_sync(0xffffffffu, o[h][r], 1);
        o[h][r] += __shfl_xor_sync(0xffffffffu, o[h][r], 2);
        o[h][r] += r < 2 ? p.cw[kB41 + r] : p.cw[kB42 + r - 2];
      }
      const long long cell = cell_index(p, t, y, gq + 8 * h);
      if (cell < 0) continue;
      if (tq == 0) probs[cell] = 1.f / (1.f + expf(o[h][0] - o[h][1]));
      reg[cell * 4 + tq] = tq == 0 ? o[h][2]
                                   : (tq == 1 ? o[h][3]
                                              : (tq == 2 ? o[h][4] : o[h][5]));
    }
  }
}

}  // namespace

// integ: the chunk's [b, h+1, w+1, 3] int32 integral image (K4); cw: the
// 584 small parameters (pack_weights[:584]) and table: [n_levels, 8]
// int32 level rows, both in HOST memory (they travel in the kernel's
// parameters); weights on the device, 16-byte aligned: the f32 grid's
// conv2/conv3 (pack_weights[584:]) or, with mma, the bf16 grid's byte
// buffer (pack_weights_mma); probs: [sum B*hc*wc] f32; reg: [sum B*hc*wc, 4]
// f32. One launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int vn_pyramid_pnet(const int32_t* integ, const float* cw,
                               const int* table, const void* weights,
                               float* probs, float* reg, int b, int h, int w,
                               int n_levels, int tiles_per_frame, int mma,
                               void* stream) {
  if (b <= 0 || tiles_per_frame <= 0) return 0;
  if (n_levels <= 0 || n_levels > kMaxLevels ||
      (long long)b * tiles_per_frame > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int e = vn_set_device_of(probs);
  if (e != 0) return e;
  Params prm;
  memcpy(prm.cw, cw, sizeof(prm.cw));
  memset(prm.lv, 0, sizeof(prm.lv));
  memcpy(prm.lv, table, sizeof(int) * kTab * n_levels);
  prm.n_levels = n_levels;
  prm.tiles_per_frame = tiles_per_frame;
  prm.h = h;
  prm.w = w;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(b * tiles_per_frame);
  cudaError_t ce;
  if (mma) {
    ce = cudaFuncSetAttribute(pnet_frames_mma,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMma);
    if (ce != cudaSuccess) return (int)ce;
    pnet_frames_mma<<<grid, kThreads, kSmemMma, st>>>(
        prm, integ, reinterpret_cast<const uint4*>(weights), probs, reg);
  } else {
    ce = cudaFuncSetAttribute(pnet_frames_f32,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemF32);
    if (ce != cudaSuccess) return (int)ce;
    pnet_frames_f32<<<grid, kThreads, kSmemF32, st>>>(
        prm, integ, reinterpret_cast<const float*>(weights), probs, reg);
  }
  return (int)cudaGetLastError();
}

static_assert(kNConst + kNShared == 6632, "PNet has 6632 weights");
static_assert(kWinBytes % 16 == 0 && kMmaWBytes % 16 == 0 &&
                  (kInSize * 4) % 16 == 0,
              "16-byte alignment of the shared-memory regions");
static_assert(6 * 4 * kThreads <= kInSize + kPoolSize,
              "head partials fit the input tile and the pool map");
static_assert(16 * kC2 * kC2 <= kInSize, "conv2 map fits the input buffer");
static_assert(kRegionMma % 16 == 0 && kMmaW1 * 2 % 16 == 0,
              "16-byte alignment of the bf16 grid's regions");
static_assert((kWinBytes + (2 * kMmaW1 + kMmaW2 + kMmaW3) * 2) % 8 == 0 &&
                  kB3 % 2 == 0 && kA3 % 2 == 0 && kW41 % 2 == 0 &&
                  kW42 % 2 == 0,
              "8-byte parameter pairs in shared memory");
static_assert(kK1 >= 36 && kK1 % 16 == 0, "conv1's GEMM depth");
static_assert(sizeof(Params) + 64 <= 4096, "kernel parameters fit 4 KB");
static_assert(kK2 >= 90 && kK2 % 16 == 0 && kK3 == 9 * 16, "GEMM depths");
