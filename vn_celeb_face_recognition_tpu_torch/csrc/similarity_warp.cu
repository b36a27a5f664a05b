// K1: similarity warp of per-face windows into aligned faces.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/warp_pallas.py
// (batched_similarity_warp_pallas / _warp_kernel). The TPU kernel factors
// the warp into a hat-matrix pre-scale, a quadrant fold and a Paeth
// 3-shear because a TPU core cannot gather; this kernel computes the
// function itself: the exact bilinear warp_affine (cv2 BORDER_CONSTANT,
// zero border per tap, tap validity from the unclipped floor), the same
// arithmetic as ops/image.batched_warp_affine.
//
// Two forms share one kernel, templated on the source type:
//   windows: f32 windows [K, N, N, 3], one per face (the TPU kernel's
//            function);
//   frames:  uint8 frames [B, H, W, 3] with, per face, a frame index and
//            the origin (oy, ox) of its N x N window. The engine uses this
//            form: no [K, N, N, 3] window stack is cut or cast.
// Tap validity comes from the window's bounds, never the frame's, so both
// forms give the same values as "cut the window, cast to f32, warp".
//
// Bound on the H100: memory. Each output pixel reads a 2x2 footprint of
// its window; at the engine's scales (0.4-1.2 of a 224 px window into
// 112 px) the taps touch about half of each window, and windows of one
// frame overlap, so the frames form must read each frame pixel that some
// valid tap reads once, in uint8, and write 512 x 112 x 112 x 3 f32
// (~77 MB); chip_smoke.py counts those pixels from the run's matrices.
// The arithmetic is a few dozen flops per output pixel.
//
// Design: one block of 256 threads per (face, strip of 16 output rows);
// the grid is 1-D (K x strips blocks). Every thread inverts the face's
// matrix (six broadcast loads) and walks the strip's 16 x 16 tiles left
// to right. For each tile it maps the four corner pixels to the bounding
// box of the tile's source footprint, widened by one pixel each side
// against rounding and clipped to the window (NaN corners clip to the
// window's first pixel: fminf/fmaxf drop NaN), and the block copies that
// box, row by row in aligned 16-byte chunks (cp.async; a chunk is copied
// only if it holds a byte of the box's row, so no copy leaves the
// tensor's allocation), into one of two shared-memory buffers: the next
// tile's box is in flight while the current one is sampled. At scale 0.4
// and 45 degrees a box is ~60 x 60 px, 12.5 KB in uint8. Each thread
// computes its sample point with every product and sum rounded on its
// own, in the plain version's order, and reads its four taps from the
// buffer; a valid tap outside the box (never seen at the engine's
// scales) or a box larger than a buffer (uint8: a face downscaled below
// ~0.37 at 45 degrees; or a degenerate matrix) reads device memory. A warp's 32 pixels
// are two 16-pixel runs of output rows (2 x 192 contiguous bytes): they
// are staged in shared memory and leave as 16-byte stores.
// Registers and occupancy (-Xptxas -v, sm_90a): 40 registers a thread
// under __launch_bounds__(256, 6), with 28-36 bytes of spills; 31.7 KB
// (uint8) and 48.1 KB (f32) of static shared memory a block, so six
// uint8 blocks (48 warps) or four f32 blocks fit an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int TILE = 16;             // output tile side, one thread a pixel
constexpr int THREADS = TILE * TILE;

// bytes of one of the two stage buffers of a block: a uint8 box up to
// ~68 x 68 px, an f32 box up to ~42 x 42 px (smaller scales read memory)
template <typename T>
struct Stage;
template <>
struct Stage<uint8_t> {
  static constexpr int kBytes = 14 * 1024;
};
template <>
struct Stage<float> {
  static constexpr int kBytes = 22 * 1024;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint8_t v) { return (float)v; }
__device__ __forceinline__ float load_global(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_global(const uint8_t* p) {
  return (float)__ldg(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// src->dst matrix m -> its inverse, in ops/image.invert_affine's order
__device__ __forceinline__ void invert(const float* m, float* inv) {
  const float a = __ldg(m), b = __ldg(m + 1), tx = __ldg(m + 2);
  const float c = __ldg(m + 3), d = __ldg(m + 4), ty = __ldg(m + 5);
  const float det = __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, c));
  const float ia = d / det, ib = -b / det;
  const float ic = -c / det, id = a / det;
  inv[0] = ia;
  inv[1] = ib;
  inv[2] = -__fadd_rn(__fmul_rn(ia, tx), __fmul_rn(ib, ty));
  inv[3] = ic;
  inv[4] = id;
  inv[5] = -__fadd_rn(__fmul_rn(ic, tx), __fmul_rn(id, ty));
}

// the sample point of output pixel (x, y), rounded as the plain version
__device__ __forceinline__ float sample(float i0, float i1, float i2,
                                        float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(i0, x), __fmul_rn(i1, y)), i2);
}

// the staged source box of one output tile (ops/warp.footprint_boxes)
struct Box {
  int y0, x0, y1, x1, pitch;  // y1 = -1 when the box does not fit
  int lead;  // the first row's byte offset in its first 16-byte chunk
};

// the tile's source box, clipped to the window, and its row pitch in
// 16-byte chunks
template <typename T>
__device__ __forceinline__ Box tile_span(const float* inv, int tx0, int ty0,
                                         int s, float hm1) {
  constexpr int V = 16 / (int)sizeof(T);
  const float xa = (float)tx0, xb = (float)(min(tx0 + TILE, s) - 1);
  const float ya = (float)ty0, yb = (float)(min(ty0 + TILE, s) - 1);
  float lo_x = sample(inv[0], inv[1], inv[2], xa, ya), hi_x = lo_x;
  float lo_y = sample(inv[3], inv[4], inv[5], xa, ya), hi_y = lo_y;
  const float cx[3] = {xb, xa, xb}, cy[3] = {ya, yb, yb};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float sx = sample(inv[0], inv[1], inv[2], cx[i], cy[i]);
    const float sy = sample(inv[3], inv[4], inv[5], cx[i], cy[i]);
    lo_x = fminf(lo_x, sx);
    hi_x = fmaxf(hi_x, sx);
    lo_y = fminf(lo_y, sy);
    hi_y = fmaxf(hi_y, sy);
  }
  // taps x0 = floor(sx) and x0 + 1, one pixel of margin each side
  Box b;
  b.x0 = (int)fminf(fmaxf(floorf(lo_x) - 1.f, 0.f), hm1);
  b.x1 = max((int)fminf(fmaxf(floorf(hi_x) + 2.f, 0.f), hm1), b.x0);
  b.y0 = (int)fminf(fmaxf(floorf(lo_y) - 1.f, 0.f), hm1);
  b.y1 = max((int)fminf(fmaxf(floorf(hi_y) + 2.f, 0.f), hm1), b.y0);
  // chunks a row: enough for any alignment, and odd, so that the rows of
  // a rotated footprint spread over the shared-memory banks
  b.pitch = ((b.x1 - b.x0 + 1) * 3 / V + 2) | 1;
  b.lead = 0;
  return b;
}

template <typename T>
__device__ __forceinline__ bool box_fits(const Box& b) {
  return (b.y1 - b.y0 + 1) * b.pitch * 16 <= Stage<T>::kBytes;
}

template <typename T>
__device__ __forceinline__ Box tile_box(const float* inv, const T* base,
                                        size_t row_stride, int tx0, int ty0,
                                        int s, float hm1) {
  Box b = tile_span<T>(inv, tx0, ty0, s, hm1);
  if (!box_fits<T>(b)) b.y1 = -1;
  b.lead = (int)(reinterpret_cast<uintptr_t>(
                     base + (size_t)b.y0 * row_stride + (size_t)b.x0 * 3) &
                 15);
  return b;
}

// row r of a box starts `row_lead` bytes into its first chunk
__device__ __forceinline__ int row_lead(const Box& b, int r, int step) {
  return (b.lead + r * step) & 15;
}

// copy the box's rows, in aligned 16-byte chunks, into `stage`; a chunk is
// copied only if it holds a byte of the row
template <typename T>
__device__ __forceinline__ void stage_box(uint4* stage, const T* base,
                                          size_t row_stride, int step,
                                          const Box& b) {
  const int row_bytes = (b.x1 - b.x0 + 1) * 3 * (int)sizeof(T);
  for (int i = threadIdx.x; i < (b.y1 - b.y0 + 1) * b.pitch; i += THREADS) {
    const int r = i / b.pitch, c = i - r * b.pitch;
    const char* row = reinterpret_cast<const char*>(
        base + (size_t)(b.y0 + r) * row_stride + (size_t)b.x0 * 3);
    const int lead = row_lead(b, r, step);
    if (16 * c < lead + row_bytes) cp_async16(&stage[i], row - lead + 16 * c);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 6)
similarity_warp_kernel(const T* __restrict__ src,
                       const int* __restrict__ image_idx,
                       const int* __restrict__ origin_y,
                       const int* __restrict__ origin_x,
                       const float* __restrict__ mats,
                       float* __restrict__ out, int n_img, int h, int w,
                       int win, int s, int strips) {
  __shared__ uint4 stage[2][Stage<T>::kBytes / 16];
  __shared__ float4 tile_out[THREADS / 32][24];  // a warp's two rows
  const int k = blockIdx.x / strips;
  const int ty0 = (blockIdx.x - k * strips) * TILE;
  const int tid = threadIdx.x;

  // the face's window: frame index and origin, clamped so that every
  // read stays inside the source (the engine's origins already are)
  const int img = image_idx ? min(max(__ldg(image_idx + k), 0), n_img - 1)
                            : k;
  const int oy = origin_y ? min(max(__ldg(origin_y + k), 0), h - win) : 0;
  const int ox = origin_x ? min(max(__ldg(origin_x + k), 0), w - win) : 0;
  const size_t row_stride = (size_t)w * 3;
  const int step = (int)((row_stride * sizeof(T)) & 15);  // lead per row
  const T* base = src + ((size_t)img * h + oy) * row_stride + (size_t)ox * 3;
  const float hm1 = (float)(win - 1), hm2 = (float)(win - 2);
  float inv[6];
  invert(mats + 6 * (size_t)k, inv);

  // the strip's tiles, left to right, the next tile's box in flight
  // while the current one is sampled
  Box cur = tile_box<T>(inv, base, row_stride, 0, ty0, s, hm1);
  stage_box(stage[0], base, row_stride, step, cur);
  const int px_in = tid % TILE, py = ty0 + tid / TILE;
  const int warp = tid / 32, lane = tid % 32, py0w = ty0 + 2 * warp;
  const float fy = (float)py;
  for (int t = 0, tx0 = 0; tx0 < s; ++t, tx0 += TILE) {
    Box nxt = cur;
    if (tx0 + TILE < s) {
      nxt = tile_box<T>(inv, base, row_stride, tx0 + TILE, ty0, s, hm1);
      stage_box(stage[(t + 1) & 1], base, row_stride, step, nxt);
    } else {
      cp_async_commit();  // an empty group keeps the count
    }
    cp_async_wait_one();
    __syncthreads();
    const int px = tx0 + px_in;
    // whole 16-pixel runs whose rows start 16-byte aligned
    const bool vec_out = tx0 + TILE <= s && (s & 3) == 0;
    float res[3] = {0.f, 0.f, 0.f};
    if (px < s && py < s) {
      const uint4* st_buf = stage[t & 1];
      const float fx = (float)px;
      const float sx = sample(inv[0], inv[1], inv[2], fx, fy);
      const float sy = sample(inv[3], inv[4], inv[5], fx, fy);
      const float y0 = floorf(sy), x0 = floorf(sx);
      const float wy = sy - y0, wx = sx - x0;
      const bool vy0 = (y0 >= 0.f) && (y0 <= hm1);
      const bool vy1 = (y0 >= -1.f) && (y0 <= hm2);
      const bool vx0 = (x0 >= 0.f) && (x0 <= hm1);
      const bool vx1 = (x0 >= -1.f) && (x0 <= hm2);
      // fmaxf/fminf map NaN to the bound, so a degenerate matrix still
      // reads in range (its taps are all invalid and the output is NaN,
      // as in the reference)
      const int yi[2] = {(int)fminf(fmaxf(y0, 0.f), hm1),
                         (int)fminf(fmaxf(y0 + 1.f, 0.f), hm1)};
      const int xi[2] = {(int)fminf(fmaxf(x0, 0.f), hm1),
                         (int)fminf(fmaxf(x0 + 1.f, 0.f), hm1)};
      const bool vy[2] = {vy0, vy1}, vx[2] = {vx0, vx1};
      float v[2][2][3];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int y = yi[a];
        const T* grow = base + (size_t)y * row_stride;
        const bool row_in = y >= cur.y0 && y <= cur.y1;
        const T* srow = reinterpret_cast<const T*>(
            reinterpret_cast<const char*>(st_buf + (y - cur.y0) * cur.pitch) +
            row_lead(cur, y - cur.y0, step));
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int x = xi[b];
          const bool ok = vy[a] && vx[b];
          if (ok && row_in && x >= cur.x0 && x <= cur.x1) {
            const T* p = srow + (x - cur.x0) * 3;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) v[a][b][ch] = to_f(p[ch]);
          } else {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              v[a][b][ch] = ok ? load_global(grow + (size_t)x * 3 + ch) : 0.f;
          }
        }
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float top = __fadd_rn(__fmul_rn(v[0][0][ch], 1.f - wx),
                                    __fmul_rn(v[0][1][ch], wx));
        const float bot = __fadd_rn(__fmul_rn(v[1][0][ch], 1.f - wx),
                                    __fmul_rn(v[1][1][ch], wx));
        res[ch] = __fadd_rn(__fmul_rn(top, 1.f - wy), __fmul_rn(bot, wy));
      }
    }
    // a warp holds two 16-pixel runs of output rows: stage them and store
    // 16-byte vectors when the rows allow it, else each pixel's floats
    if (vec_out) {
      float* wbuf = reinterpret_cast<float*>(tile_out[warp]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) wbuf[lane * 3 + ch] = res[ch];
      __syncwarp();
      if (lane < 24 && py0w + lane / 12 < s)
        reinterpret_cast<float4*>(
            out + (((size_t)k * s + py0w + lane / 12) * s + tx0) * 3)
            [lane % 12] = tile_out[warp][lane];
      __syncwarp();
    } else if (px < s && py < s) {
      float* o = out + (((size_t)k * s + py) * s + px) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) o[ch] = res[ch];
    }
    __syncthreads();  // the buffer is refilled two tiles on
    cur = nxt;
  }
}

template <typename T>
int launch(const void* src, const int* image_idx, const int* oy,
           const int* ox, const float* mats, float* out, int k, int n_img,
           int h, int w, int win, int s, cudaStream_t stream) {
  const int strips = (s + TILE - 1) / TILE;
  if ((long long)k * strips > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  similarity_warp_kernel<T><<<k * strips, THREADS, 0, stream>>>(
      static_cast<const T*>(src), image_idx, oy, ox, mats, out, n_img, h, w,
      win, s, strips);
  return (int)cudaGetLastError();
}

// the box rule on its own, one thread per (face, tile): [K, T, T, 5] int32
// (y0, y1, x0, x1, staged), so a check can hold ops/warp.footprint_boxes
// to the kernel's own rule and stage sizes
template <typename T>
__global__ void tile_boxes_kernel(const float* __restrict__ mats,
                                  int* __restrict__ out, int k, int win,
                                  int s) {
  const int t = (s + TILE - 1) / TILE;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)k * t * t) return;
  const int face = (int)(i / (t * t)), tile = (int)(i % (t * t));
  float inv[6];
  invert(mats + 6 * (size_t)face, inv);
  const Box b = tile_span<T>(inv, (tile % t) * TILE, (tile / t) * TILE, s,
                             (float)(win - 1));
  int* o = out + 5 * i;
  o[0] = b.y0;
  o[1] = b.y1;
  o[2] = b.x0;
  o[3] = b.x1;
  o[4] = box_fits<T>(b) ? 1 : 0;
}

}  // namespace

// src: windows [K, N, N, 3] f32 (src_u8 = 0; image_idx, oy, ox null;
// n_img = K, h = w = win = N) or frames [n_img, h, w, 3] uint8 (src_u8 = 1)
// with per-face int32 image_idx, oy, ox [K]; mats [K, 2, 3] f32 -> out
// [K, S, S, 3] f32. Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int vn_similarity_warp(const void* src, int src_u8,
                                  const int* image_idx, const int* oy,
                                  const int* ox, const float* mats,
                                  float* out, int k, int n_img, int h,
                                  int w, int win, int s, void* stream) {
  if (k <= 0) return 0;
  if (win < 2 || win > h || win > w || n_img <= 0)
    return (int)cudaErrorInvalidValue;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (src_u8)
    return launch<uint8_t>(src, image_idx, oy, ox, mats, out, k, n_img, h,
                           w, win, s, st);
  return launch<float>(src, image_idx, oy, ox, mats, out, k, n_img, h, w,
                       win, s, st);
}

// The staged box of every output tile as the kernel computes it, for a
// uint8 (src_u8 = 1) or f32 source: mats [K, 2, 3] f32 -> out
// [K, T, T, 5] int32, T = ceil(S / 16). A check of the box rule, not a
// step of the warp.
extern "C" int vn_similarity_warp_boxes(const float* mats, int src_u8,
                                        int* out, int k, int win, int s,
                                        void* stream) {
  if (k <= 0) return 0;
  if (win < 2 || s <= 0) return (int)cudaErrorInvalidValue;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  const int t = (s + TILE - 1) / TILE;
  const long long n = (long long)k * t * t;
  const int blocks = (int)((n + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  if (src_u8)
    tile_boxes_kernel<uint8_t><<<blocks, 256, 0, st>>>(mats, out, k, win, s);
  else
    tile_boxes_kernel<float><<<blocks, 256, 0, st>>>(mats, out, k, win, s);
  return (int)cudaGetLastError();
}
