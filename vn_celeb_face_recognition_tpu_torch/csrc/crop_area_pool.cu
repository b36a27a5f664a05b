// K4: exact integer crop + adaptive average pool of many boxes per frame.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/crop_pallas.py
// (grouped_crop_area_resize_pallas). Function: for each box (1-based
// inclusive integer coordinates) of each frame, the crop
// img[y1-1:y2, x1-1:x2] average-pooled to S x S cells as torch's
// adaptive_avg_pool2d does: [B, H, W, 3] uint8 + [B, K, 4] ->
// [B, K, S, S, 3] f32, exact on uint8 pixels.
//
// Design: an int32 integral image and four corner reads per cell, as the
// plain version computes it. vn_integral_image builds the zero-padded
// prefix sums [B, H+1, W+1, 3] in two launches: a row scan (one warp per
// row and channel, warp shuffles over runs of 32 pixels) and a column
// scan (one thread per column and channel, coalesced down the rows). The
// cascade builds it once per chunk and both crop stages read it.
// vn_crop_area_pool then runs one thread block per box; each thread
// takes output cells and sums four int32 corners. The cell bounds are
// computed outside the kernel in f32, as the reference computes them, and
// arrive as int32 tables (clamped to the frame) plus each cell's f32
// extent along each axis. The scans accumulate in uint32, so the prefix
// sums wrap modulo 2^32 on frames of more than 8,421,504 pixels (unsigned
// overflow is defined); the corner difference is taken in uint32 too and
// read back as int32, which is the cell's true sum whenever that fits in
// int32 (a cell of at most 8,421,504 pixels: a 24-cell pool of a whole
// 4032x3024 frame sums at most ~5.4 M). The division by the UNclamped
// cell area wy * wx (at least 1) is one IEEE f32 division, so the result
// is bit-exact. Empty or inverted cells (off-frame boxes) sum to zero.
// The TPU kernel's 0/1-mask GEMMs are not carried over.
//
// Bound on the H100: bytes. Per chunk of 128 640x640 frames the function
// reads 157 MB of frames and writes 226 MB of 24 px crops (K = 256) and
// 453 MB of 48 px crops (K = 128): 0.25 ms. This design also writes and
// reads the 631 MB integral image twice and reads 16 B of it per output
// value.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kCh = 3;

// grid (H, B), block 96: warp c scans channel c of row y of frame b.
__global__ void __launch_bounds__(96)
row_scan_kernel(const uint8_t* __restrict__ frames,
                int32_t* __restrict__ integ, int h, int w) {
  const int y = blockIdx.x, b = blockIdx.y;
  const int c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* src = frames + ((size_t)b * h + y) * w * kCh + c;
  uint32_t* dst = reinterpret_cast<uint32_t*>(integ) +
                  (((size_t)b * (h + 1) + y + 1) * (w + 1)) * kCh + c;
  if (lane == 0) dst[0] = 0;
  uint32_t carry = 0;
  for (int x0 = 0; x0 < w; x0 += 32) {
    const int x = x0 + lane;
    uint32_t v = x < w ? (uint32_t)src[(size_t)x * kCh] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    v += carry;
    if (x < w) dst[(size_t)(x + 1) * kCh] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// grid (ceil((W+1)*3 / 256), B), block 256: one thread per (column,
// channel) accumulates down the rows; row 0 is the zero padding.
__global__ void __launch_bounds__(256)
col_scan_kernel(int32_t* __restrict__ integ, int h, int w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = (w + 1) * kCh;
  if (e >= row) return;
  uint32_t* p = reinterpret_cast<uint32_t*>(integ) +
                (size_t)blockIdx.y * (h + 1) * row + e;
  p[0] = 0;
  uint32_t acc = 0;
  for (int y = 1; y <= h; ++y) {
    acc += p[(size_t)y * row];
    p[(size_t)y * row] = acc;
  }
}

// grid (B * K), block 256: one box per block.
__global__ void __launch_bounds__(256)
crop_pool_kernel(const int32_t* __restrict__ integ,
                 const int32_t* __restrict__ ty0,
                 const int32_t* __restrict__ ty1,
                 const int32_t* __restrict__ tx0,
                 const int32_t* __restrict__ tx1,
                 const float* __restrict__ wy, const float* __restrict__ wx,
                 float* __restrict__ out, int k, int h, int w, int s) {
  const int bk = blockIdx.x;
  const int b = bk / k;
  const int row = (w + 1) * kCh;
  const uint32_t* im =
      reinterpret_cast<const uint32_t*>(integ) + (size_t)b * (h + 1) * row;
  const size_t t0 = (size_t)bk * s;
  float* dst = out + (size_t)bk * s * s * kCh;
  for (int o = threadIdx.x; o < s * s * kCh; o += blockDim.x) {
    const int c = o % kCh;
    const int cell = o / kCh;
    const int oy = cell / s, ox = cell % s;
    const int ya = __ldg(ty0 + t0 + oy), yb = __ldg(ty1 + t0 + oy);
    const int xa = __ldg(tx0 + t0 + ox), xb = __ldg(tx1 + t0 + ox);
    // modulo 2^32, then read as int32 (nvcc converts modulo 2^32)
    const uint32_t wrapped = im[(size_t)yb * row + xb * kCh + c] -
                             im[(size_t)ya * row + xb * kCh + c] -
                             im[(size_t)yb * row + xa * kCh + c] +
                             im[(size_t)ya * row + xa * kCh + c];
    const int sum = (int)wrapped;
    const float norm =
        fmaxf(__fmul_rn(__ldg(wy + t0 + oy), __ldg(wx + t0 + ox)), 1.f);
    dst[o] = __fdiv_rn(__int2float_rn(sum), norm);
  }
}

}  // namespace

// frames [b, h, w, 3] u8 -> integ [b, h+1, w+1, 3] int32 zero-padded
// prefix sums, modulo 2^32. Two launches on `stream` (written to *launches), no
// synchronisation; returns cudaGetLastError().
extern "C" int vn_integral_image(const uint8_t* frames, int32_t* integ,
                                 int b, int h, int w, void* stream,
                                 int* launches) {
  *launches = 0;
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  int e = vn_set_device_of(integ);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  row_scan_kernel<<<dim3(h, b), 96, 0, st>>>(frames, integ, h, w);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  *launches = 1;
  const int row = (w + 1) * kCh;
  col_scan_kernel<<<dim3((row + 255) / 256, b), 256, 0, st>>>(integ, h, w);
  ce = cudaGetLastError();
  if (ce == cudaSuccess) *launches = 2;
  return (int)ce;
}

// integ [b, h+1, w+1, 3] int32; per box and cell: ty0/ty1 [b*k, s] and
// tx0/tx1 [b*k, s] int32 clamped integral-image bounds, wy/wx [b*k, s]
// f32 cell extents -> out [b*k, s, s, 3] f32. One launch on `stream`, no
// synchronisation; returns cudaGetLastError().
extern "C" int vn_crop_area_pool(const int32_t* integ, const int32_t* ty0,
                                 const int32_t* ty1, const int32_t* tx0,
                                 const int32_t* tx1, const float* wy,
                                 const float* wx, float* out, int b, int k,
                                 int h, int w, int s, void* stream) {
  if (b <= 0 || k <= 0) return 0;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  crop_pool_kernel<<<b * k, 256, 0, (cudaStream_t)stream>>>(
      integ, ty0, ty1, tx0, tx1, wy, wx, out, k, h, w, s);
  return (int)cudaGetLastError();
}
