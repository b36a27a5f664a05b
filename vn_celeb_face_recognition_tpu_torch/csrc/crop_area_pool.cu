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
// prefix sums [B, H+1, W+1, 3] in two launches and writes each entry
// once: band_totals_kernel sums each band of kBand rows of a frame down
// its columns (a small [B, bands - 1, W, 3] buffer), then
// band_scan_kernel, one block per (frame, band), takes its carry-in as
// the sum of the band totals above it, walks its rows keeping the column
// running sums in registers (four pixels x 3 channels a thread, 1024
// pixels a pass) and writes each row's prefix along x: a thread's own
// four pixels, a warp-shuffle scan of the thread totals and one
// exchange of the warp totals through shared memory; passes to the right
// of the first add the row's running total of the passes before, kept in
// shared memory; a row's bytes come in, and its entries go out, through
// shared memory, so that device memory sees whole lines. The cascade
// builds it once per chunk; PNet's pyramid (K2) and both crop stages read
// it. vn_crop_area_pool then runs one
// thread per output cell, all three channels: it computes the cell's
// bounds from its box in f32 exactly as the reference does (each product,
// quotient and sum rounded on its own: no contraction), clamps them to
// the frame (an empty or inverted cell sums to zero), reads four corners
// of 12 contiguous bytes and divides by the UNclamped cell area (at least
// 1) with one IEEE f32 division, so the result is bit-exact. The sums
// accumulate in uint32, so the prefix sums wrap modulo 2^32 on frames of
// more than 8,421,504 pixels (unsigned overflow is defined); the corner
// difference is taken in uint32 too and read back as int32, which is the
// cell's true sum whenever that fits in int32 (a cell of at most
// 8,421,504 pixels: a 24-cell pool of a whole 4032x3024 frame sums at
// most ~5.4 M). The TPU kernel's 0/1-mask GEMMs are not carried over.
//
// Bound on the H100: bytes. Per chunk of 128 640x640 frames the function
// reads 157 MB of frames and writes 226 MB of 24 px crops (K = 256) and
// 453 MB of 48 px crops (K = 128): 0.25 ms. This design also writes the
// 631 MB integral image once and reads the frames twice (a floor of
// ~0.28 ms for the image alone), and reads 48 B of it per output cell.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kCh = 3;
constexpr int kBand = 64;     // rows a band
constexpr int kThreads = 256;
constexpr int kPix = 4;       // pixels a thread a pass
constexpr int kPass = kThreads * kPix;  // 1024 pixels a pass

// grid (nt, B), block 256: column totals of band `blockIdx.x` -> totals
// [B, nt, W, 3] uint32, nt = max(bands - 1, 1) (the last band's totals
// are never needed; a one-band frame computes its own all the same).
// Thread t sums the bytes t + 256 k of each 3072-byte pass of a row, so
// a warp's load reads 32 consecutive bytes.
__global__ void __launch_bounds__(kThreads)
band_totals_kernel(const uint8_t* __restrict__ frames,
                   uint32_t* __restrict__ totals, int h, int w) {
  constexpr int kPer = kPass * kCh / kThreads;  // 12 bytes a thread a pass
  const int band = blockIdx.x, b = blockIdx.y;
  const int y0 = band * kBand, y1 = min(y0 + kBand, h);
  const size_t rowb = (size_t)w * kCh;
  const uint8_t* img = frames + (size_t)b * h * rowb;
  uint32_t* dst = totals + ((size_t)b * gridDim.x + band) * rowb;
  for (size_t e0 = 0; e0 < rowb; e0 += kPass * kCh) {
    uint32_t s[kPer] = {};
    for (int y = y0; y < y1; ++y) {
      const uint8_t* src = img + (size_t)y * rowb + e0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const size_t e = e0 + threadIdx.x + k * kThreads;
        if (e < rowb) s[k] += __ldg(src + threadIdx.x + k * kThreads);
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const size_t e = e0 + threadIdx.x + k * kThreads;
      if (e < rowb) dst[e] = s[k];
    }
  }
}

// grid (bands, B), block 256: rows [band * kBand, ...) of frame b's
// integral image, each entry written once; totals [B, nt, W, 3]. Each
// pass of a row comes in through shared memory (a warp's load reads 32
// consecutive bytes; the next row's bytes are loaded while this one is
// scanned) and leaves through it (a warp's store writes 128 consecutive
// bytes).
__global__ void __launch_bounds__(kThreads)
band_scan_kernel(const uint8_t* __restrict__ frames,
                 const uint32_t* __restrict__ totals,
                 int32_t* __restrict__ integ, int h, int w, int nt) {
  constexpr int kPer = kPix * kCh;  // 12 bytes and entries a thread
  __shared__ uint32_t s_warp[kThreads / 32][kCh];
  __shared__ uint32_t s_carry[kBand][kCh];  // row totals of earlier passes
  __shared__ __align__(16) uint8_t s_px[kPass * kCh];
  __shared__ __align__(16) uint32_t s_out[kPass * kCh];
  const int band = blockIdx.x, b = blockIdx.y;
  const int y0 = band * kBand, y1 = min(y0 + kBand, h);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t rowb = (size_t)w * kCh;
  const uint8_t* img = frames + (size_t)b * h * rowb;
  const size_t row = (size_t)(w + 1) * kCh;
  uint32_t* out = reinterpret_cast<uint32_t*>(integ) +
                  (size_t)b * (h + 1) * row;
  if (band == 0)  // the zero row
    for (size_t i = tid; i < row; i += kThreads) out[i] = 0u;
  for (int i = tid; i < kBand * kCh; i += kThreads)
    s_carry[i / kCh][i % kCh] = 0u;
  for (int p0 = 0; p0 < w; p0 += kPass) {
    const int n = min(kPass, w - p0), nb = n * kCh;
    const int x0 = p0 + tid * kPix;  // this thread's four pixels
    // carry-in: the column sums of every row above this band
    uint32_t col[kPer] = {};
    for (int k = 0; k < band; ++k) {
      const uint32_t* t = totals + ((size_t)b * nt + k) * rowb;
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        if (x0 + j < w)
#pragma unroll
          for (int c = 0; c < kCh; ++c)
            col[j * kCh + c] += __ldg(t + (size_t)(x0 + j) * kCh + c);
    }
    uint32_t nxt[kPer];  // bytes tid + 256 k of the next row's pass
    auto fetch = [&](int y) {
      const uint8_t* src = img + (size_t)y * rowb + (size_t)p0 * kCh;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = tid + k * kThreads;
        nxt[k] = e < nb ? (uint32_t)__ldg(src + e) : 0u;
      }
    };
    fetch(y0);
    for (int y = y0; y < y1; ++y) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) s_px[tid + k * kThreads] = (uint8_t)nxt[k];
      __syncthreads();  // the row's bytes are in
      if (y + 1 < y1) fetch(y + 1);
      // column sums to row y, then this thread's prefix along x
      uint32_t pre[kPer];
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        uint32_t acc = 0u;
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const int e = (tid * kPix + j) * kCh + c;
          col[j * kCh + c] += e < nb ? (uint32_t)s_px[e] : 0u;
          acc += col[j * kCh + c];
          pre[j * kCh + c] = acc;
        }
      }
      // inclusive scan of the thread totals across the warp, then the
      // warp totals through shared memory
      uint32_t tot[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        uint32_t t = pre[(kPix - 1) * kCh + c];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const uint32_t v = __shfl_up_sync(0xffffffffu, t, off);
          if (lane >= off) t += v;
        }
        tot[c] = t;
        if (lane == 31) s_warp[warp][c] = t;
      }
      __syncthreads();
      const int r = y - y0;
      uint32_t base[kCh];
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        uint32_t sum = s_carry[r][c] + tot[c] - pre[(kPix - 1) * kCh + c];
        for (int q = 0; q < warp; ++q) sum += s_warp[q][c];
        base[c] = sum;
      }
      uint4* so = reinterpret_cast<uint4*>(s_out + tid * kPer);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        uint32_t v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = base[(4 * q + i) % kCh] +
                                           pre[4 * q + i];
        so[q] = make_uint4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();  // the row's entries are staged; s_carry[r] read
      if (tid == kThreads - 1)  // this pass's row total
#pragma unroll
        for (int c = 0; c < kCh; ++c)
          s_carry[r][c] = base[c] + pre[(kPix - 1) * kCh + c];
      uint32_t* dst = out + (size_t)(y + 1) * row;
      if (p0 == 0 && tid < kCh) dst[tid] = 0u;  // the zero column
      dst += (size_t)(p0 + 1) * kCh;
      for (int i = tid; i < nb; i += kThreads) dst[i] = s_out[i];
    }
    __syncthreads();
  }
}

// the cell bounds along one axis, in f32 exactly as ops.crop
// _area_pool_bounds and pool_tables compute them: [i0, i1) clamped to
// [0, n] (i1 >= i0) and the unclamped extent p1 - p0
__device__ __forceinline__ void cell_bounds(float lo, float hi, int o, int s,
                                            int n, int* i0, int* i1,
                                            float* ext) {
  const float extent = __fadd_rn(__fsub_rn(hi, lo), 1.f);
  const float fs = (float)s;
  const float r0 = floorf(__fdiv_rn(__fmul_rn((float)o, extent), fs));
  float r1 = ceilf(__fdiv_rn(__fmul_rn(__fadd_rn((float)o, 1.f), extent), fs));
  r1 = fminf(fmaxf(r1, __fadd_rn(r0, 1.f)), extent);
  const float base = __fsub_rn(lo, 1.f);
  const float p0 = __fadd_rn(base, r0), p1 = __fadd_rn(base, r1);
  const float fn = (float)n;
  const int a = (int)fminf(fmaxf(p0, 0.f), fn);
  *i0 = a;
  *i1 = max((int)fminf(fmaxf(p1, 0.f), fn), a);
  *ext = __fsub_rn(p1, p0);
}

// grid ceil(B * K * S * S / 256), block 256: one cell, three channels.
__global__ void __launch_bounds__(256)
crop_pool_kernel(const int32_t* __restrict__ integ,
                 const float* __restrict__ boxes, float* __restrict__ out,
                 int k, int h, int w, int s, long long cells) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int ox = (int)(i % s), oy = (int)((i / s) % s);
  const long long bk = i / ((long long)s * s);
  const int b = (int)(bk / k);
  const float4 box = __ldg(reinterpret_cast<const float4*>(boxes) + bk);
  int ya, yb, xa, xb;
  float wy, wx;
  cell_bounds(box.y, box.w, oy, s, h, &ya, &yb, &wy);
  cell_bounds(box.x, box.z, ox, s, w, &xa, &xb, &wx);
  const size_t row = (size_t)(w + 1) * kCh;
  const uint32_t* im =
      reinterpret_cast<const uint32_t*>(integ) + (size_t)b * (h + 1) * row;
  const uint32_t* c00 = im + (size_t)ya * row + (size_t)xa * kCh;
  const uint32_t* c01 = im + (size_t)ya * row + (size_t)xb * kCh;
  const uint32_t* c10 = im + (size_t)yb * row + (size_t)xa * kCh;
  const uint32_t* c11 = im + (size_t)yb * row + (size_t)xb * kCh;
  const float norm = fmaxf(__fmul_rn(wy, wx), 1.f);
  float* dst = out + i * kCh;
#pragma unroll
  for (int c = 0; c < kCh; ++c) {
    // modulo 2^32, then read as int32 (nvcc converts modulo 2^32)
    const uint32_t wrapped =
        __ldg(c11 + c) - __ldg(c01 + c) - __ldg(c10 + c) + __ldg(c00 + c);
    dst[c] = __fdiv_rn(__int2float_rn((int)wrapped), norm);
  }
}

}  // namespace

// frames [b, h, w, 3] u8 -> integ [b, h+1, w+1, 3] int32 zero-padded
// prefix sums, modulo 2^32; totals: uint32 scratch of
// b * max(ceil(h / 64) - 1, 1) * w * 3 entries. Two launches on `stream`
// (written to *launches), no synchronisation; returns
// cudaGetLastError().
extern "C" int vn_integral_image(const uint8_t* frames, int32_t* integ,
                                 uint32_t* totals, int b, int h, int w,
                                 void* stream, int* launches) {
  *launches = 0;
  if (b <= 0 || h <= 0 || w <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  int e = vn_set_device_of(integ);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  const int bands = (h + kBand - 1) / kBand;
  const int nt = bands > 1 ? bands - 1 : 1;
  band_totals_kernel<<<dim3(nt, b), kThreads, 0, st>>>(frames, totals, h, w);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  *launches = 1;
  band_scan_kernel<<<dim3(bands, b), kThreads, 0, st>>>(frames, totals,
                                                        integ, h, w, nt);
  ce = cudaGetLastError();
  if (ce == cudaSuccess) *launches = 2;
  return (int)ce;
}

// integ [b, h+1, w+1, 3] int32, boxes [b*k, 4] f32 (x1, y1, x2, y2,
// 1-based inclusive, 16-byte aligned) -> out [b*k, s, s, 3] f32. One
// launch on `stream`, no synchronisation; returns cudaGetLastError().
extern "C" int vn_crop_area_pool(const int32_t* integ, const float* boxes,
                                 float* out, int b, int k, int h, int w,
                                 int s, void* stream) {
  if (b <= 0 || k <= 0) return 0;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  const long long cells = (long long)b * k * s * s;
  const long long blocks = (cells + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  crop_pool_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      integ, boxes, out, k, h, w, s, cells);
  return (int)cudaGetLastError();
}
