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
// Bound on the H100: memory. A chunk reads up to K x N x N x 3 f32
// windows (320 x 224 x 224 x 3 = ~193 MB at the bench shapes) and writes
// K x 112 x 112 x 3 f32; the arithmetic is a few dozen flops per output
// pixel. Each output pixel touches a 2x2 footprint of its window, so only
// the ~112^2 sampled neighbourhoods of each window are read, not the
// whole window.
//
// Design: one thread per output pixel, all three channels; grid
// (ceil(S*S / 256), K). Neighbouring threads sample neighbouring source
// positions, so the tap reads of a warp fall in a few cache lines; the
// per-face inverse matrix is recomputed by each thread (six loads that
// hit the same line). Removing the window stack by fusing the window cut
// into this kernel is later work.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void __launch_bounds__(256)
similarity_warp_kernel(const float* __restrict__ windows,
                       const float* __restrict__ mats,
                       float* __restrict__ out, int n, int s) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int k = blockIdx.y;
  if (pix >= s * s) return;
  const int oy = pix / s;
  const int ox = pix - oy * s;

  // every product and sum is rounded on its own (no fused multiply-add),
  // in the order ops/image.batched_warp_affine evaluates them, so the
  // sample coordinates equal the plain version's bit for bit
  const float* m = mats + 6 * (size_t)k;
  const float a = m[0], b = m[1], tx = m[2];
  const float c = m[3], d = m[4], ty = m[5];
  const float det = __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, c));
  const float ia = d / det, ib = -b / det;
  const float ic = -c / det, id = a / det;
  const float itx = -__fadd_rn(__fmul_rn(ia, tx), __fmul_rn(ib, ty));
  const float ity = -__fadd_rn(__fmul_rn(ic, tx), __fmul_rn(id, ty));

  const float fx = (float)ox, fy = (float)oy;
  const float sx =
      __fadd_rn(__fadd_rn(__fmul_rn(ia, fx), __fmul_rn(ib, fy)), itx);
  const float sy =
      __fadd_rn(__fadd_rn(__fmul_rn(ic, fx), __fmul_rn(id, fy)), ity);
  const float y0 = floorf(sy), x0 = floorf(sx);
  const float wy = sy - y0, wx = sx - x0;
  const float hm1 = (float)(n - 1), hm2 = (float)(n - 2);
  const bool vy0 = (y0 >= 0.f) && (y0 <= hm1);
  const bool vy1 = (y0 >= -1.f) && (y0 <= hm2);
  const bool vx0 = (x0 >= 0.f) && (x0 <= hm1);
  const bool vx1 = (x0 >= -1.f) && (x0 <= hm2);
  // fmaxf/fminf map NaN to the bound, so a degenerate matrix still reads
  // in range (its taps are all invalid and the output is NaN, as in the
  // reference)
  const int y0i = (int)fminf(fmaxf(y0, 0.f), hm1);
  const int x0i = (int)fminf(fmaxf(x0, 0.f), hm1);
  const int y1i = (int)fminf(fmaxf(y0 + 1.f, 0.f), hm1);
  const int x1i = (int)fminf(fmaxf(x0 + 1.f, 0.f), hm1);

  const float* img = windows + (size_t)k * n * n * 3;
  const float* p00 = img + ((size_t)y0i * n + x0i) * 3;
  const float* p01 = img + ((size_t)y0i * n + x1i) * 3;
  const float* p10 = img + ((size_t)y1i * n + x0i) * 3;
  const float* p11 = img + ((size_t)y1i * n + x1i) * 3;
  float* o = out + ((size_t)k * s * s + pix) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float v00 = (vy0 && vx0) ? __ldg(p00 + ch) : 0.f;
    const float v01 = (vy0 && vx1) ? __ldg(p01 + ch) : 0.f;
    const float v10 = (vy1 && vx0) ? __ldg(p10 + ch) : 0.f;
    const float v11 = (vy1 && vx1) ? __ldg(p11 + ch) : 0.f;
    const float top =
        __fadd_rn(__fmul_rn(v00, 1.f - wx), __fmul_rn(v01, wx));
    const float bot =
        __fadd_rn(__fmul_rn(v10, 1.f - wx), __fmul_rn(v11, wx));
    o[ch] = __fadd_rn(__fmul_rn(top, 1.f - wy), __fmul_rn(bot, wy));
  }
}

}  // namespace

// windows [K, N, N, 3] f32, mats [K, 2, 3] f32 -> out [K, S, S, 3] f32.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int vn_similarity_warp(const float* windows, const float* mats,
                                  float* out, int k, int n, int s,
                                  void* stream) {
  if (k <= 0) return 0;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  dim3 grid((s * s + 255) / 256, k);
  similarity_warp_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      windows, mats, out, n, s);
  return (int)cudaGetLastError();
}
