// K6: RetinaFace MobileNetV1-0.25 stage 1 from uint8 frames.
//
// Replaces the TPU kernels vn_celeb_face_recognition_tpu/ops/
// planar_s1_pallas.py (planar_stage1_pallas) and planar_s1_pallas_v2.py
// (planar_stage1_pallas_v2). Those lay the image out as flattened lanes
// with space-to-depth phase planes and rolls because a TPU core tiles
// channels to 128 lanes; this kernel computes the function itself: six
// blocks (conv 3x3/2 3->8, then depthwise-separable blocks 8->16/1,
// 16->32/2, 32->32/1, 32->64/2, 64->64/1), each with inference BatchNorm
// (folded to a per-channel mul/add on the host) and LeakyReLU(0.1), on
// frames minus the channel means, zero padding of 1 everywhere.
//
// Bound on the H100: at 128 frames of 640x640 the stage does ~35 GFLOP
// (~275 MFLOP a frame; this kernel does them in f32 on the CUDA cores,
// 67 TFLOP/s) and must move ~157 MB of frames in and ~105 MB of bf16
// features out, so it is bound by operations (0.52 ms) before bytes
// (0.08 ms).
//
// Design: three launches, one per stride-2 segment (blocks 0-1, 2-3,
// 4-5). A thread block owns a TH x TW tile of its segment's output for
// one frame: it stages the input footprint (2*TH+5 rows incl. the halo)
// in shared memory, computes the stride-2 block on the (TH+2) x (TW+2)
// tile plus the one-cell halo the stride-1 depthwise needs (zero outside
// the image, which is that depthwise conv's padding), then the stride-1
// block, and writes the tile. Depthwise and pointwise pairs stay in
// shared memory; only the segment outputs (16 and 32 channels at 1/2 and
// 1/4 resolution, in the output dtype) go through device memory. Any H
// and W work: edges are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLeaky = 0.1f;

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * kLeaky;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(uint8_t v) { return (float)v; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Floats of one segment's packed weights (csrc order, see
// ops/planar_s1.pack_stage1_weights).
template <int CIN, int CMID, int COUT, bool FIRST>
struct SegWeights {
  // FIRST: conv0 [27][CMID], mul/add [CMID]; else dw [9][CIN],
  // mul/add [CIN], pw [CIN][CMID], mul/add [CMID]
  static constexpr int kA = FIRST ? 27 * CMID + 2 * CMID
                                  : 9 * CIN + 2 * CIN + CIN * CMID + 2 * CMID;
  // stride-1 block: dw [9][CMID], mul/add [CMID], pw [CMID][COUT],
  // mul/add [COUT]
  static constexpr int kB = 9 * CMID + 2 * CMID + CMID * COUT + 2 * COUT;
  static constexpr int kTotal = kA + kB;
};

template <int CIN, int TH, int TW, int CMID, int COUT, bool FIRST>
struct SegSmem {
  static constexpr int kIR = 2 * TH + 5, kIC = 2 * TW + 5;
  static constexpr int kAR = TH + 2, kAC = TW + 2;
  static constexpr int kIn = kIR * kIC * CIN;
  static constexpr int kD = FIRST ? 0 : kAR * kAC * CIN;
  static constexpr int kA = kAR * kAC * CMID;
  static constexpr int kE = TH * TW * CMID;
  // the stride-1 depthwise output reuses the input buffer
  static constexpr int kBuf0 = kIn > kE ? kIn : kE;
  static constexpr int kFloats = kBuf0 + kD + kA;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// One segment: a stride-2 block (conv0 when FIRST, else depthwise 3x3/2
// + pointwise) then a stride-1 depthwise-separable block. in: [B, Hi, Wi,
// CIN] NHWC; out: [B, Ho, Wo, COUT] NHWC with Ho = (Hi + 1) / 2.
template <int CIN, int CMID, int COUT, int TH, int TW, bool FIRST,
          typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const InT* __restrict__ in, const float* __restrict__ w,
               const float* __restrict__ sub, OutT* __restrict__ out,
               int hi, int wi, int ho, int wo, int tiles_x) {
  using S = SegSmem<CIN, TH, TW, CMID, COUT, FIRST>;
  extern __shared__ float smem[];
  float* inb = smem;            // [IR][IC][CIN], later ebuf [TH][TW][CMID]
  float* dbuf = smem + S::kBuf0;  // [AR][AC][CIN] (not FIRST)
  float* abuf = dbuf + S::kD;     // [AR][AC][CMID]
  float* ebuf = smem;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int ay0 = ty0 - 1, ax0 = tx0 - 1;          // stage-A origin
  const int iy0 = 2 * ay0 - 1, ix0 = 2 * ax0 - 1;  // input origin

  // ---- stage the input footprint (zero outside the frame) -------------
  const InT* img = in + (size_t)b * hi * wi * CIN;
  for (int i = tid; i < S::kIn; i += kThreads) {
    const int c = i % CIN;
    const int p = i / CIN;
    const int gy = iy0 + p / S::kIC, gx = ix0 + p % S::kIC;
    float v = 0.f;
    if (gy >= 0 && gy < hi && gx >= 0 && gx < wi) {
      v = to_f(img[((size_t)gy * wi + gx) * CIN + c]);
      if constexpr (FIRST) v -= sub[c];
    }
    inb[i] = v;
  }
  __syncthreads();

  // ---- stage A: the stride-2 block on the tile plus a 1-cell halo -------
  const float* wb;  // stride-1 block weights
  if constexpr (FIRST) {
    const float* w0 = w;                 // [27][CMID]
    const float* m0 = w0 + 27 * CMID;    // [CMID]
    const float* a0 = m0 + CMID;
    wb = a0 + CMID;
    for (int i = tid; i < S::kAR * S::kAC * CMID; i += kThreads) {
      const int o = i % CMID;
      const int p = i / CMID;
      const int r = p / S::kAC, q = p % S::kAC;
      const int gy = ay0 + r, gx = ax0 + q;
      float v = 0.f;
      if (gy >= 0 && gy < ho && gx >= 0 && gx < wo) {
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int c = 0; c < CIN; ++c)
              acc += inb[((2 * r + dy) * S::kIC + 2 * q + dx) * CIN + c] *
                     __ldg(w0 + ((dy * 3 + dx) * CIN + c) * CMID + o);
        v = leaky(acc * __ldg(m0 + o) + __ldg(a0 + o));
      }
      abuf[i] = v;
    }
  } else {
    const float* dw = w;                 // [9][CIN]
    const float* m1 = dw + 9 * CIN;      // [CIN]
    const float* a1 = m1 + CIN;
    const float* pw = a1 + CIN;          // [CIN][CMID]
    const float* m2 = pw + CIN * CMID;   // [CMID]
    const float* a2 = m2 + CMID;
    wb = a2 + CMID;
    for (int i = tid; i < S::kAR * S::kAC * CIN; i += kThreads) {
      const int c = i % CIN;
      const int p = i / CIN;
      const int r = p / S::kAC, q = p % S::kAC;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc += inb[((2 * r + dy) * S::kIC + 2 * q + dx) * CIN + c] *
                 __ldg(dw + (dy * 3 + dx) * CIN + c);
      dbuf[i] = leaky(acc * __ldg(m1 + c) + __ldg(a1 + c));
    }
    __syncthreads();
    constexpr int G = CMID / 4;
    for (int i = tid; i < S::kAR * S::kAC * G; i += kThreads) {
      const int og = (i % G) * 4;
      const int p = i / G;
      const int gy = ay0 + p / S::kAC, gx = ax0 + p % S::kAC;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* d = dbuf + p * CIN;
#pragma unroll 8
      for (int c = 0; c < CIN; ++c) {
        const float v = d[c];
        const float4 wv = __ldg(reinterpret_cast<const float4*>(
            pw + c * CMID + og));
        acc.x += v * wv.x;
        acc.y += v * wv.y;
        acc.z += v * wv.z;
        acc.w += v * wv.w;
      }
      const bool ok = gy >= 0 && gy < ho && gx >= 0 && gx < wo;
      float* dst = abuf + p * CMID + og;
      dst[0] = ok ? leaky(acc.x * __ldg(m2 + og) + __ldg(a2 + og)) : 0.f;
      dst[1] = ok ? leaky(acc.y * __ldg(m2 + og + 1) + __ldg(a2 + og + 1))
                  : 0.f;
      dst[2] = ok ? leaky(acc.z * __ldg(m2 + og + 2) + __ldg(a2 + og + 2))
                  : 0.f;
      dst[3] = ok ? leaky(acc.w * __ldg(m2 + og + 3) + __ldg(a2 + og + 3))
                  : 0.f;
    }
  }
  __syncthreads();

  // ---- stage B: the stride-1 block on the tile --------------------------
  const float* dwb = wb;                 // [9][CMID]
  const float* mb1 = dwb + 9 * CMID;
  const float* ab1 = mb1 + CMID;
  const float* pwb = ab1 + CMID;         // [CMID][COUT]
  const float* mb2 = pwb + CMID * COUT;
  const float* ab2 = mb2 + COUT;
  for (int i = tid; i < TH * TW * CMID; i += kThreads) {
    const int c = i % CMID;
    const int p = i / CMID;
    const int r = p / TW, q = p % TW;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        acc += abuf[((r + dy) * S::kAC + q + dx) * CMID + c] *
               __ldg(dwb + (dy * 3 + dx) * CMID + c);
    ebuf[i] = leaky(acc * __ldg(mb1 + c) + __ldg(ab1 + c));
  }
  __syncthreads();
  constexpr int GO = COUT / 4;
  OutT* dst_img = out + (size_t)b * ho * wo * COUT;
  for (int i = tid; i < TH * TW * GO; i += kThreads) {
    const int og = (i % GO) * 4;
    const int p = i / GO;
    const int gy = ty0 + p / TW, gx = tx0 + p % TW;
    if (gy >= ho || gx >= wo) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* e = ebuf + p * CMID;
#pragma unroll 8
    for (int c = 0; c < CMID; ++c) {
      const float v = e[c];
      const float4 wv =
          __ldg(reinterpret_cast<const float4*>(pwb + c * COUT + og));
      acc.x += v * wv.x;
      acc.y += v * wv.y;
      acc.z += v * wv.z;
      acc.w += v * wv.w;
    }
    OutT* o = dst_img + ((size_t)gy * wo + gx) * COUT + og;
    store(o + 0, leaky(acc.x * __ldg(mb2 + og) + __ldg(ab2 + og)));
    store(o + 1, leaky(acc.y * __ldg(mb2 + og + 1) + __ldg(ab2 + og + 1)));
    store(o + 2, leaky(acc.z * __ldg(mb2 + og + 2) + __ldg(ab2 + og + 2)));
    store(o + 3, leaky(acc.w * __ldg(mb2 + og + 3) + __ldg(ab2 + og + 3)));
  }
}

template <int CIN, int CMID, int COUT, int TH, int TW, bool FIRST,
          typename InT, typename OutT>
int launch_segment(const InT* in, const float* w, const float* sub,
                   OutT* out, int b, int hi, int wi, cudaStream_t stream) {
  using S = SegSmem<CIN, TH, TW, CMID, COUT, FIRST>;
  auto kern = segment_kernel<CIN, CMID, COUT, TH, TW, FIRST, InT, OutT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int ho = (hi + 1) / 2, wo = (wi + 1) / 2;
  const int tiles_x = (wo + TW - 1) / TW, tiles_y = (ho + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, b);
  kern<<<grid, kThreads, S::kBytes, stream>>>(in, w, sub, out, hi, wi, ho,
                                              wo, tiles_x);
  return (int)cudaGetLastError();
}

template <typename OutT>
int run_stage1(const uint8_t* frames, const float* weights, OutT* out,
               OutT* s1, OutT* s2, int b, int h, int w, cudaStream_t st,
               int* launches) {
  using W1 = SegWeights<3, 8, 16, true>;
  using W2 = SegWeights<16, 32, 32, false>;
  using W3 = SegWeights<32, 64, 64, false>;
  static_assert(4 + W1::kTotal + W2::kTotal + W3::kTotal == 10132,
                "packed weight count differs from ops/planar_s1.N_WEIGHTS");
  const float* sub = weights;
  const float* w1 = weights + 4;
  const float* w2 = w1 + W1::kTotal;
  const float* w3 = w2 + W2::kTotal;
  const int h2 = (h + 1) / 2, w2s = (w + 1) / 2;
  const int h4 = (h2 + 1) / 2, w4s = (w2s + 1) / 2;
  int e = launch_segment<3, 8, 16, 16, 16, true>(frames, w1, sub, s1, b, h,
                                                 w, st);
  if (e) return e;
  ++*launches;
  e = launch_segment<16, 32, 32, 8, 8, false>(s1, w2, sub, s2, b, h2, w2s,
                                              st);
  if (e) return e;
  ++*launches;
  e = launch_segment<32, 64, 64, 8, 8, false>(s2, w3, sub, out, b, h4, w4s,
                                              st);
  if (e) return e;
  ++*launches;
  return 0;
}

}  // namespace

// frames [B, H, W, 3] uint8, weights [10132] f32 -> out [B, H8, W8, 64]
// (f32, or bf16 when out_bf16), via scratch1 [B, H2, W2, 16] and scratch2
// [B, H4, W4, 32] of the same dtype. Three launches on `stream`, no
// synchronisation; writes the number of kernels launched to *launches and
// returns the first CUDA error (0 on success).
extern "C" int vn_mnet_stage1(const uint8_t* frames, const float* weights,
                              void* out, void* scratch1, void* scratch2,
                              int b, int h, int w, int out_bf16,
                              void* stream, int* launches) {
  *launches = 0;
  if (b <= 0) return 0;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return run_stage1(frames, weights, (__nv_bfloat16*)out,
                      (__nv_bfloat16*)scratch1, (__nv_bfloat16*)scratch2, b,
                      h, w, st, launches);
  return run_stage1(frames, weights, (float*)out, (float*)scratch1,
                    (float*)scratch2, b, h, w, st, launches);
}
