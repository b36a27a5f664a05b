// K7: the 2-branch emotion ResNet-50's stem on 112 px aligned faces.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/
// emotion_stem_pallas.py (emotion_stem_pallas, used by
// emotion_apply_fused). Function: area upsample 112 -> 224 (exact 2x2
// duplication), ImageNet normalisation of x/255, conv 7x7/2 pad 3
// (3 -> 64), BatchNorm, ReLU, max pool 3x3/2 pad 1:
// [K, 112, 112, 3] f32 -> [K, 56, 56, 64] (f32 or bf16), NHWC.
//
// The duplication lets the 7x7/2 conv on the 224 px image be computed as
// a 4x4/1 conv on the 112 px face whose taps are the 7x7 taps summed
// pairwise ({0}, {1,2}, {3,4}, {5,6} per axis; conv row r reads face rows
// r-2 .. r+1). The host folds that and the BatchNorm scale into a
// [48, 64] weight and a bias. The normalisation is applied to the face
// before the zero padding, as in the reference. The TPU kernel's
// subposition GEMM and 2-faces-per-128-lanes packing are not carried
// over.
//
// Bound on the H100: at K = 512 faces the folded conv is ~39.5 GFLOP,
// done here in f32 on the CUDA cores (67 TFLOP/s: 0.59 ms); it must read
// ~77 MB of faces and write ~206 MB of bf16 features (0.08 ms), so it is
// bound by operations.
//
// Design: a thread block owns an 8x8 tile of the pooled output of one
// face. It stages the normalised 20x20x3 face footprint in shared
// memory, computes the 17x17x64 conv outputs the tile's pool windows
// cover (BN folded, ReLU; -inf outside the 112x112 conv map, the pool's
// padding) into shared memory, then takes the 3x3 maxima. Each thread
// computes 4 output channels of a conv position, so one float4 weight
// load feeds 4 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFace = 112, kConv = 112, kOut = 56, kCh = 64;
constexpr int kTile = 8;                  // pooled outputs per tile side
constexpr int kCR = 2 * kTile + 1;        // conv rows/cols per tile (17)
constexpr int kIR = kCR + 3;              // face rows/cols per tile (20)
constexpr int kTilesX = kOut / kTile;     // 7
constexpr size_t kSmemBytes =
    sizeof(float) * (kIR * kIR * 3 + kCR * kCR * kCh);

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
emotion_stem_kernel(const float* __restrict__ faces,
                    const float* __restrict__ w,  // [48][64] then bias[64]
                    OutT* __restrict__ out) {
  extern __shared__ float smem[];
  float* inb = smem;                      // [20][20][3] normalised face
  float* cbuf = smem + kIR * kIR * 3;     // [17][17][64] conv outputs

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const int py0 = (blockIdx.x / kTilesX) * kTile;
  const int px0 = (blockIdx.x % kTilesX) * kTile;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // conv-map origin
  const int fy0 = cy0 - 2, fx0 = cx0 - 2;          // face origin

  const float mean[3] = {0.485f, 0.456f, 0.406f};
  const float stdv[3] = {0.229f, 0.224f, 0.225f};
  const float* face = faces + (size_t)k * kFace * kFace * 3;
  for (int i = tid; i < kIR * kIR * 3; i += kThreads) {
    const int c = i % 3;
    const int p = i / 3;
    const int gy = fy0 + p / kIR, gx = fx0 + p % kIR;
    float v = 0.f;
    if (gy >= 0 && gy < kFace && gx >= 0 && gx < kFace)
      v = (face[((size_t)gy * kFace + gx) * 3 + c] / 255.f - mean[c]) /
          stdv[c];
    inb[i] = v;
  }
  __syncthreads();

  const float* bias = w + 48 * kCh;
  constexpr int G = kCh / 4;
  for (int i = tid; i < kCR * kCR * G; i += kThreads) {
    const int og = (i % G) * 4;
    const int p = i / G;
    const int r = p / kCR, q = p % kCR;
    const int gy = cy0 + r, gx = cx0 + q;
    float4 acc = __ldg(reinterpret_cast<const float4*>(bias + og));
#pragma unroll
    for (int dy = 0; dy < 4; ++dy)
#pragma unroll
      for (int dx = 0; dx < 4; ++dx)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = inb[((r + dy) * kIR + q + dx) * 3 + c];
          const float4 wv = __ldg(reinterpret_cast<const float4*>(
              w + ((dy * 4 + dx) * 3 + c) * kCh + og));
          acc.x += v * wv.x;
          acc.y += v * wv.y;
          acc.z += v * wv.z;
          acc.w += v * wv.w;
        }
    const bool ok = gy >= 0 && gy < kConv && gx >= 0 && gx < kConv;
    float* dst = cbuf + p * kCh + og;
    dst[0] = ok ? fmaxf(acc.x, 0.f) : -INFINITY;
    dst[1] = ok ? fmaxf(acc.y, 0.f) : -INFINITY;
    dst[2] = ok ? fmaxf(acc.z, 0.f) : -INFINITY;
    dst[3] = ok ? fmaxf(acc.w, 0.f) : -INFINITY;
  }
  __syncthreads();

  OutT* dst = out + (size_t)k * kOut * kOut * kCh;
  for (int i = tid; i < kTile * kTile * kCh; i += kThreads) {
    const int o = i % kCh;
    const int p = i / kCh;
    const int r = p / kTile, q = p % kTile;
    float m = -INFINITY;
#pragma unroll
    for (int sy = 0; sy < 3; ++sy)
#pragma unroll
      for (int sx = 0; sx < 3; ++sx)
        m = fmaxf(m, cbuf[((2 * r + sy) * kCR + 2 * q + sx) * kCh + o]);
    store(dst + ((size_t)(py0 + r) * kOut + px0 + q) * kCh + o, m);
  }
}

template <typename OutT>
int launch(const float* faces, const float* w, OutT* out, int k,
           cudaStream_t stream) {
  auto kern = emotion_stem_kernel<OutT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(kTilesX * kTilesX, k);
  kern<<<grid, kThreads, kSmemBytes, stream>>>(faces, w, out);
  return (int)cudaGetLastError();
}

}  // namespace

// faces [K, 112, 112, 3] f32 (0-255), weights [48*64 + 64] f32 ->
// out [K, 56, 56, 64] (bf16 when out_bf16, else f32). One launch on
// `stream`, no synchronisation; returns cudaGetLastError().
extern "C" int vn_emotion_stem(const float* faces, const float* weights,
                               void* out, int k, int out_bf16,
                               void* stream) {
  if (k <= 0) return 0;
  if (k > 65535) return (int)cudaErrorInvalidConfiguration;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return launch(faces, weights, (__nv_bfloat16*)out, k, st);
  return launch(faces, weights, (float*)out, k, st);
}
