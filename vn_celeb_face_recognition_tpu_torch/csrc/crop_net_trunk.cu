// K5: the MTCNN RNet/ONet trunk on batched face crops.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/
// crops_net_pallas.py (crop_net_trunk, used by rnet_apply_fused and
// onet_apply_fused). Function, per normalised crop [S, S, 3] (NHWC):
// conv1 3x3 valid (3 -> C1) + bias + PReLU, max pool 3x3/2 in torch's
// ceil mode, conv2 3x3 valid (C1 -> C2) + bias + PReLU:
//   RNet: [N, 24, 24, 3] -> 22 -> 11 -> [N, 9, 9, 48]   (C1 28, C2 48)
//   ONet: [N, 48, 48, 3] -> 46 -> 23 -> [N, 21, 21, 64] (C1 32, C2 64)
// Inputs and outputs are f32, or bf16 on the bf16 path; weights arrive
// as f32 (rounded to bf16 values by the host on the bf16 path) and every
// sum is taken in f32.
//
// Bound on the H100: bytes and operations about equally. Per crop the
// trunk is ~2.7 MFLOP (RNet) and ~20 MFLOP (ONet) against 3.5 KB /
// 14 KB of bf16 in and 7.8 KB / 56 KB out; at the stock line's 32,768
// RNet and 16,384 ONet crops a chunk that is 0.41 TFLOP (0.42 ms at the
// bf16 peak) against 1.5 GB (0.45 ms). This design sums on the CUDA
// cores in f32, whose peak is 67 TFLOP/s.
//
// Design: one thread block per crop, everything between the crop and the
// output in shared memory. The crop is staged channel-planar. conv1 runs
// in bands of pooled rows: a band computes the conv1 rows its pool
// windows cover (one thread per conv position, all C1 channels in
// registers, weights broadcast from shared memory), then pools them into
// the resident pooled map [C1][P][P]. The ceil-mode edge is the window
// clipped to the conv map: the last pooled row and column see two conv
// rows (RNet 22 -> 11, ONet 46 -> 23). When the last band is pooled, the
// conv2 weights are loaded over the crop and band buffers, and conv2
// runs one output position x 16 channels per thread (float4 weight
// broadcasts, one pooled value per tap and input channel). The TPU
// kernel's space-to-depth packing and subposition matrix A1 are not
// carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store16(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* v) {
  __align__(16) __nv_bfloat162 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(h);
  d[0] = s[0];
  d[1] = s[1];
}

__device__ __forceinline__ float prelu(float v, float a) {
  return v >= 0.f ? v : v * a;
}

constexpr int round4(int v) { return (v + 3) / 4 * 4; }

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

template <int S, int C1, int C2, int R, int THREADS, typename T>
__global__ void __launch_bounds__(THREADS)
crop_net_trunk_kernel(const T* __restrict__ crops,
                      const float* __restrict__ weights, T* __restrict__ out) {
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
  const T* src = crops + n * S * S * 3;
  for (int i = tid; i < S * S * 3; i += THREADS) {
    const int c = i % 3, p = i / 3;
    crop[c * S * S + p] = load_f(src + i);
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
  T* dst = out + n * kPos * C2;
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
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = prelu(acc[j], a2s[cb * 16 + j]);
    store16(dst + (size_t)pos * C2 + cb * 16, acc);
  }
}

template <int S, int C1, int C2, int R, int THREADS, typename T>
int launch(const void* crops, const float* weights, void* out, int n,
           cudaStream_t stream) {
  using G = Trunk<S, C1, C2, R, THREADS>;
  auto kern = crop_net_trunk_kernel<S, C1, C2, R, THREADS, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<n, THREADS, G::kSmemBytes, stream>>>(
      static_cast<const T*>(crops), weights, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int net, const void* crops, const float* weights, void* out,
             int n, cudaStream_t st) {
  // (S, C1, C2, pooled rows per band, threads): ops/crops_net.py specs
  if (net == 0)
    return launch<24, 28, 48, 11, 256, T>(crops, weights, out, n, st);
  return launch<48, 32, 64, 4, 512, T>(crops, weights, out, n, st);
}

}  // namespace

// crops [n, S, S, 3] (f32, or bf16 when bf16) normalised, weights packed
// f32 (27*C1 + 2*C1 + 9*C1*C2 + 2*C2 values) -> out [n, P2, P2, C2] in
// the crops' type; net 0 is RNet (S 24), 1 is ONet (S 48). One launch on
// `stream`, no synchronisation; returns cudaGetLastError().
extern "C" int vn_crop_net_trunk(const void* crops, const float* weights,
                                 void* out, int n, int net, int bf16,
                                 void* stream) {
  if (n <= 0) return 0;
  if (net != 0 && net != 1) return (int)cudaErrorInvalidValue;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return dispatch<__nv_bfloat16>(net, crops, weights, out, n, st);
  return dispatch<float>(net, crops, weights, out, n, st);
}
