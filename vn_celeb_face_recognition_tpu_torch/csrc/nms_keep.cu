// K3: exact greedy NMS keep mask over N padded box sets.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/nms_pallas.py
// (nms_keep_mask_pallas). Function: boxes [N, K, 4] f32 (x1, y1, x2, y2),
// scores [N, K] f32, valid [N, K] bool -> keep [N, K] bool. Priority is
// descending score with ties to the lower row; a box is suppressed when a
// kept box of higher priority overlaps it with IoU > thr (strict). `off`
// is the +1 pixel-area convention, `min_mode` divides the intersection by
// the smaller area. A valid box whose score is NaN compares with no
// other, so it is kept and suppresses nothing, as in the plain version.
//
// Bound on the H100: the function reads 21 bytes and writes 1 byte per
// box, and needs one IoU test per valid box and kept box ahead of it (up
// to the first that suppresses it). At the stock line's per-scale shape
// (1,408 sets of 448 clustered candidates) that is 13.9 MB and ~1.5e7
// tests: bound by bytes, ~4 us. In practice the greedy scan's serial
// steps (one barrier per kept box) set the time.
//
// Design: one thread block per set, everything in shared memory. Each
// valid box gets its priority rank by counting the valid boxes ahead of
// it (an O(K^2) count spread over the block), and its box is stored at
// that rank. The greedy scan then walks the ranks in order: a box that
// is still unsuppressed is kept, and the block tests it against every
// lower-priority box in parallel, with one barrier per kept box. A
// suppressed box costs no barrier. The TPU kernel's Jacobi sweeps and
// [B, K, 8] packing are not carried over.
//
// Exactness: the IoU is computed in the plain version's order with
// explicitly rounded operations (no FMA contraction) and IEEE division:
//   area = (x2 - x1 + off) * (y2 - y1 + off)
//   inter = max(rb - lt + off, 0) products
//   denom = a + b - inter (or min(a, b)); iou = inter / max(denom, 1e-12)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

__device__ __forceinline__ float area_of(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off),
                   __fadd_rn(__fsub_rn(b.w, b.y), off));
}

__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float off,
                                         int min_mode, float thr) {
  const float w = fmaxf(
      __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), off), 0.f);
  const float h = fmaxf(
      __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), off), 0.f);
  const float inter = __fmul_rn(w, h);
  const float denom = min_mode ? fminf(area_a, area_b)
                               : __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(denom, 1e-12f)) > thr;
}

__global__ void nms_keep_kernel(const float4* __restrict__ boxes,
                                const float* __restrict__ scores,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int k, float thr,
                                float off, int min_mode) {
  extern __shared__ float4 smem4[];
  float4* sbox = smem4;                                    // [K] by rank
  float* sarea = reinterpret_cast<float*>(sbox + k);       // [K] by rank
  float* sscore = sarea + k;                               // [K] by row
  int* rank = reinterpret_cast<int*>(sscore + k);          // [K] by row
  uint8_t* sup = reinterpret_cast<uint8_t*>(rank + k);     // [K] by rank
  uint8_t* ordered = sup + k;                              // [K] by row
  __shared__ int n_ordered;

  const int set = blockIdx.x;
  const int tid = threadIdx.x;
  const float4* bx = boxes + (size_t)set * k;
  const float* sc = scores + (size_t)set * k;
  const uint8_t* vl = valid + (size_t)set * k;
  if (tid == 0) n_ordered = 0;
  __syncthreads();

  int mine = 0;
  for (int i = tid; i < k; i += blockDim.x) {
    const float s = sc[i];
    const uint8_t o = vl[i] && !isnan(s);
    sscore[i] = s;
    ordered[i] = o;
    sup[i] = 0;
    mine += o;
  }
  atomicAdd(&n_ordered, mine);
  __syncthreads();
  const int nv = n_ordered;

  // rank = number of ordered boxes ahead in priority
  for (int i = tid; i < k; i += blockDim.x) {
    if (!ordered[i]) continue;
    const float s = sscore[i];
    int r = 0;
    for (int j = 0; j < k; ++j) {
      const float t = sscore[j];
      r += ordered[j] && (t > s || (t == s && j < i));
    }
    rank[i] = r;
    const float4 b = bx[i];
    sbox[r] = b;
    sarea[r] = area_of(b, off);
  }
  __syncthreads();

  // greedy scan in priority order; sup[] changes only between barriers
  for (int r = 0; r < nv; ++r) {
    if (sup[r]) continue;
    const float4 a = sbox[r];
    const float area_a = sarea[r];
    for (int q = r + 1 + tid; q < nv; q += blockDim.x) {
      if (!sup[q] &&
          overlaps(a, area_a, sbox[q], sarea[q], off, min_mode, thr))
        sup[q] = 1;
    }
    __syncthreads();
  }

  uint8_t* out = keep + (size_t)set * k;
  for (int i = tid; i < k; i += blockDim.x) {
    uint8_t kv;
    if (ordered[i]) {
      kv = !sup[rank[i]];
    } else {
      kv = vl[i] != 0;  // valid with a NaN score: never compared
    }
    out[i] = kv;
  }
}

}  // namespace

// Shared memory the kernel needs for sets of k boxes.
static size_t nms_smem_bytes(int k) {
  return (size_t)k * (sizeof(float4) + 3 * sizeof(float) + 2);
}

// boxes [n, k, 4] f32, scores [n, k] f32, valid [n, k] u8 (0/1) ->
// keep [n, k] u8 (0/1). One launch on `stream`, no synchronisation;
// returns cudaGetLastError().
extern "C" int vn_nms_keep_mask(const float* boxes, const float* scores,
                                const uint8_t* valid, uint8_t* keep, int n,
                                int k, float thr, float off, int min_mode,
                                void* stream) {
  if (n <= 0 || k <= 0) return 0;
  int e = vn_set_device_of(keep);
  if (e != 0) return e;
  const size_t smem = nms_smem_bytes(k);
  cudaError_t ce = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  const int threads = k >= 2048 ? 1024 : (k >= 512 ? 512 : 256);
  nms_keep_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, valid, keep, k, thr,
      off, min_mode);
  return (int)cudaGetLastError();
}
