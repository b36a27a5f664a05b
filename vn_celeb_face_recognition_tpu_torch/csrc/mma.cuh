// Tensor-core and async-copy primitives shared by the bf16 kernels K5
// (crop_net_trunk.cu) and K8 (bottleneck_chain.cu): 16-byte cp.async
// copies into shared memory, ldmatrix.x4 fragment loads and
// mma.sync.m16n8k16 bf16 products with f32 sums (sm_80 and later).
//
// Fragment layout of mma_bf16 (per lane, gq = lane / 4, tq = lane % 4):
// A (16 x 16, row) a[0..3] from ldsm_x4 with this lane's row address
// (lane & 7) + 8 * ((lane >> 3) & 1) and column offset 8 * (lane >> 4);
// B (16 x 8, col) b0, b1 from ldsm_x4 of [n][k] rows, this lane's row
// 8 * (lane >> 4) + (lane & 7) and column offset 8 * ((lane >> 3) & 1)
// (two n8 tiles per ldsm_x4: b[0], b[1] and b[2], b[3]); the sums
// c[0], c[1] at row gq, columns 2 tq, 2 tq + 1 and c[2], c[3] at row
// gq + 8.
#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

// 16 bytes when ``valid``, else 16 zero bytes and no read of ``gmem``
// (src-size 0); ``gmem`` must still be an address inside the tensor.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) |
         ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ unsigned pack2f(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

}  // namespace
