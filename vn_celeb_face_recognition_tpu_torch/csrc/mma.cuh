// Tensor-core and async-copy primitives shared by K5 (crop_net_trunk.cu)
// and K8 (bottleneck_chain.cu): 16-byte cp.async copies into shared
// memory, ldmatrix.x4 fragment loads, mma.sync.m16n8k16 bf16 products
// with f32 sums, and the 3xTF32 product of their f32 grids (sm_80 and
// later).
//
// Fragment layout of mma_bf16 (per lane, gq = lane / 4, tq = lane % 4):
// A (16 x 16, row) a[0..3] from ldsm_x4 with this lane's row address
// (lane & 7) + 8 * ((lane >> 3) & 1) and column offset 8 * (lane >> 4);
// B (16 x 8, col) b0, b1 from ldsm_x4 of [n][k] rows, this lane's row
// 8 * (lane >> 4) + (lane & 7) and column offset 8 * ((lane >> 3) & 1)
// (two n8 tiles per ldsm_x4: b[0], b[1] and b[2], b[3]); the sums
// c[0], c[1] at row gq, columns 2 tq, 2 tq + 1 and c[2], c[3] at row
// gq + 8.
//
// 3xTF32 (mma_tf32x3, m16n8k8 with f32 operands): each f32 value x is
// split into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
// with ties away from zero (as cvt.rna), and a . b is summed as lo_a hi_b +
// hi_a lo_b + hi_a hi_b, the small products first; only lo_a lo_b
// (~2^-22 |a b|) is dropped, so the sum stays near f32 rounding as long
// as the tensor cores' sums are kept short (mma_tf32x3_add). An
// ldmatrix.x4 of f32 rows gives the m16n8k8 fragments with the same lane
// addresses in bytes as above: A (16 x 8) a[0..3] = (row gq, k tq), (gq +
// 8, tq), (gq, tq + 4), (gq + 8, tq + 4) from rows (lane & 7) + 8 *
// ((lane >> 3) & 1) at float offset 4 * (lane >> 4); B (8 x 8) b0, b1 =
// (k tq, n gq), (k tq + 4, n gq) from [n][k] rows 8 * (lane >> 4) + (lane
// & 7) at float offset 4 * ((lane >> 3) & 1), two n8 tiles per ldsm_x4;
// the sums as for mma_bf16.
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

// x -> (hi, lo) tf32 operands, each rounded as cvt.rna.tf32.f32 rounds
// (to nearest, ties away from zero) by adding half a tf32 ulp to the bit
// pattern and clearing the 13 low bits: the same values on the integer
// and f32 units, where cvt.rna made K5's and K8's f32 grids 8-16% slower
// on the H100 (tools/torch_k5_probe.py, the grids probe). x - hi is exact.
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi,
                                           unsigned& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) +
        0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32 from split A (16 x 8) and B (8 x 8) fragments
__device__ __forceinline__ void mma_tf32x3(float* c, const unsigned* ah,
                                           const unsigned* al,
                                           const unsigned* bh,
                                           const unsigned* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// mma.sync rounds its f32 sums toward zero, so products summed straight
// into a long running sum drift by up to an ulp of it a step (K8's chains
// lost ~20x f32's accuracy so). c += a . b in 3xTF32 with the products
// summed from zero on the tensor cores, then added to c on the CUDA cores
// (rounded to nearest): a step's bias is an ulp of its own partial sum.
__device__ __forceinline__ void mma_tf32x3_add(float* c, const unsigned* ah,
                                               const unsigned* al,
                                               const unsigned* bh,
                                               const unsigned* bl) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32x3(t, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// n registers (of an ldsm_x4) split into hi and lo operands
template <int N>
__device__ __forceinline__ void split_n(const unsigned* r, unsigned* hi,
                                        unsigned* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(r[i], hi[i], lo[i]);
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
