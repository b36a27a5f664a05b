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
// A pair whose plain IoU is NaN (a NaN coordinate, or inf - inf in a
// width, area or denominator) does not overlap, since NaN > thr is false.
//
// Bound on the H100: the function reads 21 bytes and writes 1 byte per
// box, and needs one IoU test per valid box and kept box ahead of it (up
// to the first that suppresses it). At the stock line's per-scale shape
// (1,408 sets of 448 clustered candidates) that is 13.9 MB and ~1.5e7
// tests: bound by bytes, ~4 us. What sets the time is the greedy scan's
// serial chain within a set and the IoU tests' IEEE divisions.
//
// Design: one thread block per set, in four phases.
//  1. Load and compact: the rows that take part in the order (valid, score
//     not NaN) get their place in a compact list by a block prefix sum
//     (warp ballots), in row order. Each holds a 64-bit key: the score's
//     bits made descending and order-preserving (-0.0 counted as +0.0, as
//     the plain version's compare does), then the row.
//  2. Order check, then sort only when needed: when the keys' score bits
//     never rise along the list, the list is already in priority order
//     (the cascade's sets after a top-k, RetinaFace's), a box's rank is
//     its place, and nothing is sorted. Otherwise a bitonic network whose
//     comparators all put the smaller key first sorts the nv keys in
//     place; slots past nv count as +inf and are never touched, so the
//     network spans the next power of two of nv but stores only nv keys.
//     Each rank then gathers its box from device memory by its row, and
//     its key slot is reused for (row, area).
//  3. Greedy scan in tiles of 32 ranks, two barriers a tile:
//     (a) first every warp at once builds each rank's 32-bit mask of the
//         earlier ranks in its tile whose box would suppress its own (the
//         masks do not depend on the scan, so they stay off its serial
//         chain);
//     (b) warp 0 settles a tile's keep bits alone, with no IoU test and
//         no block barrier: the lowest live lane is kept, one
//         __ballot_sync of the lanes whose mask holds it drops them, and
//         __ffs jumps to the next live lane (at most 32 steps). The kept
//         boxes (at most 32) go to a buffer in shared memory;
//     (c) the whole block tests every live later rank against those kept
//         boxes, four tests in flight a thread, up to the first group of
//         four that holds a hit.
//     The scan ends early when no live rank is left.
//  4. Launches of fewer sets than the card has SMs run wider blocks (up
//     to one thread per box, 1,024 at most), so the few busy SMs spread
//     each tile's tests and each sort step over more threads.
//
// Shared memory: 29 bytes a box (box 16, key or row + area 8, tile mask
// 4, suppressed flag 1) plus 772 bytes of tile buffers: 223,492 bytes at
// ops.nms.MAX_K = 7,680, under the 232,448 a block may have.
//
// Exactness: the IoU is computed in the plain version's order with
// explicitly rounded operations (no FMA contraction) and IEEE division:
//   area = (x2 - x1 + off) * (y2 - y1 + off)
//   inter = max(rb - lt + off, 0) products
//   denom = a + b - inter (or min(a, b)); iou = inter / max(denom, 1e-12)
// with NaN passed on where the plain version passes it on (see `overlaps`).
// Two screens that provably give the same answer skip the IEEE division
// in clear cases (see `overlaps`).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;
constexpr int kMaxThreads = 1024;
constexpr int kNarrowThreads = 256;

// The suppression test's parameters. thr_lo and thr_hi bound the band
// around thr in which the approximate quotient cannot decide.
struct IouTest {
  float off, thr, thr_lo, thr_hi;
  int min_mode;
};

__device__ __forceinline__ IouTest make_test(float thr, float off,
                                             int min_mode) {
  // the screen runs for a positive, normal, finite threshold only
  const bool screen = thr >= 0x1p-100f && thr <= 0x1p100f;
  return {off, thr, screen ? __fmul_rn(thr, 1.f - 0x1p-20f) : -INFINITY,
          screen ? __fmul_rn(thr, 1.f + 0x1p-20f) : INFINITY, min_mode};
}

__device__ __forceinline__ float area_of(float4 b, float off) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), off),
                   __fadd_rn(__fsub_rn(b.w, b.y), off));
}

// iou(a, b) > thr, exactly as the plain version computes it. The plain
// version's maximum, minimum and clamp pass a NaN on, where fminf and fmaxf
// drop it; so wherever its IoU is NaN (and NaN > thr is false) this returns
// false first: a NaN coordinate (which makes its box's area NaN), a NaN
// width or height (inf - inf), intersection (inf * 0) or denominator
// (inf + inf - inf). Past that check no operand is NaN and fminf/fmaxf are
// the plain version's operations. Two screens then decide the clear cases
// without the IEEE division, and give the same answer: an empty
// intersection makes the quotient +-0 (the denominator is at least 1e-12
// or +inf after fmaxf); and __fdividef is within 2 ulp (2^-22 relative) of
// the quotient for denominators up to 2^126, so a result outside
// thr (1 +- 2^-20) rounds to the same side of thr.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, const IouTest& t) {
  const float wr =
      __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), t.off);
  const float hr =
      __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), t.off);
  const float inter = __fmul_rn(fmaxf(wr, 0.f), fmaxf(hr, 0.f));
  const float dr = t.min_mode ? fminf(area_a, area_b)
                              : __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (isnan(area_a) | isnan(area_b) | isnan(wr) | isnan(hr) | isnan(inter) |
      isnan(dr))
    return false;
  if (inter == 0.f) return 0.f > t.thr;
  const float denom = fmaxf(dr, 1e-12f);
  if (denom < 0x1p100f) {
    const float q = __fdividef(inter, denom);
    if (q > t.thr_hi) return true;
    if (q < t.thr_lo) return false;
  }
  return __fdiv_rn(inter, denom) > t.thr;
}

// Bits of a non-NaN score that sort descending as unsigned integers;
// -0.0 and +0.0 get the same bits.
__device__ __forceinline__ uint32_t descending_bits(float s) {
  const uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? u : ~(u | 0x80000000u);
}

__device__ __forceinline__ void order_pair(uint64_t* key, int lo, int hi) {
  const uint64_t a = key[lo], b = key[hi];
  if (a > b) {
    key[lo] = b;
    key[hi] = a;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    nms_keep_tiled(const float4* __restrict__ boxes,
                   const float* __restrict__ scores,
                   const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, int k, float thr, float off,
                   int min_mode) {
  extern __shared__ float4 smem4[];
  float4* sbox = smem4;                                     // [k] by rank
  uint64_t* key = reinterpret_cast<uint64_t*>(sbox + k);    // [k] by rank
  uint32_t* row_area = reinterpret_cast<uint32_t*>(key);    // after sort
  uint32_t* in_tile = reinterpret_cast<uint32_t*>(key + k); // [k] by rank
  uint8_t* sup = reinterpret_cast<uint8_t*>(in_tile + k);   // [k] by rank
  __shared__ int warp_count[kMaxThreads / 32];
  __shared__ float4 kept_box[kTile];
  __shared__ float kept_area[kTile];
  __shared__ int n_kept;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const size_t base = (size_t)blockIdx.x * k;
  const float4* bx = boxes + base;
  const float* sc = scores + base;
  const uint8_t* vl = valid + base;
  const IouTest test = make_test(thr, off, min_mode);

  // -- phase 1: load and compact, in row order
  int nv = 0;
  for (int c = 0; c < k; c += threads) {
    const int i = c + tid;
    float s = 0.f;
    bool ordered = false;
    if (i < k) {
      s = sc[i];
      ordered = vl[i] && !isnan(s);
    }
    const unsigned m = __ballot_sync(kFull, ordered);
    if (lane == 0) warp_count[warp] = __popc(m);
    __syncthreads();
    int at = nv;
    for (int w = 0; w < warps; ++w) {
      const int n = warp_count[w];
      if (w < warp) at += n;
      nv += n;
    }
    if (ordered)
      key[at + __popc(m & ((1u << lane) - 1u))] =
          ((uint64_t)descending_bits(s) << 32) | (uint32_t)i;
    __syncthreads();
  }

  // -- phase 2: order check, then sort only when needed
  int disorder = 0;
  for (int p = tid + 1; p < nv; p += threads)
    disorder |= (key[p - 1] >> 32) > (key[p] >> 32);
  if (__syncthreads_or(disorder)) {
    int span = 1;
    while (span < nv) span <<= 1;
    for (int size = 2; size <= span; size <<= 1) {
      const int half = size >> 1;
      for (int i = tid; i < (span >> 1); i += threads) {
        const int j = i & (half - 1);
        const int lo = (i - j) * 2 + j;
        const int hi = lo + size - 1 - 2 * j;  // mirror in the block
        if (hi < nv) order_pair(key, lo, hi);
      }
      __syncthreads();
      for (int stride = size >> 2; stride > 0; stride >>= 1) {
        for (int i = tid; i < (span >> 1); i += threads) {
          const int lo = 2 * i - (i & (stride - 1));
          const int hi = lo + stride;
          if (hi < nv) order_pair(key, lo, hi);
        }
        __syncthreads();
      }
    }
  }
  for (int r = tid; r < nv; r += threads) {
    const float4 b = bx[row_area[2 * r]];
    sbox[r] = b;
    row_area[2 * r + 1] = __float_as_uint(area_of(b, off));
    sup[r] = 0;
  }
  __syncthreads();

  // -- phase 3: greedy scan in tiles of 32 ranks
  // Each rank's mask of the earlier ranks in its tile whose box would
  // suppress its own: independent of the scan, so every warp builds them
  // at once, a tile a warp.
  for (int u = warp; u * kTile < nv; u += warps) {
    const int r = u * kTile + lane;
    if (r < nv) {
      const float4 b = sbox[r];
      const float a = __uint_as_float(row_area[2 * r + 1]);
      uint32_t m = 0;
      for (int j = 0; j < lane; ++j) {
        const int e = u * kTile + j;
        m |= (uint32_t)overlaps(sbox[e], __uint_as_float(row_area[2 * e + 1]),
                                b, a, test) << j;
      }
      in_tile[r] = m;
    }
  }
  __syncthreads();

  // Then, tile by tile: warp 0 settles the tile, whose live ranks have
  // met every kept box of the tiles before it, with no IoU test and no
  // block barrier: the lowest live lane is kept, one ballot drops the
  // lanes whose mask holds it, and __ffs jumps to the next. The kept boxes
  // go to kept_box in rank order.
  auto resolve = [&](int u) {
    const int r = u * kTile + lane;
    const bool live = r < nv && !sup[r];
    const uint32_t m = live ? in_tile[r] : 0u;
    unsigned rem = __ballot_sync(kFull, live), kept = 0;
    while (rem) {
      const int f = __ffs(rem) - 1;
      kept |= 1u << f;
      rem &= (rem - 1) & ~__ballot_sync(kFull, (m >> f) & 1u);
    }
    if ((kept >> lane) & 1u) {
      const int j = __popc(kept & ((1u << lane) - 1u));
      kept_box[j] = sbox[r];
      kept_area[j] = __uint_as_float(row_area[2 * r + 1]);
    } else if (live) {
      sup[r] = 1;
    }
    if (lane == 0) n_kept = __popc(kept);
  };

  // After each tile the whole block tests every live later rank against
  // its kept boxes, four tests in flight a thread, up to the first group
  // of four that holds a hit; two barriers a tile.
  const int tiles = (nv + kTile - 1) / kTile;
  if (warp == 0 && tiles > 0) resolve(0);
  __syncthreads();
  for (int u = 0; u + 1 < tiles; ++u) {
    const int n_k = n_kept;
    int more = 0;
    for (int q = (u + 1) * kTile + tid; q < nv; q += threads) {
      if (sup[q]) continue;
      const float4 b = sbox[q];
      const float a = __uint_as_float(row_area[2 * q + 1]);
      bool hit = false;
      for (int j = 0; j < n_k && !hit; j += 4)  // j + 3 < kTile
        hit = overlaps(kept_box[j], kept_area[j], b, a, test) |
              ((j + 1 < n_k) &
               overlaps(kept_box[j + 1], kept_area[j + 1], b, a, test)) |
              ((j + 2 < n_k) &
               overlaps(kept_box[j + 2], kept_area[j + 2], b, a, test)) |
              ((j + 3 < n_k) &
               overlaps(kept_box[j + 3], kept_area[j + 3], b, a, test));
      if (hit) {
        sup[q] = 1;
      } else {
        more |= q >= (u + 2) * kTile;
      }
    }
    const int go = __syncthreads_or(more);
    if (warp == 0) resolve(u + 1);
    __syncthreads();
    if (!go) break;  // every rank after tile u + 1 suppressed
  }

  // -- output, in row order
  uint8_t* out = keep + base;
  for (int i = tid; i < k; i += threads) {
    const uint8_t v = vl[i];
    if (!v || isnan(sc[i])) out[i] = v;  // invalid, or NaN: never compared
  }
  for (int r = tid; r < nv; r += threads) out[row_area[2 * r]] = !sup[r];
}

}  // namespace

// Shared memory the kernel needs for sets of k boxes (beyond its static
// tile buffers).
static size_t nms_smem_bytes(int k) {
  return (size_t)k * (sizeof(float4) + sizeof(uint64_t) + sizeof(uint32_t) +
                      1);
}

// Threads a block: one per box rounded up to a warp, at least two warps;
// at most 256 when the launch has a set for every SM, else (few sets, each
// alone on its SM) up to 1,024.
static int nms_threads(int n, int k, int sms) {
  const int fit = k < 64 ? 64 : (k + 31) / 32 * 32;
  const int most = n < sms ? kMaxThreads : kNarrowThreads;
  return fit < most ? fit : most;
}

// boxes [n, k, 4] f32, scores [n, k] f32, valid [n, k] bool (one byte, 0
// or 1) -> keep [n, k] bool. One launch on `stream`, no synchronisation;
// returns cudaGetLastError().
extern "C" int vn_nms_keep_mask(const float* boxes, const float* scores,
                                const uint8_t* valid, uint8_t* keep, int n,
                                int k, float thr, float off, int min_mode,
                                void* stream) {
  if (n <= 0 || k <= 0) return 0;
  int e = vn_set_device_of(keep);
  if (e != 0) return e;
  int device = 0, sms = 0;
  cudaError_t ce = cudaGetDevice(&device);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                device);
  if (ce != cudaSuccess) return (int)ce;
  const size_t smem = nms_smem_bytes(k);
  ce = cudaFuncSetAttribute(nms_keep_tiled,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  nms_keep_tiled<<<n, nms_threads(n, k, sms), smem,
                   (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, valid, keep, k, thr,
      off, min_mode);
  return (int)cudaGetLastError();
}
