// K7: the 2-branch emotion ResNet-50's stem on 112 px aligned faces.
//
// Replaces the TPU kernel vn_celeb_face_recognition_tpu/ops/
// emotion_stem_pallas.py:171 (emotion_stem_pallas, used by
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
// Bound on the H100: at K = 512 faces the folded conv is ~39.5 GFLOP
// (M = 512 * 112 * 112 positions, K = 48, N = 64): 0.040 ms on the
// tensor cores at 989 TFLOP/s; it must read ~77 MB of f32 faces and write
// ~206 MB of bf16 features (0.084 ms at 3.35 TB/s), so the function is
// bound by bytes.
//
// A thread block owns an 8x8 tile of the pooled output of one face: it
// stages the 20x20x3 face footprint, computes the 17x17x64 conv outputs
// the tile's pool windows cover (BN folded, ReLU; -inf outside the
// 112x112 conv map, the pool's padding), then takes the 3x3 maxima.
//
// bf16 output, emotion_stem_mma (the production line's path): the conv
// is an implicit GEMM on the tensor cores, mma.sync.m16n8k16 with f32
// sums (csrc/mma.cuh).
//   A: the im2col rows of the tile's 289 conv positions (padded to 19 m16
//      tiles; the padding rows repeat position 288 and are dropped), 48
//      wide (3 k16 steps, column (dy*4 + dx)*3 + c). A row's columns for
//      one dy are 12 contiguous values of the staged face, and a column
//      pair (k, k+1) never crosses a dy, so every A register is one
//      aligned 4-byte load: from the staged face when the position's
//      column is even, else from a copy shifted by one value. The im2col
//      rows are gathered straight into the fragments, never stored.
//   B: the folded weights in bf16 as [64][48] (n-major, k contiguous;
//      ops/emotion_stem.pack_stem_mma_weights), staged once per block by
//      cp.async into rows of a 112-byte pitch (eight ldmatrix rows in
//      distinct bank groups) and read by ldsm_x4.
//   Warps: 2 halves of N (32 channels) x 4 groups of m tiles (5, 5, 5, 4).
//   Epilogue in registers: f32 bias, ReLU, -inf off the conv map, bf16x2
//   stores into cbuf [289][72] bf16 (a 144-byte pitch: the eight rows of
//   one store in distinct banks). bf16 rounding is monotone, so the max of
//   the rounded values is the rounded max: staging cbuf in bf16 loses
//   nothing against rounding at the output, and halves it.
//   Pool: 8 channels (16 bytes) a thread, bf16x2 maxima, 16-byte stores.
//   Normalisation: x * 1/(255 std) + (-mean/std) (one FMA, no division),
//   rounded to bf16 where the A operand is formed.
// Shared memory a block: cbuf 41,616 + B 7,168 + two staged faces 4,800 +
// bias 256 = 53,840 bytes; with the 1 KB each block reserves, 4 blocks
// (219,456 bytes) fit an SM's 228 KB; __launch_bounds__(256, 4) holds the
// registers to 64 a thread, so 4 blocks (32 warps) an SM.
//
// f32 output, emotion_stem_tf32x3 (the shipped configs' dtype: CLI path
// b and demo_image launch it once a call at 112 px faces; and the
// card-vs-CPU check): the bf16 grid's tile as an implicit GEMM on the
// tensor cores in 3xTF32 (mma.sync.m16n8k8, csrc/mma.cuh).
// - Bound at CLI b's 64 faces: 9.6 MB of f32 faces in and 51.4 MB of f32
//   features out, 0.018 ms at 3.35 TB/s; the folded conv is 64 x 12,544
//   x 64 x 48 x 2 = 4.93 GFLOP, 0.030 ms as three TF32 products a
//   multiply-add at 495 TFLOP/s (the floor for f32-accurate work) and
//   0.074 ms at the 67 TFLOP/s f32 peak of the CUDA cores.
// - What held the old design back (PR 2's grid on the CUDA cores, 0.53
//   ms a CLI b chunk, ~6% of that floor): a float4 weight __ldg and a
//   shared load per 4 FMAs, 78,784 bytes of f32 face and cbuf a block,
//   two divisions per normalised value.
// - A: the im2col rows of the tile's 289 conv positions (19 m16 tiles, the
//   padding rows repeat position 288 and are dropped), K = 48 (6 k8
//   steps, column (dy*4 + dx)*3 + c), gathered straight from the staged,
//   normalised f32 face (one 4-byte shared load a value) and split into
//   tf32 hi and lo where the fragment is formed (split_tf32).
// - B: the folded weights [64][48] split into hi and lo on the host
//   (ops/emotion_stem.pack_stem_tf32x3_weights), staged once a block by
//   cp.async into rows of a 208-byte pitch (13 16-byte units, so the
//   eight rows of an ldmatrix fall in distinct bank groups).
// - Sums: each k8 step's 3 products (lo.hi, hi.lo, hi.hi) are summed from
//   zero on the tensor cores, whose f32 sums round toward zero, and added
//   on the CUDA cores (mma_tf32x3_add); the bias is added last. The CPU
//   emulation (tests/test_torch_tf32x3.py) chose the step length: the
//   whole K = 48 in one partial erred 8.2e-6 against the f64 product
//   (max|ref| 14.2), a partial a step 2.0e-6, below plain f32's 3.8e-6.
// - Warps: 2 halves of N (32 channels) x 4 groups of m tiles (5, 5, 5, 4).
// - Epilogue in registers: bias, ReLU, -inf off the conv map, float2
//   stores into an f32 cbuf [289][72] (a 288-byte pitch: the four rows of
//   a half-warp's 8-byte stores in distinct banks); then the 3x3/2 max
//   pool, 4 channels (16 bytes) a thread. The normalisation is the plain
//   version's (x / 255 - mean) / std, in f32.
// - Shared memory a block: cbuf 83,232 + B hi and lo 26,624 + face 4,800
//   + bias 256 = 114,912 bytes; with the 1 KB each block reserves, 2
//   blocks (231,872 bytes) fit an SM's 228 KB; __launch_bounds__(256, 2)
//   caps the registers at 128 a thread. -Xptxas -v (sm_90a): 126
//   registers, no spills.
// - Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's K7-f32 and
//   cli-k7-f32 lines, tools/torch_f32_grids_probe.py): 0.152-0.155 ms of
//   device time at CLI b's 64 faces (32 TFLOP/s, 19-20% of the floor),
//   against 0.528 ms for the CUDA-core grid in the same call (3.4x) and
//   1.56 ms for the plain version on cuDNN with TF32 off. Persistent
//   blocks that staged B once for all their tiles measured 2-3% slower:
//   a tile's staging, GEMM and pool phases, not B's copy, bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFace = 112, kConv = 112, kOut = 56, kCh = 64;
constexpr int kTile = 8;                  // pooled outputs per tile side
constexpr int kCR = 2 * kTile + 1;        // conv rows/cols per tile (17)
constexpr int kIR = kCR + 3;              // face rows/cols per tile (20)
constexpr int kTilesX = kOut / kTile;     // 7

// ---- bf16: the folded conv on the tensor cores ---------------------------

using bf16 = __nv_bfloat16;

constexpr int kK = 48;                    // column (dy*4 + dx)*3 + c
constexpr int kM = kCR * kCR;             // conv positions of a tile (289)
constexpr int kMTiles = (kM + 15) / 16;   // 19
constexpr int kFoot = kIR * kIR * 3;      // staged face values (1200)
constexpr int kBPitch = kK + 8;           // B row pitch, bf16 (112 bytes)
constexpr int kCPitch = kCh + 8;          // cbuf row pitch, bf16 (144 bytes)
constexpr int kMmaSmem =
    2 * (kM * kCPitch + kCh * kBPitch + 2 * kFoot) + 4 * kCh;
static_assert(kMmaSmem == 53840, "the header's shared-memory reckoning");

// x/255 normalised: x * (1 / (255 std)) + (-mean / std)
__device__ __forceinline__ float normalise(float x, int c) {
  const float s = c == 0 ? 1.f / (255.f * 0.229f)
                         : c == 1 ? 1.f / (255.f * 0.224f)
                                  : 1.f / (255.f * 0.225f);
  const float t = c == 0 ? -0.485f / 0.229f
                         : c == 1 ? -0.456f / 0.224f : -0.406f / 0.225f;
  return fmaf(x, s, t);
}

__device__ __forceinline__ unsigned hmax2u(unsigned a, unsigned b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<unsigned*>(&r);
}

__global__ void __launch_bounds__(kThreads, 4)
emotion_stem_mma(const float* __restrict__ faces,
                 const float* __restrict__ w,   // f32 fold: bias at 48 * 64
                 const bf16* __restrict__ wb,   // [64][48] bf16
                 bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cbuf = reinterpret_cast<bf16*>(smem_raw);   // [289][kCPitch]
  bf16* bsm = cbuf + kM * kCPitch;                  // [64][kBPitch]
  bf16* f0 = bsm + kCh * kBPitch;                   // [20][20][3]
  bf16* f1 = f0 + kFoot;                            // f1[j] = f0[j + 1]
  float* bias = reinterpret_cast<float*>(f1 + kFoot);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k = blockIdx.y;
  const int tile_y = blockIdx.x / kTilesX;
  const int py0 = tile_y * kTile;
  const int px0 = (blockIdx.x - tile_y * kTilesX) * kTile;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // conv-map origin
  const int fy0 = cy0 - 2, fx0 = cx0 - 2;          // face origin

  // B: 64 rows of 96 bytes (6 16-byte pieces), once per block
  for (int i = tid; i < kCh * 6; i += kThreads) {
    const int row = i / 6, part = i - 6 * row;
    cp_async16(bsm + row * kBPitch + part * 8, wb + row * kK + part * 8);
  }
  cp_async_commit();
  if (tid < kCh) bias[tid] = __ldg(w + kK * kCh + tid);

  // the face footprint, normalised, in bf16; a footprint row is 60
  // contiguous floats of the face
  const float* face = faces + (size_t)k * kFace * kFace * 3;
  for (int i = tid; i < kFoot; i += kThreads) {
    const int fr = i / (kIR * 3);
    const int e = i - fr * (kIR * 3);
    const int px = e / 3, c = e - 3 * px;
    const int gy = fy0 + fr, gx = fx0 + px;
    float v = 0.f;
    if ((unsigned)gy < (unsigned)kFace && (unsigned)gx < (unsigned)kFace)
      v = normalise(__ldg(face + (gy * kFace + gx) * 3 + c), c);
    const bf16 h = __float2bfloat16(v);
    f0[i] = h;
    if (i > 0) f1[i - 1] = h;
  }
  if (tid == 0) f1[kFoot - 1] = __float2bfloat16(0.f);
  cp_async_wait_all();
  __syncthreads();

  // ---- the conv: 19 m tiles x 64 channels, K = 48 ------------------------
  const int gq = lane >> 2, tq = lane & 3;
  const int nh = warp & 1, mg = warp >> 1;
  // element offsets, from a position's first face value, of this lane's
  // column pairs ks * 16 + hf * 8 + 2 tq (+1): face row dy, then 2 values
  // of the 12 that row contributes
  int koff[3][2];
#pragma unroll
  for (int ks = 0; ks < 3; ++ks)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kk = ks * 16 + hf * 8 + 2 * tq;
      const int dy = kk / 12;
      koff[ks][hf] = dy * kIR * 3 + kk - 12 * dy;
    }
  const unsigned* w0 = reinterpret_cast<const unsigned*>(f0);
  const unsigned* w1 = reinterpret_cast<const unsigned*>(f1);
  float bia[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bia[j][0] = bias[nh * 32 + j * 8 + 2 * tq];
    bia[j][1] = bias[nh * 32 + j * 8 + 2 * tq + 1];
  }
  const bf16* b_lane = bsm + (nh * 32 + 8 * (lane >> 4) + (lane & 7)) *
                                 kBPitch + 8 * ((lane >> 3) & 1);

  for (int mt = mg; mt < kMTiles; mt += 4) {
    int base[2];
    const unsigned* src[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = min(mt * 16 + gq + 8 * hh, kM - 1);
      const int r = m / kCR, q = m - kCR * r;
      base[hh] = (r * kIR + q) * 3;  // odd exactly when q is
      src[hh] = (q & 1) ? w1 : w0;
    }
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      unsigned a[4];
      a[0] = src[0][(base[0] + koff[ks][0]) >> 1];
      a[1] = src[1][(base[1] + koff[ks][0]) >> 1];
      a[2] = src[0][(base[0] + koff[ks][1]) >> 1];
      a[3] = src[1][(base[1] + koff[ks][1]) >> 1];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned b[4];
        ldsm_x4(b, b_lane + jp * 16 * kBPitch + ks * 16);
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = mt * 16 + gq + 8 * hh;
      if (m >= kM) continue;
      const int r = m / kCR, q = m - kCR * r;
      const bool ok = (unsigned)(cy0 + r) < (unsigned)kConv &&
                      (unsigned)(cx0 + q) < (unsigned)kConv;
      bf16* row = cbuf + m * kCPitch + nh * 32 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v0 = ok ? fmaxf(acc[j][2 * hh] + bia[j][0], 0.f)
                            : -INFINITY;
        const float v1 = ok ? fmaxf(acc[j][2 * hh + 1] + bia[j][1], 0.f)
                            : -INFINITY;
        *reinterpret_cast<unsigned*>(row + j * 8) = pack2f(v0, v1);
      }
    }
  }
  __syncthreads();

  // ---- 3x3/2 max pool, 8 channels a thread -------------------------------
  bf16* dst = out + (size_t)k * kOut * kOut * kCh;
  for (int i = tid; i < kTile * kTile * 8; i += kThreads) {
    const int g = i & 7, p = i >> 3;
    const int r = p >> 3, q = p & 7;
    const bf16* s = cbuf + (2 * r * kCR + 2 * q) * kCPitch + g * 8;
    uint4 m = *reinterpret_cast<const uint4*>(s);
#pragma unroll
    for (int sy = 0; sy < 3; ++sy)
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        if (sy == 0 && sx == 0) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(
            s + (sy * kCR + sx) * kCPitch);
        m.x = hmax2u(m.x, v.x);
        m.y = hmax2u(m.y, v.y);
        m.z = hmax2u(m.z, v.z);
        m.w = hmax2u(m.w, v.w);
      }
    *reinterpret_cast<uint4*>(
        dst + ((size_t)(py0 + r) * kOut + px0 + q) * kCh + g * 8) = m;
  }
}

int launch_mma(const float* faces, const float* w, bf16* out, int k,
               cudaStream_t stream) {
  if (((uintptr_t)w | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(
      emotion_stem_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMmaSmem);
  if (e != cudaSuccess) return (int)e;
  // the bf16 B follows the f32 fold (3136 floats: 12,544 bytes)
  const bf16* wb = reinterpret_cast<const bf16*>(w + kK * kCh + kCh);
  dim3 grid(kTilesX * kTilesX, k);
  emotion_stem_mma<<<grid, kThreads, kMmaSmem, stream>>>(faces, w, wb, out);
  return (int)cudaGetLastError();
}

// ---- f32: the folded conv on the tensor cores in 3xTF32 ------------------

constexpr int kTfBPitch = kK + 4;         // B row pitch, floats (208 bytes)
constexpr int kTfCPitch = kCh + 8;        // cbuf row pitch, floats
constexpr int kTfSmem =
    4 * (kM * kTfCPitch + 2 * kCh * kTfBPitch + kFoot + kCh);
static_assert(kTfSmem == 114912, "the header's shared-memory reckoning");

__global__ void __launch_bounds__(kThreads, 2)
emotion_stem_tf32x3(const float* __restrict__ faces,
                    const float* __restrict__ w,   // f32 fold: bias at 48 * 64
                    const float* __restrict__ wt,  // [2][64][48] hi, lo
                    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cbuf = reinterpret_cast<float*>(smem_raw);  // [289][kTfCPitch]
  float* bsm = cbuf + kM * kTfCPitch;                // 2 x [64][kTfBPitch]
  float* fsm = bsm + 2 * kCh * kTfBPitch;            // [20][20][3]
  float* bias = fsm + kFoot;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k = blockIdx.y;
  const int tile_y = blockIdx.x / kTilesX;
  const int py0 = tile_y * kTile;
  const int px0 = (blockIdx.x - tile_y * kTilesX) * kTile;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // conv-map origin
  const int fy0 = cy0 - 2, fx0 = cx0 - 2;          // face origin

  // B: 128 rows (hi, then lo) of 192 bytes (12 16-byte pieces), once
  for (int i = tid; i < 2 * kCh * 12; i += kThreads) {
    const int row = i / 12, part = i - 12 * row;
    cp_async16(bsm + row * kTfBPitch + part * 4, wt + row * kK + part * 4);
  }
  cp_async_commit();
  if (tid < kCh) bias[tid] = __ldg(w + kK * kCh + tid);

  // the face footprint, normalised as the plain version does, in f32
  const float* face = faces + (size_t)k * kFace * kFace * 3;
  for (int i = tid; i < kFoot; i += kThreads) {
    const int fr = i / (kIR * 3);
    const int e = i - fr * (kIR * 3);
    const int px = e / 3, c = e - 3 * px;
    const int gy = fy0 + fr, gx = fx0 + px;
    float v = 0.f;
    if ((unsigned)gy < (unsigned)kFace && (unsigned)gx < (unsigned)kFace) {
      const float mean = c == 0 ? 0.485f : c == 1 ? 0.456f : 0.406f;
      const float stdv = c == 0 ? 0.229f : c == 1 ? 0.224f : 0.225f;
      v = (__ldg(face + (gy * kFace + gx) * 3 + c) / 255.f - mean) / stdv;
    }
    fsm[i] = v;
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- the conv: 19 m tiles x 64 channels, K = 48 in 6 k8 steps ----------
  const int gq = lane >> 2, tq = lane & 3;
  const int nh = warp & 1, mg = warp >> 1;
  // face offsets, from a position's first value, of this lane's A columns
  // k = ks * 8 + tq (+ 4): face row dy, then value k - 12 dy of its 12
  int koff[6][2];
#pragma unroll
  for (int ks = 0; ks < 6; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = ks * 8 + tq + 4 * h;
      const int dy = kk / 12;
      koff[ks][h] = dy * kIR * 3 + kk - 12 * dy;
    }
  float bia[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bia[j][0] = bias[nh * 32 + j * 8 + 2 * tq];
    bia[j][1] = bias[nh * 32 + j * 8 + 2 * tq + 1];
  }
  const float* b_lane = bsm + (nh * 32 + 8 * (lane >> 4) + (lane & 7)) *
                                  kTfBPitch + 4 * ((lane >> 3) & 1);

  for (int mt = mg; mt < kMTiles; mt += 4) {
    int base[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = min(mt * 16 + gq + 8 * hh, kM - 1);
      const int r = m / kCR, q = m - kCR * r;
      base[hh] = (r * kIR + q) * 3;
    }
    // each k8 step summed from zero on the tensor cores (header: Sums)
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 6; ++ks) {
      // a0 (row gq, k tq), a1 (row gq+8, k tq), a2 (row gq, k tq+4),
      // a3 (row gq+8, k tq+4)
      unsigned v[4], ah[4], al[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = __float_as_uint(fsm[base[q & 1] + koff[ks][q >> 1]]);
      split_n<4>(v, ah, al);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned bh[4], bl[4];
        const float* bp = b_lane + jp * 16 * kTfBPitch + ks * 8;
        ldsm_x4(bh, bp);
        ldsm_x4(bl, bp + kCh * kTfBPitch);
        mma_tf32x3_add(acc[2 * jp], ah, al, bh, bl);
        mma_tf32x3_add(acc[2 * jp + 1], ah, al, bh + 2, bl + 2);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = mt * 16 + gq + 8 * hh;
      if (m >= kM) continue;
      const int r = m / kCR, q = m - kCR * r;
      const bool ok = (unsigned)(cy0 + r) < (unsigned)kConv &&
                      (unsigned)(cx0 + q) < (unsigned)kConv;
      float* row = cbuf + m * kTfCPitch + nh * 32 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(row + j * 8) = make_float2(
            ok ? fmaxf(acc[j][2 * hh] + bia[j][0], 0.f) : -INFINITY,
            ok ? fmaxf(acc[j][2 * hh + 1] + bia[j][1], 0.f) : -INFINITY);
    }
  }
  __syncthreads();

  // ---- 3x3/2 max pool, 4 channels a thread -------------------------------
  float* dst = out + (size_t)k * kOut * kOut * kCh;
  for (int i = tid; i < kTile * kTile * 16; i += kThreads) {
    const int g = i & 15, p = i >> 4;
    const int r = p >> 3, q = p & 7;
    const float* s = cbuf + (2 * r * kCR + 2 * q) * kTfCPitch + g * 4;
    float4 m = *reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int sy = 0; sy < 3; ++sy)
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        if (sy == 0 && sx == 0) continue;
        const float4 v = *reinterpret_cast<const float4*>(
            s + (sy * kCR + sx) * kTfCPitch);
        m = make_float4(fmaxf(m.x, v.x), fmaxf(m.y, v.y), fmaxf(m.z, v.z),
                        fmaxf(m.w, v.w));
      }
    *reinterpret_cast<float4*>(
        dst + ((size_t)(py0 + r) * kOut + px0 + q) * kCh + g * 4) = m;
  }
}

int launch_tf32x3(const float* faces, const float* w, float* out, int k,
                  cudaStream_t stream) {
  if (((uintptr_t)w | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t e = cudaFuncSetAttribute(
      emotion_stem_tf32x3, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTfSmem);
  if (e != cudaSuccess) return (int)e;
  // the split B follows the f32 fold (3136 floats: 12,544 bytes)
  const float* wt = w + kK * kCh + kCh;
  dim3 grid(kTilesX * kTilesX, k);
  emotion_stem_tf32x3<<<grid, kThreads, kTfSmem, stream>>>(faces, w, wt,
                                                           out);
  return (int)cudaGetLastError();
}

}  // namespace

// faces [K, 112, 112, 3] f32 (0-255) -> out [K, 56, 56, 64]. weights: the
// f32 fold [48*64 + 64] followed by the B operand: for bf16 output
// (out_bf16) [64][48] bf16, for f32 output [2][64][48] f32 (tf32 hi, lo);
// the whole buffer 16-byte aligned. One launch on `stream`, no
// synchronisation; returns cudaGetLastError().
extern "C" int vn_emotion_stem(const float* faces, const float* weights,
                               void* out, int k, int out_bf16,
                               void* stream) {
  if (k <= 0) return 0;
  if (k > 65535) return (int)cudaErrorInvalidConfiguration;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) return launch_mma(faces, weights, (bf16*)out, k, st);
  return launch_tf32x3(faces, weights, (float*)out, k, st);
}
