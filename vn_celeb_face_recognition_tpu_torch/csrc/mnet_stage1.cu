// K6: RetinaFace MobileNetV1-0.25 stage 1 from uint8 frames.
//
// Replaces the TPU kernels vn_celeb_face_recognition_tpu/ops/
// planar_s1_pallas.py:306 (planar_stage1_pallas) and
// planar_s1_pallas_v2.py:257 (planar_stage1_pallas_v2). Those lay the
// image out as flattened lanes with space-to-depth phase planes and rolls
// because a TPU core tiles channels to 128 lanes; this kernel computes
// the function itself: six blocks (conv 3x3/2 3->8, then depthwise-
// separable blocks 8->16/1, 16->32/2, 32->32/1, 32->64/2, 64->64/1), each
// with inference BatchNorm (folded to a per-channel mul/add on the host)
// and LeakyReLU(0.1), on frames minus the channel means, zero padding of 1
// everywhere.
//
// Bound on the H100: at 128 frames of 640x640 the stage does ~35 GFLOP
// (~275 MFLOP a frame, 66% of it pointwise) and must move ~157 MB of
// frames in and ~105 MB of bf16 features out: 0.078 ms at 3.35 TB/s,
// against 0.036 ms of bf16 operations, so the function is bound by bytes.
// Three launches, one per stride-2 segment (blocks 0-1, 2-3, 4-5), write
// and read the two segment outputs once more (scratch1 [128, 320, 320,
// 16] bf16 419 MB, scratch2 [128, 160, 160, 32] 210 MB): 1.52 GB, 0.454
// ms, the floor of this three-launch design. Per segment (bytes in + out
// at 3.35 TB/s; FLOPs at 989 TFLOP/s):
//   segment 1: 577 MB, 10.9 GFLOP -> 0.172 ms (bytes)
//   segment 2: 629 MB, 12.9 GFLOP -> 0.188 ms (bytes)
//   segment 3: 315 MB, 11.5 GFLOP -> 0.094 ms (bytes)
//
// Every launch: a thread block (8 warps) owns a TH x TW tile of its
// segment's output for one frame. It stages the input footprint (2*TH+5
// x 2*TW+5 incl. the halo), computes the stride-2 block on the (TH+2) x
// (TW+2) stage-A cells (the tile plus the one-cell halo the stride-1
// depthwise needs, zero outside the map: that depthwise's padding), then
// the stride-1 block on the tile, and writes it. Only the segment outputs
// go through device memory. Any H and W work: edges are masked.
//
// bf16 output (the production line): segment_mma_first (segment 1) and
// segment_mma (segments 2, 3).
//   - Weights: staged into shared memory once per block: the pointwise
//     weights and conv0 as bf16 [out][in] by cp.async into rows of a
//     padded pitch (in + 8: ldmatrix rows in distinct bank groups), packed
//     by ops/planar_s1.pack_stage1_mma_weights; depthwise taps and BN
//     mul/add in f32. No weight is read from device memory in a loop.
//   - Input: staged as bf16. Segments 2-3 copy the bf16 scratch by 16-byte
//     cp.async pieces (a pixel is 32 or 64 bytes), zero-filled off the
//     map. Segment 1 copies each frame row's span as aligned 16-byte
//     cp.async pieces (zero-filled past the tensor's end), then a warp a
//     row, a lane a pixel, converts it to frame - means in bf16 (exact:
//     integers below 256). The staging and depthwise loops walk rows and
//     columns, stepping by constants: no / or % by a width that is not a
//     power of two (a GEMM epilogue decodes its two rows once per m tile).
//   - Depthwise 3x3: CUDA cores, two channels a thread (bf16x2 or float2
//     loads, f32 sums), BN + LeakyReLU, written as the A tile [pixels]
//     [C + 8].
//   - Pointwise convs and conv0: mma.sync.m16n8k16 GEMMs (csrc/mma.cuh),
//     M = the tile's pixels or stage-A cells (padded to 16; padding rows
//     repeat the last and are dropped), K = C_in (8 padded to 16 in
//     block 1; conv0's 27 taps x channels padded to 32, its A rows
//     gathered from the staged frame), N = C_out, f32 sums.
//   - Precision: this stage amplifies rounding. With the vendored fitted
//     weights on the bench frames, rounding the GEMM operands and the
//     stage-A maps to bf16 gives a relative L2 error of 1.37e-2 against
//     the f32 function (the CPU emulation in tests/test_torch_stem_mma.py),
//     above chip_smoke's 1e-2; the f32 kernel, which rounds only the two
//     scratch tensors and the output, gives 0.72e-2. So every GEMM operand
//     is split, x = hi + lo with hi = bf16(x) and lo = bf16(x - hi) (the
//     weights on the host, the A tiles where the depthwise writes them),
//     and each product is three mma.sync (hi.hi + lo.hi + hi.lo; lo.lo is
//     below 2^-16 of it); conv0's A (frame - means) is exact, so conv0
//     takes two. The stage-A maps (conv0's output, and the stride-2
//     blocks' in segments 2-3) stay f32 in shared memory. The error is
//     then the bf16 scratch's and output's, 0.72e-2, as before. The
//     tensor cores do 3x the products; they are not what bounds this.
//   - Epilogues in registers: BN mul/add, LeakyReLU; stage A's to the f32
//     map in shared memory, stage B's as bf16 rows into shared memory,
//     then stored to device memory 16 bytes a thread.
//   - Tiles: segment 1 16x16, segment 2 8x16 (8x8 before: 10x10 stage-A
//     cells for 8x8 pixels, a 1.56x recompute of the stride-2 block),
//     segment 3 8x8 (8x16 would take 161 KB: 1 block an SM). Shared
//     memory, blocks an SM (of 228 KB, 1 KB reserved per block; the
//     register cap of __launch_bounds__ in brackets), stride-2 recompute:
//       segment 1: 51,424 B, 4 (64 registers), conv0 on 18x18 cells 1.27x
//       segment 2: 81,760 B, 2 (128 registers), 10x18 cells 1.41x
//       segment 3: 106,944 B, 2 (128 registers), 10x10 cells 1.56x
//
// f32 output (the shipped configs' dtype: CLI path b, every RetinaFace
// library call, demo_image and each cli.fit_detector evaluation launch it;
// and the card-vs-CPU check): segment_tf32_first and segment_tf32, the
// bf16 grids' segments and tiles with every GEMM in 3xTF32 (mma.sync
// m16n8k8, csrc/mma.cuh) and every tensor f32.
//   - Bound at the fit's 8 x 640 x 640: 2.2 GFLOP (0.033 ms at the f32
//     peak; 83% of it conv0 and the pointwise convs, 0.011 ms as three TF32
//     products at 495 TFLOP/s). The function moves 9.8 MB of frames in and
//     13.1 MB of f32 features out (0.007 ms at 3.35 TB/s); this three-launch
//     design also writes and reads back scratch1 (52.4 MB) and scratch2
//     (26.2 MB), 180 MB in all: 0.054 ms, its floor, bound by bytes.
//   - What held the old design back (PR 2's grid on the CUDA cores,
//     0.315-0.326 ms at the fit's shape): a weight __ldg per FMA in conv0
//     and a float4 __ldg + a shared load per 4 FMAs in the pointwise loops;
//     shared reads at stride C_in across a warp; a / and % per staged
//     element; 94.8 KB of f32 staging for segment 3's tile.
//   - conv0: A is frame minus the channel means, integers below 256 and so
//     exact in TF32: only B is split (on the host), two products a k8 step
//     (lo, then hi), its fragments held in registers. The wrapper raises on
//     means that are not integers in [0, 255].
//   - Pointwise convs: A tiles f32 in shared memory (pitch C + 4 floats, so
//     an ldmatrix's eight rows fall in distinct bank groups), split into
//     tf32 hi and lo as they are loaded; B split on the host
//     (ops/planar_s1.pack_stage1_tf32x3_weights) and staged by cp.async;
//     three products a k8 step (lo.hi, hi.lo, hi.hi).
//   - Sums: each k8 step's products are summed from zero on the tensor
//     cores, whose f32 sums round toward zero, and added on the CUDA cores
//     (mma_tf32x3_add; conv0 likewise with its two); then BN's mul/add. In
//     the CPU emulation (tests/test_torch_tf32x3.py) a GEMM's whole K (8-64)
//     in one partial erred up to 6x more against f64 (pw5: 3.7e-6 against
//     5.9e-7, max|ref| 5.1; plain f32 1.2e-6).
//   - Depthwise 3x3s on the CUDA cores in f32, two channels a thread, as in
//     the bf16 grids. scratch1, scratch2 and the output stay f32.
//   - Shared memory, blocks an SM (register cap in brackets):
//       segment 1: 49,472 B, 4 (64 registers)
//       segment 2: 109,888 B, 2 (128 registers)
//       segment 3: 158,144 B, 1 (255 registers): its f32 input footprint
//         (56,448 B) and split B operands (53,248 B) leave no room for two.
//     -Xptxas -v (sm_90a): segment 1 61 registers, segment 2 127,
//     segment 3 239; no spills.
//   - Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's K6-f32,
//     fit-k6 and cli-k6-f32 lines, tools/torch_f32_grids_probe.py):
//     0.222-0.226 ms of device time at 8 x 640 x 640 (segments 0.073-0.076,
//     0.081-0.084, 0.066-0.067 ms; 24% of the three-launch floor) and
//     0.399-0.410 ms at CLI b's 16 frames, against 0.453-0.463 and
//     0.817-0.820 ms for the CUDA-core grid in the same call (2.0x); the
//     plain version on cuDNN (TF32 off) 1.2 and 2.0 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLeaky = 0.1f;

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * kLeaky;
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

// ---- bf16: the tensor-core segments ---------------------------------------

using bf16 = __nv_bfloat16;

// The bf16 B operands (ops/planar_s1.pack_stage1_mma_weights): each matrix
// [out][in] with in contiguous, as hi = bf16(w) then lo = bf16(w - hi);
// element offsets of hi. conv0 is [8][32], k = (dy*3 + dx)*3 + c, zero
// for k >= 27; block 1's 8 inputs are padded with zeros to 16.
constexpr int kMmaConv0 = 0;      // [8][32]
constexpr int kMmaPw1 = 512;      // block 1: [16][16]
constexpr int kMmaPw2 = 1024;     // block 2: [32][16]
constexpr int kMmaPw3 = 2048;     // block 3: [32][32]
constexpr int kMmaPw4 = 4096;     // block 4: [64][32]
constexpr int kMmaPw5 = 8192;     // block 5: [64][64]
constexpr int kF32Weights = 10132;

__device__ __forceinline__ float2 bf2(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (v0, v1) as bf16x2 hi = bf16(v) and lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, unsigned* hi,
                                       unsigned* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const unsigned*>(&h);
  *lo = pack2f(v0 - hf.x, v1 - hf.y);
}

// cp.async of 16 bytes of which the first `nbytes` (0-16) are read and the
// rest zero-filled
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem,
                                             int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(nbytes));
}

// ROWS rows of COLS bf16 (a multiple of 8) from global [ROWS][COLS] into
// shared rows of PITCH, by 16-byte cp.async pieces; hi and lo both
template <int ROWS, int COLS, int PITCH>
__device__ __forceinline__ void stage_split(bf16* dst, const bf16* src,
                                            int tid) {
  constexpr int P = COLS / 8;  // pieces a row: 2, 4 or 8
  for (int i = tid; i < 2 * ROWS * P; i += kThreads) {
    const int row = i / P, part = i % P;  // rows ROWS.. are lo's
    cp_async16(dst + row * PITCH + part * 8, src + row * COLS + part * 8);
  }
}

// global [n] f32 -> shared, once per block
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int n, int tid) {
  for (int i = tid; i < n; i += kThreads) dst[i] = __ldg(src + i);
}

// acc[NF][4] += A[rows of this lane's ldmatrix row arow][0:K] x
// B[n0 .. n0 + 8 NF][0:K]^T with A = A_hi + A_lo and B = B_hi + B_lo (bf16
// each): three mma.sync products, hi.hi + lo.hi + hi.lo (lo.lo, below
// 2^-16 of the sum, is dropped); NF is even
template <int K, int NF, int APITCH, int BPITCH>
__device__ __forceinline__ void mma_split(float (&acc)[NF][4],
                                          const bf16* a_hi, const bf16* a_lo,
                                          const bf16* b_hi, const bf16* b_lo,
                                          int arow, int n0, int lane) {
  const int ao = arow * APITCH + 8 * (lane >> 4);
  const int bo = (n0 + 8 * (lane >> 4) + (lane & 7)) * BPITCH +
                 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < K; ks += 16) {
    unsigned ah[4], al[4];
    ldsm_x4(ah, a_hi + ao + ks);
    ldsm_x4(al, a_lo + ao + ks);
#pragma unroll
    for (int j = 0; j < NF / 2; ++j) {
      unsigned bh[4], bl[4];
      ldsm_x4(bh, b_hi + bo + j * 16 * BPITCH + ks);
      ldsm_x4(bl, b_lo + bo + j * 16 * BPITCH + ks);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        mma_bf16(acc[2 * j + t], ah, bh[2 * t], bh[2 * t + 1]);
        mma_bf16(acc[2 * j + t], al, bh[2 * t], bh[2 * t + 1]);
        mma_bf16(acc[2 * j + t], ah, bl[2 * t], bl[2 * t + 1]);
      }
    }
  }
}

// Stage B's depthwise 3x3/1 + BN + LeakyReLU on the f32 stage-A map
// `amap` ([(TH+2) x (TW+2)][IPITCH]), written as the split A tile
// (`at_hi`, `at_lo`: [TH*TW][OPITCH] bf16); two channels a thread.
template <int C, int TH, int TW, int IPITCH, int OPITCH>
__device__ __forceinline__ void depthwise_s1(const float* amap, bf16* at_hi,
                                             bf16* at_lo, const float* dw,
                                             const float* bn, int tid) {
  constexpr int NP = C / 2, AC = TW + 2;
  constexpr int STEP = kThreads / NP;
  const int pr = tid % NP;
  float2 tap[9];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    tap[t] = make_float2(dw[t * C + 2 * pr], dw[t * C + 2 * pr + 1]);
  const float2 mul = make_float2(bn[2 * pr], bn[2 * pr + 1]);
  const float2 add = make_float2(bn[C + 2 * pr], bn[C + 2 * pr + 1]);
  for (int p = tid / NP; p < TH * TW; p += STEP) {
    const int r = p / TW, q = p % TW;  // TW is a power of two
    const float* s = amap + (r * AC + q) * IPITCH + 2 * pr;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float2 v =
            *reinterpret_cast<const float2*>(s + (dy * AC + dx) * IPITCH);
        s0 = fmaf(v.x, tap[dy * 3 + dx].x, s0);
        s1 = fmaf(v.y, tap[dy * 3 + dx].y, s1);
      }
    split2(leaky(fmaf(s0, mul.x, add.x)), leaky(fmaf(s1, mul.y, add.y)),
           reinterpret_cast<unsigned*>(at_hi + p * OPITCH + 2 * pr),
           reinterpret_cast<unsigned*>(at_lo + p * OPITCH + 2 * pr));
  }
}

// Stage B's pointwise GEMM and the segment's output: the split [TH*TW x K]
// A tile times B ([N][BPITCH] hi, then lo at +N*BPITCH), BN + LeakyReLU in
// registers, bf16 rows into `ob` ([TH*TW][N + 8]), then 16-byte stores of
// the pixels inside the output map. Units of one m16 tile and N / NSPLIT
// columns.
template <int K, int N, int NSPLIT, int TH, int TW, int APITCH, int BPITCH>
__device__ __forceinline__ void pointwise_out(
    const bf16* at_hi, const bf16* at_lo, const bf16* bs, const float* bn,
    bf16* ob, bf16* out, int b, int ty0, int tx0, int ho, int wo, int tid) {
  constexpr int MT = TH * TW / 16, NW = N / NSPLIT, NF = NW / 8;
  constexpr int OP = N + 8, PO = N / 8;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  for (int u = warp; u < MT * NSPLIT; u += kThreads / 32) {
    const int mt = u / NSPLIT, n0 = (u % NSPLIT) * NW;
    float acc[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    mma_split<K, NF, APITCH, BPITCH>(
        acc, at_hi, at_lo, bs, bs + N * BPITCH,
        mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), n0, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bf16* row = ob + (mt * 16 + gq + 8 * hh) * OP;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int n = n0 + j * 8 + 2 * tq;
        *reinterpret_cast<unsigned*>(row + n) = pack2f(
            leaky(fmaf(acc[j][2 * hh], bn[n], bn[N + n])),
            leaky(fmaf(acc[j][2 * hh + 1], bn[n + 1], bn[N + n + 1])));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < TH * TW * PO; i += kThreads) {
    const int m = i / PO, part = i % PO;  // powers of two
    const int gy = ty0 + m / TW, gx = tx0 + m % TW;
    if (gy < ho && gx < wo)
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * ho + gy) * wo + gx) * N + part * 8) =
          *reinterpret_cast<const uint4*>(ob + m * OP + part * 8);
  }
}

// ---- segment 1: conv0 3x3/2 (3 -> 8), then block 1 (8 -> 16) -------------

template <int TH, int TW>
struct FirstSmem {  // bytes
  static constexpr int kIR = 2 * TH + 5, kIC = 2 * TW + 5;  // 37 x 37
  static constexpr int kAR = TH + 2, kAC = TW + 2;          // 18 x 18
  static constexpr int kCells = kAR * kAC;                  // 324
  static constexpr int kRawPitch = 128;  // a row's 3 * IC bytes + alignment
  static constexpr int kRaw = kIR * kRawPitch;
  static constexpr int kXs = (kIR * kIC * 3 * 2 + 15) / 16 * 16;
  static constexpr int kAPitch = 24;  // block 1's A tile: K = 8 (+ 8 zero)
  static constexpr int kTile = TH * TW * kAPitch * 2;  // one A tile, or ob
  static constexpr int kLow = kRaw + kXs > kTile ? kRaw + kXs : kTile;
  static constexpr int kMap = kCells * 8 * 4;  // conv0's f32 output
  static constexpr int kB0 = 2 * 8 * 40 * 2, kBp = 2 * 16 * 24 * 2;
  static constexpr int kF32 = 16 + 9 * 8 + 16 + 32;
  static constexpr int kRowOff = (kIR + 3) / 4 * 4;  // ints
  static constexpr int kBytes =
      kLow + kMap + 2 * kTile + kB0 + kBp + 4 * kF32 + 4 * kRowOff;
  static_assert(kRawPitch >= 3 * kIC + 15, "8 pieces cover a row's span");
};

// frames [B, H, W, 3] u8 -> out [B, H2, W2, 16] bf16. conv0 is a GEMM on
// the tensor cores (M = the tile's stage-A cells, K = 27 padded to 32,
// N = 8) whose A rows are gathered from the staged frame (exact in bf16,
// so only B is split); block 1's depthwise runs on the CUDA cores and its
// pointwise is a split GEMM (K = 8 padded to 16, N = 16).
template <int TH, int TW>
__global__ void __launch_bounds__(kThreads, 4)
segment_mma_first(const uint8_t* __restrict__ frames,
                  const float* __restrict__ w,    // segment 1's f32 pack
                  const float* __restrict__ sub,  // channel means
                  const bf16* __restrict__ w0,    // conv0 [8][32] hi, lo
                  const bf16* __restrict__ pw,    // block 1 [16][16] hi, lo
                  bf16* __restrict__ out, int hi, int wi, int ho, int wo,
                  int tiles_x) {
  using S = FirstSmem<TH, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* raw = smem_raw;                           // [IR][128] u8
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + S::kRaw);  // [IR][IC][3]
  bf16* ob = reinterpret_cast<bf16*>(smem_raw);            // [TH*TW][24]
  float* amap = reinterpret_cast<float*>(smem_raw + S::kLow);  // [cells][8]
  bf16* at_hi = reinterpret_cast<bf16*>(amap + S::kCells * 8);  // [..][24]
  bf16* at_lo = at_hi + TH * TW * S::kAPitch;
  bf16* b0 = at_lo + TH * TW * S::kAPitch;                 // 2 x [8][40]
  bf16* bp = b0 + 2 * 8 * 40;                              // 2 x [16][24]
  float* bn0 = reinterpret_cast<float*>(bp + 2 * 16 * 24);  // mul[8] add[8]
  float* dwb = bn0 + 16;                                   // [9][8]
  float* bnb1 = dwb + 72;                                  // mul[8] add[8]
  float* bnb2 = bnb1 + 16;                                 // mul[16] add[16]
  int* roff = reinterpret_cast<int*>(bnb2 + 32);  // [IR]: span offsets

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int tile_y = blockIdx.x / tiles_x;
  const int ty0 = tile_y * TH, tx0 = (blockIdx.x - tile_y * tiles_x) * TW;
  const int ay0 = ty0 - 1, ax0 = tx0 - 1;          // stage-A origin
  const int iy0 = 2 * ay0 - 1, ix0 = 2 * ax0 - 1;  // input origin

  // ---- staging: B operands, then each frame row's span as aligned
  // 16-byte pieces: the row's 3 * IC bytes start at byte s of the frames,
  // piece j is bytes 16 * (s / 16 + j) .. + 15, zero-filled past the
  // tensor's end; rows off the frame are all padding and not read. roff
  // keeps where each staged row's span starts (s % 16), -1 off the frame.
  stage_split<8, 32, 40>(b0, w0, tid);
  stage_split<16, 16, 24>(bp, pw, tid);
  const long long total = (long long)gridDim.y * hi * wi * 3;
  for (int i = tid; i < S::kIR * 8; i += kThreads) {
    const int rr = i >> 3, j = i & 7;
    const int gy = iy0 + rr;
    const long long s = (((long long)b * hi + gy) * wi + ix0) * 3;
    const bool rok = (unsigned)gy < (unsigned)hi;
    if (j == 0) roff[rr] = rok ? (int)(s & 15) : -1;
    if (!rok) continue;
    const long long start = ((s >> 4) + j) * 16;
    const long long left = total - start;
    const int n = start < 0 ? 0 : left < 0 ? 0 : left > 16 ? 16 : (int)left;
    cp_async16_n(raw + rr * S::kRawPitch + j * 16,
                 n > 0 ? frames + start : frames, n);
  }
  cp_async_commit();
  stage_f32(bn0, w + 27 * 8, 16, tid);   // conv0's BN (mul, add)
  const float* wb = w + 29 * 8;          // block 1: dw [9][8], bn, pw, bn
  stage_f32(dwb, wb, 88, tid);           // taps and BN, contiguous
  stage_f32(bnb2, wb + 88 + 8 * 16, 32, tid);
  const float m0 = __ldg(sub), m1 = __ldg(sub + 1), m2 = __ldg(sub + 2);
  for (int p = tid; p < TH * TW; p += kThreads) {  // K's zero half
    *reinterpret_cast<uint4*>(at_hi + p * S::kAPitch + 8) =
        make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(at_lo + p * S::kAPitch + 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait_all();
  __syncthreads();

  // frame - means as bf16 [IR][IC][3], zero off the frame: a thread a
  // pixel; a thread's next pixel is kThreads on, which moves its row and
  // column by constants
  {
    constexpr int DR = kThreads / S::kIC, DC = kThreads % S::kIC;
    int rr = tid / S::kIC, px = tid % S::kIC;
    for (int i = tid; i < S::kIR * S::kIC; i += kThreads) {
      const int off = roff[rr];
      const bool ok = off >= 0 && (unsigned)(ix0 + px) < (unsigned)wi;
      const unsigned char* src =
          raw + rr * S::kRawPitch + max(off, 0) + 3 * px;
      bf16* dst = xs + 3 * i;  // i = rr * IC + px
      dst[0] = __float2bfloat16(ok ? (float)src[0] - m0 : 0.f);
      dst[1] = __float2bfloat16(ok ? (float)src[1] - m1 : 0.f);
      dst[2] = __float2bfloat16(ok ? (float)src[2] - m2 : 0.f);
      rr += DR;
      px += DC;
      if (px >= S::kIC) {
        px -= S::kIC;
        ++rr;
      }
    }
  }
  __syncthreads();

  // ---- conv0 on the tensor cores -> amap [cells][8] f32 ------------------
  {
    const int gq = lane >> 2, tq = lane & 3;
    // element offsets, from a cell's first input value, of this lane's A
    // columns ks * 16 + hf * 8 + 2 tq + e, k = (dy*3 + dx)*3 + c; columns
    // k >= 27 read offset 0 against a zero weight
    int off[2][2][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = ks * 16 + hf * 8 + 2 * tq + e;
          const int dy = k / 9, dx = (k % 9) / 3, c = k % 3;
          off[ks][hf][e] = k < 27 ? (dy * S::kIC + dx) * 3 + c : 0;
        }
    unsigned bfr[2][2][2];  // [hi, lo][ks][b0, b1]
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          bfr[p][ks][hf] = *reinterpret_cast<const unsigned*>(
              b0 + (p * 8 + gq) * 40 + ks * 16 + hf * 8 + 2 * tq);
    const float mul0 = bn0[2 * tq], mul1 = bn0[2 * tq + 1];
    const float add0 = bn0[8 + 2 * tq], add1 = bn0[8 + 2 * tq + 1];
    const unsigned short* xu = reinterpret_cast<const unsigned short*>(xs);
    for (int mt = warp; mt < (S::kCells + 15) / 16; mt += kThreads / 32) {
      int base[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // once per m tile and row
        const int m = min(mt * 16 + gq + 8 * hh, S::kCells - 1);
        const int r = m / S::kAC, q = m - r * S::kAC;
        base[hh] = (2 * r * S::kIC + 2 * q) * 3;
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned a[4];  // rows gq, gq + 8 of halves 0, 1
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = (unsigned)xu[base[i & 1] + off[ks][i >> 1][0]] |
                 ((unsigned)xu[base[i & 1] + off[ks][i >> 1][1]] << 16);
        mma_bf16(acc, a, bfr[0][ks][0], bfr[0][ks][1]);
        mma_bf16(acc, a, bfr[1][ks][0], bfr[1][ks][1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 16 + gq + 8 * hh;
        if (m >= S::kCells) continue;
        const int r = m / S::kAC, q = m - r * S::kAC;
        const bool ok = (unsigned)(ay0 + r) < (unsigned)ho &&
                        (unsigned)(ax0 + q) < (unsigned)wo;
        *reinterpret_cast<float2*>(amap + m * 8 + 2 * tq) = make_float2(
            ok ? leaky(fmaf(acc[2 * hh], mul0, add0)) : 0.f,
            ok ? leaky(fmaf(acc[2 * hh + 1], mul1, add1)) : 0.f);
      }
    }
  }
  __syncthreads();

  // ---- block 1: depthwise (CUDA cores), pointwise (tensor cores) ---------
  depthwise_s1<8, TH, TW, 8, S::kAPitch>(amap, at_hi, at_lo, dwb, bnb1, tid);
  __syncthreads();
  pointwise_out<16, 16, 1, TH, TW, S::kAPitch, 24>(
      at_hi, at_lo, bp, bnb2, ob, out, b, ty0, tx0, ho, wo, tid);
}

// ---- segments 2 and 3: dw 3x3/2 + pw, then dw 3x3/1 + pw ------------------

template <int CIN, int CMID, int COUT, int TH, int TW>
struct MmaSmem {  // bytes
  static constexpr int kIR = 2 * TH + 5, kIC = 2 * TW + 5;
  static constexpr int kAR = TH + 2, kAC = TW + 2;
  static constexpr int kCells = kAR * kAC;
  static constexpr int kAPitch = CIN + 8;   // stage-A A tile (bf16)
  static constexpr int kMPitch = CMID + 8;  // f32 stage-A map; stage B's A
  static constexpr int kIn = kIR * kIC * CIN * 2;
  static constexpr int kAb = 2 * TH * TW * kMPitch * 2;  // over the input
  static constexpr int kLow = kIn > kAb ? kIn : kAb;
  static constexpr int kAa = 2 * kCells * kAPitch * 2;
  static constexpr int kMap = kCells * kMPitch * 4;  // later ob
  static constexpr int kBa = 2 * CMID * (CIN + 8) * 2;
  static constexpr int kBb = 2 * COUT * (CMID + 8) * 2;
  static constexpr int kF32 =
      9 * CIN + 2 * CIN + 2 * CMID + 9 * CMID + 2 * CMID + 2 * COUT;
  static constexpr int kBytes = kLow + kAa + kMap + kBa + kBb + 4 * kF32;
  static_assert((kLow | kAa | kMap | kBa | kBb) % 16 == 0,
                "16-byte aligned regions");
  static_assert(TH * TW * (COUT + 8) * 2 <= kMap, "ob fits over the map");
};

// in [B, Hi, Wi, CIN] bf16 -> out [B, Ho, Wo, COUT] bf16 (Ho = (Hi+1)/2).
template <int CIN, int CMID, int COUT, int TH, int TW, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
segment_mma(const bf16* __restrict__ in,
            const float* __restrict__ w,    // the segment's f32 pack
            const bf16* __restrict__ pwa,   // [CMID][CIN] hi, lo
            const bf16* __restrict__ pwb,   // [COUT][CMID] hi, lo
            bf16* __restrict__ out, int hi, int wi, int ho, int wo,
            int tiles_x) {
  using S = MmaSmem<CIN, CMID, COUT, TH, TW>;
  constexpr int kAbT = TH * TW * S::kMPitch, kAaT = S::kCells * S::kAPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [IR][IC][CIN]
  bf16* ab_hi = xs;                              // later [TH*TW][kMPitch]
  bf16* ab_lo = ab_hi + kAbT;
  bf16* aa_hi = reinterpret_cast<bf16*>(smem_raw + S::kLow);  // [cells][..]
  bf16* aa_lo = aa_hi + kAaT;
  float* amap = reinterpret_cast<float*>(aa_lo + kAaT);  // [cells][kMPitch]
  bf16* ob = reinterpret_cast<bf16*>(amap);      // later [TH*TW][COUT + 8]
  bf16* ba = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(amap) + S::kMap);  // 2 x [CMID][..]
  bf16* bb = ba + 2 * CMID * (CIN + 8);                   // 2 x [COUT][..]
  float* dwa = reinterpret_cast<float*>(bb + 2 * COUT * (CMID + 8));
  float* bn1 = dwa + 9 * CIN;                    // mul[CIN], add[CIN]
  float* bn2 = bn1 + 2 * CIN;                    // mul[CMID], add[CMID]
  float* dwb = bn2 + 2 * CMID;                   // [9][CMID]
  float* bnb1 = dwb + 9 * CMID;                  // mul[CMID], add[CMID]
  float* bnb2 = bnb1 + 2 * CMID;                 // mul[COUT], add[COUT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int tile_y = blockIdx.x / tiles_x;
  const int ty0 = tile_y * TH, tx0 = (blockIdx.x - tile_y * tiles_x) * TW;
  const int ay0 = ty0 - 1, ax0 = tx0 - 1;          // stage-A origin
  const int iy0 = 2 * ay0 - 1, ix0 = 2 * ax0 - 1;  // input origin

  // ---- staging: B operands and the input footprint by cp.async -----------
  stage_split<CMID, CIN, CIN + 8>(ba, pwa, tid);
  stage_split<COUT, CMID, CMID + 8>(bb, pwb, tid);
  {
    // 16-byte pieces of the footprint's rows, zero off the input map; a
    // thread's next piece is kThreads pieces on, which moves its row and
    // column by constants
    constexpr int PP = CIN / 8;           // pieces a pixel
    constexpr int RP = S::kIC * PP;       // pieces a row
    constexpr int DR = kThreads / RP, DC = kThreads % RP;
    int rr = tid / RP, cc = tid % RP;
    for (int i = tid; i < S::kIR * RP; i += kThreads) {
      const int px = cc / PP, part = cc % PP;
      const int gy = iy0 + rr, gx = ix0 + px;
      const bool ok =
          (unsigned)gy < (unsigned)hi && (unsigned)gx < (unsigned)wi;
      const bf16* src =
          ok ? in + (((size_t)b * hi + gy) * wi + gx) * CIN + part * 8 : in;
      cp_async16_zfill(xs + (rr * S::kIC + px) * CIN + part * 8, src, ok);
      rr += DR;
      cc += DC;
      if (cc >= RP) {
        cc -= RP;
        ++rr;
      }
    }
  }
  cp_async_commit();
  // the f32 pack: dw [9][CIN], mul, add, pw [CIN][CMID], mul, add, then
  // block B: dw [9][CMID], mul, add, pw [CMID][COUT], mul, add
  stage_f32(dwa, w, 11 * CIN, tid);  // taps and BN, contiguous
  stage_f32(bn2, w + 11 * CIN + CIN * CMID, 2 * CMID, tid);
  const float* wb = w + 11 * CIN + CIN * CMID + 2 * CMID;
  stage_f32(dwb, wb, 11 * CMID, tid);
  stage_f32(bnb2, wb + 11 * CMID + CMID * COUT, 2 * COUT, tid);
  cp_async_wait_all();
  __syncthreads();

  // ---- stage A: depthwise 3x3/2 + BN + LeakyReLU -> split aa -------------
  {
    constexpr int NP = CIN / 2;
    constexpr int STEP = kThreads / NP;  // cells a pass
    constexpr int DR = STEP / S::kAC, DQ = STEP % S::kAC;
    const int pr = tid % NP;
    float2 tap[9];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      tap[t] = make_float2(dwa[t * CIN + 2 * pr], dwa[t * CIN + 2 * pr + 1]);
    const float2 mul = make_float2(bn1[2 * pr], bn1[2 * pr + 1]);
    const float2 add = make_float2(bn1[CIN + 2 * pr], bn1[CIN + 2 * pr + 1]);
    int cell = tid / NP;
    int r = cell / S::kAC, q = cell % S::kAC;
    for (; cell < S::kCells; cell += STEP) {
      const bf16* s = xs + (2 * r * S::kIC + 2 * q) * CIN + 2 * pr;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float2 v = bf2(*reinterpret_cast<const unsigned*>(
              s + (dy * S::kIC + dx) * CIN));
          s0 = fmaf(v.x, tap[dy * 3 + dx].x, s0);
          s1 = fmaf(v.y, tap[dy * 3 + dx].y, s1);
        }
      split2(leaky(fmaf(s0, mul.x, add.x)), leaky(fmaf(s1, mul.y, add.y)),
             reinterpret_cast<unsigned*>(aa_hi + cell * S::kAPitch + 2 * pr),
             reinterpret_cast<unsigned*>(aa_lo + cell * S::kAPitch + 2 * pr));
      r += DR;
      q += DQ;
      if (q >= S::kAC) {
        q -= S::kAC;
        ++r;
      }
    }
  }
  __syncthreads();

  // ---- stage A: pointwise GEMM [cells x CIN] x [CIN x CMID] -> f32 amap --
  // (BN + LeakyReLU, zero off the stage-A map: the next depthwise's
  // padding); units of one m16 tile and half of N
  {
    constexpr int MT = (S::kCells + 15) / 16;
    constexpr int NH = CMID / 2, NF = NH / 8;
    const int gq = lane >> 2, tq = lane & 3;
    for (int u = warp; u < 2 * MT; u += kThreads / 32) {
      const int mt = u >> 1, n0 = (u & 1) * NH;
      float acc[NF][4];
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      mma_split<CIN, NF, S::kAPitch, CIN + 8>(
          acc, aa_hi, aa_lo, ba, ba + CMID * (CIN + 8),
          min(mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), S::kCells - 1),
          n0, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 16 + gq + 8 * hh;
        if (m >= S::kCells) continue;
        const int r = m / S::kAC, q = m - r * S::kAC;  // once per row
        const bool ok = (unsigned)(ay0 + r) < (unsigned)ho &&
                        (unsigned)(ax0 + q) < (unsigned)wo;
        float* row = amap + m * S::kMPitch;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int n = n0 + j * 8 + 2 * tq;
          *reinterpret_cast<float2*>(row + n) = make_float2(
              ok ? leaky(fmaf(acc[j][2 * hh], bn2[n], bn2[CMID + n])) : 0.f,
              ok ? leaky(fmaf(acc[j][2 * hh + 1], bn2[n + 1],
                              bn2[CMID + n + 1]))
                 : 0.f);
        }
      }
    }
  }
  __syncthreads();

  // ---- stage B: depthwise 3x3/1 -> split ab, pointwise -> out ------------
  depthwise_s1<CMID, TH, TW, S::kMPitch, S::kMPitch>(amap, ab_hi, ab_lo, dwb,
                                                     bnb1, tid);
  __syncthreads();
  pointwise_out<CMID, COUT, (TH * TW >= 128 ? 1 : 2), TH, TW, S::kMPitch,
                CMID + 8>(ab_hi, ab_lo, bb, bnb2, ob, out, b, ty0, tx0, ho,
                          wo, tid);
}

template <int TH, int TW>
int launch_first(const uint8_t* frames, const float* w, const float* sub,
                 const bf16* w0, const bf16* pw, bf16* out, int b, int hi,
                 int wi, cudaStream_t stream) {
  using S = FirstSmem<TH, TW>;
  auto kern = segment_mma_first<TH, TW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int ho = (hi + 1) / 2, wo = (wi + 1) / 2;
  const int tiles_x = (wo + TW - 1) / TW, tiles_y = (ho + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, b);
  kern<<<grid, kThreads, S::kBytes, stream>>>(frames, w, sub, w0, pw, out,
                                              hi, wi, ho, wo, tiles_x);
  return (int)cudaGetLastError();
}

template <int CIN, int CMID, int COUT, int TH, int TW, int MINB>
int launch_mma(const bf16* in, const float* w, const bf16* pwa,
               const bf16* pwb, bf16* out, int b, int hi, int wi,
               cudaStream_t stream) {
  using S = MmaSmem<CIN, CMID, COUT, TH, TW>;
  auto kern = segment_mma<CIN, CMID, COUT, TH, TW, MINB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int ho = (hi + 1) / 2, wo = (wi + 1) / 2;
  const int tiles_x = (wo + TW - 1) / TW, tiles_y = (ho + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, b);
  kern<<<grid, kThreads, S::kBytes, stream>>>(in, w, pwa, pwb, out, hi, wi,
                                              ho, wo, tiles_x);
  return (int)cudaGetLastError();
}

// the three bf16 segments; the tiles and their reckoning are in the header
int run_stage1_mma(const uint8_t* frames, const float* weights, bf16* out,
                   bf16* s1, bf16* s2, int b, int h, int w, cudaStream_t st,
                   int* launches) {
  using W1 = SegWeights<3, 8, 16, true>;
  using W2 = SegWeights<16, 32, 32, false>;
  static_assert(FirstSmem<16, 16>::kBytes == 51424, "segment 1 reckoning");
  static_assert(MmaSmem<16, 32, 32, 8, 16>::kBytes == 81760,
                "segment 2 reckoning");
  static_assert(MmaSmem<32, 64, 64, 8, 8>::kBytes == 106944,
                "segment 3 reckoning");
  if (((uintptr_t)frames | (uintptr_t)weights | (uintptr_t)out |
       (uintptr_t)s1 | (uintptr_t)s2) & 15)
    return (int)cudaErrorMisalignedAddress;
  const float* sub = weights;
  const float* w1 = weights + 4;
  const float* w2 = w1 + W1::kTotal;
  const float* w3 = w2 + W2::kTotal;
  const bf16* wm = reinterpret_cast<const bf16*>(weights + kF32Weights);
  const int h2 = (h + 1) / 2, w2s = (w + 1) / 2;
  const int h4 = (h2 + 1) / 2, w4s = (w2s + 1) / 2;
  int e = launch_first<16, 16>(frames, w1, sub, wm + kMmaConv0,
                               wm + kMmaPw1, s1, b, h, w, st);
  if (e) return e;
  ++*launches;
  e = launch_mma<16, 32, 32, 8, 16, 2>(s1, w2, wm + kMmaPw2, wm + kMmaPw3,
                                       s2, b, h2, w2s, st);
  if (e) return e;
  ++*launches;
  e = launch_mma<32, 64, 64, 8, 8, 2>(s2, w3, wm + kMmaPw4, wm + kMmaPw5,
                                      out, b, h4, w4s, st);
  if (e) return e;
  ++*launches;
  return 0;
}

// ---- f32: the tensor-core segments in 3xTF32 ------------------------------

// The f32 B operands (ops/planar_s1.pack_stage1_tf32x3_weights): each
// matrix [out][in] f32 with in contiguous, as hi = tf32(w) then lo =
// tf32(w - hi); float offsets of hi after the f32 pack. conv0 is [8][32],
// k = (dy*3 + dx)*3 + c, zero for k >= 27; block 1's K = 8 is one k8 step.
constexpr int kTfConv0 = 0;       // [8][32]
constexpr int kTfPw1 = 512;       // block 1: [16][8]
constexpr int kTfPw2 = 768;       // block 2: [32][16]
constexpr int kTfPw3 = 1792;      // block 3: [32][32]
constexpr int kTfPw4 = 3840;      // block 4: [64][32]
constexpr int kTfPw5 = 7936;      // block 5: [64][64]

// ROWS rows of COLS f32 (a multiple of 4) from global [ROWS][COLS] into
// shared rows of PITCH, by 16-byte cp.async pieces; hi and lo both
template <int ROWS, int COLS, int PITCH>
__device__ __forceinline__ void stage_split_f32(float* dst, const float* src,
                                                int tid) {
  constexpr int P = COLS / 4;  // pieces a row: 2, 4, 8 or 16
  for (int i = tid; i < 2 * ROWS * P; i += kThreads) {
    const int row = i / P, part = i % P;  // rows ROWS.. are lo's
    cp_async16(dst + row * PITCH + part * 4, src + row * COLS + part * 4);
  }
}

// acc[NF][4] += A[rows of this lane's ldmatrix row arow][0:K] x
// B[n0 .. n0 + 8 NF][0:K]^T in 3xTF32: A from f32 rows of APITCH, split as
// it is loaded; B staged split (hi, lo at +N rows); each k8 step's three
// products summed from zero and added to acc (mma_tf32x3_add). NF is even.
template <int K, int NF, int APITCH, int BPITCH>
__device__ __forceinline__ void gemm_tf32x3(float (&acc)[NF][4],
                                            const float* a,
                                            const float* b_hi,
                                            const float* b_lo, int arow,
                                            int n0, int lane) {
  const int ao = arow * APITCH + 4 * (lane >> 4);
  const int bo = (n0 + 8 * (lane >> 4) + (lane & 7)) * BPITCH +
                 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < K; ks += 8) {
    unsigned r[4], ah[4], al[4];
    ldsm_x4(r, a + ao + ks);
    split_n<4>(r, ah, al);
#pragma unroll
    for (int j = 0; j < NF / 2; ++j) {
      unsigned bh[4], bl[4];
      ldsm_x4(bh, b_hi + bo + j * 16 * BPITCH + ks);
      ldsm_x4(bl, b_lo + bo + j * 16 * BPITCH + ks);
      mma_tf32x3_add(acc[2 * j], ah, al, bh, bl);
      mma_tf32x3_add(acc[2 * j + 1], ah, al, bh + 2, bl + 2);
    }
  }
}

// Stage B's depthwise 3x3/1 + BN + LeakyReLU on the f32 stage-A map
// `amap` ([(TH+2) x (TW+2)][IPITCH]), written as the f32 A tile `at`
// ([TH*TW][OPITCH]); two channels a thread.
template <int C, int TH, int TW, int IPITCH, int OPITCH>
__device__ __forceinline__ void depthwise_s1_f32(const float* amap,
                                                 float* at, const float* dw,
                                                 const float* bn, int tid) {
  constexpr int NP = C / 2, AC = TW + 2;
  constexpr int STEP = kThreads / NP;
  const int pr = tid % NP;
  float2 tap[9];
#pragma unroll
  for (int t = 0; t < 9; ++t)
    tap[t] = make_float2(dw[t * C + 2 * pr], dw[t * C + 2 * pr + 1]);
  const float2 mul = make_float2(bn[2 * pr], bn[2 * pr + 1]);
  const float2 add = make_float2(bn[C + 2 * pr], bn[C + 2 * pr + 1]);
  for (int p = tid / NP; p < TH * TW; p += STEP) {
    const int r = p / TW, q = p % TW;  // TW is a power of two
    const float* s = amap + (r * AC + q) * IPITCH + 2 * pr;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float2 v =
            *reinterpret_cast<const float2*>(s + (dy * AC + dx) * IPITCH);
        s0 = fmaf(v.x, tap[dy * 3 + dx].x, s0);
        s1 = fmaf(v.y, tap[dy * 3 + dx].y, s1);
      }
    *reinterpret_cast<float2*>(at + p * OPITCH + 2 * pr) =
        make_float2(leaky(fmaf(s0, mul.x, add.x)),
                    leaky(fmaf(s1, mul.y, add.y)));
  }
}

// Stage B's pointwise GEMM and the segment's output: the f32 [TH*TW x K]
// A tile times B ([N][BPITCH] hi, then lo at +N*BPITCH) in 3xTF32, BN +
// LeakyReLU in registers, f32 rows into `ob` ([TH*TW][N + 8]), then
// 16-byte stores of the pixels inside the output map. Units of one m16
// tile and N / NSPLIT columns.
template <int K, int N, int NSPLIT, int TH, int TW, int APITCH, int BPITCH>
__device__ __forceinline__ void pointwise_out_f32(
    const float* at, const float* bs, const float* bn, float* ob,
    float* out, int b, int ty0, int tx0, int ho, int wo, int tid) {
  constexpr int MT = TH * TW / 16, NW = N / NSPLIT, NF = NW / 8;
  constexpr int OP = N + 8, PO = N / 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  for (int u = warp; u < MT * NSPLIT; u += kThreads / 32) {
    const int mt = u / NSPLIT, n0 = (u % NSPLIT) * NW;
    float acc[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    gemm_tf32x3<K, NF, APITCH, BPITCH>(
        acc, at, bs, bs + N * BPITCH,
        mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), n0, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* row = ob + (mt * 16 + gq + 8 * hh) * OP;
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int n = n0 + j * 8 + 2 * tq;
        *reinterpret_cast<float2*>(row + n) = make_float2(
            leaky(fmaf(acc[j][2 * hh], bn[n], bn[N + n])),
            leaky(fmaf(acc[j][2 * hh + 1], bn[n + 1], bn[N + n + 1])));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < TH * TW * PO; i += kThreads) {
    const int m = i / PO, part = i % PO;  // powers of two
    const int gy = ty0 + m / TW, gx = tx0 + m % TW;
    if (gy < ho && gx < wo)
      *reinterpret_cast<float4*>(
          out + (((size_t)b * ho + gy) * wo + gx) * N + part * 4) =
          *reinterpret_cast<const float4*>(ob + m * OP + part * 4);
  }
}

// ---- f32 segment 1: conv0 3x3/2 (3 -> 8), then block 1 (8 -> 16) ----------

template <int TH, int TW>
struct FirstTfSmem {  // bytes
  static constexpr int kIR = 2 * TH + 5, kIC = 2 * TW + 5;  // 37 x 37
  static constexpr int kAR = TH + 2, kAC = TW + 2;          // 18 x 18
  static constexpr int kCells = kAR * kAC;                  // 324
  static constexpr int kRawPitch = 128;  // a row's 3 * IC bytes + alignment
  static constexpr int kRaw = kIR * kRawPitch;
  static constexpr int kXs = (kIR * kIC * 3 * 4 + 15) / 16 * 16;
  static constexpr int kOb = TH * TW * (16 + 8) * 4;  // over raw and xs
  static constexpr int kLow = kRaw + kXs > kOb ? kRaw + kXs : kOb;
  static constexpr int kAPitch = 12;  // block 1's A tile: K = 8 (+ 4)
  static constexpr int kMap = kCells * 8 * 4;  // conv0's f32 output
  static constexpr int kTile = TH * TW * kAPitch * 4;
  static constexpr int kBp = 2 * 16 * kAPitch * 4;
  static constexpr int kF32 = 16 + 9 * 8 + 16 + 32;
  static constexpr int kRowOff = (kIR + 3) / 4 * 4;  // ints
  static constexpr int kBytes =
      kLow + kMap + kTile + kBp + 4 * kF32 + 4 * kRowOff;
  static_assert(kRawPitch >= 3 * kIC + 15, "8 pieces cover a row's span");
  static_assert((kLow | kMap | kTile | kBp | (4 * kF32)) % 16 == 0,
                "16-byte aligned regions");
};

// frames [B, H, W, 3] u8 -> out [B, H2, W2, 16] f32. conv0 is a GEMM on
// the tensor cores (M = the tile's stage-A cells, K = 27 padded to 32,
// N = 8) whose A rows are gathered from the staged frame minus the means
// (integers below 256, exact in TF32, so only B is split: two products a
// step, lo then hi); block 1's depthwise runs on the CUDA cores and its
// pointwise is a 3xTF32 GEMM (K = 8, N = 16).
template <int TH, int TW>
__global__ void __launch_bounds__(kThreads, 4)
segment_tf32_first(const uint8_t* __restrict__ frames,
                   const float* __restrict__ w,    // segment 1's f32 pack
                   const float* __restrict__ sub,  // channel means
                   const float* __restrict__ w0,   // conv0 [8][32] hi, lo
                   const float* __restrict__ pw,   // block 1 [16][8] hi, lo
                   float* __restrict__ out, int hi, int wi, int ho, int wo,
                   int tiles_x) {
  using S = FirstTfSmem<TH, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* raw = smem_raw;                             // [IR][128] u8
  float* xs = reinterpret_cast<float*>(smem_raw + S::kRaw);  // [IR][IC][3]
  float* ob = reinterpret_cast<float*>(smem_raw);            // [TH*TW][24]
  float* amap = reinterpret_cast<float*>(smem_raw + S::kLow);  // [cells][8]
  float* at = amap + S::kCells * 8;                  // [TH*TW][kAPitch]
  float* bp = at + TH * TW * S::kAPitch;             // 2 x [16][kAPitch]
  float* bn0 = bp + 2 * 16 * S::kAPitch;             // mul[8] add[8]
  float* dwb = bn0 + 16;                             // [9][8]
  float* bnb1 = dwb + 72;                            // mul[8] add[8]
  float* bnb2 = bnb1 + 16;                           // mul[16] add[16]
  int* roff = reinterpret_cast<int*>(bnb2 + 32);     // [IR]: span offsets

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int tile_y = blockIdx.x / tiles_x;
  const int ty0 = tile_y * TH, tx0 = (blockIdx.x - tile_y * tiles_x) * TW;
  const int ay0 = ty0 - 1, ax0 = tx0 - 1;          // stage-A origin
  const int iy0 = 2 * ay0 - 1, ix0 = 2 * ax0 - 1;  // input origin

  // ---- staging: block 1's B operand, then each frame row's span as
  // aligned 16-byte pieces, as segment_mma_first stages them ---------------
  stage_split_f32<16, 8, S::kAPitch>(bp, pw, tid);
  const long long total = (long long)gridDim.y * hi * wi * 3;
  for (int i = tid; i < S::kIR * 8; i += kThreads) {
    const int rr = i >> 3, j = i & 7;
    const int gy = iy0 + rr;
    const long long s = (((long long)b * hi + gy) * wi + ix0) * 3;
    const bool rok = (unsigned)gy < (unsigned)hi;
    if (j == 0) roff[rr] = rok ? (int)(s & 15) : -1;
    if (!rok) continue;
    const long long start = ((s >> 4) + j) * 16;
    const long long left = total - start;
    const int n = start < 0 ? 0 : left < 0 ? 0 : left > 16 ? 16 : (int)left;
    cp_async16_n(raw + rr * S::kRawPitch + j * 16,
                 n > 0 ? frames + start : frames, n);
  }
  cp_async_commit();
  stage_f32(bn0, w + 27 * 8, 16, tid);   // conv0's BN (mul, add)
  const float* wb = w + 29 * 8;          // block 1: dw [9][8], bn, pw, bn
  stage_f32(dwb, wb, 88, tid);           // taps and BN, contiguous
  stage_f32(bnb2, wb + 88 + 8 * 16, 32, tid);
  const float m0 = __ldg(sub), m1 = __ldg(sub + 1), m2 = __ldg(sub + 2);
  // conv0's B fragments, b0 (k tq, n gq) and b1 (k tq + 4, n gq) of each
  // k8 step, hi and lo, held in registers
  const int gq = lane >> 2, tq = lane & 3;
  unsigned bfr[2][4][2];  // [hi, lo][ks][b0, b1]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bfr[p][ks][h] = __float_as_uint(
            __ldg(w0 + p * 256 + gq * 32 + ks * 8 + tq + 4 * h));
  cp_async_wait_all();
  __syncthreads();

  // frame - means as f32 [IR][IC][3], zero off the frame: a thread a
  // pixel; a thread's next pixel is kThreads on, which moves its row and
  // column by constants
  {
    constexpr int DR = kThreads / S::kIC, DC = kThreads % S::kIC;
    int rr = tid / S::kIC, px = tid % S::kIC;
    for (int i = tid; i < S::kIR * S::kIC; i += kThreads) {
      const int off = roff[rr];
      const bool ok = off >= 0 && (unsigned)(ix0 + px) < (unsigned)wi;
      const unsigned char* src =
          raw + rr * S::kRawPitch + max(off, 0) + 3 * px;
      float* dst = xs + 3 * i;  // i = rr * IC + px
      dst[0] = ok ? (float)src[0] - m0 : 0.f;
      dst[1] = ok ? (float)src[1] - m1 : 0.f;
      dst[2] = ok ? (float)src[2] - m2 : 0.f;
      rr += DR;
      px += DC;
      if (px >= S::kIC) {
        px -= S::kIC;
        ++rr;
      }
    }
  }
  __syncthreads();

  // ---- conv0 on the tensor cores -> amap [cells][8] f32 ------------------
  {
    // offsets, from a cell's first input value, of this lane's A columns
    // k = ks * 8 + tq (+ 4), k = (dy*3 + dx)*3 + c; columns k >= 27 read
    // offset 0 against a zero weight
    int off[4][2];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ks * 8 + tq + 4 * h;
        const int dy = k / 9, dx = (k % 9) / 3, c = k % 3;
        off[ks][h] = k < 27 ? (dy * S::kIC + dx) * 3 + c : 0;
      }
    const float mul0 = bn0[2 * tq], mul1 = bn0[2 * tq + 1];
    const float add0 = bn0[8 + 2 * tq], add1 = bn0[8 + 2 * tq + 1];
    for (int mt = warp; mt < (S::kCells + 15) / 16; mt += kThreads / 32) {
      int base[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // once per m tile and row
        const int m = min(mt * 16 + gq + 8 * hh, S::kCells - 1);
        const int r = m / S::kAC, q = m - r * S::kAC;
        base[hh] = (2 * r * S::kIC + 2 * q) * 3;
      }
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        unsigned a[4];  // (gq, tq), (gq + 8, tq), (gq, tq + 4), (gq + 8, ..)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = __float_as_uint(xs[base[i & 1] + off[ks][i >> 1]]);
        float t[4] = {0.f, 0.f, 0.f, 0.f};  // lo, then hi, from zero
        mma_tf32(t, a, bfr[1][ks]);
        mma_tf32(t, a, bfr[0][ks]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += t[e];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 16 + gq + 8 * hh;
        if (m >= S::kCells) continue;
        const int r = m / S::kAC, q = m - r * S::kAC;
        const bool ok = (unsigned)(ay0 + r) < (unsigned)ho &&
                        (unsigned)(ax0 + q) < (unsigned)wo;
        *reinterpret_cast<float2*>(amap + m * 8 + 2 * tq) = make_float2(
            ok ? leaky(fmaf(acc[2 * hh], mul0, add0)) : 0.f,
            ok ? leaky(fmaf(acc[2 * hh + 1], mul1, add1)) : 0.f);
      }
    }
  }
  __syncthreads();

  // ---- block 1: depthwise (CUDA cores), pointwise (tensor cores) ---------
  depthwise_s1_f32<8, TH, TW, 8, S::kAPitch>(amap, at, dwb, bnb1, tid);
  __syncthreads();
  pointwise_out_f32<8, 16, 1, TH, TW, S::kAPitch, S::kAPitch>(
      at, bp, bnb2, ob, out, b, ty0, tx0, ho, wo, tid);
}

// ---- f32 segments 2 and 3: dw 3x3/2 + pw, then dw 3x3/1 + pw --------------

template <int CIN, int CMID, int COUT, int TH, int TW>
struct TfSmem {  // bytes
  static constexpr int kIR = 2 * TH + 5, kIC = 2 * TW + 5;
  static constexpr int kAR = TH + 2, kAC = TW + 2;
  static constexpr int kCells = kAR * kAC;
  static constexpr int kAPitch = CIN + 4;   // stage-A A tile
  static constexpr int kMPitch = CMID + 8;  // stage-A map
  static constexpr int kBPitch = CMID + 4;  // stage-B A tile
  static constexpr int kIn = kIR * kIC * CIN * 4;
  static constexpr int kAb = TH * TW * kBPitch * 4;  // over the input
  static constexpr int kLow = kIn > kAb ? kIn : kAb;
  static constexpr int kAa = kCells * kAPitch * 4;
  static constexpr int kMap = kCells * kMPitch * 4;  // later ob
  static constexpr int kBa = 2 * CMID * (CIN + 4) * 4;
  static constexpr int kBb = 2 * COUT * (CMID + 4) * 4;
  static constexpr int kF32 =
      9 * CIN + 2 * CIN + 2 * CMID + 9 * CMID + 2 * CMID + 2 * COUT;
  static constexpr int kBytes = kLow + kAa + kMap + kBa + kBb + 4 * kF32;
  static_assert((kLow | kAa | kMap | kBa | kBb) % 16 == 0,
                "16-byte aligned regions");
  static_assert(TH * TW * (COUT + 8) * 4 <= kMap, "ob fits over the map");
};

// in [B, Hi, Wi, CIN] f32 -> out [B, Ho, Wo, COUT] f32 (Ho = (Hi+1)/2).
template <int CIN, int CMID, int COUT, int TH, int TW, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
segment_tf32(const float* __restrict__ in,
             const float* __restrict__ w,    // the segment's f32 pack
             const float* __restrict__ pwa,  // [CMID][CIN] hi, lo
             const float* __restrict__ pwb,  // [COUT][CMID] hi, lo
             float* __restrict__ out, int hi, int wi, int ho, int wo,
             int tiles_x) {
  using S = TfSmem<CIN, CMID, COUT, TH, TW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [IR][IC][CIN]
  float* ab = xs;                                  // later [TH*TW][kBPitch]
  float* aa = reinterpret_cast<float*>(smem_raw + S::kLow);  // [cells][..]
  float* amap = aa + S::kCells * S::kAPitch;       // [cells][kMPitch]
  float* ob = amap;                                // later [TH*TW][COUT+8]
  float* ba = amap + S::kCells * S::kMPitch;       // 2 x [CMID][CIN + 4]
  float* bb = ba + 2 * CMID * (CIN + 4);           // 2 x [COUT][CMID + 4]
  float* dwa = bb + 2 * COUT * (CMID + 4);         // [9][CIN]
  float* bn1 = dwa + 9 * CIN;                      // mul[CIN], add[CIN]
  float* bn2 = bn1 + 2 * CIN;                      // mul[CMID], add[CMID]
  float* dwb = bn2 + 2 * CMID;                     // [9][CMID]
  float* bnb1 = dwb + 9 * CMID;                    // mul[CMID], add[CMID]
  float* bnb2 = bnb1 + 2 * CMID;                   // mul[COUT], add[COUT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const int tile_y = blockIdx.x / tiles_x;
  const int ty0 = tile_y * TH, tx0 = (blockIdx.x - tile_y * tiles_x) * TW;
  const int ay0 = ty0 - 1, ax0 = tx0 - 1;          // stage-A origin
  const int iy0 = 2 * ay0 - 1, ix0 = 2 * ax0 - 1;  // input origin

  // ---- staging: B operands and the input footprint by cp.async -----------
  stage_split_f32<CMID, CIN, CIN + 4>(ba, pwa, tid);
  stage_split_f32<COUT, CMID, CMID + 4>(bb, pwb, tid);
  {
    // 16-byte pieces of the footprint's rows, zero off the input map; a
    // thread's next piece is kThreads pieces on, which moves its row and
    // column by constants
    constexpr int PP = CIN / 4;           // pieces a pixel
    constexpr int RP = S::kIC * PP;       // pieces a row
    constexpr int DR = kThreads / RP, DC = kThreads % RP;
    int rr = tid / RP, cc = tid % RP;
    for (int i = tid; i < S::kIR * RP; i += kThreads) {
      const int px = cc / PP, part = cc % PP;
      const int gy = iy0 + rr, gx = ix0 + px;
      const bool ok =
          (unsigned)gy < (unsigned)hi && (unsigned)gx < (unsigned)wi;
      const float* src =
          ok ? in + (((size_t)b * hi + gy) * wi + gx) * CIN + part * 4 : in;
      cp_async16_zfill(xs + (rr * S::kIC + px) * CIN + part * 4, src, ok);
      rr += DR;
      cc += DC;
      if (cc >= RP) {
        cc -= RP;
        ++rr;
      }
    }
  }
  cp_async_commit();
  // the f32 pack: dw [9][CIN], mul, add, pw [CIN][CMID], mul, add, then
  // block B: dw [9][CMID], mul, add, pw [CMID][COUT], mul, add
  stage_f32(dwa, w, 11 * CIN, tid);  // taps and BN, contiguous
  stage_f32(bn2, w + 11 * CIN + CIN * CMID, 2 * CMID, tid);
  const float* wb = w + 11 * CIN + CIN * CMID + 2 * CMID;
  stage_f32(dwb, wb, 11 * CMID, tid);
  stage_f32(bnb2, wb + 11 * CMID + CMID * COUT, 2 * COUT, tid);
  cp_async_wait_all();
  __syncthreads();

  // ---- stage A: depthwise 3x3/2 + BN + LeakyReLU -> aa -------------------
  {
    constexpr int NP = CIN / 2;
    constexpr int STEP = kThreads / NP;  // cells a pass
    constexpr int DR = STEP / S::kAC, DQ = STEP % S::kAC;
    const int pr = tid % NP;
    float2 tap[9];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      tap[t] = make_float2(dwa[t * CIN + 2 * pr], dwa[t * CIN + 2 * pr + 1]);
    const float2 mul = make_float2(bn1[2 * pr], bn1[2 * pr + 1]);
    const float2 add = make_float2(bn1[CIN + 2 * pr], bn1[CIN + 2 * pr + 1]);
    int cell = tid / NP;
    int r = cell / S::kAC, q = cell % S::kAC;
    for (; cell < S::kCells; cell += STEP) {
      const float* s = xs + (2 * r * S::kIC + 2 * q) * CIN + 2 * pr;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float2 v = *reinterpret_cast<const float2*>(
              s + (dy * S::kIC + dx) * CIN);
          s0 = fmaf(v.x, tap[dy * 3 + dx].x, s0);
          s1 = fmaf(v.y, tap[dy * 3 + dx].y, s1);
        }
      *reinterpret_cast<float2*>(aa + cell * S::kAPitch + 2 * pr) =
          make_float2(leaky(fmaf(s0, mul.x, add.x)),
                      leaky(fmaf(s1, mul.y, add.y)));
      r += DR;
      q += DQ;
      if (q >= S::kAC) {
        q -= S::kAC;
        ++r;
      }
    }
  }
  __syncthreads();

  // ---- stage A: pointwise GEMM [cells x CIN] x [CIN x CMID] -> f32 amap --
  // (BN + LeakyReLU, zero off the stage-A map: the next depthwise's
  // padding); units of one m16 tile and half of N
  {
    constexpr int MT = (S::kCells + 15) / 16;
    constexpr int NH = CMID / 2, NF = NH / 8;
    const int gq = lane >> 2, tq = lane & 3;
    for (int u = warp; u < 2 * MT; u += kThreads / 32) {
      const int mt = u >> 1, n0 = (u & 1) * NH;
      float acc[NF][4];
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      gemm_tf32x3<CIN, NF, S::kAPitch, CIN + 4>(
          acc, aa, ba, ba + CMID * (CIN + 4),
          min(mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1), S::kCells - 1),
          n0, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mt * 16 + gq + 8 * hh;
        if (m >= S::kCells) continue;
        const int r = m / S::kAC, q = m - r * S::kAC;  // once per row
        const bool ok = (unsigned)(ay0 + r) < (unsigned)ho &&
                        (unsigned)(ax0 + q) < (unsigned)wo;
        float* row = amap + m * S::kMPitch;
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          const int n = n0 + j * 8 + 2 * tq;
          *reinterpret_cast<float2*>(row + n) = make_float2(
              ok ? leaky(fmaf(acc[j][2 * hh], bn2[n], bn2[CMID + n])) : 0.f,
              ok ? leaky(fmaf(acc[j][2 * hh + 1], bn2[n + 1],
                              bn2[CMID + n + 1]))
                 : 0.f);
        }
      }
    }
  }
  __syncthreads();

  // ---- stage B: depthwise 3x3/1 -> ab, pointwise -> out ------------------
  depthwise_s1_f32<CMID, TH, TW, S::kMPitch, S::kBPitch>(amap, ab, dwb, bnb1,
                                                         tid);
  __syncthreads();
  pointwise_out_f32<CMID, COUT, (TH * TW >= 128 ? 1 : 2), TH, TW,
                    S::kBPitch, CMID + 4>(ab, bb, bnb2, ob, out, b, ty0,
                                          tx0, ho, wo, tid);
}

template <int TH, int TW>
int launch_tf32_first(const uint8_t* frames, const float* w,
                      const float* sub, const float* w0, const float* pw,
                      float* out, int b, int hi, int wi,
                      cudaStream_t stream) {
  using S = FirstTfSmem<TH, TW>;
  auto kern = segment_tf32_first<TH, TW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int ho = (hi + 1) / 2, wo = (wi + 1) / 2;
  const int tiles_x = (wo + TW - 1) / TW, tiles_y = (ho + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, b);
  kern<<<grid, kThreads, S::kBytes, stream>>>(frames, w, sub, w0, pw, out,
                                              hi, wi, ho, wo, tiles_x);
  return (int)cudaGetLastError();
}

template <int CIN, int CMID, int COUT, int TH, int TW, int MINB>
int launch_tf32(const float* in, const float* w, const float* pwa,
                const float* pwb, float* out, int b, int hi, int wi,
                cudaStream_t stream) {
  using S = TfSmem<CIN, CMID, COUT, TH, TW>;
  auto kern = segment_tf32<CIN, CMID, COUT, TH, TW, MINB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int ho = (hi + 1) / 2, wo = (wi + 1) / 2;
  const int tiles_x = (wo + TW - 1) / TW, tiles_y = (ho + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, b);
  kern<<<grid, kThreads, S::kBytes, stream>>>(in, w, pwa, pwb, out, hi, wi,
                                              ho, wo, tiles_x);
  return (int)cudaGetLastError();
}

// the three f32 segments; the tiles and their reckoning are in the header
int run_stage1_tf32(const uint8_t* frames, const float* weights, float* out,
                    float* s1, float* s2, int b, int h, int w,
                    cudaStream_t st, int* launches) {
  using W1 = SegWeights<3, 8, 16, true>;
  using W2 = SegWeights<16, 32, 32, false>;
  static_assert(FirstTfSmem<16, 16>::kBytes == 49472, "segment 1 reckoning");
  static_assert(TfSmem<16, 32, 32, 8, 16>::kBytes == 109888,
                "segment 2 reckoning");
  static_assert(TfSmem<32, 64, 64, 8, 8>::kBytes == 158144,
                "segment 3 reckoning");
  if (((uintptr_t)frames | (uintptr_t)weights | (uintptr_t)out |
       (uintptr_t)s1 | (uintptr_t)s2) & 15)
    return (int)cudaErrorMisalignedAddress;
  const float* sub = weights;
  const float* w1 = weights + 4;
  const float* w2 = w1 + W1::kTotal;
  const float* w3 = w2 + W2::kTotal;
  const float* wt = weights + kF32Weights;
  const int h2 = (h + 1) / 2, w2s = (w + 1) / 2;
  const int h4 = (h2 + 1) / 2, w4s = (w2s + 1) / 2;
  int e = launch_tf32_first<16, 16>(frames, w1, sub, wt + kTfConv0,
                                    wt + kTfPw1, s1, b, h, w, st);
  if (e) return e;
  ++*launches;
  e = launch_tf32<16, 32, 32, 8, 16, 2>(s1, w2, wt + kTfPw2, wt + kTfPw3, s2,
                                        b, h2, w2s, st);
  if (e) return e;
  ++*launches;
  e = launch_tf32<32, 64, 64, 8, 8, 1>(s2, w3, wt + kTfPw4, wt + kTfPw5, out,
                                       b, h4, w4s, st);
  if (e) return e;
  ++*launches;
  return 0;
}

}  // namespace

// frames [B, H, W, 3] uint8 -> out [B, H8, W8, 64] (f32, or bf16 when
// out_bf16), via scratch1 [B, H2, W2, 16] and scratch2 [B, H4, W4, 32] of
// the same dtype. weights: the f32 pack [10132], followed for bf16 output
// by the bf16 pack of pack_stage1_mma_weights [16384 bf16] and for f32
// output by the split pack of pack_stage1_tf32x3_weights [16128 f32], every
// pointer 16-byte aligned. Three launches on `stream`, no
// synchronisation; writes the number of kernels launched to *launches and
// returns the first CUDA error (0 on success).
extern "C" int vn_mnet_stage1(const uint8_t* frames, const float* weights,
                              void* out, void* scratch1, void* scratch2,
                              int b, int h, int w, int out_bf16,
                              void* stream, int* launches) {
  *launches = 0;
  if (b <= 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidConfiguration;
  int e = vn_set_device_of(out);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    return run_stage1_mma(frames, weights, (bf16*)out, (bf16*)scratch1,
                          (bf16*)scratch2, b, h, w, st, launches);
  return run_stage1_tf32(frames, weights, (float*)out, (float*)scratch1,
                         (float*)scratch2, b, h, w, st, launches);
}
