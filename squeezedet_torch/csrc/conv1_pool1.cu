// conv1 + bias + ReLU + pool1 of squeezeDet in one pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel squeezedet_tpu/ops/fused_frontend.py:conv1_pool1_fused:
//   out = max_pool_3x3_s2_SAME(relu(conv_3x3_s2_SAME(x, k) + b))
// with x [B,H,W,3] NHWC (f32 or bf16), k [3,3,3,64] HWIO and b [64] given in
// f32 (already rounded to x's dtype by the wrapper), out [B,Hp,Wp,64] NHWC in
// x's dtype.  Sums, bias and ReLU are f32; the result is rounded once.
// Padding is TF SAME (pad_top = pad_total / 2) for the conv (zeros) and the
// pool (-inf: a tap outside the conv output is skipped), so any H and W are
// taken; the wrapper computes the geometry and passes it in.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s bf16 on tensor
// cores, 67 TFLOP/s f32 on CUDA cores).  At batch 128, 384x1248, bf16 the
// kernel must read 368 MB of images and write 491 MB of pooled output:
// 0.26 ms of memory time.  The conv is 53 GFLOP (K = 27 taps x 64 channels
// per output): 0.054 ms on bf16 tensor cores, 0.8 ms on f32 CUDA cores.  So
// on tensor cores the kernel is bound by bytes.  The unfused path would
// also write and read back a 1.96 GB conv1 activation; here a block
// computes each conv output of its tile once into shared memory and pools
// out of it, so only the halo rows and columns of a tile are computed twice.
//
// bf16 route (tensor cores), conv1_pool1_tma: persistent blocks, 2 resident
// on each SM (101 KB of shared memory and 95 registers a thread each, 0
// spill bytes: 16 consumer warps and 2 producer warps an SM), walk the
// (image, 6 x 16 tile of pool outputs) tiles: 13 x 33 conv outputs, 27 x
// 67 input pixels a tile.  A block is one producer warp and 8 consumer
// warps:
//   1. the producer keeps a 2-stage ring of halo tiles full with TMA: a
//      1-D tensor map over the flat images (a pixel is 6 bytes, so a row of
//      a 1242-wide frame or of a tile window is not a whole number of 16
//      bytes, and no 2-D or 3-D map describes every geometry), one box a
//      halo row, issued by one lane a row and completed on the stage's
//      mbarrier.  A box must start on a 16-byte boundary, so it starts at
//      the word holding the row's first element, delta = 0..7 elements
//      before it, and is 216 elements long; the lane records where the row
//      begins in the stage.  Rows outside the image are not loaded.  A
//      box's start is a 32-bit coordinate from the map's base, so images
//      of 2^31 elements or more in all are cut into launches of whole
//      tile rows, each with its own 16-byte-aligned base.  The
//      consumers' registers hold no load in flight;
//   2. on an edge tile the consumers zero what lies outside the image (the
//      rows not loaded and the columns a box read from the neighbouring
//      row) and fill the one row a box cannot reach (it would start
//      before the tensor); the frame's interior tiles skip this;
//   3. the conv is a GEMM: M = the 429 conv positions (27 m16 tiles), N =
//      64, K = 27 taps padded to 32 (two k16 steps of mma.sync.m16n8k16, f32
//      accumulators whose first C is the bias), ordered as 3 kernel rows of
//      10 slots, so that each A register (2 slots) is one 4-byte load from
//      the halo tile.  A row whose first element sits at an odd delta is
//      read from one element earlier and its taps sit in slots 1-9: the
//      rows 2 apart share delta's parity, so each tile takes one of two
//      weight layouts, kept as B fragments in shared memory.  When W % 8
//      == 0 (1248-wide frames) every row of a tile has the same delta, and
//      the A addresses need no per-row offset (the kUniform instance).
//      Output channels are permuted in B so that a thread's accumulators
//      of one position are 16 consecutive channels.  Consumer warp w takes
//      m16 tiles w, w + 8, ..; then the stage is freed for the producer;
//   4. the epilogue applies ReLU and the one rounding to bf16 in one
//      conversion (cvt.rn.relu.bf16x2.f32) and stores the conv tile in
//      shared memory as 128-byte rows whose 16-byte chunks are XOR-swizzled
//      (no bank conflict on either side); positions outside the conv
//      output hold -inf.  Rounding is monotonic, so pooling the rounded
//      values equals rounding the pooled f32 value once;
//   5. each thread pools 8 channels of 2 neighbouring outputs (column
//      maxima first, shared by the two) into an output tile laid out as
//      out's 64 x 16 x 6 box, which one thread hands to a TMA store
//      (cp.async.bulk.tensor); the store clips at out's edges, and the
//      next tile waits for it only before writing the output tile again.
// What binds it is the conv GEMM's latency, not the bytes: at B=128
// 384x1248 on an H100 80GB HBM3 (700 W) it takes 0.885-0.911 ms against
// a 0.256 ms byte bound, and builds of it without the GEMM took 0.41 ms,
// without the TMA loads (computing on stale tiles) about as long as with
// them: each warp's m16 tiles are chains of dependent shared loads, mmas
// and stores, and 16 consumer warps an SM hide too little of them.  More
// stages, smaller tiles, 3 blocks an SM and the B fragments in registers
// were each slower or spilled.
// f32 route (CUDA cores, f32 FMAs: no TF32), conv1_pool1_f32_strip: each
// warp walks a strip of 15 pool columns (32 conv columns, 31 of them used;
// 65 input pixels) down a run of pool rows of one image, on its own:
//   1. its lanes keep a ring of 6 halo rows full with 4-byte cp.async
//      copies (zero-filled outside the image), two rows a conv row, issued
//      two conv rows ahead, so the loads overlap the FMAs;
//   2. each halo row, once landed, is rewritten as 9 tap planes: plane
//      (dj, ci) holds the tap's input float of each of the 32 conv
//      columns, so a tap's operands for 8 neighbouring positions are 2
//      float4 loads into the same registers at every tap;
//   3. a conv row is 32 positions x 64 channels in registers: lane 8 pg +
//      cg holds positions 8 pg .. 8 pg + 7 and channels 32 h + 4 cg + e,
//      64 accumulators, and a tap is 2 float4 loads of inputs, 2 of
//      weights (a warp reads 128 consecutive bytes of them) and 64 FMAs,
//      a weight at a time over the 8 positions;
//   4. the pool runs on the raw sums, in registers: the maxima over the
//      3 conv columns of each of the lane's 4 outputs (the ninth column is
//      the next lane group's first, by a shuffle), then over 3 conv rows
//      (the row two pool rows share is carried, not recomputed), and the
//      bias and ReLU once per pooled value, stored as float4s.  Adding the
//      bias and ReLU are monotonic (an f32 add rounds monotonically), so
//      relu(max + b) equals the max of relu(sum + b) bit for bit; each sum
//      is fmaf over the 27 taps in (di, dj, ci) order from +0.0f.
// A block is 4 such warps, 3 blocks an SM (162 registers, 0 spill bytes),
// and is not persistent; the launch plan (f32_plan, the same function as
// ops/fused_frontend.f32_plan) picks the run of pool rows a warp takes so
// that the card fills at B=1 and on a tile's window, and the conv row two
// runs share is computed seldom at B=128 (runs of 16 pool rows).
// Addresses are 64-bit and the copies 4-byte, so any contiguous f32
// images at any 4-byte-aligned start take one launch.
// What binds it is FFMA issue: a conv row costs a lane 1,728 FFMAs and
// about 330 other instructions, and about a fifth of the FFMAs read both
// register operands from one register bank (ptxas' allocation; a stall
// cycle each).  At B=128 384x1248 on an H100 80GB HBM3 (700 W) it takes
// about 1.49 ms against a 0.79 ms bound (53 GFLOP at 67 TFLOP/s), and the
// card draws its 700 W and lowers its clock under it.  Earlier builds of
// this design took 4.2 ms with the weights in constant memory (as FFMA
// operands), and 1.66-1.70 ms with a lane window of 52 input floats in
// place of the planes: the window's registers change parity from tap to
// tap, so ptxas could not keep the FFMAs' two register reads in two banks.
// The conv1 activation never reaches device memory on either route.

#include <cuda.h>  // CUtensorMap; the encoder is fetched through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCin = 3;
constexpr int kTaps = 9 * kCin;         // 27
constexpr int kCout = 64;

struct Geometry {
  int H, W;            // input
  int Hc, Wc;          // conv output
  int Hp, Wp;          // pool output
  int pad_t, pad_l;    // conv SAME pads (top, left)
  int ppad_t, ppad_l;  // pool SAME pads (top, left)
};

// ---- bf16 route (tensor cores, TMA in and out) ----------------------------

constexpr int kTcTP = 6;                    // pool rows a tile
constexpr int kTcTQ = 16;                   // pool cols a tile
constexpr int kTcCR = 2 * kTcTP + 1;        // conv rows a tile (13)
constexpr int kTcCC = 2 * kTcTQ + 1;        // conv cols a tile (33)
constexpr int kTcIR = 2 * kTcCR + 1;        // input rows a tile (27)
constexpr int kTcIC = 2 * kTcCC + 1;        // input cols a tile (67)
constexpr int kTcPos = kTcCR * kTcCC;       // conv positions (429)
constexpr int kTcM16 = (kTcPos + 15) / 16;  // m16 tiles (27)
constexpr int kRowElems = kTcIC * kCin;     // 201 bf16 in a halo row
// A halo row's 1-D box starts at the 16-byte word holding its first
// element (TMA takes no other start), delta = 0..7 elements before it, so
// 216 elements (whole 16 bytes) cover the 201 wherever they start.
constexpr int kRowBox = 216;
constexpr int kHaloPitch = 256;             // a row lands 128-byte aligned
constexpr int kZero = kRowBox;              // a zero pair past row 0's box:
                                            // the GEMM's pad taps read it
constexpr int kHaloBytes = kTcIR * kHaloPitch * 2;       // a stage (13824)
constexpr int kHaloStages = 2;
constexpr int kOutBytes = kTcTP * kTcTQ * kCout * 2;     // out's box (12288)
constexpr int kConvBytes = kTcPos * kCout * 2;           // (54912)
constexpr int kWeightBytes = 2 * 2 * 4 * 32 * 16;        // 8192: B fragments
constexpr int kRowOffWords = kTcIR;          // a stage's row offsets
constexpr int kRowOffBytes = kHaloStages * kRowOffWords * 4;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;          // 256
constexpr int kTcThreads = kConsumers + 32;              // + the producer
constexpr int kTcBlocksPerSm = 2;
constexpr int kTcSmemBytes = kHaloStages * kHaloBytes + kOutBytes +
                             kConvBytes + kWeightBytes + kCout * 4 +
                             kRowOffBytes + 128;  // + alignment
// The GEMM's K index: kernel row di (3) x 10 slots, then 2 padding: 32.
// A pair of slots (k, k+1), k even, never spans two kernel rows, so it is
// one 4-byte load from the halo row.  A row whose first element lies at
// an odd offset (delta odd: the frame's width or the window's left edge
// makes a row start mid-pixel-pair) is read from one element earlier, so
// that the pairs stay 4-byte aligned: its 9 taps (dj, ci) then sit in
// slots 1-9 instead of 0-8.  A tile's rows 2r + di share delta's parity
// for each di (the rows of one parity are an even number of rows apart),
// so each tile needs one of two weight layouts: variant v holds kernel
// rows 0 and 2 shifted when v & 1 and row 1 when the launch's width makes
// it differ (the odd shift of row 1 is (v & 1) ^ (W & 1)).
constexpr int kKRow = 10;
constexpr uint64_t kWaitNs = 10000000000ull;  // a stuck barrier traps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// spin until the phase of parity `parity` has completed; trap (a launch
// error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = global_ns();
    else if (global_ns() - start > kWaitNs) __trap();
  }
}
// a 1-D box of kRowBox elements from element `e` of the flat images; the
// part outside the tensor reads as zero
__device__ __forceinline__ void tma_load_row(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint32_t bar, int e) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(e)
      : "memory");
}
// out's 64 x 16 x 4 x 1 box at (0, q0, p0, b) from shared `src`; the part
// outside the tensor is not written
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               uint32_t src, int q0, int p0,
                                               int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(q0), "r"(p0), "r"(b)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a (16x16 bf16, row) * b (16x8 bf16, col) + (c0, c1, c0, c1)
__device__ __forceinline__ void mma_bf16_c(float* d, const uint32_t* a,
                                           const uint32_t* b, float c0,
                                           float c1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%10,%11};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c0), "f"(c1));
}

// relu(round(lo)), relu(round(hi)) as a bf16 pair (lo in the low half)
__device__ __forceinline__ uint32_t relu_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// two bf16 (lo at the smaller k) in one register
__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// elementwise max of two sets of 8 bf16 held in registers
__device__ __forceinline__ uint32_t hmax2_bits(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint4 hmax8(uint4 a, uint4 b) {
  return make_uint4(hmax2_bits(a.x, b.x), hmax2_bits(a.y, b.y),
                    hmax2_bits(a.z, b.z), hmax2_bits(a.w, b.w));
}

// byte offset of channels 8 chunk .. 8 chunk + 7 of conv position m in the
// conv tile: 128-byte rows whose 16-byte chunks are XOR-swizzled by m % 8,
// so the epilogue's 4-byte stores (8 positions x 4 pairs a warp) and the
// pool's 16-byte loads (8 chunks of a position) hit every bank once
__device__ __forceinline__ uint32_t conv_at(int m, int chunk) {
  return (uint32_t)(m * 128 + ((chunk ^ (m & 7)) << 4));
}

// Where one tile (kTcTP x kTcTQ pool outputs of one image) lies
struct Tile {
  int b, p0, q0;   // image; first pool row and column
  int cr0, cc0;    // first conv row and column
  int ir0, ic0;    // first input row and column
};

__device__ __forceinline__ Tile tile_at(int64_t t, int tiles_q, int tiles_p,
                                        const Geometry& g) {
  Tile tl;
  const int64_t per_image = (int64_t)tiles_q * tiles_p;
  tl.b = (int)(t / per_image);
  const int rest = (int)(t - tl.b * per_image);
  tl.p0 = (rest / tiles_q) * kTcTP;
  tl.q0 = (rest % tiles_q) * kTcTQ;
  tl.cr0 = 2 * tl.p0 - g.ppad_t;
  tl.cc0 = 2 * tl.q0 - g.ppad_l;
  tl.ir0 = 2 * tl.cr0 - g.pad_t;
  tl.ic0 = 2 * tl.cc0 - g.pad_l;
  return tl;
}

// Persistent: block i takes tiles i, i + gridDim.x, ...  Warp 8 is the
// producer: for each tile, one lane a halo row issues that row's 1-D TMA
// load into the next free stage of the ring, from the 16-byte word that
// holds the row's first element, and records where the row's words start
// (rows outside the image, and a row that would start before the tensor,
// are not loaded).  Warps 0-7 are the consumers: they wait for the stage,
// zero what lies outside the image and fill a row that was not loaded
// from the tensor (edge tiles only), run the conv GEMM into the conv tile
// (warp w: m16 tiles w, w + 8, ..., all 64 channels), free the stage,
// pool into the output tile and hand it to a TMA store.
template <bool kUniform>  // every halo row's first pixel at one word offset
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
conv1_pool1_tma(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap omap,
                const uint16_t* __restrict__ x, const float* __restrict__ k,
                const float* __restrict__ bias, Geometry g, int tiles_q,
                int tiles_p, int64_t t0, int64_t t1, int64_t e_base) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kHaloStages];
  __shared__ __align__(8) uint64_t empty[kHaloStages];
  // [halo stages][output tile][conv tile][weights][bias][row words],
  // 128-byte aligned
  unsigned char* smem = smem_raw + ((128 - smem_addr(smem_raw) % 128) % 128);
  unsigned char* s_o = smem + kHaloStages * kHaloBytes;
  unsigned char* s_c = s_o + kOutBytes;
  uint4* s_w = reinterpret_cast<uint4*>(s_c + kConvBytes);
  float* s_b = reinterpret_cast<float*>(s_c + kConvBytes + kWeightBytes);
  int* s_row = reinterpret_cast<int*>(s_b + kCout);  // [stage][row]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, q = lane & 3;  // mma fragment row and column
  if (tid < kCout) s_b[tid] = bias[tid];
  // B fragments of the 32 x 64 weight matrix for layout v, k16 step s and
  // n8 tile j: (k 16s+2q, +1 | 16s+2q+8, +9; column gq), a lane's 8
  // registers of a step as 4 uint4s [v][s][j / 2][lane] (consecutive
  // lanes: no bank conflict).  Column n of n8 tile j is channel
  // 16 (n / 2) + 2 j + n % 2, so that a thread's accumulators of one row
  // are channels 16 q .. 16 q + 15 in order; slot k % 10 of kernel row
  // k / 10 holds tap (dj, ci) = slot - shift.  Written by warps 0 and 1.
  if (warp < 2) {
    const int v = warp;
    const int ch = 16 * (gq >> 1) + (gq & 1);  // + 2 j
    auto weight = [&](int kk, int n) -> uint16_t {
      const int di = kk / kKRow;
      const int shift = di == 1 ? v ^ (g.W & 1) : v;
      const int t = kk % kKRow - shift;  // t = 3*dj + ci
      return di < 3 && t >= 0 && t < 9
                 ? bf16_bits(k[(9 * di + t) * kCout + n]) : 0;
    };
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // j = 2 jp + u / 2, h = u % 2
          const int k0 = 16 * s + 2 * q + 8 * (u % 2);
          const int n = ch + 2 * (2 * jp + u / 2);
          r[u] = pack(weight(k0, n), weight(k0 + 1, n));
        }
        s_w[((v * 2 + s) * 4 + jp) * 32 + lane] =
            make_uint4(r[0], r[1], r[2], r[3]);
      }
  }
  if (tid < kHaloStages)  // the zero pair the pad taps read
    reinterpret_cast<uint32_t*>(smem + tid * kHaloBytes)[kZero / 2] = 0u;
  if (tid == 0) {
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(smem_addr(&full[s]), 32);               // the producer's lanes
      mbar_init(smem_addr(&empty[s]), kConsumerWarps);  // a warp's arrive
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer
    int it = 0;
    for (int64_t t = t0 + blockIdx.x; t < t1; t += gridDim.x, ++it) {
      const int slot = it % kHaloStages;
      mbar_wait(smem_addr(&empty[slot]), ((it / kHaloStages) & 1) ^ 1);
      const Tile tl = tile_at(t, tiles_q, tiles_p, g);
      const uint32_t bar = smem_addr(&full[slot]);
      uint32_t rows = 0;
      int box[2];  // element coordinate of this lane's rows' boxes, or -1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        box[h] = -1;
        if (r >= kTcIR) continue;
        const int y = tl.ir0 + r;
        // the row's first element; delta = its offset in its 16-byte word
        // (the two's complement & 7 of a negative e too)
        const int64_t e = (((int64_t)tl.b * g.H + y) * g.W + tl.ic0) * kCin;
        const int delta = (int)(e & 7);
        s_row[slot * kRowOffWords + r] = r * kHaloPitch + delta;
        if (y >= 0 && y < g.H && e - delta >= e_base)
          box[h] = (int)(e - delta - e_base);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rows += __popc(__ballot_sync(0xffffffffu, box[h] >= 0));
      if (lane == 0) mbar_expect_tx(bar, rows * kRowBox * 2);
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (box[h] >= 0)
          tma_load_row(smem_addr(smem + slot * kHaloBytes) +
                           (lane + 32 * h) * kHaloPitch * 2,
                       &xmap, bar, box[h]);
      if (lane != 0) mbar_arrive(bar);
    }
    return;
  }

  // the consumers.  This thread's A pairs k = 16s + 2q + 8h, +1: kernel
  // row (3: padding) and slot
  int kdi[2][2], kslot[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 16 * s + 2 * q + 8 * h;
      kdi[s][h] = kk / kKRow;
      kslot[s][h] = kk % kKRow;
    }

  int it = 0;
  for (int64_t t = t0 + blockIdx.x; t < t1; t += gridDim.x, ++it) {
    const int slot = it % kHaloStages;
    mbar_wait(smem_addr(&full[slot]), (it / kHaloStages) & 1);
    const Tile tl = tile_at(t, tiles_q, tiles_p, g);
    uint16_t* s_x = reinterpret_cast<uint16_t*>(smem + slot * kHaloBytes);
    const int* rowoff = s_row + slot * kRowOffWords;  // element of row r's
                                                     // first pixel
    const bool edge = tl.ir0 < 0 || tl.ir0 + kTcIR > g.H || tl.ic0 < 0 ||
                      tl.ic0 + kTcIC > g.W || tl.cr0 < 0 ||
                      tl.cr0 + kTcCR > g.Hc || tl.cc0 < 0 ||
                      tl.cc0 + kTcCC > g.Wc;
    // 1. on an edge tile: zero what lies outside the image, and fill a row
    // of the image that was not loaded (it would start before the tensor)
    // from the tensor itself (block-uniform)
    if (edge) {
      for (int i = tid; i < kTcIR * kRowElems; i += kConsumers) {
        const int r = i / kRowElems, e = i - r * kRowElems;
        const int yy = tl.ir0 + r, xx = tl.ic0 + e / kCin;
        const int64_t row =
            (((int64_t)tl.b * g.H + yy) * g.W + tl.ic0) * kCin;
        if (yy < 0 || yy >= g.H || xx < 0 || xx >= g.W)
          s_x[rowoff[r] + e] = 0;
        else if ((row & ~(int64_t)7) < e_base)
          s_x[rowoff[r] + e] = x[row + e];
      }
      // the producer's next TMA into this stage follows these writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync();
    }

    // the tile's weight layout: the parity of its first row's delta
    // (rows an even number apart share it); the masks that zero the half
    // of a pair that holds no tap (slot 9, or slot 0 of a shifted row: a
    // neighbour's element, or a row never written)
    const int v = rowoff[0] & 1;
    const uint4* w_frag = s_w + v * 2 * 4 * 32 + lane;
    uint32_t kmask[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int shift = kdi[s][h] == 1 ? v ^ (g.W & 1) : v;
        kmask[s][h] = !shift && kslot[s][h] == 8 ? 0x0000ffffu
                      : shift && kslot[s][h] == 0 ? 0xffff0000u
                                                  : 0xffffffffu;
      }

    // 2 + 3. conv GEMM over the tile's m16 tiles: bias + sum in f32 (the
    // bias is the first mma's C), then ReLU and the one rounding to bf16
    // in one conversion, into the conv tile (the previous tile's pool has
    // read it: barrier 3); positions outside the conv output hold -inf
    const uint32_t* s_x32 = reinterpret_cast<const uint32_t*>(s_x);
    const float4* bq = reinterpret_cast<const float4*>(s_b + 16 * q);
    const int d0 = rowoff[0] >> 1;  // word of row 0's first pixel pair
    for (int mt = warp; mt < kTcM16; mt += kConsumerWarps) {
      int r_of[2], c_of[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min(16 * mt + gq + 8 * h, kTcPos - 1);
        r_of[h] = m / kTcCC;
        c_of[h] = m - r_of[h] * kTcCC;
      }
      float acc[8][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // a0a1 (row g, k 2q..), a2a3 (row g+8), a4a5 (row g, k 2q+8..),
        // a6a7: the pair's word in halo row R = 2r + di, read from the
        // even element at or before the pixel's first: every row's first
        // pixel at the same offset in its word when kUniform
        uint32_t a[4];
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int di = kdi[s][kh];
            uint32_t word = kZero / 2;
            if (di < 3) {
              const int R = 2 * r_of[h] + di;
              word = (kUniform ? d0 + R * (kHaloPitch / 2)
                               : rowoff[R] >> 1) +
                     3 * c_of[h] + (kslot[s][kh] >> 1);
            }
            a[2 * kh + h] = s_x32[word] & kmask[s][kh];
          }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const uint4 w = w_frag[(s * 4 + jp) * 32];
          const uint32_t b0[2] = {w.x, w.y}, b1[2] = {w.z, w.w};
          if (s == 0) {
            const float4 bb = bq[jp];  // channels 16q + 4jp ..
            mma_bf16_c(acc[2 * jp], a, b0, bb.x, bb.y);
            mma_bf16_c(acc[2 * jp + 1], a, b1, bb.z, bb.w);
          } else {
            mma_bf16(acc[2 * jp], a, b0);
            mma_bf16(acc[2 * jp + 1], a, b1);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * mt + gq + 8 * h;
        if (m >= kTcPos) continue;
        uint32_t o[8];  // channels 16q + 2j, +1
#pragma unroll
        for (int j = 0; j < 8; ++j)
          o[j] = relu_bf16x2(acc[j][2 * h], acc[j][2 * h + 1]);
        if (edge) {
          const int cy = tl.cr0 + r_of[h], cx = tl.cc0 + c_of[h];
          if (cy < 0 || cy >= g.Hc || cx < 0 || cx >= g.Wc)
#pragma unroll
            for (int j = 0; j < 8; ++j) o[j] = 0xff80ff80u;  // -inf pair
        }
        *reinterpret_cast<uint4*>(s_c + conv_at(m, 2 * q)) =
            make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(s_c + conv_at(m, 2 * q + 1)) =
            make_uint4(o[4], o[5], o[6], o[7]);
      }
    }
    __syncwarp();  // this warp's reads of the stage are done: free it
    if (lane == 0) mbar_arrive(smem_addr(&empty[slot]));
    if (tid == 0)  // the previous tile's store has read the output tile
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    consumers_sync();  // 2. the conv tile is whole

    // 4. pool, separably: an item is 8 channels of 2 neighbouring outputs
    // of one pool row: the max of 3 conv rows in each of the 5 conv
    // columns they span, then of 3 of those column maxima per output,
    // into the output tile as out's box lays it out ([TP][16][64])
    for (int item = tid; item < kTcTP * (kTcTQ / 2) * (kCout / 8);
         item += kConsumers) {
      const int grp = item & 7;
      const int pc0 = 2 * ((item >> 3) % (kTcTQ / 2));
      const int pr = item / (8 * (kTcTQ / 2));
      uint4 cm[5];
#pragma unroll
      for (int cc = 0; cc < 5; ++cc) {
        const int m = 2 * pr * kTcCC + 2 * pc0 + cc;
        cm[cc] = *reinterpret_cast<const uint4*>(s_c + conv_at(m, grp));
#pragma unroll
        for (int a = 1; a < 3; ++a)
          cm[cc] = hmax8(cm[cc], *reinterpret_cast<const uint4*>(
                                     s_c + conv_at(m + a * kTcCC, grp)));
      }
      uint4* dst = reinterpret_cast<uint4*>(
          s_o + ((pr * kTcTQ + pc0) * kCout + 8 * grp) * 2);
      dst[0] = hmax8(hmax8(cm[0], cm[1]), cm[2]);
      dst[kCout / 8] = hmax8(hmax8(cm[2], cm[3]), cm[4]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();  // 3. the output tile is whole; the conv tile read
    if (tid == 0) tma_store_tile(&omap, smem_addr(s_o), tl.q0, tl.p0, tl.b);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- f32 route (CUDA cores, cp.async into a ring of halo rows) ------------

constexpr int kStripQ = 15;                  // pool cols of a warp's strip
constexpr int kStripPx = 4 * kStripQ + 5;    // its halo's input pixels (65)
constexpr int kRowFloats = kStripPx * kCin;  // a halo row's floats (195)
constexpr int kRowPitch = 196;               // a ring row: 16-byte rows; the
                                             // pad float is read (zeroed)
                                             // with the last float pair
constexpr int kRing = 6;                     // halo rows of a warp's ring
constexpr int kPlaneRows = 4;                // tap planes of halo rows
constexpr int kPlane = 9 * 32;               // a halo row's 9 tap planes
constexpr int kF32Warps = 4;                 // warps (strips) of a block
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32BlocksPerSm = 3;
constexpr int kMinLoad = 2;                  // see f32_plan

// a 4-byte copy from global to shared memory, zero-filled when bytes is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warp tile t of the launch plan: strip t % strips of image t / (strips *
// segs), pool rows (t / strips % segs) * tile_rows onwards.  Each warp runs
// alone after the block has staged the weights: its halo rows (tile-
// relative r: input row ir0 + r) go to ring slot r % kRing and their tap
// planes to plane slot r % kPlaneRows, conv row kk reads rows 2 kk ..
// 2 kk + 2, and pool row j takes conv rows 2 j .. 2 j + 2.
__global__ void __launch_bounds__(kF32Threads, kF32BlocksPerSm)
conv1_pool1_f32_strip(const float* __restrict__ x, const float* __restrict__ k,
                      const float* __restrict__ bias, float* __restrict__ out,
                      Geometry g, int tile_rows, int segs, int strips,
                      int64_t tiles) {
  __shared__ __align__(16) float s_w[kTaps * kCout];  // HWIO as given
  __shared__ __align__(16) float s_b[kCout];
  __shared__ __align__(16) float s_ring[kF32Warps][kRing][kRowPitch];
  __shared__ __align__(16) float s_planes[kF32Warps][kPlaneRows][kPlane];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pg = lane >> 3, cg = lane & 7;  // positions 8 pg.., channels
  for (int i = tid; i < kTaps * kCout; i += kF32Threads) s_w[i] = k[i];
  if (tid < kCout) s_b[tid] = bias[tid];
  float* ring = &s_ring[warp][0][0];
  float* planes = &s_planes[warp][0][0];
  if (lane < kRing) ring[lane * kRowPitch + kRowFloats] = 0.f;
  __syncthreads();

  const int64_t t = (int64_t)blockIdx.x * kF32Warps + warp;
  if (t >= tiles) return;
  const int64_t rest = t / strips;
  const int b = (int)(rest / segs);
  const int p0 = (int)(rest % segs) * tile_rows;
  const int q0 = (int)(t % strips) * kStripQ;
  const int np = min(tile_rows, g.Hp - p0);  // pool rows of the tile
  const int cr0 = 2 * p0 - g.ppad_t, cc0 = 2 * q0 - g.ppad_l;
  const int ir0 = 2 * cr0 - g.pad_t, ic0 = 2 * cc0 - g.pad_l;
  const int rows = 4 * np + 3;  // its halo rows

  // 1. this lane copies elements lane + 32 j of a halo row; those inside
  // the image's columns are [e_lo, e_hi), the rest are zero
  const float* xb = x + (int64_t)b * g.H * g.W * kCin;
  const int e_lo = max(-ic0, 0) * kCin;
  const int e_hi = min(g.W - ic0, kStripPx) * kCin;
  const bool inside = e_lo == 0 && e_hi == kRowFloats;
  const uint32_t ring_lane = smem_addr(ring) + 4 * lane;
  auto stage = [&](int r) {
    const int y = ir0 + r;
    const uint32_t dst = ring_lane + (r % kRing) * kRowPitch * 4;
    const bool row_in = y >= 0 && y < g.H;
    const int64_t e0 = ((int64_t)y * g.W + ic0) * kCin + lane;
    if (row_in && inside) {
#pragma unroll
      for (int j = 0; j < kRowFloats / 32; ++j)
        cp_async4(dst + 128 * j, xb + e0 + 32 * j, 4);
      if (lane < kRowFloats % 32)
        cp_async4(dst + 128 * (kRowFloats / 32),
                  xb + e0 + 32 * (kRowFloats / 32), 4);
    } else {
#pragma unroll
      for (int j = 0; j <= kRowFloats / 32; ++j) {
        const int e = lane + 32 * j;
        const bool in = row_in && e >= e_lo && e < e_hi;
        if (e < kRowFloats)
          cp_async4(dst + 128 * j, in ? xb + e0 + 32 * j : x, in ? 4 : 0);
      }
    }
  };

  // 2. halo row r as 9 tap planes: plane (dj, ci) holds, for each of the
  // 32 conv columns c, the tap's input float 6 c + 3 dj + ci, so that the
  // 8 positions of a lane are 2 float4 loads a tap; lane c moves its
  // column's 9 floats
  auto to_planes = [&](int r) {
    const float2* src = reinterpret_cast<const float2*>(
        ring + (r % kRing) * kRowPitch + 6 * lane);
    float v[10];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float2 f = src[i];
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
    float* dst = planes + (r % kPlaneRows) * kPlane + lane;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) dst[32 * tap] = v[tap];
  };

  // which of this lane's 8 positions are conv columns (the others are -inf
  // in the pool), and its 4 outputs: stored if in the strip and the frame,
  // -inf if their window holds no conv column (as in the plain version)
  uint32_t pos_in = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int cx = cc0 + 8 * pg + i;
    pos_in |= (uint32_t)(cx >= 0 && cx < g.Wc) << i;
  }
  const bool all_in = __all_sync(0xffffffffu, pos_in == 0xffu);
  bool store[4], col_win[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int q = 4 * pg + u, c = cc0 + 2 * q;
    store[u] = q < kStripQ && q0 + q < g.Wp;
    col_win[u] = c + 2 >= 0 && c < g.Wc;
  }
  const float4* b4 = reinterpret_cast<const float4*>(s_b) + cg;

  // rows 0-2 (conv row 0) and 3-4 (conv row 1) first; conv row kk then
  // waits for its rows 2 kk + 1, 2 kk + 2 (the group before the newest),
  // turns them into tap planes and issues rows 2 kk + 5, 2 kk + 6 (a
  // group, empty past the halo) into the slots of rows already turned
  stage(0), stage(1), stage(2);
  cp_async_commit();
  stage(3), stage(4);
  cp_async_commit();
  float m[4][8];  // the pool row's maxima so far (raw sums)
  for (int kk = 0; kk < 2 * np + 1; ++kk) {
    __syncwarp();  // every lane has read conv row kk - 1's tap planes
    cp_async_wait<1>();
    __syncwarp();  // ... and every lane's copies have landed
    if (kk == 0) to_planes(0);
    to_planes(2 * kk + 1);
    to_planes(2 * kk + 2);
    __syncwarp();  // the planes are whole, their rows read
    if (2 * kk + 5 < rows) stage(2 * kk + 5);
    if (2 * kk + 6 < rows) stage(2 * kk + 6);
    cp_async_commit();

    // 3. conv row kk: 8 positions x 8 channels a lane, then the maxima
    // over each output's 3 conv columns
    float hm[4][8];
    const int cy = cr0 + kk;
    if (cy >= 0 && cy < g.Hc) {  // warp-uniform
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int o = 0; o < 8; ++o) acc[i][o] = 0.f;
#pragma unroll 1
      for (int di = 0; di < 3; ++di) {
        // the tap planes of halo row 2 kk + di at this lane's positions,
        // and the weights of tap 9 di + tap: channels 32 h + 4 cg .. + 3
        const float4* xs = reinterpret_cast<const float4*>(
            planes + ((2 * kk + di) % kPlaneRows) * kPlane + 8 * pg);
        const float4* ws =
            reinterpret_cast<const float4*>(s_w + di * 9 * kCout) + cg;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {  // (dj, ci), ci fastest
          const float4 x0 = xs[8 * tap], x1 = xs[8 * tap + 1];
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
          float4 w[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) w[h] = ws[tap * (kCout / 4) + 8 * h];
          // a weight at a time over the 8 positions: the weight stays in
          // the operand reuse cache
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float wv = e == 0 ? w[h].x : e == 1 ? w[h].y
                               : e == 2 ? w[h].z : w[h].w;
#pragma unroll
              for (int i = 0; i < 8; ++i)
                acc[i][4 * h + e] = fmaf(xv[i], wv, acc[i][4 * h + e]);
            }
        }
      }
      if (!all_in) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (!(pos_in >> i & 1))
#pragma unroll
            for (int o = 0; o < 8; ++o) acc[i][o] = -INFINITY;
      }
      // output 4 pg + u: columns 8 pg + 2 u .. 8 pg + 2 u + 2, the last
      // of u = 3 the next lane group's first position
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float next = __shfl_down_sync(0xffffffffu, acc[0][o], 8);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          hm[u][o] = fmaxf(fmaxf(acc[2 * u][o], acc[2 * u + 1][o]),
                           u < 3 ? acc[2 * u + 2][o] : next);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int o = 0; o < 8; ++o) hm[u][o] = -INFINITY;
    }

    // 4. the maxima over the pool row's 3 conv rows; after its third,
    // bias, ReLU and the store, and that row starts the next pool row
    if (kk == 0 || (kk & 1)) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int o = 0; o < 8; ++o)
          m[u][o] = kk == 0 ? hm[u][o] : fmaxf(m[u][o], hm[u][o]);
      continue;
    }
    const int j = kk / 2 - 1, c0 = cr0 + 2 * j;
    const bool row_win = c0 + 2 >= 0 && c0 < g.Hc;
    float* orow = out + (((int64_t)b * g.Hp + p0 + j) * g.Wp + q0) * kCout +
                  4 * cg;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (store[u]) {
        const bool win = row_win && col_win[u];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 bb = b4[8 * h];
          const int o = 4 * h;
          float4 r;
          r.x = win ? fmaxf(fmaxf(m[u][o], hm[u][o]) + bb.x, 0.f) : -INFINITY;
          r.y = win ? fmaxf(fmaxf(m[u][o + 1], hm[u][o + 1]) + bb.y, 0.f)
                    : -INFINITY;
          r.z = win ? fmaxf(fmaxf(m[u][o + 2], hm[u][o + 2]) + bb.z, 0.f)
                    : -INFINITY;
          r.w = win ? fmaxf(fmaxf(m[u][o + 3], hm[u][o + 3]) + bb.w, 0.f)
                    : -INFINITY;
          *reinterpret_cast<float4*>(orow + (4 * pg + u) * kCout + 32 * h) =
              r;
        }
      }
#pragma unroll
      for (int o = 0; o < 8; ++o) m[u][o] = hm[u][o];
    }
  }
  cp_async_wait<0>();
}

// The f32 route's launch plan: strips of kStripQ pool columns, and each
// image's Hp pool rows cut into `segs` runs of tile_rows rows, one warp
// tile a (image, run, strip).  Of the cuts, the one whose estimated time
// is least, the first on a tie: the blocks an SM takes (at least kMinLoad,
// since a block alone on an SM waits on latency more than on issue) times
// the conv rows a warp computes (2 tile_rows + 1).
// ops/fused_frontend.f32_plan is the same function in Python.
struct F32Plan {
  int tile_rows, segs, strips;
  int64_t tiles, blocks;
};

F32Plan f32_plan(int B, int Hp, int Wp, int sms) {
  F32Plan best{0, 0, 0, 0, 0};
  int64_t best_cost = -1;
  const int strips = (Wp + kStripQ - 1) / kStripQ;
  for (int segs = 1; segs <= Hp; ++segs) {
    const int rows = (Hp + segs - 1) / segs;
    if ((Hp + rows - 1) / rows != segs) continue;  // a cut of fewer segs
    const int64_t tiles = (int64_t)B * segs * strips;
    const int64_t blocks = (tiles + kF32Warps - 1) / kF32Warps;
    if (blocks > 0x7fffffff) continue;  // past the grid's x limit
    const int64_t per_sm = (blocks + sms - 1) / sms;
    const int64_t cost =
        (per_sm > kMinLoad ? per_sm : kMinLoad) * (2 * rows + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = F32Plan{rows, segs, strips, tiles, blocks};
    }
  }
  return best;
}

int launch_f32(const float* x, const float* k, const float* bias, float* out,
               int B, const Geometry& g, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      conv1_pool1_f32_strip, cudaFuncAttributePreferredSharedMemoryCarveout,
      100);
  if (err != cudaSuccess ||
      (err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const F32Plan p = f32_plan(B, g.Hp, g.Wp, sms);
  if (p.blocks == 0) return (int)cudaErrorInvalidValue;
  conv1_pool1_f32_strip<<<(unsigned)p.blocks, kF32Threads, 0, stream>>>(
      x, k, bias, out, g, p.tile_rows, p.segs, p.strips, p.tiles);
  return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 1-D map over `elems` bf16 of the flat images from `x` (boxes of one
// halo row), and a 4-D map over the pooled output [B, Hp, Wp, 64] (boxes
// of one tile)
bool encode_images_map(EncodeTiled fn, CUtensorMap* xm, const void* x,
                       int64_t elems) {
  const cuuint64_t dims[1] = {(cuuint64_t)elems};
  const cuuint64_t strides[1] = {0};  // none: rank 1
  const cuuint32_t box[1] = {kRowBox}, one[1] = {1};
  return fn(xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 1, const_cast<void*>(x),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_out_map(EncodeTiled fn, CUtensorMap* om, void* out, int B,
                    const Geometry& g) {
  const cuuint64_t dims[4] = {kCout, (cuuint64_t)g.Wp, (cuuint64_t)g.Hp,
                              (cuuint64_t)B};
  const cuuint64_t row = kCout * 2;
  const cuuint64_t strides[3] = {row, row * g.Wp, row * g.Wp * g.Hp};
  const cuuint32_t box[4] = {kCout, kTcTQ, kTcTP, 1}, one[4] = {1, 1, 1, 1};
  return fn(om, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, dims, strides,
            box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A halo row's box starts at a signed 32-bit element coordinate, counted
// from the tensor map's base: a launch takes the tiles whose rows lie
// within kMaxElems elements of a 16-byte-aligned base.  Images of fewer
// elements in all (B=128 at 384x1248: 184 million) take one launch.
constexpr int64_t kMaxElems = (1ll << 31) - 4096;

int launch_tc(const __nv_bfloat16* x, const float* k, const float* bias,
              __nv_bfloat16* out, int B, const Geometry& g,
              cudaStream_t stream, int* launches) {
  // the rows of a tile start at one offset in their 16-byte words when a
  // row is a whole number of 16-byte words (W % 8 == 0, as at 1248)
  auto kernel = g.W % 8 == 0 ? conv1_pool1_tma<true> : conv1_pool1_tma<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kTcThreads, kTcSmemBytes)) != cudaSuccess)
    return (int)err;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int tiles_q = (g.Wp + kTcTQ - 1) / kTcTQ;
  const int tiles_p = (g.Hp + kTcTP - 1) / kTcTP;
  const int64_t total = (int64_t)B * g.H * g.W * kCin;  // elements
  const int64_t rows = (int64_t)B * tiles_p;  // tile rows, image-major
  // the first element the halo rows of tile row R read, or (last) one
  // past the last, with room for the last box past the row's end
  auto halo_span = [&](int64_t R, bool last) -> int64_t {
    const int64_t b = R / tiles_p;
    const int ir0 =
        2 * (2 * (int)(R % tiles_p) * kTcTP - g.ppad_t) - g.pad_t;
    const int y = last ? ir0 + kTcIR - 1 : ir0;
    const int64_t row = b * g.H + (y < 0 ? 0 : y >= g.H ? g.H - 1 : y);
    if (last) return (row + 1) * g.W * kCin + 2 * kRowBox;
    const int64_t e = (row * g.W - 2 * g.ppad_l - g.pad_l) * kCin;
    return e < 0 ? 0 : e;
  };
  CUtensorMap om;
  if (!encode_out_map(fn, &om, out, B, g)) return (int)cudaErrorInvalidValue;
  for (int64_t r0 = 0; r0 < rows;) {
    const int64_t e_base = halo_span(r0, false) & ~(int64_t)7;
    if (halo_span(r0, true) - e_base > kMaxElems)
      return (int)cudaErrorInvalidValue;  // one tile row past 2^31
    int64_t r1 = total - e_base <= kMaxElems ? rows : r0 + 1;
    while (r1 < rows && halo_span(r1, true) - e_base <= kMaxElems) ++r1;
    CUtensorMap xm;
    if (!encode_images_map(fn, &xm, x + e_base,
                           total - e_base < kMaxElems ? total - e_base
                                                      : kMaxElems))
      return (int)cudaErrorInvalidValue;
    const int64_t t0 = r0 * tiles_q, t1 = r1 * tiles_q;
    const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const int blocks = (int)(t1 - t0 < resident ? t1 - t0 : resident);
    kernel<<<blocks, kTcThreads, kTcSmemBytes, stream>>>(
        xm, om, reinterpret_cast<const uint16_t*>(x), k, bias, g, tiles_q,
        tiles_p, t0, t1, e_base);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ++*launches;
    r0 = r1;
  }
  return (int)cudaSuccess;
}

}  // namespace

// Span markers (utils/profiling.span): an empty kernel for each boundary of
// each device span of the program, named for it, launched <<<1, 1>>> on the
// span's stream where the span begins and where it ends.  They read and
// write nothing.  In a profiler's trace they mark where a span's work
// begins and ends on the device, also inside a replayed CUDA graph, which
// the host's ranges do not reach.  The order is profiling.DEVICE_SPANS':
// span i begins with marker 2 i and ends with marker 2 i + 1.
#define SDT_SPANS(X)                                                      \
  X(ingest) X(matcher) X(forward) X(backward) X(optimizer) X(backbone)    \
  X(interpret) X(postprocess) X(res2) X(res3) X(res4)
#define SDT_SPAN_KERNELS(name)                                            \
  extern "C" __global__ void squeezedet_span_##name##_begin() {}          \
  extern "C" __global__ void squeezedet_span_##name##_end() {}
#define SDT_SPAN_POINTERS(name)                                           \
  squeezedet_span_##name##_begin, squeezedet_span_##name##_end,
SDT_SPANS(SDT_SPAN_KERNELS)

namespace {
void (*const kSpanMarkers[])() = {SDT_SPANS(SDT_SPAN_POINTERS)};
constexpr int kSpanMarkerCount =
    sizeof(kSpanMarkers) / sizeof(kSpanMarkers[0]);
}  // namespace

extern "C" {

// Enqueues span marker `index` on `stream`; returns the launch's
// cudaError_t.
int sdt_span_marker(int index, void* stream) {
  if (index < 0 || index >= kSpanMarkerCount)
    return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel(
      reinterpret_cast<const void*>(kSpanMarkers[index]), dim3(1), dim3(1),
      nullptr, 0, static_cast<cudaStream_t>(stream));
}

// Sets *count to the number of span markers and loads each into the
// current device's context (cudaFuncGetAttributes loads a function that
// lazy loading has not loaded yet), so that a stream capture may launch
// them.  Returns the cudaError_t.
int sdt_span_markers_load(int* count) {
  *count = kSpanMarkerCount;
  cudaFuncAttributes attributes;
  for (int i = 0; i < kSpanMarkerCount; ++i) {
    const cudaError_t err = cudaFuncGetAttributes(
        &attributes, reinterpret_cast<const void*>(kSpanMarkers[i]));
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; x must be
// 16-byte aligned, as its tensor map's base).  Sets *launches to the
// kernel launches it enqueued (one, or one per cut of bf16 images of 2^31
// elements or more) and returns the cudaError_t of the launches.
int sdt_conv1_pool1(const void* x, const void* k, const void* bias, void* out,
                    int B, int H, int W, int Hc, int Wc, int Hp, int Wp,
                    int pad_t, int pad_l, int ppad_t, int ppad_l, int dtype,
                    void* stream, int* launches) {
  const Geometry g{H, W, Hc, Wc, Hp, Wp, pad_t, pad_l, ppad_t, ppad_l};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  const float* bf = static_cast<const float*>(bias);
  *launches = 0;
  if (dtype == 0) {
    const int err = launch_f32(static_cast<const float*>(x), kf, bf,
                               static_cast<float*>(out), B, g, s);
    *launches = err == 0;
    return err;
  }
  if (dtype == 1 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_tc(static_cast<const __nv_bfloat16*>(x), kf, bf,
                     static_cast<__nv_bfloat16*>(out), B, g, s, launches);
  return (int)cudaErrorInvalidValue;
}

// The f32 route's launch plan for B images of Hp x Wp pool outputs on a
// card of `sms` SMs: plan = {tile rows, runs an image, strips, warp tiles,
// blocks}, as launch_f32 computes it.  Returns 0.
int sdt_conv1_pool1_f32_plan(int B, int Hp, int Wp, int sms,
                             int64_t* plan) {
  const F32Plan p = f32_plan(B, Hp, Wp, sms);
  plan[0] = p.tile_rows, plan[1] = p.segs, plan[2] = p.strips;
  plan[3] = p.tiles, plan[4] = p.blocks;
  return 0;
}

const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
