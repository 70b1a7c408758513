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
// bf16 route (tensor cores): persistent blocks of 8 warps, as many as are
// resident (2 on each SM), walk the (image, 8 x 16 tile of pool outputs)
// tiles, i.e. 17 x 33 conv outputs a tile (1.10x the pooled area).  Each
// tile runs four steps; the next tile's halo loads (step 1) are issued
// before this tile's steps 2-4, so they are in flight while it computes:
//   1. the input halo tile (35 x 67 pixels) is copied into shared memory as
//      bf16 with aligned 16-byte loads covering each row (a pixel is 6 bytes,
//      so rows are not 16-byte aligned); each element is moved to its place,
//      and everything outside the image is zero;
//   2. the conv is a GEMM: M = the 561 conv positions (36 m16 tiles), N = 64,
//      K = 27 taps padded to 32 (two k16 steps of mma.sync.m16n8k16, f32
//      accumulators), ordered as 3 kernel rows of 10 (9 taps, 1 pad) so
//      that each A register (2 taps) is one 4-byte load from the halo tile.
//      The 32 x 64 weight matrix lives in each warp's registers as B
//      fragments (the 5 pad taps are zero in both operands);
//   3. the epilogue adds the f32 bias, applies ReLU and stores the conv tile
//      in shared memory as bf16 (positions outside the conv output hold
//      -inf).  Rounding is monotonic, so pooling the rounded values equals
//      rounding the pooled f32 value once;
//   4. each thread pools 8 channels of 4 neighbouring outputs (column
//      maxima first, shared by neighbours) and stores each output's 8
//      channels as one 16-byte write.
// f32 route (CUDA cores): one block per (image, 4 x 16 pool tile); the halo
// tile as f32, the conv tile computed in f32 (16 channels per work item,
// weights read as float4 broadcasts), then pooled, one value per store.
// The conv1 activation never reaches device memory on either route.

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

// ---- f32 route (CUDA cores) ----------------------------------------------

constexpr int kTP = 4;                  // pool rows per block
constexpr int kTQ = 16;                 // pool cols per block
constexpr int kCR = 2 * kTP + 1;        // conv rows per block
constexpr int kCC = 2 * kTQ + 1;        // conv cols per block
constexpr int kIR = 2 * kCR + 1;        // input rows per block
constexpr int kIC = 2 * kCC + 1;        // input cols per block
constexpr int kCStride = kCout + 1;     // padded conv-tile row: no bank conflicts
constexpr int kGroup = 16;              // output channels per work item
constexpr int kThreads = 256;

constexpr int kSmemFloats = kTaps * kCout + kCout + kIR * kIC * kCin +
                            kCR * kCC * kCStride;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__global__ void __launch_bounds__(kThreads, 2)
conv1_pool1_f32(const float* __restrict__ x, const float* __restrict__ k,
                const float* __restrict__ bias, float* __restrict__ out,
                Geometry g) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [27][64], float4-aligned
  float* s_b = s_w + kTaps * kCout;              // [64]
  float* s_x = s_b + kCout;                      // [kIR][kIC][3]
  float* s_c = s_x + kIR * kIC * kCin;           // [kCR * kCC][kCStride]

  const int b = blockIdx.z;
  const int p0 = blockIdx.y * kTP;
  const int q0 = blockIdx.x * kTQ;
  const int cr0 = 2 * p0 - g.ppad_t;  // first conv row of the tile
  const int cc0 = 2 * q0 - g.ppad_l;
  const int ir0 = 2 * cr0 - g.pad_t;  // first input row of the tile
  const int ic0 = 2 * cc0 - g.pad_l;

  for (int i = threadIdx.x; i < kTaps * kCout; i += kThreads) s_w[i] = k[i];
  if (threadIdx.x < kCout) s_b[threadIdx.x] = bias[threadIdx.x];

  // 1. input halo tile; a row's 3 * kIC values are contiguous in x
  const float* xb = x + (size_t)b * g.H * g.W * kCin;
  for (int i = threadIdx.x; i < kIR * kIC * kCin; i += kThreads) {
    const int r = i / (kIC * kCin);
    const int rem = i - r * (kIC * kCin);
    const int yy = ir0 + r;
    const int xx = ic0 + rem / kCin;
    float v = 0.f;
    if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
      v = xb[((size_t)yy * g.W + xx) * kCin + rem % kCin];
    s_x[i] = v;
  }
  __syncthreads();

  // 2. conv tile: work item = (channel group, conv position); consecutive
  // threads take consecutive positions, so a warp reads one weight float4
  // at a time as a broadcast
  for (int item = threadIdx.x; item < kCR * kCC * (kCout / kGroup);
       item += kThreads) {
    const int grp = item / (kCR * kCC);
    const int pos = item - grp * (kCR * kCC);
    const int r = pos / kCC;
    const int c = pos - r * kCC;
    float* dst = s_c + pos * kCStride + grp * kGroup;
    const int cy = cr0 + r;
    const int cx = cc0 + c;
    if (cy < 0 || cy >= g.Hc || cx < 0 || cx >= g.Wc) {
#pragma unroll
      for (int o = 0; o < kGroup; ++o) dst[o] = -INFINITY;
      continue;
    }
    float acc[kGroup];
#pragma unroll
    for (int o = 0; o < kGroup; ++o) acc[o] = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const float* xin = s_x + ((2 * r + di) * kIC + 2 * c + dj) * kCin;
#pragma unroll
        for (int ci = 0; ci < kCin; ++ci) {
          const float xv = xin[ci];
          const float4* wv = reinterpret_cast<const float4*>(
              s_w + ((di * 3 + dj) * kCin + ci) * kCout + grp * kGroup);
#pragma unroll
          for (int v = 0; v < kGroup / 4; ++v) {
            const float4 w = wv[v];
            acc[4 * v + 0] = fmaf(xv, w.x, acc[4 * v + 0]);
            acc[4 * v + 1] = fmaf(xv, w.y, acc[4 * v + 1]);
            acc[4 * v + 2] = fmaf(xv, w.z, acc[4 * v + 2]);
            acc[4 * v + 3] = fmaf(xv, w.w, acc[4 * v + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kGroup; ++o)
      dst[o] = fmaxf(acc[o] + s_b[grp * kGroup + o], 0.f);
  }
  __syncthreads();

  // 3. pool out of the tile; channel-fastest threads give coalesced stores
  float* ob = out + (size_t)b * g.Hp * g.Wp * kCout;
  for (int i = threadIdx.x; i < kTP * kTQ * kCout; i += kThreads) {
    const int o = i % kCout;
    const int pq = i / kCout;
    const int pr = pq / kTQ;
    const int pc = pq - pr * kTQ;
    const int p = p0 + pr;
    const int q = q0 + pc;
    if (p >= g.Hp || q >= g.Wp) continue;
    float m = -INFINITY;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int bb = 0; bb < 3; ++bb)
        m = fmaxf(m, s_c[((2 * pr + a) * kCC + 2 * pc + bb) * kCStride + o]);
    ob[((size_t)p * g.Wp + q) * kCout + o] = m;
  }
}

// ---- bf16 route (tensor cores) -------------------------------------------

constexpr int kTcTP = 8;                    // pool rows per block
constexpr int kTcTQ = 16;                   // pool cols per block
constexpr int kTcCR = 2 * kTcTP + 1;        // 17 conv rows per block
constexpr int kTcCC = 2 * kTcTQ + 1;        // 33 conv cols per block
constexpr int kTcIR = 2 * kTcCR + 1;        // 35 input rows per block
constexpr int kTcIC = 2 * kTcCC + 1;        // 67 input cols per block
constexpr int kTcPos = kTcCR * kTcCC;       // 561 conv positions
constexpr int kTcM16 = (kTcPos + 15) / 16;  // 36 m16 tiles
constexpr int kRowElems = kTcIC * kCin;     // 201 bf16 in a halo row
constexpr int kHaloPitch = kRowElems + 1;   // even: 4-byte aligned pairs
constexpr int kHaloElems = kTcIR * kHaloPitch;  // 7070
constexpr int kZero = kHaloElems;           // two zeros: the pad taps
constexpr int kHaloAlloc = (kHaloElems + 2 + 7) / 8 * 8;
// The GEMM's K index: kernel row di (3) x 10, of which 9 are its taps
// (dj, ci) and 1 is padding, then 2 padding: 32.  A pair (k, k+1), k even,
// never spans two kernel rows, so it is one 4-byte load from the halo.
constexpr int kKRow = 10;
constexpr int kWords = (kRowElems + 7) / 8 + 1;  // 16-byte words over a row
constexpr int kCPitch = kCout + 8;          // bf16; 144-byte rows: the
                                            // epilogue's stores hit 8 banks
constexpr int kTcThreads = 256;
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kLoads = (kTcIR * kWords + kTcThreads - 1) / kTcThreads;  // 4
constexpr int kPoolRun = 4;  // neighbouring pool outputs a thread takes
constexpr size_t kTcSmemBytes =
    sizeof(__nv_bfloat16) * (kTcPos * kCPitch + kHaloAlloc) +
    sizeof(float) * kCout;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 (lo at the smaller k) in one register
__device__ __forceinline__ uint32_t pack(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// elementwise max of two bf16 pairs held in registers
__device__ __forceinline__ uint32_t hmax2_bits(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
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

// Slot j of a thread covers the 16-byte word (i - r * kWords) of halo row r,
// i = tid + j * kTcThreads, counted from the word holding the row's first
// in-image element; -1 if that word holds none of the row's elements.
__device__ __forceinline__ int64_t halo_word(const Tile& tl, const Geometry& g,
                                             int tid, int j) {
  const int xlo = max(tl.ic0, 0), xhi = min(tl.ic0 + kTcIC, g.W);
  const int i = tid + j * kTcThreads;
  const int r = i / kWords;
  const int yy = tl.ir0 + r;
  if (i >= kTcIR * kWords || yy < 0 || yy >= g.H || xlo >= xhi) return -1;
  const int64_t row = ((int64_t)tl.b * g.H + yy) * g.W * kCin;
  const int64_t word = (row + (int64_t)xlo * kCin) / 8 + (i - r * kWords);
  return word * 8 < row + (int64_t)xhi * kCin ? word : -1;
}

// Issue this thread's (up to kLoads) 16-byte loads of a tile's halo rows.
__device__ __forceinline__ void load_halo(const uint16_t* xs, const Tile& tl,
                                          const Geometry& g, int64_t total,
                                          int tid, uint4* raw) {
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int64_t word = halo_word(tl, g, tid, j);
    if (word < 0) continue;
    if (word * 8 + 8 <= total) {
      raw[j] = __ldg(reinterpret_cast<const uint4*>(xs) + word);
    } else {  // the tensor's last, partial word
      uint16_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = word * 8 + e < total ? xs[word * 8 + e] : (uint16_t)0;
      raw[j] = make_uint4(pack(v[0], v[1]), pack(v[2], v[3]),
                          pack(v[4], v[5]), pack(v[6], v[7]));
    }
  }
}

// Move the loaded words' in-image elements to their place in the halo
// tile, and write zeros where the tile lies outside the image (the two
// sets are disjoint, so no barrier separates them).
__device__ __forceinline__ void fill_halo(uint16_t* s_x, const Tile& tl,
                                          const Geometry& g, int tid,
                                          const uint4* raw) {
  // a row's in-image elements are its tile elements [lo, hi)
  const int lo = (max(tl.ic0, 0) - tl.ic0) * kCin;
  const int hi = (min(tl.ic0 + kTcIC, g.W) - tl.ic0) * kCin;
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int64_t word = halo_word(tl, g, tid, j);
    if (word < 0) continue;
    const int r = (tid + j * kTcThreads) / kWords;
    const int64_t e0 =  // image element of tile element 0 of row r
        (((int64_t)tl.b * g.H + tl.ir0 + r) * g.W + tl.ic0) * kCin;
    const int t0 = (int)(word * 8 - e0);  // tile element of the word's first
    const uint32_t w4[4] = {raw[j].x, raw[j].y, raw[j].z, raw[j].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int t = t0 + e;
      if (t >= lo && t < hi)
        s_x[r * kHaloPitch + t] =
            (uint16_t)(e & 1 ? w4[e / 2] >> 16 : w4[e / 2] & 0xffffu);
    }
  }
  const bool edge = tl.ir0 < 0 || tl.ir0 + kTcIR > g.H || tl.ic0 < 0 ||
                    tl.ic0 + kTcIC > g.W;
  if (!edge) return;  // block-uniform: only edge tiles hold padding
  for (int i = tid; i < kTcIR * kRowElems; i += kTcThreads) {
    const int r = i / kRowElems;
    const int t = i - r * kRowElems;
    const int xx = tl.ic0 + t / kCin;
    const int yy = tl.ir0 + r;
    if (yy < 0 || yy >= g.H || xx < 0 || xx >= g.W)
      s_x[r * kHaloPitch + t] = 0;
  }
}

// Persistent: block i takes tiles i, i + gridDim.x, ...; while it computes
// and pools one tile, its loads of the next tile's halo are in flight.
__global__ void __launch_bounds__(kTcThreads, 2)
conv1_pool1_tc(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ k, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, Geometry g, int tiles_q,
               int tiles_p, int64_t n_tiles, int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [561][kCPitch] bf16 conv tile, then the halo tile, then the bias
  __nv_bfloat16* s_c = reinterpret_cast<__nv_bfloat16*>(smem);
  uint16_t* s_x = reinterpret_cast<uint16_t*>(s_c + kTcPos * kCPitch);
  float* s_b = reinterpret_cast<float*>(s_x + kHaloAlloc);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, q = lane & 3;  // mma fragment row and column
  const int64_t total = (int64_t)batch * g.H * g.W * kCin;  // elements
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);

  int64_t t = blockIdx.x;
  uint4 raw[kLoads];  // the next tile's halo words, in flight
  if (t < n_tiles) load_halo(xs, tile_at(t, tiles_q, tiles_p, g), g, total,
                             tid, raw);
  if (tid < kCout) s_b[tid] = bias[tid];
  if (tid == 0) reinterpret_cast<uint32_t*>(s_x)[kZero / 2] = 0u;

  // B fragments of the 32 x 64 weight matrix (k = kKRow*di + 3*dj + ci),
  // for k16 step s and n8 tile j: (k 16s+2q, +1 | 16s+2q+8, +9; n 8j+gq)
  auto weight = [&](int kk, int n) -> uint16_t {
    const int di = kk / kKRow, t = kk % kKRow;  // t = 3*dj + ci, 9 = pad
    return di < 3 && t < 9 ? bf16_bits(k[(9 * di + t) * kCout + n]) : 0;
  };
  uint32_t bw[2][8][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = 16 * s + 2 * q + 8 * h;
        bw[s][j][h] = pack(weight(k0, 8 * j + gq), weight(k0 + 1, 8 * j + gq));
      }
  // this thread's A pairs k = 16s + 2q + 8h, +1: their halo offset from a
  // position's top-left pixel (-1: both padding) and the mask that zeroes
  // a padding half
  int koff[2][2];
  uint32_t kmask[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = 16 * s + 2 * q + 8 * h;
      const int di = kk / kKRow, t = kk % kKRow;
      koff[s][h] = di < 3 ? di * kHaloPitch + t : -1;
      kmask[s][h] = t + 1 < 9 ? 0xffffffffu : 0x0000ffffu;
    }

  for (; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, tiles_q, tiles_p, g);
    // 1. halo tile (the previous tile's conv has read it: barrier below)
    fill_halo(s_x, tl, g, tid, raw);
    __syncthreads();
    if (t + gridDim.x < n_tiles)
      load_halo(xs, tile_at(t + gridDim.x, tiles_q, tiles_p, g), g, total,
                tid, raw);

    // 2 + 3. conv GEMM over the tile's m16 tiles, then bias, ReLU, bf16
    // (the previous tile's pool has read s_c: the barrier above)
    const uint32_t* s_x32 = reinterpret_cast<const uint32_t*>(s_x);
    for (int mt = warp; mt < kTcM16; mt += kTcWarps) {
      int base[2];  // halo offset of the row's pixel (top-left tap), even
      bool live[2], inside[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * mt + gq + 8 * h;
        live[h] = m < kTcPos;
        const int mm = live[h] ? m : 0;
        const int r = mm / kTcCC, c = mm - r * kTcCC;
        base[h] = 2 * r * kHaloPitch + 2 * c * kCin;
        const int cy = tl.cr0 + r, cx = tl.cc0 + c;
        inside[h] = cy >= 0 && cy < g.Hc && cx >= 0 && cx < g.Wc;
      }
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // a0a1 (row g, k 2q..), a2a3 (row g+8), a4a5 (row g, k 2q+8..), a6a7
        uint32_t a[4];
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[2 * kh + h] =
                s_x32[(koff[s][kh] < 0 ? kZero : base[h] + koff[s][kh]) / 2] &
                kmask[s][kh];
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[j], a, bw[s][j]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live[h]) continue;
        __nv_bfloat16* dst = s_c + (16 * mt + gq + 8 * h) * kCPitch;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = 8 * j + 2 * q;
          float v0 = -INFINITY, v1 = -INFINITY;
          if (inside[h]) {
            v0 = fmaxf(acc[j][2 * h] + s_b[n], 0.f);
            v1 = fmaxf(acc[j][2 * h + 1] + s_b[n + 1], 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(dst + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();

    // 4. pool, separably: a thread takes 8 channels of 4 neighbouring
    // outputs of one pool row, maxes 3 conv rows in each of the 9 conv
    // columns they span, then 3 of those column maxima per output; one
    // 16-byte store per output
    static_assert(kTcTP * (kTcTQ / kPoolRun) * (kCout / 8) == kTcThreads,
                  "one pool work item per thread");
    {
      const int grp = tid & 7;
      const int pc0 = kPoolRun * ((tid >> 3) % (kTcTQ / kPoolRun));
      const int pr = tid / (8 * (kTcTQ / kPoolRun));
      const int p = tl.p0 + pr;
      const __nv_bfloat16* col = s_c + (2 * pr * kTcCC + 2 * pc0) * kCPitch +
                                 8 * grp;
      __nv_bfloat16* ob =
          out + (((size_t)tl.b * g.Hp + p) * g.Wp + tl.q0 + pc0) * kCout +
          8 * grp;
      uint4 prev;  // the column maximum shared with the previous output
#pragma unroll
      for (int cc = 0; cc < 2 * kPoolRun + 1; ++cc) {
        uint4 m = *reinterpret_cast<const uint4*>(col + cc * kCPitch);
#pragma unroll
        for (int a = 1; a < 3; ++a) {
          const uint4 u = *reinterpret_cast<const uint4*>(
              col + (a * kTcCC + cc) * kCPitch);
          m = make_uint4(hmax2_bits(m.x, u.x), hmax2_bits(m.y, u.y),
                         hmax2_bits(m.z, u.z), hmax2_bits(m.w, u.w));
        }
        if (cc % 2 == 1) {  // columns 2k, 2k+1 seen: keep their max
          prev = make_uint4(hmax2_bits(prev.x, m.x), hmax2_bits(prev.y, m.y),
                            hmax2_bits(prev.z, m.z), hmax2_bits(prev.w, m.w));
        } else {
          if (cc > 0) {  // output k = cc/2 - 1: columns cc-2 .. cc
            const uint4 o = make_uint4(
                hmax2_bits(prev.x, m.x), hmax2_bits(prev.y, m.y),
                hmax2_bits(prev.z, m.z), hmax2_bits(prev.w, m.w));
            if (p < g.Hp && tl.q0 + pc0 + cc / 2 - 1 < g.Wp)
              *reinterpret_cast<uint4*>(ob + (cc / 2 - 1) * kCout) = o;
          }
          prev = m;
        }
      }
    }
  }
}

int launch_f32(const float* x, const float* k, const float* bias, float* out,
               int B, const Geometry& g, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv1_pool1_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.Wp + kTQ - 1) / kTQ, (g.Hp + kTP - 1) / kTP, B);
  conv1_pool1_f32<<<grid, kThreads, kSmemBytes, stream>>>(x, k, bias, out, g);
  return (int)cudaGetLastError();
}

int launch_tc(const __nv_bfloat16* x, const float* k, const float* bias,
              __nv_bfloat16* out, int B, const Geometry& g,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv1_pool1_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTcSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, conv1_pool1_tc, kTcThreads, kTcSmemBytes)) != cudaSuccess)
    return (int)err;
  const int tiles_q = (g.Wp + kTcTQ - 1) / kTcTQ;
  const int tiles_p = (g.Hp + kTcTP - 1) / kTcTP;
  const int64_t n_tiles = (int64_t)tiles_q * tiles_p * B;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(n_tiles < resident ? n_tiles : resident);
  conv1_pool1_tc<<<blocks, kTcThreads, kTcSmemBytes, stream>>>(
      x, k, bias, out, g, tiles_q, tiles_p, n_tiles, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; x must be
// 16-byte aligned).  Returns the cudaError_t of the launch.
int sdt_conv1_pool1(const void* x, const void* k, const void* bias, void* out,
                    int B, int H, int W, int Hc, int Wc, int Hp, int Wp,
                    int pad_t, int pad_l, int ppad_t, int ppad_l, int dtype,
                    void* stream) {
  const Geometry g{H, W, Hc, Wc, Hp, Wp, pad_t, pad_l, ppad_t, ppad_l};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kf = static_cast<const float*>(k);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), kf, bf,
                      static_cast<float*>(out), B, g, s);
  if (dtype == 1 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_tc(static_cast<const __nv_bfloat16*>(x), kf, bf,
                     static_cast<__nv_bfloat16*>(out), B, g, s);
  return (int)cudaErrorInvalidValue;
}

const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
