// Filter gradient of a stride-1 SAME convolution, for Hopper (sm_90a) (K2).
//
// Replaces the TPU kernel squeezedet_tpu/ops/filter_grad.py:filter_grad:
//   dW[i, j, c, o] = sum_{b,y,x} X[b, y+i-ph, x+j-pw, c] * dY[b, y, x, o]
// with X [B,H,W,C] and dY [B,H,W,O] contiguous NHWC (both f32 or both bf16),
// odd kh and kw, ph = (kh-1)/2, pw = (kw-1)/2, X read as zero outside the
// image, and dW [kh,kw,C,O] in f32.  Every product of two bf16 values is
// exact in f32 and every sum is f32.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s, 989 TFLOP/s bf16 on tensor
// cores, 67 TFLOP/s f32 on CUDA cores).  A call reads X and dY once
// (2 * B*H*W * (C + O) bytes in bf16), writes dW (4 * kh*kw*C*O bytes) and
// does 2 * B*H*W * C * O * kh*kw operations.  squeezeDet's 1x1 squeezes are
// bound by bytes (4-14 us each at B=20); its 3x3 conv12 and the wide 3x3s of
// VGG16, squeezeDet+ and ResNet50 by the tensor cores (VGG16 conv4_2:
// 173 GFLOP, 0.175 ms).  dW is small, so parallelism has to come from
// splitting the contraction over positions, and its tiles' operands are
// read again for every tap and tile: the L2 has to serve them.
//
// bf16 route, one launch a call: filter_grad_wgmma<N> (N = the O tile);
// the short 1x1 calls ops/filter_grad.py's uses_mma names run
// filter_grad_tc_partial (below).
//   Positions are cut into boxes of hbox rows x wbox columns of one image
//   (wbox a multiple of 16).  Block (split, tile) owns a 128 (C) x N (O)
//   tile of one tap and a run of boxes; blocks are numbered split-major, so
//   the ones resident together read the same boxes and the L2 serves the
//   other taps and tiles.  One thread of a producer warpgroup keeps a ring
//   of stages full with TMA loads, guarded by mbarriers: per box, two
//   64-channel X boxes at (c0, x0 + j - pw, y0 + i - ph, b) and N/64
//   64-column dY boxes at (o0, x0, y0, b) of 4-D tensor maps over the
//   operands as they lie.  TMA fills every element outside the tensor with
//   zeros, so the SAME pad, the image edge and a box's overhang past W or H
//   cost no instruction.  Both boxes stage position-major (a 128-byte row a
//   position, 128-byte swizzle), so X^T is an M-major A and dY an N-major B
//   operand: two consumer warpgroups (64 C rows each, registers taken from
//   the producer by setmaxnreg) run wgmma.m64nNk16 bf16 -> f32 on them
//   (N = 64, 72 or 128; a wider tile as two products of 128 and N - 128)
//   straight from shared memory with the transpose bits set.
//   The splits are summed inside the launch: each block writes its f32
//   partial; an int arrival counter per group of splits picks the group's
//   last block, which sums the group's partials in split order, and the
//   tile's last group sums the groups' sums in group order into dW.  The
//   counters order only who sums, never the order of a sum.  The tensor
//   cores' f32 accumulation truncates, so on operands of one sign the
//   error would grow with a split's chain of k-steps: a stage's product is
//   taken from zero and added to the block's sums by f32 adds (mma.sync:
//   each k-step's product).
// f32 route (CUDA cores), filter_grad_f32_tma<N>: every product an f32
//   product and every sum an f32 sum (no TF32).  Bound by the FMA pipes
//   (conv12's 3x3 halves: 18.6 GFLOP each at B=20, 0.28 ms at 67 TFLOP/s)
//   or, on the narrow 1x1s, by bytes.  A fixed 64-wide O tile would pad
//   conv12's O = 72 to 128 (44 % of its FMAs on padding), 4 x 4
//   accumulators a thread take 2 shared loads for 16 FMAs, and staging
//   through registers stalls on the loads.  So: a 128 (C) x N (O) tile,
//   N the O tile that fits O (32, 48, 64, 72, 96, or an equal share of a
//   wider O, at most 128), so at most 2.6 % of any model shape's FMAs
//   fall on padding; 256 threads of 4 x 4 (N = 32) to 8 x 8 (N = 128)
//   accumulators (4 x 9 at N = 72) reading their C and O slices as
//   float4s without bank conflicts; a ring of 3 or more TMA stages (f32
//   boxes of X shifted by the tap and of dY, whose zero fill is the SAME
//   pad) that thread 0 refills after each stage's block sync; 2 blocks an
//   SM (8 warps each, 48-91 registers, 0 spill bytes).  Blocks are
//   split-major, as for bf16.  The splits' partials are summed by
//   filter_grad_reduce in split order: at the f32 shapes its second
//   launch costs a few us, under the ~20 us tail of an in-launch tree.
//   On an H100 80GB HBM3 (700 W) one B=20 backward's 12 calls take 1.64
//   ms replayed from a CUDA graph (conv12's halves 0.55 ms each, 50 % of
//   the f32 peak).  Calls whose operands no tensor map describes (C % 4
//   or O % 4 not 0, or not 16-byte aligned) run the scalar-load kernel,
//   filter_grad_partial_f32, by a fixed rule (ops/filter_grad.py).
// No float atomics: two launches on the same inputs give the same bits.

#include <cuda.h>  // CUtensorMap; the encoder is fetched through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStep = 32;     // f32 route: positions per step; every split's
                              // chunk of positions is a multiple of it

// ---- f32 route, scalar loads (CUDA cores) --------------------------------
constexpr int kTC = 64;       // C rows of a block's output tile
constexpr int kTO = 64;       // O columns of a block's output tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

struct Shape {
  int B, H, W, C, O, kh, kw;
  int64_t M;       // B * H * W positions
  int64_t chunk;   // positions per split (a multiple of kStep)
  int c_tiles;     // C tiles of the route
};

__global__ void __launch_bounds__(kThreads)
filter_grad_partial_f32(const float* __restrict__ x,
                        const float* __restrict__ dy, float* __restrict__ ws,
                        Shape s) {
  __shared__ __align__(16) float s_x[kStep][kTC];
  __shared__ __align__(16) float s_d[kStep][kTO];
  __shared__ int64_t s_xrow[kStep];  // X element offset of the row, or -1
  __shared__ int64_t s_drow[kStep];  // dY element offset of the row, or -1

  const int c0 = (blockIdx.x % s.c_tiles) * kTC;
  const int o0 = (blockIdx.x / s.c_tiles) * kTO;
  const int tap = blockIdx.y;
  const int di = tap / s.kw - (s.kh - 1) / 2;  // row shift of the tap
  const int dj = tap % s.kw - (s.kw - 1) / 2;  // column shift of the tap
  const int64_t p_begin = (int64_t)blockIdx.z * s.chunk;
  const int64_t p_end = p_begin + s.chunk < s.M ? p_begin + s.chunk : s.M;

  const int tid = threadIdx.x;
  const int tc = tid / 16;  // this thread's 4 C rows: 4*tc .. 4*tc+3
  const int to = tid % 16;  // this thread's 4 O columns: 4*to .. 4*to+3
  const int lane = tid % 64;  // column loaded by this thread
  const int row0 = tid / 64;  // first staged row loaded by this thread

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  const int hw = s.H * s.W;
  for (int64_t p0 = p_begin; p0 < p_end; p0 += kStep) {
    if (tid < kStep) {
      const int64_t p = p0 + tid;
      int64_t xoff = -1, doff = -1;
      if (p < p_end) {
        const int b = (int)(p / hw);
        const int r = (int)(p - (int64_t)b * hw);
        const int y = r / s.W;
        const int xx = r - y * s.W;
        doff = p * s.O;
        const int ys = y + di, xs = xx + dj;
        if (ys >= 0 && ys < s.H && xs >= 0 && xs < s.W)
          xoff = (((int64_t)b * s.H + ys) * s.W + xs) * s.C;
      }
      s_xrow[tid] = xoff;
      s_drow[tid] = doff;
    }
    __syncthreads();
#pragma unroll
    for (int k = row0; k < kStep; k += kThreads / 64) {
      const int64_t xoff = s_xrow[k];
      const int64_t doff = s_drow[k];
      const int c = c0 + lane;
      const int o = o0 + lane;
      s_x[k][lane] = (xoff >= 0 && c < s.C) ? x[xoff + c] : 0.f;
      s_d[k][lane] = (doff >= 0 && o < s.O) ? dy[doff + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kStep; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&s_x[k][4 * tc]);
      const float4 dv = *reinterpret_cast<const float4*>(&s_d[k][4 * to]);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float da[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa[a], da[b], acc[a][b]);
    }
    __syncthreads();
  }

  const int64_t taps = (int64_t)s.kh * s.kw;
  float* out = ws + (((int64_t)blockIdx.z * taps + tap) * s.C) * s.O;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = c0 + 4 * tc + a;
    if (c >= s.C) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int o = o0 + 4 * to + b;
      if (o < s.O) out[(int64_t)c * s.O + o] = acc[a][b];
    }
  }
}

constexpr int kReduceLanes = 32;   // outputs (float4s or floats) a block
constexpr int kReduceGroups = 8;   // warps, each summing every 8th split

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }

// out[i] = sum over splits of ws[s, i], n values (as n / VW vectors V).
// Warp g of a block sums splits g, g + 8, g + 16, ... in that order for
// its block's 32 outputs; then the 8 warps' sums are added in warp order.
// The order is fixed, so the result does not depend on scheduling.
template <typename V>
__global__ void __launch_bounds__(kReduceLanes * kReduceGroups)
filter_grad_reduce(const V* __restrict__ ws, V* __restrict__ out, int64_t n,
                   int splits) {
  __shared__ V part[kReduceGroups][kReduceLanes];
  const int lane = threadIdx.x % kReduceLanes;
  const int grp = threadIdx.x / kReduceLanes;
  const int64_t i = (int64_t)blockIdx.x * kReduceLanes + lane;
  V v = V();
  if (i < n) {
#pragma unroll 4
    for (int sp = grp; sp < splits; sp += kReduceGroups)
      v = add(v, ws[(int64_t)sp * n + i]);
  }
  part[grp][lane] = v;
  __syncthreads();
  if (grp == 0 && i < n) {
#pragma unroll
    for (int g = 1; g < kReduceGroups; ++g) v = add(v, part[g][lane]);
    out[i] = v;
  }
}

int launch_reduce(const float* ws, float* out, const Shape& s, int splits,
                  cudaStream_t stream) {
  const int64_t n = (int64_t)s.kh * s.kw * s.C * s.O;
  const int threads = kReduceLanes * kReduceGroups;
  if (n % 4 == 0) {  // always on the bf16 route; the f32 route takes any O
    const int64_t blocks = (n / 4 + kReduceLanes - 1) / kReduceLanes;
    filter_grad_reduce<float4><<<(unsigned)blocks, threads, 0, stream>>>(
        reinterpret_cast<const float4*>(ws), reinterpret_cast<float4*>(out),
        n / 4, splits);
  } else {
    const int64_t blocks = (n + kReduceLanes - 1) / kReduceLanes;
    filter_grad_reduce<float><<<(unsigned)blocks, threads, 0, stream>>>(
        ws, out, n, splits);
  }
  return (int)cudaGetLastError();
}

// ---- bf16 route for the small 1x1 calls (mma.sync) ------------------------
// Block = (C tile of 128, O tile of up to 128, tap, split), 8 warps of
// mma.sync.m16n8k16 fed by ldmatrix.trans from a 3-stage cp.async ring of
// 64 positions; the partials are summed by filter_grad_reduce.  On the
// short 1x1 calls with at most 2 x 2 of its tiles its second pass costs
// less than the in-launch tree of filter_grad_wgmma (ops/filter_grad.py's
// uses_mma holds the rule).
constexpr int kMmaC = 128;     // C rows of a block's output tile
constexpr int kMmaO = 128;     // at most this many O columns per block
constexpr int kMmaStep = 64;   // positions per stage
constexpr int kMmaStages = 3;  // cp.async ring depth
constexpr int kMmaChunks = 16; // 16-byte chunks in a 256-byte staged row
constexpr int kMmaThreads = 256;
constexpr int kMmaStageBytes = kMmaStep * kMmaChunks * 16;  // 16 KB an operand
constexpr int kMmaSmemBytes = 2 * kMmaStages * kMmaStageBytes;  // 96 KB


__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col): the k-step's product is
// taken from zero on the tensor cores and added to the f32 accumulators d
// by f32 adds, which round to nearest.  The tensor cores' own accumulation
// truncates, so a chain of k-steps into d would drift on operands of one
// sign (on an H100, 1.2e-5 of the largest sum at 228 k-steps a split).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  float p[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
#pragma unroll
  for (int v = 0; v < 4; ++v) d[v] += p[v];
}

// byte offset of 16-byte chunk `chunk` of staged row `row` (XOR swizzle)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)((row * kMmaChunks + (chunk ^ (row & 7))) * 16);
}

// (b, y, x) of a flat position, stepped kMmaStep positions per stage
struct Pos {
  int b, y, x;
  __device__ void init(int64_t p, int H, int W) {
    const int64_t hw = (int64_t)H * W;
    b = (int)(p / hw);
    const int r = (int)(p - (int64_t)b * hw);
    y = r / W;
    x = r - y * W;
  }
  __device__ void advance(int n, int H, int W) {
    x += n;
    while (x >= W) {
      x -= W;
      if (++y == H) {
        y = 0;
        ++b;
      }
    }
  }
};

// NTW: n8 tiles of O per warp (each warp owns 32 C rows x 8*NTW O columns)
template <int NTW>
__global__ void __launch_bounds__(kMmaThreads, 2)
filter_grad_tc_partial(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ dy,
                       float* __restrict__ ws, Shape s) {
  constexpr int NP = (NTW + 1) / 2;  // ldmatrix.x4 loads of dY
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_x = smem;                           // [stage][64][256 B]
  unsigned char* s_d = smem + kMmaStages * kMmaStageBytes;  // [stage][64][256]

  const int c0 = (blockIdx.x % s.c_tiles) * kMmaC;
  const int o0 = (blockIdx.x / s.c_tiles) * kMmaO;
  const int nt8 = min(kMmaO, s.O - o0) / 8;  // O is a multiple of 8
  const int tap = blockIdx.y;
  const int di = tap / s.kw - (s.kh - 1) / 2;
  const int dj = tap % s.kw - (s.kw - 1) / 2;
  const int64_t p_begin = (int64_t)blockIdx.z * s.chunk;
  const int64_t p_end = p_begin + s.chunk < s.M ? p_begin + s.chunk : s.M;
  const int n_stages = (int)((p_end - p_begin + kMmaStep - 1) / kMmaStep);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp & 3;   // C rows 32*wm .. 32*wm+31 of the tile
  const int wn = warp >> 2;  // O tiles NTW*wn .. NTW*wn+NTW-1

  // loader: this thread copies chunks 4*lq .. 4*lq+3 of staged row lr, so
  // it finds one row's (b, y, x) per stage
  static_assert(kMmaStep * 4 == kMmaThreads, "one staged row per 4 threads");
  const int lr = tid >> 2;
  const int lq = tid & 3;
  Pos pos;
  pos.init(p_begin + lr, s.H, s.W);

  auto load_stage = [&](int slot, int stage) {
    const uint32_t xs = smem_addr(s_x + slot * kMmaStageBytes);
    const uint32_t ds = smem_addr(s_d + slot * kMmaStageBytes);
    const int64_t p = p_begin + (int64_t)stage * kMmaStep + lr;
    const bool live = p < p_end;
    const int ys = pos.y + di, xs_ = pos.x + dj;
    const bool in = live && ys >= 0 && ys < s.H && xs_ >= 0 && xs_ < s.W;
    const __nv_bfloat16* xrow =
        x + (((int64_t)pos.b * s.H + ys) * s.W + xs_) * s.C + c0;
    const __nv_bfloat16* drow = dy + p * s.O + o0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int chunk = 4 * lq + j;
      const bool xc = in && c0 + 8 * chunk < s.C;
      cp_async16(xs + swz(lr, chunk), xc ? xrow + 8 * chunk : x,
                 xc ? 16 : 0);
      if (chunk < nt8)
        cp_async16(ds + swz(lr, chunk), live ? drow + 8 * chunk : dy,
                   live ? 16 : 0);
    }
    pos.advance(kMmaStep, s.H, s.W);
  };

  float acc[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_stages) load_stage(st, st);
    cp_async_commit();
  }

  // ldmatrix row addresses: lane -> (matrix lane/8, row lane%8)
  const int mat = lane >> 3, mrow = lane & 7;
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int next = st + kMmaStages - 1;
    if (next < n_stages) load_stage(next % kMmaStages, next);
    cp_async_commit();

    const uint32_t xs = smem_addr(s_x + (st % kMmaStages) * kMmaStageBytes);
    const uint32_t ds = smem_addr(s_d + (st % kMmaStages) * kMmaStageBytes);
#pragma unroll
    for (int k0 = 0; k0 < kMmaStep; k0 += 16) {
      // Every fragment of the step is loaded before the first mma, so the
      // loads' latencies overlap.  B = dY: matrices (k 0-7, n t), (k 8-15,
      // n t), (k 0-7, n t+1), (k 8-15, n t+1), stored [k][n]
      uint32_t b[NP][4];
#pragma unroll
      for (int jp = 0; jp < NP; ++jp) {
        const int t0 = NTW * wn + 2 * jp;
        if (t0 < nt8)
          ldmatrix_x4_trans(
              ds + swz(k0 + mrow + ((mat & 1) << 3), t0 + (mat >> 1)), b[jp]);
      }
      // A = X^T: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
      // (m 8-15, k 8-15) of each 16 x 16 tile, stored [k][m]
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mcol = 32 * wm + 16 * i + ((mat & 1) << 3);
        ldmatrix_x4_trans(xs + swz(k0 + mrow + ((mat >> 1) << 3), mcol >> 3),
                          a[i]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jp = 0; jp < NP; ++jp) {
          const int t0 = NTW * wn + 2 * jp;
          if (t0 >= nt8) break;
          mma_bf16(acc[i][2 * jp], a[i], b[jp]);
          if (2 * jp + 1 < NTW && t0 + 1 < nt8)
            mma_bf16(acc[i][2 * jp + 1], a[i], b[jp] + 2);
        }
    }
  }
  cp_async_wait<0>();

  // accumulator (i, j): rows c0 + 32*wm + 16*i + g (+8), columns
  // o0 + 8*(NTW*wn + j) + 2*q (+1)
  const int g = lane >> 2, q = lane & 3;
  const int64_t taps = (int64_t)s.kh * s.kw;
  float* out = ws + (((int64_t)blockIdx.z * taps + tap) * s.C) * s.O;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 32 * wm + 16 * i + g + 8 * h;
      if (c >= s.C) continue;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int t = NTW * wn + j;
        if (t >= nt8) break;
        const int o = o0 + 8 * t + 2 * q;
        *reinterpret_cast<float2*>(out + (int64_t)c * s.O + o) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <int NTW>
cudaError_t launch_mma(const Shape& s, dim3 grid, const void* x,
                      const void* dy, float* dst, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      filter_grad_tc_partial<NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMmaSmemBytes);
  if (err != cudaSuccess) return err;
  filter_grad_tc_partial<NTW><<<grid, kMmaThreads, kMmaSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), dst, s);
  return cudaGetLastError();
}

// ---- bf16 route (TMA + wgmma) --------------------------------------------
constexpr int kBoxC = 64;        // channels of a box: 128 bytes, the swizzle
constexpr int kRow = 128;        // bytes of one position's row in a box
constexpr int kTileC = 128;      // C rows of a tile: a box per consumer
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kTcThreads = kConsumers + 128;  // and the producer group
constexpr int kProducerRegs = 40;   // registers a thread after setmaxnreg:
constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;  // dynamic + static shared bytes a block
constexpr int kAlign = 1024;     // the 128-byte swizzle repeats every 1 KB

constexpr int kCounters = 16;   // arrival counters a tile: <= 15 groups
                                // of splits, then the tile's own

// The call's geometry.  Block (split s, tile t) is blockIdx s * tiles + t.
struct Geo {
  int B, H, W, C, O, kh, kw;
  int hbox, wbox, ny, nx;        // a box: hbox x wbox positions of an image
  int boxes;                     // B * ny * nx, numbered (b, row, column)
  int c_tiles, o_tiles, tiles;   // tiles = c_tiles * o_tiles * kh * kw
  int splits, chunk;             // boxes [s * chunk, (s+1) * chunk) a split
  int group;                     // splits summed per group
  int stages;                    // ring depth
};


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

// spin until the phase of parity `parity` of the barrier has completed; a
// wait past kWaitNs traps (a launch error) rather than hang the card
constexpr uint64_t kWaitNs = 10000000000ull;
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

// one 4-D box of `map` at element coordinates (c0..c3) into shared `dst`;
// elements outside the tensor, negative coordinates included, read as 0
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// a wgmma descriptor's start address field: bits 4-17 of the shared offset
__device__ __forceinline__ uint64_t desc_addr(uint32_t smem) {
  return (smem >> 4) & 0x3FFF;
}

// d (64 x N f32, the warpgroup's fragment) = A (64 x 16) * B (16 x N) + d,
// or + 0 when scale_d is 0; A and B bf16 in shared memory as described by
// the descriptors, both MN-major (transpose bits 1, 1)
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<72> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35},"
      " %36, %37, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(float* d, uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The last of `expected` blocks to arrive at `counter`?  Called by every
// consumer thread after its stores; the stores are visible to the last.
__device__ __forceinline__ bool arrive_last(int* counter, int expected,
                                            int* flag) {
  __threadfence();
  consumers_sync();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == expected - 1;
  consumers_sync();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// What a block of the bf16 kernel works on, and where its ring lies.
struct Work {
  int t, split, c0, o0, tap;  // its tile (C and O offsets, tap) and split
  int box0, n_iter;           // its boxes: box0 .. box0 + n_iter - 1
  uint32_t ring, box_bytes, stage_bytes;
};

// The producer: one thread keeps the ring full.  A stage is two
// 64-channel X boxes, shifted by the tap, and NB 64-column dY boxes.
template <int NB>
__device__ __forceinline__ void produce(const CUtensorMap* xmap,
                                        const CUtensorMap* dmap,
                                        uint64_t* full, uint64_t* empty,
                                        const Geo& g, const Work& w) {
  const int dj = w.tap % g.kw - (g.kw - 1) / 2;
  const int di = w.tap / g.kw - (g.kh - 1) / 2;
  for (int it = 0; it < w.n_iter; ++it) {
    const int slot = it % g.stages;
    mbar_wait(smem_addr(&empty[slot]), ((it / g.stages) & 1) ^ 1);
    const int box = w.box0 + it;
    const int x0 = box % g.nx * g.wbox;
    const int y0 = box / g.nx % g.ny * g.hbox;
    const int b = box / (g.nx * g.ny);
    const uint32_t bar = smem_addr(&full[slot]);
    const uint32_t dst = w.ring + slot * w.stage_bytes;
    mbar_expect_tx(bar, w.stage_bytes);
    tma_load(dst, xmap, bar, w.c0, x0 + dj, y0 + di, b);
    tma_load(dst + w.box_bytes, xmap, bar, w.c0 + kBoxC, x0 + dj, y0 + di,
             b);
#pragma unroll
    for (int q = 0; q < NB; ++q)
      tma_load(dst + (2 + q) * w.box_bytes, dmap, bar, w.o0 + q * kBoxC, x0,
               y0, b);
  }
}

// A consumer thread's share of the 128 x N tile: acc[4j + 2h + e] is
// (row + 8h, col + 8j + e), rows of C and columns of O from the tile's
// corner.
template <int N>
struct Frag {
  float acc[N / 2];
  int row, col;
  int rows, cols;  // the tile's rows and columns inside C and O

  __device__ __forceinline__ bool valid(int j, int h) const {
    return row + 8 * h < rows && col + 8 * j < cols;
  }
  // into a row-major block of leading dimension ld at dst
  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (valid(j, h))
          *reinterpret_cast<float2*>(dst + (row + 8 * h) * ld + col + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
};

// dst = slot[first] + slot[first + step] + .. (below end), each element
// summed in that order, by the 256 consumer threads with 16-byte loads,
// kBatch of a thread's float4s at a time; slot k is the dense 128 x N
// block at slots + k * stride.  Only rows < rows and columns < cols of the
// 128 x N result are written, at leading dimension ld.
constexpr int kBatch = 8;
template <int N>
__device__ __forceinline__ void sum_slots(const float* slots, int64_t stride,
                                          int first, int end, int step,
                                          float* dst, int ld, int rows,
                                          int cols) {
  constexpr int Q = N / 4;                      // float4s a row
  constexpr int PER = kTileC * Q / kConsumers;  // float4s a thread
  for (int i0 = 0; i0 < PER; i0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = first; k < end; k += step) {
      const float4* src = reinterpret_cast<const float4*>(slots + k * stride);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u < PER) {
          const float4 p = __ldcg(src + threadIdx.x + kConsumers * (i0 + u));
          v[u].x += p.x;
          v[u].y += p.y;
          v[u].z += p.z;
          v[u].w += p.w;
        }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = threadIdx.x + kConsumers * (i0 + u);
      const int r = e / Q, c = e % Q * 4;
      if (i0 + u < PER && r < rows && c < cols)
        *reinterpret_cast<float4*>(dst + (int64_t)r * ld + c) = v[u];
    }
  }
}

// The registers of an accumulator fragment, touched after a wgmma wait so
// that no read of them is scheduled before it.
template <int R>
__device__ __forceinline__ void fence_fragment(float* t) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(t[i])::"memory");
}

// One stage's product for NC columns of the tile: t = A * B over the
// stage's P positions (k-steps from zero), then sum += t by f32 adds.  The
// tensor cores' f32 accumulation truncates, so on operands of one sign a
// split's whole chain of k-steps in one fragment drifts (on an H100,
// 8.8e-5 of the largest sum at 1104 k-steps); a stage's chain is P / 16
// k-steps, and the adds across stages round to nearest.
template <int NC>
__device__ __forceinline__ void stage_product(float* t, float* sum,
                                              uint32_t a, uint32_t b, int P,
                                              uint64_t desc_hi) {
  wgmma_fence();
  for (int k = 0; k < P / 16; ++k)
    Wgmma<NC>::run(t, desc_hi | desc_addr(a + k * 2048),
                   desc_hi | desc_addr(b + k * 2048), k > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_fragment<NC / 2>(t);
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) sum[i] += t[i];
}

// The consumers: warpgroup wg multiplies its 64-channel X box (A, M-major)
// by the stage's dY boxes (B, N-major) into its 64 x N sum, 128 columns at
// a time: a product takes NC / 2 registers besides the sum's N / 2, 192 in
// all at N = 256, where a 256-wide product would need 256.  At the 3x3s of
// N = 256 two products a stage take 1.3-1.5x the time of one 256-wide
// chain a stage without the adds (on an H100, PERF.md section 6); products
// spanning two stages, and 64-wide products two in flight, were slower
// still.  Descriptors: 128-byte swizzle (layout 1 at bit 62); SBO = 1 KB
// between groups of 8 positions; LBO = one box between 64-wide groups
// along M or N; the start address advances 16 positions (2 KB) per k-step.
// Then the epilogue.
template <int N>
__device__ __forceinline__ void consume(float* out, float* part, int* count,
                                        int* flag, uint64_t* full,
                                        uint64_t* empty, const Geo& g,
                                        const Work& w) {
  constexpr int NC = N > 128 ? 128 : N;  // columns of the first product
  const int wg = threadIdx.x / 128;
  const int P = g.hbox * g.wbox;
  const uint64_t desc_hi = ((uint64_t)(w.box_bytes >> 4) << 16) |
                           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
  Frag<N> f;
  float t[NC / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) f.acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) t[i] = 0.f;
  for (int it = 0; it < w.n_iter; ++it) {
    const int slot = it % g.stages;
    mbar_wait(smem_addr(&full[slot]), (it / g.stages) & 1);
    const uint32_t st = w.ring + slot * w.stage_bytes;
    const uint32_t a = st + wg * w.box_bytes, b = st + 2 * w.box_bytes;
    stage_product<NC>(t, f.acc, a, b, P, desc_hi);
    // columns 128 on: two 64-column dY boxes on, fragment index 64 on
    if constexpr (N > 128)
      stage_product<N - 128>(t, f.acc + 64, a, b + 2 * w.box_bytes, P,
                             desc_hi);
    // free the stage as soon as its wgmmas are done, not once the next
    // stage has arrived too: the producer keeps one stage more in flight,
    // which the 3-stage rings of the wide tiles need to hide the loads
    if (threadIdx.x % 128 == 0) mbar_arrive(smem_addr(&empty[slot]));
  }

  const int lane = threadIdx.x % 32;
  f.row = 64 * wg + 16 * (threadIdx.x / 32 % 4) + lane / 4;
  f.col = 2 * (lane % 4);
  f.rows = g.C - w.c0;
  f.cols = g.O - w.o0;
  float* dw = out + ((int64_t)w.tap * g.C + w.c0) * g.O + w.o0;
  if (g.splits == 1) {
    f.store(dw, g.O);
    return;
  }
  // slot of split k: k * tiles + t
  const int64_t stride = (int64_t)g.tiles * kTileC * N;
  float* slots = part + (int64_t)w.t * kTileC * N;
  f.store(slots + w.split * stride, N);
  const int groups = (g.splits + g.group - 1) / g.group;
  const int lo = w.split / g.group * g.group;
  const int hi = min(lo + g.group, g.splits);
  if (!arrive_last(&count[w.t * kCounters + lo / g.group], hi - lo, flag))
    return;
  if (groups == 1) {
    sum_slots<N>(slots, stride, lo, hi, 1, dw, g.O, f.rows, f.cols);
    return;
  }
  sum_slots<N>(slots, stride, lo, hi, 1, slots + lo * stride, N, kTileC, N);
  if (!arrive_last(&count[w.t * kCounters + kCounters - 1], groups, flag))
    return;
  sum_slots<N>(slots, stride, 0, g.splits, g.group, dw, g.O, f.rows, f.cols);
}

// Block (split s, tile t), s-major, so that the blocks resident together
// walk the same boxes (L2 hits across taps and tiles).  Threads 0-255 are
// the consumer warpgroups (warpgroup w owns C rows c0 + 64w .. of the
// tile), 256-383 the producer warpgroup, whose registers setmaxnreg hands
// to the consumers' accumulators.  With one split the 128 x N sum over
// the tile's boxes goes straight to dW.  Otherwise it goes to partial slot
// s * tiles + t (dense 128 x N), and the splits are summed in a fixed
// tree: groups of `group` consecutive splits, summed in split order by
// the group's last block to arrive (into the group's first slot), then
// the groups' sums in group order by the tile's last group to arrive.
template <int N>
__global__ void __launch_bounds__(kTcThreads, 1)
filter_grad_wgmma(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap dmap,
                  float* __restrict__ out, float* __restrict__ part,
                  int* __restrict__ count, Geo g) {
  constexpr int NB = (N + kBoxC - 1) / kBoxC;  // dY boxes a stage
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ int flag;

  Work w;
  w.ring = (smem_addr(smem) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  w.box_bytes = (uint32_t)(g.hbox * g.wbox) * kRow;
  w.stage_bytes = (2 + NB) * w.box_bytes;
  w.t = blockIdx.x % g.tiles;
  w.split = blockIdx.x / g.tiles;
  w.c0 = w.t % g.c_tiles * kTileC;
  w.o0 = w.t / g.c_tiles % g.o_tiles * N;
  w.tap = w.t / (g.c_tiles * g.o_tiles);
  w.box0 = w.split * g.chunk;
  w.n_iter = min(g.chunk, g.boxes - w.box0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);    // the producer's expect_tx
      mbar_init(smem_addr(&empty[s]), 2);   // one arrive per consumer group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) produce<NB>(&xmap, &dmap, full, empty, g, w);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<N>(out, part, count, &flag, full, empty, g, w);
  }
}

// ---- f32 route (CUDA cores, TMA ring) -----------------------------------
// Block (split s, tile t) is blockIdx s * tiles + t, split-major as above:
// the blocks resident together read the same boxes, so the L2 serves a
// box's other taps and tiles.  A tile is 128 C rows (one X box) by N
// columns of O (one dY box): N fits O (32, 48, 64, 72, 96) or is an equal
// share of a wide O of at most 128, so few FMAs fall on padding.  Thread
// 0 keeps a ring of stages full with TMA loads (an X box of hbox x wbox
// positions x 128 channels shifted by the tap, and the dY box of the same
// positions x N columns; f32 elements, no swizzle: a position's row is
// 512 and 4N bytes), completed on one mbarrier a stage; the zero fill of
// boxes past the tensor is the SAME pad, the image edge and the ragged C
// and O tiles.  Each thread owns TM C rows x NT O columns (8 x 8, 8 x 6,
// 4 x 9, ...) in registers and, per position, reads its C slice (TM / 4
// float4s) and its O slice (float4s, then a float2 or a float) from the
// stage: a warp's C reads are 4 distinct float4s and its O reads 8 distinct
// neighbours, so no read has a bank conflict.  After a stage's last
// position the block syncs and thread 0 refills the stage.  Every sum runs
// in position order; the splits' partials go to the workspace and
// filter_grad_reduce sums them in split order (a second launch: a few us,
// under the ~20 us of an in-launch tree's tail on these calls).
constexpr int kF32C = 128;         // C rows of a tile: one X box
constexpr int kF32Threads = 256;   // 2 blocks resident on an SM

template <int N, int TM, int TO>   // O tile, C rows a thread, thread columns
__global__ void __launch_bounds__(kF32Threads, 2)
filter_grad_f32_tma(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap dmap,
                    float* __restrict__ dst, Geo g) {
  constexpr int NT = N / TO;       // O columns a thread
  constexpr int NV = NT / 4;       // its float4s
  constexpr int NR = NT % 4;       // and the rest: a float2 or a float
  constexpr int TCN = kF32C / TM;  // thread rows
  static_assert(N % TO == 0 && TCN * TO == kF32Threads && TO % 8 == 0 &&
                    (TM == 4 || TM == 8) && NR != 3,
                "thread tile");
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];

  const uint32_t base = smem_addr(smem);
  const uint32_t ring = (base + 127) & ~127u;
  const int P = g.hbox * g.wbox;
  const uint32_t xbytes = (uint32_t)P * kF32C * 4, dbytes = (uint32_t)P * N * 4;
  const uint32_t stage_bytes = (xbytes + dbytes + 127) & ~127u;
  const int t = blockIdx.x % g.tiles, split = blockIdx.x / g.tiles;
  const int c0 = t % g.c_tiles * kF32C;
  const int o0 = t / g.c_tiles % g.o_tiles * N;
  const int tap = t / (g.c_tiles * g.o_tiles);
  const int di = tap / g.kw - (g.kh - 1) / 2, dj = tap % g.kw - (g.kw - 1) / 2;
  const int box0 = split * g.chunk;
  const int n_iter = min(g.chunk, g.boxes - box0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {
    const int slot = it % g.stages, box = box0 + it;
    const int x0 = box % g.nx * g.wbox, y0 = box / g.nx % g.ny * g.hbox;
    const int b = box / (g.nx * g.ny);
    const uint32_t bar = smem_addr(&full[slot]);
    const uint32_t st = ring + slot * stage_bytes;
    mbar_expect_tx(bar, xbytes + dbytes);
    tma_load(st, &xmap, bar, c0, x0 + dj, y0 + di, b);
    tma_load(st + xbytes, &dmap, bar, o0, x0, y0, b);
  };
  if (threadIdx.x == 0)
    for (int it = 0; it < min(g.stages, n_iter); ++it) issue(it);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int to = warp % (TO / 8) * 8 + lane % 8;  // thread column
  const int tc = warp / (TO / 8) * 4 + lane / 8;  // thread row
  float acc[TM][NT];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int slot = it % g.stages;
    mbar_wait(smem_addr(&full[slot]), (it / g.stages) & 1);
    const float* xs = reinterpret_cast<const float*>(
        smem + (ring - base) + slot * stage_bytes);
    const float* ds = xs + P * kF32C;
#pragma unroll 2
    for (int k = 0; k < P; ++k) {
      float a[TM], d[NT];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            xs + k * kF32C + 64 * h + 4 * tc);
        a[4 * h] = v.x; a[4 * h + 1] = v.y; a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
      const float* dr = ds + k * N;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 u = *reinterpret_cast<const float4*>(
            dr + 4 * TO * v + 4 * to);
        d[4 * v] = u.x; d[4 * v + 1] = u.y; d[4 * v + 2] = u.z;
        d[4 * v + 3] = u.w;
      }
      if constexpr (NR == 2) {
        const float2 u = *reinterpret_cast<const float2*>(
            dr + 4 * TO * NV + 2 * to);
        d[4 * NV] = u.x; d[4 * NV + 1] = u.y;
      } else if constexpr (NR == 1) {
        d[4 * NV] = dr[4 * TO * NV + to];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j] = fmaf(a[i], d[j], acc[i][j]);
    }
    __syncthreads();  // every thread is done with the stage: refill it
    if (threadIdx.x == 0 && it + g.stages < n_iter) issue(it + g.stages);
  }

  // row i of the thread: C row c0 + 64 (i / 4) + 4 tc + i % 4; column j:
  // O column o0 + 4 TO (j / 4) + 4 to + j % 4 (the float4s), then
  // o0 + 4 TO NV + NR to + (j - 4 NV) (the rest)
  float* out =
      dst + ((int64_t)split * g.kh * g.kw + tap) * ((int64_t)g.C * g.O);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int c = c0 + 64 * (i / 4) + 4 * tc + i % 4;
    if (c >= g.C) continue;
    float* row = out + (int64_t)c * g.O;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int o = o0 + 4 * TO * v + 4 * to;  // O % 4 == 0 on this route
      if (o < g.O)
        *reinterpret_cast<float4*>(row + o) =
            make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2],
                        acc[i][4 * v + 3]);
    }
    if constexpr (NR == 2) {
      const int o = o0 + 4 * TO * NV + 2 * to;
      if (o < g.O)
        *reinterpret_cast<float2*>(row + o) =
            make_float2(acc[i][4 * NV], acc[i][4 * NV + 1]);
    } else if constexpr (NR == 1) {
      const int o = o0 + 4 * TO * NV + to;
      if (o < g.O) row[o] = acc[i][4 * NV];
    }
  }
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

// A 4-D map over a contiguous [B, H, W, ch] tensor of `elem`-byte
// elements, boxes of box_c x wbox x hbox x 1 (channels innermost), zero
// fill
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, const Geo& g,
            int ch, CUtensorMapDataType type, int elem, int box_c,
            CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)g.W,
                              (cuuint64_t)g.H, (cuuint64_t)g.B};
  const cuuint64_t strides[3] = {(cuuint64_t)ch * elem,
                                 (cuuint64_t)ch * elem * g.W,
                                 (cuuint64_t)ch * elem * g.W * g.H};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)g.wbox,
                             (cuuint32_t)g.hbox, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 boxes: 64 channels (128 bytes), 128-byte swizzle
bool encode_bf16(EncodeTiled fn, CUtensorMap* map, const void* base,
                 const Geo& g, int ch) {
  return encode(fn, map, base, g, ch, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                kBoxC, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int N>
cudaError_t launch_wgmma(const CUtensorMap& xm, const CUtensorMap& dm,
                         float* out, float* part, int* count, const Geo& g,
                         int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      filter_grad_wgmma<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  filter_grad_wgmma<N><<<g.tiles * g.splits, kTcThreads, smem, stream>>>(
      xm, dm, out, part, count, g);
  return cudaGetLastError();
}

// The bf16 call.  ws, in 4-byte words when splits > 1: kCounters arrival
// counters a tile, then splits * tiles partial slots of 128 x tile_o f32.
int launch_bf16(const void* x, const void* dy, void* ws, float* out,
                const int* geo, cudaStream_t stream) {
  Geo g{};
  g.B = geo[0]; g.H = geo[1]; g.W = geo[2]; g.C = geo[3]; g.O = geo[4];
  g.kh = geo[5]; g.kw = geo[6]; g.splits = geo[7]; g.chunk = geo[8];
  const int n = geo[9];
  g.hbox = geo[10]; g.wbox = geo[11]; g.group = geo[12]; g.stages = geo[13];
  if (g.C % 8 != 0 || g.O % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0 || g.hbox < 1 ||
      g.wbox < 16 || g.wbox % 16 != 0 || g.hbox > 256 || g.wbox > 256 ||
      g.stages < 2 || g.stages > kMaxStages || g.chunk < 1 || g.group < 1 ||
      (g.splits + g.group - 1) / g.group > kCounters - 1)
    return (int)cudaErrorInvalidValue;
  g.ny = (g.H + g.hbox - 1) / g.hbox;
  g.nx = (g.W + g.wbox - 1) / g.wbox;
  g.boxes = g.B * g.ny * g.nx;
  g.c_tiles = (g.C + kTileC - 1) / kTileC;
  g.o_tiles = (g.O + n - 1) / n;
  g.tiles = g.c_tiles * g.o_tiles * g.kh * g.kw;
  if ((int64_t)g.chunk * g.splits < g.boxes ||
      (int64_t)g.chunk * (g.splits - 1) >= g.boxes ||
      (int64_t)g.tiles * g.splits >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int nb = (n + kBoxC - 1) / kBoxC;
  const int smem = g.stages * (2 + nb) * g.hbox * g.wbox * kRow + kAlign;
  if (smem + 256 > kSmemLimit) return (int)cudaErrorInvalidValue;

  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xm, dm;
  if (!encode_bf16(fn, &xm, x, g, g.C) ||
      !encode_bf16(fn, &dm, dy, g, g.O))
    return (int)cudaErrorInvalidValue;

  int* count = static_cast<int*>(ws);
  float* part = static_cast<float*>(ws) + (int64_t)g.tiles * kCounters;
  if (g.splits > 1) {
    cudaError_t err = cudaMemsetAsync(
        count, 0, (size_t)g.tiles * kCounters * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  switch (n) {
    case 64:
      return (int)launch_wgmma<64>(xm, dm, out, part, count, g, smem, stream);
    case 72:
      return (int)launch_wgmma<72>(xm, dm, out, part, count, g, smem, stream);
    case 128:
      return (int)launch_wgmma<128>(xm, dm, out, part, count, g, smem,
                                    stream);
    case 192:
      return (int)launch_wgmma<192>(xm, dm, out, part, count, g, smem,
                                    stream);
    case 256:
      return (int)launch_wgmma<256>(xm, dm, out, part, count, g, smem,
                                    stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int N, int TM, int TO>
cudaError_t launch_f32_kernel(const CUtensorMap& xm, const CUtensorMap& dm,
                              float* dst, const Geo& g, int smem,
                              cudaStream_t stream) {
  auto kernel = filter_grad_f32_tma<N, TM, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  kernel<<<g.tiles * g.splits, kF32Threads, smem, stream>>>(xm, dm, dst, g);
  return cudaGetLastError();
}

// The f32 call by TMA: geo as launch_bf16 reads it (chunk = boxes a split,
// group unused); ws holds splits * kh*kw * C*O partials when splits > 1,
// summed by filter_grad_reduce.  Needs C % 4 == 0, O % 4 == 0 and 16-byte
// aligned x and dy (a tensor map's strides and base).
int launch_f32_tma(const float* x, const float* dy, float* ws, float* out,
                   const int* geo, cudaStream_t stream) {
  Geo g{};
  g.B = geo[0]; g.H = geo[1]; g.W = geo[2]; g.C = geo[3]; g.O = geo[4];
  g.kh = geo[5]; g.kw = geo[6]; g.splits = geo[7]; g.chunk = geo[8];
  const int n = geo[9];
  g.hbox = geo[10]; g.wbox = geo[11]; g.group = 1; g.stages = geo[13];
  if (g.C % 4 != 0 || g.O % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0 || g.hbox < 1 ||
      g.wbox < 1 || g.hbox > 256 || g.wbox > 256 || g.stages < 2 ||
      g.stages > kMaxStages || g.chunk < 1)
    return (int)cudaErrorInvalidValue;
  g.ny = (g.H + g.hbox - 1) / g.hbox;
  g.nx = (g.W + g.wbox - 1) / g.wbox;
  g.boxes = g.B * g.ny * g.nx;
  g.c_tiles = (g.C + kF32C - 1) / kF32C;
  g.o_tiles = (g.O + n - 1) / n;
  g.tiles = g.c_tiles * g.o_tiles * g.kh * g.kw;
  if ((int64_t)g.chunk * g.splits < g.boxes ||
      (int64_t)g.chunk * (g.splits - 1) >= g.boxes ||
      (int64_t)g.tiles * g.splits >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t stage = ((int64_t)g.hbox * g.wbox * (kF32C + n) * 4 + 127) /
                        128 * 128;
  const int64_t smem = g.stages * stage + 128;
  if (smem + 64 > kSmemLimit / 2 - 1024) return (int)cudaErrorInvalidValue;

  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xm, dm;
  if (!encode(fn, &xm, x, g, g.C, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kF32C,
              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(fn, &dm, dy, g, g.O, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, n,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  float* dst = g.splits == 1 ? out : ws;
  cudaError_t err;
  // (N, C rows, thread columns): 4 x N/8 accumulators a thread up to
  // N = 72, then 8 x N/16
  switch (n) {
    case 32: err = launch_f32_kernel<32, 4, 8>(xm, dm, dst, g, smem, stream);
      break;
    case 48: err = launch_f32_kernel<48, 4, 8>(xm, dm, dst, g, smem, stream);
      break;
    case 64: err = launch_f32_kernel<64, 4, 8>(xm, dm, dst, g, smem, stream);
      break;
    case 72: err = launch_f32_kernel<72, 4, 8>(xm, dm, dst, g, smem, stream);
      break;
    case 96: err = launch_f32_kernel<96, 8, 16>(xm, dm, dst, g, smem, stream);
      break;
    case 128:
      err = launch_f32_kernel<128, 8, 16>(xm, dm, dst, g, smem, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || g.splits == 1) return (int)err;
  Shape s{g.B, g.H, g.W, g.C, g.O, g.kh, g.kw, 0, 0, 0};
  return launch_reduce(ws, out, s, g.splits, stream);
}

}  // namespace

extern "C" {

// geo: {B, H, W, C, O, kh, kw, splits, chunk, tile_o, hbox, wbox, group,
// stages}; the wrapper's plan computes it.  splits: of each tile's
// contraction.  kernel 0 = float32 (CUDA cores, scalar loads; chunk =
// positions per split, a multiple of 32; ws holds splits * kh*kw * C*O
// floats, unused when splits == 1); 1 = bfloat16 by TMA + wgmma (chunk =
// boxes per split; ws as launch_bf16 lays it out); 2 = bfloat16 by
// mma.sync (chunk and ws as for kernel 0); 3 = float32 by TMA on the CUDA
// cores (chunk = boxes per split, ws as for kernel 0; needs C % 4 == 0,
// O % 4 == 0 and 16-byte aligned x and dy).  bfloat16 needs C % 8 == 0,
// O % 8 == 0 and 16-byte aligned x and dy.  Returns a cudaError_t.
int sdt_filter_grad(const void* x, const void* dy, void* ws, void* out,
                    const int* geo, int kernel, void* stream) {
  const int B = geo[0], H = geo[1], W = geo[2], C = geo[3], O = geo[4];
  const int kh = geo[5], kw = geo[6], splits = geo[7], chunk = geo[8];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kh % 2 != 1 || kw % 2 != 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (kernel == 1)
    return launch_bf16(x, dy, ws, static_cast<float*>(out), geo, st);
  if (kernel == 3)
    return launch_f32_tma(static_cast<const float*>(x),
                          static_cast<const float*>(dy),
                          static_cast<float*>(ws), static_cast<float*>(out),
                          geo, st);
  if ((kernel != 0 && kernel != 2) || chunk % kStep != 0)
    return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  float* dst = splits == 1 ? o : w;
  const int64_t M = (int64_t)B * H * W;
  cudaError_t err;
  Shape s{B, H, W, C, O, kh, kw, M, (int64_t)chunk, 0};
  if (kernel == 0) {
    s.c_tiles = (C + kTC - 1) / kTC;
    const dim3 grid(s.c_tiles * ((O + kTO - 1) / kTO), kh * kw, splits);
    filter_grad_partial_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), dst, s);
    err = cudaGetLastError();
  } else {
    if (C % 8 != 0 || O % 8 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dy) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    s.c_tiles = (C + kMmaC - 1) / kMmaC;
    const dim3 grid(s.c_tiles * ((O + kMmaO - 1) / kMmaO), kh * kw, splits);
    // n8 tiles per warp: the block's O columns split over 2 warps
    switch (((O < kMmaO ? O : kMmaO) / 8 + 1) / 2) {
      case 1: err = launch_mma<1>(s, grid, x, dy, dst, st); break;
      case 2: err = launch_mma<2>(s, grid, x, dy, dst, st); break;
      case 3: err = launch_mma<3>(s, grid, x, dy, dst, st); break;
      case 4: err = launch_mma<4>(s, grid, x, dy, dst, st); break;
      case 5: err = launch_mma<5>(s, grid, x, dy, dst, st); break;
      case 6: err = launch_mma<6>(s, grid, x, dy, dst, st); break;
      case 7: err = launch_mma<7>(s, grid, x, dy, dst, st); break;
      default: err = launch_mma<8>(s, grid, x, dy, dst, st); break;
    }
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_reduce(w, o, s, splits, st);
}

const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
