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
// (2 * B*H*W * (C + O) bytes in bf16) and writes dW (4 * kh*kw*C*O bytes);
// it does 2 * B*H*W * C * O * kh*kw operations.  At the squeezeDet train
// step (B=20, 1248x384) the ten 1x1 squeeze halves move 13-48 MB for
// 0.6-4 GFLOP each, so they are bound by bytes (4-14 us each); conv12's two
// 3x3 halves (C=384, O=72, 24x78) do 18.6 GFLOP on 16 MB each, bound by the
// tensor cores (19 us each).  Summed over one backward's 12 calls the bound
// is ~0.126 ms.  The output is small, so parallelism has to come from
// splitting the contraction.
//
// bf16 route (tensor cores):
//   pass 1: block = (C tile of 128, O tile of up to 128 columns (all of O
//     in squeezeDet: no wasted columns at O = 32..96), tap, split).  It walks
//     its split's chunk of positions 64 at a time through a 3-stage ring in
//     shared memory (96 KB), filled by 16-byte cp.async as the operands lie
//     (bf16, [position][channel]); a shifted X row outside the image, and a
//     row past the chunk's end, is copied as zeros (src-size 0).  Each
//     position is split into (b, y, x) to find its shifted row, so rows never
//     wrap across image rows.  Both operands have the contraction (position)
//     axis as their slow axis, so ldmatrix.trans loads the A (X^T) and B (dY)
//     fragments; rows are 256 bytes with the 16-byte chunk index XORed by
//     (row & 7), so the 8 rows an ldmatrix reads fall in 8 distinct bank
//     groups.  8 warps: 4 along C (32 rows each) x 2 along O, each issuing
//     mma.sync.m16n8k16 bf16 -> f32 on its 2 x NTW fragment tiles.  The
//     partial goes to ws[split, tap, C, O] (or straight to dW when there is
//     one split).
//   pass 2: dW[t, c, o] = sum over splits of ws[s, t, c, o] in a fixed
//     order: 8 warps each sum every 8th split of 32 outputs, then their 8
//     sums are added in warp order, so even a small dW (6k values) keeps
//     many loads in flight.
// f32 route (CUDA cores, unchanged): 64 x 64 C x O tile per (tap, split),
//   32 positions staged per step as f32 in shared memory, 4 x 4 f32 FMAs per
//   thread; the same pass 2.
// Every sum runs in a fixed order and no atomics are used, so two launches
// on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStep = 32;     // f32 route: positions per step; every split's
                              // chunk of positions is a multiple of it

// ---- f32 route (CUDA cores) ----------------------------------------------
constexpr int kTC = 64;       // C rows of a block's output tile
constexpr int kTO = 64;       // O columns of a block's output tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

// ---- bf16 route (tensor cores) -------------------------------------------
constexpr int kMC = 128;      // C rows of a block's output tile
constexpr int kNO = 128;      // at most this many O columns per block
constexpr int kTcStep = 64;   // positions per stage
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kChunks = 16;   // 16-byte chunks in a 256-byte staged row
constexpr int kTcThreads = 256;
constexpr int kStageBytes = kTcStep * kChunks * 16;        // 16 KB per operand
constexpr int kTcSmemBytes = 2 * kStages * kStageBytes;    // 96 KB

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

// ---- bf16 route helpers ----------------------------------------------------

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

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte offset of 16-byte chunk `chunk` of staged row `row` (XOR swizzle)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)((row * kChunks + (chunk ^ (row & 7))) * 16);
}

// (b, y, x) of a flat position, stepped kTcStep positions per stage
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
__global__ void __launch_bounds__(kTcThreads, 2)
filter_grad_tc_partial(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ dy,
                       float* __restrict__ ws, Shape s) {
  constexpr int NP = (NTW + 1) / 2;  // ldmatrix.x4 loads of dY
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_x = smem;                           // [stage][64][256 B]
  unsigned char* s_d = smem + kStages * kStageBytes;   // [stage][64][256 B]

  const int c0 = (blockIdx.x % s.c_tiles) * kMC;
  const int o0 = (blockIdx.x / s.c_tiles) * kNO;
  const int nt8 = min(kNO, s.O - o0) / 8;  // O is a multiple of 8
  const int tap = blockIdx.y;
  const int di = tap / s.kw - (s.kh - 1) / 2;
  const int dj = tap % s.kw - (s.kw - 1) / 2;
  const int64_t p_begin = (int64_t)blockIdx.z * s.chunk;
  const int64_t p_end = p_begin + s.chunk < s.M ? p_begin + s.chunk : s.M;
  const int n_stages = (int)((p_end - p_begin + kTcStep - 1) / kTcStep);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp & 3;   // C rows 32*wm .. 32*wm+31 of the tile
  const int wn = warp >> 2;  // O tiles NTW*wn .. NTW*wn+NTW-1

  // loader: this thread copies chunks 4*lq .. 4*lq+3 of staged row lr, so
  // it finds one row's (b, y, x) per stage
  static_assert(kTcStep * 4 == kTcThreads, "one staged row per 4 threads");
  const int lr = tid >> 2;
  const int lq = tid & 3;
  Pos pos;
  pos.init(p_begin + lr, s.H, s.W);

  auto load_stage = [&](int slot, int stage) {
    const uint32_t xs = smem_addr(s_x + slot * kStageBytes);
    const uint32_t ds = smem_addr(s_d + slot * kStageBytes);
    const int64_t p = p_begin + (int64_t)stage * kTcStep + lr;
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
    pos.advance(kTcStep, s.H, s.W);
  };

  float acc[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) load_stage(st, st);
    cp_async_commit();
  }

  // ldmatrix row addresses: lane -> (matrix lane/8, row lane%8)
  const int mat = lane >> 3, mrow = lane & 7;
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = st + kStages - 1;
    if (next < n_stages) load_stage(next % kStages, next);
    cp_async_commit();

    const uint32_t xs = smem_addr(s_x + (st % kStages) * kStageBytes);
    const uint32_t ds = smem_addr(s_d + (st % kStages) * kStageBytes);
#pragma unroll
    for (int k0 = 0; k0 < kTcStep; k0 += 16) {
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

template <int NTW>
cudaError_t launch_tc(const Shape& s, dim3 grid, const void* x,
                      const void* dy, float* dst, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      filter_grad_tc_partial<NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmemBytes);
  if (err != cudaSuccess) return err;
  filter_grad_tc_partial<NTW><<<grid, kTcThreads, kTcSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), dst, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ws holds splits * kh * kw * C * O floats (unused when splits == 1);
// chunk * splits >= B * H * W and chunk is a multiple of 32 (the wrapper
// computes both).  dtype: 0 = float32 (CUDA cores, C x O tiles of 64 x 64),
// 1 = bfloat16 (tensor cores, C tiles of 128 and O tiles of up to 128;
// needs C % 8 == 0, O % 8 == 0 and 16-byte aligned x and dy).  Returns the
// cudaError_t of the launches.
int sdt_filter_grad(const void* x, const void* dy, void* ws, void* out,
                    int B, int H, int W, int C, int O, int kh, int kw,
                    int splits, long long chunk, int dtype, void* stream) {
  if (kh % 2 != 1 || kw % 2 != 1 || chunk % kStep != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  float* dst = splits == 1 ? o : w;
  const int64_t M = (int64_t)B * H * W;
  if (dtype == 0) {
    Shape s{B, H, W, C, O, kh, kw, M, (int64_t)chunk, (C + kTC - 1) / kTC};
    const dim3 grid(s.c_tiles * ((O + kTO - 1) / kTO), kh * kw, splits);
    filter_grad_partial_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), dst, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    return launch_reduce(w, o, s, splits, st);
  }
  if (dtype != 1 || C % 8 != 0 || O % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Shape s{B, H, W, C, O, kh, kw, M, (int64_t)chunk, (C + kMC - 1) / kMC};
  const dim3 grid(s.c_tiles * ((O + kNO - 1) / kNO), kh * kw, splits);
  // n8 tiles per warp: the block's O columns split over 2 warps
  const int ntw = ((O < kNO ? O : kNO) / 8 + 1) / 2;
  cudaError_t err;
  switch (ntw) {
    case 1: err = launch_tc<1>(s, grid, x, dy, dst, st); break;
    case 2: err = launch_tc<2>(s, grid, x, dy, dst, st); break;
    case 3: err = launch_tc<3>(s, grid, x, dy, dst, st); break;
    case 4: err = launch_tc<4>(s, grid, x, dy, dst, st); break;
    case 5: err = launch_tc<5>(s, grid, x, dy, dst, st); break;
    case 6: err = launch_tc<6>(s, grid, x, dy, dst, st); break;
    case 7: err = launch_tc<7>(s, grid, x, dy, dst, st); break;
    default: err = launch_tc<8>(s, grid, x, dy, dst, st); break;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_reduce(w, o, s, splits, st);
}

const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
