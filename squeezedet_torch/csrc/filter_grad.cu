// Filter gradient of a stride-1 SAME convolution, for Hopper (sm_90a) (K2).
//
// Replaces the TPU kernel squeezedet_tpu/ops/filter_grad.py:filter_grad:
//   dW[i, j, c, o] = sum_{b,y,x} X[b, y+i-ph, x+j-pw, c] * dY[b, y, x, o]
// with X [B,H,W,C] and dY [B,H,W,O] contiguous NHWC (both f32 or both bf16),
// odd kh and kw, ph = (kh-1)/2, pw = (kw-1)/2, X read as zero outside the
// image, and dW [kh,kw,C,O] in f32.  bf16 operands are widened to f32, where
// their product is exact; every sum is f32.
//
// What bounds it (H100 SXM data sheet: 67 TFLOP/s f32 on CUDA cores,
// 3.35 TB/s).  The contraction runs over all B*H*W positions: at the
// squeezeDet train step (B=20, 1248x384) a fire squeeze half contracts 150k
// (48x156) or 37k (24x78) positions into a C x O tile of 128x32 .. 384x96,
// and conv12's two 3x3 halves each do 9 taps of 37k x 384 x 72.  One
// backward's 12 calls are ~52 GFLOP (conv12's halves 37 of them) over ~0.3 GB
// of operands, so the kernel is bound by arithmetic, on CUDA cores here:
// >= 0.78 ms at their peak.  The output is small, so parallelism has to come from splitting the
// contraction.
//
// Design (simple first, no tensor cores, wgmma or TMA):
//   pass 1: block (C x O tile of 64 x 64, tap, split) walks its split's
//     chunk of positions 32 at a time.  Per step it stages the 32 shifted X
//     rows (zero outside the image) and the 32 dY rows of its tile in shared
//     memory, then each of 256 threads accumulates a 4 x 4 sub-tile in f32
//     registers.  Ragged C and O edges (O = 72, 96) load zeros and skip the
//     store.  The partial goes to ws[split, tap, C, O].
//   pass 2: out[t, c, o] = sum over splits of ws[s, t, c, o], s = 0, 1, ...
// Every sum runs in a fixed order and no atomics are used, so two launches
// on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTC = 64;       // C rows of a block's output tile
constexpr int kTO = 64;       // O columns of a block's output tile
constexpr int kTK = 32;       // positions staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

struct Shape {
  int B, H, W, C, O, kh, kw;
  int64_t M;       // B * H * W positions
  int64_t chunk;   // positions per split (a multiple of kTK)
  int c_tiles;     // ceil(C / kTC)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
filter_grad_partial(const T* __restrict__ x, const T* __restrict__ dy,
                    float* __restrict__ ws, Shape s) {
  __shared__ __align__(16) float s_x[kTK][kTC];
  __shared__ __align__(16) float s_d[kTK][kTO];
  __shared__ int64_t s_xrow[kTK];  // X element offset of the row, or -1
  __shared__ int64_t s_drow[kTK];  // dY element offset of the row, or -1

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
  for (int64_t p0 = p_begin; p0 < p_end; p0 += kTK) {
    if (tid < kTK) {
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
    for (int k = row0; k < kTK; k += kThreads / 64) {
      const int64_t xoff = s_xrow[k];
      const int64_t doff = s_drow[k];
      const int c = c0 + lane;
      const int o = o0 + lane;
      s_x[k][lane] = (xoff >= 0 && c < s.C) ? to_f32(x[xoff + c]) : 0.f;
      s_d[k][lane] = (doff >= 0 && o < s.O) ? to_f32(dy[doff + o]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTK; ++k) {
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

__global__ void filter_grad_reduce(const float* __restrict__ ws,
                                   float* __restrict__ out, int64_t n,
                                   int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += ws[(int64_t)sp * n + i];
    out[i] = v;
  }
}

template <typename T>
int launch(const void* x, const void* dy, float* ws, float* out,
           const Shape& s, int splits, cudaStream_t stream) {
  const int o_tiles = (s.O + kTO - 1) / kTO;
  const dim3 grid(s.c_tiles * o_tiles, s.kh * s.kw, splits);
  filter_grad_partial<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), ws, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)s.kh * s.kw * s.C * s.O;
  const int64_t want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  filter_grad_reduce<<<blocks, 256, 0, stream>>>(ws, out, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ws holds splits * kh * kw * C * O floats; chunk * splits >= B * H * W and
// chunk is a multiple of 32 (the wrapper computes both).  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launches.
int sdt_filter_grad(const void* x, const void* dy, void* ws, void* out,
                    int B, int H, int W, int C, int O, int kh, int kw,
                    int splits, long long chunk, int dtype, void* stream) {
  if (kh % 2 != 1 || kw % 2 != 1 || chunk % kTK != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  Shape s{B, H, W, C, O, kh, kw, (int64_t)B * H * W, (int64_t)chunk,
          (C + kTC - 1) / kTC};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(x, dy, w, o, s, splits, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dy, w, o, s, splits, st);
  return (int)cudaErrorInvalidValue;
}

const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
