// conv1 + bias + ReLU + pool1 of squeezeDet in one pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel squeezedet_tpu/ops/fused_frontend.py:conv1_pool1_fused:
//   out = max_pool_3x3_s2_SAME(relu(conv_3x3_s2_SAME(x, k) + b))
// with x [B,H,W,3] NHWC (f32 or bf16), k [3,3,3,64] HWIO and b [64] given in
// f32 (already rounded to x's dtype by the wrapper), out [B,Hp,Wp,64] NHWC in
// x's dtype.  Sums, bias and ReLU are f32; the result is rounded once, at the
// store.  Padding is TF SAME (pad_top = pad_total / 2) for the conv (zeros)
// and the pool (-inf: a tap outside the conv output is skipped), so any H and
// W are taken; the wrapper computes the geometry and passes it in.
//
// What bounds it (H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s f32 on CUDA
// cores).  At batch 128, 384x1248, bf16 the kernel reads 368 MB of images and
// writes 491 MB of pooled output: ~0.26 ms of memory time.  The unfused path
// also writes and reads back a 1.96 GB conv1 activation.  The conv itself is
// about 53 GFLOP (K = 27 taps x 64 channels per output) on CUDA cores: ~0.8 ms
// at peak.  So this kernel is compute-bound on CUDA cores unless the conv
// moves to tensor cores.  A pool window overlaps its neighbours, and
// computing each conv output inside every window that needs it would cost
// 2.25x the conv; instead a block computes each conv output of its tile once
// into an f32 shared-memory tile and pools out of it, so only the halo rows
// and columns of a tile are computed twice (~1.16x at the tile size below).
//
// Design (simple first): one block per (image, TP x TQ tile of pool outputs).
//   1. load the input halo tile, zero-padded, as f32 into shared memory;
//   2. compute the tile's (2TP+1) x (2TQ+1) conv outputs for all 64 channels
//      into shared memory (16 channels per work item, weights read as float4
//      broadcasts); conv positions outside the conv output hold -inf;
//   3. pool 3x3 s2 out of the tile and store only the pooled values.
// The conv1 activation never reaches device memory.  wgmma, TMA and fusing
// the uint8 mean-subtract into the load are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTP = 4;                  // pool rows per block
constexpr int kTQ = 16;                 // pool cols per block
constexpr int kCR = 2 * kTP + 1;        // conv rows per block
constexpr int kCC = 2 * kTQ + 1;        // conv cols per block
constexpr int kIR = 2 * kCR + 1;        // input rows per block
constexpr int kIC = 2 * kCC + 1;        // input cols per block
constexpr int kCin = 3;
constexpr int kTaps = 9 * kCin;         // 27
constexpr int kCout = 64;
constexpr int kCStride = kCout + 1;     // padded conv-tile row: no bank conflicts
constexpr int kGroup = 16;              // output channels per work item
constexpr int kThreads = 256;

constexpr int kSmemFloats = kTaps * kCout + kCout + kIR * kIC * kCin +
                            kCR * kCC * kCStride;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

struct Geometry {
  int H, W;            // input
  int Hc, Wc;          // conv output
  int Hp, Wp;          // pool output
  int pad_t, pad_l;    // conv SAME pads (top, left)
  int ppad_t, ppad_l;  // pool SAME pads (top, left)
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv1_pool1_kernel(const T* __restrict__ x, const float* __restrict__ k,
                   const float* __restrict__ bias, T* __restrict__ out,
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
  const T* xb = x + (size_t)b * g.H * g.W * kCin;
  for (int i = threadIdx.x; i < kIR * kIC * kCin; i += kThreads) {
    const int r = i / (kIC * kCin);
    const int rem = i - r * (kIC * kCin);
    const int yy = ir0 + r;
    const int xx = ic0 + rem / kCin;
    float v = 0.f;
    if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
      v = load_f32(xb + ((size_t)yy * g.W + xx) * kCin + rem % kCin);
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
  T* ob = out + (size_t)b * g.Hp * g.Wp * kCout;
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
    store(ob + ((size_t)p * g.Wp + q) * kCout + o, m);
  }
}

template <typename T>
int launch(const void* x, const void* k, const void* bias, void* out, int B,
           const Geometry& g, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv1_pool1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.Wp + kTQ - 1) / kTQ, (g.Hp + kTP - 1) / kTP, B);
  conv1_pool1_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(k),
      static_cast<const float*>(bias), static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
int sdt_conv1_pool1(const void* x, const void* k, const void* bias, void* out,
                    int B, int H, int W, int Hc, int Wc, int Hp, int Wp,
                    int pad_t, int pad_l, int ppad_t, int ppad_l, int dtype,
                    void* stream) {
  const Geometry g{H, W, Hc, Wc, Hp, Wp, pad_t, pad_l, ppad_t, ppad_l};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, k, bias, out, B, g, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, k, bias, out, B, g, s);
  return (int)cudaErrorInvalidValue;
}

const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
