// ResNet's conv + frozen batch-norm epilogue in one streaming pass (K4),
// for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's conv_bn
// (squeezedet_tpu/models/layers.py:conv_bn) and its residual join
// (squeezedet_tpu/models/resnet50.py) are plain jnp that XLA fuses into
// the convolution's neighbours.  In the port they were torch ops, each a
// pass over the conv's output (ops/bn_act.py:bn_act_reference is that
// plain version): the affine's multiply and add, both torch's strided
// elementwise kernel (a per-channel vector broadcast over a channels-last
// map is not vectorised), then ReLU, or for a block's last conv the
// projection shortcut's own affine, the join's add and its ReLU.  On an
// H100 80GB HBM3 (700 W) those passes were 72 % of a B = 128 ResNet50
// scoring call at 1242 x 375 (89 of 125 ms) and about five small f32
// kernels and two casts a layer more for the scale and shift.
//
// What it computes, over a channels-last (NHWC) map of C channels, for
// element (p, c), in the map's dtype T (bf16 or f32), each step rounded
// to T as torch rounds each op's result, with no FMA across a rounding
// (__fmul_rn and friends, which nvcc never contracts):
//   inv = gamma * rsqrt(var + eps), shift = beta - mean * inv   (f32)
//   t = y[p, c] (+ T(bias[c]))  then  t * T(inv[c])  then  + T(shift[c])
//   with a shortcut s: s is the identity s[p, c], or the raw conv output
//   of a bias-free projection with its own affine, s * T(inv') + T(shift');
//   then t = s + t
//   then ReLU: max(t, 0), a NaN passed on (torch's clamp_min).
// inv and shift are computed by each thread for its own channels, in the
// f32 operations torch.rsqrt and the tensor ops take, so the five small
// kernels and two casts of a layer go too.
//
// What bounds it on this card (H100 SXM data sheet, 3.35 TB/s): bytes.
// One read of y and one write of the result, 2 x 2 bytes an element in
// bf16, and one read more of the shortcut in a join: at ResNet50's B = 128
// res2 shapes (93 x 310, 64 and 256 channels) a 2a/2b map is 236 M bf16
// elements, 944 MB moved, 0.28 ms; a res2 join 1.42 GB, 0.42 ms.  The
// arithmetic is a few f32 operations an element.
//
// Design: a grid-stride loop over 16-byte vectors (eight bf16 or four f32
// channels), streamed with __ldcs / __stcs (the maps outgrow the 50 MB
// L2).  The grid has as many threads as the card holds at once, cut to a
// multiple of the C / vector channel groups, so the loop's stride keeps
// each thread on one channel group: its per-channel constants are
// computed once into registers.  Four vectors a thread are loaded before
// any is stored, to keep enough bytes in flight.  The result is written
// over y (the caller's fresh conv output, which nothing else holds).  One
// source, templated on the dtype and on the operands: the conv bias
// (conv1's, never with a shortcut) and the shortcut (none, identity,
// projection).  Every launch ends in ReLU: the port's layers without one
// (branch2c, branch1) are finished by the join, so four forms a dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

enum Shortcut { kNone = 0, kIdentity = 1, kProjection = 2 };

// One operand's batch norm: per-channel f32 vectors, the conv bias
// optional (null without).
struct Norm {
  const float* bias;
  const float* gamma;
  const float* beta;
  const float* mean;
  const float* var;
  float eps;
};

struct Args {
  uint4* out;       // may be y itself
  const uint4* y;
  const uint4* s;   // the shortcut, or null
  Norm norm, snorm;
  int64_t vectors;  // 16-byte vectors in the map
  int64_t threads;  // the grid's working threads: a multiple of groups
  int groups;       // C / channels a vector
};

template <typename T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int kN = 4;
};
template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kN = 8;
};

// x rounded to T, as a float
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// element i of a 16-byte vector of T, widened (exactly) to float
template <typename T>
__device__ __forceinline__ float lane(const uint4& v, int i);
template <>
__device__ __forceinline__ float lane<float>(const uint4& v, int i) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return __uint_as_float(w[i]);
}
template <>
__device__ __forceinline__ float lane<__nv_bfloat16>(const uint4& v, int i) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t word = w[i >> 1];
  return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
}

// a 16-byte vector of T from floats that T holds exactly
template <typename T>
__device__ __forceinline__ uint4 pack(const float* x);
template <>
__device__ __forceinline__ uint4 pack<float>(const float* x) {
  return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                    __float_as_uint(x[2]), __float_as_uint(x[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* x) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (__float_as_uint(x[2 * k]) >> 16) |
           (__float_as_uint(x[2 * k + 1]) & 0xffff0000u);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// channel c's scale and shift, rounded to T as the tensor ops' casts do
template <typename T>
__device__ __forceinline__ void scale_shift(const Norm& n, int c, float& inv,
                                            float& shift) {
  const float f = __fmul_rn(n.gamma[c], rsqrtf(__fadd_rn(n.var[c], n.eps)));
  shift = rnd<T>(__fsub_rn(n.beta[c], __fmul_rn(n.mean[c], f)));
  inv = rnd<T>(f);
}

template <typename T, bool kBias, int kShortcut>
__global__ void __launch_bounds__(kThreads) bn_act(Args a) {
  constexpr int kN = Lanes<T>::kN;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= a.threads) return;
  const int c0 = (int)(t % a.groups) * kN;
  float bias[kN], inv[kN], shift[kN], sinv[kN], sshift[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    bias[i] = kBias ? rnd<T>(a.norm.bias[c0 + i]) : 0.0f;
    scale_shift<T>(a.norm, c0 + i, inv[i], shift[i]);
    if (kShortcut == kProjection)
      scale_shift<T>(a.snorm, c0 + i, sinv[i], sshift[i]);
  }
  const int64_t stride = a.threads;
  for (int64_t base = t; base < a.vectors; base += kUnroll * stride) {
    uint4 yv[kUnroll], sv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = base + u * stride;
      if (v < a.vectors) {
        yv[u] = __ldcs(a.y + v);
        if (kShortcut != kNone) sv[u] = __ldcs(a.s + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = base + u * stride;
      if (v >= a.vectors) break;
      float x[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        float e = lane<T>(yv[u], i);
        if (kBias) e = rnd<T>(__fadd_rn(e, bias[i]));
        e = rnd<T>(__fmul_rn(e, inv[i]));
        e = rnd<T>(__fadd_rn(e, shift[i]));
        if (kShortcut != kNone) {
          float s = lane<T>(sv[u], i);
          if (kShortcut == kProjection) {
            s = rnd<T>(__fmul_rn(s, sinv[i]));
            s = rnd<T>(__fadd_rn(s, sshift[i]));
          }
          e = rnd<T>(__fadd_rn(s, e));
        }
        if (e == e) e = fmaxf(e, 0.0f);
        x[i] = e;
      }
      __stcs(a.out + v, pack<T>(x));
    }
  }
}

template <typename T, bool kBias, int kShortcut>
int launch(Args a, cudaStream_t stream) {
  const auto kernel = bn_act<T, kBias, kShortcut>;
  // blocks of this kernel an SM holds at once (registers bound it)
  static const int resident = [kernel] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                      0) != cudaSuccess)
      n = 1;
    return n > 0 ? n : 1;
  }();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  int64_t threads = (int64_t)sms * resident * kThreads;
  if (threads > a.vectors) threads = a.vectors;
  threads -= threads % a.groups;  // vectors is a multiple of groups
  if (threads < a.groups) threads = a.groups;
  a.threads = threads;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((threads + kThreads - 1) / kThreads));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  return (int)cudaLaunchKernelEx(&config, kernel, a);
}

template <typename T>
int dispatch(const Args& a, int shortcut, cudaStream_t stream) {
  if (a.norm.bias) return launch<T, true, kNone>(a, stream);
  switch (shortcut) {
    case kNone: return launch<T, false, kNone>(a, stream);
    case kIdentity: return launch<T, false, kIdentity>(a, stream);
    case kProjection: return launch<T, false, kProjection>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// One launch on `stream` over `pixels` x `channels` elements of dtype
// (0 f32, 1 bf16), writing `out` (which may be `y`), ReLU last.
// shortcut: 0 none, 1 identity `s`, 2 `s` the raw output of a projection
// whose batch norm is (s_gamma, s_beta, s_mean, s_var, s_eps).  bias may
// be null, and must be without a shortcut.  y, s and out must be 16-byte
// aligned and channels a multiple of 8.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for what it does not take).
int sdt_bn_act(void* out, const void* y, const void* s, long long pixels,
               int channels, int dtype, int shortcut,
               const float* bias, const float* gamma, const float* beta,
               const float* mean, const float* var, float eps,
               const float* s_gamma, const float* s_beta,
               const float* s_mean, const float* s_var, float s_eps,
               void* stream) {
  if (pixels < 1 || channels < 8 || channels % 8 || dtype < 0 || dtype > 1 ||
      shortcut < 0 || shortcut > 2 || (shortcut != kNone && !s) ||
      (shortcut != kNone && bias) ||
      (shortcut == kProjection && !(s_gamma && s_beta && s_mean && s_var)) ||
      !(gamma && beta && mean && var) || !aligned16(out) || !aligned16(y) ||
      (s && !aligned16(s)))
    return (int)cudaErrorInvalidValue;
  const int lanes = dtype ? 8 : 4;
  Args a{};
  a.out = static_cast<uint4*>(out);
  a.y = static_cast<const uint4*>(y);
  a.s = static_cast<const uint4*>(s);
  a.norm = Norm{bias, gamma, beta, mean, var, eps};
  a.snorm = Norm{nullptr, s_gamma, s_beta, s_mean, s_var, s_eps};
  a.groups = channels / lanes;
  a.vectors = (int64_t)pixels * a.groups;
  const auto st = static_cast<cudaStream_t>(stream);
  return dtype ? dispatch<__nv_bfloat16>(a, shortcut, st)
               : dispatch<float>(a, shortcut, st);
}

const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
