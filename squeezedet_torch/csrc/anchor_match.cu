// The greedy anchor matcher of the train step in one launch (K3), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's matcher
// (squeezedet_tpu/data/device_pipeline.py:assign_anchors_device) is plain
// jnp that XLA compiles into one program; the port ran it as a Python loop
// of torch ops over the G ground-truth slots
// (squeezedet_torch/data/device_pipeline.py:assign_anchors_reference, its
// plain version).  On an H100 80GB HBM3 (700 W) that loop, at the recipe's
// B = 20, G = 48 and 16,848 anchors, was 4,646 of the train step's 6,778
// kernels and 8.05 of its 24.67 busy ms: about 95 elementwise, argmax and
// argmin kernels a slot over [B, A] and a sorting scatter, each of 1-2 us
// and each waiting on the one before.
//
// What it computes, for each image b (ops/boxes.py:batch_iou and the loop):
// for each slot g < min(num_gt[b], G) in order, the unclaimed anchor of the
// highest IoU with the slot's box (the largest index on ties; a NaN IoU
// above every number, as torch.argmax orders it) if that IoU is above 0,
// else the unclaimed anchor nearest to the box by the squared distance in
// (cx, cy, w, h) (the smallest index on ties, a NaN below every number, as
// torch.argmin); that anchor is claimed, and a later slot that picks it
// again (only when every anchor is claimed) takes it over, as the plain
// version's scatter keeps the last write.  Claimed anchors take the values
// the plain version masks them with: IoU -1 and distance +inf.  Then the
// dense targets: mask 1, the slot's box, its one-hot label and the deltas
// (dx, dy, log dw, log dh) at each claimed anchor, zeros elsewhere.  Slots
// at or beyond num_gt claim nothing (in the plain version they scatter to
// a dropped row), so their rounds are skipped.
//
// Bit for bit the plain version's results on the card: IoU and distance
// take the same f32 operations in the same order as the torch ops, each
// rounded once (__fadd_rn and friends, which nvcc never contracts into an
// FMA: every torch op is a kernel of its own and rounds its result), the
// four squares summed as torch.sum sums a row of four on the card ((s0 +
// s2) + (s1 + s3): four threads of a block row combined by shuffles at
// offsets 2 then 1), the deltas with IEEE division and the full-precision
// logf that torch.log calls; minimum, maximum and clamp pass a NaN on as
// torch's do.  The sign of a zero IoU may differ (fminf of -0 and +0), and
// no result sees it: a zero is no positive IoU and ties every other zero.
//
// What bounds it on this card (H100 SXM data sheet, 3.35 TB/s): the bytes
// are the dense targets, B x A x (1 + 4 + 4 + C) f32 (16.2 MB at B = 20,
// A = 16,848, C = 3: 4.8 us), and the anchors and boxes read (0.27 MB);
// the 16 M IoU and distance evaluations are ~0.5 GFLOP, nothing at 67
// TFLOP/s.  The time is the latency of the dependent slot rounds: each
// slot's choice needs the previous slot's claim.
//
// Design: one thread-block cluster an image, of up to 8 CTAs of 512
// threads (the cluster size and each CTA's slice of the anchors come from
// A: ops/anchor_match.plan).  Each thread owns the anchors tid, tid + 512,
// .. of its CTA's slice and keeps who claimed each in shared memory (a
// 16-bit slot, or none); it alone reads and writes those entries, so no
// barrier guards them.  A round is: every thread evaluates IoU and distance
// of the slot's box against its anchors (read through the L1, which holds
// the 34 KB slice from the first round on) and keeps two packed 64-bit keys,
// (ordered IoU, index) by max and (ordered distance, index) by min; warp
// shuffles, one CTA barrier and warp 0 reduce them to the CTA's pair, which
// warp 0 writes into its shared memory; one cluster barrier; then every
// warp reads the cluster's pairs through distributed shared memory and
// reduces them to the winner, and the thread that owns it marks it.  The
// keys are unique (the index is in them), so every CTA finds the same
// winner whatever the order of the reduction.  The pairs alternate between
// two buffers by round, so the one barrier a round also keeps a fast CTA
// from overwriting a pair a slow one has still to read.  A last cluster
// barrier keeps each CTA's shared memory alive while its peers may read
// it; then each thread writes its anchors' rows of the four targets.  So
// a round is one pass over ~4 anchors a thread, two short shuffle trees
// and two barriers, the images run their clusters in parallel, and the
// targets are written once, without a fill or scatter.  On an H100 80GB
// HBM3 (700 W), replayed from a CUDA graph at B = 20, G = 48 and 16,848
// anchors: 0.049 ms on the train cell's boxes (10 rounds in the slowest
// image) against 6.02 ms for the plain loop, 0.28 ms with 48 slots in
// every image; a round takes 4.5-5.8 us, above the 1-2 us its parts
// suggest, and the rounds, not the 5 us of bytes, bind.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;  // ops/anchor_match.THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr uint16_t kNone = 0xFFFF;  // no slot claimed the anchor
constexpr int kSmemLimit = 232448;  // a CTA's shared memory on Hopper
constexpr uint64_t kNoMax = 0;      // below every IoU key
constexpr uint64_t kNoMin = ~0ull;  // above every distance key

struct Args {
  const float4* anchors;  // [A, 4] center format
  const float4* boxes;    // [B, G, 4] center format
  const void* labels;     // [B, G] int32 or int64
  const void* num_gt;     // [B] int32 or int64
  float* mask;            // [B, A]
  float4* deltas;         // [B, A, 4]
  float4* box_out;        // [B, A, 4]
  float* labels_out;      // [B, A, C]
  int G, A, C, slice;
  int labels64, num64;
};

__device__ __forceinline__ int64_t load_index(const void* p, int64_t i,
                                              int wide) {
  return wide ? __ldg(static_cast<const long long*>(p) + i)
              : (int64_t)__ldg(static_cast<const int*>(p) + i);
}

// torch.minimum, torch.maximum and clamp(min=0) on the card: a NaN operand
// is the result
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp0(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

// ops/boxes.py:batch_iou of anchor a against box b, op for op
__device__ __forceinline__ float iou(float4 a, float4 b) {
  const float ahw = __fmul_rn(0.5f, a.z), ahh = __fmul_rn(0.5f, a.w);
  const float bhw = __fmul_rn(0.5f, b.z), bhh = __fmul_rn(0.5f, b.w);
  const float lr = clamp0(__fsub_rn(
      nan_min(__fadd_rn(a.x, ahw), __fadd_rn(b.x, bhw)),
      nan_max(__fsub_rn(a.x, ahw), __fsub_rn(b.x, bhw))));
  const float tb = clamp0(__fsub_rn(
      nan_min(__fadd_rn(a.y, ahh), __fadd_rn(b.y, bhh)),
      nan_max(__fsub_rn(a.y, ahh), __fsub_rn(b.y, bhh))));
  const float inter = __fmul_rn(lr, tb);
  const float uni = __fsub_rn(__fadd_rn(__fmul_rn(a.z, a.w),
                                        __fmul_rn(b.z, b.w)), inter);
  return __fdiv_rn(inter, uni);
}

// torch.sum(torch.square(box - anchor), dim=-1), in torch's order
__device__ __forceinline__ float dist(float4 a, float4 b) {
  const float dx = __fsub_rn(b.x, a.x), dy = __fsub_rn(b.y, a.y);
  const float dw = __fsub_rn(b.z, a.z), dh = __fsub_rn(b.w, a.w);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dw, dw)),
                   __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dh, dh)));
}

// A float's bits mapped to an unsigned order (-inf lowest, +inf highest;
// -0 as +0, which torch's comparisons take as equal), NaN at `nan`.
__device__ __forceinline__ uint32_t ordered(float v, uint32_t nan) {
  if (v != v) return nan;
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Reduced by max: the largest IoU, then the largest index; NaN above all.
__device__ __forceinline__ uint64_t iou_key(float v, uint32_t i) {
  return (uint64_t)ordered(v, 0xFFFFFFFFu) << 32 | i;
}

// Reduced by min: the smallest distance, then the smallest index; NaN
// below all (no number maps to 0: -inf maps to 0x007FFFFF).
__device__ __forceinline__ uint64_t dist_key(float v, uint32_t i) {
  return (uint64_t)ordered(v, 0u) << 32 | i;
}

// The IoU key's value is above 0 (and no NaN)
__device__ __forceinline__ bool positive(uint64_t key) {
  const uint32_t o = (uint32_t)(key >> 32);
  return o > 0x80000000u && o != 0xFFFFFFFFu;
}

__device__ __forceinline__ void warp_reduce(uint64_t& best_iou,
                                            uint64_t& best_dist) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t i = __shfl_xor_sync(0xFFFFFFFFu, best_iou, off);
    const uint64_t d = __shfl_xor_sync(0xFFFFFFFFu, best_dist, off);
    best_iou = i > best_iou ? i : best_iou;
    best_dist = d < best_dist ? d : best_dist;
  }
}

__global__ void __launch_bounds__(kThreads)
    anchor_match_cluster(const Args p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int b = blockIdx.x / csize;
  const int base = rank * p.slice;
  const int n = max(0, min(p.slice, p.A - base));  // this CTA's anchors
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float4* anchors = p.anchors + base;
  const float4* boxes = p.boxes + (int64_t)b * p.G;

  extern __shared__ uint16_t owner[];  // [slice]: the claiming slot
  __shared__ uint64_t warp_keys[kWarps][2];
  __shared__ uint64_t cta_keys[2][2];  // this CTA's pair, by round parity

  for (int j = tid; j < n; j += kThreads) owner[j] = kNone;

  const int64_t valid = load_index(p.num_gt, b, p.num64);
  const int rounds = (int)(valid < 0 ? 0 : (valid > p.G ? p.G : valid));
  for (int g = 0; g < rounds; ++g) {
    const float4 box = __ldg(boxes + g);
    uint64_t best_iou = kNoMax, best_dist = kNoMin;
#pragma unroll 4
    for (int j = tid; j < n; j += kThreads) {
      const float4 a = __ldg(anchors + j);
      const bool claimed = owner[j] != kNone;
      const uint64_t ki =
          iou_key(claimed ? -1.0f : iou(a, box), (uint32_t)(base + j));
      const uint64_t kd =
          dist_key(claimed ? INFINITY : dist(a, box), (uint32_t)(base + j));
      best_iou = ki > best_iou ? ki : best_iou;
      best_dist = kd < best_dist ? kd : best_dist;
    }
    warp_reduce(best_iou, best_dist);
    if (lane == 0) {
      warp_keys[warp][0] = best_iou;
      warp_keys[warp][1] = best_dist;
    }
    __syncthreads();
    if (warp == 0) {
      best_iou = lane < kWarps ? warp_keys[lane][0] : kNoMax;
      best_dist = lane < kWarps ? warp_keys[lane][1] : kNoMin;
      warp_reduce(best_iou, best_dist);
      if (lane == 0) {
        cta_keys[g & 1][0] = best_iou;
        cta_keys[g & 1][1] = best_dist;
      }
    }
    cluster.sync();
    best_iou = kNoMax, best_dist = kNoMin;
    if (lane < csize) {
      const uint64_t* peer = cluster.map_shared_rank(&cta_keys[g & 1][0],
                                                     (unsigned)lane);
      best_iou = peer[0], best_dist = peer[1];
    }
    warp_reduce(best_iou, best_dist);
    const int j = (int)(uint32_t)(positive(best_iou) ? best_iou : best_dist)
                  - base;
    if (j >= 0 && j < n && j % kThreads == tid) owner[j] = (uint16_t)g;
  }
  cluster.sync();  // no CTA leaves while a peer may read its pairs

  const int64_t row0 = (int64_t)b * p.A + base;
  for (int j = tid; j < n; j += kThreads) {
    const int64_t o = row0 + j;
    const int g = owner[j];
    float* lab = p.labels_out + o * p.C;
    if (g == kNone) {
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      p.mask[o] = 0.0f;
      p.deltas[o] = zero;
      p.box_out[o] = zero;
      for (int c = 0; c < p.C; ++c) lab[c] = 0.0f;
      continue;
    }
    const float4 box = __ldg(boxes + g), a = __ldg(anchors + j);
    p.mask[o] = 1.0f;
    p.deltas[o] = make_float4(__fdiv_rn(__fsub_rn(box.x, a.x), a.z),
                              __fdiv_rn(__fsub_rn(box.y, a.y), a.w),
                              logf(__fdiv_rn(box.z, a.z)),
                              logf(__fdiv_rn(box.w, a.w)));
    p.box_out[o] = box;
    const int64_t label = load_index(p.labels, (int64_t)b * p.G + g,
                                     p.labels64);
    for (int c = 0; c < p.C; ++c) lab[c] = label == c ? 1.0f : 0.0f;
  }
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

}  // namespace

extern "C" {

// One launch on `stream` of B clusters of `cluster` CTAs, each CTA taking
// `slice` anchors (the plan of ops/anchor_match.plan).  labels64 / num64:
// gt_labels / num_gt are int64 (1) or int32 (0).  anchors, boxes and the
// delta and box outputs must be 16-byte aligned.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a plan it does not take).
int sdt_anchor_match(const void* anchors, const void* boxes,
                     const void* labels, const void* num_gt, void* mask,
                     void* deltas, void* box_out, void* labels_out, int B,
                     int G, int A, int C, int labels64, int num64,
                     int cluster, int slice, void* stream) {
  const int64_t smem = 2 * (int64_t)slice;
  if (B < 1 || G < 1 || G >= kNone || A < 1 || C < 1 || cluster < 1 ||
      cluster > kMaxCluster || slice < 1 || (int64_t)slice * cluster < A ||
      (int64_t)slice * (cluster - 1) >= A || smem > kSmemLimit ||
      (int64_t)B * cluster > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(anchors) || !aligned16(boxes) || !aligned16(deltas) ||
      !aligned16(box_out))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        anchor_match_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const Args args{static_cast<const float4*>(anchors),
                  static_cast<const float4*>(boxes), labels, num_gt,
                  static_cast<float*>(mask), static_cast<float4*>(deltas),
                  static_cast<float4*>(box_out),
                  static_cast<float*>(labels_out), G, A, C, slice, labels64,
                  num64};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(B * cluster));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = (size_t)smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, anchor_match_cluster, args);
}

const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
