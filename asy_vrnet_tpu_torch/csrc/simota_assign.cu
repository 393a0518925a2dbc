// SimOTA dynamic label assignment for a batch of images, f32.
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/simota_pallas.py::_simota_pallas
// (kernel _simota_kernel): in-box and centre prior, pairwise IoU, BCE cost,
// dynamic k from the top-k IoUs, the k lowest-cost picks per ground truth
// (GT), and conflict resolution, with first-index ties throughout.
//
// The TPU kernel keeps ~13 (G, A) f32 planes of one image in its fast memory
// (29 MB at G = 100, A = 5376).  An SM has 227 KB, so the work is split by
// what each step reduces over, and no (G, A) plane ever exists:
//   1. prep, one thread per (image, anchor): the anchor's centre, the
//      foreground prefilter (any valid GT whose box or centre window holds
//      the centre), and per class log(p) and log(1-p) of
//      p = sqrt(sigmoid(cls) * sigmoid(obj)) with the -100 clamp, written
//      class-major to scratch; zeroes the per-anchor pick counters.
//   2. rows, one block per (image, GT): the GT's IoU and cost rows over all
//      anchors live in shared memory (8 bytes per anchor, 43 KB at A = 5376);
//      k rounds of block-wide (value, index) argmax give the top-k IoU sum
//      and dynamic k; up to dynamic-k rounds of argmin pick anchors.  A pick
//      is recorded with integer atomics on the anchor: a counter, and the
//      maximum of (GT index + 1), which is the picking GT when the counter
//      ends at 1.
//   3. resolve, one thread per (image, anchor): no pick -> background; one
//      pick -> that GT; several -> recompute the anchor's cost column over
//      all GTs and keep the first minimum.  Writes fg, matched GT, IoU.
// What bounds it on the H100: operations (f32 on CUDA cores, ~1 GFLOP at
// batch 16) and the latency of ~20 dependent block reductions per row; bytes
// are negligible (inputs + scratch ~5 MB).
//
// Ties decide results (adding 1e5 to a cost leaves an f32 ulp of 0.0078), so
// every reduction compares (value, index) pairs and keeps the lower index,
// the cost of a (GT, anchor) pair comes from one device function used by
// both the row and the resolve kernels, and the file is built with
// -fmad=false: the plain PyTorch version rounds after every multiply and
// add, and a contracted FMA would move near-ties.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e9f;            // replaces data-dependent gathers
constexpr float kCenterPenalty = 1e5f;  // soft centre constraint of the reference

struct Gt {
  float cx, cy, w, h;
  int cls;
  int valid;
};

__device__ __forceinline__ Gt load_gt(const float* gt_boxes, const int* gt_classes,
                                      const uint8_t* gt_valid, int i) {
  Gt g;
  g.cx = gt_boxes[i * 4 + 0];
  g.cy = gt_boxes[i * 4 + 1];
  g.w = gt_boxes[i * 4 + 2];
  g.h = gt_boxes[i * 4 + 3];
  g.cls = gt_classes[i];
  g.valid = gt_valid[i] != 0;
  return g;
}

__device__ __forceinline__ bool in_box(const Gt& g, float cx, float cy) {
  return cx > g.cx - 0.5f * g.w && cx < g.cx + 0.5f * g.w &&
         cy > g.cy - 0.5f * g.h && cy < g.cy + 0.5f * g.h;
}

__device__ __forceinline__ bool in_center(const Gt& g, float cx, float cy, float r) {
  return cx > g.cx - r && cx < g.cx + r && cy > g.cy - r && cy < g.cy + r;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// IoU of a valid GT with a predicted cxcywh box (0 for an invalid GT).
__device__ __forceinline__ float pair_iou(const Gt& g, const float* pb) {
  const float px = pb[0], py = pb[1], pw = pb[2], ph = pb[3];
  const float ixmin = fmaxf(g.cx - 0.5f * g.w, px - 0.5f * pw);
  const float ixmax = fminf(g.cx + 0.5f * g.w, px + 0.5f * pw);
  const float iymin = fmaxf(g.cy - 0.5f * g.h, py - 0.5f * ph);
  const float iymax = fminf(g.cy + 0.5f * g.h, py + 0.5f * ph);
  const float inter = fmaxf(ixmax - ixmin, 0.0f) * fmaxf(iymax - iymin, 0.0f);
  const float uni = g.w * g.h + pw * ph - inter;
  return g.valid ? inter / fmaxf(uni, 1e-12f) : 0.0f;
}

// Cost of assigning anchor `a` to GT `g`; the one place it is computed.
// logs: this image's [2*C][A] scratch, rows 2*ci = log p, 2*ci+1 = log(1-p).
__device__ __forceinline__ float pair_cost(const Gt& g, float iou, float cx, float cy,
                                           float r, bool fg_pre,
                                           const float* __restrict__ logs, int a, int A,
                                           int C) {
  float cls_cost = 0.0f;
  for (int ci = 0; ci < C; ++ci)     // BCE against the one-hot class, in class order
    cls_cost = cls_cost - (ci == g.cls ? logs[(2 * ci) * A + a]
                                       : logs[(2 * ci + 1) * A + a]);
  const float iou_cost = -logf(iou + 1e-8f);
  const bool both = g.valid && in_box(g, cx, cy) && in_center(g, cx, cy, r);
  const bool invalid = !fg_pre || !g.valid;
  return cls_cost + 3.0f * iou_cost + kCenterPenalty * (both ? 0.0f : 1.0f) +
         kBig * (invalid ? 1.0f : 0.0f);
}

// ---- 1. prep -------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
simota_prep_kernel(const float* __restrict__ cls_logits, const float* __restrict__ obj_logits,
                   const float* __restrict__ gt_boxes, const int* __restrict__ gt_classes,
                   const uint8_t* __restrict__ gt_valid, const float* __restrict__ grids,
                   const float* __restrict__ strides, uint8_t* __restrict__ fg_pre,
                   float* __restrict__ logs, int* __restrict__ picks, int A, int G, int C,
                   float center_radius) {
  extern __shared__ float4 smem4[];
  Gt* gts = reinterpret_cast<Gt*>(smem4);
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < G; i += kThreads)
    gts[i] = load_gt(gt_boxes + (size_t)b * G * 4, gt_classes + (size_t)b * G,
                     gt_valid + (size_t)b * G, i);
  __syncthreads();
  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= A) return;
  const float s = strides[a];
  const float cx = (grids[a * 2] + 0.5f) * s, cy = (grids[a * 2 + 1] + 0.5f) * s;
  const float r = center_radius * s;
  bool pre = false;
  for (int i = 0; i < G; ++i)
    pre = pre || (gts[i].valid && (in_box(gts[i], cx, cy) || in_center(gts[i], cx, cy, r)));
  const size_t ba = (size_t)b * A + a;
  fg_pre[ba] = pre ? 1 : 0;
  picks[ba * 2] = 0;
  picks[ba * 2 + 1] = 0;
  const float obj_sig = sigmoidf(obj_logits[ba]);
  float* lg = logs + (size_t)b * 2 * C * A;
  for (int ci = 0; ci < C; ++ci) {
    const float p = sqrtf(sigmoidf(cls_logits[ba * C + ci]) * obj_sig);
    lg[(2 * ci) * A + a] = fmaxf(logf(p), -100.0f);
    lg[(2 * ci + 1) * A + a] = fmaxf(log1pf(-p), -100.0f);
  }
}

// ---- 2. rows -------------------------------------------------------------
// Block-wide first-index arg-extremum of vals[0..A): kMax picks the maximum,
// else the minimum.  All threads return the same (value, index).
template <bool kMax>
__device__ __forceinline__ void block_arg(const float* vals, int A, float* red_v,
                                          int* red_i, float& out_v, int& out_i) {
  float bv = kMax ? -FLT_MAX : FLT_MAX;
  int bi = A;
  for (int a = threadIdx.x; a < A; a += kThreads) {   // ascending: first index wins
    const float v = vals[a];
    if (kMax ? v > bv : v < bv) { bv = v; bi = a; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if ((kMax ? ov > bv : ov < bv) || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) { red_v[warp] = bv; red_i[warp] = bi; }
  __syncthreads();
  bv = red_v[0];
  bi = red_i[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const float ov = red_v[w];
    const int oi = red_i[w];
    if ((kMax ? ov > bv : ov < bv) || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  __syncthreads();       // red_* may be rewritten by the next call
  out_v = bv;
  out_i = bi;
}

__global__ void __launch_bounds__(kThreads)
simota_rows_kernel(const float* __restrict__ pred_boxes, const float* __restrict__ gt_boxes,
                   const int* __restrict__ gt_classes, const uint8_t* __restrict__ gt_valid,
                   const float* __restrict__ grids, const float* __restrict__ strides,
                   const uint8_t* __restrict__ fg_pre, const float* __restrict__ logs,
                   int* __restrict__ picks, int* __restrict__ dynamic_ks, int A, int G,
                   int C, float center_radius, int k) {
  extern __shared__ float4 smem4[];
  float* ious = reinterpret_cast<float*>(smem4);   // [A] candidate IoUs
  float* cost = ious + A;                          // [A]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int g = blockIdx.x, b = blockIdx.y;
  const Gt gt = load_gt(gt_boxes + (size_t)b * G * 4, gt_classes + (size_t)b * G,
                        gt_valid + (size_t)b * G, g);
  if (!gt.valid) {               // an invalid row picks nothing (cost >= 1e9)
    if (threadIdx.x == 0) dynamic_ks[b * G + g] = 0;
    return;
  }
  const float* lg = logs + (size_t)b * 2 * C * A;
  for (int a = threadIdx.x; a < A; a += kThreads) {
    const size_t ba = (size_t)b * A + a;
    const float s = strides[a];
    const float cx = (grids[a * 2] + 0.5f) * s, cy = (grids[a * 2 + 1] + 0.5f) * s;
    const bool pre = fg_pre[ba] != 0;
    const float iou = pair_iou(gt, pred_boxes + ba * 4);
    ious[a] = pre ? iou : 0.0f;
    cost[a] = pair_cost(gt, iou, cx, cy, center_radius * s, pre, lg, a, A, C);
  }
  __syncthreads();

  // dynamic k = clip(int(sum of the top-k candidate IoUs), 1, k), truncating
  float topk_sum = 0.0f;
  for (int j = 0; j < k; ++j) {
    float m;
    int idx;
    block_arg<true>(ious, A, red_v, red_i, m, idx);
    if (threadIdx.x == 0 && idx < A) ious[idx] = 0.0f;   // idx == A: a row of NaNs
    topk_sum += m;
    __syncthreads();
  }
  const int dyn_k = min(max((int)topk_sum, 1), k);
  if (threadIdx.x == 0) dynamic_ks[b * G + g] = dyn_k;

  // the first dyn_k of the k lowest-cost anchors, skipping big-M costs
  for (int j = 0; j < dyn_k; ++j) {
    float m;
    int idx;
    block_arg<false>(cost, A, red_v, red_i, m, idx);
    if (threadIdx.x == 0 && idx < A) {
      cost[idx] = INFINITY;
      if (m < kBig / 2) {
        int* pk = picks + ((size_t)b * A + idx) * 2;
        atomicAdd(pk, 1);
        atomicMax(pk + 1, g + 1);
      }
    }
    __syncthreads();
  }
}

// ---- 3. resolve ----------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
simota_resolve_kernel(const float* __restrict__ pred_boxes, const float* __restrict__ gt_boxes,
                      const int* __restrict__ gt_classes, const uint8_t* __restrict__ gt_valid,
                      const float* __restrict__ grids, const float* __restrict__ strides,
                      const uint8_t* __restrict__ fg_pre, const float* __restrict__ logs,
                      const int* __restrict__ picks, uint8_t* __restrict__ fg,
                      int* __restrict__ matched, float* __restrict__ pred_iou, int A, int G,
                      int C, float center_radius) {
  extern __shared__ float4 smem4[];
  Gt* gts = reinterpret_cast<Gt*>(smem4);
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < G; i += kThreads)
    gts[i] = load_gt(gt_boxes + (size_t)b * G * 4, gt_classes + (size_t)b * G,
                     gt_valid + (size_t)b * G, i);
  __syncthreads();
  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= A) return;
  const size_t ba = (size_t)b * A + a;
  const int n = picks[ba * 2];
  int best = 0;
  float iou = 0.0f;
  if (n == 1) {
    best = picks[ba * 2 + 1] - 1;
    iou = pair_iou(gts[best], pred_boxes + ba * 4);
  } else if (n > 1) {
    // conflict: the anchor keeps the first minimum-cost GT over ALL rows
    const float s = strides[a];
    const float cx = (grids[a * 2] + 0.5f) * s, cy = (grids[a * 2 + 1] + 0.5f) * s;
    const bool pre = fg_pre[ba] != 0;
    const float* lg = logs + (size_t)b * 2 * C * A;
    float bc = FLT_MAX;
    for (int i = 0; i < G; ++i) {
      const float u = pair_iou(gts[i], pred_boxes + ba * 4);
      const float c = pair_cost(gts[i], u, cx, cy, center_radius * s, pre, lg, a, A, C);
      if (c < bc) { bc = c; best = i; iou = u; }
    }
  }
  fg[ba] = n > 0 ? 1 : 0;
  matched[ba] = best;
  pred_iou[ba] = iou;
}

}  // namespace

extern "C" {

// Scratch (caller-allocated): fg_pre [B][A] u8, logs [B][2C][A] f32,
// picks [B][A][2] i32.  Outputs: dynamic_ks [B][G] i32 (0 for invalid GTs),
// fg [B][A] u8, matched [B][A] i32, pred_iou [B][A] f32.
int simota_assign_f32(const float* pred_boxes, const float* cls_logits,
                      const float* obj_logits, const float* gt_boxes,
                      const int* gt_classes, const uint8_t* gt_valid, const float* grids,
                      const float* strides, uint8_t* fg_pre, float* logs, int* picks,
                      int* dynamic_ks, uint8_t* fg, int* matched, float* pred_iou, int B,
                      int A, int G, int C, float center_radius, int candidate_k,
                      void* stream) {
  if (B < 1 || A < 1 || G < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int k = candidate_k < A ? candidate_k : A;
  const dim3 per_anchor((A + kThreads - 1) / kThreads, B);
  const size_t gt_smem = sizeof(Gt) * (size_t)G;
  const size_t row_smem = sizeof(float) * 2 * (size_t)A;
  cudaError_t e = asy::set_smem(simota_prep_kernel, gt_smem);
  if (e == cudaSuccess) e = asy::set_smem(simota_rows_kernel, row_smem);
  if (e == cudaSuccess) e = asy::set_smem(simota_resolve_kernel, gt_smem);
  if (e != cudaSuccess) return (int)e;
  simota_prep_kernel<<<per_anchor, kThreads, gt_smem, st>>>(
      cls_logits, obj_logits, gt_boxes, gt_classes, gt_valid, grids, strides, fg_pre,
      logs, picks, A, G, C, center_radius);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  simota_rows_kernel<<<dim3(G, B), kThreads, row_smem, st>>>(
      pred_boxes, gt_boxes, gt_classes, gt_valid, grids, strides, fg_pre, logs, picks,
      dynamic_ks, A, G, C, center_radius, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  simota_resolve_kernel<<<per_anchor, kThreads, gt_smem, st>>>(
      pred_boxes, gt_boxes, gt_classes, gt_valid, grids, strides, fg_pre, logs, picks, fg,
      matched, pred_iou, A, G, C, center_radius);
  return (int)cudaGetLastError();
}

}  // extern "C"
