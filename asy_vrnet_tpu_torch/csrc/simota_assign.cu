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
//      the centre), per class log(p) and log(1-p) of
//      p = sqrt(sigmoid(cls) * sigmoid(obj)) with the -100 clamp, and from
//      them the class cost (the BCE against a one-hot class, summed in
//      class order) for each class a GT may have, written class-major to
//      scratch: a pair's cost then reads one value.  Zeroes the per-anchor
//      pick counters and the image's foreground count.
//   2. rows, one block of 256 threads per (image, GT), in one pass: each
//      thread sweeps its anchors (a = tid, tid + 256, ...) once, 4 at a
//      time (their loads in flight together), forms each IoU and cost and
//      keeps two sorted lists in registers: its kK largest candidate IoUs
//      (values only: equal ones sum alike) and its kK lowest (cost,
//      anchor) pairs, kK the first of 4, 8, 12, 16 that holds k.  Each warp
//      merges its 32 lanes' lists by shuffles (k rounds of a warp arg-best,
//      no block barrier), then one warp merges the 8 warps' lists.  The
//      merged IoUs, added in descending order, give dynamic k; the first
//      dynamic-k of the merged costs are the picks.  A pick is recorded
//      with integer atomics on the anchor: a counter, and the maximum of
//      (GT index + 1), which is the picking GT when the counter ends at 1.
//   3. resolve, one thread per (image, anchor): no pick -> background; one
//      pick -> that GT; several -> the warp recomputes the anchor's cost
//      column over the valid GTs, a lane a GT, and keeps the first minimum
//      (value, then GT index).  Writes fg (u8), matched
//      GT (i64), IoU, and counts the image's foreground anchors with
//      __syncthreads_count and integer atomics: the image's last block (a
//      ticket taken after a __threadfence) writes num_fg as f32.
// What bounds it on the H100: operations (f32 on CUDA cores, ~1 GFLOP at
// batch 16 and 100 valid GTs an image), bytes are negligible (inputs +
// scratch ~5 MB).  What holds it back is latency: a row is one block, and
// its sweep's loads and its merges run in sequence; the design keeps them
// to one sweep and one merge, with no block-wide reduction per pick.
//
// Inputs are read where the loss has them: the predictions through their
// batch and row strides (views of one (B, A, 5 + C) tensor), gt_classes as
// int32 or int64, gt_valid as bytes (bool or uint8).
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
constexpr int kMaxK = 16;               // the longest candidate list a row keeps
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr float kBig = 1e9f;            // replaces data-dependent gathers
constexpr float kCenterPenalty = 1e5f;  // soft centre constraint of the reference

// Where the inputs lie.  Strides are in elements.
struct In {
  const float *boxes, *cls, *obj;     // predictions, f32
  long long box_b, box_a, cls_b, cls_a, obj_b, obj_a;
  const float* gt_boxes;              // (B, G, 4) contiguous
  const void* gt_classes;             // (B, G) int32 or int64
  const uint8_t* gt_valid;            // (B, G) bytes
  const float *grids, *strides;       // (A, 2), (A,)
  int cls64;                          // gt_classes is int64
};

struct Gt {
  float cx, cy, w, h;
  int cls;
  int valid;
};

__device__ __forceinline__ Gt load_gt(const In& in, int b, int G, int i) {
  const size_t bi = (size_t)b * G + i;
  Gt g;
  g.cx = in.gt_boxes[bi * 4 + 0];
  g.cy = in.gt_boxes[bi * 4 + 1];
  g.w = in.gt_boxes[bi * 4 + 2];
  g.h = in.gt_boxes[bi * 4 + 3];
  g.cls = in.cls64 ? (int)static_cast<const long long*>(in.gt_classes)[bi]
                   : static_cast<const int*>(in.gt_classes)[bi];
  g.valid = in.gt_valid[bi] != 0;
  return g;
}

__device__ __forceinline__ const float* pred_box(const In& in, int b, int a) {
  return in.boxes + b * in.box_b + a * in.box_a;
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
// cls: this image's [C + 1][A] class costs from prep (row C: a class
// outside [0, C)).
__device__ __forceinline__ float pair_cost(const Gt& g, float iou, float cx, float cy,
                                           float r, bool fg_pre,
                                           const float* __restrict__ cls, int a, int A,
                                           int C) {
  const float cls_cost = cls[(g.cls >= 0 && g.cls < C ? g.cls : C) * A + a];
  const float iou_cost = -logf(iou + 1e-8f);
  const bool both = g.valid && in_box(g, cx, cy) && in_center(g, cx, cy, r);
  const bool invalid = !fg_pre || !g.valid;
  return cls_cost + 3.0f * iou_cost + kCenterPenalty * (both ? 0.0f : 1.0f) +
         kBig * (invalid ? 1.0f : 0.0f);
}

// Scratch and outputs of one call (the wrapper carves them from one buffer).
struct Out {
  uint8_t* fg_pre;  // [B][A] scratch
  float* cls_cost;  // [B][C + 1][A] scratch: class costs
  int* picks;       // [B][A][2] scratch: count, max(GT + 1)
  int* counts;      // [B][2] scratch: foreground anchors, finished blocks
  int* dynamic_ks;  // [B][G]
  uint8_t* fg;      // [B][A]
  long long* matched;  // [B][A]
  float* pred_iou;  // [B][A]
  float* num_fg;    // [B]
};

// ---- 1. prep -------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
simota_prep_kernel(In in, Out out, int A, int G, int C, float center_radius) {
  extern __shared__ float4 smem4[];
  Gt* gts = reinterpret_cast<Gt*>(smem4);
  float* lg = reinterpret_cast<float*>(gts + G) + threadIdx.x;  // [2C][kThreads]
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < G; i += kThreads) gts[i] = load_gt(in, b, G, i);
  if (blockIdx.x == 0 && threadIdx.x < 2) out.counts[b * 2 + threadIdx.x] = 0;
  __syncthreads();
  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= A) return;
  const float s = in.strides[a];
  const float cx = (in.grids[a * 2] + 0.5f) * s, cy = (in.grids[a * 2 + 1] + 0.5f) * s;
  const float r = center_radius * s;
  bool pre = false;
  for (int i = 0; i < G; ++i)
    pre = pre || (gts[i].valid && (in_box(gts[i], cx, cy) || in_center(gts[i], cx, cy, r)));
  const size_t ba = (size_t)b * A + a;
  out.fg_pre[ba] = pre ? 1 : 0;
  out.picks[ba * 2] = 0;
  out.picks[ba * 2 + 1] = 0;
  const float obj_sig = sigmoidf(in.obj[b * in.obj_b + a * in.obj_a]);
  const float* cl = in.cls + b * in.cls_b + a * in.cls_a;
  for (int ci = 0; ci < C; ++ci) {
    const float p = sqrtf(sigmoidf(cl[ci]) * obj_sig);
    lg[(2 * ci) * kThreads] = fmaxf(logf(p), -100.0f);
    lg[(2 * ci + 1) * kThreads] = fmaxf(log1pf(-p), -100.0f);
  }
  // the BCE against each one-hot class gc (row C: none), summed in class order
  float* cost = out.cls_cost + (size_t)b * (C + 1) * A + a;
  for (int gc = 0; gc <= C; ++gc) {
    float c = 0.0f;
    for (int ci = 0; ci < C; ++ci) c = c - lg[(2 * ci + (ci == gc ? 0 : 1)) * kThreads];
    cost[(size_t)gc * A] = c;
  }
}

// ---- 2. rows -------------------------------------------------------------
// A sorted list of kK values in registers, best first: kMax orders them
// descending, else ascending; kIdx keeps each value's anchor, and equal
// values then stand in anchor order.  Empty slots hold the worst value
// (and anchor A).  Selects, no branches: the slots stay in registers.
template <int kK, bool kMax, bool kIdx>
struct List {
  float v[kK];
  int i[kIdx ? kK : 1];
  static constexpr float kEmpty = kMax ? -FLT_MAX : FLT_MAX;

  __device__ __forceinline__ static bool before(float a, float b) { return kMax ? a > b : a < b; }
  __device__ __forceinline__ void clear(int A) {
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      v[j] = kEmpty;
      if constexpr (kIdx) i[j] = A;
    }
  }
  // Inserts (x, a) for an anchor a above every anchor already held (the
  // sweep is ascending), so an equal value goes behind: strict compares.
  __device__ __forceinline__ void push(float x, int a) {
    if (!before(x, v[kK - 1])) return;  // also drops NaN
    bool moved = false;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      const bool take = moved || before(x, v[j]);
      const float tv = v[j];
      v[j] = take ? x : tv;
      x = take ? tv : x;
      if constexpr (kIdx) {
        const int ti = i[j];
        i[j] = take ? a : ti;
        a = take ? ti : a;
      }
      moved = take;
    }
  }
  // Drops the head where `drop` holds (the others move up one slot).
  __device__ __forceinline__ void pop(bool drop, int A) {
#pragma unroll
    for (int j = 0; j + 1 < kK; ++j) {
      v[j] = drop ? v[j + 1] : v[j];
      if constexpr (kIdx) i[j] = drop ? i[j + 1] : i[j];
    }
    v[kK - 1] = drop ? kEmpty : v[kK - 1];
    if constexpr (kIdx) i[kK - 1] = drop ? A : i[kK - 1];
  }
};

// The best (value, index) over the lanes whose xor distance is below
// `span`: kMax the largest value, else the smallest, the lower index among
// equal values; every such lane gets the same pair.
template <bool kMax>
__device__ __forceinline__ void lanes_best(float& v, int& i, int span) {
  for (int o = span / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if ((kMax ? ov > v : ov < v) || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// The warp's k best of its lanes' lists, best first, into tv[0..k) (the
// IoUs: values only, ties broken by lane) and (lv, li)[0..k) (the costs):
// k rounds of a warp arg-best of the lanes' heads, the winning lane pops;
// the two lists' rounds run side by side.
template <int kK>
__device__ __forceinline__ void warp_merge(List<kK, true, false>& top,
                                           List<kK, false, true>& low, int k, int A, float* tv,
                                           float* lv, int* li) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < k; ++j) {
    float bv = top.v[0], cv = low.v[0];
    int bl = lane, ci = low.i[0];
    lanes_best<true>(bv, bl, 32);
    lanes_best<false>(cv, ci, 32);
    top.pop(bl == lane, A);
    low.pop(ci < A && low.i[0] == ci, A);
    if (lane == 0) {
      tv[j] = bv;
      lv[j] = cv;
      li[j] = ci;
    }
  }
}

// The k best of the kWarps warp lists by one warp, best first, the IoUs'
// (tv[w * kMaxK + j], values only, equal ones broken by list) and the
// costs' ((lv, li)[w * kMaxK + j]) side by side: lane w < kWarps walks list
// w.  Every lane gets the j-th of each in v[j] and (c[j], i[j]), j < k.
__device__ __forceinline__ void block_merge(const float* tv, const float* lv, const int* li,
                                            int k, int A, float (&v)[kMaxK],
                                            float (&c)[kMaxK], int (&i)[kMaxK]) {
  const int lane = threadIdx.x & 31;
  int p = 0, q = 0;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const bool hp = lane < kWarps && p < k, hq = lane < kWarps && q < k;
      float bv = hp ? tv[lane * kMaxK + p] : -FLT_MAX;
      float bc = hq ? lv[lane * kMaxK + q] : FLT_MAX;
      int bl = lane, bi = hq ? li[lane * kMaxK + q] : A;
      const int mine = bi;
      lanes_best<true>(bv, bl, 32);
      lanes_best<false>(bc, bi, 32);
      p += bl == lane;
      q += bi < A && mine == bi;
      v[j] = bv;
      c[j] = bc;
      i[j] = bi;
    }
  }
}

// Anchors a thread forms before it files them in its lists (their loads
// overlap).
constexpr int kSweep = 4;

// One block per (image, GT); blockIdx.x is the image, so the GT rows of one
// index are adjacent and the valid rows (padded first) start first.  kK:
// the lists' length, at least k.
template <int kK>
__global__ void __launch_bounds__(kThreads)
simota_rows_kernel(In in, Out out, int A, int G, int C, float center_radius, int k) {
  __shared__ float ious_v[kWarps * kMaxK], cost_v[kWarps * kMaxK];
  __shared__ int cost_i[kWarps * kMaxK];
  const int b = blockIdx.x, g = blockIdx.y, w = threadIdx.x >> 5;
  const Gt gt = load_gt(in, b, G, g);
  if (!gt.valid) {               // an invalid row picks nothing (cost >= 1e9)
    if (threadIdx.x == 0) out.dynamic_ks[b * G + g] = 0;
    return;
  }
  // one sweep, ascending per thread: its kK largest candidate IoUs and kK
  // lowest costs below the big-M (a cost >= 1e9 / 2 is never recorded)
  List<kK, true, false> top;
  List<kK, false, true> low;
  top.clear(A);
  low.clear(A);
  const float* cls = out.cls_cost + (size_t)b * (C + 1) * A;
  for (int a0 = threadIdx.x; a0 < A; a0 += kSweep * kThreads) {
    float iu[kSweep], co[kSweep];
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {  // past A: anchor A - 1 again, not filed
      const int a = min(a0 + u * kThreads, A - 1);
      const float s = in.strides[a];
      const float cx = (in.grids[a * 2] + 0.5f) * s, cy = (in.grids[a * 2 + 1] + 0.5f) * s;
      const bool pre = out.fg_pre[(size_t)b * A + a] != 0;
      const float iou = pair_iou(gt, pred_box(in, b, a));
      iu[u] = pre ? iou : 0.0f;
      co[u] = pair_cost(gt, iou, cx, cy, center_radius * s, pre, cls, a, A, C);
    }
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {
      const int a = a0 + u * kThreads;
      if (a < A) {
        top.push(iu[u], a);
        if (co[u] < kBig / 2) low.push(co[u], a);
      }
    }
  }
  warp_merge(top, low, k, A, ious_v + w * kMaxK, cost_v + w * kMaxK, cost_i + w * kMaxK);
  __syncthreads();
  if (w != 0) return;
  float v[kMaxK], cv[kMaxK];
  int ci[kMaxK];
  block_merge(ious_v, cost_v, cost_i, k, A, v, cv, ci);

  // dynamic k = clip(int(sum of the top-k candidate IoUs), 1, k), truncating;
  // the sum runs in descending order (equal values in any order: the same
  // sum).  Fewer than k non-NaN IoUs: the rest add 0 (a picked IoU is
  // zeroed and picked again); none at all: each of the k adds -FLT_MAX, as
  // an arg-max that finds nothing reports.  An IoU is never -FLT_MAX.
  const float none = v[0] > -FLT_MAX ? 0.0f : -FLT_MAX;
  float topk_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    if (j < k) topk_sum += v[j] > -FLT_MAX ? v[j] : none;
  const int dyn_k = min(max((int)topk_sum, 1), k);
  if (threadIdx.x == 0) out.dynamic_ks[b * G + g] = dyn_k;

  // the first dyn_k of the k lowest-cost anchors, lane j taking pick j
  const int lane = threadIdx.x & 31;
  int pick = A;
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    if (j == lane && j < dyn_k) pick = ci[j];
  if (pick < A) {
    int* pk = out.picks + ((size_t)b * A + pick) * 2;
    atomicAdd(pk, 1);
    atomicMax(pk + 1, g + 1);
  }
}

// The rows kernel with the shortest list that holds k (4, 8, 12 or 16).
inline void (*rows_kernel(int k))(In, Out, int, int, int, float, int) {
  return k <= 4 ? simota_rows_kernel<4> : k <= 8 ? simota_rows_kernel<8>
                : k <= 12 ? simota_rows_kernel<12> : simota_rows_kernel<kMaxK>;
}

// ---- 3. resolve ----------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
simota_resolve_kernel(In in, Out out, int A, int G, int C, float center_radius) {
  extern __shared__ float4 smem4[];
  Gt* gts = reinterpret_cast<Gt*>(smem4);
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < G; i += kThreads) gts[i] = load_gt(in, b, G, i);
  __syncthreads();
  const int a = blockIdx.x * kThreads + threadIdx.x;
  const size_t ba = (size_t)b * A + a;
  const int n = a < A ? out.picks[ba * 2] : 0;
  int best = 0;
  float iou = 0.0f;
  if (n == 1) {
    best = out.picks[ba * 2 + 1] - 1;
    iou = pair_iou(gts[best], pred_box(in, b, a));
  }
  // conflicts: an anchor keeps the first minimum-cost GT over all rows.  An
  // invalid row costs >= 1e9 and a row that picked the anchor < 1e9 / 2, so
  // only the valid rows can hold the minimum.  The warp takes its
  // conflicting anchors one at a time, its lanes splitting the rows.
  const int lane = threadIdx.x & 31;
  for (unsigned todo = __ballot_sync(0xffffffffu, n > 1); todo; todo &= todo - 1) {
    const int src = __ffs(todo) - 1;
    const int ac = __shfl_sync(0xffffffffu, a, src);
    const float s = in.strides[ac];
    const float cx = (in.grids[ac * 2] + 0.5f) * s, cy = (in.grids[ac * 2 + 1] + 0.5f) * s;
    const bool pre = out.fg_pre[(size_t)b * A + ac] != 0;
    const float* cls = out.cls_cost + (size_t)b * (C + 1) * A;
    const float* pb = pred_box(in, b, ac);
    float bc = FLT_MAX, bu = 0.0f;
    int bi = G;
    for (int i = lane; i < G; i += 32) {   // ascending: the first minimum stays
      if (!gts[i].valid) continue;
      const float u = pair_iou(gts[i], pb);
      const float c = pair_cost(gts[i], u, cx, cy, center_radius * s, pre, cls, ac, A, C);
      if (c < bc) { bc = c; bi = i; bu = u; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float oc = __shfl_xor_sync(0xffffffffu, bc, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const float ou = __shfl_xor_sync(0xffffffffu, bu, o);
      if (oc < bc || (oc == bc && oi < bi)) { bc = oc; bi = oi; bu = ou; }
    }
    if (lane == src && bi < G) {
      best = bi;
      iou = bu;
    }
  }
  if (a < A) {
    out.fg[ba] = n > 0 ? 1 : 0;
    out.matched[ba] = best;
    out.pred_iou[ba] = iou;
  }
  // the image's foreground count: integer sums, then its last block writes it
  const int fg_here = __syncthreads_count(n > 0);
  if (threadIdx.x == 0) {
    atomicAdd(out.counts + b * 2, fg_here);
    __threadfence();
    if (atomicAdd(out.counts + b * 2 + 1, 1) == (int)gridDim.x - 1)
      out.num_fg[b] = (float)atomicAdd(out.counts + b * 2, 0);
  }
}

}  // namespace

extern "C" {

// Predictions (f32): boxes (B, A, 4), cls (B, A, C), obj (B, A), each with
// its batch and anchor strides in elements (the last dimension contiguous);
// gt_boxes (B, G, 4) f32 contiguous; gt_classes (B, G) int32 (cls64 0) or
// int64 (cls64 1); gt_valid (B, G) bytes; grids (A, 2), strides (A,) f32.
// Scratch (caller-allocated): fg_pre [B][A] u8, cls_costs [B][C + 1][A]
// f32, picks [B][A][2] i32, counts [B][2] i32.  Outputs: dynamic_ks [B][G]
// i32 (0 for invalid GTs), fg [B][A] u8, matched [B][A] i64, pred_iou
// [B][A] f32, num_fg [B] f32.  candidate_k from 1 to 16.
int simota_assign_f32(const float* boxes, const float* cls, const float* obj,
                      long long box_b, long long box_a, long long cls_b, long long cls_a,
                      long long obj_b, long long obj_a, const float* gt_boxes,
                      const void* gt_classes, int cls64, const uint8_t* gt_valid,
                      const float* grids, const float* strides, uint8_t* fg_pre,
                      float* cls_costs, int* picks, int* counts, int* dynamic_ks, uint8_t* fg,
                      long long* matched, float* pred_iou, float* num_fg, int B, int A, int G,
                      int C, float center_radius, int candidate_k, void* stream) {
  if (B < 1 || A < 1 || G < 1 || C < 1 || candidate_k < 1 || candidate_k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const In in{boxes, cls, obj, box_b, box_a, cls_b, cls_a, obj_b, obj_a,
              gt_boxes, gt_classes, gt_valid, grids, strides, cls64};
  const Out out{fg_pre, cls_costs, picks, counts, dynamic_ks, fg, matched, pred_iou, num_fg};
  cudaStream_t st = (cudaStream_t)stream;
  const int k = candidate_k < A ? candidate_k : A;
  const dim3 per_anchor((A + kThreads - 1) / kThreads, B);
  const size_t gt_smem = sizeof(Gt) * (size_t)G;
  const size_t prep_smem = gt_smem + sizeof(float) * 2 * C * kThreads;
  cudaError_t e = cudaSuccess;  // above 48 KB a block must opt in (host calls: only then)
  if (prep_smem > kDefaultSmem) e = asy::set_smem(simota_prep_kernel, prep_smem);
  if (e == cudaSuccess && gt_smem > kDefaultSmem) e = asy::set_smem(simota_resolve_kernel, gt_smem);
  if (e != cudaSuccess) return (int)e;
  simota_prep_kernel<<<per_anchor, kThreads, prep_smem, st>>>(in, out, A, G, C,
                                                               center_radius);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rows_kernel(k)<<<dim3(B, G), kThreads, 0, st>>>(in, out, A, G, C, center_radius, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  simota_resolve_kernel<<<per_anchor, kThreads, gt_smem, st>>>(in, out, A, G, C,
                                                               center_radius);
  return (int)cudaGetLastError();
}

}  // extern "C"
