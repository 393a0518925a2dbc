// Fused segmentation-loss forward: every sum the losses and f_score need, in
// one pass over the logits, then the loss and f_score themselves.
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/losses_seg_pallas.py::
// _seg_sums_pallas (kernel _seg_loss_fwd_kernel).  Per pixel: log-softmax,
// class-weighted NLL, the focal term; per class: tp, sum p, sum t,
// thresholded tp and sum pred.  Output, one f32 buffer: rows[blocks][W] (a
// CTA's partial sums), sums[W] = [ce_num, ce_den, focal_sum, npix, tp[C],
// sum_p[C], sum_t[C], tp_f[C], sum_pred[C]] (W = 4 + 5*C), then the loss
// (focal or CE, plus dice) and f_score.
//
// What bounds it on the H100: bytes.  A pixel costs C*sizeof(T) + 4 bytes of
// traffic against ~C exp + ~15*C other operations, under the f32 ridge, but
// not by much: the per-pixel work has to stay lean for the copies to be the
// limit.  So one CTA an SM streams its tiles through a ring of bulk copies
// (seg_loss.cuh) filled by a producer warp, each consumer thread keeps its
// pixel, its probabilities and its per-class sums of p and pred in
// registers (C a template parameter), the target class's three sums in its
// own shared-memory bins, exp on the SFU, and no barrier holds the consumer
// warps in step.
//
// The TPU grid runs in order and accumulates into one block.  Here each CTA
// reduces its threads' sums in a fixed order (per value: the lanes' strided
// sums, then a butterfly) into its row, and the last CTA to finish (a
// ticket taken after a __threadfence) sums the rows in row order in f64,
// writes the sums, the loss and f_score, and resets the ticket.  So two runs give the same
// bits, a call is one launch with no memset, and it can be captured in a
// CUDA graph.  The ticket is one word of this library per device: two
// launches in flight at once (two streams) would share it, the last CTA of
// one could then reduce rows the other has not written, and both results
// would be wrong.  Calls are meant to follow one another on one stream, as
// the train step makes them.
#include "seg_loss.cuh"

namespace {

using namespace asy::seg;

// CTAs of the launch in flight that have written their row
__device__ unsigned int g_ticket = 0;

// 2^x on the SFU: ex2.approx, relative error ~2^-22 near 0 (denormal
// results flush to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// A thread's sums: the scalars and, per class, sum p and sum pred in
// registers.  tp, sum t and tp_f change at the target's class only, so they
// sit in shared memory, bins[(q * C + class) * threads + thread] (q: tp, t,
// tp_f), one read-modify-write each a pixel instead of C predicated adds;
// thread t's bins are its own, in bank t % 32.
template <int kN>
struct Acc {
  float scal[kNScal];                             // ce_num, ce_den, focal, npix
  float sp[kN], spr[kN];
};

// One pixel: v[0..C) its logits, l_t its target's logit (0 without one).
// exp is 2^((l - max) * log2 e) on the SFU and log is __logf: within the
// tolerances of the twin (relative 1e-5 on the sums in f32; a probability
// at the threshold may land on the other side), at a third of the
// instructions of expf/logf.
template <int kThr, int kN>
__device__ __forceinline__ void accumulate(Acc<kN>& a, float* bins, float (&v)[kN], float l_t,
                                           int C, int tgt, const float* w_sm, const Hyper& h) {
  // parity: a target outside [0, C) (the ignore class is C) matches no class
  const bool has = tgt >= 0 && tgt < C;
  const float w_t = has ? w_sm[tgt] : 0.0f;
  float mx = v[0];
#pragma unroll
  for (int k = 1; k < kN; ++k)
    if (k < C) mx = fmaxf(mx, v[k]);
  const float m2 = mx * kLog2e;
  float ssum = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k < C) {
      v[k] = exp2_fast(fmaf(v[k], kLog2e, -m2));
      ssum += v[k];
    }
  }
  const float inv = __frcp_rn(ssum);
  // lse - l_t and 1 - pt are >= 0; the SFU's log and exp may miss by an ulp
  // across 0 where they vanish (a pixel sure of its target), which a focal
  // gamma < 1 would turn into NaN: clamped
  const float nll = w_t * fmaxf(mx + __logf(ssum) - l_t, 0.0f);
  // parity: the class weight sits inside the focal exponent
  // (logpt = -w_t * nll_unweighted), and ignored pixels (logpt = 0, pt = 1)
  // add 0 here but are counted in npix, the focal denominator
  const float logpt = -nll;
  const float om = fmaxf(1.0f - exp2_fast(logpt * kLog2e), 0.0f);
  a.scal[kCeNum] += nll;
  a.scal[kCeDen] += w_t;
  a.scal[kFocal] += -focal_pow(om, h.gamma) * (h.alpha * logpt);
  a.scal[kNpix] += 1.0f;
  // parity: ignored pixels match no class, yet their probabilities still
  // add to sum_p and sum_pred; the threshold compare is strict
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k < C) {
      const float p = v[k] * inv;
      a.sp[k] += p;
      a.spr[k] += p > h.threshold ? 1.0f : 0.0f;
    }
  }
  if (has) {      // the target's probability: the same bits as v[tgt] * inv
    const float p = exp2_fast(fmaf(l_t, kLog2e, -m2)) * inv;
    float* b = bins + tgt * kThr + threadIdx.x;
    b[0] += p;
    b[C * kThr] += 1.0f;
    b[2 * C * kThr] += p > h.threshold ? 1.0f : 0.0f;
  }
}

// Shared memory: the ring's full and empty mbarriers, class weights, the
// bins, then the ring (reused by the reductions once the ring is drained)
constexpr int kHeader = 16 * kMaxStages + 4 * kMaxClasses;

// Consumer threads of a CTA (and pixels of a tile): one CTA an SM of 768 at
// C = 9, where three CTAs of 256 on one SM ended far apart (the warp
// schedulers do not share an SM evenly between CTAs, and the sums cannot
// move work between CTAs without changing their bits); 256 on the generic
// path, whose register arrays allow no more.  A 32-thread producer warp
// comes on top: it refills a slot as soon as every consumer warp has read
// it (the slot's empty mbarrier), so the consumer warps never wait for one
// another, where a CTA-wide barrier a tile held 24 warps in step.
constexpr int kWideThreads = 768, kProducer = 32;
__host__ __device__ constexpr int sums_threads(int kC) { return kC ? kWideThreads : kTile; }
// The ring's budget of shared memory: the wide CTA has its SM alone
__host__ __device__ constexpr int sums_ring_budget(int kC) { return kC ? 96 << 10 : kRingBytes; }
__host__ __device__ inline int bins_bytes(int C, int threads) { return 3 * C * threads * 4; }

template <typename T, int kC, bool kRound>
__global__ void __launch_bounds__(sums_threads(kC) + kProducer, 1)
seg_loss_sums_kernel(const T* __restrict__ x, const int* __restrict__ target,
                     const float* __restrict__ weights, float* __restrict__ rows,
                     float* __restrict__ sums, float* __restrict__ scal, int npix, int c_rt,
                     Hyper h, int stages, int bulk) {
  constexpr int kN = kC ? kC : kMaxClasses;
  constexpr int kThr = sums_threads(kC);
  const int C = kC ? kC : c_rt;
  const int W = kNScal + 5 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* w_sm = reinterpret_cast<float*>(smem + 16 * kMaxStages);
  float* bins = reinterpret_cast<float*>(smem + kHeader);
  unsigned char* ring = smem + kHeader + bins_bytes(C, kThr);
  const int xbytes = kThr * C * (int)sizeof(T), sbytes = xbytes + kThr * 4;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool consumer = tid < kThr;
  const Tiles tiles(npix, bulk, kThr);

  load_weights(w_sm, weights, C);
  if (consumer)
    for (int i = 0; i < 3 * C; ++i) bins[i * kThr + tid] = 0.0f;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThr / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  Acc<kN> a = {};
  if (!consumer) {
    // the producer: tile j into slot j % stages once tile j - stages has
    // been read by every consumer warp
    if (tid == kThr) {
      for (int j = 0; tiles.ring(j) >= 0; ++j) {
        const int s = j % stages, t = tiles.ring(j);
        if (j >= stages) mbar_wait(&empty[s], (j / stages - 1) & 1);
        unsigned char* slot = ring + s * sbytes;
        mbar_expect_tx(&full[s], sbytes);
        bulk_load(slot, x + (size_t)t * kThr * C, xbytes, &full[s]);
        bulk_load(slot + xbytes, target + (size_t)t * kThr, kThr * 4, &full[s]);
      }
    }
  } else {
    for (int j = 0; tiles.ring(j) >= 0; ++j) {
      const int s = j % stages;
      const unsigned char* slot = ring + s * sbytes;
      mbar_wait(&full[s], (j / stages) & 1);
      const T* px = reinterpret_cast<const T*>(slot) + tid * C;
      const int tgt = reinterpret_cast<const int*>(slot + xbytes)[tid];
      float v[kN];
      load_pixel<T, kRound>(v, px, C);
      const float l_t = tgt >= 0 && tgt < C ? load_logit<T, kRound>(px + tgt) : 0.0f;
      __syncwarp();                       // the warp has read its pixels: one arrival
      if (lane == 0) mbar_arrive(&empty[s]);
      accumulate<kThr>(a, bins, v, l_t, C, tgt, w_sm, h);
    }
    for (int t = tiles.scalar_start(); t < tiles.ntiles; t += gridDim.x) {
      const int p = t * kThr + tid;
      if (p < npix) {
        const T* px = x + (size_t)p * C;
        const int tgt = target[p];
        float v[kN];
        load_pixel<T, kRound>(v, px, C);
        const float l_t = tgt >= 0 && tgt < C ? load_logit<T, kRound>(px + tgt) : 0.0f;
        accumulate<kThr>(a, bins, v, l_t, C, tgt, w_sm, h);
      }
    }
  }

  // the CTA's row, in a fixed order.  Each value's per-thread terms sit in
  // a shared-memory row (the bins already; the register sums are written to
  // the drained ring, as many rows at a time as it holds): warp w takes
  // values w, w + kThr / 32, ..., its lane l adds terms l, l + 32, ... in
  // order, and a butterfly adds the lanes: one butterfly a value for the
  // CTA, where one a value and warp made the shuffles the reduction's
  // bottleneck.
  float* regs = reinterpret_cast<float*>(ring);   // [cap][kThr] register sums
  const int nreg = kNScal + 2 * C;
  const int cap = stages * sbytes / (kThr * 4);
  // the shared-memory row of value q of the row: a register row r (scalars,
  // then sum p, then sum pred) or a bins row
  auto source = [&](int q, int& r) -> const float* {
    const int k = (q - kNScal) % C, part = q < kNScal ? -1 : (q - kNScal) / C;
    r = q < kNScal ? q : (part == 1 ? kNScal + k : (part == 4 ? kNScal + C + k : -1));
    return r >= 0 ? nullptr : bins + ((part == 0 ? 0 : (part == 2 ? C : 2 * C)) + k) * kThr;
  };
  auto reduce = [&](const float* row, int q) {
    float val = 0.0f;
#pragma unroll
    for (int i = 0; i < kThr / 32; ++i) val += row[i * 32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) val += __shfl_xor_sync(0xffffffffu, val, o);
    if (lane == 0) rows[(size_t)blockIdx.x * W + q] = val;
  };
  __syncthreads();                        // the ring is drained; the bins are final
  for (int r0 = 0; r0 < nreg; r0 += cap) {
    auto put = [&](int r, float val) {
      if (consumer && r >= r0 && r < r0 + cap) regs[(r - r0) * kThr + tid] = val;
    };
#pragma unroll
    for (int i = 0; i < kNScal; ++i) put(i, a.scal[i]);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (k < C) {
        put(kNScal + k, a.sp[k]);
        put(kNScal + C + k, a.spr[k]);
      }
    }
    __syncthreads();
    for (int q = warp; consumer && q < W; q += kThr / 32) {
      int r;
      const float* row = source(q, r);
      if (row && r0 == 0)
        reduce(row, q);
      else if (!row && r >= r0 && r < r0 + cap)
        reduce(regs + (r - r0) * kThr, q);
    }
    __syncthreads();
  }

  // the last CTA to finish sums the rows
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // column col over rows q, q + Q, ... in f64 (Q row slices; a thread's
  // loads 16 at a time in flight, then added in row order), then the slices
  // in order
  const int Q = W < kThr ? kThr / W : 1, G = gridDim.x;
  double* dred = reinterpret_cast<double*>(ring);  // [Q][W]
  float* f = reinterpret_cast<float*>(dred + Q * W);  // [W] the f32 sums
  if (tid < Q * W) {
    const int q = tid / W, col = tid % W;
    double s = 0.0;
    for (int r0 = q; r0 < G; r0 += 16 * Q) {
      float part[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = r0 + i * Q;
        part[i] = r < G ? __ldcg(rows + (size_t)r * W + col) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) s += (double)part[i];
    }
    dred[q * W + col] = s;
  }
  __syncthreads();
  for (int col = tid; col < W; col += kThr) {
    double s = 0.0;
    for (int q = 0; q < Q; ++q) s += dred[q * W + col];
    f[col] = (float)s;
    sums[col] = (float)s;
  }
  __syncthreads();
  if (tid == 0) {
    g_ticket = 0;
    // the losses from the f32 sums (ops/losses_seg_fused.py::_losses_from_acc)
    const float *tp = f + kNScal, *sp = tp + C, *st = sp + C, *tpf = st + C, *spr = tpf + C;
    float loss = h.use_focal ? f[kFocal] / f[kNpix] : f[kCeNum] / fmaxf(f[kCeDen], 1e-12f);
    if (h.use_dice) {
      const float b2 = h.dice_beta * h.dice_beta;
      float m = 0.0f;
      for (int k = 0; k < C; ++k)
        m += ((1.0f + b2) * tp[k] + h.dice_smooth) / (b2 * st[k] + sp[k] + h.dice_smooth);
      loss = loss + 1.0f - m / (float)C;
    }
    const float b2f = h.fs_beta * h.fs_beta;
    float m = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float uf = (1.0f + b2f) * tpf[k] + h.fs_smooth;
      m += uf / (b2f * (st[k] - tpf[k]) + (spr[k] - tpf[k]) + uf);
    }
    scal[0] = loss;
    scal[1] = m / (float)C;
  }
}

template <typename T, int kC, bool kRound>
const void* kernel_ptr() {
  return (const void*)seg_loss_sums_kernel<T, kC, kRound>;
}

const void* pick(int esz, int C, int round_bf16) {
  if (esz == 2) return C == 9 ? kernel_ptr<__nv_bfloat16, 9, false>()
                              : kernel_ptr<__nv_bfloat16, 0, false>();
  if (round_bf16) return C == 9 ? kernel_ptr<float, 9, true>() : kernel_ptr<float, 0, true>();
  return C == 9 ? kernel_ptr<float, 9, false>() : kernel_ptr<float, 0, false>();
}

int threads_for(int C) { return C == 9 ? sums_threads(9) : sums_threads(0); }

int stages_for(int C, int esz) {
  const int thr = threads_for(C);
  return ring_stages(C, esz, thr, C == 9 ? sums_ring_budget(9) : sums_ring_budget(0));
}

size_t smem_bytes(int C, int esz) {
  const int thr = threads_for(C);
  return kHeader + bins_bytes(C, thr) + (size_t)stages_for(C, esz) * slot_bytes(C, esz, thr);
}

template <typename T>
int launch(const void* x, const int* target, const float* weights, float* out, int npix,
           int C, float alpha, float gamma, float threshold, int use_focal, int use_dice,
           float dice_beta, float dice_smooth, float fs_beta, float fs_smooth, int blocks,
           int round_bf16, void* stream) {
  constexpr int esz = (int)sizeof(T);
  if (npix <= 0 || C < 1 || C > kMaxClasses || blocks < 1 || (round_bf16 && esz == 2))
    return (int)cudaErrorInvalidValue;
  const void* kernel = pick(esz, C, round_bf16);
  const size_t smem = smem_bytes(C, esz);
  cudaError_t e = set_smem_carveout(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int W = kNScal + 5 * C;
  float* rows = out;
  float* sums = rows + (size_t)blocks * W;
  float* scal = sums + W;
  const Hyper h{alpha, gamma, threshold, use_focal, use_dice, dice_beta, dice_smooth,
                fs_beta, fs_smooth};
  const int stages = stages_for(C, esz);
  const int bulk = ((uintptr_t)x % 16 == 0) && ((uintptr_t)target % 16 == 0);
  const T* xt = (const T*)x;
  void* args[] = {(void*)&xt, (void*)&target, (void*)&weights, (void*)&rows, (void*)&sums,
                  (void*)&scal, (void*)&npix, (void*)&C, (void*)&h, (void*)&stages,
                  (void*)&bulk};
  e = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads_for(C) + kProducer), args, smem,
                       (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();    // read (and cleared) either way
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

// out: rows[blocks][4 + 5*C] | sums[4 + 5*C] | loss, f_score (f32).  weights
// may be null (every class 1).  round_bf16 (f32 logits only): round each
// logit to bf16 on load, the bf16 path's values.
int seg_loss_sums_bf16(const void* x, const int* target, const float* weights, float* out,
                       int npix, int C, float alpha, float gamma, float threshold,
                       int use_focal, int use_dice, float dice_beta, float dice_smooth,
                       float fs_beta, float fs_smooth, int blocks, int round_bf16,
                       void* stream) {
  return launch<__nv_bfloat16>(x, target, weights, out, npix, C, alpha, gamma, threshold,
                               use_focal, use_dice, dice_beta, dice_smooth, fs_beta, fs_smooth,
                               blocks, round_bf16, stream);
}

int seg_loss_sums_f32(const void* x, const int* target, const float* weights, float* out,
                      int npix, int C, float alpha, float gamma, float threshold, int use_focal,
                      int use_dice, float dice_beta, float dice_smooth, float fs_beta,
                      float fs_smooth, int blocks, int round_bf16, void* stream) {
  return launch<float>(x, target, weights, out, npix, C, alpha, gamma, threshold, use_focal,
                       use_dice, dice_beta, dice_smooth, fs_beta, fs_smooth, blocks, round_bf16,
                       stream);
}

// The kernel for C classes of esz-byte logits: out = [dynamic shared memory
// bytes, CTAs per SM, registers per thread, ring slots, threads per CTA]
int seg_loss_sums_info(int esz, int C, int round_bf16, int* out) {
  if ((esz != 2 && esz != 4) || C < 1 || C > kMaxClasses) return (int)cudaErrorInvalidValue;
  const void* kernel = pick(esz, C, round_bf16 && esz == 4);
  const size_t smem = smem_bytes(C, esz);
  cudaError_t e = set_smem_carveout(kernel, smem);
  int per_sm = 0;
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads_for(C) + kProducer, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)smem;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = stages_for(C, esz);
  out[4] = threads_for(C) + kProducer;
  return 0;
}

}  // extern "C"
