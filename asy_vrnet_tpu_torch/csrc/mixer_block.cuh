// Device code of the mixer half's forward that the forward kernel
// (mixer_block.cu, K2) and the full-remat backward (mixer_block_bwd.cu, K6r)
// both run.  K6r must differentiate the assignment K2 made, so both rebuild
// it with these functions: the same operations on the same values in the
// same order give the same bits.  Every rounding is written out
// (__fmul_rn, __fadd_rn, __fmaf_rn), so that no FMA contraction the
// compiler may choose in one kernel and not in the other moves a cosine.
// Every per-(token, head) result depends only on that head's columns: how
// many heads a block owns (K2's cluster split, K6r's head groups) changes
// nothing.
//
// Layouts (floats in shared memory), for a block that owns heads
// [h0, h0 + hpc), i.e. the Dg = hpc*D fc1/fc_v columns from col0 = h0*D:
//   cin  [M][C]    pooled normalised input, rounded to the working type
//   crep [M][Dg]   raw centers cin @ wf + bf (f32)
//   vc   [M][Dg]   value centers cin @ wv + bv (f32)
//   invc [M][hpc]  center inverse norms
//   cn   [M][Dg]   normalised centers, rounded
//   fs   [kChunk][DP] feat of a chunk of tokens, DP = Dg + kLanes
//
// feat runs on tensor cores (feat_chunk_mma) in bf16 when C % 16 == 0 and
// the head width D % 8 == 0 (so every head grouping's Dg = hpc*D is a
// multiple of 8 and K2, K6 and K6r take the same path), else as f32 FMA
// chains on CUDA cores (feat_chunk).  Either way the k order is fixed, so
// every caller gets the same bits for the same (token, column).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace asy {
namespace mix {

constexpr int kChunk = 32;  // tokens per sweep chunk
constexpr int kLanes = 8;   // lanes per (token, head) in the assignment
constexpr int kSplit = 4;   // fixed token splits of the aggregation

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// Whether feat runs on tensor cores (feat_chunk_mma) for T, C channels and
// head width D: the one test K2's and K6/K6r's launchers take, so that all
// three build the same bits (ops/kernels.py::mixer_feat_on_tensor_cores
// states it for the wrapper, and K2 refuses a wrapper that disagrees).
template <typename T>
inline bool feat_on_tc(int C, int D) {
  return std::is_same<T, __nv_bfloat16>::value && C % 16 == 0 && D % 8 == 0;
}

// A1. The pooled centers cin[m][c] = rnd(adaptive-average pool of the
// normalised input over proposal window m), in INPUT space, for the
// channels [part*C/parts, (part+1)*C/parts) (all with parts = 1: a cluster
// splits the channels over its CTAs and exchanges the rows).  `xin(n, c)`
// is the rounded normalised input of region token n.  The pooling spreads
// over the whole block: task (m, r, c) sums rows r, r + S, ... of window m
// (channel c fastest, so neighbouring threads read neighbouring bytes) into
// `scratch` (at least kChunk * (D + kLanes) floats), then the S partial
// sums of each (m, c) are added in order.  S follows from the geometry and
// the head width alone (not from how many heads or channels a block takes),
// so every caller gets the same bits.  Ends with a barrier.
template <typename T, typename XIN>
__device__ void pool_centers(XIN xin, int C, int D, int M, int rh, int rw, int ph, int pw,
                             float* scratch, float* cin, int part, int parts) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int S = max(1, min(min(rh / ph, 16), kChunk * (D + kLanes) / (M * C)));
  const int c0 = part * C / parts, cw = (part + 1) * C / parts - c0;
  for (int e = tid; e < M * S * cw; e += nth) {
    const int c = c0 + e % cw, r = (e / cw) % S, m = e / (cw * S);
    const int pi = m / pw, pj = m % pw;
    const int lh = (pi * rh) / ph, hh = ((pi + 1) * rh + ph - 1) / ph;
    const int lw = (pj * rw) / pw, hw = ((pj + 1) * rw + pw - 1) / pw;
    const float wgt = rnd<T>(__fmul_rn(1.f / (hh - lh), 1.f / (hw - lw)));
    float acc = 0.f;
    for (int i = lh + r; i < hh; i += S) {
#pragma unroll 4
      for (int j = lw; j < hw; ++j) acc = __fmaf_rn(wgt, xin(i * rw + j, c), acc);
    }
    if (S == 1)
      cin[m * C + c] = rnd<T>(acc);
    else
      scratch[e] = acc;
  }
  __syncthreads();
  if (S == 1) return;
  for (int e = tid; e < M * cw; e += nth) {
    const int m = e / cw, cc = e % cw;
    float acc = 0.f;
    for (int r = 0; r < S; ++r) acc = __fadd_rn(acc, scratch[(m * S + r) * cw + cc]);
    cin[m * C + c0 + cc] = rnd<T>(acc);
  }
  __syncthreads();
}

// The part (of `parts`, as pool_centers splits them) that pools channel c
__device__ __forceinline__ int pool_part(int c, int C, int parts) {
  return ((c + 1) * parts - 1) / C;
}

// A2. The region's centers for the block's columns from the pooled rows
// cin: the projections with the block's fc1/fc_v columns and the per-head
// inverse norms.  `wcol(c, j)` and `vcol(c, j)` are the fc1 and fc_v
// weights of column col0 + j; bf, bv point at column col0.  Ends with a
// barrier.
template <typename WCOL, typename VCOL>
__device__ void project_centers(WCOL wcol, VCOL vcol, const float* bf, const float* bv, int C,
                                int Dg, int D, int hpc, int M, const float* cin, float* crep,
                                float* vc, float* invc) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int e = tid; e < M * Dg; e += nth) {
    const int m = e / Dg, j = e % Dg;
    float af = 0.f, av = 0.f;
    for (int c = 0; c < C; ++c) {
      const float ci = cin[m * C + c];
      af = __fmaf_rn(ci, wcol(c, j), af);
      av = __fmaf_rn(ci, vcol(c, j), av);
    }
    crep[e] = __fadd_rn(af, bf[j]);
    vc[e] = __fadd_rn(av, bv[j]);
  }
  __syncthreads();
  for (int e = tid; e < M * hpc; e += nth) {
    const int m = e / hpc, hl = e % hpc;
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = crep[m * Dg + hl * D + d];
      s = __fmaf_rn(v, v, s);
    }
    invc[e] = rsqrtf(__fadd_rn(s, 1e-12f));
  }
  __syncthreads();
}

// cn = crep * invc per head, rounded (cn may alias crep).  Ends with a barrier.
template <typename T>
__device__ void normalise_centers(const float* crep, const float* invc, float* cn, int M,
                                  int Dg, int D, int hpc) {
  for (int e = threadIdx.x; e < M * Dg; e += blockDim.x)
    cn[e] = rnd<T>(__fmul_rn(crep[e], invc[(e / Dg) * hpc + (e % Dg) / D]));
  __syncthreads();
}

// B1 on CUDA cores: feat of the chunk's tokens for the block's columns,
// fs[t][j] = xn[t] . wcol(., j) + bf[j], with `xin(t, c4)` the float4 of
// rounded xn at token t, channels 4*c4 .. 4*c4 + 3 (C % 4 == 0).  Thread
// (tg, j) owns tokens tg + 8k.  The caller syncs after.
template <typename T, typename XIN, typename WCOL>
__device__ void feat_chunk(XIN xin, int C, WCOL wcol, const float* bf, int Dg, int DP,
                           float* fs) {
  const int C4 = C / 4;
  for (int e = threadIdx.x; e < 8 * Dg; e += blockDim.x) {
    const int j = e % Dg, tg = e / Dg;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c4 = 0; c4 < C4; ++c4) {
      const float w0 = wcol(4 * c4 + 0, j), wa = wcol(4 * c4 + 1, j);
      const float wb = wcol(4 * c4 + 2, j), wc = wcol(4 * c4 + 3, j);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 xv = xin(tg + 8 * k, c4);
        acc[k] = __fmaf_rn(xv.x, w0, __fmaf_rn(xv.y, wa, __fmaf_rn(xv.z, wb,
                           __fmaf_rn(xv.w, wc, acc[k]))));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) fs[(tg + 8 * k) * DP + j] = __fadd_rn(acc[k], bf[j]);
  }
}

// B1 on tensor cores (bf16, C % 16 == 0, Dg % 8 == 0): the chunk is two
// 16-token m-tiles by Dg/8 n-tiles; warp w takes tiles w, w + warps, ...,
// each a sum over the C/16 k-steps in order, then + bf in f32.
// `load_a(mt, kk, a)` gives the A fragment of tokens [16mt, 16mt + 16) and
// channels [16kk, 16kk + 16) of rounded xn; `load_b(nt, kk, b0, b1)` the B
// fragment of wf rows [16kk, 16kk + 16), columns [8nt, 8nt + 8).  The
// caller syncs after.
template <typename LA, typename LB>
__device__ void feat_chunk_mma(LA load_a, LB load_b, const float* bf, int C, int Dg, int DP,
                               float* fs) {
  const int lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int g = lane / 4, t = lane % 4;
  for (int i = threadIdx.x / 32; i < 2 * (Dg / 8); i += warps) {
    const int mt = i & 1, nt = i >> 1;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t a[4], b0, b1;
      load_a(mt, kk, a);
      load_b(nt, kk, b0, b1);
      mma16816(d, a, b0, b1);
    }
    const int j = nt * 8 + 2 * t, r = mt * 16 + g;
    const float c0 = bf[j], c1 = bf[j + 1];
    fs[r * DP + j] = __fadd_rn(d[0], c0);
    fs[r * DP + j + 1] = __fadd_rn(d[1], c1);
    fs[(r + 8) * DP + j] = __fadd_rn(d[2], c0);
    fs[(r + 8) * DP + j + 1] = __fadd_rn(d[3], c1);
  }
}

// Split aggregation of a chunk's nt tokens: split s (of `splits`) takes the
// tokens t = s (mod splits) in order.  Per (split, head hl, winner m), row
// (s*hpc + hl)*M + m: the sums of rnd(sim) * xn (acc, C wide; only with
// kX), of the sims (rsp) and the counts (cntp).  sg[t*hpc + hl] is the
// winner's sigmoid, arg(t*hpc + hl) its proposal, xin(t, c) rounded xn.
// Every accumulator has one owner thread, so no barrier is needed inside;
// the caller sums the splits in order afterwards.  Without kCounts only the
// weighted sums (the backward's sums of g reuse them; rsp, cntp unused).
template <typename T, bool kX, bool kCounts = true, typename XIN, typename ARG>
__device__ void agg_chunk(XIN xin, const float* sg, ARG arg, int nt, int hpc, int M, int C,
                          int splits, float* acc, float* rsp, float* cntp) {
  const int tid = threadIdx.x, nth = blockDim.x;
  if constexpr (kX) {
    const float rc = 1.f / C, rh = 1.f / hpc;
    for (int e = tid; e < splits * hpc * C; e += nth) {
      int c, hl;
      const int row = asy::div_small(e, C, rc, c), s = asy::div_small(row, hpc, rh, hl);
      float* ap = acc + (size_t)row * M * C + c;
      for (int t = s; t < nt; t += splits) {
        const int q = t * hpc + hl, m = arg(q);
        ap[m * C] = fmaf(rnd<T>(sg[q]), xin(t, c), ap[m * C]);
      }
    }
  }
  if constexpr (!kCounts) return;
  for (int e = tid; e < splits * hpc; e += nth) {
    const int hl = e % hpc, s = e / hpc;
    for (int t = s; t < nt; t += splits) {
      const int q = t * hpc + hl, row = e * M + arg(q);
      rsp[row] += sg[q];
      cntp[row] += 1.f;
    }
  }
}

// Sums the splits of agg_chunk's per-split rows in order into split 0's
// (rows of `width` values; n = hpc*M rows a split), rounding with kRound.
template <typename T, bool kRound>
__device__ void sum_splits(float* a, int n, int width, int splits) {
  for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += a[(size_t)s * n * width + e];
    a[e] = kRound ? rnd<T>(v) : v;
  }
}

// Sum over the kLanes lanes of a (token, head) item (xor butterfly).
__device__ __forceinline__ float lane_sum(float v) {
  for (int o = kLanes / 2; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rounded squared norm of one token's head (f: its D feat values), summed
// over the lanes: every lane gets the total
template <typename T>
__device__ __forceinline__ float head_norm2(const float* f, int D, int sub) {
  float n2 = 0.f;
  for (int d = sub; d < D; d += kLanes) n2 = __fadd_rn(n2, rnd<T>(__fmul_rn(f[d], f[d])));
  return lane_sum(n2);
}

struct Winner {
  int arg;     // the first proposal with the largest logit
  float best;  // its pre-sigmoid logit beta + alpha * cos
  float cos;   // its cosine (f32)
  float raw;   // its raw product cn . rnd(feat) (f32): cos = raw * inv
};

// B2. Assignment of one (token, head): the cosines of its feat f (D values)
// to the M normalised centers cn (row stride Dg), first max on beta +
// alpha*cos (strict >).  All kLanes lanes of the item call it; every lane
// of the warp must take part (the shuffles use the full mask).
// A lane's rounded feat values are loaded once (up to kPer of them, D <=
// kLanes * kPer; wider heads reread them per proposal): the same products
// in the same order either way.
constexpr int kPer = 8;
template <typename T>
__device__ __forceinline__ Winner assign(const float* f, const float* cn, int Dg, int D, int M,
                                         float alpha, float beta, int sub) {
  const float inv = rnd<T>(rsqrtf(__fadd_rn(head_norm2<T>(f, D, sub), 1e-12f)));
  Winner w{0, 0.f, 0.f, 0.f};
  const bool held = D <= kLanes * kPer;
  float fr[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int d = sub + k * kLanes;
    fr[k] = held && d < D ? rnd<T>(f[d]) : 0.f;
  }
  for (int m = 0; m < M; ++m) {
    const float* cm = cn + m * Dg;
    float raw = 0.f;
    if (held) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int d = sub + k * kLanes;
        if (d < D) raw = __fmaf_rn(cm[d], fr[k], raw);
      }
    } else {
      for (int d = sub; d < D; d += kLanes) raw = __fmaf_rn(cm[d], rnd<T>(f[d]), raw);
    }
    raw = lane_sum(raw);
    const float cs = __fmul_rn(raw, inv);
    const float lg = __fmaf_rn(alpha, cs, beta);
    if (m == 0 || lg > w.best) w = Winner{m, lg, cs, raw};
  }
  return w;
}

// The normalise-first similarity of the TPU's folded forward
// (block_pallas.py:369-392), which only the ablation tool runs: each
// (token, head) feat row is scaled by its rounded inverse norm and rounded
// (featn), and a cosine is then the plain product cn . featn.  All kLanes
// lanes of the item call these; each lane writes and reads only its own
// columns d = sub (mod kLanes).
template <typename T>
__device__ __forceinline__ void normalise_feat(float* f, int D, int sub) {
  const float inv = rnd<T>(rsqrtf(__fadd_rn(head_norm2<T>(f, D, sub), 1e-12f)));
  for (int d = sub; d < D; d += kLanes) f[d] = rnd<T>(__fmul_rn(f[d], inv));
}

// cn_m . featn over the lanes (every lane gets the total)
__device__ __forceinline__ float cos_nf(const float* fn, const float* cm, int D, int sub) {
  float cs = 0.f;
  for (int d = sub; d < D; d += kLanes) cs = __fmaf_rn(cm[d], fn[d], cs);
  return lane_sum(cs);
}

// B2 on a normalised row fn: first max on beta + alpha * cos, as `assign`
// (raw is the cosine itself: there is no separate inverse norm)
__device__ __forceinline__ Winner assign_nf(const float* fn, const float* cn, int Dg, int D,
                                            int M, float alpha, float beta, int sub) {
  Winner w{0, 0.f, 0.f, 0.f};
  for (int m = 0; m < M; ++m) {
    const float cs = cos_nf(fn, cn + m * Dg, D, sub);
    const float lg = __fmaf_rn(alpha, cs, beta);
    if (m == 0 || lg > w.best) w = Winner{m, lg, cs, cs};
  }
  return w;
}

// C. One mixed center (agg + v_c) / (count + 1), agg = aggx . wv + rs * bv,
// rounded: aggx (C values, rounded to the working type as they are read),
// `vcol(c)` the fc_v column.
template <typename T, typename VCOL>
__device__ __forceinline__ float mixed_center(const float* aggx, VCOL vcol, int C, float rs,
                                              float bv, float vc, float cnt) {
  float acc = 0.f;
  for (int c = 0; c < C; ++c) acc = __fmaf_rn(rnd<T>(aggx[c]), vcol(c), acc);
  const float agg = __fmaf_rn(rs, bv, acc);
  return rnd<T>(__fmul_rn(__fadd_rn(agg, vc), 1.f / __fadd_rn(cnt, 1.f)));
}

}  // namespace mix
}  // namespace asy
