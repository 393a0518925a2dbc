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
#pragma once

#include "common.cuh"

namespace asy {
namespace mix {

constexpr int kChunk = 32;  // tokens per sweep chunk
constexpr int kLanes = 8;   // lanes per (token, head) in the assignment
constexpr int kSplit = 8;   // fixed token splits of the aggregation

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// A. The region's centers for the block's columns: adaptive-average pool of
// the normalised input in INPUT space, then the projections with the
// block's fc1/fc_v columns and the per-head inverse norms.  `xin(n, c)` is
// the rounded normalised input of region token n; `wcol(c, j)` and
// `vcol(c, j)` the fc1 and fc_v weights of column col0 + j; bf, bv point at
// column col0.  Ends with a barrier.
template <typename T, typename XIN, typename WCOL, typename VCOL>
__device__ void project_centers(XIN xin, WCOL wcol, VCOL vcol, const float* bf,
                                const float* bv, int C, int Dg, int D, int hpc, int M,
                                int rh, int rw, int ph, int pw, float* cin, float* crep,
                                float* vc, float* invc) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int e = tid; e < M * C; e += nth) {
    const int m = e / C, c = e % C;
    const int pi = m / pw, pj = m % pw;
    const int lh = (pi * rh) / ph, hh = ((pi + 1) * rh + ph - 1) / ph;
    const int lw = (pj * rw) / pw, hw = ((pj + 1) * rw + pw - 1) / pw;
    const float wgt = rnd<T>(__fmul_rn(1.f / (hh - lh), 1.f / (hw - lw)));
    float acc = 0.f;
    for (int i = lh; i < hh; ++i)
      for (int j = lw; j < hw; ++j) acc = __fmaf_rn(wgt, xin(i * rw + j, c), acc);
    cin[e] = rnd<T>(acc);
  }
  __syncthreads();
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

// B1. feat of the chunk's tokens (xs [kChunk][C] rounded xn, rows 16-byte
// aligned, C % 4 == 0) for the block's columns: fs[t][j] = xs[t] . wcol(., j)
// + bf[j].  Thread (tg, j) owns tokens tg + 8k.  The caller syncs after.
template <typename T, typename WCOL>
__device__ void feat_chunk(const float* xs, int C, WCOL wcol, const float* bf, int Dg, int DP,
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
        const float4 xv = reinterpret_cast<const float4*>(xs + (tg + 8 * k) * C)[c4];
        acc[k] = __fmaf_rn(xv.x, w0, __fmaf_rn(xv.y, wa, __fmaf_rn(xv.z, wb,
                           __fmaf_rn(xv.w, wc, acc[k]))));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) fs[(tg + 8 * k) * DP + j] = __fadd_rn(acc[k], bf[j]);
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
template <typename T>
__device__ __forceinline__ Winner assign(const float* f, const float* cn, int Dg, int D, int M,
                                         float alpha, float beta, int sub) {
  const float inv = rnd<T>(rsqrtf(__fadd_rn(head_norm2<T>(f, D, sub), 1e-12f)));
  Winner w{0, 0.f, 0.f, 0.f};
  for (int m = 0; m < M; ++m) {
    const float* cm = cn + m * Dg;
    float raw = 0.f;
    for (int d = sub; d < D; d += kLanes) raw = __fmaf_rn(cm[d], rnd<T>(f[d]), raw);
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
