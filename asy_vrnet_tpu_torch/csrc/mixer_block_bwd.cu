// Backward of the mixer half of a ClusterBlock, fused:
//   out = x + fc2(cluster_mix(fc1(xn), fc_v(xn))),  xn = (x - mu) * rstd
// given g = d out, computes the cotangent of xn, the folded-weight gradients
// dWf, dbf, dWv, dbv, dW2 and db2 summed over the batch, d alpha and d beta,
// and per-sample sum(dxn) and sum(dxn * xn) from the f32 dxn, which the
// GroupNorm input gradient needs.  Two bodies, as the TPU kernel has:
//
// K6, from the forward's residual pack (mixer_block.cu writes it in
// training).  Replaces asy_vrnet_tpu/ops/block_pallas.py::_mixer_bwd_pallas
// with its residual body (_mixer_bwd_kernel_res + _mixer_bwd_tail).  Like
// it, the kernel rebuilds feat, the per-head token norms and the pooled
// tokens from x and never recomputes the assignment: the similarity plane
// comes from the stored winning cosine and proposal, so the cotangent of
// the raw plane is rebuilt as dcos * cbest / invr on the winner, exact
// because dcos is zero elsewhere.
//
// K6r, with the full forward remat (no pack: the path under
// ASY_MIXER_BWD_RESIDUALS=0, the JAX package's memory-lean setting).
// Replaces the same pallas_call with its body _mixer_bwd_kernel +
// _mixer_bwd_tail.  Before the sweeps a block rebuilds what K2's phases A
// and B compute for its heads, with K2's own device code
// (mixer_block.cuh): the pooled centers, projected and normalised; per
// (token, head) the cosines, the first max and the winner's sigmoid; the
// counts and the sim-weighted sums of xn in K2's fixed token splits; the
// mixed centers.  So it differentiates the assignment K2 made, bit for bit,
// and the raw plane's cotangent takes the remat's own raw product.
//
// The TPU kernel's dense masked (rows x tokens) planes are not carried
// over: everything is per (token, head) at the winner.  Roundings to the
// working type where that kernel casts to its matrix-unit type.
//
// What bounds it on the H100: per token ~6*C*I flops (feat recompute, dfeat
// @ wf^T, xn^T dfeat) plus ~4*C*heads, against 6*C bytes of bf16 traffic
// (K6r: + 2*C*I + 2*I*(M+1) for the forward remat, and no pack to read):
// bound by bytes on paper at every nano shape.  Its feat takes K2's path
// (tensor cores in bf16, mixer_block.cuh); the other products run FMA on
// CUDA cores from shared memory, with short per-(token, head) dot products,
// so it is bound by latency and shared-memory traffic instead.
//
// Design.  Two kernels.
//   1. One block per (sample, region, head group); the caller picks the
//      number G of head groups so that the batch's regions fill the card.
//      (K6r first: the centers, phase A of K2.)  Sweep 1 over the region's
//      tokens in chunks of 32 (from device memory, L2): pooled tokens (K6),
//      per (head, proposal) counts, sum of sims, and the sim-weighted sums
//      of xn and g, in fixed token classes (no atomics; K6r: K2's kSplit
//      classes for the xn sums), K6r rebuilding each chunk's feat and
//      assignment first.  Then the per-(head, proposal) algebra (K6r: the
//      mixed centers first): fc2-projected centers, d oc, d agg, d aggx,
//      and the block's columns of dW2, dWv and dbv, which need no further
//      token pass.  Sweep 2: feat of the block's columns (their wf columns
//      staged in shared memory; K6r: the assignment again), per (token,
//      head) the winner's d sim, d alpha/beta, d raw and d norm (8 lanes
//      each), d feat; the d centers sums, dbf and dWf accumulate with one
//      owner thread per element; the block's share of dxn (dispatch of d
//      aggx plus dfeat @ wf^T) goes to an f32 scratch plane of its head
//      group.  Last, d c_rep -> dWf, dbf and d cin (the pooled rows'
//      cotangent) of its columns.
//   2. One block per 256 tokens of a sample: dxn = sum of the G scratch
//      planes + pool^T (sum over groups of d cin), rounded once; GroupNorm
//      sums and db2 per block.
// Every partial is a row per block that the caller reduces with one torch
// sum: two runs give the same bits.
//
// Weight partial row per (sample, region):
//   [dWf (C*I) | dWv (C*I) | dW2 (I*C) | dbf (I) | dbv (I)]
// (each head group writes its own columns / rows).
#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mixer_block.cuh"

namespace {

using asy::mix::kChunk;  // tokens per sweep chunk
using asy::mix::kLanes;  // lanes per (token, head)
constexpr int kThreads = 256;
constexpr int kTile = 256;  // tokens per epilogue block

struct Geo {
  int B, H, W, C, I, heads, D, fold_h, fold_w, rh, rw, N, ph, pw, M;
  int G, hpc, Dg, P, split;  // head groups, heads per group, its columns, hpc*M, splits
  int splitx;                // splits of the xn sums (K6r: K2's kSplit)
  int tc;                    // feat on tensor cores (K2's path: asy::mix::feat_on_tc)
};

struct Lay {  // offsets in floats
  size_t xs, gs, fs, dfs, cbs, sg, ag, drw, dn2, rawc, pw, cin, cn, invc, ocb, dagg, dcn,
      ocw, daggx, aggx, docw, cnt, rsum, drs, icnt, accx, rsp, cntp, accg, pdwf, pdbf, dcp,
      wfs, crp, cnr, vcr, invr, red, floats;
};

// remat: the K6r buffers (the winner's raw product, K2's centers)
inline Lay layout(const Geo& g, bool remat) {
  Lay L;
  size_t o = 0;
  const size_t C = g.C, DP = g.Dg + kLanes, P = g.P, D = g.D, T = (size_t)kChunk * g.hpc;
  const size_t MD = remat ? (size_t)g.M * g.Dg : 0;
  L.xs = o;    o += kChunk * C;
  L.gs = o;    o += kChunk * C;
  L.fs = o;    o += kChunk * DP;
  L.dfs = o;   o += kChunk * DP;
  L.cbs = o;   o += T;
  L.sg = o;    o += T;
  L.ag = o;    o += T;
  L.drw = o;   o += T;
  L.dn2 = o;   o += T;
  L.rawc = o;  o += remat ? T : 0;
  L.pw = o;    o += (size_t)kChunk * g.M;
  L.cin = o;   o += (size_t)g.M * C;
  L.cn = o;    o += P * D;
  L.invc = o;  o += P;
  L.ocb = o;   o += P * D;
  L.dagg = o;  o += P * D;
  L.dcn = o;   o += P * D;
  L.ocw = o;   o += P * C;
  L.daggx = o; o += P * C;
  L.aggx = o;  o += P * C;
  L.docw = o;  o += P * C;
  L.cnt = o;   o += P;
  L.rsum = o;  o += P;
  L.drs = o;   o += P;
  L.icnt = o;  o += P;
  L.accx = o;  o += (size_t)g.splitx * P * C;
  L.rsp = o;   o += (size_t)g.splitx * P;
  L.cntp = o;  o += (size_t)g.splitx * P;
  L.accg = o;  o += (size_t)g.split * P * C;
  L.pdwf = o;  o += C * g.Dg;
  L.pdbf = o;  o += g.Dg;
  L.dcp = o;   o += (size_t)g.M * g.Dg;
  L.wfs = o;   o += C * (g.Dg + 1);
  L.crp = o;   o += MD;
  L.cnr = o;   o += MD;
  L.vcr = o;   o += MD;
  L.invr = o;  o += remat ? (size_t)g.M * g.hpc : 0;
  L.red = o;   o += 2 * (kThreads / 32);
  L.floats = o;
  return L;
}

// adaptive-average pooling weight of region-local token n in proposal m
// (0 outside its window), rounded to the working type as the TPU kernel's
// pooling matrix is
template <typename T>
__device__ __forceinline__ float pool_weight(const Geo& g, int n, int m) {
  const int i = n / g.rw, j = n % g.rw, pi = m / g.pw, pj = m % g.pw;
  const int lh = (pi * g.rh) / g.ph, hh = ((pi + 1) * g.rh + g.ph - 1) / g.ph;
  const int lw = (pj * g.rw) / g.pw, hw = ((pj + 1) * g.rw + g.pw - 1) / g.pw;
  if (i < lh || i >= hh || j < lw || j >= hw) return 0.f;
  return asy::rnd<T>((1.f / (hh - lh)) * (1.f / (hw - lw)));
}

template <typename T, bool kRemat>
__global__ void __launch_bounds__(kThreads)
mixer_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                 const float* __restrict__ stats, const T* __restrict__ wf,
                 const float* __restrict__ bf, const T* __restrict__ wv,
                 const float* __restrict__ bv, const T* __restrict__ w2,
                 const float* __restrict__ ab, const T* __restrict__ cbest,
                 const int8_t* __restrict__ argf, const T* __restrict__ crep,
                 const T* __restrict__ ocr, float* __restrict__ scratch,
                 float* __restrict__ dcin, float* __restrict__ wpart,
                 float* __restrict__ dab, int8_t* __restrict__ assign_out, Geo g, Lay L) {
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* xs = sm + L.xs;        // [kChunk][C] rounded xn
  float* gs = sm + L.gs;        // [kChunk][C] g
  float* fs = sm + L.fs;        // [kChunk][DP] feat (f32) of the group's columns
  float* dfs = sm + L.dfs;      // [kChunk][DP] d feat
  float* cbs = sm + L.cbs;      // [kChunk][hpc] winning cosine
  float* sg = sm + L.sg;        // [kChunk][hpc] winner sigmoid
  float* ag = sm + L.ag;        // [kChunk][hpc] winning proposal (-1: no token)
  float* drw = sm + L.drw;      // [kChunk][hpc] rounded d raw at the winner
  float* dn2 = sm + L.dn2;      // [kChunk][hpc] rounded d norm^2
  float* rawc = sm + L.rawc;    // [kChunk][hpc] K6r: the winner's raw product
  float* pw = sm + L.pw;        // [kChunk][M] pooling weights
  float* cin = sm + L.cin;      // [M][C] pooled xn (rounded)
  float* cn = sm + L.cn;        // [P][D] normalised centers (f32)
  float* invc = sm + L.invc;    // [P] center inverse norms
  float* ocb = sm + L.ocb;      // [P][D] mixed centers (rounded)
  float* dagg = sm + L.dagg;    // [P][D] d agg (= d value centers), f32
  float* dcn = sm + L.dcn;      // [P][D] d normalised centers
  float* ocw = sm + L.ocw;      // [P][C] fc2-projected centers (rounded)
  float* daggx = sm + L.daggx;  // [P][C] d aggx (rounded)
  float* aggx = sm + L.aggx;    // [P][C] sim-weighted sum of xn
  float* docw = sm + L.docw;    // [P][C] sim-weighted sum of g (rounded)
  float* cnt = sm + L.cnt;      // [P] counts; later <cn, dcn>
  float* rsum = sm + L.rsum;    // [P] sum of sims
  float* drs = sm + L.drs;      // [P] d rowsum(sim)
  float* icnt = sm + L.icnt;    // [P] 1 / (count + 1)
  float* accx = sm + L.accx;    // [splitx][P][C]
  float* rsp = sm + L.rsp;      // [splitx][P] split sums of sims
  float* cntp = sm + L.cntp;    // [splitx][P] split counts
  float* accg = sm + L.accg;    // [split][P][C]
  float* pdwf = sm + L.pdwf;    // [C][Dg] dWf of the group's columns
  float* pdbf = sm + L.pdbf;    // [Dg]
  float* dcp = sm + L.dcp;      // [M][Dg] d c_rep of the group's columns
  float* wfs = sm + L.wfs;      // [C][Dg + 1] the group's wf columns
  float* crp = sm + L.crp;      // K6r, K2's layout: [M][Dg] raw centers (f32)
  float* cnr = sm + L.cnr;      //   [M][Dg] normalised centers (rounded)
  float* vcr = sm + L.vcr;      //   [M][Dg] value centers (f32)
  float* invr_c = sm + L.invr;  //   [M][hpc] center inverse norms
  float* red = sm + L.red;

  const int C = g.C, I = g.I, D = g.D, M = g.M, N = g.N, hpc = g.hpc, Dg = g.Dg, P = g.P;
  const int DP = Dg + kLanes;
  const int tid = threadIdx.x, sub = tid % kLanes;
  const int r = blockIdx.x / g.G, grp = blockIdx.x % g.G, b = blockIdx.y;
  const size_t br = (size_t)b * g.fold_h * g.fold_w + r;
  const size_t rowlen = (size_t)3 * C * I + 2 * I;
  float* wrow = wpart + br * rowlen;
  const int col0 = grp * Dg, h0 = grp * hpc;
  const int row0 = (r / g.fold_w) * g.rh, cl0 = (r % g.fold_w) * g.rw;
  const float mu = stats[2 * b], rstd = stats[2 * b + 1];
  const float alpha = ab[0], beta = ab[1];
  auto tok = [&](int n) -> size_t {  // token index in (B, H, W)
    return (size_t)(b * g.H + row0 + n / g.rw) * g.W + cl0 + n % g.rw;
  };
  auto norm_in = [&](size_t o) { return rnd<T>((to_f<T>(x[o]) - mu) * rstd); };
  auto wf_at = [&](int c, int j) { return wfs[c * (Dg + 1) + j]; };
  auto wv_at = [&](int c, int j) { return to_f<T>(wv[(size_t)c * I + col0 + j]); };
  // feat of the chunk in xs: K2's device code, on K2's path (tensor cores
  // from the same bf16 values, fragments packed from the f32 copies here)
  auto feat = [&]() {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (g.tc) {
        const int gq = (tid % 32) / 4, tq = tid % 4;
        asy::mix::feat_chunk_mma(
            [&](int mt, int kk, uint32_t(&a)[4]) {
              const float* r0 = xs + (mt * 16 + gq) * C + kk * 16 + 2 * tq;
              const float* r1 = r0 + 8 * C;
              a[0] = asy::pack_bf16(r0[0], r0[1]);
              a[1] = asy::pack_bf16(r1[0], r1[1]);
              a[2] = asy::pack_bf16(r0[8], r0[9]);
              a[3] = asy::pack_bf16(r1[8], r1[9]);
            },
            [&](int nt, int kk, uint32_t& b0, uint32_t& b1) {
              const float* w = wfs + (kk * 16 + 2 * tq) * (Dg + 1) + nt * 8 + gq;
              b0 = asy::pack_bf16(w[0], w[Dg + 1]);
              b1 = asy::pack_bf16(w[8 * (Dg + 1)], w[9 * (Dg + 1)]);
            },
            bf + col0, C, Dg, DP, fs);
        return;
      }
    }
    asy::mix::feat_chunk<T>(
        [&](int t, int c4) { return reinterpret_cast<const float4*>(xs + t * C)[c4]; }, C,
        wf_at, bf + col0, Dg, DP, fs);
  };
  auto load_chunk = [&](int n0, int nt) {
    for (int e = tid; e < kChunk * C; e += kThreads) {
      const int t = e / C, c = e % C;
      const bool ok = t < nt;
      const size_t o = ok ? tok(n0 + t) * C + c : 0;
      xs[e] = ok ? norm_in(o) : 0.f;
      gs[e] = ok ? to_f<T>(gout[o]) : 0.f;
    }
    if (kRemat) return;  // the assignment comes from assign_chunk
    for (int e = tid; e < kChunk * hpc; e += kThreads) {
      const int t = e / hpc, hl = e % hpc;
      float cb = 0.f, s = 0.f, a = -1.f;
      if (t < nt) {
        const size_t o = tok(n0 + t) * g.heads + h0 + hl;
        cb = to_f<T>(cbest[o]);
        s = asy::mix::sigmoid(beta + alpha * cb);
        a = (float)argf[o];
      }
      cbs[e] = cb;
      sg[e] = s;
      ag[e] = a;
    }
    for (int e = tid; e < kChunk * M; e += kThreads) {
      const int t = e / M;
      pw[e] = t < nt ? pool_weight<T>(g, n0 + t, e % M) : 0.f;
    }
  };
  // K6r: the chunk's feat and K2's assignment of its (token, head) items
  // (kChunk*hpc items, a multiple of the 32 a pass covers, so every lane of
  // a warp runs the same iterations of the shuffles)
  auto assign_chunk = [&](int n0, int nt, bool record) {
    feat();
    __syncthreads();
    for (int it = tid / kLanes; it < kChunk * hpc; it += kThreads / kLanes) {
      const int t = it % kChunk, hl = it / kChunk, q = t * hpc + hl;
      const asy::mix::Winner win =
          asy::mix::assign<T>(fs + t * DP + hl * D, cnr + hl * D, Dg, D, M, alpha, beta, sub);
      if (sub == 0) {
        const bool ok = t < nt;
        cbs[q] = ok ? win.cos : 0.f;
        sg[q] = ok ? asy::mix::sigmoid(win.best) : 0.f;
        ag[q] = ok ? (float)win.arg : -1.f;
        rawc[q] = ok ? win.raw : 0.f;
        if (ok && record && assign_out != nullptr)
          assign_out[tok(n0 + t) * g.heads + h0 + hl] = (int8_t)win.arg;
      }
    }
  };

  for (int e = tid; e < C * Dg; e += kThreads)
    wfs[(e / Dg) * (Dg + 1) + e % Dg] = to_f<T>(wf[(size_t)(e / Dg) * I + col0 + e % Dg]);
  for (int e = tid; e < g.splitx * P * C; e += kThreads) accx[e] = 0.f;
  for (int e = tid; e < g.split * P * C; e += kThreads) accg[e] = 0.f;
  for (int e = tid; e < M * C; e += kThreads) cin[e] = 0.f;
  for (int e = tid; e < g.splitx * P; e += kThreads) rsp[e] = cntp[e] = 0.f;

  if (kRemat) {  // ---- K2's phase A: the centers of the group's heads ----
    __syncthreads();  // wfs staged
    asy::mix::pool_centers<T>([&](int n, int c) { return norm_in(tok(n) * C + c); }, C, D, M,
                              g.rh, g.rw, g.ph, g.pw, fs, cin, 0, 1);
    asy::mix::project_centers(wf_at, wv_at, bf + col0, bv + col0, C, Dg, D, hpc, M, cin, crp,
                              vcr, invr_c);
    asy::mix::normalise_centers<T>(crp, invr_c, cnr, M, Dg, D, hpc);
  }

  // ---- sweep 1: pooled tokens, counts, sim-weighted sums of xn and g ----
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int nt = min(kChunk, N - n0);
    __syncthreads();
    load_chunk(n0, nt);
    __syncthreads();
    if (kRemat) {
      assign_chunk(n0, nt, true);
      __syncthreads();
    } else {
      for (int e = tid; e < M * C; e += kThreads) {
        const int m = e / C, c = e % C;
        float a = cin[e];
        for (int t = 0; t < nt; ++t) a = fmaf(pw[t * M + m], xs[t * C + c], a);
        cin[e] = a;
      }
    }
    // counts, sums of sims and the sim-weighted sums of xn in fixed token
    // splits (K6r: K2's kSplit, so K2's order)
    asy::mix::agg_chunk<T, true>([&](int t, int c) { return xs[t * C + c]; }, sg,
                                 [&](int q) { return (int)ag[q]; }, nt, hpc, M, C, g.splitx,
                                 accx, rsp, cntp);
    for (int e = tid; e < g.split * hpc * C; e += kThreads) {
      const int c = e % C, hl = (e / C) % hpc, s = e / (C * hpc);
      float* ay = accg + (size_t)(s * P + hl * M) * C + c;
      for (int t = s; t < nt; t += g.split) {
        const int q = t * hpc + hl, m = (int)ag[q];
        ay[m * C] = fmaf(rnd<T>(sg[q]), gs[t * C + c], ay[m * C]);
      }
    }
  }
  __syncthreads();

  // ---- per (head, proposal) algebra ----
  for (int e = tid; e < P * C; e += kThreads) {
    float a = 0.f, q = 0.f;
    for (int s = 0; s < g.splitx; ++s) a += accx[(size_t)s * P * C + e];
    for (int s = 0; s < g.split; ++s) q += accg[(size_t)s * P * C + e];
    aggx[e] = a;
    docw[e] = rnd<T>(q);
  }
  for (int e = tid; e < M * C; e += kThreads) cin[e] = rnd<T>(cin[e]);
  for (int e = tid; e < P; e += kThreads) {
    float rsv = 0.f, n = 0.f;
    for (int sp = 0; sp < g.splitx; ++sp) {
      rsv += rsp[sp * P + e];
      n += cntp[sp * P + e];
    }
    rsum[e] = rsv;
    cnt[e] = n;
    icnt[e] = 1.f / (n + 1.f);
  }
  if (!kRemat) {
    for (int e = tid; e < P * D; e += kThreads) {
      const int hm = e / D, d = e % D;
      const size_t o = ((br * g.heads + h0 + hm / M) * M + hm % M) * D + d;
      cn[e] = to_f<T>(crep[o]);
      ocb[e] = to_f<T>(ocr[o]);
    }
  }
  __syncthreads();
  if (kRemat) {  // K2's raw and mixed centers, in this kernel's [P][D] layout
    for (int e = tid; e < P * D; e += kThreads) {
      const int hm = e / D, hl = hm / M, m = hm % M, j = hl * D + e % D;
      cn[e] = crp[m * Dg + j];
      ocb[e] = asy::mix::mixed_center<T>(aggx + hm * C, [&](int c) { return wv_at(c, j); }, C,
                                         rsum[hm], bv[col0 + j], vcr[m * Dg + j], cnt[hm]);
    }
    __syncthreads();
  }
  for (int e = tid; e < P; e += kThreads) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(cn[e * D + d], cn[e * D + d], s);
    invc[e] = rsqrtf(s + 1e-12f);
  }
  for (int e = tid; e < P * C; e += kThreads) {  // oc @ w2 of the head
    const int hm = e / C, c = e % C, j0 = (hm / M) * D;
    float a = 0.f;
    for (int d = 0; d < D; ++d)
      a = fmaf(ocb[hm * D + d], to_f<T>(w2[(size_t)(col0 + j0 + d) * C + c]), a);
    ocw[e] = rnd<T>(a);
  }
  for (int e = tid; e < P * D; e += kThreads) {  // d oc -> d agg
    const int hm = e / D, d = e % D;
    const T* wr = w2 + (size_t)(col0 + (hm / M) * D + d) * C;
    float a = 0.f;
    for (int c = 0; c < C; ++c) a = fmaf(docw[hm * C + c], to_f<T>(wr[c]), a);
    dagg[e] = a * icnt[hm];
  }
  for (int e = tid; e < Dg * C; e += kThreads) {  // dW2 rows: oc^T d(oc @ w2)
    const int j = e / C, c = e % C, hl = j / D, d = j % D;
    float a = 0.f;
    for (int m = 0; m < M; ++m)
      a = fmaf(ocb[(hl * M + m) * D + d], docw[(hl * M + m) * C + c], a);
    wrow[(size_t)2 * C * I + (size_t)(col0 + j) * C + c] = a;
  }
  __syncthreads();
  for (int e = tid; e < P; e += kThreads) {
    for (int d = 0; d < D; ++d) cn[e * D + d] *= invc[e];
  }
  for (int e = tid; e < P * C; e += kThreads) {  // d aggx = d agg @ wv^T
    const int hm = e / C, c = e % C, j0 = (hm / M) * D;
    float a = 0.f;
    for (int d = 0; d < D; ++d) a = fmaf(rnd<T>(dagg[hm * D + d]), wv_at(c, j0 + d), a);
    daggx[e] = rnd<T>(a);
  }
  for (int e = tid; e < P; e += kThreads) {
    const int j0 = (e / M) * D;
    float a = 0.f;
    for (int d = 0; d < D; ++d) a = fmaf(dagg[e * D + d], bv[col0 + j0 + d], a);
    drs[e] = a;
  }
  for (int e = tid; e < C * Dg; e += kThreads) {  // dWv: aggregation + value centers
    const int c = e / Dg, j = e % Dg, hl = j / D, d = j % D;
    float a = 0.f;
    for (int m = 0; m < M; ++m) {
      const int hm = hl * M + m;
      const float db = rnd<T>(dagg[hm * D + d]);
      a = fmaf(rnd<T>(aggx[hm * C + c]), db, a);
      a = fmaf(cin[m * C + c], db, a);
    }
    wrow[(size_t)C * I + (size_t)c * I + col0 + j] = a;
  }
  for (int j = tid; j < Dg; j += kThreads) {  // dbv
    const int hl = j / D, d = j % D;
    float a = 0.f, s = 0.f;
    for (int m = 0; m < M; ++m) {
      const int hm = hl * M + m;
      a = fmaf(rnd<T>(rsum[hm]), rnd<T>(dagg[hm * D + d]), a);
      s += dagg[hm * D + d];
    }
    wrow[(size_t)3 * C * I + I + col0 + j] = a + s;
  }
  for (int e = tid; e < P * D; e += kThreads) dcn[e] = 0.f;
  for (int e = tid; e < C * Dg; e += kThreads) pdwf[e] = 0.f;
  for (int j = tid; j < Dg; j += kThreads) pdbf[j] = 0.f;

  // ---- sweep 2: the similarity and feat cotangents, token by token ----
  float sa = 0.f, sb = 0.f;  // d alpha, d beta of this thread's items
  const size_t plane = (size_t)g.B * g.H * g.W * C;
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int nt = min(kChunk, N - n0);
    __syncthreads();
    load_chunk(n0, nt);
    __syncthreads();
    if (kRemat) {
      assign_chunk(n0, nt, false);
    } else {
      feat();
    }
    __syncthreads();
    // per (token, head), kLanes lanes each.  kChunk*hpc items is a multiple
    // of the 32 items a pass covers, so every lane of a warp runs the same
    // iterations of the shuffles.
    for (int it = tid / kLanes; it < kChunk * hpc; it += kThreads / kLanes) {
      const int t = it % kChunk, hl = it / kChunk, q = t * hpc + hl;
      const float n2 = asy::mix::head_norm2<T>(fs + t * DP + hl * D, D, sub);
      const int hm = hl * M + max(0, (int)ag[q]);
      float ds = 0.f;
      for (int c = sub; c < C; c += kLanes)
        ds = fmaf(ocw[hm * C + c], gs[t * C + c], fmaf(daggx[hm * C + c], xs[t * C + c], ds));
      ds = asy::mix::lane_sum(ds);
      if (sub == 0) {
        float dr = 0.f, dn = 0.f;
        if (t < nt) {
          const float inv = rsqrtf(n2 + 1e-12f), invr = rnd<T>(inv);
          const float cb = cbs[q], s = sg[q];
          const float sig = (ds + drs[hm]) * (s * (1.f - s));
          const float dcos = sig * alpha;
          sa = fmaf(sig, cb, sa);
          sb += sig;
          dr = rnd<T>(dcos * invr);
          // the raw plane's cotangent: the remat's raw product (K6r), or
          // cbest / invr on the winner (K6), exact since dcos is winner-masked
          const float dinvr = dcos * (kRemat ? rawc[q] : cb * (1.f / invr));
          dn = rnd<T>(rnd<T>(dinvr) * (-0.5f) * inv * inv * inv);
        }
        drw[q] = dr;
        dn2[q] = dn;
      }
    }
    __syncthreads();
    for (int e = tid; e < kChunk * Dg; e += kThreads) {  // d feat
      const int t = e / Dg, j = e % Dg, hl = j / D, q = t * hpc + hl;
      float v = 0.f;
      if (t < nt) {
        const int m = (int)ag[q];
        v = drw[q] * rnd<T>(cn[(hl * M + m) * D + j % D]) + 2.f * fs[t * DP + j] * dn2[q];
      }
      dfs[t * DP + j] = v;
    }
    __syncthreads();
    for (int j = tid; j < Dg; j += kThreads) {  // d centers (winner rows), dbf
      const int hl = j / D, d = j % D;
      float s = pdbf[j];
      for (int t = 0; t < nt; ++t) {
        const int q = t * hpc + hl;
        float* dc = dcn + (hl * M + (int)ag[q]) * D + d;
        *dc = fmaf(drw[q], rnd<T>(fs[t * DP + j]), *dc);
        s += dfs[t * DP + j];
      }
      pdbf[j] = s;
    }
    __syncthreads();
    for (int e = tid; e < kChunk * Dg; e += kThreads) {
      const int t = e / Dg, j = e % Dg;
      dfs[t * DP + j] = rnd<T>(dfs[t * DP + j]);
    }
    __syncthreads();
    // the group's share of dxn: dispatch of d aggx + d feat @ wf^T;
    // thread (tq, c) owns tokens 4*tq .. 4*tq + 3
    for (int e = tid; e < (kChunk / 4) * C; e += kThreads) {
      const int c = e % C, tq = e / C;
      float acc[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = 4 * tq + u;
        float a = 0.f;
        for (int hl = 0; hl < hpc; ++hl) {
          const int q = t * hpc + hl, m = (int)ag[q];
          if (m >= 0) a = fmaf(rnd<T>(sg[q]), daggx[(hl * M + m) * C + c], a);
        }
        acc[u] = a;
      }
      for (int j = 0; j < Dg; ++j) {
        const float w = wf_at(c, j);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fmaf(dfs[(4 * tq + u) * DP + j], w, acc[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = 4 * tq + u;
        if (t < nt) scratch[grp * plane + tok(n0 + t) * C + c] = acc[u];
      }
    }
    for (int e = tid; e < C * Dg; e += kThreads) {  // dWf: xn^T d feat
      const int c = e / Dg, j = e % Dg;
      float a = pdwf[e];
      for (int t = 0; t < nt; ++t) a = fmaf(xs[t * C + c], dfs[t * DP + j], a);
      pdwf[e] = a;
    }
  }
  __syncthreads();

  // ---- centers: cn = c_rep * inv_c, c_rep = pool(xn) @ wf + bf ----
  for (int e = tid; e < P; e += kThreads) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(cn[e * D + d], dcn[e * D + d], s);
    cnt[e] = s;
  }
  __syncthreads();
  for (int e = tid; e < M * Dg; e += kThreads) {
    const int m = e / Dg, j = e % Dg, hm = (j / D) * M + m, d = j % D;
    dcp[e] = invc[hm] * (dcn[hm * D + d] - cn[hm * D + d] * cnt[hm]);
  }
  __syncthreads();
  for (int e = tid; e < C * Dg; e += kThreads) {
    const int c = e / Dg, j = e % Dg;
    float a = pdwf[e];
    for (int m = 0; m < M; ++m) a = fmaf(cin[m * C + c], rnd<T>(dcp[m * Dg + j]), a);
    wrow[(size_t)c * I + col0 + j] = a;
  }
  for (int j = tid; j < Dg; j += kThreads) {
    float a = pdbf[j];
    for (int m = 0; m < M; ++m) a += dcp[m * Dg + j];
    wrow[(size_t)3 * C * I + col0 + j] = a;
  }
  for (int e = tid; e < M * C; e += kThreads) {  // d cin of the group's columns
    const int m = e / C, c = e % C;
    float a = 0.f;
    for (int j = 0; j < Dg; ++j) {
      const int hm = (j / D) * M + m;
      a = fmaf(rnd<T>(dcp[m * Dg + j]), wf_at(c, j), a);
      a = fmaf(rnd<T>(dagg[hm * D + j % D]), wv_at(c, j), a);
    }
    dcin[((br * g.G + grp) * M + m) * C + c] = a;
  }
  for (int off = 16; off > 0; off >>= 1) {
    sa += __shfl_down_sync(0xffffffffu, sa, off);
    sb += __shfl_down_sync(0xffffffffu, sb, off);
  }
  const int warps = kThreads / 32;
  if ((tid & 31) == 0) {
    red[tid >> 5] = sa;
    red[warps + (tid >> 5)] = sb;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, q = 0.f;
    for (int w = 0; w < warps; ++w) {
      a += red[w];
      q += red[warps + w];
    }
    dab[(br * g.G + grp) * 2] = a;
    dab[(br * g.G + grp) * 2 + 1] = q;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mixer_bwd_epilogue(const T* __restrict__ x, const T* __restrict__ gout,
                   const float* __restrict__ stats, const float* __restrict__ scratch,
                   const float* __restrict__ dcin, T* __restrict__ dxn,
                   float* __restrict__ epart, Geo g, int tiles) {
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, b = blockIdx.y, tile = blockIdx.x;
  const int C = g.C, M = g.M, HW = g.H * g.W;
  float* red2 = reinterpret_cast<float*>(smem4);  // [nq][C] db2 partials
  float* pwt = red2 + max(kThreads, C);           // [kTile][M] pooling weights
  int* rof = reinterpret_cast<int*>(pwt + kTile * M);  // [kTile] region of the token
  __shared__ float red[2 * (kThreads / 32)];
  const int n0 = tile * kTile, nt = min(kTile, HW - n0);
  const float mu = stats[2 * b], rstd = stats[2 * b + 1];
  const size_t plane = (size_t)g.B * HW * C;
  const int nq = max(1, kThreads / C);
  for (int t = tid; t < nt; t += kThreads) {
    const int p = n0 + t, y = p / g.W, xx = p % g.W;
    rof[t] = (y / g.rh) * g.fold_w + xx / g.rw;
    const int n = (y % g.rh) * g.rw + xx % g.rw;
    for (int m = 0; m < M; ++m) pwt[t * M + m] = pool_weight<T>(g, n, m);
  }
  __syncthreads();
  float s1 = 0.f, s2 = 0.f;
  for (int e = tid; e < nq * C; e += kThreads) {
    const int c = e % C, tq = e / C;
    float db2 = 0.f;
    for (int t = tq; t < nt; t += nq) {
      const size_t o = ((size_t)b * HW + n0 + t) * C + c;
      float v = 0.f;
      for (int grp = 0; grp < g.G; ++grp) v += scratch[grp * plane + o];
      const float* dc = dcin + ((size_t)b * g.fold_h * g.fold_w + rof[t]) * g.G * M * C + c;
      for (int m = 0; m < M; ++m) {
        const float w = pwt[t * M + m];
        if (w != 0.f) {
          float s = 0.f;
          for (int grp = 0; grp < g.G; ++grp) s += dc[(grp * M + m) * C];
          v = fmaf(w, rnd<T>(s), v);
        }
      }
      dxn[o] = asy::from_f<T>(v);
      s1 += v;
      s2 = fmaf(v, (to_f<T>(x[o]) - mu) * rstd, s2);
      db2 += to_f<T>(gout[o]);
    }
    red2[e] = db2;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  const int warps = kThreads / 32;
  if ((tid & 31) == 0) {
    red[tid >> 5] = s1;
    red[warps + (tid >> 5)] = s2;
  }
  __syncthreads();
  float* row = epart + ((size_t)b * tiles + tile) * (2 + C);
  for (int c = tid; c < C; c += kThreads) {
    float a = 0.f;
    for (int tq = 0; tq < nq; ++tq) a += red2[tq * C + c];
    row[2 + c] = a;
  }
  if (tid == 0) {
    float a = 0.f, q = 0.f;
    for (int w = 0; w < warps; ++w) {
      a += red[w];
      q += red[warps + w];
    }
    row[0] = a;
    row[1] = q;
  }
}

inline Geo make_geo(int B, int H, int W, int C, int I, int heads, int fold_h, int fold_w,
                    int ph, int pw, int G, bool remat) {
  const int rh = H / fold_h, rw = W / fold_w, D = I / heads, hpc = heads / G;
  const int split = std::min(8, std::max(1, kThreads / (hpc * C)));
  return Geo{B, H, W, C, I, heads, D, fold_h, fold_w, rh, rw, rh * rw, ph, pw, ph * pw,
             G, hpc, hpc * D, hpc * ph * pw, split, remat ? asy::mix::kSplit : split, 0};
}

template <typename T, bool kRemat>
int launch(const void* x, const void* gout, const float* stats, const void* wf,
           const float* bf, const void* wv, const float* bv, const void* w2,
           const float* ab, const void* cbest, const int8_t* argf, const void* crep,
           const void* oc, void* dxn, float* scratch, float* dcin, float* wpart,
           float* dab, float* epart, int8_t* assign, int B, int H, int W, int C, int I,
           int heads, int fold_h, int fold_w, int ph, int pw, int G, int tiles,
           void* stream) {
  if (B <= 0 || C <= 0 || C % 4 || heads <= 0 || I % heads || fold_h <= 0 || fold_w <= 0 ||
      H % fold_h || W % fold_w || ph <= 0 || pw <= 0 || ph * pw > 127 || G <= 0 ||
      heads % G || tiles != (H * W + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  Geo g = make_geo(B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, kRemat);
  g.tc = asy::mix::feat_on_tc<T>(C, g.D);
  const int M = g.M;
  if (g.rh < ph || g.rw < pw) return (int)cudaErrorInvalidValue;
  const Lay L = layout(g, kRemat);
  const size_t bytes = L.floats * sizeof(float);
  cudaError_t e = asy::set_smem(mixer_bwd_kernel<T, kRemat>, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  mixer_bwd_kernel<T, kRemat><<<dim3(fold_h * fold_w * G, B), kThreads, bytes, s>>>(
      (const T*)x, (const T*)gout, stats, (const T*)wf, bf, (const T*)wv, bv,
      (const T*)w2, ab, (const T*)cbest, argf, (const T*)crep, (const T*)oc, scratch,
      dcin, wpart, dab, assign, g, L);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t ebytes = sizeof(float) * ((size_t)std::max(kThreads, C) + (size_t)kTile * M) +
                        sizeof(int) * kTile;
  e = asy::set_smem(mixer_bwd_epilogue<T>, ebytes);
  if (e != cudaSuccess) return (int)e;
  mixer_bwd_epilogue<T><<<dim3(tiles, B), kThreads, ebytes, s>>>(
      (const T*)x, (const T*)gout, stats, scratch, dcin, (T*)dxn, epart, g, tiles);
  return (int)cudaGetLastError();
}

// K6 with the residual pack (cbest, argf, crep, oc all given; assign null);
// K6r without it (all four null), optionally writing the assignment it
// rebuilt to `assign` (B, H, W, heads) int8
template <typename T>
int dispatch(const void* x, const void* gout, const float* stats, const void* wf,
             const float* bf, const void* wv, const float* bv, const void* w2,
             const float* ab, const void* cbest, const int8_t* argf, const void* crep,
             const void* oc, void* dxn, float* scratch, float* dcin, float* wpart,
             float* dab, float* epart, int8_t* assign, int B, int H, int W, int C, int I,
             int heads, int fold_h, int fold_w, int ph, int pw, int G, int tiles,
             void* stream) {
  const int packed = (cbest != nullptr) + (argf != nullptr) + (crep != nullptr) +
                     (oc != nullptr);
  if (packed == 4 && assign == nullptr)
    return launch<T, false>(x, gout, stats, wf, bf, wv, bv, w2, ab, cbest, argf, crep, oc,
                            dxn, scratch, dcin, wpart, dab, epart, nullptr, B, H, W, C, I,
                            heads, fold_h, fold_w, ph, pw, G, tiles, stream);
  if (packed == 0)
    return launch<T, true>(x, gout, stats, wf, bf, wv, bv, w2, ab, nullptr, nullptr,
                           nullptr, nullptr, dxn, scratch, dcin, wpart, dab, epart, assign,
                           B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, tiles, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The number of head groups to launch with: the smallest divisor of heads,
// at least `min_groups`, whose block fits in the card's shared memory (each
// group owns heads / G heads' columns); -1 if none does.
int mixer_block_bwd_groups(int C, int I, int heads, int ph, int pw, int min_groups,
                           int remat) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess || C <= 0 || heads <= 0 || I % heads)
    return -1;
  for (int G = std::max(1, min_groups); G <= heads; ++G) {
    if (heads % G) continue;
    const Geo g = make_geo(1, 1, 1, C, I, heads, 1, 1, ph, pw, G, remat != 0);
    if (layout(g, remat != 0).floats * sizeof(float) <= (size_t)optin) return G;
  }
  return -1;
}

int mixer_block_bwd_bf16(const void* x, const void* g, const float* stats,
                         const void* wf, const float* bf, const void* wv,
                         const float* bv, const void* w2, const float* ab,
                         const void* cbest, const int8_t* argf, const void* crep,
                         const void* oc, void* dxn, float* scratch, float* dcin,
                         float* wpart, float* dab, float* epart, int8_t* assign, int B,
                         int H, int W, int C, int I, int heads, int fold_h, int fold_w,
                         int ph, int pw, int G, int tiles, void* stream) {
  return dispatch<__nv_bfloat16>(x, g, stats, wf, bf, wv, bv, w2, ab, cbest, argf, crep,
                                 oc, dxn, scratch, dcin, wpart, dab, epart, assign, B, H, W,
                                 C, I, heads, fold_h, fold_w, ph, pw, G, tiles, stream);
}

int mixer_block_bwd_f32(const void* x, const void* g, const float* stats,
                        const void* wf, const float* bf, const void* wv,
                        const float* bv, const void* w2, const float* ab,
                        const void* cbest, const int8_t* argf, const void* crep,
                        const void* oc, void* dxn, float* scratch, float* dcin,
                        float* wpart, float* dab, float* epart, int8_t* assign, int B,
                        int H, int W, int C, int I, int heads, int fold_h, int fold_w,
                        int ph, int pw, int G, int tiles, void* stream) {
  return dispatch<float>(x, g, stats, wf, bf, wv, bv, w2, ab, cbest, argf, crep, oc, dxn,
                         scratch, dcin, wpart, dab, epart, assign, B, H, W, C, I, heads,
                         fold_h, fold_w, ph, pw, G, tiles, stream);
}

}  // extern "C"
