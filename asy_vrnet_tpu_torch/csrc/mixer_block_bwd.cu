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
// _mixer_bwd_tail.  Before the sweeps a block rebuilds what K2's phase A
// computes for its heads, with K2's own device code (mixer_block.cuh): the
// pooled centers, projected and normalised.  Its first sweep rebuilds, per
// (token, head), the cosines, the first max and the winner's sigmoid, and
// keeps the winner (proposal, cosine, raw product) in a buffer of the call
// (`asg`, `win`: 9 bytes a (token, head), freed by the caller when the call
// returns), which its second sweep reads as K6 reads the pack: one
// assignment per call.  With the counts and the sim-weighted sums of xn in
// K2's fixed token splits and K2's mixed centers, it differentiates the
// assignment K2 made, bit for bit, and the raw plane's cotangent takes the
// remat's own raw product.
//
// The TPU kernel's dense masked (rows x tokens) planes are not carried
// over: everything is per (token, head) at the winner.  Roundings to the
// working type where that kernel casts to its matrix-unit type.
//
// What bounds it on the H100: per token ~6*C*I flops (feat recompute, dfeat
// @ wf^T, xn^T dfeat) plus ~4*C*heads, against 6*C bytes of bf16 traffic
// (K6r: + 2*C*I + 2*I*(M+1) for the forward remat, and no pack to read):
// bound by bytes on paper at every nano shape.  In practice by latency: a
// block sweeps its region's tokens twice in order, with short dependent
// steps between barriers.  The design keeps those steps short:
//   - the three C x I products of a token run on tensor cores in bf16
//     (mma.sync m16n8k16, f32 accumulate, ldmatrix fragments from bf16
//     tiles: feat on K2's path; the dxn share d feat @ wf^T and dWf = xn^T d
//     feat here), when C % 16 == 0 and the head width % 8 == 0
//     (asy::mix::feat_on_tc, the one test K2, K6 and K6r take); the
//     operands are the values the CUDA-core path rounds to, so only the f32
//     accumulation order differs from it.  f32 and other widths: FMA chains
//     on CUDA cores;
//   - every sum over a chunk's tokens is spread over the whole block, each
//     partial with one owner thread, added in a fixed order (no float
//     atomics): the pooled centers (K2's pool_centers), the counts (and
//     K6r's sums of xn, for K2's order) in K2's token classes (agg_chunk),
//     the other sim-weighted sums and the d centers with the M <= 4 sums of
//     a task in registers (wsum_chunk), dbf in token classes;
//   - the next chunk of x and g is staged with cp.async while the current
//     one computes, and normalised in shared memory; the group's wf and wv
//     columns stay in shared memory, and its w2 rows take the sweeps'
//     buffers between the sweeps;
//   - a block with an SM's shared memory to itself runs 512 threads (a
//     second instantiation), so that 16 warps hide each other's latency.
//
// Design.  Two kernels.
//   1. One block per (sample, region, head group); the caller picks the
//      number G of head groups so that the batch's regions fill the card.
//      The group's wf and wv columns are staged in shared memory (wf as
//      bf16 tiles on the tensor-core path).  Phase A: the pooled centers
//      (K6r: projected and normalised, K2's phase A).  Sweep 1 over the
//      region's tokens in chunks of 32: per (head, proposal) counts, sum of
//      sims, and the sim-weighted sums of xn and g (K6r rebuilding each
//      chunk's feat and assignment first and keeping each winner for sweep
//      2).  Then, with the w2 rows staged, the per-(head, proposal) algebra
//      (K6r: the mixed centers first): fc2-projected centers, d oc, d agg,
//      d aggx, and the block's columns of dW2, dWv and dbv, which need no
//      further token pass.  Sweep 2 (K6r reading its winners back): feat of the block's columns, per (token, head) the
//      winner's d sim, d alpha/beta, d raw and d norm (8 lanes each), d feat
//      with the d centers and dbf sums, then the two products: the block's
//      share of dxn (dispatch of d aggx plus d feat @ wf^T) to an f32
//      scratch plane of its head group, and dWf += xn^T d feat in shared
//      memory.  Last, d c_rep -> dWf, dbf and d cin (the pooled rows'
//      cotangent) of its columns.
//   2. One block per epi_tile(C) tokens of a sample (8 a thread): dxn = sum
//      of the G scratch planes + pool^T (sum over groups of d cin), rounded
//      once; GroupNorm sums and db2 per block.
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
using asy::mix::kSplit;  // token classes of the sim-weighted sums (K2's)
constexpr int kThreads = 256;     // threads of an epilogue block, and of a main block
constexpr int kMaxThreads = 512;  // ... that has an SM to itself (shared memory)
constexpr int kEpiRows = 8;   // tokens per thread of the epilogue
constexpr int kMaxItems = 2;  // (token, head) items a thread prefetches a chunk: hpc <= 16
constexpr int kMaxM = 4;      // proposals whose sums wsum_chunk keeps in registers

struct Geo {
  int B, H, W, C, I, heads, D, fold_h, fold_w, rh, rw, N, ph, pw, M;
  int G, hpc, Dg, P;  // head groups, heads per group, its columns, hpc*M
  int Dk;             // Dg rounded up to 16: the k extent of the dxn product
  int sd;             // token classes of the d centers and dbf sums
  int tc;             // the products on tensor cores (asy::mix::feat_on_tc)
  int ldx, ldw, ldd;  // row strides (elements) of the x/g chunks, the wf and d feat tiles
  int ldp;            // row stride (floats) of dWf: float2 fragments fall on disjoint banks
  int sx, sg;         // token classes of the xn and g sums (1: wsum_chunk's registers)
  int threads;        // of a main block
};

// tokens per epilogue block: kEpiRows for each of the 256 / C threads that
// share a channel
inline int epi_tile(int C) { return kEpiRows * std::max(1, kThreads / C); }

template <typename T>
inline Geo make_geo(int B, int H, int W, int C, int I, int heads, int fold_h, int fold_w,
                    int ph, int pw, int G, bool remat, int threads) {
  const int rh = H / fold_h, rw = W / fold_w, D = I / heads, hpc = heads / G, Dg = hpc * D;
  const int tc = asy::mix::feat_on_tc<T>(C, D), Dk = (Dg + 15) / 16 * 16;
  // rows padded by 16 bytes, so that ldmatrix's 8 row reads of a bf16 tile
  // fall on disjoint banks; the FMA path's wf rows by one element (its
  // threads read down a column)
  const int pad = 16 / (int)sizeof(T);
  return Geo{B, H, W, C, I, heads, D, fold_h, fold_w, rh, rw, rh * rw, ph, pw, ph * pw,
             G, hpc, Dg, hpc * ph * pw, Dk, std::max(1, std::min(kChunk, threads / Dg)), tc,
             C + pad, tc ? Dk + 8 : Dg + 1, tc ? Dk + 8 : Dg + pad, (Dg + 23) / 32 * 32 + 8,
             remat || ph * pw > kMaxM ? kSplit : 1, ph * pw > kMaxM ? kSplit : 1, threads};
}

struct Lay {  // byte offsets into the dynamic shared memory, 16-byte aligned
  size_t xb, gb, dfs, fs, w2s, wfs, wvs, cbs, sg, ag, drw, dn2, rawc, cin, cn, invc, ocb, dagg, ocw,
      daggx, cnt, rsum, drs, icnt, accx, rsp, cntp, accg, pdwf, pdbs, dcs, dcp, crp, cnr, vcr,
      invr, red, bytes;
};

// remat: the K6r buffers (the winner's raw product, K2's centers)
inline Lay layout(const Geo& g, size_t esz, bool remat) {
  Lay L;
  size_t o = 0;
  auto put = [&](size_t& at, size_t bytes) {
    at = o;
    o += (bytes + 15) / 16 * 16;
  };
  const size_t f = sizeof(float), C = g.C, P = g.P, D = g.D, Q = (size_t)kChunk * g.hpc;
  const size_t MD = (size_t)g.M * g.Dg;
  // the sweeps' buffers; between the sweeps the group's w2 rows take their
  // place
  put(L.xb, 2 * kChunk * g.ldx * esz);
  put(L.gb, 2 * kChunk * g.ldx * esz);
  put(L.dfs, kChunk * g.ldd * esz);
  put(L.fs, kChunk * (g.Dg + kLanes) * f);
  L.w2s = L.xb;
  o = std::max(o, L.w2s + (g.Dg * C * esz + 15) / 16 * 16);
  put(L.wfs, C * g.ldw * esz);
  put(L.wvs, C * g.ldw * esz);
  put(L.cbs, Q * f);
  put(L.sg, Q * f);
  put(L.ag, Q * f);
  put(L.drw, Q * f);
  put(L.dn2, Q * f);
  put(L.rawc, remat ? Q * f : 0);
  put(L.cin, g.M * C * f);
  put(L.cn, P * D * f);
  put(L.invc, P * f);
  put(L.ocb, P * D * f);
  put(L.dagg, P * D * f);
  put(L.ocw, P * C * f);
  put(L.daggx, P * C * f);
  put(L.cnt, P * f);
  put(L.rsum, P * f);
  put(L.drs, P * f);
  put(L.icnt, P * f);
  put(L.accx, g.sx * P * C * f);
  put(L.rsp, kSplit * P * f);
  put(L.cntp, kSplit * P * f);
  put(L.accg, g.sg * P * C * f);
  put(L.pdwf, C * g.ldp * f);
  put(L.pdbs, (size_t)g.sd * g.Dg * f);
  put(L.dcs, (size_t)g.sd * P * D * f);
  put(L.dcp, MD * f);
  put(L.crp, remat ? MD * f : 0);
  put(L.cnr, remat ? MD * f : 0);
  put(L.vcr, remat ? MD * f : 0);
  put(L.invr, remat ? (size_t)g.M * g.hpc * f : 0);
  put(L.red, 2 * (g.threads / 32) * f);
  L.bytes = o;
  return L;
}

// The main kernel's geometry and shared-memory layout (into L): kThreads a
// block, or kMaxThreads where a block has an SM's shared memory to itself,
// so that twice the warps hide each other's latency
template <typename T>
inline Geo plan(int B, int H, int W, int C, int I, int heads, int fold_h, int fold_w, int ph,
                int pw, int G, bool remat, Lay& L) {
  int dev = 0, per_sm = 0, reserved = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  Geo g = make_geo<T>(B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, remat, kThreads);
  L = layout(g, sizeof(T), remat);
  if (2 * (L.bytes + reserved) > (size_t)per_sm) {
    g = make_geo<T>(B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, remat, kMaxThreads);
    L = layout(g, sizeof(T), remat);
  }
  return g;
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

// Sums of rnd(sim) * u(t, c) (and with kV of rnd(sim) * v(t, c)) over a
// chunk's nt tokens per (head hl, winner m), added to au[(hl*M + m)*C + c]
// (and av), for M <= kMaxM: task (hl, c) keeps its M sums in registers over
// the tokens in order, so no step waits on shared memory it has just
// written (agg_chunk's per-split rows do).  Each accumulator has one owner
// thread.
template <typename T, bool kV, typename UIN, typename VIN>
__device__ void wsum_chunk(UIN u, VIN v, const float* sg, const float* ag, int nt, int hpc,
                           int M, int C, float* au, float* av) {
  for (int e = threadIdx.x; e < hpc * C; e += blockDim.x) {
    const int hl = e / C, c = e % C;
    float su[kMaxM] = {}, sv[kMaxM] = {};
    for (int t = 0; t < nt; ++t) {
      const int q = t * hpc + hl, m = (int)ag[q];
      const float w = asy::rnd<T>(sg[q]), x = u(t, c), y = kV ? v(t, c) : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxM; ++i) {
        su[i] = fmaf(i == m ? w : 0.f, x, su[i]);
        if (kV) sv[i] = fmaf(i == m ? w : 0.f, y, sv[i]);
      }
    }
    for (int i = 0; i < M; ++i) {
      au[(hl * M + i) * C + c] += su[i];
      if (kV) av[(hl * M + i) * C + c] += sv[i];
    }
  }
}

// Instantiated for kT = kThreads and kMaxThreads threads a block (see
// plan).  The register bound follows the CTAs an SM holds at the nano
// shapes: 3 of K6 at kThreads (stage 0), 2 of K6r, 1 at kMaxThreads.
// `asg` and `win` (K6r: the winners its first sweep writes and its second
// reads back) are neither const nor restrict: those reads must see the
// block's own writes.
template <typename T, bool kRemat, int kT>
__global__ void __launch_bounds__(kT, kT == kThreads ? (kRemat ? 2 : 3) : 1)
mixer_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gout,
                 const float* __restrict__ stats, const T* __restrict__ wf,
                 const float* __restrict__ bf, const T* __restrict__ wv,
                 const float* __restrict__ bv, const T* __restrict__ w2,
                 const float* __restrict__ ab, const T* __restrict__ cbest,
                 const int8_t* __restrict__ argf, const T* __restrict__ crep,
                 const T* __restrict__ ocr, float* __restrict__ scratch,
                 float* __restrict__ dcin, float* __restrict__ wpart,
                 float* __restrict__ dab, int8_t* asg, float2* win, Geo g, Lay L, int vx,
                 int vw, int v2) {
  using asy::from_f;
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  char* sb = reinterpret_cast<char*>(smem4);
  auto fl = [&](size_t o) { return reinterpret_cast<float*>(sb + o); };
  T* xbuf = reinterpret_cast<T*>(sb + L.xb);  // [2][kChunk][ldx] x staged, then rounded xn
  T* gbuf = reinterpret_cast<T*>(sb + L.gb);  // [2][kChunk][ldx] g staged
  T* wfs = reinterpret_cast<T*>(sb + L.wfs);  // [C][ldw] the group's wf columns
  T* wvs = reinterpret_cast<T*>(sb + L.wvs);  // [C][ldw] the group's wv columns
  T* w2s = reinterpret_cast<T*>(sb + L.w2s);  // [Dg][C] its w2 rows (between the sweeps)
  T* dfs = reinterpret_cast<T*>(sb + L.dfs);  // [kChunk][ldd] d feat, rounded
  float* fs = fl(L.fs);        // [kChunk][DP] feat (f32) of the group's columns
  float* cbs = fl(L.cbs);      // [kChunk][hpc] winning cosine
  float* sg = fl(L.sg);        // [kChunk][hpc] winner sigmoid
  float* ag = fl(L.ag);        // [kChunk][hpc] winning proposal (-1: no token)
  float* drw = fl(L.drw);      // [kChunk][hpc] rounded d raw at the winner
  float* dn2 = fl(L.dn2);      // [kChunk][hpc] rounded d norm^2
  float* rawc = fl(L.rawc);    // [kChunk][hpc] K6r: the winner's raw product
  float* cin = fl(L.cin);      // [M][C] pooled xn (rounded)
  float* cn = fl(L.cn);        // [P][D] centers (f32), then normalised
  float* invc = fl(L.invc);    // [P] center inverse norms
  float* ocb = fl(L.ocb);      // [P][D] mixed centers (rounded)
  float* dagg = fl(L.dagg);    // [P][D] d agg (= d value centers), f32
  float* ocw = fl(L.ocw);      // [P][C] fc2-projected centers (rounded)
  float* daggx = fl(L.daggx);  // [P][C] d aggx (rounded)
  float* cnt = fl(L.cnt);      // [P] counts; later <cn, dcn>
  float* rsum = fl(L.rsum);    // [P] sum of sims
  float* drs = fl(L.drs);      // [P] d rowsum(sim)
  float* icnt = fl(L.icnt);    // [P] 1 / (count + 1)
  float* accx = fl(L.accx);    // [sx][P][C] split sums of sim * xn; split 0: aggx
  float* rsp = fl(L.rsp);      // [kSplit][P] split sums of sims
  float* cntp = fl(L.cntp);    // [kSplit][P] split counts
  float* accg = fl(L.accg);    // [sg][P][C] split sums of sim * g; split 0: docw
  float* pdwf = fl(L.pdwf);    // [C][ldp] dWf of the group's columns
  float* pdbs = fl(L.pdbs);    // [sd][Dg] split dbf; split 0: dbf
  float* dcs = fl(L.dcs);      // [sd][P][D] split d normalised centers; split 0: dcn
  float* dcp = fl(L.dcp);      // [M][Dg] d c_rep of the group's columns
  float* crp = fl(L.crp);      // K6r, K2's layout: [M][Dg] raw centers (f32)
  float* cnr = fl(L.cnr);      //   [M][Dg] normalised centers (rounded)
  float* vcr = fl(L.vcr);      //   [M][Dg] value centers (f32)
  float* invr_c = fl(L.invr);  //   [M][hpc] center inverse norms
  float* red = fl(L.red);
  float* aggx = accx;
  float* docw = accg;

  const int C = g.C, I = g.I, D = g.D, M = g.M, N = g.N, hpc = g.hpc, Dg = g.Dg, P = g.P;
  const int DP = Dg + kLanes, ldx = g.ldx, ldw = g.ldw, ldd = g.ldd;
  constexpr int nth = kT;
  const int tid = threadIdx.x, sub = tid % kLanes;
  const int r = blockIdx.x / g.G, grp = blockIdx.x % g.G, b = blockIdx.y;
  const size_t br = (size_t)b * g.fold_h * g.fold_w + r;
  const size_t rowlen = (size_t)3 * C * I + 2 * I;
  float* wrow = wpart + br * rowlen;
  const int col0 = grp * Dg, h0 = grp * hpc;
  const int row0 = (r / g.fold_w) * g.rh, cl0 = (r % g.fold_w) * g.rw;
  const float mu = stats[2 * b], rstd = stats[2 * b + 1];
  const float alpha = ab[0], beta = ab[1];
  const int nch = (N + kChunk - 1) / kChunk;
  const size_t plane = (size_t)g.B * g.H * g.W * C;
  bool on_tc = false;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) on_tc = g.tc != 0;
  auto tok = [&](int n) -> size_t {  // token index in (B, H, W)
    return (size_t)(b * g.H + row0 + n / g.rw) * g.W + cl0 + n % g.rw;
  };
  auto norm_in = [&](size_t o) { return rnd<T>((to_f<T>(x[o]) - mu) * rstd); };
  auto wf_at = [&](int c, int j) { return to_f<T>(wfs[c * ldw + j]); };
  auto wv_at = [&](int c, int j) { return to_f<T>(wvs[c * ldw + j]); };
  auto chunk_x = [&](int k) { return xbuf + (k & 1) * kChunk * ldx; };
  auto chunk_g = [&](int k) { return gbuf + (k & 1) * kChunk * ldx; };
  // chunk k of the two sweeps (region tokens (k mod nch) * kChunk on) into
  // buffer k % 2, one cp.async group
  auto stage = [&](int k) {
    if (k >= 2 * nch) return;
    const int n0 = (k % nch) * kChunk, nt = min(kChunk, N - n0);
    asy::stage_rows(chunk_x(k), ldx, [&](int t) { return x + tok(n0 + t) * C; }, kChunk, nt,
                    C, vx);
    asy::stage_rows(chunk_g(k), ldx, [&](int t) { return gout + tok(n0 + t) * C; }, kChunk,
                    nt, C, vx);
    asy::cp_async_commit();
  };
  // The (token, head) winners of a chunk, fetched into registers one chunk
  // ahead: K6 reads the pack (both sweeps), K6r what its first sweep wrote
  // (second sweep).
  struct Items {
    float cb[kMaxItems], raw[kMaxItems];
    int a[kMaxItems];
  };
  auto fetch = [&](int k, Items& it) {
    if (k >= 2 * nch || (kRemat && k < nch)) return;
    const int n0 = (k % nch) * kChunk, nt = min(kChunk, N - n0);
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int e = tid + i * nth, t = e / hpc, hl = e % hpc;
      it.cb[i] = it.raw[i] = 0.f;
      it.a[i] = -1;
      if (e < kChunk * hpc && t < nt) {
        const size_t o = tok(n0 + t) * g.heads + h0 + hl;
        if constexpr (kRemat) {
          const float2 w = win[o];
          it.cb[i] = w.x;
          it.raw[i] = w.y;
          it.a[i] = asg[o];
        } else {
          it.cb[i] = to_f<T>(cbest[o]);
          it.a[i] = argf[o];
        }
      }
    }
  };
  auto put_items = [&](const Items& it) {
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int e = tid + i * nth;
      if (e >= kChunk * hpc) continue;
      const bool ok = it.a[i] >= 0;
      cbs[e] = it.cb[i];
      // K6r: the logit as assign() formed it, so the same sigmoid
      sg[e] = !ok ? 0.f
                  : asy::mix::sigmoid(kRemat ? __fmaf_rn(alpha, it.cb[i], beta)
                                             : beta + alpha * it.cb[i]);
      ag[e] = (float)it.a[i];
      if (kRemat) rawc[e] = it.raw[i];
    }
  };
  // feat of the chunk xs (rounded xn): K2's device code, on K2's path
  auto feat = [&](const T* xs) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (on_tc) {
        asy::mix::feat_chunk_mma(
            [&](int mt, int kk, uint32_t(&a)[4]) {
              asy::ldmatrix_a(a, xs + mt * 16 * ldx + kk * 16, ldx);
            },
            [&](int nt8, int kk, uint32_t& b0, uint32_t& b1) {
              asy::ldmatrix_b(b0, b1, wfs + kk * 16 * ldw + nt8 * 8, ldw);
            },
            bf + col0, C, Dg, DP, fs);
        return;
      }
    }
    asy::mix::feat_chunk<T>(
        [&](int t, int c4) {
          const T* p = xs + t * ldx + 4 * c4;
          return make_float4(to_f<T>(p[0]), to_f<T>(p[1]), to_f<T>(p[2]), to_f<T>(p[3]));
        },
        C, wf_at, bf + col0, Dg, DP, fs);
  };
  // Start of chunk k: its copies landed, the next chunk's start, xn
  // normalised in place and the chunk's winners in shared memory.
  Items items;
  auto begin_chunk = [&](int k) {
    const int nt = min(kChunk, N - (k % nch) * kChunk);
    T* xs = chunk_x(k);
    asy::cp_async_wait<0>();
    __syncthreads();  // chunk k staged; chunk k - 1 done with buffer (k + 1) % 2
    // the next chunk, unless it starts sweep 2: its copies wait for the w2
    // rows, and K6r's winners for the end of sweep 1
    if (k + 1 != nch) stage(k + 1);
    for (int e = tid; e < kChunk * C / 4; e += nth) {  // 4 channels a step (C % 4 == 0)
      const int t = e / (C / 4);
      T* p = xs + t * ldx + 4 * (e - t * (C / 4));
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = from_f<T>(t < nt ? (to_f<T>(p[u]) - mu) * rstd : 0.f);
    }
    if (!kRemat || k >= nch) put_items(items);
    if (k + 1 != nch) fetch(k + 1, items);
    __syncthreads();
  };

  // ---- the weights and the first chunk in flight; zeroed accumulators ----
  asy::stage_rows(wfs, ldw, [&](int c) { return wf + (size_t)c * I + col0; }, C, C, Dg, vw);
  asy::stage_rows(wvs, ldw, [&](int c) { return wv + (size_t)c * I + col0; }, C, C, Dg, vw);
  asy::cp_async_commit();
  stage(0);
  for (int e = tid; e < C * (ldw - Dg); e += nth)  // zero k padding (tensor cores)
    wfs[(e / (ldw - Dg)) * ldw + Dg + e % (ldw - Dg)] = from_f<T>(0.f);
  for (int e = tid; e < g.sx * P * C; e += nth) accx[e] = 0.f;
  for (int e = tid; e < g.sg * P * C; e += nth) accg[e] = 0.f;
  for (int e = tid; e < kSplit * P; e += nth) rsp[e] = cntp[e] = 0.f;
  for (int e = tid; e < C * g.ldp; e += nth) pdwf[e] = 0.f;
  for (int e = tid; e < g.sd * Dg; e += nth) pdbs[e] = 0.f;
  for (int e = tid; e < g.sd * P * D; e += nth) dcs[e] = 0.f;
  fetch(0, items);
  asy::cp_async_wait<1>();  // the weights (the first chunk may still be in flight)
  __syncthreads();

  // ---- phase A: the pooled centers (K6r: K2's centers of the group) ----
  asy::mix::pool_centers<T>([&](int n, int c) { return norm_in(tok(n) * C + c); }, C, D, M,
                            g.rh, g.rw, g.ph, g.pw, fs, cin, 0, 1);
  if (kRemat) {
    asy::mix::project_centers(wf_at, wv_at, bf + col0, bv + col0, C, Dg, D, hpc, M, cin, crp,
                              vcr, invr_c);
    asy::mix::normalise_centers<T>(crp, invr_c, cnr, M, Dg, D, hpc);
  }

  // ---- sweep 1: counts, sums of sims, sim-weighted sums of xn and g ----
  for (int k = 0; k < nch; ++k) {
    const int n0 = k * kChunk, nt = min(kChunk, N - n0);
    begin_chunk(k);
    const T* xs = chunk_x(k);
    const T* gs = chunk_g(k);
    if (kRemat) {  // the chunk's feat and K2's assignment of its (token, head) items
      feat(xs);
      __syncthreads();
      // kChunk*hpc items, a multiple of the 4 a warp takes, so every lane of
      // a warp runs the same iterations of the shuffles
      for (int it = tid / kLanes; it < kChunk * hpc; it += nth / kLanes) {
        const int t = it % kChunk, hl = it / kChunk, q = t * hpc + hl;
        const asy::mix::Winner w =
            asy::mix::assign<T>(fs + t * DP + hl * D, cnr + hl * D, Dg, D, M, alpha, beta, sub);
        if (sub == 0) {
          const bool ok = t < nt;
          sg[q] = ok ? asy::mix::sigmoid(w.best) : 0.f;
          ag[q] = ok ? (float)w.arg : -1.f;
          if (ok) {
            const size_t o = tok(n0 + t) * g.heads + h0 + hl;
            asg[o] = (int8_t)w.arg;
            win[o] = make_float2(w.cos, w.raw);
          }
        }
      }
      __syncthreads();
    }
    // the counts, the sums of sims and (K6r, or M > kMaxM) the sums of xn in
    // K2's token classes (K6r: K2's order, so K2's mixed centers); the other
    // weighted sums in registers, into split 0
    auto xin = [&](int t, int c) { return to_f<T>(xs[t * ldx + c]); };
    auto gin = [&](int t, int c) { return to_f<T>(gs[t * ldx + c]); };
    auto arg = [&](int q) { return (int)ag[q]; };
    if (g.sx > 1)
      asy::mix::agg_chunk<T, true>(xin, sg, arg, nt, hpc, M, C, kSplit, accx, rsp, cntp);
    else
      asy::mix::agg_chunk<T, false>(xin, sg, arg, nt, hpc, M, C, kSplit, accx, rsp, cntp);
    if (g.sg > 1)
      asy::mix::agg_chunk<T, true, false>(gin, sg, arg, nt, hpc, M, C, kSplit, accg, nullptr,
                                          nullptr);
    else if (g.sx == 1)
      wsum_chunk<T, true>(gin, xin, sg, ag, nt, hpc, M, C, accg, accx);
    else
      wsum_chunk<T, false>(gin, xin, sg, ag, nt, hpc, M, C, accg, nullptr);
  }
  __syncthreads();
  fetch(nch, items);
  asy::stage_rows(w2s, C, [&](int j) { return w2 + (size_t)(col0 + j) * C; }, Dg, Dg, C, v2);
  asy::cp_async_commit();
  asy::cp_async_wait<0>();
  __syncthreads();

  // ---- per (head, proposal) algebra ----
  asy::mix::sum_splits<T, false>(accx, P, C, g.sx);  // aggx
  asy::mix::sum_splits<T, true>(accg, P, C, g.sg);   // docw, rounded
  for (int e = tid; e < P; e += nth) {
    float rsv = 0.f, n = 0.f;
    for (int sp = 0; sp < kSplit; ++sp) {
      rsv += rsp[sp * P + e];
      n += cntp[sp * P + e];
    }
    rsum[e] = rsv;
    cnt[e] = n;
    icnt[e] = 1.f / (n + 1.f);
  }
  if (!kRemat) {
    for (int e = tid; e < P * D; e += nth) {
      const int hm = e / D, d = e % D;
      const size_t o = ((br * g.heads + h0 + hm / M) * M + hm % M) * D + d;
      cn[e] = to_f<T>(crep[o]);
      ocb[e] = to_f<T>(ocr[o]);
    }
  }
  __syncthreads();
  if (kRemat) {  // K2's raw and mixed centers, in this kernel's [P][D] layout
    for (int e = tid; e < P * D; e += nth) {
      const int hm = e / D, hl = hm / M, m = hm % M, j = hl * D + e % D;
      cn[e] = crp[m * Dg + j];
      ocb[e] = asy::mix::mixed_center<T>(aggx + hm * C, [&](int c) { return wv_at(c, j); }, C,
                                         rsum[hm], bv[col0 + j], vcr[m * Dg + j], cnt[hm]);
    }
    __syncthreads();
  }
  for (int e = tid; e < P; e += nth) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(cn[e * D + d], cn[e * D + d], s);
    invc[e] = rsqrtf(s + 1e-12f);
  }
  for (int e = tid; e < P * C; e += nth) {  // oc @ w2 of the head
    const int hm = e / C, c = e % C, j0 = (hm / M) * D;
    float a = 0.f;
    for (int d = 0; d < D; ++d)
      a = fmaf(ocb[hm * D + d], to_f<T>(w2s[(j0 + d) * C + c]), a);
    ocw[e] = rnd<T>(a);
  }
  for (int e = tid; e < P * D; e += nth) {  // d oc -> d agg
    const int hm = e / D, d = e % D;
    const T* wr = w2s + ((hm / M) * D + d) * C;
    float a = 0.f;
    for (int c = 0; c < C; ++c) a = fmaf(docw[hm * C + c], to_f<T>(wr[c]), a);
    dagg[e] = a * icnt[hm];
  }
  for (int e = tid; e < Dg * C; e += nth) {  // dW2 rows: oc^T d(oc @ w2)
    const int j = e / C, c = e % C, hl = j / D, d = j % D;
    float a = 0.f;
    for (int m = 0; m < M; ++m)
      a = fmaf(ocb[(hl * M + m) * D + d], docw[(hl * M + m) * C + c], a);
    wrow[(size_t)2 * C * I + (size_t)(col0 + j) * C + c] = a;
  }
  __syncthreads();
  for (int e = tid; e < P * D; e += nth) cn[e] *= invc[e / D];
  for (int e = tid; e < P * C; e += nth) {  // d aggx = d agg @ wv^T
    const int hm = e / C, c = e % C, j0 = (hm / M) * D;
    float a = 0.f;
    for (int d = 0; d < D; ++d) a = fmaf(rnd<T>(dagg[hm * D + d]), wv_at(c, j0 + d), a);
    daggx[e] = rnd<T>(a);
  }
  for (int e = tid; e < P; e += nth) {
    const int j0 = (e / M) * D;
    float a = 0.f;
    for (int d = 0; d < D; ++d) a = fmaf(dagg[e * D + d], bv[col0 + j0 + d], a);
    drs[e] = a;
  }
  for (int e = tid; e < C * Dg; e += nth) {  // dWv: aggregation + value centers
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
  for (int j = tid; j < Dg; j += nth) {  // dbv
    const int hl = j / D, d = j % D;
    float a = 0.f, s = 0.f;
    for (int m = 0; m < M; ++m) {
      const int hm = hl * M + m;
      a = fmaf(rnd<T>(rsum[hm]), rnd<T>(dagg[hm * D + d]), a);
      s += dagg[hm * D + d];
    }
    wrow[(size_t)3 * C * I + I + col0 + j] = a + s;
  }

  // ---- sweep 2: the similarity and feat cotangents, the two products ----
  __syncthreads();  // the w2 rows read: their buffers take the chunks again
  stage(nch);
  for (int e = tid; e < kChunk * (ldd - Dg); e += nth)  // zero k padding
    dfs[(e / (ldd - Dg)) * ldd + Dg + e % (ldd - Dg)] = from_f<T>(0.f);
  float sa = 0.f, sbt = 0.f;  // d alpha, d beta of this thread's items
  for (int k = nch; k < 2 * nch; ++k) {
    const int n0 = (k - nch) * kChunk, nt = min(kChunk, N - n0);
    begin_chunk(k);
    const T* xs = chunk_x(k);
    const T* gs = chunk_g(k);
    feat(xs);
    __syncthreads();
    // per (token, head), kLanes lanes each (every lane of a warp runs the
    // same iterations of the shuffles, as in sweep 1)
    for (int it = tid / kLanes; it < kChunk * hpc; it += nth / kLanes) {
      const int t = it % kChunk, hl = it / kChunk, q = t * hpc + hl;
      const float n2 = asy::mix::head_norm2<T>(fs + t * DP + hl * D, D, sub);
      const int hm = hl * M + max(0, (int)ag[q]);
      float ds = 0.f;
      for (int c = sub; c < C; c += kLanes)
        ds = fmaf(ocw[hm * C + c], to_f<T>(gs[t * ldx + c]),
                  fmaf(daggx[hm * C + c], to_f<T>(xs[t * ldx + c]), ds));
      ds = asy::mix::lane_sum(ds);
      if (sub == 0) {
        float dr = 0.f, dn = 0.f;
        if (t < nt) {
          const float inv = rsqrtf(n2 + 1e-12f), invr = rnd<T>(inv);
          const float cb = cbs[q], s = sg[q];
          const float sig = (ds + drs[hm]) * (s * (1.f - s));
          const float dcos = sig * alpha;
          sa = fmaf(sig, cb, sa);
          sbt += sig;
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
    // d feat (rounded into dfs), with the d centers (winner rows) and dbf
    // summed in sd token classes: task (s, j) takes tokens s, s + sd, ...,
    // its d centers in registers (M <= kMaxM) as wsum_chunk keeps them
    for (int e = tid; e < g.sd * Dg; e += nth) {
      const int s = e / Dg, j = e % Dg, hl = j / D, d = j % D;
      float* dc = dcs + (size_t)s * P * D + hl * M * D + d;
      float bs = 0.f, dm[kMaxM] = {};
      for (int t = s; t < kChunk; t += g.sd) {
        float v = 0.f;
        if (t < nt) {
          const int q = t * hpc + hl, m = (int)ag[q];
          const float f = fs[t * DP + j], dr = drw[q];
          v = dr * rnd<T>(cn[(hl * M + m) * D + d]) + 2.f * f * dn2[q];
          if (M <= kMaxM) {
#pragma unroll
            for (int i = 0; i < kMaxM; ++i) dm[i] = fmaf(i == m ? dr : 0.f, rnd<T>(f), dm[i]);
          } else {
            dc[m * D] = fmaf(dr, rnd<T>(f), dc[m * D]);
          }
          bs += v;
        }
        dfs[t * ldd + j] = from_f<T>(v);
      }
      if (M <= kMaxM)
        for (int i = 0; i < M; ++i) dc[i * D] += dm[i];
      pdbs[e] += bs;
    }
    __syncthreads();
    bool products_on_tc = false;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (on_tc) {
        products_on_tc = true;
        const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
        // the group's share of dxn: dispatch of d aggx + d feat @ wf^T, tiles
        // of 16 tokens x 8 channels, Dk/16 k-steps over the group's columns
        for (int i = warp; i < 2 * (C / 8); i += nth / 32) {
          const int mt = i & 1, nt8 = i >> 1;
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
          for (int kk = 0; kk < g.Dk / 16; ++kk) {
            uint32_t a[4], b0, b1;
            asy::ldmatrix_a(a, dfs + mt * 16 * ldd + kk * 16, ldd);
            asy::ldmatrix_bt(b0, b1, wfs + nt8 * 8 * ldw + kk * 16, ldw);
            asy::mma16816(d4, a, b0, b1);
          }
          const int c = nt8 * 8 + 2 * tq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = mt * 16 + gq + 8 * h;
            float a0 = 0.f, a1 = 0.f;
            for (int hl = 0; hl < hpc; ++hl) {
              const int q = t * hpc + hl, m = (int)ag[q];
              if (m >= 0) {
                const float s = rnd<T>(sg[q]);
                const float* dx = daggx + (hl * M + m) * C + c;
                a0 = fmaf(s, dx[0], a0);
                a1 = fmaf(s, dx[1], a1);
              }
            }
            if (t < nt)
              *reinterpret_cast<float2*>(scratch + grp * plane + tok(n0 + t) * C + c) =
                  make_float2(a0 + d4[2 * h], a1 + d4[2 * h + 1]);
          }
        }
        // dWf += xn^T d feat: tiles of 16 channels x 8 columns, two k-steps
        // of 16 tokens; each element has one owner lane
        for (int i = warp; i < (C / 16) * (Dg / 8); i += nth / 32) {
          const int mt = i % (C / 16), nt8 = i / (C / 16);
          float d4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {
            uint32_t a[4], b0, b1;
            asy::ldmatrix_at(a, xs + kk * 16 * ldx + mt * 16, ldx);
            asy::ldmatrix_b(b0, b1, dfs + kk * 16 * ldd + nt8 * 8, ldd);
            asy::mma16816(d4, a, b0, b1);
          }
          float2* p = reinterpret_cast<float2*>(pdwf + (mt * 16 + gq) * g.ldp + nt8 * 8 + 2 * tq);
          float2* p8 = p + 4 * g.ldp;  // 8 rows on
          *p = make_float2(p->x + d4[0], p->y + d4[1]);
          *p8 = make_float2(p8->x + d4[2], p8->y + d4[3]);
        }
      }
    }
    if (!products_on_tc) {
      // the same two products as FMA chains: thread (tq, c) owns tokens
      // 4*tq .. 4*tq + 3 of the dxn share
      for (int e = tid; e < (kChunk / 4) * C; e += nth) {
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
          for (int u = 0; u < 4; ++u)
            acc[u] = fmaf(to_f<T>(dfs[(4 * tq + u) * ldd + j]), w, acc[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = 4 * tq + u;
          if (t < nt) scratch[grp * plane + tok(n0 + t) * C + c] = acc[u];
        }
      }
      for (int e = tid; e < C * Dg; e += nth) {  // dWf: xn^T d feat
        const int c = e / Dg, j = e % Dg;
        float a = pdwf[c * g.ldp + j];
        for (int t = 0; t < nt; ++t)
          a = fmaf(to_f<T>(xs[t * ldx + c]), to_f<T>(dfs[t * ldd + j]), a);
        pdwf[c * g.ldp + j] = a;
      }
    }
  }
  __syncthreads();

  // ---- centers: cn = c_rep * inv_c, c_rep = pool(xn) @ wf + bf ----
  asy::mix::sum_splits<T, false>(dcs, P, D, g.sd);   // d cn
  asy::mix::sum_splits<T, false>(pdbs, 1, Dg, g.sd);  // dbf's token part
  __syncthreads();
  const float* dcn = dcs;
  const float* pdbf = pdbs;
  for (int e = tid; e < P; e += nth) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(cn[e * D + d], dcn[e * D + d], s);
    cnt[e] = s;
  }
  __syncthreads();
  for (int e = tid; e < M * Dg; e += nth) {
    const int m = e / Dg, j = e % Dg, hm = (j / D) * M + m, d = j % D;
    dcp[e] = invc[hm] * (dcn[hm * D + d] - cn[hm * D + d] * cnt[hm]);
  }
  __syncthreads();
  for (int e = tid; e < C * Dg; e += nth) {
    const int c = e / Dg, j = e % Dg;
    float a = pdwf[c * g.ldp + j];
    for (int m = 0; m < M; ++m) a = fmaf(cin[m * C + c], rnd<T>(dcp[m * Dg + j]), a);
    wrow[(size_t)c * I + col0 + j] = a;
  }
  for (int j = tid; j < Dg; j += nth) {
    float a = pdbf[j];
    for (int m = 0; m < M; ++m) a += dcp[m * Dg + j];
    wrow[(size_t)3 * C * I + col0 + j] = a;
  }
  for (int e = tid; e < M * C; e += nth) {  // d cin of the group's columns
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
    sbt += __shfl_down_sync(0xffffffffu, sbt, off);
  }
  const int warps = nth / 32;
  if ((tid & 31) == 0) {
    red[tid >> 5] = sa;
    red[warps + (tid >> 5)] = sbt;
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

// One block per `tile` tokens of a sample; thread (tq, c) takes channel c
// of tokens tq, tq + nq, ... (kEpiRows of them).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mixer_bwd_epilogue(const T* __restrict__ x, const T* __restrict__ gout,
                   const float* __restrict__ stats, const float* __restrict__ scratch,
                   const float* __restrict__ dcin, T* __restrict__ dxn,
                   float* __restrict__ epart, Geo g, int tiles, int tile) {
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int C = g.C, M = g.M, HW = g.H * g.W;
  float* red2 = reinterpret_cast<float*>(smem4);  // [nq][C] db2 partials
  float* pwt = red2 + max(kThreads, C);           // [tile][M] pooling weights
  int* rof = reinterpret_cast<int*>(pwt + tile * M);  // [tile] region of the token
  __shared__ float red[2 * (kThreads / 32)];
  const int n0 = blockIdx.x * tile, nt = min(tile, HW - n0);
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
  float* row = epart + ((size_t)b * tiles + blockIdx.x) * (2 + C);
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

// the main kernel's instantiation for `threads` a block
template <typename T, bool kRemat>
inline auto main_kernel(int threads) {
  return threads == kThreads ? mixer_bwd_kernel<T, kRemat, kThreads>
                             : mixer_bwd_kernel<T, kRemat, kMaxThreads>;
}

template <typename T, bool kRemat>
int launch(const void* x, const void* gout, const float* stats, const void* wf,
           const float* bf, const void* wv, const float* bv, const void* w2,
           const float* ab, const void* cbest, const int8_t* argf, const void* crep,
           const void* oc, void* dxn, float* scratch, float* dcin, float* wpart,
           float* dab, float* epart, int8_t* assign, float* win, int B, int H, int W, int C,
           int I, int heads, int fold_h, int fold_w, int ph, int pw, int G, int tiles, int tc,
           void* stream) {
  if (B <= 0 || C <= 0 || C % 4 || heads <= 0 || I % heads || fold_h <= 0 || fold_w <= 0 ||
      H % fold_h || W % fold_w || ph <= 0 || pw <= 0 || ph * pw > 127 || G <= 0 ||
      heads % G || heads / G > kMaxItems * kThreads / kChunk ||
      tiles != (H * W + epi_tile(C) - 1) / epi_tile(C))
    return (int)cudaErrorInvalidValue;
  Lay L;
  const Geo g = plan<T>(B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, kRemat, L);
  // tc: the products on tensor cores, as the caller counts it; refused
  // unless it is the kernel's own choice
  if ((tc != 0) != (g.tc != 0) || g.rh < ph || g.rw < pw) return (int)cudaErrorInvalidValue;
  const size_t sz = sizeof(T);
  const int vx = asy::copy_bytes({(size_t)x, (size_t)gout, C * sz, (size_t)g.ldx * sz});
  const int vw = asy::copy_bytes({(size_t)wf, (size_t)wv, (size_t)g.Dg * sz, (size_t)I * sz,
                                  (size_t)g.ldw * sz});
  const int v2 = asy::copy_bytes({(size_t)w2, C * sz});
  const auto k = main_kernel<T, kRemat>(g.threads);
  cudaError_t e = asy::set_smem(k, L.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  k<<<dim3(fold_h * fold_w * G, B), g.threads, L.bytes, s>>>(
      (const T*)x, (const T*)gout, stats, (const T*)wf, bf, (const T*)wv, bv,
      (const T*)w2, ab, (const T*)cbest, argf, (const T*)crep, (const T*)oc, scratch,
      dcin, wpart, dab, assign, reinterpret_cast<float2*>(win), g, L, vx, vw, v2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tile = epi_tile(C);
  const size_t ebytes = sizeof(float) * ((size_t)std::max(kThreads, C) + (size_t)tile * g.M) +
                        sizeof(int) * tile;
  e = asy::set_smem(mixer_bwd_epilogue<T>, ebytes);
  if (e != cudaSuccess) return (int)e;
  mixer_bwd_epilogue<T><<<dim3(tiles, B), kThreads, ebytes, s>>>(
      (const T*)x, (const T*)gout, stats, scratch, dcin, (T*)dxn, epart, g, tiles, tile);
  return (int)cudaGetLastError();
}

// K6 with the residual pack (cbest, argf, crep, oc all given; assign and
// win null); K6r without it (all four null), writing the assignment it
// rebuilds to `assign` (B, H, W, heads) int8 and the winners' (cosine, raw
// product) to `win` (B, H, W, heads, 2) f32, both required
template <typename T>
int dispatch(const void* x, const void* gout, const float* stats, const void* wf,
             const float* bf, const void* wv, const float* bv, const void* w2,
             const float* ab, const void* cbest, const int8_t* argf, const void* crep,
             const void* oc, void* dxn, float* scratch, float* dcin, float* wpart,
             float* dab, float* epart, int8_t* assign, float* win, int B, int H, int W, int C,
             int I, int heads, int fold_h, int fold_w, int ph, int pw, int G, int tiles, int tc,
             void* stream) {
  const int packed = (cbest != nullptr) + (argf != nullptr) + (crep != nullptr) +
                     (oc != nullptr);
  if (packed == 4 && assign == nullptr && win == nullptr)
    return launch<T, false>(x, gout, stats, wf, bf, wv, bv, w2, ab, cbest, argf, crep, oc,
                            dxn, scratch, dcin, wpart, dab, epart, nullptr, nullptr, B, H, W,
                            C, I, heads, fold_h, fold_w, ph, pw, G, tiles, tc, stream);
  if (packed == 0 && assign != nullptr && win != nullptr)
    return launch<T, true>(x, gout, stats, wf, bf, wv, bv, w2, ab, nullptr, nullptr,
                           nullptr, nullptr, dxn, scratch, dcin, wpart, dab, epart, assign,
                           win, B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, tiles, tc,
                           stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int groups(int C, int I, int heads, int ph, int pw, int min_groups, int remat) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess || C <= 0 || heads <= 0 || I % heads)
    return -1;
  for (int G = std::max(1, min_groups); G <= heads; ++G) {
    if (heads % G || heads / G > kMaxItems * kThreads / kChunk) continue;
    Lay L;
    plan<T>(1, 1, 1, C, I, heads, 1, 1, ph, pw, G, remat != 0, L);
    if (L.bytes <= (size_t)optin) return G;
  }
  return -1;
}

template <typename T>
int info(int C, int I, int heads, int ph, int pw, int G, int remat, int* out) {
  if (C <= 0 || heads <= 0 || I % heads || G <= 0 || heads % G)
    return (int)cudaErrorInvalidValue;
  Lay L;
  const Geo g = plan<T>(1, 1, 1, C, I, heads, 1, 1, ph, pw, G, remat != 0, L);
  const size_t smem = L.bytes;
  const auto k = remat ? main_kernel<T, true>(g.threads) : main_kernel<T, false>(g.threads);
  cudaError_t e = asy::set_smem(k, smem);
  int per_sm = 0;
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, g.threads, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)smem;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = g.threads;
  return 0;
}

}  // namespace

extern "C" {

// The number of head groups to launch with: the smallest divisor of heads,
// at least `min_groups`, whose block fits in the card's shared memory (each
// group owns heads / G heads' columns); -1 if none does.  esz: 2 (bf16) or
// 4 (f32).
int mixer_block_bwd_groups(int esz, int C, int I, int heads, int ph, int pw, int min_groups,
                           int remat) {
  return esz == 2 ? groups<__nv_bfloat16>(C, I, heads, ph, pw, min_groups, remat)
                  : groups<float>(C, I, heads, ph, pw, min_groups, remat);
}

// The main kernel (K6, or K6r with `remat`) as launched with G head groups:
// out = [dynamic shared memory bytes, CTAs per SM, registers per thread,
// threads per CTA]
int mixer_block_bwd_info(int esz, int C, int I, int heads, int ph, int pw, int G, int remat,
                         int* out) {
  return esz == 2 ? info<__nv_bfloat16>(C, I, heads, ph, pw, G, remat, out)
                  : info<float>(C, I, heads, ph, pw, G, remat, out);
}

int mixer_block_bwd_bf16(const void* x, const void* g, const float* stats,
                         const void* wf, const float* bf, const void* wv,
                         const float* bv, const void* w2, const float* ab,
                         const void* cbest, const int8_t* argf, const void* crep,
                         const void* oc, void* dxn, float* scratch, float* dcin,
                         float* wpart, float* dab, float* epart, int8_t* assign, float* win,
                         int B, int H, int W, int C, int I, int heads, int fold_h, int fold_w,
                         int ph, int pw, int G, int tiles, int tc, void* stream) {
  return dispatch<__nv_bfloat16>(x, g, stats, wf, bf, wv, bv, w2, ab, cbest, argf, crep,
                                 oc, dxn, scratch, dcin, wpart, dab, epart, assign, win, B, H,
                                 W, C, I, heads, fold_h, fold_w, ph, pw, G, tiles, tc, stream);
}

int mixer_block_bwd_f32(const void* x, const void* g, const float* stats,
                        const void* wf, const float* bf, const void* wv,
                        const float* bv, const void* w2, const float* ab,
                        const void* cbest, const int8_t* argf, const void* crep,
                        const void* oc, void* dxn, float* scratch, float* dcin,
                        float* wpart, float* dab, float* epart, int8_t* assign, float* win,
                        int B, int H, int W, int C, int I, int heads, int fold_h, int fold_w,
                        int ph, int pw, int G, int tiles, int tc, void* stream) {
  return dispatch<float>(x, g, stats, wf, bf, wv, bv, w2, ab, cbest, argf, crep, oc, dxn,
                         scratch, dcin, wpart, dab, epart, assign, win, B, H, W, C, I, heads,
                         fold_h, fold_w, ph, pw, G, tiles, tc, stream);
}

}  // extern "C"
