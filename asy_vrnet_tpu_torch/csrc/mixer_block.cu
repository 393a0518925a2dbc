// Mixer half of a ClusterBlock, fused:
//   out = x + fc2(cluster_mix(fc1(xn), fc_v(xn))),  xn = (x - mu) * rstd
// plus per-block partial (sum, sum of squares) of the stored output, which
// the caller reduces (torch sum, deterministic) into the GroupNorm
// statistics the MLP half consumes.  In training it also writes the residual
// pack the backward kernel (mixer_block_bwd.cu) consumes: per (token, head)
// the winning cosine and proposal, per (region, head, proposal) the raw
// pooled center and the mixed center (the TPU kernel's (cbest, argf, c_rep,
// oc), in the port's own layout).
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/block_pallas.py::_mixer_block_pallas
// (kernel _mixer_block_kernel, body _mixer_block_fwd_body), reached through
// fused_mixer_block_stats.  GN affine and LayerScale are folded into the
// weights by the caller.
//
// What bounds it on the H100: per token it reads and writes C bf16 values
// and does ~2*C*I (fc1) + 2*I*(M+1) (norms, cosines) + 4*C*heads
// (aggregate, dispatch) flops, 50-140 flop/byte at the nano shapes: under
// the bf16 tensor-core ridge (~295), so the least time is set by bytes.
// Unfused, the I-wide feat/value maps (I = 96..256 against C = 16..160)
// would cross device memory several times.  In practice the kernel is bound
// by latency: a region's tokens are swept in order by one cluster, with
// short per-(token, head) work between barriers, and at batch 8 the grid is
// 64-512 CTAs, one wave.
//
// Design.  The TPU kernel's dense masked per-head/per-region matmuls (~16x
// redundant flops) are not carried over.  Each (sample, region) is one
// thread-block cluster of G CTAs (G divides heads, G <= 8; the caller picks
// G = 1 when there are at least as many regions as SMs, since every CTA of
// a cluster sweeps its whole region, and a larger G where a block would not
// fit in shared memory); CTA g owns heads [g*hpc, (g+1)*hpc), hpc = heads/G,
// i.e. the Dg = I/G columns of those heads.  It stages its fc1/fc_v columns
// and fc2 rows in shared memory once (cp.async), so no phase reads a weight
// from device memory again:
//   A. pool the region's proposal windows in INPUT space (adaptive average of
//      xn) over all 256 threads, each CTA of the cluster a 1/G share of the
//      channels, the rows then swapped through distributed shared memory;
//      project the M pooled rows with the CTA's fc1/fc_v columns,
//      L2-normalise per head;
//   B. sweep the region's tokens in chunks of 32, staged raw with cp.async
//      (chunk n + 1 loads while chunk n computes; three buffers) and
//      normalised as they are read; two barriers a chunk.  feat of the
//      chunk's columns on tensor cores (bf16: mma.sync m16n8k16, ldmatrix
//      fragments, the normalisation applied to the A fragments; f32 and
//      widths off the tensor-core shapes: FMA chains on CUDA cores); per
//      (token, head) (8 lanes each) cosine to the M centers, first-max
//      argmax on the pre-sigmoid logit beta + alpha*cos (strict >), sigmoid
//      of the winner; one chunk behind, accumulate sim * xn per (head,
//      center) in INPUT space, the sums of sims and the counts, in 4 fixed
//      token splits, each accumulator with one owner thread (deterministic,
//      no atomics);
//   C. finish the centers ((agg @ wv + rs*bv + v_c) / (count + 1)) and fold
//      fc2 into them; the cluster then swaps fc2-projected centers and
//      (token, head) assignments through distributed shared memory, and
//      each CTA dispatches 1/G of the region's tokens over all heads, adds
//      the residual, writes the output and reduces its moments.
// feat is never stored, so a 1024-token region (the p3 neck block) needs no
// more shared memory than its chunks.
//
// Wide layout (kWide), for a block that fits in shared memory at no split G
// (C = 512-640 with 8 or 4 heads): fc_v and fc2 stay in device memory (read
// where the centers are projected and folded, once a region, L2-resident),
// two chunk buffers instead of three (chunk k is aggregated right after its
// assignment, behind a third barrier, so chunk k + 1 may load over chunk
// k - 1), and the fc2-projected centers are not gathered: the dispatch reads
// each head's from the CTA that owns it through distributed shared memory.
// The same operations in the same order: the bits of the base layout.
//
// Numerics mirror the TPU kernel: xn, feat (for the cosine), feat^2 (for the
// norms), the token inverse norms, the centers, the sims, the aggregated
// centers and the fc2-projected centers are rounded to the working type where
// that kernel casts them to its matrix-unit type; every sum is f32, in a
// fixed order.  The pooling, feat, the assignment and the split sums are the
// device code of mixer_block.cuh, which the full-remat backward (K6r) runs
// too, so that it rebuilds this kernel's assignment bit for bit (K6 takes
// the same feat).
//
// Prefixes (the ablation tool, asy_vrnet_tpu_torch/tools/ablate_mixer_fwd.py;
// it replaces the TPU tool tools/ablate_mixer_fwd.py:252).  The template
// constant kStop cuts the body after a phase: gn (B's chunk loads: normalise,
// round), centers (+ A), feat (+ B1, feat of every chunk), sim (+ B2: the
// assignment, the winner's sigmoid, rs and cnt), agg (+ the split
// aggregation and C's mixed centers), full (+ the fc2 fold, the cluster
// swap, the dispatch and the moments: this kernel).  kNf takes the
// normalise-first similarity of the TPU's folded kernel (featn, cosm: the M
// cosines without the max, then sim, agg, full).  A cut prefix sums, in f32,
// what its phases computed for the CTA's heads that no later phase of the
// prefix reads (its checksum s, so that no phase's work is dead), writes
// rnd(x + s) for the tokens the CTA dispatches (K2's output bytes) and stores
// (s, sum of |terms|) in `part`.  Every prefix launches as K2 does (the same
// shared-memory layout, block, cluster); the launcher pads a prefix's shared
// memory if it would otherwise fit more CTAs on an SM than K2.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mixer_block.cuh"

namespace cg = cooperative_groups;

namespace {

using asy::mix::kChunk;  // tokens per sweep-B chunk
using asy::mix::kLanes;  // lanes per (token, head) in the assignment
using asy::mix::kSplit;  // fixed token splits of the aggregation
constexpr int kThreads = 256;
constexpr int kBufs = 3;  // chunk buffers: load n + 1, feat n, aggregate n - 1
constexpr int kWideBufs = 2;  // the wide layout's: load n + 1, feat and aggregate n

// where a prefix stops (kCosm: the normalise-first variant only)
constexpr int kGn = 0, kCenters = 1, kFeat = 2, kCosm = 3, kSim = 4, kAgg = 5, kFull = 6;

struct Geo {
  int B, H, W, C, I, heads, D, fold_h, fold_w, rh, rw, N, ph, pw, M;
  int G, hpc, nper;  // CTAs per cluster, heads per CTA, dispatch tokens per CTA
  int tc;            // feat on tensor cores
  int wide;          // the wide layout (see above)
  int sx, sw;        // row strides (elements) of the staged chunks and wf/wv columns
  int vec;           // bytes per cp.async copy (0: plain loads)
};

struct Smem {  // byte offsets, each 16-byte aligned
  size_t wf, wv, w2, xs, fs, cin, cn, vc, aggp, rsp, cntp, ocw_own, ocw_all, invc, red, sg,
      sg_all, asg, asg_all, bytes;
};

template <typename T>
inline Geo make_geo(int B, int H, int W, int C, int I, int heads, int fold_h, int fold_w,
                    int ph, int pw, int G, int tc) {
  const int rh = H / fold_h, rw = W / fold_w, n = rh * rw, dg = I / G;
  // rows padded so that a row starts 16 bytes on from its neighbour's bank:
  // ldmatrix's 8 row reads then fall on disjoint banks
  return Geo{B, H, W, C, I, heads, I / heads, fold_h, fold_w, rh, rw, n, ph, pw, ph * pw,
             G, heads / G, (n + G - 1) / G, tc, 0, C + 16 / (int)sizeof(T),
             (dg + 15) / 16 * 16 + 8, 0};
}

inline Smem smem_layout(const Geo& g, size_t esz) {
  const size_t dg = (size_t)g.hpc * g.D, mc = (size_t)g.M * g.C, f = sizeof(float);
  const size_t gathered = g.G > 1;  // the *_all buffers exist only in clusters
  const size_t staged = !g.wide;    // fc_v, fc2 and the gathered centers (base layout)
  Smem s;
  size_t o = 0;
  auto put = [&](size_t& at, size_t bytes) {
    at = o;
    o = (o + bytes + 15) / 16 * 16;
  };
  put(s.wf, (size_t)g.C * g.sw * esz);
  put(s.wv, staged * g.C * g.sw * esz);
  put(s.w2, staged * dg * g.C * esz);
  put(s.xs, (size_t)(g.wide ? kWideBufs : kBufs) * kChunk * g.sx * esz);
  put(s.fs, std::max((size_t)kChunk * (dg + kLanes), (size_t)g.M * dg) * f);
  put(s.cin, mc * f);
  put(s.cn, g.M * dg * f);
  put(s.vc, g.M * dg * f);
  put(s.aggp, (size_t)kSplit * g.hpc * mc * f);
  put(s.rsp, (size_t)kSplit * g.hpc * g.M * f);
  put(s.cntp, (size_t)kSplit * g.hpc * g.M * f);
  put(s.ocw_own, g.hpc * mc * f);
  put(s.ocw_all, staged * gathered * g.heads * mc * f);
  put(s.invc, (size_t)g.hpc * g.M * f);
  put(s.red, 2 * (kThreads / 32) * f);
  put(s.sg, (size_t)g.N * g.hpc * f);
  put(s.sg_all, gathered * g.nper * g.heads * f);
  put(s.asg, (size_t)g.N * g.hpc);
  put(s.asg_all, gathered * g.nper * g.heads);
  s.bytes = o;
  return s;
}

template <typename T, int kStop = kFull, bool kNf = false, bool kWide = false>
__global__ void __launch_bounds__(kThreads)
mixer_block_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   const T* __restrict__ wf, const float* __restrict__ bf,
                   const T* __restrict__ wv, const float* __restrict__ bv,
                   const T* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ ab, T* __restrict__ out,
                   float* __restrict__ part, int8_t* __restrict__ assign_out,
                   T* __restrict__ cbest_out, T* __restrict__ crep_out,
                   T* __restrict__ oc_out, Geo g, Smem L) {
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = g.C, I = g.I, heads = g.heads, D = g.D, M = g.M, N = g.N;
  // feat rows padded by kLanes: the 4 tokens of a warp in the assignment
  // loop (8 lanes each) then fall on disjoint banks
  const int hpc = g.hpc, G = g.G, Dg = hpc * D, DP = Dg + kLanes, SX = g.sx, SW = g.sw;
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  auto fl = [&](size_t o) { return reinterpret_cast<float*>(sb + o); };
  T* wfs = reinterpret_cast<T*>(sb + L.wf);  // [C][SW] the CTA's fc1 columns
  T* wvs = reinterpret_cast<T*>(sb + L.wv);  // [C][SW] its fc_v columns (base layout)
  T* w2s = reinterpret_cast<T*>(sb + L.w2);  // [Dg][C] its fc2 rows (base layout)
  T* xsb = reinterpret_cast<T*>(sb + L.xs);  // [bufs][kChunk][SX] raw input chunks
  float* fs = fl(L.fs);                      // [kChunk][DP] feat chunk; later oc [M][Dg]
  float* cin = fl(L.cin);                    // [M][C] pooled input rows
  float* cn = fl(L.cn);                      // [M][Dg] normalised centers (own heads)
  float* vc = fl(L.vc);                      // [M][Dg] value centers
  float* aggp = fl(L.aggp);                  // [kSplit][hpc][M][C] partial sim*xn sums
  float* rs = fl(L.rsp);                     // [kSplit][hpc][M] sums of sims (then split 0)
  float* cnt = fl(L.cntp);                   // [kSplit][hpc][M] counts (then split 0)
  float* ocw_own = fl(L.ocw_own);            // [hpc][M][C] fc2-projected centers
  float* ocw_all = fl(L.ocw_all);            // [heads][M][C] gathered (base layout)
  float* invc = fl(L.invc);                  // [M][hpc]
  float* red = fl(L.red);                    // [2][warps]
  float* sg = fl(L.sg);                      // [N][hpc] winner sigmoid
  float* sg_all = fl(L.sg_all);              // [nper][heads]
  unsigned char* asg = sb + L.asg;           // [N][hpc] winner index
  unsigned char* asg_all = sb + L.asg_all;   // [nper][heads]

  const int tid = threadIdx.x;
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.x / G, b = blockIdx.y;
  const int col0 = rank * Dg;  // first fc1/fc_v column of the CTA's heads
  const int row0 = (r / g.fold_w) * g.rh, cl0 = (r % g.fold_w) * g.rw;
  const float mu = stats[2 * b], rstd = stats[2 * b + 1];
  const float alpha = ab[0], beta = ab[1];
  auto tok = [&](int n) -> size_t {
    return ((size_t)(b * g.H + row0 + n / g.rw) * g.W + cl0 + n % g.rw) * C;
  };
  auto norm_in = [&](T v) -> float { return rnd<T>((to_f<T>(v) - mu) * rstd); };
  // residual pack: center row (region, head, proposal), head-major
  auto center = [&](int m, int j) -> size_t {
    const int h = rank * hpc + j / D;
    return ((((size_t)b * (gridDim.x / G) + r) * heads + h) * M + m) * D + j % D;
  };

  // a cut prefix's checksum and the sum of its terms' magnitudes (per thread)
  constexpr int kCos = kNf ? kCosm : kSim;  // the first stop that reads cn
  float chk = 0.f, mag = 0.f;
  auto take = [&](float v) {
    chk += v;
    mag += fabsf(v);
  };

  // ---- staging (cp.async): the CTA's weights, then the first chunk ----
  // A chunk is staged raw and normalised as it is read (rnd((x - mu) *
  // rstd), the same bits as norm_in): no pass, no barrier of its own.
  constexpr int bufs = kWide ? kWideBufs : kBufs;
  const int chunks = (N + kChunk - 1) / kChunk;
  auto chunk = [&](int k) -> const T* { return xsb + (k % bufs) * kChunk * SX; };
  auto load_chunk = [&](int k) {
    const int n0 = k * kChunk;
    asy::stage_rows(xsb + (k % bufs) * kChunk * SX, SX,
                    [&](int t) { return x + tok(n0 + t); }, kChunk, min(kChunk, N - n0), C,
                    g.vec);
    asy::cp_async_commit();
  };
  if constexpr (kStop >= kCenters) {
    asy::stage_rows(wfs, SW, [&](int c) { return wf + (size_t)c * I + col0; }, C, C, Dg,
                    g.vec);
    if constexpr (!kWide)
      asy::stage_rows(wvs, SW, [&](int c) { return wv + (size_t)c * I + col0; }, C, C, Dg,
                      g.vec);
    if constexpr (kStop == kFull && !kWide)
      asy::stage_rows(w2s, C, [&](int j) { return w2 + (size_t)(col0 + j) * C; }, Dg, Dg, C,
                      g.vec);
    asy::cp_async_commit();
  }
  load_chunk(0);
  for (int e = tid; e < kSplit * hpc * M * C; e += kThreads) aggp[e] = 0.f;
  for (int e = tid; e < kSplit * hpc * M; e += kThreads) rs[e] = cnt[e] = 0.f;

  // ---- A. centers: adaptive-average pool in input space, then project ----
  auto wf_col = [&](int c, int j) { return to_f<T>(wfs[c * SW + j]); };
  auto wv_col = [&](int c, int j) {
    if constexpr (kWide)
      return to_f<T>(wv[(size_t)c * I + col0 + j]);
    else
      return to_f<T>(wvs[c * SW + j]);
  };
  if constexpr (kStop >= kCenters) {
    asy::cp_async_wait<1>();  // the weights (the first chunk may still be in flight)
    // the cluster's CTAs pool a share of the channels each, then swap rows
    asy::mix::pool_centers<T>([&](int n, int c) { return norm_in(x[tok(n) + c]); }, C, D, M,
                              g.rh, g.rw, g.ph, g.pw, fs, cin, rank, G);
    if (G > 1) {
      cluster.sync();
      for (int e = tid; e < M * C; e += kThreads) {
        const int p = asy::mix::pool_part(e % C, C, G);
        if (p != rank) cin[e] = cluster.map_shared_rank(cin, p)[e];
      }
      cluster.sync();  // no CTA goes on to overwrite or leave while a peer reads
    }
    asy::mix::project_centers(wf_col, wv_col, bf + col0, bv + col0, C, Dg, D, hpc, M, cin, cn,
                              vc, invc);
    if (crep_out != nullptr) {
      for (int e = tid; e < M * Dg; e += kThreads)
        crep_out[center(e / Dg, e % Dg)] = asy::from_f<T>(cn[e]);
    }
    asy::mix::normalise_centers<T>(cn, invc, cn, M, Dg, D, hpc);
    if constexpr (kStop < kCos)
      for (int e = tid; e < M * Dg; e += kThreads) take(cn[e]);
    if constexpr (kStop < kAgg)
      for (int e = tid; e < M * Dg; e += kThreads) take(vc[e]);
  }

  // ---- B. assign + aggregate, chunk by chunk ----
  // Iteration k: chunk k + 1 loads while chunk k's feat and assignment and
  // chunk k - 1's aggregation run; two barriers per chunk (wide layout:
  // chunk k's aggregation, after a third).
  const int sub = tid % kLanes;
  auto xn_at = [&](const T* xb, int t, int c) { return norm_in(xb[t * SX + c]); };
  auto aggregate = [&](int k) {  // the split sums of chunk k
    const int n0 = k * kChunk;
    const T* xb = chunk(k);
    asy::mix::agg_chunk<T, kStop >= kAgg>(
        [&](int t, int c) { return xn_at(xb, t, c); }, sg + n0 * hpc,
        [&](int q) { return (int)asg[n0 * hpc + q]; }, min(kChunk, N - n0), hpc, M, C,
        kSplit, aggp, rs, cnt);
  };
  for (int k = 0; k < chunks; ++k) {
    const int n0 = k * kChunk, nt = min(kChunk, N - n0);
    const T* xb = chunk(k);
    asy::cp_async_wait<0>();
    __syncthreads();  // chunk k staged; k - 1's assignment and k - 2's (wide: k - 1's)
                      // aggregation done
    if (k + 1 < chunks) load_chunk(k + 1);
    if constexpr (kStop < kFeat) {
      for (int e = tid; e < nt * C; e += kThreads) take(xn_at(xb, e / C, e % C));
      continue;
    }
    bool on_tc = false;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) on_tc = g.tc != 0;
    if (on_tc) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        auto norm_pair = [&](uint32_t v) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
          return asy::pack_bf16((__bfloat162float(h.x) - mu) * rstd,
                                (__bfloat162float(h.y) - mu) * rstd);
        };
        asy::mix::feat_chunk_mma(
            [&](int mt, int kk, uint32_t(&a)[4]) {
              asy::ldmatrix_a(a, xb + mt * 16 * SX + kk * 16, SX);
#pragma unroll
              for (int i = 0; i < 4; ++i) a[i] = norm_pair(a[i]);
            },
            [&](int nt_, int kk, uint32_t& b0, uint32_t& b1) {
              asy::ldmatrix_b(b0, b1, wfs + kk * 16 * SW + nt_ * 8, SW);
            },
            bf + col0, C, Dg, DP, fs);
      }
    } else {
      asy::mix::feat_chunk<T>(
          [&](int t, int c4) {
            const T* p = xb + t * SX + 4 * c4;
            return make_float4(norm_in(p[0]), norm_in(p[1]), norm_in(p[2]), norm_in(p[3]));
          },
          C, wf_col, bf + col0, Dg, DP, fs);
    }
    __syncthreads();  // feat of chunk k in fs
    if constexpr (kStop == kFeat && !kNf) {
      for (int e = tid; e < nt * Dg; e += kThreads) take(fs[(e / Dg) * DP + e % Dg]);
    } else {
      // per (token, head), kLanes lanes each: cosine to the M centers and
      // the first-max assignment.  kChunk*hpc items is a multiple of the 32
      // items a pass covers, so every lane of a warp runs the same
      // iterations.
      for (int it = tid / kLanes; it < kChunk * hpc; it += kThreads / kLanes) {
        const int t = it % kChunk, hl = it / kChunk;
        float* f = fs + t * DP + hl * D;
        if constexpr (kNf) {
          asy::mix::normalise_feat<T>(f, D, sub);
          if constexpr (kStop == kFeat) {
            if (t < nt)
              for (int d = sub; d < D; d += kLanes) take(f[d]);
            continue;
          }
          if constexpr (kStop == kCosm) {
            for (int m = 0; m < M; ++m) {
              const float cs = asy::mix::cos_nf(f, cn + m * Dg + hl * D, D, sub);
              if (sub == 0 && t < nt) take(cs);
            }
            continue;
          }
        }
        asy::mix::Winner win;
        if constexpr (kNf)
          win = asy::mix::assign_nf(f, cn + hl * D, Dg, D, M, alpha, beta, sub);
        else
          win = asy::mix::assign<T>(f, cn + hl * D, Dg, D, M, alpha, beta, sub);
        if (sub == 0 && t < nt) {
          sg[(n0 + t) * hpc + hl] = asy::mix::sigmoid(win.best);
          asg[(n0 + t) * hpc + hl] = (unsigned char)win.arg;
          if (cbest_out != nullptr)
            cbest_out[tok(n0 + t) / C * heads + rank * hpc + hl] = asy::from_f<T>(win.cos);
        }
      }
    }
    if constexpr (kWide) {
      __syncthreads();  // chunk k's assignment in sg, asg
      aggregate(k);
    } else if constexpr (kStop >= kSim) {
      if (k > 0) aggregate(k - 1);
    }
  }
  if constexpr (kStop >= kSim) {
    __syncthreads();
    if constexpr (!kWide) {
      aggregate(chunks - 1);
      __syncthreads();
    }
    asy::mix::sum_splits<T, false>(rs, hpc * M, 1, kSplit);
    asy::mix::sum_splits<T, false>(cnt, hpc * M, 1, kSplit);
    if constexpr (kStop >= kAgg) asy::mix::sum_splits<T, true>(aggp, hpc * M, C, kSplit);
  }
  __syncthreads();
  if constexpr (kStop == kSim) {
    for (int e = tid; e < hpc * M; e += kThreads) {
      take(rs[e]);
      take((float)(e % M) * cnt[e]);
    }
  }

  // ---- C. finish the CTA's centers, fold fc2 in ----
  float* oc = fs;  // [M][Dg]
  if constexpr (kStop >= kAgg) {
    for (int e = tid; e < M * Dg; e += kThreads) {
      const int m = e / Dg, j = e % Dg, hm = (j / D) * M + m;
      oc[e] = asy::mix::mixed_center<T>(aggp + hm * C, [&](int c) { return wv_col(c, j); }, C,
                                        rs[hm], bv[col0 + j], vc[e], cnt[hm]);
      if (oc_out != nullptr) oc_out[center(m, j)] = asy::from_f<T>(oc[e]);
    }
    __syncthreads();
    if constexpr (kStop == kAgg)
      for (int e = tid; e < M * Dg; e += kThreads) take(oc[e]);
  }
  const int warps = kThreads / 32;
  const int n_lo = rank * g.nper;  // the CTA's dispatch tokens
  const int nd = max(0, min(N, n_lo + g.nper) - n_lo);
  if constexpr (kStop < kFull) {
    // the cut prefix's output: rnd(x + s) for the tokens the CTA dispatches
    for (int off = 16; off > 0; off >>= 1) {
      chk += __shfl_down_sync(0xffffffffu, chk, off);
      mag += __shfl_down_sync(0xffffffffu, mag, off);
    }
    if ((tid & 31) == 0) {
      red[tid >> 5] = chk;
      red[warps + (tid >> 5)] = mag;
    }
    __syncthreads();
    float s = 0.f, sa = 0.f;
    for (int w = 0; w < warps; ++w) {
      s += red[w];
      sa += red[warps + w];
    }
    for (int e = tid; e < nd * C; e += kThreads) {
      const size_t o = tok(n_lo + e / C) + e % C;
      out[o] = asy::from_f<T>(to_f<T>(x[o]) + s);
    }
    if (tid == 0) {
      const size_t p = ((size_t)b * gridDim.x + blockIdx.x) * 2;
      part[p] = s;
      part[p + 1] = sa;
    }
  } else {
    for (int e = tid; e < hpc * M * C; e += kThreads) {
      const int c = e % C, hm = e / C, hl = hm / M, m = hm % M;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) {
        const T w = kWide ? w2[(size_t)(col0 + hl * D + d) * C + c] : w2s[(hl * D + d) * C + c];
        acc = fmaf(oc[m * Dg + hl * D + d], to_f<T>(w), acc);
      }
      ocw_own[e] = rnd<T>(acc);
    }
    if (assign_out != nullptr) {
      for (int e = tid; e < N * hpc; e += kThreads)
        assign_out[tok(e / hpc) / C * heads + rank * hpc + e % hpc] = (int8_t)asg[e];
    }

    // ---- swap centers and assignments across the cluster, then dispatch ----
    // (a cluster of one CTA already holds everything in the dispatch layout;
    // the wide layout leaves the centers with their owners)
    const float* ocw_d = ocw_own;      // [heads][M][C]
    const float* sg_d = sg;            // [nd][heads]
    const unsigned char* asg_d = asg;  // [nd][heads]
    if (G > 1) {
      cluster.sync();
      if constexpr (!kWide) {
        for (int e = tid; e < heads * M * C; e += kThreads) {
          const int h = e / (M * C);
          const float* peer = cluster.map_shared_rank(ocw_own, h / hpc);
          ocw_all[e] = peer[(h % hpc) * M * C + e % (M * C)];
        }
      }
      for (int e = tid; e < nd * heads; e += kThreads) {
        const int n = n_lo + e / heads, h = e % heads, p = h / hpc;
        sg_all[e] = cluster.map_shared_rank(sg, p)[n * hpc + h % hpc];
        asg_all[e] = cluster.map_shared_rank(asg, p)[n * hpc + h % hpc];
      }
      if constexpr (kWide)
        __syncthreads();  // peers keep their memory until the cluster.sync after the dispatch
      else
        cluster.sync();  // no CTA leaves while a peer may still read its memory
      if constexpr (!kWide) ocw_d = ocw_all;
      sg_d = sg_all;
      asg_d = asg_all;
    } else {
      __syncthreads();
    }
    // head h's fc2-projected center m (a peer's memory in a wide cluster)
    auto ocw_at = [&](int h, int m) -> const float* {
      if (kWide && G > 1)
        return cluster.map_shared_rank(ocw_own, h / hpc) + ((h % hpc) * M + m) * C;
      return ocw_d + (h * M + m) * C;
    };
    float s1 = 0.f, s2 = 0.f;
    const float rc = 1.f / C;
    for (int e = tid; e < nd * C; e += kThreads) {
      int c;
      const int nl = asy::div_small(e, C, rc, c);
      float y = 0.f;
      for (int h = 0; h < heads; ++h) {
        const int q = nl * heads + h;
        y = fmaf(rnd<T>(sg_d[q]), ocw_at(h, asg_d[q])[c], y);
      }
      const size_t o = tok(n_lo + nl) + c;
      const T v = asy::from_f<T>(to_f<T>(x[o]) + (y + b2[c]));
      out[o] = v;
      const float vf = to_f<T>(v);
      s1 += vf;
      s2 = fmaf(vf, vf, s2);
    }
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_down_sync(0xffffffffu, s1, off);
      s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    if ((tid & 31) == 0) {
      red[tid >> 5] = s1;
      red[warps + (tid >> 5)] = s2;
    }
    __syncthreads();
    if (tid == 0) {
      float a = 0.f, q = 0.f;
      for (int w = 0; w < warps; ++w) {
        a += red[w];
        q += red[warps + w];
      }
      const size_t p = ((size_t)b * gridDim.x + blockIdx.x) * 2;
      part[p] = a;
      part[p + 1] = q;
    }
    if (kWide && G > 1) cluster.sync();  // no CTA leaves while a peer reads its centers
  }
}

// K2's layout (the base one, or with `wide` the wide one) for a region of
// rh x rw tokens split over G CTAs, against the card's shared-memory limit
// per block
template <typename T>
bool fits(int C, int I, int heads, int rh, int rw, int ph, int pw, int G, int wide,
          size_t* bytes) {
  Geo g = make_geo<T>(1, rh, rw, C, I, heads, 1, 1, ph, pw, G, 0);
  g.wide = wide;
  *bytes = smem_layout(g, sizeof(T)).bytes;
  size_t optin = 0, per_sm = 0;
  asy::smem_limits(&optin, &per_sm);
  return *bytes <= optin;
}

// The layout K2 takes at G, the one place that chooses: 0 base, where it
// fits; else 1 wide, where that fits; -1 neither
template <typename T>
int layout(int C, int I, int heads, int rh, int rw, int ph, int pw, int G, size_t* bytes) {
  if (C <= 0 || heads <= 0 || I % heads || G <= 0 || G > 8 || heads % G) return -1;
  if (fits<T>(C, I, heads, rh, rw, ph, pw, G, 0, bytes)) return 0;
  return fits<T>(C, I, heads, rh, rw, ph, pw, G, 1, bytes) ? 1 : -1;
}

// Launches K2 (kStop = kFull, base) or one of its prefixes.  `occupancy`
// (the ablation: 2 ints, the prefix's CTAs per SM as launched and K2's) is
// null for K2 itself; for a prefix, the dynamic shared memory is padded until
// an SM holds no more of its CTAs than of K2's.  tc: feat on tensor cores,
// as the caller counts it; refused unless it is asy::mix::feat_on_tc's own
// choice, so it confirms the path and never selects one.  K2 takes the
// layout that layout() gives at this G.
template <typename T, int kStop, bool kNf>
int launch(const void* x, const float* stats, const void* wf, const float* bf,
           const void* wv, const float* bv, const void* w2, const float* b2,
           const float* ab, void* out, float* part, int8_t* assign, void* cbest,
           void* crep, void* oc, int B, int H, int W, int C, int I, int heads,
           int fold_h, int fold_w, int ph, int pw, int G, int tc, int* occupancy,
           void* stream) {
  if (B <= 0 || C % 4 || heads <= 0 || I % heads || fold_h <= 0 || fold_w <= 0 ||
      H % fold_h || W % fold_w || ph <= 0 || pw <= 0 || ph * pw > 255 || G <= 0 ||
      G > 8 || heads % G)
    return (int)cudaErrorInvalidValue;
  if ((tc != 0) != asy::mix::feat_on_tc<T>(C, I / heads)) return (int)cudaErrorInvalidValue;
  Geo g = make_geo<T>(B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, tc != 0);
  if (g.rh < ph || g.rw < pw) return (int)cudaErrorInvalidValue;
  const size_t sz = sizeof(T);
  g.vec = asy::copy_bytes({(size_t)x, (size_t)wf, (size_t)wv, (size_t)w2, C * sz,
                           (size_t)g.hpc * g.D * sz, I * sz});
  if (kStop == kFull && !kNf && occupancy == nullptr) {
    size_t bytes = 0;
    g.wide = layout<T>(C, I, heads, g.rh, g.rw, ph, pw, G, &bytes) == 1;
  }
  const Smem L = smem_layout(g, sz);
  const auto kernel = g.wide ? mixer_block_kernel<T, kFull, false, true>
                             : mixer_block_kernel<T, kStop, kNf, false>;
  size_t bytes = L.bytes;
  cudaError_t e = asy::set_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  if (occupancy != nullptr) {
    const auto k2 = mixer_block_kernel<T, kFull, false>;
    int full = 0, mine = 0;
    e = asy::set_smem(k2, L.bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&full, k2, kThreads, L.bytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&mine, kernel, kThreads, bytes);
    while (e == cudaSuccess && mine > full) {
      bytes += 1024;
      e = asy::set_smem(kernel, bytes);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&mine, kernel, kThreads, bytes);
    }
    if (e != cudaSuccess) return (int)e;
    occupancy[0] = mine;
    occupancy[1] = full;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(fold_h * fold_w * G, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = G > 1;  // a single-CTA "cluster" launches as a plain grid
  e = cudaLaunchKernelEx(&cfg, kernel, (const T*)x, stats, (const T*)wf, bf, (const T*)wv,
                         bv, (const T*)w2, b2, ab, (T*)out, part, assign, (T*)cbest,
                         (T*)crep, (T*)oc, g, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One prefix (`stop`, a k* constant; `nf` the normalise-first variant) on
// eval inputs: no residual pack; `assign` (may be null) receives the
// assignment from the full prefixes only.
template <typename T>
int launch_prefix(const void* x, const float* stats, const void* wf, const float* bf,
                  const void* wv, const float* bv, const void* w2, const float* b2,
                  const float* ab, void* out, float* part, int8_t* assign, int B, int H,
                  int W, int C, int I, int heads, int fold_h, int fold_w, int ph, int pw,
                  int G, int tc, int stop, int nf, int* occupancy, void* stream) {
#define ASY_PREFIX(S, NF)                                                                  \
  launch<T, S, NF>(x, stats, wf, bf, wv, bv, w2, b2, ab, out, part, assign, nullptr,      \
                   nullptr, nullptr, B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, tc, \
                   occupancy, stream)
  if (occupancy == nullptr) return (int)cudaErrorInvalidValue;
  if (!nf) {
    switch (stop) {
      case kGn: return ASY_PREFIX(kGn, false);
      case kCenters: return ASY_PREFIX(kCenters, false);
      case kFeat: return ASY_PREFIX(kFeat, false);
      case kSim: return ASY_PREFIX(kSim, false);
      case kAgg: return ASY_PREFIX(kAgg, false);
      case kFull: return ASY_PREFIX(kFull, false);
    }
  } else {
    switch (stop) {
      case kFeat: return ASY_PREFIX(kFeat, true);
      case kCosm: return ASY_PREFIX(kCosm, true);
      case kSim: return ASY_PREFIX(kSim, true);
      case kAgg: return ASY_PREFIX(kAgg, true);
      case kFull: return ASY_PREFIX(kFull, true);
    }
  }
#undef ASY_PREFIX
  return (int)cudaErrorInvalidValue;
}

// The smallest G >= least whose base layout fits; where none does, the
// smallest whose wide layout fits (*wide says which: layout()'s choice at G)
template <typename T>
int groups(int C, int I, int heads, int rh, int rw, int ph, int pw, int least, int* wide) {
  if (C <= 0 || heads <= 0 || I % heads) return -1;
  size_t bytes = 0;
  for (*wide = 0; *wide < 2; ++*wide)
    for (int G = std::max(1, least); G <= std::min(8, heads); ++G)
      if (heads % G == 0 && fits<T>(C, I, heads, rh, rw, ph, pw, G, *wide, &bytes)) return G;
  return -1;
}

// out: [dynamic shared memory bytes, CTAs per SM, registers per thread]
template <typename T>
int info(int C, int I, int heads, int rh, int rw, int ph, int pw, int G, int* out) {
  size_t bytes = 0;
  const int wide = layout<T>(C, I, heads, rh, rw, ph, pw, G, &bytes);
  if (wide < 0) return (int)cudaErrorInvalidValue;
  const auto kernel = wide ? mixer_block_kernel<T, kFull, false, true>
                           : mixer_block_kernel<T, kFull, false, false>;
  cudaError_t e = asy::set_smem(kernel, bytes);
  int per_sm = 0;
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)bytes;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  return 0;
}

}  // namespace

extern "C" {

// assign and the three residual outputs may be null (eval: nothing extra)
int mixer_block_bf16(const void* x, const float* stats, const void* wf,
                     const float* bf, const void* wv, const float* bv,
                     const void* w2, const float* b2, const float* ab, void* out,
                     float* part, int8_t* assign, void* cbest, void* crep, void* oc,
                     int B, int H, int W, int C, int I, int heads, int fold_h,
                     int fold_w, int ph, int pw, int G, int tc, void* stream) {
  return launch<__nv_bfloat16, kFull, false>(x, stats, wf, bf, wv, bv, w2, b2, ab, out,
                                             part, assign, cbest, crep, oc, B, H, W, C, I,
                                             heads, fold_h, fold_w, ph, pw, G, tc, nullptr,
                                             stream);
}

int mixer_block_f32(const void* x, const float* stats, const void* wf,
                    const float* bf, const void* wv, const float* bv,
                    const void* w2, const float* b2, const float* ab, void* out,
                    float* part, int8_t* assign, void* cbest, void* crep, void* oc,
                    int B, int H, int W, int C, int I, int heads, int fold_h,
                    int fold_w, int ph, int pw, int G, int tc, void* stream) {
  return launch<float, kFull, false>(x, stats, wf, bf, wv, bv, w2, b2, ab, out, part,
                                     assign, cbest, crep, oc, B, H, W, C, I, heads, fold_h,
                                     fold_w, ph, pw, G, tc, nullptr, stream);
}

// The ablation's prefixes; `occupancy` receives (this launch's CTAs per SM,
// K2's), `assign` (may be null) the assignment of a full prefix.  stop: 0
// gn, 1 centers, 2 feat (featn with nf), 3 cosm (nf only), 4 sim, 5 agg,
// 6 full (with nf = 0: K2 itself).
int mixer_block_ablate_bf16(const void* x, const float* stats, const void* wf,
                            const float* bf, const void* wv, const float* bv,
                            const void* w2, const float* b2, const float* ab, void* out,
                            float* part, int8_t* assign, int B, int H, int W, int C,
                            int I, int heads, int fold_h, int fold_w, int ph, int pw, int G,
                            int tc, int stop, int nf, int* occupancy, void* stream) {
  return launch_prefix<__nv_bfloat16>(x, stats, wf, bf, wv, bv, w2, b2, ab, out, part, assign,
                                      B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, tc,
                                      stop, nf, occupancy, stream);
}

int mixer_block_ablate_f32(const void* x, const float* stats, const void* wf,
                           const float* bf, const void* wv, const float* bv,
                           const void* w2, const float* b2, const float* ab, void* out,
                           float* part, int8_t* assign, int B, int H, int W, int C,
                           int I, int heads, int fold_h, int fold_w, int ph, int pw, int G,
                           int tc, int stop, int nf, int* occupancy, void* stream) {
  return launch_prefix<float>(x, stats, wf, bf, wv, bv, w2, b2, ab, out, part, assign, B, H,
                              W, C, I, heads, fold_h, fold_w, ph, pw, G, tc, stop, nf,
                              occupancy, stream);
}

// CTAs per region to launch with: the smallest divisor G of heads (G <= 8,
// the portable cluster size), at least `least`, whose base layout fits in
// the card's shared memory, else the smallest whose wide layout fits; -1 if
// none does.  *wide: 1 where K2 launches on its wide layout.  rh x rw: the
// region's tokens; esz: 2 (bf16) or 4 (f32).
int mixer_block_groups(int esz, int C, int I, int heads, int rh, int rw, int ph, int pw,
                       int least, int* wide) {
  return esz == 2 ? groups<__nv_bfloat16>(C, I, heads, rh, rw, ph, pw, least, wide)
                  : groups<float>(C, I, heads, rh, rw, ph, pw, least, wide);
}

// K2 as launched at that geometry with G CTAs per region: out = [dynamic
// shared memory bytes, CTAs per SM, registers per thread]
int mixer_block_info(int esz, int C, int I, int heads, int rh, int rw, int ph, int pw, int G,
                     int* out) {
  return esz == 2 ? info<__nv_bfloat16>(C, I, heads, rh, rw, ph, pw, G, out)
                  : info<float>(C, I, heads, rh, rw, ph, pw, G, out);
}

}  // extern "C"
