// Mixer half of a ClusterBlock, fused:
//   out = x + fc2(cluster_mix(fc1(xn), fc_v(xn))),  xn = (x - mu) * rstd
// plus per-block partial (sum, sum of squares) of the stored output, which
// the caller reduces (torch sum, deterministic) into the GroupNorm
// statistics the MLP half consumes.
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/block_pallas.py::_mixer_block_pallas
// (kernel _mixer_block_kernel, body _mixer_block_fwd_body), reached through
// fused_mixer_block_stats.  GN affine and LayerScale are folded into the
// weights by the caller.
//
// What bounds it on the H100: per token it reads and writes C bf16 values
// and does ~2*C*I (fc1) + 2*I*(M+1) (norms, cosines) + 4*C*heads
// (aggregate, dispatch) flops, 50-140 flop/byte at the nano shapes: under
// the bf16 tensor-core ridge (~295), so the least time is set by bytes.  Unfused, the I-wide feat/value
// maps (I = 96..256 against C = 16..160) would cross device memory several
// times.  In practice this design is bound by latency and parallelism: the
// cosine/argmax/aggregation work is per (token, head) and short.
//
// Design.  The TPU kernel's dense masked per-head/per-region matmuls (~16x
// redundant flops) are not carried over.  Each (sample, region) is one
// thread-block cluster of G CTAs (G divides heads, G <= 8; the caller picks
// G = 1 when there are at least as many regions as SMs, since every CTA of
// a cluster re-reads its whole region); CTA g owns heads
// [g*hpc, (g+1)*hpc), hpc = heads/G, i.e. the I-columns of those heads:
//   A. pool the region's proposal windows in INPUT space (adaptive average of
//      xn), project the M pooled rows with the CTA's fc1/fc_v columns,
//      L2-normalise per head;
//   B. sweep the region's tokens in chunks of 32 from device memory (L2):
//      recompute the chunk's feat columns in shared memory; per (token, head)
//      (8 lanes each) cosine to the M centers, first-max argmax on the
//      pre-sigmoid logit beta + alpha*cos (strict >), sigmoid of the winner;
//      accumulate sim * xn per (head, center) in INPUT space, in 8 fixed
//      token splits (deterministic), plus the sum of sims and the count;
//   C. finish the centers ((agg @ wv + rs*bv + v_c) / (count + 1)) and fold
//      fc2 into them; the cluster then swaps fc2-projected centers and
//      (token, head) assignments through distributed shared memory, and
//      each CTA dispatches 1/G of the region's tokens over all heads, adds
//      the residual, writes the output and reduces its moments.
// feat is never stored, so a 1024-token region (the p3 neck block) needs no
// more shared memory than its chunk.
//
// Numerics mirror the TPU kernel: xn, feat (for the cosine), feat^2 (for the
// norms), the token inverse norms, the centers, the sims, the aggregated
// centers and the fc2-projected centers are rounded to the working type where
// that kernel casts them to its matrix-unit type; every sum is f32.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // tokens per sweep-B chunk
constexpr int kSplit = 8;   // fixed token splits of the aggregation
constexpr int kLanes = 8;   // lanes per (token, head) in the assignment

struct Geo {
  int B, H, W, C, I, heads, D, fold_h, fold_w, rh, rw, N, ph, pw, M;
  int G, hpc, nper;  // CTAs per cluster, heads per CTA, dispatch tokens per CTA
};

struct Smem {  // offsets in floats, then bytes after `floats`
  size_t xs, fs, cin, cn, vc, aggp, ocw_own, ocw_all, rs, cnt, invc, red, sg, sg_all;
  size_t floats, asg, asg_all, bytes;
};

inline Smem smem_layout(const Geo& g) {
  const size_t dg = (size_t)g.hpc * g.D, mc = (size_t)g.M * g.C;
  const size_t gathered = g.G > 1;  // the *_all buffers exist only in clusters
  Smem s;
  size_t o = 0;
  s.xs = o;      o += (size_t)kChunk * g.C;
  s.fs = o;      o += std::max((size_t)kChunk * (dg + kLanes), (size_t)g.M * dg);
  s.cin = o;     o += mc;
  s.cn = o;      o += g.M * dg;
  s.vc = o;      o += g.M * dg;
  s.aggp = o;    o += (size_t)kSplit * g.hpc * mc;
  s.ocw_own = o; o += g.hpc * mc;
  s.ocw_all = o; o += gathered * g.heads * mc;
  s.rs = o;      o += (size_t)g.hpc * g.M;
  s.cnt = o;     o += (size_t)g.hpc * g.M;
  s.invc = o;    o += (size_t)g.hpc * g.M;
  s.red = o;     o += 2 * (kThreads / 32);
  s.sg = o;      o += (size_t)g.N * g.hpc;
  s.sg_all = o;  o += gathered * g.nper * g.heads;
  s.floats = o;
  s.asg = o * sizeof(float);
  s.asg_all = s.asg + (size_t)g.N * g.hpc;
  s.bytes = s.asg_all + gathered * g.nper * g.heads;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mixer_block_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                   const T* __restrict__ wf, const float* __restrict__ bf,
                   const T* __restrict__ wv, const float* __restrict__ bv,
                   const T* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ ab, T* __restrict__ out,
                   float* __restrict__ part, int8_t* __restrict__ assign_out,
                   Geo g, Smem L) {
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = g.C, I = g.I, heads = g.heads, D = g.D, M = g.M, N = g.N;
  // feat rows padded by kLanes: the 4 tokens of a warp in the assignment
  // loop (8 lanes each) then fall on disjoint banks
  const int hpc = g.hpc, G = g.G, Dg = hpc * D, DP = Dg + kLanes;
  float* sm = reinterpret_cast<float*>(smem4);
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  float* xs = sm + L.xs;            // [kChunk][C] normalised input chunk
  float* fs = sm + L.fs;            // [kChunk][DP] feat chunk; later oc [M][Dg]
  float* cin = sm + L.cin;          // [M][C] pooled input rows
  float* cn = sm + L.cn;            // [M][Dg] normalised centers (own heads)
  float* vc = sm + L.vc;            // [M][Dg] value centers
  float* aggp = sm + L.aggp;        // [kSplit][hpc][M][C] partial sim*xn sums
  float* ocw_own = sm + L.ocw_own;  // [hpc][M][C] fc2-projected centers
  float* ocw_all = sm + L.ocw_all;  // [heads][M][C] gathered from the cluster
  float* rs = sm + L.rs;            // [hpc][M] sum of sims
  float* cnt = sm + L.cnt;          // [hpc][M] counts
  float* invc = sm + L.invc;        // [M][hpc]
  float* red = sm + L.red;          // [2][warps]
  float* sg = sm + L.sg;            // [N][hpc] winner sigmoid
  float* sg_all = sm + L.sg_all;    // [nper][heads]
  unsigned char* asg = sb + L.asg;          // [N][hpc] winner index
  unsigned char* asg_all = sb + L.asg_all;  // [nper][heads]

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

  for (int e = tid; e < kSplit * hpc * M * C; e += kThreads) aggp[e] = 0.f;
  for (int e = tid; e < hpc * M; e += kThreads) rs[e] = cnt[e] = 0.f;

  // ---- A. centers: adaptive-average pool in input space, then project ----
  for (int e = tid; e < M * C; e += kThreads) {
    const int m = e / C, c = e % C;
    const int pi = m / g.pw, pj = m % g.pw;
    const int lh = (pi * g.rh) / g.ph, hh = ((pi + 1) * g.rh + g.ph - 1) / g.ph;
    const int lw = (pj * g.rw) / g.pw, hw = ((pj + 1) * g.rw + g.pw - 1) / g.pw;
    const float wgt = rnd<T>((1.f / (hh - lh)) * (1.f / (hw - lw)));
    float acc = 0.f;
    for (int i = lh; i < hh; ++i)
      for (int j = lw; j < hw; ++j) acc = fmaf(wgt, norm_in(x[tok(i * g.rw + j) + c]), acc);
    cin[e] = rnd<T>(acc);
  }
  __syncthreads();
  for (int e = tid; e < M * Dg; e += kThreads) {
    const int m = e / Dg, i = col0 + e % Dg;
    float af = 0.f, av = 0.f;
    for (int c = 0; c < C; ++c) {
      const float ci = cin[m * C + c];
      af = fmaf(ci, to_f<T>(wf[(size_t)c * I + i]), af);
      av = fmaf(ci, to_f<T>(wv[(size_t)c * I + i]), av);
    }
    cn[e] = af + bf[i];
    vc[e] = av + bv[i];
  }
  __syncthreads();
  for (int e = tid; e < M * hpc; e += kThreads) {
    const int m = e / hpc, hl = e % hpc;
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = cn[m * Dg + hl * D + d];
      s = fmaf(v, v, s);
    }
    invc[e] = rsqrtf(s + 1e-12f);
  }
  __syncthreads();
  for (int e = tid; e < M * Dg; e += kThreads)
    cn[e] = rnd<T>(cn[e] * invc[(e / Dg) * hpc + (e % Dg) / D]);
  __syncthreads();

  // ---- B. assign + aggregate, chunk by chunk ----
  const int C4 = C / 4;
  const int sub = tid % kLanes;
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int nt = min(kChunk, N - n0);
    for (int e = tid; e < kChunk * C; e += kThreads) {
      const int t = e / C, c = e % C;
      xs[e] = t < nt ? norm_in(x[tok(n0 + t) + c]) : 0.f;
    }
    __syncthreads();
    // feat columns of the CTA's heads; thread (tg, j) owns tokens tg + 8k
    for (int e = tid; e < 8 * Dg; e += kThreads) {
      const int j = e % Dg, tg = e / Dg, i = col0 + j;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c4 = 0; c4 < C4; ++c4) {
        const float w0 = to_f<T>(wf[(size_t)(4 * c4 + 0) * I + i]);
        const float wa = to_f<T>(wf[(size_t)(4 * c4 + 1) * I + i]);
        const float wb = to_f<T>(wf[(size_t)(4 * c4 + 2) * I + i]);
        const float wc = to_f<T>(wf[(size_t)(4 * c4 + 3) * I + i]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 xv = reinterpret_cast<const float4*>(xs + (tg + 8 * k) * C)[c4];
          acc[k] = fmaf(xv.x, w0, fmaf(xv.y, wa, fmaf(xv.z, wb, fmaf(xv.w, wc, acc[k]))));
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) fs[(tg + 8 * k) * DP + j] = acc[k] + bf[i];
    }
    __syncthreads();
    // per (token, head), kLanes lanes each: cosine to the M centers and the
    // first-max assignment.  kChunk*hpc items is a multiple of the 32 items
    // a pass covers, so every lane of a warp runs the same iterations.
    for (int it = tid / kLanes; it < kChunk * hpc; it += kThreads / kLanes) {
      const int t = it % kChunk, hl = it / kChunk;
      const float* f = fs + t * DP + hl * D;
      float n2 = 0.f;
      for (int d = sub; d < D; d += kLanes) n2 += rnd<T>(f[d] * f[d]);
      for (int o = kLanes / 2; o > 0; o >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, o);
      const float inv = rnd<T>(rsqrtf(n2 + 1e-12f));
      float best = 0.f;
      int arg = 0;
      for (int m = 0; m < M; ++m) {
        const float* cm = cn + m * Dg + hl * D;
        float raw = 0.f;
        for (int d = sub; d < D; d += kLanes) raw = fmaf(cm[d], rnd<T>(f[d]), raw);
        for (int o = kLanes / 2; o > 0; o >>= 1) raw += __shfl_xor_sync(0xffffffffu, raw, o);
        const float lg = beta + alpha * (raw * inv);
        if (m == 0 || lg > best) {  // strict >: the first max wins
          best = lg;
          arg = m;
        }
      }
      if (sub == 0 && t < nt) {
        sg[(n0 + t) * hpc + hl] = 1.f / (1.f + expf(-best));
        asg[(n0 + t) * hpc + hl] = (unsigned char)arg;
      }
    }
    __syncthreads();
    // aggregate sim * xn per (head, center) in input space; split s takes
    // the chunk's tokens t = s mod kSplit (a fixed, deterministic order)
    for (int e = tid; e < kSplit * hpc * C; e += kThreads) {
      const int c = e % C, hl = (e / C) % hpc, s = e / (C * hpc);
      float* ap = aggp + (size_t)(s * hpc + hl) * M * C + c;
      for (int t = s; t < nt; t += kSplit) {
        const int q = (n0 + t) * hpc + hl;
        ap[asg[q] * C] = fmaf(rnd<T>(sg[q]), xs[t * C + c], ap[asg[q] * C]);
      }
    }
    for (int e = tid; e < hpc * M; e += kThreads) {
      const int hl = e / M, m = e % M;
      for (int t = 0; t < nt; ++t) {
        const int q = (n0 + t) * hpc + hl;
        if (asg[q] == m) {
          rs[e] += sg[q];
          cnt[e] += 1.f;
        }
      }
    }
    __syncthreads();
  }

  // ---- C. finish the CTA's centers, fold fc2 in ----
  for (int e = tid; e < hpc * M * C; e += kThreads) {  // sum the splits, round
    float a = 0.f;
    for (int s = 0; s < kSplit; ++s) a += aggp[(size_t)s * hpc * M * C + e];
    aggp[e] = rnd<T>(a);
  }
  __syncthreads();
  float* oc = fs;  // [M][Dg]
  for (int e = tid; e < M * Dg; e += kThreads) {
    const int m = e / Dg, j = e % Dg, hm = (j / D) * M + m, i = col0 + j;
    float acc = 0.f;
    for (int c = 0; c < C; ++c)
      acc = fmaf(aggp[hm * C + c], to_f<T>(wv[(size_t)c * I + i]), acc);
    const float agg = acc + rs[hm] * bv[i];
    oc[e] = rnd<T>((agg + vc[e]) * (1.f / (cnt[hm] + 1.f)));
  }
  __syncthreads();
  for (int e = tid; e < hpc * M * C; e += kThreads) {
    const int c = e % C, hm = e / C, hl = hm / M, m = hm % M;
    float acc = 0.f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(oc[m * Dg + hl * D + d],
                 to_f<T>(w2[(size_t)(col0 + hl * D + d) * C + c]), acc);
    ocw_own[e] = rnd<T>(acc);
  }
  if (assign_out != nullptr) {
    for (int e = tid; e < N * hpc; e += kThreads)
      assign_out[tok(e / hpc) / C * heads + rank * hpc + e % hpc] = (int8_t)asg[e];
  }

  // ---- swap centers and assignments across the cluster, then dispatch ----
  // (a cluster of one CTA already holds everything in the dispatch layout)
  const int n_lo = rank * g.nper;
  const int nd = max(0, min(N, n_lo + g.nper) - n_lo);
  const float* ocw_d = ocw_own;      // [heads][M][C]
  const float* sg_d = sg;            // [nd][heads]
  const unsigned char* asg_d = asg;  // [nd][heads]
  if (G > 1) {
    cluster.sync();
    for (int e = tid; e < heads * M * C; e += kThreads) {
      const int h = e / (M * C);
      const float* peer = cluster.map_shared_rank(ocw_own, h / hpc);
      ocw_all[e] = peer[(h % hpc) * M * C + e % (M * C)];
    }
    for (int e = tid; e < nd * heads; e += kThreads) {
      const int n = n_lo + e / heads, h = e % heads, p = h / hpc;
      sg_all[e] = cluster.map_shared_rank(sg, p)[n * hpc + h % hpc];
      asg_all[e] = cluster.map_shared_rank(asg, p)[n * hpc + h % hpc];
    }
    cluster.sync();  // no CTA leaves while a peer may still read its memory
    ocw_d = ocw_all;
    sg_d = sg_all;
    asg_d = asg_all;
  } else {
    __syncthreads();
  }
  float s1 = 0.f, s2 = 0.f;
  for (int e = tid; e < nd * C; e += kThreads) {
    const int nl = e / C, c = e % C;
    float y = 0.f;
    for (int h = 0; h < heads; ++h) {
      const int q = nl * heads + h;
      y = fmaf(rnd<T>(sg_d[q]), ocw_d[(h * M + asg_d[q]) * C + c], y);
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
  const int warps = kThreads / 32;
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
}

template <typename T>
int launch(const void* x, const float* stats, const void* wf, const float* bf,
           const void* wv, const float* bv, const void* w2, const float* b2,
           const float* ab, void* out, float* part, int8_t* assign, int B, int H,
           int W, int C, int I, int heads, int fold_h, int fold_w, int ph, int pw,
           int G, void* stream) {
  if (B <= 0 || C % 4 || heads <= 0 || I % heads || fold_h <= 0 || fold_w <= 0 ||
      H % fold_h || W % fold_w || ph <= 0 || pw <= 0 || ph * pw > 255 || G <= 0 ||
      G > 8 || heads % G)
    return (int)cudaErrorInvalidValue;
  const int rh = H / fold_h, rw = W / fold_w, n = rh * rw;
  Geo g{B, H, W, C, I, heads, I / heads, fold_h, fold_w, rh, rw, n, ph, pw, ph * pw,
        G, heads / G, (n + G - 1) / G};
  if (rh < ph || rw < pw) return (int)cudaErrorInvalidValue;
  const Smem L = smem_layout(g);
  cudaError_t e = asy::set_smem(mixer_block_kernel<T>, L.bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(fold_h * fold_w * G, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = G > 1;  // a single-CTA "cluster" launches as a plain grid
  e = cudaLaunchKernelEx(&cfg, mixer_block_kernel<T>, (const T*)x, stats,
                         (const T*)wf, bf, (const T*)wv, bv, (const T*)w2, b2, ab,
                         (T*)out, part, assign, g, L);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mixer_block_bf16(const void* x, const float* stats, const void* wf,
                     const float* bf, const void* wv, const float* bv,
                     const void* w2, const float* b2, const float* ab, void* out,
                     float* part, int8_t* assign, int B, int H, int W, int C,
                     int I, int heads, int fold_h, int fold_w, int ph, int pw,
                     int G, void* stream) {
  return launch<__nv_bfloat16>(x, stats, wf, bf, wv, bv, w2, b2, ab, out, part,
                               assign, B, H, W, C, I, heads, fold_h, fold_w, ph,
                               pw, G, stream);
}

int mixer_block_f32(const void* x, const float* stats, const void* wf,
                    const float* bf, const void* wv, const float* bv,
                    const void* w2, const float* b2, const float* ab, void* out,
                    float* part, int8_t* assign, int B, int H, int W, int C,
                    int I, int heads, int fold_h, int fold_w, int ph, int pw,
                    int G, void* stream) {
  return launch<float>(x, stats, wf, bf, wv, bv, w2, b2, ab, out, part, assign,
                       B, H, W, C, I, heads, fold_h, fold_w, ph, pw, G, stream);
}

}  // extern "C"
