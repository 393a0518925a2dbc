// Stand-alone cluster mix, backward (K7b): from feat, value and the
// cotangent g of the forward's output (cluster_mix.cu), the cotangents of
// feat and value and one row of [d alpha, d beta] partial sums per CTA,
// which the caller reduces with one torch sum (no float atomics: the same
// bits on every run).  The forward is rematerialised in full; the hard
// assignment is a constant, as autograd through argmax/one_hot treats it.
// Optionally writes the winning proposal per (token, head) as int8, equal
// to the forward's (cluster_mix.cuh rebuilds it with the same code), and
// the mixed centers, equal to the forward's.
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/cluster_pallas.py::
// _cluster_nhwc_pallas_bwd (kernel _cluster_bwd_kernel, body
// _mixer_core_bwd), the backward of cluster_mix_pallas's custom VJP.
//
// What bounds it on the H100: per token and head it reads D values each of
// feat, value and g and writes D each of dfeat and dvalue, with ~30*D flops
// (the forward's ~12*D again, then the cotangents): about 3 flops a byte in
// bf16, so bytes bound it (5 * B*H*W*I * itemsize).  The TPU kernel's dense
// masked matmuls are not carried over.
//
// Design.  One CTA of 256 threads per (sample, region, head), the thread
// mapping of cluster_mix.cuh (4 tokens a warp, 8 lanes a token).  The
// region's tiles of feat, value and g are staged in shared memory once
// (cp.async; g's copy overlaps A and B) where they fit, so device memory
// sees each input once:
//   A./B. centers and assignment (cluster_mix.cuh), keeping per token the
//      winner's sim, proposal, raw cosine and the token's inverse norm;
//   C. the per-proposal sums of rnd(sim) * value and sim * g and the
//      counts: the mixed centers oc and d oc (cluster_mix.cuh::
//      mixed_centers, K7's own phase C: the same bits of oc);
//   D. per token: d sim at the winner (oc . g + d num . value), dvalue
//      (sim * d num[winner] plus the pooling term), the sigmoid's gradient,
//      d raw, the [d alpha, d beta] sums and the sums of d raw * xn per
//      proposal (d centers);
//   E. d centers through the center normalisation, then per token dfeat
//      through the token normalisation plus the pooling term.
// The per-proposal sums of C and D are, in the fast instantiation, sums in
// each thread's registers over its tokens, then over the warp's 4 token
// slots by shuffles and over the 8 warps in a fixed pairwise order; in the
// general one, one thread per (proposal, channel) walks the tokens in
// order.  No float atomics: two runs give the same bits.
#include "cluster_mix.cuh"

namespace {

using namespace asy::cmix;

struct Layout {  // byte offsets; the tiles first (16-byte aligned)
  size_t xs, vs, gs, win, crep, vc, invc, cn, cnr, oc, dnum, dcr, dotc, part, cntw, red, s,
      raw, inv, dr, arg, pmask, bytes;
  int vec;      // cp.async width of the staging copies (0: plain copies)
  bool staged;  // the tiles are in shared memory
};

inline Layout layout(const Geo& g, size_t esz, bool staged, int vec) {
  const size_t md = (size_t)g.M * g.D * 4, tile = ((size_t)g.N * g.D * esz + 15) / 16 * 16;
  Layout L;
  size_t o = 0;
  L.staged = staged;
  L.vec = vec;
  L.xs = o;   o += staged ? tile : 0;
  L.vs = o;   o += staged ? tile : 0;
  L.gs = o;   o += staged ? tile : 0;
  L.win = o;  o += (size_t)kWindowFloats * g.M * 4;
  L.crep = o; o += md;
  L.vc = o;   o += md;
  L.invc = o; o += (size_t)g.M * 4;
  L.cn = o;   o += md;
  L.cnr = o;  o += md;
  L.oc = o;   o += md;
  L.dnum = o; o += md;
  L.dcr = o;  o += md;
  L.dotc = o; o += (size_t)g.M * 4;
  L.part = o; o += fast_path(g.D, g.M) ? (size_t)kWarps * 2 * kFastM * kFastD * 4 : 0;
  L.cntw = o; o += (size_t)kWarps * kFastM * 4;
  L.red = o;  o += 2 * kWarps * 4;
  L.s = o;    o += (size_t)g.N * 4;
  L.raw = o;  o += (size_t)g.N * 4;
  L.inv = o;  o += (size_t)g.N * 4;
  L.dr = o;   o += (size_t)g.N * 4;
  L.arg = o;  o += g.N;
  L.pmask = o; o += fast_path(g.D, g.M) ? g.N : 0;
  L.bytes = (o + 15) / 16 * 16;
  return L;
}

// The layout a launch takes: staged where the card's shared memory holds it.
inline Layout pick_layout(const Geo& g, size_t esz, int vec) {
  const Layout L = layout(g, esz, true, vec);
  return L.bytes <= smem_optin() ? L : layout(g, esz, false, vec);
}

template <typename T, bool kFast, bool kStaged>
__global__ void __launch_bounds__(kThreads)
cluster_mix_bwd_kernel(const T* __restrict__ x, const T* __restrict__ v,
                       const T* __restrict__ gy, const float* __restrict__ ab,
                       T* __restrict__ dx, T* __restrict__ dv, float* __restrict__ dab,
                       int8_t* __restrict__ assign_out, float* __restrict__ centers_out, Geo g,
                       Layout L) {
  using asy::from_f;
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  auto fl = [&](size_t o) { return reinterpret_cast<float*>(sb + o); };
  Window* win = reinterpret_cast<Window*>(sb + L.win);  // [M]
  float* crep = fl(L.crep);  // [M][D] pooled feat; d cn after D
  float* vc = fl(L.vc);      // [M][D] pooled value
  float* invc = fl(L.invc);  // [M]
  float* cn = fl(L.cn);      // [M][D] normalised centers, f32
  float* cnr = fl(L.cnr);    // [M][D] the same, rounded
  float* oc = fl(L.oc);      // [M][D] mixed centers (agg + vc) / (count + 1)
  float* dnum = fl(L.dnum);  // [M][D] d oc / (count + 1)
  float* dcr = fl(L.dcr);    // [M][D] d c_rep
  float* dotc = fl(L.dotc);  // [M] cn . d cn
  float* part = fl(L.part);  // fast: [kWarps][2][kFastM][kFastD] warp sums
  int* cntw = reinterpret_cast<int*>(sb + L.cntw);  // fast: [kWarps][kFastM]
  float* red = fl(L.red);    // [2][kWarps]
  float* s = fl(L.s);        // [N] winner's sim
  float* raw = fl(L.raw);    // [N] winner's raw cosine
  float* inv = fl(L.inv);    // [N] token inverse norm
  float* dr = fl(L.dr);      // [N] d raw at the winner
  unsigned char* arg = sb + L.arg;  // [N]
  unsigned char* pmask = sb + L.pmask;  // fast: [N] bit m set: the token is in window m

  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int sub = tid % kLanes, q = tid / kLanes;
  const int D = g.D, M = g.M, MD = M * D, N = g.N;
  const float alpha = ab[0], beta = ab[1];
  T* xs = reinterpret_cast<T*>(sb + L.xs);
  T* vs = reinterpret_cast<T*>(sb + L.vs);
  T* gs = reinterpret_cast<T*>(sb + L.gs);
  const auto X = view<kStaged>(g, x, xs, b, r, h);
  const auto V = view<kStaged>(g, v, vs, b, r, h);
  const auto G = view<kStaged>(g, gy, gs, b, r, h);
  if constexpr (kStaged) {
    stage(X, x, xs, N, L.vec);
    stage(V, v, vs, N, L.vec);
    asy::cp_async_commit();
    stage(G, gy, gs, N, L.vec);
    asy::cp_async_commit();
    asy::cp_async_wait<1>();  // feat and value; g lands during A and B
  }
  __syncthreads();

  centers<T, kFast>(g, X, V, win, crep, vc, invc, cn, cnr);
  if constexpr (kFast) {  // each token's windows (read after C's barriers)
    for (int n = tid; n < N; n += kThreads) {
      int j;
      const int i = X.row(n, j);
      unsigned mk = 0;
      for (int mm = 0; mm < M; ++mm) mk |= (pool_weight(win[mm], i, j) != 0.f) << mm;
      pmask[n] = (unsigned char)mk;
    }
  }
  assign<T, kFast>(g, X, cnr, alpha, beta, s, arg, raw, inv);
  if constexpr (kStaged) {
    asy::cp_async_wait<0>();
    __syncthreads();
  }

  // C. the mixed centers oc and d oc / (count + 1), as K7 computes oc
  mixed_centers<T, kFast, true>(g, V, G, s, arg, vc, part, cntw, oc, dnum);
  if (centers_out != nullptr) store_centers(g, b, r, h, oc, centers_out);

  // D. per token: d sim at the winner, dvalue, d raw, d alpha / d beta (and,
  // fast, the register sums of d raw * xn per proposal)
  float da = 0.f, db = 0.f;  // over this slot's tokens (the same in its 8 lanes)
  float ww[kFastM];          // fast: the windows' pooling weights
#pragma unroll
  for (int mm = 0; mm < kFastM; ++mm) ww[mm] = kFast && mm < M ? win[mm].w : 0.f;
  float dcn[kFastM][4] = {};
#pragma unroll 2
  for (int n0 = 0; n0 < N; n0 += kTok) {  // the same trip count in every lane
    const int n = n0 + q, nn = n < N ? n : 0;
    const bool ok = n < N;
    int j;
    const int m = arg[nn], i = X.row(nn, j);
    const float sf = s[nn], iv = inv[nn];
    float p = 0.f;
    if constexpr (kFast) {
      float gg[4], vv[4], xx[4], o[4];
      load4(G.at(nn) + 4 * sub, gg);
      load4(V.at(nn) + 4 * sub, vv);
      load4(X.at(nn) + 4 * sub, xx);
      const float* ocm = oc + m * D + 4 * sub;
      const float* dnm = dnum + m * D + 4 * sub;
#pragma unroll
      for (int k = 0; k < 4; ++k) p = __fmaf_rn(ocm[k], gg[k], p);
#pragma unroll
      for (int k = 0; k < 4; ++k) p = __fmaf_rn(dnm[k], vv[k], p);
      const float dsim = group_sum(p);
      const float sg = __fmul_rn(__fmul_rn(dsim, sf), __fadd_rn(1.f, -sf));
      const float draw = __fmul_rn(sg, alpha);
      float pw[kFastM];  // the token's pooling weight in each window
      const unsigned mk = pmask[nn];
#pragma unroll
      for (int mm = 0; mm < kFastM; ++mm) pw[mm] = (mk >> mm) & 1 ? ww[mm] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float pv = 0.f;
#pragma unroll
        for (int mm = 0; mm < kFastM; ++mm)
          if (mm < M) pv = __fmaf_rn(pw[mm], dnum[mm * D + 4 * sub + k], pv);
        o[k] = __fadd_rn(__fmul_rn(sf, dnm[k]), pv);
      }
      if (ok) {
        da = __fmaf_rn(sg, raw[nn], da);
        db = __fadd_rn(db, sg);
        store4(dv + X.off0 + ((size_t)i * g.W + j) * g.C + 4 * sub, o);
      }
#pragma unroll
      for (int mm = 0; mm < kFastM; ++mm)
        if (ok && mm == m) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dcn[mm][k] = __fmaf_rn(draw, __fmul_rn(xx[k], iv), dcn[mm][k]);
        }
      if (ok && sub == 0) dr[n] = draw;
    } else {
      const T* gt = G.at(nn);
      const T* vt = V.at(nn);
      for (int d = sub; d < D; d += kLanes) p = __fmaf_rn(oc[m * D + d], to_f<T>(gt[d]), p);
      for (int d = sub; d < D; d += kLanes) p = __fmaf_rn(dnum[m * D + d], to_f<T>(vt[d]), p);
      const float dsim = group_sum(p);
      const float sg = __fmul_rn(__fmul_rn(dsim, sf), __fadd_rn(1.f, -sf));
      if (ok) {
        const size_t t = X.off0 + ((size_t)i * g.W + j) * g.C;
        da = __fmaf_rn(sg, raw[n], da);
        db = __fadd_rn(db, sg);
        for (int d = sub; d < D; d += kLanes) {
          float pv = 0.f;
          for (int k = 0; k < M; ++k)
            pv = __fmaf_rn(pool_weight(win[k], i, j), dnum[k * D + d], pv);
          dv[t + d] = from_f<T>(__fadd_rn(__fmul_rn(sf, dnum[m * D + d]), pv));
        }
        if (sub == 0) dr[n] = __fmul_rn(sg, alpha);
      }
    }
  }
  // the slot sums of da, db (each slot's 8 lanes hold the same values)
  da = slot_sum(da);
  db = slot_sum(db);
  if (lane == 0) {
    red[w] = da;
    red[kWarps + w] = db;
  }
  if constexpr (kFast) {
#pragma unroll
    for (int mm = 0; mm < kFastM; ++mm)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = slot_sum(dcn[mm][k]);
        if (lane < kLanes) part[(w * 2) * kFastM * kFastD + mm * kFastD + 4 * sub + k] = a;
      }
  }
  __syncthreads();

  // E. d cn (into crep), cn . d cn, d c_rep; then dfeat per token
  for (int e = tid; e < MD; e += kThreads) {
    if constexpr (kFast) {
      crep[e] = warps_sum(part + e, 2 * kFastM * kFastD);
    } else {
      const int m = e / D, d = e % D;
      float a = 0.f;
      for (int n = 0; n < N; ++n)
        if (arg[n] == m) a = __fmaf_rn(dr[n], __fmul_rn(to_f<T>(X.at(n)[d]), inv[n]), a);
      crep[e] = a;
    }
  }
  __syncthreads();
  for (int m = w; m < M; m += kWarps) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot = __fmaf_rn(cn[m * D + d], crep[m * D + d], dot);
    dot = warp_sum(dot);
    if (lane == 0) dotc[m] = dot;
  }
  __syncthreads();
  for (int e = tid; e < MD; e += kThreads)
    dcr[e] = __fmul_rn(invc[e / D], __fadd_rn(crep[e], -__fmul_rn(cn[e], dotc[e / D])));
  __syncthreads();
#pragma unroll 2
  for (int n0 = 0; n0 < N; n0 += kTok) {
    const int n = n0 + q, nn = n < N ? n : 0;
    int j;
    const int m = arg[nn], i = X.row(nn, j);
    const float iv = inv[nn], draw = dr[nn];
    const size_t t = X.off0 + ((size_t)i * g.W + j) * g.C;
    float p = 0.f;
    if constexpr (kFast) {
      float xx[4], o[4];
      load4(X.at(nn) + 4 * sub, xx);
      const float* cnm = cn + m * D + 4 * sub;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        p = __fmaf_rn(__fmul_rn(xx[k], iv), __fmul_rn(draw, cnm[k]), p);
      const float dot = group_sum(p);
      float pw[kFastM];
      const unsigned mk = pmask[nn];
#pragma unroll
      for (int mm = 0; mm < kFastM; ++mm) pw[mm] = (mk >> mm) & 1 ? ww[mm] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xn = __fmul_rn(xx[k], iv);
        const float dxn = __fmul_rn(draw, cnm[k]);
        float pc = 0.f;
#pragma unroll
        for (int mm = 0; mm < kFastM; ++mm)
          if (mm < M) pc = __fmaf_rn(pw[mm], dcr[mm * D + 4 * sub + k], pc);
        o[k] = __fadd_rn(__fmul_rn(iv, __fadd_rn(dxn, -__fmul_rn(xn, dot))), pc);
      }
      if (n < N) store4(dx + t + 4 * sub, o);
    } else {
      const T* xt = X.at(nn);
      for (int d = sub; d < D; d += kLanes)
        p = __fmaf_rn(__fmul_rn(to_f<T>(xt[d]), iv), __fmul_rn(draw, cn[m * D + d]), p);
      const float dot = group_sum(p);
      if (n < N) {
        for (int d = sub; d < D; d += kLanes) {
          const float xn = __fmul_rn(to_f<T>(xt[d]), iv);
          const float dxn = __fmul_rn(draw, cn[m * D + d]);
          float pc = 0.f;
          for (int k = 0; k < M; ++k)
            pc = __fmaf_rn(pool_weight(win[k], i, j), dcr[k * D + d], pc);
          dx[t + d] = from_f<T>(
              __fadd_rn(__fmul_rn(iv, __fadd_rn(dxn, -__fmul_rn(xn, dot))), pc));
        }
      }
    }
  }
  if (tid == 0) {
    const size_t row = ((size_t)b * gridDim.y + h) * gridDim.x + r;
    dab[2 * row] = warps_sum(red, 1);
    dab[2 * row + 1] = warps_sum(red + kWarps, 1);
  }
  if (assign_out != nullptr) store_assign(g, b, r, h, arg, assign_out);
}

// the instantiation for the fast or general mapping, staged tiles or not
template <typename T>
auto kernel_for(bool fast, bool staged) {
  return fast ? (staged ? cluster_mix_bwd_kernel<T, true, true> : cluster_mix_bwd_kernel<T, true, false>)
              : (staged ? cluster_mix_bwd_kernel<T, false, true> : cluster_mix_bwd_kernel<T, false, false>);
}

template <typename T>
int launch(const void* x, const void* v, const void* gy, const float* ab, void* dx,
           void* dv, float* dab, int8_t* assign, float* centers, int B, int H, int W, int C,
           int heads, int fold_h, int fold_w, int ph, int pw, int fast, void* stream) {
  Geo g;
  int err = make_geo(g, B, H, W, C, heads, fold_h, fold_w, ph, pw);
  if (err) return err;
  if (!path_ok(g, fast, {x, v, gy, dx, dv})) return (int)cudaErrorInvalidValue;
  const Layout L = pick_layout(g, sizeof(T), stage_vec(g, sizeof(T), {x, v, gy}));
  const auto kernel = kernel_for<T>(fast, L.staged);
  cudaError_t e = asy::set_smem(kernel, L.bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(fold_h * fold_w, heads, B);
  kernel<<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)v, (const T*)gy, ab, (T*)dx, (T*)dv, dab, assign, centers, g, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (feat), v (value), gy (cotangent of out), dx, dv: (B, H, W, C) NHWC in
// one type; ab = [alpha, beta] f32; dab (B * heads * fold_h * fold_w, 2) f32
// partial rows; assign (B, H, W, heads) int8 or null; centers (B, heads,
// fold_h * fold_w, ph * pw, D) f32 or null: the mixed centers; fast: the
// wrapper's reading of fast_path (a launch that disagrees is refused).
int cluster_mix_bwd_bf16(const void* x, const void* v, const void* gy, const float* ab,
                         void* dx, void* dv, float* dab, int8_t* assign, float* centers, int B,
                         int H, int W, int C, int heads, int fold_h, int fold_w, int ph,
                         int pw, int fast, void* stream) {
  return launch<__nv_bfloat16>(x, v, gy, ab, dx, dv, dab, assign, centers, B, H, W, C, heads,
                               fold_h, fold_w, ph, pw, fast, stream);
}

int cluster_mix_bwd_f32(const void* x, const void* v, const void* gy, const float* ab,
                        void* dx, void* dv, float* dab, int8_t* assign, float* centers, int B,
                        int H, int W, int C, int heads, int fold_h, int fold_w, int ph, int pw,
                        int fast, void* stream) {
  return launch<float>(x, v, gy, ab, dx, dv, dab, assign, centers, B, H, W, C, heads, fold_h,
                       fold_w, ph, pw, fast, stream);
}

// The kernel at this geometry (esz: 2 for bf16, 4 for f32; tensors assumed
// 16-byte aligned): out = [dynamic shared memory bytes, CTAs per SM,
// registers per thread, threads per CTA, fast path, tiles staged]
int cluster_mix_bwd_info(int esz, int B, int H, int W, int C, int heads, int fold_h,
                         int fold_w, int ph, int pw, int* out) {
  Geo g;
  int err = make_geo(g, B, H, W, C, heads, fold_h, fold_w, ph, pw);
  if (err) return err;
  if (esz != 2 && esz != 4) return (int)cudaErrorInvalidValue;
  const Layout L = pick_layout(g, esz, stage_vec(g, esz, {}));
  const bool fast = fast_path(g.D, g.M);
  const void* kernel = esz == 2 ? (const void*)kernel_for<__nv_bfloat16>(fast, L.staged)
                                : (const void*)kernel_for<float>(fast, L.staged);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.bytes);
  int per_sm = 0;
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, L.bytes);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)L.bytes;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = kThreads;
  out[4] = fast;
  out[5] = L.staged;
  return 0;
}

}  // extern "C"
