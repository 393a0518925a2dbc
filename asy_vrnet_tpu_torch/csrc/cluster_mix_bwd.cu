// Stand-alone cluster mix, backward (K7b): from feat, value and the
// cotangent g of the forward's output (cluster_mix.cu), the cotangents of
// feat and value and one row of [d alpha, d beta] partial sums per CTA,
// which the caller reduces with one torch sum (no float atomics: the same
// bits on every run).  The forward is rematerialised in full; the hard
// assignment is a constant, as autograd through argmax/one_hot treats it.
// Optionally writes the winning proposal per (token, head) as int8, equal
// to the forward's (cluster_mix.cuh rebuilds it with the same code).
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
// Design.  One CTA of 256 threads per (sample, region, head), as the
// forward; warp w takes tokens w, w + 8, ..., lane l channels l, l + 32, ...:
//   A./B. centers and assignment (cluster_mix.cuh), keeping per token the
//      winner's sim, proposal, raw cosine and the token's inverse norm;
//   C. per-warp [M][D] partials of rnd(sim) * value and sim * g, and the
//      counts, added in a fixed order: the mixed centers oc and d oc;
//   D. per token: d sim at the winner (oc . g + d num . value), dvalue
//      (sim * d num[winner] plus the pooling term), the sigmoid's gradient,
//      d raw, the [d alpha, d beta] sums and per-warp partials of
//      d raw * xn (d centers);
//   E. d centers through the center normalisation, then per token dfeat
//      through the token normalisation plus the pooling term.
#include "cluster_mix.cuh"

namespace {

using namespace asy::cmix;

struct Layout {  // offsets in floats; the per-token proposals follow
  size_t win, crep, vc, invc, cn, cnr, xrow, oc, dnum, dcr, aggp, docp, dcnp, cntp, icnt,
      red, s, raw, inv, dr, floats, arg, bytes;
};

inline Layout layout(const Geo& g) {
  const size_t md = (size_t)g.M * g.D;
  Layout L;
  size_t o = 0;
  L.win = o;  o += (size_t)kWindowFloats * g.M;
  L.crep = o; o += md;
  L.vc = o;   o += md;
  L.invc = o; o += g.M;
  L.cn = o;   o += md;
  L.cnr = o;  o += md;
  L.xrow = o; o += (size_t)kWarps * g.D;
  L.oc = o;   o += md;
  L.dnum = o; o += md;
  L.dcr = o;  o += md;
  L.aggp = o; o += (size_t)kWarps * md;
  L.docp = o; o += (size_t)kWarps * md;
  L.dcnp = o; o += (size_t)kWarps * md;
  L.cntp = o; o += (size_t)kWarps * g.M;
  L.icnt = o; o += g.M;
  L.red = o;  o += 2 * kWarps;
  L.s = o;    o += g.N;
  L.raw = o;  o += g.N;
  L.inv = o;  o += g.N;
  L.dr = o;   o += g.N;
  L.floats = o;
  L.arg = o * sizeof(float);
  L.bytes = L.arg + g.N;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cluster_mix_bwd_kernel(const T* __restrict__ x, const T* __restrict__ v,
                       const T* __restrict__ gy, const float* __restrict__ ab,
                       T* __restrict__ dx, T* __restrict__ dv, float* __restrict__ dab,
                       int8_t* __restrict__ assign_out, Geo g, Layout L) {
  using asy::from_f;
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  Window* win = reinterpret_cast<Window*>(sm + L.win);  // [M]
  float* crep = sm + L.crep;  // [M][D] pooled feat
  float* vc = sm + L.vc;      // [M][D] pooled value
  float* invc = sm + L.invc;  // [M]
  float* cn = sm + L.cn;      // [M][D] normalised centers, f32
  float* cnr = sm + L.cnr;    // [M][D] the same, rounded
  float* xrow = sm + L.xrow;  // [kWarps][D]
  float* oc = sm + L.oc;      // [M][D] mixed centers (agg + vc) / (count + 1)
  float* dnum = sm + L.dnum;  // [M][D] d oc / (count + 1)
  float* dcr = sm + L.dcr;    // [M][D] d c_rep
  float* aggp = sm + L.aggp;  // [kWarps][M][D]
  float* docp = sm + L.docp;  // [kWarps][M][D]
  float* dcnp = sm + L.dcnp;  // [kWarps][M][D]
  float* cntp = sm + L.cntp;  // [kWarps][M]
  float* icnt = sm + L.icnt;  // [M] 1 / (count + 1)
  float* red = sm + L.red;    // [2][kWarps]
  float* s = sm + L.s;        // [N] winner's sim
  float* raw = sm + L.raw;    // [N] winner's raw cosine
  float* inv = sm + L.inv;    // [N] token inverse norm
  float* dr = sm + L.dr;      // [N] d raw at the winner
  unsigned char* arg = reinterpret_cast<unsigned char*>(smem4) + L.arg;  // [N]

  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int D = g.D, M = g.M, MD = M * D;
  const float alpha = ab[0], beta = ab[1];
  for (int e = tid; e < 3 * kWarps * MD; e += kThreads) aggp[e] = 0.f;  // aggp, docp, dcnp
  for (int e = tid; e < kWarps * M; e += kThreads) cntp[e] = 0.f;

  centers<T>(g, x, v, b, r, h, win, crep, vc, invc, cn, cnr);
  assign<T>(g, x, b, r, h, cnr, alpha, beta, xrow, s, arg, raw, inv);

  // C. partials of rnd(sim) * value and sim * g per (proposal, channel)
  {
    float* ap = aggp + (size_t)w * MD;
    float* dp = docp + (size_t)w * MD;
    for (int n = w; n < g.N; n += kWarps) {
      const size_t t = token(g, b, r, h, n);
      const int m = arg[n];
      const float sf = s[n], sr = rnd<T>(sf);
      for (int d = lane; d < D; d += 32) {
        ap[m * D + d] = __fmaf_rn(sr, to_f<T>(v[t + d]), ap[m * D + d]);
        dp[m * D + d] = __fmaf_rn(sf, to_f<T>(gy[t + d]), dp[m * D + d]);
      }
      if (lane == 0) cntp[w * M + m] = __fadd_rn(cntp[w * M + m], 1.f);
    }
  }
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    float c = 0.f;
    for (int k = 0; k < kWarps; ++k) c = __fadd_rn(c, cntp[k * M + m]);
    icnt[m] = __fdiv_rn(1.f, __fadd_rn(c, 1.f));
  }
  __syncthreads();
  for (int e = tid; e < MD; e += kThreads) {
    float a = 0.f, q = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      a = __fadd_rn(a, aggp[(size_t)k * MD + e]);
      q = __fadd_rn(q, docp[(size_t)k * MD + e]);
    }
    const float ic = icnt[e / D];
    oc[e] = __fmul_rn(__fadd_rn(a, vc[e]), ic);
    dnum[e] = __fmul_rn(q, ic);
  }
  __syncthreads();

  // D. per token: d sim at the winner, dvalue, d raw, d alpha / d beta, and
  // the partials of d raw * xn
  float da = 0.f, db = 0.f;  // this warp's sums (the same in every lane)
  {
    float* cp = dcnp + (size_t)w * MD;
    for (int n = w; n < g.N; n += kWarps) {
      const size_t t = token(g, b, r, h, n);
      const int m = arg[n], i = n / g.rw, j = n % g.rw;
      const float sf = s[n], iv = inv[n];
      float p1 = 0.f, p2 = 0.f;
      for (int d = lane; d < D; d += 32) {
        p1 = __fmaf_rn(oc[m * D + d], to_f<T>(gy[t + d]), p1);
        p2 = __fmaf_rn(dnum[m * D + d], to_f<T>(v[t + d]), p2);
      }
      const float dsim = __fadd_rn(warp_sum(p1), warp_sum(p2));
      const float sg = __fmul_rn(__fmul_rn(dsim, sf), __fadd_rn(1.f, -sf));
      const float draw = __fmul_rn(sg, alpha);
      da = __fmaf_rn(sg, raw[n], da);
      db = __fadd_rn(db, sg);
      if (lane == 0) dr[n] = draw;
      for (int d = lane; d < D; d += 32) {
        float pv = 0.f;
        for (int k = 0; k < M; ++k)
          pv = __fmaf_rn(pool_weight(win[k], i, j), dnum[k * D + d], pv);
        dv[t + d] = from_f<T>(__fadd_rn(__fmul_rn(sf, dnum[m * D + d]), pv));
        const float xn = __fmul_rn(to_f<T>(x[t + d]), iv);
        cp[m * D + d] = __fmaf_rn(draw, xn, cp[m * D + d]);
      }
    }
  }
  if (lane == 0) {
    red[w] = da;
    red[kWarps + w] = db;
  }
  __syncthreads();

  // E. d centers through cn = crep * invc, then dfeat per token
  for (int e = tid; e < MD; e += kThreads) {
    float q = 0.f;
    for (int k = 0; k < kWarps; ++k) q = __fadd_rn(q, dcnp[(size_t)k * MD + e]);
    crep[e] = q;  // d cn (crep is not needed any more)
  }
  __syncthreads();
  for (int m = tid; m < M; m += kThreads) {
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = __fmaf_rn(cn[m * D + d], crep[m * D + d], dot);
    icnt[m] = dot;  // dot_c (icnt is not needed any more)
  }
  __syncthreads();
  for (int e = tid; e < MD; e += kThreads)
    dcr[e] = __fmul_rn(invc[e / D], __fadd_rn(crep[e], -__fmul_rn(cn[e], icnt[e / D])));
  __syncthreads();
  for (int n = w; n < g.N; n += kWarps) {
    const size_t t = token(g, b, r, h, n);
    const int m = arg[n], i = n / g.rw, j = n % g.rw;
    const float iv = inv[n], draw = dr[n];
    float p = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float xn = __fmul_rn(to_f<T>(x[t + d]), iv);
      p = __fmaf_rn(xn, __fmul_rn(draw, cn[m * D + d]), p);
    }
    const float dot = warp_sum(p);
    for (int d = lane; d < D; d += 32) {
      const float xn = __fmul_rn(to_f<T>(x[t + d]), iv);
      const float dxn = __fmul_rn(draw, cn[m * D + d]);
      float pc = 0.f;
      for (int k = 0; k < M; ++k)
        pc = __fmaf_rn(pool_weight(win[k], i, j), dcr[k * D + d], pc);
      dx[t + d] = from_f<T>(
          __fadd_rn(__fmul_rn(iv, __fadd_rn(dxn, -__fmul_rn(xn, dot))), pc));
    }
  }
  if (tid == 0) {
    float a = 0.f, q = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      a = __fadd_rn(a, red[k]);
      q = __fadd_rn(q, red[kWarps + k]);
    }
    const size_t row = ((size_t)b * gridDim.y + h) * gridDim.x + r;
    dab[2 * row] = a;
    dab[2 * row + 1] = q;
  }
  if (assign_out != nullptr) store_assign(g, b, r, h, arg, assign_out);
}

template <typename T>
int launch(const void* x, const void* v, const void* gy, const float* ab, void* dx,
           void* dv, float* dab, int8_t* assign, int B, int H, int W, int C, int heads,
           int fold_h, int fold_w, int ph, int pw, void* stream) {
  Geo g;
  int err = make_geo(g, B, H, W, C, heads, fold_h, fold_w, ph, pw);
  if (err) return err;
  const Layout L = layout(g);
  cudaError_t e = asy::set_smem(cluster_mix_bwd_kernel<T>, L.bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(fold_h * fold_w, heads, B);
  cluster_mix_bwd_kernel<T><<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)v, (const T*)gy, ab, (T*)dx, (T*)dv, dab, assign, g, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (feat), v (value), gy (cotangent of out), dx, dv: (B, H, W, C) NHWC in
// one type; ab = [alpha, beta] f32; dab (B * heads * fold_h * fold_w, 2) f32
// partial rows; assign (B, H, W, heads) int8 or null.
int cluster_mix_bwd_bf16(const void* x, const void* v, const void* gy, const float* ab,
                         void* dx, void* dv, float* dab, int8_t* assign, int B, int H,
                         int W, int C, int heads, int fold_h, int fold_w, int ph, int pw,
                         void* stream) {
  return launch<__nv_bfloat16>(x, v, gy, ab, dx, dv, dab, assign, B, H, W, C, heads,
                               fold_h, fold_w, ph, pw, stream);
}

int cluster_mix_bwd_f32(const void* x, const void* v, const void* gy, const float* ab,
                        void* dx, void* dv, float* dab, int8_t* assign, int B, int H, int W,
                        int C, int heads, int fold_h, int fold_w, int ph, int pw,
                        void* stream) {
  return launch<float>(x, v, gy, ab, dx, dv, dab, assign, B, H, W, C, heads, fold_h,
                       fold_w, ph, pw, stream);
}

}  // extern "C"
