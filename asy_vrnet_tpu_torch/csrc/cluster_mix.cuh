// Device code shared by the stand-alone cluster mix kernels: the forward
// (K7, cluster_mix.cu) and the backward (K7b, cluster_mix_bwd.cu).
//
// Both kernels run one CTA of kThreads threads per (sample, region, head)
// and rebuild the region's centers and each token's assignment with the
// functions below, with the same thread mapping and with every rounding
// written out (__fmaf_rn, __fmul_rn, __fadd_rn: nothing is left to the
// compiler's FMA contraction).  So the backward differentiates through the
// forward's assignment bit for bit (the reason is at
// asy_vrnet_tpu/ops/cluster_pallas.py:345-352).
//
// Numerics follow the TPU kernel's `_mixer_core`: centers pooled from the
// working-type operands with f32 sums; the center and token L2 norms in f32
// (eps 1e-12 inside the rsqrt); both normalised operands rounded to the
// working type for the cosine, summed in f32; sim = sigmoid(beta + alpha *
// cos) in f32; first max over the proposals by strict > in proposal order.
#pragma once

#include "common.cuh"

namespace asy {
namespace cmix {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Geo {
  int B, H, W, C, heads, D, fold_h, fold_w, rh, rw, N, ph, pw, M;
};

// Element offset of channel 0 of head h of token n (row-major inside the
// region) of region r (row-major over the fold grid) of sample b, NHWC.
__device__ __forceinline__ size_t token(const Geo& g, int b, int r, int h, int n) {
  const int row = (r / g.fold_w) * g.rh + n / g.rw;
  const int col = (r % g.fold_w) * g.rw + n % g.rw;
  return ((size_t)(b * g.H + row) * g.W + col) * g.C + (size_t)h * g.D;
}

// Adaptive-average window [lh, hh) x [lw, hw) of proposal m and its pooling
// weight, rounded to the working type as the TPU kernel's pool matrix is.
struct Window {
  int lh, hh, lw, hw;
  float w;
};

template <typename T>
__device__ __forceinline__ Window window(const Geo& g, int m) {
  const int pi = m / g.pw, pj = m % g.pw;
  Window o;
  o.lh = (pi * g.rh) / g.ph;
  o.hh = ((pi + 1) * g.rh + g.ph - 1) / g.ph;
  o.lw = (pj * g.rw) / g.pw;
  o.hw = ((pj + 1) * g.rw + g.pw - 1) / g.pw;
  o.w = rnd<T>(__fmul_rn(__fdiv_rn(1.f, (float)(o.hh - o.lh)),
                         __fdiv_rn(1.f, (float)(o.hw - o.lw))));
  return o;
}

// Pooling weight of the token at (i, j) of the region in window o.
__device__ __forceinline__ float pool_weight(const Window& o, int i, int j) {
  return (i >= o.lh && i < o.hh && j >= o.lw && j < o.hw) ? o.w : 0.f;
}

// Shared-memory floats that hold the M windows.
constexpr int kWindowFloats = sizeof(Window) / sizeof(float);

// Sum over the 32 lanes of a warp; every lane gets the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
}

// Centers of the CTA's (sample, region, head), all [M][D] f32 in shared
// memory: crep = pooled feat, vc = pooled value, cn = crep / |crep| and cnr =
// cn rounded to the working type; invc [M] = 1 / |crep|.  Also fills the
// window table win [M] (kWindowFloats floats each).
template <typename T>
__device__ void centers(const Geo& g, const T* __restrict__ x, const T* __restrict__ v,
                        int b, int r, int h, Window* win, float* crep, float* vc,
                        float* invc, float* cn, float* cnr) {
  const int tid = threadIdx.x, MD = g.M * g.D;
  for (int m = tid; m < g.M; m += kThreads) win[m] = window<T>(g, m);
  __syncthreads();
  for (int e = tid; e < 2 * MD; e += kThreads) {
    const int which = e / MD, m = (e % MD) / g.D, d = e % g.D;
    const T* src = which ? v : x;
    const Window o = win[m];
    float acc = 0.f;
    for (int i = o.lh; i < o.hh; ++i)
      for (int j = o.lw; j < o.hw; ++j)
        acc = __fmaf_rn(o.w, to_f<T>(src[token(g, b, r, h, i * g.rw + j) + d]), acc);
    (which ? vc : crep)[m * g.D + d] = acc;
  }
  __syncthreads();
  for (int m = tid; m < g.M; m += kThreads) {
    float s = 0.f;
    for (int d = 0; d < g.D; ++d) s = __fmaf_rn(crep[m * g.D + d], crep[m * g.D + d], s);
    invc[m] = rsqrtf(__fadd_rn(s, 1e-12f));
  }
  __syncthreads();
  for (int e = tid; e < MD; e += kThreads) {
    cn[e] = __fmul_rn(crep[e], invc[e / g.D]);
    cnr[e] = rnd<T>(cn[e]);
  }
  __syncthreads();
}

// Assignment of every token of the CTA's (sample, region, head): warp w
// takes tokens w, w + kWarps, ...; lane l takes channels l, l + 32, ...
// Writes per token the winner's sim s, its proposal arg and, where the
// pointers are not null, its raw cosine and the token's inverse norm.
// xrow is [kWarps][D] f32 scratch.  Ends with __syncthreads.
template <typename T>
__device__ void assign(const Geo& g, const T* __restrict__ x, int b, int r, int h,
                       const float* cnr, float alpha, float beta, float* xrow, float* s,
                       unsigned char* arg, float* raw_out, float* inv_out) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, D = g.D;
  float* xr = xrow + w * D;
  for (int n = w; n < g.N; n += kWarps) {
    const T* xt = x + token(g, b, r, h, n);
    float n2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float xf = to_f<T>(xt[d]);
      xr[d] = xf;
      n2 = __fmaf_rn(xf, xf, n2);
    }
    const float inv = rsqrtf(__fadd_rn(warp_sum(n2), 1e-12f));
    for (int d = lane; d < D; d += 32) xr[d] = rnd<T>(__fmul_rn(xr[d], inv));
    __syncwarp();
    float best = 0.f, rbest = 0.f;
    int a = 0;
    for (int m = 0; m < g.M; ++m) {
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc = __fmaf_rn(cnr[m * D + d], xr[d], acc);
      const float raw = warp_sum(acc);
      const float sm = sigmoid(__fadd_rn(beta, __fmul_rn(alpha, raw)));
      if (m == 0 || sm > best) {  // strict >: the first max wins
        best = sm;
        a = m;
        rbest = raw;
      }
    }
    if (lane == 0) {
      s[n] = best;
      arg[n] = (unsigned char)a;
      if (raw_out != nullptr) raw_out[n] = rbest;
      if (inv_out != nullptr) inv_out[n] = inv;
    }
    __syncwarp();
  }
  __syncthreads();
}

// Writes the CTA's assignments into the (B, H, W, heads) int8 map.
__device__ __forceinline__ void store_assign(const Geo& g, int b, int r, int h,
                                             const unsigned char* arg, int8_t* out) {
  for (int n = threadIdx.x; n < g.N; n += kThreads)
    out[token(g, b, r, 0, n) / g.C * g.heads + h] = (int8_t)arg[n];
}

inline int make_geo(Geo& g, int B, int H, int W, int C, int heads, int fold_h, int fold_w,
                    int ph, int pw) {
  if (B <= 0 || heads <= 0 || C % heads || fold_h <= 0 || fold_w <= 0 || H % fold_h ||
      W % fold_w || ph <= 0 || pw <= 0 || ph * pw > 255 || B > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  g = Geo{B, H, W, C, heads, C / heads, fold_h, fold_w, H / fold_h, W / fold_w,
          (H / fold_h) * (W / fold_w), ph, pw, ph * pw};
  return 0;
}

}  // namespace cmix
}  // namespace asy
