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
//
// Thread mapping.  A warp takes 4 tokens at a time, 8 lanes a token
// (kLanes): the block's 256 threads cover 32 tokens a step, and every sum
// over a token's D channels is a 3-level shuffle inside its 8 lanes.  Two
// instantiations (`kFast`, chosen from the shape alone by fast_path, so K7
// and K7b always take the same one):
//   fast     D == 32, M <= 4: lane `sub` holds channels 4*sub .. 4*sub + 3
//            (one 8- or 16-byte load), the M cosines of a token are formed
//            at once from centers held in registers and summed over the 8
//            lanes by a reduce-scatter (lanes 2m, 2m + 1 end with cosine m
//            and take its sigmoid), and the per-proposal sums are register
//            sums;
//   general  any D >= 8 and M: lane `sub` takes channels sub, sub + 8, ...
//            and the proposals one after another.
// The CTA's tiles of the inputs (N tokens x D channels each) are staged in
// shared memory once (cp.async where the widths allow it) when they fit;
// otherwise every phase reads them from device memory.  Where they are read
// from changes no value.
#pragma once

#include "common.cuh"

namespace asy {
namespace cmix {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                  // lanes per token
constexpr int kTok = kThreads / kLanes;    // tokens per block step
constexpr int kFastD = 32, kFastM = 4;     // the fast instantiation's widths

struct Geo {
  int B, H, W, C, heads, D, fold_h, fold_w, rh, rw, N, ph, pw, M;
};

// Whether a (head width D, proposals M) shape takes the fast instantiation
// (ops/kernels.py::cluster_mix_fast states the same for the wrapper).
__host__ __device__ inline bool fast_path(int D, int M) { return D == kFastD && M <= kFastM; }

// Element offset of channel 0 of head h of token n (row-major inside the
// region) of region r (row-major over the fold grid) of sample b, NHWC.
__device__ __forceinline__ size_t token(const Geo& g, int b, int r, int h, int n) {
  const int row = (r / g.fold_w) * g.rh + n / g.rw;
  const int col = (r % g.fold_w) * g.rw + n % g.rw;
  return ((size_t)(b * g.H + row) * g.W + col) * g.C + (size_t)h * g.D;
}

// One input's tokens of the CTA's (sample, region, head): the staged tile
// ([N][D], kStaged) or the NHWC tensor.  goff(n) is token n's offset in the
// NHWC tensor either way (for the outputs); i = n / rw and j = n % rw come
// from a float reciprocal (asy::div_small), not an integer division.
template <typename T, bool kStaged>
struct View {
  const T* p;
  size_t off0;  // offset of token 0 in the NHWC tensor
  int D, rw, W, C;
  float rrw;  // 1 / rw
  __device__ __forceinline__ int row(int n, int& j) const { return asy::div_small(n, rw, rrw, j); }
  __device__ __forceinline__ size_t goff(int n) const {
    int j;
    const int i = row(n, j);
    return off0 + ((size_t)i * W + j) * C;
  }
  __device__ __forceinline__ const T* at(int n) const {
    if constexpr (kStaged)
      return p + (size_t)n * D;
    else
      return p + goff(n);
  }
};

template <bool kStaged, typename T>
__device__ __forceinline__ View<T, kStaged> view(const Geo& g, const T* src, const T* tile,
                                                 int b, int r, int h) {
  View<T, kStaged> o;
  o.p = kStaged ? tile : src;
  o.off0 = token(g, b, r, h, 0);
  o.D = g.D;
  o.rw = g.rw;
  o.W = g.W;
  o.C = g.C;
  o.rrw = 1.f / g.rw;
  return o;
}

// Stages the CTA's N x D tile of src (as view `v` of it reads it) into dst,
// `vec` bytes a copy (cp.async; 0: plain element copies); the caller
// commits, waits and syncs.
template <typename T, bool kStaged>
__device__ __forceinline__ void stage(const View<T, kStaged>& v, const T* src, T* dst, int N,
                                      int vec) {
  const int D = v.D, tid = threadIdx.x;
  if (vec == 0) {
    const float rd = 1.f / D;
    for (int e = tid; e < N * D; e += kThreads) {
      int d;
      const int n = asy::div_small(e, D, rd, d);
      int j;
      const int i = v.row(n, j);
      dst[e] = src[v.off0 + ((size_t)i * v.W + j) * v.C + d];
    }
    return;
  }
  const int per = D * (int)sizeof(T) / vec;  // copies per token
  const float rp = 1.f / per;
  for (int e = tid; e < N * per; e += kThreads) {
    int u;
    const int n = asy::div_small(e, per, rp, u);
    int j;
    const int i = v.row(n, j);
    const char* s = reinterpret_cast<const char*>(src + v.off0 + ((size_t)i * v.W + j) * v.C) +
                    u * vec;
    char* d = reinterpret_cast<char*>(dst + (size_t)n * D) + u * vec;
    if (vec == 16)
      asy::cp_async<16>(d, s, true);
    else if (vec == 8)
      asy::cp_async<8>(d, s, true);
    else
      asy::cp_async<4>(d, s, true);
  }
}

// 4 consecutive values (8- or 16-byte aligned) to f32, and back
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  o[0] = __low2float(a);
  o[1] = __high2float(a);
  o[2] = __low2float(c);
  o[3] = __high2float(c);
}
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x;
  o[1] = f.y;
  o[2] = f.z;
  o[3] = f.w;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 u;
  u.x = asy::pack_bf16(v[0], v[1]);
  u.y = asy::pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

// Sum over a token's kLanes lanes; every lane of the group gets the same
// bits (a + b == b + a).  All 32 lanes must call it.
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The sums over a token's kLanes lanes of the 4 values v[0..3], one a lane:
// lanes 2m and 2m + 1 of the group get the sum of v[m], with the bits
// group_sum(v[m]) gives (each step adds the same two partial sums; only
// the operands' order differs).  All 32 lanes must call it.
__device__ __forceinline__ float scatter_sum4(const float (&v)[4], int sub) {
  const bool hi = sub & 4, h2 = sub & 2;
  const float k0 = hi ? v[2] : v[0], k1 = hi ? v[3] : v[1];
  const float b0 = __fadd_rn(k0, __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 4));
  const float b1 = __fadd_rn(k1, __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 4));
  const float c = __fadd_rn(h2 ? b1 : b0, __shfl_xor_sync(0xffffffffu, h2 ? b0 : b1, 2));
  return __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, 1));
}

// Sum over the 4 token slots of a warp (lanes with the same sub-lane), for
// values that are the same in the 8 lanes of a slot or per sub-lane.
__device__ __forceinline__ float slot_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// The kWarps values p[0], p[stride], ... added in a fixed pairwise order.
__device__ __forceinline__ float warps_sum(const float* p, int stride) {
  float a[kWarps];
#pragma unroll
  for (int k = 0; k < kWarps; ++k) a[k] = p[k * stride];
#pragma unroll
  for (int s = 1; s < kWarps; s <<= 1)
#pragma unroll
    for (int k = 0; k < kWarps; k += 2 * s) a[k] = __fadd_rn(a[k], a[k + s]);
  return a[0];
}

__device__ __forceinline__ float sigmoid(float z) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));
}

// Centers of the CTA's (sample, region, head), all [M][D] f32 in shared
// memory: crep = pooled feat, vc = pooled value, cn = crep / |crep| and cnr =
// cn rounded to the working type; invc [M] = 1 / |crep|.  Also fills the
// window table win [M] (kWindowFloats floats each).  Each (which, m, d)
// walks its window's rows in 4 fixed classes (row - lh mod 4), whose sums
// are added in a fixed order, (c0 + c1) + (c2 + c3).  general: a thread per
// (which, m, d) holds the 4 classes; fast: a thread per (which, m, 4
// channels, class), the classes in 4 adjacent lanes added by shuffles (the
// same bits).  Ends with __syncthreads.
template <typename T, bool kFast, typename VIEW>
__device__ void centers(const Geo& g, const VIEW& X, const VIEW& V, Window* win, float* crep,
                        float* vc, float* invc, float* cn, float* cnr) {
  const int tid = threadIdx.x, MD = g.M * g.D;
  for (int m = tid; m < g.M; m += kThreads) win[m] = window<T>(g, m);
  __syncthreads();
  if constexpr (kFast) {
    static_assert(2 * kFastM * (kFastD / 4) * 4 == kThreads, "one thread per task");
    const int k = tid & 3, c4 = (tid >> 2) & 7, m = (tid >> 5) & 3, which = tid >> 7;
    if (m < g.M) {  // the same in the whole warp
      const VIEW src = which ? V : X;
      const Window o = win[m];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = o.lh + k; i < o.hh; i += 4)
        for (int j = o.lw; j < o.hw; ++j) {
          float xv[4];
          load4(src.at(i * g.rw + j) + 4 * c4, xv);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = __fmaf_rn(o.w, xv[c], acc[c]);
        }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float h = __fadd_rn(acc[c], __shfl_xor_sync(0xffffffffu, acc[c], 1));
        acc[c] = __fadd_rn(h, __shfl_xor_sync(0xffffffffu, h, 2));
      }
      if (k == 0)
#pragma unroll
        for (int c = 0; c < 4; ++c) (which ? vc : crep)[m * g.D + 4 * c4 + c] = acc[c];
    }
  } else {
    for (int e = tid; e < 2 * MD; e += kThreads) {
      const int which = e / MD, m = (e % MD) / g.D, d = e % g.D;
      const VIEW src = which ? V : X;
      const Window o = win[m];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = o.lh; i < o.hh; i += 4)
        for (int j = o.lw; j < o.hw; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (i + k < o.hh)
              acc[k] = __fmaf_rn(o.w, to_f<T>(src.at((i + k) * g.rw + j)[d]), acc[k]);
        }
      (which ? vc : crep)[m * g.D + d] =
          __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
    }
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int m = tid >> 5; m < g.M; m += kWarps) {
    float s = 0.f;
    for (int d = lane; d < g.D; d += 32) s = __fmaf_rn(crep[m * g.D + d], crep[m * g.D + d], s);
    s = warp_sum(s);
    if (lane == 0) invc[m] = rsqrtf(__fadd_rn(s, 1e-12f));
  }
  __syncthreads();
  for (int e = tid; e < MD; e += kThreads) {
    cn[e] = __fmul_rn(crep[e], invc[e / g.D]);
    cnr[e] = rnd<T>(cn[e]);
  }
  __syncthreads();
}

// Assignment of every token of the CTA's (sample, region, head): slot q =
// tid / kLanes takes tokens q, q + kTok, ...; lane sub = tid % kLanes its
// channels (see the header).  Writes per token the winner's sim s, its
// proposal arg and, where the pointers are not null, its raw cosine and
// the token's inverse norm.  Ends with __syncthreads.
template <typename T, bool kFast, typename VIEW>
__device__ void assign(const Geo& g, const VIEW& X, const float* cnr, float alpha, float beta,
                       float* s, unsigned char* arg, float* raw_out, float* inv_out) {
  const int sub = threadIdx.x % kLanes, q = threadIdx.x / kLanes, D = g.D, M = g.M;
  float cr[kFastM][4];  // fast: this lane's channels of the rounded centers
  if constexpr (kFast) {
#pragma unroll
    for (int m = 0; m < kFastM; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) cr[m][k] = m < M ? cnr[m * D + 4 * sub + k] : 0.f;
  }
#pragma unroll 2
  for (int n0 = 0; n0 < g.N; n0 += kTok) {  // the same trip count in every lane
    const int n = n0 + q, nn = n < g.N ? n : 0;
    const T* xt = X.at(nn);
    float best = 0.f, rbest = 0.f, inv;
    int a = 0;
    if constexpr (kFast) {
      float xv[4];
      load4(xt + 4 * sub, xv);
      float n2 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) n2 = __fmaf_rn(xv[k], xv[k], n2);
      inv = rsqrtf(__fadd_rn(group_sum(n2), 1e-12f));
      float acc[kFastM] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xn = rnd<T>(__fmul_rn(xv[k], inv));
#pragma unroll
        for (int m = 0; m < kFastM; ++m) acc[m] = __fmaf_rn(cr[m][k], xn, acc[m]);
      }
      // cosine sub / 2 in this lane (the bits of group_sum: the same pairs,
      // a + b == b + a), its sigmoid, then the first max over the slot
      const float raw = scatter_sum4(acc, sub);
      const float sm = sigmoid(__fadd_rn(beta, __fmul_rn(alpha, raw)));
      const int base = (threadIdx.x & 31) & ~(kLanes - 1);
#pragma unroll
      for (int m = 0; m < kFastM; ++m) {
        const float sv = __shfl_sync(0xffffffffu, sm, base + 2 * m);
        if (m < M && (m == 0 || sv > best)) {  // strict >: the first max wins
          best = sv;
          a = m;
        }
      }
      rbest = __shfl_sync(0xffffffffu, raw, base + 2 * a);
    } else {
      float n2 = 0.f;
      for (int d = sub; d < D; d += kLanes) {
        const float xf = to_f<T>(xt[d]);
        n2 = __fmaf_rn(xf, xf, n2);
      }
      inv = rsqrtf(__fadd_rn(group_sum(n2), 1e-12f));
      for (int m = 0; m < M; ++m) {
        float acc = 0.f;
        for (int d = sub; d < D; d += kLanes)
          acc = __fmaf_rn(cnr[m * D + d], rnd<T>(__fmul_rn(to_f<T>(xt[d]), inv)), acc);
        const float raw = group_sum(acc);
        const float sm = sigmoid(__fadd_rn(beta, __fmul_rn(alpha, raw)));
        if (m == 0 || sm > best) {  // strict >: the first max wins
          best = sm;
          a = m;
          rbest = raw;
        }
      }
    }
    if (sub == 0 && n < g.N) {
      s[n] = best;
      arg[n] = (unsigned char)a;
      if (raw_out != nullptr) raw_out[n] = rbest;
      if (inv_out != nullptr) inv_out[n] = inv;
    }
  }
  __syncthreads();
}

// Phase C of both kernels: the mixed centers of the CTA's (sample, region,
// head) from each token's winner (sim s, proposal arg),
//   oc [M][D]   = (sum of rnd(s) * value + vc) / (count + 1),
//   dnum [M][D] = (sum of s * g) / (count + 1)   (kGrad only),
// as K7 and K7b both compute them: one order of every sum, so K7's output
// and K7b's rematerialised forward hold the same bits.  fast: each thread
// sums its own tokens (slot q takes q, q + kTok, ...; its 4 channels) in
// registers, the warp's 4 slots by shuffles, then the kWarps warp sums in
// a fixed pairwise order through `part` ([kWarps][1 + kGrad][kFastM]
// [kFastD] floats) and `cntw` ([kWarps][kFastM] ints).  general: one
// thread per (proposal, channel) walks the tokens in order.  No float
// atomics.  Call it after a barrier that shows s, arg and the tiles to
// every thread; it ends with __syncthreads.
template <typename T, bool kFast, bool kGrad, typename VIEW>
__device__ void mixed_centers(const Geo& g, const VIEW& V, const VIEW& G, const float* s,
                              const unsigned char* arg, const float* vc, float* part,
                              int* cntw, float* oc, float* dnum) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int sub = tid % kLanes, q = tid / kLanes, D = g.D, M = g.M, MD = M * D, N = g.N;
  if constexpr (kFast) {
    constexpr int kSet = kFastM * kFastD, kStride = (kGrad ? 2 : 1) * kSet;
    float ag[kFastM][4] = {}, dc[kFastM][4] = {};
    int cnt[kFastM] = {0, 0, 0, 0};
    for (int n = q; n < N; n += kTok) {
      const int m = arg[n];
      const float sf = s[n], sr = rnd<T>(sf);
      float vv[4], gg[4];
      load4(V.at(n) + 4 * sub, vv);
      if constexpr (kGrad) load4(G.at(n) + 4 * sub, gg);
#pragma unroll
      for (int mm = 0; mm < kFastM; ++mm) {
        if (mm == m) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            ag[mm][k] = __fmaf_rn(sr, vv[k], ag[mm][k]);
            if constexpr (kGrad) dc[mm][k] = __fmaf_rn(sf, gg[k], dc[mm][k]);
          }
          ++cnt[mm];
        }
      }
    }
#pragma unroll
    for (int mm = 0; mm < kFastM; ++mm) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float a = slot_sum(ag[mm][k]);
        if (lane < kLanes) part[w * kStride + mm * kFastD + 4 * sub + k] = a;
        if constexpr (kGrad) {
          const float c = slot_sum(dc[mm][k]);
          if (lane < kLanes) part[w * kStride + kSet + mm * kFastD + 4 * sub + k] = c;
        }
      }
      int c = cnt[mm];
      c += __shfl_xor_sync(0xffffffffu, c, 8);
      c += __shfl_xor_sync(0xffffffffu, c, 16);
      if (lane == 0) cntw[w * kFastM + mm] = c;
    }
    __syncthreads();
    for (int e = tid; e < MD; e += kThreads) {
      const int m = e / D;
      int c = 0;
      for (int k = 0; k < kWarps; ++k) c += cntw[k * kFastM + m];
      const float ic = __fdiv_rn(1.f, __fadd_rn((float)c, 1.f));
      oc[e] = __fmul_rn(__fadd_rn(warps_sum(part + e, kStride), vc[e]), ic);
      if constexpr (kGrad) dnum[e] = __fmul_rn(warps_sum(part + kSet + e, kStride), ic);
    }
  } else {
    for (int e = tid; e < MD; e += kThreads) {
      const int m = e / D, d = e % D;
      float a = 0.f, qd = 0.f, c = 0.f;
      for (int n = 0; n < N; ++n) {
        if (arg[n] == m) {
          const float sf = s[n];
          a = __fmaf_rn(rnd<T>(sf), to_f<T>(V.at(n)[d]), a);
          if constexpr (kGrad) qd = __fmaf_rn(sf, to_f<T>(G.at(n)[d]), qd);
          c = __fadd_rn(c, 1.f);
        }
      }
      const float ic = __fdiv_rn(1.f, __fadd_rn(c, 1.f));
      oc[e] = __fmul_rn(__fadd_rn(a, vc[e]), ic);
      if constexpr (kGrad) dnum[e] = __fmul_rn(qd, ic);
    }
  }
  __syncthreads();
}

// Writes the CTA's [M][D] mixed centers to row (b, h, r) of a (B, heads,
// regions, M, D) f32 tensor (a check of K7 against K7b: the same bits).
__device__ __forceinline__ void store_centers(const Geo& g, int b, int r, int h,
                                              const float* oc, float* out) {
  const int MD = g.M * g.D;
  float* row = out + (((size_t)b * g.heads + h) * (g.fold_h * g.fold_w) + r) * MD;
  for (int e = threadIdx.x; e < MD; e += kThreads) row[e] = oc[e];
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

// Whether a launch may take its shape's path: `fast` must be fast_path's
// answer (the wrapper states it, as ops/kernels.py::cluster_mix_fast), and
// the fast path's vector loads need 16-byte aligned tensors.
inline bool path_ok(const Geo& g, int fast, std::initializer_list<const void*> ptrs) {
  if (fast != (int)fast_path(g.D, g.M)) return false;
  if (!fast) return true;
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The cp.async width that stages a tile of tensors at `ptrs` (0: plain
// copies), and the card's shared memory a block may opt into.
inline int stage_vec(const Geo& g, size_t esz, std::initializer_list<const void*> ptrs) {
  int v = asy::copy_bytes({(size_t)g.D * esz, (size_t)g.C * esz});
  for (const void* p : ptrs)
    while (v && reinterpret_cast<uintptr_t>(p) % v) v = v > 4 ? v / 2 : 0;
  return v;
}
inline size_t smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return (size_t)optin;
}

}  // namespace cmix
}  // namespace asy
