// Stand-alone cluster mix, forward (K7): the token mixing between a
// Cluster's fc1/fc_v and fc2 projections,
//   out = dispatch(sim, (sim . value + value_centers) / (count + 1)),
//   sim = sigmoid(beta + alpha * cos(centers, feat)) at each token's first
//   max proposal,
// on feat and value already projected (NHWC, inner width heads * D).
// Optionally writes the winning proposal per (token, head) as int8, and
// the mixed centers (the bits K7b computes).
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/cluster_pallas.py::
// _cluster_nhwc_pallas (kernel _cluster_kernel, body _mixer_core), reached
// through cluster_mix_pallas when a ClusterBlock cannot take the fused path
// (active dropout or drop-path).
//
// What bounds it on the H100: per token and head it reads D values of feat
// and of value and writes D of out, and does ~2*D*(M+1) (norms, cosines) +
// 4*D (aggregate, dispatch) flops: about 2 flops a byte in bf16, far under
// the ridge, so bytes bound it (3 * B*H*W*I * itemsize).  The TPU kernel's
// dense masked matmuls over (region group x head) rows, ~16x redundant
// products that keep a 128-wide matrix unit busy, are not carried over.
// What holds it back is instruction throughput and latency: every region
// is 256 tokens at the stochastic-depth shapes, 4096 CTAs at stage 0 and
// 128 at stage 3, so each CTA's instruction count and its chain of
// barriers decide the time.
//
// Design.  One CTA of 256 threads per (sample, region, head), the mapping
// of cluster_mix.cuh (4 tokens a warp, 8 lanes a token); the region's
// tiles of feat and value are staged in shared memory once (cp.async)
// where they fit:
//   A. pool the M proposal windows of feat and value (cluster_mix.cuh);
//   B. per token: norm, cosines to the M centers, first max, sigmoid of
//      the winner (cluster_mix.cuh); the winner's sim and proposal stay in
//      shared memory;
//   C. the mixed centers oc = (agg + value centers) / (count + 1) by
//      cluster_mix.cuh::mixed_centers, K7b's phase C (fast: register sums
//      over each thread's tokens, shuffles over the warp's slots, the warps
//      in a fixed pairwise order; the same bits on every run, and in K7b);
//      its warp partials take feat's tile, which nothing reads after B;
//   D. the dispatch, a token at a time: its offset once, then every token
//      takes rnd(sim) * rnd(oc[winner]), 4 channels a lane in one store
//      (fast) or channels sub, sub + 8, ... (general).
#include "cluster_mix.cuh"

namespace {

using namespace asy::cmix;

struct Layout {  // byte offsets, each 16-byte aligned; the tiles first
  size_t xs, vs, part, cntw, win, crep, vc, invc, cn, cnr, s, arg, bytes;
  int vec;      // cp.async width of the staging copies (0: plain copies)
  bool staged;  // the tiles are in shared memory
};

inline Layout layout(const Geo& g, size_t esz, bool staged, int vec) {
  const size_t md = (size_t)g.M * g.D * 4, tile = (size_t)g.N * g.D * esz;
  const size_t part = fast_path(g.D, g.M) ? (size_t)kWarps * kFastM * kFastD * 4 : 0;
  Layout L;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o = (o + bytes + 15) / 16 * 16;
    return at;
  };
  L.staged = staged;
  L.vec = vec;
  L.xs = take(staged ? tile : 0);
  L.vs = take(staged ? tile : 0);
  L.part = staged && tile >= part ? L.xs : take(part);  // feat's tile is free after B
  L.cntw = take((size_t)kWarps * kFastM * 4);
  L.win = take((size_t)kWindowFloats * g.M * 4);
  L.crep = take(md);
  L.vc = take(md);
  L.invc = take((size_t)g.M * 4);
  L.cn = take(md);
  L.cnr = take(md);
  L.s = take((size_t)g.N * 4);
  L.arg = take(g.N);
  L.bytes = o;
  return L;
}

// The layout a launch takes: staged where the card's shared memory holds it.
inline Layout pick_layout(const Geo& g, size_t esz, int vec) {
  const Layout L = layout(g, esz, true, vec);
  return L.bytes <= smem_optin() ? L : layout(g, esz, false, vec);
}

template <typename T, bool kFast, bool kStaged>
__global__ void __launch_bounds__(kThreads)
cluster_mix_kernel(const T* __restrict__ x, const T* __restrict__ v,
                   const float* __restrict__ ab, T* __restrict__ out,
                   int8_t* __restrict__ assign_out, float* __restrict__ centers_out, Geo g,
                   Layout L) {
  using asy::rnd;
  extern __shared__ float4 smem4[];
  unsigned char* sb = reinterpret_cast<unsigned char*>(smem4);
  auto fl = [&](size_t o) { return reinterpret_cast<float*>(sb + o); };
  Window* win = reinterpret_cast<Window*>(sb + L.win);  // [M]
  float* crep = fl(L.crep);  // [M][D]; after C: the mixed centers oc
  float* vc = fl(L.vc);      // [M][D]
  float* invc = fl(L.invc);  // [M]
  float* cn = fl(L.cn);      // [M][D]
  float* cnr = fl(L.cnr);    // [M][D]
  float* part = fl(L.part);  // fast: [kWarps][kFastM][kFastD] warp sums
  int* cntw = reinterpret_cast<int*>(sb + L.cntw);  // fast: [kWarps][kFastM]
  float* s = fl(L.s);        // [N] winner's sim
  unsigned char* arg = sb + L.arg;  // [N]

  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int sub = threadIdx.x % kLanes, q = threadIdx.x / kLanes, D = g.D;
  T* xs = reinterpret_cast<T*>(sb + L.xs);
  T* vs = reinterpret_cast<T*>(sb + L.vs);
  const auto X = view<kStaged>(g, x, xs, b, r, h);
  const auto V = view<kStaged>(g, v, vs, b, r, h);
  if constexpr (kStaged) {
    stage(X, x, xs, g.N, L.vec);
    stage(V, v, vs, g.N, L.vec);
    asy::cp_async_commit();
    asy::cp_async_wait<0>();
  }
  __syncthreads();

  centers<T, kFast>(g, X, V, win, crep, vc, invc, cn, cnr);
  assign<T, kFast>(g, X, cnr, ab[0], ab[1], s, arg, nullptr, nullptr);
  float* oc = crep;  // c_rep is not read after A
  mixed_centers<T, kFast, false>(g, V, V, s, arg, vc, part, cntw, oc, nullptr);
  if (centers_out != nullptr) store_centers(g, b, r, h, oc, centers_out);

  // D. the dispatch: slot q takes tokens q, q + kTok, ...
  for (int n = q; n < g.N; n += kTok) {
    const int m = arg[n];
    const float sr = rnd<T>(s[n]);
    T* o = out + X.goff(n);
    if constexpr (kFast) {
      const float4 c = *reinterpret_cast<const float4*>(oc + m * D + 4 * sub);
      const float y[4] = {__fmul_rn(sr, rnd<T>(c.x)), __fmul_rn(sr, rnd<T>(c.y)),
                          __fmul_rn(sr, rnd<T>(c.z)), __fmul_rn(sr, rnd<T>(c.w))};
      store4(o + 4 * sub, y);
    } else {
      for (int d = sub; d < D; d += kLanes)
        o[d] = asy::from_f<T>(__fmul_rn(sr, rnd<T>(oc[m * D + d])));
    }
  }
  if (assign_out != nullptr) store_assign(g, b, r, h, arg, assign_out);
}

// the instantiation for the fast or general mapping, staged tiles or not
template <typename T>
auto kernel_for(bool fast, bool staged) {
  return fast ? (staged ? cluster_mix_kernel<T, true, true> : cluster_mix_kernel<T, true, false>)
              : (staged ? cluster_mix_kernel<T, false, true> : cluster_mix_kernel<T, false, false>);
}

template <typename T>
int launch(const void* x, const void* v, const float* ab, void* out, int8_t* assign,
           float* centers, int B, int H, int W, int C, int heads, int fold_h, int fold_w,
           int ph, int pw, int fast, void* stream) {
  Geo g;
  int err = make_geo(g, B, H, W, C, heads, fold_h, fold_w, ph, pw);
  if (err) return err;
  if (!path_ok(g, fast, {x, v, out})) return (int)cudaErrorInvalidValue;
  const Layout L = pick_layout(g, sizeof(T), stage_vec(g, sizeof(T), {x, v}));
  const auto kernel = kernel_for<T>(fast, L.staged);
  cudaError_t e = asy::set_smem(kernel, L.bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(fold_h * fold_w, heads, B);
  kernel<<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>((const T*)x, (const T*)v, ab,
                                                           (T*)out, assign, centers, g, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (feat), v (value), out: (B, H, W, C) NHWC, C = heads * D; ab = [alpha,
// beta] f32 on the device; assign (B, H, W, heads) int8 or null; centers
// (B, heads, fold_h * fold_w, ph * pw, D) f32 or null: the mixed centers;
// fast: the wrapper's reading of fast_path (a launch that disagrees is
// refused).
int cluster_mix_bf16(const void* x, const void* v, const float* ab, void* out,
                     int8_t* assign, float* centers, int B, int H, int W, int C, int heads,
                     int fold_h, int fold_w, int ph, int pw, int fast, void* stream) {
  return launch<__nv_bfloat16>(x, v, ab, out, assign, centers, B, H, W, C, heads, fold_h,
                               fold_w, ph, pw, fast, stream);
}

int cluster_mix_f32(const void* x, const void* v, const float* ab, void* out,
                    int8_t* assign, float* centers, int B, int H, int W, int C, int heads,
                    int fold_h, int fold_w, int ph, int pw, int fast, void* stream) {
  return launch<float>(x, v, ab, out, assign, centers, B, H, W, C, heads, fold_h, fold_w, ph,
                       pw, fast, stream);
}

// The kernel at this geometry (esz: 2 for bf16, 4 for f32; tensors assumed
// 16-byte aligned): out = [dynamic shared memory bytes, CTAs per SM,
// registers per thread, threads per CTA, fast path, tiles staged]
int cluster_mix_info(int esz, int B, int H, int W, int C, int heads, int fold_h, int fold_w,
                     int ph, int pw, int* out) {
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
