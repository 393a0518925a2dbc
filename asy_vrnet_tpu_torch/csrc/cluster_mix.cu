// Stand-alone cluster mix, forward (K7): the token mixing between a
// Cluster's fc1/fc_v and fc2 projections,
//   out = dispatch(sim, (sim . value + value_centers) / (count + 1)),
//   sim = sigmoid(beta + alpha * cos(centers, feat)) at each token's first
//   max proposal,
// on feat and value already projected (NHWC, inner width heads * D).
// Optionally writes the winning proposal per (token, head) as int8.
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
//
// Design.  One CTA of 256 threads per (sample, region, head); the head's
// D channels of the region are read from device memory (L2 after the first
// pass):
//   A. pool the M proposal windows of feat and value (cluster_mix.cuh);
//   B. one warp per token: norm, cosines to the M centers, first max,
//      sigmoid of the winner (cluster_mix.cuh); per token the winner's sim
//      and proposal stay in shared memory;
//   C. each warp sums rnd(sim) * value over its tokens into its own
//      [M][D] partial (lane = channel: no races), and counts; the 8
//      partials are added in a fixed order (the same bits on every run);
//   D. oc = (agg + value centers) / (count + 1), rounded; every token takes
//      rnd(sim) * oc[winner].
#include "cluster_mix.cuh"

namespace {

using namespace asy::cmix;

struct Layout {  // offsets in floats; the per-token proposals follow
  size_t win, crep, vc, invc, cn, cnr, xrow, aggp, cntp, s, floats, arg, bytes;
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
  L.aggp = o; o += (size_t)kWarps * md;
  L.cntp = o; o += (size_t)kWarps * g.M;
  L.s = o;    o += g.N;
  L.floats = o;
  L.arg = o * sizeof(float);
  L.bytes = L.arg + g.N;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cluster_mix_kernel(const T* __restrict__ x, const T* __restrict__ v,
                   const float* __restrict__ ab, T* __restrict__ out,
                   int8_t* __restrict__ assign_out, Geo g, Layout L) {
  using asy::rnd;
  using asy::to_f;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  Window* win = reinterpret_cast<Window*>(sm + L.win);  // [M]
  float* crep = sm + L.crep;  // [M][D]; after C: the rounded mixed centers
  float* vc = sm + L.vc;      // [M][D]
  float* invc = sm + L.invc;  // [M]
  float* cn = sm + L.cn;      // [M][D]
  float* cnr = sm + L.cnr;    // [M][D]
  float* xrow = sm + L.xrow;  // [kWarps][D]
  float* aggp = sm + L.aggp;  // [kWarps][M][D]
  float* cntp = sm + L.cntp;  // [kWarps][M]
  float* s = sm + L.s;        // [N] winner's sim
  unsigned char* arg = reinterpret_cast<unsigned char*>(smem4) + L.arg;  // [N]

  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int D = g.D, M = g.M, MD = M * D;
  for (int e = tid; e < kWarps * MD; e += kThreads) aggp[e] = 0.f;
  for (int e = tid; e < kWarps * M; e += kThreads) cntp[e] = 0.f;

  centers<T>(g, x, v, b, r, h, win, crep, vc, invc, cn, cnr);
  assign<T>(g, x, b, r, h, cnr, ab[0], ab[1], xrow, s, arg, nullptr, nullptr);

  // C. per-warp partial sums of rnd(sim) * value, and the counts
  float* ap = aggp + (size_t)w * MD;
  for (int n = w; n < g.N; n += kWarps) {
    const T* vt = v + token(g, b, r, h, n);
    const int m = arg[n];
    const float sr = rnd<T>(s[n]);
    for (int d = lane; d < D; d += 32)
      ap[m * D + d] = __fmaf_rn(sr, to_f<T>(vt[d]), ap[m * D + d]);
    if (lane == 0) cntp[w * M + m] = __fadd_rn(cntp[w * M + m], 1.f);
  }
  __syncthreads();
  // D. mixed centers (into crep), then the dispatch
  for (int e = tid; e < MD; e += kThreads) {
    const int m = e / D;
    float a = 0.f, c = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      a = __fadd_rn(a, aggp[(size_t)k * MD + e]);
      c = __fadd_rn(c, cntp[k * M + m]);
    }
    crep[e] = rnd<T>(__fdiv_rn(__fadd_rn(a, vc[e]), __fadd_rn(c, 1.f)));
  }
  __syncthreads();
  for (int e = tid; e < g.N * D; e += kThreads) {
    const int n = e / D, d = e % D;
    out[token(g, b, r, h, n) + d] =
        asy::from_f<T>(__fmul_rn(rnd<T>(s[n]), crep[arg[n] * D + d]));
  }
  if (assign_out != nullptr) store_assign(g, b, r, h, arg, assign_out);
}

template <typename T>
int launch(const void* x, const void* v, const float* ab, void* out, int8_t* assign,
           int B, int H, int W, int C, int heads, int fold_h, int fold_w, int ph, int pw,
           void* stream) {
  Geo g;
  int err = make_geo(g, B, H, W, C, heads, fold_h, fold_w, ph, pw);
  if (err) return err;
  const Layout L = layout(g);
  cudaError_t e = asy::set_smem(cluster_mix_kernel<T>, L.bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(fold_h * fold_w, heads, B);
  cluster_mix_kernel<T><<<grid, kThreads, L.bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)v, ab, (T*)out, assign, g, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (feat), v (value), out: (B, H, W, C) NHWC, C = heads * D; ab = [alpha,
// beta] f32 on the device; assign (B, H, W, heads) int8 or null.
int cluster_mix_bf16(const void* x, const void* v, const float* ab, void* out,
                     int8_t* assign, int B, int H, int W, int C, int heads, int fold_h,
                     int fold_w, int ph, int pw, void* stream) {
  return launch<__nv_bfloat16>(x, v, ab, out, assign, B, H, W, C, heads, fold_h, fold_w,
                               ph, pw, stream);
}

int cluster_mix_f32(const void* x, const void* v, const float* ab, void* out,
                    int8_t* assign, int B, int H, int W, int C, int heads, int fold_h,
                    int fold_w, int ph, int pw, void* stream) {
  return launch<float>(x, v, ab, out, assign, B, H, W, C, heads, fold_h, fold_w, ph, pw,
                       stream);
}

}  // extern "C"
