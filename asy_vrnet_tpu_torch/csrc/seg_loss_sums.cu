// Fused segmentation-loss forward: every sum the losses and f_score need, in
// one pass over the logits.
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/losses_seg_pallas.py::
// _seg_sums_pallas (kernel _seg_loss_fwd_kernel).  Per pixel: log-softmax,
// class-weighted NLL, the focal term; per class: tp, sum p, sum t,
// thresholded tp and sum pred.  Output: per-block partial sums
// part[block][4 + 5*C] = [ce_num, ce_den, focal_sum, npix, tp[C], sum_p[C],
// sum_t[C], tp_f[C], sum_pred[C]].
//
// What bounds it on the H100: bytes.  A pixel costs C*sizeof(T) + 4 bytes of
// traffic against ~C exp + ~12*C flops, far under the f32 ridge, so the
// design moves each byte once: NHWC tiles staged coalesced through shared
// memory (seg_loss.cuh), nothing but the sums written.
//
// The TPU grid runs in order and accumulates into one block; here blocks run
// unordered, so a grid-stride loop keeps a block's sums in registers, each
// block writes its own partial row, and the caller reduces the rows with one
// torch sum: no float atomics, the same bits on every run.
//
// Per-class sums use a second mapping over the staged tile: thread
// t < G*C (G = kTile / C pixel groups) owns class t % C for the pixels
// t / C, t / C + G, ... of every tile, so its five accumulators stay in
// registers for the whole loop and its shared-memory reads are consecutive
// across the warp.
#include "seg_loss.cuh"

namespace {

using asy::kTile;

template <typename T>
__global__ void __launch_bounds__(kTile)
seg_loss_sums_kernel(const T* __restrict__ x, const int* __restrict__ target,
                     const float* __restrict__ weights, float* __restrict__ part,
                     int npix, int C, float alpha, float gamma, float threshold) {
  extern __shared__ float4 smem4[];
  float* v = reinterpret_cast<float*>(smem4);          // [kTile][C] logits -> probs
  int* tg = reinterpret_cast<int*>(v + kTile * C);     // [kTile] targets
  float* red = reinterpret_cast<float*>(tg + kTile);   // [kTile][5] reduction scratch
  const int tid = threadIdx.x;
  const int G = kTile / C;
  const int my_class = tid % C, my_group = tid / C;
  const bool class_thread = tid < G * C;

  float ce_num = 0.f, ce_den = 0.f, focal_sum = 0.f, count = 0.f;
  float tp = 0.f, sp = 0.f, st = 0.f, tpf = 0.f, spr = 0.f;

  const int ntiles = (npix + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int base = tile * kTile;
    const int np = min(kTile, npix - base);
    asy::stage_in<T>(x + (size_t)base * C, v, np * C, tid);
    if (tid < np) tg[tid] = target[base + tid];
    __syncthreads();
    if (tid < np) {
      float w_t, nll;
      asy::pixel_softmax(v + tid * C, C, tg[tid], weights, w_t, nll);
      // parity: the class weight sits inside the focal exponent
      // (logpt = -w_t * nll_unweighted), and ignored pixels (logpt = 0,
      // pt = 1) add 0 here but are counted in npix, the focal denominator
      const float logpt = -nll;
      const float om = 1.0f - expf(logpt);
      ce_num += nll;
      ce_den += w_t;
      focal_sum += -asy::focal_pow(om, gamma) * (alpha * logpt);
      count += 1.0f;
    }
    __syncthreads();
    if (class_thread) {
      for (int p = my_group; p < np; p += G) {
        const float pr = v[p * C + my_class];
        // parity: ignored pixels match no class, yet their probabilities
        // still add to sum_p and sum_pred; the threshold compare is strict
        const float oh = tg[p] == my_class ? 1.0f : 0.0f;
        const float pred = pr > threshold ? 1.0f : 0.0f;
        tp += oh * pr;
        sp += pr;
        st += oh;
        tpf += oh * pred;
        spr += pred;
      }
    }
    __syncthreads();
  }

  // block reduction, fixed order: scalars over all threads, class sums over
  // the G threads of each class
  float* out = part + (size_t)blockIdx.x * (4 + 5 * C);
  red[tid * 5 + 0] = ce_num;
  red[tid * 5 + 1] = ce_den;
  red[tid * 5 + 2] = focal_sum;
  red[tid * 5 + 3] = count;
  __syncthreads();
  if (tid < 4) {
    float s = 0.f;
    for (int i = 0; i < kTile; ++i) s += red[i * 5 + tid];
    out[tid] = s;
  }
  __syncthreads();
  red[tid * 5 + 0] = tp;
  red[tid * 5 + 1] = sp;
  red[tid * 5 + 2] = st;
  red[tid * 5 + 3] = tpf;
  red[tid * 5 + 4] = spr;
  __syncthreads();
  if (tid < 5 * C) {
    const int q = tid / C, k = tid % C;
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += red[(g * C + k) * 5 + q];
    out[4 + q * C + k] = s;
  }
}

template <typename T>
int launch(const void* x, const int* target, const float* weights, float* part,
           int npix, int C, float alpha, float gamma, float threshold, int blocks,
           void* stream) {
  if (npix <= 0 || C < 1 || C > asy::kMaxClasses || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kTile * C + sizeof(int) * kTile +
                      sizeof(float) * kTile * 5;
  cudaError_t e = asy::set_smem(seg_loss_sums_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  seg_loss_sums_kernel<T><<<blocks, kTile, smem, (cudaStream_t)stream>>>(
      (const T*)x, target, weights, part, npix, C, alpha, gamma, threshold);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int seg_loss_sums_bf16(const void* x, const int* target, const float* weights,
                       float* part, int npix, int C, float alpha, float gamma,
                       float threshold, int blocks, void* stream) {
  return launch<__nv_bfloat16>(x, target, weights, part, npix, C, alpha, gamma,
                               threshold, blocks, stream);
}

int seg_loss_sums_f32(const void* x, const int* target, const float* weights,
                      float* part, int npix, int C, float alpha, float gamma,
                      float threshold, int blocks, void* stream) {
  return launch<float>(x, target, weights, part, npix, C, alpha, gamma, threshold,
                       blocks, stream);
}

}  // extern "C"
