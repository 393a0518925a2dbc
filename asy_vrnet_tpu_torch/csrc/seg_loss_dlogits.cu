// Fused segmentation-loss backward: dlogits from the saved sums' coefficients.
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/losses_seg_pallas.py::
// _seg_dlogits_pallas (kernel _seg_loss_bwd_kernel).  Recomputes the pixel's
// softmax and writes
//   dl_c = pixscale * dF/dlogpt * w_t * (onehot_c - p_c)      (focal or CE)
//        + p_c * (gp_c - sum_k p_k gp_k),  gp_c = A_c * onehot_c + B_c   (dice)
// with coef = [A[C], B[C], pixscale] computed by the caller from the forward
// sums, so no (B,H,W,C) intermediate other than dlogits exists.
//
// What bounds it on the H100: bytes (logits in, dlogits out, 4-byte target).
// One tile of 256 pixels per block, staged in and out of shared memory with
// coalesced 16-byte accesses (seg_loss.cuh); pixels are independent, so the
// grid is one block per tile.
#include "seg_loss.cuh"

namespace {

using asy::kTile;

template <typename T>
__global__ void __launch_bounds__(kTile)
seg_loss_dlogits_kernel(const T* __restrict__ x, const int* __restrict__ target,
                        const float* __restrict__ weights,
                        const float* __restrict__ coef, T* __restrict__ dx,
                        int npix, int C, float alpha, float gamma, int use_focal) {
  extern __shared__ float4 smem4[];
  float* v = reinterpret_cast<float*>(smem4);          // [kTile][C]
  float* co = v + kTile * C;                           // [2*C + 1]
  const int tid = threadIdx.x;
  const int base = blockIdx.x * kTile;
  const int np = min(kTile, npix - base);
  asy::stage_in<T>(x + (size_t)base * C, v, np * C, tid);
  if (tid < 2 * C + 1) co[tid] = coef[tid];
  __syncthreads();
  if (tid < np) {
    float* p = v + tid * C;
    const int tgt = target[base + tid];
    float w_t, nll;
    asy::pixel_softmax(p, C, tgt, weights, w_t, nll);
    float dfdlogpt = -1.0f;                            // CE: L = -sum(logpt)/ce_den
    if (use_focal) {
      const float logpt = -nll;
      const float pt = expf(logpt);
      // parity: om = max(1 - pt, 0); d/dlogpt of -(alpha * om^gamma * logpt) is
      // -alpha * (om^gamma - gamma * pt * logpt * om^(gamma-1)).  The second
      // term is taken as 0 where logpt == 0 (ignored pixels have pt = 1,
      // om = 0), so no 0 * inf appears for gamma < 1.
      const float om = fmaxf(1.0f - pt, 0.0f);
      const float tail = logpt == 0.0f
          ? 0.0f : gamma * pt * logpt * asy::focal_pow(om, gamma - 1.0f);
      dfdlogpt = -alpha * (asy::focal_pow(om, gamma) - tail);
    }
    const float pixc = co[2 * C] * dfdlogpt * w_t;
    float dot = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float gp = co[k] * (k == tgt ? 1.0f : 0.0f) + co[C + k];
      dot += p[k] * gp;
    }
    for (int k = 0; k < C; ++k) {
      const float oh = k == tgt ? 1.0f : 0.0f;
      const float gp = co[k] * oh + co[C + k];
      p[k] = pixc * (oh - p[k]) + p[k] * (gp - dot);
    }
  }
  __syncthreads();
  asy::stage_out<T>(v, dx + (size_t)base * C, np * C, tid);
}

template <typename T>
int launch(const void* x, const int* target, const float* weights, const float* coef,
           void* dx, int npix, int C, float alpha, float gamma, int use_focal,
           void* stream) {
  if (npix <= 0 || C < 1 || C > asy::kMaxClasses) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kTile * C + 2 * C + 1);
  cudaError_t e = asy::set_smem(seg_loss_dlogits_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (npix + kTile - 1) / kTile;
  seg_loss_dlogits_kernel<T><<<blocks, kTile, smem, (cudaStream_t)stream>>>(
      (const T*)x, target, weights, coef, (T*)dx, npix, C, alpha, gamma, use_focal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int seg_loss_dlogits_bf16(const void* x, const int* target, const float* weights,
                          const float* coef, void* dx, int npix, int C, float alpha,
                          float gamma, int use_focal, void* stream) {
  return launch<__nv_bfloat16>(x, target, weights, coef, dx, npix, C, alpha, gamma,
                               use_focal, stream);
}

int seg_loss_dlogits_f32(const void* x, const int* target, const float* weights,
                         const float* coef, void* dx, int npix, int C, float alpha,
                         float gamma, int use_focal, void* stream) {
  return launch<float>(x, target, weights, coef, dx, npix, C, alpha, gamma, use_focal,
                       stream);
}

}  // extern "C"
