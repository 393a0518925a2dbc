// Fused segmentation-loss backward: dlogits from the forward's sums.
//
// Replaces the TPU kernel asy_vrnet_tpu/ops/losses_seg_pallas.py::
// _seg_dlogits_pallas (kernel _seg_loss_bwd_kernel).  Recomputes the pixel's
// softmax and writes
//   dl_c = pixscale * dF/dlogpt * w_t * (onehot_c - p_c)      (focal or CE)
//        + p_c * (gp_c - sum_k p_k gp_k),  gp_c = A_c * onehot_c + B_c   (dice)
// so no (B,H,W,C) intermediate other than dlogits exists.  Every CTA first
// computes the 2*C + 1 coefficients (A, B, pixscale) from the forward's sums
// vector and the loss cotangent, both read from device memory
// (ops/losses_seg_fused.py::_backward_coef's math): the call is one launch.
//
// What bounds it on the H100: bytes (logits in, dlogits out, 4-byte target).
// A persistent grid streams the tiles through a ring of bulk copies
// (seg_loss.cuh); each thread keeps its pixel in registers and writes its C
// results into one of two output slots, which one thread copies to device
// memory with a bulk store while the CTA goes on.  A tile costs one
// __syncthreads: it frees the input slot, and it also orders the previous
// tile's output slot (written and fenced before it) ahead of that slot's
// store.  The scalar path (the partial last tile, unaligned pointers) writes
// each pixel straight to device memory.
#include "seg_loss.cuh"

namespace {

using namespace asy::seg;

// The pixel's softmax.  On entry v[0..C) holds the pixel's
// logits; on exit the softmax probabilities (exp(l - max) * (1 / sum), one
// division a pixel).  Returns through the references the class weight of
// the pixel's target (0 when it matches no class) and nll = w_t * (lse - l_t).
template <int kN>
__device__ __forceinline__ void pixel_softmax(float (&v)[kN], int C, int tgt,
                                              const float* w_sm, float& w_t, float& nll) {
  float mx = v[0];
#pragma unroll
  for (int k = 1; k < kN; ++k)
    if (k < C) mx = fmaxf(mx, v[k]);
  // parity: a target outside [0, C) (the ignore class is C) matches no class
  const bool has = tgt >= 0 && tgt < C;
  float l_t = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k)
    if (k < C && k == tgt) l_t = v[k];
  w_t = has ? w_sm[tgt] : 0.0f;
  float ssum = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k < C) {
      const float e = expf(v[k] - mx);
      v[k] = e;
      ssum += e;
    }
  }
  const float lse = mx + logf(ssum);
  const float inv = 1.0f / ssum;
#pragma unroll
  for (int k = 0; k < kN; ++k)
    if (k < C) v[k] *= inv;
  nll = w_t * (lse - l_t);
}

// Shared memory: mbarriers, class weights, coefficients, then two output
// slots and the ring
constexpr int kHeader = 8 * kMaxStages + 4 * kMaxClasses + 4 * (2 * kMaxClasses + 4);

template <int kN>
__device__ __forceinline__ void pixel_dlogits(float (&v)[kN], int C, int tgt, const float* w_sm,
                                              const float (&A)[kN], const float (&B)[kN],
                                              float pixscale, const Hyper& h) {
  float w_t, nll;
  pixel_softmax(v, C, tgt, w_sm, w_t, nll);
  float dfdlogpt = -1.0f;                          // CE: L = -sum(logpt)/ce_den
  if (h.use_focal) {
    const float logpt = -nll;
    const float pt = expf(logpt);
    // parity: om = max(1 - pt, 0); d/dlogpt of -(alpha * om^gamma * logpt) is
    // -alpha * (om^gamma - gamma * pt * logpt * om^(gamma-1)).  The second
    // term is taken as 0 where logpt == 0 (ignored pixels have pt = 1,
    // om = 0), so no 0 * inf appears for gamma < 1.
    const float om = fmaxf(1.0f - pt, 0.0f);
    const float tail =
        logpt == 0.0f ? 0.0f : h.gamma * pt * logpt * focal_pow(om, h.gamma - 1.0f);
    dfdlogpt = -h.alpha * (focal_pow(om, h.gamma) - tail);
  }
  const float pixc = pixscale * dfdlogpt * w_t;
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k < C) {
      const float gp = A[k] * (k == tgt ? 1.0f : 0.0f) + B[k];
      dot += v[k] * gp;
    }
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k < C) {
      const float oh = k == tgt ? 1.0f : 0.0f;
      const float gp = A[k] * oh + B[k];
      v[k] = pixc * (oh - v[k]) + v[k] * (gp - dot);
    }
  }
}

// Writes the C results of a pixel to `dst` in T (rounded to bf16 first with
// kRound)
template <typename T, bool kRound, int kN>
__device__ __forceinline__ void store_pixel(T* dst, const float (&v)[kN], int C) {
#pragma unroll
  for (int k = 0; k < kN; ++k)
    if (k < C) dst[k] = asy::from_f<T>(kRound ? asy::rnd<__nv_bfloat16>(v[k]) : v[k]);
}

template <typename T, int kC, bool kRound>
__global__ void __launch_bounds__(kTile, kC ? 3 : 1)
seg_loss_dlogits_kernel(const T* __restrict__ x, const int* __restrict__ target,
                        const float* __restrict__ weights, const float* __restrict__ sums,
                        const float* __restrict__ gloss, T* __restrict__ dx, int npix, int c_rt,
                        Hyper h, int stages, int bulk) {
  constexpr int kN = kC ? kC : kMaxClasses;
  const int C = kC ? kC : c_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* w_sm = reinterpret_cast<float*>(smem + 8 * kMaxStages);
  float* co = w_sm + kMaxClasses;                 // [A[C], B[C], pixscale]
  const int xbytes = kTile * C * (int)sizeof(T), sbytes = xbytes + kTile * 4;
  unsigned char* out = smem + kHeader;            // [2][kTile * C] T
  unsigned char* ring = out + 2 * xbytes;
  const int tid = threadIdx.x;
  const Tiles tiles(npix, bulk, kTile);

  load_weights(w_sm, weights, C);
  // the coefficients (ops/losses_seg_fused.py::_backward_coef): dL_dice/dp_c
  // = A_c * onehot_c + B_c, and the pixel scale g / npix (focal) or
  // g / ce_den (CE)
  const float g = *gloss;
  if (tid < C) {
    float a = 0.0f, b = 0.0f;
    if (h.use_dice) {
      const float b2 = h.dice_beta * h.dice_beta;
      const float u = (1.0f + b2) * sums[kNScal + tid] + h.dice_smooth;
      const float v = b2 * sums[kNScal + 2 * C + tid] + sums[kNScal + C + tid] + h.dice_smooth;
      // L_dice = 1 - mean_c u/v; d/dtp = -(1+b2)/(C v); d/dsum_p = u/(C v^2)
      a = g * (-(1.0f + b2) / ((float)C * v));
      b = g * (u / ((float)C * v * v));
    }
    co[tid] = a;
    co[C + tid] = b;
  }
  if (tid == 0)
    co[2 * C] = g / (h.use_focal ? sums[kNpix] : fmaxf(sums[kCeDen], 1e-12f));
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bar[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  float A[kN], B[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    A[k] = k < C ? co[k] : 0.0f;
    B[k] = k < C ? co[C + k] : 0.0f;
  }
  const float pixscale = co[2 * C];

  // asks for the CTA's j-th ring tile into slot j % stages (thread 0)
  auto issue = [&](int j) {
    const int t = tiles.ring(j);
    if (t < 0) return;
    const int s = j % stages;
    unsigned char* slot = ring + s * sbytes;
    mbar_expect_tx(&bar[s], sbytes);
    bulk_load(slot, x + (size_t)t * kTile * C, xbytes, &bar[s]);
    bulk_load(slot + xbytes, target + (size_t)t * kTile, kTile * 4, &bar[s]);
  };
  if (tid == 0)
    for (int j = 0; j < stages; ++j) issue(j);

  int j = 0;
  for (; tiles.ring(j) >= 0; ++j) {
    const int s = j % stages;
    const unsigned char* slot = ring + s * sbytes;
    mbar_wait(&bar[s], (j / stages) & 1);
    float v[kN];
    load_pixel<T, kRound>(v, reinterpret_cast<const T*>(slot) + tid * C, C);
    const int tgt = reinterpret_cast<const int*>(slot + xbytes)[tid];
    pixel_dlogits(v, C, tgt, w_sm, A, B, pixscale, h);
    // output slot j % 2 was last read by tile j - 2's store, issued after
    // the previous barrier: it is done before this one
    if (tid == 0) bulk_wait_read();
    __syncthreads();                      // input slot s free; tile j - 1's output written
    if (tid == 0) {
      if (j > 0) {
        bulk_store(dx + (size_t)tiles.ring(j - 1) * kTile * C, out + ((j - 1) & 1) * xbytes,
                   xbytes);
        bulk_commit();
      }
      issue(j + stages);
    }
    store_pixel<T, kRound>(reinterpret_cast<T*>(out + (j & 1) * xbytes) + tid * C, v, C);
    fence_async_shared();
  }
  if (j > 0) {
    __syncthreads();
    if (tid == 0) {
      bulk_store(dx + (size_t)tiles.ring(j - 1) * kTile * C, out + ((j - 1) & 1) * xbytes, xbytes);
      bulk_commit();
    }
  }
  for (int t = tiles.scalar_start(); t < tiles.ntiles; t += gridDim.x) {
    const int p = t * kTile + tid;
    if (p < npix) {
      float v[kN];
      load_pixel<T, kRound>(v, x + (size_t)p * C, C);
      pixel_dlogits(v, C, target[p], w_sm, A, B, pixscale, h);
      store_pixel<T, kRound>(dx + (size_t)p * C, v, C);
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <typename T, int kC, bool kRound>
const void* kernel_ptr() {
  return (const void*)seg_loss_dlogits_kernel<T, kC, kRound>;
}

const void* pick(int esz, int C, int round_bf16) {
  if (esz == 2) return C == 9 ? kernel_ptr<__nv_bfloat16, 9, false>()
                              : kernel_ptr<__nv_bfloat16, 0, false>();
  if (round_bf16) return C == 9 ? kernel_ptr<float, 9, true>() : kernel_ptr<float, 0, true>();
  return C == 9 ? kernel_ptr<float, 9, false>() : kernel_ptr<float, 0, false>();
}

size_t smem_bytes(int C, int esz) {
  return kHeader + 2 * (size_t)kTile * C * esz + (size_t)ring_stages(C, esz) * slot_bytes(C, esz);
}

template <typename T>
int launch(const void* x, const int* target, const float* weights, const float* sums,
           const float* gloss, void* dx, int npix, int C, float alpha, float gamma,
           int use_focal, int use_dice, float dice_beta, float dice_smooth, int blocks,
           int round_bf16, void* stream) {
  constexpr int esz = (int)sizeof(T);
  if (npix <= 0 || C < 1 || C > kMaxClasses || blocks < 1 || (round_bf16 && esz == 2))
    return (int)cudaErrorInvalidValue;
  const void* kernel = pick(esz, C, round_bf16);
  const size_t smem = smem_bytes(C, esz);
  cudaError_t e = set_smem_carveout(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const Hyper h{alpha, gamma, 0.0f, use_focal, use_dice, dice_beta, dice_smooth, 0.0f, 0.0f};
  const int stages = ring_stages(C, esz);
  const int bulk = ((uintptr_t)x % 16 == 0) && ((uintptr_t)target % 16 == 0) &&
                   ((uintptr_t)dx % 16 == 0);
  const T* xt = (const T*)x;
  T* dxt = (T*)dx;
  void* args[] = {(void*)&xt, (void*)&target, (void*)&weights, (void*)&sums, (void*)&gloss,
                  (void*)&dxt, (void*)&npix, (void*)&C, (void*)&h, (void*)&stages,
                  (void*)&bulk};
  e = cudaLaunchKernel(kernel, dim3(blocks), dim3(kTile), args, smem, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();    // read (and cleared) either way
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

// sums: the forward's (4 + 5*C,) f32 sums vector; gloss: the loss cotangent
// (one f32); weights may be null (every class 1); round_bf16 (f32 logits
// only): round each logit to bf16 on load and each result to bf16 before it
// is stored as f32, the bf16 path's values.
int seg_loss_dlogits_bf16(const void* x, const int* target, const float* weights,
                          const float* sums, const float* gloss, void* dx, int npix, int C,
                          float alpha, float gamma, int use_focal, int use_dice, float dice_beta,
                          float dice_smooth, int blocks, int round_bf16, void* stream) {
  return launch<__nv_bfloat16>(x, target, weights, sums, gloss, dx, npix, C, alpha, gamma,
                               use_focal, use_dice, dice_beta, dice_smooth, blocks, round_bf16,
                               stream);
}

int seg_loss_dlogits_f32(const void* x, const int* target, const float* weights,
                         const float* sums, const float* gloss, void* dx, int npix, int C,
                         float alpha, float gamma, int use_focal, int use_dice, float dice_beta,
                         float dice_smooth, int blocks, int round_bf16, void* stream) {
  return launch<float>(x, target, weights, sums, gloss, dx, npix, C, alpha, gamma, use_focal,
                       use_dice, dice_beta, dice_smooth, blocks, round_bf16, stream);
}

// The kernel for C classes of esz-byte logits: out = [dynamic shared memory
// bytes, CTAs per SM, registers per thread, ring slots, threads per CTA]
int seg_loss_dlogits_info(int esz, int C, int round_bf16, int* out) {
  if ((esz != 2 && esz != 4) || C < 1 || C > kMaxClasses) return (int)cudaErrorInvalidValue;
  const void* kernel = pick(esz, C, round_bf16 && esz == 4);
  const size_t smem = smem_bytes(C, esz);
  cudaError_t e = set_smem_carveout(kernel, smem);
  int per_sm = 0;
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)smem;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = ring_stages(C, esz);
  out[4] = kTile;
  return 0;
}

}  // extern "C"
