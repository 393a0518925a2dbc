// Shared by the two segmentation-loss kernels (seg_loss_sums.cu,
// seg_loss_dlogits.cu): a block stages a tile of kTile pixels x C logits in
// shared memory as f32 and each thread owns one pixel of it.
//
// Layout: the logits are NHWC, so a tile is one contiguous run of kTile * C
// elements.  It is copied with 16-byte loads where the run is aligned, every
// thread on the next 16 bytes (fully coalesced), and a thread then reads its
// own pixel's C values from shared memory at stride C (conflict-free for odd
// C such as 9).  Reading the pixel straight from device memory would make
// each warp load touch ~5 cache lines for 32 useful values.
#pragma once

#include "common.cuh"

namespace asy {

constexpr int kTile = 256;        // pixels per tile == threads per block
constexpr int kMaxClasses = 32;

// Copies `count` elements starting at `src` into dst[0..count) as f32.
template <typename T>
__device__ __forceinline__ void stage_in(const T* __restrict__ src, float* dst,
                                         int count, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  if (((uintptr_t)src % 16 == 0) && (count % kVec == 0)) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int i = tid; i < count / kVec; i += kTile) {
      const uint4 v = s4[i];
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[i * kVec + j] = to_f<T>(e[j]);
    }
  } else {
    for (int i = tid; i < count; i += kTile) dst[i] = to_f<T>(src[i]);
  }
}

// Writes src[0..count) (f32) to `dst`, rounded once to T.
template <typename T>
__device__ __forceinline__ void stage_out(const float* src, T* __restrict__ dst,
                                          int count, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  if (((uintptr_t)dst % 16 == 0) && (count % kVec == 0)) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < count / kVec; i += kTile) {
      uint4 v;
      T* e = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) e[j] = from_f<T>(src[i * kVec + j]);
      d4[i] = v;
    }
  } else {
    for (int i = tid; i < count; i += kTile) dst[i] = from_f<T>(src[i]);
  }
}

// Per-pixel head shared by both kernels.  On entry v[0..C) holds the pixel's
// logits; on exit it holds the softmax probabilities (exp(l - max) / sum, the
// TPU kernel's form).  Returns through the references the class weight of the
// pixel's target (0 when it matches no class) and nll = w_t * (lse - l_t).
__device__ __forceinline__ void pixel_softmax(float* v, int C, int tgt,
                                              const float* __restrict__ weights,
                                              float& w_t, float& nll) {
  float mx = v[0];
  for (int k = 1; k < C; ++k) mx = fmaxf(mx, v[k]);
  // parity: a target outside [0, C) (the ignore class is C) matches no class
  const bool has = tgt >= 0 && tgt < C;
  const float l_t = has ? v[tgt] : 0.0f;
  w_t = has ? weights[tgt] : 0.0f;
  float ssum = 0.0f;
  for (int k = 0; k < C; ++k) {
    const float e = expf(v[k] - mx);
    v[k] = e;
    ssum += e;
  }
  const float lse = mx + logf(ssum);
  for (int k = 0; k < C; ++k) v[k] = v[k] / ssum;
  nll = w_t * (lse - l_t);
}

// x^p for the focal terms: exact products for the usual gamma = 2.
__device__ __forceinline__ float focal_pow(float x, float p) {
  if (p == 2.0f) return x * x;
  if (p == 1.0f) return x;
  if (p == 0.0f) return 1.0f;
  return powf(x, p);
}

}  // namespace asy
