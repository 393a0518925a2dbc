// Shared by the two segmentation-loss kernels (seg_loss_sums.cu,
// seg_loss_dlogits.cu).
//
// Layout: the logits are NHWC, so a tile of `tile` pixels (one a thread of
// the CTA) is one contiguous run of tile * C elements, and its targets one
// run of tile int32.  Each CTA of a persistent grid streams its tiles
// through a ring of `stages` slots in shared memory: one thread asks for a
// whole tile with two 1-D bulk copies (cp.async.bulk, no tensor map) that
// complete on the slot's mbarrier, so the copies of the next tiles are in
// flight while the CTA computes; the mbarrier's phase tells a thread that
// the copy it waits for has landed.  Each thread then owns one pixel: it
// reads the pixel's C values from the slot into registers (C is a template
// parameter, so the per-pixel arrays and the per-class sums stay in
// registers), and once every thread of the CTA holds its pixel the slot is
// asked for again (K4b: one __syncthreads a tile; K4: a producer warp waits
// for the slot's empty mbarrier).
//
// A tile that is not whole (the last one), or a launch whose pointers are
// not 16-byte aligned (what the bulk copies need), reads each pixel straight
// from device memory instead: the scalar path.
//
// Generic C: kC = 0 instantiates arrays of kMaxClasses values and runs any
// 1 <= C <= 32 with guarded unrolled loops (slower: 140-240 registers a
// thread); the model's C = 9 has its own instantiation.
#pragma once

#include "common.cuh"

namespace asy {
namespace seg {

constexpr int kTile = 256;        // pixels a tile == threads a CTA (K4 at C = 9: 768)
constexpr int kMaxClasses = 32;
constexpr int kMinStages = 2, kMaxStages = 4;
constexpr int kRingBytes = 64 << 10;   // the ring's shared memory, at most

// Sums vector layout: 4 scalars, then 5 per-class vectors of length C
enum { kCeNum = 0, kCeDen = 1, kFocal = 2, kNpix = 3, kNScal = 4 };

// Bytes of one ring slot: the tile's logits, then its targets
__host__ __device__ inline int slot_bytes(int C, int esz, int tile = kTile) {
  return tile * C * esz + tile * 4;
}

// Ring depth: as many slots as fit in `budget` bytes, between 2 and 4
__host__ __device__ inline int ring_stages(int C, int esz, int tile = kTile,
                                           int budget = kRingBytes) {
  const int s = budget / slot_bytes(C, esz, tile);
  return s < kMinStages ? kMinStages : (s > kMaxStages ? kMaxStages : s);
}

// ---- mbarriers and 1-D bulk copies (sm_90) ----
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// makes the initialised mbarriers visible to the bulk copies
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// one arrival, no bytes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// device -> shared, completing `bytes` on `bar` (bytes a multiple of 16, both
// addresses 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// shared -> device, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until none of this thread's bulk groups still reads shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// waits until all of this thread's bulk groups have completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before later bulk copies read them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Tiles of a launch.  With `bulk`, the full tiles go through the ring, CTA
// b taking tiles b, b + gridDim.x, ...; the rest (the partial last tile, or
// every tile without `bulk`) take the scalar path, dealt from the CTA that
// follows the last ring tile's, so that the partial tile lands on a CTA with
// one ring tile fewer than the most.
struct Tiles {
  int ntiles, first_scalar;
  __device__ Tiles(int npix, bool bulk, int tile)
      : ntiles((npix + tile - 1) / tile), first_scalar(bulk ? npix / tile : 0) {}
  // this CTA's j-th ring tile, or -1 past its last
  __device__ int ring(int j) const {
    const int t = (int)blockIdx.x + j * (int)gridDim.x;
    return t < first_scalar ? t : -1;
  }
  // this CTA's first scalar tile (then every gridDim.x-th)
  __device__ int scalar_start() const {
    const int g = (int)gridDim.x;
    return first_scalar + ((int)blockIdx.x + g - first_scalar % g) % g;
  }
};

// One logit as f32 (rounded to bf16 first with kRound: the model's f32
// output holds upcast bf16 values).
template <typename T, bool kRound>
__device__ __forceinline__ float load_logit(const T* src) {
  const float f = to_f<T>(*src);
  return kRound ? rnd<__nv_bfloat16>(f) : f;
}

// Loads the C logits of a pixel from `src` into v.
template <typename T, bool kRound, int kN>
__device__ __forceinline__ void load_pixel(float (&v)[kN], const T* src, int C) {
#pragma unroll
  for (int k = 0; k < kN; ++k)
    if (k < C) v[k] = load_logit<T, kRound>(src + k);
}

// x^p for the focal terms: exact products for the usual gamma = 2.
__device__ __forceinline__ float focal_pow(float x, float p) {
  if (p == 2.0f) return x * x;
  if (p == 1.0f) return x;
  if (p == 0.0f) return 1.0f;
  return powf(x, p);
}

// Sets the kernel's dynamic shared memory and asks for the largest shared
// memory carve-out, once per kernel, device and size (setting them before
// every launch lengthened every launch on the card): the persistent grid
// counts on every SM holding as many CTAs as the occupancy calculator says,
// which a smaller carve-out chosen by the CUDA runtime on some SMs breaks (a
// second wave of CTAs).
inline cudaError_t set_smem_carveout(const void* kernel, size_t bytes) {
  constexpr int kSlots = 64;
  static const void* done[kSlots];
  static int done_dev[kSlots], ndone = 0;
  static size_t done_bytes[kSlots];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int i = 0;
  while (i < ndone && !(done[i] == kernel && done_dev[i] == dev)) ++i;
  if (i < ndone && done_bytes[i] == bytes) return cudaSuccess;
  e = set_smem(kernel, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && i < kSlots) {
    done[i] = kernel;
    done_dev[i] = dev;
    done_bytes[i] = bytes;
    if (i == ndone) ++ndone;
  }
  return e;
}

// The loss and f-score hyper-parameters, as the Python wrapper passes them
struct Hyper {
  float alpha, gamma, threshold;
  int use_focal, use_dice;
  float dice_beta, dice_smooth, fs_beta, fs_smooth;
};

// Class weights (1 where `weights` is null) into shared memory
__device__ __forceinline__ void load_weights(float* w_sm, const float* weights, int C) {
  for (int k = threadIdx.x; k < C; k += blockDim.x) w_sm[k] = weights ? weights[k] : 1.0f;
}

}  // namespace seg
}  // namespace asy
