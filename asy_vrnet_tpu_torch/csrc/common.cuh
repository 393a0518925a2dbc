// Shared helpers for the ClusterBlock kernels (plain C interface, built by
// nvcc into one shared library per source and loaded with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

namespace asy {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to the working type and carry on in f32: the points where the JAX
// kernels cast an operand to the matrix-unit dtype.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// n / d and n % d (in r) for 0 <= n < 2^22 and d > 0, from rd = 1/d: the
// float quotient is off by at most one, and one step corrects it (a loop
// index split by a width known only at run time, without an integer
// division's instruction sequence)
__device__ __forceinline__ int div_small(int n, int d, float rd, int& r) {
  int q = __float2int_rz(__int2float_rn(n) * rd);
  r = n - q * d;
  if (r < 0) {
    --q;
    r += d;
  } else if (r >= d) {
    ++q;
    r -= d;
  }
  return q;
}

// ---- tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) ----
// Fragment layout (PTX m16n8k16): lane = 4*g + t.  A regs {0,1,2,3} hold
// (row g, k 2t..2t+1), (row g+8, same k), (row g, k+8), (row g+8, k+8); B
// regs {0,1} hold (k 2t..2t+1, n g) and (k+8, n g); C/D hold (row g, n
// 2t..2t+1) and (row g+8, same n).  In a packed pair the lower column (or k)
// is the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [0,16) x k [0,16) of a row-major bf16 tile at `p` (row
// stride `ld` elements, rows 16-byte aligned)
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const __nv_bfloat16* p, int ld) {
  const int l = threadIdx.x % 32, j = l >> 3;
  const unsigned s =
      (unsigned)__cvta_generic_to_shared(p + ((j & 1) * 8 + (l & 7)) * ld + (j >> 1) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// B fragment of k [0,16) x n [0,8) from a row-major [k][n] bf16 tile at `p`
// (row stride `ld` elements, rows 16-byte aligned)
__device__ __forceinline__ void ldmatrix_b(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* p,
                                           int ld) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p + (threadIdx.x % 16) * ld);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(s));
}

// A fragment of rows m [0,16) x k [0,16) from a [k][m] bf16 tile at `p`
// (k rows, m contiguous: the transpose of what ldmatrix_a reads)
__device__ __forceinline__ void ldmatrix_at(uint32_t (&a)[4], const __nv_bfloat16* p, int ld) {
  const int l = threadIdx.x % 32, j = l >> 3;
  const unsigned s =
      (unsigned)__cvta_generic_to_shared(p + ((j >> 1) * 8 + (l & 7)) * ld + (j & 1) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

// B fragment of k [0,16) x n [0,8) from an [n][k] bf16 tile at `p` (n rows,
// k contiguous: the transpose of what ldmatrix_b reads)
__device__ __forceinline__ void ldmatrix_bt(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* p,
                                            int ld) {
  const int l = threadIdx.x % 32;
  const unsigned s =
      (unsigned)__cvta_generic_to_shared(p + (l & 7) * ld + ((l >> 3) & 1) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(s));
}

// ---- asynchronous copies into shared memory (cp.async) ----
// One copy of kBytes (4, 8 or 16); with ok false the destination is zero
// filled and nothing is read.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = ok ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(kBytes), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// waits until at most kPending of this thread's groups are in flight
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copies `rows` rows of `cols` elements into shared memory: row r from
// src(r) (a pointer) to dst + r * ld; rows >= `valid` are zero filled.  All
// threads of the block take part, `vec` bytes a copy (16, 8 or 4: every row
// start, `cols` * sizeof(T) and ld * sizeof(T) must be multiples of it), or
// with vec 0 plain element copies.  The caller commits, waits and syncs.
template <typename T, typename SRC>
__device__ void stage_rows(T* dst, int ld, SRC src, int rows, int valid, int cols, int vec) {
  const int tid = threadIdx.x, nth = blockDim.x;
  if (vec == 0) {
    for (int e = tid; e < rows * cols; e += nth) {
      const int r = e / cols, c = e % cols;
      dst[r * ld + c] = r < valid ? src(r)[c] : from_f<T>(0.f);
    }
    return;
  }
  const int per = cols * (int)sizeof(T) / vec;  // copies per row
  for (int e = tid; e < rows * per; e += nth) {
    const int r = e / per, u = e % per;
    const bool ok = r < valid;
    const char* s = reinterpret_cast<const char*>(src(ok ? r : 0)) + u * vec;
    char* d = reinterpret_cast<char*>(dst + r * ld) + u * vec;
    if (vec == 16)
      cp_async<16>(d, s, ok);
    else if (vec == 8)
      cp_async<8>(d, s, ok);
    else
      cp_async<4>(d, s, ok);
  }
}

// The largest copy (16, 8 or 4 bytes) that divides every value, 0 if none
inline int copy_bytes(std::initializer_list<size_t> vals) {
  for (int v = 16; v >= 4; v /= 2) {
    bool ok = true;
    for (size_t x : vals) ok = ok && x % v == 0;
    if (ok) return v;
  }
  return 0;
}

// The current card's shared memory that a block may opt in to (*block) and
// that an SM holds (*sm), read once per device; 0 where they cannot be read
inline void smem_limits(size_t* block, size_t* sm) {
  constexpr int kDevices = 64;
  static std::atomic<size_t> cache[kDevices][2];
  int dev = 0;
  *block = *sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kDevices) return;
  if (cache[dev][0].load() == 0) {
    int b = 0, m = 0;
    if (cudaDeviceGetAttribute(&b, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&m, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
            cudaSuccess)
      return;
    cache[dev][1].store((size_t)m);
    cache[dev][0].store((size_t)b);
  }
  *block = cache[dev][0].load();
  *sm = cache[dev][1].load();
}

// Sets the dynamic shared memory limit of `kernel` to `bytes`; returns an
// error when the card cannot give a block that much.
template <typename K> inline cudaError_t set_smem(K kernel, size_t bytes) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (bytes > (size_t)optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace asy

// Message for a code returned by a launch function (one copy per library).
extern "C" const char* asy_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
