// Shared helpers for the ClusterBlock kernels (plain C interface, built by
// nvcc into one shared library per source and loaded with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
