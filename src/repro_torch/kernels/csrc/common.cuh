// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes plain C launch functions (loaded with
// ctypes): they take raw device pointers, sizes and the caller's CUDA
// stream, launch, and return cudaGetLastError() so the Python wrapper can
// raise on a refused launch. Element types are selected at run time by a
// dtype code that matches kernels/ops.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element e of a 16-byte word of T, read as f32.
template <typename T>
__device__ __forceinline__ float word_elem(const uint4& w, int e) {
  return to_f32(reinterpret_cast<const T*>(&w)[e]);
}

// Masked logit value of the JAX reference (models/layers.py NEG_INF).
constexpr float kNegInf = -1073741824.0f;  // -2^30

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
