// Shared helpers for the hand-written Hopper kernels of ct_clip_tpu_torch.
//
// Every entry point is a plain C function taking raw device pointers and a
// cudaStream_t, launching on that stream and returning cudaGetLastError(),
// so the Python side (ops/kernels/__init__.py) binds it with ctypes and
// raises on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
// Round a float through bf16 and back: the rounding point a bf16 tensor
// between two stages of the reference computation introduces.
__device__ __forceinline__ float round_bf16(float v) { return bf2f(f2bf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

#define CT_EXPORT extern "C" __attribute__((visibility("default")))
