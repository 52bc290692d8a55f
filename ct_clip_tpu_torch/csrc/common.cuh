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

// ------------------------------------------------------------ K13's mask
// The TPU draws dropout bits from its hardware generator seeded by (seed,
// head, row).  Here the bits are Philox4x32-10 keyed on the 64-bit seed
// (read from device memory, so drawing a seed needs no host sync), with the
// counter (batch row, head, query i, key j / 4): word j % 4 of that call is
// element (i, j)'s.  A probability is kept iff bits >= thresh and then
// scaled by 1 / (1 - rate) (ct_clip_tpu/ops/pallas/attention.py:403-408).
// attention_train.cu's forward and backward and attention_tc.cu's backward
// draw from this one definition, so they regenerate the same mask, which
// never exists in device memory; ops/attention.py::dropout_mask computes the
// same bits in plain PyTorch.
struct U4 { uint32_t w[4]; };

// Philox4x32-10 (Salmon et al., SC'11), the Random123 round and key schedule.
__device__ __forceinline__ U4 philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                     uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return {{c0, c1, c2, c3}};
}

// The Philox key of the (1,) int64 seed in device memory; (0, 0) without
// dropout (thresh 0), where the seed may be null.
__device__ __forceinline__ void seed_key(const long long* seed, uint32_t thresh, uint32_t& k0,
                                         uint32_t& k1) {
  const unsigned long long s = thresh ? (unsigned long long)seed[0] : 0ull;
  k0 = (uint32_t)s;
  k1 = (uint32_t)(s >> 32);
}

// the mask's value for one word of bits: keep_scale if kept, else 0
__device__ __forceinline__ float keep(uint32_t bits, uint32_t thresh, float keep_scale) {
  return bits >= thresh ? keep_scale : 0.0f;
}

#define CT_EXPORT extern "C" __attribute__((visibility("default")))
