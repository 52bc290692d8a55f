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

// Element-type forms: a kernel templated on its element type T (bf16 or
// float) reads with to_f and writes with from_f<T>; round_as<T> is the
// rounding a T tensor between two stages introduces (none for float).  The
// bf16 instantiations compile to the bf2f / f2bf / round_bf16 code above.
__device__ __forceinline__ float to_f(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return f2bf(v); }
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ float round_as(float v) {
  return to_f(from_f<T>(v));
}

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
// attention_train.cu's forward and backward, attention_tc.cu's forward and
// backward and attention_tc32.cu's backward draw from this one definition,
// so they regenerate the same mask, which never exists in device memory;
// ops/attention.py::dropout_mask computes the same bits in plain PyTorch.
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

// Keep bits of one thread's 32 accumulator elements of the (query i, i + 8)
// x (keys j0..j0 + 63) tile, bit e set iff element e is kept, where element
// e = 4 c + 2 hi + {0, 1} is row i + 8 hi, key j0 + 8 c + 2 q4 + {0, 1} (q4 =
// lane % 4): the layout of a wgmma accumulator row block (attention_tc.cu)
// and of eight mma.sync m16n8 accumulators (attention_tc32.cu, c = the n8
// block).  Lanes q4 and q4 ^ 1 hold keys 8c + {0..3} (q4 = 0, 1) or 8c +
// {4..7} (q4 = 2, 3), one j / 4 group, in both rows: the even lane draws the
// group for the first row, the odd lane for the second, and each trades the
// half the other holds.  Every lane of the warp takes part (the shuffles).
__device__ __forceinline__ uint32_t row_keep_bits(int b, int h, int i, int j0, int q4,
                                                  uint32_t k0, uint32_t k1, uint32_t thresh) {
  const int odd = q4 & 1;
  uint32_t bits = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const U4 w = philox(b, h, i + 8 * odd, (j0 >> 2) + 2 * c + (q4 >> 1), k0, k1);
    // this lane's keys are words 0, 1 (even) or 2, 3 (odd) of the group
    const uint32_t own = (uint32_t)((odd ? w.w[2] : w.w[0]) >= thresh)
                       | (uint32_t)((odd ? w.w[3] : w.w[1]) >= thresh) << 1;
    const uint32_t sent0 = __shfl_xor_sync(0xffffffffu, odd ? w.w[0] : w.w[2], 1);
    const uint32_t sent1 = __shfl_xor_sync(0xffffffffu, odd ? w.w[1] : w.w[3], 1);
    const uint32_t other = (uint32_t)(sent0 >= thresh) | (uint32_t)(sent1 >= thresh) << 1;
    // element 4 c + 2 hi + {0, 1}: hi 0 the first row, hi 1 the second
    bits |= (odd ? (other | own << 2) : (own | other << 2)) << (4 * c);
  }
  return bits;
}

// x M of accumulator element e (dA = dP M, or the forward's P M): M is
// keep_scale where bit e of `kept` is set, else 0; without DROP, x
template <bool DROP>
__device__ __forceinline__ float masked(float dp, uint32_t kept, int e, float keep_scale) {
  if (!DROP) return dp;
  return dp * ((kept >> e) & 1 ? keep_scale : 0.0f);
}

#define CT_EXPORT extern "C" __attribute__((visibility("default")))
