// tma.cuh — the Tensor Memory Accelerator (TMA) pieces of the `wgmma`
// kernels fed by one producer thread (ffn_tc.cu, ffn_tc32.cu): 2-D tensor
// maps encoded on the host, one-instruction tile copies into 128-byte-
// swizzled shared memory that complete a transaction on an mbarrier, and
// the full / empty barriers of a ring of stages.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums

#include "wgmma.cuh"

namespace {

// one box of the tensor `map` at (column c0, row r0) -> a swizzled atom at
// dst; its bytes complete the transaction of barrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int r0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(saddr(bar))
      : "memory");
}

// the producer's arrival on `bar`, which then waits for `bytes` of copies
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(saddr(bar)), "r"(bytes) : "memory");
}

// wait until at most one committed group of this warpgroup's products is
// in flight
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// the ring's barriers: `full` completes on the producer's arrival and its
// copies' bytes, `empty` on the arrival of every consumer thread
template <int RING, int CONSUMERS>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// a barrier among the first `threads` threads of the block (the consumer
// warpgroups), apart from __syncthreads' barrier 0
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

bool aligned16(const void* p) { return p && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime, or null
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found)
            != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the tensor map of a row-major (rows, cols) bf16 (or, with f32, float)
// matrix at x (row stride ld elements) in boxes of 64 rows x 128 bytes with
// the 128-byte swizzle, zero outside
bool tensor_map(CUtensorMap* map, const void* x, int rows, int cols, int ld, bool f32 = false) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const size_t elem = f32 ? sizeof(float) : sizeof(bf16);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), TC_TILE}, steps[2] = {1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(x), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

}  // namespace
