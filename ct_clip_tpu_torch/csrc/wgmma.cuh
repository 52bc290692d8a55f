// wgmma.cuh — the Hopper building blocks of the bf16 tensor-core kernels
// (attention_tc.cu, qknorm_attention_tc.cu): cp.async copies into shared
// memory, mbarrier rings, `wgmma` (sm_90a) on 128-byte-swizzled 64-row
// tiles with f32 accumulators, and the accumulator's register layout.
#pragma once

#include "common.cuh"

namespace {

constexpr int TC_TILE = 64;  // rows of a swizzled tile: a wgmma's M
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int round1024(int x) { return (x + 1023) / 1024 * 1024; }
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (cp16) or 4 (cp4) bytes from global to shared; bytes past `src_bytes` are zero
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(saddr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(saddr(bar)) : "memory");
}
// one arrival once every earlier cp.async of this thread has landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(saddr(bar))
               : "memory");
}
// Wait for the phase of `parity` to complete.  A ring that never completes
// (a fault in the counts) traps after ~2^35 cycles (~19 s) instead of
// holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start address,
// 1024 bytes between 8-row groups (LBO and SBO alike: K-major operands read
// SBO, an MN-major operand of 64 columns spans one swizzle atom across MN).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_D                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"
#define WG_OUT(d)                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),       \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),     \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])

// d = A B (+ d when `acc`): m64 n64 k16, A and B K-major in shared memory
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT(d) : "l"(da), "l"(db), "r"(acc));
}

// [d0 | d1] = A B (+ [d0 | d1] when `acc`): m64 n128 k16, A and B K-major in
// shared memory, B's 128 rows two swizzled 64-row atoms side by side; d0
// takes columns 0-63, d1 columns 64-127 (each in the n64 accumulator
// layout).  One product where two n64 ones would read A twice: 6 KB of
// shared memory per k16 slice in place of 8.
__device__ __forceinline__ void mma_ss128(float (&d0)[32], float (&d1)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT(d0), WG_OUT(d1) : "l"(da), "l"(db), "r"(acc));
}

// d += A B: m64 n64 k16, A from registers (the accumulator layout, bf16
// pairs), B MN-major in shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keep registers in place across the asynchronous products
__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// 2^x in one MUFU op (ex2.approx, rel. error ~2^-22; results below the f32
// normal range flush to 0, as a probability that small does nothing here)
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// accumulator element e of this thread: row 8 * ((e >> 1) & 1) past its
// first, column 8 * (e >> 2) + 2 * (lane % 4) + (e & 1)
__device__ __forceinline__ int acc_hi(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int acc_col(int e, int q4) { return 8 * (e >> 2) + 2 * q4 + (e & 1); }

// the accumulator as the A operand of the k16 slices 0..3 of its 64 columns
__device__ __forceinline__ void to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// max / sum over the four threads that share a row
__device__ __forceinline__ float max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// bias[i0 + r][j0 + c] of one (n, n) f32 head, r, c < 64, -> dst + (r * ld + c)
// floats; zero past n.  16-byte chunks when n % 4 == 0, else 4-byte copies.
__device__ __forceinline__ void load_bias(uint32_t dst, const float* bias, int n, int i0,
                                          int j0, int ld, int lane) {
  if ((n & 3) == 0) {
#pragma unroll 4
    for (int e = lane; e < TC_TILE * 16; e += 32) {
      const int r = e >> 4, c = (e & 15) * 4, i = i0 + r, j = j0 + c;
      const bool ok = i < n && j < n;
      cp16(dst + (r * ld + c) * 4, bias + (ok ? (size_t)i * n + j : 0), ok ? 16 : 0);
    }
  } else {
    for (int e = lane; e < TC_TILE * TC_TILE; e += 32) {
      const int r = e >> 6, c = e & 63, i = i0 + r, j = j0 + c;
      const bool ok = i < n && j < n;
      cp4(dst + (r * ld + c) * 4, bias + (ok ? (size_t)i * n + j : 0), ok ? 4 : 0);
    }
  }
}

// v[t0 + e], e < 64, -> dst (floats); zero past n
__device__ __forceinline__ void load_vec(uint32_t dst, const float* v, int t0, int n,
                                         int lane) {
#pragma unroll
  for (int e = lane; e < TC_TILE; e += 32) {
    const int t = t0 + e;
    cp4(dst + e * 4, v + (t < n ? t : 0), t < n ? 4 : 0);
  }
}

// P = exp(s + bias - lse) of one accumulator element, 0 outside the (n, n)
// square.  The difference is scaled, never the score: an f32-min pad bias
// times log2(e) would overflow to -inf.
__device__ __forceinline__ float prob(float s, float bias, float lse, bool ok) {
  return ok ? fexp2((s + bias - lse) * LOG2E) : 0.0f;
}

}  // namespace
