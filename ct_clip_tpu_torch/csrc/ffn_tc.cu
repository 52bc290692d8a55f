// ffn_tc.cu — the bf16 GEGLU feed-forward backward (K11) on the Hopper
// tensor cores: its tile and its three products, each a `wgmma` (sm_90a)
// kernel with bf16 operands and f32 accumulators, the operand tiles copied
// by the Tensor Memory Accelerator (TMA) into 128-byte-swizzled shared
// memory behind a ring of mbarriers, for two consumer warpgroups.
//
// Replaces, in bf16, the products of ct_clip_tpu/ops/pallas/ffn.py::
// _pallas_ff_bwd (K11, :238, pallas_call :255, body _bwd_kernel :136-180),
// which gemm.cu's ff_bwd_kernel and gemm_layout_kernel ran on WMMA with
// synchronous staging (they keep the f32 form and every other caller):
//   * the tile (ff_tc_tile): a = xn wa^T and g = xn wg^T recomputed from one
//     staged xn tile, dact = dout woT^T, then act = a gelu(g), da = dact
//     gelu(g) and dg = dact a (Phi(g) + g phi(g)) with the exact erf, each
//     rounded to bf16 where _bwd_kernel rounds them (:165, :173-174); da and
//     dg go side by side into one (rows, 2 inner) buffer [da | dg];
//   * dxn = [da | dg] [wa; wg] (ff_tc_gemm, "NN": A K-major, B MN-major),
//     f32 out;
//   * [dwa; dwg] = [da | dg]^T xn and dwo = dout^T act (ff_tc_gemm, "TN":
//     A and B MN-major, both read from row-major (rows, width) tensors), f32
//     partials per split of the rows, which ct_sum_splits (gemm.cu) adds in
//     order: no atomics, every output bit-identical from run to run.
//
// What bounds it on the H100.  At CT-CLIP's batch 8 (110,592 rows x 512,
// inner 1,365 padded to 1,368) the tile runs three products of 0.155 TFLOP
// and the two weight gradients and dxn 0.775 TFLOP more: 1.24 TFLOP, 1.25 ms
// at 989 TFLOP/s, against ~1.3 GB of operands and outputs (0.40 ms).  Each
// CTA re-reads its operand tiles from L2 (xn once per 64 inner columns, the
// weights once per 128 rows), several GB in all: the L2-to-SM rate, not the
// tensor cores, is what these tile shapes meet first.  A first version
// copied the tiles with cp.async from one producer warp (16-byte copies, the
// addresses in its registers): the tile ran at 11% of the bf16 peak and the
// products at 14% (kernel-only 4.28 and 5.73 ms; PERF.md), its one warp's
// issue rate the limit; a TMA copy is one instruction per 64 x 64 tile.
//
// Design:
//   * A CTA is a producer warp (one thread issues the TMA copies, each
//     stage's bytes expected on its `full` barrier) and two consumer
//     warpgroups of 64 rows each (wgmma's M), which keep one k block's
//     products in flight while they wait for the next; every product is
//     m64n64k16 on 64-row x 128-byte swizzled atoms (TMA's 128-byte swizzle
//     is the layout wgmma reads), a K-major operand advanced 32 bytes per
//     k16 slice, an MN-major one 16 rows (2048 bytes).  The tensor maps
//     are encoded on the host for each call (cuTensorMapEncodeTiled, found
//     through the runtime: the library links no driver library).
//   * The tile: 128 rows x 64 inner columns, k blocks of 64 over the model
//     width, three accumulators per warpgroup (a, g, dact); the GEGLU
//     derivative runs on the accumulators in registers and writes act, da
//     and dg as bf16 pairs.
//   * The products: 128 x 128 output tiles, two 64-column accumulators per
//     warpgroup, k blocks of 64; the TN form walks one split of the rows.
//   * Ragged edges (rows, the padded inner width, the last k block) are
//     zero-filled by the TMA copies and masked at the stores; a split is a
//     multiple of 64 rows, so no k block straddles two; widths and row
//     strides must be multiples of 8 elements (16 bytes), as TMA requires.
#include <cuda.h>  // CUtensorMap and its enums

#include "common.cuh"
#include "wgmma.cuh"

// 1 in a one-change copy for the card checks (kernels.copy_library): dg
// without the g phi(g) term of the GELU derivative, which the K11 checks
// must catch
#ifndef CT_FF_TC_NO_GPHI
#define CT_FF_TC_NO_GPHI 0
#endif

namespace {

constexpr int ATOM = TC_TILE * 128;  // one swizzled atom: 64 rows of 128 bytes
constexpr int CWG = 2;               // consumer warpgroups
constexpr int NT = 128 * CWG + 32;   // + the producer warp
constexpr int BM = 64 * CWG;         // rows of a CTA tile
constexpr int TILE_STAGES = 4;
constexpr int TILE_STAGE = 2 * CWG * ATOM + 3 * ATOM;  // xn, dout; wa, wg, woT
constexpr int GEMM_STAGES = 3;                         // two CTAs per SM
constexpr int GEMM_STAGE = 4 * ATOM;                   // A: 2 atoms, B: 2 atoms

__host__ __device__ constexpr int tile_smem() { return 1024 + TILE_STAGES * TILE_STAGE; }
__host__ __device__ constexpr int gemm_smem() { return 1024 + GEMM_STAGES * GEMM_STAGE; }

// d += A B: m64 n64 k16, A and B from shared memory; TA / TB 1: that operand
// MN-major
template <int TA, int TB>
__device__ __forceinline__ void mma_t(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_OUT(d) : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// one 64 x 64 box of the tensor `map` at (column c0, row r0) -> a swizzled
// atom at dst; its bytes complete the transaction of barrier `bar`
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

template <int RING>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 128 * CWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------------------- the tile
// One CTA per (128 rows, 64 inner columns): xn, dout (M, K) bf16, wa, wg,
// woT (N, K) bf16, through their tensor maps -> act (M, N), dcat (M, 2N)
// [da | dg].
struct TileMaps {
  CUtensorMap xn, dout, wa, wg, woT;
};
struct TileArgs {
  bf16 *act, *dcat;
  int M, N, K, ldact, lddc;
};

__global__ void __launch_bounds__(NT, 1) ff_tc_tile(const __grid_constant__ TileMaps maps,
                                                    TileArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[TILE_STAGES], empty[TILE_STAGES];
  uint8_t* ring = align1024(smem_raw);
  const int n0 = blockIdx.x * TC_TILE, m0 = blockIdx.y * BM;
  const int kblocks = (a.K + TC_TILE - 1) / TC_TILE;
  init_ring<TILE_STAGES>(full, empty);

  if (threadIdx.x >= 128 * CWG) {  // the producer: one thread
    if (threadIdx.x != 128 * CWG) return;
    for (int kb = 0; kb < kblocks; ++kb) {
      const int st = kb % TILE_STAGES, k0 = kb * TC_TILE;
      if (kb >= TILE_STAGES) bar_wait(&empty[st], (kb / TILE_STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * TILE_STAGE);
      bar_expect(&full[st], TILE_STAGE);
#pragma unroll
      for (int w = 0; w < CWG; ++w) {
        tma_load(dst + w * ATOM, &maps.xn, k0, m0 + 64 * w, &full[st]);
        tma_load(dst + (CWG + w) * ATOM, &maps.dout, k0, m0 + 64 * w, &full[st]);
      }
      tma_load(dst + 2 * CWG * ATOM, &maps.wa, k0, n0, &full[st]);
      tma_load(dst + (2 * CWG + 1) * ATOM, &maps.wg, k0, n0, &full[st]);
      tma_load(dst + (2 * CWG + 2) * ATOM, &maps.woT, k0, n0, &full[st]);
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  float ga[32], gg[32], gd[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) ga[e] = gg[e] = gd[e] = 0.0f;
  for (int kb = 0; kb < kblocks; ++kb) {
    const int st = kb % TILE_STAGES;
    const uint32_t base = saddr(ring + st * TILE_STAGE);
    const uint32_t xa = base + wg * ATOM, da = base + (CWG + wg) * ATOM;
    const uint32_t wa = base + 2 * CWG * ATOM, wgt = wa + ATOM, wo = wa + 2 * ATOM;
    bar_wait(&full[st], (kb / TILE_STAGES) & 1);
    hold(ga);
    hold(gg);
    hold(gd);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_t<0, 0>(ga, desc(xa + 32 * kk), desc(wa + 32 * kk));
      mma_t<0, 0>(gg, desc(xa + 32 * kk), desc(wgt + 32 * kk));
      mma_t<0, 0>(gd, desc(da + 32 * kk), desc(wo + 32 * kk));
    }
    wg_commit();
    wg_wait1();  // the previous k block's products are done: free its stage
    hold(ga);
    hold(gg);
    hold(gd);
    if (kb > 0) bar_arrive(&empty[(kb - 1) % TILE_STAGES]);
  }
  wg_wait();
  hold(ga);
  hold(gg);
  hold(gd);

  // the GEGLU derivative on the accumulators (ffn.py::_bwd_kernel :160-174)
  const int r = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int gm = r + 8 * acc_hi(e), gn = n0 + acc_col(e, q4);
    if (gm >= a.M || gn >= a.N) continue;  // N is even: gn + 1 < N with gn
    float act[2], dA[2], dG[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float x = ga[e + u], g = gg[e + u], dact = gd[e + u];
      const float phi = 0.5f * (1.0f + erff(g * 0.70710678118654752f));
      const float gelu = g * phi;
      const float pdf = expf(-0.5f * g * g) * 0.3989422804014327f;
      act[u] = x * gelu;
      dA[u] = dact * gelu;
      dG[u] = CT_FF_TC_NO_GPHI ? dact * x * phi : dact * x * (phi + g * pdf);
    }
    *reinterpret_cast<bf162*>(a.act + (size_t)gm * a.ldact + gn) =
        __floats2bfloat162_rn(act[0], act[1]);
    *reinterpret_cast<bf162*>(a.dcat + (size_t)gm * a.lddc + gn) =
        __floats2bfloat162_rn(dA[0], dA[1]);
    *reinterpret_cast<bf162*>(a.dcat + (size_t)gm * a.lddc + a.N + gn) =
        __floats2bfloat162_rn(dG[0], dG[1]);
  }
}

// ---------------------------------------------------------- the products
// C[m, n] = sum_k A(m, k) B(k, n), f32, one 128 x 128 tile of C per CTA over
// the k range of split blockIdx.z (kchunk rows each):
//   A(m, k) = A[m * lda + k] (TA 0: K-major, row-major (M, K)) or
//             A[k * lda + m] (TA 1: MN-major, a row-major (K, M) matrix);
//   B(k, n) = B[k * ldb + n] (MN-major, a row-major (K, N) matrix).
// "NN": dxn = [da | dg] [wa; wg] (TA 0); "TN": dW = dY^T X (TA 1), the
// split's sums to C + z * split_stride.
struct GemmMaps {
  CUtensorMap A, B;
};
struct GemmArgs {
  float* C;
  int M, N, K, ldc, kchunk;
  long long split_stride;
};

template <int TA>
__global__ void __launch_bounds__(NT, 2) ff_tc_gemm(const __grid_constant__ GemmMaps maps,
                                                    GemmArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[GEMM_STAGES], empty[GEMM_STAGES];
  uint8_t* ring = align1024(smem_raw);
  const int n0 = blockIdx.x * 128, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * a.kchunk, kend = min(a.K, kbeg + a.kchunk);
  const int kblocks = (kend - kbeg + TC_TILE - 1) / TC_TILE;
  init_ring<GEMM_STAGES>(full, empty);

  if (threadIdx.x >= 128 * CWG) {  // the producer: one thread
    if (threadIdx.x != 128 * CWG) return;
    for (int kb = 0; kb < kblocks; ++kb) {
      const int st = kb % GEMM_STAGES, k0 = kbeg + kb * TC_TILE;
      if (kb >= GEMM_STAGES) bar_wait(&empty[st], (kb / GEMM_STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * GEMM_STAGE);
      bar_expect(&full[st], GEMM_STAGE);
#pragma unroll
      for (int w = 0; w < CWG; ++w) {
        if (TA)  // k rows [k0, k0 + 64) x columns m0 + 64 w ..
          tma_load(dst + w * ATOM, &maps.A, m0 + 64 * w, k0, &full[st]);
        else     // rows m0 + 64 w .. x k columns [k0, k0 + 64)
          tma_load(dst + w * ATOM, &maps.A, k0, m0 + 64 * w, &full[st]);
        tma_load(dst + (CWG + w) * ATOM, &maps.B, n0 + 64 * w, k0, &full[st]);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  float c0[32], c1[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) c0[e] = c1[e] = 0.0f;
  for (int kb = 0; kb < kblocks; ++kb) {
    const int st = kb % GEMM_STAGES;
    const uint32_t base = saddr(ring + st * GEMM_STAGE);
    const uint32_t at = base + wg * ATOM, b0 = base + CWG * ATOM, b1 = b0 + ATOM;
    bar_wait(&full[st], (kb / GEMM_STAGES) & 1);
    hold(c0);
    hold(c1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dA = desc(at + (TA ? 2048 : 32) * kk);
      mma_t<TA, 1>(c0, dA, desc(b0 + 2048 * kk));
      mma_t<TA, 1>(c1, dA, desc(b1 + 2048 * kk));
    }
    wg_commit();
    wg_wait1();  // the previous k block's products are done: free its stage
    hold(c0);
    hold(c1);
    if (kb > 0) bar_arrive(&empty[(kb - 1) % GEMM_STAGES]);
  }
  wg_wait();
  hold(c0);
  hold(c1);

  float* C = a.C + blockIdx.z * a.split_stride;
  const int r = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int gm = r + 8 * acc_hi(e), gn = n0 + acc_col(e, q4);
    if (gm >= a.M) continue;  // N is even: gn + 1 < N with gn
    if (gn < a.N)
      *reinterpret_cast<float2*>(C + (size_t)gm * a.ldc + gn) = make_float2(c0[e], c0[e + 1]);
    if (gn + 64 < a.N)
      *reinterpret_cast<float2*>(C + (size_t)gm * a.ldc + gn + 64) = make_float2(c1[e], c1[e + 1]);
  }
}

template <typename K, typename M, typename A>
cudaError_t launch(K kernel, dim3 grid, int smem, cudaStream_t st, const M& maps, const A& args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, st>>>(maps, args);
  return cudaGetLastError();
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

// the tensor map of a row-major (rows, cols) bf16 matrix at x (row stride
// ld elements) in 64 x 64 boxes with the 128-byte swizzle, zero outside
bool tensor_map(CUtensorMap* map, const void* x, int rows, int cols, int ld) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {TC_TILE, TC_TILE}, steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides,
                box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

}  // namespace

// K11's tile: xn, dout (M, K) with row stride ldx; wa, wg, woT (N, K) with
// row stride ldw; act (M, N) (row stride ldact); dcat (M, 2N) [da | dg] (row
// stride lddc); all bf16.  K, N, the strides multiples of 8, every base
// 16-byte aligned.
CT_EXPORT int ct_ff_tc_tile(const void* xn, const void* dout, int ldx, const void* wa,
                            const void* wg, const void* woT, int ldw, int M, int N, int K,
                            void* act, int ldact, void* dcat, int lddc, void* stream) {
  const int dims[] = {K, N, ldx, ldw, ldact, lddc};
  bool ok = M > 0 && N > 0 && K > 0;
  for (int x : dims) ok = ok && x % 8 == 0;
  const void* ptrs[] = {xn, dout, wa, wg, woT, act, dcat};
  for (const void* p : ptrs) ok = ok && aligned16(p);
  if (!ok || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  TileMaps maps;
  if (!tensor_map(&maps.xn, xn, M, K, ldx) || !tensor_map(&maps.dout, dout, M, K, ldx)
      || !tensor_map(&maps.wa, wa, N, K, ldw) || !tensor_map(&maps.wg, wg, N, K, ldw)
      || !tensor_map(&maps.woT, woT, N, K, ldw))
    return (int)cudaErrorInvalidValue;
  const TileArgs a = {static_cast<bf16*>(act), static_cast<bf16*>(dcat), M, N, K, ldact, lddc};
  return (int)launch(ff_tc_tile, dim3((N + TC_TILE - 1) / TC_TILE, (M + BM - 1) / BM),
                     tile_smem(), static_cast<cudaStream_t>(stream), maps, a);
}

// layout 0 ("NN"): C (M, N) = A (M, K) B (K, N), one split; layout 1
// ("TN"): C = A^T B for A (K, M) and B (K, N), ceil(K / kchunk) splits of
// split_stride floats each (kchunk a multiple of 64).  A, B bf16, row
// strides lda, ldb; C f32, row stride ldc.  The widths and strides of A and
// B multiples of 8 (ldc of 2), every base 16-byte aligned.
CT_EXPORT int ct_ff_tc_gemm(int layout, const void* A, int lda, const void* B, int ldb, int M,
                            int N, int K, int kchunk, void* C, int ldc, long long split_stride,
                            void* stream) {
  const int dims[] = {N, lda, ldb};
  bool ok = M > 0 && N > 0 && K > 0 && ldc % 2 == 0 && (layout == 0 || layout == 1)
            && kchunk > 0 && kchunk % TC_TILE == 0 && (layout == 1 || kchunk >= K)
            && (layout == 0 || M % 8 == 0) && (layout == 1 || K % 8 == 0);
  for (int x : dims) ok = ok && x % 8 == 0;
  const void* ptrs[] = {A, B, C};
  for (const void* p : ptrs) ok = ok && aligned16(p);
  const int splits = ok ? (K + kchunk - 1) / kchunk : 0;
  if (!ok || (M + BM - 1) / BM > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  GemmMaps maps;
  if (!(layout ? tensor_map(&maps.A, A, K, M, lda) : tensor_map(&maps.A, A, M, K, lda))
      || !tensor_map(&maps.B, B, K, N, ldb))
    return (int)cudaErrorInvalidValue;
  const GemmArgs a = {static_cast<float*>(C), M, N, K, ldc, kchunk, split_stride};
  const dim3 grid((N + 127) / 128, (M + BM - 1) / BM, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(layout ? launch(ff_tc_gemm<1>, grid, gemm_smem(), st, maps, a)
                      : launch(ff_tc_gemm<0>, grid, gemm_smem(), st, maps, a));
}
