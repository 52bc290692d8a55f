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
// The products also run the bf16 volume-embed backward, ct_clip_tpu/ops/
// pallas/patchify.py::_pallas_patch_embed_bwd (K16a, :375, pallas_call :399,
// body _embed_bwd_kernel :269-327), in two more epilogue forms of ff_tc_gemm:
// yb = xn W^T + b recomputed ("NT", B K-major, the bias added and rounded as
// the TPU kernel rounds it), and dxn = dyb W whose f32 tile is multiplied by
// xhat = (x - mean) rstd, rebuilt from the volume through the patch gather,
// and reduced to the LN(4000) scale and bias gradients' per-tile column sums
// in the epilogue: dxn, 1.77 GB of f32 at the training batch of 110,592
// rows, never reaches device memory, and no LN(4000) backward pass re-reads
// it.  dW = dyb^T xn is the "TN" form as it stands.  K16a's three products
// are 1.36 TFLOP there (1.37 ms at 989 TFLOP/s) against ~2 GB of volume,
// xn and yb moved (0.6 ms): the tensor cores bound it.
//
// And the bf16 GEGLU feed-forward forward after its LN, ct_clip_tpu/ops/
// pallas/ffn.py::_pallas_ff (K3, :105, pallas_call :114, body _kernel
// :89-103), which gemm.cu's EPI_GEGLU and EPI_RESIDUAL ran on WMMA with
// synchronous staging (they stay, for the shapes TMA cannot take), in two
// more epilogue forms, both "NT" (A and B K-major):
//   * GEMM_GEGLU: a = xn wa^T and g = xn wg^T for one 128-row x 64-column
//     tile, the weights [wa; wg] side by side in one (2 N, K) matrix, then
//     act = bf16(a gelu(g)) with the exact erf, rounded where gemm.cu's
//     EPI_GEGLU and the TPU kernel (:97) round it;
//   * GEMM_RESIDUAL: out = bf16(f32(act wo^T) + x), one rounding (:98-102),
//     x read in the epilogue.  Its K, the padded inner width 1,368, is no
//     multiple of 64: the last k block's columns past it are zero-filled by
//     the TMA copy, as are the padded columns' zero weights.
// At zero-shot's 27,648 rows the two are 116 GFLOP, 0.117 ms at 989
// TFLOP/s, against ~60 MB of xn, act, x and out (0.02 ms): the tensor
// cores bound it.
//
// And the bf16 projections of the CTViT QK-norm attention sublayer
// (ct_clip_tpu/ops/pallas/spatial_attention.py::_pallas_spatial, K1, :98-101
// and small_attention.py::_pallas_small_qknorm, K2, :98-101, :145-148; also
// the recompute at the top of their backwards, K9 and K10), which gemm.cu's
// EPI_STORE and EPI_RESIDUAL ran on WMMA (they stay, for the widths TMA
// cannot take): q = bf16(LN(x) wq^T) and kv = bf16(x wkv^T) in one more "NT"
// form, GEMM_NT_STORE, and out = bf16(merged wout^T + x) on GEMM_RESIDUAL as
// it stands (K = heads x 32).  At zero-shot's 27,648 rows the three are 29
// GFLOP (0.029 ms at 989 TFLOP/s) against ~170 MB of operands and outputs
// (0.051 ms at 3.35 TB/s): bytes bound them.
//
// And the products of the sublayer's bf16 backwards, small_attention.py::
// _bwd_kernel (K10, :249-403) and spatial_attention.py::_bwd_kernel (K9),
// which gemm.cu's gemm_layout_kernel ran (it stays for the widths TMA cannot
// take): dxn = dq wq and dx_kv = dkv wkv on "NN", the weight gradients on
// "TN", and two more forms: GEMM_NT_F32, K10's q = LN(x) wq^T and kv = x
// wkv^T kept f32 as the TPU kernel keeps them (:278-279), and
// GEMM_STORE_BF16, K9's dmerged = dO wout rounded to bf16 once.
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
//     K3's two forms issue one m64n128k16 over both B atoms (which lie side
//     by side in the stage) where the others issue two m64n64k16 sharing A:
//     two n64 products read A twice, 8 KB of shared memory per k16 slice and
//     warpgroup, which at the tensor cores' rate is all the SM's shared
//     memory bandwidth (~128 bytes a clock); one n128 reads 6 KB.
//   * Ragged edges (rows, the padded inner width, the last k block) are
//     zero-filled by the TMA copies and masked at the stores; a split is a
//     multiple of 64 rows, so no k block straddles two; widths and row
//     strides must be multiples of 8 elements (16 bytes), as TMA requires.
#include "common.cuh"
#include "tma.cuh"

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

// GEMM_LN_SUMS (below): a ring of two stages and the CTA's volume tile, 128
// rows of 128 bf16 padded to 272 bytes (the epilogue's reads of 8 rows x 4
// column pairs fall in 32 distinct banks), and its barrier
constexpr int LN_STAGES = 2;
constexpr int XS_LD = 272;
__host__ __device__ constexpr int tile_smem() { return 1024 + TILE_STAGES * TILE_STAGE; }
__host__ __device__ constexpr int gemm_smem() { return 1024 + GEMM_STAGES * GEMM_STAGE; }
__host__ __device__ constexpr int ln_sums_smem() {
  return 1024 + LN_STAGES * GEMM_STAGE + BM * XS_LD + 16;
}

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
  init_ring<TILE_STAGES, 128 * CWG>(full, empty);

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
//   B(k, n) = B[k * ldb + n] (MN-major, a row-major (K, N) matrix) or, in
//             the GEMM_BIAS form, B[n * ldb + k] (K-major, a row-major (N,
//             K) matrix).
// "NN": dxn = [da | dg] [wa; wg] (TA 0); "TN": dW = dY^T X (TA 1), the
// split's sums to C + z * split_stride.  The epilogue forms (compile-time):
//   GEMM_STORE     C f32, as above;
//   GEMM_BIAS      "NT", C bf16 = bf16(bf16(acc) + bias[n]): K16a's
//                  recompute of yb = xn W^T + b, rounded as gemm.cu's
//                  EPI_BIAS_ROUNDED rounds it (patchify.py:284-285);
//   GEMM_GEGLU     "NT", K3's act = bf16(a gelu(g)) (bf16 C, 64 columns a
//                  CTA: a from B rows n0.., g from B rows inner + n0..);
//   GEMM_RESIDUAL  "NT", K3's out = bf16(acc + x) (bf16 C, x bf16), and the
//                  QK-norm sublayer's output product;
//   GEMM_NT_STORE  "NT", C bf16 = bf16(acc): the sublayer's q and kv
//                  projections, rounded once as gemm.cu's EPI_STORE;
//   GEMM_NT_F32    "NT", C f32 = acc: K10 bf16's recompute of q and kv,
//                  which small_attention.py::_bwd_kernel keeps f32 (:278-279);
//   GEMM_STORE_BF16 "NN", C bf16 = bf16(acc): K9 bf16's dmerged = dO wout,
//                  rounded once as gemm.cu's gemm_layout_kernel rounds it;
//   GEMM_LN_SUMS   "NN", dxn = dyb W reduced in the epilogue, never stored:
//                  each accumulator times xhat = (x - mean) rstd of its patch
//                  row element, x gathered from the volume into shared
//                  memory by the producer warp's idle lanes while the
//                  products run, mean and rstd from the recompute's (M, 2)
//                  stats;
//                  the tile's column sums of dxn xhat and of dxn go to row
//                  blockIdx.y of the (tiles, 2 N) partials (ds1 | db1,
//                  patchify.py:307-308), which the caller adds in order.
enum GemmForm {
  GEMM_STORE = 0, GEMM_BIAS = 1, GEMM_LN_SUMS = 2, GEMM_GEGLU = 3, GEMM_RESIDUAL = 4,
  GEMM_NT_STORE = 5, GEMM_NT_F32 = 6, GEMM_STORE_BF16 = 7
};

struct GemmMaps {
  CUtensorMap A, B;
};
struct GemmArgs {
  float* C;
  int M, N, K, ldc, kchunk;
  long long split_stride;
  // GEMM_BIAS: the bias (N,); GEMM_LN_SUMS: the volume, its patch
  // geometry and the recompute's stats
  const bf16* bias;
  const bf16* video;
  const float* stats;
  PatchGeom g;
  // GEMM_RESIDUAL: x (M, N) bf16, row stride ldr; GEMM_GEGLU: the row of
  // wg in B
  const bf16* resid;
  int ldr, inner;
};

// 1 in a one-change copy for the card checks (kernels.copy_library): the
// K16a epilogue's xhat without rstd, which the K16a checks must catch
#ifndef CT_FF_TC_LN_NO_RSTD
#define CT_FF_TC_LN_NO_RSTD 0
#endif

// 8 bytes from global to shared memory; zero past `src_bytes`
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// GEMM_LN_SUMS's producer warp.  Lane 0 issues the TMA copies of every k
// block (A: dyb rows m0.., K-major; B: W rows k0.., MN-major); meanwhile
// lanes 1-31 gather the CTA's volume tile, x of patch rows m0 .. m0 + 127 at
// columns n0 .. n0 + 127, into xs: lane L the 4 columns n0 + 4 L .. of
// every row (one 8-byte copy each: p % 4 == 0 and W % 4 == 0, so 4 columns
// from a multiple of 4 lie side by side in one p-wide row of the patch),
// columns n0 .. n0 + 3 every 31st row from row L - 1; zero outside (M, N).
// Each of the 31 arrives on `xfull` once its copies have landed.
template <int STAGES>
__device__ __forceinline__ void ln_producer(const GemmMaps& maps, const GemmArgs& a,
                                            uint8_t* ring, uint8_t* xs, uint64_t* full,
                                            uint64_t* empty, uint64_t* xfull, int m0, int n0,
                                            int kblocks) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    for (int kb = 0; kb < kblocks; ++kb) {
      const int st = kb % STAGES, k0 = kb * TC_TILE;
      if (kb >= STAGES) bar_wait(&empty[st], (kb / STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * GEMM_STAGE);
      bar_expect(&full[st], GEMM_STAGE);
#pragma unroll
      for (int w = 0; w < CWG; ++w) {
        tma_load(dst + w * ATOM, &maps.A, k0, m0 + 64 * w, &full[st]);
        tma_load(dst + (CWG + w) * ATOM, &maps.B, n0 + 64 * w, k0, &full[st]);
      }
    }
    return;
  }
  const PatchGeom& g = a.g;
  const uint32_t xs0 = saddr(xs);
  // columns n0 + 4 lane ..: row m0's patch indices, then one row at a time
  // without divisions
  const int col = n0 + 4 * lane;
  const bool col_ok = col < a.N;
  const size_t off = col_ok ? patch_elem_offset(g, col) : 0;
  size_t r = m0;
  int wi = (int)(r % g.w);
  r /= g.w;
  int hi = (int)(r % g.h);
  r /= g.h;
  int ti = (int)(r % g.t);
  size_t bb = r / g.t;
  for (int i = 0; i < BM; ++i) {
    const bool ok = col_ok && m0 + i < a.M;
    const size_t src = ((bb * g.F + (size_t)ti * g.pt) * g.H + (size_t)hi * g.p) * g.W
                       + (size_t)wi * g.p + off;
    cp8(xs0 + i * XS_LD + 8 * lane, a.video + (ok ? src : 0), ok ? 8 : 0);
    if (++wi == g.w) {
      wi = 0;
      if (++hi == g.h) {
        hi = 0;
        if (++ti == g.t) {
          ti = 0;
          ++bb;
        }
      }
    }
  }
  // columns n0 .. n0 + 3, lane 0's share
  for (int i = lane - 1; i < BM; i += 31) {
    const bool ok = n0 < a.N && m0 + i < a.M;
    cp8(xs0 + i * XS_LD, a.video + (ok ? patch_row_base(g, m0 + i) + patch_elem_offset(g, n0) : 0),
        ok ? 8 : 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  bar_arrive(xfull);
}

// GEMM_LN_SUMS's epilogue: this CTA's column sums of c xhat and of c over
// its 128 rows into row blockIdx.y of the (tiles, 2 N) partials at a.C, x
// read from the volume tile xs (`xfull`), in a fixed order: each thread's
// two rows, the warp's eight row groups by shuffles, then the eight warps in
// turn through the ring, which every product has finished reading.  A
// thread's accumulator elements 4 q .. 4 q + 3 of each half are columns 8 q
// + 2 (lane % 4) + {0, 1} of rows r and r + 8.  Rows and columns outside
// read c = 0 (zero-filled operands) and x = 0.
__device__ __forceinline__ void ln_sums(const GemmArgs& a, const float (&c0)[32],
                                        const float (&c1)[32], int m0, int n0, int wg,
                                        int warp, int lane, uint8_t* ring, const uint8_t* xs,
                                        uint64_t* xfull) {
  const int q4 = lane & 3, rl = 64 * wg + 16 * warp + (lane >> 2);
  float mean[2], rstd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + rl + 8 * h;
    const float2 st = gm < a.M ? *reinterpret_cast<const float2*>(a.stats + 2 * (size_t)gm)
                               : make_float2(0.0f, 0.0f);
    mean[h] = st.x;
    rstd[h] = CT_FF_TC_LN_NO_RSTD ? 1.0f : st.y;
  }
  float* red = reinterpret_cast<float*>(ring);  // [warp][dxn xhat | dxn][128 columns]
  consumers_sync(128 * CWG);  // every warpgroup's products are done with the ring
  bar_wait(xfull, 0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float(&c)[32] = half ? c1 : c0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = 64 * half + 8 * q + 2 * q4;
      float s0 = 0.0f, s1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * q + 2 * h;
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const bf162*>(xs + (rl + 8 * h) * XS_LD + 2 * col));
        s0 += c[e] * ((x.x - mean[h]) * rstd[h]);
        s1 += c[e + 1] * ((x.y - mean[h]) * rstd[h]);
        d0 += c[e];
        d1 += c[e + 1];
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        d0 += __shfl_xor_sync(0xffffffffu, d0, o);
        d1 += __shfl_xor_sync(0xffffffffu, d1, o);
      }
      if (lane < 4) {
        float* w = red + (4 * wg + warp) * 256 + col;
        *reinterpret_cast<float2*>(w) = make_float2(s0, s1);
        *reinterpret_cast<float2*>(w + 128) = make_float2(d0, d1);
      }
    }
  }
  consumers_sync(128 * CWG);
  const int u = threadIdx.x >> 7, col = threadIdx.x & 127;  // 256 consumers: 2 x 128
  if (n0 + col < a.N) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < 4 * CWG; ++w) v += red[w * 256 + 128 * u + col];
    a.C[(size_t)blockIdx.y * 2 * a.N + (size_t)u * a.N + n0 + col] = v;
  }
}

template <int TA, int FORM = GEMM_STORE>
__global__ void __launch_bounds__(NT, 2) ff_tc_gemm(const __grid_constant__ GemmMaps maps,
                                                    GemmArgs a) {
  // B K-major in the NT forms
  constexpr int TB = FORM == GEMM_BIAS || FORM == GEMM_GEGLU || FORM == GEMM_RESIDUAL
                     || FORM == GEMM_NT_STORE || FORM == GEMM_NT_F32 ? 0 : 1;
  constexpr int STAGES = FORM == GEMM_LN_SUMS ? LN_STAGES : GEMM_STAGES;
  constexpr int BN = FORM == GEMM_GEGLU ? 64 : 128;  // C columns of a CTA
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[GEMM_STAGES], empty[GEMM_STAGES];
  uint8_t* ring = align1024(smem_raw);
  // GEMM_LN_SUMS: the volume tile and its barrier, past the ring
  uint8_t* xs = ring + LN_STAGES * GEMM_STAGE;
  uint64_t* xfull = reinterpret_cast<uint64_t*>(xs + BM * XS_LD);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * a.kchunk, kend = min(a.K, kbeg + a.kchunk);
  const int kblocks = (kend - kbeg + TC_TILE - 1) / TC_TILE;
  if (FORM == GEMM_LN_SUMS && threadIdx.x == 0) bar_init(xfull, 31);
  init_ring<GEMM_STAGES, 128 * CWG>(full, empty);

  if (threadIdx.x >= 128 * CWG) {  // the producer: one thread
    if (FORM == GEMM_LN_SUMS) {
      ln_producer<STAGES>(maps, a, ring, xs, full, empty, xfull, m0, n0, kblocks);
      return;
    }
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
        if (TB)
          tma_load(dst + (CWG + w) * ATOM, &maps.B, n0 + 64 * w, k0, &full[st]);
        else  // rows n0 + 64 w .. of B (N, K) x k columns [k0, k0 + 64); GEGLU:
              // the wa rows n0 .., then the wg rows inner + n0 ..
          tma_load(dst + (CWG + w) * ATOM, &maps.B, k0,
                   FORM == GEMM_GEGLU ? n0 + w * a.inner : n0 + 64 * w, &full[st]);
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
    const int st = kb % STAGES;
    const uint32_t base = saddr(ring + st * GEMM_STAGE);
    const uint32_t at = base + wg * ATOM, b0 = base + CWG * ATOM, b1 = b0 + ATOM;
    bar_wait(&full[st], (kb / STAGES) & 1);
    hold(c0);
    hold(c1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dA = desc(at + (TA ? 2048 : 32) * kk);
      if (FORM == GEMM_GEGLU || FORM == GEMM_RESIDUAL || FORM == GEMM_NT_STORE
          || FORM == GEMM_NT_F32) {
        // both B atoms in one n128
        mma_ss128(c0, c1, dA, desc(b0 + 32 * kk), 1);
        continue;
      }
      mma_t<TA, TB>(c0, dA, desc(b0 + (TB ? 2048 : 32) * kk));
      mma_t<TA, TB>(c1, dA, desc(b1 + (TB ? 2048 : 32) * kk));
    }
    wg_commit();
    wg_wait1();  // the previous k block's products are done: free its stage
    hold(c0);
    hold(c1);
    if (kb > 0) bar_arrive(&empty[(kb - 1) % STAGES]);
  }
  wg_wait();
  hold(c0);
  hold(c1);

  if (FORM == GEMM_LN_SUMS) {
    ln_sums(a, c0, c1, m0, n0, wg, warp, lane, ring, xs, xfull);
    return;
  }
  float* C = a.C + blockIdx.z * a.split_stride;
  const int r = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int gm = r + 8 * acc_hi(e), gn = n0 + acc_col(e, q4);
    if (gm >= a.M) continue;  // N is even: gn + 1 < N with gn
    if (FORM == GEMM_GEGLU) {  // value * gelu_erf(gate), one rounding (gemm.cu EPI_GEGLU)
      if (gn < a.N) {
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float g = c1[e + u];
          v[u] = c0[e + u] * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
        }
        *reinterpret_cast<bf162*>(reinterpret_cast<bf16*>(a.C) + (size_t)gm * a.ldc + gn) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
      continue;
    }
    if (FORM == GEMM_RESIDUAL) {  // one f32 add, one rounding (gemm.cu EPI_RESIDUAL)
      bf16* Cb = reinterpret_cast<bf16*>(a.C) + (size_t)gm * a.ldc;
      const bf16* R = a.resid + (size_t)gm * a.ldr;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = gn + 64 * h;
        if (c >= a.N) continue;
        const float2 x = __bfloat1622float2(*reinterpret_cast<const bf162*>(R + c));
        const float(&acc)[32] = h ? c1 : c0;
        *reinterpret_cast<bf162*>(Cb + c) = __floats2bfloat162_rn(acc[e] + x.x, acc[e + 1] + x.y);
      }
      continue;
    }
    if (FORM == GEMM_NT_STORE || FORM == GEMM_STORE_BF16) {  // one rounding (gemm.cu EPI_STORE)
      bf16* Cb = reinterpret_cast<bf16*>(a.C) + (size_t)gm * a.ldc;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = gn + 64 * h;
        if (c >= a.N) continue;
        const float(&acc)[32] = h ? c1 : c0;
        *reinterpret_cast<bf162*>(Cb + c) = __floats2bfloat162_rn(acc[e], acc[e + 1]);
      }
      continue;
    }
    if (FORM == GEMM_BIAS) {  // bf16(acc) + bias in bf16
      bf16* Cb = reinterpret_cast<bf16*>(a.C) + (size_t)gm * a.ldc;
      if (gn < a.N)
        *reinterpret_cast<bf162*>(Cb + gn) = __floats2bfloat162_rn(
            round_bf16(c0[e]) + bf2f(a.bias[gn]), round_bf16(c0[e + 1]) + bf2f(a.bias[gn + 1]));
      if (gn + 64 < a.N)
        *reinterpret_cast<bf162*>(Cb + gn + 64) = __floats2bfloat162_rn(
            round_bf16(c1[e]) + bf2f(a.bias[gn + 64]),
            round_bf16(c1[e + 1]) + bf2f(a.bias[gn + 65]));
      continue;
    }
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
// split_stride floats each (kchunk a multiple of 64); layout 2: "NN" with C
// bf16, each element rounded once.  A, B bf16, row strides lda, ldb; C f32
// (or bf16), row stride ldc.  The widths and strides of A and B multiples of
// 8 (ldc of 2), every base 16-byte aligned.
CT_EXPORT int ct_ff_tc_gemm(int layout, const void* A, int lda, const void* B, int ldb, int M,
                            int N, int K, int kchunk, void* C, int ldc, long long split_stride,
                            void* stream) {
  const int dims[] = {N, lda, ldb};
  const bool tn = layout == 1;
  bool ok = M > 0 && N > 0 && K > 0 && ldc % 2 == 0 && layout >= 0 && layout <= 2
            && kchunk > 0 && kchunk % TC_TILE == 0 && (tn || kchunk >= K)
            && (!tn || M % 8 == 0) && (tn || K % 8 == 0);
  for (int x : dims) ok = ok && x % 8 == 0;
  const void* ptrs[] = {A, B, C};
  for (const void* p : ptrs) ok = ok && aligned16(p);
  const int splits = ok ? (K + kchunk - 1) / kchunk : 0;
  if (!ok || (M + BM - 1) / BM > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  GemmMaps maps;
  if (!(tn ? tensor_map(&maps.A, A, K, M, lda) : tensor_map(&maps.A, A, M, K, lda))
      || !tensor_map(&maps.B, B, K, N, ldb))
    return (int)cudaErrorInvalidValue;
  const GemmArgs a = {static_cast<float*>(C), M, N, K, ldc, kchunk, split_stride};
  const dim3 grid((N + 127) / 128, (M + BM - 1) / BM, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 2)
    return (int)launch(ff_tc_gemm<0, GEMM_STORE_BF16>, grid, gemm_smem(), st, maps, a);
  return (int)(tn ? launch(ff_tc_gemm<1>, grid, gemm_smem(), st, maps, a)
                  : launch(ff_tc_gemm<0>, grid, gemm_smem(), st, maps, a));
}

namespace {

// the checks and tensor maps of an "NN" or "NT" product of A (M, K) K-major
// and B, (K, N) MN-major (nt 0) or (N, K) K-major (nt 1), bf16
bool gemm_maps(GemmMaps* maps, const void* A, int lda, const void* B, int ldb, int M, int N,
               int K, bool nt) {
  const int dims[] = {N, K, lda, ldb};
  bool ok = M > 0 && N > 0 && K > 0 && aligned16(A) && aligned16(B) && (M + BM - 1) / BM <= 65535;
  for (int x : dims) ok = ok && x % 8 == 0;
  return ok && tensor_map(&maps->A, A, M, K, lda)
         && (nt ? tensor_map(&maps->B, B, N, K, ldb) : tensor_map(&maps->B, B, K, N, ldb));
}

}  // namespace

// K16a's recompute ("NT"): C (M, N) bf16 = bf16(bf16(A B^T) + bias) for A
// (M, K) and B (N, K) bf16 with row strides lda and ldb, bias (N,) bf16, C
// row stride ldc.  K, N and the strides multiples of 8, A, B and C 16-byte
// aligned.
CT_EXPORT int ct_ff_tc_gemm_bias(const void* A, int lda, const void* B, int ldb, int M, int N,
                                 int K, const void* bias, void* C, int ldc, void* stream) {
  GemmMaps maps;
  if (!bias || !aligned16(C) || ldc % 8 || !gemm_maps(&maps, A, lda, B, ldb, M, N, K, true))
    return (int)cudaErrorInvalidValue;
  GemmArgs a = {static_cast<float*>(C), M, N, K, ldc, (K + TC_TILE - 1) / TC_TILE * TC_TILE, 0};
  a.bias = static_cast<const bf16*>(bias);
  return (int)launch(ff_tc_gemm<0, GEMM_BIAS>, dim3((N + 127) / 128, (M + BM - 1) / BM, 1),
                     gemm_smem(), static_cast<cudaStream_t>(stream), maps, a);
}

// K16a's LN(pt p p) sums ("NN", dxn never stored): dxn = A (M, K) B (K, N),
// A, B bf16 with row strides lda, ldb; with xhat = (x - mean) rstd of the
// patch rows of video (Bv, F, H, W) bf16 and their stats (M, 2) f32 (mean,
// rstd), part (ceil(M / 128), 2 N) f32 gets row by row each 128-row tile's
// column sums of dxn xhat, then of dxn.  N = pt p p and M = Bv t h w; p and
// W multiples of 4 (the volume tile copied 4 columns at a time); K, N and
// the strides multiples of 8.
CT_EXPORT int ct_ff_tc_ln_sums(const void* A, int lda, const void* B, int ldb, int M, int N,
                               int K, const void* video, int Bv, int F, int H, int W, int pt,
                               int p, const void* stats, void* part, void* stream) {
  GemmMaps maps;
  const bool geom = pt > 0 && p > 0 && F % pt == 0 && H % p == 0 && W % p == 0 && p % 4 == 0
                    && W % 4 == 0 && N == pt * p * p
                    && (long long)M == (long long)Bv * (F / pt) * (H / p) * (W / p);
  if (!geom || !aligned16(video) || !aligned16(stats) || !aligned16(part)
      || !gemm_maps(&maps, A, lda, B, ldb, M, N, K, false))
    return (int)cudaErrorInvalidValue;
  GemmArgs a = {static_cast<float*>(part), M, N, K, 2 * N, (K + TC_TILE - 1) / TC_TILE * TC_TILE,
                0};
  a.video = static_cast<const bf16*>(video);
  a.stats = static_cast<const float*>(stats);
  a.g = {F, H, W, pt, p, F / pt, H / p, W / p};
  return (int)launch(ff_tc_gemm<0, GEMM_LN_SUMS>, dim3((N + 127) / 128, (M + BM - 1) / BM, 1),
                     ln_sums_smem(), static_cast<cudaStream_t>(stream), maps, a);
}

// K3's GEGLU product ("NT"): act (M, N) bf16 = bf16(a gelu(g)), a = A wa^T
// and g = A wg^T, for A (M, K) bf16 (row stride lda) and W (2 N, K) = [wa;
// wg] bf16 (row stride ldw); act row stride ldact.  N (the padded inner
// width), K and the strides multiples of 8, A, W and act 16-byte aligned.
CT_EXPORT int ct_ff_tc_geglu(const void* A, int lda, const void* W, int ldw, int M, int N, int K,
                             void* act, int ldact, void* stream) {
  GemmMaps maps;
  if (N % 8 || ldact % 8 || !aligned16(act)
      || !gemm_maps(&maps, A, lda, W, ldw, M, 2 * N, K, true))
    return (int)cudaErrorInvalidValue;
  GemmArgs a = {static_cast<float*>(act), M, N, K, ldact, (K + TC_TILE - 1) / TC_TILE * TC_TILE,
                0};
  a.inner = N;
  return (int)launch(ff_tc_gemm<0, GEMM_GEGLU>, dim3((N + 63) / 64, (M + BM - 1) / BM, 1),
                     gemm_smem(), static_cast<cudaStream_t>(stream), maps, a);
}

// The QK-norm sublayer's q and kv products ("NT"): C (M, N) bf16 = bf16(A
// B^T) for A (M, K) and B (N, K) bf16 with row strides lda and ldb, C row
// stride ldc.  K, N and the strides multiples of 8, A, B and C 16-byte
// aligned.
CT_EXPORT int ct_ff_tc_gemm_nt(const void* A, int lda, const void* B, int ldb, int M, int N,
                               int K, void* C, int ldc, void* stream) {
  GemmMaps maps;
  if (!aligned16(C) || ldc % 8 || !gemm_maps(&maps, A, lda, B, ldb, M, N, K, true))
    return (int)cudaErrorInvalidValue;
  const GemmArgs a = {static_cast<float*>(C), M, N, K, ldc,
                      (K + TC_TILE - 1) / TC_TILE * TC_TILE, 0};
  return (int)launch(ff_tc_gemm<0, GEMM_NT_STORE>, dim3((N + 127) / 128, (M + BM - 1) / BM, 1),
                     gemm_smem(), static_cast<cudaStream_t>(stream), maps, a);
}

// The same with C f32, unrounded (K10 bf16's recompute of q and kv): C row
// stride ldc a multiple of 2, C 16-byte aligned.
CT_EXPORT int ct_ff_tc_gemm_nt_f32(const void* A, int lda, const void* B, int ldb, int M, int N,
                                   int K, void* C, int ldc, void* stream) {
  GemmMaps maps;
  if (!aligned16(C) || ldc % 2 || !gemm_maps(&maps, A, lda, B, ldb, M, N, K, true))
    return (int)cudaErrorInvalidValue;
  const GemmArgs a = {static_cast<float*>(C), M, N, K, ldc,
                      (K + TC_TILE - 1) / TC_TILE * TC_TILE, 0};
  return (int)launch(ff_tc_gemm<0, GEMM_NT_F32>, dim3((N + 127) / 128, (M + BM - 1) / BM, 1),
                     gemm_smem(), static_cast<cudaStream_t>(stream), maps, a);
}

// K3's residual product ("NT"), also the QK-norm sublayer's output product
// (K = heads x 32): out (M, N) bf16 = bf16(A W^T + x) for A (M,
// K) and W (N, K) bf16 (row strides lda, ldw; K the padded inner width,
// W's padded columns zero), x (M, N) bf16 (row stride ldx), out row stride
// ldo.  N, K and the strides multiples of 8, every base 16-byte aligned.
CT_EXPORT int ct_ff_tc_residual(const void* A, int lda, const void* W, int ldw, int M, int N,
                                int K, const void* x, int ldx, void* out, int ldo, void* stream) {
  GemmMaps maps;
  if (ldx % 8 || ldo % 8 || !aligned16(x) || !aligned16(out)
      || !gemm_maps(&maps, A, lda, W, ldw, M, N, K, true))
    return (int)cudaErrorInvalidValue;
  GemmArgs a = {static_cast<float*>(out), M, N, K, ldo, (K + TC_TILE - 1) / TC_TILE * TC_TILE, 0};
  a.resid = static_cast<const bf16*>(x);
  a.ldr = ldx;
  return (int)launch(ff_tc_gemm<0, GEMM_RESIDUAL>, dim3((N + 127) / 128, (M + BM - 1) / BM, 1),
                     gemm_smem(), static_cast<cudaStream_t>(stream), maps, a);
}
