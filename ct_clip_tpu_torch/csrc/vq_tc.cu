// vq_tc.cu — the VQ's inference assignment (K5, exact=False) on the Hopper
// tensor cores: ids[m] = argmax_n x_m . c_n over every code, the similarity
// products on `wgmma` (sm_90a) with f32 accumulators, the argmax on the
// accumulators in registers, only the int32 ids written.
//
// Replaces ct_clip_tpu/ops/pallas/vq.py::pallas_assign (K5, :104,
// pallas_call :121, body _assign_kernel :62-101) in its inference mode,
// which gemm.cu's gemm_argmax_kernel ran on WMMA with synchronous staging
// (it stays, for shapes this kernel does not take):
//   * bf16 rows (raw_bf16, :67-82): the raw rows against the bf16-rounded
//     normalised codebook, one bf16 product, f32 sums;
//   * f32 rows (:83-93): each row l2-normalised in f32 and rounded to bf16
//     (xh = xn.astype(bf16), :84), then the same product.  A pre-pass
//     (vq_rows_bf16_kernel) writes the rounded rows once (28 MB at
//     zero-shot's 27,648 x 512, ~0.02 ms), each row's sum of squares in the
//     order of vq_stats.cu's sum_f32_kernel (one rounded square and add per
//     element over a lane's 16-byte pieces, then the warp's xor butterfly)
//     and its inverse norm a rounded sqrt and division, which
//     ops/vq.py::_lane_inv_norm repeats bit for bit: the card's check holds
//     the ids to a plain version whose bf16 rows are the kernel's.
//
// And the same function in its exact mode (training, exact=True), which
// gemm.cu's gemm_argmax2_kernel and gemm_argmax3_rows_kernel ran on WMMA
// (they stay for the widths this kernel does not take):
//   * bf16 rows (:67-82): sim = x c_hi + x c_lo against the normalised
//     codebook split into bf16 hi and lo parts;
//   * f32 rows (:83-95): the pre-pass also writes xl = bf16(xn - xh), and
//     sim = (xh c_hi + xh c_lo) + xl c_hi.
// The exact forms are the inference kernel with more products per k block:
// each stage of the ring holds one 64-wide k block of a code tile's c_hi and
// c_lo, and the consumers run x c_hi, x c_lo (and xl c_hi) for each k16
// slice into the one accumulator pair, so the pair alternation and the
// argmax under the next tile's products stay as they are.  This sums in
// another order than the TPU kernel's separate dots (ids can differ only
// where two codes tie within that order's f32 rounding).  Shared memory:
// 128 resident rows of x (128 KB at K 512) and three stages of both parts
// (96 KB); with f32 rows xh and xl are both resident, so a CTA takes 64
// rows (one consumer warpgroup) and every CTA walks the codebook's 16 MiB
// of hi and lo: 1,728 CTAs read ~29 GB from L2 at the contrastive step's
// 110,592 rows (864 CTAs and ~14 GB with bf16 rows), which a cluster
// multicasting the code tiles would halve.
//
// What bounds it on the H100.  At zero-shot's 27,648 rows x 512 against
// 8,192 codes the products are 232 GFLOP, 0.235 ms at 989 TFLOP/s, against
// 37 MB of rows, codebook and ids (0.011 ms): the tensor cores.  Every CTA
// walks the whole 8 MiB codebook, so the codebook's traffic from L2 grows
// with the number of row tiles (1.8 GB at 128 rows a tile): the L2-to-SM
// rate is the next limit, which taller row tiles lower (CT_VQ_TC_CWG=3:
// 192 rows; a 256-row tile's 256 KB of resident rows does not fit).
//
// Design:
//   * A CTA is a producer warp and CWG consumer warpgroups of 64 rows each.
//     Its row tile (BM x K, K <= 512) is copied once by TMA and stays in
//     shared memory (K / 64 128-byte-swizzled atoms per 64 rows); the
//     producer then streams the codebook in 128-code tiles, one 64-wide k
//     block (two atoms) per stage of a ring.
//   * Each consumer warpgroup runs S = x c^T for its 64 rows x 128 codes
//     as one m64n128k16 `wgmma` per k16 slice (the first slice of a tile
//     overwrites, scale-d 0) into two 64-column halves of its accumulator;
//     one n128 product reads its A slice once, where two n64 ones would
//     read it twice and meet the SM's shared-memory bandwidth first.  Two accumulator pairs alternate: once
//     a tile's first k block is issued, the previous tile's products are
//     all done, and its argmax runs while the tensor cores work on this one.
//   * The argmax: each thread keeps a (max, index) for its two rows, taking
//     its columns in increasing order with a strict >, so ties go to the
//     lower code; at the end the four threads of a row merge by shuffles,
//     the lower index winning a tie, as torch.argmax and jnp.argmax do.
//   * Ragged edges: rows past M and codes past N are zero-filled by the TMA
//     copies; codes past N are skipped by the compare, rows past M by the
//     store.  K, the row strides and every base must suit TMA: multiples of
//     8 elements (16 bytes).
#include <type_traits>

#include "common.cuh"
#include "tma.cuh"

// consumer warpgroups of a CTA (rows per CTA: 64 each); 3 in a copy for the
// card's L2-traffic probe (kernels.copy_library)
#ifndef CT_VQ_TC_CWG
#define CT_VQ_TC_CWG 2
#endif

namespace {

constexpr int ATOM = TC_TILE * 128;  // one swizzled atom: 64 rows of 128 bytes
constexpr int CWG = CT_VQ_TC_CWG;
constexpr int BN = 128;             // codes of a tile: two n64 accumulators
constexpr int KMAX = 512;           // the widest row the resident tile holds

// the forms: the inference mode, and the exact mode on bf16 rows (x c_hi + x
// c_lo) and on f32 rows ((xh c_hi + xh c_lo) + xl c_hi)
enum VqMode { VQ_INFER = 0, VQ_EXACT = 1, VQ_EXACT_ROWS = 2 };

// the shape of a form: consumer warpgroups, threads, rows of a CTA tile,
// resident row tiles (x; or xh and xl), codebook parts a stage holds (c_hi;
// or c_hi and c_lo, one 64-wide k block of a 128-code tile each) and the
// ring's stages.  The inference form keeps the shape it had; the exact forms
// take 128 rows (bf16) or, with xl resident beside xh, 64 (f32 rows), and
// three stages of both parts, so that rows and ring fit 227 KB at K 512.
template <int MODE>
struct Form {
  static constexpr int cwg = MODE == VQ_INFER ? CWG : MODE == VQ_EXACT ? 2 : 1;
  static constexpr int nt = 128 * cwg + 32;  // + the producer warp
  static constexpr int bm = 64 * cwg;
  static constexpr int xparts = MODE == VQ_EXACT_ROWS ? 2 : 1;
  static constexpr int cparts = MODE == VQ_INFER ? 1 : 2;
  static constexpr int stages = MODE == VQ_INFER ? (CWG == 2 ? 4 : 2) : 3;
  static constexpr int stage = cparts * 2 * ATOM;
  static int smem(int kblocks) { return 1024 + kblocks * xparts * cwg * ATOM + stages * stage; }
  static_assert(1024 + KMAX / TC_TILE * xparts * cwg * ATOM + stages * stage <= 232448,
                "the row tiles and the ring fit one CTA's shared memory");
};

struct Maps {
  CUtensorMap x, codes;
};
// the exact forms': the second parts xl (f32 rows) and lo beside them
struct ExactMaps {
  CUtensorMap x, codes, xl, lo;
};

// this thread's share of one 128-code tile's similarities (d0: codes c0 ..
// c0 + 63, d1: c0 + 64 ..) into its two rows' running (max, index); columns
// in increasing order, strict >: a tie keeps the lower code
__device__ __forceinline__ void take_tile(const float (&d0)[32], const float (&d1)[32], int c0,
                                          int N, int q4, float (&best)[2], int (&arg)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float(&d)[32] = half ? d1 : d0;
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 4 * q + 2 * h + u, col = c0 + 64 * half + acc_col(e, q4);
          if (col < N && d[e] > best[h]) {
            best[h] = d[e];
            arg[h] = col;
          }
        }
    }
}

// the products of code tile t into (d0, d1), k block by k block (global
// stage counter `it`); with `prev`, once the first k block is issued the
// previous tile's accumulators (p0, p1) are final and go through take_tile
// while these products run.  The exact forms run two (x c_hi, x c_lo) or
// three (xh c_hi, xh c_lo, xl c_hi) products per k16 slice into the same
// accumulators, in that order, every one unconditional (a wgmma under a
// branch is serialized)
template <int MODE>
__device__ __forceinline__ void tile_products(float (&d0)[32], float (&d1)[32], float (&p0)[32],
                                              float (&p1)[32], bool prev, int t, int& it,
                                              int kblocks, uint32_t xs, uint8_t* ring,
                                              uint64_t* full, uint64_t* empty, int N, int q4,
                                              float (&best)[2], int (&arg)[2]) {
  using F = Form<MODE>;
  for (int kb = 0; kb < kblocks; ++kb, ++it) {
    const int st = it % F::stages;
    const uint32_t b0 = saddr(ring + st * F::stage);  // codes t BN .., two atoms (then c_lo's)
    const uint32_t at = xs + kb * F::cwg * ATOM;
    bar_wait(&full[st], (it / F::stages) & 1);
    hold(d0);
    hold(d1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_ss128(d0, d1, desc(at + 32 * kk), desc(b0 + 32 * kk), kb > 0 || kk > 0);
      if constexpr (MODE != VQ_INFER)
        mma_ss128(d0, d1, desc(at + 32 * kk), desc(b0 + 2 * ATOM + 32 * kk), 1);
      if constexpr (MODE == VQ_EXACT_ROWS)  // xl, kblocks x cwg atoms past xh
        mma_ss128(d0, d1, desc(at + kblocks * F::cwg * ATOM + 32 * kk), desc(b0 + 32 * kk), 1);
    }
    wg_commit();
    wg_wait1();  // every earlier group is done: free the previous stage
    hold(d0);
    hold(d1);
    if (it > 0) bar_arrive(&empty[(it - 1) % F::stages]);
    if (prev && kb == 0) {
      hold(p0);
      hold(p1);
      take_tile(p0, p1, (t - 1) * BN, N, q4, best, arg);
    }
  }
}

// ids (M,) int32 = argmax over the N codes (N, K) of x (M, K) . code, bf16
// operands through their tensor maps, f32 sums; the exact forms add the
// products of the second parts (c_lo; and xl) in the same accumulators
template <int MODE>
__global__ void __launch_bounds__(Form<MODE>::nt, 1) vq_tc_argmax(
    const __grid_constant__ std::conditional_t<MODE == VQ_INFER, Maps, ExactMaps> maps, int M,
    int N, int K, int* __restrict__ ids) {
  using F = Form<MODE>;
  constexpr int cwg = F::cwg;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[F::stages], empty[F::stages], xfull;
  uint8_t* base = align1024(smem_raw);
  const int kblocks = (K + TC_TILE - 1) / TC_TILE, tiles = (N + BN - 1) / BN;
  uint8_t* ring = base + kblocks * F::xparts * cwg * ATOM;  // past the resident row tiles
  const int m0 = blockIdx.x * F::bm;
  if (threadIdx.x == 0) bar_init(&xfull, 1);
  init_ring<F::stages, 128 * cwg>(full, empty);

  if (threadIdx.x >= 128 * cwg) {  // the producer: one thread
    if (threadIdx.x != 128 * cwg) return;
    bar_expect(&xfull, kblocks * F::xparts * cwg * ATOM);
    for (int kb = 0; kb < kblocks; ++kb)
#pragma unroll
      for (int w = 0; w < cwg; ++w) {
        tma_load(saddr(base + (kb * cwg + w) * ATOM), &maps.x, kb * TC_TILE, m0 + 64 * w,
                 &xfull);
        if constexpr (MODE == VQ_EXACT_ROWS)
          tma_load(saddr(base + ((kblocks + kb) * cwg + w) * ATOM), &maps.xl, kb * TC_TILE,
                   m0 + 64 * w, &xfull);
      }
    int it = 0;
    for (int t = 0; t < tiles; ++t)
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int st = it % F::stages;
        if (it >= F::stages) bar_wait(&empty[st], (it / F::stages - 1) & 1);
        const uint32_t dst = saddr(ring + st * F::stage);
        bar_expect(&full[st], F::stage);
        tma_load(dst, &maps.codes, kb * TC_TILE, t * BN, &full[st]);
        tma_load(dst + ATOM, &maps.codes, kb * TC_TILE, t * BN + 64, &full[st]);
        if constexpr (MODE != VQ_INFER) {
          tma_load(dst + 2 * ATOM, &maps.lo, kb * TC_TILE, t * BN, &full[st]);
          tma_load(dst + 3 * ATOM, &maps.lo, kb * TC_TILE, t * BN + 64, &full[st]);
        }
      }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  const uint32_t xs = saddr(base) + wg * ATOM;  // this warpgroup's 64 rows, k block 0
  float best[2] = {-INFINITY, -INFINITY};
  int arg[2] = {0, 0};
  float a0[32], a1[32], b0[32], b1[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) a0[e] = a1[e] = b0[e] = b1[e] = 0.0f;
  bar_wait(&xfull, 0);
  int it = 0, t = 0;
  for (; t + 1 < tiles; t += 2) {
    tile_products<MODE>(a0, a1, b0, b1, t > 0, t, it, kblocks, xs, ring, full, empty, N, q4,
                        best, arg);
    tile_products<MODE>(b0, b1, a0, a1, true, t + 1, it, kblocks, xs, ring, full, empty, N, q4,
                        best, arg);
  }
  if (t < tiles) {  // an odd count: the last tile in (a0, a1)
    tile_products<MODE>(a0, a1, b0, b1, t > 0, t, it, kblocks, xs, ring, full, empty, N, q4,
                        best, arg);
    wg_wait();
    hold(a0);
    hold(a1);
    take_tile(a0, a1, t * BN, N, q4, best, arg);
  } else {
    wg_wait();
    hold(b0);
    hold(b1);
    take_tile(b0, b1, (t - 1) * BN, N, q4, best, arg);
  }

  // the four threads of a row: the larger similarity, the lower code on a tie
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[h], o);
      const int oi = __shfl_xor_sync(0xffffffffu, arg[h], o);
      if (ov > best[h] || (ov == best[h] && oi < arg[h])) {
        best[h] = ov;
        arg[h] = oi;
      }
    }
    const int row = m0 + 64 * wg + 16 * warp + (lane >> 2) + 8 * h;
    if (q4 == 0 && row < M) ids[row] = arg[h];
  }
}

// f32 rows (M, D) -> each normalised as x / sqrt(max(sum x^2, 1e-24)) and
// rounded to bf16 (M, D): one warp a row, the sum in sum_f32_kernel's order
// (vq_stats.cu), a rounded sqrt and division, a rounded product.  SPLIT (the
// exact mode): also the lo part bf16(xn - xh) into lo (vq.py:90-95)
template <bool SPLIT>
__global__ void __launch_bounds__(256) vq_rows_bf16_kernel(const float* __restrict__ x, int M,
                                                           int D, bf16* __restrict__ out,
                                                           bf16* __restrict__ lo) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (size_t)row * D;
  float v[32];
  float ss = 0.0f;
#pragma unroll
  for (int u = 0; u < 8; ++u) {  // 16-byte pieces: lane + 32 u of D / 4
    const int c = (lane + 32 * u) * 4;
    if (c < D) {
      const float4 f = *reinterpret_cast<const float4*>(xr + c);
      v[4 * u] = f.x;
      v[4 * u + 1] = f.y;
      v[4 * u + 2] = f.z;
      v[4 * u + 3] = f.w;
      // one rounded square and one rounded add per element, in this order
#pragma unroll
      for (int e = 0; e < 4; ++e) ss = __fadd_rn(ss, __fmul_rn(v[4 * u + e], v[4 * u + e]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * u + e] = 0.0f;
    }
  }
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(warp_sum(ss), 1e-24f)));
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int c = (lane + 32 * u) * 4;
    if (c < D) {
      bf162* o = reinterpret_cast<bf162*>(out + (size_t)row * D + c);
      if constexpr (SPLIT) {
        float xn[4];
        bf162 h[2];
#pragma unroll
        for (int e = 0; e < 4; ++e) xn[e] = __fmul_rn(v[4 * u + e], inv);
        h[0] = __floats2bfloat162_rn(xn[0], xn[1]);
        h[1] = __floats2bfloat162_rn(xn[2], xn[3]);
        o[0] = h[0];
        o[1] = h[1];
        const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
        bf162* l = reinterpret_cast<bf162*>(lo + (size_t)row * D + c);
        l[0] = __floats2bfloat162_rn(__fsub_rn(xn[0], f0.x), __fsub_rn(xn[1], f0.y));
        l[1] = __floats2bfloat162_rn(__fsub_rn(xn[2], f1.x), __fsub_rn(xn[3], f1.y));
      } else {
        o[0] = __floats2bfloat162_rn(__fmul_rn(v[4 * u], inv), __fmul_rn(v[4 * u + 1], inv));
        o[1] = __floats2bfloat162_rn(__fmul_rn(v[4 * u + 2], inv),
                                     __fmul_rn(v[4 * u + 3], inv));
      }
    }
  }
}

template <int MODE, typename MapsT>
int launch_argmax(const MapsT& maps, int M, int N, int K, void* ids, void* stream) {
  using F = Form<MODE>;
  const int smem = F::smem((K + TC_TILE - 1) / TC_TILE);
  cudaError_t err = cudaFuncSetAttribute(vq_tc_argmax<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  vq_tc_argmax<MODE><<<(M + F::bm - 1) / F::bm, F::nt, smem, static_cast<cudaStream_t>(stream)>>>(
      maps, M, N, K, static_cast<int*>(ids));
  return (int)cudaGetLastError();
}

}  // namespace

// K5's inference assignment: ids (M,) int32 = argmax_n x[m] . codes[n] for
// x (M, K) bf16 (row stride ldx) and codes (N, K) bf16 (row stride ldc), f32
// sums, ties to the lower code.  K <= 512; K and the strides multiples of
// 8; x and codes 16-byte aligned.
CT_EXPORT int ct_vq_assign_tc(const void* x, int ldx, const void* codes, int ldc, int M, int N,
                              int K, void* ids, void* stream) {
  const bool ok = M > 0 && N > 0 && K > 0 && K <= KMAX && K % 8 == 0 && ldx % 8 == 0
                  && ldc % 8 == 0 && aligned16(x) && aligned16(codes) && ids;
  Maps maps;
  if (!ok || !tensor_map(&maps.x, x, M, K, ldx) || !tensor_map(&maps.codes, codes, N, K, ldc))
    return (int)cudaErrorInvalidValue;
  return launch_argmax<VQ_INFER>(maps, M, N, K, ids, stream);
}

// K5's exact assignment (training): ids (M,) int32 = argmax_n of x[m] .
// hi[n] + x[m] . lo[n] (xl null: bf16 rows) or of (x[m] . hi[n] + x[m] .
// lo[n]) + xl[m] . hi[n] (f32 rows split by ct_vq_rows_bf16 into x = xh and
// xl), summed in f32 per k16 slice in that order, ties to the lower code.
// hi and lo (N, K) bf16 share the row stride ldc, x and xl (M, K) bf16 ldx.
// K <= 512; K and the strides multiples of 8; every base 16-byte aligned.
CT_EXPORT int ct_vq_assign_exact_tc(const void* x, const void* xl, int ldx, const void* hi,
                                    const void* lo, int ldc, int M, int N, int K, void* ids,
                                    void* stream) {
  const bool ok = M > 0 && N > 0 && K > 0 && K <= KMAX && K % 8 == 0 && ldx % 8 == 0
                  && ldc % 8 == 0 && aligned16(x) && aligned16(hi) && aligned16(lo)
                  && (!xl || aligned16(xl)) && ids;
  ExactMaps maps;
  if (!ok || !tensor_map(&maps.x, x, M, K, ldx) || !tensor_map(&maps.codes, hi, N, K, ldc)
      || !tensor_map(&maps.lo, lo, N, K, ldc) || (xl && !tensor_map(&maps.xl, xl, M, K, ldx)))
    return (int)cudaErrorInvalidValue;
  return xl ? launch_argmax<VQ_EXACT_ROWS>(maps, M, N, K, ids, stream)
            : launch_argmax<VQ_EXACT>(maps, M, N, K, ids, stream);
}

// K5's pre-pass on f32 rows: x (M, D) f32 contiguous -> out (M, D) bf16,
// each row normalised (vq_rows_bf16_kernel), and with lo (the exact mode)
// the lo parts bf16(xn - out) (M, D); D % 4 == 0, D <= 1024, x 16-byte
// aligned.
CT_EXPORT int ct_vq_rows_bf16(const void* x, int M, int D, void* out, void* lo, void* stream) {
  if (M < 1 || D < 1 || D % 4 || D > 1024 || !aligned16(x) || !out)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lo)
    vq_rows_bf16_kernel<true><<<(M + 7) / 8, 256, 0, st>>>(
        static_cast<const float*>(x), M, D, static_cast<bf16*>(out), static_cast<bf16*>(lo));
  else
    vq_rows_bf16_kernel<false><<<(M + 7) / 8, 256, 0, st>>>(
        static_cast<const float*>(x), M, D, static_cast<bf16*>(out), nullptr);
  return (int)cudaGetLastError();
}
