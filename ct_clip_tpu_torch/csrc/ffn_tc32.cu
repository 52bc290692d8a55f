// ffn_tc32.cu — the f32 GEGLU feed-forward (K3 in f32) in 3xTF32 on the
// Hopper tensor cores: its two products as TF32 `wgmma` (sm_90a) kernels on
// operands split once into TF32 hi and lo planes in device memory, the tiles
// copied by TMA into 128-byte-swizzled shared memory behind a ring of
// mbarriers (ffn_tc.cu's producer-warp design), for two consumer warpgroups.
//
// Replaces, for f32 operands, ct_clip_tpu/ops/pallas/ffn.py::_pallas_ff (K3,
// :105, pallas_call :114, body _kernel :89-102), which takes "highest"
// precision for f32 (`dot_precision`): LN -> [a | g] = xn [wa | wg] -> act =
// a gelu(g) -> act wo + x, nothing rounded below f32.  gemm.cu's FFMA
// gemm_kernel<float> ran its two products on the CUDA cores (it keeps its
// other callers).  Here:
//   * layernorm.cu's LN_SPLIT form writes xn as hi and lo planes; the three
//     weights (wa, wg padded to the inner width, wo) are split by tc32_split
//     once per call;
//   * ff_tc32_geglu: a = xn wa^T and g = xn wg^T side by side (two 64-column
//     accumulators a warpgroup), then act = a gelu(g) in f32 with the exact
//     erf, written split as hi and lo planes;
//   * ff_tc32_residual: out = act wo^T + x, the f32 x added to the f32 sum
//     once.
// The same products serve K1 f32's projections (ops/qknorm_attention.py,
// ct_clip_tpu/ops/pallas/spatial_attention.py::_pallas_spatial, :276, f32
// at "highest"), which gemm.cu's FFMA tiles ran: q = LN(x) wq^T and kv = x
// wkv^T in the plain-store form (ct_tc32_gemm), out = merged wout^T + x in
// the residual form.
// Each f32 product A B runs as three TF32 products per k8 slice, lo hi, hi
// lo, then hi hi, into one f32 accumulator (tc32.cuh's mma3 order; the lo
// lo term, ~2^-22 of the product, is dropped); hi is x rounded to TF32 and
// lo = x - hi, which the tensor core reads truncated to TF32.  A tensor-core
// accumulator's sum is not rounded as an FMA chain's, so each FLUSH k range
// sums in its own accumulator, added into an f32 total.
//
// What bounds it on the H100: the tensor cores.  At zero-shot's batch of 2
// (27,648 rows x 512, inner 1,365 padded to 1,368) the products are 6 R 512
// 1,368 = 116 GFLOP, three TF32 passes each: 0.704 ms at 495 TFLOP/s,
// against ~0.4 GB of operands and planes (0.12 ms).  Both products read
// both operands K-major, the only layout TF32 `wgmma` takes: xn (R, 512)
// against wa, wg (1,368, 512); act (R, 1,368) against wo (512, 1,368).
//
// Design: a k block is 32 f32 (one 128-byte swizzled row); a stage holds A's
// hi and lo tiles for the CTA's 128 rows and B's hi and lo tiles for its 128
// columns (64 KB); three stages, one CTA per SM.  Ragged edges (rows, the
// inner width 1,368 and the last k block, 1,368 = 42 x 32 + 24) are
// zero-filled by the TMA copies and masked at the stores.  Widths and row
// strides must be multiples of 4 floats (16 bytes), as TMA requires.
#include "common.cuh"
#include "tc32.cuh"
#include "tma.cuh"

namespace {

constexpr int CWG = 2;              // consumer warpgroups
constexpr int NT = 128 * CWG + 32;  // + the producer warp
constexpr int BM = 64 * CWG;        // rows of a CTA tile
constexpr int KB = 32;              // f32 of a k block: one 128-byte row
constexpr int ATOM = TC_TILE * 128;  // one swizzled atom: 64 rows x 32 f32
constexpr int STAGES = 3;
constexpr int STAGE = 8 * ATOM;  // A hi, lo: 2 atoms each; B hi, lo: 2 atoms each
constexpr int FLUSH = 8;         // k blocks (256 of K) summed in one accumulator
constexpr int SMEM = 1024 + STAGES * STAGE;
// the kernel's epilogue forms (compile-time)
constexpr int EPI_GEGLU = 0, EPI_RESIDUAL = 1, EPI_STORE = 2;

// d += A B: m64 n64 k8, TF32 operands, both K-major in shared memory
__device__ __forceinline__ void mma_tf32(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D ", %32, %33, p, 1, 1;\n}\n"
      : WG_OUT(d) : "l"(da), "l"(db), "r"(1));
}

// one k8 slice in 3xTF32: lo hi, hi lo, then hi hi (tc32.cuh's mma3 order);
// built with CT_TC32_PASSES=1, hi hi alone (plain TF32)
__device__ __forceinline__ void mma3_tf32(float (&d)[32], uint64_t ah, uint64_t al,
                                          uint64_t bh, uint64_t bl) {
  if (CT_TC32_PASSES == 3) {
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
  }
  mma_tf32(d, ah, bh);
}

// total += d, d = 0, once the warpgroup's products are done
__device__ __forceinline__ void flush(float (&total)[32], float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    total[e] += d[e];
    d[e] = 0.0f;
  }
}

// A (M, K) hi / lo and B0, B1 (N, K) hi / lo, f32 planes, through tensor maps
struct Maps {
  CUtensorMap ah, al, b0h, b0l, b1h, b1l;
};
struct Args {
  float *outh, *outl;  // geglu: act hi, lo (M, N); residual: out (M, N) in outh
  const float* x;      // residual: x (M, N)
  int M, N, K, ldo, ldx;
};

// EPI_GEGLU (ff_tc32_geglu): one CTA per (128 rows, 64 inner columns), B0 =
// wa and B1 = wg at the same 64 rows, two accumulators a and g a warpgroup;
// EPI_RESIDUAL (ff_tc32_residual, out = A W^T + x) and EPI_STORE (tc32_gemm,
// out = A W^T): one CTA per (128 rows, 128 columns), B0 and B1 the two 64-row
// halves of W's tile (B1's maps are B0's).
template <int EPI>
__global__ void __launch_bounds__(NT, 1) ff_tc32_kernel(const __grid_constant__ Maps maps,
                                                        Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = align1024(smem_raw);
  const int n0 = blockIdx.x * (EPI != EPI_GEGLU ? 128 : 64), m0 = blockIdx.y * BM;
  const int kblocks = (a.K + KB - 1) / KB;
  init_ring<STAGES, 128 * CWG>(full, empty);

  if (threadIdx.x >= 128 * CWG) {  // the producer: one thread
    if (threadIdx.x != 128 * CWG) return;
    const int nb1 = EPI != EPI_GEGLU ? n0 + 64 : n0;
    for (int kb = 0; kb < kblocks; ++kb) {
      const int st = kb % STAGES, k0 = kb * KB;
      if (kb >= STAGES) bar_wait(&empty[st], (kb / STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * STAGE);
      bar_expect(&full[st], STAGE);
#pragma unroll
      for (int w = 0; w < CWG; ++w) {
        tma_load(dst + w * ATOM, &maps.ah, k0, m0 + 64 * w, &full[st]);
        tma_load(dst + (CWG + w) * ATOM, &maps.al, k0, m0 + 64 * w, &full[st]);
      }
      tma_load(dst + 4 * ATOM, &maps.b0h, k0, n0, &full[st]);
      tma_load(dst + 5 * ATOM, &maps.b0l, k0, n0, &full[st]);
      tma_load(dst + 6 * ATOM, &maps.b1h, k0, nb1, &full[st]);
      tma_load(dst + 7 * ATOM, &maps.b1l, k0, nb1, &full[st]);
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  float c0[32], c1[32], t0[32], t1[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) c0[e] = c1[e] = t0[e] = t1[e] = 0.0f;
  for (int kb = 0; kb < kblocks; ++kb) {
    const int st = kb % STAGES;
    const uint32_t base = saddr(ring + st * STAGE);
    const uint32_t ah = base + wg * ATOM, al = base + (CWG + wg) * ATOM;
    bar_wait(&full[st], (kb / STAGES) & 1);
    hold(c0);
    hold(c1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dah = desc(ah + 32 * kk), dal = desc(al + 32 * kk);
      mma3_tf32(c0, dah, dal, desc(base + 4 * ATOM + 32 * kk), desc(base + 5 * ATOM + 32 * kk));
      mma3_tf32(c1, dah, dal, desc(base + 6 * ATOM + 32 * kk), desc(base + 7 * ATOM + 32 * kk));
    }
    wg_commit();
    wg_wait1();  // the previous k block's products are done: free its stage
    hold(c0);
    hold(c1);
    if (kb > 0) bar_arrive(&empty[(kb - 1) % STAGES]);
    if ((kb + 1) % FLUSH == 0 && kb + 1 < kblocks) {  // a k range done: its own sum
      wg_wait();
      hold(c0);
      hold(c1);
      flush(t0, c0);
      flush(t1, c1);
    }
  }
  wg_wait();
  hold(c0);
  hold(c1);
  flush(t0, c0);
  flush(t1, c1);

  const int r = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int gm = r + 8 * acc_hi(e), gn = n0 + acc_col(e, q4);
    if (gm >= a.M) continue;  // N is even: gn + 1 < N with gn
    if (EPI == EPI_RESIDUAL) {  // one f32 add, one rounding
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = gn + 64 * half;
        if (n >= a.N) continue;
        const float(&t)[32] = half ? t1 : t0;
        const float2 x = *reinterpret_cast<const float2*>(a.x + (size_t)gm * a.ldx + n);
        *reinterpret_cast<float2*>(a.outh + (size_t)gm * a.ldo + n) =
            make_float2(t[e] + x.x, t[e + 1] + x.y);
      }
    } else if (EPI == EPI_STORE) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = gn + 64 * half;
        if (n >= a.N) continue;
        const float(&t)[32] = half ? t1 : t0;
        *reinterpret_cast<float2*>(a.outh + (size_t)gm * a.ldo + n) = make_float2(t[e], t[e + 1]);
      }
    } else {  // act = a gelu(g), exact erf (gemm.cu's EPI_GEGLU), split
      if (gn >= a.N) continue;
      uint32_t h[2], l[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v = t0[e + u], g = t1[e + u];
        split(v * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f))), h[u], l[u]);
      }
      const size_t o = (size_t)gm * a.ldo + gn;
      *reinterpret_cast<float2*>(a.outh + o) =
          make_float2(__uint_as_float(h[0]), __uint_as_float(h[1]));
      *reinterpret_cast<float2*>(a.outl + o) =
          make_float2(__uint_as_float(l[0]), __uint_as_float(l[1]));
    }
  }
}

// x -> its TF32 hi and lo planes (tc32.cuh's split)
__global__ void tc32_split_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t h, l;
    split(x[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, cudaStream_t st, const Maps& maps, const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, SMEM, st>>>(maps, args);
  return cudaGetLastError();
}

bool fits(const void* const* ptrs, int n, const int* dims, int m) {
  bool ok = true;
  for (int i = 0; i < n; ++i) ok = ok && aligned16(ptrs[i]);
  for (int i = 0; i < m; ++i) ok = ok && dims[i] > 0 && dims[i] % 4 == 0;
  return ok;
}

}  // namespace

// x (n,) f32 -> hi, lo (n,) f32: the TF32 hi plane and the lo plane
CT_EXPORT int ct_tc32_split(const void* x, void* hi, void* lo, long long n, void* stream) {
  if (n <= 0 || !x || !hi || !lo) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  tc32_split_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(hi), static_cast<float*>(lo), n);
  return (int)cudaGetLastError();
}

// K3 f32's first product and GEGLU: xn hi, lo (M, K) with row stride ldx; wa
// hi, lo and wg hi, lo (N, K) with row stride ldw -> act hi, lo (M, N) with
// row stride ldact, all f32.  K, N and the strides multiples of 4, every
// base 16-byte aligned.
CT_EXPORT int ct_ff_tc32_geglu(const void* xh, const void* xl, int ldx, const void* wah,
                               const void* wal, const void* wgh, const void* wgl, int ldw, int M,
                               int N, int K, void* acth, void* actl, int ldact, void* stream) {
  const void* ptrs[] = {xh, xl, wah, wal, wgh, wgl, acth, actl};
  const int dims[] = {K, N, ldx, ldw, ldact};
  if (M <= 0 || !fits(ptrs, 8, dims, 5) || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!tensor_map(&maps.ah, xh, M, K, ldx, true) || !tensor_map(&maps.al, xl, M, K, ldx, true)
      || !tensor_map(&maps.b0h, wah, N, K, ldw, true)
      || !tensor_map(&maps.b0l, wal, N, K, ldw, true)
      || !tensor_map(&maps.b1h, wgh, N, K, ldw, true)
      || !tensor_map(&maps.b1l, wgl, N, K, ldw, true))
    return (int)cudaErrorInvalidValue;
  const Args a = {static_cast<float*>(acth), static_cast<float*>(actl), nullptr, M, N, K, ldact,
                  0};
  return (int)launch(ff_tc32_kernel<EPI_GEGLU>, dim3((N + 63) / 64, (M + BM - 1) / BM),
                     static_cast<cudaStream_t>(stream), maps, a);
}

// K3 f32's second product: out (M, N) = act (M, K) wo^T + x, act hi, lo with
// row stride lda, wo hi, lo (N, K) with row stride ldw, x and out (M, N) with
// row stride ldx, all f32.  K, N and the strides multiples of 4, every base
// 16-byte aligned.
CT_EXPORT int ct_ff_tc32_residual(const void* ah, const void* al, int lda, const void* woh,
                                  const void* wol, int ldw, int M, int N, int K, const void* x,
                                  void* out, int ldx, void* stream) {
  const void* ptrs[] = {ah, al, woh, wol, x, out};
  const int dims[] = {K, N, lda, ldw, ldx};
  if (M <= 0 || !fits(ptrs, 6, dims, 5) || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!tensor_map(&maps.ah, ah, M, K, lda, true) || !tensor_map(&maps.al, al, M, K, lda, true)
      || !tensor_map(&maps.b0h, woh, N, K, ldw, true)
      || !tensor_map(&maps.b0l, wol, N, K, ldw, true))
    return (int)cudaErrorInvalidValue;
  maps.b1h = maps.b0h;
  maps.b1l = maps.b0l;
  const Args a = {static_cast<float*>(out), nullptr, static_cast<const float*>(x), M, N, K, ldx,
                  ldx};
  return (int)launch(ff_tc32_kernel<EPI_RESIDUAL>, dim3((N + 127) / 128, (M + BM - 1) / BM),
                     static_cast<cudaStream_t>(stream), maps, a);
}

// out (M, N) = A (M, K) W^T in 3xTF32, A hi, lo with row stride lda, W hi, lo
// (N, K) with row stride ldw, out with row stride ldo, all f32 (K1 f32's q
// and kv products).  K, N and the strides multiples of 4, every base 16-byte
// aligned.
CT_EXPORT int ct_tc32_gemm(const void* ah, const void* al, int lda, const void* wh,
                           const void* wl, int ldw, int M, int N, int K, void* out, int ldo,
                           void* stream) {
  const void* ptrs[] = {ah, al, wh, wl, out};
  const int dims[] = {K, N, lda, ldw, ldo};
  if (M <= 0 || !fits(ptrs, 5, dims, 5) || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!tensor_map(&maps.ah, ah, M, K, lda, true) || !tensor_map(&maps.al, al, M, K, lda, true)
      || !tensor_map(&maps.b0h, wh, N, K, ldw, true)
      || !tensor_map(&maps.b0l, wl, N, K, ldw, true))
    return (int)cudaErrorInvalidValue;
  maps.b1h = maps.b0h;
  maps.b1l = maps.b0l;
  const Args a = {static_cast<float*>(out), nullptr, nullptr, M, N, K, ldo, 0};
  return (int)launch(ff_tc32_kernel<EPI_STORE>, dim3((N + 127) / 128, (M + BM - 1) / BM),
                     static_cast<cudaStream_t>(stream), maps, a);
}

// ===================================================== the f32 backwards
// K11 f32, the GEGLU feed-forward's backward, in 3xTF32 on the same
// machinery (the TMA producer warp, two consumer warpgroups, the three-stage
// ring, mma3_tf32, FLUSH ranges), and the weight-gradient ("TN") products of
// every f32 backward.
//
// Replaces, for f32 operands, ct_clip_tpu/ops/pallas/ffn.py::_pallas_ff_bwd
// (K11, :238, pallas_call :255, body _bwd_kernel :136-214), which takes
// "highest" precision for f32: LN again, a = xn wa, g = xn wg, dact = do wo^T,
// da = dact gelu(g), dg = dact a (Phi(g) + g phi(g)), dxn = da wa^T + dg
// wg^T, the LN backward, dwa / dwg = xn^T da / dg, dwo = act^T do, nothing
// rounded below f32.  gemm.cu's ff_bwd_kernel<float> and
// gemm_layout_f32_kernel ran it as FFMA tiles on the CUDA cores; they stay
// only as the card checks' timed twin.  Here (ops/ffn.py::_geglu_ff_bwd_tc32):
//   * ff_tc32_tile: one CTA per (128 rows, 64 inner columns) recomputes a and
//     g (xn against wa, wg) and then dact (dout against wo^T, (inner, dim):
//     K-major) in a second k loop through the same ring, three accumulators a
//     warpgroup, and writes, in f32 with the exact erf, the TF32 hi and lo
//     planes the products below read: dcat = [da | dg] row-major (rows, 2
//     inner) for the NN product, dcat^T (2 inner, rows) and act^T (inner,
//     rows) for the TN products.  No separate split pass over dcat.
//   * the NN product dxn = dcat [wa; wg] is ct_tc32_gemm with B the weights
//     split and transposed once per call (dim, 2 inner): K-major.
//   * the TN products ([dwa; dwg] = dcat^T xn and dwo = dout^T act, sums over
//     all rows) take K = the row axis.  TF32 `wgmma` reads its shared-memory
//     operands K-major only, and both operands of a weight gradient are
//     row-major (MN-major), so both are written transposed: the tile writes
//     dcat^T and act^T, tc32_split_t writes xn^T and dout^T (and transposes
//     the weights).  ct_tc32_gemm_tn then is the plain-store product on those
//     planes, the rows split in k ranges (blockIdx.z) whose partials
//     ct_sum_splits adds in order.  The transposed planes cost ~4.5 GB more
//     traffic at 110,592 rows (~1.4 ms at 3.35 TB/s) against the products'
//     7.5 ms bound.
// The same TN form takes K9 and K10 f32's dWq, dWkv and dWout, whose planes
// the short backward core (qknorm_attention_short.cu) or tc32_split_t write.
// Transposed planes may take the rows in another order than the tensor's,
// the same for both operands of a product (a weight gradient sums over the
// rows): tc32_split_t takes the rows of a (b, t, s) token grid in the order
// of its (b, s) t-columns, the order the short core writes.
//
// What bounds K11 f32 on the H100: the tensor cores.  At 110,592 rows x 512
// -> 1,368 (inner padded) it is eight products of R 512 1,368, 1.24 TFLOP,
// three TF32 products each: 7.5 ms at 495 TFLOP/s.

// 1 in a one-change copy for the card checks (kernels.copy_library): act
// rounded to bf16 in the tile, which the f32 comparisons must catch
#ifndef CT_FF_TC32_ACT_BF16
#define CT_FF_TC32_ACT_BF16 0
#endif

namespace {

// the backward kernel's forms (compile-time)
constexpr int BWD_TILE = 0, BWD_PART = 1;

// the first k loop's A and B's two 64-row tiles (tile: xn against wa, wg;
// part: A against W's rows n0.. and n0 + 64..), and the tile's second k
// loop's A (dout) and B (wo^T)
struct BwdMaps {
  CUtensorMap ah, al, b0h, b0l, b1h, b1l, ch, cl, dh, dl;
};
struct BwdArgs {
  float *dch, *dcl;  // tile: dcat hi, lo (M, 2N), row stride ldc; part: partials (dch)
  float *dth, *dtl;  // tile: dcat^T hi, lo (2N, ldt)
  float *ath, *atl;  // tile: act^T hi, lo (N, ldt)
  int M, N, K, ldc, ldt;
  int kchunk;              // part: K of a split, a multiple of KB
  long long split_stride;  // part: floats between two splits' partials
};

// One k block of a consumer warpgroup: wait for its stage, c0 (and with TWO
// c1) += A B in 3xTF32 (B's first 64-row tile, then its second), free the
// previous stage, and at the end of a k range (kb of kb1) add the range's
// sums into t0 (and t1).
template <bool TWO>
__device__ __forceinline__ void bwd_step(uint8_t* ring, uint64_t* full, uint64_t* empty, int it,
                                         int kb, int kb1, int wg, float (&c0)[32],
                                         float (&c1)[32], float (&t0)[32], float (&t1)[32]) {
  const int st = it % STAGES;
  const uint32_t base = saddr(ring + st * STAGE);
  const uint32_t ah = base + wg * ATOM, al = base + (CWG + wg) * ATOM;
  bar_wait(&full[st], (it / STAGES) & 1);
  hold(c0);
  hold(c1);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dah = desc(ah + 32 * kk), dal = desc(al + 32 * kk);
    mma3_tf32(c0, dah, dal, desc(base + 4 * ATOM + 32 * kk), desc(base + 5 * ATOM + 32 * kk));
    if (TWO)
      mma3_tf32(c1, dah, dal, desc(base + 6 * ATOM + 32 * kk), desc(base + 7 * ATOM + 32 * kk));
  }
  wg_commit();
  wg_wait1();  // the previous k block's products are done: free its stage
  hold(c0);
  hold(c1);
  if (it > 0) bar_arrive(&empty[(it - 1) % STAGES]);
  if ((kb + 1) % FLUSH == 0 || kb + 1 == kb1) {  // a k range done: its own sum
    wg_wait();
    hold(c0);
    hold(c1);
    flush(t0, c0);
    if (TWO) flush(t1, c1);
  }
}

// BWD_TILE (ff_tc32_tile): one CTA per (128 rows, 64 inner columns); BWD_PART
// (tc32_gemm_tn): one CTA per (128 rows, 128 columns, k range blockIdx.z).
template <int FORM>
__global__ void __launch_bounds__(NT, 1) ff_tc32_bwd_kernel(const __grid_constant__ BwdMaps maps,
                                                            BwdArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = align1024(smem_raw);
  const int n0 = blockIdx.x * (FORM == BWD_PART ? 128 : 64), m0 = blockIdx.y * BM;
  const int kbeg = FORM == BWD_PART ? blockIdx.z * a.kchunk : 0;
  const int kend = FORM == BWD_PART ? min(a.K, kbeg + a.kchunk) : a.K;
  const int kb1 = (kend - kbeg + KB - 1) / KB;  // k blocks of one loop
  const int total = FORM == BWD_TILE ? 2 * kb1 : kb1;
  init_ring<STAGES, 128 * CWG>(full, empty);

  if (threadIdx.x >= 128 * CWG) {  // the producer: one thread
    if (threadIdx.x != 128 * CWG) return;
    const int nb1 = FORM == BWD_PART ? n0 + 64 : n0;
    for (int it = 0; it < total; ++it) {
      const int st = it % STAGES;
      const bool first = FORM == BWD_PART || it < kb1;
      const int k0 = kbeg + (first ? it : it - kb1) * KB;
      if (it >= STAGES) bar_wait(&empty[st], (it / STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * STAGE);
      bar_expect(&full[st], first ? STAGE : 6 * ATOM);
      const CUtensorMap* mh = first ? &maps.ah : &maps.ch;
      const CUtensorMap* ml = first ? &maps.al : &maps.cl;
#pragma unroll
      for (int w = 0; w < CWG; ++w) {
        tma_load(dst + w * ATOM, mh, k0, m0 + 64 * w, &full[st]);
        tma_load(dst + (CWG + w) * ATOM, ml, k0, m0 + 64 * w, &full[st]);
      }
      if (first) {
        tma_load(dst + 4 * ATOM, &maps.b0h, k0, n0, &full[st]);
        tma_load(dst + 5 * ATOM, &maps.b0l, k0, n0, &full[st]);
        tma_load(dst + 6 * ATOM, &maps.b1h, k0, nb1, &full[st]);
        tma_load(dst + 7 * ATOM, &maps.b1l, k0, nb1, &full[st]);
      } else {
        tma_load(dst + 4 * ATOM, &maps.dh, k0, n0, &full[st]);
        tma_load(dst + 5 * ATOM, &maps.dl, k0, n0, &full[st]);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q4 = lane & 3;
  // c0, c1: the k range's sums; t0, t1 (and the tile's t2): the totals
  float c0[32], c1[32], t0[32], t1[32], t2[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) c0[e] = c1[e] = t0[e] = t1[e] = t2[e] = 0.0f;
  // two loops, not one with a branch around the second product: a
  // `wgmma` under a divergent branch is serialized
  for (int it = 0; it < kb1; ++it)
    bwd_step<true>(ring, full, empty, it, it, kb1, wg, c0, c1, t0, t1);
  if (FORM == BWD_TILE)
    for (int it = kb1; it < total; ++it)
      bwd_step<false>(ring, full, empty, it, it - kb1, kb1, wg, c0, c1, t2, t1);

  const int r = m0 + 64 * wg + 16 * warp + (lane >> 2);
  if (FORM == BWD_PART) {
    float* out = a.dch + blockIdx.z * a.split_stride;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int gm = r + 8 * acc_hi(e), gn = n0 + acc_col(e, q4);
      if (gm >= a.M) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = gn + 64 * half;
        if (n >= a.N) continue;  // N is even: n + 1 < N with n
        const float(&t)[32] = half ? t1 : t0;
        *reinterpret_cast<float2*>(out + (size_t)gm * a.ldc + n) = make_float2(t[e], t[e + 1]);
      }
    }
    return;
  }
  // the tile: act, da, dg in f32 with the exact erf (gemm.cu's ff_bwd_kernel),
  // each written split
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int gm = r + 8 * acc_hi(e), gn = n0 + acc_col(e, q4);
    if (gm >= a.M || gn >= a.N) continue;  // N is a multiple of 4: gn + 1 < N with gn
    uint32_t xh[2], xl[2], dah[2], dal[2], dgh[2], dgl[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float av = t0[e + u], g = t1[e + u], dact = t2[e + u];
      const float phi = 0.5f * (1.0f + erff(g * 0.70710678118654752f));
      const float gelu = g * phi;
      const float pdf = expf(-0.5f * g * g) * 0.3989422804014327f;
      const float act = CT_FF_TC32_ACT_BF16 ? round_bf16(av * gelu) : av * gelu;
      split(act, xh[u], xl[u]);
      split(dact * gelu, dah[u], dal[u]);
      split(dact * av * (phi + g * pdf), dgh[u], dgl[u]);
    }
    const size_t o = (size_t)gm * a.ldc + gn;
    *reinterpret_cast<float2*>(a.dch + o) = make_float2(__uint_as_float(dah[0]), __uint_as_float(dah[1]));
    *reinterpret_cast<float2*>(a.dcl + o) = make_float2(__uint_as_float(dal[0]), __uint_as_float(dal[1]));
    *reinterpret_cast<float2*>(a.dch + o + a.N) =
        make_float2(__uint_as_float(dgh[0]), __uint_as_float(dgh[1]));
    *reinterpret_cast<float2*>(a.dcl + o + a.N) =
        make_float2(__uint_as_float(dgl[0]), __uint_as_float(dgl[1]));
    // transposed: for one column the eight rows of a quad's lanes are 32
    // contiguous bytes, one whole sector a store
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const size_t ta = (size_t)(gn + u) * a.ldt + gm, tg = (size_t)(a.N + gn + u) * a.ldt + gm;
      a.dth[ta] = __uint_as_float(dah[u]);
      a.dtl[ta] = __uint_as_float(dal[u]);
      a.dth[tg] = __uint_as_float(dgh[u]);
      a.dtl[tg] = __uint_as_float(dgl[u]);
      a.ath[ta] = __uint_as_float(xh[u]);
      a.atl[ta] = __uint_as_float(xl[u]);
    }
  }
}

// x (rows, cols) [+ x2], row stride ldx -> its TF32 hi and lo planes, row-
// major (rows, cols) when hi is given, and transposed (cols, ldt): transposed
// column c holds row (b n + t) S + s for c = (b S + s) n + t, the t-columns of
// a (b, n, S) token grid one after another (S = 1: the rows in order).  A
// block stages 32 rows x 32 columns through shared memory, so the reads and
// the transposed writes are both 128-byte rows.  x + x2 is exact where x2 is
// the lo plane of x's split (hi + lo = the f32 value): the split is the same.
__global__ void tc32_split_t_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                                    int rows, int cols, int ldx, int n, int S,
                                    float* __restrict__ hi, float* __restrict__ lo,
                                    float* __restrict__ hit, float* __restrict__ lot, int ldt) {
  __shared__ float th[32][33], tl[32][33];
  const int c0 = blockIdx.y * 32, f0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, f = f0 + tx;
    uint32_t h = 0u, l = 0u;
    if (c < rows && f < cols) {
      const int sq = c / n, t = c - sq * n;
      const size_t r = ((size_t)(sq / S) * n + t) * S + sq % S;
      const float v = x2 ? x[r * ldx + f] + x2[r * ldx + f] : x[r * ldx + f];
      split(v, h, l);
      if (hi) {
        hi[r * cols + f] = __uint_as_float(h);
        lo[r * cols + f] = __uint_as_float(l);
      }
    }
    th[i][tx] = __uint_as_float(h);
    tl[i][tx] = __uint_as_float(l);
  }
  __syncthreads();
#pragma unroll
  for (int j = ty; j < 32; j += 8) {
    const int f = f0 + j, c = c0 + tx;
    if (f < cols && c < rows) {
      hit[(size_t)f * ldt + c] = th[tx][j];
      lot[(size_t)f * ldt + c] = tl[tx][j];
    }
  }
}

template <typename Kern>
cudaError_t launch_bwd(Kern kernel, dim3 grid, cudaStream_t st, const BwdMaps& maps,
                       const BwdArgs& args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, SMEM, st>>>(maps, args);
  return cudaGetLastError();
}

}  // namespace

// x (rows, cols) f32 with row stride ldx [+ x2, the same layout, or null] ->
// hi, lo (rows, cols) row-major (or null) and hit, lot (cols, ldt): the TF32
// planes, transposed with the rows in the t-column order of a (b, n, S) grid
// (n = S = 1: in order).  ldt >= rows and ldx multiples of 4 (16-byte rows).
CT_EXPORT int ct_tc32_split_t(const void* x, const void* x2, int rows, int cols, int ldx, int n,
                              int S, void* hi, void* lo, void* hit, void* lot, int ldt,
                              void* stream) {
  if (rows <= 0 || cols <= 0 || n <= 0 || S <= 0 || rows % (n * S) || ldx < cols
      || ldt < rows || !x || !hit || !lot || (!hi) != (!lo) || (rows + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((cols + 31) / 32, (rows + 31) / 32);
  tc32_split_t_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(x2), rows, cols, ldx, n, S,
      static_cast<float*>(hi), static_cast<float*>(lo), static_cast<float*>(hit),
      static_cast<float*>(lot), ldt);
  return (int)cudaGetLastError();
}

// K11 f32's tile: xn hi, lo and dout hi, lo (M, K) with row stride ldx; wa,
// wg and woT hi, lo (N, K) with row stride ldw (woT = wo^T, the inner width
// N padded with zero rows) -> dcat hi, lo (M, 2N) = [da | dg] row-major, and
// dcat^T hi, lo (2N, ldt) and act^T hi, lo (N, ldt), all f32 TF32 planes.
// K, N, the strides and ldt multiples of 4, every base 16-byte aligned.
CT_EXPORT int ct_ff_tc32_tile(const void* xh, const void* xl, const void* dh, const void* dl,
                              int ldx, const void* wah, const void* wal, const void* wgh,
                              const void* wgl, const void* woh, const void* wol, int ldw, int M,
                              int N, int K, void* dch, void* dcl, void* dth, void* dtl, void* ath,
                              void* atl, int ldt, void* stream) {
  const void* ptrs[] = {xh, xl, dh, dl, wah, wal, wgh, wgl, woh, wol, dch, dcl, dth, dtl, ath, atl};
  const int dims[] = {K, N, ldx, ldw, ldt};
  if (M <= 0 || ldt < M || !fits(ptrs, 16, dims, 5) || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  BwdMaps maps;
  if (!tensor_map(&maps.ah, xh, M, K, ldx, true) || !tensor_map(&maps.al, xl, M, K, ldx, true)
      || !tensor_map(&maps.b0h, wah, N, K, ldw, true)
      || !tensor_map(&maps.b0l, wal, N, K, ldw, true)
      || !tensor_map(&maps.b1h, wgh, N, K, ldw, true)
      || !tensor_map(&maps.b1l, wgl, N, K, ldw, true)
      || !tensor_map(&maps.ch, dh, M, K, ldx, true) || !tensor_map(&maps.cl, dl, M, K, ldx, true)
      || !tensor_map(&maps.dh, woh, N, K, ldw, true)
      || !tensor_map(&maps.dl, wol, N, K, ldw, true))
    return (int)cudaErrorInvalidValue;
  BwdArgs a = {};
  a.dch = static_cast<float*>(dch);
  a.dcl = static_cast<float*>(dcl);
  a.dth = static_cast<float*>(dth);
  a.dtl = static_cast<float*>(dtl);
  a.ath = static_cast<float*>(ath);
  a.atl = static_cast<float*>(atl);
  a.M = M; a.N = N; a.K = K; a.ldc = 2 * N; a.ldt = ldt;
  return (int)launch_bwd(ff_tc32_bwd_kernel<BWD_TILE>, dim3((N + 63) / 64, (M + BM - 1) / BM),
                         static_cast<cudaStream_t>(stream), maps, a);
}

// The TN form: part (splits, M, N), split z = sum over k in [z kchunk, (z +
// 1) kchunk) of A[:, k] W[:, k]^T, in 3xTF32, for A hi, lo (M, K) with row
// stride lda and W hi, lo (N, K) with row stride ldw: transposed planes,
// whose K is the rows of the weight gradient's operands.  kchunk a multiple
// of 256 (whole FLUSH ranges), M, N, the strides multiples of 4, every base
// 16-byte aligned.
CT_EXPORT int ct_tc32_gemm_tn(const void* ah, const void* al, int lda, const void* wh,
                              const void* wl, int ldw, int M, int N, int K, int kchunk,
                              void* part, void* stream) {
  const void* ptrs[] = {ah, al, wh, wl, part};
  const int dims[] = {M, N, lda, ldw};
  if (K <= 0 || kchunk <= 0 || kchunk % (KB * FLUSH) || lda < K || ldw < K
      || !fits(ptrs, 5, dims, 4) || (M + BM - 1) / BM > 65535 || (K + kchunk - 1) / kchunk > 65535)
    return (int)cudaErrorInvalidValue;
  BwdMaps maps = {};
  if (!tensor_map(&maps.ah, ah, M, K, lda, true) || !tensor_map(&maps.al, al, M, K, lda, true)
      || !tensor_map(&maps.b0h, wh, N, K, ldw, true)
      || !tensor_map(&maps.b0l, wl, N, K, ldw, true))
    return (int)cudaErrorInvalidValue;
  maps.b1h = maps.b0h;
  maps.b1l = maps.b0l;
  BwdArgs a = {};
  a.dch = static_cast<float*>(part);
  a.M = M; a.N = N; a.K = K; a.ldc = N; a.kchunk = kchunk;
  a.split_stride = (long long)M * N;
  return (int)launch_bwd(ff_tc32_bwd_kernel<BWD_PART>,
                         dim3((N + 127) / 128, (M + BM - 1) / BM, (K + kchunk - 1) / kchunk),
                         static_cast<cudaStream_t>(stream), maps, a);
}
