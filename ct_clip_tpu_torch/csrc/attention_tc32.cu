// attention_tc32.cu — f32 attention at head dim 64 on the Hopper tensor
// cores, forward and backward, each product as three TF32 products (3xTF32).
//
// Replaces these TPU kernels of ct_clip_tpu/ops/pallas/attention.py in f32:
//   * _pallas_attention (K7, :129; pallas_call :143 key bias, body
//     _kernel_kbias :103; :149 no bias, _kernel :91; :157 dense bias,
//     _kernel_bias :116): out = softmax(q k^T + bias) v and the row
//     log-sum-exp (b, h, n) the backward reads.  RadBERT's inference and
//     validation run the key-bias form at (32, 12, 512, 64), MaskGIT the
//     dense (1, 8, n, n) CPB form at (8, 8, 1280, 64), its TokenCritic the
//     no-bias form, T5 the dense form at (8, 12, 256, 64) -> tc32_fwd<KEY |
//     DENSE | NONE, false>;
//   * _pallas_attention_kbias_drop_impl (K13a, :474; pallas_call :490, body
//     _kernel_kbias_drop :411): the key-bias forward with K13's dropout mask
//     on the probabilities.  RadBERT's default step and f32 CT-CLIP training
//     run it at (32, 12, 512, 64), rate 0.1 -> tc32_fwd<KEY, true>;
//   * _pallas_attention_bwd_kbias (K12a, :271; pallas_call :286, body
//     _bwd_kernel_kbias :228-268): dq, dk, dv and dkey_bias (b, n), the last
//     summed over the heads in order and over the query rows, of
//     softmax(q k^T + key_bias) v.  RadBERT with attention dropout 0 runs it
//     at (32, 12, 512, 64) -> tc32_rows<KEY, false>, tc32_cols<KEY, false>,
//     tc32_dkb;
//   * _pallas_attention_kbias_drop_bwd (K13b, :499; pallas_call :516, body
//     _bwd_kernel_kbias_drop :430-471): the same with K13's dropout mask M
//     regenerated (dS = P (dP M - D), dv from (P M)^T dO).  RadBERT's default
//     step runs it at (32, 12, 512, 64), rate 0.1 -> <KEY, true>;
//   * _pallas_attention_bwd (K12b, :301; pallas_call :318, body
//     _bwd_kernel_bias :167-212): dq, dk, dv and dbias for a dense (1|h, n,
//     n) bias, summed over the batch (and the heads for a one-head bias), in
//     a fixed order, heads outer and batch inner.  MaskGIT runs it at (8, 8,
//     1280, 64) with the per-head CPB bias, T5 at (8, 12, 256, 64) ->
//     <DENSE, false>, tc32_dbias.  The same passes with no bias and no dbias
//     are MaskGIT's TokenCritic backward, which the JAX package runs in XLA
//     (`_fused_bwd`, :357-381) -> <NONE, false>.
// The TPU runs these f32 products at Precision.HIGHEST (ops/pallas/
// _call.py:50-61), several bf16 passes on its matrix unit; 3xTF32 is the
// H100's counterpart: each f32 operand x splits into hi = tf32(x) (round to
// nearest, ties away, 10 mantissa bits) and lo = x - hi (read as TF32,
// truncated), and A B ~ hi hi + hi lo + lo hi, accumulated in f32 (lo lo,
// ~2^-22 of the product, is dropped).  Everything else stays f32: P, dP, dS,
// the softmax (libm expf), the mask and the sums.  Built with
// CT_TC32_PASSES=1 the file runs hi hi alone, plain TF32: the copy the card
// checks hold it against to show that the tolerance tells the two apart.
//
// What bounds it on the H100.  The forward at (32, 12, 512, 64) runs two
// products of 12.88 GFLOP, 77.3 GFLOP as TF32 (0.156 ms at 495 TFLOP/s),
// against 201 MB of q, k, v and out (0.060 ms at 3.35 TB/s): the tensor
// cores bound it (on the f32 CUDA cores the same products take 0.385 ms at
// 67 TFLOP/s); at T5's (8, 12, 256, 64) the products take 0.010 ms and
// memory and the launch set the time.  K12a at (32, 12, 512, 64) moves 352
// MB of q, k, v, dO, dq, dk, dv (0.105 ms) and runs five products of
// 12.88 GFLOP, 193 GFLOP as TF32 (0.390 ms), so the tensor cores bound it;
// on the f32 CUDA cores the same five products take 0.962 ms.  K13b adds the
// draws: 25.2 M Philox calls of ~80 integer operations in the row pass and
// as many in the column pass.  K12b at (8, 8, 1280, 64) runs five products
// of 13.42 GFLOP (0.407 ms as TF32) and, for dbias, writes and reads a (b,
// h, n, n) f32 dS scratch (419 MB each way, ~0.25 ms).  The backward's
// layout runs seven products (S and dP twice), plus the split: 3 ALU
// operations per operand element read, and every warp splits the whole K/V
// (Q/dO) tile it reads.  Measured (tools/port_attention_tc_probe.py,
// kernel-only, NVIDIA H100 80GB HBM3 at 700 W): see PERF.md; mma.sync at
// m16n8k8 reaches well under the TF32 peak, and the split's ALU work
// competes with it for issue slots.
//
// Design, FA2's deterministic shape as in attention_tc.cu:
//   * Forward (one CTA per 64-query tile and (b, h)): Q is split into its
//     hi/lo fragments once and held in registers; K, V and the key bias
//     stream through two cp.async stages.  S = Q K^T runs in the same
//     fragment order over the head dim as the backward's row pass, so its S
//     (and the forward's lse) is bit-identical to the S that pass
//     recomputes: the backward's P rows sum to 1 up to expf.  An online
//     softmax in f32 (libm expf) per accumulator row, reduced over the four
//     lanes that share it; the running max is -inf only before the first
//     key tile, so an f32-min pad bias gives exp(-3.4e38 - m) = 0 and a row
//     whose keys are all padded attends uniformly, as the plain softmax
//     does.  With dropout P is multiplied by K13's mask (row_keep_bits, the
//     bits K13b regenerates) and the sum runs over every key.  O += P V
//     takes P from the accumulators with no shuffle (below), each key tile's
//     share in its own accumulator, the running O scaled by the max's
//     correction before the flush; out = O / l in f32 with q's strides, lse
//     = m + log l.
//   * D_i = sum_c dO_ic O_ic from the forward's f32 output (with dropout O =
//     (P M) V, so this is sum_j P_ij M_ij dP_ij, the TPU kernel's row sum),
//     summed by the row pass before its sweep: one sweep over the key
//     tiles, not two.  O comes out of the 3xTF32 forward above, not out of
//     true f32 products: the dense form's dbias rows, whose zero sum D_i
//     shifts, are what the card check holds to 16x the plain f32 version's
//     rounding.
//   * Row pass (one CTA per 64-query tile and (b, h)): S = Q K^T, dP =
//     dO V^T, P = exp(S + bias - lse), dS = P (dP M - D), dq += dS K, and
//     for dbias each (b, h)'s dS into the scratch.  Column pass (one CTA per
//     64-key tile and (b, h)): S^T = K Q^T, dP^T = V dO^T, dv += (P M)^T dO,
//     dk += dS^T Q, and the row sums of dS^T, this head's share of
//     dkey_bias, into a (b, h, n) scratch that tc32_dkb adds over the heads
//     in order; tc32_dbias adds the dS scratch over the batch in a fixed
//     order.  No atomics: every output is bit-identical from run to run.
//   * A CTA is 4 warps, 16 rows each.  Products are mma.sync m16n8k8 TF32
//     with f32 accumulators (`wgmma` takes TF32 operands only K-major from
//     shared memory, and dq, dk, dv contract over tokens).  Tiles arrive raw
//     in f32 through cp.async (all threads, two stages for the streamed
//     tiles), rows padded to 68 floats, and each fragment is split in
//     registers as it is read: every read pattern below hits 32 distinct
//     banks, and a transposed operand is only another index.
//   * dS (and P) go from the accumulators into the next product's A operand
//     with no shuffle: an m16n8 accumulator holds columns 2t and 2t + 1 of
//     its rows (t = lane % 4) where an A operand holds columns t and t + 4,
//     so the contraction index is permuted, logical t <-> token 2t and t + 4
//     <-> 2t + 1, in A and in B alike (the sum is the same in any order).
//   * Forms are compile-time (FORM: KEY, DENSE or NONE; DROP), so each form
//     carries none of another's work and K12a's kernels are the code they
//     were before the other forms existed.
//   * The dense bias is read from device memory straight into the
//     accumulator layout (each thread its 32 values of the tile, loaded
//     before the tile's products so they arrive under them): a staged 64 x
//     68 f32 tile would take the shared memory of the second CTA on the SM.
//     A warp's reads cover 32-byte sectors whole, along keys in the forward
//     and the row pass and, transposed, in the column pass.  The dense form
//     walks the heads outer (grid row h B + b), so the batch rows that read
//     one bias tile run together and find it in L2 (MaskGIT's per-head bias
//     is 52 MB, above the 50 MB L2).
//   * Dropout (K13's Philox bits, common.cuh): the forward and the row pass
//     hold the wgmma-like row layout, so they draw with row_keep_bits, one
//     call per four elements; in the column pass a thread's keys are rows
//     and four lanes need words of one call, so the CTA first draws the
//     tile's 64 x 64 keep bits into shared memory (a 32-key half of one
//     query row per thread: 8 calls) and every thread reads one word per
//     query it holds.
#include "common.cuh"

#ifndef CT_TC32_PASSES
#define CT_TC32_PASSES 3  // 3: hi hi + hi lo + lo hi; 1: hi hi alone (plain TF32)
#endif

namespace {

constexpr int TILE = 64;                  // query or key rows per tile
constexpr int LD = 68;                    // floats per staged row (64 + 4)
constexpr int TILE_FLOATS = TILE * LD;
constexpr int NT = 128;                   // 4 warps of 16 rows
// bias forms: a per-key (b, n) bias (K12a, K13b), a dense (1|h, n, n) bias
// (K12b), none (K12b without a bias)
enum Form : int { NONE, KEY, DENSE };

// Element strides (batch, head, token) of one (b, h, n, 64) view.
struct View { long long sb, sh, st; };

__device__ __forceinline__ size_t at(const View& v, int b, int h, int t) {
  return (size_t)b * v.sb + (size_t)h * v.sh + (size_t)t * v.st;
}

struct Args {
  const float *q, *k, *v, *out, *dout;
  float *dq, *dk, *dv;
  View vq, vk, vv, vo, vdo, vdq, vdk, vdv;
  const float* key_bias;    // (b, n)
  const float* lse;         // (b, h, n) from the forward
  float* rowsum;            // (b, h, n) D_i: written by the row pass, read by the columns
  float* dkb_head;          // (b, h, n) each head's share of dkey_bias, or null
  float* dkb;               // (b, n) dkey_bias, or null
  int B, H, n;
  // after the key-bias form's fields, so that its kernels read theirs where
  // they always did
  const float* bias;        // (bias_heads, n, n) dense bias (DENSE)
  int bias_heads;
  float* ds;                // (b, h, n, n) dS scratch for dbias, or null (DENSE)
  float* dbias;             // (bias_heads, n, n), or null
  const long long* seed;    // (1,) Philox key in device memory (DROP)
  uint32_t thresh;          // keep iff bits >= thresh
  float keep_scale;         // 1 / (1 - rate)
  // the forward's outputs, after the backward's fields so that its kernels
  // read theirs where they always did
  float* fwd_out;           // (b, h, n, 64) through the view vo
  float* fwd_lse;           // (b, h, n)
};

// The grid row of (b, h): b H + h, or for the dense form h B + b (the heads
// outer, so the batch rows that read one bias tile run together).
template <int FORM>
__device__ __forceinline__ int grid_bh(const Args& a) {
  return FORM == DENSE ? (int)(blockIdx.y % a.B) * a.H + (int)(blockIdx.y / a.B)
                       : (int)blockIdx.y;
}

// This thread's 32 dense-bias values of the (rows, columns) tile of head h
// in its accumulator layout, element [nb][e] at row rows0 + g + 8 (e >> 1),
// column cols0 + 8 nb + 2 t + (e & 1); `transposed`: rows are keys and
// columns queries (the column pass).  Zero outside the (n, n) square.
__device__ __forceinline__ void load_bias(float (&x)[8][4], const Args& a, int h, int rows0,
                                          int cols0, int g, int t, bool transposed) {
  const int n = a.n;
  const float* bias = a.bias + (size_t)(a.bias_heads > 1 ? h : 0) * n * n;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rows0 + g + 8 * (e >> 1), c = cols0 + 8 * nb + 2 * t + (e & 1);
      const int i = transposed ? c : r, j = transposed ? r : c;
      x[nb][e] = i < n && j < n ? __ldg(bias + (size_t)i * n + j) : 0.0f;
    }
}

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; bytes past `src_bytes` are zero
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's groups are in flight
template <int pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// x = hi + lo as TF32 operands: hi is x rounded to 10 mantissa bits, to
// nearest with ties away from zero (cvt.rna.tf32.f32's result, in two
// integer operations: cvt runs on the conversion unit at a fraction of their
// rate, and two per element cost the kernel ~25% on the card); lo = x - hi
// is exact in f32, and the tensor core reads a TF32 operand from the top 19
// bits of its register, so lo enters truncated (|error| < 2^-22 |x|, the
// order of the lo lo term 3xTF32 drops).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = CT_TC32_PASSES == 3 ? __float_as_uint(x - __uint_as_float(hi)) : 0u;
}

// d += A B: m16 n8 k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (CT_TC32_PASSES == 3) {
    mma(d, al, bh);
    mma(d, ah, bl);
  }
  mma(d, ah, bh);
}

// ---------------------------------------------------------- fragments
// Lane = 4 g + t.  A (m16 x k8) holds (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); B (k8 x n8) holds (t, g), (t + 4, g); an accumulator (m16 x n8)
// holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

// A from rows r0.. of a staged tile, columns 8 kk..: Q of S = Q K^T
__device__ __forceinline__ void frag_a(const float* s, int r0, int kk, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = s + (r0 + g) * LD + 8 * kk + t;
  const float x[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// A from the accumulator block c (columns 8 kk..) in the permuted order
__device__ __forceinline__ void frag_acc(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// B[k][n] = T[8 nb + n][8 kk + k] of a staged tile T: K of S = Q K^T
__device__ __forceinline__ void frag_bt(const float* s, int nb, int kk, int g, int t,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = s + (8 * nb + g) * LD + 8 * kk + t;
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// B[k][n] = T[8 kk + k][8 nb + n] with k in the accumulator's permuted
// order (logical t is row 2t, t + 4 row 2t + 1): K of dq = dS K
__device__ __forceinline__ void frag_bn(const float* s, int nb, int kk, int g, int t,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = s + (8 * kk + 2 * t) * LD + 8 * nb + g;
  split(p[0], hi[0], lo[0]);
  split(p[LD], hi[1], lo[1]);
}

// A tensor-core accumulator loses precision at every mma (its f32 sum is
// not rounded as an FMA chain's is), relative to the running sum: over a
// 512-token contraction (64 chunks x 3 products) that drift reached 1.1e-5
// of max|dk| on the card.
// So each 64-token tile's share of dq, dk, dv sums in an accumulator of its
// own (8 chunks x 3 products), added to the running sum in f32 here.
__device__ __forceinline__ void flush(float (&sum)[8][4], const float (&part)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[nb][e] += part[nb][e];
}

// sum += A T over one 64-token tile: A the accumulator tile `a` (rows x
// tokens) in the permuted order, T the staged (token, 64) tile
__device__ __forceinline__ void tile_product(float (&sum)[8][4], const float (&a)[8][4],
                                             const float* T, int g, int t) {
  float part[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[nb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {  // over the tokens
    uint32_t ah[4], al[4];
    frag_acc(a[kk], ah, al);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {  // over the head dim
      uint32_t bh[2], bl[2];
      frag_bn(T, nb, kk, g, t, bh, bl);
      mma3(part[nb], ah, al, bh, bl);
    }
  }
  flush(sum, part);
}

// --------------------------------------------------------------- loads
// rows [r0, r0 + 64) x 64 f32 of a (token, 64) view at `base` (token stride
// st) -> dst (LD floats per row); rows at n and beyond are zero
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long st, int r0,
                                          int n) {
  const uint32_t d = saddr(dst);
#pragma unroll 4
  for (int e = threadIdx.x; e < TILE * 16; e += NT) {
    const int r = e >> 4, c = e & 15, tok = r0 + r;
    const bool ok = tok < n;
    cp16(d + (r * LD + 4 * c) * 4, base + (ok ? (long long)tok * st : 0) + 4 * c, ok ? 16 : 0);
  }
}

// v[t0 + e], e < 64, -> dst; zero past n
__device__ __forceinline__ void load_vec(float* dst, const float* v, int t0, int n) {
  if (threadIdx.x < TILE) {
    const int t = t0 + threadIdx.x;
    cp4(saddr(dst + threadIdx.x), v + (t < n ? t : 0), t < n ? 4 : 0);
  }
}

__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// P of one score: exp(s + bias - lse), 0 outside the (n, n) square.  The
// difference is taken first: an f32-min pad bias gives exp(-3.4e38) = 0.
__device__ __forceinline__ float prob(float s, float bias, float lse, bool ok) {
  return ok ? expf(s + bias - lse) : 0.0f;
}

// ----------------------------------------------------------------- forward
// Shared memory: Q, then 2 x K, 2 x V, 2 x the key bias (64 floats): 87.5
// KB, two CTAs per SM.
constexpr size_t FWD_SMEM = (5 * TILE_FLOATS + 2 * TILE) * sizeof(float);

template <int FORM, bool DROP>
__global__ void __launch_bounds__(NT, 2) tc32_fwd(Args a) {
  constexpr bool KBIAS = FORM == KEY;
  extern __shared__ __align__(16) float sm[];
  float* sq = sm;
  float* sk = sq + TILE_FLOATS;          // stage s at sk + s * TILE_FLOATS
  float* sv = sk + 2 * TILE_FLOATS;
  float* skb = sv + 2 * TILE_FLOATS;     // stage s at skb + s * TILE
  const int i0 = blockIdx.x * TILE, bh = grid_bh<FORM>(a), b = bh / a.H, h = bh % a.H, n = a.n;
  const int tiles = (n + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows; a thread's are r0 + g and + 8

  auto stage = [&](int tile) {
    const int s = tile & 1, j0 = tile * TILE;
    load_tile(sk + s * TILE_FLOATS, a.k + at(a.vk, b, h, 0), a.vk.st, j0, n);
    load_tile(sv + s * TILE_FLOATS, a.v + at(a.vv, b, h, 0), a.vv.st, j0, n);
    if (KBIAS) load_vec(skb + s * TILE, a.key_bias + (size_t)b * n, j0, n);
  };
  load_tile(sq, a.q + at(a.vq, b, h, 0), a.vq.st, i0, n);
  cp_commit();
  stage(0);
  cp_commit();
  uint32_t k0 = 0, k1 = 0;
  if (DROP) seed_key(a.seed, a.thresh, k0, k1);
  float o[8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.0f;
  cp_wait<1>();  // Q
  __syncthreads();
  // Q's A fragments over the head dim, split once for the whole key sweep
  uint32_t qh[8][4], ql[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) frag_a(sq, r0, kk, g, t, qh[kk], ql[kk]);

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      stage(tile + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = tile * TILE;
    const float* K = sk + (tile & 1) * TILE_FLOATS;
    const float* V = sv + (tile & 1) * TILE_FLOATS;
    const float* kb = skb + (tile & 1) * TILE;
    float bias[8][4];  // DENSE: issued here, read after the products
    if (FORM == DENSE) load_bias(bias, a, h, i0 + r0, j0, g, t, false);
    // the keep bits of element [nb][e] at bit 4 nb + e (common.cuh), drawn
    // among the products
    const uint32_t kept = DROP ? row_keep_bits(b, h, i0 + r0 + g, j0, t, k0, k1, a.thresh) : 0u;
    // S = Q K^T in the row pass's order (tc32_rows), so the same S
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // over the head dim
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {  // over the keys
        uint32_t bh_[2], bl[2];
        frag_bt(K, nb, kk, g, t, bh_, bl);
        mma3(s[nb], qh[kk], ql[kk], bh_, bl);
      }
    }
    // the scores as the row pass's prob() adds the bias; keys at n and
    // beyond -inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, col = 8 * nb + 2 * t + (e & 1);
        const float x = s[nb][e] + (KBIAS ? kb[col] : FORM == DENSE ? bias[nb][e] : 0.0f);
        s[nb][e] = j0 + col < n ? x : -INFINITY;
        mx[hi] = fmaxf(mx[hi], s[nb][e]);
      }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      // key j0 < n lies in this tile, so the new max is finite
      const float mn = fmaxf(m[hi], max4(mx[hi]));
      corr[hi] = expf(m[hi] - mn);  // 0 before the first tile
      m[hi] = mn;
      l[hi] *= corr[hi];
    }
    // P, its sum over every key (kept or not), then P M in place of S
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const float p = expf(s[nb][e] - m[hi]);
        l[hi] += p;
        s[nb][e] = masked<DROP>(p, kept, 4 * nb + e, a.keep_scale);
        o[nb][e] *= corr[hi];
      }
    // O += (P M) V, over the keys, the tile's share in its own accumulator
    tile_product(o, s, V, g, t);
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = i0 + r0 + g + 8 * hi;
    const float sum = sum4(l[hi]);  // every lane: the shuffles
    if (i >= n) continue;
    const float inv = 1.0f / sum;
    float* out = a.fwd_out + at(a.vo, b, h, i);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<float2*>(out + 8 * nb + 2 * t) =
          make_float2(o[nb][2 * hi] * inv, o[nb][2 * hi + 1] * inv);
    if (t == 0) a.fwd_lse[(size_t)bh * n + i] = m[hi] + logf(sum);
  }
}

// ---------------------------------------------------------------- row pass
// Shared memory: Q, dO, then 2 x K, 2 x V, 2 x the key bias (64 floats), D.
constexpr size_t ROWS_SMEM = (6 * TILE_FLOATS + 3 * TILE) * sizeof(float);

template <int FORM, bool DROP>
__global__ void __launch_bounds__(NT, 2) tc32_rows(Args a) {
  constexpr bool KBIAS = FORM == KEY;
  extern __shared__ __align__(16) float sm[];
  float* sq = sm;
  float* sdo = sq + TILE_FLOATS;
  float* sk = sdo + TILE_FLOATS;         // stage s at sk + s * TILE_FLOATS
  float* sv = sk + 2 * TILE_FLOATS;
  float* skb = sv + 2 * TILE_FLOATS;     // stage s at skb + s * TILE
  float* sD = skb + 2 * TILE;
  const int i0 = blockIdx.x * TILE, bh = grid_bh<FORM>(a), b = bh / a.H, h = bh % a.H, n = a.n;
  const int tiles = (n + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows; a thread's are r0 + g and + 8

  auto stage = [&](int tile) {
    const int s = tile & 1, j0 = tile * TILE;
    load_tile(sk + s * TILE_FLOATS, a.k + at(a.vk, b, h, 0), a.vk.st, j0, n);
    load_tile(sv + s * TILE_FLOATS, a.v + at(a.vv, b, h, 0), a.vv.st, j0, n);
    if (KBIAS) load_vec(skb + s * TILE, a.key_bias + (size_t)b * n, j0, n);
  };
  load_tile(sq, a.q + at(a.vq, b, h, 0), a.vq.st, i0, n);
  load_tile(sdo, a.dout + at(a.vdo, b, h, 0), a.vdo.st, i0, n);
  stage(0);
  cp_commit();

  {  // D_i = sum_c dO_ic O_ic from the forward's f32 output, two threads a row
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, i = i0 + r;
    float d = 0.0f;
    if (i < n) {
      const float4* o = reinterpret_cast<const float4*>(a.out + at(a.vo, b, h, i) + 32 * half);
      const float4* go = reinterpret_cast<const float4*>(a.dout + at(a.vdo, b, h, i) + 32 * half);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 x = o[c], y = go[c];
        d = fmaf(x.x, y.x, d);
        d = fmaf(x.y, y.y, d);
        d = fmaf(x.z, y.z, d);
        d = fmaf(x.w, y.w, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (!half) {
      sD[r] = d;
      if (i < n) a.rowsum[(size_t)bh * n + i] = d;
    }
  }
  float lse[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) lse[hi] = a.lse[(size_t)bh * n + min(i0 + r0 + g + 8 * hi, n - 1)];
  uint32_t k0 = 0, k1 = 0;
  if (DROP) seed_key(a.seed, a.thresh, k0, k1);

  float dq[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nb][e] = 0.0f;

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      stage(tile + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int j0 = tile * TILE;
    const float* K = sk + (tile & 1) * TILE_FLOATS;
    const float* V = sv + (tile & 1) * TILE_FLOATS;
    const float* kb = skb + (tile & 1) * TILE;
    float bias[8][4];  // DENSE: issued here, read after the products
    if (FORM == DENSE) load_bias(bias, a, h, i0 + r0, j0, g, t, false);
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // over the head dim
      uint32_t qh[4], ql[4], oh[4], ol[4];
      frag_a(sq, r0, kk, g, t, qh, ql);
      frag_a(sdo, r0, kk, g, t, oh, ol);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {  // over the keys
        uint32_t bh_[2], bl[2];
        frag_bt(K, nb, kk, g, t, bh_, bl);
        mma3(s[nb], qh, ql, bh_, bl);
        frag_bt(V, nb, kk, g, t, bh_, bl);
        mma3(dp[nb], oh, ol, bh_, bl);
      }
    }
    // the keep bits of element [nb][e] at bit 4 nb + e (common.cuh)
    const uint32_t kept = DROP ? row_keep_bits(b, h, i0 + r0 + g, j0, t, k0, k1, a.thresh) : 0u;
    // dS = P (dP M - D_i), f32
    const float D[2] = {sD[r0 + g], sD[r0 + g + 8]};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, col = 8 * nb + 2 * t + (e & 1);
        const float p = prob(s[nb][e], KBIAS ? kb[col] : FORM == DENSE ? bias[nb][e] : 0.0f,
                             lse[hi], j0 + col < n);
        s[nb][e] = p * (masked<DROP>(dp[nb][e], kept, 4 * nb + e, a.keep_scale) - D[hi]);
      }
    if (FORM == DENSE && a.ds) {  // this (b, h)'s dS rows for dbias
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = i0 + r0 + g + 8 * hi;
        if (i >= n) continue;
        float* row = a.ds + ((size_t)bh * n + i) * n;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int c = j0 + 8 * nb + 2 * t;
          const float x = s[nb][2 * hi], y = s[nb][2 * hi + 1];
          if ((n & 1) == 0 && c + 1 < n) {
            *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
          } else {
            if (c < n) row[c] = x;
            if (c + 1 < n) row[c + 1] = y;
          }
        }
      }
    }
    // dq += dS K, over the keys, the tile's share in its own accumulator
    tile_product(dq, s, K, g, t);
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = i0 + r0 + g + 8 * hi;
    if (i >= n) continue;
    float* o = a.dq + at(a.vdq, b, h, i);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<float2*>(o + 8 * nb + 2 * t) = make_float2(dq[nb][2 * hi], dq[nb][2 * hi + 1]);
  }
}

// ------------------------------------------------------------- column pass
// Shared memory: K, V, then 2 x Q, 2 x dO, 2 x [lse | D] (128 floats), the
// CTA's key bias, and with DROP the tile's keep bits (COLS_KEEP: a word per
// 32 keys of a query).  A thread's rows are keys, its columns queries.
constexpr size_t COLS_SMEM = (6 * TILE_FLOATS + 5 * TILE) * sizeof(float);
constexpr size_t COLS_KEEP = 2 * TILE * sizeof(uint32_t);

template <int FORM, bool DROP>
__global__ void __launch_bounds__(NT, 2) tc32_cols(Args a) {
  constexpr bool KBIAS = FORM == KEY;
  extern __shared__ __align__(16) float sm[];
  float* sk = sm;
  float* sv = sk + TILE_FLOATS;
  float* sq = sv + TILE_FLOATS;          // stage s at sq + s * TILE_FLOATS
  float* sdo = sq + 2 * TILE_FLOATS;
  float* svec = sdo + 2 * TILE_FLOATS;   // stage s: lse at svec + 2 s TILE, D after it
  float* skb = svec + 4 * TILE;
  uint32_t* skeep = reinterpret_cast<uint32_t*>(skb + TILE);
  const int j0 = blockIdx.x * TILE, bh = grid_bh<FORM>(a), b = bh / a.H, h = bh % a.H, n = a.n;
  const int tiles = (n + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's keys: j0 + r0 + g and + 8

  auto stage = [&](int tile) {
    const int s = tile & 1, i0 = tile * TILE;
    load_tile(sq + s * TILE_FLOATS, a.q + at(a.vq, b, h, 0), a.vq.st, i0, n);
    load_tile(sdo + s * TILE_FLOATS, a.dout + at(a.vdo, b, h, 0), a.vdo.st, i0, n);
    load_vec(svec + 2 * s * TILE, a.lse + (size_t)bh * n, i0, n);
    load_vec(svec + (2 * s + 1) * TILE, a.rowsum + (size_t)bh * n, i0, n);
  };
  load_tile(sk, a.k + at(a.vk, b, h, 0), a.vk.st, j0, n);
  load_tile(sv, a.v + at(a.vv, b, h, 0), a.vv.st, j0, n);
  if (KBIAS) load_vec(skb, a.key_bias + (size_t)b * n, j0, n);
  stage(0);
  cp_commit();

  float dk[8][4], dv[8][4], dkb[2] = {0.0f, 0.0f}, kb[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.0f;
  uint32_t k0 = 0, k1 = 0;
  if (DROP) seed_key(a.seed, a.thresh, k0, k1);

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile + 1 < tiles) {
      stage(tile + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    if (DROP) {  // keys j0 + 32 half + [0, 32) of query tile * TILE + il; the
                 // barrier closing the last tile has passed its reads
      const int il = threadIdx.x >> 1, half = threadIdx.x & 1;
      uint32_t bits = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const U4 w = philox(b, h, tile * TILE + il, (j0 >> 2) + 8 * half + q, k0, k1);
#pragma unroll
        for (int c = 0; c < 4; ++c) bits |= (uint32_t)(w.w[c] >= a.thresh) << (4 * q + c);
      }
      skeep[2 * il + half] = bits;
    }
    __syncthreads();
    if (KBIAS && tile == 0) {
      kb[0] = skb[r0 + g];
      kb[1] = skb[r0 + g + 8];
    }
    const int i0 = tile * TILE;
    float bias[8][4];  // DENSE, transposed: issued here, read after the products
    if (FORM == DENSE) load_bias(bias, a, h, j0 + r0, i0, g, t, true);
    const float* Q = sq + (tile & 1) * TILE_FLOATS;
    const float* dO = sdo + (tile & 1) * TILE_FLOATS;
    const float* slse = svec + 2 * (tile & 1) * TILE;
    const float* sD = slse + TILE;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {  // over the head dim
      uint32_t kh[4], kl[4], vh[4], vl[4];
      frag_a(sk, r0, kk, g, t, kh, kl);
      frag_a(sv, r0, kk, g, t, vh, vl);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {  // over the queries
        uint32_t bh_[2], bl[2];
        frag_bt(Q, nb, kk, g, t, bh_, bl);
        mma3(s[nb], kh, kl, bh_, bl);
        frag_bt(dO, nb, kk, g, t, bh_, bl);
        mma3(dp[nb], vh, vl, bh_, bl);
      }
    }
    // (P M)^T and dS^T = P^T (dP^T M - D), f32; this head's dkey_bias share
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, il = 8 * nb + 2 * t + (e & 1);
        const float p = prob(s[nb][e], KBIAS ? kb[hi] : FORM == DENSE ? bias[nb][e] : 0.0f,
                             slse[il], i0 + il < n && j0 + r0 + g + 8 * hi < n);
        float ds;
        if (DROP) {
          const int jl = r0 + g + 8 * hi;
          const float m = (skeep[2 * il + (jl >> 5)] >> (jl & 31)) & 1 ? a.keep_scale : 0.0f;
          ds = p * (dp[nb][e] * m - sD[il]);
          s[nb][e] = p * m;
        } else {
          ds = p * (dp[nb][e] - sD[il]);
          s[nb][e] = p;
        }
        dp[nb][e] = ds;
        if (KBIAS) dkb[hi] += ds;
      }
    // dv += (P M)^T dO, then dk += dS^T Q, over the queries, each tile's share
    // in its own accumulator (see flush)
    tile_product(dv, s, dO, g, t);
    tile_product(dk, dp, Q, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int j = j0 + r0 + g + 8 * hi;
    const float share = KBIAS ? sum4(dkb[hi]) : 0.0f;  // this (b, h)'s dkey_bias at key j
    if (j >= n) continue;
    float* gk = a.dk + at(a.vdk, b, h, j);
    float* gv = a.dv + at(a.vdv, b, h, j);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      *reinterpret_cast<float2*>(gk + 8 * nb + 2 * t) = make_float2(dk[nb][2 * hi], dk[nb][2 * hi + 1]);
      *reinterpret_cast<float2*>(gv + 8 * nb + 2 * t) = make_float2(dv[nb][2 * hi], dv[nb][2 * hi + 1]);
    }
    if (KBIAS && a.dkb_head && t == 0) a.dkb_head[(size_t)bh * n + j] = share;
  }
}

// dkey_bias[b, j] = sum of the heads' shares, heads in order, as the TPU
// kernel accumulates its grid (ops/pallas/attention.py:263-268)
__global__ void tc32_dkb(Args a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.B * a.n) return;
  const int b = e / a.n, j = e % a.n;
  float s = 0.0f;
  for (int h = 0; h < a.H; ++h) s += a.dkb_head[((size_t)b * a.H + h) * a.n + j];
  a.dkb[e] = s;
}

// dbias[hb, i, j] = sum of the scratch's dS over the batch for a per-head
// bias, over the heads (outer) and the batch (inner) for a one-head bias, in
// that fixed order (as attention_tc.cu's attn_tc_dbias)
__global__ void tc32_dbias(Args a) {
  const size_t nn = (size_t)a.n * a.n;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)a.bias_heads * nn) return;
  const int hb = (int)(e / nn);
  const size_t ij = e % nn;
  const int h0 = a.bias_heads > 1 ? hb : 0, h1 = a.bias_heads > 1 ? hb + 1 : a.H;
  float s = 0.0f;
  for (int h = h0; h < h1; ++h)
    for (int b = 0; b < a.B; ++b) s += a.ds[((size_t)b * a.H + h) * nn + ij];
  a.dbias[e] = s;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t st, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q, k, v, out: (b, h, n, 64) f32 views with (batch, head, token) element
// strides in `strides` (4 views x 3, in that order), each a multiple of 4
// (16-byte rows), bases 16-byte aligned; key_bias (b, n) f32 or null; bias
// (bias_heads, n, n) f32 or null (not both); lse (b, h, n) f32 out; seed (1,)
// int64 in device memory, thresh and keep_scale K13a's dropout mask (thresh
// 0: none; a key bias only).  The form follows: dropout (K13a), a key bias
// (K7), a dense bias (K7 dense) or none (K7).
CT_EXPORT int ct_attn_tc32_fwd(const void* q, const void* k, const void* v, void* out,
                               const long long* strides, const void* key_bias, const void* bias,
                               int bias_heads, void* lse, const void* seed, unsigned int thresh,
                               float keep_scale, int B, int H, int n, void* stream) {
  Args a = {};
  View* const views[4] = {&a.vq, &a.vk, &a.vv, &a.vo};
  const void* bases[4] = {q, k, v, out};
  if (B <= 0 || H <= 0 || n <= 0 || (long long)B * H > 65535 || !lse
      || (key_bias && bias) || (bias && bias_heads != 1 && bias_heads != H)
      || (thresh && (!seed || !key_bias)))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i) {
    for (int c = 0; c < 3; ++c)
      if (strides[3 * i + c] % 4) return (int)cudaErrorInvalidValue;
    if (!aligned16(bases[i])) return (int)cudaErrorInvalidValue;
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.fwd_out = static_cast<float*>(out);
  a.fwd_lse = static_cast<float*>(lse);
  a.key_bias = static_cast<const float*>(key_bias);
  a.B = B; a.H = H; a.n = n;
  a.bias = static_cast<const float*>(bias);
  a.bias_heads = bias_heads;
  a.seed = static_cast<const long long*>(seed);
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  const bool drop = thresh != 0, kbias = key_bias != nullptr, dense = bias != nullptr;
  void (*fwd)(Args) = drop ? tc32_fwd<KEY, true> : kbias ? tc32_fwd<KEY, false>
                    : dense ? tc32_fwd<DENSE, false> : tc32_fwd<NONE, false>;
  return (int)launch(fwd, dim3((n + TILE - 1) / TILE, B * H), FWD_SMEM,
                     static_cast<cudaStream_t>(stream), a);
}

// q, k, v, out (the forward's f32 output), dout, dq, dk, dv: (b, h, n, 64)
// f32 views with (batch, head, token) element strides in `strides` (8 views
// x 3, in that order), each a multiple of 4 (16-byte rows), bases 16-byte
// aligned; key_bias (b, n) f32 or null; bias (bias_heads, n, n) f32 or null
// (not both); lse (b, h, n) f32 from the forward; rowsum (b, h, n) f32
// scratch; ds (b, h, n, n) f32 scratch and dbias (bias_heads, n, n) f32
// out, both null when dbias is not wanted; dkb_head (b, h, n) f32 scratch
// and dkb (b, n) f32 out, both null when dkey_bias is not wanted; seed (1,)
// int64 in device memory, thresh and keep_scale the dropout mask of K13a's
// forward (thresh 0: none; a key bias only).  The form follows: dropout
// (K13b), a key bias (K12a), a dense bias (K12b) or none.
CT_EXPORT int ct_attn_tc32_bwd(const void* q, const void* k, const void* v, const void* out,
                               const void* dout, void* dq, void* dk, void* dv,
                               const long long* strides, const void* key_bias, const void* bias,
                               int bias_heads, const void* lse, void* rowsum, void* ds,
                               void* dbias, void* dkb_head, void* dkb, const void* seed,
                               unsigned int thresh, float keep_scale, int B, int H, int n,
                               void* stream) {
  Args a = {};
  View* const views[8] = {&a.vq, &a.vk, &a.vv, &a.vo, &a.vdo, &a.vdq, &a.vdk, &a.vdv};
  const void* bases[8] = {q, k, v, out, dout, dq, dk, dv};
  if (B <= 0 || H <= 0 || n <= 0 || (long long)B * H > 65535 || !lse || !rowsum
      || (key_bias && bias) || (bias && bias_heads != 1 && bias_heads != H)
      || (!ds != !dbias) || (dbias && !bias) || (!dkb_head != !dkb) || (dkb && !key_bias)
      || (thresh && (!seed || !key_bias)))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 8; ++i) {
    for (int c = 0; c < 3; ++c)
      if (strides[3 * i + c] % 4) return (int)cudaErrorInvalidValue;
    if (!aligned16(bases[i])) return (int)cudaErrorInvalidValue;
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v); a.out = static_cast<const float*>(out);
  a.dout = static_cast<const float*>(dout);
  a.dq = static_cast<float*>(dq); a.dk = static_cast<float*>(dk); a.dv = static_cast<float*>(dv);
  a.key_bias = static_cast<const float*>(key_bias);
  a.lse = static_cast<const float*>(lse);
  a.rowsum = static_cast<float*>(rowsum);
  a.dkb_head = static_cast<float*>(dkb_head);
  a.dkb = static_cast<float*>(dkb);
  a.B = B; a.H = H; a.n = n;
  a.bias = static_cast<const float*>(bias);
  a.bias_heads = bias_heads;
  a.ds = static_cast<float*>(ds);
  a.dbias = static_cast<float*>(dbias);
  a.seed = static_cast<const long long*>(seed);
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + TILE - 1) / TILE, B * H);
  const bool drop = thresh != 0, kbias = key_bias != nullptr, dense = bias != nullptr;
  void (*rows)(Args) = drop ? tc32_rows<KEY, true> : kbias ? tc32_rows<KEY, false>
                     : dense ? tc32_rows<DENSE, false> : tc32_rows<NONE, false>;
  void (*cols)(Args) = drop ? tc32_cols<KEY, true> : kbias ? tc32_cols<KEY, false>
                     : dense ? tc32_cols<DENSE, false> : tc32_cols<NONE, false>;
  cudaError_t err = launch(rows, grid, ROWS_SMEM, st, a);
  if (err != cudaSuccess) return (int)err;
  err = launch(cols, grid, COLS_SMEM + (drop ? COLS_KEEP : 0), st, a);
  if (err != cudaSuccess) return (int)err;
  if (dbias) {
    const size_t elems = (size_t)bias_heads * n * n;
    tc32_dbias<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(a);
  }
  if (dkb) tc32_dkb<<<(B * n + 255) / 256, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}
