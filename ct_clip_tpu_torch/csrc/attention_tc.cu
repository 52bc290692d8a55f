// attention_tc.cu — bf16 attention at head dim 64 on the Hopper tensor cores:
// the forward with no bias, a per-key bias (with or without dropout) or a
// dense bias, and the backward with a dense bias, a per-key bias (with or
// without dropout) or none.  Every
// product is a `wgmma` (sm_90a) with bf16 operands and f32 accumulators;
// tiles reach shared memory through cp.async issued by one producer warp
// into a two-stage ring of mbarriers.
//
// Replaces these TPU kernels of ct_clip_tpu/ops/pallas/attention.py, bf16:
//   * _pallas_attention (K7, :129; pallas_call :143 key bias, :149 no bias,
//     :157 dense (1, 1|h, n, n) bias): softmax(q k^T + bias) v
//     -> attn_tc_forward<false>;
//   * _pallas_attention_kbias_drop_impl (K13a, :474; pallas_call :490, body
//     _kernel_kbias_drop :411-427): the key-bias form with K13's dropout mask
//     on the probabilities -> attn_tc_forward<true>;
//   * _pallas_attention_bwd (K12b, :301; pallas_call :318): dq, dk, dv and dbias
//     summed over the batch (and the heads for a one-head bias)
//     -> attn_tc_rows, attn_tc_cols, attn_tc_dbias.  The same kernels with no
//     bias serve the no-bias backward (MaskGIT's TokenCritic), which the JAX
//     package runs in XLA (`_fused_bwd`, :370): K12b with a zero bias and no
//     dbias;
//   * _pallas_attention_bwd_kbias (K12a, :271; pallas_call :286) and
//     _pallas_attention_kbias_drop_bwd (K13b, :499; pallas_call :516): dq,
//     dk, dv and dkey_bias (b, n), summed over the heads in order and over
//     the query rows, for a per-key (b, n) f32 bias; K13b regenerates the
//     dropout mask of K13a's forward in the kernel
//     -> attn_tc_rows, attn_tc_cols, attn_tc_dkb.
// The TPU kernels feed bf16 operands to the MXU and accumulate in f32
// (ops/pallas/_call.py:50-61).  They round at the same points as this file:
// the forward casts P to bf16 before P V (:95, :108, :121); the backward
// takes dP in f32, sums D_i = sum_j P_ij dP_ij from the f32 P (:191) and
// casts dS (:193) and P (:203) to bf16 for its three products.  K12a and
// K13b likewise: dA = dP M (M the scaled mask, 1 without dropout), D_i =
// sum_j P_ij dA_ij from the f32 P (:247, :450), dS = P (dA - D) and P M cast
// to bf16 (:249 and :259, :452 and :462).  One rounding point differs, in
// every forward form: the TPU kernel normalises P before the mask and the
// bf16 cast (:95; K13a :419-422); the online softmax here rounds the
// un-normalised exp(s - m) M to bf16 and divides O by the row sum at the
// end, so P's bf16 rounding lands on another scale (both ~2^-9 relative).
// K13a's row sum l runs over every key, kept or not, and lse = m + log l
// stays the residual K13b reads.
//
// What bounds it on the H100.  The forward at the zero-shot prompts' (36, 12,
// 512, 64) moves 113 MB of q, k, v and out (0.034 ms at 3.35 TB/s) and runs
// 29 GFLOP (0.029 ms at 989 TFLOP/s); at MaskGIT's (8, 8, 1280, 64) with the
// f32 (1, 8, n, n) CPB bias 94 MB (0.028 ms) against 53.7 GFLOP (0.054 ms).
// The backward there runs 67 GFLOP (five products, 0.068 ms) against 75 MB of
// q, k, v, dO, dq, dk, dv and the bias; the layout below runs nine products
// (0.122 ms) plus the dS scratch for dbias (420 MB written and read, ~0.25 ms).
// So both are bounded by the tensor cores and, with dbias, the scratch: the
// design keeps the products on `wgmma` and the K/V loads behind them.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (kernel-only device times,
// tools/port_attention_tc_probe.py): the forward takes ~0.17 ms at the
// prompts' shape and ~0.23 ms dense at MaskGIT's, 4-8x its bound.  Leaving
// out every product saves 10-20% of it and leaving out the loads nothing:
// neither the tensor cores nor memory hold it back, but the softmax (one
// ex2 per score) running between each warpgroup's own products, with only
// two or three warpgroups on an SM (a third CTA per SM gained 13-20%; a
// dense-bias CTA's 81 KB of shared memory allows two).  The dense backward
// takes ~0.94 ms: the row pass ~0.51 (~0.33 without a bias: the scratch's
// write makes the difference), the column pass ~0.28, the scratch's sum
// ~0.15, so the scratch holds about a third of it and the passes' products
// and softmax the rest, none of them near its bound.
// The key-bias backward (K12a, K13b) at CXR-BERT's (8, 12, 512, 64) moves 44
// MB of q, k, v, dO, dq, dk, dv (0.013 ms) and runs five products, 16.1
// GFLOP (0.016 ms); the layout below runs nine (0.029 ms).  K13b also draws
// its mask three times (the D sweep, the dS sweep, the column pass): 18.9 M
// Philox calls of ~80 integer operations, on the order of 0.1 ms of the
// integer units.  Measured (kernel-only, tools/port_attention_tc_probe.py,
// NVIDIA H100 80GB HBM3 at 700 W): K12a takes 0.149 ms (row pass 0.088,
// column pass 0.059, head sum 0.002), K13b 0.233 (0.142, 0.089, 0.002),
// 9-14x the bound.  The mask costs K13b 0.084 ms, 0.063 of it the Philox
// draw (a copy with no rounds); leaving out every product saves 0.054 ms in
// either; a producer that loads nothing saves nothing.  So the draw and the
// elementwise work between each warpgroup's products hold it, as in the
// forward; per call the Python wrapper adds 0.10-0.13 ms of host time.
//
// Design.
//   * A CTA is one consumer warpgroup (128 threads, 64 query rows, or 64 key
//     rows in the column pass) plus one producer warp.  The producer copies
//     16-byte chunks with cp.async (zero-filled past n, so ragged tails read
//     nothing) into a 128-byte-swizzled tile, 64 rows x 64 dims (8 KB; a
//     64-wide bf16 row is exactly 128 B: chunk c of row r lands at
//     r * 128 + (c ^ r % 8) * 16 in a 1024-byte-aligned tile), and marks each
//     stage full with cp.async.mbarrier.arrive; the consumers mark it empty
//     with mbarrier.arrive once their products have read it.  Any strides that
//     are multiples of 8 elements work (the head-major views of BERT's and
//     MaskGIT's (b, n, h, d) projections), where a TMA descriptor would need
//     one per view and call.
//   * S = Q K^T is a `wgmma` with both operands in shared memory, K-major;
//     the accumulator layout (thread t of the warpgroup holds rows
//     16 (t / 32) + (t % 32) / 4 and +8, columns 8 j + 2 (t % 4) + {0, 1}) is
//     also the layout of a `wgmma` A operand in registers, so P (and dS) go
//     from the f32 accumulators to bf16 registers and straight into
//     O += P V with V read MN-major (transposed) from shared memory.
//   * The online softmax runs in registers: biases are added to the f32
//     scores, keys at n and beyond score -inf, the row max and sum are
//     reduced over the four threads that share a row.  The running max is
//     -inf only before the first key tile, so an f32-min pad bias (the
//     prompts' pad mask) gives exp(-3.4e38 - m) = 0, and a row whose keys are
//     all padded attends uniformly, as the plain softmax does.
//   * The forward writes O / l in bf16 and lse = m + log l (b, h, n) in f32,
//     the backward's only residual; query rows at n and beyond are not written.
//   * The backward, FA2-style and deterministic (no atomics): a row pass (one
//     CTA per query tile) sweeps the key tiles twice, first to sum D_i =
//     sum_j P_ij dP_ij in f32 with P = exp(S + bias - lse) and dP = dO V^T,
//     then to form dS = P (dP - D) and dq += dS(bf16) K, writing each (b, h)'s
//     f32 dS to a (b, h, n, n) scratch where dbias is wanted; a column pass
//     (one CTA per key tile) takes S^T = K Q^T and dP^T = V dO^T and
//     accumulates dv += P^T(bf16) dO and dk += dS^T(bf16) Q, reading lse and
//     D; attn_tc_dbias adds the scratch over the batch (heads outer, batch
//     inner, as the TPU kernel accumulates its grid) in a fixed order.  D_i
//     comes from the backward's own f32 P and dP, never from the output: the
//     forward builds O from a bf16 P, and a D_i from it would shift every dS
//     row off its zero sum, which dbias (a sum of dS) collects.
//   * The dense bias tile (64 x 64 f32) is staged through the ring with the
//     K and V tiles, its rows padded (72 floats when read along keys, 68 when
//     read along queries in the column pass) so the reads hit distinct banks.
//   * A key bias (K12a, K13b) needs no scratch: the row pass stages its 64
//     values with each K/V stage; the column pass loads its CTA's 64 once
//     with K and V, row-sums dS over the queries a thread holds (then over
//     its quad) into each (b, h)'s dkey_bias share, a (b, h, n) scratch that
//     attn_tc_dkb adds over the heads in order.  No atomics anywhere: dq, dk,
//     dv, dbias and dkey_bias are bit-identical from run to run.
//   * Dropout draws K13's Philox bits (common.cuh, row_keep_bits there; the
//     counter (b, h, i, j / 4), word j % 4) in K13a's forward and regenerates them in K13b's
//     backward: the mask never exists in device memory.  The forward's S
//     accumulator has the row pass's layout, so both draw the same way.
//     Forward and row pass: lanes t and t ^ 1 hold the four
//     keys of one j / 4 group in each of their two rows, so each lane draws
//     the group for one row and trades the other row's half with a shuffle,
//     one call per four elements, drawn while the tile's products run.
//     Column pass: a thread's two keys lie in two groups, so the warpgroup
//     first draws the tile's 64 x 64 keep bits into shared memory (a 32-key
//     half of one query row per thread: 8 calls) and each thread reads one
//     word per query it holds.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TILE = 64;                    // query or key rows per tile
constexpr int TILE_BYTES = TILE * 64 * 2;   // one bf16 tile of 64 x 64
constexpr int STAGES = 2;                   // ring depth
constexpr int WG = 128;                     // consumer threads: one warpgroup
constexpr int NT = WG + 32;                 // + the producer warp
constexpr int LD_ROWS = 72;                 // floats per staged bias row, read along keys
constexpr int LD_COLS = 68;                 // ... read along queries (column pass)

// bytes of one ring stage: K, V, the bias tile, the key bias (forward)
__host__ __device__ constexpr int fwd_stage(bool dense) {
  return round1024(2 * TILE_BYTES + (dense ? TILE * LD_ROWS * 4 : 0) + TILE * 4);
}
// K, V, the bias tile, the key bias (row pass)
__host__ __device__ constexpr int rows_stage(bool dense, bool kbias) {
  return round1024(2 * TILE_BYTES + (dense ? TILE * LD_ROWS * 4 : 0) + (kbias ? TILE * 4 : 0));
}
// Q, dO, the bias tile, lse and D (column pass)
__host__ __device__ constexpr int cols_stage(bool dense) {
  return round1024(2 * TILE_BYTES + (dense ? TILE * LD_COLS * 4 : 0) + 2 * TILE * 4);
}
// past the column pass's ring: the CTA's key bias, two tiles of keep bits
__host__ __device__ constexpr int cols_tail(bool kbias, bool drop) {
  return (kbias ? TILE * 4 : 0) + (drop ? 2 * TILE * 2 * 4 : 0);
}

// Element strides (batch, head, token) of one (b, h, n, 64) view.
struct View { long long sb, sh, st; };

__device__ __forceinline__ size_t at(const View& v, int b, int h, int t) {
  return (size_t)b * v.sb + (size_t)h * v.sh + (size_t)t * v.st;
}

// --------------------------------------------------------- producer loads
// rows [r0, r0 + 64) of a (token, 64) bf16 view at `base` (token stride st)
// -> the swizzled tile at dst; rows at n and beyond are zero
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* base, long long st,
                                          int r0, int n, int lane) {
#pragma unroll 4
  for (int e = lane; e < TILE * 8; e += 32) {
    const int r = e >> 3, c = e & 7, t = r0 + r;
    const bool ok = t < n;
    cp16(dst + r * 128 + ((c ^ (r & 7)) << 4), base + (ok ? (long long)t * st : 0) + c * 8,
         ok ? 16 : 0);
  }
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  bf16 *out, *dq, *dk, *dv;
  View vq, vk, vv, vo, vdo, vdq, vdk, vdv;
  const float* key_bias;    // (b, n), or null
  const float* bias;        // (bias_heads, n, n), or null
  int bias_heads;
  float* lse;               // (b, h, n): written by the forward, read by the backward
  float* rowsum;            // (b, h, n) D_i: written by the row pass, read by the columns
  float* ds;                // (b, h, n, n) dS scratch for dbias, or null
  float* dbias;             // (bias_heads, n, n), or null
  float* dkb_head;          // (b, h, n) each head's share of dkey_bias, or null
  float* dkb;               // (b, n) dkey_bias, or null
  const long long* seed;    // (1,) Philox key in device memory, or null
  uint32_t thresh;          // keep iff bits >= thresh; 0: no dropout
  float keep_scale;         // 1 / (1 - rate)
  int B, H, n;
};

__device__ __forceinline__ const float* bias_head(const Args& a, int h) {
  return a.bias ? a.bias + (size_t)(a.bias_heads > 1 ? h : 0) * a.n * a.n : nullptr;
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], WG);
    }
    bar_init(once, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------- forward
// One CTA per (64-query tile, b * h), three to an SM where shared memory
// allows (no bias or a key bias: 45 KB; a dense bias: 81 KB, two): the
// consumer warpgroup's softmax runs between its own products, so the SM
// overlaps them across CTAs.  Shared memory: Q, then STAGES x [K | V | bias
// tile (dense) | key bias (64 floats)].  DROP: K13a, a key bias with K13's
// mask on the probabilities (compiled alone, so K7's forms carry none of it).
template <bool DROP>
__global__ void __launch_bounds__(NT, 3) attn_tc_forward(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;
  uint8_t* sq = align1024(smem_raw);
  const bool dense = !DROP && a.bias != nullptr, kbias = DROP || a.key_bias != nullptr;
  const int stage = fwd_stage(dense);
  const int i0 = blockIdx.x * TILE, bh = blockIdx.y, b = bh / a.H, h = bh % a.H, n = a.n;
  const int tiles = (n + TILE - 1) / TILE;
  init_barriers(full, empty, &qbar);

  if (threadIdx.x >= WG) {  // the producer warp
    const int lane = threadIdx.x - WG;
    load_rows(saddr(sq), a.q + at(a.vq, b, h, 0), a.vq.st, i0, n, lane);
    bar_arrive_copies(&qbar);
    const float* bias = bias_head(a, h);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) bar_wait(&empty[s], (t / STAGES - 1) & 1);
      const uint32_t st = saddr(sq + TILE_BYTES + s * stage);
      load_rows(st, a.k + at(a.vk, b, h, 0), a.vk.st, t * TILE, n, lane);
      load_rows(st + TILE_BYTES, a.v + at(a.vv, b, h, 0), a.vv.st, t * TILE, n, lane);
      if (dense) load_bias(st + 2 * TILE_BYTES, bias, n, i0, t * TILE, LD_ROWS, lane);
      if (kbias)
        load_vec(st + 2 * TILE_BYTES + (dense ? TILE * LD_ROWS * 4 : 0),
                 a.key_bias + (size_t)b * n, t * TILE, n, lane);
      bar_arrive_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows: rl, rl + 8
  float o[32], s_[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = s_[e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  uint32_t k0 = 0, k1 = 0;
  if (DROP) seed_key(a.seed, a.thresh, k0, k1);
  uint32_t pa[4][4];
  const uint32_t qa = saddr(sq);
  bar_wait(&qbar, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES, j0 = t * TILE;
    uint8_t* st = sq + TILE_BYTES + s * stage;
    bar_wait(&full[s], (t / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t ka = saddr(st), va = ka + TILE_BYTES;
    hold(s_);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(s_, desc(qa + 32 * kk), desc(ka + 32 * kk), kk);
    wg_commit();
    // the tile's keep bits, drawn while the product runs
    uint32_t kept = 0;
    if (DROP) kept = row_keep_bits(b, h, i0 + rl, j0, q4, k0, k1, a.thresh);
    wg_wait();
    hold(s_);

    const float* sb = reinterpret_cast<const float*>(st + 2 * TILE_BYTES);
    const float* skb = sb + (dense ? TILE * LD_ROWS : 0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      float x = s_[e];
      if (kbias) x += skb[col];
      if (dense) x += sb[(rl + 8 * hi) * LD_ROWS + col];
      x = j0 + col < n ? x : -INFINITY;
      s_[e] = x;
      mx[hi] = fmaxf(mx[hi], x);
    }
    float corr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      // key j0 < n lies in this tile, so the new max is finite
      const float mn = fmaxf(m[hi], max4(mx[hi]));
      corr[hi] = fexp2((m[hi] - mn) * LOG2E);  // 0 before the first tile
      m[hi] = mn;
      l[hi] *= corr[hi];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e);
      const float p = fexp2((s_[e] - m[hi]) * LOG2E);
      l[hi] += p;  // the softmax's sum runs over every key, kept or not
      s_[e] = masked<DROP>(p, kept, e, a.keep_scale);
      o[e] *= corr[hi];
    }
    to_a(s_, pa);
    hold(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(o, pa[kk], desc(va + 2048 * kk));
    wg_commit();
    wg_wait();
    hold(o);
    hold(pa);
    bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = i0 + rl + 8 * hi;
    const float sum = sum4(l[hi]);
    if (i >= n) continue;
    const float inv = 1.0f / sum;
    bf16* out = a.out + at(a.vo, b, h, i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<bf162*>(out + 8 * j + 2 * q4) =
          __floats2bfloat162_rn(o[4 * j + 2 * hi] * inv, o[4 * j + 2 * hi + 1] * inv);
    if (q4 == 0) a.lse[(size_t)bh * n + i] = m[hi] + log2f(sum) * LN2;
  }
}

// --------------------------------------------------------------- backward
// Row pass: one CTA per (64-query tile, b * h).  Shared memory: Q, dO, then
// STAGES x [K | V | bias tile (dense) | key bias (64 floats)], the key tiles
// streamed twice.  KBIAS: a key bias (K12a, K13b), DROP: K13's mask; each
// form compiles alone, so the dense and no-bias forms carry none of it.
template <bool KBIAS, bool DROP>
__global__ void __launch_bounds__(NT, 2) attn_tc_rows(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sdo = sq + TILE_BYTES;
  const bool dense = !KBIAS && a.bias != nullptr;
  const int stage = rows_stage(dense, KBIAS);
  const int bias_bytes = dense ? TILE * LD_ROWS * 4 : 0;
  const int i0 = blockIdx.x * TILE, bh = blockIdx.y, b = bh / a.H, h = bh % a.H, n = a.n;
  const int tiles = (n + TILE - 1) / TILE;
  init_barriers(full, empty, &qbar);

  if (threadIdx.x >= WG) {
    const int lane = threadIdx.x - WG;
    load_rows(saddr(sq), a.q + at(a.vq, b, h, 0), a.vq.st, i0, n, lane);
    load_rows(saddr(sdo), a.dout + at(a.vdo, b, h, 0), a.vdo.st, i0, n, lane);
    bar_arrive_copies(&qbar);
    const float* bias = bias_head(a, h);
    for (int t = 0; t < 2 * tiles; ++t) {
      const int s = t % STAGES, j0 = (t % tiles) * TILE;
      if (t >= STAGES) bar_wait(&empty[s], (t / STAGES - 1) & 1);
      const uint32_t st = saddr(sdo + TILE_BYTES + s * stage);
      load_rows(st, a.k + at(a.vk, b, h, 0), a.vk.st, j0, n, lane);
      load_rows(st + TILE_BYTES, a.v + at(a.vv, b, h, 0), a.vv.st, j0, n, lane);
      if (dense) load_bias(st + 2 * TILE_BYTES, bias, n, i0, j0, LD_ROWS, lane);
      if (KBIAS)
        load_vec(st + 2 * TILE_BYTES + bias_bytes, a.key_bias + (size_t)b * n, j0, n, lane);
      bar_arrive_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);
  float s_[32], dp[32], dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s_[e] = dp[e] = dq[e] = 0.0f;
  float lse[2], D[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) lse[hi] = a.lse[(size_t)bh * n + min(i0 + rl + 8 * hi, n - 1)];
  uint32_t k0 = 0, k1 = 0;
  if (DROP) seed_key(a.seed, a.thresh, k0, k1);
  uint32_t da[4][4];
  const uint32_t qa = saddr(sq), doa = saddr(sdo);
  bar_wait(&qbar, 0);

  for (int t = 0; t < 2 * tiles; ++t) {
    const bool second = t >= tiles;
    const int s = t % STAGES, j0 = (t % tiles) * TILE;
    uint8_t* st = sdo + TILE_BYTES + s * stage;
    bar_wait(&full[s], (t / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t ka = saddr(st), va = ka + TILE_BYTES;
    hold(s_);
    hold(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(s_, desc(qa + 32 * kk), desc(ka + 32 * kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(dp, desc(doa + 32 * kk), desc(va + 32 * kk), kk);
    wg_commit();
    // the tile's keep bits, drawn while the products run
    uint32_t kept = 0;
    if (DROP) kept = row_keep_bits(b, h, i0 + rl, j0, q4, k0, k1, a.thresh);
    wg_wait();
    hold(s_);
    hold(dp);

    const float* sb = reinterpret_cast<const float*>(st + 2 * TILE_BYTES);
    const float* skb = sb + bias_bytes / 4;
    if (!second) {  // D_i = sum_j P_ij dA_ij, f32
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int hi = acc_hi(e), col = acc_col(e, q4);
        const float bias = KBIAS ? skb[col] : dense ? sb[(rl + 8 * hi) * LD_ROWS + col] : 0.0f;
        D[hi] = fmaf(prob(s_[e], bias, lse[hi], j0 + col < n),
                     masked<DROP>(dp[e], kept, e, a.keep_scale), D[hi]);
      }
      bar_arrive(&empty[s]);
      if (t == tiles - 1) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          D[hi] = sum4(D[hi]);
          const int i = i0 + rl + 8 * hi;
          if (q4 == 0 && i < n) a.rowsum[(size_t)bh * n + i] = D[hi];
        }
      }
      continue;
    }
    // dS = P (dA - D); dq += dS(bf16) K
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      const float bias = KBIAS ? skb[col] : dense ? sb[(rl + 8 * hi) * LD_ROWS + col] : 0.0f;
      s_[e] = prob(s_[e], bias, lse[hi], j0 + col < n)
            * (masked<DROP>(dp[e], kept, e, a.keep_scale) - D[hi]);
    }
    if (!KBIAS && a.ds) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int i = i0 + rl + 8 * hi;
        if (i >= n) continue;
        float* row = a.ds + ((size_t)bh * n + i) * n;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = j0 + 8 * j + 2 * q4;
          const float x = s_[4 * j + 2 * hi], y = s_[4 * j + 2 * hi + 1];
          if ((n & 1) == 0 && c + 1 < n) {
            *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
          } else {
            if (c < n) row[c] = x;
            if (c + 1 < n) row[c + 1] = y;
          }
        }
      }
    }
    to_a(s_, da);
    hold(dq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(dq, da[kk], desc(ka + 2048 * kk));
    wg_commit();
    wg_wait();
    hold(dq);
    hold(da);
    bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = i0 + rl + 8 * hi;
    if (i >= n) continue;
    bf16* out = a.dq + at(a.vdq, b, h, i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<bf162*>(out + 8 * j + 2 * q4) =
          __floats2bfloat162_rn(dq[4 * j + 2 * hi], dq[4 * j + 2 * hi + 1]);
  }
}

// Column pass: one CTA per (64-key tile, b * h); its rows are keys, its
// columns queries.  Shared memory: K, V, then STAGES x [Q | dO | bias tile
// (dense, rows queries) | lse | D], then the CTA's key bias (64 floats) and
// two tiles of keep bits (a word per 32 keys of a query, double-buffered).
// KBIAS and DROP as in the row pass.
template <bool KBIAS, bool DROP>
__global__ void __launch_bounds__(NT, 2) attn_tc_cols(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kvbar;
  uint8_t* sk = align1024(smem_raw);
  uint8_t* sv = sk + TILE_BYTES;
  const bool dense = !KBIAS && a.bias != nullptr;
  const int stage = cols_stage(dense);
  const int bias_bytes = dense ? TILE * LD_COLS * 4 : 0;
  float* skb = reinterpret_cast<float*>(sv + TILE_BYTES + STAGES * stage);
  uint32_t* keep_tiles = reinterpret_cast<uint32_t*>(skb + (KBIAS ? TILE : 0));
  const int j0 = blockIdx.x * TILE, bh = blockIdx.y, b = bh / a.H, h = bh % a.H, n = a.n;
  const int tiles = (n + TILE - 1) / TILE;
  init_barriers(full, empty, &kvbar);

  if (threadIdx.x >= WG) {
    const int lane = threadIdx.x - WG;
    load_rows(saddr(sk), a.k + at(a.vk, b, h, 0), a.vk.st, j0, n, lane);
    load_rows(saddr(sv), a.v + at(a.vv, b, h, 0), a.vv.st, j0, n, lane);
    if (KBIAS) load_vec(saddr(skb), a.key_bias + (size_t)b * n, j0, n, lane);
    bar_arrive_copies(&kvbar);
    const float* bias = bias_head(a, h);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES, i0 = t * TILE;
      if (t >= STAGES) bar_wait(&empty[s], (t / STAGES - 1) & 1);
      const uint32_t st = saddr(sv + TILE_BYTES + s * stage);
      load_rows(st, a.q + at(a.vq, b, h, 0), a.vq.st, i0, n, lane);
      load_rows(st + TILE_BYTES, a.dout + at(a.vdo, b, h, 0), a.vdo.st, i0, n, lane);
      if (dense) load_bias(st + 2 * TILE_BYTES, bias, n, i0, j0, LD_COLS, lane);
      load_vec(st + 2 * TILE_BYTES + bias_bytes, a.lse + (size_t)bh * n, i0, n, lane);
      load_vec(st + 2 * TILE_BYTES + bias_bytes + TILE * 4, a.rowsum + (size_t)bh * n, i0, n,
               lane);
      bar_arrive_copies(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's keys: j0 + rl, + 8
  float s_[32], dp[32], dk[32], dv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s_[e] = dp[e] = dk[e] = dv[e] = 0.0f;
  float dkb[2] = {0.0f, 0.0f}, kb[2] = {0.0f, 0.0f};
  uint32_t k0 = 0, k1 = 0;
  if (DROP) seed_key(a.seed, a.thresh, k0, k1);
  uint32_t pa[4][4], da[4][4];
  const uint32_t ka = saddr(sk), va = saddr(sv);
  bar_wait(&kvbar, 0);
  if (KBIAS) {
    kb[0] = skb[rl];
    kb[1] = skb[rl + 8];
  }

  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES, i0 = t * TILE;
    uint8_t* st = sv + TILE_BYTES + s * stage;
    bar_wait(&full[s], (t / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t qa = saddr(st), doa = qa + TILE_BYTES;
    hold(s_);
    hold(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(s_, desc(ka + 32 * kk), desc(qa + 32 * kk), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss(dp, desc(va + 32 * kk), desc(doa + 32 * kk), kk);
    wg_commit();
    const uint32_t* keep_t = keep_tiles + (t & 1) * 2 * TILE;
    if (DROP) {  // while the products run: keys j0 + 32 half + [0, 32) of query i0 + il
      const int il = threadIdx.x >> 1, half = threadIdx.x & 1;
      uint32_t bits = 0;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const U4 w = philox(b, h, i0 + il, (j0 >> 2) + 8 * half + g, k0, k1);
#pragma unroll
        for (int c = 0; c < 4; ++c) bits |= (uint32_t)(w.w[c] >= a.thresh) << (4 * g + c);
      }
      keep_tiles[(t & 1) * 2 * TILE + 2 * il + half] = bits;
      // the whole tile's bits are written; tile t - 2 read this buffer
      // before every thread reached tile t - 1's barrier
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
    }
    wg_wait();
    hold(s_);
    hold(dp);

    const float* sb = reinterpret_cast<const float*>(st + 2 * TILE_BYTES);
    const float* slse = reinterpret_cast<const float*>(st + 2 * TILE_BYTES + bias_bytes);
    const float* sd = slse + TILE;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), jl = rl + 8 * hi, il = acc_col(e, q4);
      const float bias = KBIAS ? kb[hi] : dense ? sb[il * LD_COLS + jl] : 0.0f;
      const float p = prob(s_[e], bias, slse[il], i0 + il < n && j0 + jl < n);
      if (DROP) {  // dA = dP M, P M for dv
        const float m = (keep_t[2 * il + (rl >> 5)] >> (jl & 31)) & 1 ? a.keep_scale : 0.0f;
        dp[e] = p * (dp[e] * m - sd[il]);
        s_[e] = p * m;
      } else {
        dp[e] = p * (dp[e] - sd[il]);
        s_[e] = p;
      }
      if (KBIAS) dkb[hi] += dp[e];  // dS
    }
    to_a(s_, pa);
    to_a(dp, da);
    hold(dv);
    hold(dk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(dv, pa[kk], desc(doa + 2048 * kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(dk, da[kk], desc(qa + 2048 * kk));
    wg_commit();
    wg_wait();
    hold(dv);
    hold(dk);
    hold(pa);
    hold(da);
    bar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int j = j0 + rl + 8 * hi;
    const float share = KBIAS ? sum4(dkb[hi]) : 0.0f;  // this (b, h)'s dkey_bias at key j
    if (j >= n) continue;
    bf16* gk = a.dk + at(a.vdk, b, h, j);
    bf16* gv = a.dv + at(a.vdv, b, h, j);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<bf162*>(gk + 8 * c + 2 * q4) =
          __floats2bfloat162_rn(dk[4 * c + 2 * hi], dk[4 * c + 2 * hi + 1]);
      *reinterpret_cast<bf162*>(gv + 8 * c + 2 * q4) =
          __floats2bfloat162_rn(dv[4 * c + 2 * hi], dv[4 * c + 2 * hi + 1]);
    }
    if (KBIAS && a.dkb_head && q4 == 0) a.dkb_head[(size_t)bh * n + j] = share;
  }
}

// dbias[hb, i, j] = sum of the scratch's dS over the batch for a per-head
// bias, over the heads (outer) and the batch (inner) for a one-head bias, in
// that fixed order
__global__ void attn_tc_dbias(Args a) {
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

// dkey_bias[b, j] = sum of the heads' shares (attn_tc_cols), heads in order,
// as the TPU kernel accumulates its grid (ops/pallas/attention.py:465-471)
__global__ void attn_tc_dkb(Args a) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= a.B * a.n) return;
  const int b = e / a.n, j = e % a.n;
  float s = 0.0f;
  for (int h = 0; h < a.H; ++h) s += a.dkb_head[((size_t)b * a.H + h) * a.n + j];
  a.dkb[e] = s;
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t st, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

// views[i] from strides[3 i .. 3 i + 2]; every stride a multiple of 8
// elements (16-byte chunks)
bool make_views(const long long* strides, View* const* views, int count) {
  for (int i = 0; i < count; ++i) {
    for (int c = 0; c < 3; ++c)
      if (strides[3 * i + c] % 8) return false;
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  return true;
}

bool aligned16(const void* p) { return p && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool shape_ok(int B, int H, int n, const void* bias, int bias_heads) {
  return B > 0 && H > 0 && n > 0 && (long long)B * H <= 65535
      && (!bias || bias_heads == 1 || bias_heads == H);
}

}  // namespace

// q, k, v, out: (b, h, n, 64) bf16 views with (batch, head, token) element
// strides in `strides` (4 views x 3), each a multiple of 8, bases 16-byte
// aligned; key_bias (b, n) f32 or null; bias (bias_heads, n, n) f32 or null
// (not both); lse (b, h, n) f32 out; seed (1,) int64 in device memory,
// thresh and keep_scale K13a's dropout mask (thresh 0: none; a key bias only).
CT_EXPORT int ct_attn_tc_fwd(const void* q, const void* k, const void* v, void* out,
                             const long long* strides, const void* key_bias, const void* bias,
                             int bias_heads, void* lse, const void* seed, unsigned int thresh,
                             float keep_scale, int B, int H, int n, void* stream) {
  Args a = {};
  View* const views[4] = {&a.vq, &a.vk, &a.vv, &a.vo};
  if (!shape_ok(B, H, n, bias, bias_heads) || (key_bias && bias) || !lse
      || (thresh && (!seed || !key_bias)) || !make_views(strides, views, 4) || !aligned16(q)
      || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v); a.out = static_cast<bf16*>(out);
  a.key_bias = static_cast<const float*>(key_bias);
  a.bias = static_cast<const float*>(bias);
  a.bias_heads = bias_heads;
  a.lse = static_cast<float*>(lse);
  a.seed = static_cast<const long long*>(seed);
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.B = B; a.H = H; a.n = n;
  const size_t smem = 1024 + TILE_BYTES + STAGES * fwd_stage(bias != nullptr);
  return (int)launch(thresh ? attn_tc_forward<true> : attn_tc_forward<false>,
                     dim3((n + TILE - 1) / TILE, B * H), smem,
                     static_cast<cudaStream_t>(stream), a);
}

// q, k, v, dout, dq, dk, dv: (b, h, n, 64) bf16 views as in ct_attn_tc_fwd
// (7 views x 3 strides, in that order); key_bias (b, n) f32 or null; bias
// (bias_heads, n, n) f32 or null (not both); lse (b, h, n) from the forward;
// rowsum (b, h, n) f32 scratch; ds (b, h, n, n) f32 scratch and dbias
// (bias_heads, n, n) f32 out, both null when dbias is not wanted; dkb_head
// (b, h, n) f32 scratch and dkb (b, n) f32 out, both null when dkey_bias is
// not wanted; seed (1,) int64 in device memory, thresh and keep_scale the
// dropout mask of K13a's forward (thresh 0: none; a key bias only).
CT_EXPORT int ct_attn_tc_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, const long long* strides,
                             const void* key_bias, const void* bias, int bias_heads,
                             const void* lse, void* rowsum, void* ds, void* dbias,
                             void* dkb_head, void* dkb, const void* seed, unsigned int thresh,
                             float keep_scale, int B, int H, int n, void* stream) {
  Args a = {};
  View* const views[7] = {&a.vq, &a.vk, &a.vv, &a.vdo, &a.vdq, &a.vdk, &a.vdv};
  if (!shape_ok(B, H, n, bias, bias_heads) || (key_bias && bias) || !lse || !rowsum
      || (!ds != !dbias) || (dbias && !bias) || (!dkb_head != !dkb) || (dkb && !key_bias)
      || (thresh && (!seed || !key_bias)) || !make_views(strides, views, 7) || !aligned16(q)
      || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq)
      || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorInvalidValue;
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v); a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq); a.dk = static_cast<bf16*>(dk); a.dv = static_cast<bf16*>(dv);
  a.key_bias = static_cast<const float*>(key_bias);
  a.bias = static_cast<const float*>(bias);
  a.bias_heads = bias_heads;
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.rowsum = static_cast<float*>(rowsum);
  a.ds = static_cast<float*>(ds);
  a.dbias = static_cast<float*>(dbias);
  a.dkb_head = static_cast<float*>(dkb_head);
  a.dkb = static_cast<float*>(dkb);
  a.seed = static_cast<const long long*>(seed);
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.B = B; a.H = H; a.n = n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + TILE - 1) / TILE, B * H);
  const bool dense = bias != nullptr, kbias = key_bias != nullptr, drop = thresh != 0;
  void (*rows)(Args) = drop ? attn_tc_rows<true, true>
                            : kbias ? attn_tc_rows<true, false> : attn_tc_rows<false, false>;
  void (*cols)(Args) = drop ? attn_tc_cols<true, true>
                            : kbias ? attn_tc_cols<true, false> : attn_tc_cols<false, false>;
  cudaError_t err = launch(rows, grid, 1024 + 2 * TILE_BYTES + STAGES * rows_stage(dense, kbias),
                           st, a);
  if (err != cudaSuccess) return (int)err;
  err = launch(cols, grid,
               1024 + 2 * TILE_BYTES + STAGES * cols_stage(dense) + cols_tail(kbias, drop), st, a);
  if (err != cudaSuccess) return (int)err;
  if (dbias) {
    const size_t elems = (size_t)bias_heads * n * n;
    attn_tc_dbias<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(a);
  }
  if (dkb) attn_tc_dkb<<<(B * n + 255) / 256, 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}
