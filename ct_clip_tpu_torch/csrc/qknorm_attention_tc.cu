// qknorm_attention_tc.cu — the bf16 attention core of the CTViT QK-norm
// sublayer's backward on the Hopper tensor cores, at head dim 32: from the
// raw projections q, k, v and dO (the gradient of the merged heads) it
// writes the merged heads, dq and dk through the per-head l2norm and
// scales, dv, the partial sums of dq_scale and dk_scale and the (heads, n,
// n) bias gradient summed over all sequences.  Every product is a `wgmma`
// (sm_90a) with bf16 operands and f32 accumulators, its tiles staged with
// cp.async into 128-byte-swizzled shared memory behind a ring of mbarriers
// (the machinery of attention_tc.cu, shared through wgmma.cuh).
//
// Replaces, in bf16 at head dim 32 and at least 32 tokens
// (ops/kernels::qk_bwd_tensor_cores), the core of
// ct_clip_tpu/ops/pallas/spatial_attention.py::_pallas_spatial_bwd (K9,
// :297, pallas_call :320, body _bwd_kernel :138-253): the 576-token planes
// of CT-CLIP and the 64-token planes of the autoencoder, with the CPB bias
// or without one.  qknorm_attention_bwd.cu's CUDA-core
// qk_attention_bwd_kernel keeps every other shape (K10's 16-24-token
// sequences) and its f32 form every f32 call.
//
// Math per (sequence, head), at the TPU kernel's rounding points: qn =
// bf16(l2norm(q) qs) with qs including the logit scale 8, kn =
// bf16(l2norm(k) ks), k and v from the pre-norm x; S = qn kn^T + bias (f32);
// P normalised in f32, then cast to bf16 for merged = bf16(P) v and dv =
// bf16(P)^T dO (:176); dP = dO v^T; D_i = sum_j P_ij dP_ij from the f32 P,
// never from the merged heads (a D_i from a bf16 P leaves every dS row off
// its zero sum, which dbias collects); dS = P (dP - D), dbias += dS in f32,
// then bf16(dS) for dqn = dS kn and dkn = dS^T qn (:189); the l2norm
// backward (:200-211): dq = r (dqhat - qhat (qhat . dqhat)) with dqhat = dqn
// qs and r = 1 / max(|q|, 1e-12), and dq_scale += dqn qhat per dim.
//
// What bounds it on the H100.  At CT-CLIP's batch 8 the core runs 192
// planes x 8 heads of 576 x 576 scores over 32 dims: six n^2 d products per
// (plane, head), 196 GFLOP (0.2 ms on the bf16 tensor cores), against ~60 MB
// of q, k, v, dO and ~226 MB of outputs (0.09 ms).  The CUDA-core kernel
// it replaces takes 51.4 ms there.  Measured (kernel-only, NVIDIA H100 80GB
// HBM3 at 700 W, tools/port_attention_tc_probe.py --kernel k9): 5.83 ms (pre-pass 0.08, row
// pass 2.65, column pass 1.57, dbias pass 1.50); copies without the
// products take 1.07 ms less in the row pass and 0.72 in the column pass
// (each product's latency sits between a warpgroup's elementwise work, two
// CTAs per SM), copies without the loads no less.  So the elementwise work
// (four exponentials per score: two in the row pass, one each in the column
// and dbias passes) and the exposed product latency hold it.
//
// Design (four launches):
//   * A pre-pass writes qn and kn once, compact (S, H, n, 32) bf16, with each
//     row's inverse norm (four threads a row, eight dims each).
//   * A 32-wide bf16 row is 64 bytes, half a swizzled 128-byte tile row, so
//     two operands share one tile: [qn | dO] (chunks 0-3 and 4-7 of a row)
//     and [kn | v].  S = qn kn^T and dP = dO v^T are each two k16 slices of
//     one K-major pair of tiles (byte offsets 0 and 64); the products with
//     the pair as an MN-major B operand give both halves at once (bf16(P)
//     [kn | v] holds P v in columns 32-63, bf16(dS) [kn | v] holds dS kn in
//     columns 0-31), half of each product thrown away: the tensor cores are
//     not what holds the kernel.
//   * Row pass (one CTA per 64-query tile of a (sequence, head), a consumer
//     warpgroup and a producer warp): the key tiles are streamed twice.
//     The first sweep keeps an online softmax of S + bias (row max m, sum
//     l) and D = sum_j exp(s - m) dP rescaled with m, so lse = m + log l
//     and D_i = D / l come from the f32 P; the second forms P = exp(S + bias
//     - lse) and dS = P (dP - D) and accumulates the merged heads and dqn,
//     then the l2norm backward, dq and the CTA's dq_scale partial (32 sums,
//     rows in a fixed order).  lse and D_i go to (S, H, n) f32 buffers.
//   * Column pass (one CTA per 64-key tile): S^T and dP^T against streamed
//     query tiles, P^T from lse, dS^T from D, dv = bf16(P^T) dO and dkn =
//     bf16(dS^T) qn; the l2norm backward, dk, dv and the dk_scale partial.
//   * dbias pass (one CTA per (64 x 64 bias tile, head, group of
//     sequences)): recomputes S and dP on the tensor cores for each
//     sequence of its group in order, P from lse, and adds dS = P (dP - D)
//     in f32 registers; the groups' partials (one group at 576 tokens) are
//     added in order by ct_sum_splits.  No n^2 scratch, no atomics: every
//     output is bit-identical from run to run.
//   * Ragged n: tiles are zero-filled past n, keys past n score -inf (first
//     sweep) or P = 0; rows past n are not written.
//
// The forward pass (ct_qk_attention_tc_fwd) replaces, in bf16 at the same
// shapes, the core of ct_clip_tpu/ops/pallas/spatial_attention.py::
// _pallas_spatial (K1, :276, pallas_call :285, body _kernel :111-135), which
// attention.cu's attention_kernel ran on the CUDA cores (it keeps K2's
// 16-24-token sequences).  The pre-pass above writes qn and kn; then one CTA
// per 64-query tile of a (sequence, head), a consumer warpgroup and the
// producer warp, streams the [kn | v] key tiles once with the bias tile
// staged as the row pass stages it: S = qn kn^T + bias on `wgmma` in f32, an
// online softmax (running max m and sum l in f32), e = exp(S - m) rounded to
// bf16 as the A operand of e [kn | v] (columns 32-63 hold e v), the output
// rescaled by exp(m_old - m) before each tile's share; merged = bf16(O / l)
// in q's strides.  The TPU rounds exp(S - rowmax) with the row's final max
// (spatial_attention.py:125-130); this one sweep rounds exp(S - running
// max), the same bf16 rounding at another scale (K13a's forward does the
// same), and divides by the f32 sum of the unrounded exponentials as the TPU
// does.  At zero-shot's batch of 2 the core is 48 planes x 8 heads of 576 x
// 576 scores: two n^2 d products, 16.3 GFLOP (16 us at the bf16 peak), and
// 127 M exponentials, against ~40 MB of q, k, v, the bias and merged.
#include "common.cuh"
#include "wgmma.cuh"

// 1 in a one-change copy for the card checks (kernels.copy_library): the
// row pass sums D_i from bf16(P), which the dbias row sums must catch
#ifndef CT_QK_TC_D_FROM_BF16_P
#define CT_QK_TC_D_FROM_BF16_P 0
#endif

namespace {

constexpr int HD = 32;                   // head dim
constexpr int TILE = TC_TILE;            // query or key rows per tile
constexpr int TILE_BYTES = TILE * 128;   // 64 rows of [32 | 32] bf16
constexpr int STAGES = 2;                // ring depth, row and column passes
constexpr int DB_STAGES = 3;             // ring depth, dbias pass
constexpr int WG = 128;                  // consumer threads: one warpgroup
constexpr int NT = WG + 32;              // + the producer warp
constexpr int LD_ROWS = 72;              // floats per staged bias row, read along keys
constexpr int LD_COLS = 68;              // ... read along queries (column pass)

// bytes of one ring stage: [kn | v] and the bias tile (row pass); [qn | dO],
// the bias tile, lse and D (column pass); [qn | dO], [kn | v], lse and D
// (dbias pass, whose bias tile stays in front of the ring)
__host__ __device__ constexpr int rows_stage(bool bias) {
  return round1024(TILE_BYTES + (bias ? TILE * LD_ROWS * 4 : 0));
}
__host__ __device__ constexpr int cols_stage(bool bias) {
  return round1024(TILE_BYTES + (bias ? TILE * LD_COLS * 4 : 0) + 2 * TILE * 4);
}
constexpr int DB_STAGE = round1024(2 * TILE_BYTES + 2 * TILE * 4);
constexpr int DB_BIAS = round1024(TILE * LD_ROWS * 4);

struct Args {
  const bf16 *q, *k, *v, *dout;
  bf16 *merged, *dq, *dk, *dv;
  long long q_outer, q_inner, q_head, q_tok;
  long long kv_outer, kv_inner, kv_head, kv_tok;
  int inner, S, H, n, tiles, groups;
  const float* qs;     // (32,) q scale times the logit scale
  const float* ks;     // (32,) k scale
  const float* bias;   // (H, n, n), or null
  bf16* qn;            // (S, H, n, 32) bf16(l2norm(q) qs)
  bf16* kn;            // (S, H, n, 32) bf16(l2norm(k) ks)
  float* rq;           // (S, H, n) 1 / max(|q|, 1e-12)
  float* rk;           // (S, H, n) 1 / max(|k|, 1e-12)
  float* lse;          // (S, H, n): written by the row pass
  float* rowsum;       // (S, H, n) D_i: written by the row pass
  float* dbias_part;   // (groups, H, n, n), or null
  float* dqs_part;     // (S H tiles, 32)
  float* dks_part;     // (S H tiles, 32)
};

// head h of sequence s of q (dO, merged, dq alike) and of k (v, dk, dv)
__device__ __forceinline__ size_t q_at(const Args& a, int s, int h) {
  return (size_t)(s / a.inner) * a.q_outer + (size_t)(s % a.inner) * a.q_inner
         + (size_t)h * a.q_head;
}
__device__ __forceinline__ size_t kv_at(const Args& a, int s, int h) {
  return (size_t)(s / a.inner) * a.kv_outer + (size_t)(s % a.inner) * a.kv_inner
         + (size_t)h * a.kv_head;
}

// rows [r0, r0 + 64) of two (token, 32) bf16 views -> one swizzled tile of
// 128-byte rows: chunks 0-3 from `x` (token stride sx), 4-7 from `y`
// (stride sy); rows at n and beyond are zero
__device__ __forceinline__ void load_pair(uint32_t dst, const bf16* x, long long sx,
                                          const bf16* y, long long sy, int r0, int n,
                                          int lane) {
#pragma unroll 4
  for (int e = lane; e < TILE * 8; e += 32) {
    const int r = e >> 3, c = e & 7, t = r0 + r;
    const bool ok = t < n;
    const bf16* src = c < 4 ? x + (ok ? (long long)t * sx : 0) + c * 8
                            : y + (ok ? (long long)t * sy : 0) + (c - 4) * 8;
    cp16(dst + r * 128 + ((c ^ (r & 7)) << 4), src, ok ? 16 : 0);
  }
}

// S = A B^T and dP = A' B'^T of one pair of [x | y] tiles: A, B the first
// halves (k16 slices at bytes 0 and 32), A', B' the second (64 and 96)
__device__ __forceinline__ void s_and_dp(float (&s_)[32], float (&dp)[32], uint32_t a,
                                         uint32_t b) {
  hold(s_);
  hold(dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) mma_ss(s_, desc(a + 32 * kk), desc(b + 32 * kk), kk);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) mma_ss(dp, desc(a + 64 + 32 * kk), desc(b + 64 + 32 * kk), kk);
  wg_commit();
  wg_wait();
  hold(s_);
  hold(dp);
}

// x += bf16(p) T and y += bf16(ds) T for a [.. | ..] tile T at `t` read
// MN-major (64 rows of the product's k)
__device__ __forceinline__ void pd_products(float (&x)[32], float (&y)[32], const float (&p)[32],
                                            const float (&ds)[32], uint32_t t) {
  uint32_t pa[4][4], da[4][4];
  to_a(p, pa);
  to_a(ds, da);
  hold(x);
  hold(y);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(x, pa[kk], desc(t + 2048 * kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(y, da[kk], desc(t + 2048 * kk));
  wg_commit();
  wg_wait();
  hold(x);
  hold(y);
  hold(pa);
  hold(da);
}

template <int RING>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, uint64_t* once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      bar_init(&full[s], 32);
      bar_init(&empty[s], WG);
    }
    bar_init(once, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the l2norm backward of one row held by a quad (this thread's dims 8 j + 2
// q4 + u, j < 4, u < 2): dn the f32 product (dqn or dkn) in accumulator
// elements 4 j + 2 hi + u, x the raw bf16 row, r its inverse norm, sc the
// scale.  Writes bf16 r (dxhat - xhat (xhat . dxhat)) at out when `ok` and
// adds dn xhat to the scale partial acc.  Every lane of the warp calls it.
__device__ __forceinline__ void l2norm_bwd(const float (&dn)[32], int hi, const bf16* x, float r,
                                           const float* sc, bf16* out, bool ok, int q4,
                                           float (&acc)[8]) {
  float xh[8], dh[8], dot = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 8 * j + 2 * q4;
    const float2 xf = __bfloat1622float2(*reinterpret_cast<const bf162*>(x + c));
    xh[2 * j] = xf.x * r;
    xh[2 * j + 1] = xf.y * r;
    dh[2 * j] = dn[4 * j + 2 * hi] * sc[c];
    dh[2 * j + 1] = dn[4 * j + 2 * hi + 1] * sc[c + 1];
    dot = fmaf(xh[2 * j], dh[2 * j], dot);
    dot = fmaf(xh[2 * j + 1], dh[2 * j + 1], dot);
  }
  dot = sum4(dot);
  if (!ok) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<bf162*>(out + 8 * j + 2 * q4) = __floats2bfloat162_rn(
        r * (dh[2 * j] - xh[2 * j] * dot), r * (dh[2 * j + 1] - xh[2 * j + 1] * dot));
#pragma unroll
    for (int u = 0; u < 2; ++u)
      acc[2 * j + u] = fmaf(dn[4 * j + 2 * hi + u], xh[2 * j + u], acc[2 * j + u]);
  }
}

// the CTA's 32 scale sums (acc: this thread's dims 8 j + 2 q4 + u) over its
// rows in a fixed order -> part[0..31]; the consumer warpgroup only
__device__ __forceinline__ void scale_partial(float (&acc)[8], float (&red)[4][HD], float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 4);
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 8);
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 16);
  }
  if (lane < 4)
#pragma unroll
    for (int k = 0; k < 8; ++k) red[warp][8 * (k >> 1) + 2 * q4 + (k & 1)] = acc[k];
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (threadIdx.x < HD)
    part[threadIdx.x] = red[0][threadIdx.x] + red[1][threadIdx.x] + red[2][threadIdx.x]
                        + red[3][threadIdx.x];
}

// ------------------------------------------------------------- pre-pass
// qn, kn and the inverse norms of every (sequence, head, token): four
// threads a row, eight dims each
__global__ void __launch_bounds__(256) qk_tc_norm(Args a) {
  const long long rows = (long long)a.S * a.H * a.n;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool ok = (gid >> 2) < rows;
  const long long row = ok ? gid >> 2 : 0;
  const int c = (int)(gid & 3) * 8;
  const int t = (int)(row % a.n), sh = (int)(row / a.n), h = sh % a.H, s = sh / a.H;
  const uint4 qv = *reinterpret_cast<const uint4*>(a.q + q_at(a, s, h) + (size_t)t * a.q_tok + c);
  const uint4 kv = *reinterpret_cast<const uint4*>(a.k + kv_at(a, s, h) + (size_t)t * a.kv_tok + c);
  const bf162* q2 = reinterpret_cast<const bf162*>(&qv);
  const bf162* k2 = reinterpret_cast<const bf162*>(&kv);
  float x[8], y[8], sq = 0.0f, sk = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 qf = __bfloat1622float2(q2[i]), kf = __bfloat1622float2(k2[i]);
    x[2 * i] = qf.x; x[2 * i + 1] = qf.y;
    y[2 * i] = kf.x; y[2 * i + 1] = kf.y;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sq += x[i] * x[i];
    sk += y[i] * y[i];
  }
  const float fq = rsqrtf(fmaxf(sum4(sq), 1e-24f)), fk = rsqrtf(fmaxf(sum4(sk), 1e-24f));
  if (!ok) return;
  uint4 oq, ok4;
  bf162* o2 = reinterpret_cast<bf162*>(&oq);
  bf162* p2 = reinterpret_cast<bf162*>(&ok4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o2[i] = __floats2bfloat162_rn(x[2 * i] * fq * a.qs[c + 2 * i],
                                  x[2 * i + 1] * fq * a.qs[c + 2 * i + 1]);
    p2[i] = __floats2bfloat162_rn(y[2 * i] * fk * a.ks[c + 2 * i],
                                  y[2 * i + 1] * fk * a.ks[c + 2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(a.qn + row * HD + c) = oq;
  *reinterpret_cast<uint4*>(a.kn + row * HD + c) = ok4;
  if (c == 0) {
    a.rq[row] = fq;
    a.rk[row] = fk;
  }
}

// ------------------------------------------------------------- row pass
// One CTA per (64-query tile, sequence, head).  Shared memory: [qn | dO],
// then STAGES x [[kn | v] | bias tile], the key tiles streamed twice.
template <bool BIAS>
__global__ void __launch_bounds__(NT, 2) qk_tc_rows(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;
  __shared__ float red[4][HD];
  uint8_t* sqo = align1024(smem_raw);
  constexpr int stage = rows_stage(BIAS);
  const int n = a.n, tiles = a.tiles;
  const int i0 = (blockIdx.x % tiles) * TILE, sh = blockIdx.x / tiles;
  const int h = sh % a.H, s = sh / a.H;
  const size_t qo = q_at(a, s, h);
  init_ring<STAGES>(full, empty, &qbar);

  if (threadIdx.x >= WG) {  // the producer warp
    const int lane = threadIdx.x - WG;
    const bf16* kn = a.kn + (size_t)sh * n * HD;
    const bf16* v = a.v + kv_at(a, s, h);
    load_pair(saddr(sqo), a.qn + (size_t)sh * n * HD, HD, a.dout + qo, a.q_tok, i0, n, lane);
    bar_arrive_copies(&qbar);
    for (int t = 0; t < 2 * tiles; ++t) {
      const int st = t % STAGES, j0 = (t % tiles) * TILE;
      if (t >= STAGES) bar_wait(&empty[st], (t / STAGES - 1) & 1);
      const uint32_t dst = saddr(sqo + TILE_BYTES + st * stage);
      load_pair(dst, kn, HD, v, a.kv_tok, j0, n, lane);
      if (BIAS) load_bias(dst + TILE_BYTES, a.bias + (size_t)h * n * n, n, i0, j0, LD_ROWS, lane);
      bar_arrive_copies(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows: rl, rl + 8
  float s_[32], dp[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s_[e] = dp[e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, D[2] = {0.0f, 0.0f}, lse[2];
  const uint32_t qa = saddr(sqo);
  bar_wait(&qbar, 0);

  // first sweep, an online softmax: m, l and D = sum_j exp(s - m) dP, f32
  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, j0 = t * TILE;
    uint8_t* stp = sqo + TILE_BYTES + st * stage;
    bar_wait(&full[st], (t / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    s_and_dp(s_, dp, qa, saddr(stp));
    const float* sb = reinterpret_cast<const float*>(stp + TILE_BYTES);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      float x = s_[e];
      if (BIAS) x += sb[(rl + 8 * hi) * LD_ROWS + col];
      x = j0 + col < n ? x : -INFINITY;
      s_[e] = x;
      mx[hi] = fmaxf(mx[hi], x);
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      // key j0 < n lies in this tile, so the new max is finite
      const float mn = fmaxf(m[hi], max4(mx[hi]));
      const float corr = fexp2((m[hi] - mn) * LOG2E);  // 0 before the first tile
      m[hi] = mn;
      l[hi] *= corr;
      D[hi] *= corr;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e);
      const float p = fexp2((s_[e] - m[hi]) * LOG2E);
      l[hi] += p;
      D[hi] = fmaf(CT_QK_TC_D_FROM_BF16_P ? round_bf16(p) : p, dp[e], D[hi]);
    }
    bar_arrive(&empty[st]);
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float sum = sum4(l[hi]);
    lse[hi] = m[hi] + log2f(sum) * LN2;
    D[hi] = sum4(D[hi]) / sum;
    const int i = i0 + rl + 8 * hi;
    if (q4 == 0 && i < n) {
      a.lse[(size_t)sh * n + i] = lse[hi];
      a.rowsum[(size_t)sh * n + i] = D[hi];
    }
  }

  // second sweep: P and dS = P (dP - D); merged += bf16(P) [kn | v]
  // (columns 32-63), dqn += bf16(dS) [kn | v] (columns 0-31)
  float mo[32], dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) mo[e] = dq[e] = 0.0f;
  for (int t = tiles; t < 2 * tiles; ++t) {
    const int st = t % STAGES, j0 = (t - tiles) * TILE;
    uint8_t* stp = sqo + TILE_BYTES + st * stage;
    bar_wait(&full[st], (t / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t ka = saddr(stp);
    s_and_dp(s_, dp, qa, ka);
    const float* sb = reinterpret_cast<const float*>(stp + TILE_BYTES);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      const float bias = BIAS ? sb[(rl + 8 * hi) * LD_ROWS + col] : 0.0f;
      const float p = prob(s_[e], bias, lse[hi], j0 + col < n);
      dp[e] = p * (dp[e] - D[hi]);
      s_[e] = p;
    }
    pd_products(mo, dq, s_, dp, ka);
    bar_arrive(&empty[st]);
  }

  float acc[8] = {};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = i0 + rl + 8 * hi;
    const bool ok = i < n;
    const int ic = ok ? i : n - 1;
    l2norm_bwd(dq, hi, a.q + qo + (size_t)ic * a.q_tok, a.rq[(size_t)sh * n + ic], a.qs,
               a.dq + qo + (size_t)ic * a.q_tok, ok, q4, acc);
    if (!ok) continue;
    bf16* out = a.merged + qo + (size_t)i * a.q_tok;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<bf162*>(out + 8 * j + 2 * q4) =
          __floats2bfloat162_rn(mo[4 * (j + 4) + 2 * hi], mo[4 * (j + 4) + 2 * hi + 1]);
  }
  scale_partial(acc, red, a.dqs_part + (size_t)blockIdx.x * HD);
}

// ---------------------------------------------------------- column pass
// One CTA per (64-key tile, sequence, head); its rows are keys, its columns
// queries.  Shared memory: [kn | v], then STAGES x [[qn | dO] | bias tile
// (rows queries) | lse | D].
template <bool BIAS>
__global__ void __launch_bounds__(NT, 2) qk_tc_cols(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kvbar;
  __shared__ float red[4][HD];
  uint8_t* skv = align1024(smem_raw);
  constexpr int stage = cols_stage(BIAS);
  constexpr int bias_bytes = BIAS ? TILE * LD_COLS * 4 : 0;
  const int n = a.n, tiles = a.tiles;
  const int j0 = (blockIdx.x % tiles) * TILE, sh = blockIdx.x / tiles;
  const int h = sh % a.H, s = sh / a.H;
  const size_t kvo = kv_at(a, s, h);
  init_ring<STAGES>(full, empty, &kvbar);

  if (threadIdx.x >= WG) {
    const int lane = threadIdx.x - WG;
    const bf16* qn = a.qn + (size_t)sh * n * HD;
    const bf16* dout = a.dout + q_at(a, s, h);
    load_pair(saddr(skv), a.kn + (size_t)sh * n * HD, HD, a.v + kvo, a.kv_tok, j0, n, lane);
    bar_arrive_copies(&kvbar);
    for (int t = 0; t < tiles; ++t) {
      const int st = t % STAGES, i0 = t * TILE;
      if (t >= STAGES) bar_wait(&empty[st], (t / STAGES - 1) & 1);
      const uint32_t dst = saddr(skv + TILE_BYTES + st * stage);
      load_pair(dst, qn, HD, dout, a.q_tok, i0, n, lane);
      if (BIAS) load_bias(dst + TILE_BYTES, a.bias + (size_t)h * n * n, n, i0, j0, LD_COLS, lane);
      load_vec(dst + TILE_BYTES + bias_bytes, a.lse + (size_t)sh * n, i0, n, lane);
      load_vec(dst + TILE_BYTES + bias_bytes + TILE * 4, a.rowsum + (size_t)sh * n, i0, n,
               lane);
      bar_arrive_copies(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's keys: j0 + rl, + 8
  float s_[32], dp[32], dk[32], dv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s_[e] = dp[e] = dk[e] = dv[e] = 0.0f;
  const uint32_t ka = saddr(skv);
  bar_wait(&kvbar, 0);

  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, i0 = t * TILE;
    uint8_t* stp = skv + TILE_BYTES + st * stage;
    bar_wait(&full[st], (t / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t qa = saddr(stp);
    s_and_dp(s_, dp, ka, qa);
    const float* sb = reinterpret_cast<const float*>(stp + TILE_BYTES);
    const float* slse = reinterpret_cast<const float*>(stp + TILE_BYTES + bias_bytes);
    const float* sd = slse + TILE;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), jl = rl + 8 * hi, il = acc_col(e, q4);
      const float bias = BIAS ? sb[il * LD_COLS + jl] : 0.0f;
      const float p = prob(s_[e], bias, slse[il], i0 + il < n && j0 + jl < n);
      dp[e] = p * (dp[e] - sd[il]);
      s_[e] = p;
    }
    // dv += bf16(P^T) [qn | dO] (columns 32-63), dkn += bf16(dS^T) [qn | dO]
    // (columns 0-31)
    pd_products(dv, dk, s_, dp, qa);
    bar_arrive(&empty[st]);
  }

  float acc[8] = {};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int j = j0 + rl + 8 * hi;
    const bool ok = j < n;
    const int jc = ok ? j : n - 1;
    l2norm_bwd(dk, hi, a.k + kvo + (size_t)jc * a.kv_tok, a.rk[(size_t)sh * n + jc], a.ks,
               a.dk + kvo + (size_t)jc * a.kv_tok, ok, q4, acc);
    if (!ok) continue;
    bf16* out = a.dv + kvo + (size_t)j * a.kv_tok;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<bf162*>(out + 8 * c + 2 * q4) =
          __floats2bfloat162_rn(dv[4 * (c + 4) + 2 * hi], dv[4 * (c + 4) + 2 * hi + 1]);
  }
  scale_partial(acc, red, a.dks_part + (size_t)blockIdx.x * HD);
}

// ----------------------------------------------------------- dbias pass
// One CTA per (64 x 64 tile of the bias, head, group of sequences): S and dP
// of the tile for each sequence of the group in order, dS = P (dP - D)
// added in f32.  Shared memory: the bias tile, then DB_STAGES x [[qn | dO]
// query tile | [kn | v] key tile | lse | D].
__global__ void __launch_bounds__(NT, 3) qk_tc_dbias(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[DB_STAGES], empty[DB_STAGES], bbar;
  uint8_t* sbias = align1024(smem_raw);
  uint8_t* ring = sbias + DB_BIAS;
  const int n = a.n, tiles = a.tiles, h = blockIdx.y;
  const int i0 = (blockIdx.x / tiles) * TILE, j0 = (blockIdx.x % tiles) * TILE;
  const int per = (a.S + a.groups - 1) / a.groups;
  const int s0 = blockIdx.z * per, s1 = min(a.S, s0 + per);
  init_ring<DB_STAGES>(full, empty, &bbar);

  if (threadIdx.x >= WG) {
    const int lane = threadIdx.x - WG;
    load_bias(saddr(sbias), a.bias + (size_t)h * n * n, n, i0, j0, LD_ROWS, lane);
    bar_arrive_copies(&bbar);
    for (int s = s0; s < s1; ++s) {
      const int t = s - s0, st = t % DB_STAGES;
      const size_t sh = (size_t)s * a.H + h;
      if (t >= DB_STAGES) bar_wait(&empty[st], (t / DB_STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * DB_STAGE);
      load_pair(dst, a.qn + sh * n * HD, HD, a.dout + q_at(a, s, h), a.q_tok, i0, n, lane);
      load_pair(dst + TILE_BYTES, a.kn + sh * n * HD, HD, a.v + kv_at(a, s, h), a.kv_tok, j0, n,
                lane);
      load_vec(dst + 2 * TILE_BYTES, a.lse + sh * n, i0, n, lane);
      load_vec(dst + 2 * TILE_BYTES + TILE * 4, a.rowsum + sh * n, i0, n, lane);
      bar_arrive_copies(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);
  float s_[32], dp[32], acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s_[e] = dp[e] = acc[e] = 0.0f;
  const float* sb = reinterpret_cast<const float*>(sbias);
  bar_wait(&bbar, 0);

  for (int s = s0; s < s1; ++s) {
    const int t = s - s0, st = t % DB_STAGES;
    uint8_t* stp = ring + st * DB_STAGE;
    bar_wait(&full[st], (t / DB_STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t qa = saddr(stp);
    s_and_dp(s_, dp, qa, qa + TILE_BYTES);
    const float* slse = reinterpret_cast<const float*>(stp + 2 * TILE_BYTES);
    const float lse[2] = {slse[rl], slse[rl + 8]};
    const float D[2] = {slse[TILE + rl], slse[TILE + rl + 8]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      const float p = prob(s_[e], sb[(rl + 8 * hi) * LD_ROWS + col], lse[hi],
                           i0 + rl + 8 * hi < n && j0 + col < n);
      acc[e] += __fmul_rn(p, dp[e] - D[hi]);  // dS rounded to f32, then added
    }
    bar_arrive(&empty[st]);
  }

  float* out = a.dbias_part + ((size_t)blockIdx.z * a.H + h) * n * n;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = i0 + rl + 8 * hi;
    if (i >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j0 + 8 * j + 2 * q4;
      const float x = acc[4 * j + 2 * hi], y = acc[4 * j + 2 * hi + 1];
      if ((n & 1) == 0 && c + 1 < n) {
        *reinterpret_cast<float2*>(out + (size_t)i * n + c) = make_float2(x, y);
      } else {
        if (c < n) out[(size_t)i * n + c] = x;
        if (c + 1 < n) out[(size_t)i * n + c + 1] = y;
      }
    }
  }
}

// ---------------------------------------------------------- forward pass
// S = A B^T of the first halves of two [x | y] tiles (k16 slices at bytes 0
// and 32)
__device__ __forceinline__ void scores_only(float (&s_)[32], uint32_t a, uint32_t b) {
  hold(s_);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) mma_ss(s_, desc(a + 32 * kk), desc(b + 32 * kk), kk);
  wg_commit();
  wg_wait();
  hold(s_);
}

// x += bf16(p) T for a [.. | ..] tile T at `t` read MN-major
__device__ __forceinline__ void p_product(float (&x)[32], const float (&p)[32], uint32_t t) {
  uint32_t pa[4][4];
  to_a(p, pa);
  hold(x);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(x, pa[kk], desc(t + 2048 * kk));
  wg_commit();
  wg_wait();
  hold(x);
  hold(pa);
}

// One CTA per (64-query tile, sequence, head), three a SM.  Shared memory:
// [qn | qn] (S reads the first half), then STAGES x [[kn | v] | bias tile],
// the key tiles streamed once.
template <bool BIAS>
__global__ void __launch_bounds__(NT, 3) qk_tc_fwd(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;
  uint8_t* sq = align1024(smem_raw);
  constexpr int stage = rows_stage(BIAS);
  const int n = a.n, tiles = a.tiles;
  const int i0 = (blockIdx.x % tiles) * TILE, sh = blockIdx.x / tiles;
  const int h = sh % a.H, s = sh / a.H;
  init_ring<STAGES>(full, empty, &qbar);

  if (threadIdx.x >= WG) {  // the producer warp
    const int lane = threadIdx.x - WG;
    const bf16* qn = a.qn + (size_t)sh * n * HD;
    const bf16* kn = a.kn + (size_t)sh * n * HD;
    const bf16* v = a.v + kv_at(a, s, h);
    load_pair(saddr(sq), qn, HD, qn, HD, i0, n, lane);
    bar_arrive_copies(&qbar);
    for (int t = 0; t < tiles; ++t) {
      const int st = t % STAGES, j0 = t * TILE;
      if (t >= STAGES) bar_wait(&empty[st], (t / STAGES - 1) & 1);
      const uint32_t dst = saddr(sq + TILE_BYTES + st * stage);
      load_pair(dst, kn, HD, v, a.kv_tok, j0, n, lane);
      if (BIAS) load_bias(dst + TILE_BYTES, a.bias + (size_t)h * n * n, n, i0, j0, LD_ROWS, lane);
      bar_arrive_copies(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows: rl, rl + 8
  float s_[32], mo[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s_[e] = mo[e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const uint32_t qa = saddr(sq);
  bar_wait(&qbar, 0);

  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, j0 = t * TILE;
    uint8_t* stp = sq + TILE_BYTES + st * stage;
    bar_wait(&full[st], (t / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t ka = saddr(stp);
    scores_only(s_, qa, ka);
    const float* sb = reinterpret_cast<const float*>(stp + TILE_BYTES);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      float x = s_[e];
      if (BIAS) x += sb[(rl + 8 * hi) * LD_ROWS + col];
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
      l[hi] += p;
      s_[e] = p;
      mo[e] *= corr[hi];
    }
    // O += bf16(e) [kn | v]: columns 32-63 hold e v
    p_product(mo, s_, ka);
    bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float sum = sum4(l[hi]);
    const int i = i0 + rl + 8 * hi;
    if (i >= n) continue;
    bf16* out = a.merged + q_at(a, s, h) + (size_t)i * a.q_tok;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<bf162*>(out + 8 * j + 2 * q4) = __floats2bfloat162_rn(
          mo[4 * (j + 4) + 2 * hi] / sum, mo[4 * (j + 4) + 2 * hi + 1] / sum);
  }
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

// Addressing and outputs as ct_qk_attention_bwd (qknorm_attention_bwd.cu),
// bf16, head dim 32: every stride a multiple of 8 elements, q, k, v, dout,
// merged, dq, dk, dv 16-byte aligned.  Scratch: qn, kn (S, H, n, 32) bf16;
// rq, rk, lse, rowsum (S, H, n) f32.  dbias_part (groups, H, n, n) f32,
// given with bias, 1 <= groups <= sequences; dqs_part and dks_part (S H
// ceil(n / 64), 32) f32.
CT_EXPORT int ct_qk_attention_tc_bwd(const void* q, const void* k, const void* v,
                                     const void* dout, void* merged, void* dq, void* dk,
                                     void* dv, long long q_outer, long long q_inner,
                                     long long q_head, long long q_tok, long long kv_outer,
                                     long long kv_inner, long long kv_head, long long kv_tok,
                                     int inner, int sequences, int heads, int n, int d,
                                     const void* q_scale, const void* k_scale, const void* bias,
                                     void* qn, void* kn, void* rq, void* rk, void* lse,
                                     void* rowsum, void* dbias_part, int groups, void* dqs_part,
                                     void* dks_part, void* stream) {
  const long long strides[] = {q_outer, q_inner, q_head, q_tok,
                               kv_outer, kv_inner, kv_head, kv_tok};
  bool ok = d == HD && n > 0 && heads > 0 && sequences > 0 && inner > 0
            && (bias != nullptr) == (dbias_part != nullptr)
            && (!bias || (groups >= 1 && groups <= sequences));
  for (long long s : strides) ok = ok && s % 8 == 0;
  const void* ptrs[] = {q, k, v, dout, merged, dq, dk, dv, qn, kn};
  for (const void* p : ptrs) ok = ok && aligned16(p);
  const int tiles = (n + TILE - 1) / TILE;
  const long long ctas = (long long)tiles * sequences * heads;
  const long long rows = (long long)sequences * heads * n;
  if (!ok || ctas > 2147483647LL || rows * 4 > 2147483647LL * 256)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v); a.dout = static_cast<const bf16*>(dout);
  a.merged = static_cast<bf16*>(merged); a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk); a.dv = static_cast<bf16*>(dv);
  a.q_outer = q_outer; a.q_inner = q_inner; a.q_head = q_head; a.q_tok = q_tok;
  a.kv_outer = kv_outer; a.kv_inner = kv_inner; a.kv_head = kv_head; a.kv_tok = kv_tok;
  a.inner = inner; a.S = sequences; a.H = heads; a.n = n; a.tiles = tiles;
  a.groups = bias ? groups : 1;
  a.qs = static_cast<const float*>(q_scale);
  a.ks = static_cast<const float*>(k_scale);
  a.bias = static_cast<const float*>(bias);
  a.qn = static_cast<bf16*>(qn); a.kn = static_cast<bf16*>(kn);
  a.rq = static_cast<float*>(rq); a.rk = static_cast<float*>(rk);
  a.lse = static_cast<float*>(lse); a.rowsum = static_cast<float*>(rowsum);
  a.dbias_part = static_cast<float*>(dbias_part);
  a.dqs_part = static_cast<float*>(dqs_part);
  a.dks_part = static_cast<float*>(dks_part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  qk_tc_norm<<<(unsigned)((rows * 4 + 255) / 256), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ctas);
  err = launch(bias ? qk_tc_rows<true> : qk_tc_rows<false>, grid,
               1024 + TILE_BYTES + STAGES * rows_stage(bias != nullptr), st, a);
  if (err != cudaSuccess) return (int)err;
  err = launch(bias ? qk_tc_cols<true> : qk_tc_cols<false>, grid,
               1024 + TILE_BYTES + STAGES * cols_stage(bias != nullptr), st, a);
  if (err != cudaSuccess || !bias) return (int)err;
  return (int)launch(qk_tc_dbias, dim3(tiles * tiles, heads, groups),
                     1024 + DB_BIAS + DB_STAGES * DB_STAGE, st, a);
}

// K1's core forward: merged (like q, bf16) = softmax(qn kn^T + bias) v per
// (sequence, head), addressed as ct_qk_attention_tc_bwd, head dim 32, every
// stride a multiple of 8 elements, q, k, v, merged, qn and kn 16-byte
// aligned.  Scratch: qn, kn (S, H, n, 32) bf16; rq, rk (S, H, n) f32 (the
// pre-pass writes them; the forward reads qn and kn).
CT_EXPORT int ct_qk_attention_tc_fwd(const void* q, const void* k, const void* v, void* merged,
                                     long long q_outer, long long q_inner, long long q_head,
                                     long long q_tok, long long kv_outer, long long kv_inner,
                                     long long kv_head, long long kv_tok, int inner,
                                     int sequences, int heads, int n, int d, const void* q_scale,
                                     const void* k_scale, const void* bias, void* qn, void* kn,
                                     void* rq, void* rk, void* stream) {
  const long long strides[] = {q_outer, q_inner, q_head, q_tok,
                               kv_outer, kv_inner, kv_head, kv_tok};
  bool ok = d == HD && n > 0 && heads > 0 && sequences > 0 && inner > 0 && rq && rk;
  for (long long s : strides) ok = ok && s % 8 == 0;
  const void* ptrs[] = {q, k, v, merged, qn, kn};
  for (const void* p : ptrs) ok = ok && aligned16(p);
  const int tiles = (n + TILE - 1) / TILE;
  const long long ctas = (long long)tiles * sequences * heads;
  const long long rows = (long long)sequences * heads * n;
  if (!ok || ctas > 2147483647LL || rows * 4 > 2147483647LL * 256)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v); a.merged = static_cast<bf16*>(merged);
  a.q_outer = q_outer; a.q_inner = q_inner; a.q_head = q_head; a.q_tok = q_tok;
  a.kv_outer = kv_outer; a.kv_inner = kv_inner; a.kv_head = kv_head; a.kv_tok = kv_tok;
  a.inner = inner; a.S = sequences; a.H = heads; a.n = n; a.tiles = tiles; a.groups = 1;
  a.qs = static_cast<const float*>(q_scale);
  a.ks = static_cast<const float*>(k_scale);
  a.bias = static_cast<const float*>(bias);
  a.qn = static_cast<bf16*>(qn); a.kn = static_cast<bf16*>(kn);
  a.rq = static_cast<float*>(rq); a.rk = static_cast<float*>(rk);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  qk_tc_norm<<<(unsigned)((rows * 4 + 255) / 256), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch(bias ? qk_tc_fwd<true> : qk_tc_fwd<false>, dim3((unsigned)ctas),
                     1024 + TILE_BYTES + STAGES * rows_stage(bias != nullptr), st, a);
}
