// qknorm_attention_tc32.cu — the f32 attention core of the CTViT QK-norm
// sublayer's backward on the Hopper tensor cores, at head dim 32, each
// product as three TF32 products (3xTF32): from the raw projections q, k, v
// and dO (the gradient of the merged heads) it writes the merged heads, dq
// and dk through the per-head l2norm and scales, dv, the partial sums of
// dq_scale and dk_scale and the (heads, n, n) bias gradient summed over all
// sequences, all in f32.
//
// Replaces, in f32 at head dim 32 and at least 32 tokens
// (ops/kernels::qk_bwd_tensor_cores), the core of
// ct_clip_tpu/ops/pallas/spatial_attention.py::_pallas_spatial_bwd (K9,
// :297, pallas_call :320, body _bwd_kernel :138-253, f32 operands at
// "highest", :323): the 576-token planes of f32 CT-CLIP training and the
// 64-token planes of the f32 autoencoder, with the CPB bias or without one.
// qknorm_attention_bwd.cu's qk_attention_bwd_f32_kernel keeps every other
// f32 shape (K10's 16-24-token sequences).
//
// Math per (sequence, head), as _bwd_kernel in f32, where its bf16
// roundings are no-ops: qn = l2norm(q) qs with qs including the logit scale
// 8, kn = l2norm(k) ks; S = qn kn^T + bias; P = softmax(S); dP = dO v^T;
// D_i = sum_j P_ij dP_ij from the f32 P; dS = P (dP - D); merged = P v, dv =
// P^T dO, dqn = dS kn, dkn = dS^T qn, dbias = sum over sequences of dS; the
// l2norm backward dq = r (dqhat - qhat (qhat . dqhat)) with dqhat = dqn qs
// and r = 1 / max(|q|, 1e-12), and dq_scale += dqn qhat per dim.  Every
// product is hi hi + hi lo + lo hi (tc32.cuh) with f32 sums; P, dP, dS, the
// softmax and every sum stay f32.
//
// What bounds it on the H100.  At f32 CT-CLIP's batch 8 the core runs 192
// planes x 8 heads of 576 x 576 scores over 32 dims: six n^2 d products per
// (plane, head), 196 GFLOP, 587 GFLOP as TF32 (1.19 ms at 495 TFLOP/s),
// against ~120 MB of q, k, v, dO and ~450 MB of outputs and dbias partials
// (0.17 ms): the tensor cores bound it.  The CUDA-core f32 kernel it
// replaces ran its products as FFMA chains at 7.6% of the f32 CUDA-core
// bound (38.5 ms; PERF.md).  Here the passes recompute S and dP (twice in
// the row pass, once in the column and the dbias passes): twelve 64 x 64 x
// 32 products per tile pair, 36 TF32 mma.sync passes, plus the split (three
// integer/ALU operations per operand element read) and the elementwise work
// (four exponentials per score).
//
// Design: qknorm_attention_tc.cu's passes with attention_tc32.cu's arithmetic.
//   * A pre-pass writes qn and kn once, compact (S, H, n, 32) f32, with each
//     row's inverse norm (four threads a row, eight dims each).
//   * A 32-wide f32 row is 128 bytes, so each operand is a tile of its own:
//     64 rows padded to 36 floats (every fragment read below hits 32
//     distinct banks), copied with cp.async by a producer warp into a ring
//     of stages behind mbarriers (wgmma.cuh's ring); four consumer warps of
//     16 rows each run mma.sync m16n8k8 TF32 (`wgmma` takes TF32 operands
//     only K-major from shared memory, and dq, dk, dv contract over tokens)
//     and split each fragment into hi and lo as it is read.
//   * Row pass (one CTA per 64-query tile of a (sequence, head)): the key
//     tiles are streamed twice.  The first sweep keeps an online softmax of
//     S + bias (row max m, sum l) and D = sum_j exp(s - m) dP rescaled with
//     m, so lse = m + log l and D_i = D / l come from the f32 P; the second
//     forms P = exp(S + bias - lse) and dS = P (dP - D), and accumulates the
//     merged heads P v and dqn = dS kn, then the l2norm backward, dq and the
//     CTA's dq_scale partial.  lse and D_i go to (S, H, n) f32 buffers.
//   * Column pass (one CTA per 64-key tile): S^T and dP^T against streamed
//     query tiles, P^T from lse, dS^T from D, dv = P^T dO and dkn = dS^T qn;
//     the l2norm backward, dk, dv and the dk_scale partial.
//   * dbias pass (one CTA per (64 x 64 bias tile, head, group of
//     sequences)): recomputes S and dP for each sequence of its group in
//     order, P from lse, and adds dS = P (dP - D) in f32 registers; the
//     groups' partials are added in order by ct_sum_splits.  No n^2
//     scratch, no atomics: every output is bit-identical from run to run.
//   * dS and P go from the accumulators into the next product's A operand
//     with no shuffle, the contraction index permuted in A and B alike
//     (attention_tc32.cu).  Each 64-token tile's share of the merged heads,
//     dq, dk and dv sums in an accumulator of its own (8 chunks x 3
//     products), added to the running sum in f32: a tensor-core accumulator
//     drifts over long contractions (attention_tc32.cu, `flush`).
//   * Ragged n: tiles are zero-filled past n, keys past n score -inf (first
//     sweep) or P = 0; rows past n are not written.
#include "common.cuh"
#include "tc32.cuh"
#include "wgmma.cuh"

namespace {

constexpr int HD = 32;                   // head dim
constexpr int TILE = TC_TILE;            // query or key rows per tile
constexpr int LDF = HD + 4;              // floats per staged row
constexpr int TILE_BYTES = TILE * LDF * 4;
constexpr int STAGES = 2;                // ring depth, every pass
constexpr int WG = 128;                  // consumer threads: four warps
constexpr int NT = WG + 32;              // + the producer warp
constexpr int LD_ROWS = 72;              // floats per staged bias row, read along keys
constexpr int LD_COLS = 68;              // ... read along queries (column pass)

// bytes of one ring stage: kn, v and the bias tile (row pass); qn, dO, the
// bias tile, lse and D (column pass); qn, dO, kn, v, lse and D (dbias pass,
// whose bias tile stays in front of the ring)
__host__ __device__ constexpr int rows_stage(bool bias) {
  return round1024(2 * TILE_BYTES + (bias ? TILE * LD_ROWS * 4 : 0));
}
__host__ __device__ constexpr int cols_stage(bool bias) {
  return round1024(2 * TILE_BYTES + (bias ? TILE * LD_COLS * 4 : 0) + 2 * TILE * 4);
}
constexpr int DB_STAGE = round1024(4 * TILE_BYTES + 2 * TILE * 4);
constexpr int DB_BIAS = round1024(TILE * LD_ROWS * 4);

struct Args {
  const float *q, *k, *v, *dout;
  float *merged, *dq, *dk, *dv;
  long long q_outer, q_inner, q_head, q_tok;
  long long kv_outer, kv_inner, kv_head, kv_tok;
  int inner, S, H, n, tiles, groups;
  const float* qs;     // (32,) q scale times the logit scale
  const float* ks;     // (32,) k scale
  const float* bias;   // (H, n, n), or null
  float* qn;           // (S, H, n, 32) l2norm(q) qs
  float* kn;           // (S, H, n, 32) l2norm(k) ks
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

// rows [r0, r0 + 64) of a (token, 32) f32 view at x (token stride st) ->
// dst, LDF floats a row; rows at n and beyond are zero
__device__ __forceinline__ void load_rows(uint32_t dst, const float* x, long long st, int r0,
                                          int n, int lane) {
#pragma unroll 4
  for (int e = lane; e < TILE * 8; e += 32) {
    const int r = e >> 3, c = e & 7, t = r0 + r;
    const bool ok = t < n;
    cp16(dst + (r * LDF + 4 * c) * 4, x + (ok ? (long long)t * st : 0) + 4 * c, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------- fragments
// Lane = 4 g + t.  A (m16 x k8) holds (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); B (k8 x n8) holds (t, g), (t + 4, g); an accumulator (m16 x n8)
// holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1): element [nb][e]
// of a 64-column accumulator tile is wgmma.cuh's element 4 nb + e.

// A from rows r0.. of a staged tile, dims 8 kk..: qn of S = qn kn^T
__device__ __forceinline__ void frag_a(const float* s, int r0, int kk, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float* p = s + (r0 + g) * LDF + 8 * kk + t;
  const float x[4] = {p[0], p[8 * LDF], p[4], p[8 * LDF + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// A from the accumulator block c (tokens 8 kk..) in the permuted order
__device__ __forceinline__ void frag_acc(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// B[k][n] = T[8 nb + n][8 kk + k] of a staged tile T: kn of S = qn kn^T
__device__ __forceinline__ void frag_bt(const float* s, int nb, int kk, int g, int t,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = s + (8 * nb + g) * LDF + 8 * kk + t;
  split(p[0], hi[0], lo[0]);
  split(p[4], hi[1], lo[1]);
}

// B[k][n] = T[8 kk + k][8 nb + n] with k in the accumulator's permuted
// order (logical t is row 2t, t + 4 row 2t + 1): kn of dqn = dS kn
__device__ __forceinline__ void frag_bn(const float* s, int nb, int kk, int g, int t,
                                        uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float* p = s + (8 * kk + 2 * t) * LDF + 8 * nb + g;
  split(p[0], hi[0], lo[0]);
  split(p[LDF], hi[1], lo[1]);
}

// s = A B^T over the head dim: A rows r0.. of tile `a`, B the 64 rows of
// tile `b` (a fresh accumulator: 4 chunks x 3 products)
__device__ __forceinline__ void scores(float (&s)[8][4], const float* a, const float* b,
                                       int r0, int g, int t) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_a(a, r0, kk, g, t, ah, al);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      uint32_t bh[2], bl[2];
      frag_bt(b, nb, kk, g, t, bh, bl);
      mma3(s[nb], ah, al, bh, bl);
    }
  }
}

// sum += A T over one 64-token tile: A the accumulator tile `a` (rows x
// tokens), T the staged (token, 32) tile; the tile's share in an
// accumulator of its own, added in f32
__device__ __forceinline__ void tile_product(float (&sum)[4][4], const float (&a)[8][4],
                                             const float* T, int g, int t) {
  float part[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[nb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {  // over the tokens
    uint32_t ah[4], al[4];
    frag_acc(a[kk], ah, al);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {  // over the head dim
      uint32_t bh[2], bl[2];
      frag_bn(T, nb, kk, g, t, bh, bl);
      mma3(part[nb], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[nb][e] += part[nb][e];
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
// t + u, j < 4, u < 2): dn the f32 product (dqn or dkn) in accumulator
// elements [j][2 hi + u], x the raw f32 row, r its inverse norm, sc the
// scale.  Writes r (dxhat - xhat (xhat . dxhat)) at out when `ok` and adds
// dn xhat to the scale partial acc.  Every lane of the warp calls it.
__device__ __forceinline__ void l2norm_bwd(const float (&dn)[4][4], int hi, const float* x,
                                           float r, const float* sc, float* out, bool ok, int t,
                                           float (&acc)[8]) {
  float xh[8], dh[8], dot = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 xf = *reinterpret_cast<const float2*>(x + c);
    xh[2 * j] = xf.x * r;
    xh[2 * j + 1] = xf.y * r;
    dh[2 * j] = dn[j][2 * hi] * sc[c];
    dh[2 * j + 1] = dn[j][2 * hi + 1] * sc[c + 1];
    dot = fmaf(xh[2 * j], dh[2 * j], dot);
    dot = fmaf(xh[2 * j + 1], dh[2 * j + 1], dot);
  }
  dot = sum4(dot);
  if (!ok) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float2*>(out + 8 * j + 2 * t) =
        make_float2(r * (dh[2 * j] - xh[2 * j] * dot), r * (dh[2 * j + 1] - xh[2 * j + 1] * dot));
#pragma unroll
    for (int u = 0; u < 2; ++u)
      acc[2 * j + u] = fmaf(dn[j][2 * hi + u], xh[2 * j + u], acc[2 * j + u]);
  }
}

// the CTA's 32 scale sums (acc: this thread's dims 8 j + 2 t + u) over its
// rows in a fixed order -> part[0..31]; the consumer warps only
__device__ __forceinline__ void scale_partial(float (&acc)[8], float (&red)[4][HD], float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 4);
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 8);
    acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], 16);
  }
  if (lane < 4)
#pragma unroll
    for (int k = 0; k < 8; ++k) red[warp][8 * (k >> 1) + 2 * t + (k & 1)] = acc[k];
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (threadIdx.x < HD)
    part[threadIdx.x] = red[0][threadIdx.x] + red[1][threadIdx.x] + red[2][threadIdx.x]
                        + red[3][threadIdx.x];
}

// ------------------------------------------------------------- pre-pass
// qn, kn and the inverse norms of every (sequence, head, token): four
// threads a row, eight dims each
__global__ void __launch_bounds__(256) qk32_norm(Args a) {
  const long long rows = (long long)a.S * a.H * a.n;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool ok = (gid >> 2) < rows;
  const long long row = ok ? gid >> 2 : 0;
  const int c = (int)(gid & 3) * 8;
  const int t = (int)(row % a.n), sh = (int)(row / a.n), h = sh % a.H, s = sh / a.H;
  const float4* qp = reinterpret_cast<const float4*>(a.q + q_at(a, s, h) + (size_t)t * a.q_tok + c);
  const float4* kp = reinterpret_cast<const float4*>(a.k + kv_at(a, s, h) + (size_t)t * a.kv_tok + c);
  const float4 q0 = qp[0], q1 = qp[1], k0 = kp[0], k1 = kp[1];
  const float x[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  const float y[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
  float sq = 0.0f, sk = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sq = fmaf(x[i], x[i], sq);
    sk = fmaf(y[i], y[i], sk);
  }
  const float fq = rsqrtf(fmaxf(sum4(sq), 1e-24f)), fk = rsqrtf(fmaxf(sum4(sk), 1e-24f));
  if (!ok) return;
  float oq[8], ok8[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    oq[i] = x[i] * fq * a.qs[c + i];
    ok8[i] = y[i] * fk * a.ks[c + i];
  }
  float4* qn = reinterpret_cast<float4*>(a.qn + row * HD + c);
  float4* kn = reinterpret_cast<float4*>(a.kn + row * HD + c);
  qn[0] = make_float4(oq[0], oq[1], oq[2], oq[3]);
  qn[1] = make_float4(oq[4], oq[5], oq[6], oq[7]);
  kn[0] = make_float4(ok8[0], ok8[1], ok8[2], ok8[3]);
  kn[1] = make_float4(ok8[4], ok8[5], ok8[6], ok8[7]);
  if (c == 0) {
    a.rq[row] = fq;
    a.rk[row] = fk;
  }
}

// ------------------------------------------------------------- row pass
// One CTA per (64-query tile, sequence, head).  Shared memory: qn, dO, then
// STAGES x [kn | v | bias tile], the key tiles streamed twice.
template <bool BIAS>
__global__ void __launch_bounds__(NT, 2) qk32_rows(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;
  __shared__ float red[4][HD];
  uint8_t* sqo = align1024(smem_raw);
  uint8_t* ring = sqo + 2 * TILE_BYTES;
  constexpr int stage = rows_stage(BIAS);
  const int n = a.n, tiles = a.tiles;
  const int i0 = (blockIdx.x % tiles) * TILE, sh = blockIdx.x / tiles;
  const int h = sh % a.H, s = sh / a.H;
  const size_t qo = q_at(a, s, h);
  init_ring<STAGES>(full, empty, &qbar);

  if (threadIdx.x >= WG) {  // the producer warp
    const int lane = threadIdx.x - WG;
    const float* kn = a.kn + (size_t)sh * n * HD;
    const float* v = a.v + kv_at(a, s, h);
    load_rows(saddr(sqo), a.qn + (size_t)sh * n * HD, HD, i0, n, lane);
    load_rows(saddr(sqo) + TILE_BYTES, a.dout + qo, a.q_tok, i0, n, lane);
    bar_arrive_copies(&qbar);
    for (int t = 0; t < 2 * tiles; ++t) {
      const int st = t % STAGES, j0 = (t % tiles) * TILE;
      if (t >= STAGES) bar_wait(&empty[st], (t / STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * stage);
      load_rows(dst, kn, HD, j0, n, lane);
      load_rows(dst + TILE_BYTES, v, a.kv_tok, j0, n, lane);
      if (BIAS)
        load_bias(dst + 2 * TILE_BYTES, a.bias + (size_t)h * n * n, n, i0, j0, LD_ROWS, lane);
      bar_arrive_copies(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int r0 = 16 * warp, rl = r0 + g;  // this thread's rows: rl, rl + 8
  const float* Q = reinterpret_cast<const float*>(sqo);
  const float* dO = Q + TILE * LDF;
  float s_[8][4], dp[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, D[2] = {0.0f, 0.0f}, lse[2];
  bar_wait(&qbar, 0);

  // first sweep, an online softmax: m, l and D = sum_j exp(s - m) dP, f32
  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, j0 = t * TILE;
    const float* Kt = reinterpret_cast<const float*>(ring + st * stage);
    const float* Vt = Kt + TILE * LDF;
    const float* sb = Vt + TILE * LDF;
    bar_wait(&full[st], (t / STAGES) & 1);
    scores(s_, Q, Kt, r0, g, q4);
    scores(dp, dO, Vt, r0, g, q4);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      float x = s_[e >> 2][e & 3];
      if (BIAS) x += sb[(rl + 8 * hi) * LD_ROWS + col];
      x = j0 + col < n ? x : -INFINITY;
      s_[e >> 2][e & 3] = x;
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
      const float p = fexp2((s_[e >> 2][e & 3] - m[hi]) * LOG2E);
      l[hi] += p;
      D[hi] = fmaf(p, dp[e >> 2][e & 3], D[hi]);
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

  // second sweep: P and dS = P (dP - D); merged += P v, dqn += dS kn
  float mo[4][4], dq[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) mo[nb][e] = dq[nb][e] = 0.0f;
  for (int t = tiles; t < 2 * tiles; ++t) {
    const int st = t % STAGES, j0 = (t - tiles) * TILE;
    const float* Kt = reinterpret_cast<const float*>(ring + st * stage);
    const float* Vt = Kt + TILE * LDF;
    const float* sb = Vt + TILE * LDF;
    bar_wait(&full[st], (t / STAGES) & 1);
    scores(s_, Q, Kt, r0, g, q4);
    scores(dp, dO, Vt, r0, g, q4);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      const float bias = BIAS ? sb[(rl + 8 * hi) * LD_ROWS + col] : 0.0f;
      const float p = prob(s_[e >> 2][e & 3], bias, lse[hi], j0 + col < n);
      dp[e >> 2][e & 3] = p * (dp[e >> 2][e & 3] - D[hi]);
      s_[e >> 2][e & 3] = p;
    }
    tile_product(mo, s_, Vt, g, q4);
    tile_product(dq, dp, Kt, g, q4);
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
    float* out = a.merged + qo + (size_t)i * a.q_tok;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * q4) = make_float2(mo[j][2 * hi], mo[j][2 * hi + 1]);
  }
  scale_partial(acc, red, a.dqs_part + (size_t)blockIdx.x * HD);
}

// ---------------------------------------------------------- column pass
// One CTA per (64-key tile, sequence, head); its rows are keys, its columns
// queries.  Shared memory: kn, v, then STAGES x [qn | dO | bias tile (rows
// queries) | lse | D].
template <bool BIAS>
__global__ void __launch_bounds__(NT, 2) qk32_cols(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kvbar;
  __shared__ float red[4][HD];
  uint8_t* skv = align1024(smem_raw);
  uint8_t* ring = skv + 2 * TILE_BYTES;
  constexpr int stage = cols_stage(BIAS);
  constexpr int bias_bytes = BIAS ? TILE * LD_COLS * 4 : 0;
  const int n = a.n, tiles = a.tiles;
  const int j0 = (blockIdx.x % tiles) * TILE, sh = blockIdx.x / tiles;
  const int h = sh % a.H, s = sh / a.H;
  const size_t kvo = kv_at(a, s, h);
  init_ring<STAGES>(full, empty, &kvbar);

  if (threadIdx.x >= WG) {
    const int lane = threadIdx.x - WG;
    const float* qn = a.qn + (size_t)sh * n * HD;
    const float* dout = a.dout + q_at(a, s, h);
    load_rows(saddr(skv), a.kn + (size_t)sh * n * HD, HD, j0, n, lane);
    load_rows(saddr(skv) + TILE_BYTES, a.v + kvo, a.kv_tok, j0, n, lane);
    bar_arrive_copies(&kvbar);
    for (int t = 0; t < tiles; ++t) {
      const int st = t % STAGES, i0 = t * TILE;
      if (t >= STAGES) bar_wait(&empty[st], (t / STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * stage);
      load_rows(dst, qn, HD, i0, n, lane);
      load_rows(dst + TILE_BYTES, dout, a.q_tok, i0, n, lane);
      if (BIAS)
        load_bias(dst + 2 * TILE_BYTES, a.bias + (size_t)h * n * n, n, i0, j0, LD_COLS, lane);
      load_vec(dst + 2 * TILE_BYTES + bias_bytes, a.lse + (size_t)sh * n, i0, n, lane);
      load_vec(dst + 2 * TILE_BYTES + bias_bytes + TILE * 4, a.rowsum + (size_t)sh * n, i0, n,
               lane);
      bar_arrive_copies(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int r0 = 16 * warp, rl = r0 + g;  // this thread's keys: j0 + rl, + 8
  const float* Kn = reinterpret_cast<const float*>(skv);
  const float* V = Kn + TILE * LDF;
  float s_[8][4], dp[8][4], dk[4][4], dv[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.0f;
  bar_wait(&kvbar, 0);

  for (int t = 0; t < tiles; ++t) {
    const int st = t % STAGES, i0 = t * TILE;
    const float* Qt = reinterpret_cast<const float*>(ring + st * stage);
    const float* dOt = Qt + TILE * LDF;
    const float* sb = dOt + TILE * LDF;
    const float* slse = reinterpret_cast<const float*>(ring + st * stage + 2 * TILE_BYTES
                                                       + bias_bytes);
    const float* sd = slse + TILE;
    bar_wait(&full[st], (t / STAGES) & 1);
    scores(s_, Kn, Qt, r0, g, q4);
    scores(dp, V, dOt, r0, g, q4);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), jl = rl + 8 * hi, il = acc_col(e, q4);
      const float bias = BIAS ? sb[il * LD_COLS + jl] : 0.0f;
      const float p = prob(s_[e >> 2][e & 3], bias, slse[il], i0 + il < n && j0 + jl < n);
      dp[e >> 2][e & 3] = p * (dp[e >> 2][e & 3] - sd[il]);
      s_[e >> 2][e & 3] = p;
    }
    // dv += P^T dO, dkn += dS^T qn, over the queries
    tile_product(dv, s_, dOt, g, q4);
    tile_product(dk, dp, Qt, g, q4);
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
    float* out = a.dv + kvo + (size_t)j * a.kv_tok;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float2*>(out + 8 * c + 2 * q4) = make_float2(dv[c][2 * hi], dv[c][2 * hi + 1]);
  }
  scale_partial(acc, red, a.dks_part + (size_t)blockIdx.x * HD);
}

// ----------------------------------------------------------- dbias pass
// One CTA per (64 x 64 tile of the bias, head, group of sequences): S and dP
// of the tile for each sequence of the group in order, dS = P (dP - D)
// added in f32.  Shared memory: the bias tile, then STAGES x [qn | dO | kn |
// v | lse | D].
__global__ void __launch_bounds__(NT, 2) qk32_dbias(Args a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], bbar;
  uint8_t* sbias = align1024(smem_raw);
  uint8_t* ring = sbias + DB_BIAS;
  const int n = a.n, tiles = a.tiles, h = blockIdx.y;
  const int i0 = (blockIdx.x / tiles) * TILE, j0 = (blockIdx.x % tiles) * TILE;
  const int per = (a.S + a.groups - 1) / a.groups;
  const int s0 = blockIdx.z * per, s1 = min(a.S, s0 + per);
  init_ring<STAGES>(full, empty, &bbar);

  if (threadIdx.x >= WG) {
    const int lane = threadIdx.x - WG;
    load_bias(saddr(sbias), a.bias + (size_t)h * n * n, n, i0, j0, LD_ROWS, lane);
    bar_arrive_copies(&bbar);
    for (int s = s0; s < s1; ++s) {
      const int t = s - s0, st = t % STAGES;
      const size_t sh = (size_t)s * a.H + h;
      if (t >= STAGES) bar_wait(&empty[st], (t / STAGES - 1) & 1);
      const uint32_t dst = saddr(ring + st * DB_STAGE);
      load_rows(dst, a.qn + sh * n * HD, HD, i0, n, lane);
      load_rows(dst + TILE_BYTES, a.dout + q_at(a, s, h), a.q_tok, i0, n, lane);
      load_rows(dst + 2 * TILE_BYTES, a.kn + sh * n * HD, HD, j0, n, lane);
      load_rows(dst + 3 * TILE_BYTES, a.v + kv_at(a, s, h), a.kv_tok, j0, n, lane);
      load_vec(dst + 4 * TILE_BYTES, a.lse + sh * n, i0, n, lane);
      load_vec(dst + 4 * TILE_BYTES + TILE * 4, a.rowsum + sh * n, i0, n, lane);
      bar_arrive_copies(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q4 = lane & 3;
  const int r0 = 16 * warp, rl = r0 + g;
  float s_[8][4], dp[8][4], acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
  const float* sb = reinterpret_cast<const float*>(sbias);
  bar_wait(&bbar, 0);

  for (int s = s0; s < s1; ++s) {
    const int t = s - s0, st = t % STAGES;
    const float* Qt = reinterpret_cast<const float*>(ring + st * DB_STAGE);
    const float* dOt = Qt + TILE * LDF;
    const float* Kt = dOt + TILE * LDF;
    const float* Vt = Kt + TILE * LDF;
    const float* slse = Vt + TILE * LDF;
    bar_wait(&full[st], (t / STAGES) & 1);
    scores(s_, Qt, Kt, r0, g, q4);
    scores(dp, dOt, Vt, r0, g, q4);
    const float lse[2] = {slse[rl], slse[rl + 8]};
    const float D[2] = {slse[TILE + rl], slse[TILE + rl + 8]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hi = acc_hi(e), col = acc_col(e, q4);
      const float p = prob(s_[e >> 2][e & 3], sb[(rl + 8 * hi) * LD_ROWS + col], lse[hi],
                           i0 + rl + 8 * hi < n && j0 + col < n);
      // dS rounded to f32, then added
      acc[e >> 2][e & 3] += __fmul_rn(p, dp[e >> 2][e & 3] - D[hi]);
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
      const float x = acc[j][2 * hi], y = acc[j][2 * hi + 1];
      if ((n & 1) == 0 && c + 1 < n) {
        *reinterpret_cast<float2*>(out + (size_t)i * n + c) = make_float2(x, y);
      } else {
        if (c < n) out[(size_t)i * n + c] = x;
        if (c + 1 < n) out[(size_t)i * n + c + 1] = y;
      }
    }
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

// Addressing and outputs as ct_qk_attention_tc_bwd (qknorm_attention_tc.cu),
// f32, head dim 32: every stride a multiple of 4 elements, q, k, v, dout,
// merged, dq, dk, dv, qn, kn 16-byte aligned.  Scratch: qn, kn (S, H, n, 32)
// f32; rq, rk, lse, rowsum (S, H, n) f32.  dbias_part (groups, H, n, n) f32,
// given with bias, 1 <= groups <= sequences; dqs_part and dks_part (S H
// ceil(n / 64), 32) f32.
CT_EXPORT int ct_qk_attention_tc32_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* merged, void* dq, void* dk,
                                       void* dv, long long q_outer, long long q_inner,
                                       long long q_head, long long q_tok, long long kv_outer,
                                       long long kv_inner, long long kv_head, long long kv_tok,
                                       int inner, int sequences, int heads, int n, int d,
                                       const void* q_scale, const void* k_scale,
                                       const void* bias, void* qn, void* kn, void* rq, void* rk,
                                       void* lse, void* rowsum, void* dbias_part, int groups,
                                       void* dqs_part, void* dks_part, void* stream) {
  const long long strides[] = {q_outer, q_inner, q_head, q_tok,
                               kv_outer, kv_inner, kv_head, kv_tok};
  bool ok = d == HD && n > 0 && heads > 0 && sequences > 0 && inner > 0
            && (bias != nullptr) == (dbias_part != nullptr)
            && (!bias || (groups >= 1 && groups <= sequences));
  for (long long s : strides) ok = ok && s % 4 == 0;
  const void* ptrs[] = {q, k, v, dout, merged, dq, dk, dv, qn, kn};
  for (const void* p : ptrs) ok = ok && aligned16(p);
  const int tiles = (n + TILE - 1) / TILE;
  const long long ctas = (long long)tiles * sequences * heads;
  const long long rows = (long long)sequences * heads * n;
  if (!ok || ctas > 2147483647LL || rows * 4 > 2147483647LL * 256)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = static_cast<const float*>(q); a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v); a.dout = static_cast<const float*>(dout);
  a.merged = static_cast<float*>(merged); a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk); a.dv = static_cast<float*>(dv);
  a.q_outer = q_outer; a.q_inner = q_inner; a.q_head = q_head; a.q_tok = q_tok;
  a.kv_outer = kv_outer; a.kv_inner = kv_inner; a.kv_head = kv_head; a.kv_tok = kv_tok;
  a.inner = inner; a.S = sequences; a.H = heads; a.n = n; a.tiles = tiles;
  a.groups = bias ? groups : 1;
  a.qs = static_cast<const float*>(q_scale);
  a.ks = static_cast<const float*>(k_scale);
  a.bias = static_cast<const float*>(bias);
  a.qn = static_cast<float*>(qn); a.kn = static_cast<float*>(kn);
  a.rq = static_cast<float*>(rq); a.rk = static_cast<float*>(rk);
  a.lse = static_cast<float*>(lse); a.rowsum = static_cast<float*>(rowsum);
  a.dbias_part = static_cast<float*>(dbias_part);
  a.dqs_part = static_cast<float*>(dqs_part);
  a.dks_part = static_cast<float*>(dks_part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  qk32_norm<<<(unsigned)((rows * 4 + 255) / 256), 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ctas);
  err = launch(bias ? qk32_rows<true> : qk32_rows<false>, grid,
               1024 + 2 * TILE_BYTES + STAGES * rows_stage(bias != nullptr), st, a);
  if (err != cudaSuccess) return (int)err;
  err = launch(bias ? qk32_cols<true> : qk32_cols<false>, grid,
               1024 + 2 * TILE_BYTES + STAGES * cols_stage(bias != nullptr), st, a);
  if (err != cudaSuccess || !bias) return (int)err;
  return (int)launch(qk32_dbias, dim3(tiles * tiles, heads, groups),
                     1024 + DB_BIAS + STAGES * DB_STAGE, st, a);
}
