// attention_train.cu — key-tiled attention on the CUDA cores: forward with
// an optional in-kernel dropout on the probabilities, its backward, and the
// row log-sum-exp that links the two.  Templated on the element type T of
// q, k, v, out and the gradients (float and bf16).  In bf16 the operands are
// widened to f32 as they are staged, so every product and the softmax run in
// f32 and only the stored outputs round to bf16.
//
// It serves what attention_tc.cu (bf16, d 64, wgmma) and attention_tc32.cu
// (f32, d 64, 3xTF32, forward and backward) do not take
// (ops/attention.py::attention_route): head dims other than 64, in both
// dtypes; at d 64 chip_smoke.py times it beside the kernels that replaced
// it.  Of ct_clip_tpu/ops/pallas/attention.py:
//   * _pallas_attention (K7): softmax(q k^T + key_bias) v, the per-key (b, n)
//     bias optional, or with an f32 (1, 1|h, n, n) dense bias
//                                                -> ct_attn_train_fwd, rate 0;
//   * _pallas_attention_kbias_drop_impl (K13 forward): key-bias attention with
//     dropout on the probabilities               -> ct_attn_train_fwd, rate > 0;
//   * _pallas_attention_bwd_kbias (K12a): dq, dk, dv and dkey_bias summed over
//     heads and query rows                       -> ct_attn_train_bwd, rate 0;
//   * _pallas_attention_kbias_drop_bwd (K13 backward), the same with the
//     dropout mask regenerated                   -> ct_attn_train_bwd, rate > 0;
//   * _pallas_attention_bwd (K12b) in f32: dq, dk, dv and dbias summed over
//     the batch (and the heads for a one-head bias) -> ct_attn_train_bwd, bias set.
//
// Dropout mask: Philox4x32-10 bits (common.cuh), the counter (batch row,
// head, query i, key j / 4), kept iff bits >= thresh and scaled by 1 / (1 -
// rate).  Forward and backward regenerate the same bits, as attention_tc.cu's
// backward does; the mask never exists in device memory.
//
// What bounds it on the H100.  For BERT (b 32, 12 heads, n 512, d 64, f32)
// the forward's two products are 25.8 GFLOP against 201 MB of q, k, v and
// out: at the 67 TFLOP/s f32 CUDA-core peak that is 0.385 ms against 0.06 ms
// of memory time, so arithmetic bounds it.  Products run in true f32 on the
// CUDA cores, as Precision.HIGHEST does on the TPU (no TF32).
//
// Design.  One block per (64-query tile, sequence, head) walks 64-key tiles
// with an online softmax and writes the row log-sum-exp (b, h, n), the
// backward's residual.  256 threads as 16 x 16, each owning a 4 x 4 piece of
// every 64 x 64 tile; operands sit in shared memory transposed ([dim][row],
// rows padded to 68 floats).  The backward first takes D_i = sum_c dO_ic O_ic
// (= sum_j P_ij M_ij dP_ij with the dropout mask M); in bf16 (d != 64) O is
// read from an f32 copy the forward writes when this backward will follow
// (from the rounded O, every dS row shifts off its zero sum).  Then a row pass for dq
// and a column pass for dk, dv and each head's share of dkey_bias, summed
// over heads in a fixed order: no atomics, bit-identical runs.  A dense bias
// (f32, bias[head or 0, i, j]) is staged transposed in the column pass; its
// gradient goes through a (b, h, n, n) f32 scratch of dS that
// dbias_sum_kernel adds over the batch in a fixed order.
#include "common.cuh"

namespace {

constexpr int TILE = 64;        // query and key rows per tile
constexpr int DMAX = 64;        // head dims held per tile (d <= 64, zero-padded)
constexpr int LDT = TILE + 4;   // row length of a transposed tile (16-byte aligned)
constexpr int NT = 256;         // threads: 16 x 16, a 4 x 4 piece each
constexpr int TRANS = DMAX * LDT;  // floats in one transposed tile

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 v) { return bf2f(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return f2bf(v); }

// Element strides (batch, head, token) of one (b, h, n, d) tensor whose last
// dim is contiguous.
struct View { long long sb, sh, st; };

struct Args {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  void* out; void* dq; void* dk; void* dv;
  View vq, vk, vv, vo, vdo, vdq, vdk, vdv;
  const float* key_bias;    // (b, n) additive per-key bias, or null
  const float* bias;        // (bias_heads, n, n) additive dense bias, or null
  float* ds;                // (b, h, n, n) scratch: each (b, h)'s dS, or null
  float* dbias;             // (bias_heads, n, n) dbias, or null
  float* lse;               // (b, h, n) row log-sum-exp
  float* rowdot;            // (b, h, n) D_i = sum_c dO_ic O_ic
  float* o32;               // (b, h, n, d) f32 copy of out (forward writes,
                            // rowdot reads), contiguous, or null
  float* dkb_head;          // (b, h, n) each head's share of dkey_bias, or null
  float* dkb;               // (b, n) dkey_bias, or null
  const long long* seed;    // (1,) Philox key, device memory
  uint32_t thresh;          // keep iff bits >= thresh; 0: no dropout
  float keep_scale;         // 1 / (1 - rate)
  int H, n, d, bias_heads;
};

__device__ __forceinline__ size_t at(const View& v, int b, int h, int t) {
  return (size_t)b * v.sb + (size_t)h * v.sh + (size_t)t * v.st;
}

// rows [r0, r0 + TILE) x dims [0, DMAX) of a tensor -> dst[c * LDT + i]
// (transposed) and, if dst_rows, dst_rows[i * DMAX + c]; zeros past n and d.
template <typename T>
__device__ void load_tile(const T* src, const View& v, int b, int h, int r0,
                          int n, int d, float* dst_t, float* dst_rows) {
  for (int e = threadIdx.x; e < TILE * DMAX; e += NT) {
    const int i = e / DMAX, c = e % DMAX, t = r0 + i;
    const float x = (t < n && c < d) ? to_f32(src[at(v, b, h, t) + c]) : 0.0f;
    if (dst_t) dst_t[c * LDT + i] = x;
    if (dst_rows) dst_rows[i * DMAX + c] = x;
  }
}

// acc[r][c] += sum_k A[k][4*ra + r] * B[k][4*cb + c], A and B transposed tiles
// with row length lda / ldb
__device__ __forceinline__ void mma_tile(float acc[4][4], const float* A, int lda, int ra,
                                         const float* B, int ldb, int cb, int depth) {
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * lda + 4 * ra);
    const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + 4 * cb);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

// sum / max over the 16 threads that share a row (tx = lane % 16)
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float key_bias_at(const Args& a, int b, int j) {
  return a.key_bias ? a.key_bias[(size_t)b * a.n + j] : 0.0f;
}

// the dense bias at (head h, query i, key j), i and j < n; 0 without one
__device__ __forceinline__ float bias_at(const Args& a, int h, int i, int j) {
  if (!a.bias) return 0.0f;
  const int hb = a.bias_heads > 1 ? h : 0;
  return a.bias[((size_t)hb * a.n + i) * a.n + j];
}

// -------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(NT) fwd_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;              // [DMAX][LDT]
  float* Kt = Qt + TRANS;      // [DMAX][LDT]
  float* Pt = Kt + TRANS;      // [TILE keys][LDT queries]
  float* Vs = Pt + TRANS;      // [TILE keys][DMAX]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.x * TILE, b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int n = a.n;
  uint32_t k0, k1;
  seed_key(a.seed, a.thresh, k0, k1);

  load_tile(static_cast<const T*>(a.q), a.vq, b, h, i0, n, a.d, Qt, nullptr);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }

  for (int j0 = 0; j0 < n; j0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    load_tile(static_cast<const T*>(a.k), a.vk, b, h, j0, n, a.d, Kt, nullptr);
    load_tile(static_cast<const T*>(a.v), a.vv, b, h, j0, n, a.d, nullptr, Vs);
    __syncthreads();
    float s[4][4] = {};
    mma_tile(s, Qt, LDT, ty, Kt, LDT, tx, DMAX);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
      const int i = i0 + 4 * ty + r;  // rows past n are computed, not written
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * tx + c;
        s[r][c] = j < n ? s[r][c] + key_bias_at(a, b, j) + (i < n ? bias_at(a, h, i, j) : 0.0f)
                        : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      // key j0 < n lies in this tile, so the new max is finite
      const float m_new = fmaxf(m[r], max16(mx));
      const float corr = expf(m[r] - m_new);  // 0 before the first tile
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
        acc[r][c] *= corr;
      }
      l[r] = l[r] * corr + sum16(sum);
      m[r] = m_new;
      if (a.thresh) {
        const U4 bits = philox(b, h, i0 + 4 * ty + r, (j0 >> 2) + tx, k0, k1);
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] *= keep(bits.w[c], a.thresh, a.keep_scale);
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Pt + (4 * tx + c) * LDT + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();
    mma_tile(acc, Pt, LDT, ty, Vs, DMAX, tx, TILE);
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= n) continue;
    const float inv = 1.0f / l[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * tx + c;
      if (col >= a.d) continue;
      out[at(a.vo, b, h, i) + col] = from_f32<T>(acc[r][c] * inv);
      if (a.o32) a.o32[(((size_t)b * a.H + h) * n + i) * a.d + col] = acc[r][c] * inv;
    }
    if (tx == 0) a.lse[((size_t)b * a.H + h) * n + i] = m[r] + logf(l[r]);
  }
}

// ------------------------------------------------------------- backward
// D_i = sum_c dO_ic O_ic, one warp per row
template <typename T>
__global__ void rowdot_kernel(Args a, int rows) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = row % a.n, bh = row / a.n, b = bh / a.H, h = bh % a.H;
  const T* o = static_cast<const T*>(a.o) + at(a.vo, b, h, i);
  const T* g = static_cast<const T*>(a.dout) + at(a.vdo, b, h, i);
  const float* o32 = a.o32 ? a.o32 + (size_t)row * a.d : nullptr;
  float s = 0.0f;
  for (int c = lane; c < a.d; c += 32) s = fmaf(o32 ? o32[c] : to_f32(o[c]), to_f32(g[c]), s);
  s = warp_sum(s);
  if (lane == 0) a.rowdot[row] = s;
}

// row pass: dq_i = sum_j dS_ij k_j with dS_ij = P_ij (M_ij dO_i.v_j - D_i)
template <typename T>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;              // [DMAX][LDT]
  float* dOt = Qt + TRANS;     // [DMAX][LDT]
  float* Kt = dOt + TRANS;     // [DMAX][LDT]
  float* Vt = Kt + TRANS;      // [DMAX][LDT]
  float* dSt = Vt + TRANS;     // [TILE keys][LDT queries]
  float* Ks = dSt + TRANS;     // [TILE keys][DMAX]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = blockIdx.x * TILE, b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int n = a.n;
  uint32_t k0, k1;
  seed_key(a.seed, a.thresh, k0, k1);

  load_tile(static_cast<const T*>(a.q), a.vq, b, h, i0, n, a.d, Qt, nullptr);
  load_tile(static_cast<const T*>(a.dout), a.vdo, b, h, i0, n, a.d, dOt, nullptr);
  float lse[4], rd[4], dq[4][4] = {};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = min(i0 + 4 * ty + r, n - 1);  // rows past n are not written
    lse[r] = a.lse[((size_t)b * a.H + h) * n + i];
    rd[r] = a.rowdot[((size_t)b * a.H + h) * n + i];
  }

  for (int j0 = 0; j0 < n; j0 += TILE) {
    __syncthreads();
    load_tile(static_cast<const T*>(a.k), a.vk, b, h, j0, n, a.d, Kt, Ks);
    load_tile(static_cast<const T*>(a.v), a.vv, b, h, j0, n, a.d, Vt, nullptr);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_tile(s, Qt, LDT, ty, Kt, LDT, tx, DMAX);
    mma_tile(dp, dOt, LDT, ty, Vt, LDT, tx, DMAX);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mk[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (a.thresh) {
        const U4 bits = philox(b, h, i0 + 4 * ty + r, (j0 >> 2) + tx, k0, k1);
#pragma unroll
        for (int c = 0; c < 4; ++c) mk[c] = keep(bits.w[c], a.thresh, a.keep_scale);
      }
      const int i = i0 + 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + 4 * tx + c;
        const float p = (i < n && j < n)
            ? expf(s[r][c] + key_bias_at(a, b, j) + bias_at(a, h, i, j) - lse[r]) : 0.0f;
        s[r][c] = p * (mk[c] * dp[r][c] - rd[r]);
        if (a.ds && i < n && j < n) a.ds[(((size_t)b * a.H + h) * n + i) * n + j] = s[r][c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(dSt + (4 * tx + c) * LDT + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();
    mma_tile(dq, dSt, LDT, ty, Ks, DMAX, tx, TILE);
  }

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * tx + c;
      if (col < a.d) out[at(a.vdq, b, h, i) + col] = from_f32<T>(dq[r][c]);
    }
  }
}

// column pass: dv_j = sum_i P_ij M_ij dO_i, dk_j = sum_i dS_ij q_i and this
// head's share of dkey_bias_j = sum_i dS_ij.  Thread rows are keys, columns
// queries.
template <typename T>
__global__ void __launch_bounds__(NT) bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;              // [DMAX][LDT] resident
  float* Vt = Kt + TRANS;      // [DMAX][LDT] resident
  float* Qt = Vt + TRANS;      // [DMAX][LDT]
  float* dOt = Qt + TRANS;     // [DMAX][LDT]
  float* Pd = dOt + TRANS;     // [TILE queries][LDT keys]: P * M
  float* dS = Pd + TRANS;      // [TILE queries][LDT keys]
  float* Qs = dS + TRANS;      // [TILE queries][DMAX]
  float* dOs = Qs + TILE * DMAX;   // [TILE queries][DMAX]
  float* lse_s = dOs + TILE * DMAX;  // [TILE]
  float* rd_s = lse_s + TILE;        // [TILE]
  float* Bt = rd_s + TILE;           // [TILE keys][LDT queries]: the dense bias
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int j0 = blockIdx.x * TILE, b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int n = a.n;
  const size_t row0 = ((size_t)b * a.H + h) * n;
  uint32_t k0, k1;
  seed_key(a.seed, a.thresh, k0, k1);

  load_tile(static_cast<const T*>(a.k), a.vk, b, h, j0, n, a.d, Kt, nullptr);
  load_tile(static_cast<const T*>(a.v), a.vv, b, h, j0, n, a.d, Vt, nullptr);
  float dk[4][4] = {}, dv[4][4] = {}, dkb[4] = {};

  for (int i0 = 0; i0 < n; i0 += TILE) {
    __syncthreads();
    load_tile(static_cast<const T*>(a.q), a.vq, b, h, i0, n, a.d, Qt, Qs);
    load_tile(static_cast<const T*>(a.dout), a.vdo, b, h, i0, n, a.d, dOt, dOs);
    for (int e = threadIdx.x; e < TILE; e += NT) {
      const bool ok = i0 + e < n;
      lse_s[e] = ok ? a.lse[row0 + i0 + e] : 0.0f;
      rd_s[e] = ok ? a.rowdot[row0 + i0 + e] : 0.0f;
    }
    if (a.bias) {  // rows of the bias are queries: read along keys, store transposed
      for (int e = threadIdx.x; e < TILE * TILE; e += NT) {
        const int il = e / TILE, jl = e % TILE, i = i0 + il, j = j0 + jl;
        Bt[jl * LDT + il] = (i < n && j < n) ? bias_at(a, h, i, j) : 0.0f;
      }
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};   // [key r][query c]
    mma_tile(s, Kt, LDT, ty, Qt, LDT, tx, DMAX);
    mma_tile(dp, Vt, LDT, ty, dOt, LDT, tx, DMAX);
    float pd[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int il = 4 * tx + c, i = i0 + il;
      float mk[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (a.thresh) {
        const U4 bits = philox(b, h, i, (j0 >> 2) + ty, k0, k1);
#pragma unroll
        for (int r = 0; r < 4; ++r) mk[r] = keep(bits.w[r], a.thresh, a.keep_scale);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + 4 * ty + r;
        const float bij = a.bias ? Bt[(4 * ty + r) * LDT + il] : 0.0f;
        const float p = (i < n && j < n)
            ? expf(s[r][c] + key_bias_at(a, b, j) + bij - lse_s[il]) : 0.0f;
        pd[r][c] = p * mk[r];
        s[r][c] = p * (mk[r] * dp[r][c] - rd_s[il]);
        dkb[r] += s[r][c];
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(Pd + (4 * tx + c) * LDT + 4 * ty) =
          make_float4(pd[0][c], pd[1][c], pd[2][c], pd[3][c]);
      *reinterpret_cast<float4*>(dS + (4 * tx + c) * LDT + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();
    mma_tile(dv, Pd, LDT, ty, dOs, DMAX, tx, TILE);
    mma_tile(dk, dS, LDT, ty, Qs, DMAX, tx, TILE);
  }

  T* gk = static_cast<T*>(a.dk);
  T* gv = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    const float share = sum16(dkb[r]);
    if (j >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 4 * tx + c;
      if (col < a.d) {
        gk[at(a.vdk, b, h, j) + col] = from_f32<T>(dk[r][c]);
        gv[at(a.vdv, b, h, j) + col] = from_f32<T>(dv[r][c]);
      }
    }
    if (tx == 0 && a.dkb_head) a.dkb_head[row0 + j] = share;
  }
}

// dkey_bias[b, j] = sum over heads of the shares, heads in order
__global__ void dkb_sum_kernel(Args a, int rows) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows) return;
  const int b = e / a.n, j = e % a.n;
  float s = 0.0f;
  for (int h = 0; h < a.H; ++h) s += a.dkb_head[((size_t)b * a.H + h) * a.n + j];
  a.dkb[e] = s;
}

// dbias[hb, i, j] = sum of the (b, h) scratch tiles of dS: over the batch for
// a per-head bias, over the heads (outer) and the batch (inner) for a
// one-head bias, in that fixed order
__global__ void dbias_sum_kernel(Args a, int B) {
  const size_t nn = (size_t)a.n * a.n;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)a.bias_heads * nn) return;
  const int hb = (int)(e / nn);
  const size_t ij = e % nn;
  float s = 0.0f;
  for (int h = a.bias_heads > 1 ? hb : 0; h < (a.bias_heads > 1 ? hb + 1 : a.H); ++h)
    for (int b = 0; b < B; ++b) s += a.ds[((size_t)b * a.H + h) * nn + ij];
  a.dbias[e] = s;
}

constexpr size_t FWD_SMEM = (3 * TRANS + TILE * DMAX) * sizeof(float);
constexpr size_t DQ_SMEM = (5 * TRANS + TILE * DMAX) * sizeof(float);
constexpr size_t DKV_SMEM = (7 * TRANS + 2 * TILE * DMAX + 2 * TILE) * sizeof(float);

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the first `nviews` of q, k, v, out, dout, dq, dk, dv from 3 strides each
Args make_args(const long long* strides, int nviews) {
  Args a = {};
  View* views[8] = {&a.vq, &a.vk, &a.vv, &a.vo, &a.vdo, &a.vdq, &a.vdk, &a.vdv};
  for (int i = 0; i < nviews; ++i)
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return a;
}

template <typename T>
int launch_fwd(Args a, int B, cudaStream_t st) {
  cudaError_t err = allow_smem(fwd_kernel<T>, FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + TILE - 1) / TILE, B * a.H);
  fwd_kernel<T><<<grid, NT, FWD_SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(Args a, int B, cudaStream_t st) {
  const int rows = B * a.H * a.n;
  rowdot_kernel<T><<<(rows + 7) / 8, 256, 0, st>>>(a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n + TILE - 1) / TILE, B * a.H);
  if ((err = allow_smem(bwd_dq_kernel<T>, DQ_SMEM)) != cudaSuccess) return (int)err;
  bwd_dq_kernel<T><<<grid, NT, DQ_SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(bwd_dkv_kernel<T>, DKV_SMEM)) != cudaSuccess) return (int)err;
  bwd_dkv_kernel<T><<<grid, NT, DKV_SMEM, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a.dkb) {
    const int kb_rows = B * a.n;
    dkb_sum_kernel<<<(kb_rows + 255) / 256, 256, 0, st>>>(a, kb_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (a.dbias) {
    const size_t elems = (size_t)a.bias_heads * a.n * a.n;
    dbias_sum_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(a, B);
  }
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int H, int n, int d) {
  return B > 0 && H > 0 && n > 0 && d > 0 && d <= DMAX;
}

bool bias_ok(const void* bias, int bias_heads, int H) {
  return !bias || bias_heads == 1 || bias_heads == H;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
// strides: (batch, head, token) element strides of q, k, v, out; out32 a
// contiguous (b, h, n, d) f32 copy of out to write, or null; key_bias (b, n)
// or null; bias (bias_heads, n, n) f32, bias_heads 1 or H, or null.
CT_EXPORT int ct_attn_train_fwd(int dtype, const void* q, const void* k, const void* v,
                                void* out, void* out32, const long long* strides,
                                const void* key_bias,
                                const void* bias, int bias_heads, void* lse, const void* seed,
                                unsigned int thresh, float keep_scale, int B, int H, int n,
                                int d, void* stream) {
  if (!shape_ok(B, H, n, d) || !lse || (thresh && !seed) || !bias_ok(bias, bias_heads, H))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(strides, 4);
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.o32 = static_cast<float*>(out32);
  a.key_bias = static_cast<const float*>(key_bias);
  a.bias = static_cast<const float*>(bias);
  a.bias_heads = bias_heads;
  a.lse = static_cast<float*>(lse);
  a.seed = static_cast<const long long*>(seed);
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.H = H; a.n = n; a.d = d;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(a, B, st);
  if (dtype == 1) return launch_fwd<bf16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// strides: (batch, head, token) element strides of q, k, v, out, dout, dq,
// dk, dv; out32 the forward's f32 copy of out, or null (D_i from out).
// key_bias (b, n) or null; dkb_head (b, h, n) scratch and dkb (b, n)
// output, both null when dkey_bias is not wanted; rowdot (b, h, n) scratch;
// bias (bias_heads, n, n) f32 or null, with ds (b, h, n, n) scratch and
// dbias (bias_heads, n, n) output, both null when dbias is not wanted.
CT_EXPORT int ct_attn_train_bwd(int dtype, const void* q, const void* k, const void* v,
                                const void* out, const void* out32, const void* dout,
                                void* dq, void* dk, void* dv, const long long* strides,
                                const void* key_bias, const void* bias, int bias_heads,
                                const void* lse,
                                void* rowdot, void* dkb_head, void* dkb, void* ds,
                                void* dbias, const void* seed, unsigned int thresh,
                                float keep_scale, int B, int H, int n, int d, void* stream) {
  if (!shape_ok(B, H, n, d) || !lse || !rowdot || (thresh && !seed)
      || ((dkb == nullptr) != (dkb_head == nullptr)) || ((dbias == nullptr) != (ds == nullptr))
      || (dbias && !bias) || !bias_ok(bias, bias_heads, H))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(strides, 8);
  a.q = q; a.k = k; a.v = v; a.o = out; a.dout = dout;
  a.o32 = static_cast<float*>(const_cast<void*>(out32));
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.key_bias = static_cast<const float*>(key_bias);
  a.lse = static_cast<float*>(const_cast<void*>(lse));
  a.rowdot = static_cast<float*>(rowdot);
  a.dkb_head = static_cast<float*>(dkb_head);
  a.dkb = static_cast<float*>(dkb);
  a.bias = static_cast<const float*>(bias);
  a.bias_heads = bias_heads;
  a.ds = static_cast<float*>(ds);
  a.dbias = static_cast<float*>(dbias);
  a.seed = static_cast<const long long*>(seed);
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  a.H = H; a.n = n; a.d = d;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, B, st);
  if (dtype == 1) return launch_bwd<bf16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
