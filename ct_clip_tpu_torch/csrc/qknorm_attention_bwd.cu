// qknorm_attention_bwd.cu — the attention core of the CTViT QK-norm
// sublayer's backward: from the raw projections q, k, v (the forward's
// recomputed products) and dO, the gradient of the merged heads, it writes
// the merged heads themselves (for the output projection's weight
// gradient), dq and dk through the per-head l2norm and scales, dv, and the
// partial sums of dq_scale, dk_scale and of the (heads, n, n) score bias.
//
// Replaces the per-head core of these TPU kernels:
//   * ct_clip_tpu/ops/pallas/spatial_attention.py::_pallas_spatial_bwd (K9,
//     _bwd_kernel :138-236): 576-token planes with the CPB bias, whose
//     gradient dbias is summed over all planes;
//   * ops/pallas/small_attention.py::_pallas_small_qknorm_bwd with
//     grid_layout=True (K10, _bwd_kernel :249): 24-token t-columns of the
//     (b, t, h*w, d) grid, read and written in place through strides, no
//     bias.
// The products around it (projections, dX = dY W, weight gradients) run in
// gemm.cu, the LayerNorm backward in layernorm.cu.
//
// Math per (sequence, head), as _bwd_kernel: qn = bf16(l2norm(q) qs) with qs
// including the logit scale 8, kn = bf16(l2norm(k) ks); s = qn kn^T + bias;
// P = softmax(s); dP = dO v^T; dS = P (dP - rowsum(P dP)).  P and dS are
// rounded to bf16 before their products (:176, :189); the merged heads are
// bf16(P) v; dqn = bf16(dS) kn, dkn = bf16(dS)^T qn, dv = bf16(P)^T dO; then
// the l2norm backward (:200-211): dq = r (dqhat - qhat (qhat . dqhat)) with
// dqhat = dqn qs, and dq_scale += dqn qhat per dim.
//
// Addressing as attention.cu: head h of sequence s of a tensor starts at
// (s / inner) * outer + (s % inner) * inner_stride + h * head_stride, token
// i sits i * tok further on; q, dO, the merged heads and dq share strides,
// and k, v, dk, dv share theirs.
//
// What bounds it on the H100: arithmetic.  At batch 8 the spatial stage runs
// 192 x 8 (plane, head) pairs of 576 x 576 scores over 32 dims; the core's
// products (scores, dP, P v, dq, and in the column pass the scores and dP
// again, dv, dk) are 8 n^2 d multiply-adds per pair, 0.26 TFLOP per layer.
// This first version runs them on the CUDA cores (67 TFLOP/s f32), from
// shared memory: one block per (group of sequences, head) stages qn, kn, v
// and dO of a sequence (rows padded to d + 2 so 32 lanes reading 32 rows hit
// 32 banks), a row pass (warps own queries) computes P, dS, the merged
// heads, dq and the bias gradient and keeps each row's log-sum-exp and
// rowsum(P dP), and a column pass (warps own keys) recomputes P and dS for
// dv and dk.  Nothing of size n^2 reaches device memory except the bias
// gradient: the block owns one (heads, n, n) partial per group, accumulated
// over its sequences in order, and ct_sum_splits adds the groups in order;
// the scale gradients are per-(group, head, warp) partials summed the same
// way.  No atomics: the result does not change from run to run.  Tensor-core
// products are later work.
//
// The f32 form (qk_attention_bwd_f32_kernel; the TPU kernels run f32
// operands at "highest", spatial_attention.py:323, small_attention.py:487,
// where their bf16 roundings of qn, kn, P and dS are no-ops): q, k, v, dO,
// the merged heads, dq and dkv f32, nothing rounded.  A 576-token plane's
// f32 qn, kn, v and dO (313 KB) do not fit one block, so nothing of a whole
// sequence is staged: the row pass walks query tiles of QT = 4 x warps rows
// (each warp 4, their qn and dO kept as float4 per dim) and, for each tile,
// the keys twice in chunks of KC normalised keys and values: once for the
// scores and dP (all n of each row kept, 4 rows as a float4 per key), then,
// after each row's softmax, rowsum(P dP) and dS, once more for the merged
// heads P v and dqn = dS kn, each an FMA chain over the keys in order.  The
// column pass walks key tiles the same way against chunks of the queries'
// qn and dO, recomputing P from the row pass's log-sum-exp and dS from its
// rowsum, into dv and dkn.  Each sequence first takes every q and k row's
// inverse norm once, so a chunk is staged by all the block's threads with
// 16-byte loads.  The bias gradient and the scale gradients are
// the bf16 kernel's fixed-order partials.  Per block ~177 KB at n = 576, d =
// 32, 8 warps; the same 67 TFLOP/s CUDA-core bound.
#include "common.cuh"

// 1 in a one-change copy for the card checks (kernels.copy_library): P
// rounded to bf16 before the merged heads' product in the f32 form, which
// the f32 comparisons must catch
#ifndef CT_QK_BWD_F32_ROUND_P
#define CT_QK_BWD_F32_ROUND_P 0
#endif

namespace {

constexpr int MAXU = 2;  // head dims per lane: d <= 64

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* merged;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  long long q_outer, q_inner, q_head, q_tok;
  long long kv_outer, kv_inner, kv_head, kv_tok;
  int inner, sequences, heads, n, d, group;
  const float* qs;       // (d,) q scale times the logit scale
  const float* ks;       // (d,) k scale
  const float* bias;     // (heads, n, n) or null
  const float* bias_t;   // the same transposed per head ([h][j][i]), or null
  float* dbias_part;     // (groups, heads, n, n) or null
  float* dqs_part;       // (groups, heads, warps, d)
  float* dks_part;       // (groups, heads, warps, d)
};

// l2-normalise a d-vector held as v[u] = row[lane + 32 u] (zeros past d):
// returns 1 / max(|row|, 1e-12), as ops/pallas/spatial_attention.py does.
__device__ __forceinline__ float inv_norm(const float (&v)[MAXU]) {
  float ss = 0.0f;
#pragma unroll
  for (int u = 0; u < MAXU; ++u) ss += v[u] * v[u];
  return rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
}

__global__ void qk_attention_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.x, head = blockIdx.y;
  const int n = a.n, d = a.d, dp = d + 2;
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  bf16* Qn = reinterpret_cast<bf16*>(smem);  // (n, d + 2) each
  bf16* Kn = Qn + (size_t)n * dp;
  bf16* Vs = Kn + (size_t)n * dp;
  bf16* Os = Vs + (size_t)n * dp;            // dO
  size_t off = (size_t)4 * n * dp * sizeof(bf16);
  off = (off + 15) & ~(size_t)15;
  float* lse_s = reinterpret_cast<float*>(smem + off);   // (n,)
  float* rs_s = lse_s + n;                               // (n,)
  float* wbuf = rs_s + n + (size_t)warp * (2 * n + 2 * d);
  float* pbuf = wbuf;            // (n,) this warp's P row (or column)
  float* sbuf = pbuf + n;        // (n,) dP, then bf16(dS)
  float* va = sbuf + n;          // (d,) the row's qn (or kn)
  float* vb = va + d;            // (d,) the row's dO (or v)

  float qs[MAXU], ks[MAXU], dqs_acc[MAXU] = {}, dks_acc[MAXU] = {};
#pragma unroll
  for (int u = 0; u < MAXU; ++u) {
    const int c = lane + 32 * u;
    qs[u] = c < d ? a.qs[c] : 0.0f;
    ks[u] = c < d ? a.ks[c] : 0.0f;
  }
  const float* bias_h = a.bias ? a.bias + (size_t)head * n * n : nullptr;
  const float* bias_th = a.bias_t ? a.bias_t + (size_t)head * n * n : nullptr;
  float* dbias = a.dbias_part ? a.dbias_part + ((size_t)grp * a.heads + head) * n * n : nullptr;

  for (int si = 0; si < a.group; ++si) {
    const int seq = grp * a.group + si;
    if (seq >= a.sequences) break;
    const size_t q_off = (size_t)(seq / a.inner) * a.q_outer
                         + (size_t)(seq % a.inner) * a.q_inner + (size_t)head * a.q_head;
    const size_t kv_off = (size_t)(seq / a.inner) * a.kv_outer
                          + (size_t)(seq % a.inner) * a.kv_inner + (size_t)head * a.kv_head;
    __syncthreads();  // the previous sequence's readers are done
    for (int j = warp; j < n; j += nwarps) {
      const bf16* qr = a.q + q_off + (size_t)j * a.q_tok;
      const bf16* kr = a.k + kv_off + (size_t)j * a.kv_tok;
      const bf16* vr = a.v + kv_off + (size_t)j * a.kv_tok;
      const bf16* gr = a.dout + q_off + (size_t)j * a.q_tok;
      float qv[MAXU], kv[MAXU];
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int c = lane + 32 * u;
        qv[u] = c < d ? bf2f(qr[c]) : 0.0f;
        kv[u] = c < d ? bf2f(kr[c]) : 0.0f;
      }
      const float fq = inv_norm(qv), fk = inv_norm(kv);
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int c = lane + 32 * u;
        if (c < d) {
          Qn[(size_t)j * dp + c] = f2bf(qv[u] * fq * qs[u]);
          Kn[(size_t)j * dp + c] = f2bf(kv[u] * fk * ks[u]);
          Vs[(size_t)j * dp + c] = vr[c];
          Os[(size_t)j * dp + c] = gr[c];
        }
      }
    }
    __syncthreads();

    // ---- row pass: warps own query rows i
    for (int i = warp; i < n; i += nwarps) {
      for (int c = lane; c < d; c += 32) {
        va[c] = bf2f(Qn[(size_t)i * dp + c]);
        vb[c] = bf2f(Os[(size_t)i * dp + c]);
      }
      __syncwarp();
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) {
        const bf162* kr = reinterpret_cast<const bf162*>(Kn + (size_t)j * dp);
        float s = 0.0f;
        for (int c2 = 0; c2 < d / 2; ++c2) {
          const float2 kf = __bfloat1622float2(kr[c2]);
          s = fmaf(va[2 * c2], kf.x, s);
          s = fmaf(va[2 * c2 + 1], kf.y, s);
        }
        if (bias_h) s += bias_h[(size_t)i * n + j];
        pbuf[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(pbuf[j] - mx);
        pbuf[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float inv = 1.0f / sum;
      float rsum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const bf162* vr = reinterpret_cast<const bf162*>(Vs + (size_t)j * dp);
        float g = 0.0f;
        for (int c2 = 0; c2 < d / 2; ++c2) {
          const float2 vf = __bfloat1622float2(vr[c2]);
          g = fmaf(vb[2 * c2], vf.x, g);
          g = fmaf(vb[2 * c2 + 1], vf.y, g);
        }
        const float p = pbuf[j] * inv;
        pbuf[j] = p;
        sbuf[j] = g;
        rsum = fmaf(p, g, rsum);
      }
      const float rs = warp_sum(rsum);
      for (int j = lane; j < n; j += 32) {
        const float p = pbuf[j];
        const float ds = p * (sbuf[j] - rs);
        if (dbias) {
          float* db = dbias + (size_t)i * n + j;
          *db = si == 0 ? ds : *db + ds;
        }
        sbuf[j] = round_bf16(ds);
        pbuf[j] = round_bf16(p);
      }
      __syncwarp();
      float qv[MAXU], dqn[MAXU];
      const bf16* qr = a.q + q_off + (size_t)i * a.q_tok;
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int c = lane + 32 * u;
        float o = 0.0f, g = 0.0f;
        if (c < d)
          for (int j = 0; j < n; ++j) {
            o = fmaf(pbuf[j], bf2f(Vs[(size_t)j * dp + c]), o);
            g = fmaf(sbuf[j], bf2f(Kn[(size_t)j * dp + c]), g);
          }
        if (c < d) a.merged[q_off + (size_t)i * a.q_tok + c] = f2bf(o);
        dqn[u] = g;
        qv[u] = c < d ? bf2f(qr[c]) : 0.0f;
      }
      const float r = inv_norm(qv);
      float dot = 0.0f, qhat[MAXU], dqh[MAXU];
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        qhat[u] = qv[u] * r;
        dqh[u] = dqn[u] * qs[u];
        dot = fmaf(qhat[u], dqh[u], dot);
        dqs_acc[u] = fmaf(dqn[u], qhat[u], dqs_acc[u]);
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int c = lane + 32 * u;
        if (c < d) a.dq[q_off + (size_t)i * a.q_tok + c] = f2bf(r * (dqh[u] - qhat[u] * dot));
      }
      if (lane == 0) {
        lse_s[i] = mx + logf(sum);
        rs_s[i] = rs;
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- column pass: warps own keys j
    for (int j = warp; j < n; j += nwarps) {
      for (int c = lane; c < d; c += 32) {
        va[c] = bf2f(Kn[(size_t)j * dp + c]);
        vb[c] = bf2f(Vs[(size_t)j * dp + c]);
      }
      __syncwarp();
      for (int i = lane; i < n; i += 32) {
        const bf162* qr = reinterpret_cast<const bf162*>(Qn + (size_t)i * dp);
        const bf162* gr = reinterpret_cast<const bf162*>(Os + (size_t)i * dp);
        float s = 0.0f, g = 0.0f;
        for (int c2 = 0; c2 < d / 2; ++c2) {
          const float2 qf = __bfloat1622float2(qr[c2]);
          const float2 gf = __bfloat1622float2(gr[c2]);
          s = fmaf(qf.x, va[2 * c2], s);
          s = fmaf(qf.y, va[2 * c2 + 1], s);
          g = fmaf(gf.x, vb[2 * c2], g);
          g = fmaf(gf.y, vb[2 * c2 + 1], g);
        }
        if (bias_th) s += bias_th[(size_t)j * n + i];
        const float p = expf(s - lse_s[i]);
        pbuf[i] = round_bf16(p);
        sbuf[i] = round_bf16(p * (g - rs_s[i]));
      }
      __syncwarp();
      float dvv[MAXU], dkn[MAXU];
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int c = lane + 32 * u;
        float x = 0.0f, y = 0.0f;
        if (c < d)
          for (int i = 0; i < n; ++i) {
            x = fmaf(pbuf[i], bf2f(Os[(size_t)i * dp + c]), x);
            y = fmaf(sbuf[i], bf2f(Qn[(size_t)i * dp + c]), y);
          }
        dvv[u] = x;
        dkn[u] = y;
      }
      float kv[MAXU];
      const bf16* kr = a.k + kv_off + (size_t)j * a.kv_tok;
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int c = lane + 32 * u;
        kv[u] = c < d ? bf2f(kr[c]) : 0.0f;
      }
      const float r = inv_norm(kv);
      float dot = 0.0f, khat[MAXU], dkh[MAXU];
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        khat[u] = kv[u] * r;
        dkh[u] = dkn[u] * ks[u];
        dot = fmaf(khat[u], dkh[u], dot);
        dks_acc[u] = fmaf(dkn[u], khat[u], dks_acc[u]);
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int c = lane + 32 * u;
        if (c < d) {
          a.dk[kv_off + (size_t)j * a.kv_tok + c] = f2bf(r * (dkh[u] - khat[u] * dot));
          a.dv[kv_off + (size_t)j * a.kv_tok + c] = f2bf(dvv[u]);
        }
      }
      __syncwarp();
    }
  }

  const size_t slot = (((size_t)grp * a.heads + head) * nwarps + warp) * d;
#pragma unroll
  for (int u = 0; u < MAXU; ++u) {
    const int c = lane + 32 * u;
    if (c < d) {
      a.dqs_part[slot + c] = dqs_acc[u];
      a.dks_part[slot + c] = dks_acc[u];
    }
  }
}

// ------------------------------------------------------------- the f32 form
struct BwdArgs32 {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  float* merged;
  float* dq;
  float* dk;
  float* dv;
  long long q_outer, q_inner, q_head, q_tok;
  long long kv_outer, kv_inner, kv_head, kv_tok;
  int inner, sequences, heads, n, d, group;
  const float* qs;
  const float* ks;
  const float* bias;
  const float* bias_t;
  float* dbias_part;
  float* dqs_part;
  float* dks_part;
  bool vec;  // 16-byte row loads: d, the strides and the bases multiples of 4 floats
};

constexpr int F32_ROWS = 4;  // query (or key) rows per warp: one float4
constexpr int F32_KC = 64;   // keys (or queries) per staged chunk

// The shared memory qk_attention_bwd_f32_kernel takes, in floats: per warp
// two (max(n, KC), 4) tiles (scores and dP or dS of its 4 rows; in the
// column pass P and dS of its 4 keys against a chunk) and two (d, 4) tiles
// (its rows' qn and dO, or its keys' kn and v); two (KC, d + 1) chunks; the
// rows' log-sum-exp and rowsum(P dP) and the q and k rows' inverse norms.
size_t bwd_f32_smem_floats(int warps, int n, int d) {
  const size_t nn = n > F32_KC ? n : F32_KC;
  return (size_t)warps * F32_ROWS * (2 * nn + 2 * d) + 2 * (size_t)F32_KC * (d + 1)
         + 4 * (size_t)n;
}

// inv_norm for U dims per lane (the f32 form takes U = 1 for d <= 32, so
// no lane holds a second, empty dim)
template <int U>
__device__ __forceinline__ float inv_norm_u(const float (&v)[U]) {
  float ss = 0.0f;
#pragma unroll
  for (int u = 0; u < U; ++u) ss += v[u] * v[u];
  return rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
}

// row `i` of a (.., d) f32 tensor at `p`, l2-normalised and times `scale`
// per dim, into v[u] = row[lane + 32 u] (zeros past d or for a missing row)
template <int U>
__device__ __forceinline__ void norm_row(const float* p, bool valid, int d,
                                         const float (&scale)[U], float (&v)[U]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = lane + 32 * u;
    v[u] = valid && c < d ? p[c] : 0.0f;
  }
  const float f = inv_norm_u<U>(v);
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] *= f * scale[u];
}

// rows [r0, r0 + count) of a tensor at `base` (token stride `tok`) into a
// (KC, d + 1) chunk, each times rn[row] * scale[c] (its inverse l2 norm and
// scale, the same product norm_row forms) or, with rn null, as they are;
// every thread of the block loads, 16 bytes at a time with vec
__device__ __forceinline__ void stage_rows(float* chunk, const float* base, long long tok,
                                           int r0, int count, int d, bool vec,
                                           const float* rn, const float* scale) {
  const int dk = d + 1;
  if (vec) {
    const int d4 = d / 4;
    for (int e = threadIdx.x; e < count * d4; e += blockDim.x) {
      const int rr = e / d4, c = (e - rr * d4) * 4;
      const float4 x = *reinterpret_cast<const float4*>(base + (size_t)(r0 + rr) * tok + c);
      float* dst = chunk + rr * dk + c;
      if (rn) {
        const float f = rn[r0 + rr];
        dst[0] = x.x * (f * scale[c]);
        dst[1] = x.y * (f * scale[c + 1]);
        dst[2] = x.z * (f * scale[c + 2]);
        dst[3] = x.w * (f * scale[c + 3]);
      } else {
        dst[0] = x.x;
        dst[1] = x.y;
        dst[2] = x.z;
        dst[3] = x.w;
      }
    }
  } else {
    for (int e = threadIdx.x; e < count * d; e += blockDim.x) {
      const int rr = e / d, c = e - rr * d;
      const float x = base[(size_t)(r0 + rr) * tok + c];
      chunk[rr * dk + c] = rn ? x * (rn[r0 + rr] * scale[c]) : x;
    }
  }
}

__device__ __forceinline__ float& at(float4& v, int r) { return (&v.x)[r]; }
__device__ __forceinline__ float at(const float4& v, int r) { return (&v.x)[r]; }

// U: head dims per lane, (d + 31) / 32
template <int U>
__global__ void qk_attention_bwd_f32_kernel(BwdArgs32 a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.x, head = blockIdx.y;
  const int n = a.n, d = a.d, dk = d + 1, nn = max(n, F32_KC);
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qt = nwarps * F32_ROWS;

  float4* S4 = reinterpret_cast<float4*>(smem);  // per warp (nn,): scores, then P
  float4* G4 = S4 + (size_t)nwarps * nn;           // per warp (nn,): dP, then dS
  float4* A4 = G4 + (size_t)nwarps * nn;           // per warp (d,): qn (or kn)
  float4* B4 = A4 + (size_t)nwarps * d;            // per warp (d,): dO (or v)
  float* ca = reinterpret_cast<float*>(B4 + (size_t)nwarps * d);  // (KC, d + 1) kn (or qn)
  float* cb = ca + F32_KC * dk;                    // (KC, d + 1) v (or dO)
  float* lse_s = cb + F32_KC * dk;                 // (n,)
  float* rs_s = lse_s + n;                         // (n,)
  float* rq_s = rs_s + n;                          // (n,) 1 / |q_i|
  float* rk_s = rq_s + n;                          // (n,) 1 / |k_j|
  float4* s4 = S4 + (size_t)warp * nn;
  float4* g4 = G4 + (size_t)warp * nn;
  float4* a4 = A4 + (size_t)warp * d;
  float4* b4 = B4 + (size_t)warp * d;

  float qs[U], ks[U], dqs_acc[U] = {}, dks_acc[U] = {};
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = lane + 32 * u;
    qs[u] = c < d ? a.qs[c] : 0.0f;
    ks[u] = c < d ? a.ks[c] : 0.0f;
  }
  const float* bias_h = a.bias ? a.bias + (size_t)head * n * n : nullptr;
  const float* bias_th = a.bias_t ? a.bias_t + (size_t)head * n * n : nullptr;
  float* dbias = a.dbias_part ? a.dbias_part + ((size_t)grp * a.heads + head) * n * n : nullptr;

  for (int si = 0; si < a.group; ++si) {
    const int seq = grp * a.group + si;
    if (seq >= a.sequences) break;
    const size_t q_off = (size_t)(seq / a.inner) * a.q_outer
                         + (size_t)(seq % a.inner) * a.q_inner + (size_t)head * a.q_head;
    const size_t kv_off = (size_t)(seq / a.inner) * a.kv_outer
                          + (size_t)(seq % a.inner) * a.kv_inner + (size_t)head * a.kv_head;
    const float* qh = a.q + q_off;
    const float* oh = a.dout + q_off;
    const float* kh = a.k + kv_off;
    const float* vh = a.v + kv_off;

    // every q and k row's inverse l2 norm, which the chunks below scale by
    __syncthreads();  // the previous sequence's readers are done
    for (int r = warp; r < n; r += nwarps) {
      float qv[U], kv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = lane + 32 * u;
        qv[u] = c < d ? qh[(size_t)r * a.q_tok + c] : 0.0f;
        kv[u] = c < d ? kh[(size_t)r * a.kv_tok + c] : 0.0f;
      }
      const float fq = inv_norm_u<U>(qv), fk = inv_norm_u<U>(kv);
      if (lane == 0) {
        rq_s[r] = fq;
        rk_s[r] = fk;
      }
    }

    // ---- row pass: query tiles; warps own 4 query rows each
    for (int t0 = 0; t0 < n; t0 += qt) {
      const int i0 = t0 + warp * F32_ROWS;
      __syncthreads();  // the previous tile's (or sequence's) readers are done
      for (int r = 0; r < F32_ROWS; ++r) {
        const int i = i0 + r;
        float qv[U];
        norm_row(qh + (size_t)i * a.q_tok, i < n, d, qs, qv);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = lane + 32 * u;
          if (c < d) {
            at(a4[c], r) = qv[u];
            at(b4[c], r) = i < n ? oh[(size_t)i * a.q_tok + c] : 0.0f;
          }
        }
      }
      // scores and dP, key chunk by key chunk; lanes split the chunk's keys
      for (int j0 = 0; j0 < n; j0 += F32_KC) {
        const int kc = min(F32_KC, n - j0);
        __syncthreads();
        stage_rows(ca, kh, a.kv_tok, j0, kc, d, a.vec, rk_s, a.ks);
        stage_rows(cb, vh, a.kv_tok, j0, kc, d, a.vec, nullptr, nullptr);
        __syncthreads();
        for (int jj = lane; jj < kc; jj += 32) {
          float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f), g = s;
          const float* kr = ca + jj * dk;
          const float* vr = cb + jj * dk;
          for (int c = 0; c < d; ++c) {
            const float kf = kr[c], vf = vr[c];
            const float4 q4 = a4[c], o4 = b4[c];
            s.x = fmaf(q4.x, kf, s.x);
            s.y = fmaf(q4.y, kf, s.y);
            s.z = fmaf(q4.z, kf, s.z);
            s.w = fmaf(q4.w, kf, s.w);
            g.x = fmaf(o4.x, vf, g.x);
            g.y = fmaf(o4.y, vf, g.y);
            g.z = fmaf(o4.z, vf, g.z);
            g.w = fmaf(o4.w, vf, g.w);
          }
          if (bias_h)
#pragma unroll
            for (int r = 0; r < F32_ROWS; ++r)
              if (i0 + r < n) at(s, r) += bias_h[(size_t)(i0 + r) * n + j0 + jj];
          s4[j0 + jj] = s;
          g4[j0 + jj] = g;
        }
      }
      __syncwarp();
      // each row's softmax, rowsum(P dP) and dS; the four rows at once
      float4 mx = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      for (int j = lane; j < n; j += 32) {
        const float4 s = s4[j];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) at(mx, r) = fmaxf(at(mx, r), at(s, r));
      }
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) at(mx, r) = warp_max(at(mx, r));
      for (int j = lane; j < n; j += 32) {
        float4 s = s4[j];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) {
          at(s, r) = expf(at(s, r) - at(mx, r));
          at(sum, r) += at(s, r);
        }
        s4[j] = s;
      }
      float4 inv, rsum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        at(sum, r) = warp_sum(at(sum, r));
        at(inv, r) = 1.0f / at(sum, r);
      }
      for (int j = lane; j < n; j += 32) {
        float4 p = s4[j];
        const float4 g = g4[j];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) {
          at(p, r) *= at(inv, r);
          at(rsum, r) = fmaf(at(p, r), at(g, r), at(rsum, r));
        }
        s4[j] = p;
      }
      float4 rs;
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) at(rs, r) = warp_sum(at(rsum, r));
      for (int j = lane; j < n; j += 32) {
        float4 p = s4[j], g = g4[j];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) {
          const int i = i0 + r;
          const float ds = at(p, r) * (at(g, r) - at(rs, r));
          if (dbias && i < n) {
            float* db = dbias + (size_t)i * n + j;
            *db = si == 0 ? ds : *db + ds;
          }
          at(g, r) = ds;
          if (CT_QK_BWD_F32_ROUND_P) at(p, r) = round_bf16(at(p, r));
        }
        g4[j] = g;
        if (CT_QK_BWD_F32_ROUND_P) s4[j] = p;
      }
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r)
        if (lane == r && i0 + r < n) {
          lse_s[i0 + r] = at(mx, r) + logf(at(sum, r));
          rs_s[i0 + r] = at(rs, r);
        }
      __syncwarp();
      // the merged heads P v and dqn = dS kn, key chunk by key chunk
      float om[F32_ROWS][U] = {}, dqn[F32_ROWS][U] = {};
      for (int j0 = 0; j0 < n; j0 += F32_KC) {
        const int kc = min(F32_KC, n - j0);
        __syncthreads();
        stage_rows(ca, kh, a.kv_tok, j0, kc, d, a.vec, rk_s, a.ks);
        stage_rows(cb, vh, a.kv_tok, j0, kc, d, a.vec, nullptr, nullptr);
        __syncthreads();
        for (int jj = 0; jj < kc; ++jj) {
          const float4 p = s4[j0 + jj], ds = g4[j0 + jj];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = lane + 32 * u;
            const float kf = c < d ? ca[jj * dk + c] : 0.0f;
            const float vf = c < d ? cb[jj * dk + c] : 0.0f;
#pragma unroll
            for (int r = 0; r < F32_ROWS; ++r) {
              om[r][u] = fmaf(at(p, r), vf, om[r][u]);
              dqn[r][u] = fmaf(at(ds, r), kf, dqn[r][u]);
            }
          }
        }
      }
      // merged, and dq through the l2norm (:200-211)
      for (int r = 0; r < F32_ROWS; ++r) {
        const int i = i0 + r;
        if (i >= n) break;
        const float* qr = qh + (size_t)i * a.q_tok;
        float qv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = lane + 32 * u;
          qv[u] = c < d ? qr[c] : 0.0f;
        }
        const float rn = inv_norm_u<U>(qv);
        float dot = 0.0f, qhat[U], dqh[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          qhat[u] = qv[u] * rn;
          dqh[u] = dqn[r][u] * qs[u];
          dot = fmaf(qhat[u], dqh[u], dot);
          dqs_acc[u] = fmaf(dqn[r][u], qhat[u], dqs_acc[u]);
        }
        dot = warp_sum(dot);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = lane + 32 * u;
          if (c < d) {
            a.merged[q_off + (size_t)i * a.q_tok + c] = om[r][u];
            a.dq[q_off + (size_t)i * a.q_tok + c] = rn * (dqh[u] - qhat[u] * dot);
          }
        }
      }
    }

    // ---- column pass: key tiles; warps own 4 keys each
    for (int t0 = 0; t0 < n; t0 += qt) {
      const int j0k = t0 + warp * F32_ROWS;
      __syncthreads();  // the row pass (lse, rs) or the previous tile is done
      for (int r = 0; r < F32_ROWS; ++r) {
        const int j = j0k + r;
        float kv[U];
        norm_row(kh + (size_t)j * a.kv_tok, j < n, d, ks, kv);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = lane + 32 * u;
          if (c < d) {
            at(a4[c], r) = kv[u];
            at(b4[c], r) = j < n ? vh[(size_t)j * a.kv_tok + c] : 0.0f;
          }
        }
      }
      float dvv[F32_ROWS][U] = {}, dkn[F32_ROWS][U] = {};
      for (int i0 = 0; i0 < n; i0 += F32_KC) {
        const int kc = min(F32_KC, n - i0);
        __syncthreads();
        stage_rows(ca, qh, a.q_tok, i0, kc, d, a.vec, rq_s, a.qs);
        stage_rows(cb, oh, a.q_tok, i0, kc, d, a.vec, nullptr, nullptr);
        __syncthreads();
        // P and dS of this warp's 4 keys against the chunk's queries
        for (int ii = lane; ii < kc; ii += 32) {
          float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f), g = s;
          const float* qr = ca + ii * dk;
          const float* gr = cb + ii * dk;
          for (int c = 0; c < d; ++c) {
            const float qf = qr[c], gf = gr[c];
            const float4 k4 = a4[c], v4 = b4[c];
            s.x = fmaf(qf, k4.x, s.x);
            s.y = fmaf(qf, k4.y, s.y);
            s.z = fmaf(qf, k4.z, s.z);
            s.w = fmaf(qf, k4.w, s.w);
            g.x = fmaf(gf, v4.x, g.x);
            g.y = fmaf(gf, v4.y, g.y);
            g.z = fmaf(gf, v4.z, g.z);
            g.w = fmaf(gf, v4.w, g.w);
          }
          const int i = i0 + ii;
          const float lse = lse_s[i], rsi = rs_s[i];
          float4 p, ds;
#pragma unroll
          for (int r = 0; r < F32_ROWS; ++r) {
            float sv = at(s, r);
            if (bias_th && j0k + r < n) sv += bias_th[(size_t)(j0k + r) * n + i];
            at(p, r) = expf(sv - lse);
            at(ds, r) = at(p, r) * (at(g, r) - rsi);
          }
          s4[ii] = p;
          g4[ii] = ds;
        }
        __syncwarp();
        for (int ii = 0; ii < kc; ++ii) {
          const float4 p = s4[ii], ds = g4[ii];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = lane + 32 * u;
            const float qf = c < d ? ca[ii * dk + c] : 0.0f;
            const float gf = c < d ? cb[ii * dk + c] : 0.0f;
#pragma unroll
            for (int r = 0; r < F32_ROWS; ++r) {
              dvv[r][u] = fmaf(at(p, r), gf, dvv[r][u]);
              dkn[r][u] = fmaf(at(ds, r), qf, dkn[r][u]);
            }
          }
        }
        __syncwarp();
      }
      // dv, and dk through the l2norm
      for (int r = 0; r < F32_ROWS; ++r) {
        const int j = j0k + r;
        if (j >= n) break;
        const float* kr = kh + (size_t)j * a.kv_tok;
        float kv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = lane + 32 * u;
          kv[u] = c < d ? kr[c] : 0.0f;
        }
        const float rn = inv_norm_u<U>(kv);
        float dot = 0.0f, khat[U], dkh[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          khat[u] = kv[u] * rn;
          dkh[u] = dkn[r][u] * ks[u];
          dot = fmaf(khat[u], dkh[u], dot);
          dks_acc[u] = fmaf(dkn[r][u], khat[u], dks_acc[u]);
        }
        dot = warp_sum(dot);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = lane + 32 * u;
          if (c < d) {
            a.dk[kv_off + (size_t)j * a.kv_tok + c] = rn * (dkh[u] - khat[u] * dot);
            a.dv[kv_off + (size_t)j * a.kv_tok + c] = dvv[r][u];
          }
        }
      }
    }
  }

  const size_t slot = (((size_t)grp * a.heads + head) * nwarps + warp) * d;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = lane + 32 * u;
    if (c < d) {
      a.dqs_part[slot + c] = dqs_acc[u];
      a.dks_part[slot + c] = dks_acc[u];
    }
  }
}

}  // namespace

// Grid (groups, heads), `warps` warps a block; groups = ceil(sequences /
// group).  dbias_part (groups, heads, n, n) must be given with bias;
// dqs_part and dks_part are (groups, heads, warps, d).
CT_EXPORT int ct_qk_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* dout, void* merged, void* dq, void* dk, void* dv,
                                  long long q_outer, long long q_inner, long long q_head,
                                  long long q_tok, long long kv_outer, long long kv_inner,
                                  long long kv_head, long long kv_tok, int inner,
                                  int sequences, int heads, int n, int d, int group,
                                  const void* q_scale, const void* k_scale, const void* bias,
                                  const void* bias_t, void* dbias_part, void* dqs_part,
                                  void* dks_part, int warps, void* stream) {
  if (d > 32 * MAXU || d % 2 || warps < 1 || warps > 32 || group < 1
      || (bias != nullptr) != (dbias_part != nullptr) || (bias != nullptr) != (bias_t != nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.merged = static_cast<bf16*>(merged);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.q_outer = q_outer; a.q_inner = q_inner; a.q_head = q_head; a.q_tok = q_tok;
  a.kv_outer = kv_outer; a.kv_inner = kv_inner; a.kv_head = kv_head; a.kv_tok = kv_tok;
  a.inner = inner; a.sequences = sequences; a.heads = heads; a.n = n; a.d = d;
  a.group = group;
  a.qs = static_cast<const float*>(q_scale);
  a.ks = static_cast<const float*>(k_scale);
  a.bias = static_cast<const float*>(bias);
  a.bias_t = static_cast<const float*>(bias_t);
  a.dbias_part = static_cast<float*>(dbias_part);
  a.dqs_part = static_cast<float*>(dqs_part);
  a.dks_part = static_cast<float*>(dks_part);
  size_t smem = (size_t)4 * n * (d + 2) * sizeof(bf16);
  smem = (smem + 15) & ~(size_t)15;
  smem += ((size_t)2 * n + (size_t)warps * (2 * n + 2 * d)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qk_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((sequences + group - 1) / group, heads);
  qk_attention_bwd_kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The f32 form of ct_qk_attention_bwd: q, k, v, dout, merged, dq, dk and dv
// f32, the same addressing, partials and grid.
CT_EXPORT int ct_qk_attention_bwd_f32(const void* q, const void* k, const void* v,
                                      const void* dout, void* merged, void* dq, void* dk,
                                      void* dv, long long q_outer, long long q_inner,
                                      long long q_head, long long q_tok, long long kv_outer,
                                      long long kv_inner, long long kv_head, long long kv_tok,
                                      int inner, int sequences, int heads, int n, int d,
                                      int group, const void* q_scale, const void* k_scale,
                                      const void* bias, const void* bias_t, void* dbias_part,
                                      void* dqs_part, void* dks_part, int warps, void* stream) {
  if (d > 32 * MAXU || d < 1 || n < 1 || warps < 1 || warps > 32 || group < 1
      || (bias != nullptr) != (dbias_part != nullptr) || (bias != nullptr) != (bias_t != nullptr))
    return (int)cudaErrorInvalidValue;
  BwdArgs32 a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.merged = static_cast<float*>(merged);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.q_outer = q_outer; a.q_inner = q_inner; a.q_head = q_head; a.q_tok = q_tok;
  a.kv_outer = kv_outer; a.kv_inner = kv_inner; a.kv_head = kv_head; a.kv_tok = kv_tok;
  a.inner = inner; a.sequences = sequences; a.heads = heads; a.n = n; a.d = d;
  a.group = group;
  a.qs = static_cast<const float*>(q_scale);
  a.ks = static_cast<const float*>(k_scale);
  a.bias = static_cast<const float*>(bias);
  a.bias_t = static_cast<const float*>(bias_t);
  a.dbias_part = static_cast<float*>(dbias_part);
  a.dqs_part = static_cast<float*>(dqs_part);
  a.dks_part = static_cast<float*>(dks_part);
  const long long strides[] = {q_outer, q_inner, q_head, q_tok, kv_outer, kv_inner, kv_head,
                               kv_tok, d};
  a.vec = true;
  for (long long st : strides) a.vec = a.vec && st % 4 == 0;
  const void* bases[] = {q, k, v, dout};
  for (const void* p : bases) a.vec = a.vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const size_t smem = bwd_f32_smem_floats(warps, n, d) * sizeof(float);
  const dim3 grid((sequences + group - 1) / group, heads);
  const auto kernel = d <= 32 ? qk_attention_bwd_f32_kernel<1> : qk_attention_bwd_f32_kernel<2>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
