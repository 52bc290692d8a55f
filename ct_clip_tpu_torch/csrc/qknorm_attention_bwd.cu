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
#include "common.cuh"

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
