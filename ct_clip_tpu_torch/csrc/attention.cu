// attention.cu — softmax(q k^T + bias) v for one (sequence, head) per block,
// with an optional per-head l2 QK-norm and f32 scores.
//
// Replaces the attention cores of these TPU kernels:
//   * ct_clip_tpu/ops/pallas/spatial_attention.py::_pallas_spatial (K1):
//     576-token planes, QK-norm, per-head (h, n, n) CPB bias;
//   * ops/pallas/small_attention.py::_pallas_small_qknorm (K2): 24-token
//     temporal columns read in place from the (b, t, h*w, d) grid through
//     the strides below (no sequence-major copy), QK-norm, no bias.
// (K7, BERT's key-bias attention, runs in attention_train.cu.)
//
// Addressing: head h of sequence s of a tensor starts at
//   (s / inner) * outer + (s % inner) * inner_stride + h * head_stride
// and token i sits i * tok further on.  q and the output share strides; k
// and v share theirs.
//
// What bounds it on the H100: arithmetic.  At batch 2 the spatial stage's
// scores and PV are 16.3 GFLOP per layer against ~57 MB of q, k, v and
// output (~17 us of memory time).
// This first version runs them on the CUDA cores (67 TFLOP/s fp32 peak, so
// >= 0.24 ms per spatial layer) from shared memory: K and V of the (sequence, head)
// are staged once (K rows padded to d + 2 so 32 lanes reading 32 keys hit
// 32 banks), each warp owns query rows, keeps its f32 scores in shared
// memory, and never writes them to device memory.  A 576-token plane stages
// ~76 KB, above the 48 KB default, so the launch raises the dynamic
// shared-memory limit.  Tensor-core (mma) scores are later work.
//
// The f32 form (attention_f32_kernel; the TPU kernels run f32 operands in
// f32, "highest", spatial_attention.py:288, small_attention.py:242): q, k,
// v and the output f32, nothing rounded.  A 576-token plane's f32 k and v
// (295 KB) do not fit one block, so a block owns one (sequence, head) and a
// tile of QT = 4 x warps query rows and walks the keys in chunks of KC: the
// normalised keys of a chunk are staged, each warp scores its 4 rows
// against them (all n f32 scores of the tile kept in shared memory), then
// each row's softmax as in the bf16 kernel (row max, exp, sum, one
// reciprocal), then the values chunk by chunk into the rows' f32 sums, each
// an FMA chain over the keys in order.  Per block: the score tile (QT x n),
// the q tile and one key or value chunk, ~115 KB at n = 576; k and v are
// read once per query tile (from L2).  The same 67 TFLOP/s bound.
#include "common.cuh"

namespace {

constexpr int MAX_D = 128;  // dims per lane: d <= 4 * 32

template <typename T>
struct AttnArgsT {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  long long q_outer, q_inner, q_head, q_tok;
  long long kv_outer, kv_inner, kv_head, kv_tok;
  int inner, n, d;
  const float* qs;  // (d,) q scale incl. the fixed logit scale; null: no QK-norm
  const float* ks;  // (d,) k scale
  const float* bias;  // (heads, n, n) or null
};
typedef AttnArgsT<bf16> AttnArgs;

__global__ void attention_kernel(AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int seq = blockIdx.x, head = blockIdx.y;
  const int n = a.n, d = a.d, dk = d + 2;
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool qknorm = a.qs != nullptr;

  bf16* Ks = reinterpret_cast<bf16*>(smem);               // (n, d + 2)
  bf16* Vs = Ks + (size_t)n * dk;                          // (n, d)
  size_t off = ((size_t)n * dk + (size_t)n * d) * sizeof(bf16);
  off = (off + 15) & ~(size_t)15;
  float* qbuf = reinterpret_cast<float*>(smem + off) + warp * d;            // (nwarps, d)
  float* sbuf = reinterpret_cast<float*>(smem + off) + nwarps * d + (size_t)warp * n;  // (nwarps, n)

  const size_t q_off = (size_t)(seq / a.inner) * a.q_outer + (size_t)(seq % a.inner) * a.q_inner
                       + (size_t)head * a.q_head;
  const size_t kv_off = (size_t)(seq / a.inner) * a.kv_outer
                        + (size_t)(seq % a.inner) * a.kv_inner + (size_t)head * a.kv_head;

  // stage K (l2-normalised and scaled, rounded to bf16) and V
  for (int j = warp; j < n; j += nwarps) {
    const bf16* kr = a.k + kv_off + (size_t)j * a.kv_tok;
    const bf16* vr = a.v + kv_off + (size_t)j * a.kv_tok;
    float kv[MAX_D / 32];
    float ss = 0.0f;
#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) {
      const int c = lane + u * 32;
      kv[u] = c < d ? bf2f(kr[c]) : 0.0f;
      ss += kv[u] * kv[u];
    }
    float f = 1.0f;
    if (qknorm) f = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) {
      const int c = lane + u * 32;
      if (c < d) {
        Ks[(size_t)j * dk + c] = f2bf(qknorm ? kv[u] * f * a.ks[c] : kv[u]);
        Vs[(size_t)j * d + c] = vr[c];
      }
    }
  }
  __syncthreads();

  for (int i = warp; i < n; i += nwarps) {
    const bf16* qr = a.q + q_off + (size_t)i * a.q_tok;
    float qv[MAX_D / 32];
    float ss = 0.0f;
#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) {
      const int c = lane + u * 32;
      qv[u] = c < d ? bf2f(qr[c]) : 0.0f;
      ss += qv[u] * qv[u];
    }
    float f = 1.0f;
    if (qknorm) f = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) {
      const int c = lane + u * 32;
      if (c < d) qbuf[c] = qknorm ? round_bf16(qv[u] * f * a.qs[c]) : qv[u];
    }
    __syncwarp();

    // f32 scores for this query row; lanes split the keys
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const bf162* kr = reinterpret_cast<const bf162*>(Ks + (size_t)j * dk);
      float s = 0.0f;
      for (int c2 = 0; c2 < d / 2; ++c2) {
        const float2 kf = __bfloat1622float2(kr[c2]);
        s = fmaf(qbuf[2 * c2], kf.x, s);
        s = fmaf(qbuf[2 * c2 + 1], kf.y, s);
      }
      if (a.bias) s += a.bias[((size_t)head * n + i) * n + j];
      sbuf[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sbuf[j] - mx);
      sbuf[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    // probabilities rounded to bf16 before the PV product, as the reference
    // casts softmax(sim) to v's dtype
    for (int j = lane; j < n; j += 32) sbuf[j] = round_bf16(sbuf[j] * inv);
    __syncwarp();

#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) {
      const int c = lane + u * 32;
      if (c < d) {
        float acc = 0.0f;
        for (int j = 0; j < n; ++j) acc = fmaf(sbuf[j], bf2f(Vs[(size_t)j * d + c]), acc);
        a.o[q_off + (size_t)i * a.q_tok + c] = f2bf(acc);
      }
    }
    __syncwarp();
  }
}

constexpr int F32_ROWS = 4;  // query rows per warp
constexpr int F32_KC = 64;   // keys per staged chunk

// The shared memory attention_f32_kernel takes, in floats: the (QT, n)
// score tile, the (QT, d) q tile and one (KC, d + 1) key or (KC, d) value
// chunk.
size_t f32_smem_floats(int warps, int n, int d) {
  const size_t qt = (size_t)warps * F32_ROWS;
  return qt * n + qt * d + (size_t)F32_KC * (d + 1);
}

__global__ void attention_f32_kernel(AttnArgsT<float> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int seq = blockIdx.x, head = blockIdx.y;
  const int n = a.n, d = a.d, dk = d + 1;
  const int nwarps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qt = nwarps * F32_ROWS, i0 = blockIdx.z * qt + warp * F32_ROWS;
  const bool qknorm = a.qs != nullptr;

  float* sbuf = reinterpret_cast<float*>(smem);     // (qt, n) scores, then p
  float* qbuf = sbuf + (size_t)qt * n;               // (qt, d)
  float* chunk = qbuf + (size_t)qt * d;              // (KC, d + 1) keys or (KC, d) values
  float* srow = sbuf + (size_t)warp * F32_ROWS * n;  // this warp's rows
  float* qrow = qbuf + (size_t)warp * F32_ROWS * d;

  const size_t q_off = (size_t)(seq / a.inner) * a.q_outer + (size_t)(seq % a.inner) * a.q_inner
                       + (size_t)head * a.q_head;
  const size_t kv_off = (size_t)(seq / a.inner) * a.kv_outer
                        + (size_t)(seq % a.inner) * a.kv_inner + (size_t)head * a.kv_head;

  // this warp's q rows, l2-normalised and scaled (rows past n: zeros)
  for (int r = 0; r < F32_ROWS; ++r) {
    const int i = i0 + r;
    float qv[MAX_D / 32];
    float ss = 0.0f;
#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) {
      const int c = lane + u * 32;
      qv[u] = (c < d && i < n) ? a.q[q_off + (size_t)i * a.q_tok + c] : 0.0f;
      ss += qv[u] * qv[u];
    }
    float f = 1.0f;
    if (qknorm) f = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) {
      const int c = lane + u * 32;
      if (c < d) qrow[r * d + c] = qknorm ? qv[u] * f * a.qs[c] : qv[u];
    }
  }

  // f32 scores, key chunk by key chunk; lanes split the chunk's keys
  for (int j0 = 0; j0 < n; j0 += F32_KC) {
    const int kc = min(F32_KC, n - j0);
    __syncthreads();  // the previous chunk is consumed (and the q tile written)
    for (int jj = warp; jj < kc; jj += nwarps) {
      const float* kr = a.k + kv_off + (size_t)(j0 + jj) * a.kv_tok;
      float kv[MAX_D / 32];
      float ss = 0.0f;
#pragma unroll
      for (int u = 0; u < MAX_D / 32; ++u) {
        const int c = lane + u * 32;
        kv[u] = c < d ? kr[c] : 0.0f;
        ss += kv[u] * kv[u];
      }
      float f = 1.0f;
      if (qknorm) f = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
#pragma unroll
      for (int u = 0; u < MAX_D / 32; ++u) {
        const int c = lane + u * 32;
        if (c < d) chunk[jj * dk + c] = qknorm ? kv[u] * f * a.ks[c] : kv[u];
      }
    }
    __syncthreads();
    for (int jj = lane; jj < kc; jj += 32) {
      const float* kr = chunk + jj * dk;
      float s[F32_ROWS];
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) s[r] = 0.0f;
      for (int c = 0; c < d; ++c) {
        const float kf = kr[c];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r) s[r] = fmaf(qrow[r * d + c], kf, s[r]);
      }
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) {
        const int i = i0 + r;
        if (a.bias && i < n) s[r] += a.bias[((size_t)head * n + i) * n + j0 + jj];
        srow[r * n + j0 + jj] = s[r];
      }
    }
  }
  __syncwarp();

  // each row's softmax in place: p = exp(s - max) / sum
  for (int r = 0; r < F32_ROWS; ++r) {
    float* sr = srow + r * n;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sr[j] - mx);
      sr[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int j = lane; j < n; j += 32) sr[j] *= inv;
  }

  // p v, value chunk by value chunk
  float acc[F32_ROWS][MAX_D / 32];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r)
#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) acc[r][u] = 0.0f;
  for (int j0 = 0; j0 < n; j0 += F32_KC) {
    const int kc = min(F32_KC, n - j0);
    __syncthreads();  // the previous chunk is consumed, every row's p written
    for (int e = threadIdx.x; e < kc * d; e += blockDim.x) {
      const int jj = e / d, c = e - jj * d;
      chunk[jj * d + c] = a.v[kv_off + (size_t)(j0 + jj) * a.kv_tok + c];
    }
    __syncthreads();
    for (int jj = 0; jj < kc; ++jj) {
#pragma unroll
      for (int u = 0; u < MAX_D / 32; ++u) {
        const int c = lane + u * 32;
        const float vf = c < d ? chunk[jj * d + c] : 0.0f;
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r)
          acc[r][u] = fmaf(srow[r * n + j0 + jj], vf, acc[r][u]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) {
    const int i = i0 + r;
    if (i >= n) continue;
#pragma unroll
    for (int u = 0; u < MAX_D / 32; ++u) {
      const int c = lane + u * 32;
      if (c < d) a.o[q_off + (size_t)i * a.q_tok + c] = acc[r][u];
    }
  }
}

template <typename T>
AttnArgsT<T> attn_args(const void* q, const void* k, const void* v, void* o, long long q_outer,
                       long long q_inner, long long q_head, long long q_tok,
                       long long kv_outer, long long kv_inner, long long kv_head,
                       long long kv_tok, int inner, int n, int d, const void* q_scale,
                       const void* k_scale, const void* bias) {
  AttnArgsT<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<T*>(o);
  a.q_outer = q_outer; a.q_inner = q_inner; a.q_head = q_head; a.q_tok = q_tok;
  a.kv_outer = kv_outer; a.kv_inner = kv_inner; a.kv_head = kv_head; a.kv_tok = kv_tok;
  a.inner = inner; a.n = n; a.d = d;
  a.qs = static_cast<const float*>(q_scale);
  a.ks = static_cast<const float*>(k_scale);
  a.bias = static_cast<const float*>(bias);
  return a;
}

}  // namespace

// The f32 form of ct_attention: q, k, v and o f32, the same addressing;
// blocks of (sequence, head, 4 x warps query rows).
CT_EXPORT int ct_attention_f32(const void* q, const void* k, const void* v, void* o,
                               long long q_outer, long long q_inner, long long q_head,
                               long long q_tok, long long kv_outer, long long kv_inner,
                               long long kv_head, long long kv_tok,
                               int inner, int sequences, int heads, int n, int d,
                               const void* q_scale, const void* k_scale, const void* bias,
                               int warps, void* stream) {
  if (d > MAX_D || d < 1 || n < 1 || warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  const AttnArgsT<float> a = attn_args<float>(q, k, v, o, q_outer, q_inner, q_head, q_tok,
                                              kv_outer, kv_inner, kv_head, kv_tok, inner, n, d,
                                              q_scale, k_scale, bias);
  const size_t smem = f32_smem_floats(warps, n, d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int qt = warps * F32_ROWS;
  const dim3 grid(sequences, heads, (n + qt - 1) / qt);
  attention_f32_kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

CT_EXPORT int ct_attention(const void* q, const void* k, const void* v, void* o,
                           long long q_outer, long long q_inner, long long q_head,
                           long long q_tok, long long kv_outer, long long kv_inner,
                           long long kv_head, long long kv_tok,
                           int inner, int sequences, int heads, int n, int d,
                           const void* q_scale, const void* k_scale, const void* bias,
                           int warps, void* stream) {
  if (d > MAX_D || d % 2 || warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  const AttnArgs a = attn_args<bf16>(q, k, v, o, q_outer, q_inner, q_head, q_tok, kv_outer,
                                     kv_inner, kv_head, kv_tok, inner, n, d, q_scale, k_scale,
                                     bias);
  size_t smem = ((size_t)n * (d + 2) + (size_t)n * d) * sizeof(bf16);
  smem = (smem + 15) & ~(size_t)15;
  smem += ((size_t)warps * d + (size_t)warps * n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(sequences, heads);
  attention_kernel<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
