// qknorm_attention_short.cu — the attention core of the CTViT QK-norm
// sublayer's forward on short sequences at head dim 32, in bf16 and in f32:
// from the projections q and kv = [k | v] it writes the merged heads
// softmax(l2norm(q) qs (l2norm(k) ks)^T) v of every (sequence, head).
//
// Replaces, at head dim 32 and 16 <= n < 32 tokens (ops/kernels::
// qk_fwd_route), the core of ct_clip_tpu/ops/pallas/small_attention.py::
// _pallas_small_qknorm (K2, :196, pallas_call :239, body _kernel :82-149, the
// core :104-146) in both its layouts: the t-columns of the native (b, t, h w,
// dim) token grid, read in place through the strides
// (fused_small_qknorm_attention_grid, :606; CT-CLIP's 24 and 16 frames of
// tokens), and the sequence-major (b h w, t, dim) sequences of non-cubic
// grids (fused_small_qknorm_attention, :503; the autoencoder's 20).
// attention.cu's attention_kernel and attention_f32_kernel ran it before (one
// (sequence, head) per 64-thread block, 2-byte loads, each output a serial
// FMA chain from shared memory); they keep every other shape.
//
// Math per (sequence, head), at the TPU kernel's rounding points: qn =
// l2norm(q) qs, qs including the logit scale 8, kn = l2norm(k) ks; S = qn
// kn^T in f32; e = exp(S - rowmax); merged = (e v) / sum(e).  bf16 rounds qn
// and kn (:117-118) and e before e v (:142); the sum is the f32 sum of the
// unrounded e (:140), and merged is rounded once (:144).  f32 rounds nothing
// and writes merged as its TF32 hi and lo planes, the A operand of
// ffn_tc32.cu's residual product.
//
// What bounds it on the H100: bytes.  At zero-shot's batch of 2 (1,152
// t-columns of 24 tokens, 8 heads of 32) the scores and e v are 0.68 GFLOP
// against 57 MB of q, kv and merged in bf16 (0.017 ms at 3.35 TB/s); in f32,
// merged written twice, 141 MB (0.042 ms), and the same 0.68 GFLOP are 0.010
// ms on the f32 CUDA cores.
//
// Design:
//   * One CTA of four warps takes one sequence and all of its heads: its n
//     token rows of q (heads x 32 contiguous elements: 512 bytes in bf16 at 8
//     heads) and of kv (1,024) are copied whole by 16-byte cp.async into
//     shared memory, each staged row padded by 16 bytes, so the eight rows a
//     fragment read or a quarter-warp's 16-byte read touches start 4 banks
//     apart.  A sequence is ~37 KB in bf16 and ~74 KB in f32 at n 24: five /
//     three CTAs an SM, one CTA's copies in flight under another's arithmetic,
//     and no grid of 9,216 64-thread blocks.
//   * A warp owns one (sequence, head) at a time (heads warp, warp + 4, ...).
//     bf16 runs the two products on mma.sync m16n8k16: the queries padded to
//     two m16 tiles, the keys to four n8 tiles for S and two k16 steps for e
//     v, the 32 dims two k16 steps.  The four threads of a fragment row hold
//     its 32 dims, so q and k are normalised as their fragments are read (a
//     sum over the quad), v comes by ldmatrix.trans, and e goes from S's
//     accumulators into the A operand of e v with no shuffle.  Keys past n
//     score -inf; rows past n are zero and never written.
//   * f32 runs on the CUDA cores in true f32 (FFMA: more exact than 3xTF32,
//     and ~0.01 ms of work): a lane a query, its qn row in registers, the kn
//     rows (normalised in place, a lane a key) and the v rows broadcast from
//     shared memory.
//   * merged goes over the warp's own q columns in shared memory (f32: the hi
//     plane there, the lo plane over its k columns), and the CTA stores whole
//     rows with 16-byte stores once every warp is done.
// A launch that the checks or the card refuse returns its error.
#include "common.cuh"
#include "tc32.cuh"
#include "wgmma.cuh"

namespace {

constexpr int HD = 32;          // head dim
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;  // threads of a CTA
constexpr int MAX_N = 32;       // tokens a warp's tiles hold

struct ShortArgs {
  const void* q;
  const void* kv;
  void* merged;
  void* merged_lo;  // f32: merged's TF32 lo plane
  long long q_outer, q_inner, q_tok, kv_outer, kv_inner, kv_tok;
  int inner, H, n;
  const float* qs;  // (32,) q scale incl. the logit scale
  const float* ks;  // (32,) k scale
};

// elements of a staged q or kv row: heads x 32 (q) or 2 heads x 32 (kv),
// plus 16 bytes
template <typename T>
__host__ __device__ constexpr int pad_elems() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ inline int q_ld(int H) { return H * HD + pad_elems<T>(); }
template <typename T>
__host__ __device__ inline int kv_ld(int H) { return 2 * H * HD + pad_elems<T>(); }
template <typename T>
size_t smem_bytes(int H, int n) { return (size_t)n * (q_ld<T>(H) + kv_ld<T>(H)) * sizeof(T); }

// n rows of `width` elements, src + t tok, into shared memory at dst + t ld
// elements, 16 bytes a copy
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long tok, int n, int width,
                                      int ld) {
  constexpr int CH = pad_elems<T>();
  const int chunks = width / CH;
  const uint32_t base = saddr(dst);
  for (int i = threadIdx.x; i < n * chunks; i += NT) {
    const int t = i / chunks, c = i - t * chunks;
    cp16(base + (uint32_t)(t * ld + c * CH) * sizeof(T), src + t * tok + c * CH, 16);
  }
}

// n rows of `width` elements from shared memory (src + t ld) to dst + t tok,
// 16 bytes a store
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, long long tok, const T* src, int ld, int n,
                                           int width) {
  constexpr int CH = pad_elems<T>();
  const int chunks = width / CH;
  for (int i = threadIdx.x; i < n * chunks; i += NT) {
    const int t = i / chunks, c = i - t * chunks;
    *reinterpret_cast<uint4*>(dst + t * tok + c * CH) =
        *reinterpret_cast<const uint4*>(src + t * ld + c * CH);
  }
}

// ------------------------------------------------------ bf16 on mma.sync
// d += A B: m16 n8 k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: lane L gives row L % 8 of matrix L / 8
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The 8 of a row's 32 dims a fragment thread holds, dims 8 u + 2 q4 + {0, 1}
// as r[u], l2-normalised over the row (its four threads) and scaled by sc,
// rounded to bf16; zero for a row past n (`ok` false).  Every lane calls it.
__device__ __forceinline__ void normed_row(uint32_t (&r)[4], const bf16* row, bool ok,
                                           const float* sc, int q4) {
  float x[8];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 v = ok ? __bfloat1622float2(*reinterpret_cast<const bf162*>(row + 8 * u + 2 * q4))
                        : make_float2(0.0f, 0.0f);
    x[2 * u] = v.x;
    x[2 * u + 1] = v.y;
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ss = fmaf(x[i], x[i], ss);
  const float f = rsqrtf(fmaxf(sum4(ss), 1e-24f));
#pragma unroll
  for (int u = 0; u < 4; ++u)
    r[u] = pack_bf16(x[2 * u] * f * sc[8 * u + 2 * q4], x[2 * u + 1] * f * sc[8 * u + 2 * q4 + 1]);
}

// One (sequence, head) in bf16: Qh, Kh, Vh its columns of the staged rows;
// merged over Qh.
__device__ __forceinline__ void pair_mma(bf16* Qh, const bf16* Kh, const bf16* Vh, int qld,
                                         int kvld, int n, const float* qs, const float* ks,
                                         int lane) {
  const int g = lane >> 2, q4 = lane & 3;
  // kn as B of S = qn kn^T: key tile nt (keys 8 nt + g), dims 0-15 in kb[nt][0..1],
  // 16-31 in kb[nt][2..3]
  uint32_t kb[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    normed_row(kb[nt], Kh + (8 * nt + g) * kvld, 8 * nt + g < n, ks, q4);
  // v as B of e v: key step ks (keys 16 ks ..), dim tile dt; matrix m of an x4 is
  // keys 16 ks + 8 (m & 1) .. of dims 8 (2 dp + (m >> 1)) ..; keys past n read
  // row 0 (finite; their e is 0)
  uint32_t vb[2][4][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      const int m = lane >> 3, j = 16 * ks + 8 * (m & 1) + (lane & 7);
      uint32_t r[4];
      ldsm_x4_trans(r, saddr(Vh + (j < n ? j : 0) * kvld + 8 * (2 * dp + (m >> 1))));
      vb[ks][2 * dp][0] = r[0];
      vb[ks][2 * dp][1] = r[1];
      vb[ks][2 * dp + 1][0] = r[2];
      vb[ks][2 * dp + 1][1] = r[3];
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int i0 = 16 * mt + g;  // this thread's rows: i0, i0 + 8
    uint32_t lo[4], hi[4];
    normed_row(lo, Qh + i0 * qld, i0 < n, qs, q4);
    normed_row(hi, Qh + (i0 + 8) * qld, i0 + 8 < n, qs, q4);
    const uint32_t qa0[4] = {lo[0], hi[0], lo[1], hi[1]};  // dims 0-15
    const uint32_t qa1[4] = {lo[2], hi[2], lo[3], hi[3]};  // dims 16-31
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      mma16816(s[nt], qa0, kb[nt][0], kb[nt][1]);
      mma16816(s[nt], qa1, kb[nt][2], kb[nt][3]);
    }
    // the rows' softmax: element e of tile nt is row i0 + 8 (e >> 1), key 8 nt + 2 q4 + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = 8 * nt + 2 * q4 + (e & 1) < n ? s[nt][e] : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    mx[0] = max4(mx[0]);
    mx[1] = max4(mx[1]);
    float l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fexp2((s[nt][e] - mx[e >> 1]) * LOG2E);  // 0 past n
        l[e >> 1] += p;
        s[nt][e] = p;
      }
    l[0] = sum4(l[0]);
    l[1] = sum4(l[1]);
    // e v, e rounded to bf16 as the A operand (S tiles 2 ks, 2 ks + 1 are its k16 step ks)
    float o[4][4];
#pragma unroll
    for (int dt = 0; dt < 4; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int dt = 0; dt < 4; ++dt) mma16816(o[dt], pa, vb[ks][dt][0], vb[ks][dt][1]);
    }
    __syncwarp();  // every lane has read this m tile's q rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 8 * h;
      if (i >= n) continue;
#pragma unroll
      for (int dt = 0; dt < 4; ++dt)
        *reinterpret_cast<bf162*>(Qh + i * qld + 8 * dt + 2 * q4) =
            __floats2bfloat162_rn(o[dt][2 * h] / l[h], o[dt][2 * h + 1] / l[h]);
    }
  }
}

// ------------------------------------------------------- f32 on FFMA
// 8 elements of a row in shared memory, and back
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// a row's 32 elements l2-normalised and scaled by sc
__device__ __forceinline__ void normed(float (&x)[HD], const float* sc) {
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < HD; ++c) ss = fmaf(x[c], x[c], ss);
  const float f = rsqrtf(fmaxf(ss, 1e-24f));
#pragma unroll
  for (int c = 0; c < HD; ++c) x[c] = x[c] * f * sc[c];
}

// One (sequence, head) in f32 on the CUDA cores, a lane a query: kn
// normalised in place over Kh (a lane a key), merged's hi plane over Qh and
// its lo plane over Kh.
__device__ __forceinline__ void pair_ffma(float* Qh, float* Kh, const float* Vh, int qld,
                                          int kvld, int n, const float* qs, const float* ks,
                                          int lane) {
  float x[HD];
  if (lane < n) {
#pragma unroll
    for (int c = 0; c < HD; c += 8) load8(Kh + lane * kvld + c, x + c);
    normed(x, ks);
#pragma unroll
    for (int c = 0; c < HD; c += 8) store8(Kh + lane * kvld + c, x + c);
  }
  float q[HD];
#pragma unroll
  for (int c = 0; c < HD; c += 8) {
    if (lane < n) load8(Qh + lane * qld + c, q + c);
    else
#pragma unroll
      for (int i = 0; i < 8; ++i) q[c + i] = 0.0f;
  }
  normed(q, qs);
  __syncwarp();  // kn is in place
  float s[MAX_N], mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAX_N; ++j) {
    s[j] = 0.0f;
    if (j < n) {
#pragma unroll
      for (int c = 0; c < HD; c += 8) {
        float k[8];
        load8(Kh + j * kvld + c, k);
#pragma unroll
        for (int i = 0; i < 8; ++i) s[j] = fmaf(q[c + i], k[i], s[j]);
      }
      mx = fmaxf(mx, s[j]);
    }
  }
  float l = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_N; ++j)
    if (j < n) {
      const float p = fexp2((s[j] - mx) * LOG2E);
      l += p;
      s[j] = p;
    }
  float o[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] = 0.0f;
#pragma unroll
  for (int j = 0; j < MAX_N; ++j)
    if (j < n) {
#pragma unroll
      for (int c = 0; c < HD; c += 8) {
        float v[8];
        load8(Vh + j * kvld + c, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) o[c + i] = fmaf(s[j], v[i], o[c + i]);
      }
    }
  __syncwarp();  // every lane's scores are done with kn
  if (lane >= n) return;
#pragma unroll
  for (int c = 0; c < HD; ++c) o[c] /= l;
  float hi[HD], lo[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    uint32_t h, l32;
    split(o[c], h, l32);
    hi[c] = __uint_as_float(h);
    lo[c] = __uint_as_float(l32);
  }
#pragma unroll
  for (int c = 0; c < HD; c += 8) {
    store8(Qh + lane * qld + c, hi + c);
    store8(Kh + lane * kvld + c, lo + c);
  }
}

// ----------------------------------------------------------------- kernel
// One CTA a sequence: stage its q and kv rows, a warp a (sequence, head),
// store merged's rows.
// CTAs an SM: five in bf16 (96 registers a thread), three in f32 (a
// sequence's 74 KB of shared memory at n 24)
template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 5 : 3) qk_short_fwd(ShortArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float sc[2][HD];  // qs, ks
  const int H = a.H, n = a.n, hd = H * HD, qld = q_ld<T>(H), kvld = kv_ld<T>(H);
  T* sq = reinterpret_cast<T*>(smem_raw);
  T* skv = sq + (size_t)n * qld;
  const int s = blockIdx.x;
  const long long qo = (long long)(s / a.inner) * a.q_outer + (long long)(s % a.inner) * a.q_inner;
  const long long ko =
      (long long)(s / a.inner) * a.kv_outer + (long long)(s % a.inner) * a.kv_inner;
  stage(sq, static_cast<const T*>(a.q) + qo, a.q_tok, n, hd, qld);
  stage(skv, static_cast<const T*>(a.kv) + ko, a.kv_tok, n, 2 * hd, kvld);
  if (threadIdx.x < 2 * HD)
    sc[threadIdx.x / HD][threadIdx.x % HD] = (threadIdx.x < HD ? a.qs : a.ks)[threadIdx.x % HD];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < H; h += WARPS) {
    T* Qh = sq + h * HD;
    T* Kh = skv + h * HD;
    const T* Vh = skv + hd + h * HD;
    if constexpr (sizeof(T) == 2)
      pair_mma(Qh, Kh, Vh, qld, kvld, n, sc[0], sc[1], lane);
    else
      pair_ffma(Qh, Kh, Vh, qld, kvld, n, sc[0], sc[1], lane);
  }
  __syncthreads();
  store_rows(static_cast<T*>(a.merged) + qo, a.q_tok, sq, qld, n, hd);
  if constexpr (sizeof(T) == 4)
    store_rows(static_cast<T*>(a.merged_lo) + qo, a.q_tok, skv, kvld, n, hd);
}

bool aligned16(const void* p) { return p && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch_short(const void* q, const void* kv, void* merged, void* merged_lo,
                 const long long (&st)[8], int inner, int sequences, int heads, int n, int d,
                 const void* q_scale, const void* k_scale, void* stream) {
  // (outer, inner, head, token) element strides of q / merged and of kv; the
  // heads of a token lie side by side (head stride 32) in rows the copies
  // take whole, 16 bytes at a time
  bool ok = d == HD && n >= 1 && n <= MAX_N && heads >= 1 && sequences >= 1 && inner >= 1
            && st[2] == HD && st[6] == HD && q_scale && k_scale;
  const int idx[] = {0, 1, 3, 4, 5, 7};
  for (int i : idx) ok = ok && st[i] % pad_elems<T>() == 0;
  const void* ptrs[] = {q, kv, merged};
  for (const void* p : ptrs) ok = ok && aligned16(p);
  if (sizeof(T) == 4) ok = ok && aligned16(merged_lo);
  const size_t smem = smem_bytes<T>(heads, n);
  if (!ok || smem + 2 * HD * sizeof(float) > 227 * 1024) return (int)cudaErrorInvalidValue;
  ShortArgs a = {};
  a.q = q; a.kv = kv; a.merged = merged; a.merged_lo = merged_lo;
  a.q_outer = st[0]; a.q_inner = st[1]; a.q_tok = st[3];
  a.kv_outer = st[4]; a.kv_inner = st[5]; a.kv_tok = st[7];
  a.inner = inner; a.H = heads; a.n = n;
  a.qs = static_cast<const float*>(q_scale);
  a.ks = static_cast<const float*>(k_scale);
  cudaError_t err = cudaFuncSetAttribute(qk_short_fwd<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  qk_short_fwd<T><<<(unsigned)sequences, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K2's core, bf16: merged (like q) = softmax(qn kn^T) v per (sequence, head)
// of the projections q (rows, heads 32) and kv (rows, 2 heads 32) [k | v],
// addressed through (outer, inner, head, token) element strides as
// ct_qk_attention_tc_fwd addresses them, the head strides 32; the other
// strides multiples of 8 elements, q, kv and merged 16-byte aligned; 1 <= n
// <= 32, head dim 32; q_scale (incl. the logit scale) and k_scale (32,) f32.
CT_EXPORT int ct_qk_attention_short(const void* q, const void* kv, void* merged,
                                    long long q_outer, long long q_inner, long long q_head,
                                    long long q_tok, long long kv_outer, long long kv_inner,
                                    long long kv_head, long long kv_tok, int inner,
                                    int sequences, int heads, int n, int d, const void* q_scale,
                                    const void* k_scale, void* stream) {
  const long long st[8] = {q_outer, q_inner, q_head, q_tok, kv_outer, kv_inner, kv_head, kv_tok};
  return launch_short<bf16>(q, kv, merged, nullptr, st, inner, sequences, heads, n, d, q_scale,
                            k_scale, stream);
}

// The same in f32, nothing rounded: merged written as its TF32 hi plane
// (merged) and lo plane (merged_lo), both laid out as q; strides multiples
// of 4 elements.
CT_EXPORT int ct_qk_attention_short_f32(const void* q, const void* kv, void* merged,
                                        void* merged_lo, long long q_outer, long long q_inner,
                                        long long q_head, long long q_tok, long long kv_outer,
                                        long long kv_inner, long long kv_head, long long kv_tok,
                                        int inner, int sequences, int heads, int n, int d,
                                        const void* q_scale, const void* k_scale,
                                        void* stream) {
  const long long st[8] = {q_outer, q_inner, q_head, q_tok, kv_outer, kv_inner, kv_head, kv_tok};
  return launch_short<float>(q, kv, merged, merged_lo, st, inner, sequences, heads, n, d,
                             q_scale, k_scale, stream);
}

// ============================================================ the backward
// The f32 core of the sublayer's backward on the same short sequences
// (kernels.qk_bwd_route: f32, head dim 32, 16 <= n < 32, no bias, both
// layouts).  Replaces, there, the core of ct_clip_tpu/ops/pallas/
// small_attention.py::_pallas_small_qknorm_bwd (K10, :437, pallas_call :483,
// body _bwd_kernel :249; grid form via _bwd_grid :633, sequence-major via
// _bwd :532), which runs f32 at "highest"; qknorm_attention_bwd.cu's
// qk_attention_bwd_f32_kernel ran it before (it keeps every other f32 shape
// off the tensor cores).  From the projections q, kv = [k | v] and dO, the
// gradient of the merged heads (the dmerged product), per (sequence, head):
// qn = l2norm(q) qs (qs including the logit scale), kn = l2norm(k) ks, S = qn
// kn^T, P = softmax(S), merged = P v, dP = dO v^T, D = rowsum(P dP) (=
// rowsum(dO o merged)), dS = P (dP - D), dV = P^T dO, dqn = dS kn, dkn = dS^T
// qn, then through the l2norms (dq = rq (dqhat - qhat (qhat . dqhat)), dqhat
// = dqn qs), and the partial sums of dq_scale (sum dqn qhat) and dk_scale.
// Nothing is rounded: true f32 on the CUDA cores (FFMA), as the forward's
// f32 core.
//
// In f32 what it writes is what the 3xTF32 products after it read (ffn_tc32.cu):
// dq and dkv as TF32 hi and lo planes laid out as q and kv (the NN products
// dxn = dq wq, dx_kv = dkv wkv), and merged, dq and dkv as transposed planes
// (heads x 32 or 2 heads x 32, ldt), the sequence's tokens in columns s n ..
// s n + n - 1 (the TN products' operands: tc32_split_t writes x, xn and dO
// in the same column order); per CTA the 32 dims of dq_scale's and
// dk_scale's sums over its tokens and heads, which the caller adds in two
// levels.
//
// The bf16 form (qk_short_bwd<true>, K10 bf16: kernels.qk_bwd_route gives
// QK_SHORT for bf16 too) is _bwd_kernel's own arithmetic (small_attention.py
// :249-403): the recompute q = LN(x)_bf16 wq and kv = x_bf16 wkv and dmerged =
// dO wout come in as f32, unrounded (:278-279, :301-303), the whole (n, n)
// core runs in f32 exactly as the f32 form (:304-350), and only its outputs
// are rounded, each once: dq (:353), [dk | dv] (:354) and merged (:377) go out
// as bf16 rows laid out as q and kv, the operands of ffn_tc.cu's bf16 NN and
// TN products after it; the scale partials stay f32.
//
// What bounds it on the H100: bytes.  At the contrastive step's (8, 24, 576)
// grid (4,608 t-columns, 8 heads) it reads 0.45 GB of q, kv and dO and writes
// 1.6 GB of planes (0.61 ms at 3.35 TB/s); its n x n x 32 products are 8.2
// GFLOP (0.12 ms on the f32 CUDA cores).  The bf16 form reads the same 0.45
// GB and writes dq, dkv and merged in bf16, 0.23 GB (0.20 ms).
//
// Design: one CTA of four warps per (sequence, group of four heads), so that
// three CTAs fit an SM at n 24 and one CTA's copies run under another's
// arithmetic; a warp a (sequence, head).  The group's columns of the
// sequence's q, k, v and dO rows are staged whole by 16-byte cp.async (rows
// padded by 16 bytes).  A row pass (a lane a query) writes S, then P, and dP,
// then dS, into the warp's own n x n scratch (row stride n | 1, odd, so that
// a row's and a column's 32 lanes both hit 32 banks), and takes merged and
// dqn = ks o sum_j (dS_ij rk_j) k_j; a column pass (a lane a key) reads P and
// dS down the columns for dv and dkn: nothing recomputed, and no 32-wide
// array indexed by token in registers.  Each dot product over the 32 dims
// runs four keys at a time, four independent FMA chains.  Every output goes
// to device memory from the lane that holds it: a planes' row is 128
// contiguous bytes, a transposed plane's 32 stores a column run of the
// sequence's n tokens.  The scale sums over a warp's lanes go by a fixed
// butterfly (`lane_sums`), then over the warps in order: no atomics.

// 1 in a one-change copy for the card checks (kernels.copy_library): P
// rounded to bf16 before the merged heads' product, which the f32
// comparisons must catch
#ifndef CT_QK_SHORT_BWD_ROUND_P
#define CT_QK_SHORT_BWD_ROUND_P 0
#endif

namespace {

constexpr int HG = 4;  // heads of a CTA: one a warp

struct ShortBwdArgs {
  const float* q;
  const float* kv;
  const float* dout;                   // laid out as q
  float *dqh, *dql, *dkvh, *dkvl;      // laid out as q and kv (the bf16 form: dqh, dkvh and
                                       // mth carry its bf16 dq, dkv and merged rows)
  float *mth, *mtl, *dqth, *dqtl;      // (H 32, ldt)
  float *dkvth, *dkvtl;                // (2 H 32, ldt)
  float *dqs, *dks;                    // (sequences G, 32), G = ceil(H / HG)
  long long q_outer, q_inner, q_tok, kv_outer, kv_inner, kv_tok;
  int inner, H, n, ldt;
  const float* qs;  // (32,) q scale incl. the logit scale
  const float* ks;  // (32,) k scale
};

// floats of a staged row of one tensor (a group's heads x 32, plus 16 bytes),
// of a scratch row (odd), and the CTA's dynamic shared memory in bytes: q, k,
// v and dO rows, then each warp's P and dS
__host__ __device__ inline int bwd_ld(int H) { return (H < HG ? H : HG) * HD + 4; }
__host__ __device__ inline int bwd_lds(int n) { return n | 1; }
size_t bwd_smem_bytes(int H, int n) {
  return ((size_t)4 * n * bwd_ld(H) + (size_t)WARPS * 2 * n * bwd_lds(n)) * sizeof(float);
}
// the kernel's static shared memory, at most
constexpr size_t BWD_STATIC_SMEM = 4096;

// one step of `lane_sums`: v[0, OFF) keeps the half of v[0, 2 OFF) this
// lane's bit OFF picks, plus the partner lane's same half
template <int OFF>
__device__ __forceinline__ void halve(float (&v)[HD], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int k = 0; k < OFF; ++k) {
    const float send = upper ? v[k] : v[k + OFF];
    const float keep = upper ? v[k + OFF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// lane L returns sum over the warp's lanes of v[L], in a fixed order (a
// butterfly that halves the vector each step, every index static so v
// stays in registers); v is consumed
__device__ __forceinline__ float lane_sums(float (&v)[HD], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// 32 f32 values -> their hi and lo planes' rows at hi, lo (16-byte stores)
__device__ __forceinline__ void store_split_row(float* hi, float* lo, const float (&x)[HD]) {
#pragma unroll
  for (int c = 0; c < HD; c += 4) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) split(x[c + u], h[u], l[u]);
    *reinterpret_cast<uint4*>(hi + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// 32 f32 values -> one bf16 row of 64 bytes, each rounded once (16-byte stores)
__device__ __forceinline__ void store_bf16_row(bf16* p, const float (&x)[HD]) {
#pragma unroll
  for (int c = 0; c < HD; c += 8) {
    uint4 u;
    bf162* h = reinterpret_cast<bf162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(x[c + 2 * k], x[c + 2 * k + 1]);
    *reinterpret_cast<uint4*>(p + c) = u;
  }
}

// ... and into a transposed pair of planes: element c at hi + c ldt
__device__ __forceinline__ void store_split_col(float* hi, float* lo, int ldt,
                                                const float (&x)[HD]) {
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    uint32_t h, l;
    split(x[c], h, l);
    hi[(size_t)c * ldt] = __uint_as_float(h);
    lo[(size_t)c * ldt] = __uint_as_float(l);
  }
}

// dx of a row's l2norm times scale: x's 32 raw elements, r its inverse norm,
// dn the gradient of the normalised, scaled row; c_out = dn o xhat (the
// scale's gradient), dn becomes dx
__device__ __forceinline__ void l2norm_bwd(const float* row, float r, const float* sc,
                                           float (&dn)[HD], float (&c_out)[HD]) {
  float xh[HD], dot = 0.0f;
#pragma unroll
  for (int c = 0; c < HD; c += 8) load8(row + c, xh + c);
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    xh[c] *= r;
    c_out[c] = dn[c] * xh[c];
    dn[c] *= sc[c];
    dot = fmaf(xh[c], dn[c], dot);
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) dn[c] = r * (dn[c] - xh[c] * dot);
}

// out[j * ld] = x . rows[j * rld] (32 dims, x in registers) for j < n, four
// rows at a time, each an FMA chain over the dims in order
__device__ __forceinline__ void row_dots(const float (&x)[HD], const float* rows, int rld, int n,
                                         float* out, int ld) {
  for (int j0 = 0; j0 < n; j0 += 4) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < HD; c += 8) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u < n) {
          float r8[8];
          load8(rows + (j0 + u) * rld + c, r8);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[u] = fmaf(x[c + e], r8[e], acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u < n) out[(j0 + u) * ld] = acc[u];
  }
}

// a += w_j rows_j and b += z_j rows2_j over j < n, the weights read from the
// scratch at stride wst (P and dS down a row or a column), 32 dims each
__device__ __forceinline__ void weighted_rows(float (&a)[HD], float (&b)[HD], const float* w,
                                              const float* z, int wst, const float* za,
                                              const float* rows_a, const float* rows_b, int rld,
                                              int n) {
  for (int j = 0; j < n; ++j) {
    const float p = CT_QK_SHORT_BWD_ROUND_P ? round_bf16(w[j * wst]) : w[j * wst];
    const float y = z[j * wst] * za[j];
#pragma unroll
    for (int c = 0; c < HD; c += 8) {
      float ra[8], rb[8];
      load8(rows_a + j * rld + c, ra);
      load8(rows_b + j * rld + c, rb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        a[c + e] = fmaf(p, ra[e], a[c + e]);
        b[c + e] = fmaf(y, rb[e], b[c + e]);
      }
    }
  }
}

// One CTA per (sequence, group of HG heads), a warp a (sequence, head).
// CTAs an SM: three at n 24 (70 KB of shared memory, at most 170 registers).
// BF: the bf16 form, which writes merged, dq and dkv as bf16 rows through
// the mth, dqh and dkvh pointers (laid out as q, q and kv) and no planes.
template <bool BF>
__global__ void __launch_bounds__(NT, 3) qk_short_bwd(ShortBwdArgs a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float sc[2][HD];             // qs, ks
  __shared__ float rowv[WARPS][2][MAX_N];  // a warp's rq, rk
  __shared__ float part[2][WARPS][HD];     // the warps' scale sums
  const int H = a.H, n = a.n, hd = H * HD, ld = bwd_ld(H), lds = bwd_lds(n);
  const int groups = (H + HG - 1) / HG, s = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int h0 = grp * HG, gh = H - h0 < HG ? H - h0 : HG, width = gh * HD;
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sk = sq + (size_t)n * ld;
  float* sv = sk + (size_t)n * ld;
  float* sg = sv + (size_t)n * ld;
  const long long qo = (long long)(s / a.inner) * a.q_outer + (long long)(s % a.inner) * a.q_inner;
  const long long ko =
      (long long)(s / a.inner) * a.kv_outer + (long long)(s % a.inner) * a.kv_inner;
  stage(sq, a.q + qo + h0 * HD, a.q_tok, n, width, ld);
  stage(sk, a.kv + ko + h0 * HD, a.kv_tok, n, width, ld);
  stage(sv, a.kv + ko + hd + h0 * HD, a.kv_tok, n, width, ld);
  stage(sg, a.dout + qo + h0 * HD, a.q_tok, n, width, ld);
  if (threadIdx.x < 2 * HD)
    sc[threadIdx.x / HD][threadIdx.x % HD] = (threadIdx.x < HD ? a.qs : a.ks)[threadIdx.x % HD];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, h = h0 + warp;
  const bool live = lane < n;
  const float *qs = sc[0], *ks = sc[1];
  float* rq = rowv[warp][0];
  float* rk = rowv[warp][1];
  float* sP = sg + (size_t)n * ld + (size_t)warp * 2 * n * lds;  // P, then dS, n x lds each
  float* sD = sP + (size_t)n * lds;
  float accq = 0.0f, acck = 0.0f;  // dim `lane` of the warp's scale sums
  if (warp < gh) {
    const float* Q = sq + warp * HD;
    const float* Kr = sk + warp * HD;
    const float* V = sv + warp * HD;
    const float* G = sg + warp * HD;
    const size_t col = (size_t)s * n + lane;  // this lane's token in the transposed planes
    // the rows' inverse norms: a lane a query and a key
    {
      float ssq = 0.0f, ssk = 0.0f;
      if (live) {
#pragma unroll
        for (int c = 0; c < HD; c += 8) {
          float x[8], y[8];
          load8(Q + lane * ld + c, x);
          load8(Kr + lane * ld + c, y);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            ssq = fmaf(x[i], x[i], ssq);
            ssk = fmaf(y[i], y[i], ssk);
          }
        }
      }
      rq[lane] = rsqrtf(fmaxf(ssq, 1e-24f));
      rk[lane] = rsqrtf(fmaxf(ssk, 1e-24f));
    }
    __syncwarp();
    // ---- the row pass: lane i a query
    if (live) {
      float* Pi = sP + lane * lds;
      float* Di = sD + lane * lds;
      {
        float u[HD];  // qn o ks of the row
        const float r = rq[lane];
#pragma unroll
        for (int c = 0; c < HD; c += 8) load8(Q + lane * ld + c, u + c);
#pragma unroll
        for (int c = 0; c < HD; ++c) u[c] = u[c] * r * qs[c] * ks[c];
        row_dots(u, Kr, ld, n, Pi, 1);  // S_ij = rk_j (u . k_j) once scaled below
      }
      float mx = -INFINITY;
      for (int j = 0; j < n; ++j) {
        Pi[j] *= rk[j];
        mx = fmaxf(mx, Pi[j]);
      }
      float l = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float e = fexp2((Pi[j] - mx) * LOG2E);
        Pi[j] = e;
        l += e;
      }
      const float inv = 1.0f / l;
      for (int j = 0; j < n; ++j) Pi[j] *= inv;  // P
      {
        float g[HD];  // dO of the row
#pragma unroll
        for (int c = 0; c < HD; c += 8) load8(G + lane * ld + c, g + c);
        row_dots(g, V, ld, n, Di, 1);  // dP
      }
      float d = 0.0f;
      for (int j = 0; j < n; ++j) d = fmaf(Pi[j], Di[j], d);
      for (int j = 0; j < n; ++j) Di[j] = Pi[j] * (Di[j] - d);  // dS
    }
    {
      float m[HD], dq[HD], cq[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) m[c] = dq[c] = cq[c] = 0.0f;
      if (live) {
        weighted_rows(m, dq, sP + lane * lds, sD + lane * lds, 1, rk, V, Kr, ld, n);
        if constexpr (BF)
          store_bf16_row(reinterpret_cast<bf16*>(a.mth) + qo + lane * a.q_tok + h * HD, m);
        else
          store_split_col(a.mth + (size_t)h * HD * a.ldt + col,
                          a.mtl + (size_t)h * HD * a.ldt + col, a.ldt, m);
#pragma unroll
        for (int c = 0; c < HD; ++c) dq[c] *= ks[c];  // dqn
        l2norm_bwd(Q + lane * ld, rq[lane], qs, dq, cq);
        const long long o = qo + lane * a.q_tok + h * HD;
        if constexpr (BF) {
          store_bf16_row(reinterpret_cast<bf16*>(a.dqh) + o, dq);
        } else {
          store_split_row(a.dqh + o, a.dql + o, dq);
          store_split_col(a.dqth + (size_t)h * HD * a.ldt + col,
                          a.dqtl + (size_t)h * HD * a.ldt + col, a.ldt, dq);
        }
      }
      accq = lane_sums(cq, lane);
    }
    __syncwarp();  // every row of P and dS is in place
    // ---- the column pass: lane j a key
    {
      float dv[HD], dk[HD], ck[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) dv[c] = dk[c] = ck[c] = 0.0f;
      if (live) {
        weighted_rows(dv, dk, sP + lane, sD + lane, lds, rq, G, Q, ld, n);
#pragma unroll
        for (int c = 0; c < HD; ++c) dk[c] *= qs[c];  // dkn
        l2norm_bwd(Kr + lane * ld, rk[lane], ks, dk, ck);
        const long long o = ko + lane * a.kv_tok + h * HD;
        if constexpr (BF) {
          store_bf16_row(reinterpret_cast<bf16*>(a.dkvh) + o, dk);
          store_bf16_row(reinterpret_cast<bf16*>(a.dkvh) + o + hd, dv);
        } else {
          store_split_row(a.dkvh + o, a.dkvl + o, dk);
          store_split_row(a.dkvh + o + hd, a.dkvl + o + hd, dv);
          store_split_col(a.dkvth + (size_t)h * HD * a.ldt + col,
                          a.dkvtl + (size_t)h * HD * a.ldt + col, a.ldt, dk);
          store_split_col(a.dkvth + (size_t)(hd + h * HD) * a.ldt + col,
                          a.dkvtl + (size_t)(hd + h * HD) * a.ldt + col, a.ldt, dv);
        }
      }
      acck = lane_sums(ck, lane);
    }
  }
  part[0][warp][lane] = accq;
  part[1][warp][lane] = acck;
  __syncthreads();
  if (threadIdx.x < 2 * HD) {
    const int which = threadIdx.x / HD, c = threadIdx.x % HD;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += part[which][w][c];
    (which ? a.dks : a.dqs)[(size_t)blockIdx.x * HD + c] = v;
  }
}

// the checks and arguments of a launch of either form; false if the shape
// or the layout is refused.  elem: the outputs' element size (4 or 2), whose
// 16-byte stores need strides of 16 / elem elements.
bool short_bwd_args(ShortBwdArgs* a, const void* q, const void* kv, const void* dout,
                    const void* const* outs, int nout, int ldt, const long long (&st)[8],
                    int inner, int sequences, int heads, int n, int d, const void* q_scale,
                    const void* k_scale, void* dq_scale_part, void* dk_scale_part, int elem) {
  const long long ctas = (long long)sequences * ((heads + HG - 1) / HG);
  bool ok = d == HD && n >= 1 && n <= MAX_N && heads >= 1 && sequences >= 1 && inner >= 1
            && st[2] == HD && st[6] == HD && q_scale && k_scale && dq_scale_part
            && dk_scale_part && (long long)ldt >= (long long)sequences * n && ctas < (1ll << 31);
  const int idx[] = {0, 1, 3, 4, 5, 7};
  for (int i : idx) ok = ok && st[i] % (16 / elem) == 0;
  const void* ins[] = {q, kv, dout};
  for (const void* p : ins) ok = ok && aligned16(p);
  for (int i = 0; i < nout; ++i) ok = ok && aligned16(outs[i]);
  if (!ok || bwd_smem_bytes(heads, n) + BWD_STATIC_SMEM > 227 * 1024) return false;
  *a = ShortBwdArgs{};
  a->q = static_cast<const float*>(q);
  a->kv = static_cast<const float*>(kv);
  a->dout = static_cast<const float*>(dout);
  a->dqs = static_cast<float*>(dq_scale_part);
  a->dks = static_cast<float*>(dk_scale_part);
  a->q_outer = st[0]; a->q_inner = st[1]; a->q_tok = st[3];
  a->kv_outer = st[4]; a->kv_inner = st[5]; a->kv_tok = st[7];
  a->inner = inner; a->H = heads; a->n = n; a->ldt = ldt;
  a->qs = static_cast<const float*>(q_scale);
  a->ks = static_cast<const float*>(k_scale);
  return true;
}

template <bool BF>
int launch_short_bwd(const ShortBwdArgs& a, int sequences, void* stream) {
  const size_t smem = bwd_smem_bytes(a.H, a.n);
  cudaError_t err = cudaFuncSetAttribute(qk_short_bwd<BF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)sequences * ((a.H + HG - 1) / HG);
  qk_short_bwd<BF><<<(unsigned)ctas, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K10 f32's core (kernels.qk_attention_short_bwd): from q (rows, heads 32),
// kv (rows, 2 heads 32) [k | v] and dout (laid out as q), addressed through
// (outer, inner, head, token) element strides as ct_qk_attention_short_f32
// addresses them, the head strides 32, the other strides multiples of 4
// elements -> dq hi, lo (laid out as q), dkv hi, lo (laid out as kv), and the
// transposed planes of merged, dq (heads 32, ldt) and dkv (2 heads 32, ldt),
// sequence s's token t in column s n + t; dq_scale (before the logit scale)
// and dk_scale partials (sequences x ceil(heads / 4), 32), row s G + g the
// sums over head group g of sequence s.  16-byte aligned bases, 1 <= n <=
// 32, head dim 32, ldt >= sequences n; q_scale (incl. the logit scale) and
// k_scale (32,) f32.
CT_EXPORT int ct_qk_attention_short_bwd_f32(
    const void* q, const void* kv, const void* dout, void* dqh, void* dql, void* dkvh, void* dkvl,
    void* mth, void* mtl, void* dqth, void* dqtl, void* dkvth, void* dkvtl, int ldt,
    long long q_outer, long long q_inner, long long q_head, long long q_tok, long long kv_outer,
    long long kv_inner, long long kv_head, long long kv_tok, int inner, int sequences, int heads,
    int n, int d, const void* q_scale, const void* k_scale, void* dq_scale_part,
    void* dk_scale_part, void* stream) {
  const long long st[8] = {q_outer, q_inner, q_head, q_tok, kv_outer, kv_inner, kv_head, kv_tok};
  const void* outs[] = {dqh, dql, dkvh, dkvl, mth, mtl, dqth, dqtl, dkvth, dkvtl};
  ShortBwdArgs a;
  if (!short_bwd_args(&a, q, kv, dout, outs, 10, ldt, st, inner, sequences, heads, n, d, q_scale,
                      k_scale, dq_scale_part, dk_scale_part, 4))
    return (int)cudaErrorInvalidValue;
  a.dqh = static_cast<float*>(dqh); a.dql = static_cast<float*>(dql);
  a.dkvh = static_cast<float*>(dkvh); a.dkvl = static_cast<float*>(dkvl);
  a.mth = static_cast<float*>(mth); a.mtl = static_cast<float*>(mtl);
  a.dqth = static_cast<float*>(dqth); a.dqtl = static_cast<float*>(dqtl);
  a.dkvth = static_cast<float*>(dkvth); a.dkvtl = static_cast<float*>(dkvtl);
  return launch_short_bwd<false>(a, sequences, stream);
}

// K10 bf16's core (kernels.qk_attention_short_bwd, out_dtype bf16): the same
// f32 inputs, addressed the same way with strides multiples of 8 elements ->
// dq (laid out as q), dkv (laid out as kv) and merged (laid out as q) in bf16,
// each rounded once from the f32 core; the same f32 scale partials.
CT_EXPORT int ct_qk_attention_short_bwd(
    const void* q, const void* kv, const void* dout, void* dq, void* dkv, void* merged,
    long long q_outer, long long q_inner, long long q_head, long long q_tok, long long kv_outer,
    long long kv_inner, long long kv_head, long long kv_tok, int inner, int sequences, int heads,
    int n, int d, const void* q_scale, const void* k_scale, void* dq_scale_part,
    void* dk_scale_part, void* stream) {
  const long long st[8] = {q_outer, q_inner, q_head, q_tok, kv_outer, kv_inner, kv_head, kv_tok};
  const void* outs[] = {dq, dkv, merged};
  ShortBwdArgs a;
  if (!short_bwd_args(&a, q, kv, dout, outs, 3, sequences * n, st, inner, sequences, heads, n, d,
                      q_scale, k_scale, dq_scale_part, dk_scale_part, 2))
    return (int)cudaErrorInvalidValue;
  a.dqh = static_cast<float*>(dq);
  a.dkvh = static_cast<float*>(dkv);
  a.mth = static_cast<float*>(merged);
  return launch_short_bwd<true>(a, sequences, stream);
}
