// layernorm.cu — row LayerNorm with f32 statistics, bf16 in and out, and a
// variant that gathers each row from the raw volume in patch order.
//
// Replaces the normalisations inside these TPU kernels:
//   * ct_clip_tpu/ops/pallas/patchify.py::_pallas_patch_embed (K8): the
//     '(c pt p1 p2)' patchify shuffle fused with LN(4000) (ct_patch_layernorm)
//     and the closing LN(512) (ct_layernorm);
//   * ops/pallas/ffn.py::_pallas_ff (K3): the leading LN(512) with scale and
//     bias;
//   * ops/pallas/spatial_attention.py::_pallas_spatial (K1) and
//     ops/pallas/small_attention.py::_pallas_small_qknorm (K2): the
//     gamma-only LN that feeds the q projection;
//   * and the LN backwards inside the training kernels: K11, K9, K10 and
//     the embed backwards patchify.py::_pallas_patch_embed_bwd (K16a, the
//     LN(4000) backward read through the patch gather, ct_patch_layernorm_bwd)
//     and ::_pallas_row_embed_bwd (K16b), both with the LN(512) backward
//     whose column sum of the f32 dx is the projection bias gradient.
//
// The patch LN also runs as K16a's recompute (patch_ln_stats_kernel: each
// row's mean and rstd written beside it, 8-byte gathers), and the f32 row LN
// has a compile-time form that writes its rows split into TF32 hi and lo
// planes (LnForm; the f32 K3's 3xTF32 products); the plain forms compile to
// the code they had.
//
// f32 forms (compile-time template forms on the element type T; the bf16
// instantiations are the code as it was): f32 rows in and out for the f32
// K3 / K1 / K2 (ln_kernel), and the backward on f32 x with an f32 dx for the
// f32 K11 (ln_bwd_kernel).  The patch gather stays bf16: the JAX package
// runs K8 / K16a in f32 as XLA, and the port takes their plain versions.
//
// What bounds it on the H100: memory.  Each row is read once and written
// once (the patch gather reads 20-element runs of 40 bytes); at batch 2 the
// patch LN moves 27648 x 4000 x 2 B in and out (~0.44 GB, ~0.13 ms at
// 3.35 TB/s).  One block of 256 threads per row keeps the row in registers
// (up to 16 values a thread, so D <= 4096) and computes mean and variance in
// two passes, as ct_clip_tpu/ops/norms.py::layer_norm does.  The backward
// walks 64 rows per block and writes each block's column sums as one row of
// a partial buffer, which ct_sum_splits adds in order: no atomics.  f32 rows
// of 128-512 floats (the f32 sublayers' 512) take warp-a-row forms of the
// split LN and of the backward (ln_split_rows_kernel, ln_bwd_rows_kernel):
// the same arithmetic with warp-shuffle sums and 16-byte accesses, in place
// of four block barriers a row; bf16 rows of that width take the backward's
// warp-a-row form too (8-byte accesses of x, add2 and dx).
#include "common.cuh"
#include "tc32.cuh"

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_PER = 16;

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < LN_THREADS / 32 ? red[lane] : 0.0f;
  t = warp_sum(t);
  __syncthreads();  // red is reused by the next reduction
  return t;
}

// Output forms of ln_kernel: the normalised rows alone; or, f32 rows, as the
// TF32 hi plane in `out` and the lo plane in `aux` (tc32.cuh's split: the
// f32 K3's operand, ffn_tc32.cu).
enum LnForm { LN_PLAIN = 0, LN_SPLIT = 1 };

// GATHER: row `row` of the patch rows of the video x; else x[row*D + e].
template <typename T, bool GATHER, int FORM = LN_PLAIN>
__global__ void __launch_bounds__(LN_THREADS)
ln_kernel(const T* __restrict__ x, int D, const float* __restrict__ scale,
          const float* __restrict__ bias, float eps, T* __restrict__ out, PatchGeom g,
          float* __restrict__ aux) {
  __shared__ float red[LN_THREADS / 32];
  const size_t row = blockIdx.x;
  float vals[LN_PER];
  const size_t base = row * (size_t)D;
  const size_t src = GATHER ? patch_row_base(g, row) : base;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_PER; ++i) {
    const int e = threadIdx.x + i * LN_THREADS;
    float v = 0.0f;
    if (e < D) v = to_f(x[src + (GATHER ? patch_elem_offset(g, e) : e)]);
    vals[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / D;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_PER; ++i) {
    const int e = threadIdx.x + i * LN_THREADS;
    if (e < D) {
      const float c = vals[i] - mean;
      q += c * c;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / D + eps);
#pragma unroll
  for (int i = 0; i < LN_PER; ++i) {
    const int e = threadIdx.x + i * LN_THREADS;
    if (e < D) {
      float y = (vals[i] - mean) * rstd;
      if (scale) y *= scale[e];
      if (bias) y += bias[e];
      if (FORM == LN_SPLIT) {
        uint32_t hi, lo;
        split(y, hi, lo);
        out[base + e] = from_f<T>(__uint_as_float(hi));
        aux[base + e] = __uint_as_float(lo);
      } else {
        out[base + e] = from_f<T>(y);
      }
    }
  }
}

// The patch LN of K16a's recompute: ln_kernel<bf16, true>'s rows, and each
// row's mean and rstd as (rows, 2) f32 in `stats`, from which ffn_tc.cu's
// epilogue rebuilds xhat.  A thread takes runs of 4 elements, each one
// 8-byte load and one 8-byte store (p % 4 == 0 and W % 4 == 0: a run never
// leaves a p-wide row of its patch), where ln_kernel loads 2 bytes at a
// time: the 20-element rows of a 20-wide patch are 5 such loads.
__global__ void __launch_bounds__(LN_THREADS)
patch_ln_stats_kernel(const bf16* __restrict__ x, int D, const float* __restrict__ scale,
                      const float* __restrict__ bias, float eps, bf16* __restrict__ out,
                      PatchGeom g, float* __restrict__ stats) {
  constexpr int RUNS = LN_PER / 4;
  __shared__ float red[LN_THREADS / 32];
  const size_t row = blockIdx.x;
  const size_t base = row * (size_t)D, src = patch_row_base(g, row);
  float vals[LN_PER];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    const int e = 4 * (threadIdx.x + i * LN_THREADS);
    uint2 v = make_uint2(0u, 0u);
    if (e < D) v = *reinterpret_cast<const uint2*>(x + src + patch_elem_offset(g, e));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v.y));
    vals[4 * i] = lo.x;
    vals[4 * i + 1] = lo.y;
    vals[4 * i + 2] = hi.x;
    vals[4 * i + 3] = hi.y;
    s += (lo.x + lo.y) + (hi.x + hi.y);
  }
  const float mean = block_sum(s, red) / D;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    if (4 * (threadIdx.x + i * LN_THREADS) < D) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float c = vals[4 * i + u] - mean;
        q += c * c;
      }
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / D + eps);
  if (threadIdx.x == 0) *reinterpret_cast<float2*>(stats + 2 * row) = make_float2(mean, rstd);
#pragma unroll
  for (int i = 0; i < RUNS; ++i) {
    const int e = 4 * (threadIdx.x + i * LN_THREADS);
    if (e >= D) continue;
    float y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      y[u] = (vals[4 * i + u] - mean) * rstd * (scale ? scale[e + u] : 1.0f)
             + (bias ? bias[e + u] : 0.0f);
    bf162 a = __floats2bfloat162_rn(y[0], y[1]), b = __floats2bfloat162_rn(y[2], y[3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&a);
    w.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(out + base + e) = w;
  }
}

// LayerNorm backward of `rows_per_block` consecutive rows per block, as
// ffn.py::_bwd_kernel (:182-188) and spatial_attention.py::_bwd_kernel
// (:220-226) compute it in f32: recompute xhat from x, then
//   dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) + add + add2,
// dxhat = dxn * scale, and this block's column sums of dxn * xhat (dscale),
// of dxn (dbias) and of the f32 dx (part_dxs) into row `blockIdx.x` of the
// partial buffers, which ct_sum_splits adds in block order.  dx, part_db and
// part_dxs may be null.
//
// GATHER reads x through the patch gather of the video (K16a's LN(4000)
// backward, patchify.py::_embed_bwd_kernel :278-308): xhat is recomputed
// from the volume, so no patch tensor is stored, and dx, when asked for,
// is written as contiguous patch rows for K17.
template <typename T, bool GATHER>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const T* __restrict__ x, int rows, int D, const float* __restrict__ scale,
              const float* __restrict__ dxn, const float* __restrict__ add,
              const T* __restrict__ add2, float eps, T* __restrict__ dx,
              float* __restrict__ part_ds, float* __restrict__ part_db,
              float* __restrict__ part_dxs, int rows_per_block, PatchGeom pg) {
  __shared__ float red[LN_THREADS / 32];
  float ds[LN_PER], db[LN_PER], dxs[LN_PER], sc[LN_PER];
  int off[LN_PER];
#pragma unroll
  for (int i = 0; i < LN_PER; ++i) {
    const int e = threadIdx.x + i * LN_THREADS;
    ds[i] = db[i] = dxs[i] = 0.0f;
    sc[i] = (e < D && scale) ? scale[e] : 1.0f;
    off[i] = (GATHER && e < D) ? patch_elem_offset(pg, e) : e;
  }
  const int r0 = blockIdx.x * rows_per_block, r1 = min(rows, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * D;
    const size_t src = GATHER ? patch_row_base(pg, row) : base;
    float xv[LN_PER], g[LN_PER];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < LN_PER; ++i) {
      const int e = threadIdx.x + i * LN_THREADS;
      xv[i] = e < D ? to_f(x[src + off[i]]) : 0.0f;
      g[i] = e < D ? dxn[base + e] : 0.0f;
      s += xv[i];
    }
    const float mean = block_sum(s, red) / D;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < LN_PER; ++i) {
      const int e = threadIdx.x + i * LN_THREADS;
      if (e < D) {
        const float c = xv[i] - mean;
        q += c * c;
      }
    }
    const float rstd = rsqrtf(block_sum(q, red) / D + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < LN_PER; ++i) {
      const int e = threadIdx.x + i * LN_THREADS;
      if (e < D) {
        xv[i] = (xv[i] - mean) * rstd;  // xhat
        const float dh = g[i] * sc[i];
        s1 += dh;
        s2 += dh * xv[i];
        ds[i] += g[i] * xv[i];
        db[i] += g[i];
      }
    }
    const float m1 = block_sum(s1, red) / D, m2 = block_sum(s2, red) / D;
#pragma unroll
    for (int i = 0; i < LN_PER; ++i) {
      const int e = threadIdx.x + i * LN_THREADS;
      if (e < D) {
        float v = rstd * (g[i] * sc[i] - m1 - xv[i] * m2);
        if (add) v += add[base + e];
        if (add2) v += to_f(add2[base + e]);
        dxs[i] += v;
        if (dx) dx[base + e] = from_f<T>(v);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < LN_PER; ++i) {
    const int e = threadIdx.x + i * LN_THREADS;
    if (e < D) {
      part_ds[(size_t)blockIdx.x * D + e] = ds[i];
      if (part_db) part_db[(size_t)blockIdx.x * D + e] = db[i];
      if (part_dxs) part_dxs[(size_t)blockIdx.x * D + e] = dxs[i];
    }
  }
}

// ---------------------------------------------- f32 rows, a warp a row
// The f32 forms on rows of D = 128 PER floats (PER <= 4: the f32 sublayers'
// 512): a warp takes a row, each lane PER float4 chunks (element j 128 +
// 4 lane + u), so the row's sums are warp shuffles with no block barrier,
// and eight warps of a block walk its rows in turn.  The block-per-row
// kernels above spend most of their time in four barriers a row (the f32 LN
// backward at 110,592 x 512 ran at ~22% of its bytes' bound); these read
// and write 16 bytes a lane.  Same arithmetic as ln_kernel / ln_bwd_kernel;
// the backward's column sums go per warp over its rows, then over the warps
// in order, into the block's partial row.
constexpr int ROW_WARPS = LN_THREADS / 32;

template <int PER>
__device__ __forceinline__ void load_row(const float* p, int lane, float (&v)[4 * PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const float4 f = *reinterpret_cast<const float4*>(p + j * 128 + 4 * lane);
    v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
  }
}
template <int PER>
__device__ __forceinline__ void store_row(float* p, int lane, const float (&v)[4 * PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j)
    *reinterpret_cast<float4*>(p + j * 128 + 4 * lane) =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}
// ... bf16 rows in the same element order: 8 bytes a lane and chunk
template <int PER>
__device__ __forceinline__ void load_row(const bf16* p, int lane, float (&v)[4 * PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + j * 128 + 4 * lane);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const bf162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const bf162*>(&u.y));
    v[4 * j] = a.x; v[4 * j + 1] = a.y; v[4 * j + 2] = b.x; v[4 * j + 3] = b.y;
  }
}
template <int PER>
__device__ __forceinline__ void store_row(bf16* p, int lane, const float (&v)[4 * PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    uint2 u;
    *reinterpret_cast<bf162*>(&u.x) = __floats2bfloat162_rn(v[4 * j], v[4 * j + 1]);
    *reinterpret_cast<bf162*>(&u.y) = __floats2bfloat162_rn(v[4 * j + 2], v[4 * j + 3]);
    *reinterpret_cast<uint2*>(p + j * 128 + 4 * lane) = u;
  }
}

// mean and rstd of a row held as v, over D elements (two passes, as ln_kernel)
template <int PER>
__device__ __forceinline__ void row_stats(const float (&v)[4 * PER], int D, float eps,
                                          float& mean, float& rstd) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4 * PER; ++i) s += v[i];
  mean = warp_sum(s) / D;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < 4 * PER; ++i) {
    const float c = v[i] - mean;
    q += c * c;
  }
  rstd = rsqrtf(warp_sum(q) / D + eps);
}

// ct_layernorm_split_f32 on such rows: the normalised row as TF32 hi and lo
template <int PER>
__global__ void __launch_bounds__(LN_THREADS)
ln_split_rows_kernel(const float* __restrict__ x, int rows, int D,
                     const float* __restrict__ scale, const float* __restrict__ bias, float eps,
                     float* __restrict__ hi, float* __restrict__ lo) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= (size_t)rows) return;
  float v[4 * PER];
  load_row<PER>(x + row * D, lane, v);
  float mean, rstd;
  row_stats<PER>(v, D, eps, mean, rstd);
  float h[4 * PER], l[4 * PER];
#pragma unroll
  for (int i = 0; i < 4 * PER; ++i) {
    const int e = (i >> 2) * 128 + 4 * lane + (i & 3);
    float y = (v[i] - mean) * rstd;
    if (scale) y *= scale[e];
    if (bias) y += bias[e];
    uint32_t uh, ul;
    split(y, uh, ul);
    h[i] = __uint_as_float(uh);
    l[i] = __uint_as_float(ul);
  }
  store_row<PER>(hi + row * D, lane, h);
  store_row<PER>(lo + row * D, lane, l);
}

// out[e] = the sum over the block's warps, in order, of each warp's v at
// column e (every thread of the block calls it)
template <int PER>
__device__ __forceinline__ void block_col_sums(const float (&v)[4 * PER],
                                               float (*red)[4 * PER * 32], float* out, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4 * PER; ++i) red[warp][(i >> 2) * 128 + 4 * lane + (i & 3)] = v[i];
  __syncthreads();
  for (int e = threadIdx.x; e < D; e += LN_THREADS) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) t += red[w][e];
    out[e] = t;
  }
  __syncthreads();
}

// ct_layernorm_bwd_f32 and ct_layernorm_bwd on such rows (ln_bwd_kernel's
// arithmetic): T float, or bf16 x, add2 and dx (dxn and add f32 in both)
template <typename T, int PER>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_rows_kernel(const T* __restrict__ x, int rows, int D, const float* __restrict__ scale,
                   const float* __restrict__ dxn, const float* __restrict__ add,
                   const T* __restrict__ add2, float eps, T* __restrict__ dx,
                   float* __restrict__ part_ds, float* __restrict__ part_db,
                   float* __restrict__ part_dxs, int rows_per_block) {
  __shared__ float red[ROW_WARPS][4 * PER * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sc[4 * PER], ds[4 * PER], db[4 * PER], dxs[4 * PER];
#pragma unroll
  for (int i = 0; i < 4 * PER; ++i) {
    sc[i] = scale ? scale[(i >> 2) * 128 + 4 * lane + (i & 3)] : 1.0f;
    ds[i] = db[i] = dxs[i] = 0.0f;
  }
  const int r0 = blockIdx.x * rows_per_block, r1 = min(rows, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += ROW_WARPS) {
    const size_t base = (size_t)row * D;
    float xv[4 * PER], g[4 * PER];
    load_row<PER>(x + base, lane, xv);
    load_row<PER>(dxn + base, lane, g);
    float mean, rstd;
    row_stats<PER>(xv, D, eps, mean, rstd);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4 * PER; ++i) {
      xv[i] = (xv[i] - mean) * rstd;  // xhat
      const float dh = g[i] * sc[i];
      s1 += dh;
      s2 += dh * xv[i];
      ds[i] += g[i] * xv[i];
      db[i] += g[i];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    float a[4 * PER], b[4 * PER];
    if (add) load_row<PER>(add + base, lane, a);
    if (add2) load_row<PER>(add2 + base, lane, b);
#pragma unroll
    for (int i = 0; i < 4 * PER; ++i) {
      float v = rstd * (g[i] * sc[i] - m1 - xv[i] * m2);
      if (add) v += a[i];
      if (add2) v += b[i];
      dxs[i] += v;
      g[i] = v;
    }
    if (dx) store_row<PER>(dx + base, lane, g);
  }
  // the block's column sums: each warp's, then over the warps in order
  if (part_ds) block_col_sums<PER>(ds, red, part_ds + (size_t)blockIdx.x * D, D);
  if (part_db) block_col_sums<PER>(db, red, part_db + (size_t)blockIdx.x * D, D);
  if (part_dxs) block_col_sums<PER>(dxs, red, part_dxs + (size_t)blockIdx.x * D, D);
}

// the warp-a-row forms take f32 rows of D = 128 PER, PER <= 4, on 16-byte
// boundaries; 0 when they do not
int row_per(int D, const void* const* ptrs, int n) {
  if (D % 128 || D > 512) return 0;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] && (reinterpret_cast<uintptr_t>(ptrs[i]) & 15)) return 0;
  return D / 128;
}

// launches the warp-a-row backward where the rows take it (`row_per`);
// false where they do not
template <typename T>
bool launch_ln_bwd_rows(const void* x, int rows, int D, const void* scale, const void* dxn,
                        const void* add, const void* add2, float eps, void* dx, void* part_ds,
                        void* part_db, void* part_dxs, int rows_per_block, void* stream) {
  const void* ptrs[] = {x, dxn, add, add2, dx};
  const int per = row_per(D, ptrs, 5);
  if (!per || rows_per_block < 1) return false;
  const unsigned blocks = (rows + rows_per_block - 1) / rows_per_block;
  auto kernel = per == 1 ? ln_bwd_rows_kernel<T, 1>
              : per == 2 ? ln_bwd_rows_kernel<T, 2>
              : per == 3 ? ln_bwd_rows_kernel<T, 3> : ln_bwd_rows_kernel<T, 4>;
  kernel<<<blocks, LN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), rows, D, static_cast<const float*>(scale),
      static_cast<const float*>(dxn), static_cast<const float*>(add),
      static_cast<const T*>(add2), eps, static_cast<T*>(dx), static_cast<float*>(part_ds),
      static_cast<float*>(part_db), static_cast<float*>(part_dxs), rows_per_block);
  return true;
}

template <typename T>
int launch_ln_bwd(bool gather, const void* x, int rows, int D, const void* scale,
                  const void* dxn, const void* add, const void* add2, float eps, void* dx,
                  void* part_ds, void* part_db, void* part_dxs, int rows_per_block,
                  const PatchGeom& g, void* stream) {
  if (D > LN_THREADS * LN_PER || rows_per_block < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  auto kernel = gather ? ln_bwd_kernel<T, true> : ln_bwd_kernel<T, false>;
  kernel<<<blocks, LN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), rows, D, static_cast<const float*>(scale),
      static_cast<const float*>(dxn), static_cast<const float*>(add),
      static_cast<const T*>(add2), eps, static_cast<T*>(dx),
      static_cast<float*>(part_ds), static_cast<float*>(part_db),
      static_cast<float*>(part_dxs), rows_per_block, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, D) bf16, dxn (rows, D) f32 -> dx (rows, D) bf16 and the partial
// column sums (ceil(rows / rows_per_block), D) f32 of dxn * xhat, of dxn and
// of the f32 dx (dx, part_db and part_dxs may be null).  scale (D,) f32 or
// null; add (rows, D) f32 and add2 (rows, D) bf16 are added to dx when not
// null.  Rows of D = 128, 256, 384 or 512 take the warp-a-row form
// (ln_bwd_rows_kernel<bf16>: every model of the repo), other widths
// ln_bwd_kernel<bf16>.
CT_EXPORT int ct_layernorm_bwd(const void* x, int rows, int D, const void* scale,
                               const void* dxn, const void* add, const void* add2, float eps,
                               void* dx, void* part_ds, void* part_db, void* part_dxs,
                               int rows_per_block, void* stream) {
  if (launch_ln_bwd_rows<bf16>(x, rows, D, scale, dxn, add, add2, eps, dx, part_ds, part_db,
                               part_dxs, rows_per_block, stream))
    return (int)cudaGetLastError();
  const PatchGeom g = {0, 0, 0, 0, 0, 0, 0, 0};
  return launch_ln_bwd<bf16>(false, x, rows, D, scale, dxn, add, add2, eps, dx, part_ds,
                             part_db, part_dxs, rows_per_block, g, stream);
}

// The f32 form of ct_layernorm_bwd: x, add2 and dx f32 (dx unrounded).
// Rows of D = 128, 256, 384 or 512 take the warp-a-row form
// (ln_bwd_rows_kernel), other widths ln_bwd_kernel<float>.
CT_EXPORT int ct_layernorm_bwd_f32(const void* x, int rows, int D, const void* scale,
                                   const void* dxn, const void* add, const void* add2,
                                   float eps, void* dx, void* part_ds, void* part_db,
                                   void* part_dxs, int rows_per_block, void* stream) {
  if (launch_ln_bwd_rows<float>(x, rows, D, scale, dxn, add, add2, eps, dx, part_ds, part_db,
                                part_dxs, rows_per_block, stream))
    return (int)cudaGetLastError();
  const PatchGeom g = {0, 0, 0, 0, 0, 0, 0, 0};
  return launch_ln_bwd<float>(false, x, rows, D, scale, dxn, add, add2, eps, dx, part_ds,
                              part_db, part_dxs, rows_per_block, g, stream);
}

// The LN(pt*p*p) backward over the patch rows of the video (B, F, H, W) bf16,
// read through the patch gather: dxn (B*t*h*w, pt*p*p) f32 -> dx as patch
// rows bf16 (or null) and the partial column sums of dxn * xhat and of dxn.
CT_EXPORT int ct_patch_layernorm_bwd(const void* video, int B, int F, int H, int W, int pt,
                                     int p, const void* scale, const void* dxn, float eps,
                                     void* dx, void* part_ds, void* part_db,
                                     int rows_per_block, void* stream) {
  if (pt <= 0 || p <= 0 || F % pt || H % p || W % p) return (int)cudaErrorInvalidValue;
  const PatchGeom g = {F, H, W, pt, p, F / pt, H / p, W / p};
  return launch_ln_bwd<bf16>(true, video, B * g.t * g.h * g.w, pt * p * p, scale, dxn,
                             nullptr, nullptr, eps, dx, part_ds, part_db, nullptr,
                             rows_per_block, g, stream);
}

namespace {

template <typename T>
int layernorm(const void* x, int rows, int D, const void* scale, const void* bias, float eps,
              void* out, void* stream) {
  if (D > LN_THREADS * LN_PER) return (int)cudaErrorInvalidValue;
  PatchGeom g = {0, 0, 0, 0, 0, 0, 0, 0};
  ln_kernel<T, false><<<rows, LN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), D, static_cast<const float*>(scale),
      static_cast<const float*>(bias), eps, static_cast<T*>(out), g, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, D) bf16 -> out (rows, D) bf16; scale/bias f32 (D,) or null.
CT_EXPORT int ct_layernorm(const void* x, int rows, int D, const void* scale, const void* bias,
                           float eps, void* out, void* stream) {
  return layernorm<bf16>(x, rows, D, scale, bias, eps, out, stream);
}

// The f32 form split for 3xTF32 (tc32.cuh): x f32 -> the normalised rows'
// TF32 hi plane `hi` and lo plane `lo`, (rows, D) f32 each.
// Rows of D = 128, 256, 384 or 512 take the warp-a-row form
// (ln_split_rows_kernel), other widths ln_kernel's LN_SPLIT form.
CT_EXPORT int ct_layernorm_split_f32(const void* x, int rows, int D, const void* scale,
                                     const void* bias, float eps, void* hi, void* lo,
                                     void* stream) {
  if (D > LN_THREADS * LN_PER) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, hi, lo};
  const int per = row_per(D, ptrs, 3);
  if (per) {
    const unsigned blocks = (rows + ROW_WARPS - 1) / ROW_WARPS;
    auto kernel = per == 1 ? ln_split_rows_kernel<1>
                : per == 2 ? ln_split_rows_kernel<2>
                : per == 3 ? ln_split_rows_kernel<3> : ln_split_rows_kernel<4>;
    kernel<<<blocks, LN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), rows, D, static_cast<const float*>(scale),
        static_cast<const float*>(bias), eps, static_cast<float*>(hi), static_cast<float*>(lo));
    return (int)cudaGetLastError();
  }
  const PatchGeom g = {0, 0, 0, 0, 0, 0, 0, 0};
  ln_kernel<float, false, LN_SPLIT><<<rows, LN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), D, static_cast<const float*>(scale),
      static_cast<const float*>(bias), eps, static_cast<float*>(hi), g, static_cast<float*>(lo));
  return (int)cudaGetLastError();
}

// The f32 form: x and out f32.
CT_EXPORT int ct_layernorm_f32(const void* x, int rows, int D, const void* scale,
                               const void* bias, float eps, void* out, void* stream) {
  return layernorm<float>(x, rows, D, scale, bias, eps, out, stream);
}

// video (B, F, H, W) bf16 -> out (B*t*h*w, pt*p*p) bf16, LN over each patch;
// with `stats` (not null), each row's mean and rstd as (rows, 2) f32 too
// (patch_ln_stats_kernel: p and W multiples of 4, video and out 8-byte
// aligned).
CT_EXPORT int ct_patch_layernorm(const void* video, int B, int F, int H, int W, int pt, int p,
                                 const void* scale, const void* bias, float eps, void* out,
                                 void* stats, void* stream) {
  const int D = pt * p * p;
  if (D > LN_THREADS * LN_PER) return (int)cudaErrorInvalidValue;
  PatchGeom g = {F, H, W, pt, p, F / pt, H / p, W / p};
  const int rows = B * g.t * g.h * g.w;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats) {
    if (p % 4 || W % 4 || (reinterpret_cast<uintptr_t>(video) & 7)
        || (reinterpret_cast<uintptr_t>(out) & 7) || (reinterpret_cast<uintptr_t>(stats) & 7))
      return (int)cudaErrorInvalidValue;
    patch_ln_stats_kernel<<<rows, LN_THREADS, 0, st>>>(
        static_cast<const bf16*>(video), D, static_cast<const float*>(scale),
        static_cast<const float*>(bias), eps, static_cast<bf16*>(out), g,
        static_cast<float*>(stats));
  } else {
    ln_kernel<bf16, true><<<rows, LN_THREADS, 0, st>>>(
        static_cast<const bf16*>(video), D, static_cast<const float*>(scale),
        static_cast<const float*>(bias), eps, static_cast<bf16*>(out), g, nullptr);
  }
  return (int)cudaGetLastError();
}

CT_EXPORT const char* ct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
