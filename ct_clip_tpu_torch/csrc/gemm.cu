// gemm.cu — tiled bf16 matrix product with fp32 accumulation on the tensor
// cores (WMMA 16x16x16), C[m, n] = sum_k A[m, k] * W[n, k].
//
// W is in nn.Linear layout (out_features, in_features), row-major, so every
// projection weight and the VQ codebook (codes, dim) are passed as they are.
//
// Replaces the matrix products inside these TPU kernels:
//   * ct_clip_tpu/ops/pallas/spatial_attention.py::_pallas_spatial (K1) and
//     ops/pallas/small_attention.py::_pallas_small_qknorm (K2): the q, kv and
//     out projections (EPI_STORE, EPI_RESIDUAL);
//   * ops/pallas/ffn.py::_pallas_ff (K3): x*Wa and x*Wg with the GEGLU
//     epilogue (EPI_GEGLU), then act*Wo + x (EPI_RESIDUAL);
//   * ops/pallas/patchify.py::_pallas_patch_embed (K8): the 4000x512
//     projection with the rounded bias add (EPI_BIAS_ROUNDED);
//   * ops/pallas/vq.py::pallas_assign (K5): similarity against all 8192
//     codes with a running row argmax (gemm_argmax_kernel), and its exact
//     training mode against the hi + lo bf16 codebook (gemm_argmax2_kernel);
//   * the products inside the backwards ops/pallas/ffn.py::_pallas_ff_bwd
//     (K11: the recomputed a and g with dact = do wo and the GEGLU
//     derivative in one tile, ff_bwd_kernel), spatial_attention.py::
//     _pallas_spatial_bwd (K9) and small_attention.py::
//     _pallas_small_qknorm_bwd (K10): dX = dY W ("NN") and the weight
//     gradients dW = dY^T X over all rows ("TN", f32, split over row blocks
//     and summed in a fixed order), gemm_layout_kernel.
//
// What bounds it on the H100: at the full-width shapes these products are
// compute-bound (the K3 input product is 27648 x 512 x 2730 at batch 2,
// ~77 GFLOP against ~57 MB of operands).  This first version keeps the
// structure simple: 64x64x32 block tiles staged through shared memory with
// plain loads (no cp.async/TMA pipeline, no wgmma), four warps of 32x32
// WMMA tiles each.  It reaches a fraction of the 989 TFLOP/s bf16 peak;
// a TMA + wgmma pipeline is later work.  Ragged edges (inner = 1365) are
// zero-filled on load and masked on store, so any M, N, K is taken.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;   // shared row stride (bf16), multiple of 8
constexpr int LDC = BN + 4;   // shared row stride (f32), multiple of 4
constexpr int THREADS = 128;  // four warps, 2x2 over the 64x64 tile

enum Epilogue { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_BIAS_ROUNDED = 2, EPI_GEGLU = 3 };

// Copy a 64-row x 32-k tile of a row-major (rows, K) matrix into shared
// memory, zero-filling outside the matrix.  VEC: 16-byte loads, valid when
// K, ld and the base pointer are multiples of 8 elements.
template <bool VEC>
__device__ __forceinline__ void load_tile(bf16* __restrict__ s, const bf16* __restrict__ g,
                                          int ld, int row0, int rows, int k0, int K) {
  if (VEC) {
    for (int c = threadIdx.x; c < 64 * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const int gr = row0 + r, gk = k0 + kc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rows && gk < K)
        v = *reinterpret_cast<const uint4*>(g + (size_t)gr * ld + gk);
      *reinterpret_cast<uint4*>(s + r * LDS + kc) = v;
    }
  } else {
    for (int c = threadIdx.x; c < 64 * BK; c += THREADS) {
      const int r = c / BK, kk = c % BK;
      const int gr = row0 + r, gk = k0 + kk;
      bf16 v = __ushort_as_bfloat16((unsigned short)0);
      if (gr < rows && gk < K) v = g[(size_t)gr * ld + gk];
      s[r * LDS + kk] = v;
    }
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;

// Accumulate one (BM x BN) tile over all of K for NB weight matrices that
// share the A operand.  As/Bs: shared tiles; acc[nb][i][j]: the warp's 2x2.
template <int NB, bool VEC>
__device__ __forceinline__ void mainloop(Acc (&acc)[NB][2][2], bf16* As, bf16* Bs,
                                         const bf16* A, int lda, const bf16* const* Ws,
                                         int ldw, int m0, int n0, int M, int N, int K) {
  const int warp = threadIdx.x / 32;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[nb][i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<VEC>(As, A, lda, m0, M, k0, K);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) load_tile<VEC>(Bs + nb * BN * LDS, Ws[nb], ldw, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], As + (wr + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB b;
          wmma::load_matrix_sync(b, Bs + nb * BN * LDS + (wc + j * 16) * LDS + kk, LDS);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[nb][i][j], a[i], b, acc[nb][i][j]);
        }
    }
    __syncthreads();
  }
}

template <int NB>
__device__ __forceinline__ void stage_acc(float* Cs, Acc (&acc)[NB][2][2]) {
  const int warp = threadIdx.x / 32;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + nb * BM * LDC + (wr + i * 16) * LDC + wc + j * 16,
                                acc[nb][i][j], LDC, wmma::mem_row_major);
}

constexpr int TILE_BYTES = (BM * LDS + 2 * BN * LDS) * 2;
constexpr int STAGE_BYTES = 2 * BM * LDC * 4;
constexpr int GEMM_SMEM = TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES;

template <int EPI, bool VEC>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ W,
            const bf16* __restrict__ W2, int ldw, int M, int N, int K,
            bf16* __restrict__ C, int ldc, const bf16* __restrict__ R, int ldr,
            const bf16* __restrict__ bias) {
  constexpr int NB = EPI == EPI_GEGLU ? 2 : 1;
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the main loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* Ws[2] = {W, W2};
  Acc acc[NB][2][2];
  mainloop<NB, VEC>(acc, As, Bs, A, lda, Ws, ldw, m0, n0, M, N, K);
  stage_acc<NB>(Cs, acc);
  __syncthreads();

  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float v = Cs[r * LDC + c];
    float out;
    if (EPI == EPI_STORE) {
      out = v;
    } else if (EPI == EPI_RESIDUAL) {  // one f32 add, one rounding
      out = v + bf2f(R[(size_t)gm * ldr + gn]);
    } else if (EPI == EPI_BIAS_ROUNDED) {  // bf16(acc) + bias in bf16
      out = round_bf16(v) + bf2f(bias[gn]);
    } else {  // GEGLU: value * gelu_erf(gate), exact erf
      const float g = Cs[BM * LDC + r * LDC + c];
      out = v * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
    }
    C[(size_t)gm * ldc + gn] = f2bf(out);
  }
}

// Row argmax of A * W^T over all N columns.  One block owns 64 rows and
// walks every 64-column chunk of W, so no reduction crosses blocks.  Two
// threads share a row (32 columns each of every chunk); ties resolve to the
// lowest column, as torch.argmax and jnp.argmax do.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gemm_argmax_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ W, int ldw,
                   int M, int N, int K, int* __restrict__ ids) {
  __shared__ __align__(128) unsigned char smem[(BM * LDS + BN * LDS) * 2 + BM * LDC * 4];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem + (BM * LDS + BN * LDS) * 2);

  const int m0 = blockIdx.x * BM;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float best = -INFINITY;
  int best_i = 0;
  const bf16* Ws[1] = {W};
  for (int n0 = 0; n0 < N; n0 += BN) {
    Acc acc[1][2][2];
    mainloop<1, VEC>(acc, As, Bs, A, lda, Ws, ldw, m0, n0, M, N, K);
    stage_acc<1>(Cs, acc);
    __syncthreads();
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const int gn = n0 + c;
      const float v = Cs[r * LDC + c];
      if (gn < N && v > best) {
        best = v;
        best_i = gn;
      }
    }
    __syncthreads();
  }
  const float ov = __shfl_xor_sync(0xffffffffu, best, 1);
  const int oi = __shfl_xor_sync(0xffffffffu, best_i, 1);
  if (ov > best || (ov == best && oi < best_i)) {
    best = ov;
    best_i = oi;
  }
  if (half == 0 && m0 + r < M) ids[m0 + r] = best_i;
}

// Exact-mode assignment (K5 in training): similarities against a codebook
// split into bf16 hi and lo parts, x.c_hi + x.c_lo, each product summed in
// f32 and the two added, as vq.py::_assign_kernel (raw_bf16, exact) does.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gemm_argmax2_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ W,
                    const bf16* __restrict__ W2, int ldw, int M, int N, int K,
                    int* __restrict__ ids) {
  __shared__ __align__(128) unsigned char smem[(BM * LDS + 2 * BN * LDS) * 2 + BM * LDC * 4];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem + (BM * LDS + 2 * BN * LDS) * 2);

  const int m0 = blockIdx.x * BM;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float best = -INFINITY;
  int best_i = 0;
  const bf16* Ws[2] = {W, W2};
  for (int n0 = 0; n0 < N; n0 += BN) {
    Acc acc[2][2][2];
    mainloop<2, VEC>(acc, As, Bs, A, lda, Ws, ldw, m0, n0, M, N, K);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < acc[0][i][j].num_elements; ++t) acc[0][i][j].x[t] += acc[1][i][j].x[t];
    stage_acc<1>(Cs, *reinterpret_cast<Acc(*)[1][2][2]>(&acc[0]));
    __syncthreads();
    for (int c = half * 32; c < half * 32 + 32; ++c) {
      const int gn = n0 + c;
      const float v = Cs[r * LDC + c];
      if (gn < N && v > best) {
        best = v;
        best_i = gn;
      }
    }
    __syncthreads();
  }
  const float ov = __shfl_xor_sync(0xffffffffu, best, 1);
  const int oi = __shfl_xor_sync(0xffffffffu, best_i, 1);
  if (ov > best || (ov == best && oi < best_i)) {
    best = ov;
    best_i = oi;
  }
  if (half == 0 && m0 + r < M) ids[m0 + r] = best_i;
}

// ------------------------------------------------ the backwards' layouts
// C[m, n] = sum_k A(m, k) B(k, n) with
//   A(m, k) = A[m * lda + k] (TA false: row-major (M, K)) or A[k * lda + m]
//             (TA true: a row-major (K, M) matrix read transposed);
//   B(k, n) = B[n * ldb + k] (TB false: nn.Linear layout (N, K)) or
//             B[k * ldb + n] (TB true: row-major (K, N)).
// The backwards use two: dX = dY W (TA false, TB true: "NN", W in nn.Linear
// layout is (K, N) row-major) and dW = dY^T X summed over all rows (TA and
// TB true: "TN").  K may be split over blockIdx.z in chunks of kchunk rows;
// split z writes f32 partial sums to C + z * split_stride, and ct_sum_splits
// adds the splits in order, so the result does not change from run to run.
constexpr int LDT = BN + 8;  // shared row stride (bf16) of a [k][row] tile
constexpr int TILE_ELEMS = BM * LDS > BK * LDT ? BM * LDS : BK * LDT;

// k rows [k0, k0 + BK) x columns [c0, c0 + 64) of a row-major (K, cols)
// matrix -> s[k][c] with row stride LDT, zero-filled outside.  VEC: 16-byte
// loads, valid when cols, ld and the base pointer are multiples of 8.
template <bool VEC>
__device__ __forceinline__ void load_cols(bf16* __restrict__ s, const bf16* __restrict__ g,
                                          int ld, int k0, int kend, int c0, int cols) {
  if (VEC) {
    for (int e = threadIdx.x; e < BK * BN / 8; e += THREADS) {
      const int r = e / (BN / 8), cc = (e % (BN / 8)) * 8;
      const int gk = k0 + r, gc = c0 + cc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gk < kend && gc < cols) v = *reinterpret_cast<const uint4*>(g + (size_t)gk * ld + gc);
      *reinterpret_cast<uint4*>(s + r * LDT + cc) = v;
    }
  } else {
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN, cc = e % BN;
      const int gk = k0 + r, gc = c0 + cc;
      bf16 v = __ushort_as_bfloat16((unsigned short)0);
      if (gk < kend && gc < cols) v = g[(size_t)gk * ld + gc];
      s[r * LDT + cc] = v;
    }
  }
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;

template <bool TA, bool TB, bool VEC, bool OUT_F32>
__global__ void __launch_bounds__(THREADS)
gemm_layout_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
                   int M, int N, int K, int kchunk, void* __restrict__ C, int ldc,
                   long long split_stride) {
  constexpr int TILE_BYTES2 = 2 * TILE_ELEMS * 2;
  constexpr int SMEM = TILE_BYTES2 > BM * LDC * 4 ? TILE_BYTES2 : BM * LDC * 4;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + TILE_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  const int warp = threadIdx.x / 32;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  Acc acc[1][2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[0][i][j], 0.0f);

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    if constexpr (TA) load_cols<VEC>(As, A, lda, k0, kend, m0, M);
    else load_tile<VEC>(As, A, lda, m0, M, k0, kend);
    if constexpr (TB) load_cols<VEC>(Bs, B, ldb, k0, kend, n0, N);
    else load_tile<VEC>(Bs, B, ldb, n0, N, k0, kend);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      typename std::conditional<TA, FragAc, FragA>::type a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (TA) wmma::load_matrix_sync(a[i], As + kk * LDT + wr + i * 16, LDT);
        else wmma::load_matrix_sync(a[i], As + (wr + i * 16) * LDS + kk, LDS);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        typename std::conditional<TB, FragBr, FragB>::type b;
        if constexpr (TB) wmma::load_matrix_sync(b, Bs + kk * LDT + wc + j * 16, LDT);
        else wmma::load_matrix_sync(b, Bs + (wc + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[0][i][j], a[i], b, acc[0][i][j]);
      }
    }
    __syncthreads();
  }
  stage_acc<1>(Cs, acc);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float v = Cs[r * LDC + c];
    if (OUT_F32)
      static_cast<float*>(C)[blockIdx.z * split_stride + (size_t)gm * ldc + gn] = v;
    else
      static_cast<bf16*>(C)[(size_t)gm * ldc + gn] = f2bf(v);
  }
}

// out[e] = sum over s of part[s * n + e], s in order
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, long long n,
                                  float* __restrict__ out) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[z * n + e];
    out[e] = s;
  }
}

// ---------------------------------------------- K11: the FF backward's core
// One (64 rows x 64 inner) tile: recompute a = xn wa^T and g = xn wg^T
// (K = dim), take dact = do wo over the same tile (wo passed transposed as
// woT (inner, dim), so it is a third nn.Linear-layout weight with K = dim),
// and write act = a gelu(g), da = dact gelu(g) and
// dg = dact a (Phi(g) + g phi(g)), each rounded to bf16 as ffn.py::
// _bwd_kernel rounds them (:165, :173-174).  da and dg go side by side into
// one (rows, 2 * inner_pad) buffer, so dxn = [da | dg] [wa; wg] is one NN
// product and [dwa; dwg] one TN product.
constexpr int FF_SMEM = 3 * BM * LDC * 4;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ff_bwd_kernel(const bf16* __restrict__ xn, const bf16* __restrict__ dout, int ldx,
              const bf16* __restrict__ wa, const bf16* __restrict__ wg,
              const bf16* __restrict__ woT, int ldw, int M, int N, int K,
              bf16* __restrict__ act, int ldact, bf16* __restrict__ dcat, int lddc) {
  extern __shared__ __align__(128) unsigned char fsm[];
  bf16* As = reinterpret_cast<bf16*>(fsm);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(fsm);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* Wag[2] = {wa, wg};
  const bf16* Wo[1] = {woT};
  Acc ag[2][2][2], dacc[1][2][2];
  mainloop<2, VEC>(ag, As, Bs, xn, ldx, Wag, ldw, m0, n0, M, N, K);
  mainloop<1, VEC>(dacc, As, Bs, dout, ldx, Wo, ldw, m0, n0, M, N, K);
  stage_acc<2>(Cs, ag);
  stage_acc<1>(Cs + 2 * BM * LDC, dacc);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float a = Cs[r * LDC + c], g = Cs[BM * LDC + r * LDC + c];
    const float dact = Cs[2 * BM * LDC + r * LDC + c];
    const float phi = 0.5f * (1.0f + erff(g * 0.70710678118654752f));
    const float gelu = g * phi;
    const float pdf = expf(-0.5f * g * g) * 0.3989422804014327f;
    act[(size_t)gm * ldact + gn] = f2bf(a * gelu);
    dcat[(size_t)gm * lddc + gn] = f2bf(dact * gelu);
    dcat[(size_t)gm * lddc + N + gn] = f2bf(dact * a * (phi + g * pdf));
  }
}

template <int EPI>
void launch_gemm(bool vec, dim3 grid, cudaStream_t s, const bf16* A, int lda, const bf16* W,
                 const bf16* W2, int ldw, int M, int N, int K, bf16* C, int ldc, const bf16* R,
                 int ldr, const bf16* bias) {
  if (vec)
    gemm_kernel<EPI, true><<<grid, THREADS, 0, s>>>(A, lda, W, W2, ldw, M, N, K, C, ldc, R, ldr, bias);
  else
    gemm_kernel<EPI, false><<<grid, THREADS, 0, s>>>(A, lda, W, W2, ldw, M, N, K, C, ldc, R, ldr, bias);
}

}  // namespace

// epi: 0 store, 1 + residual R, 2 bf16(acc) + bias, 3 GEGLU(A*W^T, A*W2^T).
// vec: 1 when K, lda, ldw and the A/W base pointers are multiples of 8
// elements (16 bytes); the wrapper decides.
CT_EXPORT int ct_gemm(int epi, const void* A, int lda, const void* W, const void* W2, int ldw,
                      int M, int N, int K, void* C, int ldc, const void* R, int ldr,
                      const void* bias, int vec, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *a = static_cast<const bf16*>(A), *w = static_cast<const bf16*>(W),
             *w2 = static_cast<const bf16*>(W2), *res = static_cast<const bf16*>(R),
             *b = static_cast<const bf16*>(bias);
  bf16* c = static_cast<bf16*>(C);
  switch (epi) {
    case EPI_STORE: launch_gemm<EPI_STORE>(vec, grid, s, a, lda, w, w2, ldw, M, N, K, c, ldc, res, ldr, b); break;
    case EPI_RESIDUAL: launch_gemm<EPI_RESIDUAL>(vec, grid, s, a, lda, w, w2, ldw, M, N, K, c, ldc, res, ldr, b); break;
    case EPI_BIAS_ROUNDED: launch_gemm<EPI_BIAS_ROUNDED>(vec, grid, s, a, lda, w, w2, ldw, M, N, K, c, ldc, res, ldr, b); break;
    case EPI_GEGLU: launch_gemm<EPI_GEGLU>(vec, grid, s, a, lda, w, w2, ldw, M, N, K, c, ldc, res, ldr, b); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

CT_EXPORT int ct_gemm_argmax(const void* A, int lda, const void* W, int ldw, int M, int N, int K,
                             void* ids, int vec, void* stream) {
  const dim3 grid((M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *a = static_cast<const bf16*>(A), *w = static_cast<const bf16*>(W);
  if (vec)
    gemm_argmax_kernel<true><<<grid, THREADS, 0, s>>>(a, lda, w, ldw, M, N, K, static_cast<int*>(ids));
  else
    gemm_argmax_kernel<false><<<grid, THREADS, 0, s>>>(a, lda, w, ldw, M, N, K, static_cast<int*>(ids));
  return (int)cudaGetLastError();
}

// argmax_n (A W^T + A W2^T)[m, n]: W and W2 the hi and lo bf16 parts of one
// codebook, sharing ldw.
CT_EXPORT int ct_gemm_argmax2(const void* A, int lda, const void* W, const void* W2, int ldw,
                              int M, int N, int K, void* ids, int vec, void* stream) {
  const dim3 grid((M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *a = static_cast<const bf16*>(A), *w = static_cast<const bf16*>(W),
             *w2 = static_cast<const bf16*>(W2);
  int* out = static_cast<int*>(ids);
  if (vec)
    gemm_argmax2_kernel<true><<<grid, THREADS, 0, s>>>(a, lda, w, w2, ldw, M, N, K, out);
  else
    gemm_argmax2_kernel<false><<<grid, THREADS, 0, s>>>(a, lda, w, w2, ldw, M, N, K, out);
  return (int)cudaGetLastError();
}

template <bool TA, bool TB, bool OUT_F32>
int launch_layout(bool vec, dim3 grid, cudaStream_t s, const bf16* A, int lda, const bf16* B,
                  int ldb, int M, int N, int K, int kchunk, void* C, int ldc,
                  long long split_stride) {
  if (vec)
    gemm_layout_kernel<TA, TB, true, OUT_F32><<<grid, THREADS, 0, s>>>(
        A, lda, B, ldb, M, N, K, kchunk, C, ldc, split_stride);
  else
    gemm_layout_kernel<TA, TB, false, OUT_F32><<<grid, THREADS, 0, s>>>(
        A, lda, B, ldb, M, N, K, kchunk, C, ldc, split_stride);
  return (int)cudaGetLastError();
}

// layout 0: NN (TA false, TB true), C bf16 (out_f32 0) or f32 (1), one split;
// layout 1: TN (TA and TB true), C f32, ceil(K / kchunk) splits of
// split_stride floats each (kchunk a multiple of 32).
CT_EXPORT int ct_gemm_layout(int layout, int out_f32, const void* A, int lda, const void* B,
                             int ldb, int M, int N, int K, int kchunk, void* C, int ldc,
                             long long split_stride, int vec, void* stream) {
  if (kchunk <= 0 || kchunk % BK) return (int)cudaErrorInvalidValue;
  const int splits = (K + kchunk - 1) / kchunk;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *a = static_cast<const bf16*>(A), *b = static_cast<const bf16*>(B);
  if (layout == 0 && splits == 1)
    return out_f32 ? launch_layout<false, true, true>(vec, grid, s, a, lda, b, ldb, M, N, K,
                                                      kchunk, C, ldc, 0)
                   : launch_layout<false, true, false>(vec, grid, s, a, lda, b, ldb, M, N, K,
                                                       kchunk, C, ldc, 0);
  if (layout == 1 && out_f32)
    return launch_layout<true, true, true>(vec, grid, s, a, lda, b, ldb, M, N, K, kchunk, C,
                                           ldc, split_stride);
  return (int)cudaErrorInvalidValue;
}

CT_EXPORT int ct_sum_splits(const void* part, int splits, long long n, void* out,
                            void* stream) {
  const long long blocks = (n + 255) / 256;
  sum_splits_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), splits, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// xn, dout (M, K) with row stride ldx; wa, wg, woT (N, K) with row stride
// ldw; act (M, N); dcat (M, 2N) [da | dg].
CT_EXPORT int ct_ff_bwd(const void* xn, const void* dout, int ldx, const void* wa,
                        const void* wg, const void* woT, int ldw, int M, int N, int K,
                        void* act, int ldact, void* dcat, int lddc, int vec, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) -> int {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           FF_SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, FF_SMEM, s>>>(
        static_cast<const bf16*>(xn), static_cast<const bf16*>(dout), ldx,
        static_cast<const bf16*>(wa), static_cast<const bf16*>(wg),
        static_cast<const bf16*>(woT), ldw, M, N, K, static_cast<bf16*>(act), ldact,
        static_cast<bf16*>(dcat), lddc);
    return (int)cudaGetLastError();
  };
  return vec ? run(ff_bwd_kernel<true>) : run(ff_bwd_kernel<false>);
}
