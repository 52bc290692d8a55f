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
//     codes with a running row argmax (gemm_argmax_kernel).
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
