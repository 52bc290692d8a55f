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
//     epilogue (EPI_GEGLU), then act*Wo + x (EPI_RESIDUAL); in bf16 only at
//     model widths ffn_tc.cu's TMA copies cannot take (ops/ffn.py::
//     fwd_route), elsewhere ffn_tc.cu's `wgmma` forms;
//   * ops/pallas/patchify.py::_pallas_patch_embed (K8): the 4000x512
//     projection with the rounded bias add (EPI_BIAS_ROUNDED);
//   * ops/pallas/vq.py::pallas_assign (K5): similarity against all 8192
//     codes with a running row argmax (gemm_argmax_kernel: the inference
//     mode at widths vq_tc.cu does not fit, kernels.vq_tc_fits), and its exact
//     training mode against the hi + lo bf16 codebook (gemm_argmax2_kernel;
//     on f32 rows gemm_argmax3_rows_kernel, three bf16 products);
//   * the products inside the backwards ops/pallas/ffn.py::_pallas_ff_bwd
//     (K11 in f32: the recomputed a and g with dact = do wo and the GEGLU
//     derivative in one tile, ff_bwd_kernel; in bf16 ffn_tc.cu's `wgmma`
//     kernels take K11's tile and products), spatial_attention.py::
//     _pallas_spatial_bwd (K9) and small_attention.py::
//     _pallas_small_qknorm_bwd (K10): dX = dY W ("NN") and the weight
//     gradients dW = dY^T X over all rows ("TN", f32, split over row blocks
//     and summed in a fixed order), gemm_layout_kernel.
//
// f32 forms (compile-time template forms; the bf16 instantiations are the
// code above them unchanged): the same kernels on f32 operands compute true
// f32 products, as the TPU kernels' "highest" precision does for f32
// (ct_clip_tpu/ops/pallas/_call.py:50-70), with FFMA register tiles on the
// CUDA cores (f32_mainloop: 64x64x16 block tiles, each thread an 8x4 tile of
// f32 sums in FMA chains): K3 and K11 for an f32 MaskGit, the K1 / K2
// projections for an f32 CTViT.  gemm_argmax_kernel's f32-row form is K5 on
// f32 rows (vq.py:83-93): each row is l2-normalised in f32 and rounded to
// bf16 as its tile is loaded, then taken against the bf16 codebook on the
// tensor cores as before.  f32 on the CUDA cores is bound at 67 TFLOP/s.
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

// The f32-row form of load_tile (K5 on f32 rows): row r of the tile times
// rn[r], the row's inverse l2 norm, rounded to bf16 (vq.py:90-91).  VEC:
// 16-byte loads, valid when K, ld and the base pointer are multiples of 4.
template <bool VEC>
__device__ __forceinline__ void load_tile_norm(bf16* __restrict__ s, const float* __restrict__ g,
                                               int ld, int row0, int rows, int k0, int K,
                                               const float* __restrict__ rn) {
  if (VEC) {
    for (int c = threadIdx.x; c < 64 * BK / 4; c += THREADS) {
      const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const int gr = row0 + r, gk = k0 + kc;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gr < rows && gk < K) v = *reinterpret_cast<const float4*>(g + (size_t)gr * ld + gk);
      const float f = rn[r];
      bf162* d = reinterpret_cast<bf162*>(s + r * LDS + kc);
      d[0] = __floats2bfloat162_rn(v.x * f, v.y * f);
      d[1] = __floats2bfloat162_rn(v.z * f, v.w * f);
    }
  } else {
    for (int c = threadIdx.x; c < 64 * BK; c += THREADS) {
      const int r = c / BK, kk = c % BK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.0f;
      if (gr < rows && gk < K) v = g[(size_t)gr * ld + gk];
      s[r * LDS + kk] = f2bf(v * rn[r]);
    }
  }
}

// Accumulate one (BM x BN) tile over all of K for NB weight matrices that
// share the A operand.  As/Bs: shared tiles; acc[nb][i][j]: the warp's 2x2.
// TA float: A holds f32 rows, normalised and rounded on load (rn).
template <int NB, bool VEC, typename TA = bf16>
__device__ __forceinline__ void mainloop(Acc (&acc)[NB][2][2], bf16* As, bf16* Bs,
                                         const TA* A, int lda, const bf16* const* Ws,
                                         int ldw, int m0, int n0, int M, int N, int K,
                                         const float* rn = nullptr) {
  const int warp = threadIdx.x / 32;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[nb][i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    if constexpr (std::is_same<TA, float>::value) load_tile_norm<VEC>(As, A, lda, m0, M, k0, K, rn);
    else load_tile<VEC>(As, A, lda, m0, M, k0, K);
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

// ------------------------------------------ f32 products on the CUDA cores
// A block tile of 64 x 64 f32 sums over k tiles of FBK, both operands
// staged k-major (s[k][row], row stride FLD) so a thread reads its 8 rows
// of A and 4 columns of B as float4s; thread (tid / 16, tid % 16) owns rows
// 8 (tid / 16) + [0, 8) and columns 4 (tid % 16) + [0, 4) of the tile, each
// sum one FMA chain over k.
constexpr int FBK = 16;
constexpr int FLD = BM + 4;
constexpr int FTILE = FBK * FLD;  // floats per staged operand tile
constexpr int FR = 8, FC = 4;
static_assert(BM == BN && THREADS == (BM / FR) * (BN / FC), "f32 tile layout");

// rows [row0, row0 + 64) x k [k0, k0 + FBK) of a row-major (rows, K)
// matrix -> s[k][r], zero-filled outside rows and [.., kend).  VEC: 16-byte
// loads, valid when kend, ld and the base pointer are multiples of 4.
template <bool VEC>
__device__ __forceinline__ void f32_load_rows(float* __restrict__ s, const float* __restrict__ g,
                                              int ld, int row0, int rows, int k0, int kend) {
  if (VEC) {
    for (int c = threadIdx.x; c < 64 * FBK / 4; c += THREADS) {
      const int r = c / (FBK / 4), kc = (c % (FBK / 4)) * 4;
      const int gr = row0 + r, gk = k0 + kc;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gr < rows && gk < kend) v = *reinterpret_cast<const float4*>(g + (size_t)gr * ld + gk);
      s[kc * FLD + r] = v.x;
      s[(kc + 1) * FLD + r] = v.y;
      s[(kc + 2) * FLD + r] = v.z;
      s[(kc + 3) * FLD + r] = v.w;
    }
  } else {
    for (int c = threadIdx.x; c < 64 * FBK; c += THREADS) {
      const int r = c / FBK, kk = c % FBK;
      const int gr = row0 + r, gk = k0 + kk;
      s[kk * FLD + r] = (gr < rows && gk < kend) ? g[(size_t)gr * ld + gk] : 0.0f;
    }
  }
}

// k rows [k0, k0 + FBK) x columns [c0, c0 + 64) of a row-major (K, cols)
// matrix -> s[k][c], zero-filled outside.  VEC: cols, ld and the base
// pointer multiples of 4.
template <bool VEC>
__device__ __forceinline__ void f32_load_cols(float* __restrict__ s, const float* __restrict__ g,
                                              int ld, int k0, int kend, int c0, int cols) {
  if (VEC) {
    for (int e = threadIdx.x; e < FBK * BN / 4; e += THREADS) {
      const int r = e / (BN / 4), cc = (e % (BN / 4)) * 4;
      const int gk = k0 + r, gc = c0 + cc;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gk < kend && gc < cols) v = *reinterpret_cast<const float4*>(g + (size_t)gk * ld + gc);
      *reinterpret_cast<float4*>(s + r * FLD + cc) = v;
    }
  } else {
    for (int e = threadIdx.x; e < FBK * BN; e += THREADS) {
      const int r = e / BN, cc = e % BN;
      const int gk = k0 + r, gc = c0 + cc;
      s[r * FLD + cc] = (gk < kend && gc < cols) ? g[(size_t)gk * ld + gc] : 0.0f;
    }
  }
}

// C(m, n) = sum over k in [kbeg, kend) of A(m, k) B_nb(k, n) for NB B
// operands sharing A, with the layouts of gemm_layout_kernel (TA, TB; the
// forward's weights are TB false).  sm: (1 + NB) * FTILE floats of shared
// memory.  Ends synchronised, so the caller may reuse sm.
template <int NB, bool TA, bool TB, bool VEC>
__device__ __forceinline__ void f32_mainloop(float (&acc)[NB][FR][FC], float* sm,
                                             const float* A, int lda, const float* const* Bg,
                                             int ldb, int m0, int n0, int M, int N, int kbeg,
                                             int kend) {
  float* As = sm;
  float* Bs = sm + FTILE;
  const int ty = threadIdx.x / (BN / FC), tx = threadIdx.x % (BN / FC);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < FC; ++j) acc[nb][i][j] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += FBK) {
    if constexpr (TA) f32_load_cols<VEC>(As, A, lda, k0, kend, m0, M);
    else f32_load_rows<VEC>(As, A, lda, m0, M, k0, kend);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if constexpr (TB) f32_load_cols<VEC>(Bs + nb * FTILE, Bg[nb], ldb, k0, kend, n0, N);
      else f32_load_rows<VEC>(Bs + nb * FTILE, Bg[nb], ldb, n0, N, k0, kend);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * FLD + ty * FR);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * FLD + ty * FR + 4);
      const float a[FR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 b4 = *reinterpret_cast<const float4*>(Bs + nb * FTILE + kk * FLD + tx * FC);
        const float b[FC] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < FR; ++i)
#pragma unroll
          for (int j = 0; j < FC; ++j) acc[nb][i][j] = fmaf(a[i], b[j], acc[nb][i][j]);
      }
    }
    __syncthreads();
  }
}

// the sums into the (BM x LDC) f32 staging tiles the epilogues read
template <int NB>
__device__ __forceinline__ void f32_stage(float* Cs, const float (&acc)[NB][FR][FC]) {
  const int ty = threadIdx.x / (BN / FC), tx = threadIdx.x % (BN / FC);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < FR; ++i)
      *reinterpret_cast<float4*>(Cs + nb * BM * LDC + (ty * FR + i) * LDC + tx * FC) =
          make_float4(acc[nb][i][0], acc[nb][i][1], acc[nb][i][2], acc[nb][i][3]);
}

constexpr int TILE_BYTES = (BM * LDS + 2 * BN * LDS) * 2;
constexpr int STAGE_BYTES = 2 * BM * LDC * 4;
constexpr int GEMM_SMEM = TILE_BYTES > STAGE_BYTES ? TILE_BYTES : STAGE_BYTES;

static_assert((1 + 2) * FTILE * 4 <= GEMM_SMEM, "f32 tiles fit the staging buffer");

// T bf16: WMMA on the tensor cores; T float: the f32 form (f32_mainloop),
// every epilogue in f32 with the rounding a T output takes.
template <typename T, int EPI, bool VEC>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ W,
            const T* __restrict__ W2, int ldw, int M, int N, int K,
            T* __restrict__ C, int ldc, const T* __restrict__ R, int ldr,
            const T* __restrict__ bias) {
  constexpr int NB = EPI == EPI_GEGLU ? 2 : 1;
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the main loop

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* Ws[2] = {W, W2};
  if constexpr (std::is_same<T, float>::value) {
    float acc[NB][FR][FC];
    f32_mainloop<NB, false, false, VEC>(acc, Cs, A, lda, Ws, ldw, m0, n0, M, N, 0, K);
    f32_stage<NB>(Cs, acc);
  } else {
    bf16* As = reinterpret_cast<bf16*>(smem);
    bf16* Bs = As + BM * LDS;
    Acc acc[NB][2][2];
    mainloop<NB, VEC>(acc, As, Bs, A, lda, Ws, ldw, m0, n0, M, N, K);
    stage_acc<NB>(Cs, acc);
  }
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
      out = v + to_f(R[(size_t)gm * ldr + gn]);
    } else if (EPI == EPI_BIAS_ROUNDED) {  // T(acc) + bias in T
      out = round_as<T>(v) + to_f(bias[gn]);
    } else {  // GEGLU: value * gelu_erf(gate), exact erf
      const float g = Cs[BM * LDC + r * LDC + c];
      out = v * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
    }
    C[(size_t)gm * ldc + gn] = from_f<T>(out);
  }
}

// Row argmax of A * W^T over all N columns.  One block owns 64 rows and
// walks every 64-column chunk of W, so no reduction crosses blocks.  Two
// threads share a row (32 columns each of every chunk); ties resolve to the
// lowest column, as torch.argmax and jnp.argmax do.
//
// TA float (K5 on f32 rows, vq.py:83-93): A holds raw f32 rows; the block
// first takes its rows' inverse l2 norms rsqrt(max(sum x^2, 1e-24)) in f32
// (two threads a row), and every A tile is normalised and rounded to bf16
// as it is loaded, so the normalised rows never reach device memory.
template <bool VEC, typename TA = bf16>
__global__ void __launch_bounds__(THREADS)
gemm_argmax_kernel(const TA* __restrict__ A, int lda, const bf16* __restrict__ W, int ldw,
                   int M, int N, int K, int* __restrict__ ids) {
  constexpr bool ROWS32 = std::is_same<TA, float>::value;
  constexpr int TILES = (BM * LDS + BN * LDS) * 2 + BM * LDC * 4;
  __shared__ __align__(128) unsigned char smem[TILES + (ROWS32 ? BM * 4 : 0)];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem + (BM * LDS + BN * LDS) * 2);

  const int m0 = blockIdx.x * BM;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float* rn = nullptr;
  if constexpr (ROWS32) {
    rn = reinterpret_cast<float*>(smem + TILES);
    float ss = 0.0f;
    if (m0 + r < M)
      for (int k = half; k < K; k += 2) {
        const float x = A[(size_t)(m0 + r) * lda + k];
        ss = fmaf(x, x, ss);
      }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    if (half == 0) rn[r] = rsqrtf(fmaxf(ss, 1e-24f));
    __syncthreads();
  }
  float best = -INFINITY;
  int best_i = 0;
  const bf16* Ws[1] = {W};
  for (int n0 = 0; n0 < N; n0 += BN) {
    Acc acc[1][2][2];
    mainloop<1, VEC>(acc, As, Bs, A, lda, Ws, ldw, m0, n0, M, N, K, rn);
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

// The exact-mode f32-row form of load_tile (K5 exact on f32 rows,
// vq.py:90-95): row r of the tile times rn[r] in f32, split into its bf16
// hi part xh = bf16(xn) (into sh) and lo part xl = bf16(xn - xh) (into sl).
// VEC: 16-byte loads, valid when K, ld and the base pointer are multiples
// of 4.
template <bool VEC>
__device__ __forceinline__ void load_tile_split(bf16* __restrict__ sh, bf16* __restrict__ sl,
                                                const float* __restrict__ g, int ld, int row0,
                                                int rows, int k0, int K,
                                                const float* __restrict__ rn) {
  if (VEC) {
    for (int c = threadIdx.x; c < 64 * BK / 4; c += THREADS) {
      const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const int gr = row0 + r, gk = k0 + kc;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gr < rows && gk < K) v = *reinterpret_cast<const float4*>(g + (size_t)gr * ld + gk);
      const float f = rn[r];
      const float x[4] = {v.x * f, v.y * f, v.z * f, v.w * f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bf16 h = f2bf(x[e]);
        sh[r * LDS + kc + e] = h;
        sl[r * LDS + kc + e] = f2bf(x[e] - bf2f(h));
      }
    }
  } else {
    for (int c = threadIdx.x; c < 64 * BK; c += THREADS) {
      const int r = c / BK, kk = c % BK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.0f;
      if (gr < rows && gk < K) v = g[(size_t)gr * ld + gk];
      const float x = v * rn[r];
      const bf16 h = f2bf(x);
      sh[r * LDS + kk] = h;
      sl[r * LDS + kk] = f2bf(x - bf2f(h));
    }
  }
}

// Exact-mode assignment on f32 rows (K5 exact, vq.py::_assign_kernel with
// exact and f32 input, :83-95): each row l2-normalised in f32 (rn, as
// gemm_argmax_kernel's f32-row form) and split into bf16 xh + xl as its
// tile is loaded, the codebook into bf16 hi + lo (W, W2); three products
// on the tensor cores, xh.c_hi, xh.c_lo and xl.c_hi, each summed in its own
// f32 accumulator and added as (xh.c_hi + xh.c_lo) + xl.c_hi, then the
// running row argmax.  The dropped xl.c_lo term is <= 2^-16 relative.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gemm_argmax3_rows_kernel(const float* __restrict__ A, int lda, const bf16* __restrict__ W,
                         const bf16* __restrict__ W2, int ldw, int M, int N, int K,
                         int* __restrict__ ids) {
  __shared__ __align__(128) unsigned char smem[(2 * BM * LDS + 2 * BN * LDS) * 2
                                               + BM * LDC * 4 + BM * 4];
  bf16* Ah = reinterpret_cast<bf16*>(smem);
  bf16* Al = Ah + BM * LDS;
  bf16* Bh = Al + BM * LDS;
  bf16* Bl = Bh + BN * LDS;
  float* Cs = reinterpret_cast<float*>(smem + (2 * BM * LDS + 2 * BN * LDS) * 2);
  float* rn = Cs + BM * LDC;

  const int m0 = blockIdx.x * BM;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  {
    float ss = 0.0f;
    if (m0 + r < M)
      for (int k = half; k < K; k += 2) {
        const float x = A[(size_t)(m0 + r) * lda + k];
        ss = fmaf(x, x, ss);
      }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    if (half == 0) rn[r] = rsqrtf(fmaxf(ss, 1e-24f));
    __syncthreads();
  }
  const int warp = threadIdx.x / 32;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
  float best = -INFINITY;
  int best_i = 0;
  for (int n0 = 0; n0 < N; n0 += BN) {
    Acc acc[3][2][2];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[p][i][j], 0.0f);
    for (int k0 = 0; k0 < K; k0 += BK) {
      load_tile_split<VEC>(Ah, Al, A, lda, m0, M, k0, K, rn);
      load_tile<VEC>(Bh, W, ldw, n0, N, k0, K);
      load_tile<VEC>(Bl, W2, ldw, n0, N, k0, K);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA ah[2], al[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(ah[i], Ah + (wr + i * 16) * LDS + kk, LDS);
          wmma::load_matrix_sync(al[i], Al + (wr + i * 16) * LDS + kk, LDS);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB bh, bl;
          wmma::load_matrix_sync(bh, Bh + (wc + j * 16) * LDS + kk, LDS);
          wmma::load_matrix_sync(bl, Bl + (wc + j * 16) * LDS + kk, LDS);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::mma_sync(acc[0][i][j], ah[i], bh, acc[0][i][j]);
            wmma::mma_sync(acc[1][i][j], ah[i], bl, acc[1][i][j]);
            wmma::mma_sync(acc[2][i][j], al[i], bh, acc[2][i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < acc[0][i][j].num_elements; ++t)
          acc[0][i][j].x[t] = (acc[0][i][j].x[t] + acc[1][i][j].x[t]) + acc[2][i][j].x[t];
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

// The f32 form of gemm_layout_kernel (f32_mainloop with the same layouts),
// always f32 out.
template <bool TA, bool TB, bool VEC>
__global__ void __launch_bounds__(THREADS)
gemm_layout_f32_kernel(const float* __restrict__ A, int lda, const float* __restrict__ B,
                       int ldb, int M, int N, int K, int kchunk, float* __restrict__ C, int ldc,
                       long long split_stride) {
  __shared__ __align__(128) float Cs[BM * LDC];
  static_assert(2 * FTILE <= BM * LDC, "f32 tiles fit the staging buffer");
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * kchunk, kend = min(K, kbeg + kchunk);
  float acc[1][FR][FC];
  const float* Bg[1] = {B};
  f32_mainloop<1, TA, TB, VEC>(acc, Cs, A, lda, Bg, ldb, m0, n0, M, N, kbeg, kend);
  f32_stage<1>(Cs, acc);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    C[blockIdx.z * split_stride + (size_t)gm * ldc + gn] = Cs[r * LDC + c];
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
// The f32 form (ffn.py's cdt f32, :145-174; the bf16 form is ffn_tc.cu's
// ff_tc_tile).  One (64 rows x 64 inner) tile: recompute a = xn wa^T and
// g = xn wg^T (K = dim) as f32 FMA-chain sums (f32_mainloop), take dact =
// do wo over the same tile (wo passed transposed as woT (inner, dim), so it
// is a third nn.Linear-layout weight with K = dim), and write act =
// a gelu(g), da = dact gelu(g) and dg = dact a (Phi(g) + g phi(g)) in f32,
// unrounded.  da and dg go side by side into one (rows, 2 * inner_pad)
// buffer, so dxn = [da | dg] [wa; wg] is one NN product and [dwa; dwg] one
// TN product.
constexpr int FF_SMEM = 3 * BM * LDC * 4;

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
ff_bwd_kernel(const T* __restrict__ xn, const T* __restrict__ dout, int ldx,
              const T* __restrict__ wa, const T* __restrict__ wg,
              const T* __restrict__ woT, int ldw, int M, int N, int K,
              T* __restrict__ act, int ldact, T* __restrict__ dcat, int lddc) {
  static_assert(std::is_same<T, float>::value, "the f32 form alone");
  extern __shared__ __align__(128) unsigned char fsm[];
  float* Cs = reinterpret_cast<float*>(fsm);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const T* Wag[2] = {wa, wg};
  const T* Wo[1] = {woT};
  float ag[2][FR][FC], dacc[1][FR][FC];
  f32_mainloop<2, false, false, VEC>(ag, Cs, xn, ldx, Wag, ldw, m0, n0, M, N, 0, K);
  f32_mainloop<1, false, false, VEC>(dacc, Cs, dout, ldx, Wo, ldw, m0, n0, M, N, 0, K);
  f32_stage<2>(Cs, ag);
  f32_stage<1>(Cs + 2 * BM * LDC, dacc);
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
    act[(size_t)gm * ldact + gn] = from_f<T>(a * gelu);
    dcat[(size_t)gm * lddc + gn] = from_f<T>(dact * gelu);
    dcat[(size_t)gm * lddc + N + gn] = from_f<T>(dact * a * (phi + g * pdf));
  }
}

template <typename T, int EPI>
void launch_gemm(bool vec, dim3 grid, cudaStream_t s, const T* A, int lda, const T* W,
                 const T* W2, int ldw, int M, int N, int K, T* C, int ldc, const T* R,
                 int ldr, const T* bias) {
  if (vec)
    gemm_kernel<T, EPI, true><<<grid, THREADS, 0, s>>>(A, lda, W, W2, ldw, M, N, K, C, ldc, R, ldr, bias);
  else
    gemm_kernel<T, EPI, false><<<grid, THREADS, 0, s>>>(A, lda, W, W2, ldw, M, N, K, C, ldc, R, ldr, bias);
}

template <typename T>
int gemm(int epi, const void* A, int lda, const void* W, const void* W2, int ldw, int M, int N,
         int K, void* C, int ldc, const void* R, int ldr, const void* bias, int vec,
         void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T *a = static_cast<const T*>(A), *w = static_cast<const T*>(W),
          *w2 = static_cast<const T*>(W2), *res = static_cast<const T*>(R),
          *b = static_cast<const T*>(bias);
  T* c = static_cast<T*>(C);
  switch (epi) {
    case EPI_STORE: launch_gemm<T, EPI_STORE>(vec, grid, s, a, lda, w, w2, ldw, M, N, K, c, ldc, res, ldr, b); break;
    case EPI_RESIDUAL: launch_gemm<T, EPI_RESIDUAL>(vec, grid, s, a, lda, w, w2, ldw, M, N, K, c, ldc, res, ldr, b); break;
    case EPI_BIAS_ROUNDED: launch_gemm<T, EPI_BIAS_ROUNDED>(vec, grid, s, a, lda, w, w2, ldw, M, N, K, c, ldc, res, ldr, b); break;
    case EPI_GEGLU: launch_gemm<T, EPI_GEGLU>(vec, grid, s, a, lda, w, w2, ldw, M, N, K, c, ldc, res, ldr, b); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, bool TA, bool TB, bool OUT_F32>
int launch_layout(bool vec, dim3 grid, cudaStream_t s, const T* A, int lda, const T* B,
                  int ldb, int M, int N, int K, int kchunk, void* C, int ldc,
                  long long split_stride) {
  if constexpr (std::is_same<T, float>::value) {
    float* c = static_cast<float*>(C);
    if (vec)
      gemm_layout_f32_kernel<TA, TB, true><<<grid, THREADS, 0, s>>>(
          A, lda, B, ldb, M, N, K, kchunk, c, ldc, split_stride);
    else
      gemm_layout_f32_kernel<TA, TB, false><<<grid, THREADS, 0, s>>>(
          A, lda, B, ldb, M, N, K, kchunk, c, ldc, split_stride);
  } else if (vec) {
    gemm_layout_kernel<TA, TB, true, OUT_F32><<<grid, THREADS, 0, s>>>(
        A, lda, B, ldb, M, N, K, kchunk, C, ldc, split_stride);
  } else {
    gemm_layout_kernel<TA, TB, false, OUT_F32><<<grid, THREADS, 0, s>>>(
        A, lda, B, ldb, M, N, K, kchunk, C, ldc, split_stride);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int gemm_layout(int layout, int out_f32, const void* A, int lda, const void* B, int ldb, int M,
                int N, int K, int kchunk, void* C, int ldc, long long split_stride, int vec,
                void* stream) {
  if (kchunk <= 0 || kchunk % BK) return (int)cudaErrorInvalidValue;
  const int splits = (K + kchunk - 1) / kchunk;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T *a = static_cast<const T*>(A), *b = static_cast<const T*>(B);
  if (layout == 0 && splits == 1)
    return out_f32 ? launch_layout<T, false, true, true>(vec, grid, s, a, lda, b, ldb, M, N, K,
                                                         kchunk, C, ldc, 0)
                   : launch_layout<T, false, true, false>(vec, grid, s, a, lda, b, ldb, M, N,
                                                          K, kchunk, C, ldc, 0);
  if (layout == 1 && out_f32)
    return launch_layout<T, true, true, true>(vec, grid, s, a, lda, b, ldb, M, N, K, kchunk, C,
                                              ldc, split_stride);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int ff_bwd(const void* xn, const void* dout, int ldx, const void* wa, const void* wg,
           const void* woT, int ldw, int M, int N, int K, void* act, int ldact, void* dcat,
           int lddc, int vec, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) -> int {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           FF_SMEM);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, FF_SMEM, s>>>(
        static_cast<const T*>(xn), static_cast<const T*>(dout), ldx,
        static_cast<const T*>(wa), static_cast<const T*>(wg),
        static_cast<const T*>(woT), ldw, M, N, K, static_cast<T*>(act), ldact,
        static_cast<T*>(dcat), lddc);
    return (int)cudaGetLastError();
  };
  return vec ? run(ff_bwd_kernel<T, true>) : run(ff_bwd_kernel<T, false>);
}

}  // namespace

// epi: 0 store, 1 + residual R, 2 bf16(acc) + bias, 3 GEGLU(A*W^T, A*W2^T).
// vec: 1 when K, lda, ldw and the A/W base pointers are multiples of 8
// elements (16 bytes); the wrapper decides.
CT_EXPORT int ct_gemm(int epi, const void* A, int lda, const void* W, const void* W2, int ldw,
                      int M, int N, int K, void* C, int ldc, const void* R, int ldr,
                      const void* bias, int vec, void* stream) {
  return gemm<bf16>(epi, A, lda, W, W2, ldw, M, N, K, C, ldc, R, ldr, bias, vec, stream);
}

// The f32 form of ct_gemm: every operand f32, true f32 products on the CUDA
// cores, the epilogue's T rounding none (EPI_BIAS_ROUNDED adds the bias to
// the f32 sum); vec: K, lda, ldw and the base pointers multiples of 4.
CT_EXPORT int ct_gemm_f32(int epi, const void* A, int lda, const void* W, const void* W2,
                          int ldw, int M, int N, int K, void* C, int ldc, const void* R, int ldr,
                          const void* bias, int vec, void* stream) {
  return gemm<float>(epi, A, lda, W, W2, ldw, M, N, K, C, ldc, R, ldr, bias, vec, stream);
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

// K5 on f32 rows: argmax_n of bf16(l2norm(A[m])) . W[n] with A (M, K) f32
// and the bf16 codebook W (N, K); vec: K a multiple of 8, lda a multiple of
// 4, ldw of 8, base pointers 16-byte aligned.
CT_EXPORT int ct_gemm_argmax_rows(const void* A, int lda, const void* W, int ldw, int M, int N,
                                  int K, void* ids, int vec, void* stream) {
  const dim3 grid((M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const bf16* w = static_cast<const bf16*>(W);
  if (vec)
    gemm_argmax_kernel<true, float><<<grid, THREADS, 0, s>>>(a, lda, w, ldw, M, N, K,
                                                            static_cast<int*>(ids));
  else
    gemm_argmax_kernel<false, float><<<grid, THREADS, 0, s>>>(a, lda, w, ldw, M, N, K,
                                                             static_cast<int*>(ids));
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

// K5 exact on f32 rows: argmax_n of (xh W^T + xh W2^T) + xl W^T with xh + xl
// the bf16 split of l2norm(A[m]) (A (M, K) f32) and W, W2 the hi and lo bf16
// parts of one codebook, sharing ldw; vec as ct_gemm_argmax_rows.
CT_EXPORT int ct_gemm_argmax2_rows(const void* A, int lda, const void* W, const void* W2,
                                   int ldw, int M, int N, int K, void* ids, int vec,
                                   void* stream) {
  const dim3 grid((M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const bf16 *w = static_cast<const bf16*>(W), *w2 = static_cast<const bf16*>(W2);
  int* out = static_cast<int*>(ids);
  if (vec)
    gemm_argmax3_rows_kernel<true><<<grid, THREADS, 0, s>>>(a, lda, w, w2, ldw, M, N, K, out);
  else
    gemm_argmax3_rows_kernel<false><<<grid, THREADS, 0, s>>>(a, lda, w, w2, ldw, M, N, K, out);
  return (int)cudaGetLastError();
}

// layout 0: NN (TA false, TB true), C bf16 (out_f32 0) or f32 (1), one split;
// layout 1: TN (TA and TB true), C f32, ceil(K / kchunk) splits of
// split_stride floats each (kchunk a multiple of 32).
CT_EXPORT int ct_gemm_layout(int layout, int out_f32, const void* A, int lda, const void* B,
                             int ldb, int M, int N, int K, int kchunk, void* C, int ldc,
                             long long split_stride, int vec, void* stream) {
  return gemm_layout<bf16>(layout, out_f32, A, lda, B, ldb, M, N, K, kchunk, C, ldc,
                           split_stride, vec, stream);
}

// The f32 form: A and B f32, C f32 (out_f32 must be 1); vec: the row
// strides, widths and base pointers multiples of 4.
CT_EXPORT int ct_gemm_layout_f32(int layout, int out_f32, const void* A, int lda, const void* B,
                                 int ldb, int M, int N, int K, int kchunk, void* C, int ldc,
                                 long long split_stride, int vec, void* stream) {
  if (!out_f32) return (int)cudaErrorInvalidValue;
  return gemm_layout<float>(layout, out_f32, A, lda, B, ldb, M, N, K, kchunk, C, ldc,
                            split_stride, vec, stream);
}

CT_EXPORT int ct_sum_splits(const void* part, int splits, long long n, void* out,
                            void* stream) {
  const long long blocks = (n + 255) / 256;
  sum_splits_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), splits, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// K11's tile in f32: xn, dout (M, K) with row stride ldx; wa, wg, woT (N,
// K) with row stride ldw; act (M, N); dcat (M, 2N) [da | dg]; every operand
// and output f32 (vec: K, the strides and the bases multiples of 4).
CT_EXPORT int ct_ff_bwd_f32(const void* xn, const void* dout, int ldx, const void* wa,
                            const void* wg, const void* woT, int ldw, int M, int N, int K,
                            void* act, int ldact, void* dcat, int lddc, int vec, void* stream) {
  return ff_bwd<float>(xn, dout, ldx, wa, wg, woT, ldw, M, N, K, act, ldact, dcat, lddc, vec,
                       stream);
}
