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
//     gamma-only LN that feeds the q projection.
//
// What bounds it on the H100: memory.  Each row is read once and written
// once (the patch gather reads 20-element runs of 40 bytes); at batch 2 the
// patch LN moves 27648 x 4000 x 2 B in and out (~0.44 GB, ~0.13 ms at
// 3.35 TB/s).  One block of 256 threads per row keeps the row in registers
// (up to 16 values a thread, so D <= 4096) and computes mean and variance in
// two passes, as ct_clip_tpu/ops/norms.py::layer_norm does.
#include "common.cuh"

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

struct PatchGeom {
  int F, H, W, pt, p, t, h, w;
};

// GATHER: row = ((b*t + ti)*h + hi)*w + wi, element e = (z*p + p1)*p + p2
// of video[b, ti*pt + z, hi*p + p1, wi*p + p2]; else x[row*D + e].
template <bool GATHER>
__global__ void __launch_bounds__(LN_THREADS)
ln_kernel(const bf16* __restrict__ x, int D, const float* __restrict__ scale,
          const float* __restrict__ bias, float eps, bf16* __restrict__ out, PatchGeom g) {
  __shared__ float red[LN_THREADS / 32];
  const size_t row = blockIdx.x;
  float vals[LN_PER];
  size_t base = row * (size_t)D;
  int bb = 0, ti = 0, hi = 0, wi = 0;
  if (GATHER) {
    size_t rr = row;
    wi = rr % g.w; rr /= g.w;
    hi = rr % g.h; rr /= g.h;
    ti = rr % g.t; bb = (int)(rr / g.t);
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < LN_PER; ++i) {
    const int e = threadIdx.x + i * LN_THREADS;
    float v = 0.0f;
    if (e < D) {
      if (GATHER) {
        const int p2 = e % g.p, p1 = (e / g.p) % g.p, z = e / (g.p * g.p);
        const size_t idx = (((size_t)bb * g.F + ti * g.pt + z) * g.H + hi * g.p + p1) * g.W
                           + wi * g.p + p2;
        v = bf2f(x[idx]);
      } else {
        v = bf2f(x[base + e]);
      }
    }
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
      out[base + e] = f2bf(y);
    }
  }
}

}  // namespace

// x (rows, D) bf16 -> out (rows, D) bf16; scale/bias f32 (D,) or null.
CT_EXPORT int ct_layernorm(const void* x, int rows, int D, const void* scale, const void* bias,
                           float eps, void* out, void* stream) {
  if (D > LN_THREADS * LN_PER) return (int)cudaErrorInvalidValue;
  PatchGeom g = {0, 0, 0, 0, 0, 0, 0, 0};
  ln_kernel<false><<<rows, LN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), D, static_cast<const float*>(scale),
      static_cast<const float*>(bias), eps, static_cast<bf16*>(out), g);
  return (int)cudaGetLastError();
}

// video (B, F, H, W) bf16 -> out (B*t*h*w, pt*p*p) bf16, LN over each patch.
CT_EXPORT int ct_patch_layernorm(const void* video, int B, int F, int H, int W, int pt, int p,
                                 const void* scale, const void* bias, float eps, void* out,
                                 void* stream) {
  const int D = pt * p * p;
  if (D > LN_THREADS * LN_PER) return (int)cudaErrorInvalidValue;
  PatchGeom g = {F, H, W, pt, p, F / pt, H / p, W / p};
  const int rows = B * g.t * g.h * g.w;
  ln_kernel<true><<<rows, LN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(video), D, static_cast<const float*>(scale),
      static_cast<const float*>(bias), eps, static_cast<bf16*>(out), g);
  return (int)cudaGetLastError();
}

CT_EXPORT const char* ct_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
