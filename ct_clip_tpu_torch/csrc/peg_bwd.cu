// peg_bwd.cu — the weight and bias gradients of the PEG's depthwise 3x3x3
// convolution: dW[tap, c] = sum over (b, t, h, w) of dout[b, t, h, w, c] times
// the zero-padded input at the tap's shift, db[c] = sum of dout[..., c].
//
// Replaces ct_clip_tpu/ops/pallas/peg.py::_pallas_peg_bwd (K14, _dw_kernel
// :153-178): 27 shifted multiply-reduce taps over the token-native
// (b, t, h, w, c) layout, accumulated in f32.  The pads are the forward's
// leading pads per axis (2 on the causal axis, 1 elsewhere); tap
// (kz * 3 + ky) * 3 + kx shifts (t, h, w) by (kz, ky, kx) minus those pads.
// dx is the depthwise convolution of dout with the flipped kernel, as in
// JAX (lax_peg_dx), and is not computed here.
//
// What bounds it on the H100: memory.  At batch 8 the call must read x and
// dout once, 2 x 8 x 24^3 x 512 bf16 = 113 MB, against 1.5 G multiply-adds.
// One block per (64-channel slab, frame): four warps split the frame's
// positions, each lane owns two neighbouring channels (4-byte loads, a warp
// reads 128 contiguous bytes), the 27 neighbours of a position come from
// L1/L2, and 28 x 2 sums sit in registers.  The four warps' sums are added
// in a fixed order in shared memory and each frame writes its own partial
// row; ct_sum_splits adds the frames in order, so the result does not change
// from run to run.
#include "common.cuh"

namespace {

constexpr int PEG_WARPS = 4;
constexpr int PEG_CH = 64;  // channels per block: two per lane
constexpr int TAPS = 28;    // 27 weight taps + the bias

__global__ void __launch_bounds__(PEG_WARPS * 32)
peg_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dout, int T, int H, int W,
              int C, int p0t, int p0h, int p0w, float* __restrict__ part) {
  __shared__ float red[PEG_WARPS][TAPS][PEG_CH];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * PEG_CH + 2 * lane;
  const int frame = blockIdx.y, b = frame / T, t = frame % T;
  const bool ok = c < C;  // C is even
  float acc[TAPS][2];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) acc[k][0] = acc[k][1] = 0.0f;

  const size_t plane = (size_t)H * W * C;
  const bf16* xb = x + (size_t)b * T * plane;
  for (int pos = warp; pos < H * W; pos += PEG_WARPS) {
    const int hh = pos / W, ww = pos % W;
    if (!ok) continue;
    const float2 g = __bfloat1622float2(*reinterpret_cast<const bf162*>(
        dout + ((size_t)frame * H * W + pos) * C + c));
    acc[27][0] += g.x;
    acc[27][1] += g.y;
#pragma unroll
    for (int kz = 0; kz < 3; ++kz) {
      const int tz = t + kz - p0t;
      if (tz < 0 || tz >= T) continue;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int hy = hh + ky - p0h;
        if (hy < 0 || hy >= H) continue;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int wx = ww + kx - p0w;
          if (wx < 0 || wx >= W) continue;
          const float2 xv = __bfloat1622float2(*reinterpret_cast<const bf162*>(
              xb + (size_t)tz * plane + ((size_t)hy * W + wx) * C + c));
          const int k = (kz * 3 + ky) * 3 + kx;
          acc[k][0] = fmaf(xv.x, g.x, acc[k][0]);
          acc[k][1] = fmaf(xv.y, g.y, acc[k][1]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    red[warp][k][2 * lane] = acc[k][0];
    red[warp][k][2 * lane + 1] = acc[k][1];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TAPS * PEG_CH; e += PEG_WARPS * 32) {
    const int k = e / PEG_CH, cl = e % PEG_CH, cc = blockIdx.x * PEG_CH + cl;
    if (cc >= C) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < PEG_WARPS; ++w) s += red[w][k][cl];
    part[((size_t)frame * TAPS + k) * C + cc] = s;
  }
}

}  // namespace

// x, dout (B, T, H, W, C) bf16 contiguous, C even; part (B * T, 28, C) f32:
// per frame, rows 0-26 the weight taps, row 27 the bias.
CT_EXPORT int ct_peg_dw(const void* x, const void* dout, int B, int T, int H, int W, int C,
                        int p0t, int p0h, int p0w, void* part, void* stream) {
  if (C % 2 || B < 1 || T < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + PEG_CH - 1) / PEG_CH, B * T);
  peg_dw_kernel<<<grid, PEG_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dout), T, H, W, C, p0t, p0h, p0w,
      static_cast<float*>(part));
  return (int)cudaGetLastError();
}
