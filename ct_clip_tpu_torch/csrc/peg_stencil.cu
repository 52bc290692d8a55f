// peg_stencil.cu — the PEG's depthwise 3x3x3 convolution over channels-last
// (B, T, H, W, C) activations as one hand-written stencil, in two forms of
// one template:
//
//   FWD  out[p] = sum_j taps[j] x[p + j - lead] + x[p] + bias
//   BWD  dx[q]  = sum_j flip(taps)[j] dout[q + j - (2 - lead)] + dout[q],
//        and in the same pass dW[k] = sum_q x[q] dout[q - k + lead],
//        db = sum_q dout[q], in f32
//
// with j, k = (kz, ky, kx) the 27 taps in order, `lead` the forward's leading
// pads per axis (t, h, w) in {0, 1, 2} (trailing = 2 - leading; zeros
// outside the tensor) and `taps` the (c, 1, 3, 3, 3) Conv3d weight as
// applied: its tap axes rotated (t, h, w) -> (h, w, t) with `rot` (the
// temporal stage on a cubic grid).
//
// BWD replaces ct_clip_tpu/ops/pallas/peg.py::_pallas_peg_bwd (K14: dx by
// `lax_peg_dx`, :131-150, dW and db by `_dw_kernel` through pallas_call,
// :153-211).  FWD replaces no TPU kernel: on the TPU the PEG forward is
// XLA's grouped conv (`lax_peg_conv`, peg.py:83-101); it is the same
// correlation as dx with the taps unflipped, so one stencil serves both.
//
// Rounding.  bf16: taps and bias rounded to bf16 first (kernel.astype(x.dtype));
// FWD sums the 27 exact products in f32 and rounds, then rounds + x, then
// + bias (lax_peg_conv's three points); BWD rounds the sum, then + dout
// (lax_peg_dx's two).  f32: FWD starts from x, adds the 27 taps in order,
// then the bias (xla_peg_conv's order); BWD starts from dout.  dW and db are
// f32 sums: each CTA writes its partial (28, C) rows, its warps added in a
// fixed order, and ct_sum_splits adds the CTAs' rows in order, so a run
// repeats bit for bit.
//
// What bounds it on the H100: memory.  At (8, 24, 24, 24, 512) bf16 the
// forward must read x and write out, 226 MB (0.068 ms at 3.35 TB/s); BWD
// reads x and dout and writes dx, 340 MB (0.101 ms), against 27 (FWD) or 54
// (BWD) multiply-adds per element on the CUDA cores (f32 sums).  Design: no
// transpose, no padded copy.  A CTA owns 128 bytes of channels (64 bf16 or
// 32 f32; a lane owns 4 bytes: conflict-free shared reads, a warp on 128
// contiguous bytes), `th` rows of h and `tw` columns of w, and slides along
// t: a ring of PEG_RING planes in shared memory, each the tile with its
// halo, filled by 16-byte cp.async with the pads zero-filled, two planes in
// flight while three are read, so each byte is fetched once per tile.  A
// warp step computes PEG_NQ consecutive w outputs, reading each of the 9
// (kz, ky) rows' PEG_NQ + 2 columns once; the taps and, in BWD, the 28 dW /
// db sums of the lane's channels sit in registers across every position the
// warp visits.  dW uses dx's window: dout at q's 27 neighbours times x[q].
//
// Takes any contiguous (B, T, H, W, C) with C a multiple of 8 (16-byte
// chunks) and 16-byte aligned bases; the wrapper (ops/kernels::peg_fwd,
// peg_bwd) checks that and picks th and tw (`peg_plan`).
#include "wgmma.cuh"  // saddr, cp16

namespace {

constexpr int PEG_WARPS = 4;
constexpr int PEG_THREADS = 32 * PEG_WARPS;
constexpr int PEG_POS = 128;  // bytes of one position's channel slab in shared memory
constexpr int PEG_NQ = 4;     // consecutive w outputs of one warp step
constexpr int PEG_RING = 5;   // planes in shared memory: the stencil's 3, 2 in flight
constexpr int PEG_ROWS = 28;  // dW's 27 taps and db

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the channels a lane owns, 4 bytes: two bf16 or one float
template <typename T>
struct PegLane;
template <>
struct PegLane<bf16> {
  static constexpr int V = 2;
  static __device__ __forceinline__ void load(const uint8_t* p, float* v) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
  static __device__ __forceinline__ void store(void* p, const float* v) {
    *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};
template <>
struct PegLane<float> {
  static constexpr int V = 1;
  static __device__ __forceinline__ void load(const uint8_t* p, float* v) {
    v[0] = *reinterpret_cast<const float*>(p);
  }
  static __device__ __forceinline__ void store(void* p, const float* v) {
    *reinterpret_cast<float*>(p) = v[0];
  }
};

struct PegArgs {
  const void* in;       // the stencil's input: x (FWD), dout (BWD)
  const void* x;        // BWD: x, dW's other factor
  const float* weight;  // (C, 27) f32: the Conv3d weight (C, 1, 3, 3, 3)
  const float* bias;    // (C) f32 (FWD)
  void* out;            // out (FWD), dx (BWD)
  float* part;          // BWD: (B * tiles, 28, C) partial dW / db rows
  int B, T, H, W, C;
  int pt, ph, pw;  // the forward's leading pads
  int rot;         // the taps' axes rotated (t, h, w) -> (h, w, t)
  int th, tw, nwt;  // tile rows and columns, tiles along w
};

// shared-memory bytes of a launch: the ring of planes (and, in BWD, of x
// tiles), at least the warps' dW / db sums
__host__ __device__ inline size_t peg_smem(bool bwd, int th, int tw, int lane_ch) {
  size_t ring = (size_t)PEG_RING * (th + 2) * (tw + 2) * PEG_POS;
  if (!bwd) return ring;
  ring += (size_t)PEG_RING * th * tw * PEG_POS;
  const size_t red = (size_t)PEG_WARPS * PEG_ROWS * 32 * lane_ch * sizeof(float);
  return ring > red ? ring : red;
}

// rows [r0, r0 + rows) x columns [w0, w0 + cols) of frame f of batch b of
// the (B, T, H, W, C) tensor g, 128 bytes of channels from c0, into dst as
// (rows, cols) positions of 128 bytes; zeros outside the tensor (the pads)
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* g, int T_, int H, int W, int C,
                                          int b, int f, int r0, int w0, int rows, int cols,
                                          int c0) {
  constexpr int CH = 16 / sizeof(T);  // channels of one 16-byte chunk
  const int n = rows * cols * (PEG_POS / 16);
  const bool frame = f >= 0 && f < T_;
  for (int e = threadIdx.x; e < n; e += PEG_THREADS) {
    const int pos = e / (PEG_POS / 16), r = pos / cols, col = pos - r * cols;
    const int h = r0 + r, w = w0 + col, c = c0 + (e % (PEG_POS / 16)) * CH;
    const bool ok = frame && h >= 0 && h < H && w >= 0 && w < W && c < C;
    const T* src = ok ? g + ((((size_t)b * T_ + f) * H + h) * W + w) * C + c : g;
    cp16(dst + e * 16, src, ok ? 16 : 0);
  }
}

template <typename T, bool BWD>
__global__ void __launch_bounds__(PEG_THREADS, 2) peg_stencil_kernel(const PegArgs a) {
  using L = PegLane<T>;
  constexpr int V = L::V, CS = 32 * V;  // channels of a lane, of the CTA
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CS, b = blockIdx.z;
  const int h0 = blockIdx.y / a.nwt * a.th, w0 = blockIdx.y % a.nwt * a.tw;
  // the stencil's leading offsets: the forward's pads, complemented for dx
  const int lt = BWD ? 2 - a.pt : a.pt, lh = BWD ? 2 - a.ph : a.ph, lw = BWD ? 2 - a.pw : a.pw;
  const int prow = a.tw + 2, plane = (a.th + 2) * prow * PEG_POS, xtile = a.th * a.tw * PEG_POS;
  uint8_t* const planes = smem;
  uint8_t* const xs = smem + PEG_RING * plane;  // BWD: x tiles, no halo
  const int c = c0 + lane * V;                  // the lane's first channel
  const bool lane_ok = c < a.C;                 // C is a multiple of 8
  const T* const in = static_cast<const T*>(a.in);
  const T* const xg = static_cast<const T*>(a.x);

  // the taps in window order: as applied (rotated or not), flipped for dx
  float tap[27][V];
#pragma unroll
  for (int j = 0; j < 27; ++j) {
    const int k = BWD ? 26 - j : j;
    const int src = a.rot ? (k / 3 % 3 * 3 + k % 3) * 3 + k / 9 : k;
#pragma unroll
    for (int v = 0; v < V; ++v)
      tap[j][v] = lane_ok ? round_as<T>(a.weight[(size_t)(c + v) * 27 + src]) : 0.0f;
  }
  float bias[V], dw[BWD ? 27 : 1][V], db[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    bias[v] = !BWD && lane_ok ? round_as<T>(a.bias[c + v]) : 0.0f;
    db[v] = 0.0f;
#pragma unroll
    for (int j = 0; j < (BWD ? 27 : 1); ++j) dw[j][v] = 0.0f;
  }

  // group g: the stencil's input frame g - lt into plane g % PEG_RING and,
  // in BWD, x's frame g - 2 (the frame output at step g - 2) into x tile
  // g % PEG_RING; one commit group each, empty past the end
  const int T_ = a.T, H = a.H, W = a.W, C = a.C, th = a.th, tw = a.tw;
  auto load_group = [&](int g) {
    if (g < T_ + 2)
      load_tile<T>(saddr(planes + (g % PEG_RING) * plane), in, T_, H, W, C, b, g - lt, h0 - lh,
                   w0 - lw, th + 2, prow, c0);
    if (BWD && g >= 2 && g < T_ + 2)
      load_tile<T>(saddr(xs + (g % PEG_RING) * xtile), xg, T_, H, W, C, b, g - 2, h0, w0, th,
                   tw, c0);
    cp_commit();
  };
#pragma unroll 1
  for (int g = 0; g < PEG_RING; ++g) load_group(g);

  const int steps = a.tw / PEG_NQ, items = a.th * steps;
#pragma unroll 1
  for (int t = 0; t < a.T; ++t) {
    cp_wait<PEG_RING - 3>();  // groups up to t + 2 have landed
    __syncthreads();
    const uint8_t* const pz[3] = {planes + t % PEG_RING * plane + lane * 4,
                                  planes + (t + 1) % PEG_RING * plane + lane * 4,
                                  planes + (t + 2) % PEG_RING * plane + lane * 4};
#pragma unroll 1
    for (int it = warp; it < items; it += PEG_WARPS) {
      const int r = it / steps, q0 = it % steps * PEG_NQ;
      // the center: x[p] (FWD's residual) or dout[q] (dx's residual, db)
      float ctr[PEG_NQ][V], acc[PEG_NQ][V], xq[PEG_NQ][V];
      const uint8_t* cp = planes + (t + lt) % PEG_RING * plane +
                          ((r + lh) * prow + q0 + lw) * PEG_POS + lane * 4;
#pragma unroll
      for (int i = 0; i < PEG_NQ; ++i) {
        L::load(cp + i * PEG_POS, ctr[i]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[i][v] = V == 1 ? ctr[i][v] : 0.0f;  // f32: from x / dout
      }
      if (BWD) {
        const uint8_t* xp = xs + (t + 2) % PEG_RING * xtile + (r * a.tw + q0) * PEG_POS + lane * 4;
#pragma unroll
        for (int i = 0; i < PEG_NQ; ++i) L::load(xp + i * PEG_POS, xq[i]);
      }
#pragma unroll
      for (int jz = 0; jz < 3; ++jz) {
#pragma unroll
        for (int jy = 0; jy < 3; ++jy) {
          const uint8_t* row = pz[jz] + ((r + jy) * prow + q0) * PEG_POS;
          float col[PEG_NQ + 2][V];
#pragma unroll
          for (int cc = 0; cc < PEG_NQ + 2; ++cc) L::load(row + cc * PEG_POS, col[cc]);
#pragma unroll
          for (int jx = 0; jx < 3; ++jx) {
            const int j = (jz * 3 + jy) * 3 + jx;
#pragma unroll
            for (int i = 0; i < PEG_NQ; ++i) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[i][v] = fmaf(tap[j][v], col[i + jx][v], acc[i][v]);
                if (BWD) dw[BWD ? j : 0][v] = fmaf(xq[i][v], col[i + jx][v], dw[BWD ? j : 0][v]);
              }
            }
          }
        }
      }
      const int h = h0 + r;
#pragma unroll
      for (int i = 0; i < PEG_NQ; ++i) {
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (BWD) db[v] += ctr[i][v];
          if (V == 1)  // f32: xla_peg_conv's order, then the bias
            o[v] = BWD ? acc[i][v] : acc[i][v] + bias[v];
          else if (BWD)  // bf16: lax_peg_dx's points
            o[v] = round_bf16(acc[i][v]) + ctr[i][v];
          else  // bf16: lax_peg_conv's points
            o[v] = round_bf16(round_bf16(acc[i][v]) + ctr[i][v]) + bias[v];
        }
        const int w = w0 + q0 + i;
        if (lane_ok && h < a.H && w < a.W)
          L::store(static_cast<T*>(a.out) + ((((size_t)b * a.T + t) * a.H + h) * a.W + w) * a.C + c,
                   o);
      }
    }
    __syncthreads();  // every warp is done with plane t % PEG_RING
    load_group(t + PEG_RING);
  }

  if (BWD) {  // the warps' sums in a fixed order, one partial (28, CS) a CTA
    cp_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);  // [warp][28][CS]
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int j = 0; j < 27; ++j)  // window j is the forward's tap 26 - j
        red[(warp * PEG_ROWS + 26 - j) * CS + lane * V + v] = dw[BWD ? j : 0][v];
      red[(warp * PEG_ROWS + 27) * CS + lane * V + v] = db[v];
    }
    __syncthreads();
    const size_t tile = (size_t)b * gridDim.y + blockIdx.y;
    for (int e = threadIdx.x; e < PEG_ROWS * CS; e += PEG_THREADS) {
      const int k = e / CS, cl = e % CS;
      if (c0 + cl >= a.C) continue;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < PEG_WARPS; ++w) s += red[(w * PEG_ROWS + k) * CS + cl];
      a.part[(tile * PEG_ROWS + k) * a.C + c0 + cl] = s;
    }
  }
}

template <typename T, bool BWD>
int peg_launch(const PegArgs& a, void* stream) {
  constexpr int V = PegLane<T>::V;
  if (a.C % 8 || a.B < 1 || a.T < 1 || a.H < 1 || a.W < 1 || a.th < 1 || a.tw < PEG_NQ ||
      a.tw % PEG_NQ || a.pt < 0 || a.pt > 2 || a.ph < 0 || a.ph > 2 || a.pw < 0 || a.pw > 2 ||
      a.nwt != (a.W + a.tw - 1) / a.tw)
    return (int)cudaErrorInvalidValue;
  const size_t smem = peg_smem(BWD, a.th, a.tw, V);
  const dim3 grid((a.C + 32 * V - 1) / (32 * V), (a.H + a.th - 1) / a.th * a.nwt, a.B);
  if (smem > 232448 || grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      peg_stencil_kernel<T, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  peg_stencil_kernel<T, BWD>
      <<<grid, PEG_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

PegArgs peg_args(const void* in, const void* x, const void* weight, const void* bias, void* out,
                 void* part, int B, int T, int H, int W, int C, int pt, int ph, int pw, int rot,
                 int th, int tw) {
  PegArgs a;
  a.in = in;
  a.x = x;
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.B = B, a.T = T, a.H = H, a.W = W, a.C = C;
  a.pt = pt, a.ph = ph, a.pw = pw, a.rot = rot;
  a.th = th, a.tw = tw, a.nwt = tw > 0 ? (W + tw - 1) / tw : 0;
  return a;
}

}  // namespace

// The forward: x, out (B, T, H, W, C) bf16 (ct_peg_fwd) or f32 (_f32)
// contiguous; weight (C, 27) and bias (C) f32; (pt, ph, pw) the leading pads;
// rot the rotated taps; tiles of th rows x tw columns (tw a multiple of 4).
CT_EXPORT int ct_peg_fwd(const void* x, const void* weight, const void* bias, void* out, int B,
                         int T, int H, int W, int C, int pt, int ph, int pw, int rot, int th,
                         int tw, void* stream) {
  return peg_launch<bf16, false>(
      peg_args(x, nullptr, weight, bias, out, nullptr, B, T, H, W, C, pt, ph, pw, rot, th, tw),
      stream);
}
CT_EXPORT int ct_peg_fwd_f32(const void* x, const void* weight, const void* bias, void* out,
                             int B, int T, int H, int W, int C, int pt, int ph, int pw, int rot,
                             int th, int tw, void* stream) {
  return peg_launch<float, false>(
      peg_args(x, nullptr, weight, bias, out, nullptr, B, T, H, W, C, pt, ph, pw, rot, th, tw),
      stream);
}

// K14: x, dout, dx (B, T, H, W, C) contiguous, bf16 (ct_peg_bwd) or f32
// (_f32); weight (C, 27) f32; part (B * ceil(H / th) * ceil(W / tw), 28, C)
// f32: per tile, rows 0-26 the weight taps as applied, row 27 the bias.
CT_EXPORT int ct_peg_bwd(const void* x, const void* dout, const void* weight, void* dx,
                         void* part, int B, int T, int H, int W, int C, int pt, int ph, int pw,
                         int rot, int th, int tw, void* stream) {
  return peg_launch<bf16, true>(
      peg_args(dout, x, weight, nullptr, dx, part, B, T, H, W, C, pt, ph, pw, rot, th, tw),
      stream);
}
CT_EXPORT int ct_peg_bwd_f32(const void* x, const void* dout, const void* weight, void* dx,
                             void* part, int B, int T, int H, int W, int C, int pt, int ph,
                             int pw, int rot, int th, int tw, void* stream) {
  return peg_launch<float, true>(
      peg_args(dout, x, weight, nullptr, dx, part, B, T, H, W, C, pt, ph, pw, rot, th, tw),
      stream);
}
