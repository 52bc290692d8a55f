// vq_segstats.cu — the VQ codebook's EMA statistics in segments: for each
// code k, bins[k] = the number of rows assigned to it and embed_sum[k] = the
// sum of those rows after l2 normalisation in f32, in a time that follows the
// rows and not the fullest code.
//
// Replaces ct_clip_tpu/ops/pallas/vq.py::pallas_cluster_stats (K15,
// _stats_kernel :132-165, pallas_call :180), whose one-hot product
// accumulates over the sequential grid, and vq_stats.cu, which ran it with
// one warp walking each code's rows: a code that holds thousands of rows
// (the tokens of a constant region such as a cropped volume's -1 pad, or a
// collapsed codebook) ran on one warp while the other SMs idled, and its
// scan of the (chunk, code) counts ran on one CTA.  Here:
//   1. group_rows, one cooperative launch of a CTA per SM, in phases that
//      meet at grid-wide barriers:
//      a. rank: a warp walks each chunk of CHUNK rows in order, 32 at a
//         time; __match_any_sync groups equal ids, so each row gets its rank
//         among the chunk's earlier rows of its code, and the chunk its
//         counts (chunk-major);
//      b. each code's counts are scanned over the chunks by one thread (its
//         chunks' offsets within the code, in place), giving bins and the
//         code's number of segments, max(1, ceil(bins / SEG)); each CTA adds
//         its codes' totals;
//      c. each CTA scans the CTA totals before it and its own codes: each
//         code's first row and first segment;
//      d. perm[start + offset + rank] = row: each code's rows in row order.
//   2. seg_sum: one warp per segment of at most SEG consecutive rows of a
//      code, which it l2-normalises in f32 (1 / max(|x|, 1e-12), as the JAX
//      package) and adds in row order, up to four rows in flight.  A code of
//      one segment (every code with <= SEG rows, and an empty one, which
//      writes zeros) stores its sum; otherwise each segment stores its
//      partial, the last of each GROUP consecutive segments to finish adds
//      the group's partials in order, and the last group to finish adds the
//      groups' sums in order (counters and __threadfence, the partials read
//      from L2).  The order of every addition is fixed by the segment
//      numbering, so each result is the same bit for bit from run to run
//      whichever warp finishes last.
// Two kernel launches and a 4-byte memset a call, on one workspace.
// What bounds it: memory.  At batch 8 it must read the 110,592 x 512 bf16
// rows (113 MB) and the ids and write the 8,192 x 512 f32 sums (17 MB):
// ~0.04 ms at 3.35 TB/s; step 2 reads each row once with 16-byte loads,
// and its parallelism is the number of segments, ~rows / SEG + codes.
//
// The f32-row form (_stats_kernel on f32 rows): the same, each normalised
// row added as its bf16 hi part h1 = bf16(xn) plus its lo part h2 = bf16(xn
// - h1) (exact in f32), as the TPU kernel's two bf16 one-hot products sum
// them (:149-157).  A row's sum of squares is taken in vq_stats.cu's fixed
// order (each lane its 16-byte pieces element by element, one rounded
// square and one rounded add at a time, then the warp's xor butterfly) and
// its inverse root rounded as 1 / sqrt, which ops/vq.py::_lane_inv_norm
// repeats: a norm one ulp apart flips the lo part's rounding.
#include "common.cuh"

// 1 in a one-change copy for the card checks (kernels.copy_library): the
// second segment of every code of more than one segment adds no rows, which
// the K15 checks on a crowded code must catch
#ifndef CT_VQ_SEG_DROP
#define CT_VQ_SEG_DROP 0
#endif

namespace {

constexpr int CHUNK = 1024;  // rows a warp ranks in order
constexpr int SEG = 32;      // rows of a segment
constexpr int GROUP = 32;    // segments whose partials one warp adds
constexpr int GT = 512;      // threads of a group_rows CTA
constexpr int ST = 256;      // threads of a seg_sum CTA: 8 segments

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

// The workspace, in 4-byte words: bins (codes, f32) from word 0, embed_sum
// (codes, D) f32 from word round4(codes), then the scratch below, the
// partials 16-byte aligned at the end.
struct Layout {
  long long bins, esum, barrier, rank, perm, counts, start, seg0, cnt_group, cnt_code, bsum,
      part, words;
};

int max_segments(int rows, int K) { return ceil_div(rows, SEG) + K; }

Layout layout(int rows, int D, int K, int blocks) {
  auto r4 = [](long long w) { return (w + 3) / 4 * 4; };
  Layout l;
  const long long chunks = ceil_div(rows, CHUNK), segs = max_segments(rows, K);
  l.bins = 0;
  l.esum = r4(K);
  l.barrier = l.esum + (long long)K * D;
  l.rank = l.barrier + 4;
  l.perm = l.rank + rows;
  l.counts = l.perm + rows;
  l.start = l.counts + chunks * K;
  l.seg0 = l.start + K + 1;
  l.cnt_group = l.seg0 + K + 1;
  l.cnt_code = l.cnt_group + segs;
  l.bsum = l.cnt_code + K;
  l.part = r4(l.bsum + 2LL * blocks);
  l.words = l.part + segs * D;
  return l;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

struct GroupArgs {
  const int* ids;
  int rows, K, chunks;
  int *rank, *perm, *counts, *start, *seg0, *cnt_group, *cnt_code, *bsum;
  unsigned* barrier;
  float* bins;
  int segs;
};

// every CTA of the (co-resident, cooperative) grid arrives; the counter was
// zeroed before the launch and only grows, `target` the arrivals so far
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (*reinterpret_cast<volatile unsigned*>(bar) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// exclusive sums over the CTA's threads of a and b (in thread order), and
// their totals
__device__ __forceinline__ void block_scan2(int& a, int& b, int& ta, int& tb, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xa = __shfl_up_sync(0xffffffffu, ia, o), xb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) {
    sh[warp] = ia;
    sh[32 + warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = lane < GT / 32 ? sh[lane] : 0, wb = lane < GT / 32 ? sh[32 + lane] : 0;
    const int va = wa, vb = wb;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int xa = __shfl_up_sync(0xffffffffu, wa, o), xb = __shfl_up_sync(0xffffffffu, wb, o);
      if (lane >= o) {
        wa += xa;
        wb += xb;
      }
    }
    if (lane < GT / 32) {
      sh[64 + lane] = wa - va;  // the warps before it
      sh[96 + lane] = wb - vb;
    }
    if (lane == 31) {
      sh[128] = wa;
      sh[129] = wb;
    }
  }
  __syncthreads();
  a = ia - a + sh[64 + warp];
  b = ib - b + sh[96 + warp];
  ta = sh[128];
  tb = sh[129];
  __syncthreads();
}

__global__ void __launch_bounds__(GT, 1) group_rows(GroupArgs a) {
  extern __shared__ int cursor[];  // (K,)
  __shared__ int sh[160];
  const int tid = threadIdx.x, lane = tid & 31, nb = gridDim.x;
  const int K = a.K;
  // the segment counters seg_sum counts its finished segments and groups on
  for (int i = blockIdx.x * GT + tid; i < a.segs + K; i += nb * GT) {
    if (i < a.segs)
      a.cnt_group[i] = 0;
    else
      a.cnt_code[i - a.segs] = 0;
  }

  // a. rank each chunk's rows
  for (int c = blockIdx.x; c < a.chunks; c += nb) {
    for (int k = tid; k < K; k += GT) cursor[k] = 0;
    __syncthreads();
    if (tid < 32) {
      const int r0 = c * CHUNK, r1 = min(a.rows, r0 + CHUNK);
      for (int base = r0; base < r1; base += 32) {
        const int row = base + lane;
        const int id = row < r1 ? a.ids[row] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, id);
        const int before = __popc(peers & ((1u << lane) - 1u));
        const int at = id >= 0 ? cursor[id] : 0;
        __syncwarp();
        if (id >= 0) {
          a.rank[row] = at + before;
          if (before == 0) cursor[id] = at + __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    for (int k = tid; k < K; k += GT) a.counts[(size_t)c * K + k] = cursor[k];
    __syncthreads();
  }
  grid_sync(a.barrier, nb);

  // b. this CTA's codes: each code's chunk offsets, bins and segments
  const int per = (K + nb - 1) / nb, k = blockIdx.x * per + tid;
  const bool mine = tid < per && k < K;
  int run = 0;
  if (mine) {
    for (int c0 = 0; c0 < a.chunks; c0 += 8) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = c0 + u < a.chunks ? __ldcg(a.counts + (size_t)(c0 + u) * K + k) : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (c0 + u >= a.chunks) break;
        a.counts[(size_t)(c0 + u) * K + k] = run;
        run += v[u];
      }
    }
    a.bins[k] = (float)run;
  }
  int rows_before = mine ? run : 0, segs_before = mine ? max(1, (run + SEG - 1) / SEG) : 0;
  const int own_rows = rows_before, own_segs = segs_before;
  int block_rows, block_segs;
  block_scan2(rows_before, segs_before, block_rows, block_segs, sh);
  if (tid == 0) {
    a.bsum[2 * blockIdx.x] = block_rows;
    a.bsum[2 * blockIdx.x + 1] = block_segs;
  }
  grid_sync(a.barrier, 2 * nb);

  // c. the CTAs before this one, then each code's first row and segment
  if (tid < 32) {
    int pr = 0, ps = 0;
    for (int b = lane; b < blockIdx.x; b += 32) {
      pr += __ldcg(a.bsum + 2 * b);
      ps += __ldcg(a.bsum + 2 * b + 1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      pr += __shfl_xor_sync(0xffffffffu, pr, o);
      ps += __shfl_xor_sync(0xffffffffu, ps, o);
    }
    if (lane == 0) {
      sh[130] = pr;
      sh[131] = ps;
    }
  }
  __syncthreads();
  if (mine) {
    const int s0 = sh[130] + rows_before, g0 = sh[131] + segs_before;
    a.start[k] = s0;
    a.seg0[k] = g0;
    if (k == K - 1) {
      a.start[K] = s0 + own_rows;
      a.seg0[K] = g0 + own_segs;
    }
  }
  grid_sync(a.barrier, 3 * nb);

  // d. place each row
  for (int row = blockIdx.x * GT + tid; row < a.rows; row += nb * GT) {
    const int id = a.ids[row];
    a.perm[__ldcg(a.start + id) + __ldcg(a.counts + (size_t)(row / CHUNK) * K + id)
           + __ldcg(a.rank + row)] = row;
  }
}

// A lane's share of a row: pieces lane, lane + 32, ... of 16 bytes
template <typename T, int NP>
struct Row {
  uint4 p[NP];
};

template <typename T, int NP>
__device__ __forceinline__ void load_row(Row<T, NP>& r, const T* row, int D, int lane) {
  constexpr int EPP = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const int c = (lane + 32 * u) * EPP;
    r.p[u] = c < D ? *reinterpret_cast<const uint4*>(row + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the lane's part of the row's sum of squares, in vq_stats.cu's order
template <int NP>
__device__ __forceinline__ float squares(const Row<bf16, NP>& r) {
  float ss = 0.0f;
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const bf162* h = reinterpret_cast<const bf162*>(&r.p[u]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
  return ss;
}
template <int NP>
__device__ __forceinline__ float squares(const Row<float, NP>& r) {
  float ss = 0.0f;
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const float* f = reinterpret_cast<const float*>(&r.p[u]);
    // one rounded square and one rounded add per element, in this order (no
    // contraction), so ops/vq.py::_lane_inv_norm can follow it
#pragma unroll
    for (int e = 0; e < 4; ++e) ss = __fadd_rn(ss, __fmul_rn(f[e], f[e]));
  }
  return ss;
}

// acc += the row normalised by its warp-wide sum of squares ss
template <int NP>
__device__ __forceinline__ void add_row(float (&acc)[NP * 8], const Row<bf16, NP>& r, float ss) {
  const float inv = rsqrtf(fmaxf(ss, 1e-24f));
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const bf162* h = reinterpret_cast<const bf162*>(&r.p[u]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      acc[8 * u + 2 * e] = fmaf(f.x, inv, acc[8 * u + 2 * e]);
      acc[8 * u + 2 * e + 1] = fmaf(f.y, inv, acc[8 * u + 2 * e + 1]);
    }
  }
}
template <int NP>
__device__ __forceinline__ void add_row(float (&acc)[NP * 4], const Row<float, NP>& r, float ss) {
  // a rounded sqrt and division (rsqrtf's error is not PyTorch's)
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(ss, 1e-24f)));
#pragma unroll
  for (int u = 0; u < NP; ++u) {
    const float* f = reinterpret_cast<const float*>(&r.p[u]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float xn = __fmul_rn(f[e], inv);
      const float h1 = bf2f(f2bf(xn));
      acc[4 * u + e] += h1 + bf2f(f2bf(xn - h1));
    }
  }
}

// the lane's columns of a (D,) f32 row: pieces of EPP floats at (lane + 32 u) EPP
template <int E, int EPP>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[E], int D, int lane,
                                          bool to_l2) {
#pragma unroll
  for (int u = 0; u < E / EPP; ++u) {
    const int c = (lane + 32 * u) * EPP;
    if (c >= D) continue;
#pragma unroll
    for (int e = 0; e < EPP; e += 4) {
      const float4 v = make_float4(acc[EPP * u + e], acc[EPP * u + e + 1], acc[EPP * u + e + 2],
                                   acc[EPP * u + e + 3]);
      float4* p = reinterpret_cast<float4*>(dst + c + e);
      if (to_l2)
        __stcg(p, v);
      else
        *p = v;
    }
  }
}

// acc = the sum, in order, of the partial rows first, first + step, ...
// (n of them), read from L2
template <int E, int EPP>
__device__ __forceinline__ void add_partials(float (&acc)[E], const float* part, long long first,
                                             int step, int n, int D, int lane) {
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
    const float* src = part + (first + (long long)t * step) * D;
#pragma unroll
    for (int u = 0; u < E / EPP; ++u) {
      const int c = (lane + 32 * u) * EPP;
      if (c >= D) continue;
#pragma unroll
      for (int e = 0; e < EPP; e += 4) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + c + e));
        acc[EPP * u + e] += v.x;
        acc[EPP * u + e + 1] += v.y;
        acc[EPP * u + e + 2] += v.z;
        acc[EPP * u + e + 3] += v.w;
      }
    }
  }
}

// one warp per segment (module note, step 2); NP 16-byte pieces a lane: D <=
// 32 NP 16 / sizeof(T)
template <typename T, int NP>
__global__ void __launch_bounds__(ST) seg_sum(const T* __restrict__ x, int D,
                                              const int* __restrict__ perm,
                                              const int* __restrict__ start,
                                              const int* __restrict__ seg0, int K,
                                              float* __restrict__ esum, float* part,
                                              int* cnt_group, int* cnt_code) {
  constexpr int EPP = 16 / sizeof(T), E = NP * EPP;
  constexpr int FLIGHT = NP * sizeof(T) <= 16 ? 4 : 2;  // rows in flight
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (ST / 32) + (threadIdx.x >> 5);
  if (s >= seg0[K]) return;
  int lo = 0, hi = K;  // seg0[lo] <= s < seg0[hi]; every code has a segment
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (seg0[mid] <= s)
      lo = mid;
    else
      hi = mid;
  }
  const int k = lo, first = seg0[k], nk = seg0[k + 1] - first, j = s - first;
  const int b0 = start[k], b = start[k + 1] - b0;
  const int r0 = b0 + j * SEG;
  int r1 = b0 + min(b, (j + 1) * SEG);
  if (CT_VQ_SEG_DROP && nk > 1 && j == 1) r1 = r0;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  for (int r = r0; r < r1; r += FLIGHT) {
    Row<T, NP> rows[FLIGHT];
    float ss[FLIGHT];
#pragma unroll
    for (int f = 0; f < FLIGHT; ++f)
      if (r + f < r1) load_row(rows[f], x + (size_t)perm[r + f] * D, D, lane);
#pragma unroll
    for (int f = 0; f < FLIGHT; ++f) ss[f] = r + f < r1 ? squares(rows[f]) : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int f = 0; f < FLIGHT; ++f) ss[f] += __shfl_xor_sync(0xffffffffu, ss[f], o);
#pragma unroll
    for (int f = 0; f < FLIGHT; ++f)
      if (r + f < r1) add_row(acc, rows[f], ss[f]);
  }
  if (nk == 1) {
    store_acc<E, EPP>(esum + (size_t)k * D, acc, D, lane, false);
    return;
  }
  // the segment's partial; the last of its group to finish adds the group's
  store_acc<E, EPP>(part + (size_t)s * D, acc, D, lane, true);
  __threadfence();
  __syncwarp();
  const int g = j / GROUP, head = first + g * GROUP, gsize = min(GROUP, nk - g * GROUP);
  int done = 0;
  if (lane == 0) done = atomicAdd(cnt_group + head, 1);
  if (__shfl_sync(0xffffffffu, done, 0) != gsize - 1) return;
  __threadfence();
  add_partials<E, EPP>(acc, part, head, 1, gsize, D, lane);
  const int ng = (nk + GROUP - 1) / GROUP;
  if (ng == 1) {
    store_acc<E, EPP>(esum + (size_t)k * D, acc, D, lane, false);
    return;
  }
  // the group's sum in its first slot; the last group to finish adds the code's
  store_acc<E, EPP>(part + (size_t)head * D, acc, D, lane, true);
  __threadfence();
  __syncwarp();
  if (lane == 0) done = atomicAdd(cnt_code + k, 1);
  if (__shfl_sync(0xffffffffu, done, 0) != ng - 1) return;
  __threadfence();
  add_partials<E, EPP>(acc, part, first, GROUP, ng, D, lane);
  store_acc<E, EPP>(esum + (size_t)k * D, acc, D, lane, false);
}

template <typename T>
cudaError_t seg_stats(const T* x, const void* ids, int rows, int D, int K, void* ws,
                      cudaStream_t st) {
  constexpr int EPP = 16 / sizeof(T);
  const int blocks = sm_count();
  if (D % EPP || D > 1024 || K < 1 || rows < 1 || !blocks || K > blocks * GT
      || (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(ws) & 15))
    return cudaErrorInvalidValue;
  const Layout l = layout(rows, D, K, blocks);
  int* w = static_cast<int*>(ws);
  GroupArgs a;
  a.ids = static_cast<const int*>(ids);
  a.rows = rows;
  a.K = K;
  a.chunks = ceil_div(rows, CHUNK);
  a.rank = w + l.rank;
  a.perm = w + l.perm;
  a.counts = w + l.counts;
  a.start = w + l.start;
  a.seg0 = w + l.seg0;
  a.cnt_group = w + l.cnt_group;
  a.cnt_code = w + l.cnt_code;
  a.bsum = w + l.bsum;
  a.barrier = reinterpret_cast<unsigned*>(w + l.barrier);
  a.bins = reinterpret_cast<float*>(w + l.bins);
  a.segs = max_segments(rows, K);
  const size_t smem = (size_t)K * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(group_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(a.barrier, 0, sizeof(unsigned), st)) != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)group_rows, dim3(blocks), dim3(GT), args, smem,
                                    st);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(a.segs, ST / 32));
  float* esum = reinterpret_cast<float*>(w + l.esum);
  float* part = reinterpret_cast<float*>(w + l.part);
  constexpr int NP = 512 / 32 / EPP;  // pieces a lane at D <= 512, twice that up to 1,024
  if (D > 512)
    seg_sum<T, 2 * NP><<<grid, ST, 0, st>>>(x, D, a.perm, a.start, a.seg0, K, esum, part,
                                             a.cnt_group, a.cnt_code);
  else
    seg_sum<T, NP><<<grid, ST, 0, st>>>(x, D, a.perm, a.start, a.seg0, K, esum, part,
                                         a.cnt_group, a.cnt_code);
  return cudaGetLastError();
}

}  // namespace

// The workspace of ct_vq_seg_stats for these shapes, in 4-byte words: bins
// (K,) f32 at word 0, embed_sum (K, D) f32 from word ceil(K / 4) * 4, then
// its scratch.
CT_EXPORT long long ct_vq_seg_stats_words(int rows, int D, int K) {
  return layout(rows, D, K, sm_count()).words;
}

// x (rows, D) bf16 contiguous, D % 8 == 0 and D <= 1024, ids (rows,) int32
// in [0, K), ws 16-byte aligned of ct_vq_seg_stats_words(rows, D, K) words;
// out: bins and embed_sum in ws.
CT_EXPORT int ct_vq_seg_stats(const void* x, const void* ids, int rows, int D, int K, void* ws,
                              void* stream) {
  return (int)seg_stats(static_cast<const bf16*>(x), ids, rows, D, K, ws,
                        static_cast<cudaStream_t>(stream));
}

// The f32-row form: x (rows, D) f32 contiguous, D % 4 == 0 and D <= 1024.
CT_EXPORT int ct_vq_seg_stats_f32(const void* x, const void* ids, int rows, int D, int K,
                                  void* ws, void* stream) {
  return (int)seg_stats(static_cast<const float*>(x), ids, rows, D, K, ws,
                        static_cast<cudaStream_t>(stream));
}
