// vq_stats.cu — the VQ codebook's EMA statistics: for each code k, bins[k]
// = the number of rows assigned to it and embed_sum[k] = the sum of those
// rows after l2 normalisation in f32.
//
// Replaces ct_clip_tpu/ops/pallas/vq.py::pallas_cluster_stats (K15,
// _stats_kernel :132-165), whose one-hot product accumulates over the
// sequential grid.  On the H100 that one-hot product would be 8192 x 512 x
// 110592 multiply-adds of which all but one in 8192 are by zero; here the
// rows are grouped by code instead, and each code's rows are summed in row
// order, so the result does not change from run to run:
//   1. rank: one warp per chunk of CHUNK rows walks them in order, 32 at a
//      time; __match_any_sync groups equal ids, so each row gets its rank
//      among the chunk's earlier rows of its code and the chunk its counts;
//   2. scan: one block turns the (chunk, code) counts into each chunk's
//      offset within its code, writes bins and each code's start;
//   3. place: perm[start + offset + rank] = row;
//   4. sum: one warp per code walks its rows in order, l2-normalises each
//      in f32 (1 / max(|x|, 1e-12), as the JAX package) and adds it.
// What bounds it: memory.  At batch 8 it must read the 110592 x 512 bf16
// rows (113 MB) and the ids and write the 8192 x 512 f32 sums (17 MB):
// ~0.04 ms at 3.35 TB/s.  Step 4 reads each row once, with 16-byte loads.
#include "common.cuh"

namespace {

constexpr int CHUNK = 1024;
constexpr int SCAN_THREADS = 1024;

__global__ void __launch_bounds__(32)
rank_kernel(const int* __restrict__ ids, int rows, int K, int* __restrict__ rank,
            int* __restrict__ counts) {
  extern __shared__ int cursor[];  // (K,)
  const int lane = threadIdx.x;
  for (int k = lane; k < K; k += 32) cursor[k] = 0;
  __syncwarp();
  const int r0 = blockIdx.x * CHUNK, r1 = min(rows, r0 + CHUNK);
  for (int base = r0; base < r1; base += 32) {
    const int row = base + lane;
    const int id = row < r1 ? ids[row] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const int before = __popc(peers & ((1u << lane) - 1u));
    const int start = id >= 0 ? cursor[id] : 0;
    __syncwarp();
    if (id >= 0) {
      rank[row] = start + before;
      if (before == 0) cursor[id] = start + __popc(peers);
    }
    __syncwarp();
  }
  for (int k = lane; k < K; k += 32) counts[(size_t)blockIdx.x * K + k] = cursor[k];
}

// counts (chunks, K) -> each chunk's offset within its code (in place);
// bins (K,) f32; start (K,) the code's first slot in perm.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int* __restrict__ counts, int chunks, int K, float* __restrict__ bins,
            int* __restrict__ start) {
  __shared__ int tot[SCAN_THREADS];
  const int per = (K + SCAN_THREADS - 1) / SCAN_THREADS;
  const int k0 = threadIdx.x * per, k1 = min(K, k0 + per);
  int mine = 0;
  for (int k = k0; k < k1; ++k) {
    int run = 0;
    for (int c = 0; c < chunks; ++c) {
      const int v = counts[(size_t)c * K + k];
      counts[(size_t)c * K + k] = run;
      run += v;
    }
    bins[k] = (float)run;
    start[k] = run;  // the code's total until the scan below
    mine += run;
  }
  tot[threadIdx.x] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive scan of the thread totals, in order
    int run = 0;
    for (int t = 0; t < SCAN_THREADS; ++t) {
      const int v = tot[t];
      tot[t] = run;
      run += v;
    }
  }
  __syncthreads();
  int run = tot[threadIdx.x];
  for (int k = k0; k < k1; ++k) {
    const int v = start[k];
    start[k] = run;
    run += v;
  }
}

__global__ void place_kernel(const int* __restrict__ ids, const int* __restrict__ rank,
                             const int* __restrict__ offsets, const int* __restrict__ start,
                             int rows, int K, int* __restrict__ perm) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int id = ids[row];
  perm[start[id] + offsets[(size_t)(row / CHUNK) * K + id] + rank[row]] = row;
}

// one warp per code; D % 8 == 0 and D <= 1024 (each lane holds D / 32 sums)
__global__ void sum_kernel(const bf16* __restrict__ x, int D, const int* __restrict__ perm,
                           const int* __restrict__ start, const float* __restrict__ bins,
                           int K, float* __restrict__ embed_sum) {
  const int k = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (k >= K) return;
  float acc[32];
#pragma unroll
  for (int u = 0; u < 32; ++u) acc[u] = 0.0f;
  const int s0 = start[k], cnt = (int)bins[k];
  for (int r = 0; r < cnt; ++r) {
    const bf16* row = x + (size_t)perm[s0 + r] * D;
    float v[32];
    float ss = 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // 16-byte pieces: lane + 32 u of D / 8
      const int c = (lane + 32 * u) * 8;
      if (c < D) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
        const bf162* h = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          v[8 * u + 2 * e] = f.x;
          v[8 * u + 2 * e + 1] = f.y;
          ss += f.x * f.x + f.y * f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[8 * u + e] = 0.0f;
      }
    }
    const float inv = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
#pragma unroll
    for (int u = 0; u < 32; ++u) acc[u] = fmaf(v[u], inv, acc[u]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = (lane + 32 * u) * 8;
    if (c < D)
#pragma unroll
      for (int e = 0; e < 8; ++e) embed_sum[(size_t)k * D + c + e] = acc[8 * u + e];
  }
}

}  // namespace

// x (rows, D) bf16 contiguous, ids (rows,) int32 in [0, K); scratch:
// rank (rows,), counts (ceil(rows / 1024), K), start (K,), perm (rows,)
// int32; out: bins (K,) and embed_sum (K, D) f32.
CT_EXPORT int ct_vq_cluster_stats(const void* x, const void* ids, int rows, int D, int K,
                                  void* rank, void* counts, void* start, void* perm,
                                  void* bins, void* embed_sum, void* stream) {
  if (D % 8 || D > 1024 || K < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (rows + CHUNK - 1) / CHUNK;
  const size_t cursor_bytes = (size_t)K * sizeof(int);
  if (cursor_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cursor_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int* id = static_cast<const int*>(ids);
  int *rk = static_cast<int*>(rank), *cn = static_cast<int*>(counts),
      *st = static_cast<int*>(start), *pm = static_cast<int*>(perm);
  float* bn = static_cast<float*>(bins);
  rank_kernel<<<chunks, 32, cursor_bytes, s>>>(id, rows, K, rk, cn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(cn, chunks, K, bn, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  place_kernel<<<(rows + 255) / 256, 256, 0, s>>>(id, rk, cn, st, rows, K, pm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_kernel<<<(K + 7) / 8, 256, 0, s>>>(static_cast<const bf16*>(x), D, pm, st, bn, K,
                                        static_cast<float*>(embed_sum));
  return (int)cudaGetLastError();
}
