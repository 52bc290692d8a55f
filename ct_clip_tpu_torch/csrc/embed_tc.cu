// embed_tc.cu — the bf16 patch embed on the Hopper tensor cores: each patch
// row LayerNorm(patch_dim) -> x W^T + b -> LayerNorm(dim), one `wgmma`
// (sm_90a) kernel that normalises its operand tiles in shared memory, so the
// normalised rows never reach device memory.
//
// Replaces, in bf16, ct_clip_tpu/ops/pallas/patchify.py::_pallas_row_embed
// (K4, :609, pallas_call :621, body _rows_kernel :479 -> _rows_embed_math
// :461-476) on contiguous patch rows and ::_pallas_patch_embed (K8, :341,
// pallas_call :356, body _embed_kernel :249-266, the patch gather
// _embed_shuffle :237-246) on the (b, F, H, W) volume, which the port ran as
// three passes: layernorm.cu's LN(patch_dim) writing the normalised rows
// (221 MB of bf16 at zero-shot's 27,648 x 4,000), gemm.cu's WMMA product
// reading them back, and layernorm.cu's block-a-row LN(dim) (those stay for
// K16b's backward).  The rounding points
// are the TPU kernel's (:465-476):
//   1. mean and var over patch_dim in f32, two passes;
//   2. xn = bf16(((x - mean) rstd) s1 + b1), each operation rounded alone;
//   3. y = xn W^T in f32;
//   4. yb = bf16(bf16(y) + bf16(pbias));
//   5. out = bf16(((yb - mean2) rstd2) s2 + b2), LN(dim) in f32.
//
// What bounds it on the H100.  At zero-shot's 27,648 rows the product is 113
// GFLOP, 0.1145 ms at 989 TFLOP/s, against 221 MB of rows, 4 MB of W and 28
// MB out (0.076 ms at 3.35 TB/s): the tensor cores.  The statistics need
// the whole row before the first product, so a pre-pass reads the rows once
// more (0.066 ms of bytes).  Each CTA streams all of W's k blocks through
// its shared memory, and that stream of tiles into each SM, not the
// products, sets the pace (PERF.md: the copies alone take ~86% of
// the kernel's time).
//
// Design:
//   * embed_stats (its own launch, first): one warp a row, (mean, rstd) in
//     f32 into (M, 2) stats; 16-byte loads of contiguous rows, or 8-byte
//     runs through the patch gather (p % 4 == 0 and W % 4 == 0: 4 columns
//     from a multiple of 4 lie side by side in one p-wide row of the patch),
//     the run offsets in a shared table.  Its XN form writes the normalised
//     rows too: the recompute of the row embed's backward (K16b), whose
//     products run on ffn_tc.cu.
//   * embed_tc_kernel: one CTA a 64-row x 512-column tile, whole rows of
//     the output, for LN(dim) in the epilogue: a producer warpgroup and two
//     consumer warpgroups of 256 columns each (m64n256k16), the producer's
//     registers handed to the consumers (setmaxnreg).  The producer copies
//     each 64-wide k block of the raw rows and of W (K-major, 64-row x
//     128-byte atoms with the 128-byte swizzle) into a ring of stages: the
//     rows by TMA (K4), or gathered from the volume by the warpgroup's
//     8-byte cp.async copies (K8); W by TMA; the k block's s1 and b1 by a
//     bulk copy into a small ring beside it.  The consumer threads rewrite
//     16-byte chunks of the stage's row atom in place as xn, from their
//     rows' stats and the slot's s1, b1, fence the generic writes for the
//     async proxy, and after a named barrier each warpgroup issues its
//     products while the next stage is normalised.  patch_dim need not be a
//     multiple of 64 (4,000 = 62 x 64 + 32): the copies zero-fill past it,
//     the last k block copies only patch_dim's s1 and b1, and the normalise
//     writes 0 past patch_dim (not b1 - mean rstd s1).  The row sums of
//     LN(dim) cross the two warpgroups through shared memory in a fixed
//     order.
//   A 128 x 256 tile (a third fewer bytes into each SM a product, yb stored,
//   then a LN(dim) pass) ran the K4 product as fast and K8's more than twice
//   as long (its 8-byte gathers thrash L1), and a cluster sharing W's tiles
//   by TMA multicast ran no faster (PERF.md).
#include "common.cuh"
#include "tma.cuh"

// 1 in a one-change copy for the card checks (kernels.copy_library): the bias
// added to the f32 y before one rounding, yb = bf16(y + pbias), which the
// mean check must catch
#ifndef CT_EMBED_TC_ONE_ROUNDING
#define CT_EMBED_TC_ONE_ROUNDING 0
#endif

namespace {

constexpr int ATOM = TC_TILE * 128;  // one swizzled atom: 64 rows of 128 bytes
constexpr int CWG = 2;               // consumer warpgroups, 256 columns each
constexpr int NT = 128 * CWG + 128;  // + the producer warpgroup
constexpr int BN = 256 * CWG;        // output columns of a CTA: the widest dim
constexpr int B_ATOMS = BN / TC_TILE;
constexpr int STAGE = (1 + B_ATOMS) * ATOM;  // the row atom, then W's
constexpr int STAGES = 3;
constexpr int SMEM = 1024 + STAGES * STAGE;
constexpr int MAX_K = 4096;          // patch_dim: the stats pass keeps a row in registers
// registers a thread: the producer warpgroup gives back what the consumers'
// 128 accumulators a thread take (64,512 of the SM's 65,536 in all)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;

// [d0 | d1 | d2 | d3] += A B: m64 n256 k16, A and B K-major in shared memory,
// B's 256 rows four swizzled atoms side by side; d[j] takes columns 64 j ..
// 64 j + 63, each in the n64 accumulator layout
__device__ __forceinline__ void mma256(float (&d)[4][32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT(d[0]), WG_OUT(d[1]), WG_OUT(d[2]), WG_OUT(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void hold4(float (&d)[4][32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) hold(d[j]);
}

// a barrier among `n` threads of the block under barrier `id` (0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(saddr(bar)) : "memory");
}

// a bf16 pair, normalised as the TPU kernel does (:465-469): every product
// and sum rounded alone (no fused multiply-add), then rounded to bf16
__device__ __forceinline__ uint32_t norm2(uint32_t v, float mean, float rstd, float s0, float s1,
                                          float b0, float b1) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v));
  const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x.x, mean), rstd), s0), b0);
  const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x.y, mean), rstd), s1), b1);
  return pack_bf16(y0, y1);
}

// ----------------------------------------------------------- the row stats
// (mean, rstd) of each row in f32, two passes over registers: rows x[row *
// ldx + k] (GATHER false) or the patch rows of the volume x (GATHER true).
// One warp a row, the rows strided over the grid.  XN (rows only): K16b's
// recompute (patchify.py::_pallas_row_embed_bwd, K16b, :637, body
// _rows_bwd_kernel :487-549) also writes xn = bf16(((x - mean) rstd) s1 +
// b1), rounded as the product's normalise (norm2) rounds it, so xn is the
// forward's bit for bit; s1 and b1 (K,) f32, 16-byte aligned, xn row
// stride ldn; stats may be null (the row backward that follows with
// d(rows) takes its own).
template <bool GATHER, bool XN>
__global__ void __launch_bounds__(256) embed_stats(const bf16* __restrict__ x, int ldx,
                                                   PatchGeom g, int M, int K, float eps,
                                                   float* __restrict__ stats,
                                                   const float* __restrict__ s1,
                                                   const float* __restrict__ b1,
                                                   bf16* __restrict__ xn, int ldn) {
  constexpr int RUNS = GATHER ? MAX_K / 4 / 32 : MAX_K / 8 / 32;  // a lane's loads
  __shared__ int offs[GATHER ? MAX_K / 4 : 1];  // run j of a patch row at offs[j]
  if (GATHER) {
    for (int j = threadIdx.x; j < K / 4; j += blockDim.x) offs[j] = patch_elem_offset(g, 4 * j);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, n = GATHER ? K / 4 : K / 8;
  for (size_t row = (size_t)blockIdx.x * 8 + (threadIdx.x >> 5); row < (size_t)M;
       row += (size_t)gridDim.x * 8) {
    uint32_t v[RUNS][GATHER ? 2 : 4];
    float s = 0.0f;
    const size_t base = GATHER ? patch_row_base(g, row) : row * (size_t)ldx;
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      const int j = lane + 32 * i;
#pragma unroll
      for (int u = 0; u < (GATHER ? 2 : 4); ++u) v[i][u] = 0u;
      if (j >= n) continue;
      if (GATHER) {
        const uint2 t = *reinterpret_cast<const uint2*>(x + base + offs[j]);
        v[i][0] = t.x;
        v[i][1] = t.y;
      } else {
        const uint4 t = *reinterpret_cast<const uint4*>(x + base + 8 * j);
        v[i][0] = t.x;
        v[i][1] = t.y;
        v[i][2] = t.z;
        v[i][3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < (GATHER ? 2 : 4); ++u) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v[i][u]));
        s += f.x;
        s += f.y;
      }
    }
    const float mean = warp_sum(s) / K;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < RUNS; ++i) {
      if (lane + 32 * i >= n) continue;
#pragma unroll
      for (int u = 0; u < (GATHER ? 2 : 4); ++u) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v[i][u]));
        const float c0 = f.x - mean, c1 = f.y - mean;
        q += c0 * c0;
        q += c1 * c1;
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / K + eps);
    if (lane == 0 && (!XN || stats))
      *reinterpret_cast<float2*>(stats + 2 * row) = make_float2(mean, rstd);
    if constexpr (XN && !GATHER) {
#pragma unroll
      for (int i = 0; i < RUNS; ++i) {
        const int j = lane + 32 * i;
        if (j >= n) continue;
        const float4* sp = reinterpret_cast<const float4*>(s1 + 8 * j);
        const float4* bp = reinterpret_cast<const float4*>(b1 + 8 * j);
        const float4 sl = sp[0], sh = sp[1], bl = bp[0], bh = bp[1];
        uint4 o;
        o.x = norm2(v[i][0], mean, rstd, sl.x, sl.y, bl.x, bl.y);
        o.y = norm2(v[i][1], mean, rstd, sl.z, sl.w, bl.z, bl.w);
        o.z = norm2(v[i][2], mean, rstd, sh.x, sh.y, bh.x, bh.y);
        o.w = norm2(v[i][3], mean, rstd, sh.z, sh.w, bh.z, bh.w);
        *reinterpret_cast<uint4*>(xn + row * (size_t)ldn + 8 * j) = o;
      }
    }
  }
}

// ------------------------------------------------------------- the product
struct EmbedMaps {
  CUtensorMap x, w;  // x unused when the rows are gathered from the volume
};
struct EmbedArgs {
  const bf16* video;   // the volume (GATHER)
  PatchGeom g;
  const float *s1, *b1;  // (K,) f32
  const float* stats;  // (M, 2) f32 (mean, rstd)
  const bf16* pbias;   // (N,)
  const float *s2, *b2;
  float eps;
  bf16* out;           // (M, N)
  int M, N, K;
};

// The bytes of s1 and b1 in the k block from k0: up to K (a multiple of 8,
// so a multiple of 32 bytes)
__device__ __forceinline__ int sb_bytes(const EmbedArgs& a, int k0) {
  return 2 * 4 * min(TC_TILE, a.K - k0);
}

// The k block's W atoms (rows 64 b .., columns k0 ..) and its s1 and b1 (the
// columns below K) into stage `dst` and its slot of the small ring,
// completing on bar.
__device__ __forceinline__ void load_w_sb(const EmbedMaps& maps, const EmbedArgs& a, uint32_t dst,
                                          float* slot, int k0, uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < B_ATOMS; ++b) tma_load(dst + (1 + b) * ATOM, &maps.w, k0, TC_TILE * b, bar);
  const int half = sb_bytes(a, k0) / 2;
  bulk_copy(saddr(slot), a.s1 + k0, half, bar);
  bulk_copy(saddr(slot + TC_TILE), a.b1 + k0, half, bar);
}

// The producer of the volume form: the warpgroup's thread pt copies the 4
// columns 4 (pt % 16) .. of each k block for the tile's rows pt / 16 + 8 i
// (8-byte cp.async, zero past M and K) and arrives on the stage's barrier
// once they land; thread 0 also expects the stage's other bytes and copies
// them.
__device__ __forceinline__ void gather_producer(const EmbedMaps& maps, const EmbedArgs& a,
                                                uint8_t* ring, float* sbr, uint64_t* full,
                                                uint64_t* empty, int m0, int kblocks) {
  constexpr int RN = TC_TILE / 8;  // rows a thread copies
  const int pt = threadIdx.x - 128 * CWG, j = pt & 15, r0 = pt >> 4;
  size_t base[RN];
  uint32_t rows_ok = 0;
#pragma unroll
  for (int i = 0; i < RN; ++i) {
    const int m = m0 + r0 + 8 * i;
    base[i] = m < a.M ? patch_row_base(a.g, m) : 0;
    rows_ok |= (uint32_t)(m < a.M) << i;
  }
  for (int kb = 0; kb < kblocks; ++kb) {
    const int st = kb % STAGES, k0 = kb * TC_TILE;
    if (kb >= STAGES) bar_wait(&empty[st], (kb / STAGES - 1) & 1);
    const uint32_t s0 = saddr(ring + st * STAGE);
    if (pt == 0) {
      bar_expect(&full[st], B_ATOMS * ATOM + sb_bytes(a, k0));
      load_w_sb(maps, a, s0, sbr + st * 2 * TC_TILE, k0, &full[st]);
    }
    const int e = k0 + 4 * j;
    const bool k_ok = e < a.K;
    const size_t eo = k_ok ? patch_elem_offset(a.g, e) : 0;
#pragma unroll
    for (int i = 0; i < RN; ++i) {
      const int r = r0 + 8 * i;
      const bool ok = k_ok && (rows_ok >> i & 1);
      const uint32_t dst = s0 + r * 128 + ((((j >> 1) ^ (r & 7)) << 4) | ((j & 1) << 3));
      cp8(dst, a.video + (ok ? base[i] + eo : 0), ok ? 8 : 0);
    }
    bar_arrive_copies(&full[st]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The rows' producer: one thread copies each k block's row atom by TMA and
// the rest of the stage, expecting all of its bytes.
__device__ __forceinline__ void rows_producer(const EmbedMaps& maps, const EmbedArgs& a,
                                              uint8_t* ring, float* sbr, uint64_t* full,
                                              uint64_t* empty, int m0, int kblocks) {
  for (int kb = 0; kb < kblocks; ++kb) {
    const int st = kb % STAGES, k0 = kb * TC_TILE;
    if (kb >= STAGES) bar_wait(&empty[st], (kb / STAGES - 1) & 1);
    const uint32_t dst = saddr(ring + st * STAGE);
    bar_expect(&full[st], STAGE + sb_bytes(a, k0));
    tma_load(dst, &maps.x, k0, m0, &full[st]);
    load_w_sb(maps, a, dst, sbr + st * 2 * TC_TILE, k0, &full[st]);
  }
}

// The consumers: warpgroup wg takes the output columns 256 wg ..; both
// normalise the stage's one row atom together, a thread 16-byte chunks (8
// columns) of two rows, in place, from the rows' stats and the stage's slot
// of s1, b1 (0 past K, where the slot holds no s1, b1), then a proxy fence
// and a named barrier before the products read them.  Then yb and LN(dim) on
// the accumulators.
__device__ __forceinline__ void consume(const EmbedArgs& a, uint8_t* ring, const float* sbr,
                                        uint64_t* full, uint64_t* empty,
                                        float (&red)[2][CWG][TC_TILE], int m0, int kblocks) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int q4 = lane & 3, c = threadIdx.x & 7;
  constexpr int RI = TC_TILE / (128 * CWG / 8);  // rows a thread normalises
  float mean[RI], rstd[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int m = m0 + (threadIdx.x >> 3) + (128 * CWG / 8) * i;
    const float2 st = m < a.M ? *reinterpret_cast<const float2*>(a.stats + 2 * (size_t)m)
                              : make_float2(0.0f, 0.0f);
    mean[i] = st.x;
    rstd[i] = st.y;
  }
  float d[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) d[j][e] = 0.0f;

  for (int kb = 0; kb < kblocks; ++kb) {
    const int st = kb % STAGES;
    uint8_t* stage = ring + st * STAGE;
    const float4* sb = reinterpret_cast<const float4*>(sbr + st * 2 * TC_TILE + 8 * c);
    bar_wait(&full[st], (kb / STAGES) & 1);
    const bool in_k = kb * TC_TILE + 8 * c < a.K;  // the chunk's 8 columns (K % 8 == 0)
    const float4 sl = sb[0], sh = sb[1], bl = sb[TC_TILE / 4], bh = sb[TC_TILE / 4 + 1];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = (threadIdx.x >> 3) + (128 * CWG / 8) * i;
      uint4* p = reinterpret_cast<uint4*>(stage + r * 128 + ((c ^ (r & 7)) << 4));
      uint4 v = *p;
      v.x = norm2(v.x, mean[i], rstd[i], sl.x, sl.y, bl.x, bl.y);
      v.y = norm2(v.y, mean[i], rstd[i], sl.z, sl.w, bl.z, bl.w);
      v.z = norm2(v.z, mean[i], rstd[i], sh.x, sh.y, bh.x, bh.y);
      v.w = norm2(v.w, mean[i], rstd[i], sh.z, sh.w, bh.z, bh.w);
      if (!in_k) v = make_uint4(0u, 0u, 0u, 0u);
      *p = v;
    }
    // the generic writes, visible to the products' async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(2, 128 * CWG);
    const uint32_t at = saddr(stage), bt = at + (1 + 4 * wg) * ATOM;
    hold4(d);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma256(d, desc(at + 32 * kk), desc(bt + 32 * kk));
    wg_commit();
    wg_wait1();  // the previous k block's products are done: free its stage
    hold4(d);
    if (kb > 0) bar_arrive(&empty[(kb - 1) % STAGES]);
  }
  wg_wait();
  hold4(d);

  // yb = bf16(bf16(y) + bias), as the TPU kernel rounds it (:471); element
  // (j, e) of a thread: row rl + 8 acc_hi(e), column cb + 64 j + acc_col(e)
  const int rl = 16 * warp + (lane >> 2), r = m0 + rl, cb = 256 * wg;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = cb + 64 * j + acc_col(e, q4);
      const float pb = col < a.N ? bf2f(a.pbias[col]) : 0.0f;
      d[j][e] = col >= a.N ? 0.0f
                : CT_EMBED_TC_ONE_ROUNDING ? round_bf16(d[j][e] + pb)
                                           : round_bf16(round_bf16(d[j][e]) + pb);
    }

  // LN(dim) of rows rl and rl + 8 over both warpgroups' columns; each sum in
  // a fixed order: the thread's 64 columns, its quad, then warpgroup 0's
  // half + warpgroup 1's
  float mu[2] = {0.0f, 0.0f}, rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int col = cb + 64 * j + acc_col(e, q4);
        const float v = pass ? d[j][e] - mu[acc_hi(e)] : d[j][e];
        if (col < a.N) s[acc_hi(e)] += pass ? v * v : v;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      if (q4 == 0) red[pass][wg][rl + 8 * h] = s[h];
    }
    named_sync(1, 128 * CWG);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float t = (red[pass][0][rl + 8 * h] + red[pass][1][rl + 8 * h]) / a.N;
      if (pass)
        rs[h] = rsqrtf(t + a.eps);
      else
        mu[h] = t;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int h = acc_hi(e), gm = r + 8 * h, gn = cb + 64 * j + acc_col(e, q4);
      if (gm >= a.M || gn >= a.N) continue;  // N is even: gn + 1 < N with gn
      const float o0 =
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(d[j][e], mu[h]), rs[h]), a.s2[gn]), a.b2[gn]);
      const float o1 = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(d[j][e + 1], mu[h]), rs[h]), a.s2[gn + 1]), a.b2[gn + 1]);
      *reinterpret_cast<bf162*>(a.out + (size_t)gm * a.N + gn) = __floats2bfloat162_rn(o0, o1);
    }
}

// One CTA a 64-row tile of the output's whole rows: the producer warpgroup
// and the consumers as above.
template <bool GATHER>
__global__ void __launch_bounds__(NT, 1)
    embed_tc_kernel(const __grid_constant__ EmbedMaps maps, EmbedArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float red[2][CWG][TC_TILE];  // the LN(dim) sums: [pass][warpgroup][row]
  __shared__ __align__(128) float sbr[STAGES * 2 * TC_TILE];  // s1, b1 of each stage
  uint8_t* ring = align1024(smem_raw);
  const int m0 = blockIdx.x * TC_TILE, kblocks = (a.K + TC_TILE - 1) / TC_TILE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the volume form: each copying thread's arrival, and thread 0's bulk bytes
      bar_init(&full[s], GATHER ? 128 + 1 : 1);
      bar_init(&empty[s], 128 * CWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * CWG) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (GATHER)
      gather_producer(maps, a, ring, sbr, full, empty, m0, kblocks);
    else if (threadIdx.x == 128 * CWG)
      rows_producer(maps, a, ring, sbr, full, empty, m0, kblocks);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  consume(a, ring, sbr, full, empty, red, m0, kblocks);
}

template <typename K>
cudaError_t launch(K kernel, int tiles, cudaStream_t st, const EmbedMaps& maps,
                   const EmbedArgs& args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<tiles, NT, SMEM, st>>>(maps, args);
  return cudaGetLastError();
}

// The rows' checks: x (M, K) with row stride ldx, or, with x null, the patch
// rows of video (Bv, F, H, W) in (pt, p, p) patches, p and W multiples of 4,
// M = Bv t h w; K a multiple of 8 up to MAX_K.  The patch geometry into *g.
bool rows_fit(const void* x, int ldx, const void* video, int Bv, int F, int H, int W, int pt,
              int p, int M, int K, PatchGeom* g) {
  if (M <= 0 || K <= 0 || K % 8 || K > MAX_K) return false;
  if (x) {
    *g = {F, H, W, pt, p, 1, 1, 1};
    return aligned16(x) && ldx % 8 == 0 && ldx >= K;
  }
  const bool ok = video && (reinterpret_cast<uintptr_t>(video) & 7) == 0 && pt > 0 && p > 0
                  && F % pt == 0 && H % p == 0 && W % p == 0 && p % 4 == 0 && W % 4 == 0
                  && K == pt * p * p
                  && (long long)M == (long long)Bv * (F / pt) * (H / p) * (W / p);
  *g = {F, H, W, pt, p, ok ? F / pt : 1, ok ? H / p : 1, ok ? W / p : 1};
  return ok;
}

int row_blocks(int M) { return (M + 7) / 8 < 132 * 8 ? (M + 7) / 8 : 132 * 8; }

}  // namespace

// The rows' (mean, rstd) into stats (M, 2) f32 (8-byte aligned), for the
// rows as ct_embed_tc takes them: launched first, so that it runs while the
// caller prepares the product's operands.
CT_EXPORT int ct_embed_stats(const void* x, int ldx, const void* video, int Bv, int F, int H,
                             int W, int pt, int p, int M, int K, float eps, void* stats,
                             void* stream) {
  PatchGeom g;
  if (!rows_fit(x, ldx, video, Bv, F, H, W, pt, p, M, K, &g) || !stats
      || (reinterpret_cast<uintptr_t>(stats) & 7))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(stats);
  if (x)
    embed_stats<false, false><<<row_blocks(M), 256, 0, st>>>(
        static_cast<const bf16*>(x), ldx, g, M, K, eps, out, nullptr, nullptr, nullptr, 0);
  else
    embed_stats<true, false><<<row_blocks(M), 256, 0, st>>>(
        static_cast<const bf16*>(video), 0, g, M, K, eps, out, nullptr, nullptr, nullptr, 0);
  return (int)cudaGetLastError();
}

// K16b's recompute (embed_stats' XN form): xn (M, K) bf16 (row stride ldn)
// and stats (M, 2) f32 (mean, rstd; 8-byte aligned, or null: not written) of the rows x (M, K)
// bf16 (row stride ldx), s1 and b1 (K,) f32; K a multiple of 8 up to MAX_K,
// x, xn, s1 and b1 16-byte aligned.
CT_EXPORT int ct_embed_ln_rows(const void* x, int ldx, int M, int K, const void* s1,
                               const void* b1, float eps, void* xn, int ldn, void* stats,
                               void* stream) {
  PatchGeom g;
  if (!rows_fit(x, ldx, nullptr, 0, 0, 0, 0, 0, 0, M, K, &g) || !aligned16(s1) || !aligned16(b1)
      || !aligned16(xn) || ldn % 8 || ldn < K || (reinterpret_cast<uintptr_t>(stats) & 7))
    return (int)cudaErrorInvalidValue;
  embed_stats<false, true><<<row_blocks(M), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), ldx, g, M, K, eps, static_cast<float*>(stats),
      static_cast<const float*>(s1), static_cast<const float*>(b1), static_cast<bf16*>(xn), ldn);
  return (int)cudaGetLastError();
}

// The patch embed, bf16: out (M, N) = LN(dim)(bf16(bf16(xn W^T) + pbias))
// with xn = LN(patch_dim) of the rows (their stats from ct_embed_stats), K =
// patch_dim; the rows as ct_embed_stats takes them.  W (N, K), row stride
// ldw; s1, b1 (K,) f32; pbias (N,) bf16; s2, b2 (N,) f32.  N a multiple of 8
// up to 512; W, out, s1, b1, s2, b2 16-byte aligned.
CT_EXPORT int ct_embed_tc(const void* x, int ldx, const void* video, int Bv, int F, int H, int W,
                          int pt, int p, const void* w, int ldw, const void* s1, const void* b1,
                          const void* pbias, const void* s2, const void* b2, float eps, int M,
                          int N, int K, const void* stats, void* out, void* stream) {
  PatchGeom g;
  const bool ok = rows_fit(x, ldx, video, Bv, F, H, W, pt, p, M, K, &g) && N > 0 && N % 8 == 0
                  && N <= BN && ldw % 8 == 0 && ldw >= K && aligned16(w) && aligned16(s1)
                  && aligned16(b1) && aligned16(s2) && aligned16(b2) && aligned16(out) && pbias
                  && (reinterpret_cast<uintptr_t>(pbias) & 3) == 0 && stats
                  && (reinterpret_cast<uintptr_t>(stats) & 7) == 0;
  EmbedMaps maps;
  if (!ok || (x && !tensor_map(&maps.x, x, M, K, ldx)) || !tensor_map(&maps.w, w, N, K, ldw))
    return (int)cudaErrorInvalidValue;
  EmbedArgs a;
  a.video = static_cast<const bf16*>(video);
  a.g = g;
  a.s1 = static_cast<const float*>(s1);
  a.b1 = static_cast<const float*>(b1);
  a.stats = static_cast<const float*>(stats);
  a.pbias = static_cast<const bf16*>(pbias);
  a.s2 = static_cast<const float*>(s2);
  a.b2 = static_cast<const float*>(b2);
  a.eps = eps;
  a.out = static_cast<bf16*>(out);
  a.M = M;
  a.N = N;
  a.K = K;
  const int tiles = (M + TC_TILE - 1) / TC_TILE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(x ? launch(embed_tc_kernel<false>, tiles, st, maps, a)
                 : launch(embed_tc_kernel<true>, tiles, st, maps, a));
}
