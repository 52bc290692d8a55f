// rearrange.cu — (B, F, H, W) volume -> (B, t*h*w, pt*p*p) patch rows in
// (pt, p1, p2) order: the '(c pt p1 p2)' patchify of CTViT's to_patch_emb as
// a pure move, written into a caller's view (one slot of a batch buffer).
//
// Replaces ct_clip_tpu/ops/pallas/patchify.py::_pallas_rearrange (K6), the
// forward of rearrange_patches, which the patch-row ingest runs as its last
// stage (ops/resample.py::preprocess_rows_into).
//
// What bounds it on the H100: memory.  Each voxel is read once and written
// once: 2 x 110.6 MB for a full-width bf16 volume (240 x 480 x 480), about
// 0.066 ms at 3.35 TB/s.  In patch order an output row (4000 values, 8000 B)
// gathers pt*p = 200 runs of p = 20 voxels (40 B, only 8-byte aligned) from
// ten frames, so a thread per element loses coalescing on one side.  Here a
// block owns one (b, ti, hi, z) slab instead: rows hi*p .. hi*p+p-1 of frame
// ti*pt+z, which are p*W contiguous voxels (19.2 KB at full width).  It reads
// the slab into shared memory with 16-byte loads, then writes the slab's part
// of the w patch rows of (b, ti, hi): one contiguous run of p*p values (800 B)
// at column z*p*p of each row, with 16-byte stores whose 8 values it gathers
// from shared memory.  Geometries that break 16-byte alignment take the same
// kernel with 2-byte accesses.
#include "common.cuh"

namespace {

constexpr int RA_THREADS = 256;

struct RowsGeom {
  int F, H, W, pt, p, t, h, w;
  long long out_batch_stride, out_row_stride;  // in elements
};

template <int VEC>
struct VecOf;
template <>
struct VecOf<1> {
  typedef unsigned short type;
};
template <>
struct VecOf<8> {
  typedef uint4 type;
};

template <int VEC>
__global__ void __launch_bounds__(RA_THREADS)
rearrange_kernel(const bf16* __restrict__ video, bf16* __restrict__ out, RowsGeom g) {
  typedef typename VecOf<VEC>::type V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* slab = reinterpret_cast<bf16*>(smem_raw);

  long long idx = blockIdx.x;
  const int z = (int)(idx % g.pt); idx /= g.pt;
  const int hi = (int)(idx % g.h); idx /= g.h;
  const int ti = (int)(idx % g.t);
  const long long b = idx / g.t;

  const int n_slab = g.p * g.W;
  const bf16* src = video + ((b * g.F + (long long)ti * g.pt + z) * g.H + (long long)hi * g.p) * g.W;
  const V* src_v = reinterpret_cast<const V*>(src);
  V* slab_v = reinterpret_cast<V*>(slab);
  for (int i = threadIdx.x; i < n_slab / VEC; i += RA_THREADS) slab_v[i] = src_v[i];
  __syncthreads();

  const int pp = g.p * g.p;
  const int segs = pp / VEC;  // stores per output row
  bf16* dst = out + b * g.out_batch_stride + (long long)z * pp;
  const long long row0 = ((long long)ti * g.h + hi) * g.w;
  for (int j = threadIdx.x; j < g.w * segs; j += RA_THREADS) {
    const int wi = j / segs;
    const int e0 = (j - wi * segs) * VEC;
    V v;
    bf16* ve = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int e = e0 + k;
      const int p1 = e / g.p, p2 = e - p1 * g.p;
      ve[k] = slab[p1 * g.W + wi * g.p + p2];
    }
    *reinterpret_cast<V*>(dst + (row0 + wi) * g.out_row_stride + e0) = v;
  }
}

template <int VEC>
int launch_rearrange(const bf16* video, bf16* out, const RowsGeom& g, int B, cudaStream_t stream) {
  const size_t smem = (size_t)g.p * g.W * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rearrange_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)B * g.t * g.h * g.pt;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  rearrange_kernel<VEC><<<(unsigned)blocks, RA_THREADS, smem, stream>>>(video, out, g);
  return (int)cudaGetLastError();
}

}  // namespace

// video (B, F, H, W) bf16, contiguous -> out[b, row, e] bf16 at element
// offset b*out_batch_stride + row*out_row_stride + e.  vec != 0 takes
// 16-byte accesses; the caller guarantees W % 8 == 0, (p*p) % 8 == 0, both
// strides % 8 == 0 and 16-byte aligned pointers.
CT_EXPORT int ct_rearrange_patches(const void* video, int B, int F, int H, int W, int pt, int p,
                                   void* out, long long out_batch_stride,
                                   long long out_row_stride, int vec, void* stream) {
  if (pt <= 0 || p <= 0 || F % pt || H % p || W % p) return (int)cudaErrorInvalidValue;
  const RowsGeom g = {F, H, W, pt, p, F / pt, H / p, W / p, out_batch_stride, out_row_stride};
  const bf16* v = static_cast<const bf16*>(video);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_rearrange<8>(v, o, g, B, s) : launch_rearrange<1>(v, o, g, B, s);
}
