// rearrange.cu — (B, F, H, W) volume <-> (B, t*h*w, pt*p*p) patch rows in
// (pt, p1, p2) order: the '(c pt p1 p2)' patchify of CTViT's to_patch_emb as
// a pure move (K6), written into a caller's view (one slot of a batch
// buffer), and its inverse (K17), the move back.
//
// Replaces ct_clip_tpu/ops/pallas/patchify.py::_pallas_rearrange (K6), the
// forward of rearrange_patches, which the patch-row ingest runs as its last
// stage (ops/resample.py::preprocess_rows_into) and the volume training
// embed runs on the batch, and ::_pallas_unrearrange (K17), its VJP, which
// moves a patch-row gradient back onto the volume.  The TPU runs K17 in f32
// (a Mosaic shape cast needs 32-bit types); here it moves bf16 untouched.
//
// What bounds them on the H100: memory.  Each voxel is read once and written
// once: 2 x 110.6 MB for a full-width bf16 volume (240 x 480 x 480), about
// 0.066 ms at 3.35 TB/s.  In patch order a row (4000 values, 8000 B)
// gathers pt*p = 200 runs of p = 20 voxels (40 B, only 8-byte aligned) from
// ten frames, so a thread per element loses coalescing on one side.  Here a
// block owns one (b, ti, hi, z) slab instead: rows hi*p .. hi*p+p-1 of frame
// ti*pt+z, which are p*W contiguous voxels (19.2 KB at full width).  K6
// reads the slab into shared memory with 16-byte loads, then writes the
// slab's part of the w patch rows of (b, ti, hi): one contiguous run of p*p
// values (800 B) at column z*p*p of each row, with 16-byte stores whose 8
// values it gathers from shared memory.  K17 runs the same two stages the
// other way: 16-byte loads of the rows' runs scattered into the slab, then
// 16-byte stores of the slab.  Geometries that break 16-byte alignment take
// the same kernels with one element per access.
//
// The f32 forms (a compile-time template form on the element type; the bf16
// instantiations are the code as it was) move 4-byte elements, as the TPU
// kernels' f32 blocks do (patchify.py:55-64, 200-215): the f32 zero-shot
// rows ingest writes f32 rows (K6), and an f32 autoencoder's decoder
// un-patchifies f32 pixel rows (K17).  An f32 slab is 38.4 KB at full width.
#include "common.cuh"

namespace {

constexpr int RA_THREADS = 256;

struct RowsGeom {
  int F, H, W, pt, p, t, h, w;
  long long batch_stride, row_stride;  // of the patch rows, in elements
};

// the access type of VEC elements of BYTES bytes each
template <int VEC_BYTES>
struct VecOf;
template <>
struct VecOf<2> {
  typedef unsigned short type;
};
template <>
struct VecOf<4> {
  typedef unsigned int type;
};
template <>
struct VecOf<16> {
  typedef uint4 type;
};

// One block per (b, ti, hi, z) slab.  INVERSE false: volume -> rows (K6);
// true: rows -> volume (K17).
template <typename T, int VEC, bool INVERSE>
__global__ void __launch_bounds__(RA_THREADS)
rearrange_kernel(const T* __restrict__ in, T* __restrict__ out, RowsGeom g) {
  typedef typename VecOf<VEC * (int)sizeof(T)>::type V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);

  long long idx = blockIdx.x;
  const int z = (int)(idx % g.pt); idx /= g.pt;
  const int hi = (int)(idx % g.h); idx /= g.h;
  const int ti = (int)(idx % g.t);
  const long long b = idx / g.t;

  const int n_slab = g.p * g.W;
  const long long vol_off = ((b * g.F + (long long)ti * g.pt + z) * g.H + (long long)hi * g.p) * g.W;
  V* slab_v = reinterpret_cast<V*>(slab);
  const int pp = g.p * g.p;
  const int segs = pp / VEC;  // vector accesses per patch row
  const long long rows_off = b * g.batch_stride + (long long)z * pp;
  const long long row0 = ((long long)ti * g.h + hi) * g.w;

  if (!INVERSE) {
    const V* src_v = reinterpret_cast<const V*>(in + vol_off);
    for (int i = threadIdx.x; i < n_slab / VEC; i += RA_THREADS) slab_v[i] = src_v[i];
    __syncthreads();
  }
  for (int j = threadIdx.x; j < g.w * segs; j += RA_THREADS) {
    const int wi = j / segs;
    const int e0 = (j - wi * segs) * VEC;
    const long long at = rows_off + (row0 + wi) * g.row_stride + e0;
    V v;
    T* ve = reinterpret_cast<T*>(&v);
    if (INVERSE) v = *reinterpret_cast<const V*>(in + at);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int e = e0 + k;
      const int p1 = e / g.p, p2 = e - p1 * g.p;
      T& s = slab[p1 * g.W + wi * g.p + p2];
      if (INVERSE) s = ve[k];
      else ve[k] = s;
    }
    if (!INVERSE) *reinterpret_cast<V*>(out + at) = v;
  }
  if (INVERSE) {
    __syncthreads();
    V* dst_v = reinterpret_cast<V*>(out + vol_off);
    for (int i = threadIdx.x; i < n_slab / VEC; i += RA_THREADS) dst_v[i] = slab_v[i];
  }
}

template <typename T, int VEC, bool INVERSE>
int launch_rearrange(const T* in, T* out, const RowsGeom& g, int B, cudaStream_t stream) {
  const size_t smem = (size_t)g.p * g.W * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rearrange_kernel<T, VEC, INVERSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)B * g.t * g.h * g.pt;
  if (blocks <= 0 || blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  rearrange_kernel<T, VEC, INVERSE><<<(unsigned)blocks, RA_THREADS, smem, stream>>>(in, out, g);
  return (int)cudaGetLastError();
}

// T bf16 or float; vec: 16-byte accesses (16 / sizeof(T) elements)
template <typename T, bool INVERSE>
int rearrange(const void* in, void* out, int B, int F, int H, int W, int pt, int p,
              long long batch_stride, long long row_stride, int vec, void* stream) {
  if (pt <= 0 || p <= 0 || F % pt || H % p || W % p) return (int)cudaErrorInvalidValue;
  const RowsGeom g = {F, H, W, pt, p, F / pt, H / p, W / p, batch_stride, row_stride};
  const T* i = static_cast<const T*>(in);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V16 = 16 / sizeof(T);
  return vec ? launch_rearrange<T, V16, INVERSE>(i, o, g, B, s)
             : launch_rearrange<T, 1, INVERSE>(i, o, g, B, s);
}

}  // namespace

// video (B, F, H, W) bf16, contiguous -> out[b, row, e] bf16 at element
// offset b*out_batch_stride + row*out_row_stride + e.  vec != 0 takes
// 16-byte accesses; the caller guarantees W % 8 == 0, (p*p) % 8 == 0, both
// strides % 8 == 0 and 16-byte aligned pointers.
CT_EXPORT int ct_rearrange_patches(const void* video, int B, int F, int H, int W, int pt, int p,
                                   void* out, long long out_batch_stride,
                                   long long out_row_stride, int vec, void* stream) {
  return rearrange<bf16, false>(video, out, B, F, H, W, pt, p, out_batch_stride,
                                out_row_stride, vec, stream);
}

// The f32 form: video and out f32; vec needs W % 4 == 0, (p*p) % 4 == 0,
// both strides % 4 == 0 and 16-byte aligned pointers.
CT_EXPORT int ct_rearrange_patches_f32(const void* video, int B, int F, int H, int W, int pt,
                                       int p, void* out, long long out_batch_stride,
                                       long long out_row_stride, int vec, void* stream) {
  return rearrange<float, false>(video, out, B, F, H, W, pt, p, out_batch_stride,
                                 out_row_stride, vec, stream);
}

// The inverse: rows[b, row, e] at b*rows_batch_stride + row*rows_row_stride + e
// -> video (B, F, H, W) bf16, contiguous, every voxel written once; the same
// conditions for vec.
CT_EXPORT int ct_unrearrange_patches(const void* rows, long long rows_batch_stride,
                                     long long rows_row_stride, int B, int F, int H, int W,
                                     int pt, int p, void* video, int vec, void* stream) {
  return rearrange<bf16, true>(rows, video, B, F, H, W, pt, p, rows_batch_stride,
                               rows_row_stride, vec, stream);
}

// The f32 form of ct_unrearrange_patches (the conditions of the f32 K6).
CT_EXPORT int ct_unrearrange_patches_f32(const void* rows, long long rows_batch_stride,
                                         long long rows_row_stride, int B, int F, int H, int W,
                                         int pt, int p, void* video, int vec, void* stream) {
  return rearrange<float, true>(rows, video, B, F, H, W, pt, p, rows_batch_stride,
                                rows_row_stride, vec, stream);
}
