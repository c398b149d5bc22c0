// K4: multi-column row gather -- every column of a batch by one index array.
//
// Replaces oceanbase_tpu/ops/gather.py:54 gather_rows and
// engine/executor.py:99 gather_payload: out[c][r] = col[c][idx[r]] for all
// payload columns (values, validity masks and the sel mask). The JAX
// package bitcasts columns into int32 planes packed as (N, 8) matrices
// because a TPU row gather vectorizes across lanes; that packing is a TPU
// workaround and has no counterpart here.
//
// Bound on an H100 (3.35 TB/s): it reads the index array and writes every
// output once, and reads each gathered element once, M * (4 + 2 * sum of
// column widths) bytes -- memory bound. The source reads are random when
// the index is a sort order, so they move whole 32-byte sectors.
//
// Design: one launch for all columns. The wrapper groups the columns by
// element width (1, 2, 4, 8 bytes) into a pointer table passed by value;
// blockIdx.y picks the width group, and each thread loads one index (clamped
// to the source length, like a jnp gather) and copies that row of every
// column in its group. Writes are coalesced; reads are one element each.
#include "ob_common.cuh"

#define K4_THREADS 256
#define K4_MAX_COLS 48

struct K4Args {
  const void* src[K4_MAX_COLS];
  void* dst[K4_MAX_COLS];
  int gstart[5];  // columns [gstart[g], gstart[g+1]) have width gwidth[g]
  int gwidth[4];
};

template <typename T>
__device__ __forceinline__ void k4_copy_row(const K4Args& a, int c0, int c1,
                                            long long r, long long s) {
  for (int c = c0; c < c1; c++) {
    ((T*)a.dst[c])[r] = ((const T*)a.src[c])[s];
  }
}

__global__ void k4_gather(const int* __restrict__ idx, long long m,
                          long long nsrc, K4Args a) {
  int g = blockIdx.y;
  int c0 = a.gstart[g], c1 = a.gstart[g + 1];
  if (c0 == c1) return;
  int w = a.gwidth[g];
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < m;
       r += stride) {
    long long s = idx[r];
    s = s < 0 ? 0 : (s >= nsrc ? nsrc - 1 : s);
    switch (w) {
      case 1: k4_copy_row<unsigned char>(a, c0, c1, r, s); break;
      case 2: k4_copy_row<unsigned short>(a, c0, c1, r, s); break;
      case 4: k4_copy_row<unsigned int>(a, c0, c1, r, s); break;
      default: k4_copy_row<unsigned long long>(a, c0, c1, r, s); break;
    }
  }
}

// src/dst: ncols pointers ordered by width group; gstart: 5 group bounds
// over [0, ncols]; gwidth: the 4 group widths. idx: int32 [m].
extern "C" int ob_k4_gather(const void* idx, long long m, long long nsrc,
                            int ncols, const void* const* src,
                            void* const* dst, const int* gstart,
                            const int* gwidth, int nblocks, void* stream) {
  if (ncols < 1 || ncols > K4_MAX_COLS || nsrc < 1) {
    return (int)cudaErrorInvalidValue;
  }
  K4Args a;
  for (int c = 0; c < ncols; c++) {
    a.src[c] = src[c];
    a.dst[c] = dst[c];
  }
  for (int g = 0; g < 5; g++) a.gstart[g] = gstart[g];
  for (int g = 0; g < 4; g++) a.gwidth[g] = gwidth[g];
  dim3 grid(nblocks, 4);
  k4_gather<<<grid, K4_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)idx, m, nsrc, a);
  return (int)cudaGetLastError();
}
