// K23: first-k live-row compaction -- the first k live rows of a result
// frame, every column and validity plane gathered in the same pass.
//
// Replaces oceanbase_tpu/engine/executor.py:3867-3876 _head_gather_impl
// (DeviceResult.fetch_head's `jnp.nonzero(sel, size=k, fill_value=0)` +
// `jnp.take` of every column and validity plane) and the compaction step
// of :3691-3715 _build_narrow's run_narrow (the same nonzero + take, plus
// nlive = sum(sel)). Output lane p < min(nlive, k) holds the p-th live row
// in ascending row order (jnp.nonzero's order); lanes p >= nlive hold row
// 0's bytes (the fill_value=0 gather), and k may exceed the capacity.
//
// Bound on an H100 (3.35 TB/s): it must read sel once (cap bytes) and, for
// the min(nlive, k) gathered rows, read and write each row's bytes once --
// cap + 2 * k * row_bytes, memory bound. A head fetch of 10 rows over a
// 60M-row frame is all sel bytes; the write pass then touches only the
// blocks that hold the first k live rows.
//
// Design: three launches on the caller's stream (one more write pass per
// further K23_GROUP columns) and no host sync:
//  1. k23_count: each block popcounts a tile of K23_TILE rows of sel
//     (each thread 16 consecutive bytes, one 16-byte load when aligned);
//  2. k23_scan: one block turns the per-tile counts into exclusive tile
//     prefixes and writes nlive;
//  3. k23_write: a block whose tile prefix is already >= k exits at once;
//     the others rank their live rows (a block scan of the per-thread
//     counts) and rows of rank < k write idx[rank] and their bytes of
//     every column through a pointer table passed by value (element size
//     1/2/4/8 and elements per row, so a VECTOR column moves whole rows).
//     Every block first fills its share of the padding lanes [nlive, k)
//     with row 0. A frame of more than K23_GROUP columns and validity
//     planes runs this pass once per group of K23_GROUP (the count and
//     the scan run once); only the first group writes idx.
#include "ob_common.cuh"

#define K23_THREADS 256
#define K23_ROWS_PER_THREAD 16
#define K23_TILE (K23_THREADS * K23_ROWS_PER_THREAD)
#define K23_SCAN_THREADS 1024
#define K23_GROUP 48

struct K23Args {
  const void* src[K23_GROUP];
  void* dst[K23_GROUP];
  int esize[K23_GROUP];  // element bytes: 1, 2, 4 or 8
  int nper[K23_GROUP];   // elements per row (1, or a VECTOR's width)
};

// Bit j of the result: row r0 + j is live (j < 16, rows past cap dead).
__device__ __forceinline__ unsigned k23_mask16(const unsigned char* sel,
                                               long long r0, long long cap) {
  unsigned m = 0;
  if (r0 + K23_ROWS_PER_THREAD <= cap &&
      ((reinterpret_cast<uintptr_t>(sel + r0) & 15) == 0)) {
    uint4 q = *reinterpret_cast<const uint4*>(sel + r0);
    unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; j++) {
#pragma unroll
      for (int b = 0; b < 4; b++) {
        if ((w[j] >> (8 * b)) & 0xffu) m |= 1u << (4 * j + b);
      }
    }
  } else {
    for (int j = 0; j < K23_ROWS_PER_THREAD; j++) {
      if (r0 + j < cap && sel[r0 + j]) m |= 1u << j;
    }
  }
  return m;
}

// Exclusive block-wide sum of one int per thread (blockDim.x a multiple
// of 32, at most 1024); *total gets the block's sum.
__device__ __forceinline__ long long k23_block_exscan(long long v,
                                                      long long* total) {
  __shared__ long long warp_sums[32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(OB_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(OB_FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) warp_sums[lane] = s;  // inclusive warp prefixes
  }
  __syncthreads();
  long long before = (warp > 0 ? warp_sums[warp - 1] : 0) + (x - v);
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before;
}

__global__ void k23_count(const unsigned char* __restrict__ sel,
                          long long cap, int* __restrict__ counts) {
  long long r0 = (long long)blockIdx.x * K23_TILE +
                 (long long)threadIdx.x * K23_ROWS_PER_THREAD;
  int c = __popc(k23_mask16(sel, r0, cap));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(OB_FULL_MASK, c, o);
  __shared__ int warp_counts[K23_THREADS / 32];
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < K23_THREADS / 32; w++) s += warp_counts[w];
    counts[blockIdx.x] = s;
  }
}

// One block: prefix[b] = sum of counts[0..b), *nlive = sum of all.
__global__ void k23_scan(const int* __restrict__ counts, long long ntiles,
                         long long* __restrict__ prefix,
                         long long* __restrict__ nlive) {
  long long per = (ntiles + blockDim.x - 1) / blockDim.x;
  long long t0 = (long long)threadIdx.x * per;
  long long t1 = t0 + per < ntiles ? t0 + per : ntiles;
  long long s = 0;
  for (long long t = t0; t < t1; t++) s += counts[t];
  long long total;
  long long run = k23_block_exscan(s, &total);
  for (long long t = t0; t < t1; t++) {
    prefix[t] = run;
    run += counts[t];
  }
  if (threadIdx.x == 0) *nlive = total;
}

__device__ __forceinline__ void k23_copy(const K23Args& a, int ncols,
                                         long long p, long long row) {
  for (int c = 0; c < ncols; c++) {
    long long n = a.nper[c];
    long long s = row * n, d = p * n;
    switch (a.esize[c]) {
      case 1:
        for (long long e = 0; e < n; e++)
          ((unsigned char*)a.dst[c])[d + e] =
              ((const unsigned char*)a.src[c])[s + e];
        break;
      case 2:
        for (long long e = 0; e < n; e++)
          ((unsigned short*)a.dst[c])[d + e] =
              ((const unsigned short*)a.src[c])[s + e];
        break;
      case 4:
        for (long long e = 0; e < n; e++)
          ((unsigned int*)a.dst[c])[d + e] =
              ((const unsigned int*)a.src[c])[s + e];
        break;
      default:
        for (long long e = 0; e < n; e++)
          ((unsigned long long*)a.dst[c])[d + e] =
              ((const unsigned long long*)a.src[c])[s + e];
        break;
    }
  }
}

__global__ void k23_write(const unsigned char* __restrict__ sel,
                          long long cap, long long k,
                          const long long* __restrict__ prefix,
                          const long long* __restrict__ nlive_p,
                          long long* __restrict__ idx, int ncols,
                          K23Args a) {
  // padding lanes [min(nlive, k), k) take row 0, spread over every block;
  // idx is null in the passes of the second and later column groups
  long long nlive = *nlive_p;
  long long lo = nlive < k ? nlive : k;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = lo + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < k; p += stride) {
    if (idx) idx[p] = 0;
    k23_copy(a, ncols, p, 0);
  }
  long long base = prefix[blockIdx.x];
  if (base >= k) return;  // the first k live rows lie in earlier tiles
  long long r0 = (long long)blockIdx.x * K23_TILE +
                 (long long)threadIdx.x * K23_ROWS_PER_THREAD;
  unsigned m = k23_mask16(sel, r0, cap);
  long long total;
  long long rank = base + k23_block_exscan(__popc(m), &total);
  while (m != 0u && rank < k) {
    int j = __ffs(m) - 1;
    m &= m - 1u;
    if (idx) idx[rank] = r0 + j;
    k23_copy(a, ncols, rank, r0 + j);
    rank++;
  }
}

extern "C" int ob_k23_tile_rows() { return K23_TILE; }

// sel: bool[cap] (cap >= 1); k >= 1 output lanes; idx: int64[k];
// nlive: int64[1]; counts: int32[ntiles]; prefix: int64[ntiles] with
// ntiles = ceil(cap / K23_TILE); src/dst: ncols pointers (any number),
// esize/nper per column (dst column c holds k * nper[c] elements).
extern "C" int ob_k23_first_live(const void* sel, long long cap, long long k,
                                 void* idx, void* nlive, void* counts,
                                 void* prefix, int ncols,
                                 const void* const* src, void* const* dst,
                                 const int* esize, const int* nper,
                                 void* stream) {
  if (cap < 1 || k < 1 || ncols < 0) return (int)cudaErrorInvalidValue;
  for (int c = 0; c < ncols; c++) {
    if (esize[c] != 1 && esize[c] != 2 && esize[c] != 4 && esize[c] != 8) {
      return (int)cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  long long ntiles = (cap + K23_TILE - 1) / K23_TILE;
  k23_count<<<(unsigned)ntiles, K23_THREADS, 0, s>>>(
      (const unsigned char*)sel, cap, (int*)counts);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  k23_scan<<<1, K23_SCAN_THREADS, 0, s>>>((const int*)counts, ntiles,
                                          (long long*)prefix,
                                          (long long*)nlive);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // the write pass, once per group of K23_GROUP columns (once when the
  // frame has none: idx alone)
  int c0 = 0;
  do {
    int n = ncols - c0 < K23_GROUP ? ncols - c0 : K23_GROUP;
    K23Args a;
    for (int c = 0; c < n; c++) {
      a.src[c] = src[c0 + c];
      a.dst[c] = dst[c0 + c];
      a.esize[c] = esize[c0 + c];
      a.nper[c] = nper[c0 + c];
    }
    k23_write<<<(unsigned)ntiles, K23_THREADS, 0, s>>>(
        (const unsigned char*)sel, cap, k, (const long long*)prefix,
        (const long long*)nlive, c0 == 0 ? (long long*)idx : nullptr, n, a);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    c0 += n;
  } while (c0 < ncols);
  return 0;
}
