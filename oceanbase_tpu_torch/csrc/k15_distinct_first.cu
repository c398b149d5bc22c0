// K15: first occurrences through a sort order, and rows written back
// through a permutation.
//
// Replaces oceanbase_tpu/ops/hashagg.py:240 distinct_first_mask (the run
// boundaries over the sorted (dead, keys, value) planes and the
// argsort(sidx) inverse that maps the winner bit back to row order) and
// the write-back of oceanbase_tpu/engine/executor.py:2628 _emit_window
// (the inverse permutation of :2687 and the packed gather by it):
//   ob_k15_first    given the stable order of (dead, keys...) from K3,
//                   first[order[i]] = live[order[i]] and (i == 0, or the
//                   live flag or any key of row order[i] differs from that
//                   of row order[i - 1]); keys compare with `!=`, so every
//                   NaN row is its own value and -0.0 equals 0.0
//   ob_k15_scatter  dst[c][order[i]] = src[c][i] for every column c
//
// Bound on an H100 (3.35 TB/s): first reads the order, then the keys and
// live flags at random rows (a 32-byte sector for each element, at
// worst), and writes one byte a row at a random row; the scatter reads
// each column once and writes each element once: bytes bound, dominated
// by the sectors of the random accesses.
//
// Design: first runs one thread per sorted position, each output element
// written by exactly one thread (order is a permutation): no inverse
// sort, no atomics, no ordering between threads. The scatter writes the
// inverse permutation once (4 random bytes a row) and then gathers every
// column through it, so the many columns' random accesses are reads and
// their writes stay coalesced. Two runs give the same bits. The key
// columns come from a table in device memory (ob_common.cuh ObKeys), so a
// DISTINCT aggregate takes any number of group keys.
#include "ob_common.cuh"

#define K15_THREADS 256
#define K15_MAX_SCATTER 48

// One warp covers 32 consecutive sorted positions: each thread reads the
// live flag and keys of its own row (order[i]) once and takes the previous
// position's from the lane below by a shuffle; only lane 0 reads row
// order[i - 1] itself. That halves the random reads of comparing each row
// with its predecessor.
__global__ void k15_first(ObKeys k, const unsigned char* __restrict__ live,
                          const int* __restrict__ order, long long n,
                          unsigned char* __restrict__ first) {
  int lane = threadIdx.x & 31;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += step) {
    long long i = base + threadIdx.x;
    bool in = i < n;
    long long r = in ? __ldg(order + i) : 0;
    long long p = (in && lane == 0 && i > 0) ? __ldg(order + i - 1) : 0;
    int lv = in ? __ldg(live + r) : 0;
    int plv = __shfl_up_sync(OB_FULL_MASK, lv, 1);
    if (lane == 0) plv = (in && i > 0) ? __ldg(live + p) : 0;
    bool nw = i == 0 || plv != lv;
    for (int c = 0; c < k.ncols; c++) {
      const void* col = ob_key_col(k, c);
      int dt = ob_key_dt(k, c);
      if (ob_is_float(dt)) {
        double v = in ? ob_ldg_f64(col, dt, r) : 0.0;
        double pv = __shfl_up_sync(OB_FULL_MASK, v, 1);
        if (lane == 0 && in && i > 0) pv = ob_ldg_f64(col, dt, p);
        nw = nw || v != pv;
      } else {
        long long v = in ? ob_ldg_i64(col, dt, r) : 0;
        long long pv = __shfl_up_sync(OB_FULL_MASK, v, 1);
        if (lane == 0 && in && i > 0) pv = ob_ldg_i64(col, dt, p);
        nw = nw || v != pv;
      }
    }
    if (in) first[r] = nw && lv;
  }
}

// table: the device table of ncols key columns of n rows in row order
// (ObKeys); live: bool [n]; order: int32 [n], a permutation sorting (dead,
// keys...); first: bool [n].
extern "C" int ob_k15_first(int ncols, const void* table, const void* live,
                            const void* order, long long n, void* first,
                            int nblocks, void* stream) {
  ObKeys k;
  if (!ob_keys_set(&k, ncols, table)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  k15_first<<<nblocks, K15_THREADS, 0, (cudaStream_t)stream>>>(
      k, (const unsigned char*)live, (const int*)order, n,
      (unsigned char*)first);
  return (int)cudaGetLastError();
}

struct K15Scatter {
  const void* src[K15_MAX_SCATTER];
  void* dst[K15_MAX_SCATTER];
  int width[K15_MAX_SCATTER];
  int ncols;
};

__global__ void k15_inverse(const int* __restrict__ order, long long n,
                            int* __restrict__ inv) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    inv[__ldg(order + i)] = (int)i;
  }
}

__global__ void k15_gather(K15Scatter a, const int* __restrict__ inv,
                           long long n) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += step) {
    long long i = __ldg(inv + j);
    for (int c = 0; c < a.ncols; c++) {
      switch (a.width[c]) {
        case 1:
          ((unsigned char*)a.dst[c])[j] = __ldg((const unsigned char*)a.src[c] + i);
          break;
        case 2:
          ((unsigned short*)a.dst[c])[j] = __ldg((const unsigned short*)a.src[c] + i);
          break;
        case 4:
          ((unsigned int*)a.dst[c])[j] = __ldg((const unsigned int*)a.src[c] + i);
          break;
        default:
          ((unsigned long long*)a.dst[c])[j] =
              __ldg((const unsigned long long*)a.src[c] + i);
          break;
      }
    }
  }
}

// src/dst/widths: ncols columns of n elements of 1, 2, 4 or 8 bytes;
// order: int32 [n], a permutation of 0..n-1; inv: int32 scratch [n].
extern "C" int ob_k15_scatter(int ncols, const void* const* src,
                              void* const* dst, const int* widths,
                              const void* order, void* inv, long long n,
                              int nblocks, void* stream) {
  if (ncols < 1 || ncols > K15_MAX_SCATTER) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  K15Scatter a;
  a.ncols = ncols;
  for (int c = 0; c < ncols; c++) {
    int w = widths[c];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    a.src[c] = src[c];
    a.dst[c] = dst[c];
    a.width[c] = w;
  }
  cudaStream_t st = (cudaStream_t)stream;
  k15_inverse<<<nblocks, K15_THREADS, 0, st>>>((const int*)order, n,
                                               (int*)inv);
  k15_gather<<<nblocks, K15_THREADS, 0, st>>>(a, (const int*)inv, n);
  return (int)cudaGetLastError();
}
