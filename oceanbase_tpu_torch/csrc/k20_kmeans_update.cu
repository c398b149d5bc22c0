// K20: per-list sums and counts of the rows by their assignment (the
// k-means centroid update's segment sums), deterministic.
//
// Replaces oceanbase_tpu/storage/vector_index.py:64 _kmeans_update:
//   sums[l] = sum of x[i] over a[i] == l (float32), cnt[l] = #{a[i] == l}.
// Float atomics would change the bits from run to run. Here each list sums
// its rows in row order, in float32: the bits of a sequential sum (the
// CPU's index_add_), on every run.
//
// Bound on an H100: x and the assignment read once, the (L, d) sums
// written: 516 MB / 3.35 TB/s = 0.15 ms at 1M x 128. Memory bound.
//
// Design: the wrapper orders the rows by assignment with K3 (a stable
// radix sort: row order within a list). A block per list finds the list's
// range in that order by binary search, then one thread per dimension
// walks the list's rows in order; a warp reads 32 neighbouring floats of
// one row, and eight rows' loads are in flight before their adds, which
// stay in row order. The counts are the range lengths, exact below 2^24.
// Lists are uneven (the largest several times the mean), so the busiest
// block sets the time.
#include "ob_common.cuh"

#define K20_UNROLL 8

__device__ __forceinline__ long long k20_key(const void* a, int dt,
                                             const int* order, long long m) {
  return ob_ldg_i64(a, dt, (long long)__ldg(order + m));
}

__global__ void k20_update(const float* __restrict__ x,
                           const void* __restrict__ a, int dt,
                           const int* __restrict__ order, long long n, int d,
                           float* __restrict__ sums, float* __restrict__ cnt) {
  __shared__ long long bounds[2];
  const int l = blockIdx.x;
  if (threadIdx.x < 2) {
    long long target = (long long)l + threadIdx.x;
    long long lo = 0, hi = n;
    while (lo < hi) {
      long long mid = (lo + hi) >> 1;
      if (k20_key(a, dt, order, mid) < target) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    bounds[threadIdx.x] = lo;
  }
  __syncthreads();
  const long long s0 = bounds[0], s1 = bounds[1];
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    float s = 0.0f;
    long long m = s0;
    for (; m + K20_UNROLL <= s1; m += K20_UNROLL) {
      float v[K20_UNROLL];
#pragma unroll
      for (int u = 0; u < K20_UNROLL; u++) {
        v[u] = __ldg(x + (long long)__ldg(order + m + u) * d + k);
      }
#pragma unroll
      for (int u = 0; u < K20_UNROLL; u++) s += v[u];  // row order
    }
    for (; m < s1; m++) s += __ldg(x + (long long)__ldg(order + m) * d + k);
    sums[(long long)l * d + k] = s;
  }
  if (threadIdx.x == 0) cnt[l] = (float)(s1 - s0);
}

// x: (n, d) float32 row-major; a: assignment (dtype code dt: int32 or
// int64), order: int32 [n], rows sorted by a (stable); sums: (nl, d)
// float32; cnt: float32 [nl].
extern "C" int ob_k20_update(const void* x, const void* a, int dt,
                             const void* order, long long n, int d, int nl,
                             void* sums, void* cnt, void* stream) {
  if (n < 0 || d < 1 || nl < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int threads = ((d + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  k20_update<<<nl, threads, 0, s>>>((const float*)x, a, dt,
                                    (const int*)order, n, d, (float*)sums,
                                    (float*)cnt);
  return (int)cudaGetLastError();
}
