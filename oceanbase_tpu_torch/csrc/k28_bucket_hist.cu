// K28: the per-shard key histograms of PX -- equal-width range buckets
// and the range bounds drawn from their merged cdf, hash buckets and the
// hot-bucket test, the join bloom bitset and its probe.
//
// Replaces oceanbase_tpu/parallel/exchange.py:171 sample_range_bounds
// (4096 equal-width buckets over [kmin, kmax] with an integer ceiling
// step, the psum'd histogram's cdf, targets (i * total) // nsh for i in
// 1..nsh-1, searchsorted side="left", bound = kmin + (idx + 1) * step,
// all in wrapping int64); px.py:579-583 hot_buckets (hash32 % 4096
// bucket counts, psum'd, a bucket hot when its count exceeds max(2 *
// total // nsh, 1)) and the popular-row test popular[h] & sel; and
// px.py:608-623 _bloom_prefilter (bits[h % m] = 1 over the build's live
// rows, OR-merged over shards, then probe.sel & bits[h % m]). The merges
// over shards run on K27; the span's pmin/pmax on K1 + K27.
//
// Bound on an H100 (3.35 TB/s): read the key columns and the mask once,
// write the buckets (4096 x 8 B, or m x 4 B of bits) once; the probe
// reads keys and mask and writes a bool a row. Memory bound.
//
// Design: k28_hist counts each live row's bucket with a global atomicAdd
// (integer counts are exact in any order; bits are written, a benign
// race of equal values); k28_bounds is one block: a block scan of the
// 4096 counts into the cdf in shared memory, then one thread per bound
// runs the left binary search; k28_hot is one block: the two totals by
// block reduction, then the hot flags; k28_probe is one thread a row.
#include "ob_common.cuh"

#define K28_THREADS 256
#define K28_SCAN_THREADS 1024
#define K28_MAX_RES 4096

#define K28_RANGE 0
#define K28_COUNT 1
#define K28_BITS 2

// floor division of wrapping int64 values (jnp's //)
__device__ __forceinline__ long long k28_floor_div(long long a, long long b) {
  long long q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ long long k28_sub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

__device__ __forceinline__ long long k28_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ long long k28_mul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

// step of the equal-width buckets from the merged span [kmin, kmax]
__device__ __forceinline__ long long k28_step(long long kmin, long long kmax,
                                              long long res) {
  long long span = k28_add(k28_sub(kmax, kmin), 1);
  if (span < 1) span = 1;
  long long step = k28_floor_div(k28_add(span, res - 1), res);
  return step < 1 ? 1 : step;
}

// mode K28_RANGE: out int64 [res] += live rows per bucket of cols[0]
// (span from minmax = {kmin, kmax}); K28_COUNT: out int64 [res] += live
// rows per hash32 % res; K28_BITS: out int32 [res][h % res] = 1.
__global__ void k28_hist(int mode, int ncols, const long long* __restrict__ cols,
                         const long long* __restrict__ dts,
                         const unsigned char* __restrict__ mask, long long n,
                         const long long* __restrict__ minmax, long long res,
                         void* out) {
  long long kmin = 0, step = 1;
  if (mode == K28_RANGE) {
    kmin = minmax[0];
    step = k28_step(kmin, minmax[1], res);
  }
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!mask[i]) continue;
    if (mode == K28_RANGE) {
      long long k = ob_ldg_i64((const void*)cols[0], (int)dts[0], i);
      long long b = k28_floor_div(k28_sub(k, kmin), step);
      b = b < 0 ? 0 : (b > res - 1 ? res - 1 : b);
      atomicAdd((unsigned long long*)out + b, 1ull);
    } else {
      unsigned h = ob_hash32_row(ncols, cols, dts, i) % (unsigned)res;
      if (mode == K28_COUNT) {
        atomicAdd((unsigned long long*)out + h, 1ull);
      } else {
        ((int*)out)[h] = 1;
      }
    }
  }
}

// One block: nsh - 1 bounds from the merged histogram hist int64 [res]
// and the merged span minmax = {kmin, kmax}.
__global__ void k28_bounds(const long long* __restrict__ hist, long long res,
                           const long long* __restrict__ minmax, int nsh,
                           long long* __restrict__ bounds) {
  __shared__ long long cdf[K28_MAX_RES];
  long long per = (res + blockDim.x - 1) / blockDim.x;
  long long b0 = (long long)threadIdx.x * per;
  long long b1 = b0 + per < res ? b0 + per : res;
  long long s = 0;
  for (long long b = b0; b < b1; b++) s = k28_add(s, hist[b]);
  long long total;
  long long run = ob_block_exscan(s, &total);
  for (long long b = b0; b < b1; b++) {
    run = k28_add(run, hist[b]);
    cdf[b] = run;
  }
  __syncthreads();
  long long kmin = minmax[0];
  long long step = k28_step(kmin, minmax[1], res);
  total = cdf[res - 1];
  for (int i = threadIdx.x; i < nsh - 1; i += blockDim.x) {
    long long target = k28_floor_div(k28_mul(i + 1, total), nsh);
    long long lo = 0, hi = res;  // first cdf >= target (side="left")
    while (lo < hi) {
      long long mid = (lo + hi) >> 1;
      if (cdf[mid] < target) lo = mid + 1; else hi = mid;
    }
    bounds[i] = k28_add(kmin, k28_mul(lo + 1, step));
  }
}

// One block: hot[b] = cnt_a[b] > max(sum(cnt_a) * 2 // nsh, 1) or the
// same of cnt_b (null = no second side).
__global__ void k28_hot(const long long* __restrict__ cnt_a,
                        const long long* __restrict__ cnt_b, long long res,
                        int nsh, unsigned char* __restrict__ hot) {
  long long sa = 0, sb = 0;
  for (long long b = threadIdx.x; b < res; b += blockDim.x) {
    sa = k28_add(sa, cnt_a[b]);
    if (cnt_b) sb = k28_add(sb, cnt_b[b]);
  }
  long long ta, tb;
  ob_block_exscan(sa, &ta);
  ob_block_exscan(sb, &tb);
  long long lim_a = k28_floor_div(k28_mul(ta, 2), nsh);
  long long lim_b = k28_floor_div(k28_mul(tb, 2), nsh);
  lim_a = lim_a > 1 ? lim_a : 1;
  lim_b = lim_b > 1 ? lim_b : 1;
  for (long long b = threadIdx.x; b < res; b += blockDim.x) {
    bool h = cnt_a[b] > lim_a || (cnt_b && cnt_b[b] > lim_b);
    hot[b] = h ? 1 : 0;
  }
}

// out[i] = mask[i] && table[hash32(keys_i) % m] (table bool [m]).
__global__ void k28_probe(int ncols, const long long* __restrict__ cols,
                          const long long* __restrict__ dts,
                          const unsigned char* __restrict__ mask, long long n,
                          const unsigned char* __restrict__ table, long long m,
                          unsigned char* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool keep = false;
    if (mask[i]) {
      unsigned h = ob_hash32_row(ncols, cols, dts, i) % (unsigned)m;
      keep = table[h] != 0;
    }
    out[i] = keep ? 1 : 0;
  }
}

// table: int64 device array of ncols addresses then ncols type codes.
// out must be zeroed by the caller (it accumulates).
extern "C" int ob_k28_hist(int mode, int ncols, const void* table,
                           const void* mask, long long n, const void* minmax,
                           long long res, void* out, int blocks,
                           void* stream) {
  if (ncols < 1 || n < 0 || res < 1 || res > (1ll << 31) ||
      (mode == K28_RANGE && minmax == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const long long* t = (const long long*)table;
  k28_hist<<<blocks, K28_THREADS, 0, (cudaStream_t)stream>>>(
      mode, ncols, t, t + ncols, (const unsigned char*)mask, n,
      (const long long*)minmax, res, out);
  return (int)cudaGetLastError();
}

extern "C" int ob_k28_bounds(const void* hist, long long res,
                             const void* minmax, int nsh, void* bounds,
                             void* stream) {
  if (res < 1 || res > K28_MAX_RES || nsh < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (nsh == 1) return 0;
  k28_bounds<<<1, K28_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)hist, res, (const long long*)minmax, nsh,
      (long long*)bounds);
  return (int)cudaGetLastError();
}

extern "C" int ob_k28_hot(const void* cnt_a, const void* cnt_b, long long res,
                          int nsh, void* hot, void* stream) {
  if (res < 1 || nsh < 1) return (int)cudaErrorInvalidValue;
  k28_hot<<<1, K28_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)cnt_a, (const long long*)cnt_b, res, nsh,
      (unsigned char*)hot);
  return (int)cudaGetLastError();
}

extern "C" int ob_k28_probe(int ncols, const void* table, const void* mask,
                            long long n, const void* bits, long long m,
                            void* out, int blocks, void* stream) {
  if (ncols < 1 || n < 0 || m < 1 || m > (1ll << 32)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const long long* t = (const long long*)table;
  k28_probe<<<blocks, K28_THREADS, 0, (cudaStream_t)stream>>>(
      ncols, t, t + ncols, (const unsigned char*)mask, n,
      (const unsigned char*)bits, m, (unsigned char*)out);
  return (int)cudaGetLastError();
}
