// K17: the range slice of a sorted-projection scan.
//
// Replaces oceanbase_tpu/engine/executor.py:4179 _slice_sorted_scan. The
// scan of a sorted projection (storage/sorted_projection.py) reads only
// the rows whose sort key lies in the statement's range: lo is the largest
// of searchsorted(key[:n], low bound, side) over the low bounds, hi the
// smallest over the high bounds, then hi = max(hi, lo); the slice is the
// `cap` rows from start = clip(lo, 0, capacity - cap) of every column,
// validity mask and sel, with sel cleared outside [lo, hi); nrows counts
// the sliced sel and overflow = max(hi - lo - cap, 0) sends a range wider
// than the static slice capacity back through the overflow retry.
//
// The bounds may be parameterized literals, i.e. 0-d device tensors that
// the host has not read, so the slice cannot be a host-offset narrow: it
// is a copy whose offset is found on the device. Bound on an H100 (3.35
// TB/s): the sliced bytes, read once and written once, plus the probes of
// the searches (a few sectors) -- memory bound.
//
// Design: one launch. Every block repeats the binary searches (the
// block's threads strided over the bounds, about 26 dependent probes over
// 60M keys each, the bound cast to the key's width first as the
// reference's astype does, lo and hi folded with shared atomics), writes
// its share of sel and counts its live rows into nrows with one atomic
// per warp, then copies its share of the `cap` rows column by column
// through a pointer table grouped by element width (as K4 does). Block 0
// writes the overflow. The columns and the bounds come from one table of
// entries: up to K17_INLINE of them ride the kernel's parameters (no
// upload, as the by-value table of the first design), a longer table lies
// in device memory, so a projection of any width and a range of any
// number of bounds take one launch. The copy runs column by column so that
// a thread reads a column's two addresses once, not once a row, and issues
// four independent loads before its stores.
#include "ob_common.cuh"

#define K17_THREADS 256
#define K17_INLINE 64

// The table: ncols source addresses, ncols destination addresses (grouped
// by width), then three entries per bound: the 0-d bound tensor's
// address, its type code, its flags (bit 0: side right; bit 1: high
// bound). In `e` when it has at most K17_INLINE entries (t is null), else
// at t in device memory.
struct K17Args {
  long long e[K17_INLINE];
  const long long* t;
  int ncols;
  int gstart[5];  // columns [gstart[g], gstart[g+1]) have width gwidth[g]
  int gwidth[4];
  int nbounds;
};

// A bound value converted to the key's type (two's-complement truncation,
// as astype does), widened back to int64 for the comparisons.
__device__ __forceinline__ long long k17_as_key(long long v, int key_dt) {
  switch (key_dt) {
    case OB_I8: return (long long)(signed char)v;
    case OB_I16: return (long long)(short)v;
    case OB_I32: return (long long)(int)v;
    default: return v;
  }
}

__device__ __forceinline__ long long k17_entry(const K17Args& a, int i) {
  return a.t != nullptr ? __ldg(a.t + i) : a.e[i];
}

// searchsorted(key[:n], v, side): the first i with key[i] >= v (left) or
// key[i] > v (right).
__device__ long long k17_search(const void* key, int key_dt, long long n,
                                long long v, bool right) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = lo + ((hi - lo) >> 1);
    long long k = ob_ldg_i64(key, key_dt, mid);
    bool go_right = right ? (k <= v) : (k < v);
    if (go_right) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Rows first, first + stride, ... below cap of columns [c0, c1): dst[r] =
// src[start + r].
template <typename T>
__device__ __forceinline__ void k17_copy_cols(const K17Args& a, int c0, int c1,
                                              long long start, long long cap,
                                              long long first,
                                              long long stride) {
  for (int c = c0; c < c1; c++) {
    const T* src = (const T*)k17_entry(a, c) + start;
    T* dst = (T*)k17_entry(a, a.ncols + c);
    long long r = first;
    for (; r + 3 * stride < cap; r += 4 * stride) {
      T v0 = src[r], v1 = src[r + stride], v2 = src[r + 2 * stride],
        v3 = src[r + 3 * stride];
      dst[r] = v0;
      dst[r + stride] = v1;
      dst[r + 2 * stride] = v2;
      dst[r + 3 * stride] = v3;
    }
    for (; r < cap; r += stride) dst[r] = src[r];
  }
}

__global__ void k17_slice(const void* __restrict__ key, int key_dt,
                          long long n, long long cap, long long cap2,
                          const unsigned char* __restrict__ sel_in,
                          unsigned char* __restrict__ sel_out,
                          unsigned long long* nrows, long long* ovf,
                          K17Args a) {
  __shared__ long long s_lo, s_hi, s_start;
  int t = threadIdx.x;
  if (t == 0) {
    s_lo = 0;
    s_hi = n;
  }
  __syncthreads();
  for (int b = t; b < a.nbounds; b += blockDim.x) {
    int i = 2 * a.ncols + 3 * b;
    const void* bv = (const void*)k17_entry(a, i);
    int bdt = (int)k17_entry(a, i + 1);
    int flag = (int)k17_entry(a, i + 2);
    long long v = k17_as_key(ob_ldg_i64(bv, bdt, 0), key_dt);
    long long pos = k17_search(key, key_dt, n, v, (flag & 1) != 0);
    // positions lie in [0, n]: the signed atomics order them as integers
    if (flag & 2) {
      atomicMin(&s_hi, pos);
    } else {
      atomicMax(&s_lo, pos);
    }
  }
  __syncthreads();
  if (t == 0) {
    long long lo = s_lo, hi = s_hi;
    hi = hi > lo ? hi : lo;
    long long start = lo < 0 ? 0 : lo;
    if (start > cap2 - cap) start = cap2 - cap;
    s_lo = lo;
    s_hi = hi;
    s_start = start;
    if (blockIdx.x == 0) {
      long long over = hi - lo - cap;
      *ovf = over > 0 ? over : 0;
    }
  }
  __syncthreads();
  long long lo = s_lo, hi = s_hi, start = s_start;
  long long stride = (long long)gridDim.x * blockDim.x;
  long long first = (long long)blockIdx.x * blockDim.x + t;
  unsigned int live = 0;
  for (long long r = first; r < cap; r += stride) {
    long long s = start + r;
    bool on = sel_in[s] != 0 && s >= lo && s < hi;
    sel_out[r] = on ? 1 : 0;
    live += on ? 1u : 0u;
  }
  for (int o = 16; o > 0; o >>= 1) {
    live += __shfl_xor_sync(OB_FULL_MASK, live, o);
  }
  if ((t & 31) == 0 && live) {
    atomicAdd(nrows, (unsigned long long)live);
  }
  for (int g = 0; g < 4; g++) {
    int c0 = a.gstart[g], c1 = a.gstart[g + 1];
    if (c0 == c1) continue;
    switch (a.gwidth[g]) {
      case 1:
        k17_copy_cols<unsigned char>(a, c0, c1, start, cap, first, stride);
        break;
      case 2:
        k17_copy_cols<unsigned short>(a, c0, c1, start, cap, first, stride);
        break;
      case 4:
        k17_copy_cols<unsigned int>(a, c0, c1, start, cap, first, stride);
        break;
      default:
        k17_copy_cols<unsigned long long>(a, c0, c1, start, cap, first,
                                          stride);
        break;
    }
  }
}

// key: the sort-key column (element type key_dt), its first n rows sorted;
// cap: the slice capacity; cap2: the capacity of every column (> cap);
// the table of K17Args (the ncols columns and validity masks grouped by
// width, as K4, then the nbounds bounds): `entries` on the host when it
// has at most K17_INLINE entries, else `table` in device memory (the other
// one null); gstart/gwidth: the width groups; sel_in [cap2] -> sel_out
// [cap]; nrows: one zeroed int64; ovf: one int64.
extern "C" int ob_k17_slice(const void* key, int key_dt, long long n,
                            long long cap, long long cap2, int nbounds,
                            int ncols, const long long* entries,
                            const void* table, const int* gstart,
                            const int* gwidth, const void* sel_in,
                            void* sel_out, void* nrows, void* ovf,
                            int nblocks, void* stream) {
  long long ne = 2LL * ncols + 3LL * nbounds;
  if (ncols < 0 || nbounds < 0 || cap < 1 || cap > cap2 || n > cap2 ||
      (entries != nullptr) == (table != nullptr) ||
      (entries != nullptr && ne > K17_INLINE)) {
    return (int)cudaErrorInvalidValue;
  }
  K17Args a;
  a.t = (const long long*)table;
  if (entries != nullptr) {
    for (long long i = 0; i < ne; i++) a.e[i] = entries[i];
  }
  a.ncols = ncols;
  for (int g = 0; g < 5; g++) a.gstart[g] = gstart[g];
  for (int g = 0; g < 4; g++) a.gwidth[g] = gwidth[g];
  a.nbounds = nbounds;
  k17_slice<<<nblocks, K17_THREADS, 0, (cudaStream_t)stream>>>(
      key, key_dt, n, cap, cap2, (const unsigned char*)sel_in,
      (unsigned char*)sel_out, (unsigned long long*)nrows, (long long*)ovf,
      a);
  return (int)cudaGetLastError();
}
