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
// Design: one launch. Every block repeats the binary searches (one thread
// per bound, about 26 dependent probes over 60M keys, the bound cast to
// the key's width first as the reference's astype does), then copies its
// share of the `cap` rows of every column through a pointer table grouped
// by element width (as K4 does) and counts its live rows into nrows with
// one atomic per warp. Block 0 writes the overflow.
#include "ob_common.cuh"

#define K17_THREADS 256
#define K17_MAX_COLS 48
#define K17_MAX_BOUNDS 16

struct K17Args {
  const void* src[K17_MAX_COLS];
  void* dst[K17_MAX_COLS];
  int gstart[5];  // columns [gstart[g], gstart[g+1]) have width gwidth[g]
  int gwidth[4];
  const void* bval[K17_MAX_BOUNDS];  // 0-d bound tensors
  int bdt[K17_MAX_BOUNDS];           // their element type codes
  int bflag[K17_MAX_BOUNDS];         // bit 0: side right; bit 1: high bound
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

template <typename T>
__device__ __forceinline__ void k17_copy_row(const K17Args& a, int c0, int c1,
                                             long long r, long long s) {
  for (int c = c0; c < c1; c++) {
    ((T*)a.dst[c])[r] = ((const T*)a.src[c])[s];
  }
}

__global__ void k17_slice(const void* __restrict__ key, int key_dt,
                          long long n, long long cap, long long cap2,
                          const unsigned char* __restrict__ sel_in,
                          unsigned char* __restrict__ sel_out,
                          unsigned long long* nrows, long long* ovf,
                          K17Args a) {
  __shared__ long long s_pos[K17_MAX_BOUNDS];
  __shared__ long long s_lo, s_hi, s_start;
  int t = threadIdx.x;
  if (t < a.nbounds) {
    long long v = k17_as_key(ob_ldg_i64(a.bval[t], a.bdt[t], 0), key_dt);
    s_pos[t] = k17_search(key, key_dt, n, v, (a.bflag[t] & 1) != 0);
  }
  __syncthreads();
  if (t == 0) {
    long long lo = 0, hi = n;
    for (int b = 0; b < a.nbounds; b++) {
      if (a.bflag[b] & 2) {
        hi = s_pos[b] < hi ? s_pos[b] : hi;
      } else {
        lo = s_pos[b] > lo ? s_pos[b] : lo;
      }
    }
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
  unsigned int live = 0;
  for (long long r = (long long)blockIdx.x * blockDim.x + t; r < cap;
       r += stride) {
    long long s = start + r;
    for (int g = 0; g < 4; g++) {
      int c0 = a.gstart[g], c1 = a.gstart[g + 1];
      if (c0 == c1) continue;
      switch (a.gwidth[g]) {
        case 1: k17_copy_row<unsigned char>(a, c0, c1, r, s); break;
        case 2: k17_copy_row<unsigned short>(a, c0, c1, r, s); break;
        case 4: k17_copy_row<unsigned int>(a, c0, c1, r, s); break;
        default: k17_copy_row<unsigned long long>(a, c0, c1, r, s); break;
      }
    }
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
}

// key: the sort-key column (element type key_dt), its first n rows sorted;
// cap: the slice capacity; cap2: the capacity of every column (> cap);
// bval/bdt/bflag: nbounds bounds; src/dst/gstart/gwidth: the columns and
// validity masks grouped by width, as K4; sel_in [cap2] -> sel_out [cap];
// nrows: one zeroed int64; ovf: one int64.
extern "C" int ob_k17_slice(const void* key, int key_dt, long long n,
                            long long cap, long long cap2, int nbounds,
                            const void* const* bval, const int* bdt,
                            const int* bflag, int ncols,
                            const void* const* src, void* const* dst,
                            const int* gstart, const int* gwidth,
                            const void* sel_in, void* sel_out, void* nrows,
                            void* ovf, int nblocks, void* stream) {
  if (ncols < 0 || ncols > K17_MAX_COLS || nbounds < 0 ||
      nbounds > K17_MAX_BOUNDS || cap < 1 || cap > cap2 || n > cap2) {
    return (int)cudaErrorInvalidValue;
  }
  K17Args a;
  for (int c = 0; c < ncols; c++) {
    a.src[c] = src[c];
    a.dst[c] = dst[c];
  }
  for (int g = 0; g < 5; g++) a.gstart[g] = gstart[g];
  for (int g = 0; g < 4; g++) a.gwidth[g] = gwidth[g];
  for (int b = 0; b < nbounds; b++) {
    a.bval[b] = bval[b];
    a.bdt[b] = bdt[b];
    a.bflag[b] = bflag[b];
  }
  a.nbounds = nbounds;
  k17_slice<<<nblocks, K17_THREADS, 0, (cudaStream_t)stream>>>(
      key, key_dt, n, cap, cap2, (const unsigned char*)sel_in,
      (unsigned char*)sel_out, (unsigned long long*)nrows, (long long*)ovf,
      a);
  return (int)cudaGetLastError();
}
