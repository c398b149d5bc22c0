// Shared definitions of the port's CUDA kernels (sm_90a, plain C ABI,
// loaded with ctypes by oceanbase_tpu_torch/kernels.py).
//
// Element type codes (kernels.py DTYPE_CODE must match):
//   0 bool, 1 int8, 2 int16, 3 int32, 4 int64, 5 float32, 6 float64, 7 uint8
// Aggregate op codes (kernels.py AGG_CODE must match):
//   0 count, 1 sum, 2 min, 3 max
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define OB_BOOL 0
#define OB_I8 1
#define OB_I16 2
#define OB_I32 3
#define OB_I64 4
#define OB_F32 5
#define OB_F64 6
#define OB_U8 7

#define OB_COUNT 0
#define OB_SUM 1
#define OB_MIN 2
#define OB_MAX 3

#define OB_FULL_MASK 0xffffffffu

static inline __host__ __device__ bool ob_is_float(int dt) {
  return dt == OB_F32 || dt == OB_F64;
}

// Load element i of a typed column widened to int64 (integer types) or to
// double (floats), through the read-only data path (ld.global.nc): the
// compiler may then hoist the loads above shared-memory stores.
__device__ __forceinline__ long long ob_ldg_i64(const void* p, int dt,
                                                long long i) {
  switch (dt) {
    case OB_BOOL: return __ldg((const unsigned char*)p + i) ? 1 : 0;
    case OB_I8: return __ldg((const signed char*)p + i);
    case OB_U8: return __ldg((const unsigned char*)p + i);
    case OB_I16: return __ldg((const short*)p + i);
    case OB_I32: return __ldg((const int*)p + i);
    default: return __ldg((const long long*)p + i);
  }
}

__device__ __forceinline__ double ob_ldg_f64(const void* p, int dt,
                                             long long i) {
  if (dt == OB_F32) return (double)__ldg((const float*)p + i);
  return __ldg((const double*)p + i);
}

// Bytes sh .. sh + 15 of the 32 bytes A:B (little endian), sh in 1..15.
__device__ __forceinline__ uint4 ob_funnel16(uint4 A, uint4 B, int sh) {
  int r = (sh & 3) * 8;
  unsigned o0, o1, o2, o3;
  switch (sh >> 2) {
    case 0:
      o0 = __funnelshift_r(A.x, A.y, r);
      o1 = __funnelshift_r(A.y, A.z, r);
      o2 = __funnelshift_r(A.z, A.w, r);
      o3 = __funnelshift_r(A.w, B.x, r);
      break;
    case 1:
      o0 = __funnelshift_r(A.y, A.z, r);
      o1 = __funnelshift_r(A.z, A.w, r);
      o2 = __funnelshift_r(A.w, B.x, r);
      o3 = __funnelshift_r(B.x, B.y, r);
      break;
    case 2:
      o0 = __funnelshift_r(A.z, A.w, r);
      o1 = __funnelshift_r(A.w, B.x, r);
      o2 = __funnelshift_r(B.x, B.y, r);
      o3 = __funnelshift_r(B.y, B.z, r);
      break;
    default:
      o0 = __funnelshift_r(A.w, B.x, r);
      o1 = __funnelshift_r(B.x, B.y, r);
      o2 = __funnelshift_r(B.y, B.z, r);
      o3 = __funnelshift_r(B.z, B.w, r);
      break;
  }
  return make_uint4(o0, o1, o2, o3);
}

__device__ __forceinline__ long long ob_combine_i64(int op, long long a,
                                                    long long b) {
  if (op == OB_MIN) return b < a ? b : a;
  if (op == OB_MAX) return b > a ? b : a;
  return a + b;  // count / sum: two's-complement wraparound like int64 jnp
}

// NaN-propagating min/max (jnp.min / jnp.max semantics).
__device__ __forceinline__ double ob_combine_f64(int op, double a, double b) {
  if (op == OB_MIN || op == OB_MAX) {
    if (a != a) return a;
    if (b != b) return b;
    if (op == OB_MIN) return b < a ? b : a;
    return b > a ? b : a;
  }
  return a + b;
}

__device__ __forceinline__ long long ob_warp_reduce_i64(int op, long long x) {
  for (int o = 16; o > 0; o >>= 1) {
    x = ob_combine_i64(op, x, __shfl_xor_sync(OB_FULL_MASK, x, o));
  }
  return x;
}

__device__ __forceinline__ double ob_warp_reduce_f64(int op, double x) {
  for (int o = 16; o > 0; o >>= 1) {
    x = ob_combine_f64(op, x, __shfl_xor_sync(OB_FULL_MASK, x, o));
  }
  return x;
}

// Atomic combine of an int64 partial into memory (shared or global).
__device__ __forceinline__ void ob_atomic_i64(int op, long long* p,
                                              long long x) {
  if (op == OB_MIN) {
    atomicMin(p, x);
  } else if (op == OB_MAX) {
    atomicMax(p, x);
  } else {
    atomicAdd((unsigned long long*)p, (unsigned long long)x);
  }
}

// splitmix64 finalizer (oceanbase_tpu/ops/hashing.py:32 mix64), uint64
// arithmetic wrapping modulo 2^64 as jnp's uint64 does.
#define OB_MIX_C1 0xBF58476D1CE4E5B9ull
#define OB_MIX_C2 0x94D049BB133111EBull
#define OB_GOLDEN64 0x9E3779B97F4A7C15ull

__device__ __forceinline__ unsigned long long ob_mix64(unsigned long long x) {
  x = (x ^ (x >> 30)) * OB_MIX_C1;
  x = (x ^ (x >> 27)) * OB_MIX_C2;
  return x ^ (x >> 31);
}

// murmur3 fmix32 (oceanbase_tpu/ops/hashing.py:48 mix32) and the
// width-stable 32-bit fold of a key column (:63 fold32), uint32 wrapping.
#define OB_MIX32_M1 0x85EBCA6Bu
#define OB_MIX32_M2 0xC2B2AE35u
#define OB_GOLDEN32 0x9E3779B9u

__device__ __forceinline__ unsigned int ob_mix32(unsigned int x) {
  x = (x ^ (x >> 16)) * OB_MIX32_M1;
  x = (x ^ (x >> 13)) * OB_MIX32_M2;
  return x ^ (x >> 16);
}

// fold32 of a 64-bit pattern: xor of the high word into the low one.
__device__ __forceinline__ unsigned int ob_fold64(unsigned long long u) {
  return (unsigned int)(u ^ (u >> 32));
}

// fold32 of element i: columns of at most 4 bytes convert to int32 and
// fold the sign in (i ^ (i >> 31), arithmetic shift); 8-byte columns
// convert to uint64 and fold the high word. Float conversions truncate
// toward zero and saturate, NaN giving 0, as XLA converts (float32 to
// int32; float64 to uint64, so every negative double gives 0).
__device__ __forceinline__ unsigned int ob_fold32(const void* p, int dt,
                                                  long long i) {
  if (dt == OB_F32) {
    float f = __ldg((const float*)p + i);
    int v;
    if (f != f) {
      v = 0;
    } else if (f >= 2147483648.0f) {
      v = 2147483647;
    } else if (f <= -2147483648.0f) {
      v = (int)0x80000000u;
    } else {
      v = (int)f;
    }
    return (unsigned int)(v ^ (v >> 31));
  }
  if (dt == OB_F64) {
    double d = __ldg((const double*)p + i);
    unsigned long long u;
    if (!(d >= 1.0)) {
      u = 0ull;  // NaN, every negative, and (-1, 1) truncate to 0
    } else if (d >= 18446744073709551616.0) {
      u = ~0ull;
    } else {
      u = (unsigned long long)d;
    }
    return ob_fold64(u);
  }
  if (dt == OB_I64) {
    return ob_fold64((unsigned long long)__ldg((const long long*)p + i));
  }
  int v = (int)ob_ldg_i64(p, dt, i);
  return (unsigned int)(v ^ (v >> 31));
}

// Order-preserving unsigned image of a float32 (the sign bit flipped for
// non-negatives, every bit for negatives), so that unsigned order is
// numeric order. -0.0 maps to +0.0's image (they compare equal) and every
// NaN to the positive quiet NaN's, above +inf: torch.sort's order.
#define OB_F32_INF_IMAGE 0xFF800000u

__device__ __forceinline__ unsigned int ob_f32_image(float v) {
  if (v != v) return 0xFFC00000u;
  if (v == 0.0f) v = 0.0f;
  unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The float32 of an ob_f32_image (-0.0 comes back as +0.0, a NaN as the
// positive quiet NaN).
__device__ __forceinline__ float ob_f32_from_image(unsigned int b) {
  return (b & 0x80000000u) ? __uint_as_float(b & 0x7fffffffu)
                           : __uint_as_float(~b);
}

// Exclusive block-wide sum of one int64 per thread (blockDim.x a
// multiple of 32, at most 1024); *total gets the block's sum. Every
// thread of the block must call it.
__device__ __forceinline__ long long ob_block_exscan(long long v,
                                                     long long* total) {
  __shared__ long long ob_warp_sums[32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long y = __shfl_up_sync(OB_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ob_warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < nwarps ? ob_warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(OB_FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) ob_warp_sums[lane] = s;  // inclusive warp prefixes
  }
  __syncthreads();
  long long before = (warp > 0 ? ob_warp_sums[warp - 1] : 0) + (x - v);
  *total = ob_warp_sums[nwarps - 1];
  __syncthreads();  // the sums are reused by the next call
  return before;
}

// hash32_combine (oceanbase_tpu/ops/hashing.py:76) of row i over ncols
// key columns read through a device table: cols[j] the column's address,
// dts[j] its type code.
__device__ __forceinline__ unsigned int ob_hash32_row(
    int ncols, const long long* __restrict__ cols,
    const long long* __restrict__ dts, long long i) {
  unsigned int h = 0u;
  for (int j = 0; j < ncols; j++) {
    h = ob_mix32(h ^ (ob_fold32((const void*)cols[j], (int)dts[j], i) +
                      OB_GOLDEN32));
  }
  return h;
}

// A tuple of key columns read through an int64 table in device memory
// (K12's hash, K14's hash set, K15's first rows, K29's group-by; K8
// keeps the same two entries a column in its own table): t[j] is column
// j's address and t[ncols + j] its type code;
// a kernel may keep more per-column entries after those (K29 its key
// outputs at t[2 ncols + j]). The table is not passed by value, so a
// tuple takes any number of columns.
struct ObKeys {
  const long long* t;
  int ncols;
};

// An ObKeys over a device table; 0 when ncols < 1 or the table is null.
static inline int ob_keys_set(ObKeys* k, int ncols, const void* table) {
  if (ncols < 1 || table == nullptr) return 0;
  k->t = (const long long*)table;
  k->ncols = ncols;
  return 1;
}

__device__ __forceinline__ const void* ob_key_col(const ObKeys& k, int j) {
  return (const void*)__ldg(k.t + j);
}

__device__ __forceinline__ int ob_key_dt(const ObKeys& k, int j) {
  return (int)__ldg(k.t + k.ncols + j);
}

// hash32_combine (oceanbase_tpu/ops/hashing.py:76) of row i of a key
// tuple: h = 0; for each column c: h = mix32(h ^ (fold32(c) + GOLDEN32)).
__device__ __forceinline__ unsigned int ob_keys_hash32(const ObKeys& c,
                                                       long long i) {
  unsigned int h = 0u;
  for (int j = 0; j < c.ncols; j++) {
    h = ob_mix32(h ^ (ob_fold32(ob_key_col(c, j), ob_key_dt(c, j), i) +
                      OB_GOLDEN32));
  }
  return h;
}

// Row a of key tuple x equals row b of key tuple y, column by column with
// `==` (in double where either side is a float, so NaN never equals and
// -0.0 equals 0.0).
__device__ __forceinline__ bool ob_keys_equal(const ObKeys& x, long long a,
                                              const ObKeys& y, long long b) {
  for (int j = 0; j < x.ncols; j++) {
    const void* xc = ob_key_col(x, j);
    const void* yc = ob_key_col(y, j);
    int xd = ob_key_dt(x, j), yd = ob_key_dt(y, j);
    if (ob_is_float(xd) || ob_is_float(yd)) {
      double u = ob_is_float(xd) ? ob_ldg_f64(xc, xd, a)
                                 : (double)ob_ldg_i64(xc, xd, a);
      double v = ob_is_float(yd) ? ob_ldg_f64(yc, yd, b)
                                 : (double)ob_ldg_i64(yc, yd, b);
      if (!(u == v)) return false;
    } else if (ob_ldg_i64(xc, xd, a) != ob_ldg_i64(yc, yd, b)) {
      return false;
    }
  }
  return true;
}

// Running top-k selections over unique 64-bit keys (K22's IVF probe,
// K31's sharded probe): a run is the kk smallest keys seen so far, sorted,
// padded with OB_RUN_EMPTY. The run and its merge buffer may lie in shared
// or in device memory (generic addresses).
#define OB_RUN_EMPTY 0xffffffffffffffffULL

// Merge `tile` (m keys in any order; OB_RUN_EMPTY = none) into `run`,
// the sorted kk smallest keys so far (OB_RUN_EMPTY-padded). Keys other
// than OB_RUN_EMPTY are unique. Called by every thread of the block.
static __device__ void ob_run_merge_tile(unsigned long long* run,
                                         unsigned long long* nrun,
                                         const unsigned long long* tile,
                                         int m, int kk) {
  for (int r = threadIdx.x; r < kk; r += blockDim.x) nrun[r] = OB_RUN_EMPTY;
  __syncthreads();
  const unsigned long long thr = run[kk - 1];
  for (int e = threadIdx.x; e < kk + m; e += blockDim.x) {
    unsigned long long v = e < kk ? run[e] : tile[e - kk];
    if (v == OB_RUN_EMPTY) continue;
    int rank;
    if (e < kk) {
      rank = e;  // the run is sorted and its keys unique
    } else {
      if (v > thr) continue;  // kk smaller keys already held
      int lo = 0, hi = kk;
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (run[mid] < v) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      rank = lo;
    }
    for (int t = 0; t < m && rank < kk; t++) rank += tile[t] < v;
    if (rank < kk) nrun[rank] = v;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kk; r += blockDim.x) run[r] = nrun[r];
  __syncthreads();
}

// The first index of a sorted run of m keys holding a key >= v.
__device__ __forceinline__ int ob_run_lower(const unsigned long long* run,
                                            int m, unsigned long long v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (run[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Merge the sorted run `tile` (kk keys, OB_RUN_EMPTY-padded) into `run`
// (the same shape): a key's rank is its index in its own run plus the
// smaller keys of the other, found by a binary search. Called by every
// thread of the block.
static __device__ void ob_run_merge_sorted(unsigned long long* run,
                                           unsigned long long* nrun,
                                           const unsigned long long* tile,
                                           int kk) {
  for (int r = threadIdx.x; r < kk; r += blockDim.x) nrun[r] = OB_RUN_EMPTY;
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * kk; e += blockDim.x) {
    bool mine = e < kk;
    unsigned long long v = mine ? run[e] : tile[e - kk];
    if (v == OB_RUN_EMPTY) continue;
    int rank = (mine ? e : e - kk) + ob_run_lower(mine ? tile : run, kk, v);
    if (rank < kk) nrun[rank] = v;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kk; r += blockDim.x) run[r] = nrun[r];
  __syncthreads();
}

// Copy element `s` of a plane of `esize`-byte elements to element `d` of
// another (a zero when s < 0). An element wider than 8 bytes is a
// fixed-width row (a VECTOR column's d float32 values), copied a 4-byte
// word at a time when its width allows, else a byte at a time.
__device__ __forceinline__ void ob_copy_elem(const void* src, void* dst,
                                             int esize, long long s,
                                             long long d) {
  if (esize > 8) {
    if ((esize & 3) == 0) {
      const int nw = esize >> 2;
      const unsigned int* sp = (const unsigned int*)src + s * nw;
      unsigned int* dp = (unsigned int*)dst + d * nw;
      for (int k = 0; k < nw; k++) dp[k] = s < 0 ? 0u : sp[k];
    } else {
      const unsigned char* sp = (const unsigned char*)src + s * esize;
      unsigned char* dp = (unsigned char*)dst + d * esize;
      for (int k = 0; k < esize; k++) dp[k] = s < 0 ? 0 : sp[k];
    }
    return;
  }
  switch (esize) {
    case 1:
      ((unsigned char*)dst)[d] =
          s < 0 ? 0 : ((const unsigned char*)src)[s];
      break;
    case 2:
      ((unsigned short*)dst)[d] =
          s < 0 ? 0 : ((const unsigned short*)src)[s];
      break;
    case 4:
      ((unsigned int*)dst)[d] = s < 0 ? 0u : ((const unsigned int*)src)[s];
      break;
    default:
      ((unsigned long long*)dst)[d] =
          s < 0 ? 0ull : ((const unsigned long long*)src)[s];
      break;
  }
}
