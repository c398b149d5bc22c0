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
