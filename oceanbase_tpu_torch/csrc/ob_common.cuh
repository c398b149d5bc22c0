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

static inline bool ob_is_float(int dt) { return dt == OB_F32 || dt == OB_F64; }

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
