// K1: masked scalar reduction (count / sum / min / max over live rows).
//
// Replaces oceanbase_tpu/ops/hashagg.py:384 scalar_aggregate (and the
// executor's scalar-aggregate path, engine/executor.py:3202-3215): one
// jnp.sum / jnp.min / jnp.max of jnp.where(mask, v, identity) per aggregate.
//
// Bound on an H100 (3.35 TB/s): it must read every mask byte and the values
// of the selected rows, N + selected * value bytes -- memory bound. For
// TPC-H Q6 at SF 10 (60M mask bytes; about 2% of the int64 values
// selected) that is about 0.02 ms.
//
// Design: one grid-stride pass, values widened to int64 in registers, a
// warp-shuffle then shared-memory block reduction. Integer inputs finish
// with one 64-bit atomic per block (add, or min/max on long long): integer
// atomics are exact and order-free, so the result is deterministic. Float
// inputs take a two-pass path instead -- per-block double partials, then one
// block folds them in a fixed order -- so repeated runs give the same bits.
// A float32 input is accumulated in double and narrowed at the end, while
// the plain version (like jnp.sum) adds in float32: the two agree to
// float32 rounding, not bit for bit.
#include "ob_common.cuh"

#define K1_THREADS 256

__global__ void k1_init(long long* out, long long ident) { *out = ident; }

template <typename T>
__global__ void k1_reduce_int(const T* __restrict__ v,
                              const unsigned char* __restrict__ m,
                              long long n, int op, long long ident,
                              long long* out) {
  long long acc = ident;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (m[i]) {
      long long x = (op == OB_COUNT) ? 1LL : (long long)v[i];
      acc = ob_combine_i64(op, acc, x);
    }
  }
  acc = ob_warp_reduce_i64(op, acc);
  __shared__ long long warp_acc[32];
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_acc[w] = acc;
  __syncthreads();
  if (w == 0) {
    int nw = blockDim.x >> 5;
    long long x = lane < nw ? warp_acc[lane] : ident;
    x = ob_warp_reduce_i64(op, x);
    if (lane == 0) ob_atomic_i64(op, out, x);
  }
}

template <typename T>
__global__ void k1_partial_f(const T* __restrict__ v,
                             const unsigned char* __restrict__ m, long long n,
                             int op, double ident, double* partials) {
  double acc = ident;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (m[i]) acc = ob_combine_f64(op, acc, (double)v[i]);
  }
  acc = ob_warp_reduce_f64(op, acc);
  __shared__ double warp_acc[32];
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_acc[w] = acc;
  __syncthreads();
  if (w == 0) {
    int nw = blockDim.x >> 5;
    double x = lane < nw ? warp_acc[lane] : ident;
    x = ob_warp_reduce_f64(op, x);
    if (lane == 0) partials[blockIdx.x] = x;
  }
}

// One block folds the per-block partials in a fixed order.
__global__ void k1_final_f(const double* __restrict__ partials, int nb, int op,
                           double ident, double* out) {
  __shared__ double part[K1_THREADS];
  double acc = ident;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    acc = ob_combine_f64(op, acc, partials[b]);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) {
      part[threadIdx.x] = ob_combine_f64(op, part[threadIdx.x],
                                         part[threadIdx.x + s]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = part[0];
}

// Integer inputs and count: out is one int64. ident is the identity of op
// in the input's own type (0 for count/sum). v may be null for count.
extern "C" int ob_k1_reduce_int(const void* v, int dt, const void* mask,
                                long long n, int op, long long ident,
                                void* out, int nblocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  long long* o = (long long*)out;
  const unsigned char* m = (const unsigned char*)mask;
  k1_init<<<1, 1, 0, s>>>(o, ident);
  switch (op == OB_COUNT ? OB_BOOL : dt) {
    case OB_BOOL:
    case OB_U8:
      k1_reduce_int<unsigned char><<<nblocks, K1_THREADS, 0, s>>>(
          (const unsigned char*)v, m, n, op, ident, o);
      break;
    case OB_I8:
      k1_reduce_int<signed char><<<nblocks, K1_THREADS, 0, s>>>(
          (const signed char*)v, m, n, op, ident, o);
      break;
    case OB_I16:
      k1_reduce_int<short><<<nblocks, K1_THREADS, 0, s>>>(
          (const short*)v, m, n, op, ident, o);
      break;
    case OB_I32:
      k1_reduce_int<int><<<nblocks, K1_THREADS, 0, s>>>(
          (const int*)v, m, n, op, ident, o);
      break;
    case OB_I64:
      k1_reduce_int<long long><<<nblocks, K1_THREADS, 0, s>>>(
          (const long long*)v, m, n, op, ident, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Float inputs (sum / min / max): out is one double; partials holds
// nblocks doubles of scratch.
extern "C" int ob_k1_reduce_float(const void* v, int dt, const void* mask,
                                  long long n, int op, double ident,
                                  void* out, void* partials, int nblocks,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* m = (const unsigned char*)mask;
  double* p = (double*)partials;
  if (dt == OB_F32) {
    k1_partial_f<float><<<nblocks, K1_THREADS, 0, s>>>(
        (const float*)v, m, n, op, ident, p);
  } else if (dt == OB_F64) {
    k1_partial_f<double><<<nblocks, K1_THREADS, 0, s>>>(
        (const double*)v, m, n, op, ident, p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  k1_final_f<<<1, K1_THREADS, 0, s>>>(p, nblocks, op, ident, (double*)out);
  return (int)cudaGetLastError();
}
