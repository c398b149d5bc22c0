// K27: the merge of the shards' partials -- every plane reduced
// elementwise over the shards, in shard order.
//
// Replaces oceanbase_tpu/parallel/exchange.py:166 merge_partials (psum
// over a pytree), the datahub-rollup merge of oceanbase_tpu/parallel/
// px.py:1069-1078 (psum of sum/count/approx_ndv partials, pmin, pmax;
// sel and validity planes as psum(int) > 0), the overflow psums at
// exchange.py:110 and px.py:1191, and the pmin/pmax of the range-bound
// key span (exchange.py:193-194).
//
// Bound on an H100 (3.35 TB/s): read every shard's plane once and write
// the merged plane once: (nsh + 1) * T * element bytes a plane. The
// planes are O(groups) (Q1: 4 slots of 10 columns), so a merge is one
// launch's latency.
//
// Design: one thread per element of each plane walks the shards 0..nsh-1
// and folds them in that order: integer sums wrap like int64 jnp, float
// sums add in the element type (float32 in float32) in shard order, so a
// merge gives the same bits on every run and equals the plain version's
// left fold bit for bit; min and max propagate NaN like jnp.minimum; the
// OR of a bool or int plane (psum > 0) writes a bool. The (plane, shard)
// addresses come through a device table, any number of each.
#include "ob_common.cuh"

#define K27_THREADS 256

#define K27_SUM 1
#define K27_MIN 2
#define K27_MAX 3
#define K27_OR 4

template <typename T>
__device__ __forceinline__ T k27_fold(int op, T a, T b) {
  if (op == K27_MIN) return b < a ? b : a;
  if (op == K27_MAX) return b > a ? b : a;
  return a + b;
}

template <typename T>
__device__ __forceinline__ T k27_fold_float(int op, T a, T b) {
  if (op == K27_MIN || op == K27_MAX) {
    if (a != a) return a;
    if (b != b) return b;
    if (op == K27_MIN) return b < a ? b : a;
    return b > a ? b : a;
  }
  return a + b;
}

template <typename T>
__device__ __forceinline__ void k27_int(int op, const long long* src,
                                        int nsh, void* dst, long long i) {
  T acc = ((const T*)src[0])[i];
  for (int s = 1; s < nsh; s++) {
    T v = ((const T*)src[s])[i];
    // two's-complement wrap for sums, as jnp's int arithmetic
    acc = op == K27_SUM ? (T)((unsigned long long)acc + (unsigned long long)v)
                        : k27_fold<T>(op, acc, v);
  }
  ((T*)dst)[i] = acc;
}

// table: np * nsh source addresses (plane-major), np destinations, np
// type codes, np op codes, np element counts.
__global__ void k27_merge(int np, int nsh, const long long* __restrict__ t) {
  const long long* dst = t + (long long)np * nsh;
  const long long* dts = dst + np;
  const long long* ops = dts + np;
  const long long* lens = ops + np;
  for (int c = blockIdx.y; c < np; c += gridDim.y) {
    const long long* src = t + (long long)c * nsh;
    int dt = (int)dts[c], op = (int)ops[c];
    long long n = lens[c];
    long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
      if (op == K27_OR) {
        bool any = false;
        for (int s = 0; s < nsh; s++) {
          any = any || ob_ldg_i64((const void*)src[s], dt, i) != 0;
        }
        ((unsigned char*)dst[c])[i] = any ? 1 : 0;
      } else if (dt == OB_F64) {
        double acc = ((const double*)src[0])[i];
        for (int s = 1; s < nsh; s++) {
          acc = k27_fold_float<double>(op, acc, ((const double*)src[s])[i]);
        }
        ((double*)dst[c])[i] = acc;
      } else if (dt == OB_F32) {
        float acc = ((const float*)src[0])[i];
        for (int s = 1; s < nsh; s++) {
          acc = k27_fold_float<float>(op, acc, ((const float*)src[s])[i]);
        }
        ((float*)dst[c])[i] = acc;
      } else if (dt == OB_I64) {
        k27_int<long long>(op, src, nsh, (void*)dst[c], i);
      } else if (dt == OB_I32) {
        k27_int<int>(op, src, nsh, (void*)dst[c], i);
      } else if (dt == OB_I16) {
        k27_int<short>(op, src, nsh, (void*)dst[c], i);
      } else if (dt == OB_I8) {
        k27_int<signed char>(op, src, nsh, (void*)dst[c], i);
      } else {
        k27_int<unsigned char>(op, src, nsh, (void*)dst[c], i);
      }
    }
  }
}

extern "C" int ob_k27_merge(int np, int nsh, const void* table, int blocks,
                            int planes_per_grid, void* stream) {
  if (np < 1 || nsh < 1 || planes_per_grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)blocks, (unsigned)planes_per_grid);
  k27_merge<<<grid, K27_THREADS, 0, (cudaStream_t)stream>>>(
      np, nsh, (const long long*)table);
  return (int)cudaGetLastError();
}
