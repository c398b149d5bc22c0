// K6: clustered-FK segment aggregation -- per build row, the count and the
// sums of the live probe rows in its range [starts[i], ends[i]).
//
// Replaces oceanbase_tpu/engine/executor.py:1779 _emit_clustered_agg: when
// the probe table is stored clustered by the join key, build row i joins
// exactly the probe rows [starts[i], ends[i]) (host searchsorted ranges),
// and an Aggregate over the PK-FK join collapses into one reduction per
// range. The reference takes differences of whole-array cumsums gathered
// at the range bounds. K6 sums each range directly: for int64 sums the two
// give the same bits (two's-complement wraparound makes the cumsum
// difference exact); float sums accumulate in double here and in the
// value's own type as cumsum differences there, so they agree to rounding.
//
// Bound on an H100 (3.35 TB/s): one read of the ranges, the probe sel and
// each aggregate's probe values and mask, plus one write of the count and
// each sum per build row -- memory bound.
//
// Design: one thread per build row (grid-stride). The ranges are sorted and
// contiguous, so the threads of a warp walk consecutive probe rows and
// their loads fall into the same sectors. Empty ranges (padded build rows
// carry [0, 0)) give 0. A build row whose range is very long is summed by
// one thread; TPC-H's clustered keys carry 1 to 7 rows per range.
#include "ob_common.cuh"

#define K6_THREADS 256
#define K6_MAX_AGGS 16

struct K6Args {
  const void* val[K6_MAX_AGGS];    // null for count(col)
  const void* mask[K6_MAX_AGGS];   // null: no validity mask
  void* out[K6_MAX_AGGS];          // int64, or double for float sums
  int dt[K6_MAX_AGGS];
  int isf[K6_MAX_AGGS];
  int nagg;
};

__global__ void k6_segments(const int* __restrict__ starts,
                            const int* __restrict__ ends, long long nbuild,
                            const unsigned char* __restrict__ sel,
                            long long* __restrict__ cnt, K6Args a) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nbuild; i += step) {
    long long s = starts[i], e = ends[i];
    long long c = 0;
    for (long long j = s; j < e; j++) c += sel[j] ? 1 : 0;
    cnt[i] = c;
    for (int k = 0; k < a.nagg; k++) {
      const unsigned char* m = (const unsigned char*)a.mask[k];
      if (a.isf[k]) {
        double acc = 0.0;
        for (long long j = s; j < e; j++) {
          if (sel[j] && (!m || m[j])) acc += ob_ldg_f64(a.val[k], a.dt[k], j);
        }
        ((double*)a.out[k])[i] = acc;
      } else {
        unsigned long long acc = 0ULL;
        for (long long j = s; j < e; j++) {
          if (sel[j] && (!m || m[j])) {
            acc += a.val[k] ? (unsigned long long)ob_ldg_i64(a.val[k], a.dt[k], j)
                            : 1ULL;
          }
        }
        ((long long*)a.out[k])[i] = (long long)acc;
      }
    }
  }
}

// starts/ends: int32 [nbuild]; sel: bool probe mask; cnt: int64 [nbuild].
// Per aggregate k: val (dtype code dt, or null to count), mask (bool or
// null), out ([nbuild] int64, or double when isf).
extern "C" int ob_k6_segments(const void* starts, const void* ends,
                              long long nbuild, const void* sel, void* cnt,
                              int nagg, const void* const* vals,
                              const void* const* masks, void* const* outs,
                              const int* dts, const int* isf, int nblocks,
                              void* stream) {
  if (nagg < 0 || nagg > K6_MAX_AGGS) return (int)cudaErrorInvalidValue;
  K6Args a;
  a.nagg = nagg;
  for (int k = 0; k < nagg; k++) {
    a.val[k] = vals[k];
    a.mask[k] = masks[k];
    a.out[k] = outs[k];
    a.dt[k] = dts[k];
    a.isf[k] = isf[k];
  }
  k6_segments<<<nblocks, K6_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)ends, nbuild,
      (const unsigned char*)sel, (long long*)cnt, a);
  return (int)cudaGetLastError();
}
