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
// one thread; TPC-H's clustered keys carry 1 to 7 rows per range. The
// aggregates' addresses and codes come from a table in device memory, so
// one launch takes any number of aggregates and walks the ranges once.
#include "ob_common.cuh"

#define K6_THREADS 256
#define K6_FIELDS 5

// The aggregates' table: K6_FIELDS int64 entries per aggregate k, at
// t[k * K6_FIELDS]: the values' address (0 for count(col)), the mask's
// address (0: no validity mask), the output's address (int64, or double
// for float sums), the values' type code, 1 for a float sum.
struct K6Args {
  const long long* t;
  int nagg;
};

__device__ __forceinline__ long long k6_field(const K6Args& a, int k, int f) {
  return __ldg(a.t + (long long)k * K6_FIELDS + f);
}

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
      const void* val = (const void*)k6_field(a, k, 0);
      const unsigned char* m = (const unsigned char*)k6_field(a, k, 1);
      void* out = (void*)k6_field(a, k, 2);
      int dt = (int)k6_field(a, k, 3);
      if (k6_field(a, k, 4)) {
        double acc = 0.0;
        for (long long j = s; j < e; j++) {
          if (sel[j] && (!m || m[j])) acc += ob_ldg_f64(val, dt, j);
        }
        ((double*)out)[i] = acc;
      } else {
        unsigned long long acc = 0ULL;
        for (long long j = s; j < e; j++) {
          if (sel[j] && (!m || m[j])) {
            acc += val ? (unsigned long long)ob_ldg_i64(val, dt, j) : 1ULL;
          }
        }
        ((long long*)out)[i] = (long long)acc;
      }
    }
  }
}

// starts/ends: int32 [nbuild]; sel: bool probe mask; cnt: int64 [nbuild].
// table: nagg aggregates' entries in device memory (K6Args): per
// aggregate the values (dtype code, or null to count), the mask (bool or
// null) and the output ([nbuild] int64, or double for a float sum).
extern "C" int ob_k6_segments(const void* starts, const void* ends,
                              long long nbuild, const void* sel, void* cnt,
                              int nagg, const void* table, int nblocks,
                              void* stream) {
  if (nagg < 0 || (nagg > 0 && table == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  K6Args a;
  a.t = (const long long*)table;
  a.nagg = nagg;
  k6_segments<<<nblocks, K6_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)ends, nbuild,
      (const unsigned char*)sel, (long long*)cnt, a);
  return (int)cudaGetLastError();
}
