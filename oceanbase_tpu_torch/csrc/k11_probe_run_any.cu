// K11: per probe row, whether any pair of its run passed.
//
// Replaces oceanbase_tpu/ops/join.py:228 probe_run_any: the OR of
// pair_ok over each probe row's run of output slots
// [min(starts, cap), min(offs, cap)), the runs that expand_join (K10)
// laid out. The reference computes it scatter-free as a cumsum of pair_ok
// and two gathers at the run bounds; the result is the same bool.
//
// Bound on an H100 (3.35 TB/s): it reads starts and offs (16 bytes a
// probe row), pair_ok once (1 byte a slot) and writes 1 byte a probe row:
// bytes bound.
//
// Design: one thread per probe row walks its own run and stops at the
// first passing pair; the runs are disjoint and ascending in probe order,
// so neighbouring threads read neighbouring bytes. Runs of TPC-H's joins
// are short (a customer's orders, an order's lines); a warp per row would
// serve long runs and is left for a later PR.
//
// Second entry, ob_k11_mark_build: the build side's matched bit of the
// full outer join (oceanbase_tpu/engine/executor.py:2998-2999,
// zeros(nr).at[br].max(pair_sel, mode="drop")): has_r[br[i]] = 1 for
// every pair slot i whose pair_sel is set, build rows outside [0, nr)
// dropped. It reads 5 bytes a pair slot and writes the bit rows it marks
// (bytes bound). The stores all write 1, so they need no atomics and the
// result does not depend on their order.
#include "ob_common.cuh"

#define K11_THREADS 256

__global__ void k11_run_any(const unsigned char* __restrict__ pair_ok,
                            long long cap,
                            const long long* __restrict__ starts,
                            const long long* __restrict__ offs, long long np,
                            unsigned char* __restrict__ out) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < np;
       p += step) {
    long long a = __ldg(starts + p), b = __ldg(offs + p);
    a = a < cap ? a : cap;
    b = b < cap ? b : cap;
    unsigned char any = 0;
    for (long long t = a; t < b; t++) {
      if (__ldg(pair_ok + t)) {
        any = 1;
        break;
      }
    }
    out[p] = any;
  }
}

// pair_ok: bool [cap]; starts, offs: int64 [np]; out: bool [np].
extern "C" int ob_k11_run_any(const void* pair_ok, long long cap,
                              const void* starts, const void* offs,
                              long long np, void* out, int nblocks,
                              void* stream) {
  if (np <= 0) return (int)cudaGetLastError();
  k11_run_any<<<nblocks, K11_THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)pair_ok, cap, (const long long*)starts,
      (const long long*)offs, np, (unsigned char*)out);
  return (int)cudaGetLastError();
}

__global__ void k11_mark_build(const int* __restrict__ br,
                               const unsigned char* __restrict__ pair_sel,
                               long long cap, long long nr,
                               unsigned char* __restrict__ has_r) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < cap; i += step) {
    if (!__ldg(pair_sel + i)) continue;
    long long r = __ldg(br + i);
    if (r >= 0 && r < nr) has_r[r] = 1;
  }
}

// br: int32 [cap] build rows of the pair slots; pair_sel: bool [cap];
// has_r: bool [nr], zeroed by the caller.
extern "C" int ob_k11_mark_build(const void* br, const void* pair_sel,
                                 long long cap, long long nr, void* has_r,
                                 int nblocks, void* stream) {
  if (cap <= 0 || nr <= 0) return (int)cudaGetLastError();
  k11_mark_build<<<nblocks, K11_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)br, (const unsigned char*)pair_sel, cap, nr,
      (unsigned char*)has_r);
  return (int)cudaGetLastError();
}
