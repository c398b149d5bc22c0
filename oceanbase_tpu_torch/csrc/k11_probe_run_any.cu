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
