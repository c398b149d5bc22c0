// K9: the unique-build equi-join on one integer key column.
//
// Replaces oceanbase_tpu/ops/join.py:120 merge_join_unique: for each probe
// row, in probe order, the build row whose live key equals the live probe
// key, or -1; among live build rows with equal keys the lowest row index
// wins (the row that sorts first in the reference's combined sort of
// (dead, key, side, row)). Keys are int64 over the whole domain, so no key
// value can mark an empty slot or a dead row.
//
// Bound on an H100 (3.35 TB/s): it reads the build key and sel, the probe
// key and sel, and writes the int32 match row of every probe row; the
// keys of dead rows need not be read, and a reader of a few live rows out
// of many pays 32-byte sectors. The table's own traffic (4 bytes a slot
// cleared, one random slot and one random build key per probe step) is on
// top of that bound.
//
// Design: the reference sorts build ++ probe because scatters cost about
// a second on a TPU; on this card an open-addressing table of T = 2^k >=
// 2 nb int32 slots does the join in three launches with no sort at all.
// (1) Clear every slot to -1 (emptiness is marked out of band, in the row
// slot, never by a key value). (2) One thread per live build row walks
// linear probes from mix64(key) & (T - 1): atomicCAS(-1 -> row) claims an
// empty slot; a slot that holds a row with an equal key (read from the
// build key column through the row, so a slot's key never changes) takes
// atomicMin(row), so the lowest live row of each key wins whatever the
// order the threads run in. (3) One thread per live probe row walks the
// same probes until an empty slot or an equal key and writes the match
// row straight into probe order: the reference's inverse-permutation sort
// disappears. The result does not depend on the schedule, so two runs
// give the same bits.
#include "ob_common.cuh"

#define K9_THREADS 256

__global__ void k9_clear(int* __restrict__ slot, long long tsize) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < tsize; i += step) {
    slot[i] = -1;
  }
}

__global__ void k9_build(const void* __restrict__ bkey, int bdt,
                         const unsigned char* __restrict__ bsel, long long nb,
                         int* slot, unsigned long long tmask) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nb;
       i += step) {
    if (!__ldg(bsel + i)) continue;
    long long key = ob_ldg_i64(bkey, bdt, i);
    unsigned long long s = ob_mix64((unsigned long long)key) & tmask;
    while (true) {
      int cur = atomicCAS(slot + s, -1, (int)i);
      if (cur < 0) break;
      if (ob_ldg_i64(bkey, bdt, cur) == key) {
        atomicMin(slot + s, (int)i);
        break;
      }
      s = (s + 1) & tmask;
    }
  }
}

__global__ void k9_probe(const void* __restrict__ pkey, int pdt,
                         const unsigned char* __restrict__ psel, long long np,
                         const void* __restrict__ bkey, int bdt,
                         const int* __restrict__ slot, unsigned long long tmask,
                         int* __restrict__ match) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < np;
       i += step) {
    int m = -1;
    if (__ldg(psel + i)) {
      long long key = ob_ldg_i64(pkey, pdt, i);
      unsigned long long s = ob_mix64((unsigned long long)key) & tmask;
      while (true) {
        int cur = __ldg(slot + s);
        if (cur < 0) break;
        if (ob_ldg_i64(bkey, bdt, cur) == key) {
          m = cur;
          break;
        }
        s = (s + 1) & tmask;
      }
    }
    match[i] = m;
  }
}

// bkey/bsel: build key (type code bdt) and sel, nb rows; pkey/psel: probe
// key (type code pdt) and sel, np rows; slot: int32 scratch of tsize (a
// power of two >= 2 nb) slots; match: int32 [np].
extern "C" int ob_k9_merge_join(const void* bkey, int bdt, const void* bsel,
                                long long nb, const void* pkey, int pdt,
                                const void* psel, long long np, void* slot,
                                long long tsize, void* match, int nblocks,
                                void* stream) {
  if (tsize < 2 * nb || (tsize & (tsize - 1)) != 0 || nb >= (1ll << 31) ||
      ob_is_float(bdt) || ob_is_float(pdt)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long tmask = (unsigned long long)(tsize - 1);
  k9_clear<<<nblocks, K9_THREADS, 0, s>>>((int*)slot, tsize);
  if (nb > 0) {
    k9_build<<<nblocks, K9_THREADS, 0, s>>>(
        bkey, bdt, (const unsigned char*)bsel, nb, (int*)slot, tmask);
  }
  if (np > 0) {
    k9_probe<<<nblocks, K9_THREADS, 0, s>>>(
        pkey, pdt, (const unsigned char*)psel, np, bkey, bdt,
        (const int*)slot, tmask, (int*)match);
  }
  return (int)cudaGetLastError();
}
