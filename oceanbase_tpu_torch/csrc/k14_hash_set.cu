// K14: the open-addressing hash set of multi-column keys, its build and
// its existence probe.
//
// Replaces oceanbase_tpu/ops/join.py:56 build_hash_table (over
// oceanbase_tpu/ops/hashagg.py:42 assign_group_slots) and :74
// hash_join_probe, with the 32-bit key hash of
// oceanbase_tpu/ops/hashing.py:76 hash32_combine (over :48 mix32 and :63
// fold32): h = 0; for each key column c: h = mix32(h ^ (fold32(c) +
// GOLDEN32)). The tag is h read as int32, the home slot h & (T - 1).
// For each live probe row the result is the lowest live build row whose
// key tuple equals the probe's exactly (every column compared with `==`,
// in double where either side is a float, so NaN never matches) and whose
// tag equals the probe's tag, else -1: what the reference's lockstep
// claim (the lowest row wins every empty slot) and its probe give.
//
// Bound on an H100 (3.35 TB/s): the build reads the live build rows' keys
// and sel, the probe the probe rows' keys and sel and writes 4 bytes a
// probe row; the table (8 bytes a slot, cleared once) and the random key
// reads through slot rows are on top of that bound.
//
// Design: K9's table extended to k columns (the key tuple, its hash and its
// equality are ob_common.cuh's ObKeys, shared with K29; the columns'
// addresses and types come from a table in device memory, so a key tuple
// takes any number of columns: INTERSECT and EXCEPT give each nullable
// column two planes). (1) Clear every
// slot (row -1, tag 0). (2) One thread per live build row walks linear
// probes from its home slot: atomicCAS(-1 -> row) claims an empty slot and
// writes the tag; a slot whose row holds an equal key tuple (read through
// the row from the build columns, so a slot's key never changes) takes
// atomicMin(row). Which key lands in which slot depends on the order the
// threads run in; each key's row does not. (3) One thread per live probe
// row walks the same probes until an empty slot or an equal tag and key
// tuple, and writes the row into probe order. The match rows are schedule-
// free, so two runs give the same bits; the slot layout may differ.
#include "ob_common.cuh"

#define K14_THREADS 256

__global__ void k14_clear(int* __restrict__ slot_tag, int* __restrict__ slot_row,
                          long long tsize) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < tsize; i += step) {
    slot_tag[i] = 0;
    slot_row[i] = -1;
  }
}

__global__ void k14_build(ObKeys b, const unsigned char* __restrict__ bsel,
                          long long nb, int* slot_tag, int* slot_row,
                          unsigned long long tmask) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nb;
       i += step) {
    if (!__ldg(bsel + i)) continue;
    unsigned int h = ob_keys_hash32(b, i);
    unsigned long long s = (unsigned long long)h & tmask;
    for (unsigned long long step_n = 0; step_n <= tmask; step_n++) {
      int cur = atomicCAS(slot_row + s, -1, (int)i);
      if (cur < 0) {
        slot_tag[s] = (int)h;
        break;
      }
      if (ob_keys_equal(b, cur, b, i)) {
        atomicMin(slot_row + s, (int)i);
        break;
      }
      s = (s + 1) & tmask;
    }
  }
}

__global__ void k14_probe(ObKeys b, ObKeys p,
                          const unsigned char* __restrict__ psel, long long np,
                          const int* __restrict__ slot_tag,
                          const int* __restrict__ slot_row,
                          unsigned long long tmask, int* __restrict__ match) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < np;
       i += step) {
    int m = -1;
    if (__ldg(psel + i)) {
      unsigned int h = ob_keys_hash32(p, i);
      unsigned long long s = (unsigned long long)h & tmask;
      for (unsigned long long step_n = 0; step_n <= tmask; step_n++) {
        int cur = __ldg(slot_row + s);
        if (cur < 0) break;
        if (__ldg(slot_tag + s) == (int)h && ob_keys_equal(b, cur, p, i)) {
          m = cur;
          break;
        }
        s = (s + 1) & tmask;
      }
    }
    match[i] = m;
  }
}

// table: the device table of ncols build key columns of nb rows (ObKeys);
// sel: bool [nb]; slot_tag/slot_row: int32 [tsize], tsize a power of two
// >= 2 nb.
extern "C" int ob_k14_build(int ncols, const void* table, const void* sel,
                            long long nb, void* slot_tag, void* slot_row,
                            long long tsize, int nblocks, void* stream) {
  ObKeys b;
  if (!ob_keys_set(&b, ncols, table) || tsize < 2 * nb ||
      (tsize & (tsize - 1)) != 0 || nb >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  k14_clear<<<nblocks, K14_THREADS, 0, s>>>((int*)slot_tag, (int*)slot_row,
                                            tsize);
  if (nb > 0) {
    k14_build<<<nblocks, K14_THREADS, 0, s>>>(
        b, (const unsigned char*)sel, nb, (int*)slot_tag, (int*)slot_row,
        (unsigned long long)(tsize - 1));
  }
  return (int)cudaGetLastError();
}

// btable: the device table of the build key columns the hash set was
// built from; ptable: that of the probe key columns of np rows (column j
// compared with build column j); psel: bool [np]; match: int32 [np].
extern "C" int ob_k14_probe(int ncols, const void* btable,
                            const void* ptable, const void* psel,
                            long long np, const void* slot_tag,
                            const void* slot_row, long long tsize,
                            void* match, int nblocks, void* stream) {
  ObKeys b, p;
  if (!ob_keys_set(&b, ncols, btable) || !ob_keys_set(&p, ncols, ptable) ||
      tsize < 1 || (tsize & (tsize - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (np <= 0) return (int)cudaGetLastError();
  k14_probe<<<nblocks, K14_THREADS, 0, (cudaStream_t)stream>>>(
      b, p, (const unsigned char*)psel, np, (const int*)slot_tag,
      (const int*)slot_row, (unsigned long long)(tsize - 1), (int*)match);
  return (int)cudaGetLastError();
}
