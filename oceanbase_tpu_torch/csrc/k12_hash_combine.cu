// K12: the 64-bit hash of multi-column join keys.
//
// Replaces oceanbase_tpu/ops/hashing.py:40 hash_combine (over :32 mix64),
// as oceanbase_tpu/ops/join.py:46 join_keys64 calls it for keys of more
// than one column:
//   h = 0; for each column c: h = mix64(h ^ (uint64(c) + GOLDEN))
// uint64(c) converts modulo 2^64, so a negative int32 value sign-extends
// (-1 -> 2^64 - 1) and an unsigned byte zero-extends; the result's bits
// are read as int64, as join_keys64's astype does. The bits decide which
// rows share a sorted run in expand_join, so they equal the JAX package's.
// A float column (float32 or float64) hashes the canonical image of its
// value instead: the float64 bits, float32 widened exactly, -0.0 as +0.0,
// so equal values hash alike (the JAX package casts floats to uint64,
// which truncates; the port joins float keys by value, and its plain
// version hashes the same image).
//
// Bound on an H100 (3.35 TB/s): it reads each key column once and writes
// 8 bytes a row; three 64-bit multiplies per column a row are far below
// the integer rate: bytes bound.
//
// Design: one thread per row (grid-stride), the column pointers and type
// codes in a table in device memory (ob_common.cuh ObKeys, any number of
// join columns), loads widened through ob_ldg_i64.
#include "ob_common.cuh"

#define K12_THREADS 256

__global__ void k12_hash(ObKeys a, long long n, long long* __restrict__ out) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    unsigned long long h = 0ull;
    for (int c = 0; c < a.ncols; c++) {
      const int dt = ob_key_dt(a, c);
      unsigned long long v;
      if (ob_is_float(dt)) {
        double f = ob_ldg_f64(ob_key_col(a, c), dt, i);
        v = (unsigned long long)__double_as_longlong(f == 0.0 ? 0.0 : f);
      } else {
        v = (unsigned long long)ob_ldg_i64(ob_key_col(a, c), dt, i);
      }
      h = ob_mix64(h ^ (v + OB_GOLDEN64));
    }
    out[i] = (long long)h;
  }
}

// table: the device table (ObKeys) of ncols key columns of n rows (type
// codes of ob_common.cuh); out: int64 [n].
extern "C" int ob_k12_hash(int ncols, const void* table, long long n,
                           void* out, int nblocks, void* stream) {
  ObKeys a;
  if (!ob_keys_set(&a, ncols, table)) return (int)cudaErrorInvalidValue;
  k12_hash<<<nblocks, K12_THREADS, 0, (cudaStream_t)stream>>>(
      a, n, (long long*)out);
  return (int)cudaGetLastError();
}
