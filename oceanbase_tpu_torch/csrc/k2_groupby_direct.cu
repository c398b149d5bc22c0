// K2: direct-addressed group-by over a small key domain.
//
// Replaces oceanbase_tpu/ops/hashagg.py:181 groupby_direct and the
// executor's direct path (engine/executor.py:3104-3143 with _direct_slot_agg,
// :4255): for every slot g of the packed key and every aggregate a, a
// masked reduction of values[a] over rows with key == g and mask[a] set.
// The JAX package runs domain x aggregates fused masked sums; here one pass
// over the rows serves every (slot, aggregate) pair.
//
// Bound on an H100 (3.35 TB/s): it must read the key column, each distinct
// mask and each aggregate's values once -- memory bound. TPC-H Q1 at SF 10
// (60M rows: an int32 key, one mask shared by the 10 aggregates, two int32
// and three int64 value columns) reads about 2.2 GB: about 0.66 ms.
//
// Slots. The executor admits a group-by to this path when the product D of
// its keys' domains is at most 64, but pack_keys gives each key whole bits
// (a domain rounded up to a power of two, a domain of 1 one bit), so the
// packed slots can be many more than D (5 x 3 x 3 = 45 packs into 128).
// The kernel therefore takes each row's dense mixed-radix slot (key i times
// the product of the domains before it, < D <= 64) and keeps D cells; the
// final pass writes every packed slot, the dense cell its key fields name,
// or the aggregate's identity where a field lies outside its domain. No
// extra launch, no host read.
//
// Design: per-thread private accumulators in shared memory ([aggregates
// x D] 8-byte cells for each thread, laid out thread-minor so a warp's
// accesses hit 32 different banks). Each thread loads the
// keys, masks and values of four rows before it folds any of them, through
// the read-only path, so the loads overlap, and folds them into its own
// cells with no atomics and no shuffles. At the end each block folds its
// threads' cells into its row of a [blocks x aggregates x D] partials
// table, and a second kernel folds each cell's column of that table in
// block order, into the packed layout. No atomic merges anything, so a
// float aggregate gives the same bits on every run. The wrapper sizes the
// block and splits the aggregates so a block's cells fit the shared memory
// budget (Q1: 10 aggregates x 6 slots x 128 threads = 60 KB). Integer
// aggregates (every stored type but float) are widened to int64 and exact.
// Float aggregates accumulate as double and the wrapper narrows a float32
// result at the end, so a float sum agrees with the plain version (which
// adds in the value's own type, in another order) to rounding, not bit for
// bit.
#include "ob_common.cuh"

#define K2_MAX_AGGS 32
#define K2_MAX_KEYS 6  // keys of domain >= 2: their product is <= 64
#define K2_ROWS 4

// pack_keys's layout: `slots` packed slots; key i (of domain >= 2) in bits
// [shift, shift + bits) with dense radix `radix`; the bits in zmask belong
// to keys of domain 1 and must be 0.
struct K2Layout {
  long long slots, zmask;
  int nk;
  int shift[K2_MAX_KEYS], bits[K2_MAX_KEYS], dom[K2_MAX_KEYS],
      radix[K2_MAX_KEYS];
};

// The dense slot of packed slot p, or -1 where a key field lies outside
// its domain.
__device__ __forceinline__ int k2_dense(const K2Layout& l, long long p) {
  if (p & l.zmask) return -1;
  int d = 0;
  for (int i = 0; i < l.nk; i++) {
    int f = (int)((p >> l.shift[i]) & ((1LL << l.bits[i]) - 1));
    if (f >= l.dom[i]) return -1;
    d += f * l.radix[i];
  }
  return d;
}

struct K2Args {
  const void* vals[K2_MAX_AGGS];
  const unsigned char* masks[K2_MAX_AGGS];
  long long ident[K2_MAX_AGGS];  // int64 identity, or the bits of a double
  int dts[K2_MAX_AGGS];
  int ops[K2_MAX_AGGS];
  int isf[K2_MAX_AGGS];  // 1: accumulate as double
};


template <typename K>
__global__ void k2_groupby(const K* __restrict__ keys, long long n, int domain,
                           int nagg, K2Args a, long long* part) {
  extern __shared__ long long acc[];  // [(agg * domain + slot) * T + thread]
  const int T = blockDim.x, t = threadIdx.x, cells = nagg * domain;
  for (int c = 0; c < cells; c++) acc[(long long)c * T + t] = a.ident[c / domain];
  // K2_ROWS rows per thread per step (r * T + t within a block step), all
  // loaded before any is folded, so their loads overlap
  const long long step = (long long)T * K2_ROWS;
  for (long long base = (long long)blockIdx.x * step; base < n;
       base += (long long)gridDim.x * step) {
    long long row[K2_ROWS];
    int slot[K2_ROWS];
#pragma unroll
    for (int r = 0; r < K2_ROWS; r++) {
      row[r] = base + (long long)r * T + t;
      long long k = row[r] < n ? (long long)__ldg(keys + row[r]) : -1;
      slot[r] = (k >= 0 && k < domain) ? (int)k : -1;
    }
    for (int j = 0; j < nagg; j++) {
      const int op = a.ops[j], dt = a.dts[j], isf = a.isf[j];
      const void* v = a.vals[j];
      const unsigned char* m = a.masks[j];
      bool take[K2_ROWS];
      long long xi[K2_ROWS];
      double xf[K2_ROWS];
#pragma unroll
      for (int r = 0; r < K2_ROWS; r++) {
        take[r] = slot[r] >= 0 && __ldg(m + row[r]);
        xi[r] = 1LL;
        xf[r] = 1.0;
        if (slot[r] >= 0 && op != OB_COUNT) {
          if (isf) xf[r] = ob_ldg_f64(v, dt, row[r]);
          else xi[r] = ob_ldg_i64(v, dt, row[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < K2_ROWS; r++) {
        if (!take[r]) continue;
        long long* cell = &acc[(long long)(j * domain + slot[r]) * T + t];
        if (isf) *(double*)cell = ob_combine_f64(op, *(double*)cell, xf[r]);
        else *cell = ob_combine_i64(op, *cell, xi[r]);
      }
    }
  }
  __syncthreads();
  long long* mine = part + (long long)blockIdx.x * cells;
  for (int c = t; c < cells; c += T) {
    int j = c / domain, op = a.ops[j];
    const long long* row = &acc[(long long)c * T];
    if (a.isf[j]) {
      double v = __longlong_as_double(row[0]);
      for (int u = 1; u < T; u++) {
        v = ob_combine_f64(op, v, __longlong_as_double(row[u]));
      }
      mine[c] = __double_as_longlong(v);
    } else {
      long long v = row[0];
      for (int u = 1; u < T; u++) v = ob_combine_i64(op, v, row[u]);
      mine[c] = v;
    }
  }
}

// out[j * slots + p] = the fold of part[b * cells + j * domain + d] over
// blocks b = 0, 1, ... in order, d the dense slot of packed slot p (the
// identity where p has none): one thread per output cell.
__global__ void k2_final(const long long* __restrict__ part, int nblocks,
                         int domain, int nagg, K2Args a, K2Layout l,
                         long long* out) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)nagg * l.slots) return;
  const int j = (int)(c / l.slots), op = a.ops[j];
  const int d = k2_dense(l, c % l.slots);
  const int cells = nagg * domain;
  const long long* col = part + (long long)j * domain + d;
  if (a.isf[j]) {
    double v = __longlong_as_double(a.ident[j]);
    for (int b = 0; d >= 0 && b < nblocks; b++) {
      v = ob_combine_f64(op, v, __longlong_as_double(col[(long long)b * cells]));
    }
    out[c] = __double_as_longlong(v);
  } else {
    long long v = a.ident[j];
    for (int b = 0; d >= 0 && b < nblocks; b++) {
      v = ob_combine_i64(op, v, col[(long long)b * cells]);
    }
    out[c] = v;
  }
}

// keys: int32 (key_dt 3) or int64 (key_dt 4) dense slots [n] in
// [0, domain); per aggregate j: vals[j] (null for count), dts[j], masks[j]
// (bool [n]), ops[j], identity bits and float flag; the packed layout:
// `slots` packed slots, zmask, and per key of domain >= 2 (nk of them)
// shift, bits, domain and dense radix. out: [nagg, slots] 8-byte cells;
// part: nblocks * nagg * domain 8-byte cells of scratch.
// threads * nagg * domain * 8 bytes of shared memory per block.
extern "C" int ob_k2_groupby(const void* keys, int key_dt, long long n,
                             int domain, int nagg, const void* const* vals,
                             const int* dts, const void* const* masks,
                             const int* ops, const long long* ident,
                             const int* isf, void* out, void* part,
                             int threads, int nblocks, long long slots,
                             long long zmask, int nk, const int* kshift,
                             const int* kbits, const int* kdom,
                             const int* kradix, void* stream) {
  if (nagg < 1 || nagg > K2_MAX_AGGS || domain < 1 || domain > 64 ||
      threads < 32 || threads > 1024 || threads % 32 != 0 || nk < 0 ||
      nk > K2_MAX_KEYS || slots < 1) {
    return (int)cudaErrorInvalidValue;
  }
  K2Layout l;
  l.slots = slots;
  l.zmask = zmask;
  l.nk = nk;
  for (int i = 0; i < nk; i++) {
    l.shift[i] = kshift[i];
    l.bits[i] = kbits[i];
    l.dom[i] = kdom[i];
    l.radix[i] = kradix[i];
  }
  K2Args a;
  for (int j = 0; j < nagg; j++) {
    a.vals[j] = vals[j];
    a.masks[j] = (const unsigned char*)masks[j];
    a.ident[j] = ident[j];
    a.dts[j] = dts[j];
    a.ops[j] = ops[j];
    a.isf[j] = isf[j];
  }
  cudaStream_t s = (cudaStream_t)stream;
  long long* p = (long long*)part;
  int cells = nagg * domain;
  int shmem = cells * threads * (int)sizeof(long long);
  cudaError_t err;
  if (key_dt == OB_I32) {
    err = cudaFuncSetAttribute(k2_groupby<int>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               shmem);
    if (err != cudaSuccess) return (int)err;
    k2_groupby<int><<<nblocks, threads, shmem, s>>>(
        (const int*)keys, n, domain, nagg, a, p);
  } else if (key_dt == OB_I64) {
    err = cudaFuncSetAttribute(k2_groupby<long long>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               shmem);
    if (err != cudaSuccess) return (int)err;
    k2_groupby<long long><<<nblocks, threads, shmem, s>>>(
        (const long long*)keys, n, domain, nagg, a, p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  long long outs = (long long)nagg * slots;
  k2_final<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
      p, nblocks, domain, nagg, a, l, (long long*)out);
  return (int)cudaGetLastError();
}
