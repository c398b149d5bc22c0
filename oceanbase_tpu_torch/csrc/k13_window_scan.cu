// K13: the scans of window functions and of INTERSECT/EXCEPT ALL.
//
// Replaces oceanbase_tpu/ops/window.py:31 boundaries, :43 segment_starts,
// :49 peer_ends, :67 segmented_scan_minmax, :83 suffix_scan_minmax, the
// global cumsum of the window frames' csum_range and the frame-bound
// searches of oceanbase_tpu/engine/executor.py:2628 _emit_window (the
// packed searchsorted and the per-segment binary search _lex_bound :2750),
// and the same scans in _emit_setop_all (:2577-2600). All run over rows
// already in sorted order (capacity n, dead rows last):
//   ob_k13_flags   run flags: row 0, or any key column differs from the
//                  previous row (`!=`, so NaN starts a run of its own and
//                  -0.0 equals 0.0)
//   ob_k13_scan    inclusive scans in either direction: a plain sum
//                  (int64 or double), a segmented min/max (NaN
//                  propagating, like jnp.minimum/maximum), the cummax of
//                  marked segment starts and the reversed cummin of the
//                  marked segment ends
//   ob_k13_search  per-row binary search of a target in a sorted int64
//                  array, globally or inside [lo, hi) per row
//
// Bound on an H100 (3.35 TB/s): each scan reads its input once (plus the
// flags) and writes its output once; the search reads log2(range) random
// sectors per row. All bytes bound.
//
// Design: a scan is three launches, as K8 folds its carries: (1) each
// tile of 4096 rows (256 threads x 16 rows, staged through shared memory
// so the loads and stores stay coalesced) reduces to one (flag, value)
// pair, combining in row order; (2) one block scans the tile pairs in
// tile order into exclusive carries; (3) each tile scans again from its
// carry. No atomics and a fixed association: two runs give the same bits,
// and integer results equal any other order's. A float sum is associated
// by tile, thread and row, so it agrees with a sequential cumsum to
// rounding only.
#include "ob_common.cuh"

#define K13_THREADS 256
#define K13_ITEMS 16
#define K13_TILE (K13_THREADS * K13_ITEMS)
#define K13_MAX_KEYS 16
#define K13_CARRY_THREADS 1024

// value modes: the input itself, the marked segment starts
// (flags[i] ? i : 0, scanned with max), the marked segment ends
// ((i == n - 1 || flags[i + 1]) ? i : n - 1, scanned with min in reverse)
#define K13_VAL 0
#define K13_START_MARK 1
#define K13_END_MARK 2

template <typename T>
struct K13Pair {
  T v;
  int f;
};

__device__ __forceinline__ long long k13_op(int op, long long a, long long b) {
  return ob_combine_i64(op, a, b);
}

__device__ __forceinline__ double k13_op(int op, double a, double b) {
  return ob_combine_f64(op, a, b);
}

template <typename T>
__device__ __forceinline__ K13Pair<T> k13_combine(int op, K13Pair<T> a,
                                                  K13Pair<T> b) {
  K13Pair<T> r;
  r.f = a.f | b.f;
  r.v = b.f ? b.v : k13_op(op, a.v, b.v);
  return r;
}

__device__ __forceinline__ long long k13_load(const void* p, int dt,
                                              long long i, long long*) {
  return ob_ldg_i64(p, dt, i);
}

__device__ __forceinline__ double k13_load(const void* p, int dt, long long i,
                                           double*) {
  if (ob_is_float(dt)) return ob_ldg_f64(p, dt, i);
  return (double)ob_ldg_i64(p, dt, i);
}

__device__ __forceinline__ void k13_store(void* p, int dt, long long i,
                                          long long v) {
  switch (dt) {
    case OB_I8: ((signed char*)p)[i] = (signed char)v; break;
    case OB_U8: ((unsigned char*)p)[i] = (unsigned char)v; break;
    case OB_I16: ((short*)p)[i] = (short)v; break;
    case OB_I32: ((int*)p)[i] = (int)v; break;
    default: ((long long*)p)[i] = v; break;
  }
}

__device__ __forceinline__ void k13_store(void* p, int dt, long long i,
                                          double v) {
  if (dt == OB_F32) {
    ((float*)p)[i] = (float)v;
  } else {
    ((double*)p)[i] = v;
  }
}

struct K13Scan {
  const void* in;
  int dt;
  const unsigned char* flags;
  int mode;
  int op;
  int reverse;
  int segmented;
  long long n;
  void* out;
  int out_dt;
};

// The (flag, value) pair of logical position k (physical row i).
template <typename T>
__device__ __forceinline__ K13Pair<T> k13_item(const K13Scan& s, long long i) {
  K13Pair<T> p;
  p.f = 0;
  if (s.segmented) {
    if (s.reverse) {
      p.f = (i == s.n - 1) || __ldg(s.flags + i + 1);
    } else {
      p.f = __ldg(s.flags + i) != 0;
    }
  }
  if (s.mode == K13_START_MARK) {
    p.v = (T)(__ldg(s.flags + i) ? i : 0);
  } else if (s.mode == K13_END_MARK) {
    p.v = (T)((i == s.n - 1 || __ldg(s.flags + i + 1)) ? i : s.n - 1);
  } else {
    p.v = k13_load(s.in, s.dt, i, (T*)0);
  }
  return p;
}

// Inclusive scan of one pair per thread over the block, in thread order;
// returns the thread's EXCLUSIVE prefix (ident for thread 0) and the
// block total through `total`.
template <typename T>
__device__ K13Pair<T> k13_block_exclusive(int op, K13Pair<T> x,
                                          K13Pair<T> ident,
                                          K13Pair<T>* warp_tot,
                                          K13Pair<T>* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = blockDim.x >> 5;
  K13Pair<T> inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    K13Pair<T> up;
    up.v = __shfl_up_sync(OB_FULL_MASK, inc.v, o);
    up.f = __shfl_up_sync(OB_FULL_MASK, inc.f, o);
    if (lane >= o) inc = k13_combine(op, up, inc);
  }
  K13Pair<T> exc;
  exc.v = __shfl_up_sync(OB_FULL_MASK, inc.v, 1);
  exc.f = __shfl_up_sync(OB_FULL_MASK, inc.f, 1);
  if (lane == 0) exc = ident;
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    K13Pair<T> run = ident;
    for (int w = 0; w < nwarps; w++) {
      K13Pair<T> t = warp_tot[w];
      warp_tot[w] = run;
      run = k13_combine(op, run, t);
    }
    *total = run;
  }
  __syncthreads();
  return k13_combine(op, warp_tot[warp], exc);
}

// Phase 1 (store_out = 0): each tile's aggregate pair into tile_v/tile_f.
// Phase 3 (store_out = 1): the scan of each tile from its carry.
template <typename T>
__global__ void __launch_bounds__(K13_THREADS)
k13_tiles(K13Scan s, K13Pair<T> ident, T* tile_v, int* tile_f, int store_out) {
  __shared__ T sv[K13_TILE];
  __shared__ unsigned char sf[K13_TILE];
  __shared__ K13Pair<T> warp_tot[K13_THREADS / 32];
  __shared__ K13Pair<T> total;
  long long base = (long long)blockIdx.x * K13_TILE;
  for (int j = threadIdx.x; j < K13_TILE; j += K13_THREADS) {
    long long k = base + j;
    if (k < s.n) {
      long long i = s.reverse ? s.n - 1 - k : k;
      K13Pair<T> p = k13_item<T>(s, i);
      sv[j] = p.v;
      sf[j] = (unsigned char)p.f;
    } else {
      sv[j] = ident.v;
      sf[j] = 0;
    }
  }
  __syncthreads();
  int j0 = threadIdx.x * K13_ITEMS;
  K13Pair<T> mine = ident;
  for (int j = 0; j < K13_ITEMS; j++) {
    K13Pair<T> p;
    p.v = sv[j0 + j];
    p.f = sf[j0 + j];
    mine = k13_combine(s.op, mine, p);
  }
  K13Pair<T> exc = k13_block_exclusive<T>(s.op, mine, ident, warp_tot, &total);
  if (!store_out) {
    if (threadIdx.x == 0) {
      tile_v[blockIdx.x] = total.v;
      tile_f[blockIdx.x] = total.f;
    }
    return;
  }
  K13Pair<T> carry;
  carry.v = tile_v[blockIdx.x];
  carry.f = tile_f[blockIdx.x];
  K13Pair<T> run = k13_combine(s.op, carry, exc);
  __syncthreads();  // every thread has read its items before the rewrite
  for (int j = 0; j < K13_ITEMS; j++) {
    K13Pair<T> p;
    p.v = sv[j0 + j];
    p.f = sf[j0 + j];
    run = k13_combine(s.op, run, p);
    sv[j0 + j] = run.v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < K13_TILE; j += K13_THREADS) {
    long long k = base + j;
    if (k < s.n) {
      long long i = s.reverse ? s.n - 1 - k : k;
      k13_store(s.out, s.out_dt, i, sv[j]);
    }
  }
}

// Phase 2: exclusive carries of the tile pairs, in tile order, in place.
template <typename T>
__global__ void __launch_bounds__(K13_CARRY_THREADS)
k13_carries(int op, K13Pair<T> ident, T* tile_v, int* tile_f,
            long long ntiles) {
  __shared__ K13Pair<T> warp_tot[K13_CARRY_THREADS / 32];
  __shared__ K13Pair<T> total;
  long long chunk = (ntiles + K13_CARRY_THREADS - 1) / K13_CARRY_THREADS;
  long long t0 = (long long)threadIdx.x * chunk;
  long long t1 = t0 + chunk < ntiles ? t0 + chunk : ntiles;
  K13Pair<T> mine = ident;
  for (long long t = t0; t < t1; t++) {
    K13Pair<T> p;
    p.v = tile_v[t];
    p.f = tile_f[t];
    mine = k13_combine(op, mine, p);
  }
  K13Pair<T> run = k13_block_exclusive<T>(op, mine, ident, warp_tot, &total);
  for (long long t = t0; t < t1; t++) {
    K13Pair<T> p;
    p.v = tile_v[t];
    p.f = tile_f[t];
    tile_v[t] = run.v;
    tile_f[t] = run.f;
    run = k13_combine(op, run, p);
  }
}

template <typename T>
static int k13_run(const K13Scan& s, T ident_v, void* tile_v, void* tile_f,
                   long long ntiles, cudaStream_t st) {
  K13Pair<T> ident;
  ident.v = ident_v;
  ident.f = 0;
  k13_tiles<T><<<(unsigned)ntiles, K13_THREADS, 0, st>>>(
      s, ident, (T*)tile_v, (int*)tile_f, 0);
  k13_carries<T><<<1, K13_CARRY_THREADS, 0, st>>>(
      s.op, ident, (T*)tile_v, (int*)tile_f, ntiles);
  k13_tiles<T><<<(unsigned)ntiles, K13_THREADS, 0, st>>>(
      s, ident, (T*)tile_v, (int*)tile_f, 1);
  return (int)cudaGetLastError();
}

extern "C" int ob_k13_tile_rows() { return K13_TILE; }

// in/dt: the input column (ignored by the mark modes); flags: bool [n]
// segment starts (null unless segmented or a mark mode); op: OB_SUM,
// OB_MIN or OB_MAX; reverse: scan from the last row; out/out_dt: the
// output column; tile_v: 8-byte scratch and tile_f int32 scratch of
// ntiles = ceil(n / ob_k13_tile_rows()) entries; ident: the identity of
// op as int64 bits (a double's bits when the scan is in double).
extern "C" int ob_k13_scan(const void* in, int dt, const void* flags,
                           int mode, int op, int reverse, int segmented,
                           long long n, void* out, int out_dt, long long ident,
                           void* tile_v, void* tile_f, long long ntiles,
                           void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (ntiles != (n + K13_TILE - 1) / K13_TILE || ntiles >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((mode != K13_VAL || segmented) && flags == 0) {
    return (int)cudaErrorInvalidValue;
  }
  K13Scan s;
  s.in = in;
  s.dt = dt;
  s.flags = (const unsigned char*)flags;
  s.mode = mode;
  s.op = op;
  s.reverse = reverse;
  s.segmented = segmented;
  s.n = n;
  s.out = out;
  s.out_dt = out_dt;
  cudaStream_t st = (cudaStream_t)stream;
  if (ob_is_float(out_dt)) {
    double d;
    memcpy(&d, &ident, sizeof(d));
    return k13_run<double>(s, d, tile_v, tile_f, ntiles, st);
  }
  return k13_run<long long>(s, ident, tile_v, tile_f, ntiles, st);
}

struct K13Keys {
  const void* col[K13_MAX_KEYS];
  int dt[K13_MAX_KEYS];
  int ncols;
};

__global__ void k13_flags(K13Keys a, long long n, unsigned char* out) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    unsigned char nw = i == 0;
    for (int c = 0; c < a.ncols && !nw; c++) {
      if (ob_is_float(a.dt[c])) {
        nw = ob_ldg_f64(a.col[c], a.dt[c], i) !=
             ob_ldg_f64(a.col[c], a.dt[c], i - 1);
      } else {
        nw = ob_ldg_i64(a.col[c], a.dt[c], i) !=
             ob_ldg_i64(a.col[c], a.dt[c], i - 1);
      }
    }
    out[i] = nw;
  }
}

// cols/dts: ncols sorted key columns of n rows; out: bool [n].
extern "C" int ob_k13_flags(int ncols, const void* const* cols,
                            const int* dts, long long n, void* out,
                            int nblocks, void* stream) {
  if (ncols < 1 || ncols > K13_MAX_KEYS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  K13Keys a;
  a.ncols = ncols;
  for (int c = 0; c < ncols; c++) {
    a.col[c] = cols[c];
    a.dt[c] = dts[c];
  }
  k13_flags<<<nblocks, K13_THREADS, 0, (cudaStream_t)stream>>>(
      a, n, (unsigned char*)out);
  return (int)cudaGetLastError();
}

__global__ void k13_search(const long long* __restrict__ arr, long long n,
                           const long long* __restrict__ target,
                           const long long* __restrict__ lo,
                           const long long* __restrict__ hi, int right,
                           long long m, long long* __restrict__ out) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += step) {
    long long l = lo ? __ldg(lo + i) : 0;
    long long h = hi ? __ldg(hi + i) : n;
    long long t = __ldg(target + i);
    while (l < h) {
      long long mid = (l + h) >> 1;
      long long kv = __ldg(arr + (mid < 0 ? 0 : (mid >= n ? n - 1 : mid)));
      bool go = right ? (kv <= t) : (kv < t);
      if (go) {
        l = mid + 1;
      } else {
        h = mid;
      }
    }
    out[i] = l;
  }
}

// arr: int64 [n], ascending within every searched range; target: int64
// [m]; lo/hi: int64 [m] per-row ranges [lo, hi), or null for [0, n);
// right: 0 = first position with arr >= target, 1 = first with arr >
// target; out: int64 [m].
extern "C" int ob_k13_search(const void* arr, long long n, const void* target,
                             const void* lo, const void* hi, int right,
                             long long m, void* out, int nblocks,
                             void* stream) {
  if ((lo == 0) != (hi == 0) || n <= 0) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaGetLastError();
  k13_search<<<nblocks, K13_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)arr, n, (const long long*)target,
      (const long long*)lo, (const long long*)hi, right, m, (long long*)out);
  return (int)cudaGetLastError();
}
