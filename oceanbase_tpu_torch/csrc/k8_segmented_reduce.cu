// K8: segmented reduce-by-key over rows in sorted key order.
//
// Replaces oceanbase_tpu/ops/hashagg.py:271 sort_groupby (its reduction
// half), with the ops/window.py functions it runs on
// (:43 segment_starts, :49 peer_ends, :60 segmented_cumsum, :67
// segmented_scan_minmax): after the sort (K3) and the key gather (K4), a
// segment starts at row 0 and wherever any key, or the dead flag, differs
// from the previous sorted row; every aggregate (count / sum / min / max
// over sel & its mask at the sorted position) reduces each segment, and
// the result lands at the segment's first row, which is the group's one
// live row (sel = new_seg & live). Every other row, the first rows of the
// dead segments among them, holds 0 and is dead.
//
// Integer sums equal the reference's c - c[seg_start] + v[seg_start]
// bit for bit (two's-complement wraparound); min, max and counts are exact.
// Float sums accumulate in double in a fixed order here, and in the
// value's own type as cumsum differences in the reference: they agree to
// rounding, and the same bits come back on every run (no float atomics).
//
// Bound on an H100 (3.35 TB/s): one read of the sorted keys, the sorted
// sel and the order, one read of each aggregate's values and mask (through
// the order, so the reads are random and sector bound), one write of sel
// and of each result -- memory bound.
//
// Design: a tile of K8_TILE sorted rows per block, K8_ITEMS consecutive
// rows per thread. Each thread marks its segment starts, then for each
// aggregate reduces its rows sequentially; a block-wide segmented scan of
// the per-thread (has start, tail) pairs (warp shuffles, then the warp
// totals) hands each thread the running value coming into its rows. The
// owner of a segment's last row in the tile writes the total at the
// segment's first row. A segment crossing tiles: its head tile writes its
// partial, every later tile writes its leading piece to a carry table,
// and a second kernel folds the carries into the partial, one warp per
// segment reading 32 carries a step in a fixed order. Dead segments are
// not folded: after the sort they are one long tail run (their keys are
// whatever the dead rows hold), and walking it would cost more than the
// live groups.
//
// The sorted keys and the aggregates come from tables in device memory
// (the keys an ObKeys of ob_common.cuh, the aggregates K8_FIELDS entries
// each), so one launch takes any number of group keys and aggregates and
// finds the segments once.
#include "ob_common.cuh"

#define K8_THREADS 256
#define K8_ITEMS 8
#define K8_TILE (K8_THREADS * K8_ITEMS)
#define K8_FIELDS 8

// The aggregates' table: K8_FIELDS int64 entries per aggregate g, at
// t[g * K8_FIELDS]: the values' address (0: count), the mask's address
// (0: no mask beyond sel), the output's ([n] int64, or double for
// floats), the carry's ([ntiles] of the same type), the values' type
// code, the op (count as sum), 1 for a float accumulator, the identity
// (a double's bits for floats).
struct K8Aggs {
  const long long* t;
  int nagg;
};

__device__ __forceinline__ long long k8_f(const K8Aggs& a, int g, int f) {
  return __ldg(a.t + (long long)g * K8_FIELDS + f);
}
#define K8_VAL(a, g) ((const void*)k8_f(a, g, 0))
#define K8_MASK(a, g) ((const unsigned char*)k8_f(a, g, 1))
#define K8_OUT(a, g) ((void*)k8_f(a, g, 2))
#define K8_CARRY(a, g) ((void*)k8_f(a, g, 3))
#define K8_DT(a, g) ((int)k8_f(a, g, 4))
#define K8_OP(a, g) ((int)k8_f(a, g, 5))
#define K8_ISF(a, g) ((int)k8_f(a, g, 6))
#define K8_IDENT(a, g) (k8_f(a, g, 7))

// Row r starts a segment: r == 0, or the live flag or any key differs from
// row r - 1. Floats compare as values (NaN != NaN, -0.0 == 0.0), like the
// reference's k[1:] != k[:-1]. nkeys 0 (k.t null): the live flag alone.
__device__ __forceinline__ bool k8_new_seg(const ObKeys& k,
                                           const unsigned char* ssel,
                                           long long r) {
  if (r == 0) return true;
  if ((ssel[r] != 0) != (ssel[r - 1] != 0)) return true;
  for (int j = 0; j < k.ncols; j++) {
    const void* key = ob_key_col(k, j);
    int dt = ob_key_dt(k, j);
    if (dt == OB_F32 || dt == OB_F64) {
      if (ob_ldg_f64(key, dt, r) != ob_ldg_f64(key, dt, r - 1)) {
        return true;
      }
    } else if (ob_ldg_i64(key, dt, r) != ob_ldg_i64(key, dt, r - 1)) {
      return true;
    }
  }
  return false;
}

template <typename A>
__device__ __forceinline__ A k8_comb(int op, A a, A b);

template <>
__device__ __forceinline__ long long k8_comb<long long>(int op, long long a,
                                                        long long b) {
  if (op == OB_SUM) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
  return ob_combine_i64(op, a, b);
}

template <>
__device__ __forceinline__ double k8_comb<double>(int op, double a, double b) {
  return ob_combine_f64(op, a, b);
}

template <typename A>
__device__ __forceinline__ A k8_ident(long long bits);

template <>
__device__ __forceinline__ long long k8_ident<long long>(long long bits) {
  return bits;
}

template <>
__device__ __forceinline__ double k8_ident<double>(long long bits) {
  return __longlong_as_double(bits);
}

template <typename A>
__device__ __forceinline__ A k8_value(const K8Aggs& a, int g,
                                      const unsigned char* ssel,
                                      const int* order, long long r, A id);

template <>
__device__ __forceinline__ long long k8_value<long long>(
    const K8Aggs& a, int g, const unsigned char* ssel, const int* order,
    long long r, long long id) {
  if (!ssel[r]) return id;
  long long src = order[r];
  const unsigned char* m = K8_MASK(a, g);
  if (m && !m[src]) return id;
  const void* val = K8_VAL(a, g);
  if (!val) return 1;  // count
  return ob_ldg_i64(val, K8_DT(a, g), src);
}

template <>
__device__ __forceinline__ double k8_value<double>(
    const K8Aggs& a, int g, const unsigned char* ssel, const int* order,
    long long r, double id) {
  if (!ssel[r]) return id;
  long long src = order[r];
  const unsigned char* m = K8_MASK(a, g);
  if (m && !m[src]) return id;
  return ob_ldg_f64(K8_VAL(a, g), K8_DT(a, g), src);
}

template <typename A>
__device__ __forceinline__ void k8_store(void* p, long long i, A v) {
  ((A*)p)[i] = v;
}

// Block-wide exclusive segmented scan of (flag, value) pairs in thread
// order: the result is the reduction of the values since the latest flag
// among the earlier threads (or since the tile start, with fl = false).
template <typename A>
__device__ __forceinline__ void k8_block_scan(int op, A id, bool f, A v,
                                              bool* fl_out, A* v_out,
                                              int* wf, A* wv) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int fi = f ? 1 : 0;
  // inclusive warp scan; the pair of an earlier lane comes first
  for (int o = 1; o < 32; o <<= 1) {
    int f2 = __shfl_up_sync(OB_FULL_MASK, fi, o);
    A v2 = __shfl_up_sync(OB_FULL_MASK, v, o);
    if (lane >= o) {
      if (!fi) v = k8_comb<A>(op, v2, v);
      fi |= f2;
    }
  }
  // exclusive within the warp
  int fe = __shfl_up_sync(OB_FULL_MASK, fi, 1);
  A ve = __shfl_up_sync(OB_FULL_MASK, v, 1);
  if (lane == 0) {
    fe = 0;
    ve = id;
  }
  __syncthreads();
  if (lane == 31) {
    wf[w] = fi;
    wv[w] = v;
  }
  __syncthreads();
  // the warps before this one, folded in order
  int pf = 0;
  A pv = id;
  for (int k = 0; k < w; k++) {
    if (wf[k]) {
      pv = wv[k];
      pf = 1;
    } else {
      pv = k8_comb<A>(op, pv, wv[k]);
    }
  }
  if (!fe) ve = k8_comb<A>(op, pv, ve);
  *fl_out = (fe | pf) != 0;
  *v_out = ve;
}

template <typename A>
__device__ void k8_tile_agg(const K8Aggs& a, int g, const bool* fs,
                            bool next_flag, long long r0, long long n,
                            long long tile_start, long long tile_end,
                            long long start_in, const unsigned char* ssel,
                            const int* order, int* wf, A* wv) {
  int op = K8_OP(a, g);
  A id = k8_ident<A>(K8_IDENT(a, g));
  void* out = K8_OUT(a, g);
  A x[K8_ITEMS];
  bool any = false;
  A tail = id;
  for (int j = 0; j < K8_ITEMS; j++) {
    long long r = r0 + j;
    x[j] = r < n ? k8_value<A>(a, g, ssel, order, r, id) : id;
    if (fs[j]) {
      tail = x[j];
      any = true;
    } else {
      tail = k8_comb<A>(op, tail, x[j]);
    }
  }
  bool fin;
  A run;
  k8_block_scan<A>(op, id, any, tail, &fin, &run, wf, wv);
  long long cur = start_in;  // -1: the segment began before this tile
  for (int j = 0; j < K8_ITEMS; j++) {
    long long r = r0 + j;
    if (r >= tile_end) break;
    if (fs[j]) {
      run = x[j];
      cur = r;
    } else {
      run = k8_comb<A>(op, run, x[j]);
      k8_store<A>(out, r, (A)0);
    }
    bool last = r == tile_end - 1 || (j + 1 < K8_ITEMS ? fs[j + 1] : next_flag);
    if (last) {
      // a segment is live or dead as a whole (the live flag is a key);
      // a dead segment's start gets 0 and its pieces carry nothing
      bool live = ssel[r] != 0;
      if (cur >= 0) {
        k8_store<A>(out, cur, live ? run : (A)0);
      } else if (live) {
        k8_store<A>(K8_CARRY(a, g), tile_start / K8_TILE, run);
      }
    }
  }
}

__global__ void k8_tile(ObKeys k, K8Aggs a, const unsigned char* ssel,
                        const int* __restrict__ order, long long n,
                        unsigned char* __restrict__ out_sel,
                        int* __restrict__ tile_has, long long* last_start) {
  __shared__ int wf[K8_THREADS / 32];
  __shared__ long long wv_i[K8_THREADS / 32];
  __shared__ double wv_f[K8_THREADS / 32];
  __shared__ long long wpos[K8_THREADS / 32];
  long long tile_start = (long long)blockIdx.x * K8_TILE;
  long long tile_end = tile_start + K8_TILE < n ? tile_start + K8_TILE : n;
  long long r0 = tile_start + (long long)threadIdx.x * K8_ITEMS;
  bool fs[K8_ITEMS];
  long long lastf = -1;
  for (int j = 0; j < K8_ITEMS; j++) {
    long long r = r0 + j;
    fs[j] = r < n && k8_new_seg(k, ssel, r);
    if (fs[j]) lastf = r;
    if (r < n) out_sel[r] = (fs[j] && ssel[r]) ? 1 : 0;
  }
  long long rn = r0 + K8_ITEMS;
  bool next_flag = rn < n && k8_new_seg(k, ssel, rn);
  // start position of the segment coming into each thread's rows: an
  // exclusive max-scan of the per-thread last start positions
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long p = lastf;
  for (int o = 1; o < 32; o <<= 1) {
    long long p2 = __shfl_up_sync(OB_FULL_MASK, p, o);
    if (lane >= o && p2 > p) p = p2;
  }
  long long pe = __shfl_up_sync(OB_FULL_MASK, p, 1);
  if (lane == 0) pe = -1;
  if (lane == 31) wpos[w] = p;
  __syncthreads();
  for (int q = 0; q < w; q++) pe = wpos[q] > pe ? wpos[q] : pe;
  if (threadIdx.x == K8_THREADS - 1) {
    long long tl = p;
    for (int q = 0; q < w; q++) tl = wpos[q] > tl ? wpos[q] : tl;
    tile_has[blockIdx.x] = tl >= 0;
    last_start[blockIdx.x] = tl;
  }
  for (int g = 0; g < a.nagg; g++) {
    if (K8_ISF(a, g)) {
      k8_tile_agg<double>(a, g, fs, next_flag, r0, n, tile_start, tile_end,
                          pe, ssel, order, wf, wv_f);
    } else {
      k8_tile_agg<long long>(a, g, fs, next_flag, r0, n, tile_start,
                             tile_end, pe, ssel, order, wf, wv_i);
    }
  }
}

template <typename A>
__device__ __forceinline__ A k8_warp_reduce(int op, A x) {
  for (int o = 16; o > 0; o >>= 1) {
    x = k8_comb<A>(op, x, __shfl_xor_sync(OB_FULL_MASK, x, o));
  }
  return x;
}

// The carries of the tiles after tile t that continue its last segment,
// folded in a fixed order: 32 tiles a step, one per lane. A tile that
// begins with a start ends the walk before it (it wrote no carry); a
// tile that holds a start ends it after its leading piece.
template <typename A>
__device__ __forceinline__ A k8_walk(int op, A id, const void* carry, int t,
                                     int ntiles, const int* tile_has,
                                     const unsigned char* first_flag) {
  int lane = threadIdx.x & 31;
  A acc = id;
  for (int base = t + 1; base < ntiles; base += 32) {
    int j = base + lane;
    bool in = j < ntiles;
    unsigned mff = __ballot_sync(OB_FULL_MASK, !in || first_flag[j]);
    unsigned mhs = __ballot_sync(OB_FULL_MASK, in && tile_has[j]);
    int lim_ff = mff ? __ffs(mff) - 1 : 32;  // lanes before it count
    int lim_hs = mhs ? __ffs(mhs) : 32;      // lanes up to it count
    int lim = lim_ff < lim_hs ? lim_ff : lim_hs;
    A x = lane < lim ? ((const A*)carry)[j] : id;
    acc = k8_comb<A>(op, acc, k8_warp_reduce<A>(op, x));
    if (mff | mhs) break;
  }
  return acc;
}

// One warp per tile t whose last segment is live and continues into the
// next tile: fold the following tiles' carries into the partial written
// at the tile's last start.
__global__ void k8_fix(K8Aggs a, const unsigned char* ssel, long long n,
                       const int* __restrict__ tile_has,
                       const long long* __restrict__ last_start,
                       const unsigned char* __restrict__ first_flag,
                       int ntiles) {
  int t = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (t >= ntiles - 1 || !tile_has[t] || first_flag[t + 1]) return;
  long long at = last_start[t];
  if (!ssel[at]) return;  // a dead segment keeps its 0
  int lane = threadIdx.x & 31;
  for (int g = 0; g < a.nagg; g++) {
    int op = K8_OP(a, g);
    if (K8_ISF(a, g)) {
      double acc = k8_walk<double>(op, k8_ident<double>(K8_IDENT(a, g)),
                                   K8_CARRY(a, g), t, ntiles, tile_has,
                                   first_flag);
      double* o = (double*)K8_OUT(a, g);
      if (lane == 0) o[at] = k8_comb<double>(op, o[at], acc);
    } else {
      long long acc = k8_walk<long long>(op, K8_IDENT(a, g), K8_CARRY(a, g),
                                         t, ntiles, tile_has, first_flag);
      long long* o = (long long*)K8_OUT(a, g);
      if (lane == 0) o[at] = k8_comb<long long>(op, o[at], acc);
    }
  }
}

// Whether the first row of each tile starts a segment.
__global__ void k8_first_flags(ObKeys k, const unsigned char* ssel,
                               long long n, int ntiles,
                               unsigned char* first_flag) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < ntiles) first_flag[t] = k8_new_seg(k, ssel, (long long)t * K8_TILE);
}

// ktable: the device table (ObKeys) of nkeys sorted key columns, null
// when nkeys is 0; ssel: sorted live flags; order: int32 sort order (value
// row of each sorted position). atable: nagg aggregates' entries in
// device memory (K8Aggs; op codes as ob_common.cuh, count taken as a sum
// of ones). out_sel: bool [n]; tile_has: int32 [ntiles]; last_start:
// int64 [ntiles]; first_flag: uint8 [ntiles]; ntiles = ceil(n / K8_TILE).
extern "C" int ob_k8_segreduce(
    int nkeys, const void* ktable, const void* ssel, const void* order,
    long long n, int nagg, const void* atable, void* out_sel, void* tile_has,
    void* last_start, void* first_flag, int ntiles, void* stream) {
  if (nkeys < 0 || nagg < 0 || n < 1 || (nkeys > 0 && ktable == nullptr) ||
      (nagg > 0 && atable == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  ObKeys k;
  k.t = (const long long*)ktable;
  k.ncols = nkeys;
  K8Aggs a;
  a.t = (const long long*)atable;
  a.nagg = nagg;
  const unsigned char* ss = (const unsigned char*)ssel;
  k8_tile<<<ntiles, K8_THREADS, 0, s>>>(k, a, ss, (const int*)order, n,
                                        (unsigned char*)out_sel,
                                        (int*)tile_has,
                                        (long long*)last_start);
  int fb = (ntiles + K8_THREADS - 1) / K8_THREADS;
  k8_first_flags<<<fb, K8_THREADS, 0, s>>>(k, ss, n, ntiles,
                                            (unsigned char*)first_flag);
  int wb = (int)(((long long)ntiles * 32 + K8_THREADS - 1) / K8_THREADS);
  k8_fix<<<wb, K8_THREADS, 0, s>>>(a, ss, n, (const int*)tile_has,
                                    (const long long*)last_start,
                                    (const unsigned char*)first_flag, ntiles);
  return (int)cudaGetLastError();
}

extern "C" int ob_k8_tile_rows() { return K8_TILE; }
