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
//                  (int64, float32 or float64), a segmented min/max (NaN
//                  propagating, like jnp.minimum/maximum), the cummax of
//                  marked segment starts and the reversed cummin of the
//                  marked segment ends
//   ob_k13_search  per-row binary search of a target in a sorted int64
//                  array, globally or inside [lo, hi) per row
//
// Bound on an H100 (3.35 TB/s): each scan reads its input once (plus the
// flags) and writes its output once; the flags read each key column once
// and write a byte a row; the search reads log2(range) random sectors per
// row. All bytes bound.
//
// Design: what held the first design back, and what this one does about
// it:
// - a scan was three launches (tile pairs, a carry walk by one block of
//   1,024 threads over 3,700+ tiles, a rescan), so each input and flag was
//   read twice: now ONE launch a scan. Tiles take tickets in launch order
//   (a reverse scan walks the tiles from the end); each publishes its
//   (flag, aggregate) descriptor, then looks back over its predecessors'
//   (below) for the prefix it carries in;
// - elements were staged one by one behind a runtime type switch a row:
//   a kernel body per (element type, accumulator, op), inputs and flags
//   read with 16-byte loads into a shared tile (padded one slot in 16, so
//   a thread's 16 consecutive rows fall on distinct banks) and the output
//   written through it with 16-byte stores. The mark modes read the one
//   flag past a tile's edge beside its own;
// - the run flags read every key column with a type switch a row: each
//   thread now compares 16 consecutive rows of a column (16-byte loads,
//   the previous row from the lane below) in a loop compiled per type,
//   and writes its 16 flags as one 16-byte store.
// Fixed association, so every op takes the look-back: a tile's aggregate
// folds its rows in an order fixed by the tile (each thread's 16 rows in
// order, then a fixed shuffle tree), tiles fall into chunks of 32 whose
// aggregate is a fixed shuffle scan of theirs, and a chunk's prefix is the
// left fold of the chunk aggregates in scan order, published as soon as a
// tile has computed it (k13_lookback). Every published prefix is the same
// fold whichever tiles were running, so a float sum (in double) comes out
// with the same bits on every run, and agrees with a sequential cumsum to
// rounding; integer sums, min, max and the marks equal any other order's.
// A first look-back that waited for an inclusive prefix within 32 tiles
// ran the prefix sum 1.5x slower at 15M rows (the prefix advanced 32 tiles
// a hop). Measured and not kept (bench_k13.py, PERF.md): a full tile's
// loads in flight together; 8 rows a thread; 32 chunk statuses read at
// once with four chunks' aggregates a round trip.
#include <type_traits>

#include "ob_common.cuh"

#define K13_THREADS 256
#define K13_ITEMS 16
#define K13_TILE (K13_THREADS * K13_ITEMS)
// rows a thread of the run flags compares (its flags are one 16-byte
// store)
#define K13_FLAG_ROWS 16
#define K13_MAX_KEYS 16
#define K13_MAX_SPINS (1LL << 26)
// the shared tile's padded slot of row o (one slot in 16)
#define K13_PAD(o) ((o) + ((o) >> 4))
#define K13_SLOTS (K13_TILE + K13_TILE / 16)

// value modes: the input itself, the marked segment starts
// (flags[i] ? i : 0, scanned with max), the marked segment ends
// ((i == n - 1 || flags[i + 1]) ? i : n - 1, scanned with min in reverse)
#define K13_VAL 0
#define K13_START_MARK 1
#define K13_END_MARK 2

// a tile's status word (by its place in the scan): the kind in bits 0-1,
// the published pair's flag in bit 2
#define K13_AGG 1
#define K13_INC 2

template <typename A>
struct K13P {
  A v;
  int f;
};

template <typename A>
struct K13Lim;
template <>
struct K13Lim<signed char> {
  __device__ static signed char lo() { return -128; }
  __device__ static signed char hi() { return 127; }
};
template <>
struct K13Lim<unsigned char> {
  __device__ static unsigned char lo() { return 0; }
  __device__ static unsigned char hi() { return 255; }
};
template <>
struct K13Lim<short> {
  __device__ static short lo() { return -32768; }
  __device__ static short hi() { return 32767; }
};
template <>
struct K13Lim<int> {
  __device__ static int lo() { return (int)0x80000000u; }
  __device__ static int hi() { return 0x7fffffff; }
};
template <>
struct K13Lim<long long> {
  __device__ static long long lo() { return (long long)0x8000000000000000ull; }
  __device__ static long long hi() { return 0x7fffffffffffffffll; }
};
template <>
struct K13Lim<float> {
  __device__ static float lo() { return -__int_as_float(0x7f800000); }
  __device__ static float hi() { return __int_as_float(0x7f800000); }
};
template <>
struct K13Lim<double> {
  __device__ static double lo() { return -__longlong_as_double(0x7ff0000000000000ll); }
  __device__ static double hi() { return __longlong_as_double(0x7ff0000000000000ll); }
};

template <int OP, typename A>
__device__ __forceinline__ A k13_ident() {
  if constexpr (OP == OB_SUM) {
    return (A)0;
  } else if constexpr (OP == OB_MIN) {
    return K13Lim<A>::hi();
  } else {
    return K13Lim<A>::lo();
  }
}

// NaN-propagating min/max (the earlier operand on ties, so -0.0 and 0.0
// keep their order's first); integer sums wrap in two's complement
template <int OP, typename A>
__device__ __forceinline__ A k13_op(A a, A b) {
  if constexpr (OP == OB_SUM) {
    if constexpr (std::is_integral<A>::value) {
      return (A)((unsigned long long)a + (unsigned long long)b);
    } else {
      return a + b;
    }
  } else {
    if (a != a) return a;
    if (b != b) return b;
    if constexpr (OP == OB_MIN) {
      return b < a ? b : a;
    } else {
      return b > a ? b : a;
    }
  }
}

template <int OP, typename A>
__device__ __forceinline__ K13P<A> k13_comb(K13P<A> a, K13P<A> b) {
  K13P<A> r;
  r.f = a.f | b.f;
  r.v = b.f ? b.v : k13_op<OP, A>(a.v, b.v);
  return r;
}

// warp shuffles of any accumulator (narrow integers ride an int)
template <typename A>
__device__ __forceinline__ A k13_shfl_up(A v, int d) {
  if constexpr (sizeof(A) < 4) {
    return (A)__shfl_up_sync(OB_FULL_MASK, (int)v, d);
  } else {
    return __shfl_up_sync(OB_FULL_MASK, v, d);
  }
}

template <typename A>
__device__ __forceinline__ A k13_shfl(A v, int l) {
  if constexpr (sizeof(A) < 4) {
    return (A)__shfl_sync(OB_FULL_MASK, (int)v, l);
  } else {
    return __shfl_sync(OB_FULL_MASK, v, l);
  }
}

template <typename A>
__device__ __forceinline__ unsigned long long k13_bits(A v) {
  unsigned long long u = 0ull;
  memcpy(&u, &v, sizeof(A));
  return u;
}

template <typename A>
__device__ __forceinline__ A k13_from(unsigned long long u) {
  A v;
  memcpy(&v, &u, sizeof(A));
  return v;
}

// The scratch of one scan (ob_k13_scratch_bytes): the ticket, a status
// word a tile and a chunk of 32 tiles (all zeroed before the launch),
// each tile's aggregate and each chunk's inclusive prefix, 8-byte words.
struct K13Scratch {
  int* ticket;
  int* tile_st;
  int* chunk_st;
  unsigned long long* agg;
  unsigned long long* qv;
};

static __host__ __device__ long long k13_chunks(long long ntiles) {
  return (ntiles + 31) / 32;
}

static __host__ __device__ long long k13_status_bytes(long long ntiles) {
  return 8 + ((4 * (ntiles + k13_chunks(ntiles)) + 7) & ~7ll);
}

static K13Scratch k13_scratch(void* base, long long ntiles) {
  K13Scratch s;
  unsigned char* b = (unsigned char*)base;
  s.ticket = (int*)b;
  s.tile_st = (int*)(b + 8);
  s.chunk_st = s.tile_st + ntiles;
  s.agg = (unsigned long long*)(b + k13_status_bytes(ntiles));
  s.qv = s.agg + ntiles;
  return s;
}

struct K13Scan {
  const void* in;
  const unsigned char* flags;
  void* out;
  long long n;
  int mode;
  int reverse;
  int segmented;
  int ntiles;
  K13Scratch sc;
};

// len elements of T from src (16-byte loads where aligned) into the
// padded shared tile
template <typename T>
__device__ __forceinline__ void k13_stage(const T* src, int len, T* s_v) {
  constexpr int V = 16 / sizeof(T);
  int nv = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? len / V : 0;
  for (int c = threadIdx.x; c < nv; c += K13_THREADS) {
    uint4 q = __ldg((const uint4*)src + c);
    T e[V];
    memcpy(e, &q, 16);
#pragma unroll
    for (int k = 0; k < V; k++) s_v[K13_PAD(c * V + k)] = e[k];
  }
  for (int o = nv * V + threadIdx.x; o < len; o += K13_THREADS) {
    s_v[K13_PAD(o)] = __ldg(src + o);
  }
}

// the flags F[start .. start + len] into s_f[0 .. len], F[n] = 1 (the row
// after the last row ends every segment)
__device__ __forceinline__ void k13_stage_flags(const unsigned char* flags,
                                                long long start, int len,
                                                long long n,
                                                unsigned char* s_f) {
  const unsigned char* src = flags + start;
  int nv = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? len >> 4 : 0;
  for (int c = threadIdx.x; c < nv; c += K13_THREADS) {
    ((uint4*)s_f)[c] = __ldg((const uint4*)src + c);
  }
  for (int o = (nv << 4) + threadIdx.x; o <= len; o += K13_THREADS) {
    s_f[o] = start + o < n ? (__ldg(src + o) != 0) : 1;
  }
}

// the out tile from the padded shared tile to dst, 16-byte stores where
// aligned
template <typename T>
__device__ __forceinline__ void k13_unstage(T* dst, int len, const T* s_v) {
  constexpr int V = 16 / sizeof(T);
  int nv = (reinterpret_cast<uintptr_t>(dst) & 15) == 0 ? len / V : 0;
  for (int c = threadIdx.x; c < nv; c += K13_THREADS) {
    T e[V];
#pragma unroll
    for (int k = 0; k < V; k++) e[k] = s_v[K13_PAD(c * V + k)];
    uint4 q;
    memcpy(&q, e, 16);
    ((uint4*)dst)[c] = q;
  }
  for (int o = nv * V + threadIdx.x; o < len; o += K13_THREADS) {
    dst[o] = s_v[K13_PAD(o)];
  }
}

// The (flag, value) pair of the tile's j-th row in scan order (physical
// row o of the tile).
template <typename T, typename A>
__device__ __forceinline__ K13P<A> k13_item(const K13Scan& s, long long start,
                                            int o, const T* s_v,
                                            const unsigned char* s_f) {
  K13P<A> p;
  p.f = 0;
  if (s.mode == K13_START_MARK) {
    p.v = (A)(s_f[o] ? start + o : 0);
  } else if (s.mode == K13_END_MARK) {
    p.v = (A)(s_f[o + 1] ? start + o : s.n - 1);
  } else {
    p.v = (A)s_v[K13_PAD(o)];
    if (s.segmented) p.f = s.reverse ? s_f[o + 1] : s_f[o];
  }
  return p;
}

// Spin until tile j's aggregate is published; its (flag, value).
template <typename A>
__device__ __forceinline__ K13P<A> k13_tile_agg(const K13Scratch& sc, int j) {
  volatile int* ps = sc.tile_st + j;
  int st;
  long long spins = 0;
  while ((st = *ps) == 0) {
    __nanosleep(32);
    if (++spins > K13_MAX_SPINS) __trap();
  }
  __threadfence();
  K13P<A> x;
  x.f = (st >> 2) & 1;
  x.v = k13_from<A>(__ldcg(sc.agg + j));
  return x;
}

// Inclusive scan of one pair a lane, in lane order (a fixed shuffle tree:
// lane l's result depends on lanes 0..l alone).
template <int OP, typename A>
__device__ __forceinline__ K13P<A> k13_warp_scan(K13P<A> x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    K13P<A> up;
    up.v = k13_shfl_up(x.v, d);
    up.f = __shfl_up_sync(OB_FULL_MASK, x.f, d);
    if (lane >= d) x = k13_comb<OP, A>(up, x);
  }
  return x;
}

template <typename A>
__device__ __forceinline__ K13P<A> k13_shfl_pair(K13P<A> x, int l) {
  K13P<A> y;
  y.v = k13_shfl(x.v, l);
  y.f = __shfl_sync(OB_FULL_MASK, x.f, l);
  return y;
}

__device__ __forceinline__ void k13_publish(int* st, unsigned long long* slot,
                                            int kind, unsigned long long v,
                                            int f) {
  *slot = v;
  __threadfence();
  atomicExch(st, kind | (f ? 4 : 0));
}

// The exclusive prefix of scan tile q > 0 (aggregate `mine`, already
// published), by one warp. Tiles fall into chunks of 32; a chunk's
// aggregate C is the fixed shuffle scan of its tiles' aggregates, and the
// prefix through chunk g is Q(g) = Q(g - 1) (+) C(g), a left fold in chunk
// order. The tile's prefix is Q(g - 1) (+) (its chunk's tiles before it,
// scanned), unless those hold a segment start. Q(g - 1) comes from the
// nearest chunk whose Q is published (or whose C holds a segment start,
// or chunk 0), then the later chunks' C folded on one by one, oldest
// first, and is published in turn; the chunk's last tile publishes Q(g).
// Every Q is thus the same left fold whichever tiles were running. Every
// tile it waits on holds an earlier ticket, so it runs or is done; a
// status that never comes is a fault, and the launch traps.
template <int OP, typename A>
__device__ K13P<A> k13_lookback(const K13Scratch& sc, int q, K13P<A> mine) {
  const int lane = threadIdx.x & 31;
  const int g = q >> 5, k = q & 31;
  // this chunk's tiles up to this one
  K13P<A> x;
  x.v = k13_ident<OP, A>();
  x.f = 0;
  if (lane < k) x = k13_tile_agg<A>(sc, (g << 5) + lane);
  if (lane == k) x = mine;
  x = k13_warp_scan<OP, A>(x);
  K13P<A> loc = k13_shfl_pair(x, k > 0 ? k - 1 : 0);
  const K13P<A> chunk = k13_shfl_pair(x, 31);
  K13P<A> ex = loc;
  if (g > 0 && !(k > 0 && loc.f)) {
    // walk back: lane w holds chunk g - 1 - w's Q or C
    K13P<A> held;
    held.v = k13_ident<OP, A>();
    held.f = 0;
    int w = 0;
    bool direct = false;
    long long polls = 0;
    for (;;) {
      const int c = g - 1 - w;
      int cs = lane == 0 ? *(volatile int*)(sc.chunk_st + c) : 0;
      cs = __shfl_sync(OB_FULL_MASK, cs, 0);
      K13P<A> val;
      bool stop;
      if (cs != 0) {
        __threadfence();
        val.f = (cs >> 2) & 1;
        val.v = k13_from<A>(__ldcg(sc.qv + c));
        stop = true;
        direct = w == 0;
      } else {
        K13P<A> y = k13_warp_scan<OP, A>(k13_tile_agg<A>(sc, (c << 5) + lane));
        val = k13_shfl_pair(y, 31);
        stop = val.f != 0 || c == 0;
      }
      if (lane == w) held = val;
      w++;
      if (stop) break;
      if (w == 32) {  // none of 32 chunks settles it yet: poll again
        w = 0;
        __nanosleep(256);
        if (++polls > K13_MAX_SPINS) __trap();
      }
    }
    K13P<A> acc = k13_shfl_pair(held, w - 1);
    for (int i = w - 2; i >= 0; i--) {
      acc = k13_comb<OP, A>(acc, k13_shfl_pair(held, i));
    }
    if (lane == 0 && !direct) {
      k13_publish(sc.chunk_st + g - 1, sc.qv + g - 1, K13_INC,
                  k13_bits<A>(acc.v), acc.f);
    }
    ex = k > 0 ? k13_comb<OP, A>(acc, loc) : acc;
    if (k == 31 && lane == 0) {
      K13P<A> qg = k13_comb<OP, A>(acc, chunk);
      k13_publish(sc.chunk_st + g, sc.qv + g, K13_INC, k13_bits<A>(qg.v),
                  qg.f);
    }
  } else if (k == 31 && lane == 0) {
    // chunk 0's Q is its C; a chunk whose tiles before the last hold a
    // segment start: Q(g) = Q(g - 1) (+) C(g) = C(g)
    k13_publish(sc.chunk_st + g, sc.qv + g, K13_INC, k13_bits<A>(chunk.v),
                chunk.f);
  }
  return ex;
}

// One scan, single pass. T: the element type of the input and the output
// (long long for the mark modes), A: the accumulator (double for float32
// sums, else T). Thread t owns the tile's rows 16 t .. 16 t + 15 in scan
// order (a reverse scan's first is the tile's last row).
template <typename T, typename A, int OP>
__global__ void __launch_bounds__(K13_THREADS) k13_scan(K13Scan s) {
  __shared__ __align__(16) T s_v[K13_SLOTS];
  __shared__ __align__(16) unsigned char s_f[K13_TILE + 16];
  __shared__ K13P<A> s_w[K13_THREADS / 32];
  __shared__ K13P<A> s_carry, s_total;
  __shared__ int s_q;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_q = atomicAdd(s.sc.ticket, 1);
  __syncthreads();
  const int q = s_q;
  const int p = s.reverse ? s.ntiles - 1 - q : q;
  const long long start = (long long)p * K13_TILE;
  const int len = (int)(s.n - start < K13_TILE ? s.n - start : K13_TILE);
  if (s.mode == K13_VAL) k13_stage<T>((const T*)s.in + start, len, s_v);
  if (s.mode != K13_VAL || s.segmented) {
    k13_stage_flags(s.flags, start, len, s.n, s_f);
  }
  __syncthreads();

  // the thread's rows folded in scan order
  const int j0 = t * K13_ITEMS;
  K13P<A> mine;
  mine.v = k13_ident<OP, A>();
  mine.f = 0;
#pragma unroll
  for (int k = 0; k < K13_ITEMS; k++) {
    const int j = j0 + k;
    if (j < len) {
      const int o = s.reverse ? len - 1 - j : j;
      K13P<A> x = k13_item<T, A>(s, start, o, s_v, s_f);
      mine = k == 0 ? x : k13_comb<OP, A>(mine, x);
    }
  }
  // the block's exclusive scan of the threads' pairs (a fixed tree)
  K13P<A> inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    K13P<A> up;
    up.v = k13_shfl_up(inc.v, d);
    up.f = __shfl_up_sync(OB_FULL_MASK, inc.f, d);
    if (lane >= d) inc = k13_comb<OP, A>(up, inc);
  }
  K13P<A> exc;
  exc.v = k13_shfl_up(inc.v, 1);
  exc.f = __shfl_up_sync(OB_FULL_MASK, inc.f, 1);
  if (lane == 31) s_w[warp] = inc;
  __syncthreads();
  bool has = lane > 0;  // exc holds the warp's earlier lanes
  K13P<A> before;
  before.v = k13_ident<OP, A>();
  before.f = 0;
  for (int w = 0; w < warp; w++) {
    before = w == 0 ? s_w[0] : k13_comb<OP, A>(before, s_w[w]);
  }
  if (warp > 0) exc = has ? k13_comb<OP, A>(before, exc) : before;
  has = has || warp > 0;

  // publish the tile's aggregate, then look back
  if (t == 0) {
    K13P<A> total = s_w[0];
    for (int w = 1; w < K13_THREADS / 32; w++) {
      total = k13_comb<OP, A>(total, s_w[w]);
    }
    s_total = total;
    k13_publish(s.sc.tile_st + q, s.sc.agg + q, K13_AGG,
                k13_bits<A>(total.v), total.f);
  }
  if (warp == 0 && q > 0) {
    __syncwarp();
    K13P<A> ex = k13_lookback<OP, A>(s.sc, q, s_total);
    if (lane == 0) s_carry = ex;
  }
  __syncthreads();

  // the rows' prefixes into the shared tile, then out
  K13P<A> run;
  if (q > 0) {
    run = has ? k13_comb<OP, A>(s_carry, exc) : s_carry;
  } else {
    run = exc;
  }
  bool any = q > 0 || has;
#pragma unroll
  for (int k = 0; k < K13_ITEMS; k++) {
    const int j = j0 + k;
    if (j < len) {
      const int o = s.reverse ? len - 1 - j : j;
      K13P<A> x = k13_item<T, A>(s, start, o, s_v, s_f);
      run = any ? k13_comb<OP, A>(run, x) : x;
      any = true;
      s_v[K13_PAD(o)] = (T)run.v;
    }
  }
  __syncthreads();
  k13_unstage<T>((T*)s.out + start, len, s_v);
}

template <typename T, typename A, int OP>
static cudaError_t k13_launch(const K13Scan& s, cudaStream_t st) {
  k13_scan<T, A, OP><<<s.ntiles, K13_THREADS, 0, st>>>(s);
  return cudaGetLastError();
}

// T = A for min and max, one body a type
template <int OP>
static cudaError_t k13_minmax(const K13Scan& s, int dt, cudaStream_t st) {
  switch (dt) {
    case OB_I8: return k13_launch<signed char, signed char, OP>(s, st);
    case OB_BOOL:
    case OB_U8: return k13_launch<unsigned char, unsigned char, OP>(s, st);
    case OB_I16: return k13_launch<short, short, OP>(s, st);
    case OB_I32: return k13_launch<int, int, OP>(s, st);
    case OB_F32: return k13_launch<float, float, OP>(s, st);
    case OB_F64: return k13_launch<double, double, OP>(s, st);
    default: return k13_launch<long long, long long, OP>(s, st);
  }
}

extern "C" int ob_k13_tile_rows() { return K13_TILE; }

// Bytes of a scan's scratch for ntiles tiles.
extern "C" long long ob_k13_scratch_bytes(long long ntiles) {
  return k13_status_bytes(ntiles) + 8 * (ntiles + k13_chunks(ntiles));
}

// in/dt: the input column (ignored by the mark modes, whose output is
// int64); flags: bool [n] segment starts (null unless segmented or a mark
// mode); op: OB_SUM (int64, float32, float64), OB_MIN or OB_MAX; reverse:
// scan from the last row; out: n elements of dt (int64 for the marks);
// scratch: ob_k13_scratch_bytes(ntiles) bytes, ntiles = ceil(n /
// ob_k13_tile_rows()), its ticket and status words zeroed here.
extern "C" int ob_k13_scan(const void* in, int dt, const void* flags,
                           int mode, int op, int reverse, int segmented,
                           long long n, void* out, void* scratch,
                           long long ntiles, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (ntiles != (n + K13_TILE - 1) / K13_TILE || ntiles >= (1ll << 31) ||
      scratch == nullptr || out == nullptr ||
      (mode != K13_VAL && mode != K13_START_MARK && mode != K13_END_MARK) ||
      ((mode != K13_VAL || segmented) && flags == nullptr) ||
      (mode == K13_VAL && in == nullptr) ||
      (op != OB_SUM && op != OB_MIN && op != OB_MAX) ||
      (mode == K13_VAL && op == OB_SUM &&
       dt != OB_I64 && dt != OB_F32 && dt != OB_F64) ||
      (mode != K13_VAL && op == OB_SUM)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)k13_status_bytes(ntiles),
                                  st);
  if (e != cudaSuccess) return (int)e;
  K13Scan s;
  s.in = in;
  s.flags = (const unsigned char*)flags;
  s.out = out;
  s.n = n;
  s.mode = mode;
  s.reverse = reverse;
  s.segmented = segmented;
  s.ntiles = (int)ntiles;
  s.sc = k13_scratch(scratch, ntiles);
  if (mode != K13_VAL) dt = OB_I64;
  if (op == OB_SUM) {
    if (dt == OB_F32) e = k13_launch<float, double, OB_SUM>(s, st);
    else if (dt == OB_F64) e = k13_launch<double, double, OB_SUM>(s, st);
    else e = k13_launch<long long, long long, OB_SUM>(s, st);
  } else if (op == OB_MIN) {
    e = k13_minmax<OB_MIN>(s, dt, st);
  } else {
    e = k13_minmax<OB_MAX>(s, dt, st);
  }
  return (int)e;
}

// ---- run flags ---------------------------------------------------------------

struct K13Keys {
  const void* col[K13_MAX_KEYS];
  int dt[K13_MAX_KEYS];
  int ncols;
};

// the type a key's values are compared and shuffled in: narrow integers
// widen to int (equal exactly when the values are), floats stay floats
// (NaN != NaN, -0.0 == 0.0)
template <typename T> struct K13Wide { typedef int type; };
template <> struct K13Wide<long long> { typedef long long type; };
template <> struct K13Wide<float> { typedef float type; };
template <> struct K13Wide<double> { typedef double type; };

// Bit k of *d set where row r0 + k differs from row r0 + k - 1 in this
// column: the thread's 16 rows as 16-byte loads where aligned, the row
// before them from the lane below (lane 0 loads it).
template <typename T>
__device__ __forceinline__ void k13_col_diff(const void* col, long long r0,
                                             long long n, unsigned* d) {
  typedef typename K13Wide<T>::type W;
  constexpr int V = 16 / sizeof(T);
  const T* c = (const T*)col;
  const int lane = threadIdx.x & 31;
  T v[K13_FLAG_ROWS];
  if (r0 + K13_FLAG_ROWS <= n && (reinterpret_cast<uintptr_t>(c) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < K13_FLAG_ROWS / V; q++) {
      uint4 x = __ldg((const uint4*)(c + r0) + q);
      memcpy(v + q * V, &x, 16);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K13_FLAG_ROWS; k++) {
      v[k] = r0 + k < n ? __ldg(c + r0 + k) : (T)0;
    }
  }
  W prev = __shfl_up_sync(OB_FULL_MASK, (W)v[K13_FLAG_ROWS - 1], 1);
  if (lane == 0 && r0 > 0 && r0 < n) prev = (W)__ldg(c + r0 - 1);
  unsigned b = 0u;
#pragma unroll
  for (int k = 0; k < K13_FLAG_ROWS; k++) {
    W x = (W)v[k];
    if (x != prev) b |= 1u << k;
    prev = x;
  }
  *d |= b;
}

__global__ void __launch_bounds__(K13_THREADS)
    k13_flags(K13Keys a, long long n, unsigned char* __restrict__ out) {
  const long long rows = (long long)K13_THREADS * K13_FLAG_ROWS;
  for (long long base = (long long)blockIdx.x * rows; base < n;
       base += (long long)gridDim.x * rows) {
    const long long r0 = base + (long long)threadIdx.x * K13_FLAG_ROWS;
    unsigned d = r0 == 0 ? 1u : 0u;
    for (int c = 0; c < a.ncols; c++) {
      switch (a.dt[c]) {
        case OB_BOOL:
        case OB_U8:
          k13_col_diff<unsigned char>(a.col[c], r0, n, &d);
          break;
        case OB_I8:
          k13_col_diff<signed char>(a.col[c], r0, n, &d);
          break;
        case OB_I16:
          k13_col_diff<short>(a.col[c], r0, n, &d);
          break;
        case OB_I32:
          k13_col_diff<int>(a.col[c], r0, n, &d);
          break;
        case OB_F32:
          k13_col_diff<float>(a.col[c], r0, n, &d);
          break;
        case OB_F64:
          k13_col_diff<double>(a.col[c], r0, n, &d);
          break;
        default:
          k13_col_diff<long long>(a.col[c], r0, n, &d);
          break;
      }
    }
    if (r0 + K13_FLAG_ROWS <= n && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      unsigned w[4];
#pragma unroll
      for (int q = 0; q < 4; q++) {
        w[q] = 0u;
#pragma unroll
        for (int k = 0; k < 4; k++) {
          w[q] |= ((d >> (4 * q + k)) & 1u) << (8 * k);
        }
      }
      *(uint4*)(out + r0) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int k = 0; k < K13_FLAG_ROWS && r0 + k < n; k++) {
        out[r0 + k] = (unsigned char)((d >> k) & 1u);
      }
    }
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

// ---- frame-bound search ---------------------------------------------------------

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
