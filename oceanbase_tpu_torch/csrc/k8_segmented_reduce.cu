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
// Bound on an H100 (3.35 TB/s): one read of the sorted sel and one write
// of sel and of each result over every row; the sorted keys and the order
// only over the live rows (a dead row's keys do not change the result),
// and each aggregate's values and mask through the order (random reads,
// sector bound) -- memory bound. What held the first design back, and
// what this one does about it:
// - every row was worked in full, live or dead (the key compares through
//   a type switch per row, a block-wide scan per aggregate): each warp
//   reads the tile's sel with 16-byte loads and votes, and a tile with no
//   live row only writes its zeros (16-byte stores, each warp its eighth,
//   no block barrier); keys are compared only where a row and its
//   neighbour are live, each key column's type resolved once a block and
//   its compare loop compiled for that type;
// - loads and stores strided across the warp (a thread owns 8
//   consecutive rows): sel and the order are staged in shared memory with
//   16-byte loads, the keys read with neighbouring threads on neighbouring
//   rows (the previous row through a warp shuffle), and the results go
//   through a shared tile (padded one value in 16 against bank conflicts)
//   and out as 16-byte stores (sel as one 8-byte store a thread, whole
//   sectors). A value and its mask are loaded side by side, and
//   aggregates under one mask (a sum and a count) read it once;
// - three launches a call (the tiles, the first-row flags, a carry walk):
//   one launch, single pass. Tiles take tickets in launch order; each
//   publishes a descriptor (its last segment's start, that segment's
//   piece per aggregate) once its own rows are stored, and the tile where
//   a segment that crossed tiles ends looks back over those descriptors,
//   32 a step, to the tile that holds the segment's start, folds the
//   pieces in an order fixed by those two tiles, and writes the total at
//   the start. A tile publishes before it looks back, so no wait chains;
// - the key and aggregate tables were uploaded from pinned host memory on
//   every call: up to K8_INLINE entries ride the kernel's parameters, a
//   longer table lies in device memory, so any number of keys and
//   aggregates still take one launch.
// The values are read through the order, so at the dense shape (every
// row live, a segment every ~30 rows) the two random reads a row (value
// and mask, a 32-byte sector each) set the pace, not the bound's bytes.
//
// Design: a tile of K8_TILE sorted rows per block, K8_ITEMS consecutive
// rows per thread for the reduction. Segment starts are found striped
// (row i by thread i % K8_THREADS) and kept as a bitmask in shared memory;
// each thread then reduces its rows sequentially (its values parked in
// shared memory, so they hold no registers across the scan), and a
// block-wide segmented scan of the per-thread (has start, tail) pairs
// (warp shuffles, then the warp totals) hands each thread the running
// value coming into its rows. The owner of a segment's last row in the
// tile writes the total at the segment's first row in the shared result
// tile.
#include "ob_common.cuh"

#define K8_THREADS 256
#define K8_ITEMS 8
#define K8_TILE (K8_THREADS * K8_ITEMS)
#define K8_FIELDS 7
#define K8_INLINE 128
#define K8_HALO 16
#define K8_MAX_SPINS (1LL << 26)
// blocks an SM holds at once (the register cap of __launch_bounds__, 80
// a thread): a tile's phases are short and latency bound, so occupancy
// sets the pace (H100 80GB HBM3 at 700 W, bench_k8.py: 3 blocks ran Q7's
// shape in 0.248 ms and the dense one in 4.30, 2 blocks 0.283 and 4.68,
// 4 blocks, which spill, 0.226 and 5.00)
#define K8_MIN_BLOCKS 3
// the shared result tile is padded by one value in 16, so that a thread's
// 8 consecutive rows (64 bytes apart from its neighbour's) do not all fall
// on one bank pair
#define K8_PAD(i) ((i) + ((i) >> 4))
#define K8_OUT_SLOTS (K8_TILE + K8_TILE / 16)
// a tile's published flag: its descriptor is visible, and whether the
// tile holds a segment start (its last start in `start`)
#define K8_PUB_NO_START 1
#define K8_PUB_START 2

// The table: nkeys key addresses, their nkeys type codes, then K8_FIELDS
// int64 entries per aggregate g: the values' address (0: count), the
// mask's address (0: no mask beyond sel), the output's ([n] int64, or
// double for floats), the values' type code, the op (count as sum), 1 for
// a float accumulator, the identity (a double's bits for floats). In `e`
// when it has at most K8_INLINE entries (t is null), else at t in device
// memory.
struct K8Args {
  long long e[K8_INLINE];
  const long long* t;
  int nkeys;
  int nagg;
};

__device__ __forceinline__ long long k8_entry(const K8Args& a, int i) {
  return a.t != nullptr ? __ldg(a.t + i) : a.e[i];
}

__device__ __forceinline__ long long k8_f(const K8Args& a, int g, int f) {
  return k8_entry(a, 2 * a.nkeys + g * K8_FIELDS + f);
}

// The scratch the wrapper allocates: [0] the ticket counter, then ntiles
// published flags (both zeroed before the launch; K8_PUB_*), ntiles last
// starts, and per tile and aggregate its last segment's piece and its
// leading segment's piece.
struct K8Scratch {
  int* ticket;
  int* flag;
  long long* start;
  long long* piece;
  long long* lead;
};

__device__ __forceinline__ K8Scratch k8_scratch(long long* base, int ntiles,
                                                int nagg) {
  K8Scratch s;
  s.ticket = (int*)base;
  s.flag = (int*)(base + 1);
  long long* p = base + 1 + (ntiles + 1) / 2;
  s.start = p;
  s.piece = p + ntiles;
  s.lead = p + ntiles + (long long)ntiles * nagg;
  return s;
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
__device__ __forceinline__ long long k8_bits(A v);

template <>
__device__ __forceinline__ long long k8_bits<long long>(long long v) {
  return v;
}

template <>
__device__ __forceinline__ long long k8_bits<double>(double v) {
  return __double_as_longlong(v);
}

// The shuffle type of a key column: narrow integers widen to int (equal
// exactly when the values are), floats compare as floats (NaN != NaN,
// -0.0 == 0.0, like the reference's k[1:] != k[:-1]).
template <typename T> struct K8Wide { typedef int type; };
template <> struct K8Wide<float> { typedef float type; };
template <> struct K8Wide<double> { typedef double type; };
template <> struct K8Wide<long long> { typedef long long type; };

// Striped key compares of one column: row i = q * K8_THREADS + threadIdx.x
// of the tile differs from row i - 1, where both are live (a change of
// the live flag is a start already, and a dead row's keys do not matter).
// The previous row comes from the neighbouring lane.
template <typename T>
__device__ __forceinline__ void k8_key_flags(const void* col,
                                             long long tile_start,
                                             long long n,
                                             const unsigned char* s_sel,
                                             bool* fl) {
  typedef typename K8Wide<T>::type W;
  const T* k = (const T*)col;
  int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < K8_ITEMS; q++) {
    int i = q * K8_THREADS + threadIdx.x;
    long long r = tile_start + i;
    bool live = r < n && s_sel[K8_HALO + i] != 0;
    bool both = live && r > 0 && s_sel[K8_HALO + i - 1] != 0;
    W v = live ? (W)__ldg(k + r) : (W)0;
    W p = __shfl_up_sync(OB_FULL_MASK, v, 1);
    if (lane == 0 && both) p = (W)__ldg(k + r - 1);
    if (both && v != p) fl[q] = true;
  }
}

// Whether row r > 0 (both r and r - 1 live) starts a segment: any key
// differs, compared through the type switch (once a tile, for the row
// after it).
__device__ __forceinline__ bool k8_keys_differ(const K8Args& a, long long r) {
  for (int j = 0; j < a.nkeys; j++) {
    const void* key = (const void*)k8_entry(a, j);
    int dt = (int)k8_entry(a, a.nkeys + j);
    if (dt == OB_F32 || dt == OB_F64) {
      if (ob_ldg_f64(key, dt, r) != ob_ldg_f64(key, dt, r - 1)) return true;
    } else if (ob_ldg_i64(key, dt, r) != ob_ldg_i64(key, dt, r - 1)) {
      return true;
    }
  }
  return false;
}

// Bytes [0, nbytes) at dst set to zero by one warp: 16-byte stores where
// dst is aligned, bytes otherwise and for the tail.
__device__ __forceinline__ void k8_zero_warp(unsigned char* dst, int nbytes) {
  int lane = threadIdx.x & 31;
  int nv = ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) ? nbytes >> 4 : 0;
  uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int v = lane; v < nv; v += 32) ((uint4*)dst)[v] = z;
  for (int b = (nv << 4) + lane; b < nbytes; b += 32) dst[b] = 0;
}

// A result tile of len 8-byte values from the padded shared tile to dst,
// two rows (one 16-byte store) a thread at a time.
__device__ __forceinline__ void k8_store_tile(long long* dst,
                                              const long long* s, int len) {
  int nv = ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) ? len >> 1 : 0;
  for (int v = threadIdx.x; v < nv; v += K8_THREADS) {
    int p = K8_PAD(2 * v);  // rows 2v and 2v + 1 share a pad group
    unsigned long long lo = (unsigned long long)s[p];
    unsigned long long hi = (unsigned long long)s[p + 1];
    ((uint4*)dst)[v] = make_uint4((unsigned)lo, (unsigned)(lo >> 32),
                                  (unsigned)hi, (unsigned)(hi >> 32));
  }
  for (int i = (nv << 1) + threadIdx.x; i < len; i += K8_THREADS) {
    dst[i] = s[K8_PAD(i)];
  }
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

// What a thread knows of its K8_ITEMS rows and of its tile. Rows are
// counted from the tile's first row (0 .. len - 1).
struct K8Rows {
  long long tile_start;  // the tile's first row
  int tile, len;
  int i0;                // the thread's first row, K8_ITEMS * threadIdx.x
  unsigned fs;           // bit j: row i0 + j starts a segment
  unsigned live;         // bit j: row i0 + j is live
  bool next_flag;        // the row after the thread's rows starts a segment
  bool tile_closes;      // the tile's last segment ends in the tile
  int start_in;          // where the segment coming into the rows starts,
                         // or -1 (before the tile)
};

// The rows of a thread that feed an aggregate: live, and set in its mask
// at the row's order. Aggregates under the same mask (a sum and a count
// of one column) share the bits, so the mask is read once a tile.
struct K8Mask {
  const unsigned char* ptr;
  unsigned bits;
};

// Each thread's values of one aggregate: the identity on a dead or masked
// row, 1 for a count, the value at the row's order otherwise. A mask not
// yet read is loaded beside the values (independent loads, both in
// flight). The values go to the thread's own slots of s_x, so they hold
// no registers across the block scan; returns the thread's tail (its
// rows reduced since its last start) and whether it holds a start.
template <typename A, typename V>
__device__ __forceinline__ A k8_values(const V* val,
                                       const unsigned char* mask,
                                       const int* s_ord, const K8Rows& w,
                                       int op, A id, K8Mask* mc, A* sx,
                                       bool* any_out) {
  bool fresh = mask != nullptr && mask != mc->ptr;
  unsigned want = w.live;
  if (mask != nullptr && !fresh) want &= mc->bits;
  int4 o0 = *(const int4*)(s_ord + w.i0);
  int4 o1 = *(const int4*)(s_ord + w.i0 + 4);
  int ord[K8_ITEMS] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
  A x[K8_ITEMS];
  unsigned char m[K8_ITEMS];
#pragma unroll
  for (int j = 0; j < K8_ITEMS; j++) {
    x[j] = id;
    m[j] = 1;
    if ((want >> j) & 1) {
      int src = ord[j];
      if (fresh) m[j] = __ldg(mask + src);
      if (val != nullptr) x[j] = (A)__ldg(val + src);
    }
  }
  unsigned eff = want;
  if (fresh) {
#pragma unroll
    for (int j = 0; j < K8_ITEMS; j++) {
      if (!m[j]) eff &= ~(1u << j);
    }
    mc->ptr = mask;
    mc->bits = eff;
  }
  bool any = false;
  A tail = id;
#pragma unroll
  for (int j = 0; j < K8_ITEMS; j++) {
    A v = ((eff >> j) & 1) ? (val != nullptr ? x[j] : (A)1) : id;
    sx[K8_PAD(w.i0 + j)] = v;
    if ((w.fs >> j) & 1) {
      tail = v;
      any = true;
    } else {
      tail = k8_comb<A>(op, tail, v);
    }
  }
  *any_out = any;
  return tail;
}

// One aggregate over the tile: results into the shared tile s_out, the
// tile's last piece and its leading piece into the scratch, then the
// tile out to device memory.
template <typename A, typename V>
__device__ __forceinline__ void k8_tile_agg(const K8Args& a, int g,
                                            const K8Rows& w,
                                            const int* s_ord,
                                            const K8Scratch& sc,
                                            long long* s_out,
                                            long long* s_x, int* wf, A* wv,
                                            K8Mask* mc) {
  int op = (int)k8_f(a, g, 4);
  A id = k8_ident<A>(k8_f(a, g, 6));
  A* sx = (A*)s_x;
  A* so = (A*)s_out;
  bool any;
  A tail = k8_values<A, V>((const V*)k8_f(a, g, 0),
                           (const unsigned char*)k8_f(a, g, 1), s_ord, w, op,
                           id, mc, sx, &any);
  bool fin;
  A run;
  k8_block_scan<A>(op, id, any, tail, &fin, &run, wf, wv);
  int cur = w.start_in;  // -1: the segment began before this tile
#pragma unroll
  for (int j = 0; j < K8_ITEMS; j++) {
    int i = w.i0 + j;
    if (i < w.len) {
      A xj = sx[K8_PAD(i)];
      if ((w.fs >> j) & 1) {
        run = xj;
        cur = i;
      } else {
        run = k8_comb<A>(op, run, xj);
        so[K8_PAD(i)] = (A)0;
      }
      bool tile_last = i == w.len - 1;
      bool last = tile_last ||
                  (j + 1 < K8_ITEMS ? ((w.fs >> (j + 1)) & 1) != 0
                                    : w.next_flag);
      if (last) {
        // a segment is live or dead as a whole (the live flag is a key)
        bool live = ((w.live >> j) & 1) != 0;
        bool ends = !tile_last || w.tile_closes;
        if (cur >= 0) {
          // its start is in this tile: the total, or 0 for a dead
          // segment and for one that continues (the tile where it ends
          // writes its total here after this tile is stored)
          so[K8_PAD(cur)] = (live && ends) ? run : (A)0;
        } else if (live) {
          sc.lead[(long long)w.tile * a.nagg + g] = k8_bits<A>(run);
        }
        if (tile_last) {
          sc.piece[(long long)w.tile * a.nagg + g] = k8_bits<A>(run);
        }
      }
    }
  }
  __syncthreads();
  k8_store_tile((long long*)k8_f(a, g, 2) + w.tile_start, s_out, w.len);
}

template <typename A>
__device__ __forceinline__ void k8_agg_dispatch(const K8Args& a, int g,
                                                const K8Rows& w,
                                                const int* s_ord,
                                                const K8Scratch& sc,
                                                long long* s_out,
                                                long long* s_x, int* wf,
                                                A* wv, K8Mask* mc) {
  if (k8_f(a, g, 0) == 0) {  // count: no values
    k8_tile_agg<A, long long>(a, g, w, s_ord, sc, s_out, s_x, wf, wv, mc);
    return;
  }
  switch ((int)k8_f(a, g, 3)) {
    case OB_BOOL:
    case OB_U8:
      k8_tile_agg<A, unsigned char>(a, g, w, s_ord, sc, s_out, s_x, wf, wv,
                                    mc);
      break;
    case OB_I8:
      k8_tile_agg<A, signed char>(a, g, w, s_ord, sc, s_out, s_x, wf, wv,
                                  mc);
      break;
    case OB_I16:
      k8_tile_agg<A, short>(a, g, w, s_ord, sc, s_out, s_x, wf, wv, mc);
      break;
    case OB_I32:
      k8_tile_agg<A, int>(a, g, w, s_ord, sc, s_out, s_x, wf, wv, mc);
      break;
    case OB_F32:
      k8_tile_agg<A, float>(a, g, w, s_ord, sc, s_out, s_x, wf, wv, mc);
      break;
    case OB_F64:
      k8_tile_agg<A, double>(a, g, w, s_ord, sc, s_out, s_x, wf, wv, mc);
      break;
    default:
      k8_tile_agg<A, long long>(a, g, w, s_ord, sc, s_out, s_x, wf, wv, mc);
      break;
  }
}

template <typename A>
__device__ __forceinline__ A k8_warp_reduce(int op, A x) {
  for (int o = 16; o > 0; o >>= 1) {
    x = k8_comb<A>(op, x, __shfl_xor_sync(OB_FULL_MASK, x, o));
  }
  return x;
}

// The total of the segment that ends in this tile and began in tile
// `head`: the pieces of tiles head .. tile - 1 (32 a step, nearest first,
// each step a fixed shuffle tree) and this tile's leading piece, written
// at the segment's start. One warp; every descriptor it reads is
// published.
template <typename A>
__device__ __forceinline__ void k8_close(const K8Args& a, int g, const K8Scratch& sc,
                         int tile, int head, long long at) {
  int lane = threadIdx.x & 31;
  int op = (int)k8_f(a, g, 4);
  A id = k8_ident<A>(k8_f(a, g, 6));
  A acc = id;
  for (int base = tile - 1; base >= head; base -= 32) {
    int j = base - lane;
    A x = id;
    if (j >= head) {
      long long b = __ldcg(sc.piece + (long long)j * a.nagg + g);
      x = *(A*)&b;
    }
    acc = k8_comb<A>(op, k8_warp_reduce<A>(op, x), acc);
  }
  if (lane == 0) {
    long long b = __ldcg(sc.lead + (long long)tile * a.nagg + g);
    A* out = (A*)k8_f(a, g, 2);
    out[at] = k8_comb<A>(op, acc, *(A*)&b);
  }
}

// Whether a tile's start bitmask holds any start.
__device__ __forceinline__ bool s_flags_any(const unsigned* f) {
  unsigned any = 0;
#pragma unroll
  for (int q = 0; q < K8_TILE / 32; q++) any |= f[q];
  return any != 0;
}

__global__ void __launch_bounds__(K8_THREADS, K8_MIN_BLOCKS)
    k8_segreduce(K8Args a, const unsigned char* __restrict__ ssel,
                 const int* __restrict__ order, long long n,
                 unsigned char* __restrict__ out_sel, long long* scratch,
                 int ntiles) {
  __shared__ __align__(16) unsigned char s_sel[K8_TILE + 2 * K8_HALO];
  __shared__ unsigned s_flags[K8_TILE / 32];
  __shared__ __align__(16) long long s_out[K8_OUT_SLOTS];
  __shared__ __align__(16) long long s_x[K8_OUT_SLOTS];
  __shared__ __align__(16) int s_ord[K8_TILE];
  __shared__ int wf[K8_THREADS / 32];
  __shared__ long long wv_i[K8_THREADS / 32];
  __shared__ double wv_f[K8_THREADS / 32];
  __shared__ int wpos[K8_THREADS / 32];
  __shared__ int s_tile, s_next;
  K8Scratch sc = k8_scratch(scratch, ntiles, a.nagg);
  int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(sc.ticket, 1);
  __syncthreads();
  int tile = s_tile;
  long long tile_start = (long long)tile * K8_TILE;
  int len = (int)((n - tile_start) < K8_TILE ? n - tile_start : K8_TILE);

  // every warp reads the whole tile's sel (64 bytes a lane, 16-byte loads)
  // and votes: a tile with no live row writes its zeros, each warp its
  // eighth, without a block barrier. Its flag carries all a look-back
  // reads of it (no start), so it is published at once; no look-back
  // ever folds a dead tile (a live segment cannot cross one)
  {
    const unsigned char* src = ssel + tile_start;
    unsigned long long any = 0;
    if (len == K8_TILE && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < 4; k++) {
        uint4 v = __ldg((const uint4*)src + lane * 4 + k);
        any |= (unsigned long long)(v.x | v.y | v.z | v.w);
      }
    } else {
      for (int b = lane; b < len; b += 32) any |= __ldg(src + b);
    }
    if (!__any_sync(OB_FULL_MASK, any != 0ull)) {
      if (t == 0) atomicExch(sc.flag + tile, K8_PUB_NO_START);
      const int part = K8_TILE / (K8_THREADS / 32);
      int r0 = warp * part;
      int n0 = len - r0 < part ? len - r0 : part;
      if (n0 > 0) {
        k8_zero_warp(out_sel + tile_start + r0, n0);
        for (int g = 0; g < a.nagg; g++) {
          k8_zero_warp((unsigned char*)((long long*)k8_f(a, g, 2) +
                                        tile_start + r0),
                       n0 * 8);
        }
      }
      return;
    }
  }

  // stage sel (with a halo row on each side) and the order, 16-byte loads
  {
    const unsigned char* src = ssel + tile_start;
    int nv = ((reinterpret_cast<uintptr_t>(src) & 15) == 0) ? len >> 4 : 0;
    for (int v = t; v < nv; v += K8_THREADS) {
      ((uint4*)(s_sel + K8_HALO))[v] = __ldg((const uint4*)src + v);
    }
    for (int b = (nv << 4) + t; b < K8_TILE + K8_HALO; b += K8_THREADS) {
      long long r = tile_start + b;
      s_sel[K8_HALO + b] = r < n ? __ldg(ssel + r) : 0;
    }
    if (t == 0) s_sel[K8_HALO - 1] = tile_start > 0 ? ssel[tile_start - 1] : 0;
    const int* po = order + tile_start;
    int no = ((reinterpret_cast<uintptr_t>(po) & 15) == 0) ? len >> 2 : 0;
    for (int v = t; v < no; v += K8_THREADS) {
      ((int4*)s_ord)[v] = __ldg((const int4*)po + v);
    }
    for (int i = (no << 2) + t; i < len; i += K8_THREADS) {
      s_ord[i] = __ldg(po + i);
    }
  }
  __syncthreads();
  unsigned long long mine =
      *(const unsigned long long*)(s_sel + K8_HALO + t * K8_ITEMS);

  // segment starts, striped: row 0, a change of the live flag, or (both
  // live) any key differing from the previous row
  {
    bool fl[K8_ITEMS];
#pragma unroll
    for (int q = 0; q < K8_ITEMS; q++) {
      int i = q * K8_THREADS + t;
      long long r = tile_start + i;
      fl[q] = r < n && (r == 0 || s_sel[K8_HALO + i] != s_sel[K8_HALO + i - 1]);
    }
    for (int j = 0; j < a.nkeys; j++) {
      const void* col = (const void*)k8_entry(a, j);
      switch ((int)k8_entry(a, a.nkeys + j)) {
        case OB_BOOL:
        case OB_U8:
          k8_key_flags<unsigned char>(col, tile_start, n, s_sel, fl);
          break;
        case OB_I8:
          k8_key_flags<signed char>(col, tile_start, n, s_sel, fl);
          break;
        case OB_I16:
          k8_key_flags<short>(col, tile_start, n, s_sel, fl);
          break;
        case OB_I32:
          k8_key_flags<int>(col, tile_start, n, s_sel, fl);
          break;
        case OB_F32:
          k8_key_flags<float>(col, tile_start, n, s_sel, fl);
          break;
        case OB_F64:
          k8_key_flags<double>(col, tile_start, n, s_sel, fl);
          break;
        default:
          k8_key_flags<long long>(col, tile_start, n, s_sel, fl);
          break;
      }
    }
#pragma unroll
    for (int q = 0; q < K8_ITEMS; q++) {
      unsigned b = __ballot_sync(OB_FULL_MASK, fl[q]);
      if (lane == 0) s_flags[q * (K8_THREADS / 32) + warp] = b;
    }
    if (t == 0) {
      // whether the row after the tile starts a segment
      bool nx = true;
      if (tile_start + len < n) {
        bool l1 = s_sel[K8_HALO + len] != 0;
        bool l0 = s_sel[K8_HALO + len - 1] != 0;
        nx = l1 != l0 || (l1 && k8_keys_differ(a, tile_start + len));
      }
      s_next = nx ? 1 : 0;
    }
  }
  __syncthreads();

  K8Rows w;
  w.tile_start = tile_start;
  w.tile = tile;
  w.len = len;
  w.i0 = t * K8_ITEMS;
  w.fs = (s_flags[t >> 2] >> ((t & 3) * 8)) & 0xffu;
  w.live = 0;
#pragma unroll
  for (int j = 0; j < K8_ITEMS; j++) {
    if ((mine >> (8 * j)) & 0xffull) w.live |= 1u << j;
  }
  w.tile_closes = s_next != 0;
  w.next_flag = t + 1 < K8_THREADS
                    ? ((s_flags[(t + 1) >> 2] >> (((t + 1) & 3) * 8)) & 1u)
                    : w.tile_closes;
  // the start of the segment coming into each thread's rows: an
  // exclusive max-scan of the per-thread last start positions
  {
    int p = w.fs ? w.i0 + (31 - __clz(w.fs)) : -1;
    for (int o = 1; o < 32; o <<= 1) {
      int p2 = __shfl_up_sync(OB_FULL_MASK, p, o);
      if (lane >= o && p2 > p) p = p2;
    }
    int pe = __shfl_up_sync(OB_FULL_MASK, p, 1);
    if (lane == 0) pe = -1;
    if (lane == 31) wpos[warp] = p;
    __syncthreads();
    for (int q = 0; q < warp; q++) pe = wpos[q] > pe ? wpos[q] : pe;
    w.start_in = pe;
    if (t == K8_THREADS - 1) {
      int tl = p;
      for (int q = 0; q < warp; q++) tl = wpos[q] > tl ? wpos[q] : tl;
      sc.start[tile] = tl >= 0 ? tile_start + tl : -1;
    }
  }

  // sel = start & live, one 8-byte store a thread
  {
    unsigned long long sb = 0;
    unsigned both = w.fs & w.live;
#pragma unroll
    for (int j = 0; j < K8_ITEMS; j++) {
      if ((both >> j) & 1) sb |= 1ull << (8 * j);
    }
    unsigned char* dst = out_sel + tile_start + w.i0;
    if (w.i0 + K8_ITEMS <= len &&
        (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
      *(unsigned long long*)dst = sb;
    } else {
      for (int j = 0; j < K8_ITEMS && w.i0 + j < len; j++) {
        dst[j] = (unsigned char)((sb >> (8 * j)) & 0xff);
      }
    }
  }

  K8Mask mc;
  mc.ptr = nullptr;
  mc.bits = 0;
  for (int g = 0; g < a.nagg; g++) {
    __syncthreads();  // the previous tile store has read s_out
    if (k8_f(a, g, 5)) {
      k8_agg_dispatch<double>(a, g, w, s_ord, sc, s_out, s_x, wf, wv_f, &mc);
    } else {
      k8_agg_dispatch<long long>(a, g, w, s_ord, sc, s_out, s_x, wf, wv_i,
                                 &mc);
    }
  }

  // publish: this tile's rows are stored, its descriptor written
  __threadfence();
  __syncthreads();
  if (t == 0) {
    atomicExch(sc.flag + tile, s_flags_any(s_flags) ? K8_PUB_START
                                                    : K8_PUB_NO_START);
  }

  // the leading segment began before this tile, is live and ends here:
  // look back to the tile that holds its start
  bool lead_in = tile_start > 0 && !(s_flags[0] & 1u) &&
                 s_sel[K8_HALO] != 0;
  if (!lead_in) return;
  bool closes = w.tile_closes || s_flags_any(s_flags);
  if (!closes || warp != 0 || a.nagg == 0) return;
  int head = -1, head_lane = 0;
  for (int base = tile - 1; head < 0; base -= 32) {
    if (base < 0) __trap();  // no earlier tile holds a start: a fault
    int j = base - lane;
    int pub = 0;
    if (j >= 0) {
      // every earlier tile holds an earlier ticket, so it is running or
      // done and publishes without waiting; a flag that never comes is a
      // fault, and the launch fails rather than hangs
      volatile int* f = sc.flag + j;
      long long spins = 0;
      while ((pub = *f) == 0) {
        __nanosleep(64);
        if (++spins > K8_MAX_SPINS) __trap();
      }
    }
    unsigned m = __ballot_sync(OB_FULL_MASK, pub == K8_PUB_START);
    if (m) {
      head_lane = __ffs(m) - 1;
      head = base - head_lane;
    }
  }
  // each lane reads what it saw published; the head's start is read by
  // the lane that saw the head's flag
  __threadfence();
  long long at = lane == head_lane ? __ldcg(sc.start + head) : 0;
  at = __shfl_sync(OB_FULL_MASK, at, head_lane);
  for (int g = 0; g < a.nagg; g++) {
    if (k8_f(a, g, 5)) {
      k8_close<double>(a, g, sc, tile, head, at);
    } else {
      k8_close<long long>(a, g, sc, tile, head, at);
    }
  }
}

// nkeys sorted key columns and nagg aggregates in one table (K8Args): up
// to K8_INLINE entries from `inl` into the kernel's parameters (table
// null), else `table` in device memory. ssel: sorted live flags; order:
// int32 sort order (value row of each sorted position); out_sel: bool [n];
// scratch: int64 [k8_scratch_entries(ntiles, nagg)], its ticket and flags
// zeroed here; ntiles = ceil(n / K8_TILE).
extern "C" int ob_k8_segreduce(int nkeys, int nagg, const long long* inl,
                               int ninl, const void* table, const void* ssel,
                               const void* order, long long n, void* out_sel,
                               void* scratch, int ntiles, void* stream) {
  if (nkeys < 0 || nagg < 0 || n < 1 || ninl < 0 || scratch == nullptr ||
      ntiles != (int)((n + K8_TILE - 1) / K8_TILE) ||
      (table == nullptr && (ninl != 2 * nkeys + K8_FIELDS * nagg ||
                            ninl > K8_INLINE ||
                            (ninl > 0 && inl == nullptr)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  K8Args a;
  memset(&a, 0, sizeof(a));
  a.t = (const long long*)table;
  a.nkeys = nkeys;
  a.nagg = nagg;
  if (table == nullptr) {
    for (int i = 0; i < ninl; i++) a.e[i] = inl[i];
  }
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)(1 + (ntiles + 1) / 2) * sizeof(long long), s);
  if (e != cudaSuccess) return (int)e;
  k8_segreduce<<<ntiles, K8_THREADS, 0, s>>>(
      a, (const unsigned char*)ssel, (const int*)order, n,
      (unsigned char*)out_sel, (long long*)scratch, ntiles);
  return (int)cudaGetLastError();
}

extern "C" int ob_k8_tile_rows() { return K8_TILE; }

extern "C" int ob_k8_inline() { return K8_INLINE; }

// int64 entries of the scratch for ntiles tiles and nagg aggregates.
extern "C" long long ob_k8_scratch_entries(int ntiles, int nagg) {
  return 1 + (ntiles + 1) / 2 + (long long)ntiles * (1 + 2LL * nagg);
}
