// K10: M:N join expansion against a key-sorted build side.
//
// Replaces oceanbase_tpu/ops/join.py:177 expand_join, and the range search
// that the sorted-range route of oceanbase_tpu/engine/executor.py:2283-2296
// (_emit_semi_anti) runs alone. The build keys arrive sorted ascending with
// the dead rows last (sort_build_side); nlive, the live build count, stays
// on the device. Per probe row p:
//   lo, hi = the [lower, upper) bounds of its int64 key in the sorted
//            keys, clamped to nlive (the dead tail carries int64 max, and
//            a live probe key of int64 max must not match it)
//   cnt    = probe_sel ? hi - lo : 0
//   offs   = inclusive prefix sum of cnt, starts = offs - cnt (int64)
//   total  = offs[np - 1]
// and per output slot t < cap, with p the probe row whose run
// [starts[p], offs[p]) holds t:
//   probe_row = p, build_row = order[lo[p] + t - starts[p]], valid = 1.
// Slots t >= total hold the reference's clip values: probe_row = np - 1,
// build_row = order[clip(int32(lo[np-1] + t - starts[np-1]), 0, nb - 1)],
// valid = 0, so every slot equals the reference's.
//
// Bound on an H100 (3.35 TB/s): sel once, each live probe key's sector
// once, starts and offs written (16 bytes a probe row), 9 bytes an output
// slot written and the order entry it reads. Bytes bound.
//
// Design: two launches (one for the range search alone).
// (a) k10_ranges: a block takes a tile of K10_TILE probe rows, a warp 256
//     rows as 4 strips of 64, a lane two adjacent rows a strip (16-byte
//     key loads, only where a row of the pair is live; 2-byte sel loads).
//     The tile's live keys span [kmin, kmax]; two warps find that window
//     of the sorted keys by 33-way searches (a round: 32 lanes load 32
//     pivots), so a tile searches global memory twice, not twice a row.
//     The window, or where it is longer than K10_WIN keys an evenly spaced
//     sample of it, is staged in shared memory; each live row searches it
//     (the rows of a lane in lockstep, so their loads overlap), then,
//     where the sample was coarser than the keys, the sample's gap in
//     global memory. hi comes from a galloping search from lo. The counts
//     and the non-empty runs are scanned in the block; the tile's offsets
//     come from a decoupled look-back over the tiles' aggregates, the whole
//     block reading 256 tiles' statuses a round (the tiles in flight run
//     ahead of the nearest inclusive prefix by about as many). Tiles
//     take tickets in launch order; the ticket is put back to 0 by the
//     last taker, and a tile's status word carries the call's epoch, so
//     the scratch is never cleared. starts and offs go out as 16-byte
//     stores, and each non-empty run (its end, probe row and lo) to the
//     next place of a compacted list; the last tile writes total, the
//     runs and row np - 1's lo. The range search alone stops at the counts.
// (b) k10_fill: blocks that stay take tiles of K10_FILL output slots below
//     the total. Two warps find the first and last runs that meet a tile
//     (33-way searches over the compacted runs' ends, so dead and empty
//     probe rows cost nothing here); those runs are staged in shared
//     memory, and each thread writes 4 adjacent slots at a time (16-byte
//     stores), the run of the first by a search of the staged ends, the
//     next ones by stepping. A long run is spread over as many tiles as its
//     slots. Past the last such tile every thread streams the clip values,
//     4 slots at a time.
// Slot indices and offsets are int64 throughout (Q21 expands past 10^8
// pairs); fewer than 2^31 probe and build rows.
#include <atomic>
#include <climits>

#include "ob_common.cuh"

#define K10_THREADS 256
#define K10_TILE 2048          // probe rows a tile: 8 warps x 4 strips x 64
#define K10_WIN 4096           // window (or sample) keys in shared memory
#define K10_FILL 4096          // output slots a fill block: 4 groups of 1024
#define K10_FROWS 2048         // probe rows staged a round of the fill
#define K10_MAX_SPINS (1ll << 26)

#define K10_AGG 1  // a tile's status kinds (low 2 bits; the epoch above)
#define K10_INC 2

// A tile's status: its pairs and its non-empty runs, as an aggregate and
// as an inclusive prefix.
struct K10Tile {
  long long st;            // epoch * 4 + kind
  long long agg_c, agg_z;  // the tile's aggregate (K10_AGG on)
  long long inc_c, inc_z;  // its inclusive prefix (K10_INC)
  long long pad;
};

struct K10Pair {
  long long c, z;  // pairs, non-empty runs
};

// The first index i in [lo, hi) of the sorted a[] with a[i] > key (upper)
// or a[i] >= key, or hi; called by a whole warp, 33 ways a round.
__device__ long long k10_warp_search(const long long* __restrict__ a,
                                     long long lo, long long hi,
                                     long long key, bool upper) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long n = hi - lo;
    const long long p = lo + (n / 33) * (lane + 1) +
                        ((n % 33) * (lane + 1)) / 33;
    const long long v = __ldg(a + p);
    const bool before = upper ? v <= key : v < key;
    const int c = __popc(__ballot_sync(OB_FULL_MASK, before));
    const long long plo = __shfl_sync(OB_FULL_MASK, p, c > 0 ? c - 1 : 0);
    const long long phi = __shfl_sync(OB_FULL_MASK, p, c < 32 ? c : 31);
    if (c > 0) lo = plo + 1;
    if (c < 32) hi = phi;
  }
  const long long n = hi - lo;
  bool before = false;
  if (lane < n) {
    const long long v = __ldg(a + lo + lane);
    before = upper ? v <= key : v < key;
  }
  return lo + __popc(__ballot_sync(OB_FULL_MASK, before));
}

template <typename T>
__device__ __forceinline__ T k10_warp_min(T x) {
  for (int o = 16; o > 0; o >>= 1) {
    T y = __shfl_xor_sync(OB_FULL_MASK, x, o);
    x = y < x ? y : x;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ T k10_warp_max(T x) {
  for (int o = 16; o > 0; o >>= 1) {
    T y = __shfl_xor_sync(OB_FULL_MASK, x, o);
    x = y > x ? y : x;
  }
  return x;
}

struct K10Args {
  const long long* skeys;
  const int* order;
  const long long* nlive;
  const long long* pkey;
  const unsigned char* psel;
  long long np, nb, cap, epoch;
  long long* cnt;     // the range search alone: cnt out
  long long* starts;  // the expansion: starts, offs, total out
  long long* offs;
  long long* total;
  long long* run_end;  // the non-empty runs in row order: their offs,
  int* run_row;        // probe rows and lo
  int* run_lo;
  long long* misc;     // [0] the ticket, [1] the runs, [2] lo of row np - 1
  K10Tile* tiles;
  int* out_pr;
  int* out_br;
  unsigned char* out_valid;
  int vec;  // pkey 16-byte and psel 2-byte aligned
};

// The exclusive prefix of tile q > 0, whose aggregate is published, by
// the whole block: thread t reads tile q - 1 - t's status, 256 tiles a
// round, and the aggregates up to the nearest inclusive prefix are added.
// Every tile it waits on holds an earlier ticket, so it runs or is done; a
// status that never comes is a fault, and it traps. s_first: a shared int;
// s_sum: 16 shared words.
__device__ K10Pair k10_lookback(const K10Args& a, int q, int* s_first,
                                long long* s_sum) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  K10Pair ex = {0, 0};
  int j = q - 1;
  long long spins = 0;
  for (;;) {
    const int idx = j - t;
    int kind = K10_INC;
    if (idx >= 0) {
      const long long st = *(volatile long long*)&a.tiles[idx].st;
      kind = (st >> 2) == a.epoch ? (int)(st & 3) : 0;
    }
    if (t == 0) *s_first = K10_THREADS;
    __syncthreads();
    if (kind == K10_INC) atomicMin(s_first, t);
    __syncthreads();
    const int first = *s_first;  // K10_THREADS: no prefix among these
    if (__syncthreads_or(kind == 0 && t <= first)) {
      __nanosleep(64);  // a tile before the nearest prefix is not out yet
      if (++spins > K10_MAX_SPINS) __trap();
      continue;
    }
    __threadfence();
    long long c = 0, z = 0;
    if (t <= first && idx >= 0) {
      const K10Tile* tl = &a.tiles[idx];
      c = __ldcg(kind == K10_INC ? &tl->inc_c : &tl->agg_c);
      z = __ldcg(kind == K10_INC ? &tl->inc_z : &tl->agg_z);
    }
    for (int o = 16; o > 0; o >>= 1) {
      c += __shfl_xor_sync(OB_FULL_MASK, c, o);
      z += __shfl_xor_sync(OB_FULL_MASK, z, o);
    }
    if (lane == 0) {
      s_sum[w] = c;
      s_sum[8 + w] = z;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K10_THREADS / 32; k++) {
      ex.c += s_sum[k];
      ex.z += s_sum[8 + k];
    }
    __syncthreads();
    if (first < K10_THREADS) return ex;
    j -= K10_THREADS;
  }
}

__device__ __forceinline__ void k10_publish(K10Tile* t, long long epoch,
                                            int kind, K10Pair v) {
  if (kind == K10_INC) {
    t->inc_c = v.c;
    t->inc_z = v.z;
  } else {
    t->agg_c = v.c;
    t->agg_z = v.z;
  }
  __threadfence();
  atomicExch((unsigned long long*)&t->st,
             (unsigned long long)(epoch * 4 + kind));
}

// (a) the ranges of a tile of probe rows; EXPAND: the scan, starts, offs,
// lo and total; else cnt alone.
template <bool VEC, bool EXPAND>
__global__ void __launch_bounds__(K10_THREADS, 4)
k10_ranges(const K10Args a) {
  __shared__ long long s_win[K10_WIN];
  __shared__ long long s_red[3][K10_THREADS / 32];
  __shared__ long long s_w[4];  // wlo, whi, lo of row np - 1, prefix
  __shared__ long long s_sum[16];
  __shared__ int s_tile, s_first;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (EXPAND) {
    if (t == 0) {
      int q = (int)atomicAdd((unsigned long long*)a.misc, 1ull);
      if (q == (int)((a.np + K10_TILE - 1) / K10_TILE) - 1) {
        a.misc[0] = 0;  // the last taker: the ticket back to 0 for the next call
      }
      s_tile = q;
    }
    __syncthreads();
  }
  const int tile = EXPAND ? s_tile : (int)blockIdx.x;
  const long long np = a.np;
  const long long wbase = (long long)tile * K10_TILE + warp * 256 + 2 * lane;
  // a lane's rows: wbase + 64 * s + {0, 1}, strips s = 0..3
  long long key[8];
  unsigned live = 0;  // bit 2s + e: row wbase + 64 s + e is live
#pragma unroll
  for (int s = 0; s < 4; s++) {
    const long long r = wbase + 64 * s;
    unsigned sb = 0;
    if (VEC && r + 1 < np) {
      unsigned short w = __ldg((const unsigned short*)(a.psel + r));
      sb = (w & 0xff ? 1u : 0u) | (w >> 8 ? 2u : 0u);
    } else {
      if (r < np && __ldg(a.psel + r)) sb |= 1u;
      if (r + 1 < np && __ldg(a.psel + r + 1)) sb |= 2u;
    }
    key[2 * s] = key[2 * s + 1] = 0;
    if (sb) {
      if (VEC && r + 1 < np) {
        longlong2 k2 = __ldg((const longlong2*)(a.pkey + r));
        key[2 * s] = k2.x;
        key[2 * s + 1] = k2.y;
      } else {
        if (sb & 1u) key[2 * s] = __ldg(a.pkey + r);
        if (sb & 2u) key[2 * s + 1] = __ldg(a.pkey + r + 1);
      }
    }
    live |= sb << (2 * s);
  }
  // the tile's live key range
  long long kmin = LLONG_MAX, kmax = LLONG_MIN;
  int nl = 0;
#pragma unroll
  for (int e = 0; e < 8; e++) {
    if (live >> e & 1u) {
      kmin = key[e] < kmin ? key[e] : kmin;
      kmax = key[e] > kmax ? key[e] : kmax;
      nl++;
    }
  }
  kmin = k10_warp_min(kmin);
  kmax = k10_warp_max(kmax);
  nl = __reduce_add_sync(OB_FULL_MASK, nl);
  if (lane == 0) {
    s_red[0][warp] = kmin;
    s_red[1][warp] = kmax;
    s_red[2][warp] = nl;
  }
  __syncthreads();
  kmin = LLONG_MAX;
  kmax = LLONG_MIN;
  long long tl = 0;
#pragma unroll
  for (int w = 0; w < K10_THREADS / 32; w++) {
    kmin = s_red[0][w] < kmin ? s_red[0][w] : kmin;
    kmax = s_red[1][w] > kmax ? s_red[1][w] : kmax;
    tl += s_red[2][w];
  }
  const long long nlive = __ldg(a.nlive);
  const long long lastrow = np - 1;
  const bool has_last =
      EXPAND && lastrow >= (long long)tile * K10_TILE &&
      lastrow < (long long)(tile + 1) * K10_TILE;
  if (tl > 0 && warp == 0) {
    long long v = k10_warp_search(a.skeys, 0, nlive, kmin, false);
    if (lane == 0) s_w[0] = v;
  }
  if (tl > 0 && warp == 1) {
    long long v = k10_warp_search(a.skeys, 0, nlive, kmax, true);
    if (lane == 0) s_w[1] = v;
  }
  if (has_last && warp == 2) {
    // row np - 1's lo is read by the clip values of the tail slots, live or not
    long long v = k10_warp_search(a.skeys, 0, nlive, __ldg(a.pkey + lastrow),
                                  false);
    if (lane == 0) s_w[2] = v;
  }
  __syncthreads();
  const long long wlo = tl > 0 ? s_w[0] : 0;
  const long long whi = tl > 0 ? s_w[1] : 0;
  const long long W = whi - wlo;
  const long long step = W > K10_WIN ? (W + K10_WIN - 1) / K10_WIN : 1;
  const int m = W > 0 ? (int)((W + step - 1) / step) : 0;
  for (int j = t; j < m; j += K10_THREADS) {
    s_win[j] = __ldg(a.skeys + wlo + (long long)j * step);
  }
  __syncthreads();
  // lo: the sample entries below the key (the rows of a lane in lockstep),
  // then the sample's gap
  long long lo[8], cnt[8];
  long long gb[8], gn[8];
  int sb[8], sn[8];
#pragma unroll
  for (int e = 0; e < 8; e++) {
    sb[e] = 0;
    sn[e] = live >> e & 1u ? m : 0;  // lower_bound over s_win[0, m)
  }
  if (live) {
    int mbits = 0;
    while ((1 << mbits) < m + 1) mbits++;
    for (int it = 0; it <= mbits; it++) {
#pragma unroll
      for (int e = 0; e < 8; e++) {
        if (sn[e] > 0) {
          const int half = sn[e] >> 1;
          if (s_win[sb[e] + half] < key[e]) {
            sb[e] += half + 1;
            sn[e] -= half + 1;
          } else {
            sn[e] = half;
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; e++) {
    const int c = sb[e];
    if (step == 1 || c == 0) {
      lo[e] = wlo + (c == 0 ? 0 : (long long)c * step);
      gb[e] = lo[e];
      gn[e] = 0;
    } else {
      gb[e] = wlo + (long long)(c - 1) * step + 1;
      long long end = wlo + (long long)c * step;
      end = end < whi ? end : whi;
      gn[e] = end - gb[e];
    }
    if (!(live >> e & 1u)) gn[e] = 0;
  }
  if (step > 1) {
    int gbits = 0;
    while ((1ll << gbits) < step) gbits++;
    for (int it = 0; it <= gbits; it++) {
      long long v[8];
#pragma unroll
      for (int e = 0; e < 8; e++) {
        v[e] = gn[e] > 0 ? __ldg(a.skeys + gb[e] + (gn[e] >> 1)) : 0;
      }
#pragma unroll
      for (int e = 0; e < 8; e++) {
        if (gn[e] > 0) {
          const long long half = gn[e] >> 1;
          if (v[e] < key[e]) {
            gb[e] += half + 1;
            gn[e] -= half + 1;
          } else {
            gn[e] = half;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; e++) lo[e] = gb[e];
  }
  // hi: gallop from lo (the window when it is staged whole)
#pragma unroll
  for (int e = 0; e < 8; e++) {
    cnt[e] = 0;
    if (!(live >> e & 1u)) continue;
    const long long k = key[e];
    long long b = lo[e], d = 1, h;
    // invariant: a[b] <= k for every index below b from lo on; find the
    // first index in [b, whi) above k
    for (;;) {
      const long long probe = b + d - 1;
      if (probe >= whi) {
        h = whi;
        break;
      }
      const long long v = step == 1 ? s_win[probe - wlo] : __ldg(a.skeys + probe);
      if (v > k) {
        h = probe;
        break;
      }
      b = probe + 1;
      d <<= 1;
    }
    // the answer lies in [b, h)
    while (b < h) {
      const long long mid = b + ((h - b) >> 1);
      const long long v = step == 1 ? s_win[mid - wlo] : __ldg(a.skeys + mid);
      if (v > k) h = mid; else b = mid + 1;
    }
    cnt[e] = b - lo[e];
  }
  if (!EXPAND) {
#pragma unroll
    for (int s = 0; s < 4; s++) {
      const long long r = wbase + 64 * s;
      if (VEC && r + 1 < np) {
        *(longlong2*)(a.cnt + r) = make_longlong2(cnt[2 * s], cnt[2 * s + 1]);
      } else {
        if (r < np) a.cnt[r] = cnt[2 * s];
        if (r + 1 < np) a.cnt[r + 1] = cnt[2 * s + 1];
      }
    }
    return;
  }
  // the scan of the pairs and of the non-empty runs: each strip's pairs
  // of rows in lane order, the strips in order, the warps in order, then
  // the tiles before
  long long ex[4];
  int exz[4];
  long long run = 0;
  int runz = 0;
#pragma unroll
  for (int s = 0; s < 4; s++) {
    const long long pair = cnt[2 * s] + cnt[2 * s + 1];
    const int pz = (cnt[2 * s] > 0) + (cnt[2 * s + 1] > 0);
    long long x = pair;
    int xz = pz;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(OB_FULL_MASK, x, o);
      const int yz = __shfl_up_sync(OB_FULL_MASK, xz, o);
      if (lane >= o) {
        x += y;
        xz += yz;
      }
    }
    ex[s] = run + x - pair;
    exz[s] = runz + xz - pz;
    run += __shfl_sync(OB_FULL_MASK, x, 31);
    runz += __shfl_sync(OB_FULL_MASK, xz, 31);
  }
  __syncthreads();  // s_red is reused
  if (lane == 0) {
    s_red[0][warp] = run;
    s_red[1][warp] = runz;
  }
  __syncthreads();
  long long wex = 0, wexz = 0;
  K10Pair agg = {0, 0};
#pragma unroll
  for (int w = 0; w < K10_THREADS / 32; w++) {
    if (w < warp) {
      wex += s_red[0][w];
      wexz += s_red[1][w];
    }
    agg.c += s_red[0][w];
    agg.z += s_red[1][w];
  }
  K10Pair prefix = {0, 0};
  if (tile == 0) {
    if (t == 0) k10_publish(&a.tiles[0], a.epoch, K10_INC, agg);
  } else {
    if (t == 0) k10_publish(&a.tiles[tile], a.epoch, K10_AGG, agg);
    prefix = k10_lookback(a, tile, &s_first, s_sum);
    if (t == 0) {
      const K10Pair inc = {prefix.c + agg.c, prefix.z + agg.z};
      k10_publish(&a.tiles[tile], a.epoch, K10_INC, inc);
    }
  }
  if (t == 0) {
    s_w[3] = prefix.c;
    s_red[2][0] = prefix.z;
    if (has_last) {
      a.total[0] = prefix.c + agg.c;
      a.misc[1] = prefix.z + agg.z;
      a.misc[2] = s_w[2];
    }
  }
  __syncthreads();
  const long long base = s_w[3] + wex;
  const long long basez = s_red[2][0] + wexz;
#pragma unroll
  for (int s = 0; s < 4; s++) {
    const long long r = wbase + 64 * s;
    const long long st0 = base + ex[s];
    const long long of0 = st0 + cnt[2 * s];
    const long long of1 = of0 + cnt[2 * s + 1];
    if (VEC && r + 1 < np) {
      *(longlong2*)(a.starts + r) = make_longlong2(st0, of0);
      *(longlong2*)(a.offs + r) = make_longlong2(of0, of1);
    } else {
      if (r < np) {
        a.starts[r] = st0;
        a.offs[r] = of0;
      }
      if (r + 1 < np) {
        a.starts[r + 1] = of0;
        a.offs[r + 1] = of1;
      }
    }
    long long k = basez + exz[s];
#pragma unroll
    for (int e = 0; e < 2; e++) {
      if (cnt[2 * s + e] > 0) {  // the next non-empty run
        a.run_end[k] = e ? of1 : of0;
        a.run_row[k] = (int)(r + e);
        a.run_lo[k] = (int)lo[2 * s + e];
        k++;
      }
    }
  }
}

// The reference's clip values of slot ts >= total: probe row np - 1 and
// the build row at int32(lo[np - 1] + ts - starts[np - 1]) clipped.
__device__ __forceinline__ int k10_clip_row(const K10Args& a, long long b0,
                                            long long ts) {
  // jnp: (lo + k).astype(int32) wraps, then clips to [0, nb - 1]
  long long b = (long long)(int)(unsigned int)(unsigned long long)(b0 + ts);
  b = b < 0 ? 0 : (b > a.nb - 1 ? a.nb - 1 : b);
  return __ldg(a.order + b);
}

// (b) the output slots: blocks take tiles of K10_FILL slots below the
// total (and the clip values past it in the same tiles), then every thread
// streams 4 slots at a time past them.
__global__ void __launch_bounds__(K10_THREADS, 3)
k10_fill(const K10Args a) {
  __shared__ long long s_off[K10_FROWS + 1];
  __shared__ int s_lo[K10_FROWS];
  __shared__ int s_row[K10_FROWS];
  __shared__ long long s_p[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long np = a.np, cap = a.cap;
  const long long total = __ldcg(a.total);
  const long long nruns = __ldcg(a.misc + 1);
  const long long b0 = __ldcg(a.misc + 2) - __ldcg(a.starts + (np - 1));
  const long long V = total < cap ? total : cap;
  const long long vtiles = (V + K10_FILL - 1) / K10_FILL;
  for (long long tile = blockIdx.x; tile < vtiles; tile += gridDim.x) {
    const long long t0 = tile * K10_FILL;
    const long long t1 = t0 + K10_FILL < cap ? t0 + K10_FILL : cap;
    const long long vend = total < t1 ? total : t1;  // valid slots [t0, vend)
    int pr[16], br[16];
    if (warp == 0) {
      long long v = k10_warp_search(a.run_end, 0, nruns, t0, true);
      if (lane == 0) s_p[0] = v;
    } else if (warp == 1) {
      long long v = k10_warp_search(a.run_end, 0, nruns, vend - 1, true);
      if (lane == 0) s_p[1] = v;
    }
    __syncthreads();
    const long long p0 = s_p[0], p1 = s_p[1];
    for (long long c0 = p0; c0 <= p1; c0 += K10_FROWS) {
      const int k = (int)(p1 - c0 + 1 < K10_FROWS ? p1 - c0 + 1 : K10_FROWS);
      // s_off[i]: the start of run c0 + i (the end of the run before it)
      for (int i = t; i <= k; i += K10_THREADS) {
        const long long r = c0 + i - 1;
        s_off[i] = r >= 0 ? __ldcg(a.run_end + r) : 0;
        if (i < k) {
          s_lo[i] = __ldcg(a.run_lo + c0 + i);
          s_row[i] = __ldcg(a.run_row + c0 + i);
        }
      }
      __syncthreads();
      const long long cs = s_off[0], ce = s_off[k];  // the chunk's slots
#pragma unroll
      for (int g = 0; g < 4; g++) {
        const long long tg = t0 + g * 1024 + 4 * t;
        int i = -1;
#pragma unroll
        for (int u = 0; u < 4; u++) {
          const long long ts = tg + u;
          if (ts < cs || ts >= ce || ts >= vend) continue;
          if (i < 0) {  // the first run of the chunk ending past ts
            int b = 0, n = k;
            while (n > 0) {
              const int half = n >> 1;
              if (s_off[b + half + 1] <= ts) {
                b += half + 1;
                n -= half + 1;
              } else {
                n = half;
              }
            }
            i = b;
          }
          while (s_off[i + 1] <= ts) i++;
          pr[4 * g + u] = s_row[i];
          br[4 * g + u] = __ldg(a.order + (s_lo[i] + (ts - s_off[i])));
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int g = 0; g < 4; g++) {
      const long long tg = t0 + g * 1024 + 4 * t;
#pragma unroll
      for (int u = 0; u < 4; u++) {
        const long long ts = tg + u;
        if (ts >= vend && ts < t1) {
          pr[4 * g + u] = (int)(np - 1);
          br[4 * g + u] = k10_clip_row(a, b0, ts);
        }
      }
      if (tg + 4 <= t1) {
        *(int4*)(a.out_pr + tg) =
            make_int4(pr[4 * g], pr[4 * g + 1], pr[4 * g + 2], pr[4 * g + 3]);
        *(int4*)(a.out_br + tg) =
            make_int4(br[4 * g], br[4 * g + 1], br[4 * g + 2], br[4 * g + 3]);
        unsigned v = 0;
#pragma unroll
        for (int u = 0; u < 4; u++) v |= (tg + u < vend ? 1u : 0u) << (8 * u);
        *(unsigned*)(a.out_valid + tg) = v;
      } else {
#pragma unroll
        for (int u = 0; u < 4; u++) {
          const long long ts = tg + u;
          if (ts < t1) {
            a.out_pr[ts] = pr[4 * g + u];
            a.out_br[ts] = br[4 * g + u];
            a.out_valid[ts] = ts < vend ? 1 : 0;
          }
        }
      }
    }
  }
  // past the tiles: clip values only, 4 slots a thread at a time
  const long long from = vtiles * K10_FILL;
  const long long stride = (long long)gridDim.x * K10_THREADS * 4;
  for (long long tg = from + ((long long)blockIdx.x * K10_THREADS + t) * 4;
       tg < cap; tg += stride) {
    if (tg + 4 <= cap) {
      *(int4*)(a.out_br + tg) =
          make_int4(k10_clip_row(a, b0, tg), k10_clip_row(a, b0, tg + 1),
                    k10_clip_row(a, b0, tg + 2), k10_clip_row(a, b0, tg + 3));
      const int p = (int)(np - 1);
      *(int4*)(a.out_pr + tg) = make_int4(p, p, p, p);
      *(unsigned*)(a.out_valid + tg) = 0u;
    } else {
      for (long long ts = tg; ts < cap; ts++) {
        a.out_br[ts] = k10_clip_row(a, b0, ts);
        a.out_pr[ts] = (int)(np - 1);
        a.out_valid[ts] = 0;
      }
    }
  }
}

static int k10_check(const K10Args& a) {
  return a.np > 0 && a.np < (1ll << 31) && a.nb > 0 && a.nb < (1ll << 31) &&
         a.skeys && a.nlive && a.pkey && a.psel;
}

// The kernels this library has launched (both entries), for a caller that
// checks how many a call takes.
static std::atomic<long long> k10_launched{0};

static cudaError_t k10_counted(cudaError_t e) {
  if (e == cudaSuccess) k10_launched.fetch_add(1);
  return e;
}

template <bool EXPAND>
static cudaError_t k10_launch_ranges(const K10Args& a, cudaStream_t s) {
  const unsigned tiles = (unsigned)((a.np + K10_TILE - 1) / K10_TILE);
  if (a.vec) k10_ranges<true, EXPAND><<<tiles, K10_THREADS, 0, s>>>(a);
  else k10_ranges<false, EXPAND><<<tiles, K10_THREADS, 0, s>>>(a);
  return k10_counted(cudaGetLastError());
}

// The range search alone: cnt int64 [np]. skeys: int64 [nb] sorted (dead
// tail last); nlive: int64 [1] on the device; pkey: int64 [np]; psel: bool
// [np]; vec: pkey 16-byte, psel 2-byte and cnt 16-byte aligned.
extern "C" int ob_k10_ranges(const void* skeys, long long nb,
                             const void* nlive, const void* pkey,
                             const void* psel, long long np, void* cnt,
                             int vec, void* stream) {
  K10Args a = {};
  a.skeys = (const long long*)skeys;
  a.nlive = (const long long*)nlive;
  a.pkey = (const long long*)pkey;
  a.psel = (const unsigned char*)psel;
  a.np = np;
  a.nb = nb;
  a.cnt = (long long*)cnt;
  a.vec = vec;
  if (!k10_check(a) || !cnt) return (int)cudaErrorInvalidValue;
  return (int)k10_launch_ranges<false>(a, (cudaStream_t)stream);
}

// The whole expansion, two launches (one where cap is 0). order: int32
// [nb]; run_end: int64 [np], run_row, run_lo: int32 [np] (scratch: the
// non-empty runs); scratch: ob_k10_scratch_bytes(np), the ticket (0
// between calls), two words of this call, then a 48-byte status a tile
// carrying an earlier epoch than this call's (0 at first); total: int64
// [1]; starts, offs: int64 [np]; out_pr, out_br: int32 [cap]; out_valid:
// bool [cap], all 16-byte aligned; vec as for ob_k10_ranges; fill_blocks:
// the fill's grid (blocks that stay, a few an SM).
extern "C" int ob_k10_expand(const void* skeys, const void* order,
                             long long nb, const void* nlive,
                             const void* pkey, const void* psel, long long np,
                             long long cap, void* run_end, void* run_row,
                             void* run_lo, void* scratch, long long epoch,
                             void* total, void* starts, void* offs,
                             void* out_pr, void* out_br, void* out_valid,
                             int vec, int fill_blocks, void* stream) {
  K10Args a = {};
  a.skeys = (const long long*)skeys;
  a.order = (const int*)order;
  a.nlive = (const long long*)nlive;
  a.pkey = (const long long*)pkey;
  a.psel = (const unsigned char*)psel;
  a.np = np;
  a.nb = nb;
  a.cap = cap;
  a.epoch = epoch;
  a.starts = (long long*)starts;
  a.offs = (long long*)offs;
  a.total = (long long*)total;
  a.run_end = (long long*)run_end;
  a.run_row = (int*)run_row;
  a.run_lo = (int*)run_lo;
  a.misc = (long long*)scratch;
  a.tiles = (K10Tile*)((char*)scratch + 32);
  a.out_pr = (int*)out_pr;
  a.out_br = (int*)out_br;
  a.out_valid = (unsigned char*)out_valid;
  a.vec = vec;
  if (!k10_check(a) || cap < 0 || epoch < 1 || !order || !run_end ||
      !run_row || !run_lo || !scratch || !total || !starts || !offs ||
      fill_blocks < 1 ||
      (cap > 0 && (!out_pr || !out_br || !out_valid))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = k10_launch_ranges<true>(a, s);
  if (e != cudaSuccess || cap == 0) return (int)e;
  const long long tiles = (cap + K10_FILL - 1) / K10_FILL;
  const unsigned blocks =
      (unsigned)(tiles < fill_blocks ? tiles : (long long)fill_blocks);
  k10_fill<<<blocks, K10_THREADS, 0, s>>>(a);
  return (int)k10_counted(cudaGetLastError());
}

extern "C" long long ob_k10_kernel_launches() { return k10_launched.load(); }

// The scratch bytes of an expansion of np probe rows.
extern "C" long long ob_k10_scratch_bytes(long long np) {
  return 32 + (long long)sizeof(K10Tile) * ((np + K10_TILE - 1) / K10_TILE);
}
