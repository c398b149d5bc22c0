// K7: exact top-k candidates of a masked integer key, in lax.top_k order.
//
// Replaces oceanbase_tpu/engine/executor.py:2095 _topn_candidates, whose
// device work is lax.top_k over
//   masked = where(sel, flip, INT64_MIN),  flip = key (DESC) or ~key (ASC)
// and the tie count cnt = #live rows with masked >= kth (the C-th value).
// The C indices must come in lax.top_k's order: value descending, the
// lower row index first among equal values. torch.topk promises no tie
// order, so it cannot stand in.
//
// Bound on an H100 (3.35 TB/s): one read of the sel mask, the 32-byte
// sectors of the live rows' keys, and the C indices written -- memory
// bound. A dead row's value is INT64_MIN whatever its key, so its key is
// never read.
//
// Design: every pass reads sel as 16-byte vectors, a lane 16 rows, and
// visits only the live rows: a warp queues them in shared memory and its
// lanes load their keys together. The value's image u = v ^ 2^63 orders
// as v does; its 13-bit code (k7_bin: sign, the top bit's position, the
// next 6 bits) is order-preserving too, and a bin spans 1/64 of its
// values' magnitude, so small int64 values spread as well as wide ones.
// Four kernels a call:
//  k7_init   zeroes the state and the first histogram.
//  k7_pass1  the codes' histogram (shared atomics; the dead rows are
//            counted, not visited); the block that finishes last (a ticket
//            after a __threadfence) picks the kth bin b* (the bin holding
//            the c-th largest value; dead rows in the lowest bin) and the
//            path: the survivor path when b* and the bins above hold at
//            most K7_SORT_MAX rows and c is at most K7_FAST_C, else the
//            exact path from the bits b* fixes.
//  k7_pass2  the survivor path: the rows above b* and in b* become
//            entries (value, row | live << 31) by warp-aggregated atomics.
//  k7_finish cooperative, one block an SM. The survivor path: block 0
//            selects the c best entries in shared memory (a radix select
//            of the kth image over the bits the entries do not share, then
//            of the tie rows' indices), sorts those c (bitonic) and writes
//            them and cnt. The exact path: the radix select of kth over the
//            grid, 11 bits a round with grid barriers; a pass that gathers
//            the rows above kth (fewer than c) and the live ties (kept up
//            to K7_SORT_MAX); the ties to take, the lowest rows: block 0
//            selects them among the kept ones, or (a dead kth, or more
//            ties) the grid walks the tiles in row order, a tile a block a
//            wave, until enough are placed (ties crowd the front); block 0
//            sorts the c candidates (past K7_FAST_C the grid ranks them by
//            counting).
// The survivor path reads sel twice; the exact path three times, once
// more a remaining digit, and its tie waves read the tiles they need. No
// host read chooses the path; the state's `path` records it (0 survivors,
// 1 overflow, 2 full).
#include <stddef.h>

#include "ob_common.cuh"

#define K7_THREADS 256
#define K7_FIN_THREADS 1024
#define K7_TILE 4096  // rows of a tile of the exact path's tie waves
#define K7_BINS 8192
#define K7_DEAD_BIN 384  // the bin of INT64_MIN (k7_bin)
#define K7_SORT_MAX 8192
#define K7_FAST_C 4096
#define K7_SEL_BITS 8  // digit bits of k7_select's rounds
#define K7_EXACT_BITS 11  // digit bits of the exact path's rounds
#define K7_EXACT_BINS (1 << K7_EXACT_BITS)
#define K7_WARP_ROWS 512  // rows a warp of k7_rows reads a step
#define K7_MAX_GRID 1024  // k7_finish's blocks at most (two tie counts each)
#define K7_SIGN (1ULL << 63)

struct K7State {
  unsigned int ticket;   // finished blocks of k7_pass1
  unsigned int exact;    // 1: the exact path
  long long nlive;       // live rows
  long long bin;         // b*
  long long above;       // rows above b* (entries [0, above))
  long long total;       // entries to select from
  long long dense;       // k7_pass2 must visit dead rows too (b* is theirs)
  long long na;          // entries written above b*
  long long ns;          // entries written from b*
  unsigned long long prefix;  // exact path: the bits of kth known
  long long free_bits;   // exact path: the bits of u below the known ones
  long long need;        // exact path: kth's rank among rows with the prefix
  long long cnt;         // live rows with masked >= kth (the result)
  long long ngt;         // exact path: rows with image > kth
  long long path;        // 0 survivors, 1 overflow, 2 full
  unsigned int bar[2];   // k7_finish's grid barrier: arrivals, generation
};

// The order-preserving code of an int64 value: 8192 bins, INT64_MIN in
// K7_DEAD_BIN, every other value above it. x = v or ~v (>= 0); below 64 the
// code is x, else (e - 5) << 6 | the 6 bits after the top one (e its
// position), at most 3711.
__device__ __forceinline__ int k7_bin(long long v) {
  unsigned long long x = v >= 0 ? (unsigned long long)v
                                : ~(unsigned long long)v;
  int code;
  if (x < 64ull) {
    code = (int)x;
  } else {
    int e = 63 - __clzll((long long)x);
    code = ((e - 5) << 6) | (int)((x >> (e - 6)) & 63ull);
  }
  return v >= 0 ? 4096 + code : 4095 - code;
}

// The lowest bit that every image of bin b fixes (0: the bin is one
// value), and one image of the bin (its bits at and above that are the
// bin's).
__device__ __forceinline__ int k7_bin_low(int b, unsigned long long* rep) {
  int code = b >= 4096 ? b - 4096 : 4095 - b;
  unsigned long long x;
  int low;
  if (code < 64) {
    x = (unsigned long long)code;
    low = 0;
  } else {
    int e = (code >> 6) + 5;
    low = e - 6;
    x = (1ULL << e) | ((unsigned long long)(code & 63) << low);
  }
  unsigned long long v = b >= 4096 ? x : ~x;
  *rep = v ^ K7_SIGN;
  return low;
}

__device__ __forceinline__ long long k7_value(const void* key, int dt,
                                              int desc, long long i) {
  long long x = ob_ldg_i64(key, dt, i);
  return desc ? x : ~x;
}

// One chunk of a warp: 32 sel vectors from vector cb (lane l's in x, rows
// head + 16 (cb + l) ...), its rows to visit queued in q, then visited by
// the lanes in turn (k7_rows).
template <bool DENSE, typename F>
__device__ __forceinline__ void k7_chunk(const void* __restrict__ key, int dt,
                                         int desc, long long n, long long head,
                                         long long nvec, long long cb, uint4 x,
                                         unsigned short* q, F f) {
  const int lane = threadIdx.x & 31;
  const long long v = cb + lane;
  const long long base = head + 16 * v;  // this lane's first row
  unsigned int live = 0u, rows = 0u;     // bit k: row base + k
  if (v < nvec) {
    const unsigned int w4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int w = 0; w < 4; w++) {
      unsigned int b = w4[w];
      // bit 8j + 7 set when byte j is not zero
      unsigned int nz = (((b & 0x7f7f7f7fu) + 0x7f7f7f7fu) | b) & 0x80808080u;
      live |= (((nz >> 7) & 1u) | ((nz >> 14) & 2u) | ((nz >> 21) & 4u) |
               ((nz >> 28) & 8u)) << (4 * w);
    }
    rows = base + 16 > n ? (1u << (n - base)) - 1u : 0xffffu;
    live &= rows;
  }
  const unsigned int take = DENSE ? rows : live;
  if (!__any_sync(OB_FULL_MASK, take != 0u)) return;
  const int mine = __popc(take);
  int off = mine;  // inclusive scan of the lanes' counts
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(OB_FULL_MASK, off, o);
    if (lane >= o) off += y;
  }
  const int total = __shfl_sync(OB_FULL_MASK, off, 31);
  off -= mine;
  for (unsigned int t = take; t; t &= t - 1u) {
    const int k = __ffs(t) - 1;
    q[off++] = (unsigned short)((lane * 16 + k) | (((live >> k) & 1u) << 15));
  }
  __syncwarp();
  const long long row0 = head + 16 * cb;
  for (int j = lane; j < total; j += 32) {
    const unsigned int e = q[j];
    const long long i = row0 + (e & 0x7fffu);
    const bool on = (e >> 15) != 0u;
    f(i, on, on ? k7_value(key, dt, desc, i) : (long long)K7_SIGN);
  }
  __syncwarp();
}

// f(row, live, value) for the live rows of [0, n) (DENSE: every row; a
// dead row's value is INT64_MIN), a warp at a time: each step a warp reads
// 512 rows of sel (a 16-byte vector a lane, from sel's first 16-byte
// boundary), queues the rows it must visit in its part of `queue`
// (K7_WARP_ROWS entries), then its lanes take the queued rows in turn, so
// up to 32 key loads of a warp are in flight together. Thread 0 of block
// 0 visits the rows before the boundary. The last vector may hold bytes
// past n (inside its aligned 16 bytes, so inside the allocation); they are
// skipped.
template <bool DENSE, typename F>
__device__ __forceinline__ void k7_rows(const void* __restrict__ key, int dt,
                                        int desc,
                                        const unsigned char* __restrict__ sel,
                                        long long n, unsigned short* queue,
                                        F f) {
  const int lane = threadIdx.x & 31;
  unsigned short* q = queue + (threadIdx.x >> 5) * K7_WARP_ROWS;
  long long head = (long long)((16 - ((size_t)sel & 15)) & 15);
  if (head > n) head = n;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (long long i = 0; i < head; i++) {
      bool on = sel[i] != 0;
      if (DENSE || on)
        f(i, on, on ? k7_value(key, dt, desc, i) : (long long)K7_SIGN);
    }
  }
  const uint4* vsel = (const uint4*)(sel + head);
  const long long nvec = (n - head + 15) >> 4;
  const long long gw = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nw = ((long long)gridDim.x * blockDim.x) >> 5;
  // two chunks of 32 vectors a step: both loads in flight before either's
  // rows are visited
  for (long long cb = gw * 64; cb < nvec; cb += nw * 64) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 x0 = cb + lane < nvec ? __ldg(vsel + cb + lane) : zero;
    const uint4 x1 = cb + 32 + lane < nvec ? __ldg(vsel + cb + 32 + lane)
                                           : zero;
    k7_chunk<DENSE>(key, dt, desc, n, head, nvec, cb, x0, q, f);
    k7_chunk<DENSE>(key, dt, desc, n, head, nvec, cb + 32, x1, q, f);
  }
}

__device__ __forceinline__ long long k7_gthread() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long k7_nthreads() {
  return (long long)gridDim.x * blockDim.x;
}

// Sum of one int64 a thread over the block (every thread calls it).
__device__ __forceinline__ long long k7_block_sum(long long x, long long* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(OB_FULL_MASK, x, o);
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  long long t = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); k++) t += red[k];
  return t;
}

// The bin holding rank `c` from the top of a histogram of `nb` bins
// (global, read through L2), one thread of the block a slice of bins:
// returns (on every thread) the bin, and *above the rows in higher bins.
// extra is added to bin `xbin` (the dead rows).
__device__ long long k7_pick_bin(const unsigned int* hist, int nb, long long c,
                                 int xbin, long long extra, long long* above,
                                 long long* sh) {
  // one thread 32 bins from the top (nb == 32 * blockDim.x), loaded at once
  const int hi = nb - 1 - threadIdx.x * 32;
  long long x[32];
  long long s = 0;
#pragma unroll
  for (int k = 0; k < 32; k++) {
    x[k] = __ldcg(hist + hi - k) + (hi - k == xbin ? extra : 0);
    s += x[k];
  }
  // exclusive prefix of the slices from the top
  long long total;
  long long a = ob_block_exscan(s, &total);
  if (threadIdx.x == 0) sh[0] = -1;
  __syncthreads();
  if (a < c && a + s >= c) {
#pragma unroll
    for (int k = 0; k < 32; k++) {
      if (a < c && a + x[k] >= c) {
        sh[0] = hi - k;
        sh[1] = a;
        sh[2] = x[k];
      }
      a += x[k];
    }
  }
  __syncthreads();
  *above = sh[1];
  long long r = sh[0];
  __syncthreads();
  return r;
}

// The exact path's starting point: the bits of kth known, the rank to
// find among the rows that have them.
__device__ __forceinline__ void k7_set_exact(K7State* st, unsigned long long
                                             prefix, int free_bits,
                                             long long need, long long path) {
  st->exact = 1u;
  st->prefix = prefix;
  st->free_bits = free_bits;
  st->need = need;
  st->path = path;
}

__global__ void k7_init(K7State* st, unsigned int* hist) {
  for (int i = threadIdx.x; i < (int)(sizeof(K7State) / 4); i += blockDim.x)
    ((unsigned int*)st)[i] = 0u;
  for (int i = threadIdx.x; i < K7_BINS; i += blockDim.x) hist[i] = 0u;
}

__global__ void __launch_bounds__(K7_THREADS)
k7_pass1(const void* __restrict__ key, int dt,
         const unsigned char* __restrict__ sel, int desc, long long n,
         long long c, K7State* st, unsigned int* __restrict__ hist,
         unsigned long long* hist3) {
  __shared__ unsigned int h[K7_BINS];
  __shared__ unsigned short kq[K7_THREADS / 32 * K7_WARP_ROWS];
  __shared__ long long red[32];
  __shared__ long long sh[4];
  __shared__ bool last;
  for (int t = threadIdx.x; t < K7_BINS; t += blockDim.x) h[t] = 0u;
  // the exact path's histograms, zeroed here for it
  for (long long t = k7_gthread(); t < 3 * K7_EXACT_BINS; t += k7_nthreads())
    hist3[t] = 0ull;
  __syncthreads();
  long long live = 0;
  k7_rows<false>(key, dt, desc, sel, n, kq,
                 [&](long long, bool, long long v) {
    live++;
    atomicAdd(&h[k7_bin(v)], 1u);
  });
  long long bl = k7_block_sum(live, red);
  for (int t = threadIdx.x; t < K7_BINS; t += blockDim.x) {
    if (h[t]) atomicAdd(&hist[t], h[t]);
  }
  __syncthreads();  // every bin of this block is out before the ticket
  if (threadIdx.x == 0) {
    if (bl) atomicAdd((unsigned long long*)&st->nlive, (unsigned long long)bl);
    __threadfence();
    last = atomicAdd(&st->ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long nlive =
      (long long)__ldcg((const unsigned long long*)&st->nlive);
  long long above;
  int b = (int)k7_pick_bin(hist, K7_BINS, c, K7_DEAD_BIN, n - nlive, &above,
                           sh);
  if (threadIdx.x != 0) return;
  const long long m = sh[2];
  unsigned long long rep;
  const int low = k7_bin_low(b, &rep);
  st->bin = b;
  st->above = above;
  st->total = above + m;
  st->dense = b == K7_DEAD_BIN;
  if (c > K7_FAST_C || above + m > K7_SORT_MAX) {
    // the exact path from b*'s bits; a kth bin of dead rows alone puts kth
    // at their image, 0
    const long long path = c > K7_FAST_C ? 2 : 1;
    if (b == K7_DEAD_BIN && !__ldcg(hist + b)) {
      k7_set_exact(st, 0ull, 0, c - above, path);
    } else {
      k7_set_exact(st, low ? rep & (~0ULL << low) : rep, low, c - above,
                   path);
    }
  }
}

// The next slot of a counter for each calling lane: one atomic for the
// lanes that call together (warp-aggregated).
__device__ __forceinline__ long long k7_slot(long long* counter) {
  const unsigned m = __activemask();
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  unsigned long long base = 0ull;
  if (lane == leader)
    base = atomicAdd((unsigned long long*)counter,
                     (unsigned long long)__popc(m));
  base = __shfl_sync(m, base, leader);
  return (long long)base + __popc(m & ((1u << lane) - 1u));
}

// An entry: the value and the row with its live bit.
__device__ __forceinline__ void k7_put(long long* ev, unsigned int* er,
                                       long long p, long long v,
                                       long long i, bool on) {
  ev[p] = v;
  er[p] = (unsigned int)i | (on ? 0x80000000u : 0u);
}

__global__ void __launch_bounds__(K7_THREADS)
k7_pass2(const void* __restrict__ key, int dt,
         const unsigned char* __restrict__ sel, int desc, long long n,
         K7State* st, long long* __restrict__ ev,
         unsigned int* __restrict__ er) {
  __shared__ unsigned short kq[K7_THREADS / 32 * K7_WARP_ROWS];
  if (st->exact) return;
  const int bstar = (int)st->bin;
  const long long above = st->above;
  auto put = [&](long long i, bool on, long long v) {
    int b = on ? k7_bin(v) : K7_DEAD_BIN;
    if (b > bstar) {
      k7_put(ev, er, k7_slot(&st->na), v, i, on);
    } else if (b == bstar) {
      k7_put(ev, er, above + k7_slot(&st->ns), v, i, on);
    }
  };
  if (st->dense) {
    k7_rows<true>(key, dt, desc, sel, n, kq, put);
  } else {
    k7_rows<false>(key, dt, desc, sel, n, kq, put);
  }
}

// ---- k7_finish ------------------------------------------------------------

// Every block of the cooperative grid waits here until all have arrived.
__device__ __forceinline__ void k7_grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long k7_image(
    const void* key, int dt, const unsigned char* sel, int desc, long long i) {
  if (!sel[i]) return 0ull;  // INT64_MIN's image
  return (unsigned long long)k7_value(key, dt, desc, i) ^ K7_SIGN;
}

// Warp 0 picks the digit holding rank `need` in a shared histogram of
// 2^w bins (w <= 11), from the top (desc) or from the bottom; out[0] the
// digit, out[1] the rank inside it, out[2] its rows. The block syncs
// after.
__device__ __forceinline__ void k7_pick_digit(const unsigned int* h, int w,
                                              long long need, bool desc,
                                              long long* out) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int nb = 1 << w;
    const int per = (nb + 31) / 32;
    long long s = 0;
    for (int k = 0; k < per; k++) {
      int j = lane * per + k;
      if (j < nb) s += h[desc ? nb - 1 - j : j];
    }
    long long x = s;
    for (int o = 1; o < 32; o <<= 1) {
      long long y = __shfl_up_sync(OB_FULL_MASK, x, o);
      if (lane >= o) x += y;
    }
    long long before = x - s;
    if (before < need && x >= need) {
      long long a = before;
      for (int k = 0; k < per; k++) {
        int j = lane * per + k;
        int d = desc ? nb - 1 - j : j;
        long long y = h[d];
        if (a + y >= need) {
          out[0] = d;
          out[1] = need - a;
          out[2] = y;
          break;
        }
        a += y;
      }
    }
  }
  __syncthreads();
}

// a precedes b: the larger image, then the lower row
__device__ __forceinline__ bool k7_before(unsigned long long ua,
                                          unsigned int ra,
                                          unsigned long long ub,
                                          unsigned int rb) {
  return ua > ub || (ua == ub && (ra & 0x7fffffffu) < (rb & 0x7fffffffu));
}

__device__ void k7_sort_out(unsigned long long* cu, unsigned int* cr,
                            long long c, int* out);

// One block: the need-th lowest of the candidate rows row(i), lo <= i <
// hi (rows unique and below 2^31; row(i) >= 2^31: not a candidate), by a
// radix select, 8 bits a round from the top. h: 256 shared bins.
template <typename R>
__device__ unsigned int k7_lowest(int lo, int hi, long long need, R row,
                                  unsigned int* h, long long* pick) {
  unsigned int prefix = 0u, mask = 0u;
  for (int fr = 31; fr > 0;) {
    const int w = fr < 8 ? fr : 8, s = fr - w;
    const unsigned int dm = (1u << w) - 1u;
    for (int t = threadIdx.x; t < (1 << w); t += blockDim.x) h[t] = 0u;
    __syncthreads();
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const unsigned int r = row(i);
      if (r < 0x80000000u && (r & mask) == prefix)
        atomicAdd(&h[(r >> s) & dm], 1u);
    }
    __syncthreads();
    k7_pick_digit(h, w, need, false, pick);
    prefix |= (unsigned int)pick[0] << s;
    mask |= dm << s;
    need = pick[1];
    fr = s;
    __syncthreads();
  }
  return prefix;
}

// Block 0 of the survivor path: the c best of `total` entries (entries
// [0, A) all among them), in order, to out; cnt to the state.
__device__ void k7_select(K7State* st, const long long* ev,
                          const unsigned int* er, long long c, int* out,
                          unsigned char* smem) {
  unsigned long long* su = (unsigned long long*)smem;
  unsigned int* sr = (unsigned int*)(su + K7_SORT_MAX);
  unsigned long long* cu = (unsigned long long*)(sr + K7_SORT_MAX);
  unsigned int* cr = (unsigned int*)(cu + K7_FAST_C);
  __shared__ unsigned int h[1 << K7_SEL_BITS];
  __shared__ long long pick[3];
  __shared__ unsigned long long red_or[32], red_and[32];
  __shared__ unsigned int ncand;
  __shared__ unsigned long long ncnt;
  const int total = (int)st->total;
  const int A = (int)st->above;
  const int tid = threadIdx.x, nt = blockDim.x;
  unsigned long long vor = 0ull, vand = ~0ull;
  for (int i = tid; i < total; i += nt) {
    su[i] = (unsigned long long)__ldcg(ev + i) ^ K7_SIGN;
    sr[i] = __ldcg(er + i);
    if (i >= A) {
      vor |= su[i];
      vand &= su[i];
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    vor |= __shfl_xor_sync(OB_FULL_MASK, vor, o);
    vand &= __shfl_xor_sync(OB_FULL_MASK, vand, o);
  }
  if ((tid & 31) == 0) {
    red_or[tid >> 5] = vor;
    red_and[tid >> 5] = vand;
  }
  if (tid == 0) {
    ncand = 0u;
    ncnt = 0ull;
  }
  __syncthreads();
  vor = 0ull;
  vand = ~0ull;
  for (int k = 0; k < nt / 32; k++) {
    vor |= red_or[k];
    vand &= red_and[k];
  }
  // the kth image among the entries [A, total): bits where they all agree
  // are known; a round a digit of the rest
  long long need = c - A;
  long long eq = total - A;  // entries with the prefix so far
  int fb = (vor ^ vand) ? 64 - __clzll((long long)(vor ^ vand)) : 0;
  unsigned long long prefix = fb >= 64 ? 0ull : (vand & (~0ull << fb));
  unsigned long long himask = fb >= 64 ? 0ull : (~0ull << fb);
  while (fb > 0) {
    const int w = fb < K7_SEL_BITS ? fb : K7_SEL_BITS, s = fb - w;
    const unsigned long long dm = (1ull << w) - 1;
    for (int t = tid; t < (1 << w); t += nt) h[t] = 0u;
    __syncthreads();
    for (int i = A + tid; i < total; i += nt) {
      if ((su[i] & himask) == prefix) atomicAdd(&h[(su[i] >> s) & dm], 1u);
    }
    __syncthreads();
    k7_pick_digit(h, w, need, true, pick);
    prefix |= (unsigned long long)pick[0] << s;
    himask |= dm << s;
    need = pick[1];
    eq = pick[2];
    fb = s;
    __syncthreads();
  }
  const unsigned long long kth = prefix;
  // the `need` lowest rows among the entries equal to kth (every one of
  // them when need is all)
  const unsigned int rprefix =
      need < eq ? k7_lowest(A, total, need, [&](int i) {
        return su[i] == kth ? sr[i] & 0x7fffffffu : 0xffffffffu;
      }, h, pick)
                : 0x7fffffffu;
  const unsigned int rlast = rprefix;  // the last tie row taken
  unsigned long long live_ge = 0;
  for (int i = tid; i < total; i += nt) {
    const unsigned long long u = su[i];
    const unsigned int r = sr[i] & 0x7fffffffu;
    if ((sr[i] >> 31) && u >= kth) live_ge++;
    if (i < A || u > kth || (u == kth && r <= rlast)) {
      unsigned int p = atomicAdd(&ncand, 1u);
      cu[p] = u;
      cr[p] = sr[i];
    }
  }
  if (live_ge) atomicAdd(&ncnt, live_ge);
  __syncthreads();
  if (tid == 0) st->cnt = (long long)ncnt;
  k7_sort_out(cu, cr, c, out);
}

// One block: the c entries (image, row) in cu, cr sorted by (image desc,
// row asc), bitonic over the next power of two (pads last), their rows to
// out. cu, cr hold K7_FAST_C entries.
__device__ void k7_sort_out(unsigned long long* cu, unsigned int* cr,
                            long long c, int* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int p2 = 1;
  while (p2 < c) p2 <<= 1;
  for (int i = (int)c + tid; i < p2; i += nt) {  // pads sort last
    cu[i] = 0ull;
    cr[i] = 0x7fffffffu;
  }
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += nt) {
        int l = i ^ j;
        if (l > i) {
          unsigned long long ui = cu[i], ul = cu[l];
          unsigned int ri = cr[i], rl = cr[l];
          bool up = (i & k) == 0;
          if (up ? k7_before(ul, rl, ui, ri) : k7_before(ui, ri, ul, rl)) {
            cu[i] = ul;
            cu[l] = ui;
            cr[i] = rl;
            cr[l] = ri;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < c; i += nt) out[i] = (int)(cr[i] & 0x7fffffffu);
}

// The exact path's ties in row order, a wave of one tile a block at a
// time, until `want` are placed after the ngt rows above kth: each block
// counts its tile's ties (a buffer by the wave's parity), then places them
// after the earlier tiles'. The grid calls it together.
__device__ void k7_tie_waves(const void* key, int dt, const unsigned char* sel,
                             int desc, long long n, long long c, K7State* st,
                             unsigned long long kth, long long ngt,
                             long long want, unsigned int* tile_eq,
                             int ntiles, int* cand, long long* red) {
  const int items = K7_TILE / blockDim.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  __shared__ unsigned wq[32];
  __shared__ unsigned long long s_before, s_wave;
  long long taken = 0;
  for (int wave = 0; (long long)wave * gridDim.x < ntiles && taken < want;
       wave++) {
    const long long t = (long long)wave * gridDim.x + blockIdx.x;
    unsigned int* cnts = tile_eq + (wave & 1) * gridDim.x;
    long long e = 0;
    if (t < ntiles) {
      for (int it = 0; it < items; it++) {
        long long i = t * K7_TILE + (long long)it * blockDim.x + threadIdx.x;
        if (i < n) e += k7_image(key, dt, sel, desc, i) == kth;
      }
    }
    e = k7_block_sum(e, red);
    if (threadIdx.x == 0) cnts[blockIdx.x] = (unsigned int)e;
    k7_grid_sync(st->bar);
    if (threadIdx.x < 32) {  // warp 0: the earlier tiles' ties, the wave's
      unsigned long long b = 0, all = 0;
      for (int k = lane; k < (int)gridDim.x; k += 32) {
        unsigned long long x = __ldcg(cnts + k);
        if (k < (int)blockIdx.x) b += x;
        all += x;
      }
      for (int o = 16; o > 0; o >>= 1) {
        b += __shfl_xor_sync(OB_FULL_MASK, b, o);
        all += __shfl_xor_sync(OB_FULL_MASK, all, o);
      }
      if (lane == 0) {
        s_before = b;
        s_wave = all;
      }
    }
    __syncthreads();
    long long at = ngt + taken + (long long)s_before;  // this tile's first
    if (t < ntiles && at < c) {
      for (int it = 0; it < items; it++) {
        long long i = t * K7_TILE + (long long)it * blockDim.x + threadIdx.x;
        bool q = i < n && k7_image(key, dt, sel, desc, i) == kth;
        unsigned m = __ballot_sync(OB_FULL_MASK, q);
        if (lane == 0) wq[w] = __popc(m);
        __syncthreads();
        long long o = at;
        for (int k = 0; k < w; k++) o += wq[k];
        o += __popc(m & lt);
        if (q && o < c) cand[o] = (int)i;
        __syncthreads();
        for (int k = 0; k < (int)(blockDim.x >> 5); k++) at += wq[k];
        __syncthreads();
      }
    }
    taken += (long long)s_wave;
    __syncthreads();
  }
}

// The grid's exact path: the digits of kth below the known bits, the rows
// above kth, the ties in row order, the candidates' order (see the head of
// the file).
__device__ void k7_exact(const void* key, int dt, const unsigned char* sel,
                         int desc, long long n, long long c, K7State* st,
                         unsigned long long* hist3, unsigned int* tile_eq,
                         int ntiles, int* cand, unsigned int* er, int* out,
                         unsigned short* kq) {
  __shared__ unsigned int h[K7_EXACT_BINS];
  __shared__ long long red[32];
  __shared__ long long pick[3];
  unsigned long long prefix = st->prefix;
  int fb = (int)st->free_bits;
  unsigned long long himask = fb >= 64 ? 0ull : (~0ull << fb);
  long long need = st->need;
  const long long dead = n - st->nlive;
  for (int round = 0; fb > 0; round++) {
    const int w = fb < K7_EXACT_BITS ? fb : K7_EXACT_BITS, s = fb - w;
    const unsigned long long dm = (1ull << w) - 1;
    unsigned long long* hc = hist3 + (round % 3) * K7_EXACT_BINS;
    for (int t = threadIdx.x; t < (1 << w); t += blockDim.x) h[t] = 0u;
    __syncthreads();
    k7_rows<false>(key, dt, desc, sel, n, kq,
                   [&](long long, bool, long long v) {
      unsigned long long u = (unsigned long long)v ^ K7_SIGN;
      if ((u & himask) == prefix) atomicAdd(&h[(u >> s) & dm], 1u);
    });
    __syncthreads();
    for (int t = threadIdx.x; t < (1 << w); t += blockDim.x) {
      if (h[t]) atomicAdd(&hc[t], (unsigned long long)h[t]);
    }
    k7_grid_sync(st->bar);
    if (blockIdx.x == 0) {  // free: last read before this round's barrier
      unsigned long long* hz = hist3 + ((round + 2) % 3) * K7_EXACT_BINS;
      for (int t = threadIdx.x; t < K7_EXACT_BINS; t += blockDim.x)
        hz[t] = 0ull;
    }
    // every block the same digit; the dead rows (u = 0) in digit 0 while
    // the prefix is 0
    for (int t = threadIdx.x; t < (1 << w); t += blockDim.x)
      h[t] = (unsigned int)__ldcg(hc + t) +
             (t == 0 && prefix == 0 ? (unsigned int)dead : 0u);
    __syncthreads();
    k7_pick_digit(h, w, need, true, pick);
    prefix |= (unsigned long long)pick[0] << s;
    himask |= dm << s;
    need = pick[1];
    fb = s;
    __syncthreads();
  }
  const unsigned long long kth = prefix;
  // the rows above kth (live, and fewer than c) to cand[0, ngt) in any
  // order; the live rows equal to kth counted, the first K7_SORT_MAX of
  // them kept (their rows in er)
  long long eq_live = 0;
  bool keep = true;  // this thread's ties still find room
  k7_rows<false>(key, dt, desc, sel, n, kq, [&](long long i, bool,
                                                long long v) {
    const unsigned long long u = (unsigned long long)v ^ K7_SIGN;
    if (u > kth) {
      cand[k7_slot(&st->ngt)] = (int)i;
    } else if (u == kth) {
      eq_live++;
      if (keep) {
        const long long p = k7_slot(&st->ns);
        keep = p < K7_SORT_MAX;
        if (keep) er[p] = (unsigned int)i;
      }
    }
  });
  eq_live = k7_block_sum(eq_live, red);
  if (threadIdx.x == 0 && eq_live)
    atomicAdd((unsigned long long*)&st->cnt, (unsigned long long)eq_live);
  k7_grid_sync(st->bar);
  const long long ngt = (long long)__ldcg((const unsigned long long*)&st->ngt);
  const long long want = c - ngt;  // ties to take, the lowest rows first
  const long long ties =
      (long long)__ldcg((const unsigned long long*)&st->cnt);
  if (kth != 0ull && ties <= K7_SORT_MAX) {
    // a live kth with few ties: block 0 takes the `want` lowest kept rows
    if (blockIdx.x == 0) {
      __shared__ unsigned int nput;
      unsigned int* tr = (unsigned int*)((unsigned char*)kq + K7_SORT_MAX * 8);
      for (int i = threadIdx.x; i < ties; i += blockDim.x)
        tr[i] = __ldcg(er + i);
      if (threadIdx.x == 0) nput = 0u;
      __syncthreads();
      const unsigned int rl = want < ties
          ? k7_lowest(0, (int)ties, want, [&](int i) { return tr[i]; }, h,
                      pick)
          : 0x7fffffffu;
      for (int i = threadIdx.x; i < ties; i += blockDim.x) {
        if (tr[i] <= rl) cand[ngt + atomicAdd(&nput, 1u)] = (int)tr[i];
      }
    }
  } else {
    k7_tie_waves(key, dt, sel, desc, n, c, st, kth, ngt, want, tile_eq,
                 ntiles, cand, red);
  }
  k7_grid_sync(st->bar);
  // every block has read the live ties' count: cnt takes the rows above
  if (blockIdx.x == 0 && threadIdx.x == 0) st->cnt += ngt;
  if (c <= K7_FAST_C) {  // block 0 orders the c candidates
    if (blockIdx.x != 0) return;
    unsigned long long* cu =
        (unsigned long long*)((unsigned char*)kq + K7_SORT_MAX * 12);
    unsigned int* cr = (unsigned int*)(cu + K7_FAST_C);
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      const int r = __ldcg(cand + i);
      cu[i] = k7_image(key, dt, sel, desc, r);
      cr[i] = (unsigned int)r;
    }
    k7_sort_out(cu, cr, c, out);
    return;
  }
  // past K7_FAST_C: the grid ranks the candidates by counting
  {
    __shared__ unsigned long long sk[K7_FIN_THREADS];
    __shared__ int si[K7_FIN_THREADS];
    const int nt = blockDim.x;
    for (long long mb = (long long)blockIdx.x * nt; mb < c;
         mb += (long long)gridDim.x * nt) {
      long long me = mb + threadIdx.x;
      unsigned long long u = 0ULL;
      int idx = 0;
      if (me < c) {
        idx = __ldcg(cand + me);
        u = k7_image(key, dt, sel, desc, idx);
      }
      long long rank = 0;
      for (long long base = 0; base < c; base += nt) {
        long long j = base + threadIdx.x;
        __syncthreads();
        if (j < c) {
          int cj = __ldcg(cand + j);
          si[threadIdx.x] = cj;
          sk[threadIdx.x] = k7_image(key, dt, sel, desc, cj);
        }
        __syncthreads();
        long long m = c - base < nt ? c - base : nt;
        for (int k = 0; k < m; k++) {
          rank += sk[k] > u || (sk[k] == u && si[k] < idx);
        }
      }
      if (me < c) out[rank] = idx;
    }
  }
}

__global__ void __launch_bounds__(K7_FIN_THREADS, 1)
k7_finish(const void* __restrict__ key, int dt,
          const unsigned char* __restrict__ sel, int desc, long long n,
          long long c, K7State* st, unsigned long long* hist3,
          unsigned int* tile_eq, int ntiles, int* cand,
          long long* ev, unsigned int* er, int* __restrict__ out) {
  extern __shared__ unsigned char k7_sm[];
  // the row walker's queues alias the selection's arrays (used before it)
  unsigned short* kq = (unsigned short*)k7_sm;
  if (st->exact) {
    k7_exact(key, dt, sel, desc, n, c, st, hist3, tile_eq, ntiles, cand, er,
             out, kq);
    return;
  }
  if (blockIdx.x != 0) return;
  k7_select(st, ev, er, c, out, k7_sm);
}

#define K7_FIN_SMEM (K7_SORT_MAX * 12 + K7_FAST_C * 12)

// The passes' grid: as many blocks as fit on the card at once (at most
// `cap`), and no more than the rows need (a warp's step takes 1024 rows).
static int k7_pass_grid(long long n, int cap) {
  static int fit[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!fit[dev]) {
    int sms = 0, p1 = 0, p2 = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p1, k7_pass1,
                                                      K7_THREADS, 0) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p2, k7_pass2,
                                                      K7_THREADS, 0) !=
            cudaSuccess) {
      return 0;
    }
    fit[dev] = sms * (p1 < p2 ? p1 : p2);
  }
  long long need = (n + 1024 * (K7_THREADS / 32) - 1) /
                   (1024 * (K7_THREADS / 32));
  long long g = fit[dev] < cap ? fit[dev] : cap;
  return (int)(need < g ? (need > 0 ? need : 1) : g);
}

static int k7_finish_grid() {
  static int cap[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!cap[dev]) {
    int sms = 0, per = 0;
    if (cudaFuncSetAttribute(k7_finish,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K7_FIN_SMEM) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, k7_finish, K7_FIN_THREADS, K7_FIN_SMEM) != cudaSuccess ||
        per < 1) {
      return 0;
    }
    cap[dev] = sms * per < K7_MAX_GRID ? sms * per : K7_MAX_GRID;
  }
  return cap[dev];
}

// Byte offsets of the scratch's parts.
#define K7_OFF_HIST 256
#define K7_OFF_HIST3 (K7_OFF_HIST + K7_BINS * 4)
#define K7_OFF_EV (K7_OFF_HIST3 + 3 * K7_EXACT_BINS * 8)
#define K7_OFF_ER (K7_OFF_EV + K7_SORT_MAX * 8)
#define K7_OFF_TILES (K7_OFF_ER + K7_SORT_MAX * 4)
#define K7_OFF_CAND (K7_OFF_TILES + 2 * K7_MAX_GRID * 4)

static long long k7_ntiles(long long n) { return (n + K7_TILE - 1) / K7_TILE; }

extern "C" long long ob_k7_scratch_bytes(long long c) {
  return (K7_OFF_CAND + 4 * c + 255) / 256 * 256;
}

// key: integer column (dtype code dt), sel: bool, n rows; c candidates
// (1 <= c <= n). out: int32 [c] in lax.top_k order; scratch:
// ob_k7_scratch_bytes(c) bytes (the K7State at its start: the tie count
// at K7State::cnt, the path at K7State::path). nblocks: the most blocks
// the passes' grid may take.
extern "C" int ob_k7_topk(const void* key, int dt, const void* sel, int desc,
                          long long n, long long c, void* out, void* scratch,
                          int nblocks, void* stream) {
  if (c < 1 || c > n || n >= (1ll << 31) || nblocks < 1 || dt == OB_F32 ||
      dt == OB_F64) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  char* base = (char*)scratch;
  K7State* st = (K7State*)base;
  unsigned int* hist = (unsigned int*)(base + K7_OFF_HIST);
  unsigned long long* hist3 = (unsigned long long*)(base + K7_OFF_HIST3);
  long long* ev = (long long*)(base + K7_OFF_EV);
  unsigned int* er = (unsigned int*)(base + K7_OFF_ER);
  int ntiles = (int)k7_ntiles(n);
  unsigned int* te = (unsigned int*)(base + K7_OFF_TILES);
  int* cand = (int*)(base + K7_OFF_CAND);
  const unsigned char* m = (const unsigned char*)sel;
  int grid = k7_finish_grid();
  int pgrid = k7_pass_grid(n, nblocks);
  if (grid < 1 || pgrid < 1) return (int)cudaErrorInvalidConfiguration;
  k7_init<<<1, K7_THREADS, 0, s>>>(st, hist);
  k7_pass1<<<pgrid, K7_THREADS, 0, s>>>(key, dt, m, desc, n, c, st, hist,
                                        hist3);
  if (c <= K7_FAST_C) {
    k7_pass2<<<pgrid, K7_THREADS, 0, s>>>(key, dt, m, desc, n, st, ev, er);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&key, (void*)&dt, (void*)&m, (void*)&desc,
                  (void*)&n, (void*)&c, (void*)&st, (void*)&hist3,
                  (void*)&te, (void*)&ntiles, (void*)&cand,
                  (void*)&ev, (void*)&er, (void*)&out};
  e = cudaLaunchCooperativeKernel((const void*)k7_finish, dim3(grid),
                                  dim3(K7_FIN_THREADS), args, K7_FIN_SMEM, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int ob_k7_fast_c() { return K7_FAST_C; }

// The int64 word of the scratch that holds the tie count (0) or the path
// (1).
extern "C" int ob_k7_word(int which) {
  return (int)((which ? offsetof(K7State, path) : offsetof(K7State, cnt)) /
               8);
}
