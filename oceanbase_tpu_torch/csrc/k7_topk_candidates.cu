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
// Bound on an H100 (3.35 TB/s): one read of the key and the sel mask, plus
// the C indices written -- memory bound. A radix select reads them once
// per digit pass.
//
// Design: all on the device, with no host read.
//  1. Radix select of the kth value: masked is mapped to an unsigned image
//     (sign bit flipped, so image order is value order) and narrowed from
//     the top, 8 bits a pass: a histogram of the next digit among rows
//     whose higher digits equal the prefix so far (warp-aggregated shared
//     atomics, then one global add per bin), then one thread walks the
//     bins from 255 down to the bin holding the kth largest.
//  2. A per-tile count of the rows above kth and equal to kth (plus the
//     live tie count, with exact integer atomics), one scan over the tiles,
//     and a stable write: every row above kth, and the rows equal to kth
//     with the lowest indices until C are taken.
//  3. The C candidates are ordered by counting, for each, the candidates
//     that precede it under (value desc, index asc): the rank is unique, so
//     every candidate lands in its own slot.
#include "ob_common.cuh"

#define K7_THREADS 256
#define K7_ITEMS 16
#define K7_TILE (K7_THREADS * K7_ITEMS)

struct K7State {
  unsigned long long prefix;    // image bits fixed so far
  unsigned long long himask;    // which image bits are fixed
  long long need;               // rank of kth among rows matching prefix
  long long cnt;                // live rows with masked >= kth
  long long ngt;                // rows with masked > kth
};

__device__ __forceinline__ unsigned long long k7_image(
    const void* key, int dt, const unsigned char* sel, int desc, long long i) {
  long long x;
  if (!sel[i]) {
    x = (long long)(1ULL << 63);  // INT64_MIN
  } else {
    x = ob_ldg_i64(key, dt, i);
    if (!desc) x = ~x;
  }
  return (unsigned long long)x ^ (1ULL << 63);
}

__global__ void k7_init(K7State* st, long long c, unsigned long long* hist) {
  st->prefix = 0ULL;
  st->himask = 0ULL;
  st->need = c;
  st->cnt = 0;
  st->ngt = 0;
  for (int d = 0; d < 256; d++) hist[d] = 0ULL;
}

__global__ void k7_hist(const void* __restrict__ key, int dt,
                        const unsigned char* __restrict__ sel, int desc,
                        long long n, int shift, const K7State* __restrict__ st,
                        unsigned long long* __restrict__ hist) {
  __shared__ unsigned h[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) h[t] = 0u;
  __syncthreads();
  unsigned long long prefix = st->prefix, himask = st->himask;
  int lane = threadIdx.x & 31;
  long long step = (long long)gridDim.x * blockDim.x;
  // every thread of a warp runs the same number of iterations, so the
  // match below always sees the full warp
  long long base0 = (long long)blockIdx.x * blockDim.x;
  for (long long b = base0; b < n; b += step) {
    long long i = b + threadIdx.x;
    int d = 256;
    if (i < n) {
      unsigned long long u = k7_image(key, dt, sel, desc, i);
      if ((u & himask) == prefix) d = (int)((u >> shift) & 255ULL);
    }
    unsigned peers = __match_any_sync(OB_FULL_MASK, d);
    if (d < 256 && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    if (h[t]) atomicAdd(&hist[t], (unsigned long long)h[t]);
  }
}

// One thread: fix the next digit of kth and clear the histogram.
__global__ void k7_pick(unsigned long long* hist, K7State* st, int shift) {
  long long need = st->need, above = 0;
  int d = 255;
  for (; d > 0; d--) {
    long long c = (long long)hist[d];
    if (above + c >= need) break;
    above += c;
  }
  st->need = need - above;
  st->prefix |= (unsigned long long)d << shift;
  st->himask |= 255ULL << shift;
  for (int t = 0; t < 256; t++) hist[t] = 0ULL;
}

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

// Per tile: rows above kth and equal to kth; live rows at or above kth
// into st->cnt.
__global__ void k7_tile_count(const void* __restrict__ key, int dt,
                              const unsigned char* __restrict__ sel, int desc,
                              long long n, K7State* st,
                              unsigned* __restrict__ tile_gt,
                              unsigned* __restrict__ tile_eq) {
  __shared__ long long red[K7_THREADS / 32];
  unsigned long long kth = st->prefix;
  long long start = (long long)blockIdx.x * K7_TILE;
  long long gt = 0, eq = 0, live = 0;
  for (int it = 0; it < K7_ITEMS; it++) {
    long long i = start + (long long)it * K7_THREADS + threadIdx.x;
    if (i < n) {
      unsigned long long u = k7_image(key, dt, sel, desc, i);
      gt += u > kth;
      eq += u == kth;
      live += (u >= kth) && sel[i];
    }
  }
  long long tg = k7_block_sum(gt, red);
  long long te = k7_block_sum(eq, red);
  long long tl = k7_block_sum(live, red);
  if (threadIdx.x == 0) {
    tile_gt[blockIdx.x] = (unsigned)tg;
    tile_eq[blockIdx.x] = (unsigned)te;
    if (tl) atomicAdd((unsigned long long*)&st->cnt, (unsigned long long)tl);
    if (tg) atomicAdd((unsigned long long*)&st->ngt, (unsigned long long)tg);
  }
}

// One block: exclusive scans of tile_gt and tile_eq, in place.
__global__ void k7_scan_tiles(unsigned* tile_gt, unsigned* tile_eq,
                              int ntiles) {
  __shared__ unsigned sg[K7_THREADS], se[K7_THREADS];
  __shared__ unsigned cg, ce;
  int tid = threadIdx.x;
  if (tid == 0) cg = ce = 0u;
  __syncthreads();
  for (int base = 0; base < ntiles; base += K7_THREADS) {
    int t = base + tid;
    unsigned g = t < ntiles ? tile_gt[t] : 0u;
    unsigned e = t < ntiles ? tile_eq[t] : 0u;
    sg[tid] = g;
    se[tid] = e;
    __syncthreads();
    for (int off = 1; off < K7_THREADS; off <<= 1) {
      unsigned xg = tid >= off ? sg[tid - off] : 0u;
      unsigned xe = tid >= off ? se[tid - off] : 0u;
      __syncthreads();
      sg[tid] += xg;
      se[tid] += xe;
      __syncthreads();
    }
    if (t < ntiles) {
      tile_gt[t] = cg + sg[tid] - g;
      tile_eq[t] = ce + se[tid] - e;
    }
    __syncthreads();
    if (tid == K7_THREADS - 1) {
      cg += sg[tid];
      ce += se[tid];
    }
    __syncthreads();
  }
}

// Stable write of the candidates: rows above kth at [0, ngt), the first
// (c - ngt) rows equal to kth at [ngt, c).
__global__ void k7_tile_write(const void* __restrict__ key, int dt,
                              const unsigned char* __restrict__ sel, int desc,
                              long long n, long long c,
                              const K7State* __restrict__ st,
                              const unsigned* __restrict__ tile_gt,
                              const unsigned* __restrict__ tile_eq,
                              int* __restrict__ cand) {
  __shared__ unsigned wg[K7_THREADS / 32], we[K7_THREADS / 32];
  __shared__ unsigned rg, re;
  unsigned long long kth = st->prefix;
  long long ngt = st->ngt;
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned lt = (1u << lane) - 1u;
  if (threadIdx.x == 0) rg = re = 0u;
  long long start = (long long)blockIdx.x * K7_TILE;
  long long bg = tile_gt[blockIdx.x], be = tile_eq[blockIdx.x];
  for (int it = 0; it < K7_ITEMS; it++) {
    long long i = start + (long long)it * K7_THREADS + threadIdx.x;
    bool g = false, e = false;
    if (i < n) {
      unsigned long long u = k7_image(key, dt, sel, desc, i);
      g = u > kth;
      e = u == kth;
    }
    unsigned mg = __ballot_sync(OB_FULL_MASK, g);
    unsigned me = __ballot_sync(OB_FULL_MASK, e);
    __syncthreads();  // the previous item's running counts are final
    if (lane == 0) {
      wg[w] = __popc(mg);
      we[w] = __popc(me);
    }
    __syncthreads();
    unsigned og = rg, oe = re;
    for (int k = 0; k < w; k++) {
      og += wg[k];
      oe += we[k];
    }
    if (g) cand[bg + og + __popc(mg & lt)] = (int)i;
    if (e) {
      long long q = be + oe + __popc(me & lt);
      if (ngt + q < c) cand[ngt + q] = (int)i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < (int)(blockDim.x >> 5); k++) {
        rg += wg[k];
        re += we[k];
      }
    }
  }
}

// Order the c candidates by (value desc, index asc): rank by counting.
__global__ void k7_rank(const void* __restrict__ key, int dt,
                        const unsigned char* __restrict__ sel, int desc,
                        const int* __restrict__ cand, long long c,
                        int* __restrict__ out) {
  __shared__ unsigned long long su[K7_THREADS];
  __shared__ int si[K7_THREADS];
  long long me = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long u = 0ULL;
  int idx = 0;
  if (me < c) {
    idx = cand[me];
    u = k7_image(key, dt, sel, desc, idx);
  }
  long long rank = 0;
  for (long long base = 0; base < c; base += K7_THREADS) {
    long long j = base + threadIdx.x;
    __syncthreads();
    if (j < c) {
      si[threadIdx.x] = cand[j];
      su[threadIdx.x] = k7_image(key, dt, sel, desc, cand[j]);
    }
    __syncthreads();
    long long m = c - base < K7_THREADS ? c - base : K7_THREADS;
    for (int k = 0; k < m; k++) {
      rank += su[k] > u || (su[k] == u && si[k] < idx);
    }
  }
  if (me < c) out[rank] = idx;
}

// key: integer column (dtype code dt), sel: bool, n rows; c candidates
// (1 <= c <= n). out: int32 [c] in lax.top_k order; state: one K7State
// (its cnt is the tie count); hist: 256 uint64; tile_gt/tile_eq: ntiles
// uint32 each, ntiles = ceil(n / K7_TILE); cand: int32 [c] scratch.
extern "C" int ob_k7_topk(const void* key, int dt, const void* sel, int desc,
                          long long n, long long c, void* out, void* state,
                          void* hist, void* tile_gt, void* tile_eq,
                          int ntiles, void* cand, int nblocks, void* stream) {
  if (c < 1 || c > n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned char* m = (const unsigned char*)sel;
  K7State* st = (K7State*)state;
  unsigned long long* h = (unsigned long long*)hist;
  k7_init<<<1, 1, 0, s>>>(st, c, h);
  for (int shift = 56; shift >= 0; shift -= 8) {
    k7_hist<<<nblocks, K7_THREADS, 0, s>>>(key, dt, m, desc, n, shift, st, h);
    k7_pick<<<1, 1, 0, s>>>(h, st, shift);
  }
  k7_tile_count<<<ntiles, K7_THREADS, 0, s>>>(
      key, dt, m, desc, n, st, (unsigned*)tile_gt, (unsigned*)tile_eq);
  k7_scan_tiles<<<1, K7_THREADS, 0, s>>>((unsigned*)tile_gt,
                                         (unsigned*)tile_eq, ntiles);
  k7_tile_write<<<ntiles, K7_THREADS, 0, s>>>(
      key, dt, m, desc, n, c, st, (const unsigned*)tile_gt,
      (const unsigned*)tile_eq, (int*)cand);
  int rb = (int)((c + K7_THREADS - 1) / K7_THREADS);
  k7_rank<<<rb, K7_THREADS, 0, s>>>(key, dt, m, desc, (const int*)cand, c,
                                    (int*)out);
  return (int)cudaGetLastError();
}

extern "C" int ob_k7_tile_rows() { return K7_TILE; }
extern "C" int ob_k7_state_bytes() { return (int)sizeof(K7State); }
