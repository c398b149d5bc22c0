// K18: decode one wire-encoded streamed chunk on the device.
//
// Replaces oceanbase_tpu/engine/pipeline.py:187 _decode_staged. The
// streaming pipeline ships each chunk of the streamed table in the wire
// plan the host froze per column (pipeline.py ChunkStager): `for` deltas
// narrowed to uint8/16/32 with a base, `rle` run values (narrowed) with
// int32 run lengths padded to a frozen run capacity, `bits` validity
// bitmaps packed little-endian, or `raw` storage-width values with a zero
// base. This kernel expands all of them to full-width columns, plus the
// live-row mask sel = r < count, exactly as the reference does:
//   raw/for: out = (storage) staged + base, in the storage type;
//   rle:     ends = inclusive int64 prefix sum of the lengths, and row r
//            takes vals[clip(searchsorted(ends, r, right), 0, run_cap-1)]
//            + base -- so rows past the live total read the last (padded)
//            run value, as the reference's clip defines them;
//   bits:    (packed[r >> 3] >> (r & 7)) & 1.
//
// Bound on an H100 (3.35 TB/s): the wire bytes read once plus the decoded
// columns and sel written once -- memory bound.
//
// Design: one launch per chunk for up to 32 planes (the wrapper launches
// again for the next 32, and only the first writes sel). The first `row_blocks`
// blocks take 4096-row tiles of the raw/for/bits columns and sel. Each
// rle column gets one block per 2048-run tile; a block takes its tile by
// an atomic ticket (so every earlier tile's block is already running),
// scans its run lengths in shared memory, publishes its sum and finds its
// exclusive prefix by decoupled look-back over the earlier tiles' status
// words, then writes the rows its runs cover, each thread a row (coalesced
// writes, a binary search in the tile's shared ends). The last tile also
// fills the rows past the live total. No global barrier, no second pass.
#include "ob_common.cuh"

#define K18_THREADS 256
#define K18_ROW_TILE 4096
#define K18_ITEMS 8
#define K18_RUN_TILE (K18_THREADS * K18_ITEMS)
#define K18_MAX_COLS 32

// wire-plan kinds and the two narrow types beyond ob_common.cuh's codes
#define K18_RAW 0
#define K18_RLE 1
#define K18_BITS 2
#define K18_U16 8
#define K18_U32 9

#define K18_FLAG_AGG (1ull << 62)
#define K18_FLAG_PRE (2ull << 62)
#define K18_VALUE ((1ull << 62) - 1)

struct K18Col {
  int kind;
  int src_dt;   // staged values (raw/for), run values (rle), uint8 (bits)
  int dst_dt;   // the storage type (bool for bits)
  int tile0;    // rle: first run-tile block, counted after the row blocks
  int ntiles;   // rle: run tiles
  const void* src;
  const int* lens;           // rle: run lengths [run_cap]
  void* dst;                 // [cap]
  long long base;            // integer base, or the bits of a double base
  long long run_cap;
  unsigned long long* state; // rle: [ntiles] status words + 1 ticket
};

struct K18Args {
  K18Col c[K18_MAX_COLS];
  int ncols;
  int row_blocks;
  long long cap;
  long long count;
  unsigned char* sel;
};

// Element i of a staged array, as an integer (unsigned narrow types
// zero-extend, as astype from uint does).
__device__ __forceinline__ long long k18_ld(const void* p, int dt,
                                            long long i) {
  switch (dt) {
    case K18_U16: return (long long)((const unsigned short*)p)[i];
    case K18_U32: return (long long)((const unsigned int*)p)[i];
    default: return ob_ldg_i64(p, dt, i);
  }
}

// Store an integer result in the storage type (truncating, i.e. the
// storage-width wraparound of astype + base).
__device__ __forceinline__ void k18_st(void* p, int dt, long long r,
                                       long long v) {
  switch (dt) {
    case OB_BOOL: ((unsigned char*)p)[r] = v != 0 ? 1 : 0; break;
    case OB_I8: ((signed char*)p)[r] = (signed char)v; break;
    case OB_U8: ((unsigned char*)p)[r] = (unsigned char)v; break;
    case OB_I16: ((short*)p)[r] = (short)v; break;
    case OB_I32: ((int*)p)[r] = (int)v; break;
    default: ((long long*)p)[r] = v; break;
  }
}

// x + base modulo 2^64 (the storage-width wrap follows in k18_st)
__device__ __forceinline__ long long k18_add(long long x, long long base) {
  return (long long)((unsigned long long)x + (unsigned long long)base);
}

// One row of a raw/for/bits column.
__device__ __forceinline__ void k18_row(const K18Col& c, long long r) {
  if (c.kind == K18_BITS) {
    unsigned char b = ((const unsigned char*)c.src)[r >> 3];
    ((unsigned char*)c.dst)[r] = (b >> (r & 7)) & 1;
    return;
  }
  if (c.dst_dt == OB_F64) {
    // raw floats: staged + 0.0 in IEEE double (-0.0 + 0.0 is +0.0)
    ((double*)c.dst)[r] =
        ((const double*)c.src)[r] + __longlong_as_double(c.base);
    return;
  }
  if (c.dst_dt == OB_F32) {
    ((float*)c.dst)[r] = ((const float*)c.src)[r] +
                         (float)__longlong_as_double(c.base);
    return;
  }
  if (c.dst_dt == OB_BOOL) {
    // bool + bool is a logical or
    ((unsigned char*)c.dst)[r] =
        (k18_ld(c.src, c.src_dt, r) != 0 || c.base != 0) ? 1 : 0;
    return;
  }
  k18_st(c.dst, c.dst_dt, r, k18_add(k18_ld(c.src, c.src_dt, r), c.base));
}

__device__ __forceinline__ unsigned long long k18_load_state(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ void k18_rle_tile(const K18Col& c, long long cap) {
  __shared__ long long s_ends[K18_RUN_TILE];
  __shared__ long long s_warp[K18_THREADS / 32];
  __shared__ int s_tile;
  __shared__ long long s_excl;
  int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* status = c.state;
  unsigned long long* ticket = c.state + c.ntiles;
  if (t == 0) s_tile = (int)atomicAdd(ticket, 1ull);
  __syncthreads();
  int tile = s_tile;
  long long run0 = (long long)tile * K18_RUN_TILE;
  long long nrun = c.run_cap - run0;
  if (nrun > K18_RUN_TILE) nrun = K18_RUN_TILE;

  // tile-local inclusive ends: each thread scans its 8 runs, then the
  // block scans the thread totals (warp shuffles, then the 8 warp sums)
  long long local[K18_ITEMS];
  long long tsum = 0;
  for (int i = 0; i < K18_ITEMS; i++) {
    long long j = (long long)t * K18_ITEMS + i;
    tsum += j < nrun ? (long long)c.lens[run0 + j] : 0;
    local[i] = tsum;
  }
  long long incl = tsum;
  for (int o = 1; o < 32; o <<= 1) {
    long long up = __shfl_up_sync(OB_FULL_MASK, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (t == 0) {
    long long acc = 0;
    for (int w = 0; w < K18_THREADS / 32; w++) {
      long long x = s_warp[w];
      s_warp[w] = acc;
      acc += x;
    }
    // acc is the tile's sum of run lengths
    long long excl = 0;
    if (tile == 0) {
      atomicExch(&status[0], K18_FLAG_PRE | (unsigned long long)acc);
    } else {
      atomicExch(&status[tile], K18_FLAG_AGG | (unsigned long long)acc);
      for (int j = tile - 1; j >= 0; j--) {
        unsigned long long w;
        do {
          w = k18_load_state(&status[j]);
        } while ((w & ~K18_VALUE) == 0);
        excl += (long long)(w & K18_VALUE);
        if ((w & ~K18_VALUE) == K18_FLAG_PRE) break;
      }
      atomicExch(&status[tile],
                 K18_FLAG_PRE | (unsigned long long)(excl + acc));
    }
    s_excl = excl;
  }
  __syncthreads();
  long long texcl = s_warp[warp] + incl - tsum;
  for (int i = 0; i < K18_ITEMS; i++) {
    s_ends[t * K18_ITEMS + i] = texcl + local[i];
  }
  __syncthreads();
  long long excl = s_excl;
  long long total_tile = nrun > 0 ? s_ends[nrun - 1] : 0;
  long long row_end = excl + total_tile;
  if (row_end > cap) row_end = cap;
  for (long long r = excl + t; r < row_end; r += K18_THREADS) {
    long long rel = r - excl;
    int lo = 0, hi = (int)nrun;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (s_ends[mid] <= rel) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    k18_st(c.dst, c.dst_dt, r, k18_add(k18_ld(c.src, c.src_dt, run0 + lo),
                                       c.base));
  }
  if (tile == c.ntiles - 1) {
    // rows past the live total read the last run value (the clip)
    long long v = k18_add(k18_ld(c.src, c.src_dt, c.run_cap - 1), c.base);
    long long from = excl + total_tile;
    for (long long r = from + t; r < cap; r += K18_THREADS) {
      k18_st(c.dst, c.dst_dt, r, v);
    }
  }
}

__global__ void k18_decode(K18Args a) {
  int b = blockIdx.x;
  if (b < a.row_blocks) {
    long long r0 = (long long)b * K18_ROW_TILE;
    long long r1 = r0 + K18_ROW_TILE;
    if (r1 > a.cap) r1 = a.cap;
    for (int ci = 0; ci < a.ncols; ci++) {
      const K18Col& c = a.c[ci];
      if (c.kind == K18_RLE) continue;
      for (long long r = r0 + threadIdx.x; r < r1; r += K18_THREADS) {
        k18_row(c, r);
      }
    }
    if (a.sel != nullptr) {
      for (long long r = r0 + threadIdx.x; r < r1; r += K18_THREADS) {
        a.sel[r] = r < a.count ? 1 : 0;
      }
    }
    return;
  }
  int rb = b - a.row_blocks;
  for (int ci = 0; ci < a.ncols; ci++) {
    const K18Col& c = a.c[ci];
    if (c.kind == K18_RLE && rb >= c.tile0 && rb < c.tile0 + c.ntiles) {
      k18_rle_tile(c, a.cap);
      return;
    }
  }
}

// Per column (ncols of them): kind, src_dt, dst_dt, src, lens, dst, base
// bits, run_cap and state (rle: ntiles + 1 zeroed uint64 words). cap: the
// chunk capacity; count: its live rows; sel: bool [cap], or null when an
// earlier launch over the chunk's other planes wrote it (the wrapper
// launches once per K18_MAX_COLS planes).
extern "C" int ob_k18_decode(int ncols, const int* kind, const int* src_dt,
                             const int* dst_dt, const void* const* src,
                             const void* const* lens, void* const* dst,
                             const long long* base, const long long* run_cap,
                             void* const* state, long long cap,
                             long long count, void* sel, void* stream) {
  if (ncols < 0 || ncols > K18_MAX_COLS || cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  K18Args a;
  memset(&a, 0, sizeof(a));
  int tiles = 0;
  for (int i = 0; i < ncols; i++) {
    K18Col& c = a.c[i];
    c.kind = kind[i];
    c.src_dt = src_dt[i];
    c.dst_dt = dst_dt[i];
    c.src = src[i];
    c.lens = (const int*)lens[i];
    c.dst = dst[i];
    c.base = base[i];
    c.run_cap = run_cap[i];
    c.state = (unsigned long long*)state[i];
    if (c.kind == K18_RLE) {
      if (c.run_cap < 1) return (int)cudaErrorInvalidValue;
      c.tile0 = tiles;
      c.ntiles = (int)((c.run_cap + K18_RUN_TILE - 1) / K18_RUN_TILE);
      tiles += c.ntiles;
    }
  }
  a.ncols = ncols;
  a.cap = cap;
  a.count = count;
  a.sel = (unsigned char*)sel;
  a.row_blocks = (int)((cap + K18_ROW_TILE - 1) / K18_ROW_TILE);
  k18_decode<<<a.row_blocks + tiles, K18_THREADS, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

// the run-tile size, so the wrapper sizes each rle column's state words
extern "C" int ob_k18_run_tile() { return K18_RUN_TILE; }
