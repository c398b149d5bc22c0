// K3: stable lexicographic sort order -- a one-sweep LSD radix sort over
// packed, order-preserving unsigned images of the keys.
//
// Replaces oceanbase_tpu/ops/sort.py:57 sort_indices (with split_sort_key
// :31 and rebuild_i64 :51), which lax.sort's (dead flag, key planes...,
// row index) operands, and the stable sort on ~sel in
// engine/executor.py:116 compact_batch. The order must equal lax.sort's
// exactly: dead rows last, ties by row index.
//
// Key images (64-bit unsigned, ascending image order == lax.sort order):
//   - signed integers: the value, negated in its own width for DESC (jnp's
//     -v, so the type's minimum maps to itself and sorts first under DESC,
//     as in the JAX package), sign-extended, sign bit flipped;
//   - bool: v, or !v for DESC; uint8: v, negated mod 256 for DESC;
//   - floats: negated for DESC, -0.0 folded onto +0.0 and every NaN onto
//     one image above +inf (lax.sort's total order treats them so), then
//     the sign-magnitude flip;
//   - the dead flag is the most significant key (bool, DESC on sel).
//
// Bound on an H100 (3.35 TB/s): a sort must at least read its k keys and
// write the int32 order once, N * (sum of key bytes + 1 + 4) bytes. For the
// S1 statement at SF 10 (60M rows; int64 + int64 + int8 keys plus the
// mask) that is about 1.3 GB, about 0.4 ms. The radix passes move far more:
// each 8-bit pass reads and writes the image (and the order beside it).
//
// Design: the wrapper (kernels.sort_order) plans, ob_k3_sort launches:
// - spans: one sweep a K3_MAX_PACK keys finds the min and max of each
//   key's image (the dead flag and other bool keys too), and the sweep
//   over the least significant keys which suffixes of them the rows
//   already follow (the tuple never decreases from a row to the next). The wrapper reads it all back at
//   once, drops constant keys and the longest such suffix (with the row
//   index after it, it orders rows as the row index alone: key columns a
//   table is stored in the order of), and packs the rest,
//   least significant first, into as few composites of at most 64 bits as
//   their spans allow ((image - min) << shift);
// - per composite, one pack launch gathers its keys through the current
//   order into its image and counts every 8-bit digit of every pass of the
//   composite at once (block histograms in shared memory, a warp whose
//   lanes share a digit adds once) into one global table of passes x 256
//   counters. The image is the one that moves the fewest bytes a pass:
//   with the order's row in its low bits where both fit (8 bytes a row a
//   pass in 32 bits, 16 in 64), else beside the order (16 or 24). A
//   composite of at most 8 bits (one pass; the dead flag alone in the root
//   compaction) writes no image: the pack only counts, and its pass reads
//   the keys themselves. The sweeps (spans, pack) hold K3_SWEEP_ROWS rows
//   a thread and dispatch once a key on its type, so that many loads are
//   in flight;
// - per digit pass, ONE launch (k3_onesweep): each block takes a tile by
//   ticket (an atomic counter, so a tile only ever waits on tiles that
//   started earlier), copies the tile's order into shared memory
//   (cp.async) while it holds K3_ITEMS keys a thread in registers and
//   ranks them through warp-private digit counters (8 ballots give each
//   key its peers; the lowest peer adds the group to the warp's counter
//   with one shared atomic), publishes its 256 digit counts ("aggregate"), scans
//   the warps' counts and the pass's global counts in one block scan,
//   stages the tile in shared memory in digit order, looks back over the
//   earlier tiles' published counts digit by digit (one thread a digit,
//   K3_LOOK tiles a step) until an "inclusive prefix", publishes its own,
//   and writes each digit's run out contiguously. Five block barriers a
//   tile;
// - a pass whose digit is one value for every row (one global count equals
//   N) moves nothing: its blocks return at once and the buffers stay where
//   they are. Which buffer holds the current image and order is kept on
//   the device (a state word per pass), so the host plans the launches
//   once, after the one read of the spans, and never waits again; the last
//   pass of the sort writes the caller's output.
// Stability of every pass gives the row-index tiebreak. For K15's image
// route (kernels.sort_order_images) the plan puts the row inside a 64-bit
// image where the 32-bit one beside the order would move as many bytes a
// pass, and the last pass writes the sorted images (img_out) instead of
// the order: the row is their low bits.
// Tried on the H100 (PERF.md): the look-back width, plain stores
// or atomics for the published counts, and tiles of 3072-6144 rows moved
// the passes by a few per cent; a look-back before the ranking (after a
// first count) cost more than it saved; one row a thread in the sweeps, a
// type dispatch a load, and an atomic a warp on the spans' one line of L2
// together slowed the span sweep severalfold.
#include <cuda_pipeline.h>

#include <atomic>

#include "ob_common.cuh"

#define K3_THREADS 256
#define K3_WARPS (K3_THREADS / 32)
// keys a thread ranks (a tile is K3_THREADS x K3_ITEMS rows) and blocks
// an SM holds, in every mode; at 3 blocks an SM the 64-bit modes spill
// 44-64 bytes a thread (ptxas, sm_90a) and the 32-bit ones none (on the
// H100, 4 blocks spilled more and ran the 64-bit row mode slower; 12 keys
// a thread ran slower, 20 at 2 blocks a few per cent faster in the 64-bit
// pair mode only, PERF.md)
#define K3_ITEMS 16
#define K3_MINB 3
#define K3_MAX_PACK 8
// a pass's mode: the image and the order beside it; the order's row in
// the image's low bits; the keys themselves (a one-pass composite)
#define K3_PAIR 0
#define K3_ROW 1
#define K3_KEYS 2
#define K3_MAX_SPINS (1LL << 26)
// rows a thread of the span sweep and of the pack loads at once
#define K3_SWEEP_ROWS 2
// earlier tiles' counts a look-back step reads at once
#define K3_LOOK 4
// a published count: bits 32-33 the kind, bits 34-63 the pass (g + 1),
// bits 0-31 the count (at most 2^31 - 1 rows)
#define K3_AGGREGATE 1ULL
#define K3_INCLUSIVE 2ULL

// The key's bits at row j, widened (the load alone, so that the loads of
// several keys can be in flight before any is used).
__device__ __forceinline__ unsigned long long k3_raw(const void* key, int dt,
                                                     long long j) {
  switch (dt) {
    case OB_BOOL:
    case OB_U8:
    case OB_I8:
      return ((const unsigned char*)key)[j];
    case OB_I16:
      return ((const unsigned short*)key)[j];
    case OB_I32:
    case OB_F32:
      return ((const unsigned int*)key)[j];
    default:
      return ((const unsigned long long*)key)[j];
  }
}

// The image of a key's bits (k3_raw) in its type and direction.
__device__ __forceinline__ unsigned long long k3_map(unsigned long long raw,
                                                     int dt, int desc) {
  const unsigned long long flip = 1ULL << 63;
  switch (dt) {
    case OB_BOOL: {
      unsigned long long b = raw ? 1ULL : 0ULL;
      return desc ? 1ULL - b : b;
    }
    case OB_U8: {
      unsigned char x = (unsigned char)raw;
      if (desc) x = (unsigned char)(0u - (unsigned)x);
      return (unsigned long long)x;
    }
    case OB_I8: {
      unsigned char u = (unsigned char)raw;
      if (desc) u = (unsigned char)(0u - (unsigned)u);
      long long x = (long long)(signed char)u;
      return (unsigned long long)x ^ flip;
    }
    case OB_I16: {
      unsigned short u = (unsigned short)raw;
      if (desc) u = (unsigned short)(0u - (unsigned)u);
      long long x = (long long)(short)u;
      return (unsigned long long)x ^ flip;
    }
    case OB_I32: {
      unsigned int u = (unsigned int)raw;
      if (desc) u = 0u - u;
      long long x = (long long)(int)u;
      return (unsigned long long)x ^ flip;
    }
    case OB_I64: {
      unsigned long long u = raw;
      if (desc) u = 0ULL - u;
      return u ^ flip;
    }
    case OB_F32: {
      unsigned int u = (unsigned int)raw;
      if (desc) u ^= 0x80000000u;
      if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffULL;  // NaN
      if ((u & 0x7fffffffu) == 0u) u = 0u;                         // -0.0
      u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
      return (unsigned long long)u;
    }
    default: {  // OB_F64
      unsigned long long u = raw;
      if (desc) u ^= flip;
      if ((u & ~flip) > 0x7ff0000000000000ULL) return ~0ULL;  // NaN
      if ((u & ~flip) == 0ULL) u = 0ULL;                       // -0.0
      u = (u & flip) ? ~u : (u | flip);
      return u;
    }
  }
}

__device__ __forceinline__ unsigned long long k3_image(const void* key, int dt,
                                                       int desc, long long j) {
  return k3_map(k3_raw(key, dt, j), dt, desc);
}

// F(DT) for the key type dt, DT a constant: one dispatch for a body that
// loads several rows of the key before it uses any
#define K3_ON_TYPE(dt, F) \
  switch (dt) {           \
    case OB_BOOL:         \
      F(OB_BOOL) break;   \
    case OB_I8:           \
      F(OB_I8) break;     \
    case OB_I16:          \
      F(OB_I16) break;    \
    case OB_I32:          \
      F(OB_I32) break;    \
    case OB_I64:          \
      F(OB_I64) break;    \
    case OB_F32:          \
      F(OB_F32) break;    \
    case OB_F64:          \
      F(OB_F64) break;    \
    default:              \
      F(OB_U8) break;     \
  }

// The block's max of (lo, hi) into mm[0], mm[1]: a warp reduction, then
// one atomic a block (all blocks' atomics land on one line of L2, so one a
// warp would queue there)
__device__ __forceinline__ void k3_block_max2(unsigned long long lo,
                                              unsigned long long hi,
                                              unsigned long long* mm) {
  __shared__ unsigned long long s_lo[K3_WARPS], s_hi[K3_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long l2 = __shfl_xor_sync(OB_FULL_MASK, lo, o);
    unsigned long long h2 = __shfl_xor_sync(OB_FULL_MASK, hi, o);
    lo = l2 > lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
  __syncthreads();  // the arrays may hold an earlier call's values
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < K3_WARPS; w++) {
      lo = s_lo[w] > lo ? s_lo[w] : lo;
      hi = s_hi[w] > hi ? s_hi[w] : hi;
    }
    atomicMax(&mm[0], lo);
    atomicMax(&mm[1], hi);
  }
}

// At most K3_MAX_PACK keys, in one sweep.
struct K3Span {
  const void* key[K3_MAX_PACK];
  int dt[K3_MAX_PACK];
  int desc[K3_MAX_PACK];
  int nkeys;
};

// The spans of p's NK keys, mm[2k] = max of ~image (the complement of the
// min) and mm[2k + 1] = max of the image over all n rows (both start at
// 0), and, when bad is not null (the least significant keys), which of
// their suffixes already run in row order: bit m of *bad is set when the
// tuple of p's keys m..NK - 1 decreases somewhere from a row to the next
// (images compared, so in sort order). Such a suffix, with the row
// index after it, orders rows as the row index alone does.
// NK is a template argument so that a thread holds registers for the keys
// there are, and the blocks an SM holds stay many.
template <int NK>
__global__ void __launch_bounds__(K3_THREADS)
    k3_span_group(K3Span p, long long n, unsigned long long* mm,
                  unsigned long long* bad) {
  unsigned long long lo[NK], hi[NK];
#pragma unroll
  for (int k = 0; k < NK; k++) lo[k] = hi[k] = 0ULL;
  unsigned badm = 0u;
  // K3_SWEEP_ROWS rows a thread at once (rows a block apart), so that
  // each dispatch on a key's type puts that many rows' loads in flight
  const long long stride = (long long)gridDim.x * K3_THREADS * K3_SWEEP_ROWS;
  for (long long base = (long long)blockIdx.x * K3_THREADS * K3_SWEEP_ROWS;
       base < n; base += stride) {
    long long i[K3_SWEEP_ROWS];
    bool v[K3_SWEEP_ROWS], pair[K3_SWEEP_ROWS];
    int s[K3_SWEEP_ROWS];  // row i against row i + 1 over the keys from k on
#pragma unroll
    for (int r = 0; r < K3_SWEEP_ROWS; r++) {
      i[r] = base + r * K3_THREADS + threadIdx.x;
      v[r] = i[r] < n;
      pair[r] = i[r] + 1 < n;
      s[r] = 0;
    }
#pragma unroll
    for (int k = NK - 1; k >= 0; k--) {
      // the images of rows i and i + 1 (the neighbour's load, from L1),
      // behind one dispatch on the key's type
      unsigned long long a[K3_SWEEP_ROWS], c[K3_SWEEP_ROWS];
#define K3_SPAN_ROWS_OF(DT)                                   \
  _Pragma("unroll") for (int r = 0; r < K3_SWEEP_ROWS; r++) { \
    a[r] = v[r] ? k3_raw(p.key[k], DT, i[r]) : 0ULL;          \
    c[r] = pair[r] ? k3_raw(p.key[k], DT, i[r] + 1) : 0ULL;   \
  }                                                           \
  _Pragma("unroll") for (int r = 0; r < K3_SWEEP_ROWS; r++) { \
    a[r] = k3_map(a[r], DT, p.desc[k]);                       \
    c[r] = k3_map(c[r], DT, p.desc[k]);                       \
  }
      K3_ON_TYPE(p.dt[k], K3_SPAN_ROWS_OF)
#undef K3_SPAN_ROWS_OF
#pragma unroll
      for (int r = 0; r < K3_SWEEP_ROWS; r++) {
        if (v[r]) {
          lo[k] = ~a[r] > lo[k] ? ~a[r] : lo[k];
          hi[k] = a[r] > hi[k] ? a[r] : hi[k];
        }
        if (a[r] != c[r]) s[r] = a[r] < c[r] ? -1 : 1;
        if (pair[r] && s[r] > 0) badm |= 1u << k;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NK; k++) k3_block_max2(lo[k], hi[k], mm + 2 * k);
  __shared__ unsigned s_bad;
  if (threadIdx.x == 0) s_bad = 0u;
  __syncthreads();
  if (badm) atomicOr(&s_bad, badm);
  __syncthreads();
  if (threadIdx.x == 0 && s_bad && bad) {
    atomicOr(bad, (unsigned long long)s_bad);
  }
}

// One composite: img = sum over keys of (image(key[j]) - min) << shift,
// the fields disjoint bit ranges.
struct K3Pack {
  const void* key[K3_MAX_PACK];
  unsigned long long min[K3_MAX_PACK];
  int dt[K3_MAX_PACK];
  int desc[K3_MAX_PACK];
  int shift[K3_MAX_PACK];
  int nkeys;
};

__device__ __forceinline__ unsigned long long k3_compose(const K3Pack& p,
                                                         long long j) {
  unsigned long long u = 0ULL;
  for (int k = 0; k < p.nkeys; k++) {
    u |= (k3_image(p.key[k], p.dt[k], p.desc[k], j) - p.min[k]) << p.shift[k];
  }
  return u;
}


// The buffers of one sort. state holds two ints a pass g: [2g] which image
// the pass reads (0: img[0], 1: img[1]), [2g + 1] which order (0: the
// identity, 1: perm[0], 2: perm[1]); the scratch is zeroed first, so the
// first pass reads the packed image and the identity.
struct K3Bufs {
  void* img[2];
  int* perm[2];
  int* out;
  int* state;
  void* img_out;  // K15's images: the last pass writes them, not the order
};

__device__ __forceinline__ const int* k3_order_in(const K3Bufs& b, int psel) {
  return psel == 0 ? nullptr : b.perm[psel - 1];
}

// The pack of one composite (the order it reads through from the state of
// its first pass g0) and the digit counts of its npass passes into
// hist[npass][256]; rbits > 0: the order's row rides the image's low bits.
// WRITE false: count only (a one-pass composite).
template <typename T, bool WRITE>
__global__ void __launch_bounds__(K3_THREADS)
    k3_pack_hist(K3Pack p, K3Bufs b, int g0, long long n, int npass,
                 int rbits, unsigned* __restrict__ hist) {
  __shared__ unsigned sh[8 * 256];
  const int t = threadIdx.x, lane = t & 31;
  for (int q = t; q < npass * 256; q += K3_THREADS) sh[q] = 0u;
  __syncthreads();
  const int* perm = k3_order_in(b, b.state[2 * g0 + 1]);
  T* img = (T*)b.img[0];
  // K3_SWEEP_ROWS rows a thread at once (rows a block apart), each key's
  // loads for all of them behind one dispatch on its type
  const long long stride = (long long)gridDim.x * K3_THREADS * K3_SWEEP_ROWS;
  for (long long base = (long long)blockIdx.x * K3_THREADS * K3_SWEEP_ROWS;
       base < n; base += stride) {
    long long j[K3_SWEEP_ROWS];
    bool v[K3_SWEEP_ROWS];
    unsigned long long u[K3_SWEEP_ROWS];
#pragma unroll
    for (int r = 0; r < K3_SWEEP_ROWS; r++) {
      const long long i = base + r * K3_THREADS + t;
      v[r] = i < n;
      j[r] = v[r] && perm ? (long long)__ldg(perm + i) : i;
      u[r] = 0ULL;
    }
    for (int k = 0; k < p.nkeys; k++) {
      unsigned long long x[K3_SWEEP_ROWS];
#define K3_PACK_ROWS_OF(DT)                                   \
  _Pragma("unroll") for (int r = 0; r < K3_SWEEP_ROWS; r++) { \
    x[r] = v[r] ? k3_raw(p.key[k], DT, j[r]) : 0ULL;          \
  }                                                           \
  _Pragma("unroll") for (int r = 0; r < K3_SWEEP_ROWS; r++) { \
    x[r] = k3_map(x[r], DT, p.desc[k]);                       \
  }
      K3_ON_TYPE(p.dt[k], K3_PACK_ROWS_OF)
#undef K3_PACK_ROWS_OF
#pragma unroll
      for (int r = 0; r < K3_SWEEP_ROWS; r++) {
        u[r] |= (x[r] - p.min[k]) << p.shift[k];
      }
    }
#pragma unroll
    for (int r = 0; r < K3_SWEEP_ROWS; r++) {
      const long long i = base + r * K3_THREADS + t;
      if (WRITE && v[r]) {
        img[i] = rbits ? (T)((u[r] << rbits) | (unsigned long long)j[r])
                       : (T)u[r];
      }
      unsigned vm = __ballot_sync(OB_FULL_MASK, v[r]);
      if (vm == 0u) continue;
      int first = __ffs(vm) - 1;
      for (int q = 0; q < npass; q++) {
        unsigned d = (unsigned)(u[r] >> (8 * q)) & 255u;
        unsigned d0 = __shfl_sync(OB_FULL_MASK, d, first);
        if (__all_sync(OB_FULL_MASK, !v[r] || d == d0)) {
          if (lane == first) {
            atomicAdd(&sh[q * 256 + d0], (unsigned)__popc(vm));
          }
        } else if (v[r]) {
          atomicAdd(&sh[q * 256 + d], 1u);
        }
      }
    }
  }
  __syncthreads();
  for (int q = t; q < npass * 256; q += K3_THREADS) {
    if (sh[q]) atomicAdd(&hist[q], sh[q]);
  }
}

// The lanes of the warp whose digit equals this lane's (8 ballots; lanes
// past the end of the rows are nobody's peers).
__device__ __forceinline__ unsigned k3_peers(unsigned d, bool valid) {
  unsigned m = __ballot_sync(OB_FULL_MASK, valid);
#pragma unroll
  for (int b = 0; b < 8; b++) {
    unsigned bit = (d >> b) & 1u;
    unsigned x = __ballot_sync(OB_FULL_MASK, bit);
    m &= bit ? x : ~x;
  }
  return m;
}

// a published count is one aligned 64-bit word: its kind, pass and count
// are read and written whole, so no fence orders anything around it
__device__ __forceinline__ unsigned long long k3_ld_volatile(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void k3_st_volatile(unsigned long long* p,
                                               unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

struct K3PassArgs {
  K3Pack p;                      // K3_KEYS: the composite's keys
  K3Bufs b;
  const unsigned* hist;          // [256] this pass's global digit counts
  unsigned long long* status;    // [ntiles * 256] published counts
  int* ticket;
  long long n;
  int g;                         // the pass's index in the sort
  int shift;                     // the digit's first bit in the image
  int rbits;                     // K3_ROW: the row's bits below the keys
  int last_comp;                 // last pass of its composite: no image out
  int final_pass;                // last pass of the sort: the order to out
};

// One stable 8-bit digit pass: (image, order) -> (image', order'). MODE
// K3_ROW: the order is the image's low rbits (written out as the order by
// the composite's last pass); K3_KEYS: the image is composed from the keys
// through the order (a one-pass composite). A block a tile of K3_THREADS *
// K3_ITEMS rows, taken by ticket.
template <typename T, int MODE>
__global__ void __launch_bounds__(K3_THREADS, K3_MINB)
    k3_onesweep(K3PassArgs a) {
  constexpr int ITEMS = K3_ITEMS, TILE = K3_THREADS * ITEMS;
  extern __shared__ __align__(16) unsigned char k3_smem[];
  T* sk = (T*)k3_smem;                            // [TILE] images
  int* sp = (int*)(sk + TILE);                    // [TILE] order values
  int* so = sp + TILE;                            // [TILE] order, row order
  // [K3_WARPS][256] counters
  unsigned* wh = MODE == K3_ROW ? (unsigned*)sp : (unsigned*)(so + TILE);
  __shared__ unsigned s_gofs[256];
  __shared__ unsigned s_ws[K3_WARPS], s_wc[K3_WARPS];
  __shared__ int s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(a.ticket, 1);
  for (int q = t; q < K3_WARPS * 256; q += K3_THREADS) wh[q] = 0u;
  const unsigned h = __ldg(a.hist + t);
  const int trivial = __syncthreads_or(h == (unsigned)a.n);
  const int tile = s_tile;
  const long long n = a.n;
  const long long tile_start = (long long)tile * TILE;
  const int len = (int)(n - tile_start < TILE ? n - tile_start : TILE);
  const int isel = a.b.state[2 * a.g];
  const int psel = a.b.state[2 * a.g + 1];
  const int* pin = k3_order_in(a.b, psel);
  const T* iin = MODE == K3_KEYS ? nullptr : (const T*)a.b.img[isel];
  // the passes that write an order: every pass that moves rows, in
  // K3_ROW only a composite's last. A composite's top digit is never
  // trivial (its span reaches its top bit), so the last pass of a
  // composite, and of the sort, always moves rows and writes the order
  const bool order_out = !trivial && (MODE != K3_ROW || a.last_comp);
  if (tile == 0 && t == 0) {
    int* next = a.b.state + 2 * (a.g + 1);
    next[0] = a.last_comp ? 0 : (trivial ? isel : 1 - isel);
    next[1] = order_out ? (psel == 1 ? 2 : 1) : psel;
  }
  // every row has one digit: the pass is the identity
  if (trivial) return;

  // the tile's order values copied into shared memory while the keys are
  // ranked (cp.async, 16 bytes a copy; their loads then cost the tile no
  // wait of its own)
  const bool fetch = MODE == K3_PAIR && pin != nullptr;
  if (fetch) {
    const int full = len & ~3;
    for (int q = 4 * t; q < full; q += 4 * K3_THREADS) {
      __pipeline_memcpy_async(so + q, pin + tile_start + q, 16);
    }
    __pipeline_commit();
    for (int q = full + t; q < len; q += K3_THREADS) {
      so[q] = __ldg(pin + tile_start + q);
    }
  }

  // the tile's keys: warp w owns rows [w * 32 * ITEMS, (w + 1) * 32 *
  // ITEMS) of the tile, item i of lane l is row 32 i + l of them, so the
  // (warp, item, lane) order is the row order
  const long long wbase = tile_start + (long long)warp * (32 * ITEMS);
  T u[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; it++) {
    long long r = wbase + it * 32 + lane;
    u[it] = 0;
    if (r < n) {
      if (MODE == K3_KEYS) {
        long long j = pin ? (long long)__ldg(pin + r) : r;
        u[it] = (T)k3_compose(a.p, j);
      } else {
        u[it] = __ldg(iin + r);
      }
    }
  }

  // rank each key among the warp's earlier keys of its digit
  unsigned* mine = wh + warp * 256;
  const unsigned lt = (1u << lane) - 1u;
  unsigned short rk[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; it++) {
    bool v = wbase + it * 32 + lane < n;
    unsigned d = (unsigned)(u[it] >> a.shift) & 255u;
    unsigned peers = k3_peers(d, v);
    int leader = __ffs(peers) - 1;
    unsigned base = 0u;
    if (v && lane == leader) base = atomicAdd(mine + d, (unsigned)__popc(peers));
    base = __shfl_sync(OB_FULL_MASK, base, v ? leader : lane);
    rk[it] = (unsigned short)(base + __popc(peers & lt));
  }
  if (fetch) __pipeline_wait_prior(0);
  __syncthreads();

  // thread t owns digit t: the warps' exclusive offsets, the tile's count,
  // published at once (the first tile's is already inclusive)
  unsigned cnt = 0u;
#pragma unroll
  for (int w = 0; w < K3_WARPS; w++) {
    unsigned c = wh[w * 256 + t];
    wh[w * 256 + t] = cnt;
    cnt += c;
  }
  unsigned long long* status = a.status + (long long)tile * 256 + t;
  const unsigned long long tag = (unsigned long long)(a.g + 1) << 34;
  k3_st_volatile(status,
                 tag | ((tile == 0 ? K3_INCLUSIVE : K3_AGGREGATE) << 32) | cnt);
  // one block scan of (the pass's global counts, the tile's counts)
  unsigned x = h, y = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    unsigned xx = __shfl_up_sync(OB_FULL_MASK, x, o);
    unsigned yy = __shfl_up_sync(OB_FULL_MASK, y, o);
    if (lane >= o) {
      x += xx;
      y += yy;
    }
  }
  if (lane == 31) {
    s_ws[warp] = x;
    s_wc[warp] = y;
  }
  __syncthreads();
  for (int w = 0; w < warp; w++) {
    x += s_ws[w];
    y += s_wc[w];
  }
  const unsigned gbase = x - h;    // rows of smaller digits in the pass
  const unsigned lbase = y - cnt;  // rows of smaller digits in the tile
#pragma unroll
  for (int w = 0; w < K3_WARPS; w++) wh[w * 256 + t] += lbase;
  __syncthreads();

  // stage the tile in digit order
#pragma unroll
  for (int it = 0; it < ITEMS; it++) {
    long long r = wbase + it * 32 + lane;
    if (r < n) {
      unsigned d = (unsigned)(u[it] >> a.shift) & 255u;
      unsigned slot = mine[d] + rk[it];
      sk[slot] = u[it];
      if (MODE != K3_ROW) {
        sp[slot] = fetch ? so[r - tile_start] : pin ? __ldg(pin + r) : (int)r;
      }
    }
  }

  // look back, digit t: the counts of every earlier tile, from the nearest
  // inclusive prefix on. Every earlier tile holds an earlier ticket, so it
  // is running or done and publishes its aggregate without waiting; a
  // count that never comes is a fault, and the launch traps
  unsigned excl = 0u;
  if (tile > 0) {
    // K3_LOOK earlier tiles' counts read at once, then taken in order
    const unsigned long long pass = (unsigned long long)(a.g + 1);
    bool done = false;
    for (int j = tile - 1; !done; j -= K3_LOOK) {
      unsigned long long w[K3_LOOK];
#pragma unroll
      for (int k = 0; k < K3_LOOK; k++) {
        w[k] = j - k >= 0 ? k3_ld_volatile(a.status + (long long)(j - k) * 256 + t)
                          : 0ULL;
      }
#pragma unroll
      for (int k = 0; k < K3_LOOK; k++) {
        if (done) break;
        long long spins = 0;
        while ((w[k] >> 34) != pass) {
          __nanosleep(32);
          if (++spins > K3_MAX_SPINS) __trap();
          w[k] = k3_ld_volatile(a.status + (long long)(j - k) * 256 + t);
        }
        excl += (unsigned)w[k];
        done = ((w[k] >> 32) & 3ULL) == K3_INCLUSIVE;
      }
    }
    k3_st_volatile(status, tag | (K3_INCLUSIVE << 32) | (excl + cnt));
  }
  s_gofs[t] = gbase + excl - lbase;
  __syncthreads();

  // each digit's run to its place: consecutive slots, consecutive rows
  T* iout = (T*)a.b.img[1 - isel];
  int* pout = a.final_pass ? a.b.out : a.b.perm[psel == 1 ? 1 : 0];
  const T rmask = (T)(((T)1 << a.rbits) - 1);
  for (int q = t; q < len; q += K3_THREADS) {
    T v = sk[q];
    unsigned d = (unsigned)(v >> a.shift) & 255u;
    unsigned pos = s_gofs[d] + (unsigned)q;
    if (MODE != K3_KEYS && !a.last_comp) iout[pos] = v;
    if (MODE == K3_ROW) {
      if (a.final_pass && a.b.img_out != nullptr) {
        ((T*)a.b.img_out)[pos] = v;
      } else if (a.last_comp) {
        pout[pos] = (int)(v & rmask);
      }
    } else {
      pout[pos] = sp[q];
    }
  }
}

// a tile's image, its staged order and its prefetched order (K3_PAIR), or
// its image alone (K3_ROW), then the warps' digit counters
template <typename T, int MODE>
static constexpr size_t k3_smem_bytes() {
  return (size_t)K3_THREADS * K3_ITEMS *
             (sizeof(T) + (MODE == K3_ROW ? 0 : 2) * sizeof(int)) +
         (size_t)K3_WARPS * 256 * sizeof(unsigned);
}

// rows a tile of a digit pass holds, whatever the image
extern "C" int ob_k3_tile_rows() { return K3_THREADS * K3_ITEMS; }

static long long k3_align8(long long b) { return (b + 7) & ~7LL; }

// The scratch of one sort: the published counts of a pass's tiles, the
// digit counts of every pass, a ticket a pass, two state ints a pass and
// one more; all zeroed by one memset before the first launch.
extern "C" long long ob_k3_scratch_bytes(int ncomp, const int* comp_bits,
                                         long long n) {
  long long passes = 0;
  const long long tr = ob_k3_tile_rows(), tiles = (n + tr - 1) / tr;
  for (int c = 0; c < ncomp; c++) passes += (comp_bits[c] + 7) / 8;
  return (tiles > 1 ? tiles : 1) * 256 * 8 + passes * 256 * 4 +
         k3_align8(passes * 4) + k3_align8((2 * passes + 2) * 4);
}

// (max of ~image, max of image) of each key into minmax[2k..2k + 1], and
// into minmax[2 nkeys] bit m - first for each of the last K3_MAX_PACK keys
// m (first = max(0, nkeys - K3_MAX_PACK)) whose suffix m..nkeys - 1 does
// not run in row order (k3_span_group; a sweep a K3_MAX_PACK keys, from
// the least significant).
extern "C" int ob_k3_spans(int nkeys, const void* const* keys, const int* dts,
                           const int* descs, long long n, void* minmax,
                           int nblocks, void* stream) {
  if (nkeys < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* mm = (unsigned long long*)minmax;
  cudaError_t e = cudaMemsetAsync(mm, 0, (size_t)(2 * nkeys + 1) * 8, s);
  if (e != cudaSuccess) return (int)e;
  for (int end = nkeys; end > 0; end -= K3_MAX_PACK) {
    const int first = end > K3_MAX_PACK ? end - K3_MAX_PACK : 0;
    K3Span p;
    memset(&p, 0, sizeof(p));
    p.nkeys = end - first;
    for (int k = 0; k < p.nkeys; k++) {
      p.key[k] = keys[first + k];
      p.dt[k] = dts[first + k];
      p.desc[k] = descs[first + k];
    }
    unsigned long long* got = mm + 2 * first;
    unsigned long long* bad = end == nkeys ? mm + 2 * nkeys : nullptr;
    switch (p.nkeys) {
#define K3_SPAN_CASE(NK)                                                   \
  case NK:                                                                 \
    k3_span_group<NK><<<nblocks, K3_THREADS, 0, s>>>(p, n, got, bad);        \
    break;
      K3_SPAN_CASE(1)
      K3_SPAN_CASE(2)
      K3_SPAN_CASE(3)
      K3_SPAN_CASE(4)
      K3_SPAN_CASE(5)
      K3_SPAN_CASE(6)
      K3_SPAN_CASE(7)
      K3_SPAN_CASE(8)
#undef K3_SPAN_CASE
    }
  }
  return (int)cudaGetLastError();
}

// The pass's shared memory is set once a device (the setting is the
// device's), not before every launch.
template <typename T, int MODE>
static cudaError_t k3_launch_pass(const K3PassArgs& a, cudaStream_t s) {
  static std::atomic<unsigned long long> ready{0};
  const size_t smem = k3_smem_bytes<T, MODE>();
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ULL << (dev & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(k3_onesweep<T, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit, std::memory_order_acq_rel);
  }
  const long long tile = ob_k3_tile_rows();
  int ntiles = (int)((a.n + tile - 1) / tile);
  k3_onesweep<T, MODE><<<ntiles, K3_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
static void k3_launch_pack(const K3Pack& p, const K3Bufs& b, int g,
                           long long n, int npass, int rbits, unsigned* h,
                           bool write, int nblocks, cudaStream_t s) {
  if (write) {
    k3_pack_hist<T, true><<<nblocks, K3_THREADS, 0, s>>>(p, b, g, n, npass,
                                                          rbits, h);
  } else {
    k3_pack_hist<T, false><<<nblocks, K3_THREADS, 0, s>>>(p, b, g, n, npass,
                                                           rbits, h);
  }
}

// The whole sort after the spans: ncomp composites, least significant
// first; composite c has comp_nkeys[c] members (their addresses, type
// codes, DESC flags, mins and shifts flattened in composite order),
// comp_bits[c] bits, image width comp_width[c] (64, 32, or 0 for a
// one-pass composite without an image) and comp_rbits[c] row bits in the
// image's low bits (0: the order beside the image). img_a / img_b hold n
// images of the widest width (null when no composite has an image),
// perm_a / perm_b n int32 (null when only the last pass writes an order),
// out the n int32 of the result; scratch ob_k3_scratch_bytes(...) bytes.
// img_out (K15's image route; then out may be null): one composite whose
// image holds the row (comp_rbits > 0), and its last pass writes the n
// sorted images of comp_width bits there instead of the order (the row is
// their low comp_rbits bits).
extern "C" int ob_k3_sort(int ncomp, const int* comp_nkeys,
                          const int* comp_bits, const int* comp_width,
                          const int* comp_rbits, const void* const* keys,
                          const int* dts, const int* descs,
                          const unsigned long long* mins, const int* shifts,
                          long long n, void* scratch, long long scratch_bytes,
                          void* img_a, void* img_b, void* perm_a,
                          void* perm_b, void* out, void* img_out,
                          int nblocks, void* stream) {
  if (ncomp < 1 || n < 1 || n > 0x7fffffffLL ||
      (out == nullptr && img_out == nullptr) || scratch == nullptr ||
      scratch_bytes != ob_k3_scratch_bytes(ncomp, comp_bits, n) ||
      (img_out != nullptr &&
       (ncomp != 1 || comp_width[0] == 0 || comp_rbits[0] == 0))) {
    return (int)cudaErrorInvalidValue;
  }
  long long passes = 0;
  const long long tr = ob_k3_tile_rows(), tiles = (n + tr - 1) / tr;
  bool orders = ncomp > 1;  // an order written before the last pass
  for (int c = 0; c < ncomp; c++) {
    int w = comp_width[c], bits = comp_bits[c], rb = comp_rbits[c];
    if (comp_nkeys[c] < 1 || comp_nkeys[c] > K3_MAX_PACK || bits < 1 ||
        bits > 64 || (w == 0 && (bits > 8 || rb != 0)) ||
        (w != 0 && w != 32 && w != 64) || bits + rb > (w ? w : 8) ||
        (rb != 0 && (rb > 31 || (n - 1) >> rb != 0)) ||
        (w != 0 && (img_a == nullptr || img_b == nullptr))) {
      return (int)cudaErrorInvalidValue;
    }
    orders = orders || (w != 0 && rb == 0);
    passes += (bits + 7) / 8;
  }
  if (orders && (perm_a == nullptr || perm_b == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)scratch_bytes, s);
  if (e != cudaSuccess) return (int)e;
  unsigned char* base = (unsigned char*)scratch;
  unsigned long long* status = (unsigned long long*)base;
  unsigned* hist = (unsigned*)(base + tiles * 256 * 8);
  int* ticket = (int*)(base + tiles * 256 * 8 + passes * 256 * 4);
  int* state = (int*)((unsigned char*)ticket + k3_align8(passes * 4));
  K3Bufs b;
  b.img[0] = img_a;
  b.img[1] = img_b;
  b.perm[0] = (int*)perm_a;
  b.perm[1] = (int*)perm_b;
  b.out = (int*)out;
  b.state = state;
  b.img_out = img_out;
  int g = 0, m = 0;
  for (int c = 0; c < ncomp; c++) {
    K3Pack p;
    memset(&p, 0, sizeof(p));
    p.nkeys = comp_nkeys[c];
    for (int k = 0; k < p.nkeys; k++, m++) {
      p.key[k] = keys[m];
      p.dt[k] = dts[m];
      p.desc[k] = descs[m];
      p.min[k] = mins[m];
      p.shift[k] = shifts[m];
    }
    int w = comp_width[c], rb = comp_rbits[c];
    int npass = (comp_bits[c] + 7) / 8;
    unsigned* h = hist + (long long)g * 256;
    if (w == 64) {
      k3_launch_pack<unsigned long long>(p, b, g, n, npass, rb, h, true,
                                         nblocks, s);
    } else {
      k3_launch_pack<unsigned>(p, b, g, n, npass, rb, h, w != 0, nblocks, s);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    for (int q = 0; q < npass; q++, g++) {
      K3PassArgs a;
      a.p = p;
      a.b = b;
      a.hist = hist + (long long)g * 256;
      a.status = status;
      a.ticket = ticket + g;
      a.n = n;
      a.g = g;
      a.shift = rb + 8 * q;
      a.rbits = rb;
      a.last_comp = q == npass - 1;
      a.final_pass = c == ncomp - 1 && q == npass - 1;
      if (w == 64 && rb) {
        e = k3_launch_pass<unsigned long long, K3_ROW>(a, s);
      } else if (w == 64) {
        e = k3_launch_pass<unsigned long long, K3_PAIR>(a, s);
      } else if (w == 32 && rb) {
        e = k3_launch_pass<unsigned, K3_ROW>(a, s);
      } else if (w == 32) {
        e = k3_launch_pass<unsigned, K3_PAIR>(a, s);
      } else {
        e = k3_launch_pass<unsigned, K3_KEYS>(a, s);
      }
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
