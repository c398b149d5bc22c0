// K3: stable lexicographic sort order -- an LSD radix sort over packed,
// order-preserving unsigned images of the keys.
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
// mask) that is about 1.3 GB, about 0.4 ms. The radix passes move far more.
//
// Design: one kernel per non-bool key finds the min and max of its image
// (a bool key, the dead flag among them, spans 0..1 and is not measured);
// the wrapper reads them all at once, drops constant keys and packs the
// rest, least significant first, into as few 64-bit composites as their spans
// allow ((image - min) << shift; S1's four keys span 54 bits, one
// composite). Each composite is built in one gather through the current
// permutation, then sorted by 8-bit digit passes over its bits only. A pass
// is three kernels: a per-tile digit histogram (warp-aggregated shared
// atomics), a scan of each digit's row of tile counts (one block per
// digit), and a stable scatter of (image, row) pairs that ranks each
// element among equal digits in its tile by warp match masks, stages the
// tile in shared memory in digit order and writes each digit's run out
// contiguously. Stability of every pass gives the row-index tiebreak.
#include "ob_common.cuh"

#define K3_THREADS 256
#define K3_WARPS (K3_THREADS / 32)
#define K3_ITEMS 16
#define K3_TILE (K3_THREADS * K3_ITEMS)

__device__ __forceinline__ unsigned long long k3_image(const void* key, int dt,
                                                       int desc, long long j) {
  const unsigned long long flip = 1ULL << 63;
  switch (dt) {
    case OB_BOOL: {
      unsigned long long b = ((const unsigned char*)key)[j] ? 1ULL : 0ULL;
      return desc ? 1ULL - b : b;
    }
    case OB_U8: {
      unsigned char x = ((const unsigned char*)key)[j];
      if (desc) x = (unsigned char)(0u - (unsigned)x);
      return (unsigned long long)x;
    }
    case OB_I8: {
      unsigned char u = ((const unsigned char*)key)[j];
      if (desc) u = (unsigned char)(0u - (unsigned)u);
      long long x = (long long)(signed char)u;
      return (unsigned long long)x ^ flip;
    }
    case OB_I16: {
      unsigned short u = ((const unsigned short*)key)[j];
      if (desc) u = (unsigned short)(0u - (unsigned)u);
      long long x = (long long)(short)u;
      return (unsigned long long)x ^ flip;
    }
    case OB_I32: {
      unsigned int u = ((const unsigned int*)key)[j];
      if (desc) u = 0u - u;
      long long x = (long long)(int)u;
      return (unsigned long long)x ^ flip;
    }
    case OB_I64: {
      unsigned long long u = ((const unsigned long long*)key)[j];
      if (desc) u = 0ULL - u;
      return u ^ flip;
    }
    case OB_F32: {
      unsigned int u = __float_as_uint(((const float*)key)[j]);
      if (desc) u ^= 0x80000000u;
      if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffULL;  // NaN
      if ((u & 0x7fffffffu) == 0u) u = 0u;                         // -0.0
      u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
      return (unsigned long long)u;
    }
    default: {  // OB_F64
      unsigned long long u =
          (unsigned long long)__double_as_longlong(((const double*)key)[j]);
      if (desc) u ^= flip;
      if ((u & ~flip) > 0x7ff0000000000000ULL) return ~0ULL;  // NaN
      if ((u & ~flip) == 0ULL) u = 0ULL;                       // -0.0
      u = (u & flip) ? ~u : (u | flip);
      return u;
    }
  }
}

__global__ void k3_init_minmax(unsigned long long* mm) {
  mm[0] = ~0ULL;
  mm[1] = 0ULL;
}

// mm = (min, max) of the key's image over all n rows.
__global__ void k3_minmax_kernel(const void* key, int dt, int desc,
                                 long long n, unsigned long long* mm) {
  unsigned long long lo = ~0ULL, hi = 0ULL;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned long long u = k3_image(key, dt, desc, i);
    lo = u < lo ? u : lo;
    hi = u > hi ? u : hi;
  }
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long l2 = __shfl_xor_sync(OB_FULL_MASK, lo, o);
    unsigned long long h2 = __shfl_xor_sync(OB_FULL_MASK, hi, o);
    lo = l2 < lo ? l2 : lo;
    hi = h2 > hi ? h2 : hi;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&mm[0], lo);
    atomicMax(&mm[1], hi);
  }
}

#define K3_MAX_PACK 8

struct K3Pack {
  const void* key[K3_MAX_PACK];
  unsigned long long min[K3_MAX_PACK];
  int dt[K3_MAX_PACK];
  int desc[K3_MAX_PACK];
  int shift[K3_MAX_PACK];
  int nkeys;
};

// img[i] = sum over keys of (image(key[perm[i]]) - min) << shift
// (perm null = identity); the fields are disjoint bit ranges.
__global__ void k3_pack_kernel(K3Pack p, const int* __restrict__ perm,
                               long long n,
                               unsigned long long* __restrict__ img) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long j = perm ? (long long)perm[i] : i;
    unsigned long long u = 0ULL;
    for (int k = 0; k < p.nkeys; k++) {
      u |= (k3_image(p.key[k], p.dt[k], p.desc[k], j) - p.min[k])
           << p.shift[k];
    }
    img[i] = u;
  }
}

__device__ __forceinline__ int k3_digit(unsigned long long u, int shift) {
  return (int)((u >> shift) & 255ULL);
}

// hist[d * ntiles + tile] = count of digit d in the tile.
__global__ void k3_hist(const unsigned long long* __restrict__ img, long long n,
                        int shift, unsigned* __restrict__ hist, int ntiles) {
  __shared__ unsigned h[256];
  for (int t = threadIdx.x; t < 256; t += blockDim.x) h[t] = 0;
  __syncthreads();
  int lane = threadIdx.x & 31;
  long long start = (long long)blockIdx.x * K3_TILE;
  for (int it = 0; it < K3_ITEMS; it++) {
    long long i = start + (long long)it * K3_THREADS + threadIdx.x;
    int d = 256;  // out of range
    if (i < n) d = k3_digit(img[i], shift);
    unsigned peers = __match_any_sync(OB_FULL_MASK, d);
    if (lane == __ffs(peers) - 1 && d < 256) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    hist[(long long)t * ntiles + blockIdx.x] = h[t];
  }
}

// Block d: exclusive scan of digit d's row of tile counts, in place, and
// the row total into totals[d].
__global__ void k3_scan_rows(unsigned* hist, int ntiles, unsigned* totals) {
  __shared__ unsigned s[K3_THREADS];
  __shared__ unsigned carry;
  unsigned* row = hist + (long long)blockIdx.x * ntiles;
  int tid = threadIdx.x;
  if (tid == 0) carry = 0u;
  __syncthreads();
  for (int base = 0; base < ntiles; base += K3_THREADS) {
    int t = base + tid;
    unsigned v = t < ntiles ? row[t] : 0u;
    s[tid] = v;
    __syncthreads();
    for (int off = 1; off < K3_THREADS; off <<= 1) {
      unsigned x = tid >= off ? s[tid - off] : 0u;
      __syncthreads();
      s[tid] += x;
      __syncthreads();
    }
    unsigned incl = s[tid];
    if (t < ntiles) row[t] = carry + incl - v;
    __syncthreads();
    if (tid == K3_THREADS - 1) carry += incl;
    __syncthreads();
  }
  if (tid == 0) totals[blockIdx.x] = carry;
}

// Stable scatter of (image, row) by the pass digit. hist = per-digit
// scanned tile counts, totals = per-digit row totals. The tile is first
// ranked into shared memory in digit order, then written out so that each
// digit's run goes to consecutive global positions (coalesced stores).
// img_out may be null (last pass of a composite: only the order is needed).
__global__ void k3_scatter(const unsigned long long* __restrict__ img_in,
                           const int* __restrict__ perm_in, long long n,
                           int shift, const unsigned* __restrict__ hist,
                           const unsigned* __restrict__ totals, int ntiles,
                           unsigned long long* __restrict__ img_out,
                           int* __restrict__ perm_out) {
  extern __shared__ unsigned long long k3_smem[];
  unsigned long long* sk = k3_smem;                 // [K3_TILE] images
  int* sp = (int*)(sk + K3_TILE);                   // [K3_TILE] rows
  unsigned* gbase = (unsigned*)(sp + K3_TILE);      // [256] global bases
  unsigned* lbase = gbase + 256;                    // [256] tile-local bases
  unsigned* run = lbase + 256;                      // [256] running counts
  unsigned* wcnt = run + 256;                       // [K3_WARPS][256]
  int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  long long cell = (long long)tid * ntiles + blockIdx.x;
  unsigned mine = hist[cell];
  unsigned cnt = (blockIdx.x + 1 < ntiles ? hist[cell + 1] : totals[tid]) - mine;
  // exclusive scans over the 256 digits (one thread per digit) of the
  // global totals and of this tile's counts
  unsigned tot = totals[tid];
  gbase[tid] = tot;
  lbase[tid] = cnt;
  __syncthreads();
  for (int off = 1; off < 256; off <<= 1) {
    unsigned x = tid >= off ? gbase[tid - off] : 0u;
    unsigned y = tid >= off ? lbase[tid - off] : 0u;
    __syncthreads();
    gbase[tid] += x;
    lbase[tid] += y;
    __syncthreads();
  }
  gbase[tid] = gbase[tid] - tot + mine;
  lbase[tid] -= cnt;
  run[tid] = 0u;
  long long start = (long long)blockIdx.x * K3_TILE;
  unsigned lt_mask = (1u << lane) - 1u;
  for (int it = 0; it < K3_ITEMS; it++) {
    for (int t = tid; t < K3_WARPS * 256; t += blockDim.x) wcnt[t] = 0u;
    __syncthreads();
    long long i = start + (long long)it * K3_THREADS + tid;
    int d = 256;
    unsigned long long u = 0ULL;
    int p = 0;
    if (i < n) {
      u = img_in[i];
      p = perm_in ? perm_in[i] : (int)i;
      d = k3_digit(u, shift);
    }
    unsigned peers = __match_any_sync(OB_FULL_MASK, d);
    unsigned rank = __popc(peers & lt_mask);
    if (lane == __ffs(peers) - 1 && d < 256) wcnt[warp * 256 + d] = __popc(peers);
    __syncthreads();
    if (d < 256) {
      unsigned q = lbase[d] + run[d] + rank;
      for (int w = 0; w < warp; w++) q += wcnt[w * 256 + d];
      sk[q] = u;
      sp[q] = p;
    }
    __syncthreads();
    unsigned s2 = 0;
    for (int w = 0; w < K3_WARPS; w++) s2 += wcnt[w * 256 + tid];
    run[tid] += s2;
    __syncthreads();
  }
  long long m = n - start < K3_TILE ? n - start : K3_TILE;
  for (int q = tid; q < m; q += K3_THREADS) {
    unsigned long long u = sk[q];
    int d = k3_digit(u, shift);
    unsigned pos = gbase[d] + ((unsigned)q - lbase[d]);
    if (img_out) img_out[pos] = u;
    perm_out[pos] = sp[q];
  }
}

#define K3_SCATTER_SMEM \
  (K3_TILE * (sizeof(unsigned long long) + sizeof(int)) + \
   (3 + K3_WARPS) * 256 * sizeof(unsigned))

// (min, max) of one key's image, into minmax[0..1].
extern "C" int ob_k3_minmax(const void* key, int dt, int desc, long long n,
                            void* minmax, int nblocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  k3_init_minmax<<<1, 1, 0, s>>>((unsigned long long*)minmax);
  k3_minmax_kernel<<<nblocks, K3_THREADS, 0, s>>>(
      key, dt, desc, n, (unsigned long long*)minmax);
  return (int)cudaGetLastError();
}

// One composite image of up to K3_MAX_PACK keys through perm (null =
// identity).
extern "C" int ob_k3_pack(int nkeys, const void* const* keys, const int* dts,
                          const int* descs, const unsigned long long* mins,
                          const int* shifts, const void* perm, long long n,
                          void* img, int nblocks, void* stream) {
  if (nkeys < 1 || nkeys > K3_MAX_PACK) return (int)cudaErrorInvalidValue;
  K3Pack p;
  p.nkeys = nkeys;
  for (int k = 0; k < nkeys; k++) {
    p.key[k] = keys[k];
    p.dt[k] = dts[k];
    p.desc[k] = descs[k];
    p.min[k] = mins[k];
    p.shift[k] = shifts[k];
  }
  k3_pack_kernel<<<nblocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
      p, (const int*)perm, n, (unsigned long long*)img);
  return (int)cudaGetLastError();
}

// One 8-bit digit pass: (img_in, perm_in) -> (img_out, perm_out), stable.
// hist holds 256 * ntiles and totals 256 uint32 of scratch,
// ntiles = ceil(n / K3_TILE). img_out may be null.
extern "C" int ob_k3_pass(const void* img_in, const void* perm_in, long long n,
                          int shift, void* hist, void* totals, int ntiles,
                          void* img_out, void* perm_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned long long* ii = (const unsigned long long*)img_in;
  unsigned* h = (unsigned*)hist;
  unsigned* tot = (unsigned*)totals;
  k3_hist<<<ntiles, K3_THREADS, 0, s>>>(ii, n, shift, h, ntiles);
  k3_scan_rows<<<256, K3_THREADS, 0, s>>>(h, ntiles, tot);
  cudaError_t err = cudaFuncSetAttribute(
      k3_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)K3_SCATTER_SMEM);
  if (err != cudaSuccess) return (int)err;
  k3_scatter<<<ntiles, K3_THREADS, K3_SCATTER_SMEM, s>>>(
      ii, (const int*)perm_in, n, shift, h, tot, ntiles,
      (unsigned long long*)img_out, (int*)perm_out);
  return (int)cudaGetLastError();
}

extern "C" int ob_k3_tile_rows() { return K3_TILE; }
