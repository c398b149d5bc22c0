// K17: the range slice of a sorted-projection scan.
//
// Replaces oceanbase_tpu/engine/executor.py:4179 _slice_sorted_scan. The
// scan of a sorted projection (storage/sorted_projection.py) reads only
// the rows whose sort key lies in the statement's range: lo is the largest
// of searchsorted(key[:n], low bound, side) over the low bounds, hi the
// smallest over the high bounds, then hi = max(hi, lo); the slice is the
// `cap` rows from start = clip(lo, 0, capacity - cap) of every column,
// validity mask and sel, with sel cleared outside [lo, hi); nrows counts
// the sliced sel and overflow = max(hi - lo - cap, 0) sends a range wider
// than the static slice capacity back through the overflow retry.
//
// The bounds may be parameterized literals, i.e. 0-d device tensors that
// the host has not read, so the slice cannot be a host-offset narrow: it
// is a copy whose offset is found on the device. Bound on an H100 (3.35
// TB/s): the sliced bytes, read once and written once, plus the probes of
// the searches (a few sectors) -- memory bound.
//
// Design: one launch, nothing before it. Every block first finds lo and
// hi: one warp a bound, each step probing 32 positions that cut the range
// into 33 parts and keeping the part the ballot names (about 6 dependent
// rounds over 60M keys, where a binary search takes 26), the bound cast to
// the key's width first as the reference's astype does, lo and hi folded
// with shared atomics. Then every column is copied as bytes, 16 a thread:
// the slice of a column starts at any row, so each destination vector is
// assembled from the two aligned source vectors that hold its bytes with
// funnel shifts (as K26 does); sel goes the same way, its bytes outside
// [lo, hi) cleared and its live rows counted in the same pass. The outputs
// are one allocation of the wrapper's: nrows and overflow in its first 16
// bytes, then each column and sel at a 16-byte aligned offset, so a last
// vector may write into its own padding. nrows needs no zeroed counter and
// no second launch: each block writes its count, and the block that takes
// the last ticket folds them and puts the ticket back to 0 for the next
// call. The columns and bounds come from one table: up to
// K17_INLINE entries ride the kernel's parameters, a longer table lies in
// device memory (the wrapper caches it with the rest of the arguments).
//
// The first design ran a binary search per bound thread by
// thread, copied a column element by element and a byte of sel per
// thread, zeroed nrows with a launch of its own, and its wrapper rebuilt
// the argument table and made seven allocations on every call.
#include "ob_common.cuh"

#define K17_THREADS 256
#define K17_INLINE 64
#define K17_UNROLL 4

// The table: two entries per column (the source address; the byte offset
// of its slice in the output times 16 plus its element width), then two
// per bound (the 0-d bound tensor's address; its type code times 4 plus
// its flags: bit 0 side right, bit 1 high bound). In `e` when it has at
// most K17_INLINE entries (t is null), else at t in device memory.
struct K17Args {
  const void* key;
  const unsigned char* sel;
  const long long* t;
  long long n, cap, cap2;
  long long sel_off;  // osel's byte offset in the output
  int key_dt, ncols, nbounds, pad;
  long long e[K17_INLINE];
};

// A bound value converted to the key's type (two's-complement truncation,
// as astype does), widened back to int64 for the comparisons.
__device__ __forceinline__ long long k17_as_key(long long v, int key_dt) {
  switch (key_dt) {
    case OB_I8: return (long long)(signed char)v;
    case OB_I16: return (long long)(short)v;
    case OB_I32: return (long long)(int)v;
    default: return v;
  }
}

__device__ __forceinline__ long long k17_entry(const K17Args& a, int i) {
  return a.t != nullptr ? __ldg(a.t + i) : a.e[i];
}

// searchsorted(key[:n], v, side) by one warp: the number of leading keys
// below v (left) or at most v (right). Each round the 32 lanes probe the
// positions that cut [lo, hi) into 33 parts; the count of probes still
// below v names the part that holds the answer.
__device__ long long k17_search(const void* key, int key_dt, long long n,
                                long long v, bool right) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long m = hi - lo;
    const long long p = lo + ((long long)(lane + 1) * m) / 33;
    const long long k = ob_ldg_i64(key, key_dt, p);
    // probes below v come first (the keys are sorted): the answer lies
    // past the last of them and at or before the first probe that is not
    const int c = __popc(__ballot_sync(OB_FULL_MASK, right ? k <= v : k < v));
    const long long nlo = c > 0 ? lo + ((long long)c * m) / 33 + 1 : lo;
    if (c < 32) hi = lo + ((long long)(c + 1) * m) / 33;
    lo = nlo;
  }
  const long long m = hi - lo;
  bool t = false;
  if (lane < m) {
    const long long k = ob_ldg_i64(key, key_dt, lo + lane);
    t = right ? k <= v : k < v;
  }
  return lo + __popc(__ballot_sync(OB_FULL_MASK, t));
}

// Destination vector i of a copy whose source starts at byte address s:
// bytes s + 16 i .. s + 16 i + 15, of which the first `need` are wanted
// (the source's aligned blocks past them are not read).
__device__ __forceinline__ uint4 k17_vec(const unsigned char* s, long long i,
                                         int need) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(s) + 16 * (uintptr_t)i;
  const int sh = (int)(at & 15);
  const uint4* a = reinterpret_cast<const uint4*>(at - sh);
  const uint4 A = __ldg(a);
  if (sh == 0) return A;
  const uint4 B = sh + need > 16 ? __ldg(a + 1) : make_uint4(0, 0, 0, 0);
  return ob_funnel16(A, B, sh);
}

// A byte-mask word: byte b of word w (rows 4 w + b of the vector) kept
// where lo <= row < hi.
__device__ __forceinline__ unsigned k17_keep(long long row0, long long lo,
                                             long long hi) {
  unsigned m = 0;
#pragma unroll
  for (int b = 0; b < 4; b++) {
    const long long r = row0 + b;
    if (r >= lo && r < hi) m |= 0xffu << (8 * b);
  }
  return m;
}

__global__ void __launch_bounds__(K17_THREADS)
k17_slice(const __grid_constant__ K17Args a, unsigned char* out,
          unsigned long long* scratch) {
  __shared__ long long s_lo, s_hi;
  __shared__ unsigned long long s_live[K17_THREADS / 32];
  __shared__ bool s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) {
    s_lo = 0;
    s_hi = a.n;
  }
  __syncthreads();
  for (int b = warp; b < a.nbounds; b += K17_THREADS / 32) {
    const int i = 2 * a.ncols + 2 * b;
    const void* bv = (const void*)k17_entry(a, i);
    const int code = (int)k17_entry(a, i + 1);
    const long long v = k17_as_key(ob_ldg_i64(bv, code >> 2, 0), a.key_dt);
    const long long pos = k17_search(a.key, a.key_dt, a.n, v, (code & 1) != 0);
    // positions lie in [0, n]: the signed atomics order them as integers
    if (lane == 0) {
      if (code & 2) {
        atomicMin(&s_hi, pos);
      } else {
        atomicMax(&s_lo, pos);
      }
    }
  }
  __syncthreads();
  const long long lo = s_lo, hi = s_hi > s_lo ? s_hi : s_lo;
  long long start = lo;
  if (start > a.cap2 - a.cap) start = a.cap2 - a.cap;
  if (blockIdx.x == 0 && t == 0) {
    const long long over = hi - lo - a.cap;
    reinterpret_cast<long long*>(out)[1] = over > 0 ? over : 0;
  }
  const long long stride = (long long)gridDim.x * K17_THREADS;
  const long long first = (long long)blockIdx.x * K17_THREADS + t;
  // sel: 16 rows a vector, cleared outside [lo, hi), the kept ones counted
  const long long nvs = (a.cap + 15) >> 4;
  const long long rlo = lo - start, rhi = (hi - start < a.cap ? hi - start
                                                                : a.cap);
  unsigned long long live = 0;
  uint4* osel = reinterpret_cast<uint4*>(out + a.sel_off);
  for (long long v = first; v < nvs; v += stride) {
    const long long r0 = 16 * v;
    const int need = a.cap - r0 < 16 ? (int)(a.cap - r0) : 16;
    uint4 x = k17_vec(a.sel + start, v, need);
    x.x &= k17_keep(r0, rlo, rhi) & 0x01010101u;
    x.y &= k17_keep(r0 + 4, rlo, rhi) & 0x01010101u;
    x.z &= k17_keep(r0 + 8, rlo, rhi) & 0x01010101u;
    x.w &= k17_keep(r0 + 12, rlo, rhi) & 0x01010101u;
    live += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
    osel[v] = x;
  }
  // the columns: cap * width bytes each, from byte start * width
  for (int c = 0; c < a.ncols; c++) {
    const unsigned char* src = (const unsigned char*)k17_entry(a, 2 * c);
    const long long d = k17_entry(a, 2 * c + 1);
    const int w = (int)(d & 15);
    uint4* dst = reinterpret_cast<uint4*>(out + (d >> 4));
    const unsigned char* s = src + start * w;
    const long long bytes = a.cap * w, nv = (bytes + 15) >> 4;
    for (long long v = first; v < nv; v += stride * K17_UNROLL) {
      uint4 x[K17_UNROLL];
#pragma unroll
      for (int u = 0; u < K17_UNROLL; u++) {
        const long long i = v + u * stride;
        if (i < nv) {
          x[u] = k17_vec(s, i, bytes - 16 * i < 16 ? (int)(bytes - 16 * i)
                                                   : 16);
        }
      }
#pragma unroll
      for (int u = 0; u < K17_UNROLL; u++) {
        const long long i = v + u * stride;
        if (i < nv) dst[i] = x[u];
      }
    }
  }
  // nrows: each block's count, folded by the block that finishes last
  for (int o = 16; o > 0; o >>= 1) {
    live += __shfl_xor_sync(OB_FULL_MASK, live, o);
  }
  if (lane == 0) s_live[warp] = live;
  __syncthreads();
  if (t == 0) {
    unsigned long long sum = 0;
    for (int k = 0; k < K17_THREADS / 32; k++) sum += s_live[k];
    scratch[1 + blockIdx.x] = sum;
    __threadfence();
    s_last = atomicAdd(scratch, 1ull) == gridDim.x - 1ull;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block folds the blocks' counts, a thread a stride of them
  unsigned long long total = 0;
  for (unsigned b = t; b < gridDim.x; b += K17_THREADS) {
    total += __ldcg(scratch + 1 + b);
  }
  for (int o = 16; o > 0; o >>= 1) {
    total += __shfl_xor_sync(OB_FULL_MASK, total, o);
  }
  if (lane == 0) s_live[warp] = total;
  __syncthreads();
  if (t == 0) {
    unsigned long long sum = 0;
    for (int k = 0; k < K17_THREADS / 32; k++) sum += s_live[k];
    reinterpret_cast<long long*>(out)[0] = (long long)sum;
    scratch[0] = 0;  // the ticket, back for the next call on this stream
  }
}

// args: a host K17Args (kernels.py packs and caches it); out: the output
// allocation (nrows, overflow, then each column's slice and sel at the
// offsets in the table); scratch: 1 + nblocks uint64, the first (the
// ticket) 0 between calls.
extern "C" int ob_k17_slice(const void* args, int nblocks, void* out,
                            void* scratch, void* stream) {
  K17Args a;
  memcpy(&a, args, sizeof(K17Args));
  const long long ne = 2LL * a.ncols + 2LL * a.nbounds;
  if (a.ncols < 0 || a.nbounds < 0 || a.cap < 1 || a.cap > a.cap2 ||
      a.n > a.cap2 || nblocks < 1 || (a.t == nullptr && ne > K17_INLINE)) {
    return (int)cudaErrorInvalidValue;
  }
  k17_slice<<<nblocks, K17_THREADS, 0, (cudaStream_t)stream>>>(
      a, (unsigned char*)out, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}

extern "C" int ob_k17_args_bytes() { return (int)sizeof(K17Args); }
