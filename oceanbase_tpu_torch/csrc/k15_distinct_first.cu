// K15: first occurrences through a sort order, and rows written back
// through a permutation.
//
// Replaces oceanbase_tpu/ops/hashagg.py:240 distinct_first_mask (the run
// boundaries over the sorted (dead, keys, value) planes and the
// argsort(sidx) inverse that maps the winner bit back to row order) and
// the write-back of oceanbase_tpu/engine/executor.py:2628 _emit_window
// (the inverse permutation of :2687 and the packed gather by it):
//   first    bool [n] in row order, set at the lowest live row of every run
//            of equal (dead, keys...) along K3's stable order; keys compare
//            with `!=`, so every NaN row is its own value and -0.0 equals
//            0.0
//   scatter  dst[c][order[i]] = src[c][i] for every column c
//
// Bound on an H100 (3.35 TB/s): first must read its keys and the live
// flags once and write one byte a row, memory bound. What held the first
// design back: one thread a sorted position read the live flag, every key
// column and then wrote first[order[i]], each at a random row, so four or
// five 32-byte sectors a row at D1's shape (~9-10 GB for a function of
// 1 GB). K3 has just sorted these very keys, and where one composite holds
// them with the row in its low bits, its last pass writes the sorted
// images instead of the order (kernels.sort_order_images).
//
// Design: first has three routes, chosen on the host by kernels.k15_route
// from K3's plan:
//   image    read the images coalesced (16-byte loads), compare each
//            image's key bits (img >> rbits) with its neighbour's, take the
//            row from the low bits; the dead flag is a bit of the image (or
//            constant). K3's images merge every NaN, so no float key takes
//            this route, nor a shape where K3 dropped keys already in row
//            order (rows may tie on the kept keys and differ there);
//   record   one coalesced pass packs each row's keys (-0.0 as 0.0) and its
//            live and has-NaN bits into a record of 8, 16 or 32 bytes
//            (widest keys first, the flag byte last); the walk then reads
//            the order coalesced and one random record a row, and compares
//            records by their bits (a row with a NaN key starts a run);
//   columns  keys too wide for a 32-byte record: the sorted walk reads each
//            key column at the row (the first design's walk); with no order
//            (K3 found every key constant or in row order) it runs in row
//            order, so every read is coalesced.
// The image and record routes zero first (a memset) and write only the
// run starts: at D1's shape some 600,000 random bytes, not 60M. Two runs
// give the same bits (each byte written by exactly one thread, no atomics).
//
// The scatter writes the inverse permutation once (4 random bytes a row)
// and then gathers every column through it, so the many columns' random
// accesses are reads and their writes stay coalesced.
#include "ob_common.cuh"

#define K15_THREADS 256
#define K15_MAX_SCATTER 48
// the record route's flag byte (the record's last): its two low bits
#define K15_LIVE 1u
#define K15_NAN 2u

// ---- image route ----------------------------------------------------------

// Sorted images of one composite (T: 32 or 64 bits): the keys above
// rbits, the row below. live_const: -1 the dead flag is bit dead_bit of
// the image; 1 every row is live; 0 none is.
template <typename T>
__global__ void __launch_bounds__(K15_THREADS)
    k15_images(const T* __restrict__ img, long long n, int rbits,
               int dead_bit, int live_const,
               unsigned char* __restrict__ first) {
  constexpr int V = 16 / sizeof(T);  // images a 16-byte load
  if (live_const == 0) return;
  const int lane = threadIdx.x & 31;
  const T rmask = (T)(((T)1 << rbits) - 1);
  const long long step = (long long)gridDim.x * K15_THREADS * V;
  for (long long base = ((long long)blockIdx.x * K15_THREADS) * V;
       base < n; base += step) {
    const long long e0 = base + (long long)threadIdx.x * V;
    T v[V];
    if (e0 + V <= n) {
      uint4 q = __ldg((const uint4*)(img + e0));
      memcpy(v, &q, 16);
    } else {
#pragma unroll
      for (int k = 0; k < V; k++) v[k] = e0 + k < n ? __ldg(img + e0 + k) : 0;
    }
    // the image before this thread's first: the lane below's last
    T prev = __shfl_up_sync(OB_FULL_MASK, v[V - 1], 1);
    if (lane == 0 && e0 > 0 && e0 < n) prev = __ldg(img + e0 - 1);
#pragma unroll
    for (int k = 0; k < V; k++) {
      const long long e = e0 + k;
      if (e < n) {
        const bool nw = e == 0 || (v[k] >> rbits) != (prev >> rbits);
        const bool live =
            live_const > 0 || ((v[k] >> dead_bit) & (T)1) == (T)0;
        if (nw && live) first[(long long)(v[k] & rmask)] = 1;
      }
      prev = v[k];
    }
  }
}

// img: n sorted images of `width` bits (32 or 64); first: bool [n],
// zeroed here before the launch.
extern "C" int ob_k15_first_images(const void* img, int width, long long n,
                                   int rbits, int dead_bit, int live_const,
                                   void* first, int nblocks, void* stream) {
  if ((width != 32 && width != 64) || rbits < 1 || rbits >= width ||
      (live_const < 0 && (dead_bit < rbits || dead_bit >= width)) ||
      live_const > 1 || ((reinterpret_cast<uintptr_t>(img) & 15) != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(first, 0, (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  if (width == 64) {
    k15_images<unsigned long long><<<nblocks, K15_THREADS, 0, s>>>(
        (const unsigned long long*)img, n, rbits, dead_bit, live_const,
        (unsigned char*)first);
  } else {
    k15_images<unsigned><<<nblocks, K15_THREADS, 0, s>>>(
        (const unsigned*)img, n, rbits, dead_bit, live_const,
        (unsigned char*)first);
  }
  return (int)cudaGetLastError();
}

// ---- record route ---------------------------------------------------------

// One key of row r into the record at rec (its byte offset off), floats
// with -0.0 as 0.0 and a NaN's payload dropped (the NaN bit says it).
template <typename T>
__device__ __forceinline__ void k15_put(const void* col, long long r,
                                        unsigned char* rec, int off,
                                        unsigned* nan) {
  T v = __ldg((const T*)col + r);
  *(T*)(rec + off) = v;
}

template <>
__device__ __forceinline__ void k15_put<float>(const void* col, long long r,
                                               unsigned char* rec, int off,
                                               unsigned* nan) {
  float v = __ldg((const float*)col + r);
  if (v != v) *nan = K15_NAN;
  *(float*)(rec + off) = (v != v || v == 0.0f) ? 0.0f : v;
}

template <>
__device__ __forceinline__ void k15_put<double>(const void* col, long long r,
                                                unsigned char* rec, int off,
                                                unsigned* nan) {
  double v = __ldg((const double*)col + r);
  if (v != v) *nan = K15_NAN;
  *(double*)(rec + off) = (v != v || v == 0.0) ? 0.0 : v;
}

// Records of R bytes for K15_THREADS rows a step: each thread builds its
// row's record in shared memory (the key table: t[j] address, t[ncols +
// j] type code, t[2 ncols + j] byte offset), then the block stores its
// records with 16-byte stores.
template <int R>
__global__ void __launch_bounds__(K15_THREADS)
    k15_pack(ObKeys k, const unsigned char* __restrict__ live, long long n,
             unsigned char* __restrict__ rec) {
  __shared__ __align__(16) unsigned char s_rec[K15_THREADS * R];
  const int t = threadIdx.x;
  unsigned char* mine = s_rec + t * R;
  const long long step = (long long)gridDim.x * K15_THREADS;
  for (long long base = (long long)blockIdx.x * K15_THREADS; base < n;
       base += step) {
    const long long r = base + t;
    const bool in = r < n;
#pragma unroll
    for (int q = 0; q < R / 4; q++) ((unsigned*)mine)[q] = 0u;
    unsigned nan = 0u;
    if (in) {
      for (int j = 0; j < k.ncols; j++) {
        const void* col = ob_key_col(k, j);
        const int off = (int)__ldg(k.t + 2 * k.ncols + j);
        switch (ob_key_dt(k, j)) {
          case OB_BOOL:
          case OB_U8:
          case OB_I8:
            k15_put<unsigned char>(col, r, mine, off, &nan);
            break;
          case OB_I16:
            k15_put<unsigned short>(col, r, mine, off, &nan);
            break;
          case OB_I32:
            k15_put<unsigned>(col, r, mine, off, &nan);
            break;
          case OB_F32:
            k15_put<float>(col, r, mine, off, &nan);
            break;
          case OB_F64:
            k15_put<double>(col, r, mine, off, &nan);
            break;
          default:
            k15_put<unsigned long long>(col, r, mine, off, &nan);
            break;
        }
      }
      mine[R - 1] = (unsigned char)((__ldg(live + r) ? K15_LIVE : 0u) | nan);
    }
    __syncthreads();
    const long long rows = n - base < K15_THREADS ? n - base : K15_THREADS;
    uint4* dst = (uint4*)(rec + base * R);
    const int nv = (int)(rows * R / 16);
    for (int q = t; q < nv; q += K15_THREADS) dst[q] = ((const uint4*)s_rec)[q];
    if (R == 8 && (rows & 1) && t == 0) {
      ((uint2*)(rec + base * R))[rows - 1] = ((const uint2*)s_rec)[rows - 1];
    }
    __syncthreads();
  }
}

template <int R>
struct K15Rec {
  unsigned w[R / 4];
};

template <int R>
__device__ __forceinline__ K15Rec<R> k15_load_rec(const unsigned char* rec,
                                                  long long r) {
  K15Rec<R> x;
  const uint4* p = (const uint4*)(rec + r * R);
  if (R == 8) {
    uint2 a = __ldg((const uint2*)p);
    x.w[0] = a.x;
    x.w[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < R / 16; q++) {
      uint4 a = __ldg(p + q);
      x.w[4 * q] = a.x;
      x.w[4 * q + 1] = a.y;
      x.w[4 * q + 2] = a.z;
      x.w[4 * q + 3] = a.w;
    }
  }
  return x;
}

// The sorted walk over records: one sorted position a thread, the order
// read coalesced, the row's record at random; the previous position's
// record from the lane below (lane 0 reads it).
template <int R>
__global__ void __launch_bounds__(K15_THREADS)
    k15_walk(const unsigned char* __restrict__ rec,
             const int* __restrict__ order, long long n,
             unsigned char* __restrict__ first) {
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * K15_THREADS;
  for (long long i = (long long)blockIdx.x * K15_THREADS + threadIdx.x;
       i - threadIdx.x < n; i += step) {
    const bool in = i < n;
    const long long r = in ? __ldg(order + i) : 0;
    K15Rec<R> x = k15_load_rec<R>(rec, r);
    bool differ = false;
    K15Rec<R> p;
#pragma unroll
    for (int q = 0; q < R / 4; q++) {
      p.w[q] = __shfl_up_sync(OB_FULL_MASK, x.w[q], 1);
    }
    if (lane == 0 && in && i > 0) p = k15_load_rec<R>(rec, __ldg(order + i - 1));
#pragma unroll
    for (int q = 0; q < R / 4; q++) differ = differ || p.w[q] != x.w[q];
    const unsigned flags = x.w[R / 4 - 1] >> 24;
    const bool nw = i == 0 || differ || (flags & K15_NAN);
    if (in && nw && (flags & K15_LIVE)) first[r] = 1;
  }
}

// table: the device table of ncols key columns of n rows (ObKeys, then
// each key's byte offset in the record); live: bool [n]; order: int32 [n]
// (K3's order of (dead, keys...)); rec: scratch of n * rbytes bytes,
// 16-byte aligned; rbytes 8, 16 or 32; first: bool [n], zeroed here.
extern "C" int ob_k15_first_records(int ncols, const void* table,
                                    const void* live, const void* order,
                                    long long n, int rbytes, void* rec,
                                    void* first, int nblocks, void* stream) {
  ObKeys k;
  if (!ob_keys_set(&k, ncols, table) ||
      (rbytes != 8 && rbytes != 16 && rbytes != 32) ||
      (reinterpret_cast<uintptr_t>(rec) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(first, 0, (size_t)n, s);
  if (e != cudaSuccess) return (int)e;
  const unsigned char* lv = (const unsigned char*)live;
  unsigned char* rc = (unsigned char*)rec;
  const int* od = (const int*)order;
  unsigned char* fo = (unsigned char*)first;
  switch (rbytes) {
    case 8:
      k15_pack<8><<<nblocks, K15_THREADS, 0, s>>>(k, lv, n, rc);
      k15_walk<8><<<nblocks, K15_THREADS, 0, s>>>(rc, od, n, fo);
      break;
    case 16:
      k15_pack<16><<<nblocks, K15_THREADS, 0, s>>>(k, lv, n, rc);
      k15_walk<16><<<nblocks, K15_THREADS, 0, s>>>(rc, od, n, fo);
      break;
    default:
      k15_pack<32><<<nblocks, K15_THREADS, 0, s>>>(k, lv, n, rc);
      k15_walk<32><<<nblocks, K15_THREADS, 0, s>>>(rc, od, n, fo);
      break;
  }
  return (int)cudaGetLastError();
}

// ---- columns route ----------------------------------------------------------

// One warp covers 32 consecutive sorted positions: each thread reads the
// live flag and keys of its own row (order[i], or i with no order) once
// and takes the previous position's from the lane below by a shuffle; only
// lane 0 reads row order[i - 1] itself.
__global__ void k15_first(ObKeys k, const unsigned char* __restrict__ live,
                          const int* __restrict__ order, long long n,
                          unsigned char* __restrict__ first) {
  int lane = threadIdx.x & 31;
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += step) {
    long long i = base + threadIdx.x;
    bool in = i < n;
    long long r = in ? (order ? __ldg(order + i) : i) : 0;
    long long p = (in && lane == 0 && i > 0) ? (order ? __ldg(order + i - 1)
                                                      : i - 1)
                                             : 0;
    int lv = in ? __ldg(live + r) : 0;
    int plv = __shfl_up_sync(OB_FULL_MASK, lv, 1);
    if (lane == 0) plv = (in && i > 0) ? __ldg(live + p) : 0;
    bool nw = i == 0 || plv != lv;
    for (int c = 0; c < k.ncols; c++) {
      const void* col = ob_key_col(k, c);
      int dt = ob_key_dt(k, c);
      if (ob_is_float(dt)) {
        double v = in ? ob_ldg_f64(col, dt, r) : 0.0;
        double pv = __shfl_up_sync(OB_FULL_MASK, v, 1);
        if (lane == 0 && in && i > 0) pv = ob_ldg_f64(col, dt, p);
        nw = nw || v != pv;
      } else {
        long long v = in ? ob_ldg_i64(col, dt, r) : 0;
        long long pv = __shfl_up_sync(OB_FULL_MASK, v, 1);
        if (lane == 0 && in && i > 0) pv = ob_ldg_i64(col, dt, p);
        nw = nw || v != pv;
      }
    }
    if (in) first[r] = nw && lv;
  }
}

// table: the device table of ncols key columns of n rows in row order
// (ObKeys); live: bool [n]; order: int32 [n], a permutation sorting (dead,
// keys...), or null when the rows are in that order already; first: bool
// [n].
extern "C" int ob_k15_first(int ncols, const void* table, const void* live,
                            const void* order, long long n, void* first,
                            int nblocks, void* stream) {
  ObKeys k;
  if (!ob_keys_set(&k, ncols, table)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  k15_first<<<nblocks, K15_THREADS, 0, (cudaStream_t)stream>>>(
      k, (const unsigned char*)live, (const int*)order, n,
      (unsigned char*)first);
  return (int)cudaGetLastError();
}

// ---- scatter ----------------------------------------------------------------

struct K15Scatter {
  const void* src[K15_MAX_SCATTER];
  void* dst[K15_MAX_SCATTER];
  int width[K15_MAX_SCATTER];
  int ncols;
};

__global__ void k15_inverse(const int* __restrict__ order, long long n,
                            int* __restrict__ inv) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    inv[__ldg(order + i)] = (int)i;
  }
}

__global__ void k15_gather(K15Scatter a, const int* __restrict__ inv,
                           long long n) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += step) {
    long long i = __ldg(inv + j);
    for (int c = 0; c < a.ncols; c++) {
      switch (a.width[c]) {
        case 1:
          ((unsigned char*)a.dst[c])[j] = __ldg((const unsigned char*)a.src[c] + i);
          break;
        case 2:
          ((unsigned short*)a.dst[c])[j] = __ldg((const unsigned short*)a.src[c] + i);
          break;
        case 4:
          ((unsigned int*)a.dst[c])[j] = __ldg((const unsigned int*)a.src[c] + i);
          break;
        default:
          ((unsigned long long*)a.dst[c])[j] =
              __ldg((const unsigned long long*)a.src[c] + i);
          break;
      }
    }
  }
}

// src/dst/widths: ncols columns of n elements of 1, 2, 4 or 8 bytes;
// order: int32 [n], a permutation of 0..n-1; inv: int32 scratch [n].
extern "C" int ob_k15_scatter(int ncols, const void* const* src,
                              void* const* dst, const int* widths,
                              const void* order, void* inv, long long n,
                              int nblocks, void* stream) {
  if (ncols < 1 || ncols > K15_MAX_SCATTER) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  K15Scatter a;
  a.ncols = ncols;
  for (int c = 0; c < ncols; c++) {
    int w = widths[c];
    if (w != 1 && w != 2 && w != 4 && w != 8) return (int)cudaErrorInvalidValue;
    a.src[c] = src[c];
    a.dst[c] = dst[c];
    a.width[c] = w;
  }
  cudaStream_t st = (cudaStream_t)stream;
  k15_inverse<<<nblocks, K15_THREADS, 0, st>>>((const int*)order, n,
                                               (int*)inv);
  k15_gather<<<nblocks, K15_THREADS, 0, st>>>(a, (const int*)inv, n);
  return (int)cudaGetLastError();
}
