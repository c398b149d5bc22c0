// K2: direct-addressed group-by over a small key domain.
//
// Replaces oceanbase_tpu/ops/hashagg.py:181 groupby_direct and the
// executor's direct path (engine/executor.py:3104-3143 with _direct_slot_agg,
// :4255): for every slot g of the packed key and every aggregate a, a
// masked reduction of values[a] over rows with key == g and mask[a] set.
// The JAX package runs domain x aggregates fused masked sums; here one pass
// over the rows serves every (slot, aggregate) pair.
//
// Bound on an H100 (3.35 TB/s): it must read the key column, each distinct
// mask and each aggregate's values once -- memory bound. TPC-H Q1 at SF 10
// (60M rows: an int32 key, one mask shared by the 10 aggregates, two int32
// and three int64 value columns) reads about 2.2 GB: about 0.66 ms.
//
// Slots. The executor admits a group-by to this path when the product D of
// its keys' domains is at most 64, but pack_keys gives each key whole bits
// (a domain rounded up to a power of two, a domain of 1 one bit), so the
// packed slots can be many more than D (5 x 3 x 3 = 45 packs into 128).
// The kernel takes each row's dense mixed-radix slot (key i times the
// product of the domains before it, < D <= 64) and keeps D cells; the
// last block writes every packed slot, the dense cell its key fields name,
// or the aggregate's identity where a field lies outside its domain.
//
// Design: one launch. The wrapper hands over each distinct aggregate once
// (the same op over the same values and mask tensors is one) and each
// distinct mask once. A lane takes 16 adjacent rows of a chunk, a warp 512,
// and a warp two chunks at a time: their keys (as dense slots, a byte a
// row) and every distinct mask (16 rows a load, as bits) are read once into
// registers; then each aggregate, in K2_W slots a pass (one pass up to 8
// dense slots), reads its values by 16-byte loads (the value type resolved
// once a pass, not a load) and folds each row into the lane's register
// accumulator of its slot (a predicated fold a slot: no shared memory, no
// atomics, nothing across lanes). After the two chunks each slot's 32 lane
// accumulators meet in a fixed butterfly, and one lane folds the result
// into the warp's cell in shared memory ([warps x aggregates x D] 8-byte
// cells, at most K2_CELLS x 8 warps, whatever the threads). Every fold has
// a fixed order, so a float aggregate (accumulated as double) has the same
// bits on every run. At the end each block folds its warps' cells in warp
// order into its partials; the block that finishes last (a self-resetting
// ticket) folds every block's partials in a fixed order, a warp a cell
// (lanes in block order, then a shuffle tree), and writes the packed slots,
// each result in its output type. Integer aggregates (every stored type but
// float) are widened to int64 and exact.
#include <atomic>

#include "ob_common.cuh"

#define K2_THREADS 256
#define K2_WARPS (K2_THREADS / 32)
#define K2_ROWS 16                 // rows a lane a chunk
#define K2_CHUNK (32 * K2_ROWS)    // rows a warp a chunk
#define K2_BATCH 2                 // chunks a warp holds at a time
#define K2_W 8                     // dense slots a pass
#define K2_MAX_AGGS 32
#define K2_MAX_MASKS 8
#define K2_MAX_OUTS 64
#define K2_MAX_KEYS 6              // keys of domain >= 2: their product is <= 64
#define K2_CELLS 704               // aggregates x D a launch: 8 warps x 704 x 8 B = 44 KB
#define K2_NONE 255u               // a row that joins no cell

struct K2Agg {
  const void* vals;  // null for count
  long long ident;   // int64 identity, or the bits of a double
  int dt, op, isf, mask;
};

struct K2Out {
  int agg, row, dt, pad;  // output row `row` holds aggregate `agg` as type dt
};

// The arguments of one launch (kernels.py packs them, byte for byte).
struct K2Params {
  const void* keys;
  const unsigned char* masks[K2_MAX_MASKS];
  long long n, slots, zmask;
  unsigned long long aligned;  // bit 0 keys, 1 + m mask m, 9 + a values of a
  int key_dt, D, nagg, nmask, nout, nk;
  int shift[K2_MAX_KEYS], bits[K2_MAX_KEYS], dom[K2_MAX_KEYS],
      radix[K2_MAX_KEYS];
  K2Agg agg[K2_MAX_AGGS];
  K2Out out[K2_MAX_OUTS];
};

// The dense slot of packed slot p, or -1 where a key field lies outside
// its domain.
__device__ __forceinline__ int k2_dense(const K2Params& P, long long p) {
  if (p & P.zmask) return -1;
  int d = 0;
#pragma unroll
  for (int i = 0; i < K2_MAX_KEYS; i++) {
    if (i < P.nk) {
      const int f = (int)((p >> P.shift[i]) & ((1LL << P.bits[i]) - 1));
      if (f >= P.dom[i]) return -1;
      d += f * P.radix[i];
    }
  }
  return d;
}

// 4 bool bytes (0 or 1) of a word as 4 bits
__device__ __forceinline__ unsigned k2_bits4(unsigned w) {
  return ((w & 0x01010101u) * 0x10204080u) >> 28;
}

// Word i of NV 16-byte vectors.
__device__ __forceinline__ unsigned k2_word(const uint4* q, int i) {
  const uint4 u = q[i >> 2];
  switch (i & 3) {
    case 0: return u.x;
    case 1: return u.y;
    case 2: return u.z;
    default: return u.w;
  }
}

// Element j of 16 values packed in 16-byte vectors (little endian).
template <typename T>
__device__ __forceinline__ T k2_elem(const uint4* q, int j);
template <>
__device__ __forceinline__ long long k2_elem<long long>(const uint4* q, int j) {
  return (long long)(((unsigned long long)k2_word(q, 2 * j + 1) << 32) |
                     k2_word(q, 2 * j));
}
template <>
__device__ __forceinline__ double k2_elem<double>(const uint4* q, int j) {
  return __hiloint2double((int)k2_word(q, 2 * j + 1), (int)k2_word(q, 2 * j));
}
template <>
__device__ __forceinline__ int k2_elem<int>(const uint4* q, int j) {
  return (int)k2_word(q, j);
}
template <>
__device__ __forceinline__ float k2_elem<float>(const uint4* q, int j) {
  return __uint_as_float(k2_word(q, j));
}
template <>
__device__ __forceinline__ short k2_elem<short>(const uint4* q, int j) {
  return (short)(k2_word(q, j >> 1) >> (16 * (j & 1)));
}
template <>
__device__ __forceinline__ signed char k2_elem<signed char>(const uint4* q,
                                                           int j) {
  return (signed char)(k2_word(q, j >> 2) >> (8 * (j & 3)));
}
template <>
__device__ __forceinline__ unsigned char k2_elem<unsigned char>(
    const uint4* q, int j) {
  return (unsigned char)(k2_word(q, j >> 2) >> (8 * (j & 3)));
}

// Word i of NV 16-byte vectors: keep the bits of `keep`, or in `bits`.
__device__ __forceinline__ void k2_set_word(uint4* q, int i, unsigned keep,
                                            unsigned bits) {
  uint4& u = q[i >> 2];
  switch (i & 3) {
    case 0: u.x = (u.x & keep) | bits; break;
    case 1: u.y = (u.y & keep) | bits; break;
    case 2: u.z = (u.z & keep) | bits; break;
    default: u.w = (u.w & keep) | bits; break;
  }
}

// Element j of 16 values stored into their 16-byte vectors.
template <typename T>
__device__ __forceinline__ void k2_put(uint4* q, int j, T v) {
  unsigned long long u = 0;
  memcpy(&u, &v, sizeof(T));
  if constexpr (sizeof(T) == 8) {
    k2_set_word(q, 2 * j, 0u, (unsigned)u);
    k2_set_word(q, 2 * j + 1, 0u, (unsigned)(u >> 32));
  } else if constexpr (sizeof(T) == 4) {
    k2_set_word(q, j, 0u, (unsigned)u);
  } else {
    const int per = 4 / (int)sizeof(T), sh = 8 * (int)sizeof(T) * (j % per);
    const unsigned m = (sizeof(T) == 2 ? 0xffffu : 0xffu) << sh;
    k2_set_word(q, j / per, ~m, ((unsigned)u << sh) & m);
  }
}

// Rows r0 .. r0 + 15 of a column as raw 16-byte vectors (0 past n): 16-byte
// loads where `vec`, else element by element.
template <typename T>
__device__ __forceinline__ void k2_load16(const T* __restrict__ p,
                                          long long r0, long long n, bool vec,
                                          uint4 q[K2_ROWS * sizeof(T) / 16]) {
  constexpr int NV = K2_ROWS * (int)sizeof(T) / 16;
  if (vec) {
#pragma unroll
    for (int i = 0; i < NV; i++) q[i] = __ldg((const uint4*)(p + r0) + i);
  } else {
#pragma unroll
    for (int i = 0; i < NV; i++) q[i] = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < K2_ROWS; j++) {
      if (r0 + j < n) k2_put<T>(q, j, __ldg(p + r0 + j));
    }
  }
}

__device__ __forceinline__ unsigned k2_mask16(const unsigned char* m,
                                              long long r0, long long n,
                                              bool vec) {
  if (vec) {
    const uint4 q = __ldg((const uint4*)(m + r0));
    return k2_bits4(q.x) | k2_bits4(q.y) << 4 | k2_bits4(q.z) << 8 |
           k2_bits4(q.w) << 12;
  }
  unsigned b = 0;
#pragma unroll
  for (int j = 0; j < K2_ROWS; j++) {
    if (r0 + j < n && __ldg(m + r0 + j)) b |= 1u << j;
  }
  return b;
}

// The fold of an op, templated so the row loop carries no branch on it.
template <int OP, bool F>
struct K2Op;
template <int OP>
struct K2Op<OP, false> {
  typedef long long A;
  static __device__ __forceinline__ A comb(A a, A b) {
    if (OP == OB_MIN) return b < a ? b : a;
    if (OP == OB_MAX) return b > a ? b : a;
    return a + b;
  }
  static __device__ __forceinline__ A from_bits(long long u) { return u; }
  static __device__ __forceinline__ long long to_bits(A v) { return v; }
};
template <int OP>
struct K2Op<OP, true> {
  typedef double A;
  static __device__ __forceinline__ A comb(A a, A b) {
    return ob_combine_f64(OP, a, b);
  }
  static __device__ __forceinline__ A from_bits(long long u) {
    return __longlong_as_double(u);
  }
  static __device__ __forceinline__ long long to_bits(A v) {
    return __double_as_longlong(v);
  }
};

// The dense slots of a lane's rows of a warp's chunks, a byte a row
// (K2_NONE: a row that joins no cell).
struct K2Rows {
  unsigned sl[K2_BATCH * 4];
};

__device__ __forceinline__ unsigned k2_slot(const K2Rows& r, int b, int j) {
  return (r.sl[4 * b + (j >> 2)] >> (8 * (j & 3))) & 0xffu;
}

// One pass of one aggregate over a warp's chunks c0, c0 + 1 (slots base ..
// base + K2_W - 1): each row folded into the lane's accumulator of its
// slot, then each slot's lanes by a butterfly, into the warp's cells.
// Called, not inlined: each (type, op) is compiled once.
template <typename T, int OP, bool F>
__device__ __noinline__ void k2_pass(const void* vals, long long ident,
                                     long long c0, long long n, bool aligned,
                                     unsigned m32, K2Rows rows, int base,
                                     long long* cell, int D, int lane) {
  typedef K2Op<OP, F> Op;
  typedef typename Op::A A;
  const A id = Op::from_bits(ident);
  A acc[K2_W];
#pragma unroll
  for (int k = 0; k < K2_W; k++) acc[k] = id;
#pragma unroll
  for (int b = 0; b < K2_BATCH; b++) {
    if ((c0 + b) * K2_CHUNK >= n) break;
    const long long r0 = (c0 + b) * K2_CHUNK + lane * K2_ROWS;
    uint4 q[K2_ROWS * sizeof(T) / 16];
    k2_load16((const T*)vals, r0, n, aligned && r0 + K2_ROWS <= n, q);
#pragma unroll
    for (int j = 0; j < K2_ROWS; j++) {
      const unsigned s = k2_slot(rows, b, j) - (unsigned)base;
      const bool take = (m32 >> (16 * b + j)) & 1u;
      const A x = (A)k2_elem<T>(q, j);
#pragma unroll
      for (int k = 0; k < K2_W; k++) {
        if (take && s == (unsigned)k) acc[k] = Op::comb(acc[k], x);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K2_W; k++) {
    A r = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r = Op::comb(r, __shfl_xor_sync(OB_FULL_MASK, r, o));
    }
    if (lane == k && base + k < D) {
      cell[base + k] = Op::to_bits(Op::comb(Op::from_bits(cell[base + k]), r));
    }
  }
}

// The count pass: 32-bit lane counters, summed by redux.
__device__ __forceinline__ void k2_count(long long c0, long long n,
                                         unsigned m32, const K2Rows& rows,
                                         int base, long long* cell, int D,
                                         int lane) {
  unsigned acc[K2_W];
#pragma unroll
  for (int k = 0; k < K2_W; k++) acc[k] = 0;
#pragma unroll
  for (int b = 0; b < K2_BATCH; b++) {
    if ((c0 + b) * K2_CHUNK >= n) break;
#pragma unroll
    for (int j = 0; j < K2_ROWS; j++) {
      const unsigned s = k2_slot(rows, b, j) - (unsigned)base;
      const unsigned take = (m32 >> (16 * b + j)) & 1u;
#pragma unroll
      for (int k = 0; k < K2_W; k++) acc[k] += s == (unsigned)k ? take : 0u;
    }
  }
#pragma unroll
  for (int k = 0; k < K2_W; k++) {
    const unsigned r = __reduce_add_sync(OB_FULL_MASK, acc[k]);
    if (lane == k && base + k < D) cell[base + k] += r;
  }
}

// A lane's keys of chunk c0 + b as slots into rows.sl.
template <typename K>
__device__ __forceinline__ void k2_key_slots(const K2Params& P, long long r0,
                                             bool vec, int b, K2Rows& rows) {
  uint4 q[K2_ROWS * sizeof(K) / 16];
  k2_load16((const K*)P.keys, r0, P.n, vec, q);
#pragma unroll
  for (int i = 0; i < 4; i++) rows.sl[4 * b + i] = 0;
#pragma unroll
  for (int j = 0; j < K2_ROWS; j++) {
    const K kj = k2_elem<K>(q, j);
    const unsigned s = r0 + j < P.n && kj >= 0 && kj < P.D ? (unsigned)kj
                                                           : K2_NONE;
    rows.sl[4 * b + (j >> 2)] |= s << (8 * (j & 3));
  }
}

__global__ void __launch_bounds__(K2_THREADS, 2)
k2_groupby(const __grid_constant__ K2Params P, long long* __restrict__ out,
           unsigned long long* __restrict__ scratch) {
  extern __shared__ long long s_cell[];  // [warp][agg][D], then the results
  __shared__ bool s_last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int D = P.D, nagg = P.nagg, cells = nagg * D;
  for (int i = t; i < K2_WARPS * cells; i += K2_THREADS) {
    s_cell[i] = P.agg[(i / D) % nagg].ident;
  }
  __syncthreads();
  const long long n = P.n;
  const long long nchunks = (n + K2_CHUNK - 1) / K2_CHUNK;
  long long* mine = s_cell + warp * cells;
  for (long long c0 = ((long long)blockIdx.x * K2_WARPS + warp) * K2_BATCH;
       c0 < nchunks; c0 += (long long)gridDim.x * K2_WARPS * K2_BATCH) {
    K2Rows rows;
    unsigned mb[K2_MAX_MASKS];
#pragma unroll
    for (int m = 0; m < K2_MAX_MASKS; m++) mb[m] = 0;
#pragma unroll
    for (int b = 0; b < K2_BATCH; b++) {
      const long long r0 = (c0 + b) * K2_CHUNK + lane * K2_ROWS;
      const bool full = r0 + K2_ROWS <= n;
      const bool kv = full && (P.aligned & 1ull);
      if (P.key_dt == OB_I32) k2_key_slots<int>(P, r0, kv, b, rows);
      else k2_key_slots<long long>(P, r0, kv, b, rows);
#pragma unroll
      for (int m = 0; m < K2_MAX_MASKS; m++) {
        if (m < P.nmask) {
          mb[m] |= k2_mask16(P.masks[m], r0, n,
                             full && (P.aligned >> (1 + m) & 1ull))
                   << (16 * b);
        }
      }
    }
    for (int a = 0; a < nagg; a++) {
      const int op = P.agg[a].op, dt = P.agg[a].dt, mk = P.agg[a].mask;
      const void* vals = P.agg[a].vals;
      const long long ident = P.agg[a].ident;
      const bool al = P.aligned >> (9 + a) & 1ull;
      unsigned m32 = 0;
#pragma unroll
      for (int m = 0; m < K2_MAX_MASKS; m++) m32 = m == mk ? mb[m] : m32;
      long long* cell = mine + a * D;
      for (int base = 0; base < D; base += K2_W) {
#define K2_PASS(T, OP, F)                                                 \
  k2_pass<T, OP, F>(vals, ident, c0, n, al, m32, rows, base, cell, D, lane); \
  break
#define K2_TYPES(OP)                                  \
  switch (dt) {                                       \
    case OB_BOOL:                                     \
    case OB_U8: K2_PASS(unsigned char, OP, false);    \
    case OB_I8: K2_PASS(signed char, OP, false);      \
    case OB_I16: K2_PASS(short, OP, false);           \
    case OB_I32: K2_PASS(int, OP, false);             \
    case OB_I64: K2_PASS(long long, OP, false);       \
    case OB_F32: K2_PASS(float, OP, true);            \
    default: K2_PASS(double, OP, true);               \
  }
        if (op == OB_COUNT) {
          k2_count(c0, n, m32, rows, base, cell, D, lane);
        } else if (op == OB_SUM) {
          K2_TYPES(OB_SUM)
        } else if (op == OB_MIN) {
          K2_TYPES(OB_MIN)
        } else {
          K2_TYPES(OB_MAX)
        }
#undef K2_TYPES
#undef K2_PASS
      }
    }
  }
  __syncthreads();
  // the block's partials: its warps' cells folded in warp order
  long long* part = (long long*)(scratch + 4);
  for (int i = t; i < cells; i += K2_THREADS) {
    const K2Agg& g = P.agg[i / D];
    long long v = s_cell[i];
    for (int w = 1; w < K2_WARPS; w++) {
      const long long u = s_cell[w * cells + i];
      v = g.isf ? __double_as_longlong(ob_combine_f64(
                      g.op, __longlong_as_double(v), __longlong_as_double(u)))
                : ob_combine_i64(g.op, v, u);
    }
    part[(long long)blockIdx.x * cells + i] = v;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(scratch, 1ull) == gridDim.x - 1ull;
  __syncthreads();
  if (!s_last) return;
  if (t == 0) scratch[0] = 0;  // the ticket, back for the next launch
  __threadfence();
  // the last block: every block's partials, a warp a cell, lanes in block
  // order then a shuffle tree
  for (int i = warp; i < cells; i += K2_WARPS) {
    const K2Agg& g = P.agg[i / D];
    long long v = g.ident;
    for (unsigned b = lane; b < gridDim.x; b += 32) {
      const long long u = __ldcg(part + (long long)b * cells + i);
      v = g.isf ? __double_as_longlong(ob_combine_f64(
                      g.op, __longlong_as_double(v), __longlong_as_double(u)))
                : ob_combine_i64(g.op, v, u);
    }
    for (int o = 16; o > 0; o >>= 1) {
      const long long u = __shfl_down_sync(OB_FULL_MASK, v, o);
      v = g.isf ? __double_as_longlong(ob_combine_f64(
                      g.op, __longlong_as_double(v), __longlong_as_double(u)))
                : ob_combine_i64(g.op, v, u);
    }
    if (lane == 0) s_cell[i] = v;  // the warps' cells are folded already
  }
  __syncthreads();
  const long long slots = P.slots;
  for (int o = 0; o < P.nout; o++) {
    const K2Out& ob = P.out[o];
    char* row = (char*)out + (long long)ob.row * slots * 8;
    const long long idv = P.agg[ob.agg].ident;
    for (long long p = t; p < slots; p += K2_THREADS) {
      const int d = k2_dense(P, p);
      const long long v = d >= 0 ? s_cell[ob.agg * D + d] : idv;
      switch (ob.dt) {
        case OB_I32: ((int*)row)[p] = (int)v; break;
        case OB_I16: ((short*)row)[p] = (short)v; break;
        case OB_I8:
        case OB_U8:
        case OB_BOOL: ((unsigned char*)row)[p] = (unsigned char)v; break;
        default: ((long long*)row)[p] = v; break;
      }
    }
  }
}

// The kernels this library has launched, for a caller that checks how many
// a call takes.
static std::atomic<long long> k2_launched{0};

// args: a host K2Params (kernels.py packs and caches it); out: the call's
// output rows (slots 8-byte cells each); scratch: 32 bytes (the ticket
// first, 0 between launches) then nblocks x nagg x D 8-byte partials.
extern "C" int ob_k2_groupby(const void* args, int nblocks, void* out,
                             void* scratch, void* stream) {
  K2Params P;
  memcpy(&P, args, sizeof(K2Params));
  if (P.nagg < 1 || P.nagg > K2_MAX_AGGS || P.D < 1 || P.D > 64 ||
      P.nagg * P.D > K2_CELLS || P.nmask < 0 || P.nmask > K2_MAX_MASKS ||
      P.nout < 1 || P.nout > K2_MAX_OUTS || P.nk < 0 ||
      P.nk > K2_MAX_KEYS || P.slots < 1 || P.n < 0 || nblocks < 1 ||
      (P.key_dt != OB_I32 && P.key_dt != OB_I64)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int a = 0; a < P.nagg; a++) {
    const K2Agg& g = P.agg[a];
    if (g.mask < 0 || g.mask >= P.nmask ||
        (g.op != OB_COUNT && g.vals == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (int o = 0; o < P.nout; o++) {
    if (P.out[o].agg < 0 || P.out[o].agg >= P.nagg) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const size_t shmem = (size_t)K2_WARPS * P.nagg * P.D * sizeof(long long);
  k2_groupby<<<nblocks, K2_THREADS, shmem, (cudaStream_t)stream>>>(
      P, (long long*)out, (unsigned long long*)scratch);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) k2_launched.fetch_add(1);
  return (int)e;
}

extern "C" long long ob_k2_kernel_launches() { return k2_launched.load(); }

extern "C" int ob_k2_args_bytes() { return (int)sizeof(K2Params); }
extern "C" int ob_k2_cells() { return K2_CELLS; }
