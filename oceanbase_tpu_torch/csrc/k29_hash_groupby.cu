// K29: the general hash group-by: open-addressing slot assignment over a
// multi-column key, count/sum/min/max per slot, each slot's representative
// row and its key columns.
//
// Replaces oceanbase_tpu/ops/hashagg.py:155 groupby_hash, over :42
// assign_group_slots and :123 _apply_agg (and with them the device step
// of oceanbase_tpu/ops/spill.py:201 _device_groupby_sum). The reference
// probes every live row in lockstep from the home slot h & (T - 1) of its
// 32-bit hash32_combine tag: the lowest row wins an empty slot, a row
// meeting a slot of an equal key tuple joins it, any other row advances
// one slot; after T rounds a row still without a slot gets slot -1. Each
// aggregate is a scatter into T slots (count and integer sums in int64,
// float sums in the value's type, min/max in the value's type). A dead
// row drops out; a live row with slot -1 lands in slot T - 1, since JAX's
// scatter wraps the index -1.
//
// Bound on an H100 (3.35 TB/s): the live rows' keys, values and sel read
// once, row_slot written once, and the T-slot outputs (slot rows, used
// flags, keys, aggregates) written once -- memory bound. The atomics on
// the slot words and the random key reads through slot rows are on top.
//
// Design: a simple first kernel (the table sized to 2 x NDV, not to rows,
// so it stays in L2 at the spill's sizes). (1) Clear the slot rows to -1
// and each aggregate to its identity. (2) One thread per live row walks
// linear probes from its home slot: atomicCAS(-1 -> row) claims an empty
// slot; a slot whose row holds an equal key tuple (read from the input
// columns through that row, so no slot tag can be read half-written)
// takes atomicMin(row), so each key keeps its lowest row as the
// reference's schedule gives it; the thread then adds its values into the
// slot with 64-bit atomics (integer add/min/max, atomicAdd on floats, a
// CAS loop for float min/max with NaN propagating). (3) One thread per
// slot writes slot_used, the representative row's key columns and the
// narrow integer min/max out of their int64 accumulators. Which key lands
// in which slot depends on the order the threads run in; the groups, their
// integer aggregates and the number of used slots do not. An aggregate-
// only entry (no key columns) takes row_slot as given, as _apply_agg does.
// The key columns come from a table in device memory (ob_common.cuh
// ObKeys, any number of them); a launch takes at most K29_MAX_AGGS
// aggregates, and the wrapper runs the aggregates after the first 16
// through the aggregate-only entry over the same row slots, so the slot
// pass runs once however many aggregates a statement has.
#include "ob_common.cuh"

#define K29_THREADS 256
#define K29_MAX_AGGS 16

// accumulator kinds
#define K29_ACC_I64 0
#define K29_ACC_F32 1
#define K29_ACC_F64 2

struct K29Agg {
  int op;      // OB_COUNT / OB_SUM / OB_MIN / OB_MAX
  int val_dt;  // the value column's type code (unused for count)
  int acc;     // accumulator kind
  int out_dt;  // narrow integer min/max: the output type; else -1
  const void* val;
  void* acc_ptr;  // [T]
  void* out;      // [T] when out_dt >= 0
};

struct K29Args {
  ObKeys keys;  // ncols 0: row_slot is an input; the table holds each key
                // column's output [T] at t[2 ncols + j] (the key's type;
                // int64 for a bool key)
  const unsigned char* sel;
  long long n;
  long long tsize;
  int naggs;
  K29Agg agg[K29_MAX_AGGS];
  int* row_slot;               // [n]
  int* slot_row;               // [T]
  unsigned char* slot_used;    // [T]
};

__device__ __forceinline__ int k29_esize(int dt) {
  switch (dt) {
    case OB_I16: return 2;
    case OB_I32: case OB_F32: return 4;
    case OB_I64: case OB_F64: return 8;
    default: return 1;
  }
}

// iinfo(dt).max (min = true) or iinfo(dt).min, as int64
__device__ __forceinline__ long long k29_int_ident(int dt, bool is_min) {
  switch (dt) {
    case OB_I8: return is_min ? 127ll : -128ll;
    case OB_U8: case OB_BOOL: return is_min ? 255ll : 0ll;
    case OB_I16: return is_min ? 32767ll : -32768ll;
    case OB_I32: return is_min ? 2147483647ll : -2147483648ll;
    default: return is_min ? 0x7fffffffffffffffll : (long long)0x8000000000000000ull;
  }
}

__global__ void k29_clear(K29Args a) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < a.tsize; s += step) {
    if (a.keys.ncols > 0) a.slot_row[s] = -1;
    for (int j = 0; j < a.naggs; j++) {
      const K29Agg& g = a.agg[j];
      bool is_min = g.op == OB_MIN;
      bool ext = g.op == OB_MIN || g.op == OB_MAX;
      if (g.acc == K29_ACC_I64) {
        ((long long*)g.acc_ptr)[s] = ext ? k29_int_ident(g.val_dt, is_min) : 0;
      } else if (g.acc == K29_ACC_F32) {
        ((float*)g.acc_ptr)[s] =
            ext ? (is_min ? __int_as_float(0x7f800000) : __int_as_float((int)0xff800000u))
                : 0.0f;
      } else {
        ((double*)g.acc_ptr)[s] =
            ext ? (is_min ? __longlong_as_double(0x7ff0000000000000ll)
                          : __longlong_as_double((long long)0xfff0000000000000ull))
                : 0.0;
      }
    }
  }
}

// NaN-propagating min/max into a float or double slot by a CAS loop
__device__ __forceinline__ void k29_minmax_f32(float* p, float v, bool is_min) {
  int* w = (int*)p;
  int old = *w;
  while (true) {
    float o = __int_as_float(old);
    float r = (o != o) ? o : (v != v) ? v : (is_min ? (v < o ? v : o) : (v > o ? v : o));
    if (__float_as_int(r) == old) return;
    int got = atomicCAS(w, old, __float_as_int(r));
    if (got == old) return;
    old = got;
  }
}

__device__ __forceinline__ void k29_minmax_f64(double* p, double v, bool is_min) {
  unsigned long long* w = (unsigned long long*)p;
  unsigned long long old = *w;
  while (true) {
    double o = __longlong_as_double((long long)old);
    double r = (o != o) ? o : (v != v) ? v : (is_min ? (v < o ? v : o) : (v > o ? v : o));
    unsigned long long rb = (unsigned long long)__double_as_longlong(r);
    if (rb == old) return;
    unsigned long long got = atomicCAS(w, old, rb);
    if (got == old) return;
    old = got;
  }
}

__device__ __forceinline__ void k29_add_row(const K29Args& a, long long i,
                                            long long s) {
  for (int j = 0; j < a.naggs; j++) {
    const K29Agg& g = a.agg[j];
    if (g.acc == K29_ACC_I64) {
      long long* p = (long long*)g.acc_ptr + s;
      if (g.op == OB_COUNT) {
        atomicAdd((unsigned long long*)p, 1ull);
        continue;
      }
      long long v = ob_ldg_i64(g.val, g.val_dt, i);
      if (g.op == OB_SUM) {
        atomicAdd((unsigned long long*)p, (unsigned long long)v);
      } else if (g.op == OB_MIN) {
        atomicMin(p, v);
      } else {
        atomicMax(p, v);
      }
    } else if (g.acc == K29_ACC_F32) {
      float v = __ldg((const float*)g.val + i);
      float* p = (float*)g.acc_ptr + s;
      if (g.op == OB_SUM) {
        atomicAdd(p, v);
      } else {
        k29_minmax_f32(p, v, g.op == OB_MIN);
      }
    } else {
      double v = __ldg((const double*)g.val + i);
      double* p = (double*)g.acc_ptr + s;
      if (g.op == OB_SUM) {
        atomicAdd(p, v);
      } else {
        k29_minmax_f64(p, v, g.op == OB_MIN);
      }
    }
  }
}

__global__ void k29_assign(K29Args a) {
  unsigned long long tmask = (unsigned long long)(a.tsize - 1);
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += step) {
    bool live = __ldg(a.sel + i) != 0;
    long long slot = -1;
    if (a.keys.ncols == 0) {
      slot = a.row_slot[i];
    } else if (live) {
      unsigned long long s = (unsigned long long)ob_keys_hash32(a.keys, i) & tmask;
      for (unsigned long long k = 0; k <= tmask; k++) {
        int cur = atomicCAS(a.slot_row + s, -1, (int)i);
        if (cur < 0) {
          slot = (long long)s;
          break;
        }
        if (ob_keys_equal(a.keys, cur, a.keys, i)) {
          atomicMin(a.slot_row + s, (int)i);
          slot = (long long)s;
          break;
        }
        s = (s + 1) & tmask;
      }
      a.row_slot[i] = (int)slot;
    } else {
      a.row_slot[i] = -1;
    }
    if (!live) continue;
    // JAX's scatter wraps a negative index i to i + T (so slot -1 lands
    // in T - 1); an index still outside [0, T) drops
    long long target = slot < 0 ? slot + a.tsize : slot;
    if (target < 0 || target >= a.tsize) continue;
    k29_add_row(a, i, target);
  }
}

__global__ void k29_final(K29Args a) {
  long long step = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       s < a.tsize; s += step) {
    if (a.keys.ncols > 0) {
      int r = a.slot_row[s];
      a.slot_used[s] = r >= 0 ? 1 : 0;
      for (int j = 0; j < a.keys.ncols; j++) {
        const void* col = ob_key_col(a.keys, j);
        int dt = ob_key_dt(a.keys, j);
        void* out = (void*)__ldg(a.keys.t + 2 * a.keys.ncols + j);
        if (dt == OB_BOOL) {
          // jnp.where(used, bool_key, 0) promotes to int64
          ((long long*)out)[s] = r >= 0 ? ob_ldg_i64(col, OB_BOOL, r) : 0;
        } else {
          ob_copy_elem(col, out, k29_esize(dt), r >= 0 ? (long long)r : -1,
                       s);
        }
      }
    }
    for (int j = 0; j < a.naggs; j++) {
      const K29Agg& g = a.agg[j];
      if (g.out_dt < 0) continue;
      long long v = ((const long long*)g.acc_ptr)[s];
      switch (g.out_dt) {
        case OB_I8: ((signed char*)g.out)[s] = (signed char)v; break;
        case OB_U8: ((unsigned char*)g.out)[s] = (unsigned char)v; break;
        case OB_I16: ((short*)g.out)[s] = (short)v; break;
        default: ((int*)g.out)[s] = (int)v; break;
      }
    }
  }
}

// table: the device table of ncols key columns of n rows, their type
// codes and their outputs (3 ncols entries; ncols 0: row_slot is an
// input); sel: bool [n]; tsize: a power of two; per aggregate j (naggs of
// them): ops[j], val_dts[j], acc_kinds[j], out_dts[j] (-1 unless a narrow
// integer min/max), vals[j] ([n], null for count), accs[j] ([T]), outs[j]
// ([T] or null). row_slot: int32 [n]; slot_row: int32 [T]; slot_used:
// bool [T]. The key outputs are columns [T] of the keys' types (int64
// for a bool key).
extern "C" int ob_k29_groupby(int ncols, const void* table,
                              const void* sel, long long n,
                              long long tsize, int naggs, const int* ops,
                              const int* val_dts, const int* acc_kinds,
                              const int* out_dts, const void* const* vals,
                              void* const* accs, void* const* outs,
                              void* row_slot, void* slot_row, void* slot_used,
                              int row_blocks,
                              int slot_blocks, void* stream) {
  K29Args a;
  memset(&a, 0, sizeof(a));
  if (ncols != 0 && !ob_keys_set(&a.keys, ncols, table)) {
    return (int)cudaErrorInvalidValue;
  }
  if (tsize < 1 || (tsize & (tsize - 1)) != 0 || n < 0 || n >= (1ll << 31) ||
      naggs < 0 || naggs > K29_MAX_AGGS) {
    return (int)cudaErrorInvalidValue;
  }
  a.sel = (const unsigned char*)sel;
  a.n = n;
  a.tsize = tsize;
  a.naggs = naggs;
  for (int j = 0; j < naggs; j++) {
    K29Agg& g = a.agg[j];
    g.op = ops[j];
    g.val_dt = val_dts[j];
    g.acc = acc_kinds[j];
    g.out_dt = out_dts[j];
    g.val = vals[j];
    g.acc_ptr = accs[j];
    g.out = outs[j];
  }
  a.row_slot = (int*)row_slot;
  a.slot_row = (int*)slot_row;
  a.slot_used = (unsigned char*)slot_used;
  cudaStream_t s = (cudaStream_t)stream;
  k29_clear<<<slot_blocks, K29_THREADS, 0, s>>>(a);
  if (n > 0) k29_assign<<<row_blocks, K29_THREADS, 0, s>>>(a);
  k29_final<<<slot_blocks, K29_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
