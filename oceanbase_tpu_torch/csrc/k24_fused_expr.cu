// K24: the fused expression kernel -- a register-program interpreter that
// evaluates a lowered expression tree (or several) over a batch in one
// pass: every input column read once at its storage width, each output
// written once.
//
// Replaces oceanbase_tpu/expr/compile.py:260 evaluate and :912
// compile_predicate, whose elementwise work XLA fuses into the statement's
// program (compares, decimal rescales, CASE, IN, dictionary-LUT reads,
// Kleene AND/OR, date parts). The program comes from
// oceanbase_tpu_torch/expr/program.py, which records the port's torch
// route op for op; this kernel computes each recorded op exactly as the
// torch op of the same dtype does, so its outputs equal the route's bit
// for bit.
//
// Bound on an H100 (3.35 TB/s): memory. It must read each input column
// and validity plane once and write each output once (Q6's predicate:
// three columns, sel and one bool mask, 14 bytes a row); the arithmetic is
// a few dozen integer and float ops a row.
//
// Design: one thread per row in a grid-stride loop. The program is the
// kernel's parameter (by value, __grid_constant__, so it stays in the
// constant bank): every thread of a warp runs the same instruction, so the
// opcode switch does not diverge. Registers hold 64 bits each (integers
// sign-extended, bool 0/1, float32 bits in the low half, float64 bits);
// narrow columns widen on load. Each thread runs K24_ROWS rows, so one
// decode of an instruction serves them all. The register file lives in
// shared memory, register j of row slot k of thread t at
// [(j * K24_ROWS + k) * K24_THREADS + t] (a warp touches 256 consecutive
// bytes, no bank conflict), sized to the chunk's own register count: a
// thread-local array indexed by the program's register numbers sits in
// local memory and spills to L2 (the first version did: Q6's predicate
// took 3.56 ms against a bound of 0.25 ms on the H100). Float arithmetic uses the _rn intrinsics,
// so nvcc never contracts a multiply and an add into an FMA (torch runs
// them as separate kernels), and division is the IEEE quotient, as torch's
// division by a tensor on the card is. Integer floor division and
// remainder follow torch's (the sign of the divisor), float remainder and
// floor division follow torch's fmod-based formulas, min/max propagate
// NaN, and float-to-integer casts are the same static_casts torch compiles.
#include "ob_common.cuh"

#define K24_MAX_INS 160
#define K24_MAX_REGS 32
#define K24_MAX_IN 32
#define K24_MAX_OUT 32
#define K24_THREADS 128
#define K24_ROWS 4

// opcodes: oceanbase_tpu_torch/expr/program.py must match
enum {
  K24_LOAD, K24_PARAM, K24_CONST, K24_LUT, K24_CAST, K24_ADD, K24_SUB,
  K24_MUL, K24_DIV, K24_FLOORDIV, K24_MOD, K24_EQ, K24_NE, K24_LT, K24_LE,
  K24_GT, K24_GE, K24_AND, K24_OR, K24_NOT, K24_NEG, K24_ABS, K24_MIN,
  K24_MAX, K24_ROUND, K24_SELECT, K24_STORE
};

struct K24Ins {
  unsigned char op, t, dst, a, b, c, t2, pad;
  long long imm;
};

struct K24Prog {
  long long n;
  const long long* qrow;
  const void* in[K24_MAX_IN];
  void* out[K24_MAX_OUT];
  int n_ins;
  int nregs;  // registers the chunk uses (its shared register file)
  K24Ins ins[K24_MAX_INS];
};

__device__ __forceinline__ float k24_f(long long r) {
  return __int_as_float((int)r);
}
__device__ __forceinline__ long long k24_pf(float f) {
  return (long long)(unsigned)__float_as_int(f);
}
__device__ __forceinline__ double k24_d(long long r) {
  return __longlong_as_double(r);
}
__device__ __forceinline__ long long k24_pd(double d) {
  return __double_as_longlong(d);
}

// An integer result truncated to type t, in register form.
__device__ __forceinline__ long long k24_wrap(int t, unsigned long long x) {
  switch (t) {
    case OB_BOOL: return x != 0;
    case OB_I8: return (signed char)x;
    case OB_U8: return (unsigned char)x;
    case OB_I16: return (short)x;
    case OB_I32: return (int)x;
    default: return (long long)x;
  }
}

__device__ __forceinline__ long long k24_load(const void* p, int t,
                                              long long i) {
  switch (t) {
    case OB_BOOL: return ((const unsigned char*)p)[i] != 0;
    case OB_I8: return ((const signed char*)p)[i];
    case OB_U8: return ((const unsigned char*)p)[i];
    case OB_I16: return ((const short*)p)[i];
    case OB_I32: return ((const int*)p)[i];
    case OB_F32: return (long long)((const unsigned*)p)[i];
    default: return ((const long long*)p)[i];
  }
}

__device__ __forceinline__ void k24_store(void* p, int t, long long i,
                                          long long v) {
  switch (t) {
    case OB_BOOL: ((unsigned char*)p)[i] = v != 0; break;
    case OB_I8: case OB_U8: ((unsigned char*)p)[i] = (unsigned char)v; break;
    case OB_I16: ((short*)p)[i] = (short)v; break;
    case OB_I32: case OB_F32: ((int*)p)[i] = (int)v; break;
    default: ((long long*)p)[i] = v; break;
  }
}

template <typename F>
__device__ __forceinline__ long long k24_f2i(F x, int to) {
  switch (to) {
    case OB_BOOL: return x != (F)0;
    case OB_I8: return (signed char)x;
    case OB_U8: return (unsigned char)x;
    case OB_I16: return (short)x;
    case OB_I32: return (int)x;
    default: return (long long)x;
  }
}

__device__ __forceinline__ long long k24_cast(long long x, int from, int to) {
  if (from == to) return x;
  if (from == OB_F32) {
    float f = k24_f(x);
    if (to == OB_F64) return k24_pd((double)f);
    return k24_f2i(f, to);
  }
  if (from == OB_F64) {
    double d = k24_d(x);
    if (to == OB_F32) return k24_pf(__double2float_rn(d));
    return k24_f2i(d, to);
  }
  if (to == OB_F32) return k24_pf(__ll2float_rn(x));
  if (to == OB_F64) return k24_pd(__ll2double_rn(x));
  return k24_wrap(to, (unsigned long long)x);
}

// torch's div_floor_floating (c10/util/generic_math.h)
template <typename F>
__device__ __forceinline__ F k24_floordiv_f(F a, F b) {
  if (b == (F)0) return a / b;
  F mod = fmod(a, b);
  F div = (a - mod) / b;
  if ((mod != (F)0) && ((b < (F)0) != (mod < (F)0))) div -= (F)1;
  F fl;
  if (div != (F)0) {
    fl = floor(div);
    if (div - fl > (F)0.5) fl += (F)1;
  } else {
    fl = copysign((F)0, a / b);
  }
  return fl;
}

template <typename F>
__device__ __forceinline__ F k24_mod_f(F a, F b) {
  F mod = fmod(a, b);
  if ((mod != (F)0) && ((b < (F)0) != (mod < (F)0))) mod += b;
  return mod;
}

template <typename F>
__device__ __forceinline__ F k24_min_f(F a, F b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

template <typename F>
__device__ __forceinline__ F k24_max_f(F a, F b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ long long k24_arith(int op, int t, long long a,
                                               long long b) {
  if (t == OB_F32) {
    float x = k24_f(a), y = k24_f(b), r;
    switch (op) {
      case K24_ADD: r = __fadd_rn(x, y); break;
      case K24_SUB: r = __fsub_rn(x, y); break;
      case K24_MUL: r = __fmul_rn(x, y); break;
      case K24_DIV: r = __fdiv_rn(x, y); break;
      case K24_FLOORDIV: r = k24_floordiv_f(x, y); break;
      case K24_MOD: r = k24_mod_f(x, y); break;
      case K24_MIN: r = k24_min_f(x, y); break;
      default: r = k24_max_f(x, y); break;
    }
    return k24_pf(r);
  }
  if (t == OB_F64) {
    double x = k24_d(a), y = k24_d(b), r;
    switch (op) {
      case K24_ADD: r = __dadd_rn(x, y); break;
      case K24_SUB: r = __dsub_rn(x, y); break;
      case K24_MUL: r = __dmul_rn(x, y); break;
      case K24_DIV: r = __ddiv_rn(x, y); break;
      case K24_FLOORDIV: r = k24_floordiv_f(x, y); break;
      case K24_MOD: r = k24_mod_f(x, y); break;
      case K24_MIN: r = k24_min_f(x, y); break;
      default: r = k24_max_f(x, y); break;
    }
    return k24_pd(r);
  }
  unsigned long long ua = (unsigned long long)a, ub = (unsigned long long)b;
  switch (op) {
    case K24_ADD: return k24_wrap(t, ua + ub);
    case K24_SUB: return k24_wrap(t, ua - ub);
    case K24_MUL: return k24_wrap(t, ua * ub);
    case K24_FLOORDIV: {
      if (b == 0) return 0;
      if (b == -1) return k24_wrap(t, 0ull - ua);
      long long q = a / b, r = a % b;
      if (r != 0 && ((r < 0) != (b < 0))) q -= 1;
      return k24_wrap(t, (unsigned long long)q);
    }
    case K24_MOD: {
      if (b == 0 || b == -1) return 0;
      long long r = a % b;
      if (r != 0 && ((r < 0) != (b < 0))) r += b;
      return k24_wrap(t, (unsigned long long)r);
    }
    case K24_MIN: return a < b ? a : b;
    case K24_MAX: return a > b ? a : b;
    case K24_AND: return k24_wrap(t, ua & ub);
    case K24_OR: return k24_wrap(t, ua | ub);
    default: {  // K24_DIV of integers never reaches here: it computes in float
      return 0;
    }
  }
}

__device__ __forceinline__ bool k24_cmp(int op, int t, long long a,
                                        long long b) {
  if (t == OB_F32 || t == OB_F64) {
    double x = t == OB_F32 ? (double)k24_f(a) : k24_d(a);
    double y = t == OB_F32 ? (double)k24_f(b) : k24_d(b);
    switch (op) {
      case K24_EQ: return x == y;
      case K24_NE: return x != y;
      case K24_LT: return x < y;
      case K24_LE: return x <= y;
      case K24_GT: return x > y;
      default: return x >= y;
    }
  }
  switch (op) {
    case K24_EQ: return a == b;
    case K24_NE: return a != b;
    case K24_LT: return a < b;
    case K24_LE: return a <= b;
    case K24_GT: return a > b;
    default: return a >= b;
  }
}

__device__ __forceinline__ long long k24_unary(int op, int t, long long a) {
  switch (op) {
    case K24_NOT:
      return t == OB_BOOL ? (long long)(a == 0)
                          : k24_wrap(t, ~(unsigned long long)a);
    case K24_NEG:
      return t == OB_F32   ? k24_pf(-k24_f(a))
             : t == OB_F64 ? k24_pd(-k24_d(a))
                           : k24_wrap(t, 0ull - (unsigned long long)a);
    case K24_ABS:
      return t == OB_F32   ? k24_pf(fabsf(k24_f(a)))
             : t == OB_F64 ? k24_pd(fabs(k24_d(a)))
             : (t == OB_BOOL || t == OB_U8 || a >= 0)
                 ? a
                 : k24_wrap(t, 0ull - (unsigned long long)a);
    default:  // K24_ROUND
      return t == OB_F32   ? k24_pf(rintf(k24_f(a)))
             : t == OB_F64 ? k24_pd(rint(k24_d(a)))
                           : a;
  }
}

// Each thread runs K24_ROWS rows of a tile (row base + k * K24_THREADS +
// thread, so every load and store of a warp is contiguous): one decode of
// an instruction serves K24_ROWS rows. The loops are instantiated per
// opcode and per dtype (the helpers above fold to a few instructions when
// their op and dtype arguments are constants), so a row pays no dispatch;
// the rare narrow dtypes (int8, int16, uint8) share one loop that
// dispatches on the dtype per row.
#define R(j, k) r0[((int)(j) * K24_ROWS + (k)) * K24_THREADS]
// (a loop of constant trip count: nvcc unrolls it)
#define K24_EACH(stmt) \
  for (int k = 0; k < K24_ROWS; ++k) { stmt; }
// BODY once per common dtype as the constant T, once for the rest with T
// the runtime dtype
#define K24_BY_TYPE(tv, BODY)                                  \
  switch (tv) {                                                \
    case OB_BOOL: { constexpr int T = OB_BOOL; BODY; } break;  \
    case OB_I32: { constexpr int T = OB_I32; BODY; } break;    \
    case OB_I64: { constexpr int T = OB_I64; BODY; } break;    \
    case OB_F32: { constexpr int T = OB_F32; BODY; } break;    \
    case OB_F64: { constexpr int T = OB_F64; BODY; } break;    \
    default: { const int T = (tv); BODY; } break;              \
  }
#define K24_BY_SRC(tv, BODY)                                    \
  switch (tv) {                                                 \
    case OB_BOOL: { constexpr int T2 = OB_BOOL; BODY; } break;  \
    case OB_I32: { constexpr int T2 = OB_I32; BODY; } break;    \
    case OB_I64: { constexpr int T2 = OB_I64; BODY; } break;    \
    case OB_F32: { constexpr int T2 = OB_F32; BODY; } break;    \
    case OB_F64: { constexpr int T2 = OB_F64; BODY; } break;    \
    default: { const int T2 = (tv); BODY; } break;              \
  }
#define K24_ROW const long long i = i0 + (long long)k * K24_THREADS
#define K24_BIN(OPV)                                                    \
  case OPV:                                                             \
    K24_BY_TYPE(t, K24_EACH(R(in.dst, k) =                              \
                                k24_arith(OPV, T, R(in.a, k), R(in.b, k)))) \
    break;
#define K24_CMP(OPV)                                                    \
  case OPV:                                                             \
    K24_BY_TYPE(t, K24_EACH(R(in.dst, k) =                              \
                                k24_cmp(OPV, T, R(in.a, k), R(in.b, k)))) \
    break;
#define K24_UN(OPV)                                                     \
  case OPV:                                                             \
    K24_BY_TYPE(t, K24_EACH(R(in.dst, k) = k24_unary(OPV, T, R(in.a, k)))) \
    break;

__global__ void __launch_bounds__(K24_THREADS)
k24_fused(const __grid_constant__ K24Prog p) {
  extern __shared__ long long k24_file[];
  long long* const r0 = k24_file + threadIdx.x;
  const long long tile = (long long)K24_THREADS * K24_ROWS;
  for (long long base = (long long)blockIdx.x * tile; base < p.n;
       base += (long long)gridDim.x * tile) {
    const long long i0 = base + threadIdx.x;
    for (int pc = 0; pc < p.n_ins; ++pc) {
      const K24Ins in = p.ins[pc];
      const int t = in.t;
      switch (in.op) {
        case K24_LOAD: {
          const void* src = p.in[in.imm];
          K24_BY_TYPE(t, K24_EACH(K24_ROW;
                                  R(in.dst, k) =
                                      i < p.n ? k24_load(src, T, i) : 0))
          break;
        }
        case K24_PARAM: {
          long long raw = p.qrow[in.imm], v;
          if (t == OB_F64) v = raw;
          else if (t == OB_F32) v = k24_pf(__double2float_rn(k24_d(raw)));
          else v = k24_wrap(t, (unsigned long long)raw);
          K24_EACH(R(in.dst, k) = v)
          break;
        }
        case K24_CONST:
          K24_EACH(R(in.dst, k) = in.imm)
          break;
        case K24_LUT: {
          const void* lut = p.in[in.imm];
          K24_BY_TYPE(t, K24_EACH(K24_ROW;
                                  R(in.dst, k) = i < p.n
                                      ? k24_load(lut, T, R(in.a, k)) : 0))
          break;
        }
        case K24_CAST:
          K24_BY_SRC(in.t2, K24_BY_TYPE(t, K24_EACH(
              R(in.dst, k) = k24_cast(R(in.a, k), T2, T))))
          break;
        K24_CMP(K24_EQ)
        K24_CMP(K24_NE)
        K24_CMP(K24_LT)
        K24_CMP(K24_LE)
        K24_CMP(K24_GT)
        K24_CMP(K24_GE)
        K24_UN(K24_NOT)
        K24_UN(K24_NEG)
        K24_UN(K24_ABS)
        K24_UN(K24_ROUND)
        case K24_SELECT:
          K24_EACH(R(in.dst, k) = R(in.a, k) ? R(in.b, k) : R(in.c, k))
          break;
        case K24_STORE: {
          void* dst = p.out[in.imm];
          K24_BY_TYPE(t, K24_EACH(K24_ROW;
                                  if (i < p.n) k24_store(dst, T, i,
                                                         R(in.a, k))))
          break;
        }
        K24_BIN(K24_ADD)
        K24_BIN(K24_SUB)
        K24_BIN(K24_MUL)
        K24_BIN(K24_DIV)
        K24_BIN(K24_FLOORDIV)
        K24_BIN(K24_MOD)
        K24_BIN(K24_AND)
        K24_BIN(K24_OR)
        K24_BIN(K24_MIN)
        K24_BIN(K24_MAX)
        default:
          break;
      }
    }
  }
}
#undef K24_BIN
#undef K24_CMP
#undef K24_UN
#undef K24_ROW
#undef K24_BY_SRC
#undef K24_BY_TYPE
#undef K24_EACH
#undef R

// prog: a host K24Prog (kernels.py packs it); blocks: the grid size.
extern "C" int ob_k24_run(const void* prog, int blocks, void* stream) {
  static bool sized = false;
  K24Prog p;
  memcpy(&p, prog, sizeof(K24Prog));
  if (p.n <= 0) return 0;
  if (p.nregs < 1 || p.nregs > K24_MAX_REGS) return (int)cudaErrorInvalidValue;
  if (!sized) {
    // the largest register file (32 registers) is 128 KB, past the
    // default 48 KB of dynamic shared memory
    cudaError_t e = cudaFuncSetAttribute(
        k24_fused, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K24_MAX_REGS * K24_ROWS * K24_THREADS * (int)sizeof(long long));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  size_t smem = (size_t)p.nregs * K24_ROWS * K24_THREADS * sizeof(long long);
  k24_fused<<<blocks, K24_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int ob_k24_prog_bytes() { return (int)sizeof(K24Prog); }

// rows of one block's tile: the grid size's unit
extern "C" int ob_k24_tile_rows() { return K24_THREADS * K24_ROWS; }
