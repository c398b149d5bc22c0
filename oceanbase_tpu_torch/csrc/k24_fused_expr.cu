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
// Design: the program is the kernel's parameter (by value,
// __grid_constant__, so it stays in the constant bank): every thread of a
// warp runs the same instruction, so no switch on an opcode or a dtype
// diverges. A chunk is two codes:
// - the uniform prologue: parameters, constants and every instruction
//   whose operands are all uniform (the lowering marks them), computed
//   once per block (the parameters and constants a thread each, the rest
//   by one thread in order) into a small shared array U, in the 64-bit
//   register form (integers sign-extended, bool 0/1, float32 bits
//   in the low half, float64 bits). A row instruction's operand may name a
//   slot of U, so a compare with a literal reads one row value.
// - the row code, over R adjacent rows a thread (8, or 4 where the
//   chunk's file is large): one decode of an instruction serves all of a
//   thread's rows, and the loop bodies are instantiated per opcode and per
//   common dtype. Row values live in a shared-memory file of two classes:
//   values of 32 bits or fewer in 32-bit slots (integers sign-extended,
//   uint8 zero-extended, bool 0/1, float32 bits), int64 and float64 in
//   64-bit ones, slot j of row k of thread t at [(j * R + k) * threads +
//   t], so a warp's access is 32 consecutive words. An operand that names
//   a uniform slot is read through the same loads with a stride of 0, so
//   a body's loads issue back to back with no branch between them. The
//   row code starts with its LOADs, and a LOAD or STORE of a 32- or 64-bit
//   column moves 16 bytes a thread per vector (8 bool rows in one 8-byte
//   load).
// The first design kept every value of every row in a 64-bit
// slot of the file, parameters and constants included, 4 rows a thread
// strided by the block (0.97 ms at Q6's predicate, 4.33 at Q19's, against
// bounds of 0.25 and 0.32 on the H100). Measured with bench_k24.py and
// not kept: a window of thread registers addressed by switches on
// the register number (2.0-5.0 ms at Q6's predicate); values read only by
// the next instruction forwarded in a register, with a branch per operand
// to find it (7% at Q6's predicate, but the statements' programs slower
// than the parent's); the file in 16-byte chunks a thread, the leading
// LOADs staged in registers or issued with cp.async, the next instruction
// word read ahead, an operand fetch shared by every opcode (1.07-2.22 ms):
// each cost registers, and with them the warps that hide the
// interpreter's latency.
//
// Float arithmetic uses the _rn intrinsics, so nvcc never contracts a
// multiply and an add into an FMA (torch runs them as separate kernels),
// and division is the IEEE quotient, as torch's division by a tensor on
// the card is. Integer floor division and remainder follow torch's (the
// sign of the divisor), float remainder and floor division follow
// torch's fmod-based formulas, min/max propagate NaN, and float-to-integer
// casts are the same static_casts torch compiles.
#include "ob_common.cuh"

#define K24_MAX_INS 160
#define K24_MAX_IN 32
#define K24_MAX_OUT 32
#define K24_MAX_UNI 64
#define K24_FILE 32  // slots of each class (expr/program.py MAX_REGS)
// file bytes a row up to which a thread runs 8 rows, past which 4
// (expr/program.py FILE8_BYTES)
#define K24_FILE8_BYTES 96
#define K24_THREADS 128
// blocks an SM must hold: caps a thread at 128 registers (bench_k24.py on
// the H100: 3 blocks 1.57 ms at Q6's predicate, 4 0.97, 5 1.43)
#define K24_MINB 4
#define K24_UNI 0x80  // an operand naming a uniform slot
#define K24_BLOCKS_PER_SM 16

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

// ins[0, n_uni) is the uniform prologue, ins[n_uni, n_ins) the row code;
// n32 / n64 the file's slots of each class; rows: 8 or 4 rows a thread
struct K24Prog {
  long long n;
  const long long* qrow;
  const void* in[K24_MAX_IN];
  void* out[K24_MAX_OUT];
  int n_ins, n_uni, n32, n64, rows, pad;
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

// ---- the uniform prologue -------------------------------------------------

__device__ long long k24_uniform(const K24Prog& p, const K24Ins& in,
                                 const long long* U) {
  const int t = in.t;
  const long long a = U[in.a & 0x7f], b = U[in.b & 0x7f];
  switch (in.op) {
    case K24_PARAM: {
      const long long raw = p.qrow[in.imm];
      if (t == OB_F64) return raw;
      if (t == OB_F32) return k24_pf(__double2float_rn(k24_d(raw)));
      return k24_wrap(t, (unsigned long long)raw);
    }
    case K24_CONST: return in.imm;
    case K24_LUT: return k24_load(p.in[in.imm], t, a);
    case K24_CAST: return k24_cast(a, in.t2, t);
    case K24_SELECT: return a ? b : U[in.c & 0x7f];
    case K24_EQ: case K24_NE: case K24_LT: case K24_LE: case K24_GT:
    case K24_GE:
      return k24_cmp(in.op, t, a, b);
    case K24_NOT: case K24_NEG: case K24_ABS: case K24_ROUND:
      return k24_unary(in.op, t, a);
    default: return k24_arith(in.op, t, a, b);
  }
}

// The block's uniform values: the parameters and constants a thread each,
// at once, then the instructions over them by one thread in order; every
// thread reads them.
__device__ __forceinline__ void k24_prologue(const K24Prog& p, long long* U) {
  const int t = threadIdx.x;
  if (t < p.n_uni) {
    const K24Ins in = p.ins[t];
    if (in.op == K24_PARAM || in.op == K24_CONST) {
      U[in.dst] = k24_uniform(p, in, U);
    }
  }
  __syncthreads();
  if (t == 0) {
    for (int pc = 0; pc < p.n_uni; ++pc) {
      const K24Ins in = p.ins[pc];
      if (in.op != K24_PARAM && in.op != K24_CONST) {
        U[in.dst] = k24_uniform(p, in, U);
      }
    }
  }
  __syncthreads();
}

// ---- row values of the 32-bit class ----------------------------------------

__device__ __forceinline__ bool k24_wide(int t) {
  return t == OB_I64 || t == OB_F64;
}

// A 32-bit value in the 64-bit register form.
__device__ __forceinline__ long long k24_up(int t, unsigned x) {
  return t == OB_F32 ? (long long)x : (long long)(int)x;
}

__device__ __forceinline__ unsigned k24_bin32(int op, int t, unsigned a,
                                              unsigned b) {
  if (t == OB_F32) return (unsigned)k24_arith(op, t, a, b);
  if (t == OB_I32) {
    const int x = (int)a, y = (int)b;
    switch (op) {
      case K24_ADD: return a + b;
      case K24_SUB: return a - b;
      case K24_MUL: return a * b;
      case K24_AND: return a & b;
      case K24_OR: return a | b;
      case K24_MIN: return x < y ? a : b;
      case K24_MAX: return x > y ? a : b;
      // k24_arith's rules in 32 bits (a 64-bit division costs several
      // times a 32-bit one); -1 as k24_arith takes it, where x / y traps
      case K24_FLOORDIV: {
        if (y == 0) return 0u;
        if (y == -1) return 0u - a;
        int q = x / y;
        const int r = x % y;
        if (r != 0 && ((r < 0) != (y < 0))) q -= 1;
        return (unsigned)q;
      }
      case K24_MOD: {
        if (y == 0 || y == -1) return 0u;
        int r = x % y;
        if (r != 0 && ((r < 0) != (y < 0))) r += y;
        return (unsigned)r;
      }
      default: break;
    }
  } else if (t == OB_BOOL) {
    switch (op) {
      case K24_AND: case K24_MIN: return a & b;
      case K24_OR: case K24_MAX: return a | b;
      default: break;
    }
  }
  return (unsigned)k24_arith(op, t, k24_up(t, a), k24_up(t, b));
}

__device__ __forceinline__ unsigned k24_cmp32(int op, int t, unsigned a,
                                              unsigned b) {
  if (t == OB_F32) {
    const float x = __uint_as_float(a), y = __uint_as_float(b);
    switch (op) {
      case K24_EQ: return x == y;
      case K24_NE: return x != y;
      case K24_LT: return x < y;
      case K24_LE: return x <= y;
      case K24_GT: return x > y;
      default: return x >= y;
    }
  }
  const int x = (int)a, y = (int)b;
  switch (op) {
    case K24_EQ: return x == y;
    case K24_NE: return x != y;
    case K24_LT: return x < y;
    case K24_LE: return x <= y;
    case K24_GT: return x > y;
    default: return x >= y;
  }
}

#define K24_EACH(stmt) \
  _Pragma("unroll") for (int k = 0; k < R; ++k) { stmt; }

// ---- vector loads and stores of a thread's R adjacent rows ----------------
// (bool, int32 and float32 in the 32-bit class, int64 and float64 in the
// 64-bit class; the rare int8, uint8 and int16 go row by row)

template <int R, int T>
__device__ __forceinline__ void k24_vload32(const void* p, long long i0,
                                            long long n, unsigned (&v)[R]) {
  constexpr int S = (T == OB_I32 || T == OB_F32) ? 4 : 1;
  constexpr int B = R * S;  // bytes a thread
  constexpr int A = B < 16 ? B : 16;
  const unsigned char* at = (const unsigned char*)p + i0 * S;
  if (i0 + R <= n && (reinterpret_cast<uintptr_t>(at) & (A - 1)) == 0) {
    unsigned w[B / 4];
    if constexpr (B >= 16) {
#pragma unroll
      for (int q = 0; q < B / 16; ++q) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(at) + q);
        w[4 * q] = x.x;
        w[4 * q + 1] = x.y;
        w[4 * q + 2] = x.z;
        w[4 * q + 3] = x.w;
      }
    } else if constexpr (B == 8) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(at));
      w[0] = x.x;
      w[1] = x.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(at));
    }
    if constexpr (S == 4) {
      K24_EACH(v[k] = w[k])
    } else {
      K24_EACH(v[k] = ((w[k >> 2] >> ((k & 3) * 8)) & 0xffu) != 0u)
    }
  } else {
    K24_EACH(v[k] = i0 + k < n ? (unsigned)k24_load(p, T, i0 + k) : 0u)
  }
}

template <int R>
__device__ __forceinline__ void k24_vload64(const void* p, long long i0,
                                            long long n,
                                            unsigned long long (&v)[R]) {
  const unsigned long long* at = (const unsigned long long*)p + i0;
  if (i0 + R <= n && (reinterpret_cast<uintptr_t>(at) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const ulonglong2 x = __ldg(reinterpret_cast<const ulonglong2*>(at) + q);
      v[2 * q] = x.x;
      v[2 * q + 1] = x.y;
    }
  } else {
    K24_EACH(v[k] = i0 + k < n ? (unsigned long long)__ldg(at + k) : 0ull)
  }
}

template <int R, int T>
__device__ __forceinline__ void k24_vstore32(void* p, long long i0,
                                             long long n,
                                             const unsigned (&v)[R]) {
  constexpr int S = (T == OB_I32 || T == OB_F32) ? 4 : 1;
  constexpr int B = R * S;
  constexpr int A = B < 16 ? B : 16;
  unsigned char* at = (unsigned char*)p + i0 * S;
  if (i0 + R <= n && (reinterpret_cast<uintptr_t>(at) & (A - 1)) == 0) {
    unsigned w[B / 4];
    if constexpr (S == 4) {
      K24_EACH(w[k] = v[k])
    } else {
#pragma unroll
      for (int q = 0; q < B / 4; ++q) w[q] = 0u;
      K24_EACH(w[k >> 2] |= (v[k] != 0u ? 1u : 0u) << ((k & 3) * 8))
    }
    if constexpr (B >= 16) {
#pragma unroll
      for (int q = 0; q < B / 16; ++q) {
        reinterpret_cast<uint4*>(at)[q] =
            make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
      }
    } else if constexpr (B == 8) {
      *reinterpret_cast<uint2*>(at) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned*>(at) = w[0];
    }
  } else {
    K24_EACH(if (i0 + k < n) k24_store(p, T, i0 + k, k24_up(T, v[k])))
  }
}

template <int R>
__device__ __forceinline__ void k24_vstore64(void* p, long long i0,
                                             long long n,
                                             const unsigned long long (&v)[R]) {
  unsigned long long* at = (unsigned long long*)p + i0;
  if (i0 + R <= n && (reinterpret_cast<uintptr_t>(at) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      reinterpret_cast<ulonglong2*>(at)[q] = make_ulonglong2(v[2 * q],
                                                             v[2 * q + 1]);
    }
  } else {
    K24_EACH(if (i0 + k < n) at[k] = v[k])
  }
}

// ---- the shared file and the accumulators --------------------------------
// Slot j of row k of thread t at [(j * R + k) * threads + t] of its class's
// array: a warp reads or writes 32 consecutive words, no bank conflict.
template <int R>
struct K24File {
  unsigned* s32;  // this thread's row 0 of slot 0, each class
  unsigned long long* s64;
  const long long* U;

  // operand x: a slot of the file, or a uniform slot read on every row
  // (its address with a stride of 0), no branch between the loads
  __device__ __forceinline__ void get32(int x, unsigned (&v)[R]) const {
    const bool u = x & K24_UNI;
    const unsigned* at = u ? reinterpret_cast<const unsigned*>(U + (x & 0x7f))
                           : s32 + x * R * K24_THREADS;
    const int step = u ? 0 : K24_THREADS;
    K24_EACH(v[k] = at[k * step])
  }
  __device__ __forceinline__ void put32(int d, const unsigned (&v)[R]) {
    K24_EACH(s32[(d * R + k) * K24_THREADS] = v[k])
  }
  __device__ __forceinline__ void get64(int x,
                                        unsigned long long (&v)[R]) const {
    const bool u = x & K24_UNI;
    const unsigned long long* at =
        u ? reinterpret_cast<const unsigned long long*>(U + (x & 0x7f))
          : s64 + x * R * K24_THREADS;
    const int step = u ? 0 : K24_THREADS;
    K24_EACH(v[k] = at[k * step])
  }
  __device__ __forceinline__ void put64(int d,
                                        const unsigned long long (&v)[R]) {
    K24_EACH(s64[(d * R + k) * K24_THREADS] = v[k])
  }
};

// A column's R rows of this thread into slot d, 16 bytes a load where the
// rows are whole and aligned.
template <int R>
__device__ __forceinline__ void k24_load_into(K24File<R>& f, const void* src,
                                              int t, int d, long long i0,
                                              long long n) {
  unsigned w[R];
  switch (t) {
    case OB_BOOL: k24_vload32<R, OB_BOOL>(src, i0, n, w); break;
    case OB_I32: k24_vload32<R, OB_I32>(src, i0, n, w); break;
    case OB_F32: k24_vload32<R, OB_F32>(src, i0, n, w); break;
    case OB_I64: case OB_F64: {
      unsigned long long v[R];
      k24_vload64<R>(src, i0, n, v);
      f.put64(d, v);
      return;
    }
    default:
      K24_EACH(w[k] = i0 + k < n ? (unsigned)k24_load(src, t, i0 + k) : 0u)
      break;
  }
  f.put32(d, w);
}

// ---- the row code ----------------------------------------------------------

// BODY with T the instruction's dtype: a constant for the common ones, the
// runtime dtype for int8, uint8 and int16 (32-bit class)
#define K24_T32(tv, BODY)                                      \
  switch (tv) {                                                \
    case OB_BOOL: { constexpr int T = OB_BOOL; BODY; } break;  \
    case OB_I32: { constexpr int T = OB_I32; BODY; } break;    \
    case OB_F32: { constexpr int T = OB_F32; BODY; } break;    \
    default: { const int T = (tv); BODY; } break;              \
  }
#define K24_T64(tv, BODY)                                      \
  switch (tv) {                                                \
    case OB_I64: { constexpr int T = OB_I64; BODY; } break;    \
    default: { constexpr int T = OB_F64; BODY; } break;        \
  }
// B32 / B64 (each in parentheses): the body of a 32-bit and of a 64-bit
// dtype
#define K24_ID(...) __VA_ARGS__
#define K24_BYCLS(tv, B32, B64) \
  if (k24_wide(tv)) {           \
    K24_T64(tv, K24_ID B64)     \
  } else {                      \
    K24_T32(tv, K24_ID B32)     \
  }
#define K24_G32(x, v) f.get32((x), v)
#define K24_G64(x, v) f.get64((x), v)
#define K24_BIN(OPV, BY)                                                 \
  case OPV:                                                              \
    BY(t,                                                                \
      (unsigned x[R], y[R]; K24_G32(in.a, x); K24_G32(in.b, y);          \
       K24_EACH(x[k] = k24_bin32(OPV, T, x[k], y[k])); f.put32(in.dst, x)), \
      (unsigned long long x[R], y[R]; K24_G64(in.a, x); K24_G64(in.b, y); \
       K24_EACH(x[k] = (unsigned long long)k24_arith(OPV, T, (long long)x[k], \
                                                     (long long)y[k]));  \
       f.put64(in.dst, x)))                                              \
    break;
#define K24_CMP(OPV)                                                     \
  case OPV:                                                              \
    K24_BYCLS(t,                                                         \
      (unsigned x[R], y[R]; K24_G32(in.a, x); K24_G32(in.b, y);          \
       K24_EACH(x[k] = k24_cmp32(OPV, T, x[k], y[k])); f.put32(in.dst, x)), \
      (unsigned long long x[R], y[R]; unsigned z[R]; K24_G64(in.a, x);   \
       K24_G64(in.b, y);                                                 \
       K24_EACH(z[k] = k24_cmp(OPV, T, (long long)x[k], (long long)y[k])); \
       f.put32(in.dst, z)))                                              \
    break;
#define K24_UN(OPV)                                                      \
  case OPV:                                                              \
    K24_BYCLS(t,                                                         \
      (unsigned x[R]; K24_G32(in.a, x);                                  \
       K24_EACH(x[k] = (unsigned)k24_unary(OPV, T, k24_up(T, x[k])));    \
       f.put32(in.dst, x)),                                              \
      (unsigned long long x[R]; K24_G64(in.a, x);                        \
       K24_EACH(x[k] = (unsigned long long)k24_unary(OPV, T,             \
                                                     (long long)x[k]));  \
       f.put64(in.dst, x)))                                              \
    break;

// One tile: the row code over this thread's rows i0 .. i0 + R - 1.
template <int R>
__device__ __forceinline__ void k24_rows(const K24Prog& p, K24File<R>& f,
                                         const long long* U, long long i0) {
  const long long n = p.n;
  for (int pc = p.n_uni; pc < p.n_ins; ++pc) {
    const K24Ins in = p.ins[pc];
    const int t = in.t;
    switch (in.op) {
      case K24_LOAD:
        k24_load_into<R>(f, p.in[in.imm], t, in.dst, i0, n);
        break;
      case K24_LUT: {
        const void* lut = p.in[in.imm];
        unsigned long long x[R];
        K24_G64(in.a, x);
        K24_BYCLS(t,
          (unsigned z[R];
           K24_EACH(z[k] = i0 + k < n ? (unsigned)k24_load(lut, T,
                                                           (long long)x[k])
                                      : 0u);
           f.put32(in.dst, z)),
          (K24_EACH(x[k] = i0 + k < n ? (unsigned long long)k24_load(
                                            lut, T, (long long)x[k])
                                      : 0ull);
           f.put64(in.dst, x)))
        break;
      }
      case K24_CAST: {
        // the main path's casts (int32 -> int64, int64 / int32 ->
        // float64) compiled for their dtypes, the rest with the dtypes read
        // at run time
        const int t2 = in.t2;
        if (k24_wide(t2)) {
          unsigned long long x[R];
          K24_G64(in.a, x);
          if (t2 == OB_I64 && t == OB_F64) {
            K24_EACH(x[k] = (unsigned long long)k24_cast((long long)x[k],
                                                         OB_I64, OB_F64))
            f.put64(in.dst, x);
          } else if (k24_wide(t)) {
            K24_EACH(x[k] = (unsigned long long)k24_cast((long long)x[k], t2,
                                                         t))
            f.put64(in.dst, x);
          } else {
            unsigned z[R];
            K24_EACH(z[k] = (unsigned)k24_cast((long long)x[k], t2, t))
            f.put32(in.dst, z);
          }
        } else {
          unsigned x[R];
          K24_G32(in.a, x);
          if (k24_wide(t)) {
            unsigned long long z[R];
            if (t2 == OB_I32 && t == OB_I64) {
              K24_EACH(z[k] = (unsigned long long)(long long)(int)x[k])
            } else if (t2 == OB_I32 && t == OB_F64) {
              K24_EACH(z[k] = (unsigned long long)k24_cast(
                           (long long)(int)x[k], OB_I32, OB_F64))
            } else {
              K24_EACH(z[k] = (unsigned long long)k24_cast(k24_up(t2, x[k]),
                                                           t2, t))
            }
            f.put64(in.dst, z);
          } else {
            K24_EACH(x[k] = (unsigned)k24_cast(k24_up(t2, x[k]), t2, t))
            f.put32(in.dst, x);
          }
        }
        break;
      }
      case K24_SELECT: {
        unsigned c[R];
        K24_G32(in.a, c);
        if (k24_wide(t)) {
          unsigned long long x[R], y[R];
          K24_G64(in.b, x);
          K24_G64(in.c, y);
          K24_EACH(x[k] = c[k] ? x[k] : y[k])
          f.put64(in.dst, x);
        } else {
          unsigned x[R], y[R];
          K24_G32(in.b, x);
          K24_G32(in.c, y);
          K24_EACH(x[k] = c[k] ? x[k] : y[k])
          f.put32(in.dst, x);
        }
        break;
      }
      case K24_STORE: {
        void* dst = p.out[in.imm];
        if (k24_wide(t)) {
          unsigned long long x[R];
          K24_G64(in.a, x);
          k24_vstore64<R>(dst, i0, n, x);
        } else {
          unsigned x[R];
          K24_G32(in.a, x);
          switch (t) {
            case OB_BOOL: k24_vstore32<R, OB_BOOL>(dst, i0, n, x); break;
            case OB_I32: k24_vstore32<R, OB_I32>(dst, i0, n, x); break;
            case OB_F32: k24_vstore32<R, OB_F32>(dst, i0, n, x); break;
            default:
              K24_EACH(if (i0 + k < n) k24_store(dst, t, i0 + k,
                                                 k24_up(t, x[k])))
              break;
          }
        }
        break;
      }
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
      K24_BIN(K24_ADD, K24_BYCLS)
      K24_BIN(K24_SUB, K24_BYCLS)
      K24_BIN(K24_MUL, K24_BYCLS)
      K24_BIN(K24_DIV, K24_BYCLS)
      K24_BIN(K24_AND, K24_BYCLS)
      K24_BIN(K24_OR, K24_BYCLS)
      K24_BIN(K24_FLOORDIV, K24_BYCLS)
      K24_BIN(K24_MOD, K24_BYCLS)
      K24_BIN(K24_MIN, K24_BYCLS)
      K24_BIN(K24_MAX, K24_BYCLS)
      default:
        break;
    }
  }
}
#undef K24_BIN
#undef K24_CMP
#undef K24_UN
#undef K24_G32
#undef K24_G64

template <int R>
__global__ void __launch_bounds__(K24_THREADS, K24_MINB)
k24_run(const __grid_constant__ K24Prog p) {
  __shared__ long long U[K24_MAX_UNI];
  extern __shared__ unsigned long long k24_smem[];
  k24_prologue(p, U);
  K24File<R> f;
  f.s64 = k24_smem + threadIdx.x;
  f.s32 = reinterpret_cast<unsigned*>(
              k24_smem + (long long)p.n64 * R * K24_THREADS) +
          threadIdx.x;
  f.U = U;
  const long long tile = (long long)K24_THREADS * R;
  for (long long base = (long long)blockIdx.x * tile; base < p.n;
       base += (long long)gridDim.x * tile) {
    k24_rows<R>(p, f, U, base + (long long)threadIdx.x * R);
  }
}

// prog: a host K24Prog (kernels.py packs it); sms: the card's SM count.
extern "C" int ob_k24_run(const void* prog, int sms, void* stream) {
  static bool sized = false;
  K24Prog p;
  memcpy(&p, prog, sizeof(K24Prog));
  if (p.n <= 0) return 0;
  const int row_bytes = 4 * p.n32 + 8 * p.n64;
  if (p.n_uni < 0 || p.n_uni > p.n_ins || p.n_ins > K24_MAX_INS ||
      p.n32 < 0 ||
      p.n64 < 0 || p.n32 > K24_FILE || p.n64 > K24_FILE || sms < 1 ||
      (p.rows != 4 && p.rows != 8) ||
      (p.rows == 8 && row_bytes > K24_FILE8_BYTES)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!sized) {
    // the largest files: 32 slots of each class at 4 rows (192 KB), 96
    // bytes a row at 8 (96 KB), past the default 48 KB
    cudaError_t e = cudaFuncSetAttribute(
        k24_run<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K24_FILE * 12 * 4 * K24_THREADS);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(k24_run<8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K24_FILE8_BYTES * 8 * K24_THREADS);
    }
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (p.n + (long long)K24_THREADS * p.rows - 1) /
                          ((long long)K24_THREADS * p.rows);
  const long long most = (long long)sms * K24_BLOCKS_PER_SM;
  const int blocks = (int)(tiles < most ? tiles : most);
  const size_t smem = (size_t)row_bytes * p.rows * K24_THREADS;
  if (p.rows == 8) {
    k24_run<8><<<blocks, K24_THREADS, smem, s>>>(p);
  } else {
    k24_run<4><<<blocks, K24_THREADS, smem, s>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" int ob_k24_prog_bytes() { return (int)sizeof(K24Prog); }
