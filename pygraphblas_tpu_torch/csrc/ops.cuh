// Semiring ops shared by the port's CUDA kernels.
//
// Op and dtype codes match pygraphblas_tpu_torch/_kernels.py (FOLDS,
// MULS, TYPE_CODES), derived there from the ops' names.  A kernel reads
// 4-byte words: float (DT_F32), uint32_t (DT_U32), or int32_t for every
// other type of 4 bytes or less, the narrow ones widened (signed ones
// sign-extended, unsigned ones and BOOL zero-extended).  A multiply's
// result is narrowed back to its type (`narrow`), so that a fold that
// compares (MIN, MAX) sees the type's own values; a fold that wraps
// (PLUS, TIMES) or works bitwise needs no narrowing between steps: its
// low bits are the type's, and the caller keeps only those.  Integer
// division follows SuiteSparse: x / 0 is 0 for x == 0, else the type's
// max (its min for x < 0), at the type itself (INT8: 5 / 0 is 127).
//
// The float ops use the _rn intrinsics so that nvcc never contracts a
// mul and an add into one FMA: the kernels must round exactly as their
// plain PyTorch versions do.  Integer ops wrap (two's complement), as
// torch's integer arithmetic does.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

enum {
  FOLD_PLUS = 0, FOLD_MIN = 1, FOLD_MAX = 2, FOLD_TIMES = 3, FOLD_ANY = 4,
  FOLD_LOR = 5, FOLD_LAND = 6, FOLD_LXOR = 7, FOLD_LXNOR = 8, FOLD_BOR = 9,
  FOLD_BAND = 10, FOLD_BXOR = 11, FOLD_BXNOR = 12
};
enum {
  MUL_TIMES = 0, MUL_PLUS = 1, MUL_MINUS = 2, MUL_RMINUS = 3, MUL_DIV = 4,
  MUL_RDIV = 5, MUL_FIRST = 6, MUL_SECOND = 7, MUL_PAIR = 8, MUL_MIN = 9,
  MUL_MAX = 10, MUL_ISEQ = 11, MUL_ISNE = 12, MUL_ISGT = 13, MUL_ISLT = 14,
  MUL_ISGE = 15, MUL_ISLE = 16, MUL_LOR = 17, MUL_LAND = 18, MUL_LXOR = 19,
  MUL_EQ = 20, MUL_NE = 21, MUL_GT = 22, MUL_LT = 23, MUL_GE = 24,
  MUL_LE = 25, MUL_POW = 26, MUL_BOR = 27, MUL_BAND = 28, MUL_BXOR = 29,
  MUL_BXNOR = 30, MUL_BGET = 31, MUL_BSET = 32, MUL_BCLR = 33,
  MUL_BSHIFT = 34, MUL_ATAN2 = 35, MUL_HYPOT = 36, MUL_FMOD = 37,
  MUL_REMAINDER = 38, MUL_LDEXP = 39, MUL_COPYSIGN = 40
};
enum {
  DT_F32 = 0, DT_I32 = 1, DT_U32 = 2, DT_I8 = 3, DT_I16 = 4, DT_U8 = 5,
  DT_U16 = 6, DT_BOOL = 7
};

// the word type of a dtype code's launch: float, uint32_t or int32_t
#define PGB_DISPATCH_WORD(dtype, CALL)                          \
  do {                                                          \
    if ((dtype) == DT_F32) { using T = float; return CALL; }    \
    if ((dtype) == DT_U32) { using T = uint32_t; return CALL; } \
    if ((dtype) >= DT_I32 && (dtype) <= DT_BOOL) {              \
      using T = int32_t; return CALL;                           \
    }                                                           \
    return -1;                                                  \
  } while (0)

__device__ __forceinline__ float op_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float op_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float op_mul(float a, float b) { return __fmul_rn(a, b); }
// torch.minimum / torch.maximum propagate NaN
__device__ __forceinline__ float op_min(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ float op_max(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

template <typename T>
__device__ __forceinline__ T op_add(T a, T b) {
  return (T)((uint32_t)a + (uint32_t)b);
}
template <typename T>
__device__ __forceinline__ T op_sub(T a, T b) {
  return (T)((uint32_t)a - (uint32_t)b);
}
template <typename T>
__device__ __forceinline__ T op_mul(T a, T b) {
  return (T)((uint32_t)a * (uint32_t)b);
}
template <typename T>
__device__ __forceinline__ T op_min(T a, T b) { return b < a ? b : a; }
template <typename T>
__device__ __forceinline__ T op_max(T a, T b) { return b > a ? b : a; }

// the low bits of an int32 word as a value of the narrow type `nt`
__device__ __forceinline__ int32_t narrow(int32_t x, int nt) {
  if (nt <= DT_U32) return x;       // 4-byte types: nothing to cut
  switch (nt) {
    case DT_I8: return (int32_t)(int8_t)x;
    case DT_I16: return (int32_t)(int16_t)x;
    case DT_U8: return x & 0xff;
    case DT_U16: return x & 0xffff;
    case DT_BOOL: return x != 0;
    default: return x;
  }
}
__device__ __forceinline__ float narrow(float x, int) { return x; }
__device__ __forceinline__ uint32_t narrow(uint32_t x, int) { return x; }

__device__ __forceinline__ float op_div(float a, float b, int) {
  return __fdiv_rn(a, b);
}
// truncating division; x / 0 saturates at the type of `nt`
__device__ __forceinline__ int32_t op_div(int32_t a, int32_t b, int nt) {
  if (b == 0) {
    if (a == 0) return 0;
    switch (nt) {
      case DT_I8: return a > 0 ? 127 : -128;
      case DT_I16: return a > 0 ? 32767 : -32768;
      case DT_U8: return 255;
      case DT_U16: return 65535;
      case DT_BOOL: return a;  // BOOL DIV is FIRST (mapped before launch)
      default: return a > 0 ? INT32_MAX : INT32_MIN;
    }
  }
  if (b == -1) return op_sub<int32_t>(0, a);
  return a / b;
}
__device__ __forceinline__ uint32_t op_div(uint32_t a, uint32_t b, int) {
  if (b == 0) return a ? 0xffffffffu : 0u;
  return a / b;
}

// The op codes the algebra added (ANY aside) are kept out of the hot
// loops of the arithmetic ones: a kernel that takes them is a separate
// instantiation (EXT = true), picked at launch from the codes.  (Their
// cases inlined into the arithmetic kernels' unrolled loops, or called
// out of line from anywhere in a source, measured 17-33% slower on the
// card.)
__host__ __device__ constexpr bool fold_ext_code(int op) {
  return op > FOLD_ANY;
}
__host__ __device__ constexpr bool mul_ext_code(int op) {
  return op > MUL_MAX;
}

template <typename T, bool EXT = true>
__device__ __forceinline__ T apply_fold(int op, T a, T b) {
  switch (op) {
    case FOLD_PLUS: return op_add(a, b);
    case FOLD_MIN: return op_min(a, b);
    // ANY: any product will do; the largest, so that an identity lane
    // (the caller fills with MAX's identity) never beats a product
    case FOLD_MAX: case FOLD_ANY: return op_max(a, b);
    default: break;
  }
  if constexpr (!EXT || std::is_floating_point<T>::value) {
    return op_mul(a, b);  // FOLD_TIMES (no logical or bitwise float fold)
  } else {
    switch (op) {
      case FOLD_TIMES: return op_mul(a, b);
      case FOLD_LOR: return (T)(a != 0 || b != 0);
      case FOLD_LAND: return (T)(a != 0 && b != 0);
      case FOLD_LXOR: return (T)((a != 0) != (b != 0));
      case FOLD_LXNOR: return (T)((a != 0) == (b != 0));
      case FOLD_BOR: return a | b;
      case FOLD_BAND: return a & b;
      case FOLD_BXOR: return a ^ b;
      default: return ~(a ^ b);  // FOLD_BXNOR
    }
  }
}

// the fold of op code OP, chosen at compile time
template <int OP, typename T>
__device__ __forceinline__ T fold_c(T a, T b) {
  if constexpr (OP == FOLD_PLUS) return op_add(a, b);
  else if constexpr (OP == FOLD_MIN) return op_min(a, b);
  else if constexpr (OP == FOLD_MAX || OP == FOLD_ANY) return op_max(a, b);
  else if constexpr (OP == FOLD_TIMES) return op_mul(a, b);
  else if constexpr (std::is_floating_point<T>::value) return a;
  else if constexpr (OP == FOLD_LOR) return (T)(a != 0 || b != 0);
  else if constexpr (OP == FOLD_LAND) return (T)(a != 0 && b != 0);
  else if constexpr (OP == FOLD_LXOR) return (T)((a != 0) != (b != 0));
  else if constexpr (OP == FOLD_LXNOR) return (T)((a != 0) == (b != 0));
  else if constexpr (OP == FOLD_BOR) return a | b;
  else if constexpr (OP == FOLD_BAND) return a & b;
  else if constexpr (OP == FOLD_BXOR) return a ^ b;
  else return ~(a ^ b);
}

// the fold of code OP as a functor (segfold's instantiations)
template <int OP>
struct FoldCode {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return fold_c<OP, T>(a, b);
  }
};

// the folds a word type takes: floats fold arithmetically only; uint32
// words differ from int32 ones only where order matters (MIN, MAX, ANY)
template <typename T>
__host__ __device__ constexpr bool fold_ok(int op) {
  return std::is_floating_point<T>::value ? op >= FOLD_PLUS && op <= FOLD_ANY
                                          : op >= FOLD_PLUS && op <= FOLD_BXNOR;
}

// the bits of the narrow type of dtype code `nt`: 8, 16 or 32
__device__ __forceinline__ int nt_bits(int nt) {
  return nt == DT_I8 || nt == DT_U8 ? 8
                                    : nt == DT_I16 || nt == DT_U16 ? 16 : 32;
}

// an integer word's bits of its type `nt`, as an unsigned value
template <typename T>
__device__ __forceinline__ uint32_t type_bits(T x, int nt) {
  const int b = nt_bits(nt);
  return b == 32 ? (uint32_t)x : (uint32_t)x & ((1u << b) - 1u);
}

// x << s in the type: 0 unless 0 <= s < its bits (ops/table.py:_shl)
template <typename T>
__device__ __forceinline__ T shl_t(T x, int64_t s, int nt) {
  return s >= 0 && s < nt_bits(nt) ? (T)((uint32_t)x << s) : (T)0;
}

// x >>> s, logical over the type's bits: 0 unless 0 <= s < its bits
// (ops/table.py:_shr_logical)
template <typename T>
__device__ __forceinline__ T shr_t(T x, int64_t s, int nt) {
  return s >= 0 && s < nt_bits(nt) ? (T)(type_bits(x, nt) >> s) : (T)0;
}

// x ** e as the JAX package's jnp.power over integers (ops/table.py:
// _ipow): square and multiply over e's low six bits only, wrapping in 32
// bits (the type's low bits are right), from 0 where x == 0 and e != 0;
// six fixed rounds, no branch on the data
__device__ __forceinline__ uint32_t ipow_u(uint32_t x, uint32_t e) {
  uint32_t r = (x == 0u && e != 0u) ? 0u : 1u;
#pragma unroll
  for (int k = 0; k < 6; ++k, x *= x)
    r = ((e >> k) & 1u) ? r * x : r;
  return r;
}

// The binary ops the masked SpGEMM's valued path took from the JAX rule
// (POW .. COPYSIGN), at the types ops/table.py gives them: POW at every
// type, the bitwise ones at the integer types, the rest at FP32.  Each
// computes its ops/table.py function at the type `nt`, narrowed: integer
// POW by ipow_u over the exponent's bits in the type (|y|, wrapping, for
// a signed type, and then, for y < 0, 1 / x^|y| with DIV's rule at 0),
// BOOL POW x | !y; the shifts read y's value in the type (BSHIFT: as
// int32, a negative y a logical right shift by -y negated in int32, so
// that -2^31 shifts by 0); FP32 REMAINDER is x - rint(x / y)
// y and LDEXP x * 2^(int)y, rounded as torch's are.
template <typename T>
__device__ __forceinline__ T apply_mul_x(int op, T a, T b, int nt) {
  if constexpr (std::is_floating_point<T>::value) {
    switch (op) {
      case MUL_POW: return powf(a, b);
      case MUL_ATAN2: return atan2f(a, b);
      case MUL_HYPOT: return hypotf(a, b);
      case MUL_FMOD: return fmodf(a, b);
      case MUL_REMAINDER:
        return __fsub_rn(a, __fmul_rn(rintf(__fdiv_rn(a, b)), b));
      case MUL_LDEXP: {
        const int e = (int)b;
        const float p = e > 127 ? __int_as_float(0x7f800000)
                                : e < -149 ? 0.0f : ldexpf(1.0f, e);
        return __fmul_rn(a, p);
      }
      default: return copysignf(a, b);  // MUL_COPYSIGN
    }
  } else {
    T r;
    switch (op) {
      case MUL_POW: {
        if (nt == DT_BOOL) return (T)(a != 0 || b == 0);
        if (std::is_same<T, uint32_t>::value || nt == DT_U8 || nt == DT_U16)
          return narrow((T)ipow_u((uint32_t)a, type_bits(b, nt)), nt);
        const int32_t x = (int32_t)a, y = (int32_t)b;
        const uint32_t e = y < 0 ? 0u - (uint32_t)y : (uint32_t)y;
        const int32_t mag = narrow((int32_t)ipow_u((uint32_t)x,
                                                   type_bits(e, nt)), nt);
        return (T)(y < 0 ? op_div(1, mag, nt) : mag);
      }
      case MUL_BOR: r = a | b; break;
      case MUL_BAND: r = a & b; break;
      case MUL_BXOR: r = a ^ b; break;
      case MUL_BXNOR: r = ~(a ^ b); break;
      case MUL_BGET: r = shr_t(a, (int64_t)b, nt) & (T)1; break;
      case MUL_BSET: r = a | shl_t((T)1, (int64_t)b, nt); break;
      case MUL_BCLR: r = a & ~shl_t((T)1, (int64_t)b, nt); break;
      default: {  // MUL_BSHIFT: y as int32 (a UINT16 word is its value)
        const int32_t y = (int32_t)b;
        const int32_t ny = (int32_t)(0u - (uint32_t)y);
        r = y >= 0 ? shl_t(a, (int64_t)y, nt)
                   : shr_t(a, (int64_t)(ny < 0 ? 0 : ny), nt);
      }
    }
    return narrow(r, nt);
  }
}

// a = matrix value, b = gathered x value (mono.py: mul(vals, gathered));
// nt: the dtype code, for narrowing and the division's saturation
template <typename T, bool EXT = true>
__device__ __forceinline__ T apply_mul(int op, T a, T b, int nt) {
  T r;
  switch (op) {
    case MUL_TIMES: r = op_mul(a, b); break;
    case MUL_PLUS: r = op_add(a, b); break;
    case MUL_MINUS: r = op_sub(a, b); break;
    case MUL_RMINUS: r = op_sub(b, a); break;
    case MUL_DIV: r = op_div(a, b, nt); break;
    case MUL_RDIV: r = op_div(b, a, nt); break;
    case MUL_FIRST: return a;
    case MUL_SECOND: return b;
    case MUL_PAIR: return (T)1;
    case MUL_MIN: return op_min(a, b);
    default:
      if constexpr (!EXT) {
        return op_max(a, b);  // MUL_MAX
      } else {
        // the comparisons and logical multiplies give 0 or 1
        switch (op) {
          case MUL_MAX: return op_max(a, b);
          case MUL_ISEQ: case MUL_EQ: return (T)(a == b);
          case MUL_ISNE: case MUL_NE: return (T)(a != b);
          case MUL_ISGT: case MUL_GT: return (T)(a > b);
          case MUL_ISLT: case MUL_LT: return (T)(a < b);
          case MUL_ISGE: case MUL_GE: return (T)(a >= b);
          case MUL_ISLE: case MUL_LE: return (T)(a <= b);
          case MUL_LOR: return (T)(a != (T)0 || b != (T)0);
          case MUL_LAND: return (T)(a != (T)0 && b != (T)0);
          case MUL_LXOR: return (T)((a != (T)0) != (b != (T)0));
          default: return apply_mul_x(op, a, b, nt);
        }
      }
  }
  return narrow(r, nt);
}

// apply_mul with the dtype code packed beside the op code:
// op | dtype << 8 (pair_fold's kernels carry one int for both)
template <typename T, bool EXT = true>
__device__ __forceinline__ T apply_mul_packed(int op_nt, T a, T b) {
  return apply_mul<T, EXT>(op_nt & 0xff, a, b, op_nt >> 8);
}

// pair_fold's built-in ops as functors (csrc/spgemm.cuh): the codes,
// picked at run time; EXT: the algebra's added codes too
template <typename T, bool EXT>
struct MulSwitch {
  int op_nt;  // op | dtype << 8
  __device__ __forceinline__ T operator()(T a, T b) const {
    return apply_mul_packed<T, EXT>(op_nt, a, b);
  }
};

template <typename T, bool EXT>
struct FoldSwitch {
  int op;
  __device__ __forceinline__ T operator()(T a, T b) const {
    return apply_fold<T, EXT>(op, a, b);
  }
};
