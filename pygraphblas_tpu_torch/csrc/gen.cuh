// Device semantics of the aten ops that _opgen.py lowers a traced
// operator to: each computes what torch computes on the CPU for operands
// of one type T (the caller casts them to it, as torch promotes before
// it computes).  Floats round as torch's do: the basic arithmetic uses
// the _rn intrinsics (no FMA contraction), sqrt and division are IEEE
// (no -use_fast_math); the transcendental functions are CUDA's, within
// a few ulp of torch's.  Integers wrap (two's complement).  Where torch
// refuses on the CPU (an integer x / 0 or x % 0), the kernel gives -1
// for a quotient and 0 for a remainder: such an op is outside any
// comparison the port makes.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace gen {

template <typename T>
constexpr bool is_f = std::is_floating_point<T>::value;
template <typename T>
constexpr bool is_b = std::is_same<T, bool>::value;
template <typename T>
constexpr bool is_32 = std::is_same<T, float>::value;

// the unsigned type integer arithmetic on T wraps in (no int promotion
// overflow for the narrow types)
template <typename T>
using W = std::conditional_t<(sizeof(T) < 4), uint32_t,
                             std::make_unsigned_t<T>>;

// the C math functions at T: the float ones (expf ...) at float, the
// double ones at double
#define PGB_GEN_MATH1(F)                                   \
  template <typename T>                                    \
  __device__ __forceinline__ T m_##F(T a) {                \
    if constexpr (is_32<T>) return F##f(a);                \
    else return ::F(a);                                    \
  }
#define PGB_GEN_MATH2(F)                                   \
  template <typename T>                                    \
  __device__ __forceinline__ T m_##F(T a, T b) {           \
    if constexpr (is_32<T>) return F##f(a, b);             \
    else return ::F(a, b);                                 \
  }
PGB_GEN_MATH1(sqrt) PGB_GEN_MATH1(exp) PGB_GEN_MATH1(exp2)
PGB_GEN_MATH1(log) PGB_GEN_MATH1(log2) PGB_GEN_MATH1(log1p)
PGB_GEN_MATH1(expm1) PGB_GEN_MATH1(sin) PGB_GEN_MATH1(cos)
PGB_GEN_MATH1(tanh) PGB_GEN_MATH1(floor) PGB_GEN_MATH1(ceil)
PGB_GEN_MATH1(trunc) PGB_GEN_MATH1(rint) PGB_GEN_MATH1(fabs)
PGB_GEN_MATH2(fmod) PGB_GEN_MATH2(pow) PGB_GEN_MATH2(atan2)
PGB_GEN_MATH2(hypot) PGB_GEN_MATH2(copysign)
#undef PGB_GEN_MATH1
#undef PGB_GEN_MATH2

template <typename To, typename From>
__device__ __forceinline__ To cast(From x) {
  if constexpr (is_b<To>)
    return x != From(0);
  else
    return static_cast<To>(x);
}

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  if constexpr (is_32<T>) return __fadd_rn(a, b);
  else if constexpr (is_f<T>) return __dadd_rn(a, b);
  else if constexpr (is_b<T>) return a || b;
  else return (T)((W<T>)a + (W<T>)b);
}

template <typename T>
__device__ __forceinline__ T sub(T a, T b) {
  if constexpr (is_32<T>) return __fsub_rn(a, b);
  else if constexpr (is_f<T>) return __dsub_rn(a, b);
  else return (T)((W<T>)a - (W<T>)b);
}

template <typename T>
__device__ __forceinline__ T mul(T a, T b) {
  if constexpr (is_32<T>) return __fmul_rn(a, b);
  else if constexpr (is_f<T>) return __dmul_rn(a, b);
  else if constexpr (is_b<T>) return a && b;
  else return (T)((W<T>)a * (W<T>)b);
}

template <typename T>
__device__ __forceinline__ T neg(T a) {
  if constexpr (is_f<T>) return -a;
  else return (T)((W<T>)0 - (W<T>)a);
}

// true division (T a float type)
template <typename T>
__device__ __forceinline__ T div(T a, T b) {
  if constexpr (is_32<T>) return __fdiv_rn(a, b);
  else return __ddiv_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T div_trunc(T a, T b) {
  if constexpr (is_f<T>) {
    return m_trunc(div(a, b));
  } else {
    if (b == 0) return (T)-1;
    if constexpr (std::is_signed<T>::value)
      if (b == (T)-1) return neg(a);
    return (T)(a / b);
  }
}

// c10::div_floor_floating and div_floor_integer
template <typename T>
__device__ __forceinline__ T div_floor(T a, T b) {
  if constexpr (is_f<T>) {
    if (b == 0) return div(a, b);
    const T mod = m_fmod(a, b);
    T q = div(sub(a, mod), b);
    if (mod != 0 && (b < 0) != (mod < 0)) q = sub(q, (T)1);
    if (q == 0) return m_copysign((T)0, div(a, b));
    T f = m_floor(q);
    if (sub(q, f) > (T)0.5) f = add(f, (T)1);
    return f;
  } else {
    if (b == 0) return (T)-1;
    if constexpr (std::is_signed<T>::value) {
      if (b == (T)-1) return neg(a);
      const T q = (T)(a / b), r = (T)(a % b);
      return r != 0 && ((r < 0) != (b < 0)) ? (T)(q - 1) : q;
    } else {
      return (T)(a / b);
    }
  }
}

// Python's %: the sign of b
template <typename T>
__device__ __forceinline__ T remainder(T a, T b) {
  if constexpr (is_f<T>) {
    T m = m_fmod(a, b);
    if (m != 0 && (b < 0) != (m < 0)) m = add(m, b);
    return m;
  } else {
    if (b == 0) return (T)0;
    if constexpr (std::is_signed<T>::value) {
      if (b == (T)-1) return (T)0;
      T m = (T)(a % b);
      if (m != 0 && (m < 0) != (b < 0)) m = add(m, b);
      return m;
    } else {
      return (T)(a % b);
    }
  }
}

// C's %: the sign of a
template <typename T>
__device__ __forceinline__ T fmod_(T a, T b) {
  if constexpr (is_f<T>) {
    return m_fmod(a, b);
  } else {
    if (b == 0) return (T)0;
    if constexpr (std::is_signed<T>::value)
      if (b == (T)-1) return (T)0;
    return (T)(a % b);
  }
}

// torch's pow: floats std::pow; integers by squaring, wrapping, a
// negative exponent 1, +-1 or 0 (c10 powi)
template <typename T>
__device__ __forceinline__ T pow_(T a, T b) {
  if constexpr (is_f<T>) {
    return m_pow(a, b);
  } else if constexpr (is_b<T>) {
    return a || !b;
  } else {
    if constexpr (std::is_signed<T>::value) {
      if (b < 0) {
        if (a == 1) return 1;
        if (a == -1) return (b & 1) ? (T)-1 : (T)1;
        return 0;
      }
    }
    W<T> r = 1, x = (W<T>)a;
    for (W<T> e = (W<T>)b; e; e >>= 1, x *= x)
      if (e & 1) r *= x;
    return (T)r;
  }
}

// an integer tensor ** tensor as the JAX package traces it (jnp.power's
// _pow_int_int; _unsigned.py): square and multiply over b's low six
// bits, wrapping, from 0 where a == 0 and b != 0; floats and bools as
// pow_ (ops/table.py:power)
template <typename T>
__device__ __forceinline__ T ipow(T a, T b) {
  if constexpr (is_f<T> || is_b<T>) {
    return pow_(a, b);
  } else {
    W<T> r = (a == 0 && b != 0) ? 0 : 1, x = (W<T>)a;
#pragma unroll
    for (int k = 0; k < 6; ++k, x *= x)
      r = ((b >> k) & 1) ? (W<T>)(r * x) : r;
    return (T)r;
  }
}

template <typename T>
__device__ __forceinline__ T minimum(T a, T b) {
  if constexpr (is_f<T>) return a != a ? a : (b != b ? b : (b < a ? b : a));
  else if constexpr (is_b<T>) return a && b;
  else return b < a ? b : a;
}

template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  if constexpr (is_f<T>) return a != a ? a : (b != b ? b : (b > a ? b : a));
  else if constexpr (is_b<T>) return a || b;
  else return b > a ? b : a;
}

// x << s and x >> s as torch's CPU kernels: a shift by s < 0 or past the
// type's bits gives 0 (>>: -1 for a negative x)
template <typename T>
__device__ __forceinline__ T lshift(T a, T s) {
  constexpr int bits = 8 * sizeof(T);
  if ((int64_t)s < 0 || (int64_t)s >= bits) return 0;
  return (T)((W<T>)a << s);
}

template <typename T>
__device__ __forceinline__ T rshift(T a, T s) {
  constexpr int bits = 8 * sizeof(T);
  if ((int64_t)s < 0 || (int64_t)s >= bits) return a < 0 ? (T)-1 : (T)0;
  return (T)(a >> s);
}

template <typename T>
__device__ __forceinline__ T abs_(T a) {
  if constexpr (is_f<T>) return m_fabs(a);
  else if constexpr (std::is_signed<T>::value) return a < 0 ? neg(a) : a;
  else return a;
}

// (a > 0) - (a < 0): NaN and -0 give +0, as torch's
template <typename T>
__device__ __forceinline__ T sign(T a) {
  if constexpr (is_b<T>) return a;
  else return (T)((int)(a > 0) - (int)(a < 0));
}

template <typename T>
__device__ __forceinline__ T clamp(T a, bool has_lo, T lo, bool has_hi, T hi) {
  if constexpr (is_f<T>)
    if (a != a) return a;
  if (has_lo && a < lo) a = lo;
  if (has_hi && a > hi) a = hi;
  return a;
}

// x * 2^e as torch's mul(x, pow(2.0, e)): 2^e exact, or 0 or inf
template <typename T, typename E>
__device__ __forceinline__ T ldexp_(T a, E e) {
  const int64_t k = (int64_t)e;
  if constexpr (is_32<T>) {
    const float p = k > 127 ? __int_as_float(0x7f800000)
                            : k < -149 ? 0.0f : ldexpf(1.0f, (int)k);
    return __fmul_rn(a, p);
  } else {
    const double p = k > 1023 ? __longlong_as_double(0x7ff0000000000000LL)
                              : k < -1074 ? 0.0 : ::ldexp(1.0, (int)k);
    return __dmul_rn(a, p);
  }
}

template <typename T>
__device__ __forceinline__ T reciprocal(T a) { return div((T)1, a); }

template <typename T>
__device__ __forceinline__ T rsqrt_(T a) { return div((T)1, m_sqrt(a)); }

template <typename T>
__device__ __forceinline__ T sigmoid(T a) {
  return div((T)1, add((T)1, m_exp(-a)));
}

template <typename T>
__device__ __forceinline__ T round_(T a) {
  if constexpr (is_f<T>) return m_rint(a);
  else return a;
}

template <typename T>
__device__ __forceinline__ T floor_(T a) {
  if constexpr (is_f<T>) return m_floor(a);
  else return a;
}

template <typename T>
__device__ __forceinline__ T ceil_(T a) {
  if constexpr (is_f<T>) return m_ceil(a);
  else return a;
}

template <typename T>
__device__ __forceinline__ T trunc_(T a) {
  if constexpr (is_f<T>) return m_trunc(a);
  else return a;
}

}  // namespace gen
