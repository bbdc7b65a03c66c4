// Semiring ops shared by the port's CUDA kernels.
//
// Op codes match pygraphblas_tpu_torch/semiring.py (ADDS / MULS).  The
// float ops use the _rn intrinsics so that nvcc never contracts a mul
// and an add into one FMA: the kernels must round exactly as their
// plain PyTorch versions do.  Integer ops wrap (two's complement), as
// torch's int32 arithmetic does.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

enum { FOLD_PLUS = 0, FOLD_MIN = 1, FOLD_MAX = 2, FOLD_TIMES = 3 };
enum {
  MUL_TIMES = 0, MUL_PLUS = 1, MUL_MINUS = 2, MUL_RMINUS = 3, MUL_DIV = 4,
  MUL_RDIV = 5, MUL_FIRST = 6, MUL_SECOND = 7, MUL_PAIR = 8, MUL_MIN = 9,
  MUL_MAX = 10
};
enum { DT_F32 = 0, DT_I32 = 1 };

__device__ __forceinline__ float op_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float op_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float op_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float op_div(float a, float b) { return __fdiv_rn(a, b); }
// torch.minimum / torch.maximum propagate NaN
__device__ __forceinline__ float op_min(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ float op_max(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

__device__ __forceinline__ int32_t op_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t op_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t op_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}
// truncating division; x / 0 -> 0 (semiring.py:_div)
__device__ __forceinline__ int32_t op_div(int32_t a, int32_t b) {
  if (b == 0) return 0;
  if (b == -1) return op_sub(0, a);
  return a / b;
}
__device__ __forceinline__ int32_t op_min(int32_t a, int32_t b) { return b < a ? b : a; }
__device__ __forceinline__ int32_t op_max(int32_t a, int32_t b) { return b > a ? b : a; }

template <typename T>
__device__ __forceinline__ T apply_fold(int op, T a, T b) {
  switch (op) {
    case FOLD_PLUS: return op_add(a, b);
    case FOLD_MIN: return op_min(a, b);
    case FOLD_MAX: return op_max(a, b);
    default: return op_mul(a, b);
  }
}

// the fold of op code OP, chosen at compile time
template <int OP, typename T>
__device__ __forceinline__ T fold_c(T a, T b) {
  if constexpr (OP == FOLD_PLUS) return op_add(a, b);
  else if constexpr (OP == FOLD_MIN) return op_min(a, b);
  else if constexpr (OP == FOLD_MAX) return op_max(a, b);
  else return op_mul(a, b);
}

// a = matrix value, b = gathered x value (mono.py: mul(vals, gathered))
template <typename T>
__device__ __forceinline__ T apply_mul(int op, T a, T b) {
  switch (op) {
    case MUL_TIMES: return op_mul(a, b);
    case MUL_PLUS: return op_add(a, b);
    case MUL_MINUS: return op_sub(a, b);
    case MUL_RMINUS: return op_sub(b, a);
    case MUL_DIV: return op_div(a, b);
    case MUL_RDIV: return op_div(b, a);
    case MUL_FIRST: return a;
    case MUL_SECOND: return b;
    case MUL_PAIR: return (T)1;
    case MUL_MIN: return op_min(a, b);
    default: return op_max(a, b);
  }
}
