// Monotone windowed gathers: the CUDA counterparts of
// pygraphblas_tpu/core/mono.py:_mono_pallas_span (mono_span, below) and
// pygraphblas_tpu/core/mono.py:_mono_pallas (mono_rows, further down).
//
// The kernels live in this header; mono.cu holds the C entry points,
// and each instantiation set is compiled in its own translation unit
// (mono_span_*.cu, mono_rows_*.cu, which define PGB_MONO_DEFS before
// including this), so that nvcc builds them in parallel: in one source
// they took 165 s to build (cicc 96 s, ptxas 64 s) while every other
// source took under 12 s.  Split, mono_span's int32 arithmetic
// instantiation alone still took 126 s (cicc 78 s, ptxas 43 s; its
// EXT instantiation 7 s); it now takes 4-byte words only.
//
// mono_span, the group-span encoding:
//   out[s, l] = src[qg[s / 8] * 128 + dm[s, l]]        (dm < 0 -> fill)
//   optional  out[s, l] = mul(vals[s, l], out[s, l])    (valid lanes)
//   optional  fold: out[g, l] = fold over s = 0..7 of row 8g+s, in order
//
// dm is int16, relative to the 8-row group's base row qg[g]
// (mono.py:146-159).  Design: one thread per output lane of an 8-row
// group; it computes each source index directly and keeps the 8-slot
// fold in a register.  The TPU kernel's window slice + in-register lane
// gather has no Hopper counterpart worth copying: the source (<= a few
// MB for the span plans) stays in L2, and the 8 int16 reads of dm per
// thread are coalesced across the warp.
//
// Bound: bytes.  Each call reads dm (S*128*2 B), qg, the source and the
// optional vals once and writes S*128 (or S*16) values of 4 B.

#pragma once

#include <cstring>

#include "ops.cuh"

// mono_span at word type T; EXT: the instantiation that takes the codes
// the algebra added (the caller picks it from the codes)
template <typename T, bool EXT>
int launch_span(const int32_t* qg, const int16_t* dm, const void* src,
                int64_t src_len, const void* vals, void* out,
                int64_t n_groups, int mul_op, int fold_op,
                uint32_t fill_bits, int nt, cudaStream_t stream);

// mono_rows at word type T and dm type D, every fold
template <typename T, typename D>
int launch_rows_fold(int fold_op, const int32_t* q0, const void* dm,
                     const int32_t* xblk, int64_t xb, int blk_shift,
                     const void* src, int64_t src_len, const void* vals,
                     void* out, int64_t n_groups, int mul_op,
                     uint32_t fill_bits, int nt, cudaStream_t st);

#define PGB_SPAN_INSTANCE(T, EXT)                                          \
  template int launch_span<T, EXT>(const int32_t*, const int16_t*,          \
                                   const void*, int64_t, const void*,       \
                                   void*, int64_t, int, int, uint32_t, int, \
                                   cudaStream_t)
#define PGB_ROWS_INSTANCE(T, D)                                              \
  template int launch_rows_fold<T, D>(int, const int32_t*, const void*,       \
                                      const int32_t*, int64_t, int,           \
                                      const void*, int64_t, const void*,      \
                                      void*, int64_t, int, uint32_t, int,     \
                                      cudaStream_t)

#ifdef PGB_MONO_DEFS

// EXT: the mul or fold is one the algebra added (ops.cuh)
template <typename T, bool EXT>
__global__ void mono_span_kernel(const int32_t* __restrict__ qg,
                                 const int16_t* __restrict__ dm,
                                 const T* __restrict__ src, int64_t src_len,
                                 const T* __restrict__ vals,
                                 T* __restrict__ out, int64_t n_groups,
                                 int mul_op, int fold_op, T fill, int nt) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_groups * 128) return;
  int64_t g = t >> 7;
  int l = (int)(t & 127);
  int64_t base = (int64_t)qg[g] * 128;
  T acc = fill;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    int64_t cell = (g * 8 + s) * 128 + l;
    int d = dm[cell];
    T v = fill;
    if (d >= 0) {
      int64_t i = base + d;
      // the clip of the plain version (mono.py:221)
      i = i < 0 ? 0 : (i >= src_len ? src_len - 1 : i);
      v = src[i];
      // the arithmetic instantiation takes 4-byte words only (the
      // caller sends the narrow types to EXT): a constant dtype code
      // leaves no loop-invariant switch on it for cicc and ptxas to
      // unswitch the unrolled loop over
      if (mul_op >= 0)
        v = apply_mul<T, EXT>(mul_op, vals[cell], v, EXT ? nt : DT_I32);
    }
    if (fold_op < 0)
      out[cell] = v;
    else
      acc = s == 0 ? v : apply_fold<T, EXT>(fold_op, acc, v);
  }
  if (fold_op >= 0) out[g * 128 + l] = acc;
}

template <typename T, bool EXT>
int launch_span(const int32_t* qg, const int16_t* dm, const void* src,
                       int64_t src_len, const void* vals, void* out,
                       int64_t n_groups, int mul_op, int fold_op,
                       uint32_t fill_bits, int nt, cudaStream_t stream) {
  T fill;
  memcpy(&fill, &fill_bits, sizeof(T));
  const int threads = 256;
  int64_t blocks = (n_groups * 128 + threads - 1) / threads;
  if (blocks > 0)
    mono_span_kernel<T, EXT><<<(unsigned)blocks, threads, 0, stream>>>(
        qg, dm, (const T*)src, src_len, (const T*)vals, (T*)out, n_groups,
        mul_op, fold_op, fill, nt);
  return (int)cudaGetLastError();
}

// mono_rows, the per-row encoding (mono.py:_mono_pallas):
//
//   out[s, l] = src[(q0[s] + xb * xblk[s / blk]) * 128 + dm[s, l]]
//
// q0 is each row's window base; for a streamed plan it is relative to
// the row block's source block xblk[s / blk] of xb rows (resident plans
// pass no xblk; blk is a power of two, mono.py:103-106).  dm is int16
// or int32 (mono.py:122-123), -1 = invalid.  mul, then the 8-slot fold
// in the order s = 0..7, as in mono_span.  The TPU kernel walks each
// row's max_w windows and, when streaming, pulls two xb-row source
// blocks a grid step into VMEM: layouts of a 128 MB scratchpad, not
// rules of this card.  A streamed plan's window (up to 2 x 8192 rows of
// 128, 8 MB) is too large to stage, so the source is read from device
// memory, where a warp's reads are monotone.
//
// Design: one warp an 8-row group, each lane 4 neighbouring lanes of
// it, 12 groups a block.  Lanes 0..7 compute the 8 rows' bases once (a
// shift for / blk) and broadcast them by shuffles; each lane loads its 4
// dm cells of a row as one 8- or 16-byte word, issues its 32 source
// reads with nothing between them, folds its 4 columns in registers
// (the fold op is a template argument) and stores 16 bytes.  The first
// port (one thread a lane; for each cell a 64-bit division by blk and
// reloads of q0 and xblk; 2-byte dm loads: 0.0534 ms at pr21's level-1
// fold on an H100 80GB HBM3 at 700 W, 3.8x its bound) spent its time on
// each cell's integer work and dependent loads.
//
// Bound: bytes.  dm (2 or 4 B a cell), q0 (4 B a row), the source and
// the optional vals are read once, the output written once.
constexpr int kRowsWarps = 12;           // groups a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_dm4(const int16_t* p, int d[4]) {
  const uint2 w = *(const uint2*)p;
  d[0] = (int16_t)(w.x & 0xffff);
  d[1] = (int16_t)(w.x >> 16);
  d[2] = (int16_t)(w.y & 0xffff);
  d[3] = (int16_t)(w.y >> 16);
}

__device__ __forceinline__ void load_dm4(const int32_t* p, int d[4]) {
  const int4 w = *(const int4*)p;
  d[0] = w.x;
  d[1] = w.y;
  d[2] = w.z;
  d[3] = w.w;
}

__device__ __forceinline__ int as_bits(float x) { return __float_as_int(x); }
__device__ __forceinline__ int as_bits(int32_t x) { return x; }
__device__ __forceinline__ int as_bits(uint32_t x) { return (int)x; }
template <typename T>
__device__ __forceinline__ T from_bits(int x);
template <>
__device__ __forceinline__ float from_bits<float>(int x) {
  return __int_as_float(x);
}
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(int x) { return x; }
template <>
__device__ __forceinline__ uint32_t from_bits<uint32_t>(int x) {
  return (uint32_t)x;
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T v[4]) {
  *(int4*)p = make_int4(as_bits(v[0]), as_bits(v[1]), as_bits(v[2]),
                        as_bits(v[3]));
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, T v[4]) {
  const int4 w = __ldg((const int4*)p);
  v[0] = from_bits<T>(w.x);
  v[1] = from_bits<T>(w.y);
  v[2] = from_bits<T>(w.z);
  v[3] = from_bits<T>(w.w);
}

// FOLD: a fold op code, or -1 for none
template <typename T, typename D, int FOLD>
__global__ void __launch_bounds__(kRowsWarps * 32)
mono_rows_kernel(const int32_t* __restrict__ q0, const D* __restrict__ dm,
                 const int32_t* __restrict__ xblk, int64_t xb,
                 int blk_shift, const T* __restrict__ src, int64_t src_len,
                 const T* __restrict__ vals, T* __restrict__ out,
                 int64_t n_groups, int mul_op, T fill, int nt) {
  const int lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * kRowsWarps + (threadIdx.x >> 5);
  if (g >= n_groups) return;               // warp-uniform
  long long rb = 0;                        // row lane's first source cell
  if (lane < 8) {
    const int64_t row = g * 8 + lane;
    int64_t base = __ldg(q0 + row);
    if (xblk != nullptr) base += (int64_t)__ldg(xblk + (row >> blk_shift)) * xb;
    rb = base * 128;
  }
  const int l0 = lane * 4;
  T acc[4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const long long rbs = __shfl_sync(kFull, rb, s);
    const int64_t cell = (g * 8 + s) * 128 + l0;
    int d[4];
    load_dm4(dm + cell, d);
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = fill;
      if (d[u] >= 0) {
        int64_t i = rbs + d[u];
        // the clip of the plain version (mono.py:221)
        i = i < 0 ? 0 : (i >= src_len ? src_len - 1 : i);
        v[u] = __ldg(src + i);
      }
    }
    if (mul_op >= 0) {
      T w[4];
      load4(vals + cell, w);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (d[u] >= 0) v[u] = apply_mul<T>(mul_op, w[u], v[u], nt);
    }
    if constexpr (FOLD < 0) {
      store4(out + cell, v);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = s == 0 ? v[u] : fold_c<FOLD, T>(acc[u], v[u]);
    }
  }
  if constexpr (FOLD >= 0) store4(out + g * 128 + l0, acc);
}

template <typename T, typename D, int FOLD>
static int launch_rows(const int32_t* q0, const void* dm, const int32_t* xblk,
                       int64_t xb, int blk_shift, const void* src,
                       int64_t src_len, const void* vals, void* out,
                       int64_t n_groups, int mul_op, uint32_t fill_bits,
                       int nt, cudaStream_t stream) {
  T fill;
  memcpy(&fill, &fill_bits, sizeof(T));
  const int64_t blocks = (n_groups + kRowsWarps - 1) / kRowsWarps;
  if (blocks > 0)
    mono_rows_kernel<T, D, FOLD><<<(unsigned)blocks, kRowsWarps * 32, 0,
                                   stream>>>(
        q0, (const D*)dm, xblk, xb, blk_shift, (const T*)src, src_len,
        (const T*)vals, (T*)out, n_groups, mul_op, fill, nt);
  return (int)cudaGetLastError();
}

template <typename T, typename D>
int launch_rows_fold(int fold_op, const int32_t* q0, const void* dm,
                            const int32_t* xblk, int64_t xb, int blk_shift,
                            const void* src, int64_t src_len,
                            const void* vals, void* out, int64_t n_groups,
                            int mul_op, uint32_t fill_bits, int nt,
                            cudaStream_t st) {
#define PGB_ROWS(F)                                                         \
  launch_rows<T, D, F>(q0, dm, xblk, xb, blk_shift, src, src_len, vals, out, \
                       n_groups, mul_op, fill_bits, nt, st)
  switch (fold_op) {
    case -1: return PGB_ROWS(-1);
    case FOLD_PLUS: return PGB_ROWS(FOLD_PLUS);
    case FOLD_MIN: return PGB_ROWS(FOLD_MIN);
    case FOLD_MAX: case FOLD_ANY: return PGB_ROWS(FOLD_MAX);
    case FOLD_TIMES: return PGB_ROWS(FOLD_TIMES);
  }
#undef PGB_ROWS
  return -1;
}

#endif  // PGB_MONO_DEFS
