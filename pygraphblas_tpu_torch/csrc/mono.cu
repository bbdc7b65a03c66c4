// Monotone windowed gathers: the CUDA counterparts of
// pygraphblas_tpu/core/mono.py:_mono_pallas_span (mono_span, below) and
// pygraphblas_tpu/core/mono.py:_mono_pallas (mono_rows, further down).
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

#include <cstring>

#include "ops.cuh"

template <typename T>
__global__ void mono_span_kernel(const int32_t* __restrict__ qg,
                                 const int16_t* __restrict__ dm,
                                 const T* __restrict__ src, int64_t src_len,
                                 const T* __restrict__ vals,
                                 T* __restrict__ out, int64_t n_groups,
                                 int mul_op, int fold_op, T fill) {
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
      if (mul_op >= 0) v = apply_mul<T>(mul_op, vals[cell], v);
    }
    if (fold_op < 0)
      out[cell] = v;
    else
      acc = s == 0 ? v : apply_fold<T>(fold_op, acc, v);
  }
  if (fold_op >= 0) out[g * 128 + l] = acc;
}

template <typename T>
static int launch_span(const int32_t* qg, const int16_t* dm, const void* src,
                       int64_t src_len, const void* vals, void* out,
                       int64_t n_groups, int mul_op, int fold_op,
                       uint32_t fill_bits, cudaStream_t stream) {
  T fill;
  memcpy(&fill, &fill_bits, sizeof(T));
  const int threads = 256;
  int64_t blocks = (n_groups * 128 + threads - 1) / threads;
  if (blocks > 0)
    mono_span_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
        qg, dm, (const T*)src, src_len, (const T*)vals, (T*)out, n_groups,
        mul_op, fold_op, fill);
  return (int)cudaGetLastError();
}

extern "C" int pgb_mono_span(const void* qg, const void* dm, const void* src,
                             int64_t src_len, const void* vals, void* out,
                             int64_t n_groups, int dtype, int mul_op,
                             int fold_op, uint32_t fill_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch_span<float>((const int32_t*)qg, (const int16_t*)dm, src,
                              src_len, vals, out, n_groups, mul_op, fold_op,
                              fill_bits, st);
  if (dtype == DT_I32)
    return launch_span<int32_t>((const int32_t*)qg, (const int16_t*)dm, src,
                                src_len, vals, out, n_groups, mul_op,
                                fold_op, fill_bits, st);
  return -1;
}

// mono_rows, the per-row encoding (mono.py:_mono_pallas):
//
//   out[s, l] = src[(q0[s] + xb * xblk[s / blk]) * 128 + dm[s, l]]
//
// q0 is each row's window base; for a streamed plan it is relative to
// the row block's source block xblk[s / blk] of xb rows (resident plans
// pass no xblk).  dm is int16 or int32 (mono.py:122-123), -1 = invalid.
// The TPU kernel walks each row's max_w windows and, when streaming,
// pulls two xb-row source blocks per grid step into VMEM; both are
// layouts of a 128 MB scratchpad, not rules of this card.  Here each
// thread computes its global source index directly (the arithmetic of
// mono.py:214-221) and reads the source from device memory; the source
// rows a warp touches are a monotone window, so its reads coalesce.
// mul, then the 8-slot fold in the order s = 0..7, as in mono_span.
//
// Bound: bytes.  dm (2 or 4 B a cell), q0 (4 B a row), the source and
// the optional vals are read once, the output written once.
template <typename T, typename D>
__global__ void mono_rows_kernel(const int32_t* __restrict__ q0,
                                 const D* __restrict__ dm,
                                 const int32_t* __restrict__ xblk,
                                 int64_t xb, int64_t blk,
                                 const T* __restrict__ src, int64_t src_len,
                                 const T* __restrict__ vals,
                                 T* __restrict__ out, int64_t n_groups,
                                 int mul_op, int fold_op, T fill) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_groups * 128) return;
  int64_t g = t >> 7;
  int l = (int)(t & 127);
  T acc = fill;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    int64_t row = g * 8 + s;
    int64_t cell = row * 128 + l;
    int64_t d = (int64_t)dm[cell];
    T v = fill;
    if (d >= 0) {
      int64_t base = q0[row];
      if (xblk != nullptr) base += (int64_t)xblk[row / blk] * xb;
      int64_t i = base * 128 + d;
      i = i < 0 ? 0 : (i >= src_len ? src_len - 1 : i);
      v = src[i];
      if (mul_op >= 0) v = apply_mul<T>(mul_op, vals[cell], v);
    }
    if (fold_op < 0)
      out[cell] = v;
    else
      acc = s == 0 ? v : apply_fold<T>(fold_op, acc, v);
  }
  if (fold_op >= 0) out[g * 128 + l] = acc;
}

template <typename T, typename D>
static int launch_rows(const int32_t* q0, const void* dm, const int32_t* xblk,
                       int64_t xb, int64_t blk, const void* src,
                       int64_t src_len, const void* vals, void* out,
                       int64_t n_groups, int mul_op, int fold_op,
                       uint32_t fill_bits, cudaStream_t stream) {
  T fill;
  memcpy(&fill, &fill_bits, sizeof(T));
  const int threads = 256;
  int64_t blocks = (n_groups * 128 + threads - 1) / threads;
  if (blocks > 0)
    mono_rows_kernel<T, D><<<(unsigned)blocks, threads, 0, stream>>>(
        q0, (const D*)dm, xblk, xb, blk, (const T*)src, src_len,
        (const T*)vals, (T*)out, n_groups, mul_op, fold_op, fill);
  return (int)cudaGetLastError();
}

// dm_bytes: 2 (int16) or 4 (int32); xblk may be null (resident plan)
extern "C" int pgb_mono_rows(const void* q0, const void* dm, int dm_bytes,
                             const void* xblk, int64_t xb, int64_t blk,
                             const void* src, int64_t src_len,
                             const void* vals, void* out, int64_t n_groups,
                             int dtype, int mul_op, int fold_op,
                             uint32_t fill_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *q = (const int32_t*)q0, *xk = (const int32_t*)xblk;
  if (blk <= 0) return -1;
  if (dtype == DT_F32 && dm_bytes == 2)
    return launch_rows<float, int16_t>(q, dm, xk, xb, blk, src, src_len,
                                       vals, out, n_groups, mul_op, fold_op,
                                       fill_bits, st);
  if (dtype == DT_F32 && dm_bytes == 4)
    return launch_rows<float, int32_t>(q, dm, xk, xb, blk, src, src_len,
                                       vals, out, n_groups, mul_op, fold_op,
                                       fill_bits, st);
  if (dtype == DT_I32 && dm_bytes == 2)
    return launch_rows<int32_t, int16_t>(q, dm, xk, xb, blk, src, src_len,
                                         vals, out, n_groups, mul_op,
                                         fold_op, fill_bits, st);
  if (dtype == DT_I32 && dm_bytes == 4)
    return launch_rows<int32_t, int32_t>(q, dm, xk, xb, blk, src, src_len,
                                         vals, out, n_groups, mul_op,
                                         fold_op, fill_bits, st);
  return -1;
}
