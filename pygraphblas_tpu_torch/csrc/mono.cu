// The C entry points of mono_span and mono_rows (mono.cuh): each picks
// the instantiation its arguments need; the instantiations are compiled
// in mono_span_*.cu and mono_rows_*.cu.

#include "mono.cuh"

extern "C" int pgb_mono_span(const void* qg, const void* dm, const void* src,
                             int64_t src_len, const void* vals, void* out,
                             int64_t n_groups, int dtype, int mul_op,
                             int fold_op, uint32_t fill_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (fold_op >= 0 && !(dtype == DT_F32 ? fold_ok<float>(fold_op)
                                        : fold_ok<int32_t>(fold_op)))
    return -1;
  // the algebra's added codes, and the narrow types (their multiply
  // narrows at the dtype code), take the EXT instantiation
  if (mul_ext_code(mul_op) || fold_ext_code(fold_op) || dtype > DT_U32)
    PGB_DISPATCH_WORD(dtype, (launch_span<T, true>(
                                 (const int32_t*)qg, (const int16_t*)dm, src,
                                 src_len, vals, out, n_groups, mul_op,
                                 fold_op, fill_bits, dtype, st)));
  PGB_DISPATCH_WORD(dtype, (launch_span<T, false>(
                               (const int32_t*)qg, (const int16_t*)dm, src,
                               src_len, vals, out, n_groups, mul_op, fold_op,
                               fill_bits, dtype, st)));
}

// dm_bytes: 2 (int16) or 4 (int32); xblk may be null (resident plan);
// blk a power of two; dm, vals and out 16-byte aligned; fold_op one of
// the xspmv folds (PLUS, MIN, MAX, TIMES; ANY folds as MAX) or -1
extern "C" int pgb_mono_rows(const void* q0, const void* dm, int dm_bytes,
                             const void* xblk, int64_t xb, int64_t blk,
                             const void* src, int64_t src_len,
                             const void* vals, void* out, int64_t n_groups,
                             int dtype, int mul_op, int fold_op,
                             uint32_t fill_bits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *q = (const int32_t*)q0, *xk = (const int32_t*)xblk;
  if (blk <= 0 || (blk & (blk - 1))) return -1;
  if ((uintptr_t)dm % 16 || (uintptr_t)vals % 16 || (uintptr_t)out % 16)
    return -1;
  const int shift = __builtin_ctzll((unsigned long long)blk);
  if (dm_bytes == 2)
    PGB_DISPATCH_WORD(dtype, (launch_rows_fold<T, int16_t>(
                                 fold_op, q, dm, xk, xb, shift, src, src_len,
                                 vals, out, n_groups, mul_op, fill_bits,
                                 dtype, st)));
  if (dm_bytes == 4)
    PGB_DISPATCH_WORD(dtype, (launch_rows_fold<T, int32_t>(
                                 fold_op, q, dm, xk, xb, shift, src, src_len,
                                 vals, out, n_groups, mul_op, fill_bits,
                                 dtype, st)));
  return -1;
}
