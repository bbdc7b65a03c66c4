// The ESC engine's dual-source gather: the CUDA counterpart of
// pygraphblas_tpu/core/esc.py:_esc_gw_gather.
//
//   out_c[s] = cols[128 * q + (dm[s] & 127)],  out_v[s] = vals[same]
//   q = clamp(qg[s / 1024] + (dm[s] >> 7), 0, rows_src - 1)
//
// B's column ids and values are gathered together at the positions the
// segmented scans produced, bpos = 128 * qg[group] + dm.  The TPU kernel
// serves each 1024-slot group from one dynamic sublane window per step
// of a span loop (s = 0 .. span - 1, keeping the lanes whose dm >> 7 ==
// s), because a TPU core has no cheap per-element gather from VMEM.  The
// card has one: a thread computes each slot's flat position directly,
// so the window, the span loop and span itself are not needed.  Every
// slot the TPU kernel fills has dm >> 7 in [0, span) by construction
// (qg is its group's smallest bpos >> 7, span covers the largest), and
// there both give the same element: the row clamped as the TPU kernel
// clamps it (esc.py:111), then the lane.
//
// A thread serves 4 slots: one 16-byte load of dm, its group's qg, 4
// reads of each source, one 16-byte store to each output.  Values move
// as 32-bit words, so float32 and int32 share the kernel.  B is at most
// 5 MB (the _B_RESIDENT rule, esc.py:50), so both sources stay in the
// 50 MB L2.
//
// Bound: bytes.  dm read once (4 bytes a slot), both outputs written once
// (8 bytes a slot); qg is 1/256 of that; B's reads hit L2.

#include "ops.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
esc_gather_kernel(const uint32_t* __restrict__ cols,
                  const uint32_t* __restrict__ vals, int64_t rows_src,
                  const int32_t* __restrict__ qg, const int4* __restrict__ dm,
                  uint4* __restrict__ out_c, uint4* __restrict__ out_v,
                  int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int4 d = dm[i];
  const int32_t q0 = qg[i >> 8];  // 4 slots a thread, 1024 a group
  const int32_t dd[4] = {d.x, d.y, d.z, d.w};
  uint32_t c[4], v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int64_t q = (int64_t)q0 + (dd[k] >> 7);
    q = q < 0 ? 0 : (q > rows_src - 1 ? rows_src - 1 : q);
    const int64_t pos = q * 128 + (dd[k] & 127);
    c[k] = __ldg(cols + pos);
    v[k] = __ldg(vals + pos);
  }
  out_c[i] = make_uint4(c[0], c[1], c[2], c[3]);
  out_v[i] = make_uint4(v[0], v[1], v[2], v[3]);
}

}  // namespace

// cols, vals: (rows_src, 128) 4-byte words; qg: (n_slots / 1024,) int32;
// dm: (n_slots / 128, 128) int32; outputs (n_slots / 128, 128) 4-byte
// words; n_slots % 1024 == 0
extern "C" int pgb_esc_gather(const void* cols, const void* vals,
                              int64_t rows_src, const void* qg, const void* dm,
                              void* out_c, void* out_v, int64_t n_slots,
                              void* stream) {
  if (n_slots <= 0) return 0;
  if (n_slots % 1024 || rows_src <= 0) return -1;
  const int64_t n4 = n_slots / 4;
  esc_gather_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)cols, (const uint32_t*)vals, rows_src,
      (const int32_t*)qg, (const int4*)dm, (uint4*)out_c, (uint4*)out_v, n4);
  return (int)cudaGetLastError();
}
