// The xspmv fold cascade in one launch: the CUDA counterpart of
// pygraphblas_tpu/core/mono.py:mono_cascade.
//
// What it computes.  The chain it replaces runs `levels` span gathers
// that fold 8-slot groups, then a plain placement gather.  In xspmv's
// plans (core/xspmv.py) every level folds, for each matrix row, that
// row's cells 8 at a time in order, and a row already folded to one
// cell rides along as a group of one child and seven empty slots.  So
// placed output cell i is an 8-ary tree fold of one contiguous run of
// the level-0 source, src[start[i] .. start[i + 1]) (empty: `fill`),
// whose shape follows from the run's length n and the level count:
//
//   level 1 cell q    = fold_{s=0..7} (8q + s < n ? src[8q + s] : fill)
//   level k + 1 cell q = fold_{s=0..7} of level k's cells 8q + s, fill
//                        for the missing ones,
//
// each fold from slot 0 in the order s = 0..7, and `fill` folded into
// every empty slot, as the chain folds them: PLUS turns -0.0 into +0.0
// and MIN/MAX fills match bit for bit.  The host makes `start` once
// per plan, from the run lengths it builds the levels from
// (core/mono.py: fold_plans).
//
// What bounds it on the card: bytes, the first source read once, the
// table (4 B a row) and the placed output (4 B a row); 17.7 MB, 0.0053
// ms at 3.35 TB/s at kron-20.  The earlier design (a cooperative kernel
// walking every level's plan, 2-group tiles waiting on flags from the
// level before; 0.0572 ms at kron-20 on an H100 80GB HBM3 at 700 W)
// read every level's dm (8.8 MB a level there, 7 of its 8 slots empty
// from level 2 on) to fold a few thousand rows, and waited on flags.
//
// This design: one launch, no grid-wide waits, no flags.  A block takes
// 256 consecutive output rows: it reads their 257 table entries, stages
// the first 2048 source cells of its span in shared memory with 16-byte
// loads, and each thread folds its own row if the run has at most 64
// cells (from shared memory where the run was staged).  A run of 65 ..
// 1024 cells goes to a warp: 256 cells a step, a level-1 cell a lane
// from 8 registers loaded a step ahead, level-2 cells by shuffles, the
// level-2 group in registers.  A longer run goes to the whole block,
// 2048 cells a round, one step a warp, the level-3 cells by shuffles in
// warp 0; so kron-20's longest run (4,942 cells) takes 3 rounds, not 20
// dependent steps of one warp.  From level 3 up one thread folds the
// cells as they arrive, one pending group a level, so a run of any
// length needs registers for one step.  The fold op is a template
// argument, and registers are capped at 32 a thread so that 8 blocks
// fit an SM.  One-off edits of this kernel on the card (not kept)
// were slower with 63 registers a thread or with every run past 64
// cells on one warp, and showed that kron-20's 6,196 runs past 64
// cells take a large share of its time.  Output cells are written in
// row order.

#include <cstring>

#include "ops.cuh"

namespace cascade {
constexpr int BLOCK = 256;      // threads a block = output rows a block
constexpr int STAGE = 2048;     // source cells a block stages
constexpr int SHORT = 64;       // the longest run one thread folds
constexpr int MID = 1024;       // the longest run one warp folds
constexpr int STEP = 256;       // cells a warp folds a step: 32 x 8
constexpr int ROUND = STEP * BLOCK / 32;    // cells a block folds a round
constexpr int MAX_LEVELS = 32;
}  // namespace cascade

// A run of 1..64 cells (levels >= 2 past 8 cells) folded by one thread.
template <typename T, int OP>
__device__ __forceinline__ T fold_short(const T* v, int n, int levels,
                                        T fill) {
  T b = fill;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (8 * j < n) {            // level-1 cell j
      T a = v[8 * j];
#pragma unroll
      for (int s = 1; s < 8; ++s)
        a = fold_c<OP>(a, 8 * j + s < n ? v[8 * j + s] : fill);
      b = j == 0 ? a : fold_c<OP>(b, a);
    } else if (levels > 1) {    // an empty slot of the level-2 group
      b = fold_c<OP>(b, fill);
    }
  }
  for (int l = 2; l < levels; ++l)
#pragma unroll
    for (int s = 1; s < 8; ++s) b = fold_c<OP>(b, fill);
  return b;
}

// The fold of the cells from level `first` on, one thread's: a cell of
// level k joins the pending group of its level, a full group moves up
// as a cell of level k + 1, and a cell of level `levels` is the result;
// finish() folds the fill into every partial group, bottom up.
template <typename T, int OP>
struct Levels {
  T acc[cascade::MAX_LEVELS];
  int cnt[cascade::MAX_LEVELS];
  int first, levels;
  T fill, result;

  __device__ Levels(int first_, int levels_, T fill_)
      : first(first_), levels(levels_), fill(fill_), result(fill_) {
    for (int k = 0; k < cascade::MAX_LEVELS; ++k) cnt[k] = 0;
  }
  __device__ void feed(T x, int k) {
    while (k < levels) {
      acc[k] = cnt[k] == 0 ? x : fold_c<OP>(acc[k], x);
      if (++cnt[k] < 8) return;
      x = acc[k];
      cnt[k] = 0;
      ++k;
    }
    result = x;
  }
  __device__ T finish() {
    for (int k = first; k < levels; ++k) {
      if (cnt[k] == 0) continue;
      T a = acc[k];
      for (int s = cnt[k]; s < 8; ++s) a = fold_c<OP>(a, fill);
      cnt[k] = 0;
      feed(a, k + 1);
    }
    return result;
  }
};

// Lane l's level-1 cell of a step's m cells (m capped at 256; lane l's
// 8 values in r), and in lanes 8q the step's level-2 cell q, q < *n2
// (the return).
template <typename T, int OP>
__device__ __forceinline__ T level2(const T* r, int64_t m, T fill,
                                    int* n2) {
  const int lane = threadIdx.x & 31;
  const int n1 = (int)(((m < cascade::STEP ? m : cascade::STEP) + 7) >> 3);
  *n2 = (n1 + 7) >> 3;
  T a = r[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) a = fold_c<OP>(a, r[s]);
  if (lane >= n1) a = fill;
  T c2 = a;
#pragma unroll
  for (int s = 1; s < 8; ++s) {
    const T o = __shfl_down_sync(0xffffffffu, a, s);
    if ((lane & 7) == 0) c2 = fold_c<OP>(c2, lane + s < n1 ? o : fill);
  }
  return c2;
}

// this lane's 8 cells of the 256 from c0 (fill past n)
template <typename T>
__device__ __forceinline__ void load8(T* dst, const T* v, int64_t c0,
                                      int64_t n, T fill) {
  const int64_t c = c0 + 8 * (threadIdx.x & 31);
#pragma unroll
  for (int s = 0; s < 8; ++s) dst[s] = c + s < n ? v[c + s] : fill;
}

// A run of 65..1024 cells (so levels >= 3) folded by one warp, 256 cells
// a step with the next step's loads in flight: lane l folds level-1 cell
// l of the step, lanes 8q .. 8q + 7 level-2 cell q by shuffles, and
// lane 0 the level-2 cells onward.  The result is valid in lane 0.
template <typename T, int OP>
__device__ T fold_mid(const T* v, int64_t n, int levels, T fill) {
  using namespace cascade;
  const int lane = threadIdx.x & 31;
  // lane 0: the pending group of level-2 cells in registers, levels 3 ..
  // in `up`
  Levels<T, OP> up(3, levels, fill);
  T acc2 = fill;
  int cnt2 = 0;
  T r[8], nx[8];
  load8(r, v, 0, n, fill);
  for (int64_t c0 = 0; c0 < n; c0 += STEP) {
    if (c0 + STEP < n) load8(nx, v, c0 + STEP, n, fill);
    int n2;
    const T c2 = level2<T, OP>(r, n - c0, fill, &n2);
    for (int q = 0; q < n2; ++q) {
      const T x = __shfl_sync(0xffffffffu, c2, 8 * q);
      if (lane == 0) {
        acc2 = cnt2 == 0 ? x : fold_c<OP>(acc2, x);
        if (++cnt2 == 8) {
          up.feed(acc2, 3);
          cnt2 = 0;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 8; ++s) r[s] = nx[s];
  }
  if (lane != 0) return fill;
  if (cnt2) {
    for (int s = cnt2; s < 8; ++s) acc2 = fold_c<OP>(acc2, fill);
    up.feed(acc2, 3);
  }
  return up.finish();
}

// A run of more than 1024 cells (so levels >= 4) folded by the whole
// block, 2048 cells a round with the next round's loads in flight: warp
// w folds the round's step w to 4 level-2 cells (as fold_mid), warp 0
// their 32 to 4 level-3 cells by shuffles, and thread 0 those onward.
// The result is valid in thread 0.
template <typename T, int OP>
__device__ T fold_long(const T* v, int64_t n, int levels, T fill, T* l2) {
  using namespace cascade;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  Levels<T, OP> up(3, levels, fill);
  T r[8], nx[8];
  load8(r, v, STEP * w, n, fill);
  for (int64_t c0 = 0; c0 < n; c0 += ROUND) {
    const int64_t cs = c0 + STEP * w;
    if (c0 + ROUND < n) load8(nx, v, cs + ROUND, n, fill);
    int n2;
    const T c2 = level2<T, OP>(r, cs < n ? n - cs : 0, fill, &n2);
    if ((lane & 7) == 0) l2[4 * w + (lane >> 3)] = c2;
    __syncthreads();
    if (w == 0) {
      const int64_t mr = n - c0 < ROUND ? n - c0 : ROUND;
      const int n2r = (int)((((mr + 7) >> 3) + 7) >> 3);
      const int n3 = (n2r + 7) >> 3;
      const T x = l2[lane];
      T c3 = x;
#pragma unroll
      for (int s = 1; s < 8; ++s) {
        const T o = __shfl_down_sync(0xffffffffu, x, s);
        if ((lane & 7) == 0) c3 = fold_c<OP>(c3, lane + s < n2r ? o : fill);
      }
      for (int q = 0; q < n3; ++q) {
        const T y = __shfl_sync(0xffffffffu, c3, 8 * q);
        if (lane == 0) up.feed(y, 3);
      }
    }
    __syncthreads();            // l2 is read
#pragma unroll
    for (int s = 0; s < 8; ++s) r[s] = nx[s];
  }
  return threadIdx.x == 0 ? up.finish() : fill;
}

template <typename T, int OP>
__global__ void __launch_bounds__(cascade::BLOCK, 8)
mono_cascade_kernel(const T* __restrict__ src, int64_t src_len,
                    const int32_t* __restrict__ start, T* __restrict__ out,
                    int64_t n_rows, int levels, uint32_t fill_bits) {
  using namespace cascade;
  __shared__ int32_t s_start[BLOCK + 1];
  __shared__ __align__(16) T stage[STAGE];
  __shared__ int16_t longs[BLOCK], vlongs[BLOCK];
  __shared__ int n_long, n_vlong;
  __shared__ T l2[ROUND / 64];
  T fill;
  memcpy(&fill, &fill_bits, sizeof(T));
  const int t = threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.x * BLOCK;
  const int rows = (int)(n_rows - i0 < BLOCK ? n_rows - i0 : BLOCK);
  if (t < rows) s_start[t] = __ldg(start + i0 + t);
  if (t == 0) {
    s_start[rows] = __ldg(start + i0 + rows);
    n_long = n_vlong = 0;
  }
  __syncthreads();
  // stage [base, end): the span's first cells, from a 16-byte boundary
  const int64_t lo = s_start[0], hi = s_start[rows];
  const int64_t base = lo & ~(int64_t)3;
  const int64_t end = hi < base + STAGE ? hi : base + STAGE;
  if ((((uintptr_t)src) & 15) == 0) {
    const int nq = (int)((end - base + 3) >> 2);
    for (int q = t; q < nq; q += BLOCK) {
      const int64_t g = base + 4 * q;
      if (g + 4 <= src_len) {
        *(uint4*)(stage + 4 * q) = __ldg((const uint4*)(src + g));
      } else {
        for (int e = 0; e < 4 && g + e < src_len; ++e)
          stage[4 * q + e] = src[g + e];
      }
    }
  } else {
    for (int q = t; q < end - base; q += BLOCK)
      stage[q] = src[base + q];
  }
  int64_t s = 0, n = 0;
  if (t < rows) {
    s = s_start[t];
    n = s_start[t + 1] - s;
    if (n > MID)
      vlongs[atomicAdd(&n_vlong, 1)] = (int16_t)t;
    else if (n > SHORT)
      longs[atomicAdd(&n_long, 1)] = (int16_t)t;
  }
  __syncthreads();
  if (t < rows && n <= SHORT) {
    T v = fill;
    if (n > 0) {
      const T* p = s + n <= end ? stage + (s - base) : src + s;
      v = fold_short<T, OP>(p, (int)n, levels, fill);
    }
    out[i0 + t] = v;
  }
  for (int j = t >> 5; j < n_long; j += BLOCK / 32) {
    const int r = longs[j];
    const int64_t rs = s_start[r], rn = s_start[r + 1] - rs;
    const T* p = rs + rn <= end ? stage + (rs - base) : src + rs;
    const T v = fold_mid<T, OP>(p, rn, levels, fill);
    if ((t & 31) == 0) out[i0 + r] = v;
  }
  for (int j = 0; j < n_vlong; ++j) {
    const int r = vlongs[j];
    const int64_t rs = s_start[r], rn = s_start[r + 1] - rs;
    const T* p = rs + rn <= end ? stage + (rs - base) : src + rs;
    const T v = fold_long<T, OP>(p, rn, levels, fill, l2);
    if (t == 0) out[i0 + r] = v;
  }
}

template <typename T, int OP>
static int launch_cascade_op(const void* src, int64_t src_len,
                          const int32_t* start, void* out, int64_t n_rows,
                          int levels, uint32_t fill_bits, cudaStream_t st) {
  using namespace cascade;
  const int64_t grid = (n_rows + BLOCK - 1) / BLOCK;
  if (grid > 0)
    mono_cascade_kernel<T, OP><<<(unsigned)grid, BLOCK, 0, st>>>(
        (const T*)src, src_len, start, (T*)out, n_rows, levels, fill_bits);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_cascade(int fold_op, const void* src, int64_t src_len,
                          const int32_t* start, void* out, int64_t n_rows,
                          int levels, uint32_t fill_bits, cudaStream_t st) {
  using Launch = int (*)(const void*, int64_t, const int32_t*, void*,
                         int64_t, int, uint32_t, cudaStream_t);
  static const Launch by_op[] = {
      launch_cascade_op<T, FOLD_PLUS>, launch_cascade_op<T, FOLD_MIN>,
      launch_cascade_op<T, FOLD_MAX>, launch_cascade_op<T, FOLD_TIMES>,
      launch_cascade_op<T, FOLD_MAX>};      // ANY folds as MAX
  if (fold_op < FOLD_PLUS || fold_op > FOLD_ANY) return -1;
  return by_op[fold_op](src, src_len, start, out, n_rows, levels, fill_bits,
                        st);
}

// src: the level-0 source (src_len elements, at least the table's last
// entry); start: n_rows + 1 int32, non-decreasing from 0; out: n_rows
// elements; 1 <= levels <= 32; fold_op one of the xspmv folds (PLUS,
// MIN, MAX, TIMES; ANY folds as MAX).
extern "C" int pgb_mono_cascade(const void* src, int64_t src_len,
                                const void* start, void* out,
                                int64_t n_rows, int levels, int dtype,
                                int fold_op, uint32_t fill_bits,
                                void* stream) {
  if (levels < 1 || levels > cascade::MAX_LEVELS || n_rows < 0) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t* s = (const int32_t*)start;
  PGB_DISPATCH_WORD(dtype, launch_cascade<T>(fold_op, src, src_len, s, out,
                                             n_rows, levels, fill_bits, st));
}
