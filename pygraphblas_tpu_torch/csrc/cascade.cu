// The xspmv fold cascade in one launch: the CUDA counterpart of
// pygraphblas_tpu/core/mono.py:mono_cascade.
//
// Levels 0..n-2 are span-encoded monotone gathers with an 8-slot fold
// (mono_span's arithmetic); level n-1 is the final placement, a plain
// span gather.  Level l reads level l-1's output:
//
//   dst_l[g, lane] = fold_{s=0..7} src_l[qg_l[g] * 128 + dm_l[8g+s, lane]]
//
// (dm < 0 -> fill; the fold in the order s = 0..7, so PLUS folds equal
// the per-level chain bit for bit).
//
// The TPU runs the cascade as one grid-less program that keeps every
// level in VMEM scratch, serialising some 24k 8-row groups at kron-20.
// Here it is one cooperative persistent kernel.  The work is cut into
// tiles of 2 groups (one 256-thread block, a thread per output lane),
// numbered level by level, and the grid (as large as the card holds at
// once: occupancy x SMs) takes them grid-strided in that order.  A
// level's groups read only a window of the level before: group g reads
// source rows qg[g] .. qg[g] + wva - 1, which are the outputs of that
// level's groups of the same numbers.  So in place of a grid-wide
// barrier between levels, a tile waits only for the tiles of the level
// before that wrote its window: each finished tile publishes a flag
// (release), and a tile acquires the flags it needs before it reads.
// A block streams its next tile's dm (4 KB, contiguous) into shared
// memory with cp.async while it waits on and computes the current one,
// so the dm bytes, most of the cascade's, keep flowing.  (On an H100 at
// kron-20, 256-thread tiles were the fastest of 128 to 1024 threads,
// and folding several groups a thread was slower.)
//
// No deadlock: a tile waits only on tiles of smaller number; a block
// takes its tiles in increasing order; and the cooperative launch makes
// every block co-resident, so the block owning the smallest unfinished
// tile always runs.  Flags hold the number of the call (`epoch`, a
// caller-kept counter that never repeats on one buffer), so the buffer
// is never cleared.
//
// Each thread computes its source index directly and clips it as the
// plain version does, so no window reads past a buffer: the TPU
// kernel's pad rows (mono.py:441-446) have nothing to guard here.  The
// per-level buffers are device memory (a few MB, so they stay in the 50
// MB L2); the wrapper allocates them.  A level's source, written by
// other blocks in this launch, is read from L2 (ld.global.cg).
//
// Bound: bytes.  Every level's dm (2 B a cell) and qg, the first source
// and the placed output; the intermediates stay in L2.

#include <cstring>

#include "ops.cuh"

constexpr int CASCADE_MAX = 32;
constexpr int CASCADE_THREADS = 256;
constexpr int TILE_GROUPS = CASCADE_THREADS / 128;

struct CascadeLevel {
  const int32_t* qg;
  const int16_t* dm;
  const void* src;
  void* dst;
  int64_t src_len;
  int64_t n_groups;
  int64_t tile0;  // number of this level's first tile
  int64_t wva;    // source rows a group's window spans
};

struct CascadeArgs {
  CascadeLevel lv[CASCADE_MAX];
  int n;
  int fold_op;
  uint32_t fill_bits;
  int* flags;  // one a tile: the epoch of the call that finished it
  int epoch;
  int64_t n_tiles;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// the level of tile t, from the level of an earlier tile
__device__ __forceinline__ int level_of(const CascadeArgs& a, int64_t t,
                                        int l) {
  while (l + 1 < a.n && t >= a.lv[l + 1].tile0) ++l;
  return l;
}

// this thread's 16 B of tile t's dm (level l) into shared memory, then
// a cp.async group boundary (an empty group past the last tile)
__device__ __forceinline__ void fetch_dm(const CascadeArgs& a, int64_t t,
                                         int l, int16_t* buf) {
  if (t < a.n_tiles) {
    const CascadeLevel& lv = a.lv[l];
    const int64_t off = (t - lv.tile0) * (TILE_GROUPS * 8 * 128) +
                        threadIdx.x * 8;
    if (off < lv.n_groups * 8 * 128) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(
          buf + threadIdx.x * 8);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                   "l"(lv.dm + off)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(CASCADE_THREADS, 2)
mono_cascade_kernel(const CascadeArgs a) {
  __shared__ __align__(16) int16_t dms[2][TILE_GROUPS * 8 * 128];
  T fill;
  memcpy(&fill, &a.fill_bits, sizeof(T));
  const int lane = threadIdx.x & 127;
  const int sub = threadIdx.x >> 7;
  int64_t t = blockIdx.x;
  int l = level_of(a, t, 0);
  fetch_dm(a, t, l, dms[0]);
  for (int k = 0; t < a.n_tiles; t += gridDim.x, k ^= 1) {
    const int64_t tn = t + gridDim.x;
    const int ln = tn < a.n_tiles ? level_of(a, tn, l) : l;
    fetch_dm(a, tn, ln, dms[k ^ 1]);
    const CascadeLevel& lv = a.lv[l];
    const int64_t tile = t - lv.tile0;
    const int64_t g = tile * TILE_GROUPS + sub;
    const bool live = g < lv.n_groups;
    const bool folded = l + 1 < a.n;
    const int64_t base = live ? (int64_t)__ldg(lv.qg + g) * 128 : 0;
    if (l > 0 && threadIdx.x < 32) {
      // the tiles of level l-1 that wrote rows qg[g0] .. qg[g1] + wva - 1,
      // one flag a lane
      const CascadeLevel& pv = a.lv[l - 1];
      const int64_t g0 = tile * TILE_GROUPS;
      int64_t g1 = g0 + TILE_GROUPS - 1;
      if (g1 >= lv.n_groups) g1 = lv.n_groups - 1;
      int64_t r0 = __ldg(lv.qg + g0), r1 = __ldg(lv.qg + g1) + lv.wva - 1;
      const int64_t last = pv.n_groups - 1;
      r0 = r0 > last ? last : r0;
      r1 = r1 > last ? last : r1;
      for (int64_t f = pv.tile0 + r0 / TILE_GROUPS + threadIdx.x;
           f <= pv.tile0 + r1 / TILE_GROUPS; f += 32)
        while (ld_acquire(a.flags + f) != a.epoch) __nanosleep(32);
    }
    // this tile's dm has landed (the next tile's group may still fly)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    if (live) {
      const int16_t* dm = dms[k] + sub * 8 * 128 + lane;
      const T* src = (const T*)lv.src;
      T* dst = (T*)lv.dst;
      const int64_t src_len = lv.src_len;
      T acc = fill;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int d = dm[s * 128];
        T v = fill;
        if (d >= 0) {
          int64_t i = base + d;
          i = i < 0 ? 0 : (i >= src_len ? src_len - 1 : i);
          v = l == 0 ? __ldg(src + i) : __ldcg(src + i);
        }
        if (!folded)
          dst[(g * 8 + s) * 128 + lane] = v;
        else
          acc = s == 0 ? v : apply_fold<T>(a.fold_op, acc, v);
      }
      if (folded) dst[g * 128 + lane] = acc;
    }
    // every write of this tile (and every read of dms[k]) is done
    __syncthreads();
    if (folded && threadIdx.x == 0) st_release(a.flags + t, a.epoch);
    l = ln;
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

template <typename T>
static int launch_cascade(const CascadeArgs& a, cudaStream_t st) {
  // grid: every block co-resident (a cooperative launch refuses more)
  static int per_sm = -1, sms = -1;
  if (per_sm < 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mono_cascade_kernel<T>, CASCADE_THREADS, 0);
    if (e != cudaSuccess) {
      per_sm = -1;
      return (int)e;
    }
  }
  int64_t grid = (int64_t)per_sm * sms;
  if (grid > a.n_tiles) grid = a.n_tiles;
  if (grid < 1) return -1;
  void* args[] = {(void*)&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)mono_cascade_kernel<T>, dim3((unsigned)grid),
      dim3(CASCADE_THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Tiles a cascade of n plans of n_groups[i] groups needs flags for.
extern "C" int64_t pgb_mono_cascade_tiles(int n, const int64_t* n_groups) {
  int64_t tiles = 0;
  for (int i = 0; i < n; ++i)
    tiles += (n_groups[i] + TILE_GROUPS - 1) / TILE_GROUPS;
  return tiles;
}

// n plans: qg[i], dm[i] (int16), n_groups[i], wva[i]; bufs[0] is the
// source, bufs[i + 1] the output of plan i (bufs[n] the placed output);
// lens[i] is the length in elements of bufs[i].  flags: n_flags int32
// on the card (at least pgb_mono_cascade_tiles), none holding `epoch`.
extern "C" int pgb_mono_cascade(int n, const void* const* qg,
                                const void* const* dm,
                                const int64_t* n_groups, const int64_t* wva,
                                void* const* bufs, const int64_t* lens,
                                int dtype, int fold_op, uint32_t fill_bits,
                                void* flags, int64_t n_flags, int epoch,
                                void* stream) {
  if (n < 2 || n > CASCADE_MAX || fold_op < 0 || !flags) return -1;
  CascadeArgs a;
  a.n = n;
  a.fold_op = fold_op;
  a.fill_bits = fill_bits;
  a.flags = (int*)flags;
  a.epoch = epoch;
  int64_t tiles = 0;
  for (int i = 0; i < n; ++i) {
    a.lv[i].qg = (const int32_t*)qg[i];
    a.lv[i].dm = (const int16_t*)dm[i];
    a.lv[i].src = bufs[i];
    a.lv[i].dst = bufs[i + 1];
    a.lv[i].src_len = lens[i];
    a.lv[i].n_groups = n_groups[i];
    a.lv[i].tile0 = tiles;
    a.lv[i].wva = wva[i];
    if (n_groups[i] < 1 || wva[i] < 1 || (uintptr_t)dm[i] % 16) return -1;
    tiles += (n_groups[i] + TILE_GROUPS - 1) / TILE_GROUPS;
  }
  a.n_tiles = tiles;
  if (n_flags < tiles) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32) return launch_cascade<float>(a, st);
  if (dtype == DT_I32) return launch_cascade<int32_t>(a, st);
  return -1;
}
