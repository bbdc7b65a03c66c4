// The segmented fold-scan kernel (see scan.cu for its design), with
// the fold a functor type F: F()(a, b) folds two words of type T.
// scan.cu instantiates it at the built-in fold codes (FoldCode, ops.cuh);
// a generated translation unit (_opgen.py) at a user monoid's fold.

#pragma once

#include "ops.cuh"

namespace {
namespace scan {

constexpr int kThreads = 256;
constexpr int kItems = 16;              // values a thread, contiguous
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = kItems / 4;        // 16-byte words of values a thread
constexpr uint32_t kAggregate = 1, kPrefix = 2;
// n % 1024 == 0 and kItems | 1024: a thread's values are all in or out

// a (value, segment-start flag) pair; h = 0: the empty prefix
template <typename T>
struct Seg {
  T v;
  uint32_t f, h;
};

template <typename F, typename T>
__device__ __forceinline__ Seg<T> combine(Seg<T> a, Seg<T> b) {
  if (!b.h) return a;
  if (!a.h) return b;
  return Seg<T>{b.f ? b.v : F()(a.v, b.v), a.f | b.f, 1u};
}

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(int32_t v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits_of(uint32_t v) { return v; }
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b);
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t b) { return (int32_t)b; }
template <>
__device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t b) { return b; }

template <typename T>
__device__ __forceinline__ Seg<T> unpack(uint32_t v, uint32_t fh) {
  return Seg<T>{from_bits<T>(v), fh & 1u, fh >> 1};
}

template <typename T>
__device__ __forceinline__ Seg<T> shfl_up(Seg<T> x, int d) {
  return unpack<T>(__shfl_up_sync(0xffffffffu, bits_of(x.v), d),
                   __shfl_up_sync(0xffffffffu, x.f | (x.h << 1), d));
}

template <typename T>
__device__ __forceinline__ Seg<T> shfl_down(Seg<T> x, int d) {
  return unpack<T>(__shfl_down_sync(0xffffffffu, bits_of(x.v), d),
                   __shfl_down_sync(0xffffffffu, x.f | (x.h << 1), d));
}

template <typename T>
__device__ __forceinline__ Seg<T> shfl(Seg<T> x, int lane) {
  return unpack<T>(__shfl_sync(0xffffffffu, bits_of(x.v), lane),
                   __shfl_sync(0xffffffffu, x.f | (x.h << 1), lane));
}

// status word: low 32 bits the value, high 32 bits
// epoch << 3 | flag << 2 | kind (kind 0: not yet published this call).
// The word carries all a reader needs, so relaxed accesses suffice
// (acquire polls measured slower).
__device__ __forceinline__ void st_status(unsigned long long* p,
                                          unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <typename T>
__device__ __forceinline__ void publish(unsigned long long* st, uint32_t epoch,
                                        uint32_t kind, Seg<T> x) {
  const unsigned long long hi = (epoch << 3) | (x.f << 2) | kind;
  st_status(st, (hi << 32) | bits_of(x.v));
}

// The exclusive prefix of `tile` (> 0), in lane 0 of the calling warp:
// 32 tiles at a time, lane l polling tile end - 32 + l, folded right to
// left down to the last tile that has published its inclusive prefix or
// holds a segment start (nothing before such a tile can reach this one),
// or down to tile 0.  (Windows of 64 to 256 tiles measured slower.)
template <typename T, typename F>
__device__ __forceinline__ Seg<T> look_back(
    const unsigned long long* status, uint32_t epoch, int64_t tile,
    int lane) {
  Seg<T> prefix{T(0), 0u, 0u};
  for (int64_t end = tile;; end -= 32) {
    const int64_t j = end - 32 + lane;
    Seg<T> x{T(0), 0u, 0u};
    bool stop = j < 0;
    if (j >= 0) {
      unsigned long long s;
      while (((s = ld_status(status + j)) >> 35) != epoch ||
             ((s >> 32) & 3u) == 0) {
      }
      const uint32_t hi = (uint32_t)(s >> 32);
      x = Seg<T>{from_bits<T>((uint32_t)s), (hi >> 2) & 1u, 1u};
      stop = (hi & 3u) == kPrefix || x.f;
    }
    const uint32_t stops = __ballot_sync(0xffffffffu, stop);
    const int from = stops ? 31 - __clz(stops) : 0;
    if (lane < from) x.h = 0;
    // ordered fold of lanes from..31 into lane 0
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg<T> y = shfl_down(x, d);
      if ((lane & (2 * d - 1)) == 0 && lane + d < 32) x = combine<F>(x, y);
    }
    prefix = combine<F>(x, prefix);
    if (stops) return prefix;
  }
}

// a thread's share of a tile as loaded: its values' bits, its flag bytes
struct Chunk {
  uint4 v[kVec];
  uint32_t f[kItems / 4];
};

__device__ __forceinline__ void load_chunk(Chunk& c,
                                           const uint32_t* __restrict__ vals,
                                           const uint8_t* __restrict__ flags,
                                           int64_t i0) {
  const uint4* vp = reinterpret_cast<const uint4*>(vals + i0);
#pragma unroll
  for (int q = 0; q < kVec; ++q) c.v[q] = __ldcs(vp + q);
  const uint4 f = __ldcs(reinterpret_cast<const uint4*>(flags + i0));
  c.f[0] = f.x, c.f[1] = f.y, c.f[2] = f.z, c.f[3] = f.w;
}

__device__ __forceinline__ uint32_t word(const uint4& q, int e) {
  return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
}

// a ticket; the block that takes the last one sets the counter back to 0
__device__ __forceinline__ int take(int* ticket, int last) {
  const int t = atomicAdd(ticket, 1);
  if (t == last) atomicExch(ticket, 0);
  return t;
}

// 8 blocks an SM (32 registers a thread) measured fastest
template <typename T, typename F>
__global__ void __launch_bounds__(kThreads, 8)
segfold_kernel(const uint32_t* __restrict__ vals,
               const uint8_t* __restrict__ flags, uint32_t* __restrict__ out,
               int64_t n, unsigned long long* status, uint32_t epoch,
               int* ticket, int n_tiles) {
  __shared__ int s_tile;
  __shared__ Seg<T> s_warp[kWarps];
  __shared__ Seg<T> s_prefix;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = take(ticket, n_tiles - 1);
  __syncthreads();
  const int tile = s_tile;
  const int64_t i0 = (int64_t)tile * kTile + (int64_t)threadIdx.x * kItems;
  const bool live = i0 < n;

  // 1. this thread's values, scanned serially; bit k of `starts`: a
  //    segment start at value k
  T v[kItems];
  uint32_t starts = 0;
  Seg<T> mine{T(0), 0u, 0u};
  if (live) {
    Chunk cur;
    load_chunk(cur, vals, flags, i0);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const uint32_t fk = (cur.f[k >> 2] >> (8 * (k & 3))) & 0xffu;
      const T x = from_bits<T>(word(cur.v[k >> 2], k & 3));
      v[k] = (k == 0 || fk) ? x : F()(v[k - 1], x);
      starts |= (fk ? 1u : 0u) << k;
    }
    mine = Seg<T>{v[kItems - 1], starts ? 1u : 0u, 1u};
  }

  // 2. inclusive scan of the threads' totals within the warp
  Seg<T> inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg<T> y = shfl_up(inc, d);
    if (lane >= d) inc = combine<F>(y, inc);
  }
  Seg<T> excl = shfl_up(inc, 1);
  if (lane == 0) excl.h = 0;
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();

  // 3. the warps' totals, scanned by every warp in its lanes
  Seg<T> wx = lane < kWarps ? s_warp[lane] : Seg<T>{T(0), 0u, 0u};
#pragma unroll
  for (int d = 1; d < kWarps; d <<= 1) {
    const Seg<T> y = shfl_up(wx, d);
    if (lane >= d) wx = combine<F>(y, wx);
  }
  const Seg<T> total = shfl(wx, kWarps - 1);
  Seg<T> wpre = shfl(wx, warp > 0 ? warp - 1 : 0);
  if (warp == 0) wpre.h = 0;

  // 4. the tile's look-back
  if (warp == 0) {
    // a tile that holds a segment start needs nothing before it for its
    // inclusive prefix (its values before that start still do)
    if (lane == 0)
      publish(status + tile, epoch,
              tile == 0 || total.f ? kPrefix : kAggregate, total);
    const Seg<T> prefix = tile > 0
        ? look_back<T, F>(status, epoch, tile, lane)
        : Seg<T>{T(0), 0u, 0u};
    if (lane == 0) {
      if (tile > 0 && !total.f)
        publish(status + tile, epoch, kPrefix, combine<F>(prefix, total));
      s_prefix = prefix;
    }
  }
  __syncthreads();

  // 5. this thread's exclusive prefix, applied up to its first start
  if (!live) return;
  const Seg<T> pre = combine<F>(s_prefix, combine<F>(wpre, excl));
  // bit k: a start at or before value k
  const uint32_t run = starts ? ~0u << (__ffs(starts) - 1) : 0u;
  uint4* op4 = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      w[e] = bits_of((pre.h && !((run >> k) & 1u))
                         ? F()(pre.v, v[k])
                         : v[k]);
    }
    op4[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, typename F>
int launch_segfold(const void* vals, const void* flags, void* out, int64_t n,
                   void* status, uint32_t epoch, void* ticket,
                   cudaStream_t st) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  segfold_kernel<T, F><<<(unsigned)n_tiles, kThreads, 0, st>>>(
      (const uint32_t*)vals, (const uint8_t*)flags, (uint32_t*)out, n,
      (unsigned long long*)status, epoch, (int*)ticket, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace scan
}  // namespace
