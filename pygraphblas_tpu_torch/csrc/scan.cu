// Inclusive segmented fold-scan: the CUDA counterpart of
// pygraphblas_tpu/core/scan.py:_segfold_pallas.
//
//   out[i] = flags[i] ? values[i] : fold(out[i-1], values[i])
//
// i.e. the running monoid fold within each segment, segments starting
// at set flags.  The segmented combine
//   (va, fa) . (vb, fb) = (fb ? vb : fold(va, vb), fa | fb)
// is associative, so any grouping of a prefix gives the same answer
// (for a float PLUS up to rounding: the fold order differs from the
// plain version's log-step scan).
//
// The TPU kernel carries the running value from one grid block to the
// next in SMEM scratch, which is right only because a TPU grid runs its
// blocks in order (scan.py:68-72, 113-116).  CUDA blocks run in no
// order, so this is a single-pass scan with decoupled look-back:
//   - each block takes a ticket from an atomic counter (not blockIdx)
//     and scans tile `ticket` (256 threads x 16 values, loaded as five
//     16-byte words a thread): a serial scan of each thread's 16 values,
//     warp shuffles over the threads' (value, flag) totals, shuffles
//     over the 8 warps' totals in every warp;
//   - it publishes the tile's total (an "aggregate"; its inclusive
//     prefix already if the tile holds a segment start), then its warp 0
//     looks back over the 32 tiles before it at a time: it folds their
//     aggregates right to left until it meets a tile that has published
//     its inclusive prefix, or one that holds a segment start (nothing
//     before such a tile can reach this one), or the first tile;
//   - it publishes its own inclusive prefix and applies the exclusive
//     one to its values up to the tile's first segment start.
// A block waits only on tiles of smaller tickets, whose blocks took
// their tickets earlier and so are already running, and those never
// wait on later tiles: no deadlock, with no cooperative launch.  The
// block with the last ticket sets the counter back to 0 for the next
// call.  Each status word holds the value and, in its upper half, the
// number of the call (`epoch`, a caller-kept counter, as the cascade's
// flags in csrc/cascade.cu), so the status buffer is never cleared.
// One launch of this kernel is the whole scan: `segfold` counts one.
// It folds with any monoid of ops.cuh (the op a template argument): the
// arithmetic ones, ANY, the logical ones over 0/1 words and the bitwise
// ones, over float, int32 or uint32 words.
//
// Bound: bytes.  Each value and flag is read once and each result
// written once (9 bytes an element); the statuses are 8 bytes a tile:
// 0.7212 ms for esc14's four scans of 2^26 (an H100 at 3.35 TB/s).  The
// first port (2048-value tiles, 1.6443 ms there in chip_smoke on an
// H100 80GB HBM3 at 700 W) polled statuses with acquire loads and a
// sleep, folded the warps' totals serially and loaded 32 bytes of
// values a thread.  Here tiles are twice as long, polls are relaxed
// (the status word carries all a reader needs) and tight, the warps'
// totals are scanned by shuffles, and 8 blocks fit an SM.  Designs tried
// on the card and not kept (PERF.md): persistent blocks loading their
// next ticket's tile while they look back (a held ticket's aggregate
// comes an iteration late, which stalls every look-back behind it),
// look-back windows of 64 to 256 tiles, tiles of 2048 and 8192 values.

#include "ops.cuh"

namespace {

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

template <int OP, typename T>
__device__ __forceinline__ Seg<T> combine(Seg<T> a, Seg<T> b) {
  if (!b.h) return a;
  if (!a.h) return b;
  return Seg<T>{b.f ? b.v : fold_c<OP, T>(a.v, b.v), a.f | b.f, 1u};
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
template <typename T, int OP>
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
      if ((lane & (2 * d - 1)) == 0 && lane + d < 32) x = combine<OP>(x, y);
    }
    prefix = combine<OP>(x, prefix);
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
template <typename T, int OP>
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
      v[k] = (k == 0 || fk) ? x : fold_c<OP, T>(v[k - 1], x);
      starts |= (fk ? 1u : 0u) << k;
    }
    mine = Seg<T>{v[kItems - 1], starts ? 1u : 0u, 1u};
  }

  // 2. inclusive scan of the threads' totals within the warp
  Seg<T> inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg<T> y = shfl_up(inc, d);
    if (lane >= d) inc = combine<OP>(y, inc);
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
    if (lane >= d) wx = combine<OP>(y, wx);
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
        ? look_back<T, OP>(status, epoch, tile, lane)
        : Seg<T>{T(0), 0u, 0u};
    if (lane == 0) {
      if (tile > 0 && !total.f)
        publish(status + tile, epoch, kPrefix, combine<OP>(prefix, total));
      s_prefix = prefix;
    }
  }
  __syncthreads();

  // 5. this thread's exclusive prefix, applied up to its first start
  if (!live) return;
  const Seg<T> pre = combine<OP>(s_prefix, combine<OP>(wpre, excl));
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
                         ? fold_c<OP, T>(pre.v, v[k])
                         : v[k]);
    }
    op4[q] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T, int OP>
int launch_op(const void* vals, const void* flags, void* out, int64_t n,
              void* status, uint32_t epoch, void* ticket, cudaStream_t st) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  segfold_kernel<T, OP><<<(unsigned)n_tiles, kThreads, 0, st>>>(
      (const uint32_t*)vals, (const uint8_t*)flags, (uint32_t*)out, n,
      (unsigned long long*)status, epoch, (int*)ticket, (int)n_tiles);
  return (int)cudaGetLastError();
}

// the instantiations: floats fold arithmetically (and ANY); uint32 words
// only where order matters (MIN, MAX, ANY: the others take the int32
// ones, the same bits)
template <typename T>
constexpr bool seg_inst(int op) {
  if (std::is_same<T, uint32_t>::value)
    return op == FOLD_MIN || op == FOLD_MAX || op == FOLD_ANY;
  return fold_ok<T>(op);
}

template <typename T>
int launch(const void* vals, const void* flags, void* out, int64_t n, int op,
           void* status, uint32_t epoch, void* ticket, cudaStream_t st) {
#define PGB_SEG(OP)                                                       \
  case OP:                                                                \
    if constexpr (seg_inst<T>(OP))                                        \
      return launch_op<T, OP>(vals, flags, out, n, status, epoch, ticket, \
                              st);                                        \
    return -1;
  switch (op) {
    PGB_SEG(FOLD_PLUS) PGB_SEG(FOLD_MIN) PGB_SEG(FOLD_MAX)
    PGB_SEG(FOLD_TIMES) PGB_SEG(FOLD_ANY) PGB_SEG(FOLD_LOR)
    PGB_SEG(FOLD_LAND) PGB_SEG(FOLD_LXOR) PGB_SEG(FOLD_LXNOR)
    PGB_SEG(FOLD_BOR) PGB_SEG(FOLD_BAND) PGB_SEG(FOLD_BXOR)
    PGB_SEG(FOLD_BXNOR)
  }
#undef PGB_SEG
  return -1;
}

}  // namespace

extern "C" int64_t pgb_segfold_tiles(int64_t n) {
  return (n + kTile - 1) / kTile;
}

// values (n,) 4-byte words of dtype code `dtype`, flags (n,) bool,
// n % 1024 == 0, below 2^31 tiles; values and out 16-byte aligned, flags
// 16-byte aligned; op: a fold code the word type takes (ops.cuh);
// status: pgb_segfold_tiles(n) 8-byte words; ticket: one int, 0 between
// calls; epoch: nonzero, below 2^29, new for each call on this status
// buffer
extern "C" int pgb_segfold(const void* vals, const void* flags, void* out,
                           int64_t n, int dtype, int op, void* status,
                           uint32_t epoch, void* ticket, void* stream) {
  if (n <= 0) return 0;
  if (n % 1024 || epoch == 0 || epoch >= (1u << 29)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_U32 && !seg_inst<uint32_t>(op)) dtype = DT_I32;
  PGB_DISPATCH_WORD(dtype, launch<T>(vals, flags, out, n, op, status, epoch,
                                     ticket, st));
}
