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
//   - each block takes a ticket from an atomic counter (not blockIdx),
//     and scans tile `ticket` (256 threads x 8 values): a serial scan of
//     each thread's 8 values, warp shuffles over the threads' (value,
//     flag) totals, a serial pass over the 8 warps' totals;
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
//
// Bound: bytes.  Each value and flag is read once and each result
// written once (9 bytes an element); the statuses are 8 bytes a tile.

#include "ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kAggregate = 1, kPrefix = 2;

// a (value, segment-start flag) pair; h = 0: the empty prefix
template <typename T>
struct Seg {
  T v;
  uint32_t f, h;
};

template <typename T>
__device__ __forceinline__ Seg<T> combine(int op, Seg<T> a, Seg<T> b) {
  if (!b.h) return a;
  if (!a.h) return b;
  return Seg<T>{b.f ? b.v : apply_fold<T>(op, a.v, b.v), a.f | b.f, 1u};
}

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(int32_t v) { return (uint32_t)v; }
template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b);
template <>
__device__ __forceinline__ float from_bits<float>(uint32_t b) { return __uint_as_float(b); }
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(uint32_t b) { return (int32_t)b; }

template <typename T>
__device__ __forceinline__ Seg<T> shfl_up(Seg<T> x, int d) {
  uint32_t v = __shfl_up_sync(0xffffffffu, bits_of(x.v), d);
  uint32_t fh = __shfl_up_sync(0xffffffffu, x.f | (x.h << 1), d);
  return Seg<T>{from_bits<T>(v), fh & 1u, fh >> 1};
}

template <typename T>
__device__ __forceinline__ Seg<T> shfl_down(Seg<T> x, int d) {
  uint32_t v = __shfl_down_sync(0xffffffffu, bits_of(x.v), d);
  uint32_t fh = __shfl_down_sync(0xffffffffu, x.f | (x.h << 1), d);
  return Seg<T>{from_bits<T>(v), fh & 1u, fh >> 1};
}

// status word: low 32 bits the value, high 32 bits
// epoch << 3 | flag << 2 | kind (kind 0: not yet published this call)
__device__ __forceinline__ void st_release64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

template <typename T>
__device__ __forceinline__ void publish(unsigned long long* st, uint32_t epoch,
                                        uint32_t kind, Seg<T> x) {
  const unsigned long long hi = (epoch << 3) | (x.f << 2) | kind;
  st_release64(st, (hi << 32) | bits_of(x.v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segfold_kernel(const T* __restrict__ vals, const uint8_t* __restrict__ flags,
               T* __restrict__ out, int64_t n, int op,
               unsigned long long* status, uint32_t epoch, int* ticket,
               int64_t n_tiles) {
  __shared__ int s_tile;
  __shared__ Seg<T> s_warp[kWarps];
  __shared__ Seg<T> s_prefix;
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    if (t == n_tiles - 1) atomicExch(ticket, 0);  // every ticket is taken
    s_tile = t;
  }
  __syncthreads();
  const int64_t tile = s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i0 = tile * kTile + (int64_t)threadIdx.x * kItems;
  const bool live = i0 < n;  // n % 1024 == 0: a thread's 8 are all in or out

  // 1. this thread's 8 values, scanned serially
  T v[kItems];
  uint32_t run[kItems];  // a segment start at or before item k (this thread)
  Seg<T> mine{T(0), 0u, 0u};
  if (live) {
    const uint4* vp = reinterpret_cast<const uint4*>(vals + i0);
    const uint4 a = vp[0], b = vp[1];
    const uint2 fw = *reinterpret_cast<const uint2*>(flags + i0);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const uint32_t fk = ((k < 4 ? fw.x : fw.y) >> (8 * (k & 3))) & 0xffu;
      const T x = from_bits<T>(w[k]);
      v[k] = (k == 0 || fk) ? x : apply_fold<T>(op, v[k - 1], x);
      run[k] = (k ? run[k - 1] : 0u) | (fk ? 1u : 0u);
    }
    mine = Seg<T>{v[kItems - 1], run[kItems - 1], 1u};
  }

  // 2. inclusive scan of the threads' totals within the warp
  Seg<T> inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg<T> y = shfl_up(inc, d);
    if (lane >= d) inc = combine(op, y, inc);
  }
  Seg<T> excl = shfl_up(inc, 1);
  if (lane == 0) excl.h = 0;
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();

  // 3. the warps' totals, serially; then the tile's look-back
  if (warp == 0) {
    Seg<T> total{T(0), 0u, 0u};
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const Seg<T> x = s_warp[w];
        s_warp[w] = total;  // now the exclusive prefix of warp w
        total = combine(op, total, x);
      }
      // a tile that holds a segment start needs nothing before it for
      // its inclusive prefix (its values before that start still do)
      publish(status + tile, epoch,
              tile == 0 || total.f ? kPrefix : kAggregate, total);
    }
    Seg<T> prefix{T(0), 0u, 0u};
    if (tile > 0) {
      int64_t end = tile;  // the window is tiles [end - 32, end)
      while (true) {
        const int64_t j = end - 32 + lane;
        Seg<T> x{T(0), 0u, 0u};
        bool stop = j < 0;
        if (j >= 0) {
          unsigned long long s;
          while (((s = ld_acquire64(status + j)) >> 35) != epoch ||
                 ((s >> 32) & 3u) == 0)
            __nanosleep(20);
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
          if ((lane & (2 * d - 1)) == 0 && lane + d < 32)
            x = combine(op, x, y);
        }
        prefix = combine(op, x, prefix);
        if (stops) break;
        end -= 32;
      }
    }
    if (lane == 0) {
      if (tile > 0 && !total.f)
        publish(status + tile, epoch, kPrefix,
                combine(op, prefix, total));
      s_prefix = prefix;
    }
  }
  __syncthreads();

  // 4. this thread's exclusive prefix, applied up to its first start
  if (!live) return;
  Seg<T> pre = combine(op, s_prefix, combine(op, s_warp[warp], excl));
  uint4* op4 = reinterpret_cast<uint4*>(out + i0);
  uint32_t w[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const T x = (pre.h && !run[k]) ? apply_fold<T>(op, pre.v, v[k]) : v[k];
    w[k] = bits_of(x);
  }
  op4[0] = make_uint4(w[0], w[1], w[2], w[3]);
  op4[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename T>
int launch(const void* vals, const void* flags, void* out, int64_t n, int op,
           void* status, uint32_t epoch, void* ticket, cudaStream_t st) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  segfold_kernel<T><<<(unsigned)n_tiles, kThreads, 0, st>>>(
      (const T*)vals, (const uint8_t*)flags, (T*)out, n, op,
      (unsigned long long*)status, epoch, (int*)ticket, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int64_t pgb_segfold_tiles(int64_t n) {
  return (n + kTile - 1) / kTile;
}

// values (n,) float32 or int32, flags (n,) bool, n % 1024 == 0; status:
// pgb_segfold_tiles(n) 8-byte words; ticket: one int, 0 between calls;
// epoch: nonzero, below 2^29, new for each call on this status buffer
extern "C" int pgb_segfold(const void* vals, const void* flags, void* out,
                           int64_t n, int dtype, int op, void* status,
                           uint32_t epoch, void* ticket, void* stream) {
  if (n <= 0) return 0;
  if (n % 1024 || epoch == 0 || epoch >= (1u << 29)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch<float>(vals, flags, out, n, op, status, epoch, ticket, st);
  if (dtype == DT_I32)
    return launch<int32_t>(vals, flags, out, n, op, status, epoch, ticket, st);
  return -1;
}
