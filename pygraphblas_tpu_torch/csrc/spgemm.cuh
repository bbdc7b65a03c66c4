// The masked SpGEMM intersect kernels' shared helpers and pair_fold's
// kernels (their design below; pair_count's and the file's in
// spgemm.cu), with the multiply and the fold functor types M and F:
// mul(a, b) and fold(a, b) on words of type T.  spgemm.cu instantiates pair_fold at the built-in codes (MulSwitch,
// FoldSwitch: ops.cuh); a generated translation unit (_opgen.py) at a
// user semiring's ops.

#pragma once

#include <cstring>

#include "ops.cuh"

namespace {
namespace spgemm {

constexpr int kThreads = 256;        // 8 warps: 8 edges a block
constexpr unsigned kFull = 0xffffffffu;

// edge e's segment of a column array of n entries: its start and length,
// clipped to the array (a segment outside it is outside the wrappers'
// contract; the clip only keeps every read inside the array)
__device__ __forceinline__ int segment(const int32_t* __restrict__ st,
                                       const int32_t* __restrict__ w,
                                       int64_t e, int64_t n, int64_t* s) {
  int64_t a = st[e], b = a + w[e];
  a = a < 0 ? 0 : (a > n ? n : a);
  b = b < a ? a : (b > n ? n : b);
  *s = a;
  return (int)(b - a);
}

// first index i in l[lo, n) with l[i] >= key
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ l,
                                           int lo, int n, int32_t key) {
  int hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(l + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// the pair_count and pair_fold kernels' blocks (spgemm.cu)
constexpr int kPcThreads = 512;
constexpr int kPcWarps = kPcThreads / 32;
constexpr int kPcChunk = kPcThreads;     // most edges a block, one a thread
constexpr int kBitWords = 8192;          // 32 KB: a window of 2^18 ids
constexpr int64_t kBitIds = (int64_t)kBitWords * 32;
constexpr int kMinRun = 8;
constexpr int kShortThreads = 256;

// exclusive prefix of `flag` over the block, and the block's total;
// wsum: kPcWarps ints of shared memory
__device__ __forceinline__ int block_scan(bool flag, int* wsum, int* total) {
  const unsigned m = __ballot_sync(kFull, flag);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) wsum[w] = __popc(m);
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < kPcWarps; ++i) {
    const int v = wsum[i];
    base += i < w ? v : 0;
    tot += v;
  }
  __syncthreads();                   // wsum is free for the next scan
  *total = tot;
  return base + __popc(m & ((1u << lane) - 1));
}

// sum over the aligned groups of `group` lanes
__device__ __forceinline__ int group_sum(int c, int group) {
  for (int off = group >> 1; off; off >>= 1)
    c += __shfl_xor_sync(kFull, c, off);
  return c;
}

// edge e's lists, the shorter first; returns whether the longer is A's
__device__ __forceinline__ bool edge_lists(
    const int32_t* __restrict__ ast, const int32_t* __restrict__ wa,
    const int32_t* __restrict__ bst, const int32_t* __restrict__ wb,
    int64_t e, int64_t a_len, int64_t b_len, int64_t* s_st, int* ns,
    int64_t* l_st, int* nl) {
  int64_t sa, sb;
  const int na = segment(ast, wa, e, a_len, &sa);
  const int nb = segment(bst, wb, e, b_len, &sb);
  const bool la = na >= nb;
  *l_st = la ? sa : sb;
  *nl = la ? na : nb;
  *s_st = la ? sb : sa;
  *ns = la ? nb : na;
  return la;
}

// pair_fold (replaces spgemm.py:_pallas_fill_merge_fold).  Bound: the
// ids read once and four int32 an edge, against the fewer of a merge's
// and a search's compares.  Per edge the count of A ∩ B and the fold of
// mul(A's value, B's value) over it (A's operand first, whichever list
// the lanes walk): each lane folds its matches, then the lanes of the
// edge by xor shuffles.  The first port (one warp an edge, each lane
// binary-searching the longer list through L2 for its ids of the
// shorter: 0.4956 ms at val16 on an H100 80GB HBM3 at 700 W) left most
// lanes idle in the narrow buckets and reread a run's shared A list for
// every edge.  Three kernels, the bucket's chosen by its shape before
// launch (the wrapper's rule, core/spgemm.py:fold_path):
//   - widths up to 512: pair_fold_search_kernel, 4 lanes an edge at
//     width 128, 8 at 256 and 16 at 512 (the shorter list holds at most
//     half the width), each lane searching its ids of the shorter list
//     in the longer;
//   - widths from 1024 with at least 32768 edges: pair_fold_kernel,
//     pair_count's runs with values.  A block splits its chunk of edges
//     into runs of equal A list; a run of kMinRun edges or more marks
//     A's list in the bitmap and ranks it in a directory beside it (each
//     word's count of marks in the words before it, 2 bytes a word: A
//     lists hold at most WIDTH_CAP = 32768 ids), so that a B id marked
//     at bit p of word w is A's entry dir[w] + popc(bits[w] below p) of
//     the window.  The run's edges probe it 8 lanes an edge, 4 edges a
//     warp (a warp an edge waited on one edge's round trips at a time),
//     and a round's hits load their A and B values together.  Edges
//     whose B list holds over 8x A's ids search A's ids in B, and the
//     edges of shorter runs search, a warp an edge;
//   - wider buckets with fewer edges: pair_fold_warp_kernel, the first
//     port's kernel.  There the runs kernel lost to it in development
//     builds on the card: too few edges to give every SM long chunks.

// the fold of mul(A value, B value) into (c, acc) for one match
template <typename T, typename M, typename F>
__device__ __forceinline__ void take(int* c, T* acc, M mul, F fold, T x_a,
                                     T x_b) {
  ++*c;
  *acc = fold(*acc, mul(x_a, x_b));
}

// fold over the aligned groups of `group` lanes
template <typename T, typename F>
__device__ __forceinline__ T group_fold(T v, int group, F fold) {
  for (int off = group >> 1; off; off >>= 1)
    v = fold(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// count_found with values: s[gl], s[gl + step], ... searched in l;
// s_is_a says which list is A's (its value is mul's first operand)
template <typename T, typename M, typename F>
__device__ __forceinline__ void fold_found(
    const int32_t* __restrict__ s, const T* __restrict__ sv, int ns,
    const int32_t* __restrict__ l, const T* __restrict__ lv, int nl,
    bool s_is_a, int gl, int step, M mul, F fold, int* c, T* acc) {
  int from = 0;
  for (int p = gl; p < ns; p += step) {
    const int32_t key = __ldg(s + p);
    from = lower_bound(l, from, nl, key);
    if (from < nl && __ldg(l + from) == key) {
      const T x_s = __ldg(sv + p), x_l = __ldg(lv + from);
      take(c, acc, mul, fold, s_is_a ? x_s : x_l, s_is_a ? x_l : x_s);
    }
  }
}

// count_marked with values: B's ids s[gl], s[gl + step], ... probed in
// the bitmap window of ids [w0, w0 + kBitIds), four at a time; a marked
// id is A's entry av[dir[w] + popc(bits[w] below it)] (av: A's values
// from its first id in the window).  The round's hits issue their value
// loads together, before any is folded.
template <typename T, typename M, typename F>
__device__ __forceinline__ void fold_marked(
    const int32_t* __restrict__ s, const T* __restrict__ sv, int ns,
    const uint32_t* bits, const uint16_t* dir, const T* __restrict__ av,
    int64_t w0, int gl, int step, M mul, F fold, int* c, T* acc) {
  for (int p0 = gl; p0 < ns; p0 += 4 * step) {
    int off[4];                  // ids and w0 lie in [0, 2^31)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = p0 + u * step;
      off[u] = p < ns ? __ldg(s + p) - (int)w0 : -1;
    }
    int rank[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      rank[u] = -1;
      if ((unsigned)off[u] < (unsigned)kBitIds) {
        const int w = off[u] >> 5, bit = off[u] & 31;
        const uint32_t m = bits[w];
        if ((m >> bit) & 1) rank[u] = dir[w] + __popc(m & ((1u << bit) - 1));
      }
    }
    T x_a[4], x_b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (rank[u] >= 0) {
        x_a[u] = __ldg(av + rank[u]);
        x_b[u] = __ldg(sv + p0 + u * step);
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (rank[u] >= 0) take(c, acc, mul, fold, x_a[u], x_b[u]);
  }
}

// exclusive prefix sum of v over the block, and the block's total;
// wsum: kPcWarps ints of shared memory
__device__ __forceinline__ int block_sum_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < kPcWarps; ++i) {
    const int u = wsum[i];
    base += i < w ? u : 0;
    tot += u;
  }
  __syncthreads();
  *total = tot;
  return base + x - v;
}

// G lanes an edge, each searching the longer list for its ids of the
// shorter
template <typename T, int G, typename M, typename F>
__global__ void __launch_bounds__(kShortThreads)
pair_fold_search_kernel(const int32_t* __restrict__ a,
                        const T* __restrict__ av, int64_t a_len,
                        const int32_t* __restrict__ b,
                        const T* __restrict__ bv, int64_t b_len,
                        const int32_t* __restrict__ ast,
                        const int32_t* __restrict__ wa,
                        const int32_t* __restrict__ bst,
                        const int32_t* __restrict__ wb,
                        int32_t* __restrict__ cnt, T* __restrict__ out,
                        int64_t n_edges, M mul, F fold, T ident) {
  const int64_t e = ((int64_t)blockIdx.x * kShortThreads + threadIdx.x) / G;
  const int gl = threadIdx.x % G;
  constexpr int group = G;
  int c = 0;
  T acc = ident;
  if (e < n_edges) {
    int64_t s_st, l_st;
    int ns, nl;
    const bool la = edge_lists(ast, wa, bst, wb, e, a_len, b_len, &s_st,
                               &ns, &l_st, &nl);
    fold_found((la ? b : a) + s_st, (la ? bv : av) + s_st, ns,
               (la ? a : b) + l_st, (la ? av : bv) + l_st, nl, !la, gl,
               group, mul, fold, &c, &acc);
  }
  c = group_sum(c, group);
  acc = group_fold(acc, group, fold);
  if (e < n_edges && gl == 0) {
    cnt[e] = c;
    out[e] = acc;
  }
}

// the first port's kernel: one warp an edge, each lane binary-searching
// the longer list for its ids of the shorter (the search kernel at 32
// lanes an edge measured slower than it)
template <typename T, typename M, typename F>
__global__ void pair_fold_warp_kernel(const int32_t* __restrict__ a,
                                      const T* __restrict__ av,
                                      int64_t a_len,
                                      const int32_t* __restrict__ b,
                                      const T* __restrict__ bv,
                                      int64_t b_len,
                                      const int32_t* __restrict__ ast,
                                      const int32_t* __restrict__ wa,
                                      const int32_t* __restrict__ bst,
                                      const int32_t* __restrict__ wb,
                                      int32_t* __restrict__ cnt,
                                      T* __restrict__ out, int64_t n_edges,
                                      M mul, F fold, T ident) {
  int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (e >= n_edges) return;          // warp-uniform
  int64_t sa, sb;
  int na = segment(ast, wa, e, a_len, &sa);
  int nb = segment(bst, wb, e, b_len, &sb);
  bool walk_a = na <= nb;
  const int32_t* s = walk_a ? a + sa : b + sb;
  const int32_t* l = walk_a ? b + sb : a + sa;
  const T* vs = walk_a ? av + sa : bv + sb;
  const T* vl = walk_a ? bv + sb : av + sa;
  int ns = walk_a ? na : nb, nl = walk_a ? nb : na;
  int c = 0, from = 0;
  T acc = ident;
  for (int p = lane; p < ns; p += 32) {
    int32_t key = __ldg(s + p);
    from = lower_bound(l, from, nl, key);
    if (from < nl && __ldg(l + from) == key) {
      ++c;
      T x = walk_a ? mul(vs[p], vl[from]) : mul(vl[from], vs[p]);
      acc = fold(acc, x);
    }
  }
  c = __reduce_add_sync(kFull, c);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc = fold(acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) {
    cnt[e] = c;
    out[e] = acc;
  }
}

// the runs kernel probes an edge's B list with kRunLanes lanes, so that
// a warp has kRunEdges edges' loads in flight at once
constexpr int kRunLanes = 8;
constexpr int kRunEdges = 32 / kRunLanes;

// the longest A list the 2-byte directory ranks (longer lists, past
// the wrappers' WIDTH_CAP, are searched)
constexpr int kMaxRanked = 65535;

template <typename T, typename M, typename F>
__global__ void __launch_bounds__(kPcThreads)
pair_fold_kernel(const int32_t* __restrict__ a, const T* __restrict__ av,
                 int64_t a_len, const int32_t* __restrict__ b,
                 const T* __restrict__ bv, int64_t b_len,
                 const int32_t* __restrict__ ast,
                 const int32_t* __restrict__ wa,
                 const int32_t* __restrict__ bst,
                 const int32_t* __restrict__ wb,
                 int32_t* __restrict__ cnt_out, T* __restrict__ out,
                 int64_t n_edges, int chunk, M mul, F fold,
                 T ident) {
  extern __shared__ uint32_t bits[];               // kBitWords
  uint16_t* dir = (uint16_t*)(bits + kBitWords);   // kBitWords
  int* a_s = (int*)(dir + kBitWords);              // A's list: start,
  int* a_n = a_s + kPcChunk;                       // length
  int* b_s = a_n + kPcChunk;                       // B's
  int* b_n = b_s + kPcChunk;
  int* cnt = b_n + kPcChunk;
  T* val = (T*)(cnt + kPcChunk);
  int* runs = (int*)(val + kPcChunk);              // run starts, then ne
  int* queue = runs + kPcChunk + 1;                // edges of short runs
  int* wsum = queue + kPcChunk;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t e0 = (int64_t)blockIdx.x * chunk;
  const int ne = (int)(n_edges - e0 < chunk ? n_edges - e0 : chunk);
  for (int i = t; i < kBitWords; i += kPcThreads) bits[i] = 0;
  const bool valid = t < ne;
  if (valid) {
    int64_t sa, sb;
    a_n[t] = segment(ast, wa, e0 + t, a_len, &sa);
    b_n[t] = segment(bst, wb, e0 + t, b_len, &sb);
    a_s[t] = (int)sa;
    b_s[t] = (int)sb;
    cnt[t] = 0;
    val[t] = ident;
  }
  __syncthreads();
  const bool start =
      valid && (t == 0 || a_s[t] != a_s[t - 1] || a_n[t] != a_n[t - 1]);
  int nruns;
  const int before = block_scan(start, wsum, &nruns);
  if (start) runs[before] = t;
  if (t == 0) runs[nruns] = ne;
  __syncthreads();
  bool in_short = false;
  if (valid) {
    const int r = before + start - 1;              // this edge's run
    in_short = runs[r + 1] - runs[r] < kMinRun || a_n[t] > kMaxRanked;
  }
  int nshort;
  const int qpos = block_scan(in_short, wsum, &nshort);
  if (in_short) queue[qpos] = t;
  __syncthreads();

  // edges of short runs: a warp an edge, the shorter list's ids searched
  // in the longer
  for (int i = warp; i < nshort; i += kPcWarps) {
    const int k = queue[i];
    const bool la = a_n[k] >= b_n[k];
    int c = 0;
    T acc = ident;
    if (la)
      fold_found(b + b_s[k], bv + b_s[k], b_n[k], a + a_s[k], av + a_s[k],
                 a_n[k], false, lane, 32, mul, fold, &c, &acc);
    else
      fold_found(a + a_s[k], av + a_s[k], a_n[k], b + b_s[k], bv + b_s[k],
                 b_n[k], true, lane, 32, mul, fold, &c, &acc);
    c = group_sum(c, 32);
    acc = group_fold(acc, 32, fold);
    if (lane == 0) {
      cnt[k] = c;
      val[k] = acc;
    }
  }
  // long runs, one at a time: A's list marked in the bitmap and ranked
  // in the directory; an edge probes it with B's ids, or (where B's list
  // is much the longer) searches A's ids in B
  for (int r = 0; r < nruns; ++r) {
    const int rs = runs[r], re = runs[r + 1];
    const int nl = a_n[rs];
    if (re - rs < kMinRun || nl == 0 || nl > kMaxRanked)
      continue;                                    // block-uniform
    const int32_t* l = a + a_s[rs];
    const T* lv = av + a_s[rs];
    const int64_t first = __ldg(l), last = __ldg(l + nl - 1);
    const int64_t w_first = first & ~(int64_t)31;
    int below = 0;                 // A's ids in the windows before w0
    for (int64_t w0 = w_first; w0 <= last; w0 += kBitIds) {
      for (int i0 = t; i0 < nl; i0 += 4 * kPcThreads) {
        int64_t off[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kPcThreads;
          off[u] = i < nl ? (int64_t)__ldg(l + i) - w0 : -1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (off[u] >= 0 && off[u] < kBitIds)
            atomicOr(bits + (off[u] >> 5), 1u << (off[u] & 31));
      }
      __syncthreads();
      // the directory over the window's words that may hold marks,
      // each thread a span of neighbouring words
      const int64_t hi = last - w0 < kBitIds ? last - w0 : kBitIds - 1;
      const int nw = (int)(hi >> 5) + 1;
      const int per = (nw + kPcThreads - 1) / kPcThreads;
      const int w_lo = t * per, w_hi = min(w_lo + per, nw);
      int mine = 0;
      for (int w = w_lo; w < w_hi; ++w) mine += __popc(bits[w]);
      int in_window;
      int pre = block_sum_scan(mine, wsum, &in_window);
      for (int w = w_lo; w < w_hi; ++w) {
        dir[w] = (uint16_t)pre;
        pre += __popc(bits[w]);
      }
      __syncthreads();
      // kRunLanes lanes an edge, several edges a warp
      for (int k0 = rs + warp * kRunEdges; k0 < re;
           k0 += kPcWarps * kRunEdges) {              // warp-uniform
        const int k = k0 + lane / kRunLanes, gl = lane % kRunLanes;
        int c = 0;
        T acc = ident;
        if (k < re) {
          const int nb = b_n[k];
          if (nb <= 8 * nl)
            fold_marked(b + b_s[k], bv + b_s[k], nb, bits, dir, lv + below,
                        w0, gl, kRunLanes, mul, fold, &c, &acc);
          else if (w0 == w_first)    // once, in the first window
            fold_found(l, lv, nl, b + b_s[k], bv + b_s[k], nb, true, gl,
                       kRunLanes, mul, fold, &c, &acc);
        }
        c = group_sum(c, kRunLanes);
        acc = group_fold(acc, kRunLanes, fold);
        if (k < re && gl == 0) {
          cnt[k] += c;
          val[k] = fold(val[k], acc);
        }
      }
      __syncthreads();
      below += in_window;
      for (int i = t; i < nw; i += kPcThreads) bits[i] = 0;
      __syncthreads();
    }
  }
  __syncthreads();
  if (valid) {
    cnt_out[e0 + t] = cnt[t];
    out[e0 + t] = val[t];
  }
}

constexpr int kPfSmem = kBitWords * 6 + (8 * kPcChunk + 1 + kPcWarps) * 4;

template <typename T, int G, typename M, typename F>
void launch_search(const int32_t* a, const T* av, int64_t a_len,
                   const int32_t* b, const T* bv, int64_t b_len,
                   const int32_t* ast, const int32_t* wa, const int32_t* bst,
                   const int32_t* wb, int32_t* cnt, T* out, int64_t n_edges,
                   M mul, F fold, T ident, cudaStream_t st) {
  pair_fold_search_kernel<T, G>
      <<<(unsigned)((n_edges * G + kShortThreads - 1) / kShortThreads),
         kShortThreads, 0, st>>>(a, av, a_len, b, bv, b_len, ast, wa, bst,
                                 wb, cnt, out, n_edges, mul, fold, ident);
}

// the warp kernel at every width: the built-in launches whose mul or
// fold the algebra added (csrc/spgemm.cu)
template <typename T, typename M, typename F>
int launch_fold_warp(const int32_t* a, const void* av, int64_t a_len,
                     const int32_t* b, const void* bv, int64_t b_len,
                     const int32_t* ast, const int32_t* wa,
                     const int32_t* bst, const int32_t* wb, int32_t* cnt,
                     void* out, int64_t n_edges, M mul, F fold,
                     uint32_t ident_bits, cudaStream_t st) {
  T ident;
  memcpy(&ident, &ident_bits, sizeof(T));
  pair_fold_warp_kernel<T><<<(unsigned)((n_edges * 32 + kThreads - 1) /
                                        kThreads),
                             kThreads, 0, st>>>(
      a, (const T*)av, a_len, b, (const T*)bv, b_len, ast, wa, bst, wb, cnt,
      (T*)out, n_edges, mul, fold, ident);
  return (int)cudaGetLastError();
}

// runs: whether the bucket takes the runs kernel (the wrapper's rule,
// core/spgemm.py:fold_path); else the search kernel, its lanes an edge
// by the width (the warp kernel past 512)
template <typename T, typename M, typename F>
int launch_fold(const int32_t* a, const void* av_, int64_t a_len,
                const int32_t* b, const void* bv_, int64_t b_len,
                const int32_t* ast, const int32_t* wa, const int32_t* bst,
                const int32_t* wb, int32_t* cnt, void* out_, int64_t n_edges,
                int width, bool runs, M mul, F fold, uint32_t ident_bits,
                cudaStream_t st) {
  T ident;
  memcpy(&ident, &ident_bits, sizeof(T));
  const T *av = (const T*)av_, *bv = (const T*)bv_;
  T* out = (T*)out_;
  if (!runs) {
    // lanes an edge: the shorter list holds at most width / 2 ids
    if (width <= 128)
      launch_search<T, 4>(a, av, a_len, b, bv, b_len, ast, wa, bst, wb, cnt,
                          out, n_edges, mul, fold, ident, st);
    else if (width <= 256)
      launch_search<T, 8>(a, av, a_len, b, bv, b_len, ast, wa, bst, wb, cnt,
                          out, n_edges, mul, fold, ident, st);
    else if (width <= 512)
      launch_search<T, 16>(a, av, a_len, b, bv, b_len, ast, wa, bst, wb, cnt,
                           out, n_edges, mul, fold, ident, st);
    else
      return launch_fold_warp<T>(a, av_, a_len, b, bv_, b_len, ast, wa, bst,
                                 wb, cnt, out_, n_edges, mul, fold,
                                 ident_bits, st);
    return (int)cudaGetLastError();
  }
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_fold_kernel<T, M, F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kPfSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  // edges a block: enough blocks for 4 on each of 132 SMs, 64 to 512
  int64_t chunk = (n_edges + 527) / 528;
  chunk = (chunk + 31) / 32 * 32;
  chunk = chunk < 64 ? 64 : chunk > kPcChunk ? kPcChunk : chunk;
  pair_fold_kernel<T><<<(unsigned)((n_edges + chunk - 1) / chunk),
                        kPcThreads, kPfSmem, st>>>(
      a, av, a_len, b, bv, b_len, ast, wa, bst, wb, cnt, out, n_edges,
      (int)chunk, mul, fold, ident);
  return (int)cudaGetLastError();
}

}  // namespace spgemm
}  // namespace
