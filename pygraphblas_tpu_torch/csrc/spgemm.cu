// Masked SpGEMM intersect kernels: the CUDA counterparts of
// pygraphblas_tpu/core/spgemm.py:_pallas_fill_merge_count (pair_count),
// _pallas_fill_keys (fill_keys) and _pallas_fill_merge_fold (pair_fold).
//
// Each mask edge e names two sorted lists of unique column ids,
//   A: a[ast[e] .. ast[e] + wa[e])   B: b[bst[e] .. bst[e] + wb[e])
// (a row of A and a row of B^T).  The TPU kernels lay each edge out as
// one key row (A ascending | pads | B descending), bitonic-merge it in
// VMEM and count equal neighbours: machinery for a core with no cheap
// dynamic lane gather.  The card has one, and L2 holds both column
// arrays (under 31 MB at kron-18), so pair_count and pair_fold compute
// the same function directly: runs of edges that share A's list mark
// it once in a shared-memory bitmap and probe it with B's ids, and
// narrow buckets and short runs binary-search the shorter list in the
// longer (see each kernel).
//
// Bounds.  pair_fold: the ids read once and four int32 per edge (plus
// the values), over the HBM rate, against the compares over the int32
// rate, whichever is larger; an edge needs the fewer of a linear
// merge's wa + wb and a search's min(wa, wb) log2(max(wa, wb)).
// pair_count: the same bytes, against one probe per id of each edge's
// shorter list.  fill_keys: the E x W int32 keys it writes.
//
// The ops of pair_fold are those of ops.cuh (no FMA contraction), at any
// 4-byte word type; a launch whose mul or fold the algebra added (ISEQ
// .. ISLE, LOR, LAND, LXOR, POW .. COPYSIGN; the logical and bitwise
// folds) takes the warp kernel's EXT instantiation at every width, so
// the arithmetic codes keep small loops in all three kernels.  The
// kernels live in spgemm.cuh with the ops as functors, so that a
// generated translation unit (_opgen.py) instantiates them at a user
// semiring's ops, by width as the arithmetic codes.  Its
// fold order (per lane in list order, then a shuffle tree across the
// lanes of an edge, then across bitmap windows) differs from the TPU's
// log-roll: integer folds and MIN/MAX are exact, float PLUS and TIMES
// agree within rounding.

#include "spgemm.cuh"

namespace {

using namespace spgemm;

// pair_count (replaces spgemm.py:_pallas_fill_merge_count).  Bound: the
// ids read once, against one probe per id of each edge's shorter list.
// The first port (one warp an edge, each lane binary-searching the
// longer list through L2: 2.2221 ms at tc18 on an H100 80GB HBM3 at
// 700 W) read a longer list again for every edge, left most lanes idle
// on short lists, and waited on one dependent load at a time.  Two
// paths, by the bucket's width:
//   - up to 256 (lists of at most 256 ids): 4 lanes an edge at width
//     128, 8 at 256 (the shorter list holds at most half the width, so
//     at most 16 ids a lane; more lanes measured slower), no shared
//     memory and no barrier; each lane binary-searches the longer list
//     for its ids, each search from its last hit;
//   - wider: mask edges come in row-major order, so runs of hundreds to
//     thousands of edges share A's list (the mask row's).  A block takes
//     `chunk` consecutive edges (up to 512, fewer where a bucket is
//     small, so that every SM gets blocks) and splits them into runs of
//     equal A list.  A run of at least kMinRun edges marks that list in
//     a shared-memory bitmap (a window of 2^18 ids; a list spanning more
//     ids takes several windows); each edge then probes it with B's ids,
//     one bit each and four loads in flight a lane, or, where B's list
//     holds over 8x A's ids, searches A's ids in it.  The edges of
//     other runs binary-search their shorter list in the longer.
// how many of s[gl], s[gl + step], ... (s: ns sorted ids) the sorted
// list l[0, nl) holds: a binary search per id, each starting at the
// lane's last hit (its ids grow)
__device__ __forceinline__ int count_found(const int32_t* __restrict__ s,
                                           int ns,
                                           const int32_t* __restrict__ l,
                                           int nl, int gl, int step) {
  int c = 0, from = 0;
  for (int p = gl; p < ns; p += step) {
    const int32_t key = __ldg(s + p);
    from = lower_bound(l, from, nl, key);
    c += from < nl && __ldg(l + from) == key;
  }
  return c;
}

// how many of s[gl], s[gl + step], ... are marked in the bitmap window
// of ids [w0, w0 + kBitIds): four loads in flight
__device__ __forceinline__ int count_marked(const int32_t* __restrict__ s,
                                            int ns, const uint32_t* bits,
                                            int64_t w0, int gl, int step) {
  int c = 0;
  for (int p0 = gl; p0 < ns; p0 += 4 * step) {
    int64_t off[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = p0 + u * step;
      off[u] = p < ns ? (int64_t)__ldg(s + p) - w0 : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (off[u] >= 0 && off[u] < kBitIds)
        c += (bits[off[u] >> 5] >> (off[u] & 31)) & 1;
  }
  return c;
}

__global__ void __launch_bounds__(kShortThreads)
pair_count_short_kernel(const int32_t* __restrict__ a, int64_t a_len,
                        const int32_t* __restrict__ b, int64_t b_len,
                        const int32_t* __restrict__ ast,
                        const int32_t* __restrict__ wa,
                        const int32_t* __restrict__ bst,
                        const int32_t* __restrict__ wb,
                        int32_t* __restrict__ out, int64_t n_edges,
                        int group) {
  const int64_t tid = (int64_t)blockIdx.x * kShortThreads + threadIdx.x;
  const int64_t e = tid / group;
  const int gl = (int)(tid % group);
  int c = 0;
  if (e < n_edges) {
    int64_t s_st, l_st;
    int ns, nl;
    const bool la = edge_lists(ast, wa, bst, wb, e, a_len, b_len, &s_st,
                               &ns, &l_st, &nl);
    c = count_found((la ? b : a) + s_st, ns, (la ? a : b) + l_st, nl, gl,
                    group);
  }
  c = group_sum(c, group);
  if (e < n_edges && gl == 0) out[e] = c;
}

__global__ void __launch_bounds__(kPcThreads)
pair_count_kernel(const int32_t* __restrict__ a, int64_t a_len,
                  const int32_t* __restrict__ b, int64_t b_len,
                  const int32_t* __restrict__ ast,
                  const int32_t* __restrict__ wa,
                  const int32_t* __restrict__ bst,
                  const int32_t* __restrict__ wb,
                  int32_t* __restrict__ out, int64_t n_edges, int chunk) {
  extern __shared__ uint32_t bits[];               // kBitWords
  int* a_s = (int*)(bits + kBitWords);             // A's list: start,
  int* a_n = a_s + kPcChunk;                       // length
  int* b_s = a_n + kPcChunk;                       // B's
  int* b_n = b_s + kPcChunk;
  int* cnt = b_n + kPcChunk;
  int* runs = cnt + kPcChunk;                      // run starts, then ne
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
    in_short = runs[r + 1] - runs[r] < kMinRun;
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
    int c = la ? count_found(b + b_s[k], b_n[k], a + a_s[k], a_n[k], lane, 32)
               : count_found(a + a_s[k], a_n[k], b + b_s[k], b_n[k], lane,
                             32);
    c = group_sum(c, 32);
    if (lane == 0) cnt[k] = c;
  }
  // long runs, one at a time: A's list marked in the bitmap; an edge
  // probes it with B's ids, or (where B's list is much the longer)
  // searches A's ids in B
  for (int r = 0; r < nruns; ++r) {
    const int rs = runs[r], re = runs[r + 1];
    const int nl = a_n[rs];
    if (re - rs < kMinRun || nl == 0) continue;    // block-uniform
    const int32_t* l = a + a_s[rs];
    const int64_t first = __ldg(l), last = __ldg(l + nl - 1);
    for (int64_t w0 = first & ~(int64_t)31; w0 <= last; w0 += kBitIds) {
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
      for (int k = rs + warp; k < re; k += kPcWarps) {
        const int nb = b_n[k];
        int c;
        if (nb <= 8 * nl)
          c = count_marked(b + b_s[k], nb, bits, w0, lane, 32);
        else if (w0 == (first & ~(int64_t)31))   // once, in the first window
          c = count_found(l, nl, b + b_s[k], nb, lane, 32);
        else
          c = 0;
        c = group_sum(c, 32);
        if (lane == 0) cnt[k] += c;
      }
      __syncthreads();
      // clear the window's words that hold marks
      const int64_t hi = last - w0 < kBitIds ? last - w0 : kBitIds - 1;
      for (int i = t; i <= (int)(hi >> 5); i += kPcThreads) bits[i] = 0;
      __syncthreads();
    }
  }
  __syncthreads();
  if (valid) out[e0 + t] = cnt[t];
}

constexpr int kPcSmem = kBitWords * 4 + (7 * kPcChunk + 1 + kPcWarps) * 4;

__device__ __forceinline__ int64_t clip(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// One thread writes 4 neighbouring lanes (16 bytes) of one key row:
//   p < wa: 2 a[ast + p];  p >= W - wb: 2 b[bst + W-1-p] + 1;
//   otherwise (1 << 30) + 2p  (spgemm.py:152-156),
// each index clipped to its array as the plain version's are.
// Neighbouring threads write neighbouring 16-byte words; their reads of
// a and b are neighbouring too (b backwards).
__global__ void fill_keys_kernel(const int32_t* __restrict__ a,
                                 int64_t a_len,
                                 const int32_t* __restrict__ b,
                                 int64_t b_len,
                                 const int32_t* __restrict__ ast,
                                 const int32_t* __restrict__ wa,
                                 const int32_t* __restrict__ bst,
                                 const int32_t* __restrict__ wb,
                                 int4* __restrict__ out, int64_t n_edges,
                                 int width) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int q = width >> 2;
  if (t >= n_edges * q) return;
  int64_t e = t / q;
  int p0 = (int)(t - e * q) * 4;
  int na = wa[e], nb = wb[e];
  int64_t sa = ast[e], sb = (int64_t)bst[e] + (width - 1);
  int k[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int p = p0 + j;
    if (p < na)
      k[j] = 2 * __ldg(a + clip(sa + p, a_len));
    else if (p >= width - nb)
      k[j] = 2 * __ldg(b + clip(sb - p, b_len)) + 1;
    else
      k[j] = (1 << 30) + 2 * p;
  }
  out[t] = make_int4(k[0], k[1], k[2], k[3]);
}

}  // namespace

// width: the bucket's (>= wa + wb): it picks the path and the lanes an
// edge
extern "C" int pgb_pair_count(const void* a, int64_t a_len, const void* b,
                              int64_t b_len, const void* ast, const void* wa,
                              const void* bst, const void* wb, void* out,
                              int64_t n_edges, int width, void* stream) {
  if (n_edges <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *ia = (const int32_t*)a, *ib = (const int32_t*)b;
  const int32_t *as = (const int32_t*)ast, *na = (const int32_t*)wa;
  const int32_t *bs = (const int32_t*)bst, *nb = (const int32_t*)wb;
  if (width <= 256) {
    const int group = width <= 128 ? 4 : 8;
    pair_count_short_kernel<<<(unsigned)((n_edges * group + kShortThreads -
                                          1) / kShortThreads),
                              kShortThreads, 0, st>>>(
        ia, a_len, ib, b_len, as, na, bs, nb, (int32_t*)out, n_edges, group);
    return (int)cudaGetLastError();
  }
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        pair_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kPcSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  // edges a block: enough blocks for 4 on each of 132 SMs, 64 to 512
  int64_t chunk = (n_edges + 527) / 528;
  chunk = (chunk + 31) / 32 * 32;
  chunk = chunk < 64 ? 64 : chunk > kPcChunk ? kPcChunk : chunk;
  pair_count_kernel<<<(unsigned)((n_edges + chunk - 1) / chunk), kPcThreads,
                      kPcSmem, st>>>(ia, a_len, ib, b_len, as, na, bs, nb,
                                     (int32_t*)out, n_edges, (int)chunk);
  return (int)cudaGetLastError();
}

extern "C" int pgb_fill_keys(const void* a, int64_t a_len, const void* b,
                             int64_t b_len, const void* ast, const void* wa,
                             const void* bst, const void* wb, void* out,
                             int64_t n_edges, int width, void* stream) {
  if (width <= 0 || width % 4 || a_len <= 0 || b_len <= 0) return -1;
  int64_t threads = n_edges * (width / 4);
  if (threads <= 0) return 0;
  fill_keys_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                     kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_len, (const int32_t*)b, b_len,
      (const int32_t*)ast, (const int32_t*)wa, (const int32_t*)bst,
      (const int32_t*)wb, (int4*)out, n_edges, width);
  return (int)cudaGetLastError();
}

// width: the bucket's (>= wa + wb): it picks the search kernel's lanes
// an edge; runs: 1 for the runs kernel, 0 for the search kernel; values
// 4-byte words of dtype code `dtype`
extern "C" int pgb_pair_fold(const void* a, const void* av, int64_t a_len,
                             const void* b, const void* bv, int64_t b_len,
                             const void* ast, const void* wa, const void* bst,
                             const void* wb, void* cnt, void* out,
                             int64_t n_edges, int width, int runs, int dtype,
                             int mul_op, int fold_op, uint32_t ident_bits,
                             void* stream) {
  if (n_edges <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *ia = (const int32_t*)a, *ib = (const int32_t*)b;
  const int32_t *as = (const int32_t*)ast, *na = (const int32_t*)wa;
  const int32_t *bs = (const int32_t*)bst, *nb = (const int32_t*)wb;
  // the kernels read the dtype code beside the mul code (ops.cuh:
  // apply_mul_packed), for narrowing and the division's saturation
  const int mul_nt = mul_op < 0 ? mul_op : mul_op | (dtype << 8);
  if (fold_op < 0 || !(dtype == DT_F32 ? fold_ok<float>(fold_op)
                                       : fold_ok<int32_t>(fold_op)))
    return -1;
  if (mul_ext_code(mul_op) || fold_ext_code(fold_op))
    PGB_DISPATCH_WORD(dtype, (launch_fold_warp<T>(
                                 ia, av, a_len, ib, bv, b_len, as, na, bs,
                                 nb, (int32_t*)cnt, out, n_edges,
                                 MulSwitch<T, true>{mul_nt},
                                 FoldSwitch<T, true>{fold_op}, ident_bits,
                                 st)));
  PGB_DISPATCH_WORD(dtype, (launch_fold<T>(
                               ia, av, a_len, ib, bv, b_len, as, na, bs, nb,
                               (int32_t*)cnt, out, n_edges, width, runs != 0,
                               MulSwitch<T, false>{mul_nt},
                               FoldSwitch<T, false>{fold_op}, ident_bits,
                               st)));
}
