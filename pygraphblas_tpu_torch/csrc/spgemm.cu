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
// the same function directly: one warp per edge, the lanes stride over
// the shorter list and each binary-searches its id in the longer one
// (__ldg); a lane's later ids are larger, so its next search starts at
// its last hit.  Edges arrive in width-bucket order, so a block's eight
// warps get similar work.
//
// Bounds.  pair_count and pair_fold: the ids read once and four int32 per
// edge (plus the values), over the HBM rate, against the compares over
// the int32 rate, whichever is larger; an edge needs the fewer of a
// linear merge's wa + wb and a search's min(wa, wb) log2(max(wa, wb)).
// fill_keys: the E x W int32 keys it writes.
//
// The ops of pair_fold are those of ops.cuh (no FMA contraction).  Its
// fold order (per lane in list order, then a shuffle tree across the
// warp) differs from the TPU's log-roll: integer folds and MIN/MAX are
// exact, float PLUS and TIMES agree within rounding.

#include <cstring>

#include "ops.cuh"

namespace {

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

__global__ void pair_count_kernel(const int32_t* __restrict__ a,
                                  int64_t a_len,
                                  const int32_t* __restrict__ b,
                                  int64_t b_len,
                                  const int32_t* __restrict__ ast,
                                  const int32_t* __restrict__ wa,
                                  const int32_t* __restrict__ bst,
                                  const int32_t* __restrict__ wb,
                                  int32_t* __restrict__ out, int64_t n_edges) {
  int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (e >= n_edges) return;          // warp-uniform
  int64_t sa, sb;
  int ns = segment(ast, wa, e, a_len, &sa);
  int nl = segment(bst, wb, e, b_len, &sb);
  const int32_t* s = a + sa;
  const int32_t* l = b + sb;
  if (nl < ns) {
    const int32_t* t = s; s = l; l = t;
    int n = ns; ns = nl; nl = n;
  }
  int c = 0, from = 0;
  for (int p = lane; p < ns; p += 32) {
    int32_t key = __ldg(s + p);
    from = lower_bound(l, from, nl, key);
    c += from < nl && __ldg(l + from) == key;
  }
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) out[e] = c;
}

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

// pair_count's search; at each match mul(a value, b value) (A's operand
// first, whichever list the lanes walk), folded into the lane's
// accumulator, then across the warp by xor shuffles.
template <typename T>
__global__ void pair_fold_kernel(const int32_t* __restrict__ a,
                                 const T* __restrict__ av, int64_t a_len,
                                 const int32_t* __restrict__ b,
                                 const T* __restrict__ bv, int64_t b_len,
                                 const int32_t* __restrict__ ast,
                                 const int32_t* __restrict__ wa,
                                 const int32_t* __restrict__ bst,
                                 const int32_t* __restrict__ wb,
                                 int32_t* __restrict__ cnt,
                                 T* __restrict__ out, int64_t n_edges,
                                 int mul_op, int fold_op, T ident) {
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
      T x = walk_a ? apply_mul<T>(mul_op, vs[p], vl[from])
                   : apply_mul<T>(mul_op, vl[from], vs[p]);
      acc = apply_fold<T>(fold_op, acc, x);
    }
  }
  c = __reduce_add_sync(kFull, c);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc = apply_fold<T>(fold_op, acc, __shfl_xor_sync(kFull, acc, off));
  if (lane == 0) {
    cnt[e] = c;
    out[e] = acc;
  }
}

unsigned warp_blocks(int64_t n_edges) {
  return (unsigned)((n_edges * 32 + kThreads - 1) / kThreads);
}

template <typename T>
int launch_fold(const int32_t* a, const void* av, int64_t a_len,
                const int32_t* b, const void* bv, int64_t b_len,
                const int32_t* ast, const int32_t* wa, const int32_t* bst,
                const int32_t* wb, int32_t* cnt, void* out, int64_t n_edges,
                int mul_op, int fold_op, uint32_t ident_bits,
                cudaStream_t st) {
  T ident;
  memcpy(&ident, &ident_bits, sizeof(T));
  pair_fold_kernel<T><<<warp_blocks(n_edges), kThreads, 0, st>>>(
      a, (const T*)av, a_len, b, (const T*)bv, b_len, ast, wa, bst, wb, cnt,
      (T*)out, n_edges, mul_op, fold_op, ident);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pgb_pair_count(const void* a, int64_t a_len, const void* b,
                              int64_t b_len, const void* ast, const void* wa,
                              const void* bst, const void* wb, void* out,
                              int64_t n_edges, void* stream) {
  if (n_edges <= 0) return 0;
  pair_count_kernel<<<warp_blocks(n_edges), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)a, a_len, (const int32_t*)b, b_len,
      (const int32_t*)ast, (const int32_t*)wa, (const int32_t*)bst,
      (const int32_t*)wb, (int32_t*)out, n_edges);
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

extern "C" int pgb_pair_fold(const void* a, const void* av, int64_t a_len,
                             const void* b, const void* bv, int64_t b_len,
                             const void* ast, const void* wa, const void* bst,
                             const void* wb, void* cnt, void* out,
                             int64_t n_edges, int dtype, int mul_op,
                             int fold_op, uint32_t ident_bits, void* stream) {
  if (n_edges <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *ia = (const int32_t*)a, *ib = (const int32_t*)b;
  const int32_t *as = (const int32_t*)ast, *na = (const int32_t*)wa;
  const int32_t *bs = (const int32_t*)bst, *nb = (const int32_t*)wb;
  if (dtype == DT_F32)
    return launch_fold<float>(ia, av, a_len, ib, bv, b_len, as, na, bs, nb,
                              (int32_t*)cnt, out, n_edges, mul_op, fold_op,
                              ident_bits, st);
  if (dtype == DT_I32)
    return launch_fold<int32_t>(ia, av, a_len, ib, bv, b_len, as, na, bs, nb,
                                (int32_t*)cnt, out, n_edges, mul_op, fold_op,
                                ident_bits, st);
  return -1;
}
