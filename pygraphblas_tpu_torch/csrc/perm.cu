// Benes permutation passes: the CUDA counterparts of
// pygraphblas_tpu/core/perm.py:_lane_gather, _lane_gather_tdesc,
// _lane_gather_tasc, _inner3 and _mid_pass.
//
// All five are pure data moves (plus the optional 8-row fold of the
// ascend pass).  The TPU transposes a 128x128 tile with an identity
// matmul (perm.py:_tp); here the transpose is a copy through shared
// memory, so every value moves bit-exactly.  Lane indices are int8
// (0..127), widened to int in the kernel.
//
// Bound: bytes.  lane_gather, tdesc and tasc read x and idx once and
// write the output once; mid_pass reads x and three int8 index slabs
// once and writes once; inner3 reads x and five int8 index slabs once
// and writes once (its scratch slab adds two round trips, partly served
// from L2).

#include <cstring>

#include "ops.cuh"

// One 128x128 tile per block.  Shared memory rows are padded (129 words,
// 132 bytes) so that a column walk hits 32 different banks.
constexpr int TILE = 128 * 128;
constexpr int XPAD = 129;
constexpr int IPAD = 132;
constexpr int THREADS = 256;

// descend: x (g*rb*128, 128), idx same shape ->
//   out (g, 128, rb, 128): out[gi, c, b, r] = x[gi, b, r, idx[gi, b, r, c]]
template <typename T>
__global__ void tdesc_kernel(const T* __restrict__ x,
                             const int8_t* __restrict__ idx,
                             T* __restrict__ out, int64_t rb) {
  extern __shared__ unsigned char smem[];
  T* tile = (T*)smem;                                  // [128][XPAD]
  int8_t* sidx = (int8_t*)(smem + 128 * XPAD * sizeof(T));  // [128][IPAD]
  const int64_t tid = blockIdx.x;                      // gi * rb + b
  const int64_t gi = tid / rb, b = tid % rb;
  const T* xt = x + tid * TILE;
  const int8_t* it = idx + tid * TILE;
  for (int k = threadIdx.x; k < TILE; k += THREADS) {
    int r = k >> 7, c = k & 127;
    tile[r * XPAD + c] = xt[k];
    sidx[r * IPAD + c] = it[k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < TILE; k += THREADS) {
    int c = k >> 7, r = k & 127;
    int lane = sidx[r * IPAD + c] & 127;
    out[((gi * 128 + c) * rb + b) * 128 + r] = tile[r * XPAD + lane];
  }
}

// ascend: x (g, 128, rb, 128), idx (g*rb*128, 128) ->
//   y[gi, b, r, l] = x[gi, idx[gi, b, r, l], b, r]
//   out = y, or with fold_op >= 0 out[gi, b, j, l] = fold_s y[gi, b, 8j+s, l]
template <typename T>
__global__ void tasc_kernel(const T* __restrict__ x,
                            const int8_t* __restrict__ idx,
                            T* __restrict__ out, int64_t rb, int fold_op) {
  extern __shared__ unsigned char smem[];
  T* tile = (T*)smem;                                  // [c][XPAD] over r
  const int64_t tid = blockIdx.x;
  const int64_t gi = tid / rb, b = tid % rb;
  for (int k = threadIdx.x; k < TILE; k += THREADS) {
    int c = k >> 7, r = k & 127;
    tile[c * XPAD + r] = x[((gi * 128 + c) * rb + b) * 128 + r];
  }
  __syncthreads();
  const int8_t* it = idx + tid * TILE;
  if (fold_op < 0) {
    T* ot = out + tid * TILE;
    for (int k = threadIdx.x; k < TILE; k += THREADS) {
      int r = k >> 7;
      ot[k] = tile[(it[k] & 127) * XPAD + r];
    }
    return;
  }
  T* ot = out + tid * (TILE / 8);
  for (int k = threadIdx.x; k < TILE / 8; k += THREADS) {
    int j = k >> 7, l = k & 127;
    int r = 8 * j;
    T acc = tile[(it[r * 128 + l] & 127) * XPAD + r];
#pragma unroll
    for (int s = 1; s < 8; ++s)
      acc = apply_fold<T>(fold_op, acc,
                          tile[(it[(r + s) * 128 + l] & 127) * XPAD + r + s]);
    ot[k] = acc;
  }
}

// fused middle (layouts as perm.py:761-766):
//   x, ai, ci, out: (g, S, 128, 128)   am, ss, cm: (g, 128, S, 128)
// One block per group runs the three stages of the TPU kernel in turn,
// through a scratch slab in device memory (the (S*128, 128) slab is up
// to 1.5 MB, past a block's shared memory), with __syncthreads between
// stages (global writes of a block are visible to the block after it):
//   1. descend, per tile s: Z[c, s, r] = x[s, r, ai[s, r, c]]
//      (x and ai tiles staged in shared memory, Z written transposed);
//   2. mid, per column c (CC columns at a time, staged in shared
//      memory with their index rows): Y2[s, l] = Z[c, s, am[c, s, l]],
//      Y3[b, l] = Y2[ss[c, b, l], l] (b when S == 1),
//      M[c, b, r] = Y3[b, cm[c, b, r]], written in place over Z[c];
//   3. ascend, per tile b: out[b, r, l] = M[ci[b, r, l], b, r].
// A select index outside [0, S) gives 0, as the TPU kernel's zero-
// initialised select does.
constexpr int INNER_THREADS = 1024;
constexpr int CC = 8;

template <typename T>
__global__ void __launch_bounds__(INNER_THREADS)
inner3_kernel(const T* __restrict__ x, const int8_t* __restrict__ ai,
              const int8_t* __restrict__ am, const int8_t* __restrict__ ss,
              const int8_t* __restrict__ cm, const int8_t* __restrict__ ci,
              T* __restrict__ z, T* __restrict__ out, int S) {
  extern __shared__ unsigned char smem[];
  T* tile = (T*)smem;
  int8_t* sidx = (int8_t*)(smem + 128 * XPAD * sizeof(T));
  const int64_t gbase = (int64_t)blockIdx.x * S * TILE;
  const int tx = threadIdx.x;

  // 1. descend
  for (int s = 0; s < S; ++s) {
    const int64_t tb = gbase + (int64_t)s * TILE;
#pragma unroll 4
    for (int k = tx; k < TILE; k += INNER_THREADS) {
      int r = k >> 7, c = k & 127;
      tile[r * XPAD + c] = x[tb + k];
      sidx[r * IPAD + c] = ai[tb + k];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = tx; k < TILE; k += INNER_THREADS) {
      int c = k >> 7, r = k & 127;
      z[gbase + ((int64_t)c * S + s) * 128 + r] =
          tile[r * XPAD + (sidx[r * IPAD + c] & 127)];
    }
    __syncthreads();
  }

  // 2. mid, CC columns at a time: the chunk of Z and its am / ss / cm
  // rows (the same offsets) are staged in shared memory, so the three
  // dependent index reads of a cell never leave the SM
  const int per_c = S * 128;
  const int chunk = CC * per_c;
  int8_t* am_s = (int8_t*)(tile + chunk);
  int8_t* ss_s = am_s + chunk;
  int8_t* cm_s = ss_s + chunk;
  for (int c0 = 0; c0 < 128; c0 += CC) {
    const int64_t cb = gbase + (int64_t)c0 * per_c;
#pragma unroll 4
    for (int k = tx; k < chunk; k += INNER_THREADS) {
      tile[k] = z[cb + k];
      am_s[k] = am[cb + k];
      cm_s[k] = cm[cb + k];
      if (S > 1) ss_s[k] = ss[cb + k];
    }
    __syncthreads();
    for (int k = tx; k < chunk; k += INNER_THREADS) {
      const int cl = k / per_c, rem = k - cl * per_c;
      const int b = rem >> 7;
      const int crow = cl * per_c;                 // row (c, 0) in the chunk
      const int l2 = cm_s[k] & 127;
      int s = b;
      if (S > 1) s = ss_s[crow + b * 128 + l2];
      T v = (T)0;
      if (s >= 0 && s < S)
        v = tile[crow + s * 128 + (am_s[crow + s * 128 + l2] & 127)];
      z[cb + k] = v;
    }
    __syncthreads();
  }

  // 3. ascend
  for (int b = 0; b < S; ++b) {
#pragma unroll 4
    for (int k = tx; k < TILE; k += INNER_THREADS) {
      int c = k >> 7, r = k & 127;
      tile[c * XPAD + r] = z[gbase + ((int64_t)c * S + b) * 128 + r];
    }
    __syncthreads();
    const int64_t tb = gbase + (int64_t)b * TILE;
#pragma unroll 4
    for (int k = tx; k < TILE; k += INNER_THREADS) {
      int r = k >> 7;
      out[tb + k] = tile[(ci[tb + k] & 127) * XPAD + r];
    }
    __syncthreads();
  }
}

// per-row lane gather (perm.py:_lane_gather): out[r, l] = x[r, idx[r, l]]
// over (rows, 128).  One thread a cell; a warp reads 32 idx bytes and
// one 512 B source row, so every access coalesces.
template <typename T>
__global__ void lane_gather_kernel(const T* __restrict__ x,
                                   const int8_t* __restrict__ idx,
                                   T* __restrict__ out, int64_t n) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  out[t] = x[(t & ~(int64_t)127) + (idx[t] & 127)];
}

// bottom Benes level (perm.py:_mid_pass) over (nsub, S, 128) tiles:
//   y[s, l] = x[s, a[s, l]]            A lane gather
//   z[s, l] = y[ss[s, l], l]           sublane select (z = y when S == 1)
//   out[s, l] = z[s, c[s, l]]          C lane gather
// composed per output cell: with c = c[s, l] and t = ss[s, c],
// out[s, l] = x[t, a[t, c]].  A block stages `tpb` whole tiles of x, a
// and ss in shared memory (one tile of 15,872 cells at S = 124; 21
// tiles at S = 3), so the two dependent index reads and the value read
// of a cell stay on the SM; c and out stream through once.  A select
// index outside [0, S) gives 0, as the TPU kernel's zero-initialised
// select does.
template <typename T>
__global__ void mid_pass_kernel(const T* __restrict__ x,
                                const int8_t* __restrict__ a,
                                const int8_t* __restrict__ ss,
                                const int8_t* __restrict__ c,
                                T* __restrict__ out, int64_t nsub, int S,
                                int tpb) {
  extern __shared__ unsigned char smem[];
  const int cells = S * 128;
  T* xs = (T*)smem;
  int8_t* as = (int8_t*)(xs + (int64_t)tpb * cells);
  int8_t* sss = as + tpb * cells;
  const int64_t tile0 = (int64_t)blockIdx.x * tpb;
  const int ntile = (int)(nsub - tile0 < tpb ? nsub - tile0 : tpb);
  const int total = ntile * cells;
  const int64_t base = tile0 * cells;
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    xs[k] = x[base + k];
    as[k] = a[base + k];
    if (ss != nullptr) sss[k] = ss[base + k];
  }
  __syncthreads();
  for (int k = threadIdx.x; k < total; k += blockDim.x) {
    const int tb = (k / cells) * cells;
    const int s = (k - tb) >> 7;
    const int cl = c[base + k] & 127;
    const int t = ss != nullptr ? sss[tb + s * 128 + cl] : s;
    T v = (T)0;
    if (t >= 0 && t < S) v = xs[tb + t * 128 + (as[tb + t * 128 + cl] & 127)];
    out[base + k] = v;
  }
}

template <typename T>
static int launch_lane_gather(const void* x, const int8_t* idx, void* out,
                              int64_t rows, cudaStream_t st) {
  const int64_t n = rows * 128;
  if (n > 0)
    lane_gather_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                            0, st>>>((const T*)x, idx, (T*)out, n);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_mid_pass(const void* x, const int8_t* a, const int8_t* ss,
                           const int8_t* c, void* out, int64_t nsub, int S,
                           cudaStream_t st) {
  if (S < 1 || S > 128) return -1;
  const int cells = S * 128;
  int tpb = 8192 / cells;
  if (tpb < 1) tpb = 1;
  const int smem = tpb * cells * ((int)sizeof(T) + 2);
  cudaFuncSetAttribute(mid_pass_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int64_t blocks = (nsub + tpb - 1) / tpb;
  if (blocks > 0)
    mid_pass_kernel<T><<<(unsigned)blocks, THREADS * 2, smem, st>>>(
        (const T*)x, a, ss, c, (T*)out, nsub, S, tpb);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_tdesc(const void* x, const int8_t* idx, void* out,
                        int64_t g, int64_t rb, cudaStream_t st) {
  const int smem = 128 * XPAD * sizeof(T) + 128 * IPAD;
  cudaFuncSetAttribute(tdesc_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (g * rb > 0)
    tdesc_kernel<T><<<(unsigned)(g * rb), THREADS, smem, st>>>(
        (const T*)x, idx, (T*)out, rb);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_tasc(const void* x, const int8_t* idx, void* out,
                       int64_t g, int64_t rb, int fold_op, cudaStream_t st) {
  const int smem = 128 * XPAD * sizeof(T);
  cudaFuncSetAttribute(tasc_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (g * rb > 0)
    tasc_kernel<T><<<(unsigned)(g * rb), THREADS, smem, st>>>(
        (const T*)x, idx, (T*)out, rb, fold_op);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_inner3(const void* x, const int8_t* ai, const int8_t* am,
                         const int8_t* ss, const int8_t* cm, const int8_t* ci,
                         void* scratch, void* out, int64_t g, int S,
                         cudaStream_t st) {
  const int tiles = 128 * XPAD * sizeof(T) + 128 * IPAD;   // stages 1, 3
  const int mid = CC * S * 128 * ((int)sizeof(T) + 3);     // stage 2
  const int smem = tiles > mid ? tiles : mid;
  if (S < 1 || smem > 232448) return -1;
  cudaFuncSetAttribute(inner3_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (g > 0)
    inner3_kernel<T><<<(unsigned)g, INNER_THREADS, smem, st>>>(
        (const T*)x, ai, am, ss, cm, ci, (T*)scratch, (T*)out, S);
  return (int)cudaGetLastError();
}

extern "C" int pgb_lane_gather_tdesc(const void* x, const void* idx,
                                     void* out, int64_t g, int64_t rb,
                                     int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch_tdesc<float>(x, (const int8_t*)idx, out, g, rb, st);
  if (dtype == DT_I32)
    return launch_tdesc<int32_t>(x, (const int8_t*)idx, out, g, rb, st);
  return -1;
}

extern "C" int pgb_lane_gather_tasc(const void* x, const void* idx, void* out,
                                    int64_t g, int64_t rb, int dtype,
                                    int fold_op, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch_tasc<float>(x, (const int8_t*)idx, out, g, rb, fold_op, st);
  if (dtype == DT_I32)
    return launch_tasc<int32_t>(x, (const int8_t*)idx, out, g, rb, fold_op,
                                st);
  return -1;
}

extern "C" int pgb_lane_gather(const void* x, const void* idx, void* out,
                               int64_t rows, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DT_F32)
    return launch_lane_gather<float>(x, (const int8_t*)idx, out, rows, st);
  if (dtype == DT_I32)
    return launch_lane_gather<int32_t>(x, (const int8_t*)idx, out, rows, st);
  return -1;
}

// ss may be null (S == 1)
extern "C" int pgb_mid_pass(const void* x, const void* a, const void* ss,
                            const void* c, void* out, int64_t nsub, int S,
                            int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t *ai = (const int8_t*)a, *si = (const int8_t*)ss,
               *ci = (const int8_t*)c;
  if (dtype == DT_F32)
    return launch_mid_pass<float>(x, ai, si, ci, out, nsub, S, st);
  if (dtype == DT_I32)
    return launch_mid_pass<int32_t>(x, ai, si, ci, out, nsub, S, st);
  return -1;
}

extern "C" int pgb_inner3(const void* x, const void* ai, const void* am,
                          const void* ss, const void* cm, const void* ci,
                          void* scratch, void* out, int64_t g, int S,
                          int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t *a = (const int8_t*)ai, *m = (const int8_t*)am,
               *s = (const int8_t*)ss, *c = (const int8_t*)cm,
               *i = (const int8_t*)ci;
  if (dtype == DT_F32)
    return launch_inner3<float>(x, a, m, s, c, i, scratch, out, g, S, st);
  if (dtype == DT_I32)
    return launch_inner3<int32_t>(x, a, m, s, c, i, scratch, out, g, S,
                                  st);
  return -1;
}
