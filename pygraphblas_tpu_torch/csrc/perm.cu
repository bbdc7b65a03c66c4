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
// and writes once.

#include <cooperative_groups.h>

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

// ascend (replaces pygraphblas_tpu/core/perm.py:_lane_gather_tasc):
//   x (g, 128, rb, 128), idx (g*rb*128, 128) ->
//   y[gi, b, r, l] = x[gi, idx[gi, b, r, l], b, r]
//   out = y, or with fold_op >= 0 out[gi, b, j, l] = fold_s y[gi, b, 8j+s, l]
//
// Bound: bytes, 5 a cell (x and idx) and the output (4 a cell, or 0.5
// with the fold): 0.0310 ms at kron-20's fold8 pass (1152 tiles).  The
// earlier design (one 128x128 tile a block, 0.0639 ms there on an H100
// 80GB HBM3 at 700 W) held a 66 KB padded tile, so 3 blocks an SM; it
// loaded the whole tile before it gathered, so HBM idled while it did;
// it read x 4 B and idx 1 B a thread, idx inside the fold loop; and its
// lane gather hit bank (idx + r) mod 32.
//
// Here output rows [32k, 32k + 32) of a tile read only columns [32k,
// 32k + 32) of its 128 source rows (128 B each) and 32 rows of idx: a
// band of 20 KB.  Persistent 128-thread blocks (as many as the SMs hold
// at once) walk the bands; each thread loads its share of the next band
// (eight 16-byte words of x, two of idx) into registers before it
// gathers from the current one, so a band's loads overlap the gather of
// the one before.  The band sits in shared memory as 128 rows of 33
// words, row c's word r at position r ^ (8 * (c >> 5)): the lane gather
// at column r hits bank (c + (r ^ 8 (c >> 5))) mod 32, so the four
// source rows c, c + 32, c + 64, c + 96 of one bank class land in four
// banks, and the stores of the band's 16-byte words (four rows of eight
// words a warp) are conflict-free.  Warp w owns the band's rows 8w ..
// 8w + 7 and each thread four lanes of them: idx comes as one word a
// row, and a thread stores 16 bytes, the fold's (one output row a warp)
// or each row's.  At kron-20's fold8 pass: 0.0356 ms against its bound
// of 0.0310 (chip_smoke, an H100 80GB HBM3 at 700 W).
namespace tasc {
constexpr int W = 32;                   // tile columns (output rows) a band
constexpr int T = 128;                  // threads a block
constexpr int XS = W + 1;               // shared words a source row
constexpr int XCH = 128 * W / 4 / T;    // 16-byte words of x a thread: 8
constexpr int ICH = W * 128 / 16 / T;   // 16-byte words of idx a thread: 2
constexpr int BANDS = 128 / W;          // bands a tile
}  // namespace tasc

template <typename V>
__device__ __forceinline__ V from_bits(uint32_t u) {
  V v;
  memcpy(&v, &u, 4);
  return v;
}
template <typename V>
__device__ __forceinline__ uint32_t to_bits(V v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

template <typename V>
__global__ void __launch_bounds__(tasc::T)
tasc_kernel(const uint32_t* __restrict__ x, const int8_t* __restrict__ idx,
            uint32_t* __restrict__ out, int64_t rb, int64_t n_bands,
            int fold_op) {
  using namespace tasc;
  __shared__ uint32_t xs[128 * XS];
  __shared__ __align__(16) uint32_t is[W * 32];
  const int t = threadIdx.x, w = t >> 5, lt = t & 31;
  uint4 xr[XCH], ir[ICH];
  auto load = [&](int64_t u) {
    const int64_t tb = u / BANDS;
    const int k = (int)(u - tb * BANDS);
    const int64_t gi = tb / rb, b = tb - gi * rb;
    const uint32_t* xb = x + (gi * 128 * rb + b) * 128 + k * W;
#pragma unroll
    for (int m = 0; m < XCH; ++m) {
      const int i = t + T * m;
      xr[m] = __ldcs((const uint4*)(xb + (int64_t)(i >> 3) * rb * 128) +
                     (i & 7));
    }
    const uint4* ib = (const uint4*)(idx + tb * (128 * 128) + k * W * 128);
#pragma unroll
    for (int m = 0; m < ICH; ++m) ir[m] = __ldcs(ib + t + T * m);
  };
  int64_t u = blockIdx.x;
  if (u >= n_bands) return;
  load(u);
  for (; u < n_bands; u += gridDim.x) {
    __syncthreads();            // the band before is gathered
#pragma unroll
    for (int m = 0; m < XCH; ++m) {
      const int i = t + T * m, c = i >> 3, q = i & 7;
      uint32_t* row = xs + c * XS;
      const int sw = (c >> 5) << 3;
      row[(4 * q + 0) ^ sw] = xr[m].x;
      row[(4 * q + 1) ^ sw] = xr[m].y;
      row[(4 * q + 2) ^ sw] = xr[m].z;
      row[(4 * q + 3) ^ sw] = xr[m].w;
    }
#pragma unroll
    for (int m = 0; m < ICH; ++m) ((uint4*)is)[t + T * m] = ir[m];
    __syncthreads();
    const int64_t tb = u / BANDS;
    const int k = (int)(u - tb * BANDS);
    if (u + gridDim.x < n_bands) load(u + gridDim.x);
    if (fold_op >= 0) {
      V acc[4];
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int r = 8 * w + s;
        const uint32_t lanes = is[r * 32 + lt];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (lanes >> (8 * e)) & 127;
          const V v = from_bits<V>(xs[c * XS + (r ^ ((c >> 5) << 3))]);
          acc[e] = s == 0 ? v : apply_fold<V>(fold_op, acc[e], v);
        }
      }
      uint4 o;
      o.x = to_bits(acc[0]);
      o.y = to_bits(acc[1]);
      o.z = to_bits(acc[2]);
      o.w = to_bits(acc[3]);
      *(uint4*)(out + (tb * 16 + (W / 8) * k + w) * 128 + 4 * lt) = o;
    } else {
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const int r = 8 * w + s;
        const uint32_t lanes = is[r * 32 + lt];
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (lanes >> (8 * e)) & 127;
          v[e] = xs[c * XS + (r ^ ((c >> 5) << 3))];
        }
        *(uint4*)(out + (tb * 128 + k * W + r) * 128 + 4 * lt) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// fused middle (layouts as perm.py:761-766), replacing
// pygraphblas_tpu/core/perm.py:_inner3:
//   x, ai, ci, out: (g, S, 128, 128)   am, ss, cm: (g, 128, S, 128)
//   1. descend: Z[c, s, r] = x[s, r, ai[s, r, c]]
//   2. mid, per column c: Y2[s, l] = Z[c, s, am[c, s, l]],
//      Y3[b, l] = Y2[ss[c, b, l], l] (b when S == 1), M[c, b, r] =
//      Y3[b, cm[c, b, r]]; a select index outside [0, S) gives 0, as the
//      TPU kernel's zero-initialised select does
//   3. ascend: out[b, r, l] = M[ci[b, r, l], b, r]
// Every stage gathers through the index slabs as given (any int8
// values, lanes taken & 127), so any slab gives the plain version's bits.
//
// Bound: bytes, 13 a cell (x and out 4 each, five int8 slabs).  The
// group's (128, S, 128) slab Z/M is S x 64 KB (1.5 MB at S = 24), past
// one block's 227 KB.  The first port (one 1024-thread block a group,
// the slab in a device-memory scratch, 0.2760 ms at pr20 on an H100
// 80GB HBM3 at 700 W, 3.8x the bound) paid four extra slab trips
// through L2/HBM and ran one block an SM.  Here one cluster of 8 CTAs
// runs a group and keeps the slab in distributed shared memory: CTA k
// owns columns [16k, 16k + 16), S x 8 KB.  Stage 1: CTA k descends rows
// [16k, 16k + 16) of every tile and stores each Z[c, s, r0..r0+3] as
// one 16-byte word into the owner of c; stage 2 is local to the owner
// (a column's mid stage reads only that column); stage 3: CTA k
// gathers M[:, b, 16k..16k+15] from all owners and ascends those rows.
// A CTA walks its units in order, so what bounds it is the bytes it
// keeps in flight: every global load goes through a cp.async ring as
// deep as the SM's shared memory allows beside the slab, up to 4 slots
// of 10 KB (sized by the launcher: 2 CTAs an SM at S = 9, 1 at S = 18
// and 24; deeper rings measured no faster), a stage-2 unit takes as
// many columns' index rows as a slot
// holds, stage 3 keeps up to 8 units' lanes in flight, and every global
// access is a 16-byte word.  cluster.sync() separates the stages (and
// keeps a CTA's shared memory alive until the others stop reading it).
namespace i3 {
constexpr int N = 8;                // CTAs a cluster (one cluster a group)
constexpr int T = 512;              // threads a CTA
constexpr int COLS = 128 / N;       // slab columns a CTA owns
constexpr int RB = 16;              // rows of a stage-1 / stage-3 unit
constexpr int UNIT = RB * 128;      // cells of a unit
constexpr int SLOT = UNIT * 4 + UNIT;   // a stage-1 unit: words + lanes
constexpr int MAX_S = 24;
constexpr int MAX_SLOTS = 4;
constexpr int PER = (SLOT / 3 + T - 1) / T;   // stage-2 cells a thread

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
#define I3_WAIT(k) \
  case k:          \
    asm volatile("cp.async.wait_group " #k ";\n" ::); break;
    I3_WAIT(1) I3_WAIT(2) I3_WAIT(3) I3_WAIT(4) I3_WAIT(5) I3_WAIT(6)
#undef I3_WAIT
    default:
      asm volatile("cp.async.wait_group 0;\n" ::);
  }
}

// Runs compute(u, slot) for u in [0, n), slot holding what load(u, slot)
// copied, with the loads of the next nslot - 1 units in flight.  The
// prologue (the first nslot - 1 loads) is issued by the caller after a
// barrier that frees the ring.
template <typename Load, typename Compute>
__device__ __forceinline__ void ring(int n, unsigned char* slots, int bytes,
                                     int nslot, Load load, Compute compute) {
  for (int u = 0; u < n; ++u) {
    wait_pending(nslot - 2);
    __syncthreads();   // unit u landed for all; slot (u - 1) % nslot free
    const int v = u + nslot - 1;
    if (v < n) load(v, slots + (v % nslot) * bytes);
    commit();
    compute(u, slots + (u % nslot) * bytes);
  }
  wait_pending(0);
}

template <typename Load>
__device__ __forceinline__ void prologue(int n, unsigned char* slots,
                                         int bytes, int nslot, Load load) {
  for (int v = 0; v < nslot - 1; ++v) {
    if (v < n) load(v, slots + v * bytes);
    commit();
  }
}
}  // namespace i3

__global__ void __launch_bounds__(i3::T, 2)
inner3_kernel(const uint32_t* __restrict__ x, const int8_t* __restrict__ ai,
              const int8_t* __restrict__ am, const int8_t* __restrict__ ss,
              const int8_t* __restrict__ cm, const int8_t* __restrict__ ci,
              uint32_t* __restrict__ out, int S, int nslot) {
  using namespace i3;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char i3smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.block_rank();
  const int64_t gbase = (int64_t)(blockIdx.x / N) * S * TILE;
  const int t = threadIdx.x;
  const int per_c = S * 128;
  uint32_t* slab = (uint32_t*)i3smem;                // [COLS][S][128]
  unsigned char* slots = i3smem + (size_t)COLS * per_c * 4;
  const int r0 = k * RB;
  // stages 1 and 3: thread t handles column c = t & 127 and rows
  // r0 + 4 (t >> 7) .. + 3; its column lives in CTA c / COLS
  const int c = t & 127, r4 = t >> 7;
  uint32_t* remote = cluster.map_shared_rank(slab, c / COLS) +
                     (c % COLS) * per_c + r0 + 4 * r4;

  // 1. descend: unit s = rows [r0, r0 + RB) of tile s
  auto load1 = [&](int s, unsigned char* slot) {
    const int64_t off = gbase + (int64_t)s * TILE + r0 * 128;
    cp16(slot + t * 16, x + off + t * 4);
    if (t < UNIT / 16) cp16(slot + UNIT * 4 + t * 16, ai + off + t * 16);
  };
  prologue(S, slots, SLOT, nslot, load1);
  cluster.sync();           // every CTA of the cluster runs: DSMEM is live
  ring(S, slots, SLOT, nslot, load1, [&](int s, unsigned char* slot) {
    const uint32_t* xs = (const uint32_t*)slot;
    const int8_t* is = (const int8_t*)(slot + UNIT * 4);
    uint4 v;
    v.x = xs[(4 * r4 + 0) * 128 + (is[(4 * r4 + 0) * 128 + c] & 127)];
    v.y = xs[(4 * r4 + 1) * 128 + (is[(4 * r4 + 1) * 128 + c] & 127)];
    v.z = xs[(4 * r4 + 2) * 128 + (is[(4 * r4 + 2) * 128 + c] & 127)];
    v.w = xs[(4 * r4 + 3) * 128 + (is[(4 * r4 + 3) * 128 + c] & 127)];
    *(uint4*)(remote + s * 128) = v;
  });

  // 2. mid: unit j = owned columns [j cpu, j cpu + cpu); their cm, am
  // and ss rows (cpu x S x 128 bytes each, contiguous) staged in a slot
  const int cpu = min(COLS, SLOT / (3 * per_c));
  // ceil(2^32 / per_c): __umulhi(cell, inv_c) == cell / per_c for every
  // cell < SLOT / 3, since cell * (inv_c * per_c - 2^32) < 2^32
  const unsigned inv_c = (unsigned)((0x100000000ull + per_c - 1) / per_c);
  const int units2 = (COLS + cpu - 1) / cpu;
  const int narr = S > 1 ? 3 : 2;
  auto load2 = [&](int j, unsigned char* slot) {
    const int nc = min(cpu, COLS - j * cpu), len = nc * per_c;
    const int64_t off = gbase + (int64_t)(k * COLS + j * cpu) * per_c;
    const int chunks = len / 16;
    for (int q = t; q < narr * chunks; q += T) {
      const int arr = q / chunks, w = q - arr * chunks;
      const int8_t* src = arr == 0 ? cm : arr == 1 ? am : ss;
      cp16(slot + arr * len + w * 16, src + off + w * 16);
    }
  };
  __syncthreads();          // the ring is free
  prologue(units2, slots, SLOT, nslot, load2);
  cluster.sync();           // every Z column has arrived
  ring(units2, slots, SLOT, nslot, load2, [&](int j, unsigned char* slot) {
    const int len = min(cpu, COLS - j * cpu) * per_c;
    const int8_t* cms = (const int8_t*)slot;
    const int8_t* ams = cms + len;
    const int8_t* sss = cms + 2 * len;
    uint32_t* cols = slab + j * cpu * per_c;
    uint32_t v[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int cell = t + q * T;
      if (cell < len) {
        // (column, 0, 0): cell / per_c by the reciprocal, exact here
        const int row = (int)__umulhi((unsigned)cell, inv_c) * per_c;
        const int b = (cell - row) >> 7, l2 = cms[cell] & 127;
        const int s = S > 1 ? (int)sss[row + b * 128 + l2] : b;
        v[q] = (s >= 0 && s < S)
                   ? cols[row + s * 128 + (ams[row + s * 128 + l2] & 127)]
                   : 0u;
      }
    }
    __syncthreads();        // the columns are read: M may overwrite Z
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int cell = t + q * T;
      if (cell < len) cols[cell] = v[q];
    }
  });

  // 3. ascend: unit b = rows [r0, r0 + RB) of output tile b.  ms takes
  // M[:, b, r0 .. r0 + RB) gathered from the owners; the units' lanes
  // (2 KB each) come through a ring of their own behind ms
  uint32_t* ms = (uint32_t*)slots;                   // [RB][128]
  unsigned char* lslots = slots + UNIT * 4;
  const int nslot3 = min(MAX_SLOTS, (nslot * SLOT - UNIT * 4) / UNIT);
  auto load3 = [&](int b, unsigned char* slot) {
    const int64_t off = gbase + (int64_t)b * TILE + r0 * 128;
    if (t < UNIT / 16) cp16(slot + t * 16, ci + off + t * 16);
  };
  __syncthreads();          // the ring is free
  prologue(S, lslots, UNIT, nslot3, load3);
  cluster.sync();           // every M column is final
  const int orow = t >> 5, l4 = (t & 31) * 4;
  uint4 m = *(const uint4*)remote;                   // unit 0's M words
  ring(S, lslots, UNIT, nslot3, load3, [&](int b, unsigned char* slot) {
    ms[(4 * r4 + 0) * 128 + c] = m.x;
    ms[(4 * r4 + 1) * 128 + c] = m.y;
    ms[(4 * r4 + 2) * 128 + c] = m.z;
    ms[(4 * r4 + 3) * 128 + c] = m.w;
    if (b + 1 < S) m = *(const uint4*)(remote + (b + 1) * 128);
    __syncthreads();
    const uint32_t lanes = *(const uint32_t*)(slot + orow * 128 + l4);
    const uint32_t* row = ms + orow * 128;
    uint4 o;
    o.x = row[lanes & 127];
    o.y = row[(lanes >> 8) & 127];
    o.z = row[(lanes >> 16) & 127];
    o.w = row[(lanes >> 24) & 127];
    *(uint4*)(out + gbase + (int64_t)b * TILE + (r0 + orow) * 128 + l4) = o;
  });
  cluster.sync();           // no CTA leaves while others read its slab
}

// per-row lane gather (replaces perm.py:_lane_gather):
//   out[r, l] = x[r, idx[r, l] & 127] over (rows, 128)
// (the & 127 keeps a bad index inside its row; the plans give 0..127).
//
// Bound: bytes, 9 a cell (x and out 4 each, idx 1): 0.0169 ms at
// (49152, 128) on an H100 at 3.35 TB/s.  The first port (one thread a
// cell, a 4-byte load and store and a 1-byte index load each: 0.0338
// ms there, chip_smoke on an H100 80GB HBM3 at 700 W) issued four
// memory instructions for every 9 bytes.  Here a warp takes whole rows:
// one 16-byte load a lane brings in the 512-byte source row, one 4-byte
// load a lane its four indices, the row goes to a per-warp row of
// shared memory, and each lane gathers its four cells from it and
// stores them as one 16-byte word.  A warp keeps ROWS rows in flight
// (all their loads issued before the first is staged), and persistent
// blocks, as many as the card holds at once, stride over the row
// groups.
namespace lg {
constexpr int T = 256;              // threads a block
constexpr int WARPS = T / 32;
constexpr int ROWS = 4;             // rows a warp keeps in flight
}  // namespace lg

__global__ void __launch_bounds__(lg::T)
lane_gather_kernel(const uint32_t* __restrict__ x,
                   const int8_t* __restrict__ idx,
                   uint32_t* __restrict__ out, int64_t rows) {
  using namespace lg;
  __shared__ uint4 buf[WARPS][ROWS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t step = (int64_t)gridDim.x * WARPS * ROWS;
  for (int64_t r0 = ((int64_t)blockIdx.x * WARPS + w) * ROWS; r0 < rows;
       r0 += step) {
    uint4 v[ROWS];
    uint32_t ix[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (r0 + k < rows) {
        v[k] = __ldcs((const uint4*)(x + (r0 + k) * 128) + lane);
        ix[k] = __ldcs((const uint32_t*)(idx + (r0 + k) * 128) + lane);
      }
    }
    __syncwarp();               // the rows before are gathered
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      if (r0 + k < rows) buf[w][k][lane] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (r0 + k < rows) {
        const uint32_t* row = (const uint32_t*)buf[w][k];
        const uint32_t i = ix[k];
        __stcs((uint4*)(out + (r0 + k) * 128) + lane,
               make_uint4(row[i & 127], row[(i >> 8) & 127],
                          row[(i >> 16) & 127], row[(i >> 24) & 127]));
      }
    }
  }
}

// bottom Benes level (perm.py:_mid_pass) over (nsub, S, 128) tiles:
//   y[s, l] = x[s, a[s, l]]            A lane gather
//   z[s, l] = y[ss[s, l], l]           sublane select (z = y when S == 1)
//   out[s, l] = z[s, c[s, l]]          C lane gather
// composed per output cell: with c = c[s, l] and t = ss[s, c],
// out[s, l] = x[t, a[t, c]]; a select index outside [0, S) gives 0, as
// the TPU kernel's zero-initialised select does.  The kernel moves
// 32-bit words, so one instantiation serves float32 and int32.
//
// Bound: bytes, 11 a cell with a select (x and out 4 each, a, ss and c
// one each), 10 without: 0.0207 ms at kron-18's bottom level (S = 3),
// 0.0067 at kron-16 symmetrised's (S = 124), on an H100 at 3.35 TB/s.
// The first port (0.0468 and 0.0161 ms there, chip_smoke on an H100
// 80GB HBM3 at 700 W) staged whole tiles with 4-byte and 1-byte loads,
// then gathered with no load in flight, and divided every cell's index
// by the tile's size.  Here persistent blocks walk chunks of whole tiles
// (at least STAGE_CELLS cells, or one tile) through a 2-stage ring
// in shared memory: x, a, c and ss of a chunk arrive by 16-byte
// cp.async copies, and the chunk after next is issued as soon as a
// stage is gathered, so one stage loads while the other gathers (at
// S = 124 a stage is one 109 KB tile and both fit in 227 KB).  Warp w
// gathers rows w, w + nw, ... of a chunk, each lane four cells of the
// row: one 4-byte word of c (a row's c is one 128-byte line: no bank
// conflict), the row's select bytes (one line), then a and x of the
// selected rows, and one 16-byte store; the rows' tile and row numbers
// advance by additions.  The x reads follow the plan's lanes, so their
// banks are as random as the permutation.
namespace midp {
constexpr int STAGE_CELLS = 1024;       // chosen on the card (PERF.md)
constexpr int CELL_BYTES = 4 + 3;       // x, a, c and ss a cell
constexpr int MAX_SMEM = 2 * 128 * 128 * CELL_BYTES;   // 229,376 at S = 128
}  // namespace midp

__global__ void __launch_bounds__(512)
mid_pass_kernel(const uint32_t* __restrict__ x, const int8_t* __restrict__ a,
                const int8_t* __restrict__ ss, const int8_t* __restrict__ c,
                uint32_t* __restrict__ out, int64_t nsub, int S, int tpb,
                int64_t n_chunks) {
  extern __shared__ __align__(16) unsigned char mp_smem[];
  const int cells = S * 128, scells = tpb * cells;
  const int sbytes = scells * midp::CELL_BYTES;
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, lane = t & 31, nw = nt >> 5;
  // stage st: x words, then a, c and ss bytes, scells of each
  auto load = [&](int64_t chunk, int st) {
    if (chunk < n_chunks) {
      const int64_t tile0 = chunk * tpb;
      const int ncell =
          (int)((nsub - tile0 < tpb ? nsub - tile0 : tpb) * cells);
      const int64_t base = tile0 * cells;
      unsigned char* xs = mp_smem + st * sbytes;
      unsigned char *as = xs + scells * 4, *cs = as + scells,
                    *sq = cs + scells;
      for (int k = t; k < ncell / 4; k += nt)
        i3::cp16(xs + 16 * k, x + base + 4 * k);
      for (int k = t; k < ncell / 16; k += nt) {
        i3::cp16(as + 16 * k, a + base + 16 * k);
        i3::cp16(cs + 16 * k, c + base + 16 * k);
        if (ss != nullptr) i3::cp16(sq + 16 * k, ss + base + 16 * k);
      }
    }
    i3::commit();
  };
  // a warp's rows advance by nw = q * S + rem rows a step
  const int q = nw / S, rem = nw - q * S;
  const int tb0 = warp / S, s0 = warp - tb0 * S;
  int64_t chunk = blockIdx.x;
  load(chunk, 0);
  load(chunk + gridDim.x, 1);
  for (int i = 0; chunk < n_chunks; chunk += gridDim.x, ++i) {
    const int st = i & 1;
    i3::wait_pending(1);        // this chunk's copies have landed
    __syncthreads();
    const unsigned char* xs = mp_smem + st * sbytes;
    const uint32_t* xw = (const uint32_t*)xs;
    const int8_t* as = (const int8_t*)(xs + scells * 4);
    const uint32_t* cw = (const uint32_t*)(xs + scells * 5);
    const int8_t* sq = (const int8_t*)(xs + scells * 6);
    const int64_t tile0 = chunk * tpb;
    const int rows = (int)((nsub - tile0 < tpb ? nsub - tile0 : tpb) * S);
    uint32_t* ob = out + tile0 * cells;
    int tb = tb0, s = s0;
    for (int r = warp; r < rows; r += nw) {
      const uint32_t cl4 = cw[r * 32 + lane];
      const int8_t* at = as + tb * cells;
      const uint32_t* xt = xw + tb * cells;
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = (cl4 >> (8 * e)) & 127;
        const int tt = ss != nullptr ? sq[r * 128 + cl] : s;
        o[e] = (tt >= 0 && tt < S) ? xt[tt * 128 + (at[tt * 128 + cl] & 127)]
                                   : 0u;
      }
      *(uint4*)(ob + r * 128 + 4 * lane) = make_uint4(o[0], o[1], o[2], o[3]);
      s += rem;
      tb += q;
      if (s >= S) s -= S, ++tb;
    }
    __syncthreads();            // the stage is free
    load(chunk + 2 * (int64_t)gridDim.x, st);
  }
}

// x, idx and out 16-byte aligned; persistent blocks, as many as the
// card holds at once (queried once)
static int launch_lane_gather(const void* x, const int8_t* idx, void* out,
                              int64_t rows, cudaStream_t st) {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lane_gather_kernel, lg::T, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return -1;
    blocks = per_sm * sms;
  }
  const int64_t groups = (rows + lg::WARPS * lg::ROWS - 1) /
                         (lg::WARPS * lg::ROWS);
  if (groups > 0)
    lane_gather_kernel<<<(unsigned)(groups < blocks ? groups : blocks), lg::T,
                         0, st>>>((const uint32_t*)x, idx, (uint32_t*)out,
                                  rows);
  return (int)cudaGetLastError();
}

// x, a, ss, c and out 16-byte aligned; persistent blocks, as many as
// the card holds at once (queried once an S)
static int launch_mid_pass(const void* x, const int8_t* a, const int8_t* ss,
                           const int8_t* c, void* out, int64_t nsub, int S,
                           cudaStream_t st) {
  static int blocks[129];
  if (S < 1 || S > 128 || (S > 1) != (ss != nullptr)) return -1;
  const int cells = S * 128;
  const int tpb = cells >= midp::STAGE_CELLS ? 1 : midp::STAGE_CELLS / cells;
  const int threads = tpb * S >= 32 ? 512 : 256;
  const int smem = 2 * tpb * cells * midp::CELL_BYTES;
  if (blocks[S] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        mid_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        midp::MAX_SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mid_pass_kernel, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return -1;
    blocks[S] = per_sm * sms;
  }
  const int64_t n_chunks = (nsub + tpb - 1) / tpb;
  const int64_t grid = n_chunks < blocks[S] ? n_chunks : blocks[S];
  if (grid > 0)
    mid_pass_kernel<<<(unsigned)grid, threads, smem, st>>>(
        (const uint32_t*)x, a, ss, c, (uint32_t*)out, nsub, S, tpb,
        n_chunks);
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

// Persistent blocks: as many as the card holds at once (queried once a
// dtype), at most one a band.
template <typename V>
static int launch_tasc(const void* x, const int8_t* idx, void* out,
                       int64_t g, int64_t rb, int fold_op, cudaStream_t st) {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tasc_kernel<V>, tasc::T, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return -1;
    blocks = per_sm * sms;
  }
  const int64_t n_bands = g * rb * tasc::BANDS;
  if (n_bands > 0)
    tasc_kernel<V><<<(unsigned)(n_bands < blocks ? n_bands : blocks),
                     tasc::T, 0, st>>>((const uint32_t*)x, idx,
                                       (uint32_t*)out, rb, n_bands, fold_op);
  return (int)cudaGetLastError();
}

// A cluster of 8 CTAs, each with S x 8 KB of slab and a ring of as many
// 10 KB slots (3 or 4) as the SM's 228 KB leave beside the slabs of the
// CTAs it can hold; returns -2 where the card cannot place one such
// cluster (never launched then).
static int launch_inner3(const uint32_t* x, const int8_t* ai,
                         const int8_t* am, const int8_t* ss,
                         const int8_t* cm, const int8_t* ci, uint32_t* out,
                         int64_t g, int S, cudaStream_t st) {
  using namespace i3;
  constexpr int kSmSmem = 233472, kBlockSmem = 232448, kReserved = 1024;
  static int placed[MAX_S + 1];      // 0 unknown, 1 placeable, -2 not
  if (S < 1 || S > MAX_S) return -1;
  const int slab = COLS * S * 128 * 4;
  int ctas = kSmSmem / (slab + 3 * SLOT + kReserved);
  ctas = ctas < 1 ? 1 : ctas > 2 ? 2 : ctas;   // 2: the launch bounds
  int budget = kSmSmem / ctas - kReserved;
  budget = budget < kBlockSmem ? budget : kBlockSmem;
  int nslot = (budget - slab) / SLOT;
  nslot = nslot > MAX_SLOTS ? MAX_SLOTS : nslot;
  const int smem = slab + nslot * SLOT;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(g * N));
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!placed[S]) {
    cudaError_t e = cudaFuncSetAttribute(
        inner3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBlockSmem);
    if (e != cudaSuccess) return (int)e;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)inner3_kernel,
                                       &cfg);
    if (e != cudaSuccess) return (int)e;
    placed[S] = clusters > 0 ? 1 : -2;
  }
  if (placed[S] < 0) return placed[S];
  if (g <= 0) return 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, inner3_kernel, x, ai, am, ss, cm,
                                     ci, out, S, nslot);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// the pure moves take any word dtype code: they move 32-bit words
static bool word_dtype(int dtype) { return dtype >= DT_F32 && dtype <= DT_BOOL; }

extern "C" int pgb_lane_gather_tdesc(const void* x, const void* idx,
                                     void* out, int64_t g, int64_t rb,
                                     int dtype, void* stream) {
  if (!word_dtype(dtype)) return -1;
  return launch_tdesc<uint32_t>(x, (const int8_t*)idx, out, g, rb,
                                (cudaStream_t)stream);
}

// fold_op: -1, or any fold code the word type takes (ops.cuh fold_ok)
extern "C" int pgb_lane_gather_tasc(const void* x, const void* idx, void* out,
                                    int64_t g, int64_t rb, int dtype,
                                    int fold_op, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (fold_op >= 0 && !(dtype == DT_F32 ? fold_ok<float>(fold_op)
                                        : fold_ok<int32_t>(fold_op)))
    return -1;
  PGB_DISPATCH_WORD(dtype, launch_tasc<T>(x, (const int8_t*)idx, out, g, rb,
                                          fold_op, st));
}

// x, idx and out 16-byte aligned
extern "C" int pgb_lane_gather(const void* x, const void* idx, void* out,
                               int64_t rows, int dtype, void* stream) {
  if (!word_dtype(dtype)) return -1;
  if ((uintptr_t)x % 16 || (uintptr_t)idx % 16 || (uintptr_t)out % 16)
    return -1;
  return launch_lane_gather(x, (const int8_t*)idx, out, rows,
                            (cudaStream_t)stream);
}

// ss null when S == 1; x and out 4-byte words of any dtype code (the
// kernel moves them); every pointer 16-byte aligned
extern "C" int pgb_mid_pass(const void* x, const void* a, const void* ss,
                            const void* c, void* out, int64_t nsub, int S,
                            int dtype, void* stream) {
  if (!word_dtype(dtype)) return -1;
  return launch_mid_pass(x, (const int8_t*)a, (const int8_t*)ss,
                         (const int8_t*)c, out, nsub, S,
                         (cudaStream_t)stream);
}

// x and out: 4-byte words of any dtype code (the kernel only moves
// them); every pointer 16-byte aligned; ss null when S == 1
extern "C" int pgb_inner3(const void* x, const void* ai, const void* am,
                          const void* ss, const void* cm, const void* ci,
                          void* out, int64_t g, int S, void* stream) {
  return launch_inner3((const uint32_t*)x, (const int8_t*)ai,
                       (const int8_t*)am, (const int8_t*)ss,
                       (const int8_t*)cm, (const int8_t*)ci, (uint32_t*)out,
                       g, S, (cudaStream_t)stream);
}
