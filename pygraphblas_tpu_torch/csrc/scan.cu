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
// ones, over float, int32 or uint32 words.  The kernel itself lives in
// scan.cuh, with the fold a functor, so that a generated translation
// unit (_opgen.py) instantiates it at a user monoid's fold too.
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

#include "scan.cuh"

namespace {

using namespace scan;

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
      return launch_segfold<T, FoldCode<OP>>(vals, flags, out, n, status, \
                                             epoch, ticket, st);          \
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
  return (n + scan::kTile - 1) / scan::kTile;
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
