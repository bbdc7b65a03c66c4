#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pygraphblas_tpu_torch) on one card.

Phases, in order; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit);
  2. the build: the CUDA kernels (nvcc, sm_90a, one process a source,
     each source's seconds logged) and the native Benes routing (g++),
     from the sources in this checkout;
  3. the paths, each on its own graph (RMAT kron, generated from seed
     42) and its xspmv plans, each driven through the entry point a user
     calls, with the launch counters set to 0 just before and read just
     after; every kernel of the path must have run, exactly the expected
     number of times per xspmv:
       pr20   fused.pagerank, kron-20 ef16 FP32 (A^T), checked against
              the planless COO oracle, timed (best of 3);
       pr21   fused.pagerank, kron-21 ef16 FP32: its first fold level
              streams its source, so the cascade does not apply;
       bfs18  fused.bfs_batch (16 sources) + fused.bfs_level(0),
              kron-18 ef16 BOOL, levels equal to scipy's BFS exactly;
       sssp18 fused.sssp from the vertex of most out-edges, kron-18
              ef16 FP32 with integer weights 1..255, distances equal
              to scipy's Dijkstra exactly;
       bc16   fused.bc, sources 0..3, kron-16 symmetrised FP32, within
              1e-4 of the same call with device="cpu";
       then the masked-SpGEMM paths (core/spgemm.py), each masked_spgemm
       call launching its kernel once per width bucket (or per chunk of
       the unfused chain), as counted from the call's arguments:
       tc16   algorithms.triangle_count, kron-16 symmetrised (bc16's
              graph), warm, best of 3, equal to scipy's count; then once
              through the unfused chain (PYGB_PAIR_FUSED=0, fill_keys),
              per-edge counts equal;
       tc18   triangle_count, kron-18 symmetrised (bfs18's edges), best
              of 3; every edge's count equal to scipy's (L @ L) .* L;
       kt14   algorithms.k_truss(A, 4), kron-14 symmetrised, warm; edges
              and supports equal to scipy's fixed point;
       kt16   k_truss(A, 4), kron-16 symmetrised, warm, then through the
              unfused chain: equal edges and supports, all >= 2;
       val16  masked_spgemm on tc16's L with weights 1..4: FP32
              PLUS_TIMES equal to scipy's exactly, INT32 MIN_PLUS equal
              to the generic intersect (torch ops) on the card;
       then the unmasked-SpGEMM paths (core/gustavson.spgemm under
       spgemm_engine="auto", which takes the ESC engine on the card: four
       segfold launches and one esc_gather a call, no dense matmul):
       esc14  C = A @ A, kron-14 ef16 directed, FP32 weights 1..4 (seed
              7), PLUS_TIMES, warm, best of 3; equal to scipy's exactly;
       esc13  kron-13 symmetrised, INT32: PLUS_PAIR (common neighbours)
              equal to scipy's S @ S; MIN_PLUS with weights 1..255 equal
              to the same product through spgemm_engine="scipy" (scipy's
              pattern, then masked_spgemm's pair_fold on the card);
       then the algebra (types, ops, monoids and semirings carried into
       the kernels at every type of 4 bytes or less):
       sr14   six gustavson.spgemm calls on esc14's graph (ESC, each
              four segfold launches and one esc_gather): BOOL LOR_LAND
              (all true) equal to scipy's (A @ A) != 0; INT8 ANY_PAIR to
              scipy's pattern, values 1; INT16 PLUS_TIMES (weights 1..4)
              to scipy's product wrapped to int16; UINT8 MIN_PLUS
              (1..100) and UINT32 BOR_BAND (any 32 bits) to the same
              call under spgemm_engine="scipy"; INT32 PLUS_DIV (B's
              values 0..4: x / 0 saturates) to the same call on the CPU;
       sr16   masked_spgemm on tc16's L with val16's weights, the JAX
              package's route shown by the counters: BOOL LOR_PAIR
              launches pair_count, INT16 PLUS_TIMES pair_fold, BOOL
              LOR_LAND and UINT32 BXOR_PAIR neither (the generic
              intersect); each equal to scipy;
       then the container API (Matrix and Vector) over the earlier
       paths' graphs, matrices and xspmv plans (no new xspmv plan):
       gpr20  algorithms.pagerank (Matrix.mxv, desc=T0, accum=PLUS) on
              pr20's matrix under spmv_engine="xspmv": 5 iterations
              within 1e-3 x the largest rank of fused.pagerank's, 2
              mono_span, 1 tdesc, 1 inner3, 1 tasc and 1 cascade an
              iteration, timed an iteration as (25-iteration call -
              5-iteration call) / 20 beside pr20's fused loop; then 5
              through spmv_engine="csr8" (torch ops, no kernel; its
              plan's host build timed) within 1e-5 x the largest rank;
       gsp18  algorithms.sssp on sssp18's matrix from its source and
              algorithms.bfs_level_vxm on bfs18's from vertex 0 (which
              has no out-edge) and from that source (vxm: SpMSpV, then
              the csr8 plan; no kernel), each equal to its fused loop
              exactly (after sssp18);
       gtc16  triangle_count "cohen" and "sandia_dot" on tc16's graph
              (tril, triu, a masked Matrix.mxm: pair_count once a width
              bucket, each launch held against its plain version),
              each equal to tc16's count (after tc16);
       gesc14 Matrix.mxm(A, PLUS_TIMES) on esc14's graph as a Matrix (the
              COO tier: ESC, 4 segfold and 1 esc_gather), equal to
              esc14's product exactly (after esc14);
       then the rest of Matrix (extract and assign over index sets,
       Kronecker) and Louvain over it:
       gx20   on pr20's matrix (after gpr20; the COO tier, no kernel):
              the row block A[0:262143, :], 4096 random rows, one row,
              one column, a 4096 x 4096 block assigned, a scalar over 8
              rows under a mask; each equal to scipy's slice or
              assignment of the same CSR;
       glv16  algorithms.louvain_cluster on bc16's graph (FP32 weights
              1.0, max_iters 20, max_levels 10): its chunk products and
              contractions through Matrix.mxm (the diagonal-B path, ESC:
              4 segfold and 1 esc_gather a call, the host tier past
              ESC's caps, the dense tier once a contracted graph is
              small); labels equal to the same call with device="cpu";
              every ESC call's launches recorded and held against
              their plain versions after the run (bit-exact over the
              live slots, as esc14's); every product's output
              row-major; modularity through scipy;
       gkr    A.kronecker(B) on the bitmap tier (two 64 x 64 FP32
              matrices at density 1/2) and on the COO tier (kron-10
              symmetrised with a 16 x 16 INT32 matrix at density 1/2),
              each equal to scipy.sparse.kron (no kernel);
       then slice 12 (the direction-optimised BFS, the sparse DNN and
       the I/O):
       gio    after gx20, binwrite / binread of pr20's kron-20 matrix,
              and after gbfs18, to_mm / from_mm (the native parser) of
              bfs18's, in temporary directories; each iseq the original;
       gbfs18 after gsp18, algorithms.bfs_level and bfs_parents on
              bfs18's matrix from 0 and from 213,770: the frontier loop
              (from 213,770 it overflows twice and the dense
              fused.bfs_level runs bfs18's plan, its xspmv kernels held
              against their plain versions first); levels equal to
              scipy's, parents equal to the device="cpu" run's, each
              parent edge present and one level up;
       groad  fused.bfs_frontier and algorithms.bfs_level on a 4096 x
              4096 4-neighbour lattice from its centre (the stand-in
              for GAP's road graph): 4097 levels equal to the closed
              form, no retry (no kernel: torch ops);
       gdnn1024 the GraphChallenge DNN at 1024 neurons, 120 layers,
              60,000 images (RadiX-Net, seed 7): fused.dnn and
              algorithms.dnn (bitmap tier) equal entry for entry to a
              float64 oracle on the card, categories equal (no kernel:
              torch.matmul without TF32);
       gdnn_coo the same net at 1024 images (DNN_COO_IMAGES) and 60
              layers (DNN_COO_LAYERS) on the COO tier: algorithms.dnn (the compact-dense tier) and
              hyperdnn (its products through ESC: 4 segfold and 1
              esc_gather a call, every call's launches held against
              their plain versions), each layer's route counted;
              categories equal to the scipy oracle's;
     then the distributed tier (parallel/dist.py): make_mesh() with no
     device, a world of one over NCCL and a (1, 1) mesh on the card; no
     hand kernel may launch (torch ops and collectives); the process
     group is destroyed after:
       gdpr20 A.shard(mesh).pagerank and dist_pagerank on pr20's
              matrix, 20 iterations, within 1e-3 x the largest rank of
              fused.pagerank's 20; ms an iteration beside pr20's;
       gdsp18 bfs_level and sssp from 213,770 on bfs18's and sssp18's
              matrices, equal to gsp18's levels and distances;
       gdtc16 triangle_count on tc16's graph (= tc16's count), k_truss
              on kt14's (= algorithms.k_truss), mxm(W, mask=W) on
              val16's weights under FP32 PLUS_TIMES (rtol 1e-5) and
              INT32 MIN_PLUS (exact) against masked_spgemm;
       gdmxv  mxv on kron-18 under FP32 PLUS_TIMES, INT32 MIN_PLUS,
              UINT32 BOR_BAND and INT32 MIN_FIRSTI1 against Matrix.mxv
              on the card (integers exact);
       gdckpt dist_pagerank on kron-18: 10 iterations with a snapshot
              every 5, resumed to 20: the resume starts from the
              snapshot's ranks bit for bit and ends equal bit for bit to
              an uninterrupted run, as two uninterrupted runs are;
     each with its seconds, the host share (balance, tiling, the rings'
     host build) and the bytes it placed on the card;
     then the user-facing entry points (gallery_phase), each with the
     kernel counters at 0 around it: run_doctests() with the card as the
     examples' default device (0 failures of at least 446), every
     demo_torch script's main (OK last), the GraphChallenge harness
     (synthetic; a small dataset in the challenge's layout against its
     truth file), gap_torch/bcmark.py at its defaults and
     gap_torch/prmark.py --scale 18 --rounds 2 (gprmark18: bfs18's
     launches an xspmv), each with its seconds and launches;
     before each path, every kernel it runs is held against its plain
     PyTorch version on the card at the path's own shapes (bit-exact,
     but pair_fold's float32 PLUS within rtol 1e-5: another fold order),
     at every width bucket of its call (pair_count at every launch of
     kt14's and kt16's first run and of gtc16's runs too, segfold on each of a call's four
     scans, esc_gather at every slot; before sr14, segfold at every fold
     code the algebra adds and pair_fold at its new mul and fold codes,
     testing.SEGFOLD_CODES and PAIR_FOLD_CODES), and timed at the shapes of the
     path named for it in TIMED (and inner3 at pr21, mid_pass at bc16's
     S = 124, lane_gather_tasc without the fold at bfs18, and pair_count
     at tc16, too); the redesigned kernels (inner3 at pr20 and pr21,
     pair_count at tc18, mono_cascade and lane_gather_tasc at pr20,
     segfold at esc14, mid_pass at bfs18 and bc16, pair_fold at val16,
     mono_rows at pr21, lane_gather alone) log their time beside their
     earlier design's
     (EARLIER_MS: constants copied from PERF.md, kept with this run's
     times in chip_smoke_checks.json, not in the kernels line);
     pair_fold's check rows hold each val16 bucket's time, and
     pair_count, timed on the same buckets, is its yardstick (a log
     line and check rows of path "val16_yardstick"); each mono_rows
     launch logs its plan's shape (S, blk, xb, max_w, dm dtype);
  4. small MIN/MAX-fold, mul and int32 cases of every kernel, inner3 at
     S = 1, 3, 9, 18 and 24 in both dtypes, lane_gather_tasc at one
     tile, several groups and several tiles a group with every fold op
     (rows of 128 indices equal mod 32 among them), the cascade on runs
     of every length class of its kernel (pygraphblas_tpu_torch.testing),
     pair_count on hand-made edge lists, pair_fold on the same lists
     with values (FP32 PLUS_TIMES and MAX_RDIV, INT32 MIN_PLUS and
     PLUS_MINUS), mono_rows on hand-made plans (streamed and resident,
     int16 and int32 dm, every fold, with mul and without, both
     dtypes), every wrapper at INT8, UINT16, UINT32 and BOOL
     (testing.wrapper_cases), and _lane_gather (which no path
     reaches) at kron-18's level-0 shape beside torch.gather, and at 1
     and 7 rows with the values' top bit set; then the
     repairs: a MonoPlan with ok == False, and int64 and float64 values
     into every gather and permutation wrapper, each giving its plain
     version's answer on the card with no launch; UINT16/32/64 value
     selects and comparisons (values past the sign bit of the signed
     bit view), user predicates among them, on both tiers, Matrix and
     Vector, equal to the JAX package's answers;
  5. one JSON line of kernel results, the card line, and the final
     {"ok": true, "device": ...} line.

Kernel times ("ms") come from CUDA events around back-to-back calls at a
path's shapes, queued behind a sleep kernel so that the host's launch
path is not timed; the plain versions' ("plain_ms") from back-to-back
calls alone (their tens of launches a call would fill the launch queue
behind the sleep; a slow plain version is called fewer times, at most
about 2 s in all).  Both are summed over the kernel's launches in one
xspmv (one masked_spgemm or unmasked spgemm call) of its timed path.
"in_path_ms" is the kernel's device time per xspmv (per call) inside
that path (torch.profiler), or "incomplete" where the trace, taken twice,
held fewer of the kernel's events than the run launched.  "bound_ms" is
the larger of the bytes moved once over the HBM rate and the fold/mul
operations over the float32 rate (for pair_fold: per edge the compares
of a linear merge, wa + wb, or of a search of the longer list for each
id of the shorter, whichever are fewer, over the int32 rate; for
pair_count one probe per id of each edge's shorter list, over the
int32 rate; for segfold the values and flags read and the values
written, for esc_gather dm read and both outputs written, B staying in
L2); for mono_cascade the bytes are the function's: the level-0 source
read once, its per-row table (4 B a row) and the placed output, with
the earlier bound (every plan's dm and qg, the first source and the
placed output) in its log line and check row ("plan_bound_ms"), not
in the kernels line; its library_ms is
torch.segment_reduce over the same runs.  A kernel whose timed launches
only move data (the gathers, tdesc, tasc without the fold, inner3,
mid_pass) has for its library_ms one torch.take a launch at an int64
index built from its plain version over 1..n (testing.take_index),
checked equal to the kernel's output first.  Each path through the cascade
also times it against the chain of mono_span launches it replaces, as
kernels ("cascade_vs_chain") and end to end through the entry point
("cascade_ab", the cascade call made to return None).

Run:  python3 chip_smoke.py [--iters 200] [--reps 20]
Logs too long for the terminal (nvcc -Xptxas -v, profiler tables, every
check) go to chiprun_out/.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
# H100 SXM data sheet, at a 700 W limit: HBM rate, and float32 outside
# the tensor cores (the folds and muls of these kernels)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# int32 compares (the masked SpGEMM's merge work): 132 SMs x 64 int32
# lanes an SM x 1.98 GHz boost clock = 1.673e13 op/s
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# kernel name -> (source, the TPU kernel it replaces)
KERNELS = {
    "mono_span": ("pygraphblas_tpu_torch/csrc/mono.cu",
                  "pygraphblas_tpu/core/mono.py:247"),
    "mono_cascade": ("pygraphblas_tpu_torch/csrc/cascade.cu",
                     "pygraphblas_tpu/core/mono.py:343"),
    "mono_rows": ("pygraphblas_tpu_torch/csrc/mono.cu",
                  "pygraphblas_tpu/core/mono.py:470"),
    "lane_gather": ("pygraphblas_tpu_torch/csrc/perm.cu",
                    "pygraphblas_tpu/core/perm.py:520"),
    "lane_gather_tdesc": ("pygraphblas_tpu_torch/csrc/perm.cu",
                          "pygraphblas_tpu/core/perm.py:577"),
    "lane_gather_tasc": ("pygraphblas_tpu_torch/csrc/perm.cu",
                         "pygraphblas_tpu/core/perm.py:642"),
    "inner3": ("pygraphblas_tpu_torch/csrc/perm.cu",
               "pygraphblas_tpu/core/perm.py:741"),
    "mid_pass": ("pygraphblas_tpu_torch/csrc/perm.cu",
                 "pygraphblas_tpu/core/perm.py:817"),
    "fill_keys": ("pygraphblas_tpu_torch/csrc/spgemm.cu",
                  "pygraphblas_tpu/core/spgemm.py:68"),
    "pair_count": ("pygraphblas_tpu_torch/csrc/spgemm.cu",
                   "pygraphblas_tpu/core/spgemm.py:179"),
    "pair_fold": ("pygraphblas_tpu_torch/csrc/spgemm.cu",
                  "pygraphblas_tpu/core/spgemm.py:388"),
    "segfold": ("pygraphblas_tpu_torch/csrc/scan.cu",
                "pygraphblas_tpu/core/scan.py:53"),
    "esc_gather": ("pygraphblas_tpu_torch/csrc/esc.cu",
                   "pygraphblas_tpu/core/esc.py:85"),
}

# kernel -> the path whose shapes its "ms" is timed at (lane_gather: no
# path launches it; it is timed alone at the bfs18 level-0 shape)
TIMED = {"mono_span": "pr20", "mono_cascade": "pr20", "mono_rows": "pr21",
         "lane_gather": "isolated", "lane_gather_tdesc": "pr20",
         "lane_gather_tasc": "pr20", "inner3": "pr20", "mid_pass": "bfs18",
         "fill_keys": "tc16_chain", "pair_count": "tc18",
         "pair_fold": "val16", "segfold": "esc14", "esc_gather": "esc14"}

# the redesigned kernels' earlier designs, as PERF.md records them (this
# script on an NVIDIA H100 80GB HBM3 at 700 W): inner3 one 1024-thread
# block a group through a device-memory slab, pair_count one warp an edge
# binary-searching the longer list, mono_cascade a cooperative kernel of
# flag-waiting tiles over every level's plan, lane_gather_tasc one tile
# a block, segfold one 2048-value tile a block (the sum of esc14's four
# scans), mid_pass whole tiles staged by 4- and 1-byte loads, pair_fold
# one warp an edge binary-searching the longer list (the sum of val16's
# buckets), mono_rows one thread a lane with a 64-bit division a cell,
# lane_gather one thread a cell (4-byte loads and stores);
# (ms, how it
# was taken) at a path's shapes: "events" as "ms" here, "in path" from
# the path's profile
EARLIER_MS = {("inner3", "pr20"): (0.2760, "events"),
              ("inner3", "pr21"): (0.5390, "in path"),
              ("pair_count", "tc18"): (2.2221, "events"),
              ("mono_cascade", "pr20"): (0.0572, "events"),
              ("lane_gather_tasc", "pr20"): (0.0639, "events"),
              ("segfold", "esc14"): (1.6443, "events"),
              ("mid_pass", "bfs18"): (0.0468, "events"),
              ("mid_pass", "bc16"): (0.0161, "events"),
              ("pair_fold", "val16"): (0.4956, "events"),
              ("mono_rows", "pr21"): (0.0534, "events"),
              ("lane_gather", "isolated"): (0.0338, "events")}
# (kernel, path) -> this run's ms beside the earlier design's
redesigned = {}


# launches per xspmv of each path (zero for every kernel not named)
EXPECTED = {
    "pr20": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 1,
             "inner3": 1, "lane_gather_tasc": 1},
    "pr21": {"mono_span": 7, "mono_rows": 1, "lane_gather_tdesc": 1,
             "inner3": 1, "lane_gather_tasc": 1},
    "bfs18": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 2,
              "mid_pass": 1, "lane_gather_tasc": 2},
    "sssp18": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 2,
               "mid_pass": 1, "lane_gather_tasc": 2},
    "bc16": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 1,
             "mid_pass": 1, "lane_gather_tasc": 1},
    # the container API (algorithms.pagerank: one Matrix.mxv an
    # iteration) over pr20's plan
    "gpr20": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 1,
              "inner3": 1, "lane_gather_tasc": 1},
    # the same through the csr8 engine, and gsp18's vxm loops (csr8 and
    # SpMSpV): torch ops on the card, no kernel of the port
    "gpr20_csr8": {},
    "gsp18": {},
    # extract/assign over ranges and Kronecker products (slice 11): host
    # COO plumbing and torch ops, no kernel of the port
    "gx20": {},
    "gkr": {},
    # slice 12: algorithms.bfs_level on bfs18's matrix (the frontier
    # loop: torch ops; its dense fallback: bfs18's xspmv plan) and
    # bfs_parents (host)
    "gbfs18": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 2,
               "mid_pass": 1, "lane_gather_tasc": 2},
    # the frontier loop on the lattice, the dense DNN (torch.matmul),
    # dnn's products on the COO tier (the compact-dense tier) and the
    # I/O: no kernel of the port
    "groad": {},
    "gdnn1024": {},
    "gdnn_coo dnn": {},
    "gio binfile": {},
    "gio mm": {},
    # slice 14: gap_torch/prmark.py at kron-18, fused.pagerank on A^T
    # (bfs18's plan shape: the plan is the pattern's)
    "gprmark18": {"mono_span": 2, "mono_cascade": 1, "lane_gather_tdesc": 2,
                  "mid_pass": 1, "lane_gather_tasc": 2},
}
# the JAX package's docstring examples that run_doctests must try on the
# card at least (its __init__, matrix, vector, base, binaryop, unaryop
# and selectop hold 440, its scalar 6)
GALLERY_MIN_EXAMPLES = 446
# masked-SpGEMM paths: the kernel each masked_spgemm call of the path
# launches, once per width bucket of its light edges ("bucket"), or once
# per chunk of (1 << 24) // W edges of each bucket ("chunk"); counted
# from each call's arguments by the script (design_launches)
EXPECTED_SPGEMM = {
    "tc16": ("pair_count", "bucket"), "tc16_chain": ("fill_keys", "chunk"),
    "tc18": ("pair_count", "bucket"), "kt14": ("pair_count", "bucket"),
    "kt16": ("pair_count", "bucket"), "kt16_chain": ("fill_keys", "chunk"),
    "val16": ("pair_fold", "bucket"),
    "sr16 LOR_PAIR": ("pair_count", "bucket"),
    "gtc16 cohen": ("pair_count", "bucket"),
    "gtc16 sandia_dot": ("pair_count", "bucket"),
    "sr16 PLUS_TIMES": ("pair_fold", "bucket"),
}
# the algebra's masked calls that the JAX package's rule sends to its
# generic intersect (spgemm.py:886-913): no kernel launches
GENERIC_SPGEMM = ("sr16 LOR_LAND", "sr16 BXOR_PAIR")

# unmasked-SpGEMM paths: launches per ESC call (segfold: one launch a
# scan, four scans a call)
EXPECTED_ESC = {"esc14": {"segfold": 4, "esc_gather": 1},
                "esc13": {"segfold": 4, "esc_gather": 1},
                "sr14": {"segfold": 4, "esc_gather": 1},
                "gesc14": {"segfold": 4, "esc_gather": 1},
                "glv16": {"segfold": 4, "esc_gather": 1},
                "gdnn_coo hyperdnn": {"segfold": 4, "esc_gather": 1}}

# kernel symbol prefix in a profile -> kernel name
_SYMBOLS = {"mono_span_kernel": "mono_span",
            "mono_cascade_kernel": "mono_cascade",
            "mono_rows_kernel": "mono_rows",
            "lane_gather_kernel": "lane_gather",
            "tdesc_kernel": "lane_gather_tdesc",
            "tasc_kernel": "lane_gather_tasc", "inner3_kernel": "inner3",
            "mid_pass_kernel": "mid_pass", "fill_keys_kernel": "fill_keys",
            "pair_count_kernel": "pair_count",
            "pair_count_short_kernel": "pair_count",
            "pair_fold_kernel": "pair_fold",
            "pair_fold_search_kernel": "pair_fold",
            "pair_fold_warp_kernel": "pair_fold", "segfold_kernel": "segfold",
            "esc_gather_kernel": "esc_gather"}


def log(msg):
    print(msg, flush=True)


def earlier(path, kernel, ms):
    """Log (and keep) a redesigned kernel's time beside its earlier
    design's."""
    old, how = EARLIER_MS[(kernel, path)]
    redesigned[(kernel, path)] = dict(ms=ms, earlier_ms=old, earlier_how=how)
    log(f"  {kernel} at {path}: {ms:.4f} ms; earlier design {old:.4f} ms "
        f"({how}, PERF.md constant), {old / ms:.2f}x this one")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps, behind_sleep=True, max_s=2.0):
    """Mean time of fn() in ms over reps back-to-back calls, from CUDA
    events, after one warm-up call.

    behind_sleep: the calls are queued behind a sleep kernel that
    outlasts the host's enqueueing of all of them (checked: the sleep
    has not ended when the last call is queued), so the events time the
    card's work and not the host's ~25 us launch path, which bounds a
    3 us kernel timed back to back.  Without it (for a call that may
    synchronise inside), plain back-to-back timing, with fewer calls
    where one takes long (at most about max_s seconds in all)."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if not behind_sleep:
        warm = time.perf_counter() - t0
        reps = max(1, min(reps, int(max_s / max(warm, 1e-9))))
    cycles = 1 << 24
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if behind_sleep:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered or not behind_sleep:
            return start.elapsed_time(end) / reps
        if cycles >= 1 << 30:
            raise RuntimeError("event_ms: the calls were not all queued "
                               "within a 0.5 s sleep; one synchronises")
        cycles *= 4


class Checks:
    """Kernel-vs-plain comparisons, each with its time and bound."""

    def __init__(self, torch, reps):
        self.torch = torch
        self.reps = reps
        self.rows = []
        self.cascade_vs_chain = {}      # path -> cascade and chain ms
        self.segment_reduce_ms = {}     # path -> torch.segment_reduce ms
        self.quiet = False              # log only failed or timed rows

    def run(self, kernel, path, case, kfn, pfn, nbytes, ops=0,
            timed=False, rtol=None, ops_per_s=FP32_OPS_PER_S,
            time_fns=None, take=None):
        """Run kfn (the kernel) and pfn (its plain version) on the same
        inputs and compare: exactly (gathers move values, and the folds
        run in the plain version's order), or for float outputs within
        `rtol` where given (a fold in another order).  A tuple output is
        compared part by part.  Timed with time_fns (kernel, plain) in
        place of kfn, pfn where given.  take: where the kernel only moves
        data, (plain version of one argument, that argument, fill): when
        timed, one torch.take at the index the recipe builds from it
        (testing.take_index), checked equal to the kernel's output first,
        is timed as the row's library_ms; a str says why no call does."""
        torch = self.torch
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        ok, err = True, 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(
                    f"{kernel}/{path} {case}: shape/dtype {tuple(g.shape)} "
                    f"{g.dtype} vs {tuple(w.shape)} {w.dtype}")
            if rtol is not None and g.is_floating_point():
                ok &= bool(torch.allclose(g, w, rtol=rtol, atol=0.0))
            else:
                ok &= bool(torch.equal(g, w))
            err = max(err, max_abs_diff(torch, g, w))
        out = self.record(kernel, path, case, ok, err, got[0], nbytes, ops,
                          timed, rtol, ops_per_s, time_fns or (kfn, pfn))
        if timed and isinstance(take, str):
            self.rows[-1]["library_note"] = take
        elif timed and take is not None:
            self.rows[-1]["library_ms"] = self.take_ms(kernel, path, case,
                                                       got[0], *take)
        return out

    def take_ms(self, kernel, path, case, got, plain, x, fill):
        """Event ms of one torch.take computing the kernel's move, at a
        premade int64 index, after checking it equals the kernel's
        output `got`."""
        from pygraphblas_tpu_torch.testing import take_index, take_source

        torch = self.torch
        idx = take_index(plain, x.shape, x.device)
        src = take_source(x, fill)
        if not torch.equal(torch.take(src, idx).reshape(got.shape), got):
            raise AssertionError(f"{kernel}/{path} {case}: torch.take at "
                                 "the recipe's index differs from the kernel")
        ms = event_ms(torch, lambda: torch.take(src, idx), self.reps)
        log(f"  {kernel:17s} {path:8s} library: torch.take {ms:.4f} ms")
        return ms

    def record(self, kernel, path, case, ok, err, out, nbytes, ops, timed,
               rtol, ops_per_s, time_fns):
        """One comparison's row: its bound, and its times where timed."""
        torch = self.torch
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / ops_per_s * 1e3
        row = dict(kernel=kernel, path=path, case=case,
                   shape=list(out.shape),
                   dtype=str(out.dtype).replace("torch.", ""),
                   max_abs_err=err,
                   tol="exact" if rtol is None else f"rtol {rtol}", ok=ok,
                   timed=timed, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        if timed:
            row["ms"] = event_ms(torch, time_fns[0], self.reps)
            # a plain version is tens of torch ops: queued behind a sleep
            # they fill the launch queue, so they are timed back to back
            row["plain_ms"] = event_ms(torch, time_fns[1], self.reps,
                                       behind_sleep=False)
        self.rows.append(row)
        if not self.quiet or not ok or timed:
            log(f"  {kernel:17s} {path:8s} {case:26s} err={err:.3e} "
                f"{'ok' if ok else 'FAIL'}"
                + (f"  {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
                   f"bound {row['bound_ms']:.4f} ms)" if timed else ""))
        if not ok:
            raise AssertionError(f"{kernel}/{path} {case} disagrees with "
                                 f"its plain version: max err {err}")
        return out


def max_abs_diff(torch, g, w):
    """Largest |g - w| over the places where both are finite."""
    diff = (g.double() - w.double()).abs()
    if g.is_floating_point():
        diff = diff[torch.isfinite(g) & torch.isfinite(w)]
    return float(diff.max()) if diff.numel() else 0.0


def mono_bytes(plan, src_len, fold, mul):
    """dm, q0 or qg, the source read once (at most src_n of it), vals,
    and the output written once."""
    S = plan.S
    out = (S // 8 if fold else S) * 128 * 4
    idx = S * 128 * plan.dm.element_size() + \
        (S // 8 * 4 if plan.wva else S * 4)
    return (idx + min(src_len, plan.src_n) * 4 + out
            + (S * 128 * 4 if mul else 0))


def cascade_vs_chain(torch, reps, cascade, chain):
    """Event ms of the cascade and of the chain of mono_span launches it
    replaces, on the same inputs, timed in the order cascade, chain,
    chain, cascade (best of each)."""
    if not torch.equal(cascade(), chain()):
        raise AssertionError("mono_cascade differs from the mono_span chain")
    ms = {"cascade_ms": [], "chain_ms": []}
    for k in ("cascade_ms", "chain_ms", "chain_ms", "cascade_ms"):
        ms[k].append(event_ms(torch, cascade if k == "cascade_ms" else chain,
                              reps))
    return {k: min(v) for k, v in ms.items()}


def check_xspmv_kernels(torch, ck, plan, x, sem, path, timed=()):
    """Walk one xspmv (core/xspmv.py:xspmv) step by step on the card,
    running each kernel and its plain version on the same inputs.
    Kernels named in `timed` are timed too."""
    from pygraphblas_tpu_torch.core import mono as M, perm as P

    fill = float(sem.add_monoid.identity(np.float32))
    add, mul = sem.pls, sem.mul

    def gather(case, mp, src, **kw):
        name = "mono_span" if mp.wva else "mono_rows"
        kfn = M.mono_span if mp.wva else M.mono_rows
        fold = kw.get("fold")
        take = ("none: the launch folds 8 rows" if fold else
                "none: the launch multiplies" if "mul" in kw else
                (lambda ids: M.mono_gather_plain(mp, ids, 0), src, fill))
        out = ck.run(name, path, case,
                     lambda: kfn(mp, src, fill, **kw),
                     lambda: M.mono_gather_plain(mp, src, fill, **kw),
                     mono_bytes(mp, src.numel(), fold, "mul" in kw),
                     ops=(mp.S // 8 * 128 * 7 if fold else 0)
                     + (mp.S * 128 if "mul" in kw else 0),
                     timed=name in timed, take=take)
        if name == "mono_rows":
            row = ck.rows[-1]
            row["plan"] = dict(S=mp.S, blk=mp.blk, xb=mp.xb, max_w=mp.max_w,
                               dm=str(mp.dm.dtype).replace("torch.", ""),
                               stream=mp.stream)
            log(f"  mono_rows {path} {case} plan: " + " ".join(
                f"{k}={v}" for k, v in row["plan"].items()))
            if "ms" in row and (name, path) in EARLIER_MS:
                earlier(path, name, row["ms"])
        return out

    xc = gather("pre", plan.pre, x).reshape(-1)
    if mul == "SECOND":
        prod = gather("decode", plan.decode, xc)
    else:
        prod = gather("decode", plan.decode, xc, vals=plan.vals_col,
                      mul=mul)
    prod = prod.reshape(-1)

    pp = plan.perm
    D, S, R0, K = pp.D, pp.S, pp.R0, pp.K
    fused8 = K == 128 and D >= 2 and pp.n % 1024 == 0
    xe = torch.cat([prod, torch.full((R0 * K - prod.numel(),), float(fill),
                                     device=prod.device)]).reshape(R0, K)
    if K < 128:
        xe = torch.nn.functional.pad(xe, (0, 128 - K))
    cur = xe.contiguous()
    cell = 4 + 1                     # fp32 value + int8 lane index
    fuse_mid = D >= 3 and K == 128 and S <= 24
    shapes = []
    for lvl in range(D - 1):
        r_l = R0 // 128 ** lvl
        g = cur.shape[0] // r_l
        shapes.append((g, r_l))
        if fuse_mid and lvl == D - 2:
            break
        assert r_l >= 128, "a level shorter than 128 rows"
        x_in, a = cur, pp.a_stages[lvl]
        cur = ck.run("lane_gather_tdesc", path, f"level{lvl} g={g} r_l={r_l}",
                     lambda: P._lane_gather_tdesc(x_in, a, g, r_l),
                     lambda: P._tdesc_plain(x_in, a, g, r_l),
                     x_in.numel() * (cell + 4),
                     timed="lane_gather_tdesc" in timed,
                     take=(lambda ids: P._tdesc_plain(ids, a, g, r_l), x_in,
                           0))
    x_in = cur
    if fuse_mid:
        g, r_l = shapes[-1]
        args = (pp.a_stages[D - 2], pp.a_stages[D - 1], pp.ssel,
                pp.c_stages[D - 1], pp.c_stages[D - 2], g, S)
        cur = ck.run("inner3", path, f"g={g} S={S}",
                     lambda: P._inner3(x_in, *args),
                     lambda: P._inner3_plain(x_in, *args),
                     x_in.numel() * (4 + 5 + 4), timed="inner3" in timed,
                     take=(lambda ids: P._inner3_plain(ids, *args), x_in, 0))
        if ("inner3", path) in EARLIER_MS:
            earlier(path, "inner3", ck.rows[-1]["ms"])
        start = D - 3
    else:
        nsub = cur.shape[0] // S
        x3 = cur.reshape(nsub, S, 128)
        args = (pp.a_stages[D - 1], pp.ssel, pp.c_stages[D - 1])
        nidx = 3 if pp.ssel is not None else 2
        cur = ck.run("mid_pass", path, f"nsub={nsub} S={S}",
                     lambda: P._mid_pass(x3, *args),
                     lambda: P._mid_pass_plain(x3, *args),
                     x3.numel() * (4 + nidx + 4),
                     timed="mid_pass" in timed,
                     take=(lambda ids: P._mid_pass_plain(ids, *args), x3, 0)
                     ).reshape(nsub * S, 128)
        if "mid_pass" in timed and ("mid_pass", path) in EARLIER_MS:
            earlier(path, "mid_pass", ck.rows[-1]["ms"])
        start = D - 2
    for lvl in range(start, -1, -1):
        g, r_l = shapes[lvl]
        x_in, c = cur, pp.c_stages[lvl]
        f8 = add if (lvl == 0 and fused8) else None
        nout = x_in.numel() // 8 if f8 else x_in.numel()
        cur = ck.run("lane_gather_tasc", path,
                     f"level{lvl} g={g} r_l={r_l}" + (" fold8" if f8
                                                      else ""),
                     lambda: P._lane_gather_tasc(x_in, c, g, r_l, f8),
                     lambda: P._tasc_plain(x_in, c, g, r_l, f8),
                     x_in.numel() * cell + nout * 4,
                     ops=nout * 7 if f8 else 0,
                     timed="lane_gather_tasc" in timed,
                     take="none: the launch folds 8 rows" if f8 else
                     (lambda ids: P._tasc_plain(ids, c, g, r_l), x_in, 0))
        if f8 and ("lane_gather_tasc", path) in EARLIER_MS:
            earlier(path, "lane_gather_tasc", ck.rows[-1]["ms"])
    if fused8:
        acc1 = cur.reshape(-1)
    else:
        acc1, _ = pp.apply_fold8(prod, fill, add)    # torch ops
    cur = acc1.reshape(-1)[:plan.m1]
    levels, place = plan.levels, plan.places[0]
    if M._cascade_applies(levels, place, cur.dtype):
        def chain(gather1):
            def run():
                c2 = cur
                for lp in levels:
                    c2 = gather1(lp, c2.reshape(-1), fill,
                                 fold=add).reshape(-1)
                return gather1(place, c2, fill)
            return run
        # the function's bytes: the level-0 source read once, the per-row
        # table and the placed output; its folds: the rows' runs' cells
        # and the fills of every level
        runs = place.cascade
        isz = cur.element_size()
        n_out = place.S * 128
        nbytes = runs.cells * isz + (n_out + 1) * 4 + n_out * isz
        ops = sum(lp.S // 8 * 128 * 7 for lp in levels)
        # the earlier bound, of the plans: every plan's dm and qg, the
        # first source and the placed output
        plan_bytes = sum(p.dm.numel() * p.dm.element_size()
                         + p.qg.numel() * 4 for p in levels + [place])
        plan_bytes += (min(cur.numel(), levels[0].src_n) + n_out) * isz
        cascade = lambda: M.mono_cascade(levels, place, cur, fill, add)
        out = ck.run("mono_cascade", path, f"{len(levels)} levels + place",
                     cascade, chain(M.mono_gather_plain), nbytes, ops=ops,
                     timed="mono_cascade" in timed)
        row = ck.rows[-1]
        row["plan_bound_ms"] = plan_bytes / HBM_BYTES_PER_S * 1e3
        log(f"  mono_cascade bound {row['bound_ms']:.4f} ms (source "
            f"{runs.cells} cells, table and output {n_out} rows); the "
            f"plans' bytes {row['plan_bound_ms']:.4f} ms")
        if "ms" in row:
            if ("mono_cascade", path) in EARLIER_MS:
                earlier(path, "mono_cascade", row["ms"])
            # the library call of the same function, in another order
            red = {"PLUS": "sum", "MIN": "min", "MAX": "max"}[add]
            offs = runs.start.long()
            data = cur[:runs.cells]
            ms = event_ms(torch, lambda: torch.segment_reduce(
                data, red, offsets=offs), ck.reps, behind_sleep=False)
            ck.segment_reduce_ms[path] = ms
            log(f"  library: torch.segment_reduce ({red}) {ms:.4f} ms")
        ck.cascade_vs_chain[path] = cascade_vs_chain(
            torch, ck.reps, cascade, chain(M.mono_span))
        return out
    for i, lp in enumerate(levels):
        cur = gather(f"level{i + 1} fold", lp, cur.reshape(-1),
                     fold=add).reshape(-1)
    return gather("place", place, cur)


class PathRunner:
    """Drives the paths: counts launches (and xspmv calls) over each."""

    def __init__(self, torch, card):
        from pygraphblas_tpu_torch import _kernels
        from pygraphblas_tpu_torch.core import xspmv as xs

        self.torch, self.card, self.K = torch, card, _kernels
        self.calls = 0
        self.counts = {}
        self.results = {}
        orig = xs.xspmv

        def counted(*a, **kw):
            self.calls += 1
            return orig(*a, **kw)

        xs.xspmv = counted       # fused.py calls xs.xspmv
        # every masked_spgemm call (algorithms.py calls SG.masked_spgemm):
        # the launches its arguments ask for, and its result
        from pygraphblas_tpu_torch.core import spgemm as SG

        self.design = {}
        self.last_spgemm = None
        orig_sg = SG.masked_spgemm

        def counted_sg(*a, **kw):
            kernel, unit = self.unit
            if kernel is not None:      # inside drive_spgemm
                self.design[kernel] = (self.design.get(kernel, 0)
                                       + design_launches(a, unit))
            self.last_spgemm = orig_sg(*a, **kw)
            return self.last_spgemm

        SG.masked_spgemm = counted_sg
        self.unit = (None, None)

    def drive(self, path, run, per_xspmv):
        """Run `run()` with the counters at 0; check every kernel of the
        path ran exactly `per_xspmv` times per xspmv call."""
        torch, K = self.torch, self.K
        torch.cuda.synchronize()
        K.reset_launches()
        self.calls = 0
        out = run()
        torch.cuda.synchronize()
        counts, calls = dict(K.launches), self.calls
        want = {k: v * calls for k, v in per_xspmv.items()}
        log(f"  {path}: {calls} xspmv calls; launches "
            + ", ".join(f"{k} {c}" for k, c in counts.items() if c))
        for k in KERNELS:
            if counts[k] != want.get(k, 0):
                raise AssertionError(
                    f"{path}: kernel {k} launched {counts[k]} times in "
                    f"{calls} xspmv calls, expected {want.get(k, 0)}")
            if per_xspmv.get(k) and counts[k] == 0:
                raise AssertionError(f"{path}: kernel {k} never ran")
        self.counts[path] = dict(counts=counts, xspmv_calls=calls)
        return out

    def drive_spgemm(self, path, run):
        """Run `run()` with the counters at 0; check that the path's
        kernel (EXPECTED_SPGEMM) ran exactly as often as the arguments of
        its masked_spgemm calls ask for, and no other kernel ran."""
        from pygraphblas_tpu_torch import algorithms as ALG
        from pygraphblas_tpu_torch.core import spgemm as SG

        torch, K = self.torch, self.K
        torch.cuda.synchronize()
        K.reset_launches()
        SG.reset_stats()
        ALG.seconds.clear()
        self.unit = EXPECTED_SPGEMM[path]
        self.design = {}
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            self.unit = (None, None)
        counts, want = dict(K.launches), self.design
        log(f"  {path}: {SG.stats['calls']} masked_spgemm calls; launches "
            + ", ".join(f"{k} {c}" for k, c in counts.items() if c))
        for k in KERNELS:
            if counts[k] != want.get(k, 0):
                raise AssertionError(
                    f"{path}: kernel {k} launched {counts[k]} times, the "
                    f"calls' buckets ask for {want.get(k, 0)}")
        kernel = EXPECTED_SPGEMM[path][0]
        if counts[kernel] == 0:
            raise AssertionError(f"{path}: kernel {kernel} never ran")
        self.counts[path] = dict(counts=counts,
                                 spgemm_calls=SG.stats["calls"],
                                 host_s={**ALG.seconds,
                                         **SG.stats["seconds"]})
        return out


    def drive_generic(self, path, run):
        """Run `run()` (masked_spgemm calls the JAX package's rule sends
        to its generic intersect) with the counters at 0; check that no
        kernel ran."""
        from pygraphblas_tpu_torch.core import spgemm as SG

        torch, K = self.torch, self.K
        torch.cuda.synchronize()
        K.reset_launches()
        SG.reset_stats()
        out = run()
        torch.cuda.synchronize()
        counts = dict(K.launches)
        log(f"  {path}: {SG.stats['calls']} masked_spgemm calls, no kernel "
            "(the generic intersect)")
        if any(counts.values()):
            raise AssertionError(f"{path}: kernels launched {counts}, the "
                                 "JAX package's rule takes none")
        self.counts[path] = dict(counts=counts,
                                 spgemm_calls=SG.stats["calls"],
                                 host_s=dict(SG.stats["seconds"]))
        return out

    def drive_esc(self, path, run, dense_ok=False):
        """Run `run()` with the counters at 0; check that every ESC call
        (esc.stats["calls"]: the calls that reached the device) launched
        segfold 4 times and esc_gather once, that no other kernel ran,
        and (unless `dense_ok`) that the dense tier's matmul was not
        used."""
        from pygraphblas_tpu_torch.core import dense as DN, esc as E

        torch, K = self.torch, self.K
        torch.cuda.synchronize()
        K.reset_launches()
        E.reset_stats()
        orig, mxm_calls = DN.mxm, []

        def counted(*a, **kw):
            mxm_calls.append(1)
            return orig(*a, **kw)

        DN.mxm = counted
        try:
            out = run()
            torch.cuda.synchronize()
        finally:
            DN.mxm = orig
        counts, calls = dict(K.launches), E.stats["calls"]
        log(f"  {path}: {calls} ESC calls, {len(mxm_calls)} dense matmuls; "
            "launches " + ", ".join(f"{k} {c}" for k, c in counts.items()
                                    if c))
        want = {k: v * calls for k, v in EXPECTED_ESC[path].items()}
        if calls == 0 or (mxm_calls and not dense_ok):
            raise AssertionError(f"{path}: the call did not take ESC")
        for k in KERNELS:
            if counts[k] != want.get(k, 0):
                raise AssertionError(
                    f"{path}: kernel {k} launched {counts[k]} times in "
                    f"{calls} ESC calls, expected {want.get(k, 0)}")
        self.counts[path] = dict(counts=counts, esc_calls=calls,
                                 dense_matmuls=len(mxm_calls),
                                 host_s=dict(E.stats["seconds"]))
        return out


def design_launches(args, unit):
    """The launches one masked_spgemm call on the card asks for, from its
    arguments alone: its light mask edges (|A row| + |B^T row| <= 32768)
    fall in pow2 width buckets from 128 up; one launch a bucket, or one
    a chunk of (1 << 24) // W edges of each bucket."""
    a_rows, _, _, bt_rows, _, _, m_rows, m_cols = args[:8]
    n = int(max(a_rows.max(), bt_rows.max(), m_rows.max(), m_cols.max())) + 1
    total = (np.bincount(a_rows, minlength=n)[m_rows]
             + np.bincount(bt_rows, minlength=n)[m_cols])
    total = total[total <= 32768]
    w = np.maximum(128, 1 << np.ceil(np.log2(np.maximum(total, 1)))
                   .astype(np.int64))
    widths, sizes = np.unique(w, return_counts=True)
    if unit == "bucket":
        return len(widths)
    return int(sum(-(-c // ((1 << 24) // wi)) for wi, c in zip(widths, sizes)))


def cascade_ab(torch, run):
    """Wall seconds of run() through xspmv's cascade and through the
    per-level chain (the cascade call made to return None, as it does
    for a plan it cannot take), in the order cascade, chain, chain,
    cascade; best of each and every run."""
    from pygraphblas_tpu_torch.core import xspmv as xs

    orig = xs.mono_cascade
    runs = {"cascade_s": [], "chain_s": []}
    try:
        for k in ("cascade_s", "chain_s", "chain_s", "cascade_s"):
            xs.mono_cascade = orig if k == "cascade_s" else \
                (lambda *a, **kw: None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            runs[k].append(time.perf_counter() - t0)
    finally:
        xs.mono_cascade = orig
    return dict({k: min(v) for k, v in runs.items()}, runs=runs)


def graph(scale, sym=False):
    from pygraphblas_tpu_torch.generators import rmat_edges

    rows, cols, n = rmat_edges(scale, 16)
    return symmetrise(rows, cols, n) if sym else (rows, cols, n)


def symmetrise(rows, cols, n):
    """Both directions of every edge, no self-loops, no duplicates, in
    (row, col) order (bench.py:285-299)."""
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    keep = r != c
    key = np.unique(r[keep] * n + c[keep])
    return key // n, key % n, n


def plan_for(A, transpose, tag):
    """The xspmv plan on the card, with its build seconds and, where it
    has fold levels, the host seconds of the cascade's row table (the
    step of mono.fold_plans, timed again on the plan's own runs)."""
    from pygraphblas_tpu_torch.core import mono as M

    t0 = time.perf_counter()
    plan = A._xspmv_plan(transpose, np.float32, device="cuda")
    build_s = time.perf_counter() - t0
    pp = plan.perm
    table = ""
    runs = plan.places[0].cascade
    if runs is not None:
        n = np.diff(runs.start.cpu().numpy())
        present = np.flatnonzero(n)
        t1 = time.perf_counter()
        M.cascade_table(n[present], present, len(n), runs.levels)
        table = f", cascade table {time.perf_counter() - t1:.4f} s"
    log(f"  {tag} plan {build_s:.1f} s{table}: n_perm="
        f"{plan.n_perm} D={pp.D} S={pp.S} R0={pp.R0} K={pp.K} "
        f"levels={len(plan.levels)}")
    for name, mp in ([("pre", plan.pre), ("decode", plan.decode)]
                     + [(f"level{i + 1}", lp)
                        for i, lp in enumerate(plan.levels)]
                     + [("place", plan.places[0])]):
        log(f"    {name:8s} S={mp.S} src_n={mp.src_n} wva={mp.wva} "
            f"blk={mp.blk} xb={mp.xb} max_w={mp.max_w} "
            f"dm={str(mp.dm.dtype).replace('torch.', '')} "
            f"stream={mp.stream} ok={mp.ok}")
    return plan


def profile_run(torch, run, tag, attempts=3):
    """One run() under torch.profiler: device ms by kernel over the run,
    the device ms of everything else (torch ops), the wall ms, and each
    kernel's (events in the trace, launches counted in the run).  A trace
    with no device event at all (seen now and then on the card: CUPTI
    delivered nothing) is taken again, up to `attempts` runs; a trace
    that holds fewer events of a kernel than the run launched is taken
    once more, and where it still does, that kernel's time is incomplete
    (see path_ms)."""
    from torch.profiler import profile, ProfilerActivity

    from pygraphblas_tpu_torch import _kernels as K

    cuda = torch.autograd.DeviceType.CUDA
    retaken = False
    for attempt in range(attempts):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = dict(K.launches)
        events = prof.key_averages()
        per_kernel = dict.fromkeys(KERNELS, 0.0)
        counts = dict.fromkeys(KERNELS, 0)
        other, any_device = 0.0, False
        for e in events:
            if e.device_type != cuda:
                continue
            any_device = True
            us = getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)
            name = next((v for k, v in _SYMBOLS.items() if k in e.key), None)
            if name:
                per_kernel[name] += us / 1e3
                counts[name] += e.count
            else:
                other += us / 1e3
        seen = {k: (counts[k], launched[k]) for k in KERNELS
                if counts[k] or launched[k]}
        if not any_device:
            log(f"  profile {tag}: no device event in the trace "
                f"(attempt {attempt + 1} of {attempts})")
            continue
        short = sorted(k for k, (ev, n) in seen.items() if ev != n)
        if not short or retaken:
            break
        log(f"  profile {tag}: events of {short} short of their launches "
            f"{ {k: seen[k] for k in short} }: taken again")
        retaken = True
    table = events.table(sort_by="cuda_time_total", row_limit=25)
    with open(os.path.join(OUT_DIR, f"chip_smoke_profile_{tag}.txt"),
              "w") as f:
        f.write(table)
    return per_kernel, other, wall * 1e3, seen


def path_ms(ms, seen, k, per=1):
    """A kernel's in-path ms (per `per` calls), or "incomplete" where the
    trace held fewer of its events than the run launched."""
    ev, n = seen.get(k, (0, 0))
    if ev != n:
        return f"incomplete: {ev} of {n} events"
    return ms / per


def profile_path(torch, drv, run, tag):
    """Device time by kernel per xspmv over one run of a path (the
    xspmv calls of the trace kept, where one is taken again)."""
    def counted():
        drv.calls = 0
        run()

    per_kernel, other, wall, seen = profile_run(torch, counted, tag)
    n_xspmv = max(drv.calls, 1)
    dev_ms = sum(per_kernel.values()) + other
    log(f"  profile {tag} ({n_xspmv} xspmv): device {dev_ms:.3f} ms of "
        f"{wall:.3f} ms wall under the profiler; per xspmv (events / "
        "launches):")
    out = {}
    for k, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        if k in seen:
            out[k] = path_ms(ms, seen, k, n_xspmv)
            log(f"    {k:18s} {ms / n_xspmv:.4f} ms ({seen[k][0]} / "
                f"{seen[k][1]})" + ("" if isinstance(out[k], float)
                                    else " incomplete"))
    log(f"    {'other (torch ops)':18s} {other / n_xspmv:.4f} ms")
    return out


def profile_spgemm(torch, run, tag, runs=1):
    """Device time by kernel per run of a masked-SpGEMM path (`runs`
    back-to-back runs traced), and the device busy share (device time
    over wall time; a lower bound where a kernel's trace is
    incomplete)."""
    per_kernel, other, wall, seen = profile_run(
        torch, lambda: [run() for _ in range(runs)], tag)
    other, wall = other / runs, wall / runs
    dev_ms = sum(per_kernel.values()) / runs + other
    busy = dev_ms / wall if dev_ms else None     # None: not measured
    times = {k: path_ms(per_kernel[k], seen, k, runs) for k in seen}
    complete = all(isinstance(v, float) for v in times.values())
    log(f"  profile {tag}: device {dev_ms:.3f} ms of {wall:.3f} ms wall "
        f"under the profiler (busy share {busy}"
        + ("" if complete else ", a lower bound: a trace is incomplete")
        + "): " + ", ".join(
            f"{k} {per_kernel[k] / runs:.4f} ms ({seen[k][0]} / "
            f"{seen[k][1]} events)" + ("" if isinstance(times[k], float)
                                       else " incomplete")
            for k in seen) + f", other (torch ops) {other:.4f} ms")
    return dict(per_kernel=times, events=seen, other_ms=other,
                device_ms=dev_ms, wall_ms=wall, busy=busy,
                complete=complete)


def check_small_cases(torch, ck):
    """MIN/MAX folds, muls and int32 at small sizes (not timed)."""
    from pygraphblas_tpu_torch.core import mono as M, perm as P
    from pygraphblas_tpu_torch.core.xspmv import XSpmvPlan
    from pygraphblas_tpu_torch.testing import cascade_runs_case

    rng = np.random.RandomState(2)
    src_n = 9000
    idx = np.sort(rng.randint(0, src_n, 64 * 128))
    idx[::11] = -1
    idx = np.concatenate([np.sort(idx[idx >= 0]),
                          np.full((idx < 0).sum(), -1)])
    span = M.MonoPlan.build(idx, src_n).to("cuda")
    assert span.wva > 0
    saved = M._SPAN_MAX_WVA
    M._SPAN_MAX_WVA = 0
    try:
        rows16 = M.MonoPlan.build(idx, src_n).to("cuda")
        big = np.sort(rng.randint(0, 2_500_000, 64 * 128))
        rows32 = M.MonoPlan.build(big, 2_500_000).to("cuda")
        stream = M.MonoPlan.build(np.sort(rng.randint(0, 1_500_000,
                                                      3 * 64 * 128)),
                                  3_000_000).to("cuda")
    finally:
        M._SPAN_MAX_WVA = saved
    assert rows16.wva == 0 and rows32.dm.dtype == torch.int32
    assert stream.stream and stream.ok
    inf = np.float32(np.inf)
    imax, imin = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    for tag, mp, n in (("span", span, src_n), ("rows16", rows16, src_n),
                       ("rows32", rows32, 2_500_000),
                       ("stream", stream, 3_000_000)):
        kernel = "mono_span" if mp.wva else "mono_rows"
        kfn = M.mono_span if mp.wva else M.mono_rows
        srcf = torch.from_numpy(rng.rand(n).astype(np.float32)).cuda()
        srci = torch.from_numpy(rng.randint(-1000, 1000, n)
                                .astype(np.int32)).cuda()
        valsf = torch.from_numpy(rng.rand(mp.S * 128)
                                 .astype(np.float32)).cuda()
        valsi = torch.from_numpy(rng.randint(-9, 9, mp.S * 128)
                                 .astype(np.int32)).cuda()
        cases = [
            ("fp32 PLUS fold", srcf, 0.0, dict(fold="PLUS")),
            ("fp32 MIN fold", srcf, inf, dict(fold="MIN")),
            ("fp32 MAX fold", srcf, -inf, dict(fold="MAX")),
            ("fp32 TIMES mul", srcf, 0.0, dict(vals=valsf, mul="TIMES")),
            ("fp32 PLUS mul", srcf, inf, dict(vals=valsf, mul="PLUS")),
            ("int32 MIN fold", srci, imax, dict(fold="MIN")),
            ("int32 MAX fold", srci, imin, dict(fold="MAX")),
            ("int32 PLUS fold", srci, 0, dict(fold="PLUS")),
            ("int32 TIMES mul", srci, 0, dict(vals=valsi, mul="TIMES")),
        ]
        for name, src, fill, kw in cases:
            ck.run(kernel, "small", f"{tag} {name}",
                   lambda: kfn(mp, src, fill, **kw),
                   lambda: M.mono_gather_plain(mp, src, fill, **kw), 0)

    # the cascade: PLUS, MIN and MAX folds, float32 and int32
    n, nnz = 3000, 30000
    rr = np.concatenate([rng.randint(0, 50, nnz // 2),
                         rng.randint(0, n, nnz - nnz // 2)])
    key = np.unique(rr * n + rng.randint(0, n, nnz))
    cp = XSpmvPlan._build(key // n, key % n, np.ones(len(key)), n, n,
                          np.dtype(np.float32)).to("cuda")
    assert len(cp.levels) >= 2
    for dt, folds in ((torch.float32, (("PLUS", 0.0), ("MIN", inf),
                                       ("MAX", -inf))),
                      (torch.int32, (("PLUS", 0), ("MIN", imax),
                                     ("MAX", imin)))):
        cur = torch.from_numpy(rng.randint(-999, 999, cp.m1)).to("cuda", dt)
        for fold, fill in folds:
            def chain():
                c2 = cur
                for lp in cp.levels:
                    c2 = M.mono_gather_plain(lp, c2.reshape(-1), fill,
                                             fold=fold).reshape(-1)
                return M.mono_gather_plain(cp.places[0], c2, fill)
            ck.run("mono_cascade", "small", f"{dt} {fold}",
                   lambda: M.mono_cascade(cp.levels, cp.places[0], cur, fill,
                                          fold), chain, 0)
    # runs of every length class of the cascade kernel (1 .. 5000 cells)
    nrows, present, counts = cascade_runs_case()
    levels, place = M.fold_plans(counts, nrows, present)
    levels = [lp.to("cuda") for lp in levels]
    place = place.to("cuda")
    m = int(counts.sum())
    for dt, folds in ((torch.float32, (("PLUS", 0.0), ("MIN", inf),
                                       ("MAX", -inf), ("PLUS", 0.25))),
                      (torch.int32, (("PLUS", 0), ("MIN", imax),
                                     ("MAX", imin), ("PLUS", 3)))):
        for fold, fill in folds:
            if dt == torch.int32:
                v = rng.randint(imin, imax, m, dtype=np.int64).astype(
                    np.int32)
            else:
                v = rng.randn(m).astype(np.float32)
                if fold == "PLUS":
                    v[::5] = -0.0
            cur = torch.from_numpy(v).cuda()

            def chain():
                c2 = cur
                for lp in levels:
                    c2 = M.mono_gather_plain(lp, c2.reshape(-1), fill,
                                             fold=fold).reshape(-1)
                return M.mono_gather_plain(place, c2, fill)
            ck.run("mono_cascade", "small", f"runs 1..5000 {dt} {fold} "
                   f"fill={fill}",
                   lambda: M.mono_cascade(levels, place, cur, fill, fold),
                   chain, 0)

    g, S = 2, 3
    r_l = S * 128
    x = torch.from_numpy(rng.randint(-99, 99, (g * r_l, 128))
                         .astype(np.int32)).cuda()
    xf = torch.from_numpy(rng.rand(g * r_l, 128).astype(np.float32)).cuda()
    ix = [torch.from_numpy(rng.randint(0, 128, (g * r_l, 128))
                           .astype(np.int8)).cuda() for _ in range(4)]
    ssel = torch.from_numpy(rng.randint(0, S, (g * 128, S, 128))
                            .astype(np.int8)).cuda()
    ck.run("lane_gather_tdesc", "small", "int32 g=2 r_l=384",
           lambda: P._lane_gather_tdesc(x, ix[0], g, r_l),
           lambda: P._tdesc_plain(x, ix[0], g, r_l), 0)
    # the banded ascend: one tile, several groups, several tiles a group;
    # rows 0..7 of each tile's idx hold values equal mod 32
    for g2, rb in ((1, 1), (3, 1), (2, 3)):
        n2 = g2 * rb * 128
        idx = rng.randint(0, 128, (g2 * rb, 128, 128)).astype(np.int8)
        idx[:, :8] = 5 + 32 * rng.randint(0, 4, (g2 * rb, 8, 128))
        idx = torch.from_numpy(idx.reshape(n2, 128)).cuda()
        for xx in (torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1,
                                                (n2, 128), dtype=np.int64)
                                    .astype(np.int32)).cuda(),
                   torch.randn((n2, 128), device="cuda")):
            for fold in (None, "PLUS", "MIN", "MAX", "TIMES"):
                ck.run("lane_gather_tasc", "small",
                       f"{xx.dtype} g={g2} rb={rb} fold={fold}",
                       lambda: P._lane_gather_tasc(xx, idx, g2, rb * 128,
                                                   fold),
                       lambda: P._tasc_plain(xx, idx, g2, rb * 128, fold), 0)
    # inner3 at S = 1 and 24 (g = 128, pr20's and pr21's group count)
    # beside S = 3, 9 and 18, in both dtypes, random index slabs
    for S3 in (1, 3, 9, 18, 24):
        g3 = 128 if S3 in (1, 24) else 8
        n3 = g3 * S3 * 128
        lanes = [torch.from_numpy(rng.randint(0, 128, (n3, 128))
                                  .astype(np.int8)).cuda() for _ in range(4)]
        sel = (torch.from_numpy(rng.randint(0, S3, (g3 * 128, S3, 128))
                                .astype(np.int8)).cuda() if S3 > 1 else None)
        args = (lanes[0], lanes[1], sel, lanes[2], lanes[3], g3, S3)
        for xx in (torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1,
                                                (n3, 128), dtype=np.int64)
                                    .astype(np.int32)).cuda(),
                   torch.rand((n3, 128), device="cuda")):
            ck.run("inner3", "small", f"{xx.dtype} g={g3} S={S3}",
                   lambda: P._inner3(xx, *args),
                   lambda: P._inner3_plain(xx, *args), 0)
        del lanes, sel, args, xx
    for xx in (x, xf):
        ck.run("lane_gather", "small", f"{xx.dtype} (768, 128)",
               lambda: P._lane_gather(xx, ix[2]),
               lambda: P._lane_gather_plain(xx, ix[2]), 0)
    for S in (1, 3, 124):
        nsub = 5
        x3 = torch.from_numpy(rng.randint(-99, 99, (nsub, S, 128))
                              .astype(np.int32)).cuda()
        a, c = (torch.from_numpy(rng.randint(0, 128, (nsub * S, 128))
                                 .astype(np.int8)).cuda() for _ in range(2))
        ss = (torch.from_numpy(rng.randint(0, S, (nsub, S, 128))
                               .astype(np.int8)).cuda() if S > 1 else None)
        ck.run("mid_pass", "small", f"int32 nsub={nsub} S={S}",
               lambda: P._mid_pass(x3, a, ss, c),
               lambda: P._mid_pass_plain(x3, a, ss, c), 0)


def check_repairs(torch):
    """The port's two card-only faults, repaired: a MonoPlan with ok ==
    False (a streamed window span over _MAX_XB rows) and int64 and
    float64 values into every gather and permutation wrapper give their
    plain version's answer on the card, with no launch counted.  Returns
    the checks (name, ok)."""
    from pygraphblas_tpu_torch import _kernels
    from pygraphblas_tpu_torch.core import mono as M, perm as P

    rng = np.random.RandomState(13)
    rows = []

    def check(name, kfn, pfn):
        _kernels.reset_launches()
        got = kfn()
        torch.cuda.synchronize()
        launched = sum(_kernels.launches.values())
        ok = launched == 0 and bool(torch.equal(got, pfn()))
        rows.append(dict(check=name, ok=ok, launches=launched))
        log(f"  repair {name:34s} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"repair {name}: {launched} launches or "
                                 "a value differs from the plain version")

    bad = M.MonoPlan.build(np.sort(rng.randint(0, 4_000_000, 64 * 128)),
                           4_000_000).to("cuda")
    assert bad.stream and not bad.ok
    src = torch.from_numpy(rng.rand(4_000_000).astype(np.float32)).cuda()
    for kw in ({}, {"fold": "PLUS"}):
        check(f"ok == False {kw}",
              lambda: M.mono_gather(bad, src, 0.0, **kw),
              lambda: M.mono_gather_plain(bad, src, 0.0, **kw))
    idx = np.sort(rng.randint(0, 9000, 64 * 128))
    span = M.MonoPlan.build(idx, 9000).to("cuda")
    saved = M._SPAN_MAX_WVA
    M._SPAN_MAX_WVA = 0
    try:
        per_row = M.MonoPlan.build(idx, 9000).to("cuda")
    finally:
        M._SPAN_MAX_WVA = saved
    g, S = 2, 3
    r_l = S * 128
    for dt in (torch.int64, torch.float64):
        def vals(*shape):
            return torch.from_numpy(rng.randint(-2 ** 40, 2 ** 40, shape)
                                    ).to("cuda", dt)

        def lanes():
            return torch.from_numpy(rng.randint(0, 128, (g * r_l, 128))
                                    .astype(np.int8)).cuda()
        s9, x = vals(9000), vals(g * r_l, 128)
        ix = [lanes() for _ in range(4)]
        ssel = torch.from_numpy(rng.randint(0, S, (g * 128, S, 128))
                                .astype(np.int8)).cuda()
        x3 = x.reshape(g * 128, S, 128)
        inner = (ix[0], ix[1], ssel, ix[2], ix[3], g, S)
        for name, kfn, pfn in (
                ("mono_gather", lambda: M.mono_gather(span, s9, 0,
                                                      fold="PLUS"),
                 lambda: M.mono_gather_plain(span, s9, 0, fold="PLUS")),
                ("mono_span", lambda: M.mono_span(span, s9, 0),
                 lambda: M.mono_gather_plain(span, s9, 0)),
                ("mono_rows", lambda: M.mono_rows(per_row, s9, 0,
                                                  fold="MIN"),
                 lambda: M.mono_gather_plain(per_row, s9, 0, fold="MIN")),
                ("lane_gather", lambda: P._lane_gather(x, ix[0]),
                 lambda: P._lane_gather_plain(x, ix[0])),
                ("lane_gather_tdesc",
                 lambda: P._lane_gather_tdesc(x, ix[0], g, r_l),
                 lambda: P._tdesc_plain(x, ix[0], g, r_l)),
                ("lane_gather_tasc fold8",
                 lambda: P._lane_gather_tasc(x, ix[1], g, r_l, "PLUS"),
                 lambda: P._tasc_plain(x, ix[1], g, r_l, "PLUS")),
                ("inner3", lambda: P._inner3(x, *inner),
                 lambda: P._inner3_plain(x, *inner)),
                ("mid_pass", lambda: P._mid_pass(x3, ix[2], ssel, ix[3]),
                 lambda: P._mid_pass_plain(x3, ix[2], ssel, ix[3]))):
            check(f"{name} {str(dt)[6:]}", kfn, pfn)
    rows += check_unsigned_selects()
    return rows


# UINT16/32/64 values past the sign bit of their signed bit view
UNSIGNED_BIG = {"UINT16": 40000, "UINT32": 3000000000,
                "UINT64": 2**63 + 2048}

# gdnn_coo's images: the largest power of two for which each layer's
# product stays under ESC's caps (F_pad <= 2^27, core/esc.py) is 4096,
# but at 4096 the path took 438 s of host-bound work on the card (ESC's
# host relabel and plan 1.26 s a call: PERF.md), so it runs at 1024
DNN_COO_IMAGES = 1024
# and its depth: ESC's host relabel runs over all of the whole-net
# matrix's rows, so hyperdnn's seconds grow with the square of the
# layers (156 s at 120 layers on an H100 80GB HBM3 at 700 W, in a whole
# run of 1017.7 s); 60 layers keep the whole run well inside its 1200 s
DNN_COO_LAYERS = 60


def check_unsigned_selects():
    """Queue C fault 1, repaired: UINT16/32/64 value selects and scalar
    comparisons on the card, Matrix and Vector, bitmap and COO tiers
    (bitmap_max_cells = vector_max_cells = 1), read the values as
    unsigned: each equal to the JAX package's answer, written out; a
    user predicate (x > t, x >= t) too, at UINT64 through Unsigned64.
    Returns the checks (name, ok)."""
    from pygraphblas_tpu_torch import Matrix, Vector, options_set, types

    rows = []
    for tier, cells in (("bitmap", None), ("coo", 1)):
        if cells:
            options_set(bitmap_max_cells=cells, vector_max_cells=cells)
        try:
            for tname, big in UNSIGNED_BIG.items():
                t = getattr(types, tname)
                A = Matrix.from_lists([0, 1, 2], [0, 1, 2], [big, 1, 0],
                                      typ=t, device="cuda")
                v = Vector.from_lists([0, 1, 2], [big, 1, 0], typ=t,
                                      device="cuda")
                for name, got, want in (
                        ("A.select('>0')", A.select(">0"),
                         [[0, 1], [0, 1], [big, 1]]),
                        ("A.select('>=', 2)", A.select(">=", 2),
                         [[0], [0], [big]]),
                        ("A > 0", A > 0, [[0, 1], [0, 1], [True, True]]),
                        ("v.select('>0')", v.select(">0"),
                         [[0, 1], [big, 1]]),
                        ("v.select('>=', 2)", v.select(">=", 2),
                         [[0], [big]]),
                        ("v > 0", v > 0, [[0, 1], [True, True]]),
                        ("A.select(x > t, 8)",
                         A.select(lambda i, j, x, th: x > th, 8),
                         [[0], [0], [big]]),
                        ("v.select(x >= t, big)",
                         v.select(lambda i, j, x, th: x >= th, big),
                         [[0], [big]])):
                    ok = got.to_lists() == want
                    case = f"{tname} {tier} {name}"
                    rows.append(dict(check=f"unsigned {case}", ok=ok))
                    log(f"  repair unsigned {case:34s} "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"repair unsigned {case}: {got.to_lists()} "
                            f"!= {want}")
        finally:
            options_set(bitmap_max_cells=1 << 26, vector_max_cells=1 << 27)
    return rows


def lane_gather_isolated(torch, ck, rows):
    """_lane_gather at the bfs18 level-0 shape (rows x 128): no path of
    either package reaches it; beside it torch.gather on a premade int64
    index, the library call that computes the same function, and its
    earlier design's time (EARLIER_MS).  Then its redesign's edge cases
    (1 and 7 rows, values with the top bit set), not timed."""
    from pygraphblas_tpu_torch.core import perm as P

    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.rand(rows, 128).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.randint(0, 128, (rows, 128))
                           .astype(np.int8)).cuda()
    ck.run("lane_gather", "isolated", f"({rows}, 128) fp32",
           lambda: P._lane_gather(x, idx),
           lambda: P._lane_gather_plain(x, idx), x.numel() * (4 + 1 + 4),
           timed=True)
    earlier("isolated", "lane_gather", ck.rows[-1]["ms"])
    # the redesign's edges: a row, part of a warp's rows, and values with
    # the top bit set (int32 and negative floats, moved bit for bit)
    for r in (1, 7, rows):
        xi = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, (r, 128),
                                          dtype=np.int64).astype(np.int32)
                              ).cuda()
        ir = idx[:r].contiguous()
        for xx in (xi, xi.view(torch.float32)):
            ck.run("lane_gather", "small", f"({r}, 128) {xx.dtype} top bit",
                   lambda: P._lane_gather(xx, ir).view(torch.int32),
                   lambda: P._lane_gather_plain(xx, ir).view(torch.int32), 0)
    idx64 = idx.long()
    lib_ms = event_ms(torch, lambda: torch.gather(x, 1, idx64), ck.reps)
    log(f"  library: torch.gather (int64 index) {lib_ms:.4f} ms")
    return lib_ms


def degree_lower(rows, cols, n):
    """The strict lower triangle of the degree-relabelled graph as scipy
    CSR, as triangle_count builds it (algorithms.py), made here apart from
    the port."""
    import scipy.sparse as sp

    deg = np.bincount(rows, minlength=n)
    perm = np.argsort(deg, kind="stable")
    rank = np.empty_like(perm)
    rank[perm] = np.arange(n)
    r, c = rank[rows], rank[cols]
    keep = r > c
    L = sp.csr_matrix((np.ones(int(keep.sum())), (r[keep], c[keep])), (n, n))
    L.sort_indices()
    return L


def csr_coo(M):
    """Row-major (rows, cols, vals) of a scipy sparse matrix."""
    M = M.tocsr()
    M.sort_indices()
    return (np.repeat(np.arange(M.shape[0]), np.diff(M.indptr)),
            M.indices.astype(np.int64), M.data)


def masked_square(W, blocks=8):
    """scipy's (W @ W) masked by W's pattern, row block by row block
    (bounded memory): row-major (rows, cols, vals)."""
    parts = []
    step = -(-W.shape[0] // blocks)
    for lo in range(0, W.shape[0], step):
        Wb = W[lo:lo + step]
        mask = Wb.copy()
        mask.data[:] = 1.0
        r, c, v = csr_coo((Wb @ W).multiply(mask))
        parts.append((r + lo, c, v))
    return tuple(np.concatenate(x) for x in zip(*parts))


def pair_count_probes(wa, wb):
    """The operations that bound pair_count: one probe per id of each
    edge's shorter list (the bitmap marks and binary-search steps the
    kernel adds are its own cost, not the function's)."""
    return int(np.minimum(np.asarray(wa, np.int64), wb).sum())


class Buckets:
    """The intersect kernels' inputs for C<M> = M (+.x) M on the card, M
    = L (a CSR matrix; with `vals`, its values as float32 and int32): M's
    columns (A), M^T's (B^T), and per width bucket (the port's own plan,
    spgemm._lookup and _buckets) its edges' (a_st, wa, b_st, wb), with
    sum(wa + wb) (the ids read), the compares that bound kernel 11 (per
    edge the fewer of a linear merge's, wa + wb, and a search of the
    longer list for each id of the shorter, min(wa, wb) *
    ceil(log2(max(wa, wb) + 1))) and the probes that bound kernel 10
    (pair_count_probes)."""

    def __init__(self, torch, L, vals=False):
        from pygraphblas_tpu_torch.core import spgemm as SG

        lr, lc, lv = csr_coo(L)
        tr, tc, tv = csr_coo(L.T)
        a_st, wa, b_st, wb = SG._lookup(lr, lc, tr, tc, lr, lc)
        total = wa + wb
        self.heavy = int((total > SG.WIDTH_CAP).sum())
        lo, hi = np.minimum(wa, wb), np.maximum(wa, wb)
        compares = np.minimum(total, lo * np.ceil(np.log2(hi + 1)).astype(
            np.int64))

        def cuda(x, dt=np.int32):
            return torch.from_numpy(np.ascontiguousarray(x, dt)).cuda()

        self.a, self.b = cuda(lc), cuda(tc)
        self.vals = {dt: (cuda(lv, dt), cuda(tv, dt))
                     for dt in (np.float32, np.int32)} if vals else None
        self.buckets = [
            dict(w=w, n=len(sel), sum=int(total[sel].sum()),
                 compares=int(compares[sel].sum()),
                 probes=pair_count_probes(wa[sel], wb[sel]),
                 meta=[cuda(x[sel]) for x in (a_st, wa, b_st, wb)])
            for w, sel in SG._buckets(total, 128)]
        self.summary = (f"{len(self.buckets)} width buckets "
                        f"{[b['w'] for b in self.buckets]}, sum(wa+wb) "
                        f"{int(total.sum())}, compares "
                        f"{int(compares.sum())}, probes "
                        f"{sum(b['probes'] for b in self.buckets)}, padded "
                        f"cells {sum(b['w'] * b['n'] for b in self.buckets)}"
                        f", heavy {self.heavy}")

    def id_bytes(self, b):
        """The ids a bucket's edges read, at most both arrays once."""
        return 4 * min(b["sum"], self.a.numel() + self.b.numel())


def check_pair_count(ck, bk, path, timed):
    """pair_count against its plain version on every width bucket."""
    from pygraphblas_tpu_torch.core import spgemm as SG

    for b in bk.buckets:
        w, m = b["w"], b["meta"]
        ck.run("pair_count", path, f"W={w} E={b['n']}",
               lambda: SG.pair_count(bk.a, bk.b, *m, w),
               lambda: SG._pair_count_plain(bk.a, bk.b, *m, w),
               bk.id_bytes(b) + 20 * b["n"], ops=b["probes"], timed=timed,
               ops_per_s=INT32_OPS_PER_S)
    if ("pair_count", path) in EARLIER_MS:
        earlier(path, "pair_count", sum(
            c["ms"] for c in ck.rows if c["kernel"] == "pair_count"
            and c["path"] == path and c["timed"]))


def record_pair_count(run):
    """run() with the arguments of each pair_count launch recorded (the
    tensors a masked_spgemm call gives the kernel).  Returns (run's
    result, the calls)."""
    from pygraphblas_tpu_torch.core import spgemm as SG

    calls, orig = [], SG.pair_count

    def rec(*a):
        calls.append(a)
        return orig(*a)

    SG.pair_count = rec
    try:
        return run(), calls
    finally:
        SG.pair_count = orig


def check_recorded_pair_count(ck, path, calls):
    """pair_count against its plain version on every recorded launch
    (every width bucket of every masked_spgemm call of a path)."""
    from pygraphblas_tpu_torch.core import spgemm as SG

    for i, (a, b, ast, wa, bst, wb, w) in enumerate(calls):
        host = [x.cpu().numpy() for x in (ast, wa, bst, wb)]
        ids = int((host[1].astype(np.int64) + host[3]).sum())
        ck.run("pair_count", path, f"launch {i} W={w} E={ast.numel()}",
               lambda: SG.pair_count(a, b, ast, wa, bst, wb, w),
               lambda: SG._pair_count_plain(a, b, ast, wa, bst, wb, w),
               4 * min(ids, a.numel() + b.numel()) + 20 * ast.numel(),
               ops=pair_count_probes(host[1], host[3]),
               ops_per_s=INT32_OPS_PER_S)


def check_pair_count_cases(torch, ck):
    """pair_count against its plain version on the hand-made edge lists
    of PAIR_COUNT_CASES."""
    from pygraphblas_tpu_torch.core import spgemm as SG
    from pygraphblas_tpu_torch.testing import (PAIR_COUNT_CASES,
                                               pair_count_case)

    for kind in PAIR_COUNT_CASES:
        *arrs, w = pair_count_case(kind)
        a, b, ast, wa, bst, wb = (torch.from_numpy(x).cuda() for x in arrs)
        ck.run("pair_count", "cases", f"{kind} W={w} E={ast.numel()}",
               lambda: SG.pair_count(a, b, ast, wa, bst, wb, w),
               lambda: SG._pair_count_plain(a, b, ast, wa, bst, wb, w), 0)


def check_pair_fold_cases(torch, ck):
    """pair_fold against its plain version on the hand-made edge lists of
    testing.pair_fold_case (pair_count's kinds, with values), through
    each of its kernels: FP32 PLUS_TIMES (rtol 1e-5) and MAX_RDIV, INT32
    MIN_PLUS and PLUS_MINUS (exact)."""
    from pygraphblas_tpu_torch.core import spgemm as SG
    from pygraphblas_tpu_torch.testing import PAIR_COUNT_CASES, pair_fold_case

    rule = SG._RUNS_WIDTH, SG._RUNS_EDGES
    try:
        for path, moved in (("search", (1, 1 << 40)), ("runs", (0, 0))):
            # the rule moved so that every case takes this kernel
            SG._RUNS_WIDTH, SG._RUNS_EDGES = moved
            for kind in PAIR_COUNT_CASES:
                for dt, sems in ((np.float32, (("PLUS", "TIMES"),
                                               ("MAX", "RDIV"))),
                                 (np.int32, (("MIN", "PLUS"),
                                             ("PLUS", "MINUS")))):
                    *arrs, w = pair_fold_case(kind, dt)
                    a, av, b, bv, ast, wa, bst, wb = (
                        torch.from_numpy(x).cuda() for x in arrs)
                    for add, mul in sems:
                        ck.run("pair_fold", "cases",
                               f"{path} {kind} W={w} {add}_{mul} "
                               f"{np.dtype(dt).name}",
                               lambda: SG.pair_fold(a, av, b, bv, ast, wa,
                                                    bst, wb, w, mul, add),
                               lambda: SG._pair_fold_plain(
                                   a, av, b, bv, ast, wa, bst, wb, w, mul,
                                   add), 0,
                               rtol=1e-5 if (add, dt) == ("PLUS", np.float32)
                               else None)
    finally:
        SG._RUNS_WIDTH, SG._RUNS_EDGES = rule


def check_mono_rows_cases(torch, ck):
    """mono_rows against its plain version on testing.mono_rows_case's
    plans, on every route: float32 and int32, no fold or a PLUS, MIN or
    MAX fold, with mul or without."""
    from pygraphblas_tpu_torch.core import mono as M
    from pygraphblas_tpu_torch.testing import MONO_ROWS_CASES, mono_rows_case

    rng = np.random.RandomState(4)
    saved = M._SPAN_MAX_WVA
    M._SPAN_MAX_WVA = 0
    try:
        plans = {k: M.MonoPlan.build(*mono_rows_case(k)).to("cuda")
                 for k in MONO_ROWS_CASES}
    finally:
        M._SPAN_MAX_WVA = saved
    for kind, mp in plans.items():
        assert mp.wva == 0 and mp.ok
        for dt in (torch.float32, torch.int32):
            src = torch.from_numpy(rng.randint(-99, 99, mp.src_n)).to(
                "cuda", dt)
            vals = torch.from_numpy(rng.randint(1, 9, mp.S * 128)).to(
                "cuda", dt)
            for kw, fill in (({}, 0), ({"fold": "PLUS"}, 0),
                             ({"fold": "MIN"}, 999), ({"fold": "MAX"}, -99),
                             ({"mul": "TIMES"}, 0),
                             ({"mul": "PLUS", "fold": "MIN"}, 999)):
                if "mul" in kw:
                    kw = dict(kw, vals=vals)
                ck.run("mono_rows", "cases",
                       f"{kind} {str(dt)[6:]} "
                       f"{kw.get('mul', '-')}/{kw.get('fold', '-')}",
                       lambda: M.mono_rows(mp, src, fill, **kw),
                       lambda: M.mono_gather_plain(mp, src, fill, **kw), 0)


def check_fill_keys(torch, ck, bk, path):
    """fill_keys against its plain version on every chunk of every width
    bucket (the launches of the unfused chain), timed over each bucket's
    chunks."""
    from pygraphblas_tpu_torch.core import spgemm as SG

    for b in bk.buckets:
        w, m = b["w"], b["meta"]
        chunks = SG._chunks(b["n"], w)

        def launch(fill, lo, hi):
            return fill(bk.a, bk.b, *[x[lo:hi] for x in m], w)

        ok, err = True, 0.0
        for lo, hi in chunks:
            got = launch(SG.fill_keys, lo, hi)
            want = launch(SG._fill_plain, lo, hi)
            ok &= bool(torch.equal(got, want))
            err = max(err, max_abs_diff(torch, got, want))
            del got, want

        def loop(fill):
            def run():
                for lo, hi in chunks:
                    launch(fill, lo, hi)
            return run

        shape = torch.empty((b["n"], w), dtype=torch.int32, device="meta")
        ck.record("fill_keys", path, f"W={w} E={b['n']} {len(chunks)} chunks",
                  ok, err, shape, 4 * b["n"] * (w + 4) + bk.id_bytes(b), 0,
                  True, None, INT32_OPS_PER_S,
                  (loop(SG.fill_keys), loop(SG._fill_plain)))


def check_pair_fold(ck, bk, path):
    """pair_fold against its plain version on every width bucket: FP32
    PLUS_TIMES (within rtol 1e-5: another fold order; timed) and INT32
    MIN_PLUS (exact)."""
    from pygraphblas_tpu_torch.core import spgemm as SG

    for b in bk.buckets:
        w, m = b["w"], b["meta"]
        for add, mul, dt, rtol in (("PLUS", "TIMES", np.float32, 1e-5),
                                   ("MIN", "PLUS", np.int32, None)):
            av, bv = bk.vals[dt]
            cnt = ck.run("pair_fold", path,
                         f"W={w} E={b['n']} {add}_{mul} {np.dtype(dt).name}",
                         lambda: SG.pair_fold(bk.a, av, bk.b, bv, *m, w, mul,
                                              add),
                         lambda: SG._pair_fold_plain(bk.a, av, bk.b, bv, *m,
                                                     w, mul, add),
                         2 * bk.id_bytes(b) + 24 * b["n"],
                         ops=b["compares"], timed=rtol is not None,
                         rtol=rtol, ops_per_s=INT32_OPS_PER_S)
            # the kernel the rule picks; the matches against the probes
            # (one a shorter-list id)
            ck.rows[-1].update(kernel_path=SG.fold_path(w, b["n"]),
                               matches=int(cnt.sum()), probes=b["probes"])
    rows = [c for c in ck.rows if c["kernel"] == "pair_fold"
            and c["path"] == path and c["timed"]]
    fold_ms = sum(c["ms"] for c in rows)
    if ("pair_fold", path) in EARLIER_MS:
        earlier(path, "pair_fold", fold_ms)
    # the yardstick: pair_count's time for the same intersections without
    # the values (checked against its plain version first; its rows are
    # not pair_count's timed path, so not in the kernels line)
    yard = 0.0
    for b in bk.buckets:
        w, m = b["w"], b["meta"]
        ck.run("pair_count", path + "_yardstick", f"W={w} E={b['n']}",
               lambda: SG.pair_count(bk.a, bk.b, *m, w),
               lambda: SG._pair_count_plain(bk.a, bk.b, *m, w),
               bk.id_bytes(b) + 20 * b["n"], ops=b["probes"],
               ops_per_s=INT32_OPS_PER_S)
        ms = event_ms(ck.torch, lambda: SG.pair_count(bk.a, bk.b, *m, w),
                      ck.reps)
        ck.rows[-1]["yardstick_ms"] = ms
        yard += ms
    log(f"  yardstick: pair_count at {path} {yard:.4f} ms over "
        f"{len(bk.buckets)} buckets; pair_fold {fold_ms:.4f} ms, "
        f"{fold_ms / yard:.2f}x it; per bucket (W: pair_fold, pair_count) "
        + ", ".join(f"{y['case'].split()[0]} {c['ms']:.4f}/"
                    f"{y['yardstick_ms']:.4f}"
                    for c, y in zip(rows, ck.rows[-len(bk.buckets):])))


def with_env(name, value, run):
    """run() with environment variable `name` set to `value`."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return run()
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def host_split(drv, path, calls):
    """Host seconds per call by phase (algorithms.seconds: relabel+build;
    spgemm.stats: csr+lookup and plan (bucket planning), dispatch, pull (which waits
    for the device), assemble."""
    return {k: v / calls for k, v in drv.counts[path]["host_s"].items()}


def tc_path(torch, ck, drv, card, path, rows, cols, n, chain, per_edge):
    """triangle_count on a symmetrised kron graph, warm, best of 3,
    against scipy's count; chain: once more through the unfused chain,
    per-edge counts equal; per_edge: every edge's count equal to scipy's
    (L @ L) .* L.  Before it, the path's kernels against their plain
    versions at every width bucket of its call."""
    from pygraphblas_tpu_torch import algorithms, types
    from pygraphblas_tpu_torch.generators import to_matrix

    t0 = time.perf_counter()
    A = to_matrix(rows, cols, n, types.INT64)
    L = degree_lower(rows, cols, n)
    bk = Buckets(torch, L)
    log(f"{path}: n={n} symmetric edges {len(rows)}, L {L.nnz}; "
        f"{bk.summary} ({time.perf_counter() - t0:.1f} s)")
    check_pair_count(ck, bk, path, timed=True)
    if chain:
        check_fill_keys(torch, ck, bk, path + "_chain")
    del bk
    t1 = time.perf_counter()
    first = algorithms.triangle_count(A)
    t_first = time.perf_counter() - t1
    runs = []

    def best_of_3():
        for _ in range(3):
            t = time.perf_counter()
            got = algorithms.triangle_count(A)
            runs.append(time.perf_counter() - t)
        return got

    ntri = drv.drive_spgemm(path, best_of_3)
    edges = drv.last_spgemm
    t1 = time.perf_counter()
    if per_edge:
        want_edges = masked_square(L)
        want = int(want_edges[2].sum())
        if not (np.array_equal(edges[0], want_edges[0])
                and np.array_equal(edges[1], want_edges[1])
                and np.array_equal(edges[2], want_edges[2].astype(np.int64))):
            raise AssertionError(f"{path}: per-edge counts differ from "
                                 "scipy's (L @ L) .* L")
    else:
        want = int((L @ L).multiply(L).sum())
    t_scipy = time.perf_counter() - t1
    if not ntri == first == want:
        raise AssertionError(f"{path}: {ntri} (first run {first}) "
                             f"triangles, scipy {want}")
    el = min(runs)
    res = dict(triangles=ntri, seconds=el, runs_s=runs, first_s=t_first,
               edges=len(rows), edges_per_s=len(rows) / el,
               host_s_per_call=host_split(drv, path, 3), scipy_s=t_scipy)
    log(f"  {path}: {ntri} triangles = scipy's"
        + (", every edge's count too" if per_edge else "")
        + f"; warm best of 3 {el:.4f} s ({runs}), first {t_first:.4f} s; "
        f"{len(rows) / el:.6e} edges/s; host per call "
        f"{json.dumps(res['host_s_per_call'])}; card {card}")
    if chain:
        t = time.perf_counter()
        nch = with_env("PYGB_PAIR_FUSED", "0", lambda: drv.drive_spgemm(
            path + "_chain", lambda: algorithms.triangle_count(A)))
        res["chain_s"] = time.perf_counter() - t
        same = all(np.array_equal(x, y)
                   for x, y in zip(drv.last_spgemm, edges))
        if nch != want or not same:
            raise AssertionError(f"{path}: the unfused chain gives {nch} "
                                 "triangles or other per-edge counts")
        log(f"  {path} unfused chain (PYGB_PAIR_FUSED=0): {nch} triangles, "
            f"per-edge counts equal the fused run's; {res['chain_s']:.4f} s")
        res["profile_chain"] = with_env(
            "PYGB_PAIR_FUSED", "0", lambda: profile_spgemm(
                torch, lambda: algorithms.triangle_count(A), path + "_chain"))
    res["profile"] = profile_spgemm(
        torch, lambda: algorithms.triangle_count(A), path)
    return res


def scipy_k_truss(rows, cols, n, k):
    """The k-truss fixed point with scipy: supports (S @ S) .* S, prune
    below k - 2, until a pass keeps every edge; row-major (rows, cols,
    supports)."""
    import scipy.sparse as sp

    S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), (n, n))
    while True:
        C = (S @ S).multiply(S).tocsr()
        C.data[C.data < k - 2] = 0
        C.eliminate_zeros()
        if C.nnz == S.nnz:
            return csr_coo(C)
        S = C
        S.data[:] = 1.0


def kt_path(torch, ck, drv, card, path, rows, cols, n, chain, scipy_ref):
    """k_truss(A, 4), warm; scipy_ref: the edge set and supports equal
    scipy's fixed point; chain: once more through the unfused chain, with
    equal edges and supports.  Every support is >= 2.  pair_count is held
    against its plain version on every launch of the first (cold) run:
    every width bucket of every pass."""
    from pygraphblas_tpu_torch import algorithms, types
    from pygraphblas_tpu_torch.generators import to_matrix

    A = to_matrix(rows, cols, n, types.INT64)
    t = time.perf_counter()
    first, calls = record_pair_count(lambda: algorithms.k_truss(A, 4)._coo())
    t_first = time.perf_counter() - t
    log(f"{path}: n={n} symmetric edges {len(rows)}; {len(calls)} "
        "pair_count launches in the first run")
    check_recorded_pair_count(ck, path, calls)
    del calls
    t = time.perf_counter()
    got = drv.drive_spgemm(path, lambda: algorithms.k_truss(A, 4))._coo()
    el = time.perf_counter() - t
    passes = drv.counts[path]["spgemm_calls"]
    if not all(np.array_equal(x, y) for x, y in zip(got, first)):
        raise AssertionError(f"{path}: the warm run differs from the first")
    if len(got[2]) == 0 or got[2].min() < 2:
        raise AssertionError(f"{path}: a support below 2, or no edge kept")
    res = dict(seconds=el, first_s=t_first, passes=passes,
               edges=len(rows), kept=len(got[0]),
               host_s_per_pass=host_split(drv, path, passes))
    log(f"  {path}: k_truss(A, 4) keeps {len(got[0])} of {len(rows)} edges "
        f"in {passes} passes; warm {el:.4f} s, first {t_first:.4f} s; host "
        f"per pass {json.dumps(res['host_s_per_pass'])}; card {card}")
    if scipy_ref:
        t = time.perf_counter()
        want = scipy_k_truss(rows, cols, n, 4)
        res["scipy_s"] = time.perf_counter() - t
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])
                and np.array_equal(got[2], want[2].astype(np.int64))):
            raise AssertionError(f"{path}: differs from scipy's 4-truss")
        log(f"  {path}: edges and supports equal scipy's fixed point")
    if chain:
        t = time.perf_counter()
        gc = with_env("PYGB_PAIR_FUSED", "0", lambda: drv.drive_spgemm(
            path + "_chain", lambda: algorithms.k_truss(A, 4)))._coo()
        res["chain_s"] = time.perf_counter() - t
        if not all(np.array_equal(x, y) for x, y in zip(gc, got)):
            raise AssertionError(f"{path}: the unfused chain's k-truss "
                                 "differs")
        log(f"  {path} unfused chain: equal edges and supports; "
            f"{res['chain_s']:.4f} s")
    res["profile"] = profile_spgemm(
        torch, lambda: algorithms.k_truss(A, 4), path)
    return res


def val_path(torch, ck, drv, card, L):
    """masked_spgemm(W, W^T, mask L) on L with weights 1..4 (seed 7):
    FP32 PLUS_TIMES equal to scipy's (W @ W) .* L exactly (every sum is
    an integer below 2^24), INT32 MIN_PLUS equal to the generic intersect
    on the card (PYGB_VAL_FUSED=0).  Before it, pair_fold against its
    plain version at every width bucket."""
    from pygraphblas_tpu_torch import types
    from pygraphblas_tpu_torch.core import spgemm as SG

    W = L.copy()
    W.data = np.random.RandomState(7).randint(1, 5, W.nnz).astype(np.float64)
    bk = Buckets(torch, W, vals=True)
    log(f"val16: weights 1..4 on L ({W.nnz} entries); {bk.summary}")
    check_pair_fold(ck, bk, "val16")
    del bk
    lr, lc, lv = csr_coo(W)
    tr, tc, tv = csr_coo(W.T)

    def call(sem, dt):
        return SG.masked_spgemm(lr, lc, lv.astype(dt), tr, tc, tv.astype(dt),
                                lr, lc, sem, dt)

    fp32 = (types.FP32.PLUS_TIMES, np.float32)
    i32 = (types.INT32.MIN_PLUS, np.int32)
    call(*fp32)
    call(*i32)                                  # warm
    secs = {}

    def both():
        out = []
        for name, args in (("PLUS_TIMES", fp32), ("MIN_PLUS", i32)):
            t = time.perf_counter()
            out.append(call(*args))
            secs[name] = time.perf_counter() - t
        return out

    got_f, got_i = drv.drive_spgemm("val16", both)
    want = masked_square(W)
    if not (np.array_equal(got_f[0], want[0])
            and np.array_equal(got_f[1], want[1])
            and np.array_equal(got_f[2], want[2].astype(np.float32))):
        raise AssertionError("val16: PLUS_TIMES differs from scipy")
    t = time.perf_counter()
    gen = with_env("PYGB_VAL_FUSED", "0", lambda: call(*i32))
    t_gen = time.perf_counter() - t
    if not all(np.array_equal(x, y) for x, y in zip(got_i, gen)):
        raise AssertionError("val16: MIN_PLUS differs from the generic "
                             "intersect on the card")
    res = dict(seconds=secs, generic_min_plus_s=t_gen, edges=W.nnz,
               present=len(got_f[0]),
               host_s_per_call=host_split(drv, "val16", 2))
    log(f"  val16: PLUS_TIMES equal to scipy's (W @ W) .* L exactly, "
        f"MIN_PLUS equal to the generic intersect on the card "
        f"({t_gen:.4f} s); {len(got_f[0])} present; seconds {secs}; "
        f"card {card}")
    # two calls traced: the traces of one call held no device event in
    # every attempt of two runs
    res["profile"] = profile_spgemm(torch, lambda: call(*fp32), "val16",
                                    runs=2)
    return res


def record_esc(run):
    """run() with the ESC engine's kernel calls recorded: the inputs of
    each segfold (values, flags, add monoid) and of esc_gather, at the
    path's own shapes.  Returns (run's result, scans, gathers)."""
    from pygraphblas_tpu_torch.core import esc as E

    scans, gathers = [], []
    orig_s, orig_g = E.segfold, E.esc_gather

    def seg(v, f, add):
        scans.append((v, f, add))
        return orig_s(v, f, add)

    def gat(*a):
        gathers.append(a)
        return orig_g(*a)

    E.segfold, E.esc_gather = seg, gat
    try:
        out = run()
    finally:
        E.segfold, E.esc_gather = orig_s, orig_g
    if len(scans) != 4 or len(gathers) != 1:
        raise AssertionError(f"the call made {len(scans)} scans and "
                             f"{len(gathers)} gathers, not one ESC call's")
    return out, scans, gathers


# the four scans of one ESC call, in order (esc.py:168-227)
SCAN_NAMES = ("bpos", "ri", "av", "totals")


def check_esc_kernels(torch, ck, path, tag, scans, gathers, live, timed):
    """segfold on each recorded scan, esc_gather at every slot, against
    their plain versions: exact, but a float PLUS scan within rtol 1e-5
    over all slots and exact over the `live` ones (the expansion's; the
    path's values are integers, so there any fold order gives the same
    bits, while the dead slots past them form one long segment whose
    float sum rounds by fold order).  With `timed`, their times, and the
    yardsticks: torch.cumsum at each scan's length (unsegmented: a lower
    yardstick, not the same function), summed; one index_select of B's
    columns and values stacked as int32 pairs at a premade int64 index
    (the same gather).  Returns (cumsum ms, index_select ms)."""
    from pygraphblas_tpu_torch.core import esc as E, scan as SC

    cumsum_ms, lib_ms = 0.0, None
    for name, (v, f, add) in zip(SCAN_NAMES, scans):
        dt = str(v.dtype).replace("torch.", "")
        aname = add if isinstance(add, str) else add.name
        plus = (add if isinstance(add, str) else add.binaryop.op) == "PLUS"
        case = f"{tag}{name} {aname} {dt} M={v.numel()}"
        rtol = 1e-5 if v.is_floating_point() and plus else None
        out = ck.run("segfold", path, case, lambda: SC.segfold(v, f, add),
                     lambda: SC._segfold_plain(v, f, add),
                     v.numel() * (2 * v.element_size() + 1), timed=timed,
                     rtol=rtol)
        if rtol is not None and not torch.equal(
                out[:live], SC._segfold_plain(v, f, add)[:live]):
            raise AssertionError(f"segfold/{path} {case}: the live slots "
                                 "differ from the plain version")
        if timed:
            cumsum_ms += event_ms(
                torch, lambda: torch.cumsum(v, 0, dtype=v.dtype), ck.reps)
    for cols2d, vals2d, qg, dm in gathers:
        S = dm.shape[0]
        ck.run("esc_gather", path,
               f"{tag}S={S} rows_b={cols2d.shape[0]} "
               + str(vals2d.dtype).replace("torch.", ""),
               lambda: E.esc_gather(cols2d, vals2d, qg, dm),
               lambda: E._esc_gather_plain(cols2d, vals2d, qg, dm),
               dm.numel() * 4 + qg.numel() * 4
               + S * 128 * (4 + vals2d.element_size()), timed=timed)
        if timed:
            src = torch.stack([cols2d.reshape(-1),
                               vals2d.reshape(-1).view(torch.int32)], 1)
            flat = (qg.long().repeat_interleave(1024) * 128
                    + dm.reshape(-1).long())
            lib_ms = event_ms(torch, lambda: src.index_select(0, flat),
                              ck.reps)
    if timed:
        earlier(path, "segfold", sum(
            r["ms"] for r in ck.rows if r["kernel"] == "segfold"
            and r["path"] == path and r["timed"]))
        log(f"  yardsticks: torch.cumsum over the four scans' lengths "
            f"{cumsum_ms:.4f} ms (unsegmented); index_select of B's "
            f"(col, value) pairs {lib_ms:.4f} ms")
    return cumsum_ms, lib_ms


def esc_same(got, want):
    return all(np.array_equal(x, y) for x, y in zip(got, want))


def esc14_path(torch, ck, drv, card):
    """C = A @ A, kron-14 ef16 directed, FP32 weights 1..4 (seed 7),
    PLUS_TIMES through gustavson.spgemm ("auto": ESC on the card), warm,
    best of 3; C equal to scipy's exactly (every sum is an integer below
    2^24).  Before it, segfold and esc_gather against their plain
    versions at the call's shapes, timed, and segfold on random float32
    values (PLUS, within rtol 1e-5: another fold order)."""
    import scipy.sparse as sp
    from pygraphblas_tpu_torch import types
    from pygraphblas_tpu_torch.core import gustavson as G, scan as SC

    t0 = time.perf_counter()
    rows, cols, n = graph(14)
    w = np.random.RandomState(7).randint(1, 5, len(rows)).astype(np.float32)
    sem = types.FP32.PLUS_TIMES
    F = int(np.bincount(rows, minlength=n)[cols].sum())

    def call():
        return G.spgemm(rows, cols, w, rows, cols, w, sem, np.float32)

    t1 = time.perf_counter()
    first, scans, gathers = record_esc(call)
    t_first = time.perf_counter() - t1
    F_pad = scans[0][0].numel()
    log(f"esc14: kron-14 ef16 n={n} nnz={len(rows)}; F={F} (F_pad {F_pad}),"
        f" nnz(C)={len(first[0])}; first call {t_first:.4f} s "
        f"({time.perf_counter() - t0:.1f} s with the graph)")
    cumsum_ms, lib_ms = check_esc_kernels(torch, ck, "esc14", "", scans,
                                          gathers, F, timed=True)
    del scans, gathers
    rng = np.random.RandomState(5)
    v = torch.from_numpy(rng.rand(1 << 22).astype(np.float32)).cuda()
    f = torch.from_numpy(rng.rand(1 << 22) < 0.01).cuda()
    ck.run("segfold", "esc14", "random fp32 PLUS M=4194304",
           lambda: SC.segfold(v, f, "PLUS"),
           lambda: SC._segfold_plain(v, f, "PLUS"), v.numel() * 9,
           rtol=1e-5)
    del v, f
    runs = []

    def best_of_3():
        for _ in range(3):
            t = time.perf_counter()
            out = call()
            runs.append(time.perf_counter() - t)
        return out

    got = drv.drive_esc("esc14", best_of_3)
    drv.results["esc14"] = (rows, cols, n, w, got)
    t = time.perf_counter()
    A = sp.csr_matrix((w.astype(np.float64), (rows, cols)), (n, n))
    want = csr_coo(A @ A)
    t_scipy = time.perf_counter() - t
    if not (esc_same(got[:2], want[:2])
            and np.array_equal(got[2], want[2].astype(np.float32))
            and esc_same(got, first)):
        raise AssertionError("esc14: C differs from scipy's A @ A")
    el = min(runs)
    nnz = len(got[0])
    res = dict(seconds=el, runs_s=runs, first_s=t_first, F=F, F_pad=F_pad,
               nnz_out=nnz, products_per_s=F / el, out_per_s=nnz / el,
               host_s_per_call=host_split(drv, "esc14", 3), scipy_s=t_scipy,
               cumsum_ms=cumsum_ms, index_select_ms=lib_ms)
    log(f"  esc14: C = A @ A equal to scipy's exactly ({nnz} entries); warm "
        f"best of 3 {el:.4f} s ({runs}), first {t_first:.4f} s; "
        f"{F / el:.6e} products/s, {nnz / el:.6e} outputs/s; host per "
        f"call {json.dumps(res['host_s_per_call'])}; scipy {t_scipy:.4f} "
        f"s; card {card}")
    res["profile"] = profile_spgemm(torch, call, "esc14")
    return res


def esc13_path(torch, ck, drv, card):
    """kron-13 symmetrised S, INT32, through gustavson.spgemm ("auto"):
    PLUS_PAIR (common-neighbour counts) equal to scipy's S @ S; MIN_PLUS
    with weights 1..255 (seed 7) equal to the same product through
    spgemm_engine="scipy" (scipy's pattern, then the generic tier's
    masked_spgemm with pair_fold on the card).  Before it, segfold (PLUS,
    and MIN over MIN_PLUS's products) and esc_gather against their plain
    versions at both calls' shapes."""
    import scipy.sparse as sp
    from pygraphblas_tpu_torch import options_set, types
    from pygraphblas_tpu_torch.core import gustavson as G

    rows, cols, n = graph(13, sym=True)
    ones = np.ones(len(rows), np.int32)
    wts = np.random.RandomState(7).randint(1, 256, len(rows)).astype(
        np.int32)

    def pair():
        return G.spgemm(rows, cols, ones, rows, cols, ones,
                        types.INT32.PLUS_PAIR, np.int32)

    def min_plus():
        return G.spgemm(rows, cols, wts, rows, cols, wts,
                        types.INT32.MIN_PLUS, np.int32)

    F = int(np.bincount(rows, minlength=n)[cols].sum())
    log(f"esc13: kron-13 symmetrised n={n} nnz={len(rows)}; F={F}")
    for tag, run in (("PLUS_PAIR ", pair), ("MIN_PLUS ", min_plus)):
        _, scans, gathers = record_esc(run)
        check_esc_kernels(torch, ck, "esc13", tag, scans, gathers, F,
                          timed=False)
        del scans, gathers
    secs = {}

    def both():
        out = []
        for name, run in (("PLUS_PAIR", pair), ("MIN_PLUS", min_plus)):
            t = time.perf_counter()
            out.append(run())
            secs[name] = time.perf_counter() - t
        return out

    got_p, got_m = drv.drive_esc("esc13", both)
    S = sp.csr_matrix((np.ones(len(rows), np.int64), (rows, cols)), (n, n))
    want = csr_coo(S @ S)
    if not (esc_same(got_p[:2], want[:2])
            and np.array_equal(got_p[2], want[2].astype(np.int32))):
        raise AssertionError("esc13: PLUS_PAIR differs from scipy's S @ S")
    options_set(spgemm_engine="scipy")
    try:
        t = time.perf_counter()
        ref = min_plus()
        t_gen = time.perf_counter() - t
    finally:
        options_set(spgemm_engine="auto")
    if not esc_same(got_m, ref):
        raise AssertionError("esc13: MIN_PLUS differs from the generic "
                             "tier on the card")
    res = dict(seconds=secs, generic_min_plus_s=t_gen, F=F,
               nnz_out=len(got_p[0]),
               host_s_per_call=host_split(drv, "esc13", 2))
    log(f"  esc13: PLUS_PAIR equal to scipy's S @ S ({len(got_p[0])} "
        f"entries), MIN_PLUS equal to the generic tier on the card "
        f"({t_gen:.4f} s); seconds {secs}; card {card}")
    res["profile"] = profile_spgemm(torch, pair, "esc13")
    return res


def check_algebra_codes(torch, ck):
    """segfold at every fold code the algebra adds, at the types of its
    paths (testing.SEGFOLD_CODES: 2^20 values, about 2000 segments), and
    pair_fold at its new mul and fold codes (testing.PAIR_FOLD_CODES, on
    the run_across_blocks edge lists, through each of its kernels; a mul
    or fold the algebra added takes the warp kernel at every width),
    against their plain versions: exact (ANY folds as MAX in both; the
    FP32 cases' values have no zero divisor, so no NaN)."""
    from pygraphblas_tpu_torch import _kernels as K, types
    from pygraphblas_tpu_torch.core import scan as SC, spgemm as SG
    from pygraphblas_tpu_torch.testing import (PAIR_FOLD_CODES,
                                               SEGFOLD_CODES, pair_fold_case,
                                               typed_values)

    for add, typ in SEGFOLD_CODES:
        T = getattr(types, typ)
        m = getattr(T, add + "_MONOID")
        rng = np.random.RandomState(len(add) + len(typ))
        v = typed_values(rng, T, 1 << 20).cuda()
        f = torch.from_numpy(rng.rand(1 << 20) < 0.002).cuda()
        f[0] = True
        ck.run("segfold", "sr14", f"codes {m.name} M={v.numel()}",
               lambda: SC.segfold(v, f, m),
               lambda: SC._segfold_plain(v, f, m),
               v.numel() * (2 * v.element_size() + 1))
    a, av, b, bv, ast, wa, bst, wb, w = pair_fold_case("run_across_blocks",
                                                       np.int32)
    a, b, ast, wa, bst, wb = (torch.from_numpy(x).cuda()
                              for x in (a, b, ast, wa, bst, wb))
    rule = SG._RUNS_WIDTH, SG._RUNS_EDGES
    try:
        for path, moved in (("search", (1, 1 << 40)), ("runs", (0, 0))):
            SG._RUNS_WIDTH, SG._RUNS_EDGES = moved
            for add, mul, typ in PAIR_FOLD_CODES:
                T = getattr(types, typ)
                x, y = av, bv
                if typ == "FP32":
                    x, y = np.where(av == 0, 5, av), np.where(bv == 0, 5, bv)
                xa, xb = (T.to_torch(z.astype(T.numpy_dtype)).cuda()
                          for z in (x, y))
                mop, fop = getattr(T, mul), getattr(T, add + "_MONOID")
                # a code the algebra added takes the warp kernel
                ext = (K.MULS[mul] > K.MULS["MAX"]
                       or K.FOLDS[add] > K.FOLDS["ANY"])
                ck.run("pair_fold", "sr16", f"codes {'warp' if ext else path}"
                       f" {fop.op}_{mop.name} W={w}",
                       lambda: SG.pair_fold(a, xa, b, xb, ast, wa, bst, wb,
                                            w, mop, fop),
                       lambda: SG._pair_fold_plain(a, xa, b, xb, ast, wa,
                                                   bst, wb, w, mop, fop), 0,
                       rtol=1e-5 if (add, typ) == ("PLUS", "FP32")
                       else None)
    finally:
        SG._RUNS_WIDTH, SG._RUNS_EDGES = rule


def check_typed_cases(torch, ck):
    """Every kernel wrapper at INT8, UINT16, UINT32 and BOOL
    (testing.wrapper_cases): 1- and 2-byte values as 4-byte words, UINT32
    words with the unsigned code, against the plain versions, exact."""
    from pygraphblas_tpu_torch.testing import (typed_plains, typed_wrappers,
                                               wrapper_cases)

    wrappers, plains = typed_wrappers(), typed_plains()
    for typ in ("INT8", "UINT16", "UINT32", "BOOL"):
        for name, case, call in wrapper_cases(typ, "cuda"):
            kfn = wrappers[name]
            ck.run(name, "small", case, lambda: call(kfn),
                   lambda: call(plains[kfn]), 0)


def sr14_calls(rows, cols):
    """sr14's six gustavson.spgemm calls on esc14's graph: (name,
    semiring, out dtype, A's values, B's values), values from seed 7."""
    from pygraphblas_tpu_torch import types

    m = len(rows)
    rng = np.random.RandomState(7)
    ones = np.ones(m, bool)
    i8 = rng.randint(-128, 128, m).astype(np.int8)
    w16 = rng.randint(1, 5, m).astype(np.int16)
    w8 = rng.randint(1, 101, m).astype(np.uint8)
    w32 = rng.randint(0, 1 << 32, m, dtype=np.int64).astype(np.uint32)
    a32 = rng.randint(-9, 10, m).astype(np.int32)
    b32 = rng.randint(0, 5, m).astype(np.int32)       # zero divisors
    return (("LOR_LAND BOOL", types.BOOL.LOR_LAND, np.bool_, ones, ones),
            ("ANY_PAIR INT8", types.INT8.ANY_PAIR, np.int8, i8, i8),
            ("PLUS_TIMES INT16", types.INT16.PLUS_TIMES, np.int16, w16, w16),
            ("MIN_PLUS UINT8", types.UINT8.MIN_PLUS, np.uint8, w8, w8),
            ("BOR_BAND UINT32", types.UINT32.BOR_BAND, np.uint32, w32, w32),
            ("PLUS_DIV INT32", types.INT32.PLUS_DIV, np.int32, a32, b32))


def sr14_path(torch, ck, drv, card):
    """The algebra through the unmasked SpGEMM: six gustavson.spgemm
    calls ("auto": ESC on the card) on esc14's graph (kron-14 ef16
    directed): BOOL LOR_LAND (every value true) equal to scipy's
    (A @ A) != 0, all true; INT8 ANY_PAIR to scipy's pattern with values
    1; INT16 PLUS_TIMES (weights 1..4) to scipy's int64 product wrapped
    to int16, exactly; UINT8 MIN_PLUS (weights 1..100) and UINT32
    BOR_BAND (any 32 bits) to the same call under spgemm_engine="scipy"
    (scipy's pattern, then masked_spgemm on the card); INT32 PLUS_DIV
    (B's values 0..4: x / 0 saturates) to the same call on the CPU (the
    ESC engine's plain versions).  Before it, each call's four scans and
    its gather against their plain versions, and segfold and pair_fold
    at every code the algebra adds."""
    import scipy.sparse as sp
    from pygraphblas_tpu_torch import options_set
    from pygraphblas_tpu_torch.core import gustavson as G

    rows, cols, n = graph(14)
    calls = sr14_calls(rows, cols)
    F = int(np.bincount(rows, minlength=n)[cols].sum())
    log(f"sr14: kron-14 ef16 n={n} nnz={len(rows)}; F={F}; "
        + ", ".join(c[0] for c in calls))

    def run(c, **kw):
        return G.spgemm(rows, cols, c[3], rows, cols, c[4], c[1], c[2], **kw)

    for c in calls:
        _, scans, gathers = record_esc(lambda: run(c))
        check_esc_kernels(torch, ck, "sr14", c[0] + " ", scans, gathers, F,
                          timed=False)
        del scans, gathers
    check_algebra_codes(torch, ck)
    secs = {}

    def all_six():
        out = []
        for c in calls:
            t = time.perf_counter()
            out.append(run(c))
            secs[c[0]] = time.perf_counter() - t
        return out

    got = drv.drive_esc("sr14", all_six)
    A1 = sp.csr_matrix((np.ones(len(rows), np.int64), (rows, cols)), (n, n))
    P = csr_coo(A1 @ A1)
    W16 = sp.csr_matrix((calls[2][3].astype(np.int64), (rows, cols)), (n, n))
    Q = csr_coo(W16 @ W16)
    checks = {}

    def same(x, y):
        return all(np.array_equal(u, v) for u, v in zip(x, y))

    checks["LOR_LAND BOOL"] = (same(got[0][:2], P[:2])
                               and got[0][2].dtype == np.bool_
                               and bool(got[0][2].all()))
    checks["ANY_PAIR INT8"] = (same(got[1][:2], P[:2])
                               and got[1][2].dtype == np.int8
                               and bool((got[1][2] == 1).all()))
    checks["PLUS_TIMES INT16"] = same(got[2], (Q[0], Q[1],
                                               Q[2].astype(np.int16)))
    options_set(spgemm_engine="scipy")
    try:
        t = time.perf_counter()
        checks["MIN_PLUS UINT8"] = same(got[3], run(calls[3]))
        checks["BOR_BAND UINT32"] = same(got[4], run(calls[4]))
        t_gen = time.perf_counter() - t
    finally:
        options_set(spgemm_engine="auto")
    options_set(spgemm_engine="esc")
    try:
        t = time.perf_counter()
        cpu = run(calls[5], device="cpu")
        t_cpu = time.perf_counter() - t
    finally:
        options_set(spgemm_engine="auto")
    checks["PLUS_DIV INT32"] = same(got[5], cpu)
    saturated = int((np.abs(got[5][2].astype(np.int64)) >= 2 ** 30).sum())
    log(f"  sr14: {checks}; PLUS_DIV {saturated} entries past 2^30 (x / 0 "
        f"saturated); generic tier {t_gen:.4f} s, CPU {t_cpu:.4f} s; "
        f"seconds {secs}; card {card}")
    if not all(checks.values()):
        raise AssertionError(f"sr14: a product differs from its oracle: "
                             f"{checks}")
    if not saturated:
        raise AssertionError("sr14: PLUS_DIV met no zero divisor")
    return dict(seconds=secs, F=F, nnz_out=len(P[0]), checks=checks,
                plus_div_saturated=saturated, generic_s=t_gen, cpu_s=t_cpu,
                host_s_per_call=host_split(drv, "sr14", len(calls)))


def record_pair_fold(run):
    """run() with the arguments of each pair_fold launch recorded."""
    from pygraphblas_tpu_torch.core import spgemm as SG

    calls, orig = [], SG.pair_fold

    def rec(*a):
        calls.append(a)
        return orig(*a)

    SG.pair_fold = rec
    try:
        return run(), calls
    finally:
        SG.pair_fold = orig


def sr16_path(torch, ck, drv, card, L):
    """The algebra through the masked SpGEMM on tc16's L with val16's
    weights (1..4, seed 7): C<L> = W (+.x) W, the route the JAX package's
    rule picks (spgemm.py:886-913) shown by the counters: BOOL LOR_PAIR
    launches pair_count (PAIR with an idempotent monoid), INT16
    PLUS_TIMES pair_fold (an int output of 4 bytes or less), BOOL
    LOR_LAND and UINT32 BXOR_PAIR (made with new_semiring: no family has
    it) neither (a BOOL output, and a parity monoid: the generic
    intersect).  LOR_* equal scipy's pattern of
    (W @ W) .* L, all true; PLUS_TIMES its values wrapped to int16;
    BXOR_PAIR the parity of scipy's counts.  Before it, pair_fold on
    every launch of the INT16 call against its plain version."""
    from pygraphblas_tpu_torch import types
    from pygraphblas_tpu_torch.core import spgemm as SG

    W = L.copy()
    W.data = np.random.RandomState(7).randint(1, 5, W.nnz).astype(np.float64)
    lr, lc, lv = csr_coo(W)
    tr, tc, tv = csr_coo(W.T)

    def call(sem, dt):
        return SG.masked_spgemm(lr, lc, lv.astype(dt), tr, tc, tv.astype(dt),
                                lr, lc, sem, dt)

    routes = (("LOR_LAND", types.BOOL.LOR_LAND, np.bool_),
              ("LOR_PAIR", types.BOOL.LOR_PAIR, np.bool_),
              ("PLUS_TIMES", types.INT16.PLUS_TIMES, np.int16),
              ("BXOR_PAIR", types.UINT32.new_semiring(
                  types.UINT32.BXOR_MONOID, types.UINT32.PAIR), np.uint32))
    _, launches = record_pair_fold(lambda: call(*routes[2][1:]))
    for i, (a, av, b, bv, ast, wa, bst, wb, w, mul, add) in \
            enumerate(launches):
        ck.run("pair_fold", "sr16", f"launch {i} W={w} E={ast.numel()} "
               f"{add.op}_{mul.name}",
               lambda: SG.pair_fold(a, av, b, bv, ast, wa, bst, wb, w, mul,
                                    add),
               lambda: SG._pair_fold_plain(a, av, b, bv, ast, wa, bst, wb,
                                           w, mul, add), 0)
    del launches
    want = masked_square(W)
    ones = W.copy()
    ones.data[:] = 1.0
    cnt = masked_square(ones)
    got, secs = {}, {}
    for tag, sem, dt in routes:
        path = f"sr16 {tag}"
        t = time.perf_counter()
        if path in GENERIC_SPGEMM:
            got[tag] = drv.drive_generic(path, lambda: call(sem, dt))
        else:
            got[tag] = drv.drive_spgemm(path, lambda: call(sem, dt))
        secs[tag] = time.perf_counter() - t

    def same(x, y):
        return all(np.array_equal(u, v) for u, v in zip(x, y))

    checks = {t: same(got[t][:2], want[:2]) and bool(got[t][2].all())
              and got[t][2].dtype == np.bool_
              for t in ("LOR_LAND", "LOR_PAIR")}
    checks["PLUS_TIMES"] = same(got["PLUS_TIMES"],
                                (want[0], want[1],
                                 want[2].astype(np.int64).astype(np.int16)))
    checks["BXOR_PAIR"] = same(got["BXOR_PAIR"],
                               (cnt[0], cnt[1],
                                (cnt[2].astype(np.int64) % 2)
                                .astype(np.uint32)))
    log(f"  sr16: {checks}; {len(want[0])} present; seconds {secs}; "
        f"card {card}")
    if not all(checks.values()):
        raise AssertionError(f"sr16: a product differs from scipy: {checks}")
    return dict(seconds=secs, checks=checks, present=len(want[0]))


# ---------------------------------------------------------------------------
# the container API (Matrix and Vector, slice 10) over the earlier paths'
# graphs, matrices and xspmv plans: no new xspmv plan is built
# ---------------------------------------------------------------------------

def gpr20_path(torch, drv, card, A, n, fused_ms):
    """algorithms.pagerank (the GAP formulation: Matrix.mxv with desc=T0
    and accum=PLUS) on pr20's matrix, spmv_engine="xspmv": 5 iterations
    within 1e-3 x the largest rank of fused.pagerank's, then timed an
    iteration (pagerank_ms: calls of 5 and 25 iterations); then 5
    iterations through the csr8 engine (torch ops on the card, its plan's
    host build timed), within 1e-5 x the largest rank of the xspmv run,
    and timed the same way (calls of 5 and 10)."""
    from pygraphblas_tpu_torch import algorithms, fused, options_set

    options_set(spmv_engine="xspmv")
    try:
        r5 = drv.drive("gpr20", lambda: algorithms.pagerank(
            A, itermax=5, tol=-1.0), EXPECTED["gpr20"])
        ref = fused.pagerank(A, itermax=5, tol=-1.0)._vals
        gap = float((r5._vals - ref).abs().max())
        top = float(ref.abs().max())
        log(f"gpr20: algorithms.pagerank through Matrix.mxv on pr20's "
            f"matrix, 5 iterations: max |container - fused| = {gap:.3e} "
            f"(max rank {top:.3e}, limit {1e-3 * top:.3e})")
        if not gap <= 1e-3 * top or r5._vals.shape != (n,):
            raise AssertionError("gpr20: container PageRank differs from "
                                 "fused.pagerank")
        ms, setup_ms, calls = pagerank_ms(torch, algorithms, A, 5, 25)
    finally:
        options_set(spmv_engine="auto")
    log(f"  gpr20: {ms:.4f} ms/iteration (xspmv; (best 25-iteration call "
        f"- best 5-iteration call) / 20, calls {calls} s), set-up "
        f"{setup_ms:.4f} ms a call; pr20's fused loop {fused_ms:.4f} "
        f"ms/iteration in this call: the container layer's host cost "
        f"{ms - fused_ms:.4f} ms an iteration; card {card}")
    options_set(spmv_engine="csr8")
    try:
        t0 = time.perf_counter()
        A._spmv_plan(True, "cuda")
        plan_s = time.perf_counter() - t0
        rc = drv.drive("gpr20_csr8", lambda: algorithms.pagerank(
            A, itermax=5, tol=-1.0), EXPECTED["gpr20_csr8"])
        csr8_ms, csr8_setup_ms, calls8 = pagerank_ms(torch, algorithms, A,
                                                     5, 10)
    finally:
        options_set(spmv_engine="auto")
    gap8 = float((rc._vals - r5._vals).abs().max())
    top5 = float(r5._vals.abs().max())
    log(f"  gpr20 csr8: plan {plan_s:.1f} s (host), {csr8_ms:.4f} "
        f"ms/iteration ((best 10-iteration call - best 5-iteration call) "
        f"/ 5, calls {calls8} s), set-up {csr8_setup_ms:.4f} ms a call; "
        f"max |csr8 - xspmv| = {gap8:.3e} (limit {1e-5 * top5:.3e}); "
        f"card {card}")
    if not gap8 <= 1e-5 * top5:
        raise AssertionError("gpr20: the csr8 engine differs from xspmv")
    return dict(ms_per_iteration=ms, setup_ms=setup_ms, calls_s=calls,
                fused_ms_per_iteration=fused_ms,
                max_abs_gap_vs_fused=gap, csr8_ms_per_iteration=csr8_ms,
                csr8_setup_ms=csr8_setup_ms, csr8_calls_s=calls8,
                csr8_plan_s=plan_s, max_abs_gap_csr8=gap8)


def pagerank_ms(torch, algorithms, A, short, long, best_of=2):
    """ms an iteration of algorithms.pagerank(A): the best wall time of a
    `long`-iteration call less that of a `short`-iteration one, over
    their difference in iterations, so that a call's set-up (the degree
    pass, the first rank vector) is not spread over its iterations; and
    that set-up's ms (the short call less its iterations).  Also returns
    every call's seconds by length."""
    secs = {short: [], long: []}
    for _ in range(best_of):
        for k in (short, long):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            algorithms.pagerank(A, itermax=k, tol=-1.0)
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)
    ts, tl = min(secs[short]), min(secs[long])
    ms = (tl - ts) / (long - short) * 1e3
    return ms, ts * 1e3 - short * ms, secs


def gsp18_path(torch, drv, card, A, Aw, s0):
    """algorithms.sssp (MIN_PLUS vxm with a MIN accumulator) on sssp18's
    matrix from its source, and algorithms.bfs_level_vxm (LOR_LAND vxm
    under a complemented mask) on bfs18's, from vertex 0 and from the
    same source: vxm on the
    COO tier, so SpMSpV while the frontier is small and the csr8 plan
    after (torch ops on the card, no kernel of the port); each equal to
    its fused loop's result exactly."""
    from pygraphblas_tpu_torch import algorithms, fused

    t0 = time.perf_counter()
    Aw._spmv_plan(True, "cuda")
    A._spmv_plan(True, "cuda")
    plan_s = time.perf_counter() - t0
    secs = {}

    def run():
        out = []
        for name, call in (("sssp", lambda: algorithms.sssp(Aw, s0)),
                           ("bfs0", lambda: algorithms.bfs_level_vxm(A, 0)),
                           ("bfs_s0",
                            lambda: algorithms.bfs_level_vxm(A, s0))):
            t = time.perf_counter()
            out.append(call())
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
        return out

    dv, lv0, lvs = drv.drive("gsp18", run, EXPECTED["gsp18"])
    drv.results["gsp18"] = (dv, lvs)     # the distributed tier's yardstick
    if dv.to_lists() != fused.sssp(Aw, s0).to_lists():
        raise AssertionError("gsp18: algorithms.sssp differs from "
                             "fused.sssp")
    for lv, src in ((lv0, 0), (lvs, s0)):
        if lv.to_lists() != fused.bfs_level(A, src).to_lists():
            raise AssertionError("gsp18: algorithms.bfs_level_vxm from "
                                 f"{src} differs from fused.bfs_level")
    # vertex 0 has no out-edge in kron-18, so the BFS from the SSSP
    # source is the one that walks the graph
    log(f"gsp18: algorithms.sssp from {s0} ({dv.nvals} reached) "
        f"{secs['sssp']:.4f} s; bfs_level_vxm from 0 ({lv0.nvals} "
        f"reached) {secs['bfs0']:.4f} s, from {s0} ({lvs.nvals} reached, "
        f"depth {int(lvs.reduce_int(lvs.type.MAX_MONOID))}) "
        f"{secs['bfs_s0']:.4f} s; each equal to its fused loop exactly; "
        f"csr8 plans {plan_s:.1f} s (host); card {card}")
    return dict(source=s0, sssp_s=secs["sssp"], bfs0_s=secs["bfs0"],
                bfs_s0_s=secs["bfs_s0"], csr8_plans_s=plan_s,
                sssp_reached=dv.nvals, bfs0_reached=lv0.nvals,
                bfs_s0_reached=lvs.nvals)


def gtc16_path(torch, ck, drv, card, rows, cols, n, want):
    """algorithms.triangle_count methods "cohen" ((L @ U)<A>) and
    "sandia_dot" ((L @ U^T)<L>) through the containers (tril, triu and a
    masked Matrix.mxm: the masked SpGEMM, pair_count on the card) on
    tc16's graph; each equal to the "sandia" count, which tc16 held to
    scipy's.  pair_count is held against its plain version on every
    launch of each method's run: its own width buckets (cohen's mask is
    the whole of A, not tc16's L)."""
    from pygraphblas_tpu_torch import algorithms, types
    from pygraphblas_tpu_torch.generators import to_matrix

    A = to_matrix(rows, cols, n, types.INT64)
    res = {}
    for method in ("cohen", "sandia_dot"):
        path = f"gtc16 {method}"
        t = time.perf_counter()
        got, calls = record_pair_count(lambda: drv.drive_spgemm(
            path, lambda: algorithms.triangle_count(A, method=method)))
        el = time.perf_counter() - t
        log(f"  {path}: {len(calls)} pair_count launches recorded")
        check_recorded_pair_count(ck, path, calls)
        del calls
        if got != want or drv.counts[path]["counts"]["pair_count"] == 0:
            raise AssertionError(f"{path}: {got} triangles, sandia and "
                                 f"scipy {want}")
        res[method] = dict(triangles=got, seconds=el,
                           host_s=drv.counts[path]["host_s"])
        log(f"  {path}: {got} triangles = sandia's = scipy's, {el:.4f} s "
            f"(first call); card {card}")
    return res


def gesc14_path(torch, drv, card):
    """Matrix.mxm(A, semiring=FP32.PLUS_TIMES) on esc14's graph as a
    Matrix (the COO tier: gustavson.spgemm, ESC on the card, 4 segfold
    launches and 1 esc_gather), equal to esc14's product exactly."""
    from pygraphblas_tpu_torch import types
    from pygraphblas_tpu_torch.generators import to_matrix

    rows, cols, n, w, want = drv.results["esc14"]
    A = to_matrix(rows, cols, n, types.FP32, vals=w)
    t = time.perf_counter()
    C = drv.drive_esc("gesc14", lambda: A.mxm(
        A, semiring=types.FP32.PLUS_TIMES))
    el = time.perf_counter() - t
    got = C._coo()
    if C._fmt != "coo" or not (esc_same(got[:2], want[:2])
                               and np.array_equal(got[2], want[2])):
        raise AssertionError("gesc14: Matrix.mxm differs from esc14's "
                             "product")
    log(f"gesc14: A.mxm(A) through the Matrix, {C.nvals} entries equal to "
        f"esc14's product exactly; {el:.4f} s; card {card}")
    return dict(seconds=el, nnz_out=C.nvals)


# ---------------------------------------------------------------------------
# the rest of Matrix (slice 11): extract and assign over index sets,
# Kronecker products, and Louvain over them
# ---------------------------------------------------------------------------

def gx20_path(torch, drv, card, A, n):
    """Extract and assign over index sets on pr20's kron-20 matrix (the
    COO tier: host triples through coosem's selectors, no kernel), each
    equal to scipy's slice or assignment of the same CSR: the row block
    A[0:262143, :] (stop-inclusive), 4096 random rows in random order,
    the row and the column of most entries, a 4096 x 4096 block
    assigned (density 1/64, weights 1..4, seed 11), and a scalar over 8
    rows under a mask of about 32k positions (seed 12)."""
    import scipy.sparse as sp
    from pygraphblas_tpu_torch import Matrix, types

    r, c, v = A._coo()
    S = sp.csr_matrix((v, (r, c)), (n, n))
    rng = np.random.RandomState(11)
    pick = rng.choice(n, 4096, replace=False)
    i0 = int(np.argmax(np.diff(S.indptr)))
    j0 = int(np.argmax(np.bincount(c, minlength=n)))
    r0, c0 = n // 8 + 1, n // 2 + 17
    kb = 4096 * 4096 // 64
    cells = np.unique(rng.randint(0, 4096 * 4096, kb))
    bv = rng.randint(1, 5, len(cells)).astype(np.float32)
    B = Matrix.sparse(types.FP32, 4096, 4096, device="cuda")
    B._build(cells // 4096, cells % 4096, bv)
    mrng = np.random.RandomState(12)
    mr = mrng.randint(r0, r0 + 8, 32768)
    mc = mrng.randint(0, n, 32768)
    mkey = np.unique(mr * n + mc)
    Mk = Matrix.sparse(types.BOOL, n, n, device="cuda")
    Mk._build(mkey // n, mkey % n, np.ones(len(mkey), bool))
    secs = {}

    def timed(name, call):
        t = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return out

    def run():
        out = dict(block=timed("row_block", lambda: A[0:262143, :]),
                   rows=timed("row_list",
                              lambda: A.extract_matrix(pick.tolist())),
                   row=timed("extract_row", lambda: A.extract_row(i0)),
                   col=timed("extract_col", lambda: A.extract_col(j0)))
        C = A.dup()
        timed("assign_matrix", lambda: C.assign_matrix(
            B, slice(r0, r0 + 4095), slice(c0, c0 + 4095)))
        D = A.dup()
        timed("assign_scalar", lambda: D.assign_scalar(
            2.0, slice(r0, r0 + 7), None, mask=Mk))
        out.update(C=C, D=D)
        return out

    got = drv.drive("gx20", run, EXPECTED["gx20"])

    def same(X, want):
        g = X._coo()
        return all(np.array_equal(x, y) for x, y in zip(g, want))

    row = S[i0].tocoo()
    col = S[:, j0].tocoo()
    want_col = np.argsort(col.row, kind="stable")
    SB = sp.csr_matrix((bv, (cells // 4096 + r0, cells % 4096 + c0)),
                       (n, n))
    region = S[r0:r0 + 4096, c0:c0 + 4096].tocoo()
    Sreg = sp.csr_matrix((region.data, (region.row + r0, region.col + c0)),
                         (n, n))
    E = (S - Sreg) + SB
    E.eliminate_zeros()
    Mr = sp.csr_matrix((np.ones(len(mkey), np.float32),
                        (mkey // n, mkey % n)), (n, n))
    F = (S - S.multiply(Mr)) + 2 * Mr
    F.eliminate_zeros()
    checks = dict(
        row_block=same(got["block"], csr_coo(S[0:262144])),
        row_list=same(got["rows"], csr_coo(S[pick])),
        extract_row=got["row"].to_lists() == [row.col.tolist(),
                                               row.data.tolist()],
        extract_col=got["col"].to_lists() == [
            col.row[want_col].tolist(), col.data[want_col].tolist()],
        assign_matrix=same(got["C"], csr_coo(E)),
        assign_scalar=same(got["D"], csr_coo(F)))
    shapes = dict(row_block=(got["block"].shape, got["block"].nvals),
                  row_list=(got["rows"].shape, got["rows"].nvals),
                  extract_row=got["row"].nvals, extract_col=got["col"].nvals,
                  assign_matrix=got["C"].nvals, assign_scalar=got["D"].nvals)
    log(f"gx20: extract and assign on kron-20 (n={n}, nnz={len(r)}, COO "
        f"tier); equal to scipy: {checks}; entries {shapes}; seconds "
        + ", ".join(f"{k} {t:.4f}" for k, t in secs.items())
        + f"; card {card}")
    if not all(checks.values()):
        raise AssertionError(f"gx20: differs from scipy: {checks}")
    return dict(seconds=secs, entries={k: str(x) for k, x in shapes.items()},
                row=i0, col=j0, region=(r0, c0))


def gkr_path(torch, drv, card):
    """Kronecker products equal to scipy.sparse.kron: on the bitmap tier
    two 64 x 64 FP32 matrices at density 1/2 (weights 1..9, seed 13; a
    4096 x 4096 output, one broadcast of TIMES on the card), and on the
    COO tier kron-10 symmetrised (INT32 ones) with a 16 x 16 INT32
    matrix at density 1/2 (1..9, seed 14; host coosem.kron)."""
    import scipy.sparse as sp
    from pygraphblas_tpu_torch import Matrix, types
    from pygraphblas_tpu_torch.generators import to_matrix

    def dense_half(k, typ, seed):
        rng = np.random.RandomState(seed)
        cells = np.nonzero(rng.rand(k * k) < 0.5)[0]
        vals = rng.randint(1, 10, len(cells)).astype(typ._numpy_t)
        M = Matrix.sparse(typ, k, k, device="cuda")
        M._build(cells // k, cells % k, vals)
        return M, sp.csr_matrix((vals, (cells // k, cells % k)), (k, k))

    A64, SA64 = dense_half(64, types.FP32, 13)
    B64, SB64 = dense_half(64, types.FP32, 13 + 100)
    rows, cols, n = graph(10, sym=True)
    A10 = to_matrix(rows, cols, n, types.INT32)
    SA10 = sp.csr_matrix((np.ones(len(rows), np.int32), (rows, cols)),
                         (n, n))
    B16, SB16 = dense_half(16, types.INT32, 14)
    secs = {}

    def run():
        out = {}
        for name, call in (("bitmap", lambda: A64.kronecker(B64)),
                           ("coo", lambda: A10.kronecker(B16))):
            t = time.perf_counter()
            out[name] = call()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
        return out

    got = drv.drive("gkr", run, EXPECTED["gkr"])
    res = {}
    # format="csr": scipy's default takes B as dense past half full and
    # stores its zeros
    for name, want in (("bitmap", sp.kron(SA64, SB64, format="csr")),
                       ("coo", sp.kron(SA10, SB16, format="csr"))):
        C = got[name]
        g, w = C._coo(), csr_coo(want)
        ok = all(np.array_equal(x, y) for x, y in zip(g, w))
        res[name] = dict(seconds=secs[name], fmt=C._fmt, shape=C.shape,
                         nvals=C.nvals, equal=ok)
        if not ok:
            raise AssertionError(f"gkr {name}: differs from scipy's kron")
    log(f"gkr: Kronecker products equal to scipy.sparse.kron: "
        + "; ".join(f"{k} {v['fmt']} {v['shape']} {v['nvals']} entries "
                    f"{v['seconds']:.4f} s" for k, v in res.items())
        + f"; card {card}")
    return res


def modularity(rows, cols, n, labels):
    """Newman's modularity of `labels` on the unit-weight graph (rows,
    cols), through scipy: sum over communities of (inner weight / 2m) -
    (degree sum / 2m)^2."""
    import scipy.sparse as sp

    S = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), (n, n))
    k = np.asarray(S.sum(axis=1)).ravel()
    two_m = float(k.sum())
    inner = float(S.multiply(sp.csr_matrix(
        ((labels[rows] == labels[cols]).astype(np.float64), (rows, cols)),
        (n, n))).sum())
    tot = np.bincount(labels, weights=k)
    return inner / two_m - float(((tot / two_m) ** 2).sum())


def glv16_path(torch, ck, drv, card, rows, cols, n, max_levels=10):
    """algorithms.louvain_cluster on kron-16 symmetrised (bc16's graph),
    weights 1.0 as FP32, max_iters 20, on the card: each chunk's product
    W[chunk, :] @ M and each contraction P^T (W P) is a Matrix.mxm on the
    COO tier (gustavson.spgemm: the diagonal-B path while the labels are
    the identity, ESC on the card where it fits, the host tier past its
    caps; the dense tier once a contracted graph fits the bitmap tier).
    Labels equal to the same call with device="cpu" (every product is a
    sum of integer weights far below 2^24: exact in FP32 in any order);
    every ESC call's segfold and esc_gather launches held against their
    plain versions after the run (check_esc_kernels: bit-exact over the
    live slots, within rtol 1e-5 over the dead ones past them); every
    product's output row-major (the local moves searchsorted its rows);
    each product's route logged by level; modularity through scipy."""
    from pygraphblas_tpu_torch import algorithms as ALG, matrix as MX, types
    from pygraphblas_tpu_torch.core import esc as E, gustavson as G
    from pygraphblas_tpu_torch.generators import to_matrix

    K = drv.K
    routes, unordered, levels = [], [], []
    state = dict(level=0, inside=False, spgemm=False)
    orig_sp, orig_dense, orig_lm, orig_mxm = (
        G.spgemm, G.dense_spgemm, ALG._louvain_local_moves, MX.dk.mxm)
    dense_hits = []

    def bitmap_mxm(*a, **kw):
        # a product of two bitmap-tier matrices (not through spgemm)
        if not state["spgemm"]:
            routes.append((state["level"],
                           "chunk" if state["inside"] else "contract",
                           "bitmap"))
        return orig_mxm(*a, **kw)

    def dense(*a, **kw):
        out = orig_dense(*a, **kw)
        dense_hits.append(out is not None)
        return out

    def spgemm(ra, ca, va, rb, cb, vb, *a, **kw):
        s0, e0, d0 = K.launches["segfold"], E.stats["calls"], len(dense_hits)
        state["spgemm"] = True
        try:
            out = orig_sp(ra, ca, va, rb, cb, vb, *a, **kw)
        finally:
            state["spgemm"] = False
        if len(rb) and bool(np.all(rb == cb)):
            route = "diag"
        elif E.stats["calls"] > e0:
            route = "esc"
            if K.launches["segfold"] - s0 != 4:
                raise AssertionError("glv16: an ESC call did not launch "
                                     "segfold 4 times")
        elif any(dense_hits[d0:]):
            route = "dense"
        elif len(out[0]) == 0:
            route = "empty"      # a chunk of isolated vertices
        else:
            route = "host"
        r, c = out[0], out[1]
        dr, dc = np.diff(r), np.diff(c)
        if not bool(np.all((dr > 0) | ((dr == 0) & (dc > 0)))):
            unordered.append((state["level"], route))
        routes.append((state["level"],
                       "chunk" if state["inside"] else "contract", route))
        return out

    def local_moves(W, *a, **kw):
        state["level"] += 1
        state["inside"] = True
        t = time.perf_counter()
        try:
            out = orig_lm(W, *a, **kw)
        finally:
            state["inside"] = False
        levels.append((state["level"], W.nrows, W._fmt,
                       round(time.perf_counter() - t, 4),
                       int(out.max()) + 1))
        log(f"  glv16 level {levels[-1]} (level, vertices, tier, s, "
            "communities)")
        return out

    def louvain(dev):
        A = to_matrix(rows, cols, n, types.FP32, device=dev)
        ALG.seconds.clear()
        state["level"] = 0
        t = time.perf_counter()
        lab = ALG.louvain_cluster(A, max_levels=max_levels)
        torch.cuda.synchronize()
        el = time.perf_counter() - t
        return lab, el, dict(ALG.seconds)

    G.spgemm, G.dense_spgemm, ALG._louvain_local_moves = (spgemm, dense,
                                                          local_moves)
    MX.dk.mxm = bitmap_mxm
    try:
        (lab, el, phases), calls = record_esc_calls(
            lambda: drv.drive_esc("glv16", lambda: louvain("cuda"),
                                  dense_ok=True))
        card_routes, card_levels = list(routes), list(levels)
        routes.clear()
        levels.clear()
        lab_cpu, el_cpu, phases_cpu = louvain("cpu")
    finally:
        G.spgemm, G.dense_spgemm, ALG._louvain_local_moves = (
            orig_sp, orig_dense, orig_lm)
        MX.dk.mxm = orig_mxm
    counts = drv.counts["glv16"]
    got, want = lab.to_lists(), lab_cpu.to_lists()
    labels = np.asarray(got[1], np.int64)
    q = modularity(rows, cols, n, labels)
    by_level = {}
    for level, kind, route in card_routes:
        d = by_level.setdefault(level, {})
        d[f"{kind} {route}"] = d.get(f"{kind} {route}", 0) + 1
    log(f"glv16: louvain_cluster on kron-16 symmetrised (n={n}, "
        f"nnz={len(rows)}), max_levels {max_levels}: {el:.4f} s on the "
        f"card, {el_cpu:.4f} s with device='cpu'; {int(labels.max()) + 1} "
        f"communities, modularity {q:.6f} (scipy); labels equal to the "
        f"CPU run: {got == want}; card phases (s) "
        + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
        + "; CPU phases (s) "
        + ", ".join(f"{k} {v:.4f}" for k, v in phases_cpu.items())
        + f"; {counts['esc_calls']} ESC calls, {counts['dense_matmuls']} "
        f"dense matmuls, launches segfold {counts['counts']['segfold']} "
        f"esc_gather {counts['counts']['esc_gather']}; products by level "
        f"(kind route: count) {json.dumps(by_level)}; card {card}")
    if got != want:
        raise AssertionError("glv16: the card's labels differ from the CPU "
                             "run's")
    if unordered:
        raise AssertionError(f"glv16: products not row-major: {unordered}")
    if len(calls) != counts["esc_calls"]:
        raise AssertionError(f"glv16: {len(calls)} ESC calls recorded, "
                             f"{counts['esc_calls']} counted")
    t = time.perf_counter()
    ck.quiet = True
    try:
        for i, call in enumerate(calls):
            if len(call["scans"]) != 4 or len(call["gathers"]) != 1:
                raise AssertionError(f"glv16: ESC call {i} made "
                                     f"{len(call['scans'])} scans")
            check_esc_kernels(torch, ck, "glv16", f"call {i} ",
                              call["scans"], call["gathers"], call["F"],
                              timed=False)
    finally:
        ck.quiet = False
    mine = [row for row in ck.rows if row["path"] == "glv16"]
    nchk = len(mine)
    dead_err = max(row["max_abs_err"] for row in mine)
    log(f"  glv16: {nchk} checks of {len(calls)} ESC calls' launches "
        f"against their plain versions: equal, bit-exact over every live "
        f"slot (largest difference over the dead slots past them, a "
        f"float PLUS fold in another order: {dead_err}) "
        f"({time.perf_counter() - t:.1f} s)")
    del calls
    return dict(seconds=el, cpu_seconds=el_cpu, max_levels=max_levels,
                communities=int(labels.max()) + 1, modularity=q,
                phases_s=phases, cpu_phases_s=phases_cpu,
                esc_calls=counts["esc_calls"],
                dense_matmuls=counts["dense_matmuls"],
                products_by_level=by_level, levels=card_levels,
                cpu_levels=list(levels), checks=nchk,
                dead_slot_max_abs_err=dead_err)


# ---------------------------------------------------------------------------
# slice 12: the direction-optimised BFS, the sparse DNN and the I/O
# ---------------------------------------------------------------------------

def gbfs18_path(torch, ck, drv, card, A, rows, cols, n, sources=(0, 213770)):
    """algorithms.bfs_level and bfs_parents on bfs18's matrix (kron-18
    ef16, directed, BOOL) from each source.  bfs_level takes the device
    frontier loop (fused.bfs_frontier): from a vertex with a small reach
    it ends in its budgets; on kron's giant frontiers it overflows them
    twice and falls back to the dense fused.bfs_level (bfs18's xspmv
    plan: the xspmv kernels, held against their plain versions here at
    the plan's shapes).  Levels equal to scipy's unweighted shortest
    paths + 1 on the reached set; parents equal to the same call on a
    device="cpu" copy, every parent edge in the graph, every parent one
    level above its child."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from pygraphblas_tpu_torch import algorithms, fused, types
    from pygraphblas_tpu_torch.generators import to_matrix

    plan = A._xspmv_plan(True, np.float32, device="cuda")
    f0 = torch.zeros(n, device="cuda")
    f0[:: 97] = 1.0
    check_xspmv_kernels(torch, ck, plan, f0, types.FP32.MAX_SECOND,
                        "gbfs18")
    routes, secs = {}, {}

    def run():
        out = {}
        for s in sources:
            t = time.perf_counter()
            fused.last_frontier.clear()
            c0 = drv.calls
            lv = algorithms.bfs_level(A, s)
            torch.cuda.synchronize()
            secs[f"bfs_level {s}"] = time.perf_counter() - t
            routes[s] = dict(fused.last_frontier, xspmv_calls=drv.calls - c0)
            t = time.perf_counter()
            pa = algorithms.bfs_parents(A, s)
            secs[f"bfs_parents {s}"] = time.perf_counter() - t
            out[s] = (lv, pa)
        return out

    got = drv.drive("gbfs18", run, EXPECTED["gbfs18"])
    G = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), (n, n))
    dist = csgraph.shortest_path(G, directed=True, unweighted=True,
                                 indices=list(sources))
    Ac = to_matrix(rows, cols, n, types.BOOL, device="cpu")
    keys = np.asarray(rows, np.int64) * n + np.asarray(cols, np.int64)
    res = {}
    for k, s in enumerate(sources):
        lv, pa = got[s]
        li, lvals = lv.to_lists()
        want = np.where(np.isfinite(dist[k]), dist[k] + 1, 0).astype(np.int64)
        dense = np.zeros(n, np.int64)
        dense[li] = lvals
        if not np.array_equal(dense, want):
            raise AssertionError(f"gbfs18: levels from {s} differ from "
                                 f"scipy's in {int((dense != want).sum())} "
                                 "places")
        pi, pv = pa.to_lists()
        if pa.to_lists() != algorithms.bfs_parents(Ac, s).to_lists():
            raise AssertionError(f"gbfs18: parents from {s} differ from the "
                                 "device='cpu' run")
        ci = np.asarray(pi, np.int64)
        pv = np.asarray(pv, np.int64)
        off = ci != s
        edge_ok = bool(np.all(np.isin(pv[off] * n + ci[off], keys)))
        level_ok = bool(np.array_equal(dense[pv[off]], dense[ci[off]] - 1))
        if not (edge_ok and level_ok and np.array_equal(
                np.sort(ci), np.flatnonzero(want))):
            raise AssertionError(f"gbfs18: parents from {s}: edges "
                                 f"{edge_ok}, levels {level_ok}")
        res[s] = dict(route=routes[s], reached=len(li),
                      depth=int(want.max()),
                      bfs_level_s=secs[f"bfs_level {s}"],
                      bfs_parents_s=secs[f"bfs_parents {s}"])
        log(f"gbfs18: from {s}: route {routes[s]['route']} (frontier loop "
            f"p_bits {routes[s]['p_bits']}, {routes[s]['levels_run']} "
            f"levels run in it; {routes[s]['xspmv_calls']} xspmv calls of "
            f"the dense fallback), {len(li)} reached, depth "
            f"{int(want.max())}; bfs_level {secs[f'bfs_level {s}']:.4f} s, "
            f"bfs_parents {secs[f'bfs_parents {s}']:.4f} s; levels equal "
            f"scipy's, parents equal the CPU run's, every parent edge "
            f"present and one level up; card {card}")
    c = drv.counts["gbfs18"]
    res["launches"] = {k: v for k, v in c["counts"].items() if v}
    res["xspmv_calls"] = c["xspmv_calls"]
    return res


def lattice(side):
    """A side x side 4-neighbour lattice in canonical (row, col) order:
    each vertex's neighbours up, left, right, down."""
    n = side * side
    v = np.arange(n, dtype=np.int64)
    i, j = v // side, v % side
    nbr = np.stack([np.where(i > 0, v - side, -1),
                    np.where(j > 0, v - 1, -1),
                    np.where(j < side - 1, v + 1, -1),
                    np.where(i < side - 1, v + side, -1)], 1)
    keep = nbr >= 0
    return np.repeat(v, keep.sum(1)), nbr[keep], n


def groad_path(torch, drv, card, side=4096):
    """fused.bfs_frontier and algorithms.bfs_level (which takes it) on a
    side x side 4-neighbour lattice from its centre: the high-diameter
    input the frontier loop exists for, standing in for GAP's road
    graph.  Levels equal to the closed form |i - c| + |j - c| + 1; every
    level's frontier fits the id buffer and its edges a tier (no
    retry); no kernel of the port runs."""
    from pygraphblas_tpu_torch import Matrix, algorithms, fused, types

    t = time.perf_counter()
    rows, cols, n = lattice(side)
    A = Matrix.sparse(types.BOOL, n, n, device="cuda")
    A._build(rows, cols, np.ones(len(rows), np.bool_))
    del rows, cols
    build_s = time.perf_counter() - t
    ctr = side // 2
    start = ctr * side + ctr
    t = time.perf_counter()
    fused._frontier_csr(A, "cuda")   # the copy bfs_frontier reads
    csr_s = time.perf_counter() - t
    secs, routes = {}, {}

    def run():
        out = []
        for name, call in (("bfs_frontier",
                            lambda: fused.bfs_frontier(A, start)),
                           ("bfs_level",
                            lambda: algorithms.bfs_level(A, start))):
            t = time.perf_counter()
            out.append(call())
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            routes[name] = dict(fused.last_frontier)
        return out

    got = drv.drive("groad", run, EXPECTED["groad"])
    copies = [k for k in A._cache() if isinstance(k, tuple)
              and k[0] == "frontier_csr"]
    if len(copies) != 1:
        raise AssertionError(f"groad: the timed calls built their own "
                             f"frontier CSR: {copies}")
    v = torch.arange(n, device="cuda")
    want = ((v // side - ctr).abs() + (v % side - ctr).abs() + 1)
    for name, lv in zip(secs, got):
        vals, mask = lv._dense_pair()
        if not (torch.equal(vals, want) and bool(mask.all())):
            raise AssertionError(f"groad: {name} levels differ from the "
                                 "closed form")
        if routes[name]["route"] != "frontier":
            raise AssertionError(f"groad: {name} took {routes[name]}")
    depth = int(want.max())
    log(f"groad: {side} x {side} lattice (n={n}, nnz={A.nvals}) from "
        f"{start}: {depth} levels, route {routes['bfs_level']['route']} "
        f"(p_bits {routes['bfs_level']['p_bits']}, no retry); "
        f"fused.bfs_frontier {secs['bfs_frontier']:.4f} s "
        f"({depth / secs['bfs_frontier']:.1f} levels/s), "
        f"algorithms.bfs_level {secs['bfs_level']:.4f} s; levels equal the "
        f"closed form; lattice build {build_s:.1f} s, host CSR + upload "
        f"{csr_s:.1f} s (before the timed calls, which reuse it); card "
        f"{card}")
    return dict(n=n, nnz=A.nvals, levels=depth, seconds=secs,
                routes=routes, build_s=build_s, csr_s=csr_s)


def dnn_net(torch, nneurons, nlayers, nimages, device, seed=7):
    """run_fullscale's RadiX net, biases and images (testing.py)."""
    from pygraphblas_tpu_torch import Matrix, testing, types

    radices, w = testing.fullscale_radices(nneurons)
    n, layers = testing.radix_net(radices, nlayers, weight=w, seed=seed,
                                  device=device)
    biases = testing.build_biases(n, nlayers, -0.25, device=device)
    r, c, v = testing.fullscale_images(nimages, n, seed=seed)
    Y = Matrix.sparse(types.FP32, nimages, n, device=device)
    Y._build(r, c, v)
    return n, layers, biases, Y, (r, c, v)


def gdnn1024_path(torch, drv, card, nlayers=120, nimages=60000):
    """The GraphChallenge sparse DNN at its published width (1024
    neurons), 120 layers and 60,000 images (run_fullscale's RadiX net:
    weights 4/32, bias -0.25, image fill in [0, 0.3), seed 7):
    fused.dnn, then algorithms.dnn on the bitmap tier, each equal entry
    for entry to a float64 oracle on the card that applies the
    recurrence (product, bias on the product's pattern, ReLU, clip at
    32; every value a binary fraction, so float32 is exact), and their
    categories equal.  torch.matmul (no TF32) and torch ops: no kernel
    of the port."""
    from pygraphblas_tpu_torch import algorithms, fused

    t = time.perf_counter()
    n, layers, biases, Y, (r, c, v) = dnn_net(torch, 1024, nlayers,
                                              nimages, "cuda")
    build_s = time.perf_counter() - t
    secs = {}

    def run():
        t = time.perf_counter()
        F = fused.dnn(layers, biases, Y)
        torch.cuda.synchronize()
        secs["fused.dnn"] = time.perf_counter() - t
        t = time.perf_counter()
        D = algorithms.dnn(layers, biases, Y)
        torch.cuda.synchronize()
        secs["algorithms.dnn"] = time.perf_counter() - t
        return F, D

    F, D = drv.drive("gdnn1024", run, EXPECTED["gdnn1024"])
    t = time.perf_counter()
    y = torch.zeros((nimages, n), dtype=torch.float64, device="cuda")
    y[torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda()] = \
        torch.from_numpy(v.astype(np.float64)).cuda()
    for w in layers:
        wr, wc, wv = w._coo()
        W = torch.zeros((n, n), dtype=torch.float64, device="cuda")
        W[torch.from_numpy(wr).cuda(), torch.from_numpy(wc).cuda()] = \
            torch.from_numpy(wv.astype(np.float64)).cuda()
        p = y @ W
        y = torch.where(p != 0, p - 0.25, 0.0).clamp(0.0, 32.0)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t
    ok = {}
    for name, M in (("fused.dnn", F), ("algorithms.dnn", D)):
        vals, mask = M._dense_pair()
        ok[name] = bool(torch.equal(torch.where(mask, vals, 0.0).double(), y)
                        and torch.equal(mask, y != 0))
    cats = (y != 0).any(1)
    ncat = int(cats.sum())
    same_cats = all(bool(torch.equal(M._dense_pair()[1].any(1), cats))
                    for M in (F, D))
    entries = int((y != 0).sum())
    flops = 2.0 * nimages * n * n * nlayers
    log(f"gdnn1024: {nimages} images x {n} neurons x {nlayers} layers "
        f"({len(r)} image entries, {entries} output entries, {ncat} "
        f"categories): fused.dnn {secs['fused.dnn']:.4f} s "
        f"({flops / secs['fused.dnn'] / 1e12:.3f} TFLOP/s of dense "
        f"float32 matmul), algorithms.dnn (bitmap tier) "
        f"{secs['algorithms.dnn']:.4f} s; equal to the float64 oracle "
        f"entry for entry: {ok}; categories equal: {same_cats}; oracle "
        f"{oracle_s:.1f} s, net and images {build_s:.1f} s; card {card}")
    if not (all(ok.values()) and same_cats) or ncat in (0, nimages):
        raise AssertionError(f"gdnn1024: {ok}, categories {same_cats}, "
                             f"{ncat} categories")
    return dict(seconds=secs, oracle_s=oracle_s, build_s=build_s,
                image_entries=len(r), output_entries=entries,
                categories=ncat, dense_tflops=flops / secs["fused.dnn"]
                / 1e12)


def record_esc_calls(run, check=None):
    """run() with the inputs of every ESC call's kernels recorded (its
    product count F, the four segfold inputs, the esc_gather inputs), so
    that the path's counts hold only its own launches.  Without `check`
    every call keeps its inputs, to be checked after the run; with it,
    check(i, call) runs on each call's inputs as soon as esc_spgemm
    returns (outside ESC's own phase seconds), with its own launches
    taken back out of the counts and its seconds in call["check_s"], and
    the inputs are then dropped.  Returns (run's result, the calls)."""
    from pygraphblas_tpu_torch import _kernels as K
    from pygraphblas_tpu_torch.core import esc as E

    calls = []
    orig_s, orig_g, orig_d, orig_e = (E.segfold, E.esc_gather,
                                      E._esc_device, E.esc_spgemm)

    def settle():
        if check is None or not calls or "check_s" in calls[-1]:
            return
        call, t = calls[-1], time.perf_counter()
        before = dict(K.launches)
        E.segfold, E.esc_gather = orig_s, orig_g
        try:
            check(len(calls) - 1, call)
        finally:
            E.segfold, E.esc_gather = seg, gat
            K.launches.update(before)
        call.update(scans=[], gathers=[],
                    check_s=time.perf_counter() - t)

    def dev(*a, **kw):
        calls.append(dict(F=a[6], scans=[], gathers=[]))
        return orig_d(*a, **kw)

    def spgemm(*a, **kw):
        out = orig_e(*a, **kw)
        settle()
        return out

    def seg(v, f, add):
        calls[-1]["scans"].append((v, f, add))
        return orig_s(v, f, add)

    def gat(*a):
        calls[-1]["gathers"].append(a)
        return orig_g(*a)

    E.segfold, E.esc_gather, E._esc_device, E.esc_spgemm = (seg, gat, dev,
                                                            spgemm)
    try:
        out = run()
    finally:
        E.segfold, E.esc_gather, E._esc_device, E.esc_spgemm = (
            orig_s, orig_g, orig_d, orig_e)
    return out, calls


def spgemm_routes(run):
    """run() with the route of every unmasked product logged, in call
    order: "diag" (gustavson.spgemm's diagonal-B path), "dense" (the
    compact-dense tier), "esc", or "host" (scipy or the generic tier);
    Matrix._mxm_diag's (a known-diagonal operand) as "mxm_diag".
    Returns (run's result, the routes)."""
    from pygraphblas_tpu_torch import matrix as MX
    from pygraphblas_tpu_torch.core import esc as E, gustavson as G

    routes, dense_hits = [], []
    orig_sp, orig_dense, orig_diag = G.spgemm, G.dense_spgemm, \
        MX.Matrix._mxm_diag

    def dense(*a, **kw):
        out = orig_dense(*a, **kw)
        dense_hits.append(out is not None)
        return out

    def spgemm(ra, ca, va, rb, cb, vb, *a, **kw):
        e0, d0 = E.stats["calls"], len(dense_hits)
        out = orig_sp(ra, ca, va, rb, cb, vb, *a, **kw)
        if len(rb) and bool(np.all(rb == cb)):
            routes.append("diag")
        elif any(dense_hits[d0:]):
            routes.append("dense")
        elif E.stats["calls"] > e0:
            routes.append("esc")
        else:
            routes.append("host")
        return out

    def mxm_diag(self, *a, **kw):
        routes.append("mxm_diag")
        return orig_diag(self, *a, **kw)

    G.spgemm, G.dense_spgemm, MX.Matrix._mxm_diag = spgemm, dense, mxm_diag
    try:
        out = run()
    finally:
        G.spgemm, G.dense_spgemm, MX.Matrix._mxm_diag = (orig_sp, orig_dense,
                                                         orig_diag)
    return out, routes


def gdnn_coo_path(torch, ck, drv, card, nimages, nlayers=120):
    """algorithms.dnn and hyperdnn (over hypergraph(layers) and
    hypergraph(biases, diag=True)) on the COO tier (bitmap_max_cells =
    vector_max_cells = 1, as tests/test_dnn.py forces it), 1024 neurons,
    `nlayers` layers, `nimages` images (run_fullscale's network at that image
    count): each layer's products logged by route.  dnn's Y @ W takes
    the compact-dense tier (torch.matmul), its bias Matrix._mxm_diag;
    hyperdnn's Y @ HW takes ESC (4 segfold and 1 esc_gather a call;
    every call's launches held against their plain versions as the call
    ends, bit-exact over the live slots), its
    Y @ HB the diagonal-B path (the user-defined ReLU multiply on host
    arrays, on the CPU).  Categories equal to the scipy oracle of the
    recurrence; dnn's and hyperdnn's outputs equal."""
    from pygraphblas_tpu_torch import (Matrix, algorithms, options_set,
                                       testing, types)
    from pygraphblas_tpu_torch.core import esc as E

    t = time.perf_counter()
    options_set(bitmap_max_cells=1, vector_max_cells=1)
    try:
        n, layers, biases, Y, (r, c, v) = dnn_net(torch, 1024, nlayers,
                                                  nimages, "cuda")
        HW = algorithms.hypergraph(layers)
        HB = algorithms.hypergraph(biases, diag=True)
        Yh = Matrix.sparse(types.FP32, nimages, HW.ncols, device="cuda")
        Yh._build(r, c, v)
        build_s = time.perf_counter() - t
        secs, res = {}, {}

        def timed(name, call):
            t = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            return out

        D, routes_d = spgemm_routes(lambda: drv.drive(
            "gdnn_coo dnn", lambda: timed(
                "algorithms.dnn", lambda: algorithms.dnn(layers, biases, Y)),
            EXPECTED["gdnn_coo dnn"]))
        def check(i, call):
            if len(call["scans"]) != 4 or len(call["gathers"]) != 1:
                raise AssertionError(f"gdnn_coo: ESC call {i} made "
                                     f"{len(call['scans'])} scans and "
                                     f"{len(call['gathers'])} gathers")
            check_esc_kernels(torch, ck, "gdnn_coo", f"call {i} ",
                              call["scans"], call["gathers"], call["F"],
                              timed=False)

        ck.quiet = True
        try:
            (H, routes_h), calls = record_esc_calls(
                lambda: spgemm_routes(lambda: drv.drive_esc(
                    "gdnn_coo hyperdnn", lambda: timed(
                        "algorithms.hyperdnn",
                        lambda: algorithms.hyperdnn(nlayers, HW, HB, Yh)))),
                check=check)
        finally:
            ck.quiet = False
        res["esc_host_s"] = dict(E.stats["seconds"])
    finally:
        options_set(bitmap_max_cells=1 << 26, vector_max_cells=1 << 27)
    if len(calls) != drv.counts["gdnn_coo hyperdnn"]["esc_calls"]:
        raise AssertionError(f"gdnn_coo: {len(calls)} ESC calls recorded, "
                             f"{drv.counts['gdnn_coo hyperdnn']['esc_calls']}"
                             " counted")
    # every call was checked inside hyperdnn's timed window
    check_s = sum(x["check_s"] for x in calls)
    secs["algorithms.hyperdnn"] -= check_s
    nchk = sum(1 for row in ck.rows if row["path"] == "gdnn_coo")
    F_by_call = [int(x["F"]) for x in calls]
    del calls
    t = time.perf_counter()
    truth = testing.scipy_dnn_oracle(r, c, v, [w._coo() for w in layers],
                                     nimages, n, -0.25)
    oracle_s = time.perf_counter() - t
    cats = set(np.flatnonzero(np.diff(truth.indptr)).tolist())
    dr, dc, dv = D._coo()
    hr, hc, hv = H._coo()
    got = dict(dnn=set(dr.tolist()), hyperdnn=set(hr.tolist()))
    same = bool(np.array_equal(dr, hr) and np.array_equal(dc, hc - nlayers * n)
                and np.array_equal(dv, hv))

    def count(routes):
        out = {}
        for x in routes:
            out[x] = out.get(x, 0) + 1
        return out

    res.update(nimages=nimages, nlayers=nlayers, image_entries=len(r),
               output_entries=len(dr), categories=len(cats), seconds=secs,
               build_s=build_s, oracle_s=oracle_s, check_s=check_s,
               esc_checks=nchk, routes_dnn=count(routes_d),
               routes_hyperdnn=count(routes_h),
               esc_calls=len(F_by_call), F_max=max(F_by_call),
               F_first=F_by_call[:3],
               esc_launches={k: x for k, x in drv.counts[
                   "gdnn_coo hyperdnn"]["counts"].items() if x})
    log(f"gdnn_coo: COO tier, {nimages} images x {n} neurons x {nlayers} "
        f"layers ({len(r)} image entries, {len(dr)} output entries, "
        f"{len(cats)} categories): algorithms.dnn "
        f"{secs['algorithms.dnn']:.4f} s, routes {count(routes_d)}; "
        f"hyperdnn {secs['algorithms.hyperdnn']:.4f} s, routes "
        f"{count(routes_h)}; {len(F_by_call)} ESC calls (F up to "
        f"{res['F_max']}), launches {res['esc_launches']}, host seconds by "
        f"phase {res['esc_host_s']}; {nchk} checks of every ESC call's "
        f"launches against their plain versions as each call ended "
        f"({check_s:.1f} s, taken out of hyperdnn's); categories equal the scipy oracle's "
        f"({oracle_s:.1f} s): { {k: x == cats for k, x in got.items()} }; "
        f"dnn == hyperdnn: {same}; net {build_s:.1f} s; card {card}")
    if not (same and all(x == cats for x in got.values())) \
            or len(cats) in (0, nimages):
        raise AssertionError(f"gdnn_coo: outputs equal {same}, categories "
                             f"{ {k: x == cats for k, x in got.items()} }")
    return res


def gio_binfile(torch, drv, card, A):
    """Matrix.binwrite / binread of pr20's kron-20 matrix in a temporary
    directory the call deletes: the read-back matrix iseq the original;
    seconds and file bytes.  Host I/O and one iseq on the card."""
    import tempfile

    from pygraphblas_tpu_torch import Matrix

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "kron20.grb")

        def run():
            t = time.perf_counter()
            A.binwrite(path)
            w = time.perf_counter() - t
            t = time.perf_counter()
            B = Matrix.binread(path, device="cuda")
            return B, w, time.perf_counter() - t

        B, w_s, r_s = drv.drive("gio binfile", run, EXPECTED["gio binfile"])
        nbytes = os.path.getsize(path)
    same = bool(B.iseq(A))
    log(f"gio: binwrite of kron-20 ({A.nvals} entries, {A.type.__name__}) "
        f"{w_s:.4f} s, {nbytes} bytes; binread {r_s:.4f} s; iseq the "
        f"original: {same}; card {card}")
    if not same:
        raise AssertionError("gio: binread of kron-20 differs")
    return dict(entries=A.nvals, write_s=w_s, read_s=r_s, bytes=nbytes)


def gio_mm(torch, drv, card, A):
    """Matrix.to_mm / from_mm of bfs18's kron-18 matrix (BOOL: a pattern
    file) through the port's native parser (csrc/fastio.cpp, built with
    g++ at first use) in a temporary directory the call deletes: the
    read-back matrix iseq the original."""
    import tempfile

    from pygraphblas_tpu_torch import Matrix
    from pygraphblas_tpu_torch.io import native

    t = time.perf_counter()
    native.lib()
    build_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "kron18.mtx")

        def run():
            t = time.perf_counter()
            with open(path, "w") as f:
                A.to_mm(f)
            w = time.perf_counter() - t
            t = time.perf_counter()
            B = Matrix.from_mm(path, device="cuda")
            return B, w, time.perf_counter() - t

        B, w_s, r_s = drv.drive("gio mm", run, EXPECTED["gio mm"])
        nbytes = os.path.getsize(path)
    same = bool(B.iseq(A))
    log(f"gio: to_mm of kron-18 ({A.nvals} entries, BOOL pattern) "
        f"{w_s:.4f} s, {nbytes} bytes; from_mm (native parser, built in "
        f"{build_s:.1f} s) {r_s:.4f} s; iseq the original: {same}; card "
        f"{card}")
    if not same:
        raise AssertionError("gio: from_mm of kron-18 differs")
    return dict(entries=A.nvals, write_s=w_s, read_s=r_s, bytes=nbytes,
                native_build_s=build_s)


# ---------------------------------------------------------------------------
# slice 13: the distributed tier (parallel/dist.py) in a world of one over
# NCCL on a (1, 1) mesh; it launches no hand kernel (torch ops and
# collectives), and each path is driven with the kernel counters at 0 to
# show it
# ---------------------------------------------------------------------------


def gd_call(torch, call):
    """One call of the tier: (result, wall s, the tier's seconds by phase,
    the bytes it placed on the card)."""
    from pygraphblas_tpu_torch.parallel import dist as pdist

    pdist.seconds.clear()
    pdist.held_bytes.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t, dict(pdist.seconds),
            dict(pdist.held_bytes))


def gd_calls(torch, drv, path, calls):
    """Drive a path's calls ((name, call) pairs) with the counters at 0;
    no kernel may launch."""
    return drv.drive(path, lambda: [gd_call(torch, c) for _, c in calls], {})


def gd_line(path, name, wall, secs, nbytes, card, note=""):
    host = sum(secs.get(k, 0.0) for k in ("balance", "tiling", "ring_host"))
    log(f"  {path} {name}: {wall:.4f} s; host {host:.4f} s (balance "
        f"{secs.get('balance', 0.0):.4f}, tiling {secs.get('tiling', 0.0):.4f}"
        f", ring host {secs.get('ring_host', 0.0):.4f}), device loop "
        f"{secs.get('device', 0.0):.4f} s; on the card {nbytes} bytes; "
        f"{note}card {card}")
    return dict(seconds=wall, host_s=host, phase_s=secs, bytes=nbytes)


def same_coo(got, want, rtol=None):
    """Indices equal; values equal, or within rtol of the want's."""
    *gi, gv = got
    *wi, wv = want
    if not all(np.array_equal(a, b) for a, b in zip(gi, wi)):
        return False
    if rtol is None:
        return np.array_equal(gv, wv)
    return bool(np.all(np.abs(gv - wv) <= rtol * np.abs(wv)))


def gdpr20_path(torch, drv, card, mesh, kron20, ref, pr20_ms, iters=20):
    """A.shard(mesh).pagerank and dist_pagerank on pr20's kron-20 matrix,
    20 iterations each, within 1e-3 x the largest rank of fused.pagerank's
    20 iterations (`ref`); ms an iteration = the device loop's seconds
    (the loop, the d_inv upload, the final gather) / iterations."""
    from pygraphblas_tpu_torch import types
    from pygraphblas_tpu_torch.generators import to_matrix
    from pygraphblas_tpu_torch.parallel import dist as pdist

    rows, cols, n = kron20
    A = to_matrix(rows, cols, n, types.FP32)
    lim = 1e-3 * float(np.abs(ref).max())
    calls = (("shard.pagerank", lambda: A.shard(mesh).pagerank(
        itermax=iters, tol=0).to_numpy()),
             ("dist_pagerank", lambda: pdist.dist_pagerank(
                 mesh, n, rows, cols, itermax=iters, tol=0)))
    res = {}
    for (name, _), (r, wall, secs, nb) in zip(
            calls, gd_calls(torch, drv, "gdpr20", calls)):
        err = float(np.abs(r - ref).max())
        if r.shape != (n,) or not np.isfinite(r).all() or not err < lim:
            raise AssertionError(f"gdpr20 {name}: max |dist - fused| {err} "
                                 f"(limit {lim}), shape {r.shape}")
        ms = secs["device"] / iters * 1e3
        res[name] = gd_line(
            "gdpr20", name, wall, secs, nb, card,
            f"max |dist - fused| {err:.3e} (limit {lim:.3e}); {ms:.4f} ms "
            f"an iteration (pr20's fused loop {pr20_ms:.4f}); ")
        res[name].update(max_abs_err=err, ms_per_iteration=ms,
                         iterations=iters)
    return res


def gdsp18_path(torch, drv, card, mesh, kron18, wts, s0, want):
    """bfs_level and sssp from s0 on bfs18's and sssp18's kron-18
    matrices, equal to gsp18's levels and distances (`want`: its
    algorithms.sssp and bfs_level_vxm from s0)."""
    from pygraphblas_tpu_torch import types
    from pygraphblas_tpu_torch.generators import to_matrix

    rows, cols, n = kron18
    A = to_matrix(rows, cols, n, types.BOOL)
    Aw = to_matrix(rows, cols, n, types.FP32, vals=wts)
    want_d, want_l = want
    calls = (("bfs_level", lambda: A.shard(mesh).bfs_level(s0)._coo()),
             ("sssp", lambda: Aw.shard(mesh).sssp(s0)._coo()))
    res = {}
    for (name, _), w, (v, wall, secs, nb) in zip(
            calls, (want_l._coo(), want_d._coo()),
            gd_calls(torch, drv, "gdsp18", calls)):
        if not same_coo(v, w):
            raise AssertionError(f"gdsp18 {name} from {s0} differs from "
                                 "gsp18's")
        res[name] = gd_line("gdsp18", name, wall, secs, nb, card,
                            f"from {s0}: {len(v[0])} reached, equal to "
                            "gsp18's; ")
        res[name]["reached"] = len(v[0])
    return res


def gdtc16_path(torch, drv, card, mesh, kron16s, tc16_count):
    """triangle_count on tc16's graph (equal to tc16's count), k_truss(4)
    on kt14's (equal to algorithms.k_truss), and mxm(W, mask=W) on
    val16's weighted L under FP32 PLUS_TIMES (within 1e-5 relative) and
    INT32 MIN_PLUS (exact), against masked_spgemm's val16 calls."""
    from pygraphblas_tpu_torch import algorithms, types
    from pygraphblas_tpu_torch.core import spgemm as SG
    from pygraphblas_tpu_torch.generators import to_matrix

    rows, cols, n = kron16s
    S = to_matrix(rows, cols, n, types.INT64)
    r14, c14, n14 = graph(14, sym=True)
    K = to_matrix(r14, c14, n14, types.INT64)
    kt_want = algorithms.k_truss(K, 4)._coo()
    W = degree_lower(*kron16s)
    W.data = np.random.RandomState(7).randint(1, 5, W.nnz).astype(np.float64)
    lr, lc, lv = csr_coo(W)
    tr, tc, tv = csr_coo(W.T)
    sems = (("FP32.PLUS_TIMES", types.FP32.PLUS_TIMES, types.FP32,
             np.float32, 1e-5),
            ("INT32.MIN_PLUS", types.INT32.MIN_PLUS, types.INT32, np.int32,
             None))
    wants, mats = {}, {}
    for name, sem, typ, dt, _ in sems:
        wants[name] = SG.masked_spgemm(lr, lc, lv.astype(dt), tr, tc,
                                       tv.astype(dt), lr, lc, sem, dt)
        mats[name] = to_matrix(lr, lc, n, typ, vals=lv.astype(dt))
    calls = [("triangle_count", lambda: S.shard(mesh).triangle_count()),
             ("k_truss", lambda: K.shard(mesh).k_truss(4)._coo())]
    for name, sem, _, _, _ in sems:
        calls.append((f"mxm {name}", lambda M=mats[name], sem=sem: M.shard(
            mesh).mxm(M, semiring=sem, mask=M)._coo()))
    got = gd_calls(torch, drv, "gdtc16", calls)
    res = {}
    (ntri, *t_tc), (kt, *t_kt), *mxm = got
    if ntri != tc16_count:
        raise AssertionError(f"gdtc16: {ntri} triangles, tc16 {tc16_count}")
    res["triangle_count"] = gd_line("gdtc16", "triangle_count", *t_tc, card,
                                    f"{ntri} triangles = tc16's; ")
    if not same_coo(kt, kt_want):
        raise AssertionError("gdtc16: k_truss(4) differs from "
                             "algorithms.k_truss")
    res["k_truss"] = gd_line("gdtc16", "k_truss", *t_kt, card,
                             f"keeps {len(kt[0])} of {len(r14)} edges = "
                             "algorithms.k_truss; ")
    for (name, _, _, _, rtol), (c, *t_m) in zip(sems, mxm):
        if not same_coo(c, wants[name], rtol):
            raise AssertionError(f"gdtc16: mxm {name} differs from "
                                 "masked_spgemm")
        res[f"mxm {name}"] = gd_line(
            "gdtc16", f"mxm {name}", *t_m, card,
            f"{len(c[0])} entries = masked_spgemm's "
            f"({'exact' if rtol is None else f'rtol {rtol}'}); ")
    return res


def gdmxv_path(torch, drv, card, mesh, kron18):
    """DistMatrix.mxv on kron-18 under FP32 PLUS_TIMES, INT32 MIN_PLUS,
    UINT32 BOR_BAND (the per-bit collective) and INT32 MIN_FIRSTI1 (a
    positional mul, on a shard without the balance relabel, whose ids a
    positional mul would report), each against Matrix.mxv on the card:
    FP32 within 1e-5 relative, the integers exact."""
    from pygraphblas_tpu_torch import Vector, types
    from pygraphblas_tpu_torch.generators import to_matrix

    rows, cols, n = kron18
    rng = np.random.RandomState(11)
    nnz = len(rows)
    u32 = lambda k: rng.randint(0, 1 << 32, k, dtype=np.uint64).astype(
        np.uint32)
    cases = (("FP32.PLUS_TIMES", types.FP32,
              rng.randint(1, 256, nnz).astype(np.float32),
              rng.rand(n).astype(np.float32), True, 1e-5),
             ("INT32.MIN_PLUS", types.INT32,
              rng.randint(1, 256, nnz).astype(np.int32),
              rng.randint(0, 1000, n).astype(np.int32), True, None),
             ("UINT32.BOR_BAND", types.UINT32, u32(nnz), u32(n), True, None),
             ("INT32.MIN_FIRSTI1", types.INT32, np.ones(nnz, np.int32),
              rng.randint(0, 1000, n).astype(np.int32), False, None))
    wants, calls = {}, []
    for name, typ, v, x, bal, _ in cases:
        sem = getattr(typ, name.split(".")[1])
        M = to_matrix(rows, cols, n, typ, vals=v)
        xv = Vector.sparse(typ, n)
        xv._build(np.arange(n, dtype=np.int64), x)
        wants[name] = M.mxv(xv, semiring=sem)._coo()
        calls.append((name, lambda M=M, x=x, sem=sem, bal=bal: M.shard(
            mesh, balance=bal).mxv(x, semiring=sem)._coo()))
    res = {}
    for (name, *_, rtol), (y, *t) in zip(
            cases, gd_calls(torch, drv, "gdmxv", calls)):
        if not same_coo(y, wants[name], rtol):
            raise AssertionError(f"gdmxv {name}: differs from Matrix.mxv")
        res[name] = gd_line("gdmxv", name, *t, card,
                            f"{len(y[0])} rows = Matrix.mxv's "
                            f"({'exact' if rtol is None else f'rtol {rtol}'})"
                            "; ")
    return res


def gdckpt_path(torch, drv, card, mesh, kron18):
    """dist_pagerank on kron-18: 10 iterations with a snapshot every 5,
    then resumed to 20.  Gates: the resumed run starts from the
    snapshot's ranks bit for bit (a resume to 10 runs no iteration and
    returns them; the 10-iteration run returned the same), and ends
    equal bit for bit to an uninterrupted 20-iteration run, as two
    uninterrupted runs are (a gate of 1e-6 relative, tightened: the
    float folds run each row in order)."""
    import shutil
    import tempfile

    from pygraphblas_tpu_torch.parallel import dist as pdist

    rows, cols, n = kron18
    d = tempfile.mkdtemp(prefix="gdckpt_")
    ck = os.path.join(d, "pagerank.npz")
    kw = dict(tol=0, checkpoint_path=ck, checkpoint_every=5)
    try:
        calls = (("uninterrupted 20", lambda: pdist.dist_pagerank(
            mesh, n, rows, cols, itermax=20, tol=0)),
                 ("10, snapshots at 5 and 10", lambda: pdist.dist_pagerank(
                     mesh, n, rows, cols, itermax=10, **kw)),
                 ("resume to 10", lambda: pdist.dist_pagerank(
                     mesh, n, rows, cols, itermax=10, **kw)),
                 ("resume to 20", lambda: pdist.dist_pagerank(
                     mesh, n, rows, cols, itermax=20, **kw)),
                 ("uninterrupted 20 again", lambda: pdist.dist_pagerank(
                     mesh, n, rows, cols, itermax=20, tol=0)))
        got = gd_calls(torch, drv, "gdckpt", calls)
        snap = np.load(ck)
        step, snap_r = int(snap["__step__"]), snap["r"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    (full, *t_full), (part, *t_part), (start, *t_start), (res20, *t_res), \
        (again, *t_again) = got
    perm = np.random.RandomState(0x5EED).permutation(n)
    if step != 20:
        raise AssertionError(f"gdckpt: the last snapshot is of step {step}")
    # the snapshot of step 10 was overwritten by the resumed run's; its
    # ranks are what "resume to 10" returned, as the 10-iteration run did
    if not np.array_equal(start, part):
        raise AssertionError("gdckpt: the resume does not start from the "
                             "snapshot's ranks bit for bit")
    if not np.array_equal(snap_r[perm], res20):
        raise AssertionError("gdckpt: the last snapshot is not the resumed "
                             "run's result")
    # the tiles' float folds run each row in order (segment_reduce), so
    # a 1e-6 relative gate is tightened to bit equality
    rel = float(np.max(np.abs(res20 - full) / np.abs(full)))
    bits = dict(resumed_vs_uninterrupted=bool(np.array_equal(res20, full)),
                two_uninterrupted_runs=bool(np.array_equal(full, again)))
    if not all(bits.values()):
        raise AssertionError(f"gdckpt: not bit for bit: {bits}; resumed "
                             f"run {rel:.3e} relative from the "
                             "uninterrupted run")
    res = {}
    for name, t in (("uninterrupted 20", t_full),
                    ("10, snapshots at 5 and 10", t_part),
                    ("resume to 10", t_start), ("resume to 20", t_res),
                    ("uninterrupted 20 again", t_again)):
        res[name] = gd_line("gdckpt", name, *t, card)
    log(f"  gdckpt: resume starts from the snapshot's ranks bit for bit; "
        f"resumed vs uninterrupted max relative {rel:.3e}; bit for bit: "
        f"{bits}; card {card}")
    res.update(max_rel_err=rel, bit_equal=bits)
    return res


def gd_phase(torch, drv, card, kron20, pr20_ref, pr20_ms, kron18, wts18, s0,
             gsp18, kron16s, tc16_count):
    """make_mesh() with no device: a world of one over NCCL, a (1, 1)
    mesh on the card; the five distributed paths; the process group
    destroyed at the end.  Returns (results, seconds a path)."""
    import torch.distributed as dist

    from pygraphblas_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mesh = make_mesh()
    if (dist.get_backend() != "nccl" or mesh.device_type != "cuda"
            or tuple(mesh.shape) != (1, 1)):
        raise AssertionError(f"gd: make_mesh() gave {mesh} over "
                             f"{dist.get_backend()}")
    t_mesh = time.perf_counter() - t0
    # NCCL sets its communicators up at their first collective: one
    # all_reduce a group, timed apart from the paths
    t0 = time.perf_counter()
    for group in (None, mesh.get_group("i"), mesh.get_group("j")):
        dist.all_reduce(torch.ones(1, device="cuda"), group=group)
    torch.cuda.synchronize()
    t_nccl = time.perf_counter() - t0
    log(f"gd: make_mesh() {t_mesh:.2f} s: a world of "
        f"{dist.get_world_size()} over {dist.get_backend()}, mesh "
        f"{tuple(mesh.shape)} {mesh.mesh_dim_names} on {mesh.device_type}; "
        f"first collectives (NCCL set-up) {t_nccl:.2f} s; card {card}")
    res, secs = {}, {}
    try:
        for path, run in (
                ("gdpr20", lambda: gdpr20_path(torch, drv, card, mesh, kron20,
                                               pr20_ref, pr20_ms)),
                ("gdsp18", lambda: gdsp18_path(torch, drv, card, mesh, kron18,
                                               wts18, s0, gsp18)),
                ("gdtc16", lambda: gdtc16_path(torch, drv, card, mesh,
                                               kron16s, tc16_count)),
                ("gdmxv", lambda: gdmxv_path(torch, drv, card, mesh, kron18)),
                ("gdckpt", lambda: gdckpt_path(torch, drv, card, mesh,
                                               kron18))):
            t = time.perf_counter()
            res[path] = run()
            secs[path] = time.perf_counter() - t
            log(f"  {path}: {secs[path]:.1f} s in all; card {card}")
    finally:
        dist.destroy_process_group()
    return res, secs


def gallery_phase(torch, drv, card):
    """Slice 14: the user-facing entry points on the card, each with the
    kernel counters at 0 just before it and read just after (its
    launches land in drv.counts as "gallery <name>"): run_doctests()
    (0 failures, at least GALLERY_MIN_EXAMPLES tried), every
    demo_torch/NN_*.py main (each must print OK last), the GraphChallenge
    harness (its synthetic net, and a small dataset in the challenge's
    layout against its truth file), gap_torch/bcmark.py at its defaults
    and gap_torch/prmark.py --scale 18 --rounds 2, driven: every xspmv
    kernel of its plan launched EXPECTED["gprmark18"] times an xspmv
    call.  Each entry point's output goes to chiprun_out/
    chip_smoke_gallery.log.  Returns {entry point: its record}."""
    import contextlib
    import doctest
    import importlib.util
    import io
    import tempfile

    import pygraphblas_tpu_torch as T
    from pygraphblas_tpu_torch import _kernels as K, testing
    from demo_torch.dnn import challenge
    from gap_torch import bcmark, prmark

    out = {}
    logf = open(os.path.join(OUT_DIR, "chip_smoke_gallery.log"), "w")

    def entry(name, call, record=True):
        torch.cuda.synchronize()
        K.reset_launches()
        buf = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = call()
            torch.cuda.synchronize()
        finally:
            logf.write(f"==== {name}\n{buf.getvalue()}\n")
            logf.flush()
        secs = time.perf_counter() - t
        counts = dict(K.launches)
        if record:              # (a driven path records its own)
            drv.counts[f"gallery {name}"] = dict(counts=counts)
        text = buf.getvalue().strip().splitlines()
        out[name] = dict(seconds=secs,
                         launches={k: c for k, c in counts.items() if c},
                         last_line=text[-1] if text else "")
        log(f"  {name}: {secs:.2f} s; hand kernels "
            f"{out[name]['launches'] or 'none'}; card {card}")
        return res, buf.getvalue()

    try:
        # the docstring examples, on the card (their default device)
        tried = {}
        orig = doctest.testmod

        def counting(mod, **kw):
            r = orig(mod, **kw)
            tried[mod.__name__] = (r.attempted, r.failed)
            return r

        doctest.testmod = counting
        try:
            failed, text = entry("run_doctests", T.run_doctests)
        finally:
            doctest.testmod = orig
        attempted = sum(a for a, _ in tried.values())
        out["run_doctests"].update(failed=failed, attempted=attempted,
                                   by_module=tried)
        log(f"    {attempted} examples tried, {failed} failed: {tried}"
            + ("" if "pygraphblas_tpu_torch.gviz" in tried else
               "; gviz's examples not run (graphviz or PIL absent)"))
        if failed or attempted < GALLERY_MIN_EXAMPLES:
            raise AssertionError(f"gallery: run_doctests() on the card: "
                                 f"{failed} of {attempted} failed:\n"
                                 f"{text[-3000:]}")

        # the demo gallery
        demos = sorted(f for f in os.listdir(os.path.join(HERE, "demo_torch"))
                       if f[:2].isdigit() and f.endswith(".py"))
        for f in demos:
            spec = importlib.util.spec_from_file_location(
                "demo_torch_" + f[:-3], os.path.join(HERE, "demo_torch", f))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            entry(f[:-3], lambda: mod.main(["--device", "cuda"]))
            if out[f[:-3]]["last_line"] != "OK":
                raise AssertionError(f"gallery: {f} ended with "
                                     f"{out[f[:-3]]['last_line']!r}")

        # the GraphChallenge harness: the synthetic net, and a small
        # dataset in the challenge's layout
        syn, _ = entry("challenge synthetic",
                       lambda: challenge.main(["--device", "cuda"]))
        if syn.nvals == 0 or syn._dense_pair()[0].device.type != "cuda":
            raise AssertionError("gallery: the synthetic net gave nothing "
                                 "on the card")
        with tempfile.TemporaryDirectory() as d:
            truth = testing.write_challenge_dataset(
                d, 1024, 3, 64, challenge.BIAS[1024])
            entry("challenge dataset", lambda: challenge.main(
                ["--ndir", d, "--nneurons", "1024", "--nlayers", "3",
                 "--device", "cuda"]))
        out["challenge dataset"]["categories"] = len(truth)

        # the GAP drivers
        bstats, pstats = {}, {}
        bc, _ = entry("bcmark", lambda: bcmark.run(
            bcmark.parser().parse_args([]), bstats))
        if not bool(torch.isfinite(bc._dense_pair()[0]).all()):
            raise AssertionError("gallery: bcmark's centrality not finite")
        out["bcmark"].update(bstats)
        args = prmark.parser().parse_args(["--scale", "18", "--rounds", "2"])
        pr, _ = entry("prmark", lambda: drv.drive(
            "gprmark18", lambda: prmark.run(args, pstats),
            EXPECTED["gprmark18"]), record=False)
        vals = pr._dense_pair()[0]
        if vals.shape != (1 << 18,) or not bool(torch.isfinite(vals).all()):
            raise AssertionError("gallery: prmark's ranks not finite of "
                                 "shape (2^18,)")
        rounds = pstats["rounds_s"]
        out["prmark"].update(
            pstats, xspmv_calls=drv.counts["gprmark18"]["xspmv_calls"],
            nnz_per_s=[pstats["nnz"] / r for r in rounds])
        log(f"    prmark kron-18: rounds {rounds} s, "
            f"{pstats['nnz']} entries, nnz/s "
            + ", ".join(f"{pstats['nnz'] / r:.6e}" for r in rounds)
            + f" ({drv.counts['gprmark18']['xspmv_calls']} xspmv); "
            f"card {card}")
    finally:
        logf.close()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200,
                    help="timed PageRank iterations at kron-20")
    ap.add_argument("--iters21", type=int, default=20,
                    help="timed PageRank iterations at kron-21")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pygraphblas_tpu_torch import _kernels, _native, fused, types
    from pygraphblas_tpu_torch.generators import to_matrix

    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    phase_s = {}

    # 1. the card
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    # 2. the build
    t0 = time.perf_counter()
    _kernels.lib()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    _native.lib()
    t_gxx = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_kernels.build_log)
    log(f"build: CUDA kernels {t_nvcc:.1f} s (nvcc sm_90a, one process a "
        f"source), benes routing {t_gxx:.1f} s (g++); card {card}")
    log("  seconds a source: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(_kernels.build_seconds.items(),
                                          key=lambda kv: -kv[1])))
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "stack" in line or line.startswith("=="):
            log("  " + line.strip())
    phase_s["build"] = time.perf_counter() - t_start

    ck = Checks(torch, args.reps)
    drv = PathRunner(torch, card)
    sem_pr = types.FP32.PLUS_SECOND
    e2e = {}
    in_path = {}

    def ab(path, run):
        e2e[path]["cascade_ab"] = r = cascade_ab(torch, run)
        k = ck.cascade_vs_chain[path]
        log(f"  {path} cascade vs chain: wall {r['cascade_s']:.6f} vs "
            f"{r['chain_s']:.6f} s (runs {r['runs']}); kernels "
            f"{k['cascade_ms']:.4f} vs {k['chain_ms']:.4f} ms; card {card}")

    def pagerank_path(path, scale, iters, best_of):
        t0 = time.perf_counter()
        rows, cols, n = graph(scale)
        nnz = len(rows)
        A = to_matrix(rows, cols, n, types.FP32)
        t_gen = time.perf_counter() - t0
        log(f"{path}: kron-{scale} ef16 n={n} nnz={nnz} ({t_gen:.1f} s)")
        plan = plan_for(A, True, path)
        per = EXPECTED[path]
        w = torch.from_numpy((np.random.RandomState(1).rand(n) * 1e-6)
                             .astype(np.float32)).cuda()
        check_xspmv_kernels(torch, ck, plan, w, sem_pr, path,
                            timed=[k for k, p in TIMED.items() if p == path]
                            + ["inner3"])
        # correctness: 5 iterations against the planless COO oracle
        r5 = fused.pagerank(A, itermax=5, tol=0.0)
        rows_d, cols_d, _ = A._device_coo("cuda")
        d_inv = fused._d_inv(fused._deg_vec(A, "cuda"), 0.85)
        ref, _, _ = fused._pagerank_loop_coo(rows_d, cols_d, n, 5, d_inv,
                                             np.float32(0.15 / n), 0.0)
        err = float((r5._vals - ref).abs().max())
        scale_r = float(ref.abs().max())
        log(f"  integrity: max |fused - coo| = {err:.3e} (max rank "
            f"{scale_r:.3e}, limit {1e-3 * scale_r:.3e})")
        if not err < 1e-3 * scale_r:
            raise AssertionError(f"{path}: fused pagerank diverges from "
                                 f"the planless oracle by {err}")
        times = []
        for _ in range(best_of):
            t0 = time.perf_counter()
            r = drv.drive(path, lambda: fused.pagerank(A, itermax=iters,
                                                       tol=-1.0), per)
            times.append(time.perf_counter() - t0)
        if r._vals.shape != (n,) or not bool(torch.isfinite(r._vals).all()):
            raise AssertionError(f"{path}: result not finite of shape (n,)")
        el = min(times)
        e2e[path] = dict(ms_per_iteration=el / iters * 1e3,
                         nnz_per_s=nnz * iters / el, iterations=iters,
                         runs_s=times, nnz=nnz, graph_s=t_gen)
        log(f"  {path}: {iters} iterations, best of {best_of} {el:.4f} s "
            f"({times}); {nnz * iters / el:.6e} nnz/s; "
            f"{el / iters * 1e3:.4f} ms/iteration; card {card}")
        in_path[path] = profile_path(
            torch, drv, lambda: fused.pagerank(A, itermax=5, tol=-1.0), path)
        if per.get("mono_cascade"):
            ab(path, lambda: fused.pagerank(A, itermax=iters, tol=-1.0))
        return A, rows, cols, n

    # 3a. PageRank at kron-20: the first slice's path, now through the
    # cascade
    t0 = time.perf_counter()
    A, rows, cols, n = pagerank_path("pr20", 20, args.iters, 3)
    # yardsticks timed here only: the COO oracle loop (index_add_) and
    # one CSR SpMV of A^T through torch.sparse
    rows_d, cols_d, _ = A._device_coo("cuda")
    d_inv = fused._d_inv(fused._deg_vec(A, "cuda"), 0.85)
    t1 = time.perf_counter()
    fused._pagerank_loop_coo(rows_d, cols_d, n, args.iters, d_inv,
                             np.float32(0.15 / n), -1.0)
    torch.cuda.synchronize()
    coo_ms = (time.perf_counter() - t1) / args.iters * 1e3
    At = torch.sparse_coo_tensor(
        torch.stack([cols_d.long(), rows_d.long()]),
        torch.ones(len(rows), device="cuda"), (n, n)).coalesce() \
        .to_sparse_csr()
    w = torch.rand(n, device="cuda")
    lib_spmv_ms = event_ms(torch, lambda: At @ w, args.reps,
                           behind_sleep=False)
    log(f"  yardsticks: COO index_add_ loop {coo_ms:.4f} ms/iteration; "
        f"torch CSR SpMV (A^T w) {lib_spmv_ms:.4f} ms")
    e2e["pr20"].update(coo_ms_per_iteration=coo_ms,
                       torch_csr_spmv_ms=lib_spmv_ms)
    # the distributed tier's yardstick (gdpr20): fused.pagerank's first 20
    # iterations on the same matrix
    pr20_ref20 = fused.pagerank(A, itermax=20, tol=-1.0)._vals.cpu().numpy()
    kron20 = (rows, cols, n)
    del At, rows_d, cols_d, rows, cols
    phase_s["pr20"] = time.perf_counter() - t0

    # 3a'. the container API's PageRank on pr20's matrix and plan
    t0 = time.perf_counter()
    e2e["gpr20"] = gpr20_path(torch, drv, card, A, n,
                              e2e["pr20"]["ms_per_iteration"])
    phase_s["gpr20"] = time.perf_counter() - t0

    # 3a''. extract and assign over index sets on the same matrix
    t0 = time.perf_counter()
    e2e["gx20"] = gx20_path(torch, drv, card, A, n)
    phase_s["gx20"] = time.perf_counter() - t0

    # 3a (iii). the binary checkpoint of the same matrix
    t0 = time.perf_counter()
    e2e["gio"] = dict(binfile=gio_binfile(torch, drv, card, A))
    del A
    phase_s["gio binfile"] = time.perf_counter() - t0

    # 3b. PageRank at kron-21: level 1 streams, mono_rows, no cascade
    t0 = time.perf_counter()
    A, rows, cols, n = pagerank_path("pr21", 21, args.iters21, 1)
    del A, rows, cols
    phase_s["pr21"] = time.perf_counter() - t0

    # 3c. BFS at kron-18 ef16 BOOL (bench.py:316-350)
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    t0 = time.perf_counter()
    rows, cols, n = graph(18)
    nnz = len(rows)
    A = to_matrix(rows, cols, n, types.BOOL)
    log(f"bfs18: kron-18 ef16 n={n} nnz={nnz}")
    plan = plan_for(A, True, "bfs18")
    per = EXPECTED["bfs18"]
    f0 = torch.zeros(n, device="cuda")
    f0[:: 97] = 1.0
    # lane_gather_tasc too: its launches here run without the fold
    check_xspmv_kernels(torch, ck, plan, f0, types.FP32.MAX_SECOND, "bfs18",
                        timed=[k for k, p in TIMED.items() if p == "bfs18"]
                        + ["lane_gather_tasc"])
    lane_lib_ms = lane_gather_isolated(torch, ck, plan.perm.R0)
    srcs = list(range(16))
    fused.bfs_batch(A, srcs)                    # warm
    drv.calls = 0
    t1 = time.perf_counter()
    fused.bfs_batch(A, srcs)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t1
    bfs_calls = drv.calls
    lvb, lv0 = drv.drive("bfs18", lambda: (fused.bfs_batch(A, srcs),
                                           fused.bfs_level(A, 0)), per)
    if not torch.equal(lvb[0].to(torch.int64), lv0._vals):
        raise AssertionError("bfs18: batch[0] != bfs_level(0)")
    G = sp.csr_matrix((np.ones(nnz, np.float32), (rows, cols)), (n, n))
    dist = csgraph.shortest_path(G, directed=True, unweighted=True,
                                 indices=srcs)
    want = np.where(np.isfinite(dist), dist + 1, 0).astype(np.int32)
    got = lvb.cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"bfs18: levels differ from scipy in "
                             f"{int((got != want).sum())} places")
    e2e["bfs18"] = dict(sources=16, seconds=t_batch,
                        edges_per_s=16 * nnz / t_batch,
                        xspmv_calls=bfs_calls,
                        ms_per_xspmv=t_batch / bfs_calls * 1e3,
                        reached_per_source=(got > 0).sum(axis=1).tolist(),
                        depth=int(got.max()))
    log(f"  bfs18: 16 sources {t_batch:.4f} s, {16 * nnz / t_batch:.6e} "
        f"edges/s (K*nnz/s), {bfs_calls} xspmv, "
        f"{t_batch / bfs_calls * 1e3:.4f} ms per xspmv step; levels equal "
        f"scipy's exactly; card {card}")
    in_path["bfs18"] = profile_path(torch, drv,
                                    lambda: fused.bfs_batch(A, srcs), "bfs18")
    ab("bfs18", lambda: fused.bfs_batch(A, srcs))

    # 3d. SSSP at kron-18 ef16, GAP's integer weights 1..255, from the
    # vertex of most out-edges (a third of kron's vertices have none)
    wts = np.random.RandomState(7).randint(1, 256, nnz).astype(np.float32)
    Aw = to_matrix(rows, cols, n, types.FP32, vals=wts)
    s0 = int(np.argmax(np.bincount(rows, minlength=n)))
    log(f"sssp18: kron-18 ef16, FP32 weights 1..255, source {s0}")
    planw = plan_for(Aw, True, "sssp18")
    sem_s = types.FP32.MIN_PLUS
    per = EXPECTED["sssp18"]
    d0 = torch.full((n,), float("inf"), device="cuda")
    d0[:: 89] = 3.0
    check_xspmv_kernels(torch, ck, planw, d0, sem_s, "sssp18")
    fused.sssp(Aw, s0)                          # warm
    t1 = time.perf_counter()
    dv = drv.drive("sssp18", lambda: fused.sssp(Aw, s0), per)
    t_sssp = time.perf_counter() - t1
    s_calls = drv.counts["sssp18"]["xspmv_calls"]
    Gw = sp.csr_matrix((wts, (rows, cols)), (n, n))
    want = csgraph.dijkstra(Gw, directed=True, indices=s0)
    got = dv._vals.cpu().numpy()
    mask = dv._mask.cpu().numpy()
    if not (np.array_equal(mask, np.isfinite(want))
            and np.array_equal(got[mask], want[mask].astype(np.float32))):
        raise AssertionError("sssp18: distances differ from scipy")
    e2e["sssp18"] = dict(source=s0, seconds=t_sssp, xspmv_calls=s_calls,
                         ms_per_xspmv=t_sssp / s_calls * 1e3,
                         edges_per_s=nnz * s_calls / t_sssp,
                         reached=int(mask.sum()))
    log(f"  sssp18: {t_sssp:.4f} s, {s_calls} xspmv, "
        f"{t_sssp / s_calls * 1e3:.4f} ms per step, "
        f"{nnz * s_calls / t_sssp:.6e} nnz/s; distances equal scipy's "
        f"exactly; card {card}")
    ab("sssp18", lambda: fused.sssp(Aw, s0))
    del G, Gw, plan, planw
    kron18 = (rows, cols, n)
    phase_s["bfs18+sssp18"] = time.perf_counter() - t0

    # 3d'. the container API's SSSP and BFS (vxm) on the same matrices
    t0 = time.perf_counter()
    e2e["gsp18"] = gsp18_path(torch, drv, card, A, Aw, s0)
    phase_s["gsp18"] = time.perf_counter() - t0

    # 3d (iii). the direction-optimised BFS and the BFS parents on
    # bfs18's matrix, and its MatrixMarket round trip
    t0 = time.perf_counter()
    e2e["gbfs18"] = gbfs18_path(torch, ck, drv, card, A, *kron18)
    phase_s["gbfs18"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    e2e["gio"]["mm"] = gio_mm(torch, drv, card, A)
    del A, Aw
    phase_s["gio mm"] = time.perf_counter() - t0

    # 3e. BC4 at kron-16 symmetrised (bench.py:285-299, 386-401)
    t0 = time.perf_counter()
    rows, cols, n = graph(16, sym=True)
    As = to_matrix(rows, cols, n, types.FP32)
    log(f"bc16: kron-16 symmetrised n={n} nnz={len(rows)}")
    plan_t = plan_for(As, True, "bc16 A^T")
    plan_f = plan_for(As, False, "bc16 A")
    per = EXPECTED["bc16"]
    x0 = torch.from_numpy(np.random.RandomState(3).rand(n)
                          .astype(np.float32)).cuda()
    check_xspmv_kernels(torch, ck, plan_t, x0, sem_pr, "bc16",
                        timed=("mid_pass",))
    srcs = [0, 1, 2, 3]
    fused.bc(As, srcs)                          # warm
    t1 = time.perf_counter()
    cent = drv.drive("bc16", lambda: fused.bc(As, srcs), per)
    t_bc = time.perf_counter() - t1
    ref = fused.bc(As, srcs, device="cpu")
    got, want = cent._vals.cpu(), ref._vals
    err = float((got - want).abs().max())
    lim = 1e-4 * float(want.abs().max())
    log(f"  bc16: {t_bc:.4f} s, {drv.counts['bc16']['xspmv_calls']} xspmv; "
        f"max |card - cpu| {err:.3e} (limit {lim:.3e}); card {card}")
    if not err <= lim or not bool(torch.isfinite(got).all()):
        raise AssertionError("bc16: centrality differs from the CPU run")
    e2e["bc16"] = dict(seconds=t_bc, max_abs_err_vs_cpu=err,
                       xspmv_calls=drv.counts["bc16"]["xspmv_calls"])
    ab("bc16", lambda: fused.bc(As, srcs))
    del As, plan_t, plan_f
    kron16s = (rows, cols, n)
    phase_s["bc16"] = time.perf_counter() - t0

    # 3f. masked SpGEMM: triangle counting (bench.py:354-368) at kron-16
    # and kron-18, k-truss (bench.py:370-384) at kron-14 and kron-16, and
    # a valued masked product at kron-16
    for path, run in (
            ("tc16", lambda: tc_path(torch, ck, drv, card, "tc16", *kron16s,
                                     chain=True, per_edge=False)),
            ("gtc16", lambda: gtc16_path(torch, ck, drv, card, *kron16s,
                                         e2e["tc16"]["triangles"])),
            ("tc18", lambda: tc_path(torch, ck, drv, card, "tc18",
                                     *symmetrise(*kron18), chain=False,
                                     per_edge=True)),
            ("kt14", lambda: kt_path(torch, ck, drv, card, "kt14",
                                     *graph(14, sym=True), chain=False,
                                     scipy_ref=True)),
            ("kt16", lambda: kt_path(torch, ck, drv, card, "kt16", *kron16s,
                                     chain=True, scipy_ref=False)),
            ("val16", lambda: val_path(torch, ck, drv, card,
                                       degree_lower(*kron16s))),
            ("esc14", lambda: esc14_path(torch, ck, drv, card)),
            ("gesc14", lambda: gesc14_path(torch, drv, card)),
            ("glv16", lambda: glv16_path(torch, ck, drv, card, *kron16s)),
            ("esc13", lambda: esc13_path(torch, ck, drv, card)),
            ("sr14", lambda: sr14_path(torch, ck, drv, card)),
            ("sr16", lambda: sr16_path(torch, ck, drv, card,
                                       degree_lower(*kron16s))),
            ("gkr", lambda: gkr_path(torch, drv, card))):
        t0 = time.perf_counter()
        e2e[path] = run()
        for tag in ("profile", "profile_chain"):
            if tag in e2e[path]:
                in_path[path + tag[7:]] = e2e[path][tag]["per_kernel"]
        phase_s[path] = time.perf_counter() - t0

    # 3g. slice 12: the frontier BFS on a lattice, the sparse DNN dense
    # and on the COO tier
    for path, run in (
            ("groad", lambda: groad_path(torch, drv, card)),
            ("gdnn1024", lambda: gdnn1024_path(torch, drv, card)),
            ("gdnn_coo", lambda: gdnn_coo_path(torch, ck, drv, card,
                                               DNN_COO_IMAGES,
                                               DNN_COO_LAYERS))):
        t0 = time.perf_counter()
        e2e[path] = run()
        phase_s[path] = time.perf_counter() - t0

    # 3h. slice 13: the distributed tier in a world of one over NCCL
    gd, gd_s = gd_phase(torch, drv, card, kron20, pr20_ref20,
                        e2e["pr20"]["ms_per_iteration"], kron18, wts, s0,
                        drv.results["gsp18"], kron16s,
                        e2e["tc16"]["triangles"])
    e2e.update(gd)
    phase_s.update(gd_s)
    del kron20

    # 3i. slice 14: the user-facing entry points (doctests, gallery,
    # harness, GAP drivers), after gd_phase has closed its process group
    # (demo 07 starts its own world of one)
    t0 = time.perf_counter()
    log("gallery:")
    e2e["gallery"] = gallery_phase(torch, drv, card)
    phase_s["gallery"] = time.perf_counter() - t0
    log(f"  gallery phase {phase_s['gallery']:.1f} s; card {card}")

    # 4. small cases of every kernel (MIN/MAX folds, muls, int32)
    t0 = time.perf_counter()
    log("small cases:")
    check_small_cases(torch, ck)
    check_pair_count_cases(torch, ck)
    check_pair_fold_cases(torch, ck)
    check_mono_rows_cases(torch, ck)
    check_typed_cases(torch, ck)
    repairs = check_repairs(torch)
    phase_s["small"] = time.perf_counter() - t0

    # 5. results
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        tp = TIMED[name]
        if tp in EXPECTED_SPGEMM:
            c = drv.counts[tp]
            per = dict(launches_per_call=c["counts"][name] / c["spgemm_calls"],
                       library_note="none: no single PyTorch call computes a "
                       "masked intersection count (torch.sparse.sampled_addmm "
                       "takes dense operands)")
        elif name == "segfold":
            c = drv.counts[tp]
            per = dict(launches_per_call=c["counts"][name] / c["esc_calls"],
                       yardstick_cumsum_ms=e2e[tp]["cumsum_ms"],
                       library_note="none: torch has no segmented scan; "
                       "yardstick_cumsum_ms is torch.cumsum at the four "
                       "scans' lengths, unsegmented: a lower yardstick, not "
                       "the same function")
        elif name == "esc_gather":
            c = drv.counts[tp]
            per = dict(launches_per_call=c["counts"][name] / c["esc_calls"],
                       library_note="one index_select of B's (column, value) "
                       "pairs stacked as int32, at a premade int64 index")
        else:
            per = dict(launches_per_xspmv=EXPECTED.get(tp, {}).get(name, 0))
        timed = [c for c in ck.rows if c["kernel"] == name and c["timed"]
                 and c["path"] == TIMED[name]]
        allc = [c for c in ck.rows if c["kernel"] == name]
        # the gathers' library call: torch.take at the recipe's index,
        # summed over the timed launches where every one only moves data
        take_rows = [c for c in timed if "library_ms" in c]
        if take_rows and len(take_rows) == len(timed):
            per["library_note"] = ("one torch.take a launch at a premade "
                                   "int64 index (testing.take_index)")
        notes = sorted({c["library_note"] for c in timed
                        if "library_note" in c})
        if notes:
            per["library_note"] = "; ".join(notes)
        if name == "lane_gather_tasc":
            # its launches without the fold, at bfs18 (no single call
            # computes the fold8 launch timed at pr20)
            nf = [c for c in ck.rows if c["kernel"] == name and c["timed"]
                  and c["path"] == "bfs18"]
            per["no_fold_bfs18"] = {
                k: sum(c[k] for c in nf)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
            per["no_fold_bfs18"]["launches_per_xspmv"] = len(nf)
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(v["counts"][name] for v in drv.counts.values()),
            launches_by_path={p: v["counts"][name]
                              for p, v in drv.counts.items()
                              if v["counts"][name]},
            timed_path=tp,
            in_path_ms=in_path.get(tp, {}).get(name),
            max_abs_err=max(c["max_abs_err"] for c in allc),
            ms=sum(c["ms"] for c in timed),
            plain_ms=sum(c["plain_ms"] for c in timed),
            bound_ms=sum(c["bound_ms"] for c in timed),
            bound_by=("bytes" if all(c["bound_by"] == "bytes"
                                     for c in timed) else "operations"),
            library_ms={"lane_gather": lane_lib_ms,
                        "esc_gather": e2e["esc14"]["index_select_ms"],
                        "mono_cascade": ck.segment_reduce_ms.get(tp)}.get(
                            name, sum(c["library_ms"] for c in take_rows)
                            if take_rows and len(take_rows) == len(timed)
                            else None),
            **({"chain_ms": ck.cascade_vs_chain[tp]["chain_ms"]}
               if name == "mono_cascade" else {}),
            checks=f"{sum(c['ok'] for c in allc)}/{len(allc)} "
            + ("exact" if all(c["tol"] == "exact" for c in allc)
               else "within tolerance"), **per))
    with open(os.path.join(OUT_DIR, "chip_smoke_checks.json"), "w") as f:
        json.dump(dict(checks=ck.rows, repairs=repairs, launches=drv.counts,
                       e2e=e2e,
                       cascade_vs_chain=ck.cascade_vs_chain,
                       redesigned_vs_perf_md={
                           f"{k} {p}": v for (k, p), v in redesigned.items()},
                       phase_s=phase_s,
                       build_seconds=_kernels.build_seconds), f, indent=1)
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    log("end to end: " + json.dumps(e2e))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
