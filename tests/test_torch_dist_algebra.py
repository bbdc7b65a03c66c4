"""The port's distributed op table (``parallel/dist.py``: ``_MULS``,
``_ADDS``, ``_COLLECTIVES``, the positional muls) against the JAX
package's, DistSpMV on a 2 x 2 mesh of four spawned gloo ranks against
the JAX tier on ``make_mesh(4)``, with the same seeded inputs.

The cross is the JAX package's (tests/test_dist_algebra.py): every mul
under PLUS, every add under TIMES, the positional and bitwise spot
checks, each whole y (absent rows included) equal.  The bitwise adds run
at INT8: the JAX tier unrolls a collective a bit, so at INT64 each such
case costs it most of a minute to compile.  The value types the port
computes in another dtype (UINT8/16/32 widened, UINT64 as its bit view,
INT16 and BOOL through int32 collectives) have their own cases."""

import os
import subprocess
import sys

import numpy as np
import pytest

import pygraphblas_tpu as J
import pygraphblas_tpu_torch as T
from pygraphblas_tpu.parallel import dist as jdist
from pygraphblas_tpu_torch.parallel import dist as tdist
from pygraphblas_tpu_torch.testing import RankPool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 40
NNZ = 160


@pytest.fixture(scope="module")
def ranks():
    pool = RankPool(4)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def jmesh():
    return jdist.make_mesh(4)


def _graph(seed=3):
    rng = np.random.RandomState(seed)
    r = rng.randint(0, N, NNZ)
    c = rng.randint(0, N, NNZ)
    keys = np.unique(r.astype(np.int64) * N + c)
    r, c = keys // N, keys % N
    v = rng.randint(1, 8, len(r)).astype(np.int64)
    x = rng.randint(1, 8, N).astype(np.int64)
    return r, c, v, x


def _cross(ranks, jmesh, cases, graph=None):
    """Every (add, mul, dtype) case through both tiers: whole y equal on
    every rank and to the JAX package's, bit for bit."""
    import jax

    r, c, v, x = graph or _graph()
    got = ranks.run("spmv", n=N, m=N, rows=r, cols=c, vals=v, x=x,
                    cases=cases)
    for k, (add, mul, dt) in enumerate(cases):
        s = jdist.DistSpMV(jmesh, N, N, r, c, v.astype(dt), add=add,
                           mul=mul, dtype=dt)
        xp = np.zeros(s.ncols_p, dt)
        xp[:N] = x.astype(dt)
        want = np.asarray(s(jax.device_put(xp, s.x_spec)))
        for rank_y in got:
            y = rank_y[k]
            assert y.dtype == want.dtype, (add, mul, dt)
            assert np.array_equal(y, want), (add, mul, dt)


MUL_GROUPS = {
    "arith": ["TIMES", "PLUS", "MINUS", "RMINUS", "MIN", "MAX", "FIRST",
              "SECOND", "ANY", "PAIR"],
    "logical": ["LAND", "LOR", "LXOR", "EQ", "NE", "GT", "LT", "GE", "LE",
                "ISEQ", "ISNE", "ISGT", "ISLT", "ISGE", "ISLE"],
    "bitwise": ["BOR", "BAND", "BXOR"],
    "positional": list(jdist._POS_MULS),
}


def test_mul_table_is_the_jax_table():
    assert set(tdist._MULS) == set(jdist._MULS)
    assert tdist._POS_MULS == jdist._POS_MULS
    assert set(tdist._ADDS) == set(jdist._ADDS)
    assert set(tdist._COLLECTIVES) == set(jdist._COLLECTIVES)
    assert set(tdist._REDUCES) == set(jdist._REDUCES)
    assert sorted(m for g in MUL_GROUPS.values() for m in g) == sorted(
        set(jdist._MULS) - {"DIV", "RDIV"} | set(jdist._POS_MULS))


@pytest.mark.parametrize("group", sorted(MUL_GROUPS))
def test_muls_under_plus(ranks, jmesh, group):
    _cross(ranks, jmesh, [("PLUS", m, "int64") for m in MUL_GROUPS[group]])


def test_adds_under_times(ranks, jmesh):
    """Every add under TIMES; the TIMES add (an all-gather and a local
    product) against a numpy oracle, since the JAX tier cannot replicate
    its result over "j" and raises."""
    _cross(ranks, jmesh, [(a, "TIMES", "int64") for a in
                          ("PLUS", "MIN", "MAX", "ANY", "LOR", "LAND",
                           "LXOR")])
    r, c, v, x = _graph()
    y = ranks.run("spmv", n=N, m=N, rows=r, cols=c, vals=v, x=x,
                  cases=[("TIMES", "TIMES", "int64")])[0][0]
    want = np.ones(len(y), np.int64)
    np.multiply.at(want, r, v * x[c])
    assert np.array_equal(y, want)


def test_bitwise_adds(ranks, jmesh):
    """BOR, BAND and BXOR adds: the per-bit segment folds and the per-bit
    collectives, under TIMES against the JAX tier; under FIRSTI1, MINUS
    and BXOR (the JAX package's spot checks) against a numpy oracle, to
    spare the JAX tier three more of its slowest compiles."""
    _cross(ranks, jmesh, [(a, "TIMES", "int8") for a in
                          ("BOR", "BAND", "BXOR")])
    r, c, v, x = _graph()
    v8, x8 = v.astype(np.int8), x.astype(np.int8)
    cases = {("BOR", "FIRSTI1"): (r + 1).astype(np.int8),
             ("BOR", "MINUS"): v8 - x8[c],
             ("BXOR", "BXOR"): v8 ^ x8[c]}
    got = ranks.run("spmv", n=N, m=N, rows=r, cols=c, vals=v, x=x,
                    cases=[(a, m, "int8") for a, m in cases])
    for k, ((add, mul), prod) in enumerate(cases.items()):
        ufunc = np.bitwise_or if add == "BOR" else np.bitwise_xor
        want = np.zeros(N, np.int8)
        ufunc.at(want, r, prod)
        for rank_y in got:
            assert np.array_equal(rank_y[k], want), (add, mul)


def test_positional_and_spot_checks(ranks, jmesh):
    _cross(ranks, jmesh, [("MIN", "FIRSTI1", "int64"),
                          ("MAX", "FIRSTI1", "int64"),
                          ("LAND", "ISGE", "int64"),
                          ("MIN", "SECONDJ1", "int32")])


def test_value_types(ranks, jmesh):
    """Values the port computes in another dtype than they are held in:
    UINT32 past 2^31 (widened to int64), UINT16, UINT8, UINT64 (its
    int64 bit view), INT16 (wrapping sums through int32 collectives),
    BOOL, FP64."""
    r, c, v, x = _graph(seed=5)
    big = np.uint64(3_000_000_000)
    cases = [("PLUS", "TIMES", "uint32"), ("MIN", "PLUS", "uint32"),
             ("MAX", "MINUS", "uint32"), ("PLUS", "TIMES", "uint16"),
             ("MAX", "TIMES", "uint8"), ("PLUS", "TIMES", "uint64"),
             ("PLUS", "TIMES", "int16"), ("MIN", "TIMES", "int16"),
             ("LOR", "LAND", "bool"), ("MAX", "TIMES", "bool"),
             ("PLUS", "TIMES", "float64")]
    # values that wrap the narrow types and pass the sign bit of uint32
    v = v.astype(np.uint64) * np.uint64(4_000_000) + big
    x = x.astype(np.uint64) * np.uint64(12_345)
    _cross(ranks, jmesh, cases, graph=(r, c, v, x))
    # bool values: some zeros
    _cross(ranks, jmesh, [("LOR", "LAND", "bool"), ("LAND", "LOR", "bool")],
           graph=(r, c, (np.arange(len(r)) % 3 == 0).astype(np.int64),
                  (np.arange(N) % 2).astype(np.int64)))


def test_uint64_order_ops_raise():
    """UINT64 is computed as its int64 bit view: the ops that compare
    values raise rather than misorder values past 2^63."""
    for add, mul in (("MIN", "TIMES"), ("PLUS", "GT"), ("MAX", "PLUS"),
                     ("PLUS", "DIV")):
        with pytest.raises(NotImplementedError, match="UINT64"):
            tdist._check_ops(np.uint64, add, mul)
    tdist._check_ops(np.uint64, "PLUS", "TIMES")
    tdist._check_ops(np.uint32, "MIN", "GT")


def test_dist_vector_apply_reduce_eadd(ranks):
    """DistVector's ops on every layout (replicated, row and column
    blocks) give the JAX package's answers on a replicated vector."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jdist.make_mesh(4)
    spec = NamedSharding(mesh, P(None))
    a = jdist.DistVector.dense(mesh, 10, 16, 3, J.types.INT64, spec)
    b = jdist.DistVector.dense(mesh, 10, 16, 4, J.types.INT64, spec)
    want = dict(eadd=a.eadd(b, "PLUS").to_numpy(),
                emult=a.emult(b, "TIMES").to_numpy(),
                ainv=a.apply("AINV").to_numpy(),
                sum10=a.apply(lambda z: z * 10).reduce("PLUS"),
                bmax=b.reduce("MAX"), bor=a.reduce("BOR"),
                float_sum=a.reduce_float())
    for got in ranks.run("vector_ops"):
        for spec_name, res in got.items():
            assert res.keys() == want.keys()
            for k in want:
                assert np.array_equal(res[k], want[k]), (spec_name, k)


def test_resolve_ops_matches_jax():
    """Semiring objects resolve to the same (add, mul) names in both
    packages; a user-defined op is refused."""
    names = ["FP32.PLUS_TIMES", "FP64.MIN_PLUS", "INT64.MAX_FIRST",
             "BOOL.LOR_LAND", "UINT32.BOR_BAND", "INT32.MIN_FIRSTI1",
             "INT64.PLUS_SECONDJ", "INT64.ANY_PAIR", "UINT32.BXOR_BAND",
             "FP32.PLUS_ISGE"]
    for name in names:
        typ, sem = name.split(".")
        jsr = getattr(getattr(J.types, typ), sem)
        tsr = getattr(getattr(T.types, typ), sem)
        assert tdist.resolve_ops(tsr) == jdist.resolve_ops(jsr), name
    from pygraphblas_tpu_torch import binaryop, semiring, monoid

    user = binaryop.BinaryOp("MYMUL", "FP32", fn=lambda a, b: a * b,
                             attach=False)
    sr = semiring.Semiring("PLUS", "MYMUL", "FP32",
                           add=monoid.PLUS_FP32_monoid, mul_op=user,
                           attach=False)
    with pytest.raises(NotImplementedError, match="builtin"):
        tdist.resolve_ops(sr)


def test_make_mesh_without_a_card_raises():
    """make_mesh() means the card: with none it raises, before any
    process group starts."""
    import torch
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.make_mesh()
    assert not dist.is_initialized()


def test_parallel_calls_never_import_jax(tmp_path):
    """The distributed tier, run end to end in a world of one on the CPU
    in a fresh interpreter, loads neither jax nor the JAX package."""
    code = f"""
import sys
import numpy as np
import torch
import pygraphblas_tpu_torch as T
from pygraphblas_tpu_torch.parallel import (DistSpMV, dist_pagerank_step,
                                            make_mesh, dist, checkpoint)
mesh = make_mesh(device="cpu")
r = np.array([0, 1, 2, 2, 3]); c = np.array([1, 2, 0, 3, 0])
s = DistSpMV(mesh, 4, 4, r, c, np.ones(5, np.float32))
s.gather(s(np.ones(4, np.float32)))
dist.dist_pagerank(mesh, 4, r, c, itermax=3,
                   checkpoint_path={str(tmp_path / "pr.npz")!r},
                   checkpoint_every=1)
dist.frontier_all_to_all(mesh, torch.arange(4), torch.ones(4),
                         torch.zeros(4, dtype=torch.int32), 4)
A = T.Matrix.from_lists(list(np.r_[r, c]), list(np.r_[c, r]), [1.0] * 10,
                        nrows=4, ncols=4, device="cpu")
D = A.shard(mesh)
D.mxv(np.ones(4, np.float32)); D.triangle_count(); D.k_truss(3)
D.bfs_level(0); D.sssp(0); D.pagerank(itermax=2); D.mxm(A, mask=A)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pygraphblas_tpu')]
print(bad)
sys.exit(1 if bad else 0)
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
