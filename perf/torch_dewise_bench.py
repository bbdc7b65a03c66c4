"""The port's device element-wise engine against its host engine at GAP
scale (the twin of ``perf/dewise_bench.py``).

Times the union (eadd, FP32 PLUS) of two canonical COOs of about
``--nnz`` entries each over n = 2^24:
  - host:   ``core/coosparse.ewise`` (numpy merges);
  - device: ``core/dewise.ewise`` end to end (the operands' upload, the
            merge, the result's download), cold and warm;
  - steady state: the operands resident on the device
            (``dewise.concat``), the merge alone (``dewise.merge``), the
            mean of 10, bracketed by CUDA events on the card.

Gate (exit 1 when it fails): the device result equals the host's,
indices exactly and values within rtol 1e-6, as the twin asserts.

    python perf/torch_dewise_bench.py [--nnz 16000000] [--device cuda|cpu]

Prints one JSON line at the end.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 1 << 24


def make(nnz, seed, n=N):
    """A canonical COO of up to `nnz` random entries of an n x n matrix,
    FP32 values in [0, 1) (perf/dewise_bench.py's ``make``; its
    ``np.unique`` by one sort, the same keys)."""
    from pygraphblas_tpu_torch.generators import unique_keys

    rr = np.random.RandomState(seed)
    k = unique_keys(rr.randint(0, n, nnz, dtype=np.int64) * n
                    + rr.randint(0, n, nnz, dtype=np.int64))
    return (k // n).astype(np.int64), (k % n).astype(np.int64), \
        rr.rand(len(k)).astype(np.float32)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nnz", type=int, default=16_000_000)
    ap.add_argument("--device", default="cuda")
    return ap


def run(args):
    """The engines on `args` (``parser()``'s options); returns the result
    dict.  Raises AssertionError when the gate fails."""
    from pygraphblas_tpu_torch import types
    from pygraphblas_tpu_torch._device import resolve_device
    from pygraphblas_tpu_torch.core import coosparse as ck, dewise as dw

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    t0 = time.perf_counter()
    ra, ca, va = make(args.nnz, 1)
    rb, cb, vb = make(args.nnz, 2)
    res = dict(nnz=args.nnz, n=N, nnz_a=len(ra), nnz_b=len(rb),
               device=str(dev), make_s=time.perf_counter() - t0)
    print(f"# nnz_a={len(ra)} nnz_b={len(rb)}", flush=True)

    def fn(x, y):
        return x + y

    t0 = time.perf_counter()
    hr, hc, hv = ck.ewise(ra, ca, va, rb, cb, vb, fn, np.float32,
                          union=True)
    res["host_s"] = time.perf_counter() - t0
    res["host_engine"] = "core/coosparse.ewise (numpy)"
    print(f"# host merge (coosparse.ewise): {res['host_s']:.4f}s", flush=True)

    for tag in ("cold", "warm"):
        t0 = time.perf_counter()
        dr, dc, dv = dw.ewise(ra, ca, va, rb, cb, vb, fn, np.float32,
                              np.float32, union=True, device=dev)
        res[f"device_e2e_{tag}_s"] = time.perf_counter() - t0
        print(f"# device engine end to end ({tag}, dewise.ewise on "
              f"{dev}): {res[f'device_e2e_{tag}_s']:.4f}s", flush=True)
    t0 = time.perf_counter()
    if not (len(dr) == len(hr) and np.array_equal(dr, hr)
            and np.array_equal(dc, hc)
            and np.allclose(dv, hv, rtol=1e-6, atol=0)):
        raise AssertionError("the device and host results differ")
    res["check_s"] = time.perf_counter() - t0
    res["out_nnz"] = len(hr)

    T = types.FP32
    r, c, v = dw.concat(ra, ca, va, rb, cb, vb, T, dev)
    out = dw.merge(r, c, v, fn, T, T)           # warm
    sync()
    iters = 10
    if cuda:
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            out = dw.merge(r, c, v, fn, T, T)
        t1.record()
        sync()
        merge_s = t0.elapsed_time(t1) / 1e3 / iters
    else:
        t = time.perf_counter()
        for _ in range(iters):
            out = dw.merge(r, c, v, fn, T, T)
        merge_s = (time.perf_counter() - t) / iters
    if not (np.array_equal(out[0].cpu().numpy(), hr)
            and np.array_equal(out[1].cpu().numpy(), hc)):
        raise AssertionError("the resident merge differs from the host's")
    res["device_merge_s"] = merge_s
    res["merge_timer"] = "CUDA events" if cuda else "perf_counter"
    res["merge_elems_per_s"] = (len(ra) + len(rb)) / merge_s
    res["host_over_merge"] = res["host_s"] / merge_s
    print(f"# device merge steady state (dewise.merge, resident, mean of "
          f"{iters}, {res['merge_timer']}): {merge_s:.6f}s/op "
          f"({res['merge_elems_per_s'] / 1e6:.1f}M elem/s); host / merge "
          f"{res['host_over_merge']:.1f}x", flush=True)
    return res


def main(argv=None):
    try:
        res = run(parser().parse_args(argv))
    except AssertionError as e:
        print(f"# FAILED: {e}", flush=True)
        return 1
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
