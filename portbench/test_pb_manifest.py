"""CPU tests of BENCHMARK.json against the benchmark's contract, and of
the rule that nothing the harness loads is JAX or the JAX package.

    python -m pytest portbench -q
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/") and FILE.match(c["file"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["name"].endswith("_roofline")
    every = [x["name"] for k in ("configs", "workloads") for x in MAN[k]]
    assert len(every) == len(set(every))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len({c["source"] for c in MAN["configs"]}) == len(MAN["configs"])


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in MAN["workloads"]]
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for cell in cells:
        ends = [m["name"] for m in harness.metrics_for(MAN, cell, 0)]
        assert "setup_s" in ends and len(ends) >= 2
        layers = harness.metrics_for(MAN, cell, 1)
        assert layers
        for m in layers:        # what a per-layer metric moves, it reports
            assert m["moves"] in ends
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_files_each_name_finds():
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for k in c["reduced"]:
            assert k in cfg["published"]
    for w in MAN["workloads"]:
        mix = json.loads((ROOT / "portbench" / "mixes" /
                          f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "trials" / f"{mix['trial']}.py").exists()
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" not in p.parts:
            assert FILE.match(str(p.relative_to(ROOT))), p


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pygraphblas_tpu_torch_like", sys)
    assert "pygraphblas_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pygraphblas_tpu.core", sys)
    assert harness.forbidden_modules() == ["pygraphblas_tpu"]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax", "pygraphblas_tpu"]


def test_a_run_loads_no_jax():
    """A whole cell on the CPU in a fresh interpreter: no module whose
    top-level name is jax, jaxlib, flax or pygraphblas_tpu."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "r = harness.run_cell('kron19-bfs', 4, 0.2, 0, device='cpu',"
        " overrides={'scale': 11})\n"
        "assert r['correct'], r\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
        % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    loaded = set(json.loads(lines[-1]))
    assert "pygraphblas_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "pygraphblas_tpu"}


def test_no_card_no_result(tmp_path):
    """run.py without a card exits 2 and prints no result line."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "kron19-pr",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
