"""Generate markdown API documentation of the PyTorch/CUDA port from its
docstrings.

The counterpart of docs/generate.py: it walks the port's public surface,
over the same modules, and emits one markdown file per module into
docs/api_torch/.  Importing the port needs no card.

Run: python docs/generate_torch.py
"""

import importlib
import inspect
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

OUT = Path(__file__).resolve().parent / "api_torch"

MODULES = [
    "pygraphblas_tpu_torch",
    "pygraphblas_tpu_torch.matrix",
    "pygraphblas_tpu_torch.vector",
    "pygraphblas_tpu_torch.scalar",
    "pygraphblas_tpu_torch.types",
    "pygraphblas_tpu_torch.unaryop",
    "pygraphblas_tpu_torch.binaryop",
    "pygraphblas_tpu_torch.monoid",
    "pygraphblas_tpu_torch.semiring",
    "pygraphblas_tpu_torch.selectop",
    "pygraphblas_tpu_torch.descriptor",
    "pygraphblas_tpu_torch.base",
    "pygraphblas_tpu_torch.algorithms",
    "pygraphblas_tpu_torch.fused",
    "pygraphblas_tpu_torch.gviz",
    "pygraphblas_tpu_torch.parallel.dist",
    "pygraphblas_tpu_torch.parallel.checkpoint",
]


def _doc(obj):
    d = inspect.getdoc(obj)
    return d or ""


def _sig(obj):
    """The signature, without the addresses of default objects (so that
    the output repeats from run to run)."""
    try:
        return re.sub(r" at 0x[0-9a-f]+", "", str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return "(...)"


def render_module(modname):
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", "", _doc(mod), ""]
    members = getattr(mod, "__all__", None)
    if members is None:
        members = [n for n in dir(mod) if not n.startswith("_")]
    for name in members:
        obj = getattr(mod, name, None)
        if obj is None:
            continue
        if inspect.isclass(obj) and obj.__module__ == modname:
            lines += [f"## class `{name}`", "", _doc(obj), ""]
            for mname, m in inspect.getmembers(obj):
                if mname.startswith("_"):
                    continue
                if inspect.isfunction(m) or inspect.ismethod(m):
                    lines += [f"### `{name}.{mname}{_sig(m)}`", "",
                              _doc(m), ""]
                elif isinstance(m, property):
                    lines += [f"### property `{name}.{mname}`", "",
                              _doc(m), ""]
        elif inspect.isfunction(obj) and obj.__module__ == modname:
            lines += [f"## `{name}{_sig(obj)}`", "", _doc(obj), ""]
    return "\n".join(lines) + "\n"


def main(out=OUT):
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    index = ["# pygraphblas_tpu_torch API documentation", ""]
    for modname in MODULES:
        fname = modname.replace(".", "_") + ".md"
        (out / fname).write_text(render_module(modname))
        index.append(f"- [{modname}]({fname})")
        print("wrote", out / fname)
    (out / "index.md").write_text("\n".join(index) + "\n")
    print("wrote", out / "index.md")


if __name__ == "__main__":
    main()
