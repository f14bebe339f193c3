"""What the benchmark imports, by whole top-level module names: nothing
under benchmark/ imports jax, jaxlib, flax or the JAX package vs_seg_tpu,
and the plain reference imports nothing of the program vs_seg_tpu_torch
either. The program's name begins with the JAX package's, so a prefix
match would be wrong."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.conftest import BENCH

JAX = {"jax", "jaxlib", "flax", "vs_seg_tpu"}
# the reference and what it imports of the benchmark
PLAIN = ["reference.py", "flops.py", "data.py"]


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("name", PLAIN)
def test_reference_imports_no_program(name):
    names = top_level_imports(BENCH / name)
    assert not names & (JAX | {"vs_seg_tpu_torch"})
    assert names - {"__future__"} <= {"math", "typing", "numpy", "torch",
                                       "benchmark"}


def test_whole_names():
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "vs_seg_tpu")
    saved = dict(sys.modules)
    try:
        sys.modules.pop("vs_seg_tpu", None)
        sys.modules["vs_seg_tpu_torch_probe"] = sys
        assert "vs_seg_tpu" not in run.forbidden_modules()
        sys.modules["vs_seg_tpu.probe"] = sys
        assert "vs_seg_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax(tiny_data):
    """A whole run in a fresh process, the training kind and the
    reference with it: none of JAX's modules is loaded at the end, and the
    reference's modules alone load nothing of the program."""
    code = (
        "import json, sys\n"
        "from benchmark import run\n"
        f"r = run.run_cell(run.load_spec(), 'spvpa.train.crop384', 5, 0.5,"
        f" False, device='cpu', data={str(tiny_data)!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "vs_seg_tpu_torch" in loaded and not loaded & JAX
    code = ("import json, sys\n"
            "import benchmark.reference, benchmark.flops, benchmark.data\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                          capture_output=True, text=True, timeout=300)
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert not loaded & (JAX | {"vs_seg_tpu_torch"})
