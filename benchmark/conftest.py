"""Test settings of the benchmark's own CPU tests (run as `python -m
pytest benchmark/` from the root of the repo): the `gpu` marker, and a
tiny copy of each traffic mix (72x72x20 volumes, 64x64x16 windows and
crops, the configurations' full widths) with the cells' own limits."""

import json
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
TINY = {"volume": [72, 72, 20], "roi": [64, 64, 16], "crop": [64, 64, 16],
        "tumour_box": [8, 8, 4], "warmup_cases": 1, "trace_cases": 2,
        "level_cases": 2, "trace_steps": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips without CUDA")


@pytest.fixture(scope="session")
def tiny_data(tmp_path_factory) -> Path:
    """A data directory (traffic/, limits/) of tiny traffic mixes."""
    root = tmp_path_factory.mktemp("tiny_bench")
    (root / "traffic").mkdir()
    (root / "limits").mkdir()
    for f in (BENCH / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update({k: v for k, v in TINY.items() if k in mix})
        (root / "traffic" / f.name).write_text(json.dumps(mix))
    for f in (BENCH / "limits").glob("*.json"):
        (root / "limits" / f.name).write_text(f.read_text())
    return root
