"""BENCHMARK.json as the benchmark's contract states it, every file each
entry names found by name, and the shape of a run's last line."""

import importlib.util
import json
import re
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.conftest import BENCH

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "-m", "benchmark.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert set(e) <= KEYS[section] and NAME.match(e["name"]), e
        for k in ("why", "layer", "source"):
            if k in e:
                assert LINE.match(e[k]), e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_metrics_and_cells():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        cell = run.Cell(SPEC, c)
        assert len(cell.end_to_end()) >= 2 and cell.per_layer()
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(cells) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = run.Cell(SPEC, cell)
    assert c.config_entry["file"].startswith("benchmark/configs/")
    assert c.limits and all(v > 0 for v in c.limits.values())
    kind = run.load_kind(c)
    assert callable(kind.run) and callable(kind.control)
    for m in c.per_layer():
        path = BENCH / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert mod.read({"kind": None, "peaks": {}}) is None


def test_configs_used_and_their_files():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert used == {c["name"] for c in SPEC["configs"]}
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert (BENCH.parent / c["file"]).is_file() and c["reduced"] == []


def test_last_line_shape(tiny_data):
    """A whole run on the CPU at tiny sizes: the result's keys in order,
    the end-to-end metrics of its cell, the checks last."""
    res = run.run_cell(SPEC, "spvpa.infer.vol448", 2 ** 31 + 11, 0.5,
                       False, device="cpu", data=tiny_data)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"volumes_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(run.Cell(SPEC, "spvpa.infer.vol448")
                                     .limits)
    json.dumps(res)


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints
    nothing on standard output."""
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "spvpa.infer.vol448", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=BENCH.parent, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, a run
    fails before any result: the program is not there."""
    import shutil
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, json; from benchmark import run; "
            "r = run.run_cell(run.load_spec(), 'spvpa.infer.vol448', 1, "
            "0.5, False, device='cpu'); print(json.dumps(r))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "vs_seg_tpu_torch" in proc.stderr
