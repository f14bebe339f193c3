"""One run of one cell of the benchmark of vs_seg_tpu_torch:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (a file under benchmark/configs/) and its traffic mix
(benchmark/traffic/<name>.json); the mix's "kind" names the generator that
drives it (benchmark/kinds/<kind>.py). The run makes its weights and inputs
from the seed, sets up and warms up the program, measures for `seconds`,
and then judges what the timed path produced against the plain reference
(benchmark/reference.py) under the cell's limits
(benchmark/limits/<cell>.json). With --trace 0 the result line carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, each read
by benchmark/metrics/<metric>.py from what the run recorded.

The last line on standard output is the result, a JSON object; the last
lines on standard error are the numbers compared, each beside its limit.
The run exits non-zero and prints no result where there is no CUDA device,
fewer than the cell asks for, or where jax, jaxlib, flax or the JAX package
vs_seg_tpu was imported by the time the window closed.
"""

import time

T_START = time.perf_counter()   # set-up runs from here

import argparse   # noqa: E402
import importlib.util   # noqa: E402
import json   # noqa: E402
import math   # noqa: E402
import os   # noqa: E402
import sys   # noqa: E402
from pathlib import Path   # noqa: E402
from typing import Dict, List, Optional   # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# whole top-level module names that no run may have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "vs_seg_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _entry(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's entries and files, found by name: its configuration file
    (a path under `root`), traffic mix and limits (under `data`)."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT,
                 data: Path = BENCH):
        self.spec = spec
        self.workload = _entry(spec["workloads"], name, "workload")
        self.name = name
        self.config_entry = _entry(spec["configs"], self.workload["config"],
                                   "config")
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(data / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(data / "limits" / f"{name}.json")

    def _reports(self, metric: dict, reported: set) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric["moves"] in reported if "moves" in metric else True

    def end_to_end(self) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if self._reports(m, set())]

    def per_layer(self) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if self._reports(m, reported)]


def read_per_layer(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell, read by its own reader
    (benchmark/metrics/<name>.py: read(ctx) -> a number or None); a reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for m in cell.per_layer():
        path = BENCH / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def load_kind(cell: Cell):
    path = BENCH / "kinds" / f"{cell.traffic['kind']}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_kind_{cell.traffic['kind']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def judge(checks: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        good = (value is not None and math.isfinite(value)
                and value <= limit)
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             *, device: str = "cuda", root: Path = ROOT,
             data: Path = BENCH, t_start: Optional[float] = None,
             program_hook=None, raw_checks: bool = False) -> dict:
    """One run of cell `name`; returns the result object (with
    `raw_checks`, also every number the kind computed, under that key)."""
    import torch

    cell = Cell(spec, name, root, Path(data))
    dev = torch.device(device)
    kind = load_kind(cell)
    out = kind.run(cell, seed=seed, seconds=seconds, trace=trace,
                   device=dev, t_start=T_START if t_start is None
                   else t_start, program_hook=program_hook)
    ok, checks = judge(out["checks"], cell.limits)
    ok = ok and out["failed"] == 0
    if trace:
        metrics = read_per_layer(cell, out["ctx"])
    else:
        metrics = {}
        for m in cell.end_to_end():
            value = out["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
            "count": int(cell.workload["chips"]),
            "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(ok), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": info}
    summary = out["ctx"].get("trace") if trace else None
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if raw_checks:
        result["raw_checks"] = out["checks"]
    result["checks"] = checks
    return result


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(ROOT)
    spec = load_spec()
    chips = int(_entry(spec["workloads"], args.workload,
                       "workload")["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run imported {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
