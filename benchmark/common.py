"""What the traffic kinds share: the program's configuration from the
configuration file, a silent logger for the program, the device's name,
and the table of peaks."""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import sys
import time
from pathlib import Path

import torch

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def program_config(cfg: dict, **overrides):
    """The port's Config: the configuration file's keys that Config has
    (lists as tuples), then `overrides`."""
    from vs_seg_tpu_torch.core.config import Config

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: tup(v) for k, v in cfg.items() if k in fields}
    kw.update(overrides)
    return Config(**kw)


def quiet_logger() -> logging.Logger:
    """The logger handed to the program: its INFO lines go nowhere."""
    log = logging.getLogger("benchmark.program")
    log.propagate = False
    if not log.handlers:
        log.addHandler(logging.NullHandler())
    return log


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def peaks() -> dict:
    """Published peaks by device name (peaks.json)."""
    with open(PEAKS) as f:
        return json.load(f)


def peak_memory(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def worst(values) -> float:
    """The largest of `values`; NaN where any is NaN (a max would drop
    it)."""
    values = [float(v) for v in values]
    if any(math.isnan(v) for v in values):
        return float("nan")
    return max(values)


def note(t_start: float, what: str) -> None:
    """A progress line on standard error: seconds since the run began."""
    print(f"[{time.perf_counter() - t_start:8.2f} s] {what}",
          file=sys.stderr, flush=True)
