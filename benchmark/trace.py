"""The device trace of a short steady stretch: torch.profiler over it, the
chrome trace written under the temporary directory and read back, then
reduced to the busy seconds, the window, device time by kernel family and
by kernel name, and the idle gaps by what the host was doing in them.

The busy time is the union of the device's kernel, copy and memset
intervals within the traced window; the window is the benchmark's own
"bench.traced" span around the stretch, which ends after a synchronise.
The kernel families are chip_smoke.py:kernel_family's rules, copied.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "python_function",
             "cuda_runtime", "cuda_driver")
TOP = 10
# the longest idle gaps that are labelled one by one; the rest are summed
LABELLED_GAPS = 400
WINDOW_SPAN = "bench.traced"

_FAMILIES = (("conv333 gated", r"\bconv333_gated_kernel\b"),
             ("conv333", r"\bconv333_kernel\b"),
             ("conv333_dw", r"\bdw_kernel\b"),
             ("ru_unit", r"\bru_unit_kernel\b"),
             ("attgate", r"\battgate_kernel\b"),
             ("library conv", r"cudnn|xmma|implicit_gemm|cutlass|conv|"
                              r"wgrad|dgrad|fprop"),
             ("gemm", r"gemm|gemv"),
             ("elementwise", r"elementwise|Elementwise"),
             ("reduction", r"reduce|Reduce|norm|Norm"),
             ("copy/memset", r"[Mm]emcpy|[Mm]emset|[Cc]opy|CatArray"))


def kernel_family(name: str) -> str:
    """A device event's family: the port's hand kernels by their
    __global__ names, then the library's by name."""
    for fam, pat in _FAMILIES:
        if re.search(pat, name):
            return fam
    return "other"


class Tracer:
    """torch.profiler over a stretch that begins at `start()` and ends at
    `stop()`, which synchronises `device` first; the stretch is the
    benchmark's "bench.traced" span. `profile()` and `open()` split
    `start()`: work run between them is traced but lies outside the
    stretch, so that the profiler's own start-up does not read as the
    stretch's idle time. `events` holds the trace's complete events once
    stopped."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts)
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.events = None

    def profile(self) -> None:
        self.prof.start()

    def open(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.__enter__()

    def start(self) -> None:
        self.profile()
        self.open()

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = [e for e in json.load(f)["traceEvents"]
                               if e.get("ph") == "X" and "dur" in e]
        finally:
            os.unlink(path)


@contextlib.contextmanager
def traced(device: torch.device, warm=None):
    """Trace the body (a Tracer started before it and stopped after);
    `warm()`, where given, runs under the profiler before the stretch
    opens."""
    tracer = Tracer(device)
    tracer.profile()
    if warm is not None:
        warm()
    tracer.open()
    yield tracer
    tracer.stop()


def _union(intervals: List[Tuple[float, float]]):
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarise(events: list) -> Optional[dict]:
    """busy_s, window_s, device seconds by family and by kernel name, and
    the idle gaps by host activity, of a trace's events; None when the
    trace holds no device event in its window."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN]
    if not spans:
        return None
    w0 = spans[0]["ts"]
    w1 = w0 + spans[0]["dur"]
    dev = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t > s:
            dev.append((s, t, e["name"]))
    if not dev:
        return None
    merged = _union([(s, t) for s, t, _ in dev])
    busy = sum(t - s for s, t in merged)
    fams: Dict[str, float] = {}
    names: Dict[str, float] = {}
    for s, t, name in dev:
        fam = kernel_family(name)
        fams[fam] = fams.get(fam, 0.0) + (t - s) / 1e6
        names[name] = names.get(name, 0.0) + (t - s) / 1e6
    gaps = []
    last = w0
    for s, t in merged + [[w1, w1]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    # the thread that drives the stretch: what it was doing idles the card
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("tid") == spans[0].get("tid")
            and e.get("name") != WINDOW_SPAN]
    starts = np.asarray([e["ts"] for e in host], np.float64)
    ends = starts + np.asarray([e["dur"] for e in host], np.float64)
    by_host: Dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for s, t in gaps[:LABELLED_GAPS]:
        label = _host_label(host, starts, ends, 0.5 * (s + t))
        by_host[label] = by_host.get(label, 0.0) + (t - s) / 1e6
    rest = gaps[LABELLED_GAPS:]
    if rest:
        label = f"gaps under {rest[0][1] - rest[0][0]:.0f} us"
        by_host[label] = sum(t - s for s, t in rest) / 1e6
    top = sorted(names.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
            "families_s": fams, "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}


def _host_label(host: list, starts, ends, mid: float) -> str:
    """What the host was doing at `mid`: the innermost host event that
    covers it, under the benchmark's innermost span where one covers it
    ("bench.*: op"), else "host idle"."""
    covering = np.nonzero((starts <= mid) & (ends >= mid))[0]
    if not len(covering):
        return "host idle"
    events = [host[i] for i in covering]
    inner = min(events, key=lambda e: e["dur"])
    bench = [e for e in events if e["name"].startswith("bench.")]
    if bench and bench[0] is not inner:
        return (f"{min(bench, key=lambda e: e['dur'])['name']}: "
                f"{inner['name']}")
    return inner["name"]
