"""Observability: the counterpart of vs_seg_tpu/core/observability.py.

  - `start_trace`: a torch.profiler trace (CPU and, on a card, CUDA
    activities) written into a directory as a Chrome trace that
    TensorBoard's profiler plugin and Perfetto read
  - `profile_trace`: the same as a context manager (JAX's over
    jax.profiler)
  - `span`: a named range of the program's own work (a
    torch.profiler.record_function range while a profiler runs, an NVTX
    range under torch.autograd.profiler.emit_nvtx), counted and timed on
    the host clock while `recording()`; `spans()` reads the counts and
    times, `reset()` clears them
  - `make_image_grid`: torchvision.make_grid equivalent (numpy) for the
    debug-mode TensorBoard image grid (reference params/VSparams.py:417-426)
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Sequence

import numpy as np
import torch


def start_trace(log_dir: str, device=None) -> torch.profiler.profile:
    """A started torch.profiler.profile; its `stop()` writes the trace into
    `log_dir`. CUDA activity is recorded when `device` is a CUDA device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True, device=None):
    """Trace the body with start_trace into `log_dir`; the trace is written
    on exit. Yields the profiler, or None (and traces nothing) when not
    `enabled`."""
    if not enabled:
        yield None
        return
    prof = start_trace(log_dir, device)
    try:
        yield prof
    finally:
        prof.stop()


# The span registry, filled while recording: {name: [count, total ns,
# max ns]}. A reset starts a new generation; a span counts only in the
# generation it opened in, so one open across a reset is left out.
_recording = False
_lock = threading.Lock()
_registry: Dict[str, list] = {}
_generation = 0
_profiler_enabled = torch._C._autograd._profiler_enabled


class _NoSpan:
    """The one context of every span that neither records nor traces."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "range", "generation", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = None
        self.generation = None

    def __enter__(self):
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if _recording:
            self.generation = _generation
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.generation is not None:
            with _lock:
                if self.generation == _generation:
                    entry = _registry.get(self.name)
                    if entry is None:
                        _registry[self.name] = [1, ns, ns]
                    else:
                        entry[0] += 1
                        entry[1] += ns
                        entry[2] = max(entry[2], ns)
        return False


def span(name: str):
    """A context manager around one piece of the program's work. While a
    profiler runs (torch.profiler.profile, start_trace, emit_nvtx) it is
    a record_function range named `name` on the device trace's clock;
    while recording, its host time (time.perf_counter_ns) is added to
    `name`'s count, total and maximum. Otherwise it is one shared no-op:
    pass a precomputed name."""
    if not _recording and not _profiler_enabled():
        return _NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Add every span closed in the body to the registry (from any
    thread); the registry is off outside."""
    global _recording
    was = _recording
    _recording = True
    try:
        yield
    finally:
        _recording = was


def spans() -> Dict[str, Dict[str, float]]:
    """The registry now: {name: {"count", "total_ms", "max_ms"}}."""
    with _lock:
        return {name: {"count": c, "total_ms": t / 1e6, "max_ms": m / 1e6}
                for name, (c, t, m) in _registry.items()}


def reset() -> None:
    """Clear the registry; spans open now are not counted."""
    global _generation
    with _lock:
        _registry.clear()
        _generation += 1


def make_image_grid(images: Sequence[np.ndarray], ncols: int = 8,
                    pad: int = 2, normalize: bool = True) -> np.ndarray:
    """Tile 2D images into one (H, W) grid image, each scaled to [0,1]
    (torchvision make_grid(normalize=True, scale_each=True) equivalent,
    used by the reference debug TB grid at params/VSparams.py:425)."""
    imgs = []
    for img in images:
        img = np.asarray(img, dtype=np.float32)
        if normalize:
            lo, hi = float(img.min()), float(img.max())
            img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        imgs.append(img)
    if not imgs:
        return np.zeros((1, 1), np.float32)
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    ncols = min(ncols, len(imgs))
    nrows = -(-len(imgs) // ncols)
    grid = np.zeros((nrows * (h + pad) + pad, ncols * (w + pad) + pad), np.float32)
    for idx, img in enumerate(imgs):
        r, c = divmod(idx, ncols)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        grid[y:y + img.shape[0], x:x + img.shape[1]] = img
    return grid
