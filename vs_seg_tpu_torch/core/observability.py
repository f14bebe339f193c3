"""Observability: the counterpart of vs_seg_tpu/core/observability.py.

  - `start_trace`: a torch.profiler trace (CPU and, on a card, CUDA
    activities) written into a directory as a Chrome trace that
    TensorBoard's profiler plugin and Perfetto read
  - `profile_trace`: the same as a context manager (JAX's over
    jax.profiler)
  - `StepTimer`: per-step wall timing with EMA + ETA logging
  - `make_image_grid`: torchvision.make_grid equivalent (numpy) for the
    debug-mode TensorBoard image grid (reference params/VSparams.py:417-426)
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Optional, Sequence

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


class StepTimer:
    """EMA step timer with ETA estimation."""

    def __init__(self, total_steps: Optional[int] = None, ema: float = 0.9):
        self.total_steps = total_steps
        self.ema = ema
        self.avg = None
        self.count = 0
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._last
        self.avg = (dt if self.avg is None
                    else self.ema * self.avg + (1 - self.ema) * dt)
        self.count += 1
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.avg if self.avg else 0.0

    def eta_seconds(self) -> Optional[float]:
        if self.total_steps is None or not self.avg:
            return None
        return (self.total_steps - self.count) * self.avg

    def log(self, logger: logging.Logger, prefix: str = ""):
        msg = f"{prefix}avg_step={self.avg:.3f}s ({self.steps_per_sec:.2f}/s)"
        eta = self.eta_seconds()
        if eta is not None:
            msg += f" eta={eta / 3600:.2f}h"
        logger.info(msg)


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
