"""Observability: what the port uses of vs_seg_tpu/core/observability.py.

  - `start_trace`: a torch.profiler trace (CPU and, on a card, CUDA
    activities) written into a directory as a Chrome trace that
    TensorBoard's profiler plugin and Perfetto read
  - `make_image_grid`: torchvision.make_grid equivalent (numpy) for the
    debug-mode TensorBoard image grid (reference params/VSparams.py:417-426)
"""

from __future__ import annotations

from typing import Sequence

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
