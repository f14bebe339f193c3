"""Whole-volume inference driver; this slice ports `make_predictor` from
vs_seg_tpu/infer/engine.py (run_inference with NIFTI, Dice and figures is
not ported yet)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from vs_seg_tpu_torch.core.config import Routes


def make_predictor(model: nn.Module, dtype=torch.bfloat16,
                   use_kernels: bool = True,
                   routes: Routes = Routes()) -> Callable:
    """(N, D, H, W, C) windows -> (N, D, H, W, out) logits in `dtype`: casts
    to the compute dtype, runs the eval forward without autograd and drops
    the attention maps. use_kernels=False runs the kernel sites with their
    plain PyTorch twins; `routes` selects the opt-in kernel routes
    (core/config.py:Routes)."""
    model.eval()

    def predictor(wins: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out = model(wins.to(dtype), use_kernels=use_kernels,
                        routes=routes)
        return out[0] if isinstance(out, tuple) else out

    return predictor
