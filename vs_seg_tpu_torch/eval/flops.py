"""Analytic conv FLOP count of one eval forward: the counterpart of
vs_seg_tpu/eval/flops.py.

Every Conv3d and ConvTranspose3d module of the model counts
2 * output elements * kh*kw*kd * Cin, JAX's formula
(vs_seg_tpu/nn/layers.py:conv3d); a transpose conv counts as the
input-dilated conv JAX runs it as, whose output is the module's. Convs are
>99% of the network's FLOPs; BN, PReLU and the attention gates'
elementwise work are left out, so an MFU from this count is slightly
conservative.

The count is the model's algebra, not what executes: it runs the eval
forward under nn/layers.py:unfused, where every block computes its own
modules (no ru_block, l2_block or Routes kernel, and the up_0 head's unit0
and residual convs rather than their fold). So it is the same under any
Routes, use_kernels, compute dtype and device, and equals JAX's count with
VS_HEADFOLD=0. The forward runs on a copy of the model on the meta device:
no conv runs, and the caller's model is not touched.
"""

from __future__ import annotations

import copy
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vs_seg_tpu_torch.nn.layers import Conv3d, ConvTranspose3d, unfused

# Published bf16 dense tensor-core peak, FLOP/s, of one NVIDIA H100 80GB
# HBM3 (SXM) at a power limit of 700.00 W; a card set below that runs
# slower under load.
H100_PEAK_BF16 = 989e12


def _meta_copy(model: nn.Module) -> nn.Module:
    """A deep copy of `model` whose parameters and buffers are meta tensors
    of the same shapes; no data is copied."""
    memo = {}
    for p in model.parameters():
        memo[id(p)] = nn.Parameter(torch.empty_like(p, device="meta"),
                                   requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(model, memo)


def conv_flops_by_module(model: nn.Module, input_shape: Sequence[int]
                         ) -> List[Tuple[str, int]]:
    """(module path, FLOP) of every conv call of one eval forward at
    `input_shape` (N, D, H, W, C), in call order."""
    meta = _meta_copy(model)
    trace: List[Tuple[str, int]] = []

    def hook(name):
        def count(module, args, out):
            trace.append((name, 2 * out.numel()
                          * int(np.prod(module.kernel.shape[:4]))))
        return count

    for name, m in meta.named_modules():
        if isinstance(m, (Conv3d, ConvTranspose3d)):
            m.register_forward_hook(hook(name))
    x = torch.empty(tuple(int(v) for v in input_shape), device="meta")
    with torch.no_grad(), unfused():
        meta(x, use_kernels=False, train=False)
    return trace


def forward_conv_flops(model: nn.Module, input_shape: Sequence[int]) -> int:
    """Total conv FLOPs of one eval forward at `input_shape` (N,D,H,W,C)."""
    return int(sum(f for _, f in conv_flops_by_module(model, input_shape)))
