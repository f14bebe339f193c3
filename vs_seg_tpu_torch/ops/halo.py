"""Halo exchange over a volume whose H axis is split across the shards of
run_spmd (parallel/collectives.py); the counterpart of
vs_seg_tpu/ops/halo.py. Inside a shard, x is its LOCAL block of H rows
(axis 2 of (N, D, H, W, C)); shard k holds global rows [k hl, (k + 1) hl).

`exchange_halo` borrows neighbour rows (nn/layers.py's convs under
spatial_sharding call it) and `halo_block_input` builds the extended block
a fused block kernel (ops/rublock.py, ops/l2block.py) runs on unchanged.
`BLOCK_CALLS` counts the fused blocks dispatched on extended blocks (by
nn/blocks.py and models/unet2d5_spvpa.py), on every device.
"""

from __future__ import annotations

import torch

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.parallel import collectives

BLOCK_CALLS = {"ru_block": 0, "l2_block": 0}


def count_block(name: str) -> None:
    _build.count(count_block, "calls", name)


count_block.calls = BLOCK_CALLS


def exchange_halo(x: torch.Tensor, halo, axis: int = 2) -> torch.Tensor:
    """x with `halo` rows of its neighbours concatenated along `axis`:
    halo is an int (both sides) or (lo, hi). The lo rows below come from
    the previous shard's top rows, the hi rows above from the next shard's
    bottom rows (JAX's two ppermutes, here one exchange of both); the
    shards at the volume's edge receive zeros there (the dense conv's zero
    padding)."""
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    if lo == 0 and hi == 0:
        return x
    local = x.shape[axis]
    if max(lo, hi) > local:
        raise ValueError(f"halo {(lo, hi)} exceeds the local block of "
                         f"{local} rows")
    n = collectives.axis_size()
    idx = collectives.axis_index()
    values = collectives.exchange((x.narrow(axis, local - lo, lo) if lo
                                   else None,
                                   x.narrow(axis, 0, hi) if hi else None))

    def rows(k: int, side: int, count: int):
        if 0 <= k < n:
            return values[k][side].to(x.device)     # cat copies it
        shape = list(x.shape)
        shape[axis] = count
        return x.new_zeros(shape)

    parts = [x]
    if lo:
        parts.insert(0, rows(idx - 1, 0, lo))
    if hi:
        parts.append(rows(idx + 1, 1, hi))
    return torch.cat(parts, dim=axis)


def halo_block_input(x: torch.Tensor, h: int, axis: int = 2):
    """(x_ext, start): the extended block a fused kernel runs on, and the
    row of x_ext's output where the local rows start (narrow(axis, start,
    local)). Interior shards get [lo halo h, local, hi halo h] and keep
    [h, h + local). The shards at the volume's edge are rolled so that the
    local rows abut the kernel's own zero padding, which then falls on the
    physical edge as in the dense chain of same-padded convs: shard 0 gets
    [local, hi halo, zeros] and keeps [0, local), the last shard [zeros,
    lo halo, local] and keeps [2h, 2h + local)."""
    n = collectives.axis_size()
    idx = collectives.axis_index()
    x_ext = exchange_halo(x, (h, h), axis)
    shift = (-h if idx == 0 else 0) + (h if idx == n - 1 else 0)
    if shift:
        x_ext = torch.roll(x_ext, shift, dims=axis)
    return x_ext, h + shift

