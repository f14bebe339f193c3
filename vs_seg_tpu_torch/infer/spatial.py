"""Spatially sharded inference: one window's H split across the shards of a
mesh; the counterpart of vs_seg_tpu/infer/spatial.py.

When a volume gives fewer windows than devices, window sharding
(infer/sharded.py) leaves devices idle; here ONE window runs on all of
them. Each shard (a thread of parallel/collectives.py:run_spmd) holds H / n
rows; under nn/layers.py:spatial_sharding every conv exchanges its halo
rows with the neighbours, and ru_block and l2_block run on halo-extended
blocks (nn/blocks.py, models/unet2d5_spvpa.py). The levels from
`pick_gather_level` down, whose H no longer divides over the shards, run
whole on every shard after one all_gather; the decoder takes each shard's
rows again where it crosses back. `spatial_forward` mirrors the model's
forward level by level, as the JAX package's does, and runs the same
modules; the opt-in routes are off in it, as JAX gates them off there.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
from torch import nn

from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.models.unet2d5_spvpa import UNet2d5_spvPA
from vs_seg_tpu_torch.nn.blocks import attention_gate
from vs_seg_tpu_torch.nn.layers import spatial_sharding
from vs_seg_tpu_torch.parallel import collectives
from vs_seg_tpu_torch.parallel.mesh import replicate


def spatial_forward(m: UNet2d5_spvPA, x: torch.Tensor, *, gather_level: int,
                    use_kernels: bool = True) -> torch.Tensor:
    """Eval forward of UNet2d5_spvPA on this shard's LOCAL H block (inside
    run_spmd): levels below gather_level run H-sharded, deeper ones whole
    after one all_gather, and the decoder re-slices this shard's rows
    where it crosses back. Returns the local logits."""
    n = m.n_levels
    shards = collectives.axis_size()
    kw = dict(use_kernels=use_kernels, routes=Routes())
    sharded = True

    def ctx():
        return spatial_sharding() if sharded else contextlib.nullcontext()

    skips = []
    for i in range(n):
        if i == gather_level and sharded:
            x = collectives.all_gather(x, dim=2)
            sharded = False
        with ctx():
            x = getattr(m, f"down_{i}")(x, **kw)
            skips.append(x)
            x = getattr(m, f"downsample_{i}")(x, **kw)
    if gather_level == n and sharded:
        x = collectives.all_gather(x, dim=2)
        sharded = False
    with ctx():
        if m.attention_module:
            _, x = m.bottom_att(x, gate=True, **kw)
        x = m.bottom(x, **kw)
    for i in reversed(range(n)):
        up = getattr(m, f"upsample_{i}")
        if not sharded and i < gather_level:
            # crossing back above the gather level: upsample whole, then
            # keep this shard's rows
            x = up(x, use_kernels=use_kernels)
            local = x.shape[2] // shards
            x = x.narrow(2, collectives.axis_index() * local,
                         local).contiguous()
            sharded = True
        else:
            with ctx():
                x = up(x, use_kernels=use_kernels)
        pair = (skips[i], x.to(skips[i].dtype))
        outc = m.out_channels if i == 0 else m.channels[i]
        with ctx():
            route = m._block_route(pair, i, outc, Routes())
            if route is not None:
                x, _ = m._block_apply(route, pair, i, use_kernels)
                continue
            if m.attention_module:
                _, pair = getattr(m, f"upatt_{i}")(pair, gate=True, **kw)
            x = getattr(m, f"up_{i}")(pair, **kw)
    return x


def pick_gather_level(model, h: int, n_shards: int) -> int:
    """The first level whose LOCAL H block would stop dividing cleanly: a
    shard must stay a multiple of the level's H stride and at least one row
    (vs_seg_tpu/infer/spatial.py:pick_gather_level). `model` has
    `strides`, (H, W, D) per level."""
    local = h // n_shards
    if h % n_shards:
        return 0
    for i, s in enumerate(model.strides):
        sh = s[0]
        if local % sh or local // sh < 1:
            return i
        local //= sh
    return len(model.strides)


def _net(model: nn.Module) -> UNet2d5_spvPA:
    net = getattr(model, "net", model)      # UNet2d5 holds the flagship
    if not isinstance(net, UNet2d5_spvPA):
        raise NotImplementedError(
            f"spatial inference runs the UNet2d5 family, not "
            f"{type(model).__name__}")
    return net


def make_spatial_predictor(model: nn.Module, mesh: Sequence[torch.device],
                           dtype=torch.bfloat16, use_kernels: bool = True
                           ) -> Callable:
    """(N, D, H, W, C) windows -> (N, D, H, W, out) logits with H split over
    the mesh's shards, on the windows' device: infer/engine.py:
    make_predictor's counterpart (run it at sw_batch_size 1: the shards
    already share one window). Where H does not divide at level 0 (gather
    level 0) it runs the plain forward of `model` on the windows' device."""
    mesh = tuple(torch.device(d) for d in mesh)
    model.eval()
    nets = [_net(m) for m in replicate(model, mesh)]
    for net in nets:
        net.eval()

    def predictor(wins: torch.Tensor) -> torch.Tensor:
        gather = pick_gather_level(nets[0], wins.shape[2], len(mesh))
        if gather == 0:
            with torch.no_grad():
                out = model(wins.to(dtype), use_kernels=use_kernels)
            return out[0] if isinstance(out, tuple) else out
        local = wins.shape[2] // len(mesh)

        def body():
            k = collectives.axis_index()
            xl = wins[:, :, k * local:(k + 1) * local].to(mesh[k], dtype)
            return spatial_forward(nets[k], xl.contiguous(),
                                   gather_level=gather,
                                   use_kernels=use_kernels)

        outs = collectives.run_spmd(body, mesh)
        return torch.cat([o.to(wins.device) for o in outs], dim=2)

    return predictor
