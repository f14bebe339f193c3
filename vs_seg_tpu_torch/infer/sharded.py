"""Window-sharded sliding-window inference: one volume's windows split over
the shards of a mesh; the counterpart of vs_seg_tpu/infer/sharded.py.

Each shard (a thread of parallel/collectives.py:run_spmd) takes the staged
volume on its device and its own block of the padded window list, and for
each window batch predicts and blends into its own accumulators
(ops/blend.py: the hand-written kernel on CUDA); masked padding windows add
zero weight (infer/sliding_window.py:blend_windows, the single-device
loop). One reduce per accumulator sums the shards on the first shard, in
shard order (JAX's psum, whose result only the first shard uses here),
and the first shard divides, crops and transposes. JAX's weak-keyed
program cache exists for jit and is not ported.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

from vs_seg_tpu_torch.infer.sliding_window import (
    StagedVolume, blend_windows, finish_blend, stage_volume, volume_on)
from vs_seg_tpu_torch.ops import blend
from vs_seg_tpu_torch.parallel import collectives


def sliding_window_inference_sharded(
        volume, roi_size: Sequence[int],
        predictor: Union[Callable, Sequence[Callable]],
        mesh: Sequence[torch.device], *, overlap: float = 0.25,
        sw_batch_size: int = 1, mode: str = "gaussian",
        sigma_scale: float = 0.125, quantize: bool = False,
        use_kernels: bool = True) -> torch.Tensor:
    """Whole-volume inference with the windows split over `mesh`.

    volume: (H, W, D, C) host array (staged on mesh[0]) or a StagedVolume
    whose window list was padded to a multiple of len(mesh) (stage_volume
    with sw_batch_size = len(mesh) * sw_batch_size). predictor: one
    callable for every shard, or one per shard (each on its shard's
    device; infer/engine.py builds them from parallel/mesh.py:replicate).
    `sw_batch_size` is per shard. use_kernels=False blends with the plain
    twin of the blend kernel. Returns (H, W, D, out) f32 blended logits on
    the staged volume's device."""
    mesh = tuple(torch.device(d) for d in mesh)
    n_dev = len(mesh)
    preds_of = (list(predictor) if isinstance(predictor, (list, tuple))
                else [predictor] * n_dev)
    if len(preds_of) != n_dev:
        raise ValueError(f"{len(preds_of)} predictors for {n_dev} shards")
    if isinstance(volume, StagedVolume):
        staged = volume
    else:
        staged = stage_volume(volume, roi_size, device=mesh[0],
                              overlap=overlap,
                              sw_batch_size=n_dev * sw_batch_size,
                              quantize=quantize)
    roi = staged.roi_size
    n_pad = staged.starts_padded.shape[0]
    if n_pad % n_dev:
        raise ValueError(f"staged window list ({n_pad}) does not divide "
                         f"into {n_dev} shards")
    local_batches = -(-(n_pad // n_dev) // sw_batch_size)
    per_shard = local_batches * sw_batch_size
    # the padded list cut in n_dev blocks of per_shard windows, the tail
    # padded with masked windows at (0, 0, 0)
    total = n_dev * per_shard
    starts = np.zeros((total, 3), np.int32)
    starts[:n_pad] = staged.starts_padded
    mask = np.zeros(total, np.float32)
    mask[:n_pad] = staged.mask
    fn = blend.blend_scatter if use_kernels else blend.blend_scatter_plain

    def body():
        k = collectives.axis_index()
        vol, imp = volume_on(staged, mesh[k], mode, sigma_scale)
        blk = slice(k * per_shard, (k + 1) * per_shard)
        out_acc, w_acc = blend_windows(vol, roi, starts[blk], mask[blk],
                                       preds_of[k], fn, imp, sw_batch_size)
        out_acc = collectives.reduce(out_acc)
        w_acc = collectives.reduce(w_acc)
        return (finish_blend(out_acc, w_acc, staged.crops) if k == 0
                else None)

    out = collectives.run_spmd(body, mesh)[0]
    return out.to(staged.vol_dev.device)
