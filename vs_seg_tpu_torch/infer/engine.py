"""Whole-volume inference over a test set: the counterpart of
vs_seg_tpu/infer/engine.py (reference run_inference).

Per test case: Gaussian-blended sliding-window inference -> hard Dice vs the
label -> uint8 argmax on the device -> volumetry -> NIFTI export of the
argmax labelmap through the label's original affine and spatial shape ->
the centre-of-mass-slice 3-panel PNG. Afterwards: the Dice histogram and the
mean +- std log line.

With a mesh of more than one shard (parallel/mesh.py; cfg.sharded_inference
or cfg.spatial_inference builds make_mesh()) each volume runs over all of
its shards: under spatial_inference one window's H is split over them
(infer/spatial.py, sw_batch 1), otherwise the windows are
(infer/sharded.py). A one-device mesh takes the single-device path.

Spans (core/observability.py:span): infer.stage around a case's staging on
the staging thread; on the engine's thread infer.stage_wait (the wait for
the staged case), infer.forward_blend (the windowed forward and blend up
to its synchronise), infer.label_upload, infer.dice, infer.argmax_copy and
infer.volumetry (both volumes), each once a case.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.core.device import DTYPES, resolve_device
from vs_seg_tpu_torch.core.observability import span
from vs_seg_tpu_torch.data import nifti
from vs_seg_tpu_torch.eval import figures
from vs_seg_tpu_torch.eval.metrics import dice_score, segmentation_volume_ml
from vs_seg_tpu_torch.infer.sharded import sliding_window_inference_sharded
from vs_seg_tpu_torch.infer.sliding_window import (count_windows,
                                                   sliding_window_inference,
                                                   stage_volume)
from vs_seg_tpu_torch.infer.spatial import make_spatial_predictor
from vs_seg_tpu_torch.parallel.mesh import make_mesh, replicate

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


def run_inference(cfg, model: nn.Module, test_loader, *, device,
                  logger: Optional[logging.Logger] = None,
                  export: Optional[bool] = None, make_figures: bool = True,
                  use_kernels: bool = True, mesh=None):
    """Returns (dice_scores, compute seconds per volume).

    The predictor runs in cfg.infer_dtype under cfg.routes; use_kernels=False
    runs every kernel site with its plain PyTorch twin (make_predictor).
    Host prep and upload of case i+1 (one staging thread) overlap the
    compute of case i. A volume's time runs from its staged upload to its
    synchronised blended logits. `mesh` (a tuple of devices, or built by
    make_mesh(device=cfg.device) under either flag) of more than one shard
    runs spatial inference under cfg.spatial_inference, else window
    sharding with a per-shard batch of min(sw_batch_size, ceil(windows /
    shards))."""
    logger = logger or logging.getLogger()
    logger.info("Running inference...")
    device = resolve_device(device)
    export = cfg.export_inferred_segmentations if export is None else export
    dtype = DTYPES[cfg.infer_dtype]
    predictor = make_predictor(model, dtype, use_kernels=use_kernels,
                               routes=cfg.routes)
    quantize = bool(cfg.quantize_transfer)
    transfer_dtype = None if quantize or dtype == torch.float32 else dtype
    roi = cfg.sliding_window_inferer_roi_size

    if mesh is None and (cfg.sharded_inference or cfg.spatial_inference):
        mesh = make_mesh(device=device)
    n_shards = 1 if mesh is None else len(mesh)
    spatial = n_shards > 1 and cfg.spatial_inference
    sharded = n_shards > 1 and not spatial
    if spatial:
        logger.info("spatially sharded inference (H over %d shards)",
                    n_shards)
        predictor = make_spatial_predictor(model, mesh, dtype,
                                           use_kernels=use_kernels)
    if sharded:
        logger.info("sharded window inference over %d shards", n_shards)
        predictors = [make_predictor(m, dtype, use_kernels=use_kernels,
                                     routes=cfg.routes)
                      for m in replicate(model, mesh)]
    sw_batch = 1 if spatial else cfg.sw_batch_size

    def stage(data):
        with span("infer.stage"):
            image = np.transpose(data["image"][0], (1, 2, 3, 0))  # HWDC
            label = np.transpose(data["label"][0], (1, 2, 3, 0))
            per_shard = sw_batch
            if sharded:
                # the per-shard batch sized to this volume's windows: a
                # fixed sw_batch_size per shard would fill most shards with
                # masked padding windows
                n_win = count_windows(image.shape[:3], roi, cfg.sw_overlap)
                per_shard = max(1, min(sw_batch, -(-n_win // n_shards)))
            staged = stage_volume(image, roi, device=device,
                                  overlap=cfg.sw_overlap,
                                  sw_batch_size=(n_shards * per_shard
                                                 if sharded else per_shard),
                                  bucket=cfg.sw_bucket,
                                  transfer_dtype=transfer_dtype,
                                  quantize=quantize)
        return image, label, staged, data, per_shard

    pool = ThreadPoolExecutor(1)
    try:
        futures = deque()
        it = iter(test_loader)
        for data in it:
            futures.append(pool.submit(stage, data))
            if len(futures) >= 2:
                break

        dice_scores = np.zeros(len(test_loader))
        times = []
        i = -1
        while futures:
            i += 1
            data_next = next(it, None)
            if data_next is not None:
                futures.append(pool.submit(stage, data_next))
            logger.info("starting image %d", i)
            with span("infer.stage_wait"):
                (image, label, staged, data,
                 per_shard) = futures.popleft().result()

            with span("infer.forward_blend"):
                t0 = time.perf_counter()
                if sharded:
                    outputs = sliding_window_inference_sharded(
                        staged, roi, predictors, mesh,
                        overlap=cfg.sw_overlap, sw_batch_size=per_shard,
                        use_kernels=use_kernels)
                else:
                    outputs = sliding_window_inference(
                        staged, roi, predictor, overlap=cfg.sw_overlap,
                        sw_batch_size=per_shard, use_kernels=use_kernels)
                if device.type == "cuda":
                    for dev in set(mesh or (device,)):
                        torch.cuda.synchronize(dev)
                times.append(time.perf_counter() - t0)

            with span("infer.label_upload"):
                label_dev = torch.from_numpy(
                    np.ascontiguousarray(label)).to(device)
            with span("infer.dice"):
                dice = float(dice_score(outputs[None].float(),
                                        label_dev[None]))
            dice_scores[i] = dice
            logger.info("dice_score = %s", dice)

            # argmax on the device, moved to the host as uint8
            with span("infer.argmax_copy"):
                pred_argmax = outputs.argmax(-1).to(
                    torch.uint8).cpu().numpy()

            meta = data["label_meta"][0]
            with span("infer.volumetry"):
                pred_ml = segmentation_volume_ml(pred_argmax,
                                                 meta["affine"])
                gt_ml = segmentation_volume_ml(label[..., 0],
                                               meta["affine"])
            logger.info("volumetry: predicted = %.3f ml, ground truth = "
                        "%.3f ml", pred_ml, gt_ml)

            if export:
                logger.info("export to nifti...")
                folder_name = os.path.basename(
                    os.path.dirname(meta["filename_or_obj"]))
                out_dir = os.path.join(cfg.results_folder_path,
                                       "inferred_segmentations_nifti",
                                       folder_name)
                base = os.path.basename(meta["filename_or_obj"])
                base = base.replace(".nii.gz", "").replace(".nii", "")
                nifti.write_labelmap(
                    pred_argmax.astype(np.float32),
                    os.path.join(out_dir, base + ".nii.gz"),
                    affine=meta["affine"],
                    target_affine=meta["original_affine"],
                    target_shape=meta.get("spatial_shape"))

            if make_figures:
                figures.save_inference_panel(image[..., 0], label[..., 0],
                                             pred_argmax, dice, i,
                                             cfg.figures_path)
    finally:
        # release the staging thread and its pinned host buffers: repeated
        # run_inference calls in one process must not leak
        pool.shutdown(wait=False, cancel_futures=True)

    if make_figures:
        figures.save_dice_histogram(dice_scores, cfg.figures_path)
    logger.info("all_dice_scores = %s", dice_scores)
    logger.info("mean_dice_score = %s +- %s", dice_scores.mean(),
                dice_scores.std())
    if times:
        steady = times[1:] if len(times) > 1 else times
        logger.info("volumes/sec (steady-state) = %.3f",
                    1.0 / (sum(steady) / len(steady)))
    return dice_scores, times
