#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vs_seg_tpu_torch) on one NVIDIA GPU.

Run from the repo root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU path):
  1. The card's name and power limit (nvidia-smi), torch/CUDA versions, and
     the nvcc build of every kernel from vs_seg_tpu_torch/ops/csrc/ into
     build/vs_seg_tpu_torch/.
  2. Each hand-written kernel against its plain PyTorch twin on the card, at
     the flagship shapes of the whole-volume path (batch of 8 windows of
     384x384x64, D-first): the ring probe (csrc/ring.cuh, one (16,128) f32
     plane per depth slice of the volume, bit-equal), conv333 single and
     pair+residual, attgate, and the blend over
     the full 448x448x80 volume with its 8 overlapping windows (bit-equal,
     its v4 instance asserted; by CUDA-graph replay, with its event time
     and the host's enqueue beside it). Kernel and plain times come from
     CUDA events unless named otherwise. ru_block at down_2/3/4 and the
     bottom (RU_SITES: one launch of conv333.cu's unit kernel (ru_unit)
     each, its weights resident at down_2, its slabs staged elsewhere;
     bit-equal to the parent chain of two conv333 launches and over two
     runs, within KERNEL_TOL of its twin; by CUDA-graph replay beside that
     chain and the cuDNN chain of its two convs, with its bound and the
     host's enqueue). l2_block at up_2/up_3/up_4
     (L2B_SITES: conv333, attgate's att-only mode (att_map) and conv333's
     gated instance, one launch each; out and att bit-equal to the parent
     conv333 + attgate + conv333 chain and over two runs, within
     KERNEL_TOL of its twin; by CUDA-graph replay beside that chain and the
     cuDNN chain of its two convs, with its bound and the host's enqueue),
     and at up_2 att_map and the gated conv0 alone against their twins.
  3. The flagship UNet2d5_spvPA (channels 16..96) at full width from a seeded
     init with randomised BatchNorm statistics, over one seeded 448x448x80x1
     volume staged as uint8: sliding_window_inference (ROI 384x384x64,
     overlap 0.25, sw_batch_size 8, gaussian, D-first) through the kernels,
     with every launch counter reset just before and read just after; then
     the same volume through the all-plain path, compared in the bf16 band
     and by argmax agreement.
  4. ms/volume of both paths, each beside the card's name and power limit.
  5. The training kernels against their plain twins: conv333_dw (the wgrad)
     at down_2 unit1 (1,64,96,96) 48->48, upatt_2 conv2 48->1 and an up_3
     unit0 half (1,32,48,48) 64->64, each run twice and required bit-equal;
     the Conv333Train backward (dx through conv333, dw/db through
     conv333_dw) against plain autograd at down_2 unit0; then
     ops/bnorm_train.py's passes at the flagship's level-0 and level-1
     train sites (BN_SHAPES, dropout 0.1): stats and bwd_reduce within
     BN_SUM_TOL of float64 sums and bit-equal over two runs, the two
     finishes, apply (output and keep mask) and bwd_apply bit-equal to
     their twins given the same statistics; each pass's time beside its
     twin's and its byte bound, the word draw's, the whole site forward
     and backward beside the eager chain it replaced, and the host's
     cost of a site (the kernel record: the level-0 site).
  6. Training of the flagship at full width (384x384x64 crops, batch 1, bf16
     compute, f32 parameters): the first step's loss and every parameter's
     gradient on both paths from the same seeded weights and dropout seed,
     held to each other and to the same step in float32 (first_step_check:
     the loss within LOSS_TOL of float32's, the gradients' errors against
     float32 within GRAD_RATIO and GRAD_FAR of the plain path's);
     Trainer(cfg, model).init_state() -> fit() for one epoch of TRAIN_STEPS
     steps and a validation pass on each path, with the launch counters reset
     just before the kernel path's fit and read just after (bn_dropout_prelu
     LAUNCHES_PER_SITE x BN_SITES a step); then ms/step and peak memory of
     each path.
  7. The kd = 1 ("2.5D") route kernels against their plain twins at the
     flagship shapes of one 8-window batch: ru_block2d at down_0 (1->16) and
     down_1 (16->32) (RB_SITES; each also bit-equal over two runs and timed
     by CUDA-graph replay beside the two-conv333 chain it replaced, the
     cuDNN chain of its two convs, its bound and the host's enqueue),
     l2_block2d at the up_0 logit head (16||16->2; L2_SITES: one
     csrc/l2block2d.cu launch, out and att against its twin and the
     conv333 + attgate + conv333 chain it replaced, bit-equal over two
     runs, timed by CUDA-graph replay beside that chain, the cuDNN chain of
     its two convs, its bound and the host's enqueue) and at up_1
     (32||32->32, past the kernel's widths: the chain, and which path it
     took), tail_block at up_1 (32||32->32) and the up_0 head (16||16->2)
     (TAIL_SITES: one csrc/tail2d.cu launch given a1, out and att against
     its twin and the attgate + conv333 chain it replaced, bit-equal over
     two runs, timed by CUDA-graph replay beside that chain, cuDNN's conv0
     + 1x1 residual, its bound and the host's enqueue),
     fused_attention_gate (kd 1) at upatt_0 and upatt_1 and (kd 3) at the
     upatt_2 shape.
  8. The phase-3 volume under three route configurations (Routes), each
     through the kernels (launch counters reset just before, read just
     after, checked per site) and through the plain path: A = ru_block2d
     at down_0/1, l2_block2d at the up_0 head, tail_block at up_1 (one
     fused launch each); B =
     fused_attention_gate; C = ds_conv
     at downsample_2/3/4. Logits are held against the configuration's plain
     path and phase 3's default kernel path; ms/volume of each path; and a
     per-level split of one 8-window forward (CUDA events at the model's
     top-level modules) for the default routes, A and C.
  9. ds_conv (the (3,3,3) stride-(2,2,2) downsample) against its plain twin
     at the flagship's downsample_2/3/4 shapes of one 8-window batch: per
     site its device time (CUDA-graph replay), its back-to-back event time
     and the host's enqueue per call, beside one cuDNN strided conv (the
     library yardstick), the bound and TFLOP/s; a cProfile of its host
     path at downsample_4.
 10. The inference CLI end to end: CLI_CASES synthetic NIFTI test cases of
     448x448x80 (non-RAS affine) from the port's generate_dataset, phase
     3's weights saved as the port's checkpoint, `cli.inference.main` on
     cuda:0 under --routes dsconv (launch counters reset just before, read
     just after: ds_conv 3 per 8-window forward), then the same data
     through `run_inference(use_kernels=False)`; the exported NIFTIs read
     back with the original affine and shape, labelmaps and Dice of the
     two paths agree, and each path's compute seconds per volume. Figures
     are drawn when matplotlib is installed.
 11. conv333 at each of its sites (CONV_SITES): the 3 ungated launches
     of one 8-window forward, the 8 of ru_block's parent chains
     and the 3 conv0 of l2_block's parent chain,
     configuration A's kd = 1 conv sites and those of
     the chains its fused kernels replaced, and three train dgrad shapes,
     each against its plain twin, with the kernel's
     time, one channels-last F.conv3d's, the bound, TFLOP/s and GB/s, and
     the host's enqueue time of one call at the bottom site.
 12. The nine Mosaic probes of tools/mosaic_probe.py (csrc/mosaic_probe.cu)
     at the tool's shapes, every scheme of each (the group sums as a
     segmented shuffle, a shared-memory reduce and a tensor-core product):
     bit-equal to the twin on the tool's all-ones inputs, and on seeded
     normals within PROBE_TOL (bit-equal for 3droll and repeat); each
     scheme's time beside the case's bound, at the tool's shapes and with
     the leading size scaled by PROBE_SCALE.
 13. attgate at each of its sites (ATT_SITES: its att-only mode, l2_block's
     middle stage, at up_2/3/4; the gating mode in the chains that
     l2_block, tail_block and l2_block2d replaced, at up_2/3/4 (kd = 3),
     the up_1 tail and the up_0 head; B's upatt_0/1 at kd = 1) against
     its plain twin, with kernel, plain and bound ms, and its ms per
     volume under the default routes, A and B.
 14. conv333_dw at each of the TRAIN_SITES sites of one train step (taken
     by a hook on Conv333Train's wgrad during a full-width forward and
     backward, dw_train_sites): two runs bit-equal, within DW_TOL of the
     plain twin, the kernel's time beside cuDNN's wgrad, the bound,
     TFLOP/s and the host's enqueue time per call, and their sums.
 15. The training CLI end to end (`cli.train.main` in this process, its
     config_from_args wrapped to set the epochs: the reference CLI has no
     epochs flag) at full width on 384x384x64 crops of TRAIN_CLI_CASES + 1
     synthetic 448x448x80 cases: (i) the host loader, (ii) --device_cache,
     (iii) (i)'s last checkpoint resumed for one more epoch under
     --profile_steps 2; each with its launch counts (reset just before,
     read just after), finite losses, the checkpoints reloaded and the
     figures when matplotlib is found; ms/step by CUDA events from one
     step's end to the next (each epoch's first step left out; the first
     epoch synchronised by the CLI's train_loss line, later ones not) and
     each step's device ms; the trace's busy share, device ms by kernel
     family and its heaviest kernel names. Then the DeviceLoader: one epoch under
     torch.cuda.set_sync_debug_mode("error"), its crops at given draws
     bit-equal to the host transforms' crops, its upload seconds, device
     MiB and ms per batch; and to_device_batch's ms per crop beside the
     parent's order (the numpy transpose first), in turns.
 16. The rest of the model zoo at full width: UNet2d5 (the flagship without
     attention) and UNet (the vendored MONAI UNet, Config(model="UNet")'s
     defaults, also under Routes(dsconv=True)) over phase 3's volume
     through the kernels and the plain path, in the bf16 band and by
     argmax agreement, with their launch counts checked (ZOO_EVAL) and
     ms/volume; one train step of each (384x384x64, batch 1, bf16) held by
     first_step_check, conv333, conv333_dw (ZOO_TRAIN_SITES) and
     bn_dropout_prelu launches checked, ms/step and peak memory; phase 6's
     flagship step with and without --remat (loss and generator state
     equal, the largest gradient difference, the recompute's extra
     bn_dropout_prelu launches, ms/step and peak memory both ways); blend_scatter with the constant importance
     map and with sigma_scale 0.25 bit-equal to its twin.
 17. Multi-shard inference (parallel/, infer/sharded.py, infer/spatial.py)
     with phase 3's weights and volume on meshes that repeat cuda:0, N
     shards on the one card (the shard machinery, not a multi-GPU
     speed-up): (a) window-sharded at 2 and 4 shards, default routes,
     against phase 3's default logits in the bf16 band and (logged)
     against the single-device path at the shards' own batch, and the
     plain float32 path at 2 and 4 shards against the single-device plain
     float32 path within SHARD_F32_TOL; (b) H-sharded at 2 and 4 shards, 8 windows
     at sw_batch 1, in the same band, with ru_block and l2_block counted
     on halo-extended blocks and, at 4 shards, ru_block at down_2 and
     l2_block at up_2 on one extended block against their plain twins by
     phase 2's rule; (c) cli.inference with --sharded_inference and with
     --spatial_inference (and phase 10's --routes dsconv) on phase 10's
     cases on the card's one-device mesh, labelmaps equal to phase 10's
     flagless run's; (d) ms/volume of (a) and
     (b) at 1, 2 and 4 shards (and of the single-device path at sw_batch
     1, (b)'s batch), the summed barrier waits and the host seconds in
     the reduce, all_gather and the halo exchanges, the device ms of one
     reduce of the accumulators and one all_gather, and one volume of (b)
     and of the single-device path under torch.profiler: wall ms against
     summed device ms (the host's share) and the heaviest kernels.
 18. Data-parallel training (parallel/distributed.py) on DP_RANKS ranks
     that share cuda:0 over gloo (the multi-rank code on the one card, not
     a speed-up): (a) the flagship at full width (384x384x64, bf16,
     dropout 0), global batch DP_BATCH, each rank a spawned process
     (distributed.launch) running its row through the kernels under
     DistributedDataParallel with BatchNorm on global statistics: the
     first step's loss within DP_LOSS_TOL of one process's batch-DP_BATCH
     step on the card, the all-reduced gradients no further from the same
     step in float32 than that step's (grads_vs_float32), parameters,
     BatchNorm buffers and gradients bit-identical across the ranks,
     conv333 and conv333_dw counted at TRAIN_SITES each and
     bn_dropout_prelu at LAUNCHES_PER_SITE x BN_SITES per rank; (c) ms/step at one process and at DP_RANKS ranks, peak
     memory, and the bytes a step all-reduces (DDP's gradients, BatchNorm's
     statistics); (b) the training CLI under torchrun on DP_CLI_CASES of
     phase 15's training cases and its validation case:
     2 ranks on cuda:0 (gloo), rank 0's log, checkpoints and figures, then
     --resume, then 1 rank on `--device cuda` (NCCL).
 19. The reference's pipeline from DICOM to labelmap: a synthetic TCIA
     download (tests/tcia_download.py, with tests/test_preprocessing.py's
     DICOM writers) of PIPE_CASES cases, each a T2 series of 80 slices at
     448x448 and a T1 series of 120 slices at 512x512 (int16, their own
     spacings, oblique-free), an RTSTRUCT, RTPLAN and RTDOSE each and the
     pair's translation .tfm; `python -m vs_seg_tpu_torch.preprocessing`
     restructure, then one `convert --register T2` per case at once into
     <root>/data/input_data, with `bids` on PIPE_BIDS_CASES beside them;
     `cli.train` for 1 epoch at full width (384x384x64, bf16) on 2 cases
     plus 1 validation case; the trained weights written as a reference
     .pth and put through `compat.convert_checkpoint`; `cli.inference` on
     the 3 cases from both checkpoints. Checked: the converted T2 equals
     the written pixels and the registered T1's tumour lies on the T2's;
     the training CLI read its NIFTIs natively (the native counters above
     0); launch counts (conv333_dw = 25 x steps; ru_block, l2_block and
     blend per forward); the converted checkpoint bit-equal to the trained
     weights; the labelmaps on the original affine and shape and equal
     from both checkpoints; every NIFTI the pipeline wrote decoded by the
     native reader bit-equal to the gzip and numpy twin, with the decode
     MB/s of each; each stage's seconds.
 20. No timed run: the conv FLOP of a 384x384x64 window of UNet2d5_spvPA
     (counted after phase 3 and again after phase 8's configurations A,
     B and C, required equal), UNet2d5 and UNet
     (vs_seg_tpu_torch/eval/flops.py, on a meta copy; each model's state
     bit-equal on the card after it); TFLOP/s and MFU against
     H100_PEAK_BF16 of every ms/volume phases 3, 8 and 16 measured (a
     JSON line {"mfu": ...}); and the bf16 and f32 FLOP each kernel
     record's bound received at its site beside the count of the conv
     modules it covers (BOUND_SITES; the bf16 FLOP required equal).

The kernels are built in parallel, one nvcc per source. Every kernel record
carries its time, its plain twin's, the time of one library call computing
the same function where there is one, and its bound: the larger of the
bytes it must move (inputs read once, outputs written once) over the HBM
rate and its operations over the peak rate for their type (H100 SXM, dense:
989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32, 3.35 TB/s). The last stdout
line is {"ok": true, "device": {...}}; the line before it is the per-kernel
JSON record, whose launch counts add up every main path (phases 3, 6, 8,
10, 15, 16, 17, 18 and 19).
"""

from __future__ import annotations

import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SEED = 0
# bf16 tolerance, kernel vs plain twin on the same inputs: both round to
# bf16 (the plain twin rounds each conv output before its f32 epilogue, the
# kernel rounds once after it) and sum in another order, so they differ by a
# few bf16 ulps (2^-8 relative) of the largest outputs.
KERNEL_TOL = 2e-2        # max|kernel - plain| / max|plain|
BLEND_TOL = 0.0          # same f32 operation order in both: bit for bit
LOGIT_TOL = 3e-2         # whole path: max|kernel - plain| / max|plain| logits
ARGMAX_MIN = 0.995       # voxelwise argmax agreement, kernel vs plain path
# conv333_dw vs its plain twin: both sum the same bf16 products exactly in
# float32 and differ only in the order of ~0.6 M additions per output.
DW_TOL = 1e-4
# --remat against none, gradients of the first step from the same weights
# and dropout masks: held per parameter tensor against its own largest
# gradient, and for the conv biases in front of a train-mode BatchNorm
# (whose gradient is zero in exact arithmetic, so only rounding noise is
# left) against the model's largest gradient.
GRAD_TOL = 5e-2
# A bf16 step's gradients against the same step in float32, one relative
# error a tensor (grad_errors, the PReLU slopes against the model's
# largest): their median and 90th percentile over the model within
# GRAD_RATIO times another bf16 step's, their furthest within GRAD_FAR
# times its furthest (grads_vs_float32; the kernel path against the plain
# path on the CPU at 128x128x32, six seeds and models: 0.48-0.95 and
# 0.33-1.27).
GRAD_RATIO = 1.5
GRAD_FAR = 2.0
# The first step's loss, kernel path against the same step's plain float32
# loss: the two bf16 paths round the train-mode BatchNorm -> dropout ->
# PReLU at other points (ops/bnorm_train.py once, at its output; the eager
# chain after each of the three), so neither is bit-equal to the other.
# The kernel path passes within LOSS_TOL of float32, or no further from it
# than twice the plain bf16 path.
LOSS_TOL = 1e-3
# Epoch-mean train loss of the two fits of phase 6: their first steps a
# few 1e-5 apart, then a few Adam steps.
FIT_LOSS_TOL = 1e-3
# The kernel path's first-step gradients against float32, one relative error
# a tensor (grad_errors): their median and 90th percentile over the model
# within GRAD_RATIO times the plain bf16 path's, their furthest within
# GRAD_FAR times its furthest (first_step_check; on the CPU at 128x128x32,
# six seeds and models: 0.48-0.95 and 0.33-1.27).
GRAD_RATIO = 1.5
GRAD_FAR = 2.0
# The first step's loss, kernel path against the same step's plain float32
# loss: the two bf16 paths round the train-mode BatchNorm -> dropout ->
# PReLU at other points (ops/bnorm_train.py once, at its output; the eager
# chain after each of the three), so neither is bit-equal to the other.
# The kernel path passes within LOSS_TOL of float32, or no further from it
# than twice the plain bf16 path.
LOSS_TOL = 1e-3
ROI = (384, 384, 64)     # (H, W, D)
VOLUME = (448, 448, 80)  # (H, W, D)
SW_BATCH = 8
REPS = 5
TRAIN_STEPS = 3          # Adam steps of the fit in phase 6
STEP_REPS = 3            # timed train steps per path and turn
# (3,3,3) stride-1 conv sites of the flagship's train forward, pair halves
# counted apart: down_2/3/4 x 2, upatt_2/3/4 x 3, up_2/3/4 x 2, bottom_att x
# 2, bottom x 2.
TRAIN_SITES = 25
# train Convolutions of the flagship with BatchNorm and PReLU, each one
# ops/bnorm_train.py site (LAUNCHES_PER_SITE launches a step): down_0..4 and
# the bottom x 2, downsample_0..4, upsample_0..4, up_1..4
BN_SITES = 26
# ops/bnorm_train.py's passes at the flagship's level-0 and level-1 train
# sites (a 384x384x64 crop, batch 1, D-first), dropout BN_RATE
BN_SHAPES = (("level 0", (1, ROI[2], ROI[0], ROI[1], 16)),
             ("level 1", (1, ROI[2], ROI[0] // 2, ROI[1] // 2, 32)))
BN_RATE = 0.1
# a pass's f32 sums (stats, bwd_reduce) against float64 sums of the twin's
# terms: within BN_SUM_TOL of the sum of |terms| (the order differs)
BN_SUM_TOL = 1e-5
# the host's cost of a site: chains of BN_HOST_CHAIN sites at a shape small
# enough that the card waits on the host, forward and one backward
BN_HOST_SHAPE = (1, 4, 16, 16, 16)
BN_HOST_CHAIN = 10
# conv333 launches of one eval forward of one crop: the 3 l2_blocks' conv1;
# their conv0 is the gated instance, with attgate's att-only mode (att_map)
# before it: 3 each. Each of the 4 ru_blocks (down_2, down_3, down_4, the
# bottom) is one launch of conv333.cu's unit kernel (ru_unit).
EVAL_CONV333 = 3
EVAL_RU = {"ru_block": 4, "ru_unit": 4}
EVAL_L2 = {"l2_block": 3, "att_map": 3, "conv333_gated": 3, "attgate": 0}
# Published H100 SXM peaks (dense) for the kernels' bounds; the bf16 tensor
# core peak is vs_seg_tpu_torch/eval/flops.py:H100_PEAK_BF16 (989 TFLOP/s).
PEAK_F32 = 67e12         # FLOP/s, CUDA cores
HBM_RATE = 3.35e12       # bytes/s
SHARDS = (1, 2, 4)       # phase 17's meshes: (cuda:0,) * n
# phase 17, plain float32 at 2 and 4 shards vs 1: the same windows and
# convs, the blend's sums in another order (its shards' accumulators, then
# their reduce)
SHARD_F32_TOL = 1e-5

REPO = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean device time of fn() over `reps` launches after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    """Bytes of the tensors given (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(moved: int, bf16_flop: float = 0.0, f32_flop: float = 0.0):
    """(bound_ms, bound_by, bytes, bf16 FLOP, f32 FLOP): the larger of
    `moved` bytes over the HBM rate and the operations over the peak rate
    for their type."""
    from vs_seg_tpu_torch.eval.flops import H100_PEAK_BF16
    t_bytes = moved / HBM_RATE
    t_ops = bf16_flop / H100_PEAK_BF16 + f32_flop / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", moved, bf16_flop,
            f32_flop)


def compare(name: str, got, ref, tol: float) -> float:
    """Raise unless max|got - ref| <= tol * max|ref|; return max|got - ref|.
    """
    import torch
    got = got.detach().float()
    ref = ref.detach().float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"  {name}: max_abs_err {err!r} max|plain| {scale!r} "
        f"rel {err / max(scale, 1e-30)!r} (tol {tol!r})")
    if err > tol * scale:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin: "
                             f"{err} > {tol} * {scale}")
    return err


def kernel_checks(dev, gen, card: str):
    """Phase 2: each kernel vs its plain twin at the flagship shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vs_seg_tpu_torch.infer.sliding_window import (
        dense_patch_starts, gaussian_importance_map)
    from vs_seg_tpu_torch.ops import (blend, conv333, l2block, ring_probe,
                                      rublock)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def weight(k, cin, cout, g=gen):
        b = 1.0 / np.sqrt(cin * int(np.prod(k)))
        return ((torch.rand((*k, cin, cout), generator=g) * 2 - 1) * b
                ).to(dev)

    def vec(c, lo, hi, g=gen):
        return (torch.rand(c, generator=g) * (hi - lo) + lo).to(dev)

    def l2_args(c, g):
        return dict(w1=weight((3, 3, 3), 2 * c, c, g), b1=vec(c, -.2, .2, g),
                    w2=weight((3, 3, 3), c, 1, g), b2=vec(1, -.2, .2, g),
                    w0=weight((3, 3, 3), 2 * c, c, g),
                    bn_scale=vec(c, .5, 1.5, g), bn_shift=vec(c, -.2, .2, g),
                    alpha=vec(1, .1, .3, g), wr=weight((1, 1, 1), 2 * c, c, g),
                    br=vec(c, -.2, .2, g))

    rec = {}
    B = SW_BATCH
    # the ring probe (csrc/ring.cuh): one plane per depth slice of the
    # volume, bit-equal to its twin; drawn from its own generator, so the
    # later phases' draws (the model's weights among them) stay as they were
    xp = torch.randn((VOLUME[2] * 16, 128),
                     generator=torch.Generator().manual_seed(SEED + 1)).to(dev)
    got = ring_probe.ring_probe(xp)
    e0 = compare(f"ring_probe {VOLUME[2]} planes of (16,128) f32", got,
                 ring_probe.ring_probe_plain(xp), 0.0)
    if not torch.equal(got, ring_probe.ring_probe_plain(xp)):
        raise AssertionError("ring_probe: not bit-equal to its twin")
    rec["ring_probe"] = dict(
        max_abs_err=e0, shape=f"{VOLUME[2]} planes of (16,128) f32",
        ms=cuda_ms(lambda: ring_probe.ring_probe(xp)),
        plain_ms=cuda_ms(lambda: ring_probe.ring_probe_plain(xp)),
        library_ms=None,
        bound=bound(2 * nbytes(xp), f32_flop=3 * xp.numel()))
    # conv333, single input + epilogue, at down_2 unit0 (32 -> 48)
    x = randn(B, 64, 96, 96, 32)
    w = weight((3, 3, 3), 32, 48)
    s, h, a = vec(48, .5, 1.5), vec(48, -.2, .2), vec(1, .1, .3)
    e1 = compare("conv333 down_2 unit0 (8,64,96,96,32)->48",
                 conv333.conv333(x, w, s, h, a),
                 conv333.conv333_plain(x, w, s, h, a), KERNEL_TOL)
    k_ms = cuda_ms(lambda: conv333.conv333(x, w, s, h, a))
    p_ms = cuda_ms(lambda: conv333.conv333_plain(x, w, s, h, a))
    # the library yardstick: one cuDNN conv (+ bias) on the same input
    wt = w.to(torch.bfloat16).permute(4, 3, 2, 0, 1).contiguous()
    hb = h.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), wt, hb,
                                      padding=1))
    vox = x[..., 0].numel()
    c_bound = bound(nbytes(x, w, s, h, a) + vox * 48 * 2,
                    2 * 27 * 32 * 48 * vox)
    # pair input + fused pair residual, at up_2 unit0 (48+48 -> 48)
    ga, gb = randn(B, 64, 96, 96, 48), randn(B, 64, 96, 96, 48)
    w = weight((3, 3, 3), 96, 48)
    res = ((ga, gb), weight((1, 1, 1), 96, 48), vec(48, -.2, .2))
    e2 = compare("conv333 up_2 unit0 pair+residual (8,64,96,96,48)x2->48",
                 conv333.conv333((ga, gb), w, s, h, a, residual=res),
                 conv333.conv333_plain((ga, gb), w, s, h, a, residual=res),
                 KERNEL_TOL)
    rec["conv333"] = dict(max_abs_err=max(e1, e2), ms=k_ms, plain_ms=p_ms,
                          shape="down_2 unit0 (8,64,96,96,32)->48",
                          library_ms=lib_ms, bound=c_bound)

    # attgate at up_2 (C = 48)
    a1 = randn(B, 64, 96, 96, 48).abs()
    w2, b2 = weight((3, 3, 3), 48, 1), vec(1, -.2, .2)
    got = l2block.attgate(a1, w2, b2, ga, gb)
    ref = l2block.attgate_plain(a1, w2, b2, ga, gb)
    e = max(compare(f"attgate up_2 {n} (8,64,96,96,48)", g, r, KERNEL_TOL)
            for n, g, r in zip(("att", "ga", "gb"), got, ref))
    rec["attgate"] = dict(
        max_abs_err=e, shape="up_2 (8,64,96,96,48)",
        ms=cuda_ms(lambda: l2block.attgate(a1, w2, b2, ga, gb)),
        plain_ms=cuda_ms(lambda: l2block.attgate_plain(a1, w2, b2, ga, gb)),
        library_ms=None,
        bound=bound(nbytes(a1, ga, gb, w2, b2, *got),
                    f32_flop=(2 * 27 + 4) * 48 * vox))
    del a1

    # ru_block at its four sites (RU_SITES): down_2 and down_3 drawn from
    # gen as before, down_4 and the bottom from their own generator, so the
    # later phases' draws stay as they were
    errs = []
    g4 = torch.Generator().manual_seed(SEED + 8)
    for site, shape, cin, cout in RU_SITES:
        g = gen if site in ("down_2", "down_3") else g4
        xr = torch.randn((*shape, cin), generator=g).to(dev, torch.bfloat16)
        kw = ru_site_args(dev, g, cin, cout)
        row = ru_site(site, xr, kw, card)
        errs.append(row["max_abs_err"])
        if site == "down_2":
            for k in ("ru_block", "ru_unit"):
                rec[k] = dict(shape=f"down_2 {shape}x{cin}->{cout}",
                              ms=row["ms"], plain_ms=row["plain_ms"],
                              library_ms=None, bound=row["bound"],
                              max_abs_err=row["max_abs_err"])
        del xr, kw
    rec["ru_block"]["max_abs_err"] = max(errs)

    # l2_block at its three sites (L2B_SITES): up_2 and up_3 drawn from
    # gen as before, up_4 from its own generator, so the later phases'
    # draws stay as they were
    errs = []
    for site, shape, c in L2B_SITES:
        g = gen if site != "up_4" else torch.Generator().manual_seed(SEED + 7)
        xa, xb = (torch.randn((*shape, c), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        kw = l2_args(c, g)
        row = l2b_site(site, xa, xb, kw, card)
        errs.append(row["max_abs_err"])
        if site == "up_2":
            rec["l2_block"] = dict(
                shape=f"up_2 {shape}x{c}x2", ms=row["ms"],
                plain_ms=row["plain_ms"], library_ms=None, bound=row["bound"])
            rec.update(l2_parts(xa, xb, kw))
    rec["l2_block"]["max_abs_err"] = max(errs)
    del xa, xb, ga, gb, x

    # blend over the full volume (D-first) with its 8 overlapping windows
    vol = (VOLUME[2], VOLUME[0], VOLUME[1])
    roi = (ROI[2], ROI[0], ROI[1])
    starts = dense_patch_starts(vol, roi, 0.25)
    assert len(starts) == SW_BATCH, starts
    mask = np.ones(len(starts), np.float32)
    imp = torch.from_numpy(gaussian_importance_map(roi)).to(dev)
    preds = randn(len(starts), *roi, 2)
    out0 = torch.rand((*vol, 2), generator=gen).to(dev)
    w0 = torch.rand((*vol, 1), generator=gen).to(dev)
    before = dict(blend.blend_scatter.instances)
    ko, kwt = blend.blend_scatter(out0.clone(), w0.clone(), preds, starts,
                                  mask, imp)
    took = {k: v - before[k] for k, v in blend.blend_scatter.instances.items()}
    if took != {"v4": 1, "v1": 0}:
        raise AssertionError(f"blend: the flagship geometry took {took} "
                             "launches, expected one of the v4 instance")
    po, pw = blend.blend_scatter_plain(out0.clone(), w0.clone(), preds,
                                       starts, mask, imp)
    e = max(compare("blend out_acc (80,448,448,2) 8 windows", ko, po,
                    BLEND_TOL),
            compare("blend w_acc (80,448,448,1) 8 windows", kwt, pw,
                    BLEND_TOL))
    oa, wa = out0.clone(), w0.clone()

    def run():
        blend.blend_scatter(oa, wa, preds, starts, mask, imp)

    rec["blend_scatter"] = dict(
        max_abs_err=e, shape="(80,448,448,2) <- 8 x (64,384,384,2)",
        ms=graph_ms(run),
        plain_ms=cuda_ms(lambda: blend.blend_scatter_plain(
            oa, wa, preds, starts, mask, imp)),
        library_ms=None,
        # the accumulators are read and written; per window voxel and
        # channel a multiply-add, per voxel the weight and its sum
        bound=bound(nbytes(preds, imp) + 2 * nbytes(out0, w0),
                    f32_flop=preds[..., 0].numel() * (2 * 2 + 2)))
    r = rec["blend_scatter"]
    log(f"  blend_scatter: instance v4, {r['ms']!r} ms device (graph "
        f"replay), {cuda_ms(run)!r} ms by events back to back, host "
        f"enqueue {host_ms(run)!r} ms a call, plain {r['plain_ms']!r} ms, "
        f"bound {r['bound'][0]!r} ms on {card}")
    torch.cuda.synchronize()
    return rec


def _counters():
    """Every launch counter: name -> (wrapper, attribute). conv333 counts
    its ungated launches in .launches, its gated ones in .gated_launches."""
    from vs_seg_tpu_torch.ops import (att, blend, block2d, bnorm_train,
                                      conv333, conv333_dw, dsconv, l2block,
                                      mosaic_probe, ring_probe, rublock,
                                      tail2d)
    fns = {"conv333": conv333.conv333, "attgate": l2block.attgate,
           "att_map": l2block.att_map,
           "ru_block": rublock.ru_block, "ru_unit": rublock.ru_unit,
           "l2_block": l2block.l2_block,
           "blend_scatter": blend.blend_scatter,
           "conv333_dw": conv333_dw.conv333_dw,
           "ru_block2d": block2d.ru_block2d,
           "l2_block2d": block2d.l2_block2d,
           "tail_block": tail2d.tail_block,
           "fused_attention_gate": att.fused_attention_gate,
           "ds_conv": dsconv.ds_conv, "ring_probe": ring_probe.ring_probe,
           "mosaic_probe": mosaic_probe.probe,
           "bn_dropout_prelu": bnorm_train.bn_dropout_prelu}
    out = {k: (fn, "launches") for k, fn in fns.items()}
    out["conv333_gated"] = (conv333.conv333, "gated_launches")
    return out


# launches of the routed kernels in a run that takes no route (and of the
# probes, which are on no path, and of the train tails, which no inference
# runs; a train run's expectation sets bn_dropout_prelu after it)
NO_KD1 = {"ru_block2d": 0, "l2_block2d": 0, "tail_block": 0,
          "fused_attention_gate": 0, "ds_conv": 0, "ring_probe": 0,
          "mosaic_probe": 0, "bn_dropout_prelu": 0}


def bn_sites(module) -> int:
    """The train Convolutions of `module` that take ops/bnorm_train.py
    (BatchNorm and PReLU, on the kernel path)."""
    from vs_seg_tpu_torch.nn.blocks import Convolution
    return sum(1 for m in module.modules()
               if isinstance(m, Convolution) and m._fused_train(True))


def bn_launches(steps: int, sites: int = BN_SITES) -> dict:
    """bn_dropout_prelu's expected launches in `steps` train steps of a
    model with `sites` sites."""
    from vs_seg_tpu_torch.ops.bnorm_train import LAUNCHES_PER_SITE
    return {"bn_dropout_prelu": LAUNCHES_PER_SITE * sites * steps}


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def check_counts(counts, expect, path: str):
    log(f"  launch counts in the counted {path} run: {counts}")
    for k, n in expect.items():
        if counts[k] != n:
            raise AssertionError(f"{k}: {counts[k]} launches in the {path} "
                                 f"run, expected {n} (one per site)")


def randomise_bn(model, gen) -> None:
    """Seeded BatchNorm running statistics (mean ~ N(0, 0.1), var in [0.5,
    1.5)), so the eval fold is not the identity."""
    import torch

    from vs_seg_tpu_torch.nn.layers import BatchNorm
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.mean.numel()
                m.mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.var.copy_(torch.rand(c, generator=gen) + 0.5)


def volume_paths(model, staged, routes, expect, card: str, tag: str):
    """One model over the staged flagship volume through the kernels and
    through the plain path (turns plain, kernel, kernel, plain; the
    counters reset just before the first kernel turn, read just after):
    logits in the bf16 band and by argmax agreement. Returns (counts, the
    kernel path's logits, (kernel ms/volume, plain ms/volume))."""
    import torch

    from vs_seg_tpu_torch.infer.engine import make_predictor
    from vs_seg_tpu_torch.infer.sliding_window import sliding_window_inference

    def run(use_kernels: bool):
        pred = make_predictor(model, torch.bfloat16, use_kernels=use_kernels,
                              routes=routes)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sliding_window_inference(
            staged, ROI, pred, overlap=0.25, sw_batch_size=SW_BATCH,
            use_kernels=use_kernels)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    run(True)      # warm-up: first launches, cuDNN algorithm choice
    run(False)
    times = {True: [], False: []}
    outs, counts = {}, None
    for use_kernels in (False, True, True, False):
        if use_kernels and counts is None:
            reset_counts()
            outs[True], ms = run(True)
            counts = read_counts()
        else:
            outs[use_kernels], ms = run(use_kernels)
        times[use_kernels].append(ms)
    check_counts(counts, expect, tag)
    ko, po = outs[True], outs[False]
    if tuple(ko.shape) != (*VOLUME, 2):
        raise AssertionError(f"{tag}: output shape {tuple(ko.shape)}")
    if not torch.isfinite(ko).all() or not torch.isfinite(po).all():
        raise AssertionError(f"{tag}: non-finite logits")
    compare(f"{tag}: whole-volume logits, kernel path vs plain path", ko, po,
            LOGIT_TOL)
    agree = float((ko.argmax(-1) == po.argmax(-1)).float().mean())
    log(f"  {tag}: argmax agreement {agree!r} (min {ARGMAX_MIN})")
    if agree < ARGMAX_MIN:
        raise AssertionError(f"{tag}: argmax agreement {agree} < "
                             f"{ARGMAX_MIN}")
    k_ms = sum(times[True]) / 2
    p_ms = sum(times[False]) / 2
    log(f"  {tag}: kernel path {k_ms:.1f} ms/volume {times[True]}, plain "
        f"path {p_ms:.1f} ms/volume {times[False]} on {card}")
    return counts, ko, (k_ms, p_ms)


def model_run(dev, gen, card: str):
    """Phase 3-4: the flagship whole-volume path, kernels vs plain. Returns
    (counts, model, staged volume, kernel path's logits, (kernel, plain)
    ms/volume)."""
    import numpy as np
    import torch

    from vs_seg_tpu_torch.core.config import Routes
    from vs_seg_tpu_torch.infer.sliding_window import stage_volume
    from vs_seg_tpu_torch.models import UNet2d5_spvPA

    model = UNet2d5_spvPA(dtype=torch.bfloat16, device=dev, generator=gen)
    randomise_bn(model, gen)
    rng = np.random.default_rng(SEED)
    volume = rng.normal(size=(*VOLUME, 1)).astype(np.float32)
    t0 = time.perf_counter()
    staged = stage_volume(volume, ROI, device=dev, overlap=0.25,
                          sw_batch_size=SW_BATCH, quantize=True)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    assert len(staged.starts_padded) == SW_BATCH
    # the model's own sites: 4 encoder units (down_2, down_3, down_4,
    # bottom), 3 decoder levels (up_2, up_3, up_4), 1 window batch
    expect = {**EVAL_RU, **EVAL_L2, "conv333": EVAL_CONV333,
              "blend_scatter": 1, "conv333_dw": 0, **NO_KD1}
    counts, ko, ms = volume_paths(model, staged, Routes(), expect, card,
                                  "inference")
    log(f"staging (host prep + upload) {stage_ms:.1f} ms; card: {card}")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB on {card}")
    return counts, model, staged, ko, ms


def train_kernel_checks(dev, gen, card: str):
    """Phase 5: conv333_dw and the Conv333Train backward vs plain."""
    import torch

    from vs_seg_tpu_torch.ops import conv333_dw as dwm
    from vs_seg_tpu_torch.ops import train_conv

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    rec, errs = {}, []
    for name, shape, cin, cout in (
            ("down_2 unit1", (1, 64, 96, 96), 48, 48),
            ("upatt_2 conv2", (1, 64, 96, 96), 48, 1),
            ("up_3 unit0 half", (1, 32, 48, 48), 64, 64)):
        x, dy = randn(*shape, cin), randn(*shape, cout)
        dw, db = dwm.conv333_dw(x, dy)
        dw2, db2 = dwm.conv333_dw(x, dy)
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            raise AssertionError(f"conv333_dw {name}: two runs differ")
        pdw, pdb = dwm.conv333_dw_plain(x, dy)
        tag = f"conv333_dw {name} {shape}x{cin}->{cout}"
        errs.append(max(compare(tag + " dw", dw, pdw, DW_TOL),
                        compare(tag + " db", db, pdb, DW_TOL)))
        if not rec:
            ms = cuda_ms(lambda: dwm.conv333_dw(x, dy))
            flop = 2 * 27 * cin * cout * x[..., 0].numel()
            log(f"  {tag}: {flop / 1e9:.1f} GFLOP, kernel {ms!r} ms = "
                f"{flop / ms / 1e9!r} TFLOP/s on {card}")
            # the library yardstick: cuDNN's wgrad on the same bf16 input
            lib_ms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(
                x.permute(0, 4, 1, 2, 3), (cout, cin, 3, 3, 3),
                dy.permute(0, 4, 1, 2, 3), padding=1))
            rec["conv333_dw"] = dict(
                shape=tag, ms=ms,
                plain_ms=cuda_ms(lambda: dwm.conv333_dw_plain(x, dy)),
                library_ms=lib_ms,
                bound=bound(nbytes(x, dy, dw, db), flop))
    rec["conv333_dw"]["max_abs_err"] = max(errs)
    log("  conv333_dw: bit-equal over two runs at all three shapes")

    # the Function's backward against plain autograd, down_2 unit0 (32->48)
    x = randn(1, 64, 96, 96, 32).requires_grad_()
    w = ((torch.rand((3, 3, 3, 32, 48), generator=gen) * 2 - 1) / 864 ** .5
         ).to(dev).requires_grad_()
    b = (torch.rand(48, generator=gen) * .4 - .2).to(dev).requires_grad_()
    dy = randn(1, 64, 96, 96, 48)
    ys, grads, bwd = {}, {}, {}
    for use_kernels in (True, False):
        y = train_conv.conv333_train(x, w, b, use_kernels)
        ys[use_kernels] = y
        bwd[use_kernels] = (lambda y=y: torch.autograd.grad(
            y, (x, w, b), dy, retain_graph=True))
        grads[use_kernels] = bwd[use_kernels]()
    tag = "Conv333Train down_2 unit0 (1,64,96,96,32)->48"
    compare(tag + " y", ys[True], ys[False], 0.0)
    for part, g, r in zip(("dx", "dw", "db"), grads[True], grads[False]):
        compare(f"{tag} {part}", g, r, KERNEL_TOL)
    k_ms, p_ms = cuda_ms(bwd[True]), cuda_ms(bwd[False])
    log(f"  {tag} backward: kernel {k_ms!r} ms, plain autograd {p_ms!r} ms "
        f"on {card}")
    torch.cuda.synchronize()
    return rec


def bn_sum_check(name: str, got, terms) -> None:
    """Raise unless each of got (K,) is within BN_SUM_TOL of the sum of
    |terms| (M, K) from the float64 sum of terms."""
    t = terms.double().reshape(terms.shape[0], -1)
    err = (got.double() - t.sum(0)).abs()
    rel = float((err / t.abs().sum(0).clamp_min(1e-30)).max())
    log(f"  {name}: max_abs_err {float(err.max())!r} against float64, "
        f"{rel!r} of the sum of |terms| (tol {BN_SUM_TOL!r})")
    if rel > BN_SUM_TOL:
        raise AssertionError(f"{name}: {rel} > {BN_SUM_TOL}")


def bnorm_site(dev, shape, card: str):
    """One site of bnorm_checks: each pass against its twin, its time
    beside its twin's and its bound, then the whole site both ways. Returns
    (the site's record, the largest |kernel - twin| of the elementwise
    passes)."""
    import torch

    from vs_seg_tpu_torch.nn.layers import BatchNorm, Dropout, PReLU
    from vs_seg_tpu_torch.ops import bnorm_train as bt

    c = shape[-1]
    n = 1
    for v in shape:
        n *= v
    m = float(n // c)
    gen = torch.Generator(dev).manual_seed(SEED)
    y = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.3).to(
        torch.bfloat16)
    g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    drop = Dropout(BN_RATE)
    words, thresh = drop.draw(y, gen)
    bn, act = BatchNorm(c, device=dev), PReLU(device=dev)
    scale = bn.scale.detach()
    run = [bn.mean.clone(), bn.var.clone()]
    tag = f"bnorm_train {tuple(shape)}"

    # stats: fixed-order sums, bit-equal over two runs
    sums = bt.stats(y)
    if not torch.equal(sums, bt.stats(y)):
        raise AssertionError(f"{tag} stats: two runs differ")
    yf = y.reshape(-1, c).float()
    bn_sum_check(f"{tag} stats sum y", sums[:c], yf)
    bn_sum_check(f"{tag} stats sum y^2", sums[c:], yf * yf)
    del yf
    # the finishes: bit-equal to their twins, torch's ops on the card
    runs = [[t.clone() for t in run] for _ in range(2)]
    fin = bt.finish(sums, m, *runs[0], scale)
    ref = bt.finish_plain(sums, m, *runs[1], scale)
    for part, a, b in zip(("mean", "rstd", "inv", "running mean",
                           "running var"), (*fin, *runs[0]), (*ref, *runs[1])):
        compare(f"{tag} finish {part}", a, b, 0.0)
    mean, rstd, inv = fin
    args = (mean, inv, bn.bias.detach(), act.alpha.detach())
    # apply: bit-equal to its twin given the same statistics
    out, bits = bt.apply(y, words, thresh, *args)
    pout, pbits = bt.apply_plain(y, words, thresh, *args)
    errs = [compare(f"{tag} apply out", out, pout, 0.0)]
    if not torch.equal(bits, pbits):
        raise AssertionError(f"{tag} apply: the keep mask differs")
    del pout, pbits
    # bwd_reduce: fixed-order sums, bit-equal over two runs
    red = bt.bwd_reduce(g, y, bits, thresh, *args)
    if not torch.equal(red, bt.bwd_reduce(g, y, bits, thresh, *args)):
        raise AssertionError(f"{tag} bwd_reduce: two runs differ")
    gf, d, zp, gh = bt._backward_terms(g, y, bits, thresh, *args)
    bn_sum_check(f"{tag} bwd_reduce sum gh", red[:c], gh)
    bn_sum_check(f"{tag} bwd_reduce sum gh (y - mean)", red[c:2 * c], gh * d)
    bn_sum_check(f"{tag} bwd_reduce slope", red[2 * c:],
                 (gf * torch.clamp_max(zp, 0)).reshape(-1, 1))
    del gf, d, zp, gh
    bfin = bt.bwd_finish(red, red[:2 * c], m, rstd, inv)
    for part, a, b in zip(("dscale", "c1", "c2"), bfin,
                          bt.bwd_finish_plain(red, red[:2 * c], m, rstd,
                                              inv)):
        compare(f"{tag} bwd_finish {part}", a, b, 0.0)
    c1, c2 = bfin[1:]
    dy = bt.bwd_apply(g, y, bits, thresh, *args, c1, c2)
    errs.append(compare(f"{tag} bwd_apply dy", dy,
                        bt.bwd_apply_plain(g, y, bits, thresh, *args, c1,
                                           c2), 0.0))
    del dy

    # each pass's time beside its twin's and its bound (bytes read and
    # written once; the word draw is torch.randint's, timed beside them)
    mask_b = -(-n // 8)
    passes = {
        "randint": (lambda: drop.draw(y, gen), None, 4 * n),
        "stats": (lambda: bt.stats(y), lambda: bt.stats_plain(y), 2 * n),
        "finish": (lambda: bt.finish(sums, m, *runs[0], scale),
                   lambda: bt.finish_plain(sums, m, *runs[1], scale),
                   4 * 9 * c),
        "apply": (lambda: bt.apply(y, words, thresh, *args),
                  lambda: bt.apply_plain(y, words, thresh, *args),
                  2 * n + 4 * n + 2 * n + mask_b),
        "bwd_reduce": (lambda: bt.bwd_reduce(g, y, bits, thresh, *args),
                       lambda: bt.bwd_reduce_plain(g, y, bits, thresh,
                                                   *args),
                       4 * n + mask_b),
        "bwd_finish": (lambda: bt.bwd_finish(red, red[:2 * c], m, rstd, inv),
                       lambda: bt.bwd_finish_plain(red, red[:2 * c], m, rstd,
                                                   inv),
                       4 * 9 * c),
        "bwd_apply": (lambda: bt.bwd_apply(g, y, bits, thresh, *args, c1,
                                           c2),
                      lambda: bt.bwd_apply_plain(g, y, bits, thresh, *args,
                                                 c1, c2),
                      6 * n + mask_b),
    }
    for name, (fn, plain, moved) in passes.items():
        ms = cuda_ms(fn)
        plain_ms = None if plain is None else cuda_ms(plain, 2)
        b = bound(moved)[0]
        log(f"  {tag} {name}: kernel {ms!r} ms, twin "
            f"{'-' if plain_ms is None else repr(plain_ms)} ms, bound {b!r} "
            f"ms ({moved / 1e9:.4f} GB) on {card}")

    # the whole site, forward and backward, its words drawn: the Function
    # against the eager chain it replaced (nn/layers.py under autograd)
    def whole(fused: bool):
        def go():
            yt = y.detach().requires_grad_()
            gw = torch.Generator(dev).manual_seed(SEED + 1)
            if fused:
                o = bt.bn_dropout_prelu(yt, bn, act.alpha, drop.draw(yt, gw))
            else:
                o = act(drop(bn(yt), True, gw))
            o.backward(g)
        return go

    site_ms, chain_ms = cuda_ms(whole(True)), cuda_ms(whole(False))
    moved = 4 * n + 2 * n + (8 * n + mask_b) + (4 * n + mask_b) \
        + (6 * n + mask_b)
    log(f"  {tag} whole site, forward and backward: the Function {site_ms!r} "
        f"ms, the eager chain {chain_ms!r} ms, bound "
        f"{bound(moved)[0]!r} ms on {card}")
    rec = dict(shape=f"{tag} forward + backward, dropout {BN_RATE}",
               ms=site_ms, plain_ms=chain_ms, library_ms=None,
               bound=bound(moved))
    return rec, max(errs)


def bnorm_host_us(dev) -> dict:
    """The host's wall µs a site, forward and backward, in chains of
    BN_HOST_CHAIN sites at BN_HOST_SHAPE (the card waits on the host):
    the Function and the eager chain."""
    import torch

    from vs_seg_tpu_torch.nn.layers import BatchNorm, Dropout, PReLU
    from vs_seg_tpu_torch.ops import bnorm_train as bt

    c = BN_HOST_SHAPE[-1]
    y = torch.randn(BN_HOST_SHAPE, device=dev).to(torch.bfloat16)
    g = torch.randn(BN_HOST_SHAPE, device=dev).to(torch.bfloat16)
    bn, act, drop = BatchNorm(c, device=dev), PReLU(device=dev), \
        Dropout(BN_RATE)
    gen = torch.Generator(dev).manual_seed(SEED)

    def chain(fused: bool):
        o = y.detach().requires_grad_()
        for _ in range(BN_HOST_CHAIN):
            if fused:
                o = bt.bn_dropout_prelu(o, bn, act.alpha, drop.draw(o, gen))
            else:
                o = act(drop(bn(o), True, gen))
        o.backward(g)

    out = {}
    for k, fused in (("function", True), ("eager_chain", False)):
        chain(fused)                                  # warm-up
        out[k] = host_ms(lambda: chain(fused), 30) * 1e3 / BN_HOST_CHAIN
    return out


def bnorm_checks(dev, card: str):
    """Phase 5 (c): ops/bnorm_train.py's passes at the flagship's level-0
    and level-1 train sites (BN_SHAPES, dropout BN_RATE) against their
    twins: stats and bwd_reduce within BN_SUM_TOL of float64 sums and
    bit-equal over two runs, the finishes, apply (output and keep mask)
    and bwd_apply bit-equal to their twins given the same statistics; each
    pass's time beside its twin's and its bound; the whole site, forward
    and backward, beside the eager chain; the host's µs a site. Returns
    the kernel record (the level-0 site)."""
    import torch

    recs, errs = [], []
    for name, shape in BN_SHAPES:
        rec, err = bnorm_site(dev, shape, card)
        recs.append(rec)
        errs.append(err)
        torch.cuda.empty_cache()
    us = bnorm_host_us(dev)
    log(f"  bnorm_train host time a site, forward and backward, chains of "
        f"{BN_HOST_CHAIN} at {BN_HOST_SHAPE}: the Function "
        f"{us['function']!r} µs, the eager chain {us['eager_chain']!r} µs on "
        f"{card}")
    rec = recs[0]
    rec["max_abs_err"] = max(errs)
    torch.cuda.synchronize()
    return {"bn_dropout_prelu": rec}


def train_crop(cfg, rng):
    """A seeded host batch {"image", "label"} of cfg.pad_crop_shape drawn
    from the numpy Generator `rng`: a sparse binary label, one box of
    32x38x12 voxels in a 384x384x64 crop, and a normal image plus it."""
    import numpy as np
    h, w, d = cfg.pad_crop_shape
    lab = np.zeros((cfg.train_batch_size, 1, h, w, d), np.float32)
    bh, bw, bd = h // 12, w // 10, d // 5
    h0, w0, d0 = (int(rng.integers(0, s - e)) for s, e in
                  ((h, bh), (w, bw), (d, bd)))
    lab[..., h0:h0 + bh, w0:w0 + bw, d0:d0 + bd] = 1.0
    img = rng.normal(size=lab.shape).astype(np.float32) + lab
    return {"image": img, "label": lab}


class StepLosses(logging.Handler):
    """Collects the float of every per-step train loss the Trainer logs."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        if "train_loss" in str(record.msg):
            self.losses.append(float(record.args[-1]))


def train_run(dev, card: str):
    """Phase 6: full-width flagship training on both paths."""
    import numpy as np
    import torch

    from vs_seg_tpu_torch.core.config import Config
    from vs_seg_tpu_torch.models import UNet2d5_spvPA
    from vs_seg_tpu_torch.train import trainer as tr

    cfg = Config(data_root=str(REPO / "build" / "chip_smoke_train"),
                 results_folder_name="smoke", num_epochs=1, val_interval=1,
                 seed=SEED)
    dtype = tr.DTYPES[cfg.compute_dtype]
    model = UNet2d5_spvPA(dtype=dtype, device=dev,
                          generator=torch.Generator().manual_seed(SEED),
                          **cfg.model_kwargs())
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(SEED + 1)
    train_data = [train_crop(cfg, rng) for _ in range(TRAIN_STEPS)]
    val_data = [train_crop(cfg, rng)]
    log(f"  {TRAIN_STEPS} train crops + 1 validation crop of "
        f"{cfg.pad_crop_shape}, channels {tuple(cfg.channels)}, "
        f"compute {cfg.compute_dtype}")

    # the first step's loss and gradients on both paths, same dropout seed,
    # held to each other and to the plain path in float32
    image, label = tr.to_device_batch(train_data[0], dev, dtype)
    first = {}
    for use_kernels in (True, False):
        model.load_state_dict(init)
        first[use_kernels] = step_grads(model, cfg, image, label,
                                        use_kernels)[:2]
    if bn_sites(model) != BN_SITES:
        raise AssertionError(f"{bn_sites(model)} bnorm_train sites in the "
                             f"flagship, expected {BN_SITES}")
    first_step_check("flagship", model, cfg, init, image, label, dev,
                     first[True], first[False])
    first = {k: v[0] for k, v in first.items()}
    del image, label

    # Trainer.fit on both paths from the same weights and dropout seed
    fits = {}
    counts = None
    for use_kernels in (True, False):
        model.load_state_dict(init)
        logger = logging.getLogger(f"chip_smoke.train.{use_kernels}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        steps = StepLosses()
        logger.addHandler(steps)
        trainer = tr.Trainer(cfg, model, dev, logger=logger,
                             use_kernels=use_kernels)
        state = trainer.init_state()
        torch.cuda.synchronize()
        if use_kernels:
            reset_counts()
        t = time.perf_counter()
        state, losses, metrics = trainer.fit(state, train_data, val_data)
        torch.cuda.synchronize()
        if use_kernels:
            counts = read_counts()
        fits[use_kernels] = dict(wall_s=time.perf_counter() - t,
                                 steps=steps.losses, epoch=losses,
                                 val_dice=metrics)
        log(f"  fit, {'kernel' if use_kernels else 'plain'} path: step "
            f"losses {steps.losses}, epoch loss {losses}, val dice {metrics}, "
            f"{fits[use_kernels]['wall_s']:.2f} s wall (validation and "
            f"checkpoints included) on {card}")
    check_counts(counts, {
        "conv333_dw": TRAIN_SITES * TRAIN_STEPS,
        "conv333": TRAIN_SITES * TRAIN_STEPS + EVAL_CONV333,
        **EVAL_RU, **EVAL_L2, "blend_scatter": 0, **NO_KD1,
        **bn_launches(TRAIN_STEPS)}, "training")

    # ms/step and peak memory, device-resident batch, turns plain, kernel,
    # kernel, plain
    image, label = tr.to_device_batch(train_data[0], dev, dtype)
    times = {True: [], False: []}
    peak = {}
    for use_kernels in (False, True, True, False):
        model.load_state_dict(init)
        opt = tr.make_optimizer(model.parameters(), cfg.initial_learning_rate,
                                cfg.weight_decay)
        step = tr.make_train_step(model, opt,
                                  supervised_attention=cfg.attention,
                                  hardness=cfg.hardness,
                                  use_kernels=use_kernels)
        gen = torch.Generator(dev).manual_seed(cfg.seed)
        step(image, label, gen)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(STEP_REPS):
            loss = step(image, label, gen)
        torch.cuda.synchronize()
        times[use_kernels].append((time.perf_counter() - t) * 1e3 / STEP_REPS)
        peak[use_kernels] = torch.cuda.max_memory_allocated() / 2 ** 30
        if not torch.isfinite(loss):
            raise AssertionError("non-finite train loss")
    for use_kernels in (True, False):
        name = "kernel" if use_kernels else "plain"
        ts = times[use_kernels]
        log(f"train step, {name} path: {sum(ts) / len(ts):.1f} ms/step {ts}, "
            f"peak device memory {peak[use_kernels]:.2f} GiB on {card}")

    # the checks
    for use_kernels, f in fits.items():
        vals = f["steps"] + f["epoch"] + f["val_dice"]
        if len(f["steps"]) != TRAIN_STEPS or not np.isfinite(vals).all():
            raise AssertionError(f"fit (use_kernels={use_kernels}): {f}")
    if fits[True]["steps"][0] != first[True]:
        raise AssertionError("the fit's first step is not the checked one: "
                             f"{fits[True]['steps'][0]} vs {first[True]}")
    ek, ep = fits[True]["epoch"][0], fits[False]["epoch"][0]
    if abs(ek - ep) > FIT_LOSS_TOL * abs(ep):
        raise AssertionError(f"epoch losses differ: {ek} vs {ep}")
    torch.cuda.synchronize()
    return counts


# ru_block's sites for one 8-window batch (D-first): (site, (N, D, H, W),
# Cin, Cout); ops/rublock.py:plan gives each the unit kernel, down_2 with
# its weights resident, the others with its slabs staged
RU_SITES = (("down_2", (SW_BATCH, 64, 96, 96), 32, 48),
            ("down_3", (SW_BATCH, 32, 48, 48), 48, 64),
            ("down_4", (SW_BATCH, 16, 24, 24), 64, 80),
            ("bottom", (SW_BATCH, 8, 12, 12), 80, 96))


def ru_site_args(dev, gen, cin, cout):
    """Seeded ru_block params at one site (drawn on the host from gen in
    phase 2's order)."""
    import numpy as np
    import torch

    def weight(k, ci, co):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        return ((torch.rand((*k, ci, co), generator=gen) * 2 - 1) * b
                ).to(dev)

    def vec(c, lo, hi):
        return (torch.rand(c, generator=gen) * (hi - lo) + lo).to(dev)

    return dict(w0=weight((3, 3, 3), cin, cout),
                bn0_scale=vec(cout, .5, 1.5), bn0_shift=vec(cout, -.2, .2),
                alpha0=vec(1, .1, .3), w1=weight((3, 3, 3), cout, cout),
                bn1_scale=vec(cout, .5, 1.5), bn1_shift=vec(cout, -.2, .2),
                alpha1=vec(1, .1, .3), wr=weight((1, 1, 1), cin, cout),
                br=vec(cout, -.2, .2))


def ru_cudnn(x, kw):
    """The library yardstick of ru_block: the cuDNN chain of its two convs
    (channels-last F.conv3d, no epilogue or residual; no single PyTorch
    call computes the unit)."""
    import torch
    import torch.nn.functional as F

    wt0, wt1 = (kw[k].to(torch.bfloat16).permute(4, 3, 2, 0, 1).contiguous()
                for k in ("w0", "w1"))
    xc = x.permute(0, 4, 1, 2, 3)

    def cudnn():
        return F.conv3d(F.conv3d(xc, wt0, padding=1), wt1, padding=1)

    return cudnn


def ru_bound(x, kw, out):
    """ru_block's bound: x, the params and out moved once (u0 never has to
    be); the MACs of conv0, conv1 and the 1x1 residual."""
    cin, cout = x.shape[-1], out.shape[-1]
    vox = x[..., 0].numel()
    return bound(nbytes(x, out, *kw.values()),
                 2 * vox * (27 * cin * cout + 27 * cout * cout + cin * cout))


def ru_site(site, x, kw, card: str):
    """ru_block at one site: the route ops/rublock.py:plan gives it (the unit
    kernel: one ru_unit launch and no conv333; the chain: two conv333
    launches), out within KERNEL_TOL of the twin and bit-equal to the parent
    chain (ru_chain(conv333, ...): the same stage order, wgmma sequence and
    epilogue) and over two runs; its device time by CUDA-graph replay
    beside the parent chain and the cuDNN chain of its two convs, the twin's
    event time, the bound and the host's enqueue. Prints a JSON line;
    returns its row."""
    import torch

    from vs_seg_tpu_torch.ops import conv333, rublock

    cin, cout = x.shape[-1], kw["w0"].shape[-1]
    name = f"ru_block {site} {tuple(x.shape[:4])}x{cin}->{cout}"
    p = rublock.plan(x.shape[:4], cin, cout)
    if p.fused:
        p = rublock.plan(x.shape[:4], cin, cout,
                         rublock.unit_grid(x.device, cin, cout))

    def run():
        return rublock.ru_block(x, **kw)

    def chain():
        return rublock.ru_chain(conv333.conv333, x, **kw)

    before = (rublock.ru_unit.launches, conv333.conv333.launches)
    got = run()
    launched = [rublock.ru_unit.launches - before[0],
                conv333.conv333.launches - before[1]]
    route = "unit" if p.fused else "chain"
    if launched != ([1, 0] if p.fused else [0, 2]):
        raise AssertionError(f"{name}: launches (ru_unit, conv333) "
                             f"{launched} on the {route} route")
    if not torch.equal(got, run()):
        raise AssertionError(f"{name}: two runs differ")
    err = compare(name, got, rublock.ru_block_plain(x, **kw), KERNEL_TOL)
    ref = chain()
    compare(f"{name}, the parent chain", got, ref, KERNEL_TOL)
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: not bit-equal to the parent chain")
    log(f"  {name}: bit-equal to the parent chain ({route}, p0 {p.p0} of "
        f"{p.grid} blocks on conv0 if the unit: {p.why})")
    b = ru_bound(x, kw, got)
    del got, ref
    row = dict(site=site, shape=[*x.shape[:4]], cin=cin, cout=cout,
               route=route, p0=p.p0, grid=p.grid,
               ms=graph_ms(run), chain_ms=graph_ms(chain),
               cudnn_chain_ms=graph_ms(ru_cudnn(x, kw)),
               plain_ms=cuda_ms(lambda: rublock.ru_block_plain(x, **kw)),
               host_enqueue_ms=host_ms(run), bound_ms=b[0], bound_by=b[1],
               max_abs_err=err, card=card)
    row["tflops"] = b[3] / row["ms"] / 1e9
    log(f"  {name}: {row['route']} {row['ms']!r} ms device (graph replay), "
        f"host enqueue {row['host_enqueue_ms']!r} ms/call; parent chain "
        f"{row['chain_ms']!r} ms, cuDNN chain {row['cudnn_chain_ms']!r} ms, "
        f"plain {row['plain_ms']!r} ms, bound {b[0]!r} ms ({b[1]}: "
        f"{b[2] / 1e9:.3f} GB, {b[3] / 1e9:.1f} GFLOP) = {row['tflops']!r} "
        f"TFLOP/s on {card}")
    print(json.dumps({"ru_block_site": row}), flush=True)
    row["bound"] = b
    return row


# ru_block2d's sites for one 8-window batch (D-first): (site, (N, D, H, W),
# Cin, Cout)
RB_SITES = (("down_0", (SW_BATCH, ROI[2], ROI[0], ROI[1]), 1, 16),
            ("down_1", (SW_BATCH, ROI[2], ROI[0] // 2, ROI[1] // 2), 16, 32))


def rb_site_args(dev, gen, shape, cin, cout):
    """Seeded ru_block2d arguments at one site: x and the unit's params."""
    import numpy as np
    import torch

    def weight(k, ci, co):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        return ((torch.rand((*k, ci, co), generator=gen) * 2 - 1) * b
                ).to(dev)

    def vec(c, lo, hi):
        return (torch.rand(c, generator=gen) * (hi - lo) + lo).to(dev)

    x = torch.randn((*shape, cin), generator=gen).to(dev, torch.bfloat16)
    return x, dict(w0=weight((3, 3, 1), cin, cout),
                   bn0_scale=vec(cout, .5, 1.5), bn0_shift=vec(cout, -.2, .2),
                   alpha0=vec(1, .1, .3), w1=weight((3, 3, 1), cout, cout),
                   bn1_scale=vec(cout, .5, 1.5),
                   bn1_shift=vec(cout, -.2, .2), alpha1=vec(1, .1, .3),
                   wr=weight((1, 1, 1), cin, cout), br=vec(cout, -.2, .2))


def rb_chains(x, kw):
    """What ru_block2d replaced and its library yardstick, as callables:
    the two conv333 launches (ops/rublock.py:ru_chain) and the cuDNN chain
    of its two convs (channels-last F.conv3d, no epilogue or residual; no
    single PyTorch call computes the unit)."""
    import torch
    import torch.nn.functional as F

    from vs_seg_tpu_torch.ops import conv333
    from vs_seg_tpu_torch.ops.rublock import ru_chain

    wt0, wt1 = (kw[k].to(torch.bfloat16).permute(4, 3, 2, 0, 1).contiguous()
                for k in ("w0", "w1"))
    xc = x.permute(0, 4, 1, 2, 3)

    def cudnn():
        u = F.conv3d(xc, wt0, padding=(0, 1, 1))
        return F.conv3d(u, wt1, padding=(0, 1, 1))

    return (lambda: ru_chain(conv333.conv333, x, **kw)), cudnn


def rb_bound(x, kw, out):
    """ru_block2d's bound: x, the params and out moved once; its MACs."""
    import torch
    cin, cout = x.shape[-1], out.shape[-1]
    vox = x[..., 0].numel()
    return bound(nbytes(x, out, *[v for v in kw.values()
                                  if isinstance(v, torch.Tensor)]),
                 2 * vox * (9 * cin * cout + 9 * cout * cout + cin * cout))


def rb_site(dev, gen, site, shape, cin, cout, card: str):
    """ru_block2d at one site: within KERNEL_TOL of its twin, bit-equal over
    two runs; its device time by CUDA-graph replay beside the conv333 chain
    it replaced and the cuDNN chain (both by graph replay), the twin's
    event time, the bound and the host's enqueue per call. Prints a JSON
    line; returns its row."""
    import torch

    from vs_seg_tpu_torch.ops import block2d

    x, kw = rb_site_args(dev, gen, shape, cin, cout)
    name = f"ru_block2d {site} {shape}x{cin}->{cout}"

    def run():
        return block2d.ru_block2d(x, **kw)

    got = run()
    if not torch.equal(got, run()):
        raise AssertionError(f"{name}: two runs differ")
    err = compare(name, got, block2d.ru_block2d_plain(x, **kw), KERNEL_TOL)
    chain, cudnn = rb_chains(x, kw)
    compare(f"{name}, the conv333 chain", chain(), got, KERNEL_TOL)
    b = rb_bound(x, kw, got)
    p = block2d.plan(tuple(shape), cin, cout)
    row = dict(site=site, shape=[*shape], cin=cin, cout=cout,
               th=p.th, stages=p.stages, ms=graph_ms(run),
               chain_ms=graph_ms(chain), cudnn_chain_ms=graph_ms(cudnn),
               plain_ms=cuda_ms(lambda: block2d.ru_block2d_plain(x, **kw)),
               host_enqueue_ms=host_ms(run), bound_ms=b[0], bound_by=b[1],
               max_abs_err=err, card=card)
    row["tflops"] = b[3] / row["ms"] / 1e9
    log(f"  {name}: kernel {row['ms']!r} ms device (graph replay, TH "
        f"{p.th}, {p.stages} slots), host enqueue "
        f"{row['host_enqueue_ms']!r} ms/call; conv333 chain "
        f"{row['chain_ms']!r} ms, cuDNN chain {row['cudnn_chain_ms']!r} ms, "
        f"plain {row['plain_ms']!r} ms, bound {b[0]!r} ms ({b[1]}: "
        f"{b[2] / 1e9:.3f} GB, {b[3] / 1e9:.1f} GFLOP) = {row['tflops']!r} "
        f"TFLOP/s on {card}")
    print(json.dumps({"ru_block2d_site": row}), flush=True)
    row["bound"] = b
    return row


# l2_block2d's fused site for one 8-window batch (D-first): (site, (N, D,
# H, W), C, Cout); the up_0 logit head (bn_scale None, bn_shift the bias,
# identity activation)
L2_SITES = (("up_0 head", (SW_BATCH, ROI[2], ROI[0], ROI[1]), 16, 2),)


def l2_site_args(dev, gen, shape, c, cout, kd: int = 1):
    """Seeded l2_block2d (kd = 1) or l2_block (kd = 3) arguments at one
    site: xa, xb and the block's params (the logit head's degenerate
    epilogue at cout = 2)."""
    import numpy as np
    import torch

    def weight(k, ci, co):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        return ((torch.rand((*k, ci, co), generator=gen) * 2 - 1) * b
                ).to(dev)

    def vec(n, lo, hi):
        return (torch.rand(n, generator=gen) * (hi - lo) + lo).to(dev)

    xa, xb = (torch.randn((*shape, c), generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))
    kw = dict(w1=weight((3, 3, kd), 2 * c, c), b1=vec(c, -.2, .2),
              w2=weight((3, 3, kd), c, 1), b2=vec(1, -.2, .2),
              w0=weight((3, 3, kd), 2 * c, cout),
              wr=weight((1, 1, 1), 2 * c, cout), br=vec(cout, -.2, .2))
    if cout == 2:
        kw.update(bn_scale=None, bn_shift=vec(cout, -.2, .2), alpha=None)
    else:
        kw.update(bn_scale=vec(cout, .5, 1.5), bn_shift=vec(cout, -.2, .2),
                  alpha=vec(1, .1, .3))
    return xa, xb, kw


def l2_chains(xa, xb, kw):
    """What l2_block2d (kd = 1) or l2_block (kd = 3) replaced and its
    library yardstick, as callables: the conv333 + attgate + conv333 chain
    (ops/l2block.py:l2_chain) and the cuDNN chain of its two convs
    (channels-last F.conv3d on xa || xb concatenated once outside the
    timing, no epilogue, gate or residual; no single PyTorch call computes
    the block)."""
    import torch
    import torch.nn.functional as F

    from vs_seg_tpu_torch.ops import conv333, l2block

    wt1, wt0 = (kw[k].to(torch.bfloat16).permute(4, 3, 2, 0, 1).contiguous()
                for k in ("w1", "w0"))
    xc = torch.cat((xa, xb), -1).permute(0, 4, 1, 2, 3)
    pad = (int(kw["w1"].shape[2]) // 2, 1, 1)

    def cudnn():
        F.conv3d(xc, wt1, padding=pad)
        return F.conv3d(xc, wt0, padding=pad)

    return (lambda: l2block.l2_chain(conv333.conv333, l2block.attgate, xa,
                                     xb, **kw)), cudnn


def l2_bound(xa, xb, kw, out, att):
    """l2_block2d's or l2_block's bound: xa, xb, the params, out and att
    moved once; its MACs (conv1, conv0 and the residual in bf16, conv2 and
    the gate f32)."""
    import torch
    c, cout = xa.shape[-1], out.shape[-1]
    taps = 9 * int(kw["w1"].shape[2])
    vox = xa[..., 0].numel()
    return bound(nbytes(xa, xb, out, att,
                        *[v for v in kw.values()
                          if isinstance(v, torch.Tensor)]),
                 2 * vox * (taps * 2 * c * c + taps * 2 * c * cout
                            + 2 * c * cout),
                 (2 * taps + 4) * c * vox)


def l2_site(dev, gen, site, shape, c, cout, card: str):
    """l2_block2d at its fused site: out and att within KERNEL_TOL of its
    twin and of the conv333 + attgate + conv333 chain it replaced,
    bit-equal over two runs; its device time by CUDA-graph replay beside
    the chain and the cuDNN chain (both by graph replay), the twin's event
    time, the bound and the host's enqueue per call. Prints a JSON line;
    returns its row."""
    import torch

    from vs_seg_tpu_torch.ops import block2d

    xa, xb, kw = l2_site_args(dev, gen, shape, c, cout)
    name = f"l2_block2d {site} {shape}x{c}x2->{cout}"

    def run():
        return block2d.l2_block2d(xa, xb, **kw)

    n0 = block2d.l2_block2d.launches
    got = run()
    if block2d.l2_block2d.launches != n0 + 1:
        raise AssertionError(f"{name}: the fused kernel was not launched")
    if not all(torch.equal(g, a) for g, a in zip(got, run())):
        raise AssertionError(f"{name}: two runs differ")
    err = max(compare(f"{name} {part}", g, r, KERNEL_TOL) for part, g, r in
              zip(("out", "att"), got, block2d.l2_block2d_plain(xa, xb,
                                                                 **kw)))
    chain, cudnn = l2_chains(xa, xb, kw)
    for part, g, r in zip(("out", "att"), chain(), got):
        compare(f"{name} {part}, the parent chain", g, r, KERNEL_TOL)
    b = l2_bound(xa, xb, kw, *got)
    del got
    p = block2d.plan_l2(tuple(shape), c, cout)
    row = dict(site=site, shape=[*shape], c=c, cout=cout, th=p.th,
               stages=p.stages, ms=graph_ms(run), chain_ms=graph_ms(chain),
               cudnn_chain_ms=graph_ms(cudnn),
               plain_ms=cuda_ms(lambda: block2d.l2_block2d_plain(xa, xb,
                                                                  **kw)),
               host_enqueue_ms=host_ms(run), bound_ms=b[0], bound_by=b[1],
               max_abs_err=err, card=card)
    row["tflops"] = b[3] / row["ms"] / 1e9
    log(f"  {name}: kernel {row['ms']!r} ms device (graph replay, TH "
        f"{p.th}, {p.stages} slots), host enqueue "
        f"{row['host_enqueue_ms']!r} ms/call; parent chain "
        f"{row['chain_ms']!r} ms, cuDNN chain {row['cudnn_chain_ms']!r} ms, "
        f"plain {row['plain_ms']!r} ms, bound {b[0]!r} ms ({b[1]}: "
        f"{b[2] / 1e9:.3f} GB, {b[3] / 1e9:.1f} GFLOP) = {row['tflops']!r} "
        f"TFLOP/s on {card}")
    print(json.dumps({"l2_block2d_site": row}), flush=True)
    row["bound"] = b
    return row


# l2_block's sites for one 8-window batch (D-first): (site, (N, D, H, W), C)
L2B_SITES = (("up_2", (SW_BATCH, 64, 96, 96), 48),
             ("up_3", (SW_BATCH, 32, 48, 48), 64),
             ("up_4", (SW_BATCH, 16, 24, 24), 80))


def _l2_counters():
    from vs_seg_tpu_torch.ops import conv333, l2block
    return ((conv333.conv333, "launches"), (conv333.conv333,
                                            "gated_launches"),
            (l2block.att_map, "launches"), (l2block.attgate, "launches"))


def l2b_site(site, xa, xb, kw, card: str):
    """l2_block at one site: conv333 (conv1), attgate's att-only mode and
    conv333's gated instance, one launch each and no other; out and att
    bit-equal to the parent chain (conv333, attgate, conv333: the same
    stage order and wgmma sequence on the same fmaf-gated values) and over
    two runs, within KERNEL_TOL of the twin; its device time by CUDA-graph
    replay beside the chain and the cuDNN chain of its two convs, the
    twin's event time, the bound and the host's enqueue. Prints a JSON
    line; returns its row."""
    import torch

    from vs_seg_tpu_torch.ops import l2block

    c = xa.shape[-1]
    name = f"l2_block {site} {tuple(xa.shape[:4])}x{c}x2"

    def run():
        return l2block.l2_block(xa, xb, **kw)

    before = [getattr(o, a) for o, a in _l2_counters()]
    got = run()
    launched = [getattr(o, a) - n for (o, a), n in zip(_l2_counters(),
                                                        before)]
    if launched != [1, 1, 1, 0]:
        raise AssertionError(f"{name}: launches (conv333, gated conv333, "
                             f"att_map, attgate) {launched}, expected "
                             f"[1, 1, 1, 0]")
    if not all(torch.equal(g, a) for g, a in zip(got, run())):
        raise AssertionError(f"{name}: two runs differ")
    err = max(compare(f"{name} {part}", g, r, KERNEL_TOL) for part, g, r in
              zip(("out", "att"), got, l2block.l2_block_plain(xa, xb,
                                                               **kw)))
    chain, cudnn = l2_chains(xa, xb, kw)
    for part, g, r in zip(("out", "att"), got, chain()):
        compare(f"{name} {part}, the parent chain", g, r, KERNEL_TOL)
        if not torch.equal(g, r):
            raise AssertionError(f"{name} {part}: not bit-equal to the "
                                 "parent chain")
    log(f"  {name}: out and att bit-equal to the parent chain")
    b = l2_bound(xa, xb, kw, *got)
    del got
    row = dict(site=site, shape=[*xa.shape[:4]], c=c, ms=graph_ms(run),
               chain_ms=graph_ms(chain), cudnn_chain_ms=graph_ms(cudnn),
               plain_ms=cuda_ms(lambda: l2block.l2_block_plain(xa, xb,
                                                               **kw)),
               host_enqueue_ms=host_ms(run), bound_ms=b[0], bound_by=b[1],
               max_abs_err=err, card=card)
    row["tflops"] = b[3] / row["ms"] / 1e9
    log(f"  {name}: kernels {row['ms']!r} ms device (graph replay), host "
        f"enqueue {row['host_enqueue_ms']!r} ms/call; parent chain "
        f"{row['chain_ms']!r} ms, cuDNN chain {row['cudnn_chain_ms']!r} ms, "
        f"plain {row['plain_ms']!r} ms, bound {b[0]!r} ms ({b[1]}: "
        f"{b[2] / 1e9:.3f} GB, {b[3] / 1e9:.1f} GFLOP) = {row['tflops']!r} "
        f"TFLOP/s on {card}")
    print(json.dumps({"l2_block_site": row}), flush=True)
    row["bound"] = b
    return row


def l2_parts(xa, xb, kw):
    """The two kernels l2_block runs after conv1, alone at one site:
    att_map (attgate's att-only mode) and conv0 as conv333's gated
    instance, each against its twin on the same inputs, timed by graph
    replay. Returns their kernel records."""
    import torch

    from vs_seg_tpu_torch.ops import conv333, l2block

    c = xa.shape[-1]
    vox = xa[..., 0].numel()
    relu = torch.zeros(1, device=xa.device)
    a1 = conv333.conv333((xa, xb), kw["w1"], None, kw["b1"], relu)
    w2, b2 = kw["w2"], kw["b2"]
    att32, att_c = l2block.att_map(a1, w2, b2)
    ref32, ref_c = l2block.att_map_plain(a1, w2, b2)
    e_a = max(compare("att_map att32", att32, ref32, KERNEL_TOL),
              compare("att_map att", att_c, ref_c, KERNEL_TOL))
    shape = f"{tuple(xa.shape[:4])}x{c}"
    rec = {"att_map": dict(
        shape=f"{shape} -> att", max_abs_err=e_a,
        ms=graph_ms(lambda: l2block.att_map(a1, w2, b2)),
        plain_ms=cuda_ms(lambda: l2block.att_map_plain(a1, w2, b2)),
        library_ms=None,
        bound=bound(nbytes(a1, w2, b2, att32, att_c),
                    f32_flop=2 * 27 * c * vox))}
    del ref32, ref_c
    args = ((xa, xb), kw["w0"], kw["bn_scale"], kw["bn_shift"], kw["alpha"])
    res = ((xa, xb), kw["wr"], kw["br"])

    def gated():
        return conv333.conv333(*args, residual=res, gate=att32)

    def twin():
        return conv333.conv333_plain(*args, residual=res, gate=att32)

    got = gated()
    e_g = compare(f"conv333 gated {shape}x2", got, twin(), KERNEL_TOL)
    rec["conv333_gated"] = dict(
        shape=f"{shape}x2 gated conv0 + residual", max_abs_err=e_g,
        ms=graph_ms(gated), plain_ms=cuda_ms(twin), library_ms=None,
        bound=bound(nbytes(xa, xb, att32, got,
                           *[kw[k] for k in ("w0", "bn_scale", "bn_shift",
                                             "alpha", "wr", "br")]),
                    2 * vox * (27 * 2 * c * c + 2 * c * c),
                    2 * 2 * c * vox))
    return rec


# tail_block's sites for one 8-window batch (D-first): (site, (N, D, H, W),
# C of a1 and of each pair half, Cout); up_1 is configuration A's (a folded
# BatchNorm and a PReLU), the up_0 logit head (bn_scale None, bn_shift the
# bias, identity activation) is taken under Routes(tail2d0=True)
TAIL_SITES = (("up_1", (SW_BATCH, ROI[2], ROI[0] // 2, ROI[1] // 2), 32, 32),
              ("up_0 head", (SW_BATCH, ROI[2], ROI[0], ROI[1]), 16, 2))


def tail_site_args(dev, gen, shape, c, cout):
    """Seeded tail_block arguments at one site: a1 (a ReLU output), xa, xb
    and the tail's params, l2_site_args' but for conv1's."""
    import torch

    xa, xb, kw = l2_site_args(dev, gen, shape, c, cout)
    del kw["w1"], kw["b1"]
    a1 = torch.randn((*shape, c), generator=gen).to(dev, torch.bfloat16)
    return a1.relu(), xa, xb, kw


def tail_chains(a1, xa, xb, kw):
    """What tail_block replaced and its library yardstick, as callables:
    the attgate + conv333 chain (ops/l2block.py:gate_conv0, ga and gb in
    device memory) and cuDNN's conv0 plus the 1x1 residual (channels-last
    F.conv3d on xa || xb concatenated once outside the timing, no conv2,
    gate or epilogue; no single PyTorch call computes the tail)."""
    import torch
    import torch.nn.functional as F

    from vs_seg_tpu_torch.ops import conv333, l2block

    wt0, wtr = (kw[k].to(torch.bfloat16).permute(4, 3, 2, 0, 1).contiguous()
                for k in ("w0", "wr"))
    xc = torch.cat((xa, xb), -1).permute(0, 4, 1, 2, 3)

    def cudnn():
        return F.conv3d(xc, wt0, padding=(0, 1, 1)) + F.conv3d(xc, wtr)

    return (lambda: l2block.gate_conv0(conv333.conv333, l2block.attgate, a1,
                                       xa, xb, **kw)), cudnn


def tail_bound(a1, xa, xb, kw, out, att):
    """tail_block's bound: a1, xa, xb, the params, out and att moved once;
    its MACs (conv0 and the residual in bf16, conv2 and the gate f32)."""
    import torch
    ca, ch, cout = a1.shape[-1], xa.shape[-1], out.shape[-1]
    vox = xa[..., 0].numel()
    return bound(nbytes(a1, xa, xb, out, att,
                        *[v for v in kw.values()
                          if isinstance(v, torch.Tensor)]),
                 2 * vox * (9 * 2 * ch * cout + 2 * ch * cout),
                 (2 * 9 * ca + 4 * ch) * vox)


def tail_site(dev, gen, site, shape, c, cout, card: str):
    """tail_block at one site: one csrc/tail2d.cu launch, out and att
    within KERNEL_TOL of its twin and of the attgate + conv333 chain it
    replaced, bit-equal over two runs; its device time by CUDA-graph
    replay beside the chain and cuDNN's conv0 + residual (both by graph
    replay), the twin's event time, the bound and the host's enqueue per
    call. Prints a JSON line; returns its row."""
    import torch

    from vs_seg_tpu_torch.ops import tail2d

    a1, xa, xb, kw = tail_site_args(dev, gen, shape, c, cout)
    name = f"tail_block {site} {shape}x{c}x2->{cout}"

    def run():
        return tail2d.tail_block(a1, xa, xb, **kw)

    n0 = tail2d.tail_block.launches
    got = run()
    if tail2d.tail_block.launches != n0 + 1:
        raise AssertionError(f"{name}: the fused kernel was not launched")
    if not all(torch.equal(g, a) for g, a in zip(got, run())):
        raise AssertionError(f"{name}: two runs differ")
    err = max(compare(f"{name} {part}", g, r, KERNEL_TOL) for part, g, r in
              zip(("out", "att"), got, tail2d.tail_block_plain(a1, xa, xb,
                                                               **kw)))
    chain, cudnn = tail_chains(a1, xa, xb, kw)
    for part, g, r in zip(("out", "att"), chain(), got):
        compare(f"{name} {part}, the parent chain", g, r, KERNEL_TOL)
    b = tail_bound(a1, xa, xb, kw, *got)
    del got
    p = tail2d.plan_tail(tuple(shape), c, c, cout)
    row = dict(site=site, shape=[*shape], c=c, cout=cout, th=p.th,
               ms=graph_ms(run), chain_ms=graph_ms(chain),
               cudnn_ms=graph_ms(cudnn),
               plain_ms=cuda_ms(lambda: tail2d.tail_block_plain(a1, xa, xb,
                                                                **kw)),
               host_enqueue_ms=host_ms(run), bound_ms=b[0], bound_by=b[1],
               max_abs_err=err, card=card)
    row["tflops"] = b[3] / row["ms"] / 1e9
    log(f"  {name}: kernel {row['ms']!r} ms device (graph replay, TH "
        f"{p.th}), host enqueue {row['host_enqueue_ms']!r} ms/call; parent "
        f"chain {row['chain_ms']!r} ms, cuDNN conv0 + residual "
        f"{row['cudnn_ms']!r} ms, plain {row['plain_ms']!r} ms, bound "
        f"{b[0]!r} ms ({b[1]}: {b[2] / 1e9:.3f} GB, {b[3] / 1e9:.1f} "
        f"GFLOP) = {row['tflops']!r} TFLOP/s on {card}")
    print(json.dumps({"tail_block_site": row}), flush=True)
    row["bound"] = b
    return row


def kd1_kernel_checks(dev, gen, card: str):
    """Phase 7: the kd = 1 route kernels vs their plain twins at the
    flagship shapes of one 8-window batch."""
    import numpy as np
    import torch

    from vs_seg_tpu_torch.ops import att, block2d, tail2d

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)

    def weight(k, cin, cout):
        b = 1.0 / np.sqrt(cin * int(np.prod(k)))
        return ((torch.rand((*k, cin, cout), generator=gen) * 2 - 1) * b
                ).to(dev)

    def vec(c, lo, hi):
        return (torch.rand(c, generator=gen) * (hi - lo) + lo).to(dev)

    def unit0(cin, cout, head):
        kw = dict(w0=weight((3, 3, 1), cin, cout),
                  wr=weight((1, 1, 1), cin, cout), br=vec(cout, -.2, .2))
        if head:      # the conv-only logit head: scale 1, identity act
            kw.update(bn_scale=None, bn_shift=vec(cout, -.2, .2), alpha=None)
        else:
            kw.update(bn_scale=vec(cout, .5, 1.5),
                      bn_shift=vec(cout, -.2, .2), alpha=vec(1, .1, .3))
        return kw

    def check(name, fn, plain, args, kw, work, record):
        """Compare every output; time both when `record`; returns the
        record (or None) and the max error."""
        got, ref = fn(*args, **kw), plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = 0.0
        for i, (g, r) in enumerate(zip(got, ref)):
            if g is None and r is None:
                continue
            if isinstance(g, tuple):
                for j, (gj, rj) in enumerate(zip(g, r)):
                    err = max(err, compare(f"{name} out{i}.{j}", gj, rj,
                                           KERNEL_TOL))
            else:
                err = max(err, compare(f"{name} out{i}", g, r, KERNEL_TOL))
        if not record:
            return None, err
        outs = [t for g in got for t in (g if isinstance(g, tuple) else (g,))]
        ins = [t for a in args for t in (a if isinstance(a, (tuple, list))
                                         else (a,))]
        b = bound(nbytes(*ins, *[v for v in kw.values()
                                 if isinstance(v, torch.Tensor)], *outs),
                  *work)
        rec = dict(shape=name, ms=cuda_ms(lambda: fn(*args, **kw)),
                   plain_ms=cuda_ms(lambda: plain(*args, **kw)),
                   library_ms=None, bound=b)
        log(f"  {name}: kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r} "
            f"ms, bound {b[0]!r} ms ({b[1]}) on {card}")
        return rec, err

    # one window batch, D-first: level 0 (8,64,384,384), level 1 (8,64,192,
    # 192), level 2 (8,64,96,96)
    B, (h, w, d) = SW_BATCH, ROI
    L0, L1, L2 = (B, d, h, w), (B, d, h // 2, w // 2), (B, d, h // 4, w // 4)
    v0, v1 = int(np.prod(L0)), int(np.prod(L1))
    rec, errs = {}, {}

    def keep(key, r_e):
        r, e = r_e
        errs[key] = max(errs.get(key, 0.0), e)
        if r is not None:
            rec[key] = r
        torch.cuda.synchronize()

    # ru_block2d at down_0 (1 -> 16) and down_1 (16 -> 32)
    for site, shape, cin, cout in RB_SITES:
        row = rb_site(dev, gen, site, shape, cin, cout, card)
        errs["ru_block2d"] = max(errs.get("ru_block2d", 0.0),
                                 row["max_abs_err"])
        if "ru_block2d" not in rec:
            rec["ru_block2d"] = dict(
                shape=f"ru_block2d {site} {shape}x{cin}->{cout}",
                ms=row["ms"], plain_ms=row["plain_ms"], library_ms=None,
                bound=row["bound"])
        torch.cuda.synchronize()

    # l2_block2d: one csrc/l2block2d.cu launch at the up_0 head (16||16 ->
    # 2), against its twin and the parent chain; at up_1 (32||32 -> 32,
    # past the kernel's widths) the conv333 + attgate chain, against its
    # twin, and which path it took
    for site, shape, c, cout in L2_SITES:
        row = l2_site(dev, gen, site, shape, c, cout, card)
        errs["l2_block2d"] = max(errs.get("l2_block2d", 0.0),
                                 row["max_abs_err"])
        rec["l2_block2d"] = dict(
            shape=f"l2_block2d {site} {shape}x{c}x2->{cout}", ms=row["ms"],
            plain_ms=row["plain_ms"], library_ms=None, bound=row["bound"])
        torch.cuda.synchronize()
    # l2_block2d at up_1 (32||32 -> 32, past the kernel's widths): the
    # conv333 + attgate chain, against its twin, and which path it took
    site, shape, c, cout = "up_1", L1, 32, 32
    xa, xb = randn(*shape, c), randn(*shape, c)
    kw = dict(unit0(2 * c, cout, False), w1=weight((3, 3, 1), 2 * c, c),
              b1=vec(c, -.2, .2), w2=weight((3, 3, 1), c, 1),
              b2=vec(1, -.2, .2))
    n0 = block2d.l2_block2d.launches
    k0 = block2d.l2_block2d.chain_calls
    keep("l2_block2d", check(
        f"l2_block2d {site} {shape}x{c}x2->{cout}", block2d.l2_block2d,
        block2d.l2_block2d_plain, (xa, xb), kw, None, False))
    path = ("the conv333 + attgate chain"
            if block2d.l2_block2d.chain_calls == k0 + 1
            and block2d.l2_block2d.launches == n0 else "the fused kernel")
    log(f"  l2_block2d {site} ({c}||{c} -> {cout}) took {path}")
    if block2d.l2_fusable(c, cout) != (path == "the fused kernel"):
        raise AssertionError(f"l2_block2d {site}: took {path}")
    del xa, xb

    # tail_block: one csrc/tail2d.cu launch at up_1 (A's site, 32||32 ->
    # 32) and at the up_0 head (16||16 -> 2), given a1, against its twin
    # and the attgate + conv333 chain it replaced
    for site, shape, c, cout in TAIL_SITES:
        row = tail_site(dev, gen, site, shape, c, cout, card)
        errs["tail_block"] = max(errs.get("tail_block", 0.0),
                                 row["max_abs_err"])
        if "tail_block" not in rec:
            rec["tail_block"] = dict(
                shape=f"tail_block {site} {shape}x{c}x2->{cout}",
                ms=row["ms"], plain_ms=row["plain_ms"], library_ms=None,
                bound=row["bound"])
        torch.cuda.synchronize()

    # fused_attention_gate, kd 1 at upatt_0 (Cm 16) and upatt_1 (Cm 32),
    # kd 3 at the upatt_2 shape (Cm 48)
    for site, shape, cm, kd in (("upatt_0", L0, 16, 1),
                                ("upatt_1", L1, 32, 1),
                                ("upatt_2", L2, 48, 3)):
        a1 = randn(*shape, cm).relu()
        xs = (randn(*shape, cm), randn(*shape, cm))
        w2, b2 = weight((3, 3, kd), cm, 1), vec(1, -.2, .2)
        vox = a1[..., 0].numel()
        keep("fused_attention_gate", check(
            f"fused_attention_gate kd{kd} {site} {shape}x{cm}",
            att.fused_attention_gate, att.fused_attention_gate_plain,
            (a1, xs, w2, b2), {}, (0.0, (2 * 9 * kd + 4) * cm * vox),
            site == "upatt_0"))
        del a1, xs
    for k in rec:
        rec[k]["max_abs_err"] = errs[k]
    return rec


def level_times(model, x, routes):
    """ms of each level of one forward of `x`: CUDA events at every top-level
    module's entry and exit; the time between two events goes to the level
    of the earlier one, so a routed decoder block (run between upsample_i
    and the next module) counts to level i."""
    import torch

    marks = []

    def level(name):
        return "bottom" if name.startswith("bottom") else (
            "level " + name.rsplit("_", 1)[1])

    def mark(lv):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((e, lv))

    hooks = []
    for name, m in model.named_children():
        lv = level(name)
        hooks.append(m.register_forward_pre_hook(
            lambda mod, args, lv=lv: mark(lv)))
        hooks.append(m.register_forward_hook(
            lambda mod, args, out, lv=lv: mark(lv)))
    try:
        with torch.no_grad():
            model(x, routes=routes)
            mark(None)
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for (e0, lv), (e1, _) in zip(marks, marks[1:]):
        out[lv] = out.get(lv, 0.0) + e0.elapsed_time(e1)
    return out


def routes_run(dev, gen, card: str, model, staged, default_logits):
    """Phase 8: the phase-3 volume under route configurations A, B and C.
    Returns (summed launch counts, {name: (kernel, plain) ms/volume})."""
    import torch

    from vs_seg_tpu_torch.core.config import Routes
    from vs_seg_tpu_torch.infer.engine import make_predictor
    from vs_seg_tpu_torch.infer.sliding_window import sliding_window_inference

    base = {**EVAL_RU, **EVAL_L2, "blend_scatter": 1,
            "conv333_dw": 0, "ds_conv": 0, "ring_probe": 0,
            "mosaic_probe": 0}
    configs = {
        # ru_block2d x 2 (one csrc/rublock2d.cu launch each), tail_block
        # at up_1 (one csrc/tail2d.cu launch), l2_block2d at the up_0 head
        # (one csrc/l2block2d.cu launch)
        "A": (Routes(rublock2d=True, l2block2d=True, tail2d1=True),
              dict(base, ru_block2d=2, l2_block2d=1, tail_block=1,
                   fused_attention_gate=0, conv333=EVAL_CONV333)),
        # upatt_0 and upatt_1
        "B": (Routes(att_fuse=True),
              dict(base, ru_block2d=0, l2_block2d=0, tail_block=0,
                   fused_attention_gate=2, conv333=EVAL_CONV333)),
        # downsample_2, downsample_3 and downsample_4
        "C": (Routes(dsconv=True),
              dict(base, ru_block2d=0, l2_block2d=0, tail_block=0,
                   fused_attention_gate=0, conv333=EVAL_CONV333,
                   ds_conv=3)),
    }
    total, vol_ms = {}, {}
    for name, (routes, expect) in configs.items():
        log(f"  configuration {name}: {routes}")

        def run(use_kernels: bool):
            pred = make_predictor(model, torch.bfloat16,
                                  use_kernels=use_kernels, routes=routes)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = sliding_window_inference(
                staged, ROI, pred, overlap=0.25, sw_batch_size=SW_BATCH,
                use_kernels=use_kernels)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t) * 1e3

        run(True)      # warm-up
        run(False)
        times = {True: [], False: []}
        counts, outs = None, {}
        for use_kernels in (False, True, True, False):
            if use_kernels and counts is None:
                reset_counts()
                outs[True], ms = run(True)
                counts = read_counts()
            else:
                outs[use_kernels], ms = run(use_kernels)
            times[use_kernels].append(ms)
        check_counts(counts, expect, f"configuration {name} inference")
        ko, po = outs[True], outs[False]
        if tuple(ko.shape) != (*VOLUME, 2) or not torch.isfinite(ko).all() \
                or not torch.isfinite(po).all():
            raise AssertionError(f"configuration {name}: bad logits")
        for what, ref in (("its plain path", po),
                          ("the default kernel path", default_logits)):
            compare(f"configuration {name} logits vs {what}", ko, ref,
                    LOGIT_TOL)
            agree = float((ko.argmax(-1) == ref.argmax(-1)).float().mean())
            log(f"  argmax agreement with {what} {agree!r} "
                f"(min {ARGMAX_MIN})")
            if agree < ARGMAX_MIN:
                raise AssertionError(f"configuration {name}: argmax "
                                     f"agreement {agree} < {ARGMAX_MIN}")
        for use_kernels in (True, False):
            ts = times[use_kernels]
            log(f"configuration {name}, "
                f"{'kernel' if use_kernels else 'plain'} path: "
                f"{sum(ts) / len(ts):.1f} ms/volume {ts} on {card}")
        vol_ms[name] = tuple(sum(times[k]) / len(times[k])
                             for k in (True, False))
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        del ko, po, outs

    # per-level split of one 8-window forward, default routes vs A and C
    x = torch.randn((SW_BATCH, ROI[2], ROI[0], ROI[1], 1),
                    generator=gen).to(dev, torch.bfloat16)
    for name, routes in (("default", Routes()), ("A", configs["A"][0]),
                         ("C", configs["C"][0])):
        level_times(model, x, routes)       # warm-up
        lv = level_times(model, x, routes)
        log(f"  per-level ms of one 8-window forward, routes {name}: "
            f"{lv} (sum {sum(lv.values())!r}) on {card}")
    return total, vol_ms


def graph_ms(fn, reps: int = REPS) -> float:
    """Device time per call of fn(): `reps` calls captured in one CUDA graph
    (after a warm-up call outside it), the graph replayed once between two
    CUDA events. The host's enqueue is out of the timing, as in a deep
    device queue (the model's forward), where a call pays device time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = REPS) -> float:
    """Host time to enqueue one call of fn() (mean of `reps` calls after a
    synchronise, the device queue not yet full)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def host_profile(fn, calls: int, top: int = 8):
    """cProfile of `calls` calls of fn(): (total ms per call, the `top`
    entries by own time as (name, own us per call, calls per call))."""
    import cProfile
    import pstats

    import torch
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof)
    rows = sorted(((k, v) for k, v in st.stats.items()),
                  key=lambda kv: -kv[1][2])[:top]
    ents = [(f"{Path(k[0]).name}:{k[1]}({k[2]})", v[2] * 1e6 / calls,
             v[1] / calls) for k, v in rows]
    return st.total_tt * 1e3 / calls, ents


# the flagship's (3,3,3) stride-(2,2,2) sites for one 8-window batch:
# (name, input (N, D, H, W), channels)
DS_SITES = (("downsample_2", (SW_BATCH, 64, 96, 96), 48),
            ("downsample_3", (SW_BATCH, 32, 48, 48), 64),
            ("downsample_4", (SW_BATCH, 16, 24, 24), 80))
DS_PROFILE_CALLS = 200   # calls of ds_conv profiled at downsample_4


def ds_site_args(dev, gen, shape, c):
    """Seeded ds_conv arguments at one site: x, w, scale, shift, alpha."""
    import numpy as np
    import torch
    x = torch.randn((*shape, c), generator=gen).to(dev, torch.bfloat16)
    bw = 1.0 / np.sqrt(27 * c)
    w = ((torch.rand((3, 3, 3, c, c), generator=gen) * 2 - 1) * bw).to(dev)
    s = (torch.rand(c, generator=gen) + .5).to(dev)
    h = (torch.rand(c, generator=gen) * .4 - .2).to(dev)
    a = (torch.rand(1, generator=gen) * .2 + .1).to(dev)
    return x, w, s, h, a


def dsconv_checks(dev, gen, card: str):
    """Phase 9: ds_conv vs its plain twin at the three flagship sites. Per
    site: the kernel's device time (CUDA-graph replay of REPS calls) beside
    its back-to-back CUDA-event time and the host's enqueue per call, the
    plain twin's time, one cuDNN strided conv's (graph replay), the bound
    and TFLOP/s; a JSON record per site; then a cProfile of
    DS_PROFILE_CALLS calls at downsample_4. The kernel record keeps
    downsample_2's numbers, its max_abs_err is the largest over the sites.
    """
    import torch
    import torch.nn.functional as F

    from vs_seg_tpu_torch.ops import dsconv

    rec, errs, sites = None, [], []
    for site, shape, c in DS_SITES:
        x, w, s, h, a = ds_site_args(dev, gen, shape, c)

        def run():
            return dsconv.ds_conv(x, w, s, h, a)

        got = run()
        name = f"ds_conv {site} {shape}x{c}->{c}"
        errs.append(compare(name, got, dsconv.ds_conv_plain(x, w, s, h, a),
                            KERNEL_TOL))
        dev_ms = graph_ms(run)
        ev_ms = cuda_ms(run)
        enq_ms = host_ms(run)
        p_ms = cuda_ms(lambda: dsconv.ds_conv_plain(x, w, s, h, a))
        # the library yardstick: one cuDNN strided conv (+ bias) on the same
        # bf16 NDHWC input (channels_last_3d, no copy)
        wt = w.to(torch.bfloat16).permute(4, 3, 2, 0, 1).contiguous()
        hb = h.to(torch.bfloat16)
        lib_ms = graph_ms(lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), wt, hb,
                                           stride=2, padding=1))
        flop = 2 * 27 * c * c * got[..., 0].numel()
        b = bound(nbytes(x, w, s, h, a, got), flop)
        row = dict(site=site, shape=[*shape], cin=c, cout=c, ms=dev_ms,
                   event_ms=ev_ms, host_enqueue_ms=enq_ms, plain_ms=p_ms,
                   cudnn_ms=lib_ms, bound_ms=b[0], bound_by=b[1],
                   tflops=flop / dev_ms / 1e9, max_abs_err=errs[-1],
                   card=card)
        sites.append(row)
        log(f"  {name}: kernel {dev_ms!r} ms device (graph replay), "
            f"{ev_ms!r} ms back to back, host enqueue {enq_ms!r} ms/call; "
            f"plain {p_ms!r} ms, cuDNN {lib_ms!r} ms, bound {b[0]!r} ms "
            f"({b[1]}: {b[2] / 1e9:.3f} GB, {b[3] / 1e9:.1f} GFLOP) = "
            f"{row['tflops']!r} TFLOP/s on {card}")
        print(json.dumps({"ds_conv_site": row}), flush=True)
        if rec is None:
            rec = dict(shape=name, ms=dev_ms, plain_ms=p_ms,
                       library_ms=lib_ms, bound=b)
        if site == DS_SITES[-1][0]:
            tot, ents = host_profile(run, DS_PROFILE_CALLS)
            log(f"  ds_conv host profile at {site}, {DS_PROFILE_CALLS} "
                f"calls: {tot!r} ms/call under cProfile; own us per call:")
            for fn_name, us, ncalls in ents:
                log(f"    {us:8.2f} us  x{ncalls:g}  {fn_name}")
        del x, got
    rec["max_abs_err"] = max(errs)
    log(f"  ds_conv over the {len(sites)} sites: device "
        f"{sum(r['ms'] for r in sites)!r} ms, cuDNN "
        f"{sum(r['cudnn_ms'] for r in sites)!r} ms, bound "
        f"{sum(r['bound_ms'] for r in sites)!r} ms, host enqueue "
        f"{sum(r['host_enqueue_ms'] for r in sites)!r} ms on {card}")
    torch.cuda.synchronize()
    return {"ds_conv": rec}


# conv333's sites for the sweep of phase 11: (site, (N, D, H, W), input
# channels (a pair has two), Cout, kd, residual input channels (None: no
# residual; "x": the conv's own input, as the decoder blocks pass it),
# epilogue: "bn" scale/shift/PReLU, "relu" bias + ReLU, "head" bias only,
# "none" the bare conv of a dgrad)
# level i of one window batch (D-first; levels 0-2 keep D, then it halves)
_L = {i: (SW_BATCH, ROI[2] >> max(0, i - 2), ROI[0] >> i, ROI[1] >> i)
      for i in range(6)}
_BOT = _L[5]
CONV_SITES = (
    # the conv333 sites of one 8-window forward (default routes) and of
    # the parent chains the unit kernel and the gated instance replaced:
    # ru_block at down_2/3/4 and the bottom (conv0, then conv1 + residual
    # from the block input: the unit kernel runs each unit in one launch,
    # timed in phase 2's ru_block rows), l2_block at up_2/3/4 (conv1 +
    # ReLU, on the path; its conv0 runs as the gated instance, timed in
    # phase 2's l2_block rows: the "conv0" rows here are the parent
    # chain's, on a materialised pair)
    ("down_2 unit0", _L[2], (32,), 48, 3, None, "bn"),
    ("down_2 unit1", _L[2], (48,), 48, 3, (32,), "bn"),
    ("down_3 unit0", _L[3], (48,), 64, 3, None, "bn"),
    ("down_3 unit1", _L[3], (64,), 64, 3, (48,), "bn"),
    ("down_4 unit0", _L[4], (64,), 80, 3, None, "bn"),
    ("down_4 unit1", _L[4], (80,), 80, 3, (64,), "bn"),
    ("bottom unit0", _BOT, (80,), 96, 3, None, "bn"),
    ("bottom unit1", _BOT, (96,), 96, 3, (80,), "bn"),
    ("up_2 conv1", _L[2], (48, 48), 48, 3, None, "relu"),
    ("up_2 conv0", _L[2], (48, 48), 48, 3, "x", "bn"),
    ("up_3 conv1", _L[3], (64, 64), 64, 3, None, "relu"),
    ("up_3 conv0", _L[3], (64, 64), 64, 3, "x", "bn"),
    ("up_4 conv1", _L[4], (80, 80), 80, 3, None, "relu"),
    ("up_4 conv0", _L[4], (80, 80), 80, 3, "x", "bn"),
    # the kd = 1 conv sites that configuration A's fused kernels replaced:
    # at down_0/1 the two of ru_block2d's chain, at up_1 the conv0 of
    # tail_block's chain, at up_0 the two convs of l2_block2d's chain
    ("A down_0 unit0", _L[0], (1,), 16, 1, None, "bn"),
    ("A down_0 unit1", _L[0], (16,), 16, 1, (1,), "bn"),
    ("A down_1 unit0", _L[1], (16,), 32, 1, None, "bn"),
    ("A down_1 unit1", _L[1], (32,), 32, 1, (16,), "bn"),
    ("chain up_1 tail conv0", _L[1], (32, 32), 32, 1, "x", "bn"),
    ("chain up_0 conv1", _L[0], (16, 16), 16, 1, None, "relu"),
    ("chain up_0 head conv0", _L[0], (16, 16), 2, 1, "x", "head"),
    # the train dgrad (batch 1): dx = conv(dy, flipped w^T), no epilogue
    ("dgrad down_2 unit0", (1,) + _L[2][1:], (48,), 32, 3, None, "none"),
    ("dgrad up_3 half", (1,) + _L[3][1:], (64,), 64, 3, None, "none"),
    ("dgrad bottom unit0", (1,) + _BOT[1:], (96,), 80, 3, None, "none"),
)


def conv_site_inputs(dev, gen, shape, cins, cout, kd, res, epi):
    """Seeded inputs of one CONV_SITES row, drawn on the card from `gen`:
    (xs, x (a tensor or the pair), w, the epilogue args, the residual
    argument or None, the residual's inputs)."""
    import numpy as np
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    xs = tuple(randn(*shape, c) for c in cins)
    x = xs if len(xs) > 1 else xs[0]
    b = 1.0 / np.sqrt(9 * kd * sum(cins))
    w = (rand(3, 3, kd, sum(cins), cout) * 2 - 1) * b

    def vec(c, lo, hi):
        return rand(c) * (hi - lo) + lo

    args = {"bn": (vec(cout, .5, 1.5), vec(cout, -.2, .2),
                   vec(1, .1, .3)),
            "relu": (None, vec(cout, -.2, .2),
                     torch.zeros(1, device=dev)),
            "head": (None, vec(cout, -.2, .2), None),
            "none": (None, None, None)}[epi]
    resid, rin = None, ()
    if res is not None:
        rin = xs if res == "x" else tuple(randn(*shape, c) for c in res)
        cr = sum(v.shape[-1] for v in rin)
        resid = (rin if len(rin) > 1 else rin[0],
                 (rand(1, 1, 1, cr, cout) * 2 - 1) / np.sqrt(cr),
                 vec(cout, -.2, .2))
    return xs, x, w, args, resid, rin


def conv333_sweep(dev, card: str):
    """Phase 11: conv333 at each of its sites against its plain twin, with
    kernel, F.conv3d (channels-last) and bound times; the host's enqueue
    time of one call at the bottom site. Inputs are drawn on the card from
    a seeded generator (the level-0 sites hold 1.2 G values)."""
    import torch
    import torch.nn.functional as F

    from vs_seg_tpu_torch.ops import conv333

    gen = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for site, shape, cins, cout, kd, res, epi in CONV_SITES:
        xs, x, w, args, resid, rin = conv_site_inputs(
            dev, gen, shape, cins, cout, kd, res, epi)

        def run():
            return conv333.conv333(x, w, *args, residual=resid)

        got = run()
        err = compare(f"conv333 sweep {site}", got,
                      conv333.conv333_plain(x, w, *args, residual=resid),
                      KERNEL_TOL)
        k_ms = cuda_ms(run)
        # the library yardstick: one cuDNN conv of the (concatenated) input,
        # channels-last, without the residual
        xc = torch.cat(xs, -1) if len(xs) > 1 else xs[0]
        wt = w.to(torch.bfloat16).permute(4, 3, 2, 0, 1).contiguous()
        lib_ms = cuda_ms(lambda: F.conv3d(xc.permute(0, 4, 1, 2, 3), wt,
                                          padding=(kd // 2, 1, 1)))
        vox = xc[..., 0].numel()
        cr = sum(v.shape[-1] for v in rin)
        flop = 2 * vox * cout * (9 * kd * sum(cins) + cr)
        moved = nbytes(*xs, w, got, *(t for t in args if t is not None))
        if resid is not None:
            moved += nbytes(resid[1], resid[2])
            if res != "x":
                moved += nbytes(*rin)
        bd = bound(moved, flop)
        row = dict(site=site, shape=[*shape], cin=list(cins), cout=cout,
                   kd=kd, residual=cr, ms=k_ms, conv3d_ms=lib_ms,
                   bound_ms=bd[0], bound_by=bd[1], tflops=flop / k_ms / 1e9,
                   gbs=moved / k_ms / 1e6, max_abs_err=err)
        if site.startswith("bottom unit1"):
            row["host_enqueue_ms"] = host_ms(run)
        rows.append(row)
        log(f"  {site} {tuple(shape)} {cins}->{cout} kd {kd} res {cr}: "
            f"kernel {k_ms!r} ms, F.conv3d {lib_ms!r} ms, bound {bd[0]!r} "
            f"ms ({bd[1]}), {row['tflops']!r} TFLOP/s, {row['gbs']!r} GB/s"
            + (f", host enqueue {row['host_enqueue_ms']!r} ms/call"
               if "host_enqueue_ms" in row else "") + f" on {card}")
        del xs, x, rin, resid, got, xc
    torch.cuda.synchronize()
    for part in ("eval", "A ", "chain", "dgrad"):
        sel = [r for r in rows if (
            r["site"].startswith(part) if part != "eval"
            else not r["site"].startswith(("A ", "chain", "dgrad")))]
        log(f"  conv333 {part.strip()} sites: kernel "
            f"{sum(r['ms'] for r in sel)!r} ms, F.conv3d "
            f"{sum(r['conv3d_ms'] for r in sel)!r} ms, bound "
            f"{sum(r['bound_ms'] for r in sel)!r} ms over {len(sel)} sites "
            f"on {card}")
    return rows


# mosaic probes vs their twins on seeded normals: f32 sums of up to 4608
# terms taken in another order (the tensor-core schemes keep ~21 bits of
# each term: x split into two TF32 parts against an exact 0/1 matrix)
PROBE_TOL = 1e-5
PROBE_REPS = 50
# the probes again with the leading size scaled by this factor (the group
# sums at 226 MB of f32), where launch overhead no longer sets the time
PROBE_SCALE = 256


def mosaic_probe_checks(dev, card: str):
    """Phase 12: the nine Mosaic probes (csrc/mosaic_probe.cu) against
    their twins at the tool's shapes, every scheme: bit-equal on the tool's
    all-ones inputs, and on seeded normals bit-equal (3droll, repeat) or
    within PROBE_TOL; each scheme's time beside the case's bound; then the
    same on seeded normals with the leading size scaled by PROBE_SCALE.
    The record's times are the tool's shapes' (default schemes, summed)."""
    import torch

    from vs_seg_tpu_torch.ops import mosaic_probe as mp

    rows, errs = [], []
    total = dict(ms=0.0, plain_ms=0.0, bound=0.0, moved=0)
    for i, case in enumerate(mp.CASES):
        ones = mp.inputs(case, dev)
        seeded = mp.inputs(case, dev, seed=SEED + 2 + i)
        ref1, ref = mp.plain(case, *ones), mp.plain(case, *seeded)
        times = {}
        for scheme in mp.SCHEMES[case]:
            tag = f"mosaic_probe {case} ({scheme})"
            if not torch.equal(mp.probe(case, *ones, scheme=scheme), ref1):
                raise AssertionError(f"{tag}: all-ones input, not the twin's "
                                     "result bit for bit")
            got = mp.probe(case, *seeded, scheme=scheme)
            if case in mp.EXACT:
                if not torch.equal(got, ref):
                    raise AssertionError(f"{tag}: not bit-equal to its twin")
                errs.append(0.0)
            else:
                errs.append(compare(tag + " seeded", got, ref, PROBE_TOL))
            times[scheme] = cuda_ms(
                lambda s=scheme: mp.probe(case, *seeded, scheme=s),
                PROBE_REPS)
        p_ms = cuda_ms(lambda: mp.plain(case, *seeded), PROBE_REPS)
        moved = mp.moved_bytes(case, ones, ref1)
        b = bound(moved)
        default = mp.SCHEMES[case][0]
        total["ms"] += times[default]
        total["plain_ms"] += p_ms
        total["bound"] += b[0]
        total["moved"] += moved
        rows.append(dict(case=case, ms=times, plain_ms=p_ms, bound_ms=b[0],
                         bytes=moved))
        log(f"  mosaic_probe {case}: " + ", ".join(
            f"{k} {v!r} ms" for k, v in times.items())
            + f"; plain {p_ms!r} ms; bound {b[0]!r} ms (bytes: {moved}) "
            f"on {card}")
    # the schemes at scale: seeded normals drawn on the card
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    for case in mp.CASES:
        rows0 = mp._shapes(case)[0][0]
        data = [torch.randn(sh, generator=gen, device=dev)
                for sh in mp._shapes(case, rows0 * PROBE_SCALE)]
        ins = tuple(data) + ((mp.group_matrix(dev),)
                             if case in ("dotreduce", "dotbcast") else ())
        ref = mp.plain(case, *ins)
        times = {}
        for scheme in mp.SCHEMES[case]:
            tag = f"mosaic_probe {case} x{PROBE_SCALE} ({scheme})"
            got = mp.probe(case, *ins, scheme=scheme)
            if case in mp.EXACT:
                if not torch.equal(got, ref):
                    raise AssertionError(f"{tag}: not bit-equal to its twin")
            else:
                errs.append(compare(tag, got, ref, PROBE_TOL))
            del got
            times[scheme] = cuda_ms(
                lambda s=scheme: mp.probe(case, *ins, scheme=s))
        p_ms = cuda_ms(lambda: mp.plain(case, *ins))
        moved = mp.moved_bytes(case, ins, ref)
        b = bound(moved)
        rows.append(dict(case=case, scale=PROBE_SCALE, ms=times,
                         plain_ms=p_ms, bound_ms=b[0], bytes=moved))
        log(f"  mosaic_probe {case} x{PROBE_SCALE} {tuple(data[0].shape)}: "
            + ", ".join(f"{k} {v!r} ms" for k, v in times.items())
            + f"; plain {p_ms!r} ms; bound {b[0]!r} ms (bytes: {moved}) "
            f"on {card}")
        del data, ins, ref
    torch.cuda.synchronize()
    log(f"  mosaic_probe rows: {json.dumps(rows)}")
    return {"mosaic_probe": dict(
        shape="nine cases at the tool's shapes, default schemes, summed",
        max_abs_err=max(errs), ms=total["ms"], plain_ms=total["plain_ms"],
        library_ms=None,
        bound=(total["bound"], "bytes", total["moved"], 0.0, 0.0))}


# attgate's sites on one 8-window batch (D-first): (site, wrapper, (N, D,
# H, W), Ca, Cx, kd); "chain" sites are those of a chain that a fused
# kernel replaced. "attgate" is ops/l2block.py:attgate (the middle stage
# of the parent chain of l2_block and of l2_block2d's and tail_block's
# chains, two gated inputs and the map); "att_map" is its att-only mode
# (ops/l2block.py:att_map, l2_block's middle stage: no gated inputs, the
# f32 and the bf16 map); "fused" is ops/att.py:fused_attention_gate (two
# gated inputs, compact map)
ATT_SITES = (
    ("chain up_2", "attgate", _L[2], 48, 48, 3),
    ("chain up_3", "attgate", _L[3], 64, 64, 3),
    ("chain up_4", "attgate", _L[4], 80, 80, 3),
    ("chain up_1 tail", "attgate", _L[1], 32, 32, 1),
    ("chain up_0 head", "attgate", _L[0], 16, 16, 1),
    ("B upatt_0", "fused", _L[0], 16, 16, 1),
    ("B upatt_1", "fused", _L[1], 32, 32, 1),
    ("up_2", "att_map", _L[2], 48, 0, 3),
    ("up_3", "att_map", _L[3], 64, 0, 3),
    ("up_4", "att_map", _L[4], 80, 0, 3),
)


def attgate_sweep(dev, card: str):
    """Phase 13: attgate at each of its sites (ATT_SITES) against its plain
    twin, with the kernel's, the twin's and the bound's times. Inputs are
    drawn on the card from a seeded generator."""
    import numpy as np
    import torch

    from vs_seg_tpu_torch.ops import att, l2block

    gen = torch.Generator(dev).manual_seed(SEED + 1)
    rows = []
    for site, kind, shape, ca, cx, kd in ATT_SITES:
        a1 = torch.randn((*shape, ca), generator=gen, device=dev,
                         dtype=torch.bfloat16).relu_()
        xa, xb = (torch.randn((*shape, cx), generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        w2 = ((torch.rand((3, 3, kd, ca, 1), generator=gen, device=dev) * 2
               - 1) / np.sqrt(9 * kd * ca))
        b2 = torch.rand(1, generator=gen, device=dev) * .4 - .2
        parts = ("att", "ga", "gb")
        if kind == "attgate":
            def run():
                return l2block.attgate(a1, w2, b2, xa, xb)

            def twin():
                return l2block.attgate_plain(a1, w2, b2, xa, xb)
        elif kind == "att_map":
            parts = ("att32", "att")
            xa = xb = None

            def run():
                return l2block.att_map(a1, w2, b2)

            def twin():
                return l2block.att_map_plain(a1, w2, b2)
        else:
            def run():
                at, (ga, gb) = att.fused_attention_gate(a1, (xa, xb), w2, b2)
                return at, ga, gb

            def twin():
                at, (ga, gb) = att.fused_attention_gate_plain(
                    a1, (xa, xb), w2, b2)
                return at, ga, gb
        got, ref = run(), twin()
        err = max(compare(f"attgate sweep {site} {part}", g, r, KERNEL_TOL)
                  for part, g, r in zip(parts, got, ref))
        vox = a1[..., 0].numel()
        b = bound(nbytes(a1, xa, xb, w2, b2, *got),
                  f32_flop=(2 * 9 * kd * ca + 4 * cx) * vox)
        del got, ref
        k_ms = cuda_ms(run)
        p_ms = cuda_ms(twin)
        rows.append(dict(site=site, shape=[*shape], ca=ca, cx=cx, kd=kd,
                         ms=k_ms, plain_ms=p_ms, bound_ms=b[0],
                         bound_by=b[1], gbs=b[2] / k_ms / 1e6,
                         max_abs_err=err))
        log(f"  attgate {site} {tuple(shape)} Ca {ca} Cx {cx} kd {kd}: "
            f"kernel {k_ms!r} ms, plain {p_ms!r} ms, bound {b[0]!r} ms "
            f"({b[1]}: {b[2] / 1e9:.3f} GB) = {b[2] / k_ms / 1e6!r} GB/s "
            f"on {card}")
        del a1, xa, xb
    torch.cuda.synchronize()
    for name, sel in (("default", ("up_",)), ("A", ("up_", "A ")),
                      ("B", ("up_", "B "))):
        rs = [r for r in rows if r["site"].startswith(sel)]
        log(f"  attgate per volume, routes {name}: kernel "
            f"{sum(r['ms'] for r in rs)!r} ms, bound "
            f"{sum(r['bound_ms'] for r in rs)!r} ms over {len(rs)} sites "
            f"on {card}")
    return rows


def dw_train_sites(dev):
    """The (N, D, H, W), Cin, Cout of every conv333_dw call in one train
    step of the flagship (the phase-6 configuration: batch 1, 384x384x64
    crops, bf16), in the order the backward makes them: a hook on
    Conv333Train's wgrad records each call. The weights and the crop are
    seeded."""
    import torch

    from vs_seg_tpu_torch.core.config import Config
    from vs_seg_tpu_torch.models import UNet2d5_spvPA
    from vs_seg_tpu_torch.ops import train_conv
    from vs_seg_tpu_torch.train import trainer as tr

    cfg = Config(data_root=str(REPO / "build" / "chip_smoke_train"), seed=SEED)
    dtype = tr.DTYPES[cfg.compute_dtype]
    model = UNet2d5_spvPA(dtype=dtype, device=dev,
                          generator=torch.Generator().manual_seed(SEED),
                          **cfg.model_kwargs())
    h, w, d = cfg.pad_crop_shape
    gen = torch.Generator(dev).manual_seed(SEED)
    image = torch.randn((cfg.train_batch_size, d, h, w, cfg.in_channels),
                        generator=gen, device=dev).to(dtype)
    sites = []
    inner = train_conv.conv333_dw

    def hook(x, dy):
        sites.append((tuple(int(s) for s in x.shape[:4]), int(x.shape[-1]),
                      int(dy.shape[-1])))
        return inner(x, dy)

    train_conv.conv333_dw = hook
    try:
        logits, atts = model(image, use_kernels=True, train=True,
                             generator=gen)
        (logits.float().sum() + sum(a.float().sum() for a in atts)).backward()
    finally:
        train_conv.conv333_dw = inner
    del model, image, logits, atts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sites


def dw_sweep(dev, card: str, rec):
    """Phase 14: conv333_dw at each of the TRAIN_SITES sites of one train
    step (dw_train_sites), seeded bf16 inputs: two runs bit-equal, within
    DW_TOL of the plain twin, the kernel's time beside cuDNN's wgrad
    (torch.nn.grad.conv3d_weight, the library yardstick), the bound,
    TFLOP/s and the host's enqueue time per call; then the sums over the
    sites. Widens rec["conv333_dw"]'s max_abs_err to every site (its times
    stay phase 5's at down_2 unit1)."""
    import torch

    from vs_seg_tpu_torch.ops import conv333_dw as dwm

    sites = dw_train_sites(dev)
    if len(sites) != TRAIN_SITES:
        raise AssertionError(f"{len(sites)} conv333_dw sites in one train "
                             f"step, expected {TRAIN_SITES}")
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    rows = []
    for i, (shape, cin, cout) in enumerate(sites):
        x = torch.randn((*shape, cin), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        dy = torch.randn((*shape, cout), generator=gen, device=dev,
                         dtype=torch.bfloat16)

        def run():
            return dwm.conv333_dw(x, dy)

        dw, db = run()
        dw2, db2 = run()
        if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
            raise AssertionError(f"conv333_dw site {i}: two runs differ")
        pdw, pdb = dwm.conv333_dw_plain(x, dy)
        tag = f"conv333_dw sweep site {i:02d} {shape}x{cin}->{cout}"
        err = max(compare(tag + " dw", dw, pdw, DW_TOL),
                  compare(tag + " db", db, pdb, DW_TOL))
        del dw2, db2, pdw, pdb
        k_ms = cuda_ms(run)
        lib_ms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(
            x.permute(0, 4, 1, 2, 3), (cout, cin, 3, 3, 3),
            dy.permute(0, 4, 1, 2, 3), padding=1))
        enq = host_ms(run)
        flop = 2 * 27 * cin * cout * x[..., 0].numel()
        bd = bound(nbytes(x, dy, dw, db), flop)
        rows.append(dict(site=i, shape=[*shape], cin=cin, cout=cout, ms=k_ms,
                         cudnn_ms=lib_ms, bound_ms=bd[0], bound_by=bd[1],
                         tflops=flop / k_ms / 1e9, host_enqueue_ms=enq,
                         max_abs_err=err))
        log(f"  {tag}: kernel {k_ms!r} ms ({flop / k_ms / 1e9!r} TFLOP/s), "
            f"cuDNN wgrad {lib_ms!r} ms, bound {bd[0]!r} ms ({bd[1]}), host "
            f"enqueue {enq!r} ms/call on {card}")
        del x, dy, dw, db
    torch.cuda.synchronize()
    sums = {k: sum(r[k] for r in rows)
            for k in ("ms", "cudnn_ms", "bound_ms", "host_enqueue_ms")}
    log(f"  conv333_dw over the {len(rows)} train sites: kernel "
        f"{sums['ms']!r} ms, cuDNN wgrad {sums['cudnn_ms']!r} ms, bound "
        f"{sums['bound_ms']!r} ms, host enqueue {sums['host_enqueue_ms']!r} "
        f"ms; kernel faster than cuDNN at "
        f"{sum(r['ms'] < r['cudnn_ms'] for r in rows)} sites on {card}")
    print(json.dumps({"conv333_dw_sites": rows}), flush=True)
    if rec is not None:
        r = rec["conv333_dw"]
        r["max_abs_err"] = max(r["max_abs_err"],
                               max(x["max_abs_err"] for x in rows))
    return rows


CLI_CASES = 2            # synthetic test cases of phase 10


def cli_run(dev, card: str, model):
    """Phase 10: the inference CLI end to end on synthetic NIFTIs, through
    the kernels under --routes dsconv and through the plain path."""
    import dataclasses
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from vs_seg_tpu_torch.cli import inference
    from vs_seg_tpu_torch.core.config import parse_cli
    from vs_seg_tpu_torch.data import nifti
    from vs_seg_tpu_torch.data.dataset import (CacheDataset, DataLoader,
                                               load_split_csv)
    from vs_seg_tpu_torch.data.synthetic import generate_dataset
    from vs_seg_tpu_torch.data.transforms import get_transforms
    from vs_seg_tpu_torch.infer.engine import run_inference
    from vs_seg_tpu_torch.train.checkpoint import save_checkpoint

    root = REPO / "build" / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    split = generate_dataset(str(root), n_train=0, n_val=0, n_test=CLI_CASES,
                             shape=VOLUME, seed=SEED)
    log(f"  {CLI_CASES} synthetic test cases of {VOLUME} written in "
        f"{time.perf_counter() - t:.1f} s")
    argv = ["--data_root", str(root), "--split", split,
            "--results_folder_name", "kernels", "--device", "cuda:0",
            "--routes", "dsconv", "--sw_batch_size", str(SW_BATCH)]
    cfg = parse_cli(argv)
    # phase 3's flagship weights as the port's checkpoint
    save_checkpoint(str(Path(cfg.model_path) / "best_metric_model.ckpt"),
                    {"model": model.state_dict()})
    figs = importlib.util.find_spec("matplotlib") is not None
    log(f"  matplotlib {'found' if figs else 'not found'}: figures "
        f"{'on' if figs else 'off'}")

    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    dice_k, times_k = inference.main(argv, make_figures=figs)
    torch.cuda.synchronize()
    counts = read_counts()
    wall = time.perf_counter() - t
    forwards = CLI_CASES          # one 8-window batch per volume
    check_counts(counts, {
        "ds_conv": 3 * forwards,
        **{k: n * forwards for k, n in {**EVAL_RU, **EVAL_L2}.items()},
        "conv333": EVAL_CONV333 * forwards, "blend_scatter": forwards,
        "conv333_dw": 0, "ru_block2d": 0, "l2_block2d": 0, "tail_block": 0,
        "fused_attention_gate": 0, "ring_probe": 0, "mosaic_probe": 0,
        "bn_dropout_prelu": 0}, "CLI (--routes dsconv)")

    # the plain path: same data, weights and routes, every kernel site on
    # its plain twin, exported beside the kernel path's results
    plain_cfg = dataclasses.replace(cfg, results_folder_name="plain")
    _, _, test_files = load_split_csv(cfg.split_csv, cfg.dataset,
                                      cfg.data_root)
    loader = DataLoader(CacheDataset(test_files,
                                     get_transforms(cfg.pad_crop_shape_test)[2],
                                     num_workers=cfg.num_workers))
    dice_p, times_p = run_inference(plain_cfg, model, loader, device=dev,
                                    make_figures=False, use_kernels=False)

    agree = []
    for f in test_files:
        case = Path(f["label"]).parent.name
        base = Path(f["label"]).name
        ref = nifti.load(f["label"])
        outs = [nifti.load(str(Path(c.results_folder_path)
                               / "inferred_segmentations_nifti" / case
                               / base))
                for c in (cfg, plain_cfg)]
        for o in outs:
            if o.data.shape != ref.data.shape or not np.allclose(
                    o.affine, ref.affine):
                raise AssertionError(f"{case}: export {o.data.shape} "
                                     f"{o.affine.tolist()} vs original "
                                     f"{ref.data.shape} {ref.affine.tolist()}")
            if not set(np.unique(o.data)) <= {0.0, 1.0}:
                raise AssertionError(f"{case}: labels {np.unique(o.data)}")
        agree.append(float((outs[0].data == outs[1].data).mean()))
    log(f"  exports read back with the original affine and shape "
        f"{ref.data.shape}; labelmap agreement kernel vs plain {agree} "
        f"(min {ARGMAX_MIN})")
    log(f"  Dice kernel path {dice_k.tolist()}, plain path {dice_p.tolist()}")
    if min(agree) < ARGMAX_MIN:
        raise AssertionError(f"labelmap agreement {agree} < {ARGMAX_MIN}")
    if not (np.isfinite(dice_k).all() and np.isfinite(dice_p).all()
            and np.abs(dice_k - dice_p).max() <= 1e-2):
        raise AssertionError(f"Dice differs: {dice_k} vs {dice_p}")
    if figs and not (Path(cfg.figures_path)
                     / "best_model_output_dice_score_histogram.png").is_file():
        raise AssertionError("the CLI wrote no figures")
    log(f"CLI --routes dsconv, kernel path: compute s/volume {times_k!r} "
        f"(whole CLI {wall:.1f} s wall) on {card}")
    log(f"CLI plain path: compute s/volume {times_p!r} on {card}")
    return counts


TRAIN_CLI_CASES = 6      # synthetic training cases of phase 15 (+1 val)
TRAIN_CLI_EPOCHS = 3     # epochs of phase 15's runs (i) and (ii)
TRACE_TOP = 12           # kernel names listed from phase 15's trace
TDB_REPS = 5             # timed to_device_batch calls per order
LOADER_EPOCHS = 5        # timed DeviceLoader epochs


def train_cli_counts(steps: int, val_forwards: int) -> dict:
    """Expected launches of a training CLI run of `steps` train steps and
    `val_forwards` eval forwards of one crop."""
    return {"conv333_dw": TRAIN_SITES * steps,
            "conv333": TRAIN_SITES * steps + EVAL_CONV333 * val_forwards,
            **{k: n * val_forwards
               for k, n in {**EVAL_RU, **EVAL_L2}.items()},
            "blend_scatter": 0, **NO_KD1, **bn_launches(steps)}


def kernel_family(name: str) -> str:
    """A trace kernel's family: the port's hand kernels by their
    __global__ names, then the library's by name."""
    import re
    rules = (("conv333 gated", r"\bconv333_gated_kernel\b"),
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
    for fam, pat in rules:
        if re.search(pat, name):
            return fam
    return "other"


def trace_summary(folder: Path):
    """Busy share, device ms by kernel family and the TRACE_TOP kernel
    names by device ms (each with its count) of the newest torch.profiler
    trace in `folder`: the union of the device's kernel, copy and memset
    intervals over the span of all the trace's events. None when the trace
    holds no device event."""
    traces = sorted(folder.glob("*.pt.trace.json"),
                    key=lambda p: p.stat().st_mtime)
    if not traces:
        raise AssertionError(f"no torch.profiler trace under {folder}")
    with open(traces[-1]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return None
    span0 = min(e["ts"] for e in events)
    span1 = max(e["ts"] + e["dur"] for e in events)
    busy, last = 0.0, span0
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        busy += max(0.0, e - max(s, last))
        last = max(last, e)
    fams, names = {}, {}
    for e in dev:
        fam = kernel_family(e["name"])
        fams[fam] = fams.get(fam, 0.0) + e["dur"] / 1e3
        ms, n = names.get(e["name"], (0.0, 0))
        names[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:TRACE_TOP]
    return {"file": traces[-1].name, "mib": traces[-1].stat().st_size / 2**20,
            "window_ms": (span1 - span0) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (span1 - span0), "device_events": len(dev),
            "families_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
            "top": [(kernel_family(k), k, ms, n) for k, (ms, n) in top]}


def train_cli_run(dev, card: str):
    """Phase 15: the training CLI end to end at full width (384x384x64
    crops): (i) the host loader, (ii) --device_cache, (iii) (i)'s last
    checkpoint resumed for one more epoch under --profile_steps 2; then the
    device loader's crops and its freedom from syncs, and the host
    transfer's time."""
    import dataclasses
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from vs_seg_tpu_torch.cli import train as cli_train
    from vs_seg_tpu_torch.core.config import parse_cli
    from vs_seg_tpu_torch.data.dataset import (CacheDataset, DataLoader,
                                               load_split_csv)
    from vs_seg_tpu_torch.data.device_pipeline import (DeviceCachedDataset,
                                                       DeviceLoader)
    from vs_seg_tpu_torch.data.synthetic import generate_dataset
    from vs_seg_tpu_torch.data.transforms import get_transforms
    from vs_seg_tpu_torch.models import build_model
    from vs_seg_tpu_torch.train import trainer as tr

    root = REPO / "build" / "chip_smoke_train_cli"
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    split = generate_dataset(str(root), n_train=TRAIN_CLI_CASES, n_val=1,
                             n_test=0, shape=VOLUME, seed=SEED)
    log(f"  {TRAIN_CLI_CASES} training + 1 validation synthetic cases of "
        f"{VOLUME} written in {time.perf_counter() - t:.1f} s")
    figs = importlib.util.find_spec("matplotlib") is not None
    log(f"  matplotlib {'found' if figs else 'not found'}: figures "
        f"{'on' if figs else 'off'}; tensorboardX "
        f"{'found' if importlib.util.find_spec('tensorboardX') else 'not found'}")

    def argv(name, *extra):
        return ["--data_root", str(root), "--split", split,
                "--results_folder_name", name, "--device", "cuda:0",
                "--seed", str(SEED), *extra]

    # The reference CLI has no epochs flag and the port adds none: each run
    # wraps cli.train.config_from_args in this process to set num_epochs
    # (val_interval 1). Each train step is bracketed by CUDA events, read
    # after the fit: the timing adds no sync to the CLI's own.
    real_cfg, real_make, real_trainer = (cli_train.config_from_args,
                                         tr.make_train_step,
                                         cli_train.Trainer)
    step_log, fit_s = [], []

    def timed_make(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def timed(image, label, gen):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(image, label, gen)
            end.record()
            step_log.append((start, end))
            return loss
        return timed

    class TimedTrainer(real_trainer):
        def fit(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().fit(*args, **kwargs)
            torch.cuda.synchronize()
            fit_s.append(time.perf_counter() - t0)
            return out

    def run(mode, args, epochs, new_epochs):
        log(f"  training CLI ({mode}): config_from_args wrapped to "
            f"num_epochs={epochs}, val_interval=1")
        cli_train.config_from_args = (
            lambda a: dataclasses.replace(real_cfg(a), num_epochs=epochs,
                                          val_interval=1))
        step_log.clear()
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, losses, dice = cli_train.main(args, make_figures=figs)
        torch.cuda.synchronize()
        counts = read_counts()
        wall = time.perf_counter() - t0
        steps = len(step_log)
        if (steps != TRAIN_CLI_CASES * new_epochs or len(losses) != new_epochs
                or len(dice) != new_epochs or state["epoch"] != epochs
                or not np.isfinite(list(losses) + list(dice)).all()):
            raise AssertionError(f"training CLI ({mode}): {steps} steps, "
                                 f"losses {losses}, dice {dice}, epoch "
                                 f"{state['epoch']}")
        check_counts(counts, train_cli_counts(steps, new_epochs),
                     f"training CLI ({mode})")
        # ms/step by the device's clock: from the end of one step to the
        # end of the next within an epoch (the loader's fetch, the host
        # transfer, the step, and any wait of the device on the host), each
        # epoch's first step left out. The CLI's train_loss line syncs every
        # step of a run's first epoch; later epochs make no sync per step
        # but the host loader's pageable copy (to_device_batch).
        gaps = [[step_log[k - 1][1].elapsed_time(step_log[k][1])
                 for k in range(e * TRAIN_CLI_CASES + 1,
                                (e + 1) * TRAIN_CLI_CASES)]
                for e in range(new_epochs)]
        device = [a.elapsed_time(b) for a, b in step_log[1:]]
        first = gaps[0]
        later = [ms for epoch in gaps[1:] for ms in epoch]

        def mean(xs):
            return (f"{sum(xs) / len(xs):.1f} ms/step "
                    f"{[round(x, 2) for x in xs]}")
        log(f"training CLI ({mode}): epoch losses {losses}, val dice {dice}; "
            f"by the device clock, steps 2.. of each epoch: first epoch "
            f"(synchronised each step by the CLI's train_loss line) "
            f"{mean(first)}"
            + (f"; epochs 2..{new_epochs} (no sync per step) {mean(later)}"
               if later else "")
            + f"; each step's own device time {mean(device)}; fit wall "
            f"{fit_s[-1]:.2f} s, CLI wall {wall:.2f} s on {card}")
        return counts, (parse_cli(args), epochs)

    total, cfgs = {}, {}
    try:
        tr.make_train_step = timed_make
        cli_train.Trainer = TimedTrainer
        for mode, args in (("host loader", argv("host")),
                           ("--device_cache",
                            argv("device_cache", "--device_cache"))):
            counts, cfgs[mode] = run(mode, args, TRAIN_CLI_EPOCHS,
                                     TRAIN_CLI_EPOCHS)
            total = {k: total.get(k, 0) + n for k, n in counts.items()}
        mode = "--resume --profile_steps 2"
        resume = parse_cli(argv("resume"))
        Path(resume.model_path).mkdir(parents=True, exist_ok=True)
        shutil.copy(Path(cfgs["host loader"][0].model_path)
                    / "last_epoch_model.ckpt",
                    Path(resume.model_path) / "last_epoch_model.ckpt")
        counts, cfgs[mode] = run(
            mode, argv("resume", "--resume", "--profile_steps", "2"),
            TRAIN_CLI_EPOCHS + 1, 1)
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
    finally:
        cli_train.config_from_args = real_cfg
        tr.make_train_step = real_make
        cli_train.Trainer = real_trainer

    # the checkpoints reload; the figures and the trace are there
    model = build_model(cfgs["host loader"][0], device=dev)
    for mode, (cfg, epochs) in cfgs.items():
        trainer = tr.Trainer(cfg, model, dev)
        state = trainer.restore_state(str(Path(cfg.model_path)
                                          / "last_epoch_model.ckpt"))
        if state["epoch"] != epochs:
            raise AssertionError(f"{mode}: last checkpoint at epoch "
                                 f"{state['epoch']}, expected {epochs}")
        best = Path(cfg.model_path) / "best_metric_model.ckpt"
        if best.is_file() or not mode.startswith("--resume"):
            # a resumed run writes one only if it beats (i)'s best
            state = trainer.restore_state(str(best))
            if state["epoch"] != state["best_metric_epoch"]:
                raise AssertionError(f"{mode}: best checkpoint {state}")
        if figs:
            for name in ("check_validation_image_and_label.png",
                         "epoch_average_loss_and_val_mean_dice.png"):
                if not (Path(cfg.figures_path) / name).is_file():
                    raise AssertionError(f"{mode}: no figure {name}")
    log(f"  the checkpoints of the three runs reload into a Trainer; "
        f"figures {'written' if figs else 'off'}")
    del model, trainer, state
    profile = Path(cfgs["--resume --profile_steps 2"][0].results_folder_path
                   ) / "profile"
    if not profile.is_dir() or not any(profile.iterdir()):
        raise AssertionError(f"no trace under {profile}")
    summary = trace_summary(profile)
    if summary is None:
        log(f"profiled step (run iii): the trace holds no device event: "
            f"busy share not measured on {card}")
    else:
        fams = {k: round(v, 3) for k, v in summary["families_ms"].items()}
        log(f"profiled steps (run iii, steps 2-3 of its first epoch, host "
            f"loader, synchronised by the train_loss line): busy share "
            f"{summary['busy_share']!r} ({summary['busy_ms']:.2f} of "
            f"{summary['window_ms']:.2f} ms, {summary['device_events']} "
            f"device events, trace {summary['mib']:.1f} MiB); device ms "
            f"by family {fams} on {card}")
        for fam, name, ms, n in summary["top"]:
            log(f"  trace kernel [{fam}] {ms:.3f} ms in {n} launches: "
                f"{name[:160]}")

    # the device loader: upload, no sync, crops at given draws bit-equal
    # to the host transforms' crops of the same cached volumes
    train_files, _, _ = load_split_csv(split, "T1", str(root))
    train_ds = CacheDataset(train_files, get_transforms(ROI)[0],
                            num_workers=4)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cache = DeviceCachedDataset(train_ds.cache, ROI, device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    mib = nbytes(cache.images, cache.labels) / 2**20
    loader = DeviceLoader(cache, batch_size=1, shuffle=True, seed=SEED)
    torch.cuda.set_sync_debug_mode("error")
    try:
        batches = list(loader)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    shape = (1, ROI[2], ROI[0], ROI[1], 1)
    for img, lbl in batches:
        if (tuple(img.shape) != shape or tuple(lbl.shape) != shape
                or img.dtype != torch.bfloat16 or lbl.dtype != torch.uint8
                or img.device != dev):
            raise AssertionError(f"device loader batch {img.shape} "
                                 f"{img.dtype} {lbl.dtype} {img.device}")
    log(f"  DeviceLoader: one epoch of {len(batches)} batches under "
        f"torch.cuda.set_sync_debug_mode('error'): no sync")
    del batches
    t = time.perf_counter()
    for _ in range(LOADER_EPOCHS):
        for img, lbl in loader:
            pass
    torch.cuda.synchronize()
    loader_ms = (time.perf_counter() - t) * 1e3 / (LOADER_EPOCHS * len(loader))
    flips = set()
    for seed in range(16):
        i = seed % len(cache)
        host = train_ds.get(i, np.random.default_rng(seed))
        # the host's draws (RandFlip, then RandSpatialCrop of the flipped
        # volume), read back from a generator in the same state
        rng = np.random.default_rng(seed)
        flip = bool(rng.random() < 0.5)
        dims = train_ds.cache[i]["image"].shape[1:]
        h0, w0, d0 = (int(rng.integers(0, n - c + 1)) if n > c else 0
                      for n, c in zip(dims, ROI))
        if flip:
            h0 = dims[0] - ROI[0] - h0
        img, lbl = cache.crop([i], [(d0, h0, w0)], [flip])
        ref_img, ref_lbl = tr.to_device_batch(
            {"image": host["image"][None], "label": host["label"][None]},
            dev, torch.bfloat16)
        if not (torch.equal(img, ref_img) and torch.equal(lbl, ref_lbl)):
            raise AssertionError(f"device crop {i} at {(d0, h0, w0)} flip "
                                 f"{flip} differs from the host transform's")
        flips.add(flip)
    if flips != {False, True}:
        raise AssertionError(f"draws took only flips {flips}")
    log("  device crops at 16 given draws (both flips) bit-equal to the "
        "host transforms' crops of the same cached volumes")
    log(f"device cache: upload {upload_s:.3f} s for {len(cache)} volumes, "
        f"{mib:.1f} MiB on the device; DeviceLoader {loader_ms:.3f} ms per "
        f"batch (mean of {LOADER_EPOCHS} epochs) on {card}")
    del cache, loader, img, lbl, ref_img, ref_lbl

    # the host transfer of one 384x384x64 crop: the torch cast, then the
    # transpose (to_device_batch), beside the parent's numpy transpose
    # first, in turns; the same bytes
    batch = next(iter(DataLoader(train_ds, batch_size=1, shuffle=True,
                                 seed=SEED)))

    def numpy_first():
        image = np.ascontiguousarray(np.transpose(batch["image"],
                                                  (0, 4, 2, 3, 1)))
        label = np.ascontiguousarray(np.transpose(batch["label"],
                                                  (0, 4, 2, 3, 1)))
        cast = label.astype(np.uint8)
        if np.array_equal(cast, label):
            label = cast
        return (torch.from_numpy(image).to(torch.bfloat16).to(dev),
                torch.from_numpy(label).to(dev))

    def torch_first():
        return tr.to_device_batch(batch, dev, torch.bfloat16)

    outs = {}
    times = {numpy_first: [], torch_first: []}
    for fn in (numpy_first, torch_first, torch_first, numpy_first):
        outs[fn] = fn()                      # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(TDB_REPS):
            fn()
        torch.cuda.synchronize()
        times[fn].append((time.perf_counter() - t) * 1e3 / TDB_REPS)
    if not all(torch.equal(a, b) for a, b in zip(outs[numpy_first],
                                                  outs[torch_first])):
        raise AssertionError("to_device_batch differs from the numpy order")
    tk, tn = times[torch_first], times[numpy_first]
    log(f"to_device_batch (torch cast, then permute): "
        f"{sum(tk) / len(tk):.1f} ms per {ROI} crop {tk}; the numpy "
        f"transpose first: {sum(tn) / len(tn):.1f} ms {tn}; the same bytes; "
        f"on {card}")
    torch.cuda.synchronize()
    return total


# Phase 16: the rest of the model zoo. Train-route (3,3,3) stride-1 conv
# sites of one train step, pair halves apart: UNet2d5 = the flagship's 25
# less its 11 attention convs; UNet = unit1 of down_0..4, the bottom's two,
# each upres_i unit0 (upres_0 at 2 -> 2 channels, 384x384x64)
ZOO_TRAIN_SITES = {"UNet2d5": 14, "UNet": 12}
# eval launches of one 8-window batch: UNet2d5 runs ru_block at down_2/3/4
# and the bottom and no decoder block (no attention); UNet's bottom is its
# one two-subunit stride-1 unit, and under Routes(dsconv=True) ds_conv
# takes the unit0 of its strided down_2/3/4 (32->48, 48->64, 64->80)
ZOO_EVAL = {
    "UNet2d5": {"ru_block": 4, "ru_unit": 4, "l2_block": 0, "att_map": 0,
                "conv333_gated": 0, "attgate": 0, "conv333": 0,
                "blend_scatter": 1, "conv333_dw": 0, **NO_KD1},
    "UNet": {"ru_block": 1, "ru_unit": 1, "l2_block": 0, "att_map": 0,
             "conv333_gated": 0, "attgate": 0, "conv333": 0,
             "blend_scatter": 1, "conv333_dw": 0, **NO_KD1},
}


def step_grads(model, cfg, image, label, use_kernels: bool):
    """(loss, {name: gradient}, generator state after) of one train forward
    and backward from the model's current weights, dropout seeded by
    cfg.seed."""
    import torch

    from vs_seg_tpu_torch.losses.dice import dice_spvpa_loss

    model.zero_grad(set_to_none=True)
    gen = torch.Generator(image.device).manual_seed(cfg.seed)
    out = model(image, use_kernels=use_kernels, train=True, generator=gen)
    logits, atts = out if isinstance(out, tuple) else (out, ())
    loss = dice_spvpa_loss(logits, atts, label.float(),
                           supervised_attention=cfg.attention,
                           hardness_weighting=cfg.hardness)
    loss.backward()
    grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, gen.get_state()


def grad_errors(model, got, ref, slopes: bool = False):
    """Each gradient's max|got - ref| over its own largest |ref| (over the
    model's largest for the conv biases in front of a train-mode
    BatchNorm, whose gradient is rounding noise, and with `slopes` for the
    PReLU slopes, one sum over a whole activation that cancels far below
    its terms, as phase 18 holds them)."""
    from vs_seg_tpu_torch.nn.blocks import Convolution
    noise = {f"{n}.conv.bias" for n, m in model.named_modules()
             if isinstance(m, Convolution) and m.norm is not None}
    if slopes:
        noise |= {f"{n}.act.alpha" for n, m in model.named_modules()
                  if isinstance(m, Convolution) and m.act_name == "prelu"}
    gmax = max(float(g.abs().max()) for g in ref.values())
    out = {}
    for n, r in ref.items():
        scale = gmax if n in noise else float(r.abs().max())
        out[n] = float((got[n] - r).abs().max()) / max(scale, 1e-30)
    return out


def time_steps(model, cfg, image, label, turns, card: str, tag: str):
    """ms/step and peak device memory of make_train_step from the model's
    current weights, STEP_REPS steps after a warm-up step per turn; `turns`
    is a list of (name, use_kernels, setup) run in order, setup() called
    before each turn. Returns {name: (mean ms/step, [ms], peak GiB)}."""
    import torch

    from vs_seg_tpu_torch.train import trainer as tr

    init = {k: v.clone() for k, v in model.state_dict().items()}
    res = {}
    for name, use_kernels, setup in turns:
        setup()
        model.load_state_dict(init)
        opt = tr.make_optimizer(model.parameters(), cfg.initial_learning_rate,
                                cfg.weight_decay)
        step = tr.make_train_step(model, opt,
                                  supervised_attention=cfg.attention,
                                  hardness=cfg.hardness,
                                  use_kernels=use_kernels)
        gen = torch.Generator(image.device).manual_seed(cfg.seed)
        step(image, label, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(STEP_REPS):
            loss = step(image, label, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / STEP_REPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not torch.isfinite(loss):
            raise AssertionError(f"{tag} {name}: non-finite train loss")
        prev = res.get(name, (0.0, [], 0.0))
        res[name] = (0.0, prev[1] + [ms], max(prev[2], peak))
    model.load_state_dict(init)
    for name, (_, ts, peak) in list(res.items()):
        res[name] = (sum(ts) / len(ts), ts, peak)
        log(f"  {tag} train step, {name}: {res[name][0]:.1f} ms/step {ts}, "
            f"peak device memory {peak:.2f} GiB on {card}")
    return res


def float32_step(cfg, state, image, label, dev):
    """(loss, {name: gradient}) of one plain-path train step of cfg's model
    in float32 from `state`, dropout seeded by cfg.seed (the masks do not
    depend on the dtype)."""
    import dataclasses

    import torch

    from vs_seg_tpu_torch.models import build_model

    model = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                        device=dev)
    model.load_state_dict(state)
    loss, grads, _ = step_grads(model, cfg, image.float(), label, False)
    del model
    torch.cuda.empty_cache()
    return loss, grads


def first_step_check(name, model, cfg, state, image, label, dev, k, p):
    """Phase 6 and 16 (c): the kernel path's first train step from `state`,
    k = (loss, {name: gradient}) of step_grads, against the plain path's p
    and the same step in float32 (float32_step). The two bf16 paths round
    the train-mode BatchNorm -> dropout -> PReLU at other points, so
    neither is the reference. The kernel path's loss passes within LOSS_TOL
    of the float32 loss or no further from it than twice the plain path's,
    its gradients where grads_vs_float32 finds them no further from
    float32 than the plain path's. Tensor by tensor the two bf16 paths
    cannot be held to each other: a gradient that is one sum over a whole
    activation (a slope, a BatchNorm scale or bias) cancels far below its
    terms, and either path lands far from float32 by chance (a UNet slope
    of 7.6e-7 in float32 read 8.0e-7 on the plain path and 3.5e-6 on the
    kernel path, the flagship's slopes up to 6x off on the plain path;
    H100)."""
    (k_loss, k_grads), (p_loss, p_grads) = k, p
    f_loss, f_grads = float32_step(cfg, state, image, label, dev)
    k_off, p_off = abs(k_loss - f_loss), abs(p_loss - f_loss)
    log(f"  {name} first-step loss: kernel path {k_loss!r}, plain path "
        f"{p_loss!r}, plain float32 {f_loss!r}: relative to float32 "
        f"{k_off / abs(f_loss)!r} and {p_off / abs(f_loss)!r} (tol "
        f"{LOSS_TOL!r}, or twice the plain path's)")
    if k_off > max(LOSS_TOL * abs(f_loss), 2 * p_off):
        raise AssertionError(f"{name}: first-step loss {k_loss} further "
                             f"than {LOSS_TOL} and than twice the plain "
                             f"path's {p_loss} from float32 {f_loss}")
    grads_vs_float32(name, model, k_grads, p_grads, f_grads,
                     ("kernel path", "plain path"))


def grads_vs_float32(name, model, got, ref, f32, labels):
    """Raise unless the gradients `got` are no further from the same step's
    float32 gradients `f32` than `ref` are, over the model: one error a
    tensor (grad_errors, the PReLU slopes against the model's largest
    gradient), their median and 90th percentile within GRAD_RATIO of ref's
    and their furthest within GRAD_FAR of ref's furthest. `labels` names
    got and ref in the log."""
    import statistics

    e_got = grad_errors(model, got, f32, slopes=True)
    e_ref = grad_errors(model, ref, f32, slopes=True)
    apart = grad_errors(model, got, ref, slopes=True)

    def marks(e):
        deciles = statistics.quantiles(e.values(), n=10)
        return {"median": deciles[4], "90th percentile": deciles[8],
                "furthest": max(e.values())}

    mg, mr = marks(e_got), marks(e_ref)
    log(f"  {name}: gradients against float32 over {len(e_got)} tensors, "
        f"{labels[0]} / {labels[1]}: "
        + ", ".join(f"{m} {mg[m]!r} / {mr[m]!r}" for m in mg)
        + f" (tol {GRAD_RATIO!r} x, the furthest {GRAD_FAR!r} x); furthest "
        f"{labels[0]} tensors "
        f"{sorted(e_got.items(), key=lambda kv: -kv[1])[:3]}; furthest "
        f"apart: {sorted(apart.items(), key=lambda kv: -kv[1])[:3]}")
    for m in mg:
        if mg[m] > (GRAD_FAR if m == "furthest" else GRAD_RATIO) * mr[m]:
            raise AssertionError(f"{name}: the {labels[0]}'s gradients are "
                                 f"further from float32 than the "
                                 f"{labels[1]}'s: {m} {mg[m]} vs {mr[m]}")


def train_site_times(model, image, card: str, name: str):
    """Per (3,3,3) train site of `model` (taken by a hook on Conv333Train's
    wgrad during one kernel-path forward and backward of `image`): the
    kernel's wgrad (conv333_dw) and dgrad (conv333) ms beside cuDNN's
    (torch.nn.grad.conv3d_weight / conv3d_input) on seeded bf16 inputs of
    the site's shapes, CUDA events; then their sums."""
    import torch

    from vs_seg_tpu_torch.ops import conv333, conv333_dw, train_conv

    sites = []
    inner = train_conv.conv333_dw

    def hook(x, dy):
        sites.append((tuple(int(v) for v in x.shape[:4]), int(x.shape[-1]),
                      int(dy.shape[-1])))
        return inner(x, dy)

    train_conv.conv333_dw = hook
    try:
        gen = torch.Generator(image.device).manual_seed(SEED)
        out = model(image, use_kernels=True, train=True, generator=gen)
        logits = out[0] if isinstance(out, tuple) else out
        logits.float().sum().backward()
    finally:
        train_conv.conv333_dw = inner
    model.zero_grad(set_to_none=True)
    del out, logits
    gen = torch.Generator(image.device).manual_seed(SEED + 3)
    sums = [0.0] * 4
    for shape, cin, cout in sites:
        x = torch.randn((*shape, cin), generator=gen, device=image.device,
                        dtype=torch.bfloat16)
        dy = torch.randn((*shape, cout), generator=gen, device=image.device,
                         dtype=torch.bfloat16)
        w = torch.randn((3, 3, 3, cin, cout), generator=gen,
                        device=image.device) * 0.05
        w_t = torch.flip(w, (0, 1, 2)).permute(0, 1, 2, 4, 3)
        wl = w.to(torch.bfloat16).permute(4, 3, 2, 0, 1)
        xn, dyn = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        ms = [cuda_ms(lambda: conv333_dw.conv333_dw(x, dy)),
              cuda_ms(lambda: torch.nn.grad.conv3d_weight(
                  xn, tuple(wl.shape), dyn, padding=1)),
              cuda_ms(lambda: conv333.conv333(dy, w_t)),
              cuda_ms(lambda: torch.nn.grad.conv3d_input(
                  tuple(xn.shape), wl, dyn, padding=1))]
        sums = [a + b for a, b in zip(sums, ms)]
        log(f"  {name} train site {shape}x{cin}->{cout}: conv333_dw "
            f"{ms[0]!r} ms, cuDNN wgrad {ms[1]!r}; conv333 dgrad {ms[2]!r} "
            f"ms, cuDNN dgrad {ms[3]!r} on {card}")
        del x, dy, w, w_t, wl, xn, dyn
    log(f"  {name}, {len(sites)} train sites summed: conv333_dw {sums[0]!r} "
        f"ms, cuDNN wgrad {sums[1]!r}; conv333 dgrad {sums[2]!r} ms, cuDNN "
        f"dgrad {sums[3]!r} on {card}")


def zoo_train(dev, card: str, name: str):
    """Phase 16 (c): one full-width train step of `name` (batch 1,
    384x384x64, bf16) through the kernels and plain, held to each other
    and to float32 by first_step_check; the conv333 (dgrad), conv333_dw
    and bn_dropout_prelu launches of the counted kernel step; ms/step and
    peak memory of each path. Returns the counts."""
    import numpy as np
    import torch

    from vs_seg_tpu_torch.core.config import Config
    from vs_seg_tpu_torch.models import build_model
    from vs_seg_tpu_torch.train import trainer as tr

    cfg = Config(model=name, seed=SEED)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    image, label = tr.to_device_batch(
        train_crop(cfg, np.random.default_rng(SEED + 1)), dev,
        tr.DTYPES[cfg.compute_dtype])
    step_grads(model, cfg, image, label, True)        # warm-up
    model.load_state_dict(init)
    torch.cuda.synchronize()
    reset_counts()
    k_loss, k_grads, _ = step_grads(model, cfg, image, label, True)
    torch.cuda.synchronize()
    counts = read_counts()
    model.load_state_dict(init)
    p_loss, p_grads, _ = step_grads(model, cfg, image, label, False)
    model.load_state_dict(init)
    sites = ZOO_TRAIN_SITES[name]
    check_counts(counts, {"conv333_dw": sites, "conv333": sites,
                          "conv333_gated": 0, "att_map": 0, "attgate": 0,
                          "ru_block": 0, "ru_unit": 0, "l2_block": 0,
                          "blend_scatter": 0, **NO_KD1,
                          **bn_launches(1, bn_sites(model))},
                 f"{name} train step")
    first_step_check(name, model, cfg, init, image, label, dev,
                     (k_loss, k_grads), (p_loss, p_grads))
    del k_grads, p_grads
    none = lambda: None  # noqa: E731
    time_steps(model, cfg, image, label,
               [("plain", False, none), ("kernel", True, none),
                ("kernel", True, none), ("plain", False, none)], card, name)
    train_site_times(model, image, card, name)
    return counts


def remat_run(dev, card: str):
    """Phase 16 (d): phase 6's flagship train step with and without
    --remat, kernel path: the loss bit-equal and the generator's state
    after the step equal, the largest gradient difference reported; ms/step
    and peak memory both ways, in turns. Returns the counts of the counted
    remat step."""
    import numpy as np
    import torch

    from vs_seg_tpu_torch.core.config import Config
    from vs_seg_tpu_torch.models import build_model
    from vs_seg_tpu_torch.train import trainer as tr

    from vs_seg_tpu_torch.models.unet2d5_spvpa import REMAT_LEVELS
    from vs_seg_tpu_torch.ops.bnorm_train import (FORWARD_LAUNCHES,
                                                  LAUNCHES_PER_SITE)

    cfg = Config(seed=SEED)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    image, label = tr.to_device_batch(
        train_crop(cfg, np.random.default_rng(SEED + 1)), dev,
        tr.DTYPES[cfg.compute_dtype])
    runs = {}
    counts = None
    for remat in (False, True):
        model.remat = remat
        model.load_state_dict(init)
        if remat:
            reset_counts()
        runs[remat] = step_grads(model, cfg, image, label, True)
        if remat:
            torch.cuda.synchronize()
            counts = read_counts()
    model.remat = False
    model.load_state_dict(init)
    (l0, g0, r0), (l1, g1, r1) = runs[False], runs[True]
    diff = max(float((g1[n] - g0[n]).abs().max()) for n in g0)
    errs = grad_errors(model, g1, g0)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    log(f"  flagship --remat: loss {l1!r} (without {l0!r}); largest gradient "
        f"difference {diff!r}, worst relative {worst}")
    if l0 != l1:
        raise AssertionError(f"--remat changed the loss: {l1} vs {l0}")
    if not torch.equal(r0, r1):
        raise AssertionError("--remat left the dropout generator in another "
                             "state")
    bad = {n: e for n, e in errs.items() if e > GRAD_TOL}
    if bad:
        raise AssertionError(f"--remat gradients outside {GRAD_TOL}: {bad}")
    # the recompute runs the level-0/1 blocks' train convs again: none are
    # (3,3,3), so the train kernels' launches are the step's; each of
    # their bnorm_train sites runs its forward passes again
    recomputed = sum(bn_sites(getattr(model, f"{k}_{i}"))
                     for k in ("down", "downsample", "upsample", "up")
                     for i in range(REMAT_LEVELS))
    check_counts(counts, {"conv333_dw": TRAIN_SITES, "conv333": TRAIN_SITES,
                          "blend_scatter": 0, **NO_KD1,
                          "bn_dropout_prelu": LAUNCHES_PER_SITE * BN_SITES
                          + FORWARD_LAUNCHES * recomputed},
                 "remat train step")
    del g0, g1

    def setter(on):
        return lambda: setattr(model, "remat", on)

    res = time_steps(model, cfg, image, label,
                     [("without --remat", True, setter(False)),
                      ("with --remat", True, setter(True)),
                      ("with --remat", True, setter(True)),
                      ("without --remat", True, setter(False))],
                     card, "flagship")
    model.remat = False
    return counts, res


def blend_options(dev, card: str):
    """Phase 16 (e): blend_scatter with the constant importance map and
    with the sigma_scale 0.25 Gaussian against its twin over the flagship
    volume's 8 windows, bit for bit."""
    import numpy as np
    import torch

    from vs_seg_tpu_torch.infer.sliding_window import (
        _importance_map_device, dense_patch_starts)
    from vs_seg_tpu_torch.ops import blend

    roi = (ROI[2], ROI[0], ROI[1])
    vol = (VOLUME[2], VOLUME[0], VOLUME[1])
    starts = dense_patch_starts(vol, roi, 0.25)
    mask = np.ones(len(starts), np.float32)
    g = torch.Generator().manual_seed(SEED)
    preds = torch.randn((len(starts), *roi, 2), generator=g).to(
        dev, torch.bfloat16)
    for mode, sigma in (("constant", 0.125), ("gaussian", 0.25)):
        imp = _importance_map_device(roi, mode, sigma, dev)
        accs = {}
        for fn in (blend.blend_scatter, blend.blend_scatter_plain):
            out = torch.zeros((*vol, 2), dtype=torch.float32, device=dev)
            w = torch.zeros((*vol, 1), dtype=torch.float32, device=dev)
            accs[fn] = fn(out, w, preds, starts, mask, imp)
        (ko, kw), (po, pw) = accs.values()
        tag = f"blend_scatter, {mode} map (sigma_scale {sigma})"
        compare(tag + " out", ko, po, BLEND_TOL)
        compare(tag + " w", kw, pw, BLEND_TOL)
        ms = cuda_ms(lambda: blend.blend_scatter(
            torch.zeros_like(ko), torch.zeros_like(kw), preds, starts, mask,
            imp))
        log(f"  {tag}: bit-equal to its twin; {ms!r} ms a call (events, "
            f"accumulators zeroed in the call) on {card}")


def zoo_run(dev, card: str):
    """Phase 16: UNet2d5 and UNet on the phase-3 volume (default routes,
    and UNet under dsconv too), one full-width train step of each, the
    flagship's train step with and without --remat, and the blend's
    constant map and sigma_scale. Returns (the summed launch counts of
    the counted runs, {tag: (kernel, plain) ms/volume})."""
    import numpy as np
    import torch

    from vs_seg_tpu_torch.core.config import Config, Routes
    from vs_seg_tpu_torch.infer.sliding_window import stage_volume
    from vs_seg_tpu_torch.models import build_model

    volume = np.random.default_rng(SEED).normal(size=(*VOLUME, 1)).astype(
        np.float32)
    staged = stage_volume(volume, ROI, device=dev, overlap=0.25,
                          sw_batch_size=SW_BATCH, quantize=True)
    total, vol_ms = [], {}
    for name, routes in (("UNet2d5", [Routes()]),
                         ("UNet", [Routes(), Routes(dsconv=True)])):
        gen = torch.Generator().manual_seed(SEED)
        model = build_model(Config(model=name), device=dev, generator=gen)
        randomise_bn(model, gen)
        for r in routes:
            expect = dict(ZOO_EVAL[name], ds_conv=3 if r.dsconv else 0)
            tag = f"{name} ({'dsconv' if r.dsconv else 'default routes'})"
            counts, _, vol_ms[tag] = volume_paths(model, staged, r, expect,
                                                  card, tag)
            total.append(counts)
        del model
        torch.cuda.empty_cache()
    del staged
    for name in ("UNet2d5", "UNet"):
        total.append(zoo_train(dev, card, name))
        torch.cuda.empty_cache()
    counts, _ = remat_run(dev, card)
    total.append(counts)
    torch.cuda.empty_cache()
    blend_options(dev, card)
    return {k: sum(c[k] for c in total) for k in total[0]}, vol_ms


def shard_expect(forwards: int, blends: int, **extra) -> dict:
    """Launch counts of `forwards` default-route forwards and `blends`
    blend launches."""
    return {**{k: n * forwards for k, n in {**EVAL_RU, **EVAL_L2}.items()},
            "conv333": EVAL_CONV333 * forwards, "blend_scatter": blends,
            "conv333_dw": 0, **NO_KD1, **extra}


def multi_shard_run(dev, card: str, model, default_logits, cli_root: Path):
    """Phase 17: window-sharded and H-sharded inference on meshes that
    repeat `dev`, and the CLI's two flags on the one-device mesh. Returns
    the summed launch counts of the counted runs."""
    import shutil

    import numpy as np
    import torch

    from vs_seg_tpu_torch.cli import inference
    from vs_seg_tpu_torch.data import nifti
    from vs_seg_tpu_torch.infer.engine import make_predictor
    from vs_seg_tpu_torch.infer.sharded import \
        sliding_window_inference_sharded
    from vs_seg_tpu_torch.infer.sliding_window import (
        sliding_window_inference, stage_volume)
    from vs_seg_tpu_torch.infer.spatial import (make_spatial_predictor,
                                                pick_gather_level)
    from vs_seg_tpu_torch.models import UNet2d5_spvPA
    from vs_seg_tpu_torch.ops import halo, l2block, rublock
    from vs_seg_tpu_torch.parallel import collectives
    from vs_seg_tpu_torch.parallel.mesh import make_mesh

    volume = np.random.default_rng(SEED).normal(size=(*VOLUME, 1)).astype(
        np.float32)
    staged = stage_volume(volume, ROI, device=dev, overlap=0.25,
                          sw_batch_size=SW_BATCH, quantize=True)
    n_win = int(staged.mask.sum())
    default_logits = default_logits.to(dev)
    total = []

    def band(tag, got):
        if tuple(got.shape) != (*VOLUME, 2) or not torch.isfinite(got).all():
            raise AssertionError(f"{tag}: logits {tuple(got.shape)}, or not "
                                 "finite")
        compare(f"{tag} vs phase 3's default logits", got, default_logits,
                LOGIT_TOL)
        agree = float((got.argmax(-1) == default_logits.argmax(-1)).float()
                      .mean())
        log(f"  {tag}: argmax agreement with phase 3 {agree!r} (min "
            f"{ARGMAX_MIN})")
        if agree < ARGMAX_MIN:
            raise AssertionError(f"{tag}: argmax agreement {agree}")

    def timed(run, tag, expect):
        """Warm-up, then two timed runs, the first counted; (logits, ms
        list, collectives' host seconds of the timed runs)."""
        run()
        times = []
        collectives.reset_stats()
        for i in range(2):
            if i == 0:
                reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                counts = read_counts()
                check_counts(counts, expect, tag)
                total.append(counts)
        stats = dict(collectives.STATS)
        log(f"{tag}: {sum(times) / 2:.1f} ms/volume {times}; collectives "
            f"over the 2 timed runs, host s summed over the shards: "
            f"barrier waits {stats['barrier_s']!r}, reduce "
            f"{stats['reduce_s']!r} ({stats['reduce']} calls), all_gather "
            f"{stats['all_gather_s']!r} ({stats['all_gather']}), halo "
            f"exchanges {stats['exchange_s']!r} ({stats['exchange']}); "
            f"N shards share one card: the shard machinery's cost, not a "
            f"multi-GPU speed-up; on {card}")
        return out, times, stats

    # (a) window-sharded, the per-shard batch as run_inference sizes it
    pred = make_predictor(model, torch.bfloat16)
    for n in SHARDS:
        mesh = make_mesh([dev] * n)
        per = max(1, min(SW_BATCH, -(-n_win // n)))
        out, _, _ = timed(
            lambda: sliding_window_inference_sharded(
                staged, ROI, pred, mesh, sw_batch_size=per),
            f"sharded inference, {n} shard(s) of {per} window(s)",
            shard_expect(n * -(-n_win // (n * per)), n))
        band(f"sharded, {n} shard(s)", out)
        if n > 1:
            # the same forwards at the shards' batch on one device: what
            # is left is the blend's order (the batch's numerics are out)
            same = sliding_window_inference(staged, ROI, pred,
                                            sw_batch_size=per)
            err = float((out - same).abs().max() / same.abs().max())
            log(f"  sharded, {n} shards vs the single-device path at "
                f"sw_batch {per}: max|d| / max|ref| {err!r}")
            del same
        del out
    f32 = UNet2d5_spvPA(dtype=torch.float32, device=dev)
    f32.load_state_dict(model.state_dict())
    plain = make_predictor(f32, torch.float32, use_kernels=False)
    with torch.no_grad():
        ref = sliding_window_inference(staged, ROI, plain,
                                       sw_batch_size=SW_BATCH,
                                       use_kernels=False)
        for n in SHARDS[1:]:
            got = sliding_window_inference_sharded(
                staged, ROI, plain, make_mesh([dev] * n),
                sw_batch_size=SW_BATCH // n, use_kernels=False)
            compare(f"sharded, {n} shards, plain float32 path vs the "
                    f"single-device plain float32 path", got, ref,
                    SHARD_F32_TOL)
            del got
    del f32, plain, ref
    torch.cuda.empty_cache()

    # (b) H-sharded, 8 windows at sw_batch 1
    staged1 = stage_volume(volume, ROI, device=dev, overlap=0.25,
                           sw_batch_size=1, quantize=True)
    caught = {}
    real = {"ru_block": rublock.ru_block, "l2_block": l2block.l2_block}

    def catch(name, cout_at):
        def fn(*a, **kw):
            c = int(kw["w0"].shape[-1])
            if (c == cout_at and name not in caught
                    and collectives.in_spmd()
                    and collectives.axis_index() == 1):
                caught[name] = (a, kw)
            return real[name](*a, **kw)
        # the wrapper stands in for the counted function in the module
        # (ru_block and l2_block count themselves by their module name),
        # so it carries the counter that _counters reads meanwhile
        fn.launches = 0
        return fn

    def profiled(run, tag):
        """One volume of run() under torch.profiler (after timed()'s
        warm-up): wall ms, the device kernels' summed ms (an upper bound
        of the card's busy share) and the heaviest kernels."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
        log(f"  {tag}, one volume under torch.profiler: {wall!r} ms wall, "
            f"{dev_ms!r} ms summed device time (busy share <= "
            f"{dev_ms / wall:.3f}) on {card}")
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:4]:
            log(f"    {e.self_device_time_total / 1e3:9.2f} ms "
                f"{e.count:6d}x {e.key[:90]}")

    # the single-device path at the same batch of 1, beside the shards
    def single1():
        return sliding_window_inference(staged1, ROI, pred, sw_batch_size=1)
    timed(single1, "single-device inference at sw_batch 1",
          shard_expect(n_win, n_win))
    profiled(single1, "single-device inference at sw_batch 1")
    for n in SHARDS:
        mesh = make_mesh([dev] * n)
        gather = pick_gather_level(model, ROI[0], n)
        spred = make_spatial_predictor(model, mesh, torch.bfloat16)
        before = dict(halo.BLOCK_CALLS)
        if n == 4:       # catch an extended block of shard 1 at down_2/up_2
            rublock.ru_block = catch("ru_block", 48)
            l2block.l2_block = catch("l2_block", 48)
        try:
            out, _, _ = timed(
                lambda: sliding_window_inference(staged1, ROI, spred,
                                                 sw_batch_size=1),
                f"spatial inference, {n} shard(s), gather level {gather}",
                shard_expect(n * n_win, n_win))
        finally:
            rublock.ru_block, l2block.l2_block = real["ru_block"], \
                real["l2_block"]
        ext = {k: halo.BLOCK_CALLS[k] - before[k] for k in before}
        log(f"  fused blocks on halo-extended blocks over the warm-up and "
            f"2 timed runs: {ext}")
        profiled(lambda: sliding_window_inference(staged1, ROI, spred,
                                                  sw_batch_size=1),
                 f"spatial inference, {n} shard(s)")
        if n > 1:
            band(f"spatial, {n} shards", out)
            # down_2/3/4 and up_2/3/4 sharded; the bottom whole
            want = 3 * 3 * n * n_win
            if ext != {"ru_block": want, "l2_block": want}:
                raise AssertionError(f"spatial, {n} shards: {ext} fused "
                                     f"blocks on extended blocks, expected "
                                     f"{want} each")
        del out
    with torch.inference_mode():
        for name, plain_fn, tag in (
                ("ru_block", rublock.ru_block_plain, "down_2"),
                ("l2_block", l2block.l2_block_plain, "up_2")):
            if name not in caught:
                raise AssertionError(f"no extended {name} block was caught")
            a, kw = caught[name]
            got, ref = real[name](*a, **kw), plain_fn(*a, **kw)
            if name == "l2_block":
                got, ref = got[0], ref[0]
            compare(f"{name} {tag} on shard 1's extended block "
                    f"{tuple(a[0].shape)} vs its plain twin", got, ref,
                    KERNEL_TOL)
    del caught

    # (d) device time of the collectives' own work, one card: the reduce of
    # the accumulator pair and the all_gather at the gather level, the
    # shards' copies and adds replayed in one thread
    out_acc = torch.rand((*staged.vol_dev.shape[:3], 2), device=dev)
    w_acc = torch.rand((*staged.vol_dev.shape[:3], 1), device=dev)
    for n in SHARDS[1:]:
        def reduce_work():
            for t in (out_acc, w_acc):
                acc = t.clone()
                for _ in range(n - 1):
                    acc.add_(t)
        blk = torch.rand((1, ROI[2] >> 3, (ROI[0] >> 5) // n, ROI[1] >> 5,
                          80), device=dev).to(torch.bfloat16)

        def gather_work():
            for _ in range(n):
                torch.cat([blk] * n, dim=2)
        log(f"  {n} shards: reduce of the accumulators "
            f"{cuda_ms(reduce_work)!r}"
            f" ms, all_gather before the bottom {cuda_ms(gather_work)!r} ms"
            f" (device, CUDA events, all shards' copies and adds) on {card}")
    del out_acc, w_acc, staged, staged1

    # (c) the CLI's flags on the one-device mesh, each against phase 10's
    # flagless run of the same CLI, weights, cases and routes
    mesh = make_mesh(device=dev)
    log(f"  make_mesh() on this machine: {mesh}")
    split = str(cli_root / "split_synthetic.csv")
    results = cli_root / "results"
    ckpt = results / "kernels" / "model" / "best_metric_model.ckpt"

    def labelmaps(name):
        out_dir = results / name / "inferred_segmentations_nifti"
        return {p.relative_to(out_dir): nifti.load(str(p)).data
                for p in sorted(out_dir.rglob("*.nii.gz"))}

    flagless = labelmaps("kernels")
    for flag in ("--sharded_inference", "--spatial_inference"):
        name = "p17" + flag.replace("-", "_")
        (results / name / "model").mkdir(parents=True, exist_ok=True)
        shutil.copy(ckpt, results / name / "model" / ckpt.name)
        argv = ["--data_root", str(cli_root), "--split", split,
                "--results_folder_name", name, "--device", str(dev),
                "--routes", "dsconv", "--sw_batch_size", str(SW_BATCH), flag]
        reset_counts()
        t = time.perf_counter()
        dice, secs = inference.main(argv, make_figures=False)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(counts, shard_expect(CLI_CASES, CLI_CASES,
                                          ds_conv=3 * CLI_CASES),
                     f"CLI {flag}")
        total.append(counts)
        got = labelmaps(name)
        if len(flagless) != CLI_CASES or got.keys() != flagless.keys() or \
                not all(np.array_equal(got[k], v)
                        for k, v in flagless.items()):
            raise AssertionError(f"CLI {flag}: labelmaps differ from the "
                                 "flagless run's (phase 10)")
        log(f"  CLI {flag} (--routes dsconv): labelmaps of its "
            f"{CLI_CASES} cases equal to phase 10's flagless run; Dice "
            f"{dice.tolist()}, compute s/volume {secs!r}, "
            f"{time.perf_counter() - t:.1f} s wall on {card}")
    return {k: sum(c[k] for c in total) for k in total[0]}


DP_RANKS = 2             # phase 18's ranks, all on cuda:0 over gloo
DP_BATCH = 2             # phase 18's global batch
DP_STEPS = 3             # phase 18 (c): timed steps per rank and count
DP_LOSS_TOL = 1e-3       # first-step loss, ranks vs one process, relative
DP_TIMEOUT_S = 600.0     # a launch of the ranks, and a torchrun run
DP_CLI_CASES = 2         # phase 15's training cases the torchrun runs take


def dp_config():
    """Phase 18's configuration: the flagship at full width (384x384x64
    crops, bf16), dropout 0 so the ranks and one process draw no masks,
    global batch DP_BATCH."""
    from vs_seg_tpu_torch.core.config import Config
    return Config(seed=SEED, dropout=0.0, train_batch_size=DP_BATCH)


def dp_batch(cfg, dev):
    """Phase 18's seeded batch of DP_BATCH crops on `dev`."""
    import numpy as np

    from vs_seg_tpu_torch.train import trainer as tr
    return tr.to_device_batch(train_crop(cfg, np.random.default_rng(SEED + 2)),
                              dev, tr.DTYPES[cfg.compute_dtype])


def dp_rank():
    """Phase 18 (a) and (c), one rank of DP_RANKS pinned to cuda:0 (gloo):
    the flagship's first data-parallel step on its row of the batch, with
    the launch counters reset just before and read just after, the bytes
    BatchNorm all-reduces in it, then DP_STEPS timed steps. Runs in a
    process of its own (distributed.launch); returns CPU tensors."""
    import torch
    import torch.distributed as dist

    from vs_seg_tpu_torch.models import build_model
    from vs_seg_tpu_torch.ops import _build
    from vs_seg_tpu_torch.parallel import distributed
    from vs_seg_tpu_torch.train import trainer as tr

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = distributed.initialize("cuda:0", timeout_s=DP_TIMEOUT_S)
    for name in ("conv333", "conv333_dw", "attgate", "bnorm_train"):
        _build.load(name)
    dev = ranks.device
    cfg = dp_config()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    image, label = dp_batch(cfg, dev)
    rows, replicated = ranks.rows(len(image))
    image, label = image[rows].contiguous(), label[rows].contiguous()
    trainer = tr.Trainer(cfg, model, dev, ranks=ranks)
    state = trainer.init_state()
    step = trainer.make_step(state)
    gen = distributed.rank_generator(dev, SEED, 0, ranks.rank)
    bn_bytes = [0]
    real_all_reduce = dist.all_reduce

    def counting(t, *args, **kwargs):
        bn_bytes[0] += t.numel() * t.element_size()
        return real_all_reduce(t, *args, **kwargs)

    dist.barrier()
    torch.cuda.synchronize()
    reset_counts()
    dist.all_reduce = counting      # DDP's reduction is not a Python call
    try:
        loss = step(image, label, gen, replicated)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = real_all_reduce
    counts = read_counts()
    out = {"rank": ranks.rank, "backend": ranks.backend, "rows": len(image),
           "replicated": replicated, "counts": counts,
           "local_loss": float(loss),
           "loss": float(distributed.mean_over_ranks(loss)),
           "grads": {n: p.grad.float().cpu()
                     for n, p in model.named_parameters()},
           "state": {k: v.cpu() for k, v in model.state_dict().items()},
           "bn_bytes": bn_bytes[0],
           "grad_bytes": sum(p.numel() * p.element_size()
                             for p in model.parameters())}
    dist.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(DP_STEPS):
        loss = step(image, label, gen, replicated)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t) * 1e3 / DP_STEPS
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["finite"] = bool(torch.isfinite(loss))
    return out


DP_CLI_ENTRY = """import dataclasses
import sys

sys.path.insert(0, {repo!r})
from vs_seg_tpu_torch.cli import train as cli

epochs = int(sys.argv[1])
real = cli.config_from_args
cli.config_from_args = lambda a: dataclasses.replace(
    real(a), num_epochs=epochs, val_interval=1)
cli.main(sys.argv[2:])
"""


def dp_cli_run(card: str):
    """Phase 18 (b): the training CLI under torchrun on the first
    DP_CLI_CASES training cases of phase 15 and its validation case (each
    rank caches every case of its run, so fewer cases shorten each run):
    2 ranks pinned to cuda:0 (gloo), that run resumed, then 1 rank on
    `--device cuda` (NCCL). The reference CLI has no epochs flag, so
    torchrun starts a two-line entry that wraps cli.train's
    config_from_args (num_epochs, val_interval 1) and calls its main."""
    import importlib.util

    import numpy as np
    import torch

    root = REPO / "build" / "chip_smoke_train_cli"
    work = REPO / "build" / "chip_smoke_dp"
    work.mkdir(parents=True, exist_ok=True)
    rows = (root / "split_synthetic.csv").read_text().splitlines()
    train = [r for r in rows if r.endswith(",training")][:DP_CLI_CASES]
    split = work / "split_dp.csv"
    split.write_text("\n".join(
        train + [r for r in rows if r.endswith(",validation")]) + "\n")
    entry = work / "cli_entry.py"
    entry.write_text(DP_CLI_ENTRY.format(repo=str(REPO)))
    figs = importlib.util.find_spec("matplotlib") is not None

    def run(nproc, device, name, epochs, *extra):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), str(entry), str(epochs),
               "--data_root", str(root), "--split", str(split),
               "--results_folder_name", name, "--device", device,
               "--train_batch_size", str(DP_BATCH), "--seed", str(SEED),
               *extra]
        t = time.perf_counter()
        # a session of its own, so that a timeout ends torchrun's ranks too
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=work,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=DP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
        wall = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(
                f"torchrun --nproc_per_node {nproc} cli.train --device "
                f"{device} {' '.join(extra)}: exit {proc.returncode} after "
                f"{wall:.1f} s\n{out[-3000:]}\n{err[-6000:]}")
        folder = root / "results" / name
        text = (folder / "logs" / "training_log.txt").read_text()
        losses = [float(v) for v in
                  re.findall(r"average loss: (\S+)", text)]
        ckpt = torch.load(folder / "model" / "last_epoch_model.ckpt",
                          map_location="cpu", weights_only=True)
        log(f"  torchrun --nproc_per_node {nproc} -m vs_seg_tpu_torch.cli."
            f"train --device {device} {' '.join(extra)} (to epoch {epochs}, "
            f"{DP_CLI_CASES // DP_BATCH} step(s) an epoch, batch "
            f"{DP_BATCH}): exit 0 in {wall:.1f} s; log epoch losses "
            f"{losses}; last checkpoint at epoch {ckpt['epoch']} on {card}")
        if (len(losses) != 1 or not np.isfinite(losses).all()
                or ckpt["epoch"] != epochs):
            raise AssertionError(f"{name}: epoch losses {losses}, last "
                                 f"checkpoint at epoch {ckpt['epoch']}")
        return folder, text

    backend = "data parallel: {} ranks on 1 node(s), {} backend"
    folder, text = run(DP_RANKS, "cuda:0", "dp", 1)
    need = ["logs/training_log.txt", "model/last_epoch_model.ckpt",
            "model/best_metric_model.ckpt"]
    if figs:
        need += ["figures/check_validation_image_and_label.png",
                 "figures/epoch_average_loss_and_val_mean_dice.png"]
    missing = [n for n in need if not (folder / n).is_file()]
    if missing or text.count(backend.format(DP_RANKS, "gloo")) != 1:
        raise AssertionError(f"torchrun cli.train: missing {missing} or "
                             "not one gloo line in rank 0's log")
    _, text = run(DP_RANKS, "cuda:0", "dp", 2, "--resume")
    if "Resuming full training state" not in text:
        raise AssertionError("torchrun cli.train --resume did not resume")
    _, text = run(1, "cuda", "dp_nccl", 1)
    if text.count(backend.format(1, "nccl")) != 1:
        raise AssertionError("torchrun --nproc_per_node 1 --device cuda: no "
                             "nccl line in the log")


def dp_run(dev, card: str):
    """Phase 18: data-parallel training on DP_RANKS ranks that share cuda:0
    (gloo: the multi-rank code on the one card, not a speed-up): (a) the
    flagship's first step at full width on global batch DP_BATCH against
    one process's batch-DP_BATCH step on the card, (c) ms/step at 1 and
    DP_RANKS ranks and the bytes a step all-reduces, (b) the training CLI
    under torchrun. Returns the launch counts of the ranks' counted
    steps, summed."""
    import torch

    from vs_seg_tpu_torch.models import build_model
    from vs_seg_tpu_torch.parallel import distributed
    from vs_seg_tpu_torch.train import trainer as tr

    torch.cuda.empty_cache()
    cfg = dp_config()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(SEED))
    trainer = tr.Trainer(cfg, model, dev)
    state = trainer.init_state()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = trainer.make_step(state)
    image, label = dp_batch(cfg, dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    torch.cuda.synchronize()
    reset_counts()
    loss = step(image, label, gen)
    torch.cuda.synchronize()
    one_counts = read_counts()
    one_loss = float(loss)
    ref_grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(DP_STEPS):
        loss = step(image, label, gen)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t) * 1e3 / DP_STEPS
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not torch.isfinite(loss):
        raise AssertionError("non-finite one-process loss")
    f32 = {n: g.cpu() for n, g in
           float32_step(cfg, init, image, label, dev)[1].items()}
    check_counts(one_counts, {"conv333_dw": TRAIN_SITES,
                              "conv333": TRAIN_SITES, "blend_scatter": 0,
                              **NO_KD1, **bn_launches(1)},
                 f"one-process batch-{DP_BATCH} step")
    del model, trainer, state, step, image, label, loss
    torch.cuda.empty_cache()

    t = time.perf_counter()
    res = distributed.launch(dp_rank, DP_RANKS, timeout_s=DP_TIMEOUT_S)
    log(f"  {DP_RANKS} ranks (spawned, {res[0]['backend']} on cuda:0, "
        f"{res[0]['rows']} row(s) each) done in "
        f"{time.perf_counter() - t:.1f} s")
    for r in res:
        check_counts(r["counts"], {"conv333_dw": TRAIN_SITES,
                                   "conv333": TRAIN_SITES,
                                   "blend_scatter": 0, **NO_KD1,
                                   **bn_launches(1)},
                     f"rank {r['rank']}'s DP step")
        if r["replicated"] or r["rows"] != DP_BATCH // DP_RANKS:
            raise AssertionError(f"rank {r['rank']}: {r['rows']} rows, "
                                 f"replicated {r['replicated']}")
        if not r["finite"]:
            raise AssertionError(f"rank {r['rank']}: non-finite loss")
    dp_loss = res[0]["loss"]
    log(f"  first-step loss: {DP_RANKS} ranks {dp_loss!r} (local "
        f"{[r['local_loss'] for r in res]}), one process {one_loss!r} "
        f"(tol {DP_LOSS_TOL!r} relative)")
    if abs(dp_loss - one_loss) > DP_LOSS_TOL * abs(one_loss):
        raise AssertionError(f"DP loss {dp_loss} vs one process {one_loss}")
    # Both steps run the kernel path in bf16, whose BatchNorm normalises
    # with f32 statistics (ops/bnorm_train.py): the ranks' sums, added by
    # the all-reduce, differ from one process's in their last bits, and a
    # gradient that cancels far below its terms moves with them (up to
    # 0.29 of a tensor's largest, H100; the eager chain's statistics,
    # rounded to bf16, mostly hid such bits). So each step is held to the
    # same step in float32, as phase 6 holds the kernel path.
    names = build_model(cfg, device="cpu")
    grads_vs_float32("all-reduced step", names, res[0]["grads"], ref_grads,
                     f32, (f"{DP_RANKS} ranks", "one process"))
    for r in res[1:]:
        for key in ("grads", "state"):
            diff = [k for k, v in res[0][key].items()
                    if not torch.equal(r[key][k], v)]
            if diff:
                raise AssertionError(f"rank {r['rank']}'s {key} differ from "
                                     f"rank 0's: {diff[:6]}")
    log(f"  parameters, BatchNorm buffers and gradients bit-identical on "
        f"the {DP_RANKS} ranks after the step")
    r0 = res[0]
    log(f"  (c) ms/step, {DP_STEPS} steps: one process (batch {DP_BATCH}) "
        f"{one_ms:.1f} ms, peak {one_peak:.2f} GiB; {DP_RANKS} ranks sharing "
        f"cuda:0 (batch {DP_BATCH // DP_RANKS} each) "
        f"{[round(r['ms'], 1) for r in res]} ms, peak "
        f"{[round(r['peak_gib'], 2) for r in res]} GiB; all-reduced per "
        f"step and rank: gradients {r0['grad_bytes']} B (DDP), BatchNorm "
        f"statistics {r0['bn_bytes']} B (forward and backward) on {card}")
    counts = {k: sum(r["counts"][k] for r in res) for k in one_counts}
    del res
    dp_cli_run(card)
    return counts

PIPE_CASES = (1, 2, 3)   # phase 19: vs_gk_1/2 train, vs_gk_3 validates; all 3
#                           are inferred
# Cases through phase 19's `bids`: each writes some 430 MB of float32
# NIFTIs (raw T1w and T2w, both registered ones) through gzip at level 9,
# ~41 s of one core a case on the H100 machine's host, beside
# the rest of the phase; all 3 would make it the phase's longest stage.
PIPE_BIDS_CASES = (1, 2)
PIPE_TIMEOUT_S = 600.0   # a preprocessing subprocess of phase 19
# phase 19's series (tests/tcia_download.py:Grid: rows, cols, slices; in-plane
# and slice mm; LPS origin): T2 448x448 at 0.5 mm, 80 slices of 1.5 mm; T1
# 512x512 at 0.46875 mm, 120 slices of 1 mm
PIPE_T2 = ((448, 448, 80), (0.5, 1.5), (-112.0, -112.0, -60.0))
PIPE_T1 = ((512, 512, 120), (0.46875, 1.0), (-120.0, -120.0, -60.0))


def reference_state_dict(model):
    """`model`'s weights under the reference's state_dict names and layouts
    (the .pth a reference training run saves): the inverse of
    compat/torch_import.py:import_unet2d5_spvpa, by its mapping."""
    from vs_seg_tpu_torch.compat.torch_import import unet2d5_spvpa_mapping

    leaf = {"conv.kernel": "conv.weight", "conv.bias": "conv.bias",
            "norm.scale": "norm.weight", "norm.bias": "norm.bias",
            "norm.mean": "norm.running_mean", "norm.var": "norm.running_var",
            "act.alpha": "act.weight", "kernel": "weight", "bias": "bias"}
    sd = model.state_dict()
    out = {}
    for prefix, kind, name in unet2d5_spvpa_mapping(
            len(model.channels) - 1, model.attention_module):
        for key, t in sd.items():
            if not key.startswith(name + "."):
                continue
            head, _, tail = key[len(name) + 1:].partition(".")
            if head.startswith("unit"):              # ResidualUnit subunits
                dst, tail = f"{prefix}.conv.{head}", tail
            elif head in ("residual", "conv1", "conv2"):
                dst = f"{prefix}.{head}"
            else:
                dst, tail = prefix, f"{head}.{tail}"
            v = t.detach().float().cpu()
            if tail.endswith("kernel"):              # (kh, kw, kd, in, out)
                v = v.permute(*((3, 4, 0, 1, 2) if kind == "convolution_t"
                                else (4, 3, 0, 1, 2)))
            out[f"{dst}.{leaf[tail]}"] = v.contiguous()
    if len(out) != len(sd):
        raise AssertionError(f"{len(sd) - len(out)} of the model's keys "
                             f"have no reference name")
    return out


def nifti_decode_check(paths, card: str):
    """Every NIFTI in `paths` through the native reader and converter and
    through their plain twins: bytes and float32 values equal; decode MB/s
    of each path (inflated bytes, converted float32 bytes)."""
    import struct

    import numpy as np

    from vs_seg_tpu_torch.native import decoder

    clock = {k: 0.0 for k in ("read", "read_plain", "conv", "conv_plain")}
    inflated = converted = 0
    for p in paths:
        p = str(p)
        t = time.perf_counter()
        raw = decoder.read_file_bytes(p)
        clock["read"] += time.perf_counter() - t
        t = time.perf_counter()
        plain = decoder.read_file_bytes_plain(p)
        clock["read_plain"] += time.perf_counter() - t
        if raw is None or raw != plain:
            raise AssertionError(f"{p}: native bytes differ from gzip's")
        dims = struct.unpack_from("<8h", raw, 40)
        count = int(np.prod(dims[1:1 + dims[0]]))
        (code,) = struct.unpack_from("<h", raw, 70)
        (vox,) = struct.unpack_from("<f", raw, 108)
        slope, inter = struct.unpack_from("<2f", raw, 112)
        payload = raw[int(vox):]
        t = time.perf_counter()
        got = decoder.convert_to_float32(payload, count, code, slope, inter)
        clock["conv"] += time.perf_counter() - t
        t = time.perf_counter()
        ref = decoder.convert_to_float32_plain(payload, count, code, slope,
                                               inter)
        clock["conv_plain"] += time.perf_counter() - t
        if got is None or not np.array_equal(got, ref):
            raise AssertionError(f"{p}: native float32 differs from numpy's")
        inflated += len(raw)
        converted += 4 * count
    mb = {"read": inflated, "read_plain": inflated, "conv": converted,
          "conv_plain": converted}
    rate = {k: mb[k] / 1e6 / clock[k] for k in clock}
    log(f"  {len(paths)} NIFTIs ({inflated / 1e6:.1f} MB inflated): native "
        f"bytes and float32 bit-equal to the gzip and numpy twins; read + "
        f"inflate {rate['read']:.1f} MB/s native, {rate['read_plain']:.1f} "
        f"MB/s twin; to float32 {rate['conv']:.1f} MB/s native, "
        f"{rate['conv_plain']:.1f} MB/s twin (MB of float32 out); seconds "
        f"{clock!r} on {card}")
    return rate


def pipeline_run(dev, card: str):
    """Phase 19: the reference's pipeline from a synthetic TCIA DICOM
    download to exported labelmaps, through the preprocessing CLI, the
    training CLI, the checkpoint converter and the inference CLI."""
    import dataclasses
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from vs_seg_tpu_torch.cli import inference
    from vs_seg_tpu_torch.cli import train as cli_train
    from vs_seg_tpu_torch.compat import convert_checkpoint
    from vs_seg_tpu_torch.core.config import parse_cli
    from vs_seg_tpu_torch.data import nifti
    from vs_seg_tpu_torch.models import build_model
    from vs_seg_tpu_torch.native import decoder
    from vs_seg_tpu_torch.ops import _build
    from vs_seg_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   load_model_state)

    # by path: a `tests` package installed on the machine would shadow the
    # repo's tests/ folder, which is no package
    spec = importlib.util.spec_from_file_location(
        "tcia_download", REPO / "tests" / "tcia_download.py")
    tcia = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tcia)
    if not decoder.native_available():
        raise AssertionError("the native NIFTI decoder did not build")
    lib = _build.library_path("nifti_decode", decoder.SRC)
    built = _build.BUILD_SECONDS.get("nifti_decode")
    log(f"  native decoder {lib.relative_to(REPO)}: "
        + (f"built by g++ in {built:.2f} s at its first use" if built
           else "found built"))

    t2, t1 = tcia.Grid(*PIPE_T2), tcia.Grid(*PIPE_T1)
    root = REPO / "build" / "chip_smoke_pipeline"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    raw, cases, data = root / "raw", root / "cases", root / "data"
    seconds = {}
    wall0 = time.perf_counter()

    def timed(stage, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[stage] = time.perf_counter() - t
        return out

    procs = {}

    def cli(name, *args):
        """Start `python -m vs_seg_tpu_torch.preprocessing ARGS`, its output
        into <root>/<name>.log; a thread notes when it exits."""
        with open(root / f"{name}.log", "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "vs_seg_tpu_torch.preprocessing",
                 *args], cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
        end = []
        waiter = threading.Thread(
            target=lambda: end.append((proc.wait(), time.perf_counter())[1]),
            daemon=True)
        procs[name] = (proc, time.perf_counter(), waiter, end)
        waiter.start()

    def finish(name):
        """Wait for `name` to exit 0; its own seconds."""
        proc, t0, waiter, end = procs.pop(name)
        try:
            proc.wait(timeout=PIPE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"{name}: no exit in {PIPE_TIMEOUT_S} s")
        waiter.join()
        if proc.returncode != 0:
            raise AssertionError(f"{name}: exit {proc.returncode}\n"
                                 + (root / f"{name}.log").read_text())
        return end[0] - t0

    def links(folder, ns):
        folder.mkdir()
        for n in ns:
            for tag in ("t1", "t2"):
                os.symlink(cases / f"vs_gk_{n}_{tag}",
                           folder / f"vs_gk_{n}_{tag}")
        return folder

    pixels = timed("write the DICOM download", tcia.write_download, raw,
                   PIPE_CASES, t2, t1)
    log(f"  {len(PIPE_CASES)} cases of a T2 series {t2.shape} and a T1 "
        f"series {t1.shape} (int16, RTSTRUCT, RTPLAN, RTDOSE each) written "
        f"in {seconds['write the DICOM download']:.1f} s")
    try:
        cli("restructure", "restructure", "-i", str(raw), "-o", str(cases))
        seconds["restructure"] = finish("restructure")
        tcia.write_transforms(cases, PIPE_CASES)

        # bids on PIPE_BIDS_CASES in the background; one `convert
        # --register T2` per case, all at once, into <root>/data/input_data
        cli("bids", "bids", "-i",
            str(links(root / "bids_in", PIPE_BIDS_CASES)),
            "-o", str(root / "bids"))
        t = time.perf_counter()
        for n in PIPE_CASES:
            cli(f"convert_{n}", "convert", "-i",
                str(links(root / f"convert_in_{n}", (n,))),
                "-o", str(data / "input_data"), "--register", "T2")
        for n in PIPE_CASES:
            seconds[f"convert --register T2, vs_gk_{n}"] = finish(
                f"convert_{n}")
        seconds["convert, the cases at once"] = time.perf_counter() - t
        for n in PIPE_CASES:
            got = nifti.load(str(data / "input_data" / f"vs_gk_{n}"
                                 / "vs_gk_t2_refT2.nii.gz"))
            if not np.array_equal(got.data,
                                  pixels[n]["t2"].astype(np.float32)):
                raise AssertionError(f"vs_gk_{n}: the converted T2 is not "
                                     f"the written pixels")
            moved = nifti.load(str(data / "input_data" / f"vs_gk_{n}"
                                   / "vs_gk_t1_refT2.nii.gz")).data
            want = np.argwhere(pixels[n]["t2"] == 900).mean(0)
            at = np.argwhere(moved > 800).mean(0)
            if np.abs(at - want).max() > 1.0:
                raise AssertionError(f"vs_gk_{n}: registered T1 tumour at "
                                     f"{at}, the T2's at {want}")
        log(f"  the converted T2 volumes equal the written pixels; each "
            f"registered T1's tumour lies on its T2's (within a voxel)")

        split = root / "split.csv"
        split.write_text("vs_gk_1,training\nvs_gk_2,training\n"
                         "vs_gk_3,validation\n"
                         + "".join(f"vs_gk_{n},test\n" for n in PIPE_CASES))

        def argv(name):
            return ["--data_root", str(data), "--split", str(split),
                    "--dataset", "T2", "--results_folder_name", name,
                    "--device", str(dev), "--seed", str(SEED)]

        figs = importlib.util.find_spec("matplotlib") is not None
        real_cfg = cli_train.config_from_args
        cli_train.config_from_args = (
            lambda a: dataclasses.replace(real_cfg(a), num_epochs=1,
                                          val_interval=1))
        decoder.read_file_bytes.native_calls = 0
        decoder.convert_to_float32.native_calls = 0
        try:
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            state, losses, dice = cli_train.main(argv("trained"),
                                                 make_figures=figs)
            torch.cuda.synchronize()
            seconds["cli.train, 1 epoch"] = time.perf_counter() - t
            train_counts = read_counts()
        finally:
            cli_train.config_from_args = real_cfg
        steps = 2                           # 2 training cases, batch 1
        if (len(losses) != 1 or len(dice) != 1 or state["epoch"] != 1
                or not np.isfinite(list(losses) + list(dice)).all()):
            raise AssertionError(f"pipeline training: losses {losses}, "
                                 f"dice {dice}, epoch {state['epoch']}")
        check_counts(train_counts, train_cli_counts(steps, 1),
                     "pipeline training")
        reads = decoder.read_file_bytes.native_calls
        convs = decoder.convert_to_float32.native_calls
        log(f"  training: loss {losses}, val dice {dice}; native NIFTI "
            f"reads {reads}, conversions {convs}")
        if reads == 0 or convs == 0:
            raise AssertionError("the training CLI read no NIFTI natively")

        # the trained weights as a reference .pth, converted by the CLI
        cfg = parse_cli(argv("trained"))
        trained = build_model(cfg, device=dev)
        if load_model_state(cfg, trained) != "torch":
            raise AssertionError("the trained checkpoint is not the port's")
        conv_cfg = parse_cli(argv("converted"))
        pth = root / "trained.pth"
        dst = Path(conv_cfg.model_path) / "best_metric_model.ckpt"
        t = time.perf_counter()
        torch.save(reference_state_dict(trained), pth)
        convert_checkpoint.main([str(pth), str(dst)])
        seconds["reference .pth + convert_checkpoint"] = (
            time.perf_counter() - t)
        back = load_checkpoint(str(dst))
        want = trained.state_dict()
        if (back["epoch"] != -1 or sorted(back["model"]) != sorted(want)
                or not all(torch.equal(back["model"][k], want[k].cpu())
                           for k in want)):
            raise AssertionError("the converted checkpoint differs from "
                                 "the trained weights")
        log("  the trained weights, written as a reference .pth and "
            "converted, read back bit-equal")

        counts = dict(train_counts)
        runs = {}
        for name in ("trained", "converted"):
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            dsc, secs = inference.main(argv(name), make_figures=figs)
            torch.cuda.synchronize()
            seconds[f"cli.inference ({name})"] = time.perf_counter() - t
            got = read_counts()
            forwards = len(PIPE_CASES)      # one 8-window batch a volume
            check_counts(got, {
                **{k: n * forwards for k, n in {**EVAL_RU,
                                                **EVAL_L2}.items()},
                "conv333": EVAL_CONV333 * forwards,
                "blend_scatter": forwards, "conv333_dw": 0, **NO_KD1},
                f"pipeline inference ({name})")
            counts = {k: counts[k] + got[k] for k in counts}
            runs[name] = (parse_cli(argv(name)), dsc, secs)
            log(f"  inference from the {name} checkpoint: Dice "
                f"{dsc.tolist()}, compute s/volume {secs!r}")

        exports = []
        for n in PIPE_CASES:
            label = data / "input_data" / f"vs_gk_{n}" / "vs_gk_seg_refT2.nii.gz"
            ref = nifti.load(str(label))
            outs = []
            for name, (c, _, _) in runs.items():
                p = (Path(c.results_folder_path)
                     / "inferred_segmentations_nifti" / f"vs_gk_{n}"
                     / label.name)
                exports.append(p)
                o = nifti.load(str(p))
                if o.data.shape != ref.data.shape or not np.allclose(
                        o.affine, ref.affine):
                    raise AssertionError(
                        f"vs_gk_{n} ({name}): export {o.data.shape} "
                        f"{o.affine.tolist()} vs original "
                        f"{ref.data.shape} {ref.affine.tolist()}")
                if not set(np.unique(o.data)) <= {0.0, 1.0}:
                    raise AssertionError(f"vs_gk_{n}: labels "
                                         f"{np.unique(o.data)}")
                outs.append(o.data)
            if not np.array_equal(outs[0], outs[1]):
                raise AssertionError(f"vs_gk_{n}: the two checkpoints' "
                                     f"labelmaps differ")
        log(f"  labelmaps exported on the original affine and shape "
            f"{ref.data.shape}, equal from both checkpoints")

        seconds[f"bids, {len(PIPE_BIDS_CASES)} cases beside the rest"] = (
            finish("bids"))
    finally:
        for proc, *_ in procs.values():
            proc.kill()
            proc.wait()
    if not (root / "bids" / "participants.tsv").is_file():
        raise AssertionError("bids wrote no dataset")

    written = (sorted((data / "input_data").rglob("*.nii.gz"))
               + sorted((root / "bids").rglob("*.nii.gz")) + exports)
    rate = timed("decode check", nifti_decode_check, written, card)
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "vs_seg_tpu"))
    if jax_mods:
        raise AssertionError(f"the pipeline imported {jax_mods[:8]}")
    wall = time.perf_counter() - wall0
    log(f"pipeline stage seconds {seconds!r}; wall {wall:.1f} s on {card}")
    return counts, seconds, rate


def window_flops(model) -> int:
    """eval/flops.py:forward_conv_flops of `model` at one ROI window; raises
    unless the model's state is where it was and bit-equal after it."""
    import torch

    from vs_seg_tpu_torch.eval.flops import forward_conv_flops
    before = {k: v.clone() for k, v in model.state_dict().items()}
    t = time.perf_counter()
    flop = forward_conv_flops(model, (1, ROI[2], ROI[0], ROI[1], 1))
    secs = time.perf_counter() - t
    after = model.state_dict()
    if sorted(after) != sorted(before) or not all(
            after[k].device == v.device and torch.equal(after[k], v)
            for k, v in before.items()):
        raise AssertionError("forward_conv_flops changed the model")
    log(f"  {type(model).__name__}: {flop} conv FLOP a window, counted in "
        f"{secs:.2f} s; the model's state bit-equal and on "
        f"{next(model.parameters()).device}")
    return flop


# Phase 20: the flagship's conv modules behind each kernel record's bound
# at its phase 2, 7 or 9 site: (the bound's bf16 FLOP, its f32 FLOP).
# l2_block's, l2_block2d's and tail_block's bounds count the attention
# conv2 (C -> 1) as f32 work, beside the gate's elementwise operations
# (4 a gated channel and voxel).
BOUND_SITES = {
    "conv333": (("down_2.unit0.conv",), ()),
    "ru_block": (("down_2.unit0.conv", "down_2.unit1.conv",
                  "down_2.residual"), ()),
    "l2_block": (("upatt_2.conv1.conv", "up_2.unit0.conv", "up_2.residual"),
                 ("upatt_2.conv2.conv",)),
    "ds_conv": (("downsample_2.conv",), ()),
    "ru_block2d": (("down_0.unit0.conv", "down_0.unit1.conv",
                    "down_0.residual"), ()),
    "l2_block2d": (("upatt_0.conv1.conv", "up_0.unit0.conv",
                    "up_0.residual"), ("upatt_0.conv2.conv",)),
    "tail_block": (("up_1.unit0.conv", "up_1.residual"),
                   ("upatt_1.conv2.conv",)),
}
# phase 20's whole-volume rows: ms/volume tag -> (label, model)
MFU_ROWS = {
    "inference": ("flagship, default routes", "UNet2d5_spvPA"),
    "configuration A": ("flagship, configuration A", "UNet2d5_spvPA"),
    "configuration B": ("flagship, configuration B", "UNet2d5_spvPA"),
    "configuration C": ("flagship, configuration C", "UNet2d5_spvPA"),
    "UNet2d5 (default routes)": ("UNet2d5, default routes", "UNet2d5"),
    "UNet (default routes)": ("UNet, default routes", "UNet"),
    "UNet (dsconv)": ("UNet, dsconv", "UNet"),
}


def flops_run(dev, card: str, rec, flagship, volume_ms):
    """Phase 20 (no timed run): the conv FLOP count of a window of each
    model (eval/flops.py); the flagship's again after configurations A, B
    and C, required unchanged; TFLOP/s and MFU against H100_PEAK_BF16 of
    every ms/volume phases 3, 8 and 16 measured (`volume_ms`: tag ->
    (kernel, plain)); and the bf16 FLOP each kernel record's bound
    received beside the conv modules it covers."""
    import torch

    from vs_seg_tpu_torch.core.config import Config
    from vs_seg_tpu_torch.eval.flops import H100_PEAK_BF16
    from vs_seg_tpu_torch.infer.sliding_window import dense_patch_starts
    from vs_seg_tpu_torch.models import build_model

    window = {"UNet2d5_spvPA": flagship["before"]}
    for name in ("UNet2d5", "UNet"):
        model = build_model(Config(model=name), device=dev,
                            generator=torch.Generator().manual_seed(SEED))
        window[name] = window_flops(model)
        del model
    for name, flop in window.items():
        log(f"  {name}: {flop} conv FLOP a {ROI[0]}x{ROI[1]}x{ROI[2]} "
            f"window on {card}")
    if flagship["after"] != flagship["before"]:
        raise AssertionError(
            f"the flagship's count moved after configurations A, B and C: "
            f"{flagship['before']} -> {flagship['after']}")
    log(f"  UNet2d5_spvPA after configurations A, B and C: "
        f"{flagship['after']} conv FLOP a window, unchanged")

    n_win = len(dense_patch_starts((VOLUME[2], VOLUME[0], VOLUME[1]),
                                   (ROI[2], ROI[0], ROI[1]), 0.25))
    missing = sorted(set(MFU_ROWS) - set(volume_ms))
    if missing:
        raise AssertionError(f"no ms/volume recorded for {missing}")
    rows = {}
    for tag, (label, name) in MFU_ROWS.items():
        flop = window[name] * n_win
        row = {"model": name, "tflop_per_volume": flop / 1e12}
        for path, ms in zip(("kernel", "plain"), volume_ms[tag]):
            tflops = flop / ms / 1e9
            row[path] = {"ms_per_volume": ms, "tflops": tflops,
                         "mfu": tflops * 1e12 / H100_PEAK_BF16}
        rows[label] = row
        k, p = row["kernel"], row["plain"]
        log(f"  {label}: {flop / 1e12:.4f} TFLOP a volume ({n_win} "
            f"windows); kernel path {k['ms_per_volume']:.1f} ms/volume, "
            f"{k['tflops']:.2f} TFLOP/s, MFU {k['mfu']:.4f}; plain path "
            f"{p['ms_per_volume']:.1f} ms/volume, {p['tflops']:.2f} TFLOP/s, "
            f"MFU {p['mfu']:.4f} (peak {H100_PEAK_BF16 / 1e12:.0f} TFLOP/s "
            f"bf16) on {card}")
    print(json.dumps({"mfu": rows, "card": card}), flush=True)

    by_module = {}
    for name, flop in flagship["by_module"]:
        by_module[name] = by_module.get(name, 0) + flop
    for k, (bf16_mods, f32_mods) in BOUND_SITES.items():
        _, _, _, f16, f32 = rec[k]["bound"]
        conv16 = sum(by_module[m] for m in bf16_mods)
        conv32 = sum(by_module[m] for m in f32_mods)
        log(f"  {k} bound at {rec[k]['shape']}: {f16:.0f} FLOP bf16, "
            f"{f32:.0f} f32; eval/flops.py over {SW_BATCH} windows: "
            f"{' + '.join(bf16_mods)} = {conv16}"
            + (f", {' + '.join(f32_mods)} = {conv32} (in the bound's f32, "
               f"the rest {f32 - conv32:.0f} the gate's)" if f32_mods
               else ""))
        if f16 != conv16 or f32 < conv32:
            raise AssertionError(f"{k}: the bound's conv FLOP differ from "
                                 f"the modules' count")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    if not (REPO / "vs_seg_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: no vs_seg_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vs_seg_tpu_torch.core.device import resolve_device
    from vs_seg_tpu_torch.eval.flops import conv_flops_by_module
    from vs_seg_tpu_torch.ops import _build

    # plain float32 convs/matmuls in full f32 (cuDNN would use TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = resolve_device("cuda:0")
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()

    def phase(msg: str) -> None:
        log(f"{msg} [{time.perf_counter() - t0:.1f} s]")

    names = ("conv333", "conv333_dw", "attgate", "blend", "rublock2d",
             "l2block2d", "tail2d", "ring_probe", "mosaic_probe",
             "bnorm_train")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        list(pool.map(_build.build, names))
    for name in names:
        _build.load(name)
    log(f"kernel build+load {time.perf_counter() - t0:.1f} s "
        f"(nvcc seconds {_build.BUILD_SECONDS})")

    gen = torch.Generator().manual_seed(SEED)
    phase("phase 2: kernels vs plain twins at flagship shapes")
    rec = kernel_checks(dev, gen, card)
    phase("phase 3: flagship whole-volume inference")
    infer_counts, model, staged, default_logits, ms = model_run(dev, gen,
                                                                card)
    volume_ms = {"inference": ms}
    flagship = {"before": window_flops(model)}
    phase("phase 5: training kernels vs plain twins")
    rec.update(train_kernel_checks(dev, gen, card))
    rec.update(bnorm_checks(dev, card))
    phase("phase 6: flagship training at full width")
    train_counts = train_run(dev, card)
    phase("phase 7: kd = 1 route kernels vs plain twins at flagship shapes")
    rec.update(kd1_kernel_checks(dev, gen, card))
    phase("phase 8: flagship whole-volume inference under route "
          "configurations A, B and C")
    route_counts, ms = routes_run(dev, gen, card, model, staged,
                                  default_logits)
    volume_ms.update({f"configuration {k}": v for k, v in ms.items()})
    flagship["after"] = window_flops(model)
    flagship["by_module"] = conv_flops_by_module(
        model, (SW_BATCH, ROI[2], ROI[0], ROI[1], 1))
    del staged
    default_logits = default_logits.cpu()    # held for phase 17
    phase("phase 9: ds_conv vs its plain twin at the flagship's downsample "
          "sites")
    rec.update(dsconv_checks(dev, gen, card))
    phase("phase 10: the inference CLI end to end (NIFTI in, Dice + NIFTI "
          "out) under --routes dsconv, and the plain path")
    cli_counts = cli_run(dev, card, model)
    phase("phase 11: conv333 at each of its sites (one 8-window forward, "
          "configuration A's kd = 1 sites, the train dgrad)")
    conv333_sweep(dev, card)
    phase("phase 12: the nine Mosaic probes vs their twins, every scheme")
    rec.update(mosaic_probe_checks(dev, card))
    phase("phase 13: attgate at each of its sites (default, A and B)")
    attgate_sweep(dev, card)
    phase("phase 14: conv333_dw at each of the train step's sites")
    dw_sweep(dev, card, rec)
    phase("phase 15: the training CLI end to end at full width (host "
          "loader, --device_cache, --resume with --profile_steps 2)")
    tcli_counts = train_cli_run(dev, card)
    phase("phase 16: UNet2d5 and UNet (inference and a train step), the "
          "flagship with and without --remat, the blend's options")
    zoo_counts, ms = zoo_run(dev, card)
    volume_ms.update(ms)
    phase("phase 17: window-sharded and H-sharded inference on meshes "
          "that repeat cuda:0, and the CLI's two flags")
    shard_counts = multi_shard_run(dev, card, model, default_logits,
                                   REPO / "build" / "chip_smoke_cli")
    del model, default_logits
    phase("phase 18: data-parallel training, 2 ranks sharing cuda:0 "
          "(gloo): the DP step vs one process, ms/step, the CLI under "
          "torchrun")
    dp_counts = dp_run(dev, card)
    phase("phase 19: the reference pipeline from a synthetic TCIA DICOM "
          "download to labelmaps (preprocessing CLI, cli.train, the "
          "checkpoint converter, cli.inference)")
    pipe_counts, _, _ = pipeline_run(dev, card)
    phase("phase 20: conv FLOP a window of each model, unchanged after "
          "configurations A, B and C; TFLOP/s and MFU of phases 3, 8 and "
          "16's ms/volume; the kernel bounds' FLOP beside the count")
    flops_run(dev, card, rec, flagship, volume_ms)
    phase("phases done")
    counts = {k: infer_counts[k] + train_counts[k] + route_counts[k]
              + cli_counts[k] + tcli_counts[k] + zoo_counts[k]
              + shard_counts[k] + dp_counts[k] + pipe_counts[k]
              for k in infer_counts}
    for k, r in rec.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        ms, by, moved, f16, f32 = r["bound"]
        log(f"  {k} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {lib} ms, bound {ms:.3f} ms "
            f"({by}: {moved / 1e9:.3f} GB, {f16 / 1e9:.1f} GFLOP bf16, "
            f"{f32 / 1e9:.1f} GFLOP f32) on {card}")

    pkg = "vs_seg_tpu_torch/ops/"
    exp = "vs_seg_tpu/ops/experimental/"
    meta = {
        "conv333": ("csrc/conv333.cu", "vs_seg_tpu/ops/pallas_conv333.py:208"),
        "attgate": ("csrc/attgate.cu", "vs_seg_tpu/ops/pallas_l2block.py:271"),
        "att_map": ("csrc/attgate.cu", "vs_seg_tpu/ops/pallas_l2block.py:271"),
        "conv333_gated": ("csrc/conv333.cu",
                          "vs_seg_tpu/ops/pallas_l2block.py:313"),
        "ru_block": ("rublock.py", "vs_seg_tpu/ops/pallas_rublock.py:183"),
        "ru_unit": ("csrc/conv333.cu",
                    "vs_seg_tpu/ops/pallas_rublock.py:183"),
        "l2_block": ("l2block.py", "vs_seg_tpu/ops/pallas_l2block.py:391"),
        "blend_scatter": ("csrc/blend.cu",
                          "vs_seg_tpu/ops/pallas_blend.py:107"),
        "conv333_dw": ("csrc/conv333_dw.cu", exp + "pallas_train.py:113"),
        "ru_block2d": ("csrc/rublock2d.cu", exp + "pallas_block2d.py:180"),
        "l2_block2d": ("csrc/l2block2d.cu", exp + "pallas_block2d.py:226"),
        "tail_block": ("csrc/tail2d.cu", exp + "pallas_tail2d.py:239"),
        "fused_attention_gate": ("att.py", exp + "pallas_att.py:146"),
        "ds_conv": ("csrc/conv333.cu", exp + "pallas_dsconv.py:145"),
        "ring_probe": ("csrc/ring_probe.cu", "tools/ring_probe.py:45"),
        "mosaic_probe": ("csrc/mosaic_probe.cu",
                         "tools/mosaic_probe.py:47-143"),
        "bn_dropout_prelu": ("csrc/bnorm_train.cu", "none (XLA fusion)"),
    }
    kernels = [{"name": k, "route": "cuda", "source": pkg + meta[k][0],
                "replaces": meta[k][1], "launches": counts[k],
                "max_abs_err": rec[k]["max_abs_err"], "ms": rec[k]["ms"],
                "plain_ms": rec[k]["plain_ms"],
                "bound_ms": rec[k]["bound"][0],
                "bound_by": rec[k]["bound"][1],
                "library_ms": rec[k]["library_ms"]} for k in meta]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
