"""Sliding-window inference with importance-weighted blending, mirroring
vs_seg_tpu/infer/sliding_window.py (MONAI 0.4 sliding_window_inference,
mode "gaussian" by default or "constant"):
  - pad each dim to >= roi (symmetric, constant 0);
  - window starts: scan_interval = int(roi*(1-overlap)) (roi if dim==roi),
    scan_num = ceil(dim/interval), start_i = i*interval clamped so the
    window fits (duplicates kept);
  - Gaussian importance map: sigma = sigma_scale*roi (0.125 by default),
    truncated at 4 sigma, normalised to max 1, zeros replaced by the min
    nonzero value; the constant map is all ones;
  - out = sum(pred * imp) / sum(imp), padding cropped.

The loop per volume: gather a batch of windows -> predictor -> blend the
batch into f32 accumulators (ops/blend.py: the hand-written kernel on CUDA)
-> out / w -> crop -> (H, W, D, O).

The port runs the JAX package's main-path configuration: the predictor
takes the model's D-first (N, D, H, W, C) windows (JAX predictor_layout=
"dfirst"). `stage_volume` has the JAX package's
shape bucketing (window placement stays on the unbucketed extent, so results
are bit-identical) and transfer dtypes (float32, a bf16/f16 cast rounded on
the host, or uint8 quantization).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from vs_seg_tpu_torch.core.device import resolve_device
from vs_seg_tpu_torch.ops import blend


def gaussian_importance_map(roi_size: Sequence[int],
                            sigma_scale: float = 0.125) -> np.ndarray:
    """MONAI 0.4 compute_importance_map(mode=gaussian), in closed form: the
    truncated separable Gaussian filter of a centre impulse is the product
    of per-axis truncated Gaussians."""
    maps_1d = []
    for dim in roi_size:
        center = dim // 2
        sigma = sigma_scale * dim
        tail = int(4.0 * sigma + 0.5)
        x = np.arange(dim, dtype=np.float64) - center
        g = np.exp(-0.5 * (x / sigma) ** 2)
        g[np.abs(x) > tail] = 0.0
        maps_1d.append(g)
    imp = (maps_1d[0][:, None, None] * maps_1d[1][None, :, None]
           * maps_1d[2][None, None, :])
    imp = (imp / imp.max()).astype(np.float32)
    nz = imp[imp != 0]
    if nz.size and (imp == 0).any():
        imp[imp == 0] = nz.min()
    return imp


@lru_cache(maxsize=8)
def _importance_map_device(roi_size: Tuple[int, ...], mode: str,
                           sigma_scale: float,
                           device: torch.device) -> torch.Tensor:
    """The importance map of `mode` on `device`, cached across volumes:
    computing it on the host (float64, ~10^7 voxels for the flagship ROI)
    for every volume would leave the device idle meanwhile. Callers must
    not modify the returned tensor."""
    if mode == "gaussian":
        imp = gaussian_importance_map(roi_size, sigma_scale)
    elif mode == "constant":
        imp = np.ones(roi_size, np.float32)
    else:
        raise ValueError(f"unsupported blend mode {mode}")
    return torch.from_numpy(imp).to(device)


def _scan_interval(image_size, roi_size, overlap: float) -> Tuple[int, ...]:
    return tuple(int(roi) if roi == dim else int(roi * (1 - overlap))
                 for roi, dim in zip(roi_size, image_size))


def dense_patch_starts(image_size, roi_size, overlap: float) -> np.ndarray:
    """MONAI 0.4 dense_patch_slices window starts (duplicates preserved)."""
    intervals = _scan_interval(image_size, roi_size, overlap)
    per_dim = []
    for dim, roi, interval in zip(image_size, roi_size, intervals):
        if interval == 0:
            per_dim.append([0])
            continue
        scan_num = int(math.ceil(float(dim) / interval))
        starts = []
        for i in range(scan_num):
            start = i * interval
            start -= max(start + roi - dim, 0)
            starts.append(start)
        per_dim.append(starts)
    grid = np.stack(np.meshgrid(*per_dim, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).astype(np.int32)


def count_windows(spatial_shape: Sequence[int], roi_size: Sequence[int],
                  overlap: float) -> int:
    """Number of sliding windows for a volume (after pad-to-roi)."""
    padded = tuple(max(int(d), int(r))
                   for d, r in zip(spatial_shape, roi_size))
    return len(dense_patch_starts(padded, tuple(int(r) for r in roi_size),
                                  overlap))


class StagedVolume:
    """A volume prepared on the host and uploaded, ready for window
    inference (from `stage_volume`)."""

    __slots__ = ("vol_dev", "crops", "starts_padded", "mask", "roi_size",
                 "dequant")

    def __init__(self, vol_dev, crops, starts_padded, mask, roi_size,
                 dequant):
        self.vol_dev = vol_dev          # padded (D, H, W, C) on the device
        self.crops = crops              # per dim (lo, hi) of the volume
        self.starts_padded = starts_padded  # (n_pad, 3) host int32 (d, h, w)
        self.mask = mask                # (n_pad,) host f32, 0 for padding
        self.roi_size = roi_size        # (D, H, W)
        self.dequant = dequant          # (scale, offset) for uint8, or None


def stage_volume(volume: np.ndarray, roi_size: Sequence[int], *, device,
                 overlap: float = 0.25, sw_batch_size: int = 4,
                 bucket: Optional[Sequence[int]] = None,
                 transfer_dtype: Optional[torch.dtype] = None,
                 quantize: bool = False) -> StagedVolume:
    """Host prep + upload: D-first transpose, pad to roi, window placement,
    optional uint8 quantization of the transfer (max error ~0.02 of the
    value range, below bf16 resolution for the predictor's bf16 compute).

    volume: (H, W, D, C) host array; roi_size and `bucket` in (H, W, D).
    `bucket` rounds the padded shape up to multiples of it; the margin gets
    no window and lies outside the crops. `transfer_dtype` (torch.bfloat16
    or torch.float16) casts the buffer on the host, rounding to nearest
    even as the JAX package's host cast does; quantize takes precedence.
    The padded D-first buffer is filled on the host (pinned when `device`
    is CUDA) and copied with one non_blocking copy."""
    device = resolve_device(device)
    volume = np.asarray(volume, dtype=np.float32)
    if volume.ndim != 4:
        raise ValueError(f"expected (H, W, D, C), got {volume.shape}")
    roi_size = tuple(int(r) for r in roi_size)
    roi_size = (roi_size[2], roi_size[0], roi_size[1])
    if bucket is not None:
        bucket = (int(bucket[2]), int(bucket[0]), int(bucket[1]))
    cast = (not quantize and transfer_dtype is not None
            and transfer_dtype != torch.float32)
    dequant = None
    pad_value = 0
    if quantize:
        # the range includes 0.0 so the zero pad-to-roi margin is
        # representable (raw code 0 would dequantize to `lo`)
        lo = min(float(volume.min()), 0.0)
        hi = max(float(volume.max()), 0.0)
        scale = (hi - lo) / 255.0 if hi > lo else 1.0
        inv_scale = np.float32(1.0 / scale)
        dequant = (np.float32(scale), np.float32(lo))
        out_dtype = np.dtype(np.uint8)
        # code for 0.0, same +0.5-truncation rounding as the fill
        pad_value = int(np.clip(np.float32(0.0 - lo) * inv_scale + 0.5, 0,
                                255))
    else:
        out_dtype = volume.dtype
    src = np.transpose(volume, (2, 0, 1, 3))

    pads, crops = [], []
    for dim, roi in zip(src.shape[:3], roi_size):
        diff = max(roi - dim, 0)
        half = diff // 2
        pads.append((half, diff - half))
        crops.append((half, half + dim))
    padded_shape = [d + p0 + p1 for d, (p0, p1) in zip(src.shape[:3], pads)]
    starts = dense_patch_starts(tuple(padded_shape), roi_size, overlap)
    if bucket is not None:
        padded_shape = [p + (-p) % b for p, b in zip(padded_shape, bucket)]

    n = starts.shape[0]
    n_pad = -(-n // sw_batch_size) * sw_batch_size
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    starts_padded = np.zeros((n_pad, 3), np.int32)
    starts_padded[:n] = starts

    shape = (*padded_shape, src.shape[3])
    host = torch.from_numpy(np.empty(shape, out_dtype))
    if device.type == "cuda" and not cast:
        host = host.pin_memory()
    buf = host.numpy()
    buf.fill(pad_value)
    (a0, _), (b0, _), (c0, _) = pads
    if quantize:
        # round to nearest via +0.5 truncation, as the JAX package does
        block = np.clip((src - lo) * inv_scale + 0.5, 0.0, 255.0
                        ).astype(np.uint8)
    else:
        block = src
    buf[a0:a0 + src.shape[0], b0:b0 + src.shape[1],
        c0:c0 + src.shape[2]] = block
    if cast:
        host = host.to(transfer_dtype)
        if device.type == "cuda":
            host = host.pin_memory()
    vol_dev = host.to(device, non_blocking=True)
    return StagedVolume(vol_dev, crops, starts_padded, mask, roi_size,
                        dequant)


def dequantize(vol_u8: torch.Tensor, scale, offset,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 codes -> out_dtype, in out_dtype arithmetic with scale and
    offset cast to it first (vs_seg_tpu's _dequantize)."""
    s = torch.tensor(float(scale), dtype=torch.float32).to(out_dtype)
    o = torch.tensor(float(offset), dtype=torch.float32).to(out_dtype)
    return vol_u8.to(out_dtype) * s.to(vol_u8.device) + o.to(vol_u8.device)


def sliding_window_inference(volume, roi_size: Sequence[int],
                             predictor: Callable, *, device=None,
                             overlap: float = 0.25, sw_batch_size: int = 4,
                             mode: str = "gaussian",
                             sigma_scale: float = 0.125,
                             quantize: bool = False,
                             use_kernels: bool = True) -> torch.Tensor:
    """Run `predictor` over overlapping ROIs of a whole volume and blend.

    volume: (H, W, D, C) host array (then `device` is required), or a
    StagedVolume; roi_size in (H, W, D). predictor: (N, D, H, W, C) windows
    -> (N, D, H, W, out). mode: the importance map, "gaussian" (sigma =
    sigma_scale * roi) or "constant". use_kernels=False blends with the
    plain twin of the blend kernel. Returns (H, W, D, out) f32 blended
    logits on the volume's device."""
    if isinstance(volume, StagedVolume):
        staged = volume
    else:
        staged = stage_volume(volume, roi_size, device=device,
                              overlap=overlap, sw_batch_size=sw_batch_size,
                              quantize=quantize)
    vol, imp = volume_on(staged, staged.vol_dev.device, mode, sigma_scale)
    n_pad = staged.starts_padded.shape[0]
    if n_pad % sw_batch_size:
        raise ValueError(
            f"staged window list ({n_pad}, padded for stage_volume("
            f"sw_batch_size=...)) is not divisible by the inference "
            f"sw_batch_size={sw_batch_size}")
    fn = blend.blend_scatter if use_kernels else blend.blend_scatter_plain
    out_acc, w_acc = blend_windows(vol, staged.roi_size, staged.starts_padded,
                                   staged.mask, predictor, fn, imp,
                                   sw_batch_size)
    return finish_blend(out_acc, w_acc, staged.crops)


def volume_on(staged: StagedVolume, device, mode: str,
              sigma_scale: float):
    """(vol, imp): the staged volume on `device` (dequantized when it was
    quantized) and the importance map of `mode` there."""
    vol = staged.vol_dev.to(device)
    if staged.dequant is not None:
        vol = dequantize(vol, *staged.dequant)
    return vol, _importance_map_device(tuple(staged.roi_size), mode,
                                       float(sigma_scale), vol.device)


def blend_windows(vol: torch.Tensor, roi: Sequence[int], starts: np.ndarray,
                  mask: np.ndarray, predictor: Callable, fn: Callable,
                  imp: torch.Tensor, sw_batch_size: int):
    """(out_acc, w_acc): the f32 sums over the windows at `starts` (whose
    count divides by sw_batch_size) of predictor(window) * imp and of imp,
    each window weighted by its `mask` entry, accumulated by `fn` (the
    blend kernel's wrapper or its plain twin) over the padded (D, H, W)
    volume `vol`, one batch of windows at a time."""
    out_acc = w_acc = None
    for lo in range(0, starts.shape[0], sw_batch_size):
        bs = starts[lo:lo + sw_batch_size]
        wins = torch.stack([
            vol[s0:s0 + roi[0], s1:s1 + roi[1], s2:s2 + roi[2]]
            for s0, s1, s2 in bs.tolist()])
        preds = predictor(wins)
        if out_acc is None:
            out_acc = torch.zeros((*vol.shape[:3], preds.shape[-1]),
                                  dtype=torch.float32, device=vol.device)
            w_acc = torch.zeros((*vol.shape[:3], 1), dtype=torch.float32,
                                device=vol.device)
        fn(out_acc, w_acc, preds.contiguous(), bs,
           mask[lo:lo + sw_batch_size], imp)
    return out_acc, w_acc


def finish_blend(out_acc: torch.Tensor, w_acc: torch.Tensor,
                 crops) -> torch.Tensor:
    """out_acc / w_acc cropped to the volume, (D, H, W, O) -> (H, W, D, O)."""
    blended = out_acc / w_acc
    (a0, a1), (b0, b1), (c0, c1) = crops
    return blended[a0:a1, b0:b1, c0:c1, :].permute(1, 2, 0, 3)
