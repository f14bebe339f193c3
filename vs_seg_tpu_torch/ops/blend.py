"""Gaussian-blend scatter-accumulate of one window batch into the volume.

Replaces vs_seg_tpu/ops/pallas_blend.py:pallas_blend_scatter. For each
window i in index order, in place on the f32 accumulators (D-first layout):

    out_acc[s_i : s_i + roi, :] += pred_i * (imp * mask_i)
    w_acc[s_i : s_i + roi, 0]   += imp * mask_i

This is the f32 order of vs_seg_tpu/infer/sliding_window.py:
_scatter_accumulate, which both versions here reproduce exactly.
`blend_scatter` runs the hand-written kernel (csrc/blend.cu) for CUDA
tensors and `blend_scatter_plain` for CPU tensors, and counts its CUDA calls
in `blend_scatter.launches`. The window starts and mask are host arrays:
the kernel wrapper takes the union box of the windows from them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import _ptr


def _host_windows(starts, mask, n: int):
    starts = np.asarray(starts, dtype=np.int64).reshape(-1, 3)
    mask = np.asarray(mask, dtype=np.float32).reshape(-1)
    if starts.shape[0] != n or mask.shape[0] != n:
        raise ValueError(f"blend: {n} predictions but {starts.shape[0]} "
                         f"starts and {mask.shape[0]} mask entries")
    return starts, mask


def blend_scatter_plain(out_acc: torch.Tensor, w_acc: torch.Tensor,
                        preds: torch.Tensor, starts, mask,
                        importance: torch.Tensor):
    """PyTorch twin of blend_scatter (any device); updates and returns
    (out_acc (D, H, W, O), w_acc (D, H, W, 1))."""
    n, rd, rh, rw = preds.shape[:4]
    starts, mask = _host_windows(starts, mask, n)
    mask_t = torch.as_tensor(mask, device=importance.device)
    imp = importance[None] * mask_t[:, None, None, None]
    for i in range(n):
        d0, h0, w0 = (int(v) for v in starts[i])
        sl = (slice(d0, d0 + rd), slice(h0, h0 + rh), slice(w0, w0 + rw))
        out_acc[sl] += preds[i].float() * imp[i][..., None]
        w_acc[sl] += imp[i][..., None]
    return out_acc, w_acc


def _lib():
    lib = _build.load("blend")
    fn = lib.blend_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def blend_scatter(out_acc: torch.Tensor, w_acc: torch.Tensor,
                  preds: torch.Tensor, starts, mask,
                  importance: torch.Tensor):
    """Fused in-place blend accumulation. out_acc (D, H, W, O) f32, w_acc
    (D, H, W, 1) f32, preds (N, RD, RH, RW, O) bf16 or f32, starts (N, 3)
    host ints (d, h, w), mask (N,) host floats, importance (RD, RH, RW) f32.
    Returns (out_acc, w_acc)."""
    dev = out_acc.device
    if dev.type == "cpu":
        return blend_scatter_plain(out_acc, w_acc, preds, starts, mask,
                                   importance)
    if dev.type != "cuda":
        raise ValueError(f"blend_scatter: unsupported device {dev}")
    n, rd, rh, rw, o = preds.shape
    D, H, W, oc = out_acc.shape
    for t, name in ((out_acc, "out_acc"), (w_acc, "w_acc"),
                    (preds, "preds"), (importance, "importance")):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"blend_scatter: {name} must be contiguous on "
                             f"{dev}")
    if (out_acc.dtype != torch.float32 or w_acc.dtype != torch.float32
            or importance.dtype != torch.float32
            or preds.dtype not in (torch.bfloat16, torch.float32)):
        raise TypeError("blend_scatter: f32 accumulators and importance, "
                        "bf16 or f32 predictions")
    if (oc != o or tuple(w_acc.shape) != (D, H, W, 1)
            or tuple(importance.shape) != (rd, rh, rw)):
        raise ValueError("blend_scatter: shapes disagree: out_acc "
                         f"{tuple(out_acc.shape)}, w_acc "
                         f"{tuple(w_acc.shape)}, preds {tuple(preds.shape)}, "
                         f"importance {tuple(importance.shape)}")
    if o > 8:
        raise ValueError(f"blend_scatter: kernel takes O <= 8, got {o}")
    starts, mask = _host_windows(starts, mask, n)
    roi = np.array([rd, rh, rw])
    if (starts < 0).any() or (starts + roi > np.array([D, H, W])).any():
        raise ValueError("blend_scatter: a window lies outside the volume")
    lo = starts.min(axis=0)
    hi = (starts + roi).max(axis=0)
    box = hi - lo
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    lib = _lib()
    err = lib.blend_launch(
        _ptr(out_acc), _ptr(w_acc), _ptr(preds),
        int(preds.dtype == torch.float32), _ptr(starts_d), _ptr(mask_d),
        _ptr(importance), n, D, H, W, o, rd, rh, rw,
        int(lo[0]), int(lo[1]), int(lo[2]), int(box[0]), int(box[1]),
        int(box[2]), dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "blend_scatter")
    blend_scatter.launches += 1
    return out_acc, w_acc


blend_scatter.launches = 0
