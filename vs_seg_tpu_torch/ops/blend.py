"""Gaussian-blend scatter-accumulate of one window batch into the volume.

Replaces vs_seg_tpu/ops/pallas_blend.py:pallas_blend_scatter. For each
window i in index order, in place on the f32 accumulators (D-first layout):

    out_acc[s_i : s_i + roi, :] += pred_i * (imp * mask_i)
    w_acc[s_i : s_i + roi, 0]   += imp * mask_i

This is the f32 order of vs_seg_tpu/infer/sliding_window.py:
_scatter_accumulate, which both versions here reproduce exactly.
`blend_scatter` runs the hand-written kernel (csrc/blend.cu) for CUDA
tensors and `blend_scatter_plain` for CPU tensors. The window starts and
mask are host arrays and travel as kernel arguments: each launch takes a
table of at most WMAX windows by value, so a call makes no host-to-device
copy and can be captured in a CUDA graph. `plan` cuts the windows into
launches of at most WMAX, in index order (each voxel's sum keeps the
reference's order), takes each launch's box as the union of its windows
and its plane order's step as the d gap between them, and picks the
kernel's instance: v4 (4 voxels a thread on 16-byte accesses) where O = 2,
W, RW and every w-start are multiples of 4 and the tensors are 16-byte
aligned, else v1. `blend_scatter.launches` counts launches,
`blend_scatter.instances` the launches of each instance.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from vs_seg_tpu_torch.ops import _build

WMAX = 8    # windows one launch takes (csrc/blend.cu:WMAX)


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


class Chunk(NamedTuple):
    lo: int                        # first window of the launch
    hi: int                        # one past its last
    box_lo: Tuple[int, int, int]   # (d, h, w) corner of the windows' union
    box: Tuple[int, int, int]      # its size
    dstep: int                     # the kernel's plane order (csrc/blend.cu)


class Plan(NamedTuple):
    instance: str                  # "v4" or "v1"
    chunks: Tuple[Chunk, ...]


def plan(out_shape, roi, starts, aligned: bool = True) -> Plan:
    """The launches of one blend over accumulators of `out_shape` (D, H, W,
    O) from windows of `roi` (RD, RH, RW) at `starts` (N, 3) host ints:
    chunks of at most WMAX windows in index order, each with the union box
    of its windows and the smallest gap between their distinct d starts (1
    where there is none), and the instance every chunk runs. `aligned`:
    every tensor starts on a 16-byte boundary."""
    return _plan(tuple(int(v) for v in out_shape), tuple(int(v) for v in roi),
                 np.ascontiguousarray(starts, dtype=np.int32).tobytes(),
                 bool(aligned))


@functools.lru_cache(maxsize=64)
def _plan(out_shape, roi, starts: bytes, aligned: bool) -> Plan:
    _, _, W, o = out_shape
    rows = np.frombuffer(starts, dtype=np.int32).reshape(-1, 3).tolist()
    v4 = (o == 2 and W % 4 == 0 and roi[2] % 4 == 0 and aligned
          and all(r[2] % 4 == 0 for r in rows))
    chunks = []
    for lo in range(0, len(rows), WMAX):
        st = rows[lo:lo + WMAX]
        b0 = tuple(min(c) for c in zip(*st))
        b1 = tuple(max(c) + r for c, r in zip(zip(*st), roi))
        ds = sorted({r[0] for r in st})
        chunks.append(Chunk(lo, lo + len(st), b0,
                            tuple(b - a for a, b in zip(b0, b1)),
                            min((b - a for a, b in zip(ds, ds[1:])),
                                default=1)))
    return Plan("v4" if v4 else "v1", tuple(chunks))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set blend_launch's argument types on a library built from
    csrc/blend.cu (or a source with its C interface)."""
    if lib.blend_launch.argtypes is None and lib.blend_wmax() != WMAX:
        raise RuntimeError(f"blend: the library takes {lib.blend_wmax()}"
                           f" windows a launch, the wrapper {WMAX}")
    _build.bind(lib, "blend_launch",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16
                + [ctypes.c_void_p])
    return lib


def _lib():
    return bind(_build.load("blend"))


def launch(lib: ctypes.CDLL, out_acc: torch.Tensor, w_acc: torch.Tensor,
           preds: torch.Tensor, starts: np.ndarray, mask: np.ndarray,
           importance: torch.Tensor) -> Plan:
    """Launch the kernel of `lib` over every chunk of `plan` on the current
    stream (tensors as blend_scatter's, already checked; starts (N, 3) and
    mask (N,) host arrays) and count the launches. Returns the plan."""
    n, rd, rh, rw, o = preds.shape
    D, H, W, _ = out_acc.shape
    ptrs = [t.data_ptr() for t in (out_acc, w_acc, preds, importance)]
    st = np.ascontiguousarray(starts, dtype=np.int32).tobytes()
    mk = np.ascontiguousarray(mask, dtype=np.float32).tobytes()
    p = _plan((D, H, W, o), (rd, rh, rw), st,
              all(v % 16 == 0 for v in ptrs))
    for c in p.chunks:
        if min(c.box_lo) < 0 or any(
                a + b > v for a, b, v in zip(c.box_lo, c.box, (D, H, W))):
            raise ValueError("blend_scatter: a window lies outside the "
                             "volume")
    bind(lib)
    dev = out_acc.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    win_bytes = preds[0].numel() * preds.element_size()
    for c in p.chunks:
        err = lib.blend_launch(
            ptrs[0], ptrs[1], ptrs[2] + c.lo * win_bytes,
            int(preds.dtype == torch.float32), int(p.instance == "v4"),
            st[12 * c.lo:12 * c.hi], mk[4 * c.lo:4 * c.hi], ptrs[3],
            c.hi - c.lo, D, H, W, o, rd, rh, rw, *c.box_lo, *c.box, c.dstep,
            dev.index, stream)
        _build.check(lib, err, "blend_scatter")
        _build.count(blend_scatter)
        _build.count(blend_scatter, "instances", p.instance)
    return p


def blend_scatter(out_acc: torch.Tensor, w_acc: torch.Tensor,
                  preds: torch.Tensor, starts, mask,
                  importance: torch.Tensor):
    """Fused in-place blend accumulation. out_acc (D, H, W, O) f32, w_acc
    (D, H, W, 1) f32, preds (N, RD, RH, RW, O) bf16 or f32, starts (N, 3)
    host ints (d, h, w), mask (N,) host floats, importance (RD, RH, RW) f32.
    Returns (out_acc, w_acc). On CUDA tensors the starts and mask go into
    the kernel's arguments: a call captured in a CUDA graph replays with the
    starts and mask it was captured with (the sliding window's are fixed
    per ROI and volume shape)."""
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
    launch(_lib(), out_acc, w_acc, preds, starts, mask, importance)
    return out_acc, w_acc


blend_scatter.launches = 0
blend_scatter.instances = {"v4": 0, "v1": 0}
