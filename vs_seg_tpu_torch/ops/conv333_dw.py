"""Weight and bias gradients of a (3,3,3) stride-1 same-padded conv.

Replaces vs_seg_tpu/ops/experimental/pallas_train.py:conv333_dw together with
its dw_extract/db_extract read-out:

    dw[kh, kw, kd, ci, co] = sum_v x_pad[v + (kd-1, kh-1, kw-1), ci] * dy[v, co]
    db[co]                 = sum_v dy[v, co]

x (N, D, H, W, Cin) and dy (N, D, H, W, Cout) are bf16 on the kernel route;
dw (3, 3, 3, Cin, Cout) and db (Cout,) are float32, in the JAX (kh, kw, kd)
order. `conv333_dw` runs the hand-written kernel (csrc/conv333_dw.cu: split-K
partials in a workspace, then a fixed-order reduction, so the result is
deterministic) for CUDA tensors and `conv333_dw_plain` for CPU tensors, and
counts its CUDA calls in `conv333_dw.launches`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import _check_act, _ptr, _tiles

WORKSPACE_MAX = 64 << 20      # bytes of split-K partials (csrc header)
TARGET_BLOCKS = 8 * 132       # about 8 waves of one block per H100 SM
TH, TW, KC = 8, 16, 16        # the kernel's voxel tile and Cin chunk


def conv333_dw_plain(x: torch.Tensor, dy: torch.Tensor):
    """PyTorch twin (any device): float32 arithmetic on the given operands
    (for bf16 inputs, the bf16-rounded values), one (Cin x V) @ (V x Cout)
    product per tap. Returns (dw (3, 3, 3, Cin, Cout), db (Cout,)) f32."""
    xf = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    dyf = dy.float()
    _, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    dym = dyf.reshape(-1, cout)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32,
                     device=x.device)
    for kh in range(3):
        for kw in range(3):
            for kd in range(3):
                tap = xf[:, kd:kd + d, kh:kh + h, kw:kw + w, :]
                dw[kh, kw, kd] = tap.reshape(-1, cin).t() @ dym
    return dw, dym.sum(0)


def _lib():
    lib = _build.load("conv333_dw")
    fn = lib.conv333_dw_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def n_splits(shape, cin: int, cout: int) -> int:
    """Split-K factor: enough blocks for ~8 waves, at most one split per
    voxel tile, and a workspace of at most WORKSPACE_MAX bytes."""
    n, d, h, w = shape
    nfrag, cop = _tiles(cout)
    cip = -(-cin // KC) * KC
    ny = (cip // KC) * (cop // (nfrag * 16))
    ntiles = n * d * -(-h // TH) * -(-w // TW)
    per_split = (27 * cip + 1) * cop * 4
    return max(1, min(ntiles, -(-TARGET_BLOCKS // ny),
                      WORKSPACE_MAX // per_split))


def conv333_dw(x: torch.Tensor, dy: torch.Tensor):
    """(dw, db) of a (3,3,3) stride-1 same-padded conv; see the module doc.
    CUDA tensors go to the kernel (contiguous NDHWC bf16, one device), CPU
    tensors to conv333_dw_plain."""
    if x.device.type == "cpu":
        return conv333_dw_plain(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv333_dw: unsupported device {x.device}")
    shape = tuple(int(s) for s in x.shape[:4])
    _check_act((x, dy), "conv333_dw", shape)
    if x.device != dy.device:
        raise ValueError(f"conv333_dw: x on {x.device}, dy on {dy.device}")
    cin, cout = int(x.shape[-1]), int(dy.shape[-1])
    nfrag, cop = _tiles(cout)
    cip = -(-cin // KC) * KC
    nsplit = n_splits(shape, cin, cout)
    dev = x.device
    ws = torch.empty(nsplit * 27 * cip * cop, dtype=torch.float32,
                     device=dev)
    dbws = torch.empty(nsplit * cop, dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=dev)
    db = torch.empty((cout,), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.conv333_dw_launch(
        _ptr(x), _ptr(dy), _ptr(ws), _ptr(dbws), _ptr(dw), _ptr(db),
        *shape, cin, cout, nfrag, cop, nsplit,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "conv333_dw")
    conv333_dw.launches += 1
    return dw, db


conv333_dw.launches = 0
