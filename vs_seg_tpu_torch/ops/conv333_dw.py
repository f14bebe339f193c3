"""Weight and bias gradients of a (3,3,3) stride-1 same-padded conv.

Replaces vs_seg_tpu/ops/experimental/pallas_train.py:conv333_dw together with
its dw_extract/db_extract read-out:

    dw[kh, kw, kd, ci, co] = sum_v x_pad[v + (kd-1, kh-1, kw-1), ci] * dy[v, co]
    db[co]                 = sum_v dy[v, co]

x (N, D, H, W, Cin) and dy (N, D, H, W, Cout) are bf16 on the kernel route;
dw (3, 3, 3, Cin, Cout) and db (Cout,) are float32, in the JAX (kh, kw, kd)
order. `conv333_dw` runs the hand-written kernel (csrc/conv333_dw.cu: wgmma
over a TMA ring that walks depth, split-K partials summed in split order in
the same launch, so the result is deterministic) for CUDA tensors and
`conv333_dw_plain` for CPU tensors, and counts its CUDA calls in
`conv333_dw.launches`. `plan` is the kernel's decomposition of a call,
cached per (shape, Cin, Cout, SMs).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import _check_act, _ptr

WORKSPACE_MAX = 64 << 20      # bytes of split-K partials at most
TH, TW = 8, 16                # the kernel's output tile (H, W)
SLAB_MAX = 64                 # input channels of a unit (wgmma M)
N_TILES = (8, 16, 32, 40, 48, 64)   # the N widths the kernel is built for
H100_SMS = 132


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


class Plan(NamedTuple):
    """The kernel's decomposition of one call. A unit is (kh, Cin slab,
    N tile, split); a split is a contiguous range of the `steps` (n, tile
    column, d) steps, columns of TH x TW voxels, d fastest."""
    cx: int          # channels of the staged x (Cin rounded up to 8)
    cdy: int         # channels of the staged dy (Cout rounded up to 8)
    cs: int          # input channels per slab
    nslab: int
    ntile: int       # N width
    nnt: int         # N tiles
    tiles_h: int
    tiles_w: int
    steps: int
    groups: int      # 3 (kh) * nslab * nnt
    nsplit: int
    units: int       # groups * nsplit
    grid: int        # blocks: one per SM at most, each loops over units
    ws_floats: int   # workspace: nsplit * (27 Cin Cout + Cout), 0 if 1 split


def _round8(c: int) -> int:
    return -(-c // 8) * 8


@functools.lru_cache(maxsize=256)
def plan(shape, cin: int, cout: int, sms: int = H100_SMS) -> Plan:
    """The launch plan of conv333_dw for x (*shape, cin), dy (*shape, cout)
    on a card of `sms` SMs (the kernel runs one block per SM). Slabs and N
    tiles are balanced; the splits fill the SMs once (as many as the units
    leave room for, at most one per step, the workspace at most
    WORKSPACE_MAX bytes); one split needs no workspace."""
    n, d, h, w = (int(s) for s in shape)
    cx, cdy = _round8(cin), _round8(cout)
    nslab = -(-cx // SLAB_MAX)
    cs = _round8(-(-cx // nslab))
    nnt = -(-cout // N_TILES[-1])
    per = -(-cout // nnt)
    ntile = next(t for t in N_TILES if t >= per)
    tiles_h, tiles_w = -(-h // TH), -(-w // TW)
    steps = n * tiles_h * tiles_w * d
    groups = 3 * nslab * nnt
    per_split = 27 * cin * cout + cout
    nsplit = max(1, min(steps, sms // groups,
                        WORKSPACE_MAX // (4 * per_split)))
    units = groups * nsplit
    return Plan(cx, cdy, cs, nslab, ntile, nnt, tiles_h, tiles_w, steps,
                groups, nsplit, units, min(units, sms),
                nsplit * per_split if nsplit > 1 else 0)


def split_ranges(p: Plan):
    """[(first step, end step)] of each split, in split order (as the
    kernel computes them)."""
    return [(p.steps * s // p.nsplit, p.steps * (s + 1) // p.nsplit)
            for s in range(p.nsplit)]


def pad_channels(t: torch.Tensor, c: int) -> torch.Tensor:
    """t with its last dim zero-padded to c, in a copy when it must change
    (or when its base is not 16-byte aligned, which the TMA needs)."""
    if t.shape[-1] == c and t.data_ptr() % 16 == 0:
        return t
    return F.pad(t, (0, c - t.shape[-1])).contiguous()


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 13 + [ctypes.c_void_p])


def _lib():
    lib = _build.load("conv333_dw")
    _build.bind(lib, "conv333_dw_launch", _ARGTYPES)
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_BARRIERS = {}


def _barrier(device: int, stream: int) -> torch.Tensor:
    """The grid barrier's two counters of a (device, stream): zero, and left
    zero by every launch that uses them."""
    bar = _BARRIERS.get((device, stream))
    if bar is None:
        bar = _BARRIERS[(device, stream)] = torch.zeros(
            2, dtype=torch.int32, device=torch.device("cuda", device))
    return bar


def conv333_dw(x: torch.Tensor, dy: torch.Tensor):
    """(dw, db) of a (3,3,3) stride-1 same-padded conv; see the module doc.
    CUDA tensors go to the kernel (contiguous NDHWC bf16, one device), CPU
    tensors to conv333_dw_plain."""
    if x.device.type == "cpu":
        return conv333_dw_plain(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv333_dw: unsupported device {x.device}")
    shape = tuple(x.shape[:4])
    _check_act((x, dy), "conv333_dw", shape)
    if x.device != dy.device:
        raise ValueError(f"conv333_dw: x on {x.device}, dy on {dy.device}")
    cin, cout = x.shape[-1], dy.shape[-1]
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    p = plan(shape, cin, cout, _sm_count(index))
    xs, dys = pad_channels(x, p.cx), pad_channels(dy, p.cdy)
    # dw and db in one allocation; the host's enqueue sets the time of the
    # small sites
    ndw = 27 * cin * cout
    out = torch.empty(ndw + cout, dtype=torch.float32, device=dev)
    dw, db = out[:ndw].view(3, 3, 3, cin, cout), out[ndw:]
    stream = torch._C._cuda_getCurrentRawStream(index)
    ws = bar = None
    if p.nsplit > 1:
        ws = torch.empty(p.ws_floats, dtype=torch.float32, device=dev)
        bar = _barrier(index, stream)
    lib = _lib()
    err = lib.conv333_dw_launch(
        _ptr(xs), p.cx, _ptr(dys), p.cdy, _ptr(ws), _ptr(bar), _ptr(dw),
        _ptr(db), *shape, cin, cout, p.cs, p.nslab, p.ntile, p.nnt,
        p.nsplit, p.grid, index, ctypes.c_void_p(stream))
    _build.check(lib, err, "conv333_dw")
    _build.count(conv333_dw)
    return dw, db


conv333_dw.launches = 0
