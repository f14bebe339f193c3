"""Fused attention tail: conv2 (Ca -> 1, (3,3,kd), kd in {1, 3}) + sigmoid +
residual gate on one or two inputs, in one pass (csrc/attgate.cu).

Replaces vs_seg_tpu/ops/experimental/pallas_att.py:fused_attention_gate:

    att  = sigmoid(conv2(a1) + b2)                        Ca -> 1
    outs = [att * x + x for x in xs]                      1-2 inputs

The TPU kernel lane-packs (W, C) rows, reduces the conv per W group with
rolls and can emit the map broadcast over the channel lanes ("wide"); its
only caller keeps `att[..., :1]`. Here the map is compact, (N, D, H, W, 1),
or None with att_out="none". The TPU kernel's preconditions (W*Cm % 128,
H % 8, all xs with a1's channel count) are Mosaic tiling rules: the port
routes on semantics alone, and the wrapper takes any shape (Ca <= 256).

`launch_attgate` is the launch shared by this module's wrapper and by
ops/l2block.py:attgate (the middle stage of the chains that l2_block2d and
tail_block run past their fused kernels' widths), which count their
launches apart; `launch_att_map` is the kernel's att-only mode, which gates
nothing and writes the unrounded f32 map beside the compact one
(ops/l2block.py:att_map, whose map gates l2_block's conv0 in conv333's
gated instance). Numerics: the conv sums
in float32 on the tensor cores with each weight as two bf16 terms (hi +
lo, about 16 bits), the sigmoid and the gate run in float32 on the
unrounded att; each output is rounded to the working dtype once. (The
TPU kernel rounds att to the working dtype before the gate: a difference
of one bf16 ulp of att.)

What bounds it on the H100: memory (see csrc/attgate.cu). The kernel
stages a1 by TMA and reduces it in 16-channel tensor-core chunks, so
`launch_attgate` pads a1 with zero channels to a multiple of 16 in a copy
(and w2 with zero taps, `pack_w2`) where Ca is not one or a1's base is not
16-byte aligned; Ca may be at most 256.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import _check_act, _ptr

ATT_OUT = ("compact", "none")
# a1's channels after padding to a multiple of 16: one TMA box row
MAX_CA = 256


def _kd(w2: torch.Tensor) -> int:
    kd = int(w2.shape[2])
    if tuple(w2.shape[:2]) != (3, 3) or kd not in (1, 3) or w2.shape[4] != 1:
        raise ValueError(f"attention conv2 weight {tuple(w2.shape)}: expected "
                         "(3, 3, kd, Ca, 1) with kd in (1, 3)")
    return kd


def att_plain(a1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """sigmoid(conv3d(a1, w2) + b2) in float32, (N, D, H, W, 1): the map of
    the kernel's twins. a1 (N, D, H, W, Ca); w2 (3, 3, kd, Ca, 1) in the JAX
    (kh, kw, kd) order; b2 (1,)."""
    kd = _kd(w2)
    wt = w2.float().permute(4, 3, 2, 0, 1)
    z = F.conv3d(a1.float().permute(0, 4, 1, 2, 3), wt, b2.float(),
                 padding=(kd // 2, 1, 1)).permute(0, 2, 3, 4, 1)
    return torch.sigmoid(z)


def fused_attention_gate_plain(a1: torch.Tensor, xs: Sequence[torch.Tensor],
                               w2: torch.Tensor, b2: torch.Tensor, *,
                               att_out: str = "compact"):
    """PyTorch twin of fused_attention_gate. a1 (N, D, H, W, Ca); xs 1-2
    tensors (N, D, H, W, Cx); w2 (3, 3, kd, Ca, 1) in the JAX (kh, kw, kd)
    order; b2 (1,). Returns (att (N, D, H, W, 1) in xs[0].dtype, or None for
    att_out="none"; tuple of gated xs)."""
    if att_out not in ATT_OUT:
        raise ValueError(f"att_out must be one of {ATT_OUT}, got {att_out!r}")
    att = att_plain(a1, w2, b2)
    gated = tuple((att * x.float() + x.float()).to(x.dtype) for x in xs)
    dt = xs[0].dtype
    return (att.to(dt) if att_out == "compact" else None), gated


def pad_channels(t: torch.Tensor, c: int) -> torch.Tensor:
    """t (..., C) zero-padded to c >= C channels, in a contiguous copy."""
    return F.pad(t, (0, c - int(t.shape[-1]))).contiguous()


def pack_w2(w2: torch.Tensor, b2: torch.Tensor, ca: int) -> torch.Tensor:
    """w2 (kh, kw, kd, Ca, 1) and b2 (1,) as the kernel reads them: f32
    (kd * 9 * ca + 1), the taps (kd, kh, kw)-major with Ca zero-padded to
    ca channels, then b2. One buffer on w2's device, so the bias needs no
    host sync."""
    taps = pad_channels(w2[..., 0].permute(2, 0, 1, 3).float(), ca)
    return torch.cat([taps.reshape(-1),
                      b2.reshape(-1).to(taps.device, torch.float32)])


def _attgate_lib():
    lib = _build.load("attgate")
    _build.bind(lib, "attgate_launch",
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                + [ctypes.c_void_p])
    return lib


def _prepare(a1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
             name: str):
    """a1 and w2 as the kernel takes them: (a1 padded, packed w2 + b2)."""
    ca = int(a1.shape[-1])
    _kd(w2)
    if w2.shape[3] != ca or b2.numel() != 1:
        raise ValueError(f"{name}: w2 {tuple(w2.shape)} / b2 "
                         f"{tuple(b2.shape)} do not match Ca = {ca}")
    # the kernel stages a1 by TMA (one box of Ca channels, at most 256, a
    # 16-byte aligned base) and reduces it in 16-channel MMA chunks
    ca16 = -(-ca // 16) * 16
    if ca16 > MAX_CA:
        raise ValueError(f"{name}: Ca = {ca} exceeds the kernel's bound of "
                         f"{MAX_CA} channels")
    dev = a1.device
    if ca16 != ca or a1.data_ptr() % 16:
        a1 = pad_channels(a1, ca16)
    return a1, pack_w2(w2.to(dev), b2.to(dev), ca16)


def _launch(a1, w2p, xs, gated, att, att32, cx: int, kd: int, name: str):
    """One csrc/attgate.cu launch: xs and gated 0-2 tensors each."""
    n, d, h, w = (int(s) for s in a1.shape[:4])
    dev = a1.device
    xa, xb = (*xs, None, None)[:2]
    ga, gb = (*gated, None, None)[:2]
    lib = _attgate_lib()
    err = lib.attgate_launch(
        _ptr(a1), _ptr(w2p), _ptr(xa), _ptr(xb), _ptr(ga), _ptr(gb),
        _ptr(att), _ptr(att32), n, d, h, w, int(a1.shape[-1]), cx, kd,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, name)


def launch_attgate(a1: torch.Tensor, xs: Sequence[torch.Tensor],
                   w2: torch.Tensor, b2: torch.Tensor, want_att: bool,
                   name: str) -> Tuple[Optional[torch.Tensor], tuple]:
    """Check the CUDA inputs and launch csrc/attgate.cu once."""
    xs = tuple(xs)
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"{name}: one or two gated inputs, got {len(xs)}")
    shape = a1.shape[:4]
    _check_act((a1, *xs), name, shape)
    cx = int(xs[0].shape[-1])
    if any(int(x.shape[-1]) != cx for x in xs):
        raise ValueError(f"{name}: gated inputs differ in channels: "
                         f"{[int(x.shape[-1]) for x in xs]}")
    a1p, w2p = _prepare(a1, w2, b2, name)
    gated = tuple(torch.empty_like(x) for x in xs)
    att = (torch.empty((*shape, 1), dtype=torch.bfloat16, device=a1.device)
           if want_att else None)
    _launch(a1p, w2p, xs, gated, att, None, cx, _kd(w2), name)
    return att, gated


def launch_att_map(a1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """csrc/attgate.cu once in its att-only mode: (att32, att), att32 the
    unrounded float32 map (N, D, H, W), att the compact (N, D, H, W, 1)
    bf16 map."""
    shape = a1.shape[:4]
    _check_act((a1,), name, shape)
    a1p, w2p = _prepare(a1, w2, b2, name)
    att32 = torch.empty(shape, dtype=torch.float32, device=a1.device)
    att = torch.empty((*shape, 1), dtype=torch.bfloat16, device=a1.device)
    _launch(a1p, w2p, (), (), att, att32, 0, _kd(w2), name)
    return att32, att


def fused_attention_gate(a1: torch.Tensor, xs: Sequence[torch.Tensor],
                         w2: torch.Tensor, b2: torch.Tensor, *,
                         att_out: str = "compact"):
    """att = sigmoid(conv3d(a1, w2) + b2); outs = [att * x + x for x in xs];
    see fused_attention_gate_plain. CUDA tensors go to the hand-written
    kernel (bf16, contiguous NDHWC), CPU tensors to the plain twin."""
    if att_out not in ATT_OUT:
        raise ValueError(f"att_out must be one of {ATT_OUT}, got {att_out!r}")
    if a1.device.type == "cpu":
        return fused_attention_gate_plain(a1, xs, w2, b2, att_out=att_out)
    if a1.device.type != "cuda":
        raise ValueError(f"fused_attention_gate: unsupported device "
                         f"{a1.device}")
    out = launch_attgate(a1, xs, w2, b2, att_out == "compact",
                         "fused_attention_gate")
    _build.count(fused_attention_gate)
    return out


fused_attention_gate.launches = 0
