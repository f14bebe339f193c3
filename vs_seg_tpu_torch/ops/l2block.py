"""One eval decoder attention block plus its ResidualUnit, as conv333 ->
attgate -> conv333 launches.

Replaces vs_seg_tpu/ops/pallas_l2block.py:l2_block (_l2block_kernel):

    a1       = relu(conv1(xa || xb) + b1)                      2C -> C
    att      = sigmoid(conv2(a1) + b2)                          C -> 1
    ga, gb   = att * xa + xa, att * xb + xb
    out      = prelu(conv0(ga || gb) * bn_scale + bn_shift; alpha)
               + (conv1x1(ga || gb, wr) + br)                  2C -> C

`||` is a pair standing for the channel concat; nothing is concatenated.
bn_scale/bn_shift fold the eval BatchNorm and unit0's conv bias. The TPU
kernel pipelines the planes through VMEM rings (its VS_L2TAP, VS_XCACHE and
VS_DMAPRE variants are schedules of this one computation); here a1, ga and gb
round-trip through device memory in bf16. The attention map is returned
too, so the model's att_maps stay complete; inference drops it.

`attgate` is the hand-written kernel of the middle stage (csrc/attgate.cu);
the convs are conv333 launches. `l2_block` and `attgate` run the kernels
for CUDA tensors and their `_plain` twins for CPU tensors, and count their
CUDA calls in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import (
    _check_act, _ptr, conv333, conv333_plain,
)


def attgate_plain(a1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  xa: torch.Tensor, xb: torch.Tensor):
    """PyTorch twin of attgate. a1, xa, xb (N, D, H, W, C); w2 (3,3,3,C,1)
    in the JAX (kh, kw, kd) order; b2 (1,). The C -> 1 conv, the sigmoid and
    the gate run in float32; returns (att (N, D, H, W, 1), ga, gb) in
    xa.dtype."""
    wt = w2.float().permute(4, 3, 2, 0, 1)
    z = F.conv3d(a1.float().permute(0, 4, 1, 2, 3), wt, b2.float(),
                 padding=1).permute(0, 2, 3, 4, 1)
    att = torch.sigmoid(z)
    dt = xa.dtype
    ga = (att * xa.float() + xa.float()).to(dt)
    gb = (att * xb.float() + xb.float()).to(dt)
    return att.to(dt), ga, gb


def _attgate_lib():
    lib = _build.load("attgate")
    fn = lib.attgate_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def attgate(a1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
            xa: torch.Tensor, xb: torch.Tensor):
    """Attention conv2 + sigmoid + gate; see attgate_plain."""
    if a1.device.type == "cpu":
        return attgate_plain(a1, w2, b2, xa, xb)
    if a1.device.type != "cuda":
        raise ValueError(f"attgate: unsupported device {a1.device}")
    shape = a1.shape[:4]
    _check_act((a1, xa, xb), "attgate", shape)
    c = int(a1.shape[-1])
    if xa.shape[-1] != c or xb.shape[-1] != c:
        raise ValueError(f"attgate: channel counts differ: a1 {c}, "
                         f"xa {xa.shape[-1]}, xb {xb.shape[-1]}")
    if tuple(w2.shape) != (3, 3, 3, c, 1) or b2.numel() != 1:
        raise ValueError(f"attgate: w2 {tuple(w2.shape)} / b2 "
                         f"{tuple(b2.shape)} do not match C = {c}")
    if (27 * c + 1) * 4 > 48 * 1024:
        raise ValueError(f"attgate: C = {c} exceeds the kernel's shared "
                         "memory bound (C <= 455)")
    dev = a1.device
    # (kh, kw, kd, C, 1) -> (kd, kh, kw, C) f32, tap-major as the kernel
    # reads it, then b2: one device buffer, so no host sync for the bias
    w2p = torch.cat([w2[..., 0].permute(2, 0, 1, 3).reshape(-1),
                     b2.reshape(-1)]).float().contiguous()
    ga = torch.empty_like(xa)
    gb = torch.empty_like(xb)
    att = torch.empty((*shape, 1), dtype=torch.bfloat16, device=dev)
    n, d, h, w = (int(s) for s in shape)
    lib = _attgate_lib()
    err = lib.attgate_launch(
        _ptr(a1), _ptr(w2p), _ptr(xa), _ptr(xb),
        _ptr(ga), _ptr(gb), _ptr(att), n, d, h, w, c, dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "attgate")
    attgate.launches += 1
    return att, ga, gb


attgate.launches = 0


def l2_block_plain(xa: torch.Tensor, xb: torch.Tensor, *, w1, b1, w2, b2, w0,
                   bn_scale, bn_shift, alpha, wr, br):
    """PyTorch twin of l2_block; returns (out, att)."""
    relu = torch.zeros(1, dtype=torch.float32, device=xa.device)
    a1 = conv333_plain((xa, xb), w1, None, b1, relu)
    att, ga, gb = attgate_plain(a1, w2, b2, xa, xb)
    out = conv333_plain((ga, gb), w0, bn_scale, bn_shift, alpha,
                        residual=((ga, gb), wr, br))
    return out, att


def l2_block(xa: torch.Tensor, xb: torch.Tensor, *, w1, b1, w2, b2, w0,
             bn_scale, bn_shift, alpha, wr, br):
    """Fused eval decoder block. xa, xb: (N, D, H, W, C) pair halves; w1 and
    w0 (3,3,3,2C,C), w2 (3,3,3,C,1), wr (1,1,1,2C,C). Returns (out (N, D, H,
    W, C), att (N, D, H, W, 1))."""
    if xa.device.type == "cpu":
        return l2_block_plain(xa, xb, w1=w1, b1=b1, w2=w2, b2=b2, w0=w0,
                              bn_scale=bn_scale, bn_shift=bn_shift,
                              alpha=alpha, wr=wr, br=br)
    if xa.device.type != "cuda":
        raise ValueError(f"l2_block: unsupported device {xa.device}")
    relu = torch.zeros(1, dtype=torch.float32, device=xa.device)
    a1 = conv333((xa, xb), w1, None, b1, relu)
    att, ga, gb = attgate(a1, w2, b2, xa, xb)
    out = conv333((ga, gb), w0, bn_scale, bn_shift, alpha,
                  residual=((ga, gb), wr, br))
    l2_block.launches += 1
    return out, att


l2_block.launches = 0
