"""The kd = 1 ("2.5D") block forms of the flagship's levels 0-1: one encoder
ResidualUnit or one decoder attention block, as conv333 (at kd = 1) and
attgate launches.

Replaces vs_seg_tpu/ops/experimental/pallas_block2d.py:

  ru_block2d (_ru2d_kernel), down_0 / down_1:
    u0  = prelu(conv0(x) * bn0_scale + bn0_shift; alpha0)      Cin  -> Cout
    out = prelu(conv1(u0) * bn1_scale + bn1_shift; alpha1)     Cout -> Cout
          + (conv1x1(x, wr) + br)
  l2_block2d (_l2_2d_kernel), up_0 / up_1:
    a1     = relu(conv1(xa || xb) + b1)                        2C -> C
    att    = sigmoid(conv2(a1) + b2)                            C -> 1
    ga, gb = att * xa + xa, att * xb + xb
    out    = act(conv0(ga || gb) * bn_scale + bn_shift; alpha)
             + (conv1x1(ga || gb, wr) + br)                    2C -> Cout

every conv (3,3,1), stride 1, same padding. The i == 0 logit head is the
degenerate epilogue bn_scale=None, bn_shift=bias, alpha=None (identity),
Cout = 2. bn*_scale/bn*_shift are folded eval BatchNorm affines that already
include the conv bias (nn/blocks.py:folded_conv_affine).

The TPU kernels compute one H row tile of one plane end to end over banded
Toeplitz matrices at channels padded to cp in {16, 32}, recomputing the H
halo; here u0, a1, ga and gb round-trip through device memory in bf16
between launches: ru_block2d is two conv333 launches, l2_block2d conv333 +
attgate + conv333. The TPU eligibility rules (`can_block2d`, `pick_cp` <= 64,
W*cp % 128, H % 8, the VMEM budget of `pick_ht_2d`) are Mosaic tiling rules:
the port routes on semantics alone, and its kernels take ragged tiles.

Rounding, as the TPU kernels round: u0 and a1 to the working dtype before
the next conv; att in float32; the gated halves rounded before conv0.

What bounds it on the H100: at levels 0-1 (16-32 channels) every launch
moves more bytes than its MACs can hide: memory (the sizing is in PERF.md).

`ru_block2d` and `l2_block2d` run the kernels for CUDA tensors and their
`_plain` twins for CPU tensors, and count their CUDA calls in `.launches`.
Returns: ru_block2d the output; l2_block2d (out, att), att the
(N, D, H, W, 1) map, so the model's att_maps stay complete.
"""

from __future__ import annotations

import torch

from vs_seg_tpu_torch.ops.conv333 import conv333, conv333_plain
from vs_seg_tpu_torch.ops.l2block import attgate, attgate_plain, l2_chain
from vs_seg_tpu_torch.ops.rublock import ru_chain


def check_kd1(name: str, *ws: torch.Tensor) -> None:
    """Raise unless every conv weight is (3, 3, 1, Cin, Cout)."""
    for w in ws:
        if tuple(w.shape[:3]) != (3, 3, 1):
            raise ValueError(f"{name}: expected (3, 3, 1, Cin, Cout) conv "
                             f"weights, got {tuple(w.shape)}")


def ru_block2d_plain(x: torch.Tensor, **params) -> torch.Tensor:
    """PyTorch twin of ru_block2d (any device, any float dtype)."""
    check_kd1("ru_block2d", params["w0"], params["w1"])
    return ru_chain(conv333_plain, x, **params)


def ru_block2d(x: torch.Tensor, **params) -> torch.Tensor:
    """Fused eval (3,3,1) ResidualUnit. x: (N, D, H, W, Cin); params as
    ops/rublock.py:ru_chain, with w0 (3,3,1,Cin,Cout), w1 (3,3,1,Cout,Cout),
    wr (1,1,1,Cin,Cout); returns (N, D, H, W, Cout)."""
    if x.device.type == "cpu":
        return ru_block2d_plain(x, **params)
    if x.device.type != "cuda":
        raise ValueError(f"ru_block2d: unsupported device {x.device}")
    check_kd1("ru_block2d", params["w0"], params["w1"])
    out = ru_chain(conv333, x, **params)
    ru_block2d.launches += 1
    return out


ru_block2d.launches = 0


def l2_block2d_plain(xa: torch.Tensor, xb: torch.Tensor, **params):
    """PyTorch twin of l2_block2d; returns (out, att)."""
    check_kd1("l2_block2d", params["w1"], params["w2"], params["w0"])
    return l2_chain(conv333_plain, attgate_plain, xa, xb, **params)


def l2_block2d(xa: torch.Tensor, xb: torch.Tensor, **params):
    """Fused eval (3,3,1) decoder block. xa, xb: (N, D, H, W, C) pair halves;
    params as ops/l2block.py:l2_chain, with w1 (3,3,1,2C,C), w2
    (3,3,1,C,1), w0 (3,3,1,2C,Cout), wr (1,1,1,2C,Cout); for the i == 0
    logit head bn_scale=None, bn_shift=bias, alpha=None. Returns (out (N, D,
    H, W, Cout), att (N, D, H, W, 1))."""
    if xa.device.type == "cpu":
        return l2_block2d_plain(xa, xb, **params)
    if xa.device.type != "cuda":
        raise ValueError(f"l2_block2d: unsupported device {xa.device}")
    check_kd1("l2_block2d", params["w1"], params["w2"], params["w0"])
    out = l2_chain(conv333, attgate, xa, xb, **params)
    l2_block2d.launches += 1
    return out


l2_block2d.launches = 0
