"""One eval decoder attention block plus its ResidualUnit, as three
launches: conv333, attgate's att-only mode, conv333's gated instance.

Replaces vs_seg_tpu/ops/pallas_l2block.py:l2_block (_l2block_kernel):

    a1       = relu(conv1(xa || xb) + b1)                      2C -> C
    att      = sigmoid(conv2(a1) + b2)                          C -> 1
    ga, gb   = att * xa + xa, att * xb + xb
    out      = prelu(conv0(ga || gb) * bn_scale + bn_shift; alpha)
               + (conv1x1(ga || gb, wr) + br)                  2C -> C

`||` is a pair standing for the channel concat; nothing is concatenated.
bn_scale/bn_shift fold the eval BatchNorm and unit0's conv bias. The TPU
kernel pipelines the planes through VMEM rings (its VS_L2TAP, VS_XCACHE and
VS_DMAPRE variants are schedules of this one computation). A ring of a1
planes for conv333's tile does not fit an H100 block's shared memory at
these widths (3 planes of 34 x 18 x 48 bf16 are 176 KB beside the conv's
own ~100 KB ring), so a1 round-trips through device memory in bf16; the
gated pair does not: `att_map` (csrc/attgate.cu in its att-only mode)
writes the unrounded f32 att, and conv0 runs as conv333's gated instance
(csrc/conv333.cu, G), which gates each staged halo of xa and xb in shared
memory, the same f32 fmaf and bf16 rounding as attgate's gate. The
attention map is returned too, so the model's att_maps stay complete;
inference drops it.

`l2_chain` is the parent design (conv333 -> attgate -> conv333, ga and gb in
device memory), kept as the twins' composition and as the chain the
kernel is timed against. `attgate` (the gating mode) stays the middle stage
of the chains that l2_block2d and tail_block run past their fused
kernels' widths (ops/block2d.py, ops/tail2d.py). `l2_block`, `att_map` and
`attgate` run the kernels for CUDA tensors and their `_plain` twins for CPU
tensors, and count their CUDA calls in `.launches`.
"""

from __future__ import annotations

import torch

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.att import (att_plain, fused_attention_gate_plain,
                                      launch_att_map, launch_attgate)
from vs_seg_tpu_torch.ops.conv333 import conv333, conv333_plain


def attgate_plain(a1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                  xa: torch.Tensor, xb: torch.Tensor):
    """PyTorch twin of attgate. a1 (N, D, H, W, Ca), xa, xb (N, D, H, W, C);
    w2 (3, 3, kd, Ca, 1) in the JAX (kh, kw, kd) order, kd in {1, 3}; b2
    (1,). The conv, the sigmoid and the gate run in float32; returns (att
    (N, D, H, W, 1), ga, gb) in xa.dtype."""
    att, (ga, gb) = fused_attention_gate_plain(a1, (xa, xb), w2, b2)
    return att, ga, gb


def attgate(a1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
            xa: torch.Tensor, xb: torch.Tensor):
    """Attention conv2 + sigmoid + gate of a pair (csrc/attgate.cu); see
    attgate_plain. The middle stage of l2_block's parent chain (l2_chain)
    and of the chains that l2_block2d and tail_block run at widths past
    their fused kernels (csrc/l2block2d.cu, csrc/tail2d.cu)."""
    if a1.device.type == "cpu":
        return attgate_plain(a1, w2, b2, xa, xb)
    if a1.device.type != "cuda":
        raise ValueError(f"attgate: unsupported device {a1.device}")
    att, (ga, gb) = launch_attgate(a1, (xa, xb), w2, b2, True, "attgate")
    _build.count(attgate)
    return att, ga, gb


attgate.launches = 0


def att_map_plain(a1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor):
    """PyTorch twin of att_map: (att32 (N, D, H, W) float32, att (N, D, H,
    W, 1) in a1.dtype), the map of attgate_plain."""
    att = att_plain(a1, w2, b2)
    return att[..., 0], att.to(a1.dtype)


def att_map(a1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor):
    """The attention map alone (csrc/attgate.cu, att-only mode): att32, the
    unrounded float32 map (N, D, H, W) that conv333's gate takes, and att,
    the compact bf16 map; see att_map_plain."""
    if a1.device.type == "cpu":
        return att_map_plain(a1, w2, b2)
    if a1.device.type != "cuda":
        raise ValueError(f"att_map: unsupported device {a1.device}")
    out = launch_att_map(a1, w2, b2, "att_map")
    _build.count(att_map)
    return out


att_map.launches = 0


def gate_conv0(conv, gate, a1: torch.Tensor, xa: torch.Tensor,
               xb: torch.Tensor, *, w2, b2, w0, bn_scale, bn_shift, alpha, wr,
               br):
    """The block's tail through `conv` and `gate` (the kernels or their
    plain twins): att, ga, gb = gate(a1, ...); out = conv0(ga || gb) +
    residual. Returns (out, att)."""
    att, ga, gb = gate(a1, w2, b2, xa, xb)
    out = conv((ga, gb), w0, bn_scale, bn_shift, alpha,
               residual=((ga, gb), wr, br))
    return out, att


def l2_chain(conv, gate, xa: torch.Tensor, xb: torch.Tensor, *, w1, b1,
             **params):
    """The whole block: a1 = relu(conv1(xa || xb) + b1), then gate_conv0.
    Any kd of the (3,3,kd) weights."""
    relu = torch.zeros(1, dtype=torch.float32, device=xa.device)
    a1 = conv((xa, xb), w1, None, b1, relu)
    return gate_conv0(conv, gate, a1, xa, xb, **params)


def l2_gated(conv, amap, xa: torch.Tensor, xb: torch.Tensor, *, w1, b1, w2,
             b2, w0, bn_scale, bn_shift, alpha, wr, br):
    """The block through `conv` and `amap` (the kernels or their plain
    twins): a1 = relu(conv1(xa || xb) + b1); att32, att = amap(a1); out =
    conv0 + residual, both on xa || xb gated by att32 inside `conv`.
    Returns (out, att)."""
    relu = torch.zeros(1, dtype=torch.float32, device=xa.device)
    a1 = conv((xa, xb), w1, None, b1, relu)
    att32, att = amap(a1, w2, b2)
    out = conv((xa, xb), w0, bn_scale, bn_shift, alpha,
               residual=((xa, xb), wr, br), gate=att32)
    return out, att


def l2_block_plain(xa: torch.Tensor, xb: torch.Tensor, **params):
    """PyTorch twin of l2_block; returns (out, att)."""
    return l2_chain(conv333_plain, attgate_plain, xa, xb, **params)


def l2_block(xa: torch.Tensor, xb: torch.Tensor, **params):
    """Fused eval decoder block. xa, xb: (N, D, H, W, C) pair halves; params
    (the keywords of l2_gated): w1 and w0 (3,3,3,2C,C), w2 (3,3,3,C,1), wr
    (1,1,1,2C,C), b1, b2, bn_scale, bn_shift, alpha, br. Returns (out (N,
    D, H, W, C), att (N, D, H, W, 1)). On CUDA tensors: conv333, att_map and
    conv333's gated instance, one launch each, with no gated pair in
    device memory."""
    if xa.device.type == "cpu":
        return l2_block_plain(xa, xb, **params)
    if xa.device.type != "cuda":
        raise ValueError(f"l2_block: unsupported device {xa.device}")
    out = l2_gated(conv333, att_map, xa, xb, **params)
    _build.count(l2_block)
    return out


l2_block.launches = 0
