"""The kd = 1 decoder tail: conv2 + sigmoid + gate + unit0 + 1x1 residual,
given the attention conv1 output a1, as attgate + conv333 (at kd = 1)
launches.

Replaces vs_seg_tpu/ops/experimental/pallas_tail2d.py:tail_block
(_tail2d_kernel), at up_0 (the logit head) and up_1:

    att    = sigmoid(conv2(a1) + b2)                            Ca -> 1
    ga, gb = att * xa + xa, att * xb + xb
    out    = act(conv0(ga || gb) * bn_scale + bn_shift; alpha)
             + (conv1x1(ga || gb, wr) + br)                    2Ch -> Cout

every conv (3,3,1), stride 1, same padding; the logit head is bn_scale=None,
bn_shift=bias, alpha=None. As in the JAX model the attention conv1 that
makes a1 (relu(conv1(xa || xb) + b1)) stays a library conv.

The TPU kernel tap-packs conv2 and, when 4*Cout <= cp, unit0 with its
residual into the lanes of a few MXU products, and double-buffers the slab
DMAs across grid steps: layout devices for the MXU. Here att is one attgate
launch (ga, gb and the map to device memory in bf16) and the unit0 conv with
its fused residual one conv333 launch. The TPU eligibility rules
(`can_tail2d`, `pick_cp`, W*cp % 128, H % 8) are Mosaic tiling rules: the
port routes on semantics alone.

Rounding, as the TPU kernel rounds: att in float32, the gated halves rounded
to the working dtype before conv0. (The TPU kernel also rounds conv2's three
per-row tap partials to the working dtype before summing them: within the
bf16 band.)

What bounds it on the H100: memory, as ops/block2d.py.

`tail_block` runs the kernels for CUDA tensors and `tail_block_plain` for
CPU tensors, and counts its CUDA calls in `tail_block.launches`. It returns
(out, att), att the (N, D, H, W, 1) map, so the model's att_maps stay
complete.
"""

from __future__ import annotations

import torch

from vs_seg_tpu_torch.ops.block2d import check_kd1
from vs_seg_tpu_torch.ops.conv333 import conv333, conv333_plain
from vs_seg_tpu_torch.ops.l2block import attgate, attgate_plain, gate_conv0


def tail_block_plain(a1: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                     **params):
    """PyTorch twin of tail_block; returns (out, att)."""
    check_kd1("tail_block", params["w2"], params["w0"])
    return gate_conv0(conv333_plain, attgate_plain, a1, xa, xb, **params)


def tail_block(a1: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
               **params):
    """Fused eval kd = 1 decoder tail. a1 (N, D, H, W, Ca) = relu(att
    conv1); xa, xb the pair halves (N, D, H, W, Ch); params as
    ops/l2block.py:gate_conv0: w2 (3,3,1,Ca,1), b2 (1,); w0 (3,3,1,2Ch,Cout)
    with the folded eval BatchNorm affine bn_scale/bn_shift (including the
    conv bias), or the logit head via bn_scale=None, bn_shift=bias,
    alpha=None; wr (1,1,1,2Ch,Cout), br (Cout,). Returns (out (N, D, H, W,
    Cout), att (N, D, H, W, 1))."""
    if a1.device.type == "cpu":
        return tail_block_plain(a1, xa, xb, **params)
    if a1.device.type != "cuda":
        raise ValueError(f"tail_block: unsupported device {a1.device}")
    check_kd1("tail_block", params["w2"], params["w0"])
    out = gate_conv0(conv333, attgate, a1, xa, xb, **params)
    tail_block.launches += 1
    return out


tail_block.launches = 0
