"""One eval encoder ResidualUnit (2 subunits, (3,3,3), Cin != Cout), as two
conv333 launches.

Replaces vs_seg_tpu/ops/pallas_rublock.py:ru_block (_rublock_kernel):

    u0  = prelu(conv0(x) * bn0_scale + bn0_shift; alpha0)      Cin  -> Cout
    out = prelu(conv1(u0) * bn1_scale + bn1_shift; alpha1)     Cout -> Cout
          + (conv1x1(x, wr) + br)

bn*_scale/bn*_shift are the folded eval BatchNorm affines that already
include each conv's bias (nn/blocks.py:folded_conv_affine). The TPU kernel
keeps u0 in VMEM depth-plane rings; here u0 round-trips through device
memory in bf16 between the two launches, and the 1x1 residual is fused into
the second launch's epilogue (csrc/conv333.cu), after the activation.
On the H100 each launch is bounded as conv333 is (see csrc/conv333.cu).

`ru_block` runs the kernels for CUDA tensors and `ru_block_plain` for CPU
tensors, and counts its CUDA calls in `ru_block.launches`.
"""

from __future__ import annotations

import torch

from vs_seg_tpu_torch.ops.conv333 import conv333, conv333_plain


def ru_chain(conv, x: torch.Tensor, *, w0, bn0_scale, bn0_shift, alpha0, w1,
             bn1_scale, bn1_shift, alpha1, wr, br) -> torch.Tensor:
    """The unit through `conv` (conv333 or conv333_plain), for (3,3,kd)
    weights of either kd: u0 = conv0(x); out = conv1(u0) + residual."""
    u0 = conv(x, w0, bn0_scale, bn0_shift, alpha0)
    return conv(u0, w1, bn1_scale, bn1_shift, alpha1, residual=(x, wr, br))


def ru_block_plain(x: torch.Tensor, **params) -> torch.Tensor:
    """PyTorch twin of ru_block (any device, any float dtype)."""
    return ru_chain(conv333_plain, x, **params)


def ru_block(x: torch.Tensor, **params) -> torch.Tensor:
    """Fused eval ResidualUnit. x: (N, D, H, W, Cin); params (ru_chain's
    keywords): w0 (3,3,3,Cin,Cout), w1 (3,3,3,Cout,Cout), wr
    (1,1,1,Cin,Cout), the folded affines and PReLU slopes; returns (N, D, H,
    W, Cout)."""
    if x.device.type == "cpu":
        return ru_block_plain(x, **params)
    if x.device.type != "cuda":
        raise ValueError(f"ru_block: unsupported device {x.device}")
    out = ru_chain(conv333, x, **params)
    ru_block.launches += 1
    return out


ru_block.launches = 0
