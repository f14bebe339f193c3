"""UNet2d5_spvPA — 6-level 2.5D residual U-Net with deep spatial-attention
supervision, mirroring vs_seg_tpu/models/unet2d5_spvpa.py.

  level i = 0..n-1 (channels c_i, stride s_i, kernel k_i, sample kernel sk_i):
    down_i        ResidualUnit(c_{i-1} -> c_i, `num_res_units` subunits)
    downsample_i  Convolution(c_i -> c_i, stride s_i, kernel sk_i)
    ... next level ...
    upsample_i    transpose Convolution(c_{i+1} -> c_i, stride s_i)
    (skip_i, up)  a pair standing for the channel concat
    upatt_i       AttentionBlock1(2 c_i) + gate
    up_i          ResidualUnit(2 c_i -> outc_i, 1 subunit, conv-only at top)
  bottom: bottom_att AttentionBlock1(c_{n-1}) + gate, ResidualUnit -> c_n

forward(x, use_kernels=True, train=False, generator=None) takes (N, D, H,
W, C) and returns (logits (N, D, H, W, out), att_maps), the maps coarsest
first, each (N, d, h, w, 1). Train or eval is the explicit `train` argument,
as in the JAX package; torch's module-level train()/eval() state is not
read. At train, BatchNorm uses batch statistics (and updates the running
ones), Dropout draws from `generator` (a torch.Generator on x's device,
required when dropout > 0), no l2block/rublock/headfold route is taken, and
every (3,3,3) stride-1 conv runs the hand-written backward of
ops/train_conv.py (25 conv sites in the flagship, pair halves counted
separately).

Eval dispatch to the hand-written kernels (ops/): the two-subunit (3,3,3)
encoder units go to ops/rublock.py from ResidualUnit; every (3,3,3) decoder
level i > 0 whose output has the skip's width goes to ops/l2block.py here,
as vs_seg_tpu's l2block_fusable/l2block_apply route it. With
use_kernels=False those sites run the kernels' plain PyTorch twins instead;
on CPU tensors both choices run the plain twins. The (3,3,1) levels run
plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vs_seg_tpu_torch.nn.blocks import (
    AttentionBlock1, Convolution, ResidualUnit, folded_conv_affine,
)
from vs_seg_tpu_torch.nn.layers import _triple
from vs_seg_tpu_torch.ops import l2block


class UNet2d5_spvPA(nn.Module):

    def __init__(self, in_channels: int = 1, out_channels: int = 2,
                 channels: Sequence[int] = (16, 32, 48, 64, 80, 96),
                 strides=((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2),
                          (2, 2, 2)),
                 kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3),
                               (3, 3, 3), (3, 3, 3)),
                 sample_kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3),
                                      (3, 3, 3), (3, 3, 3)),
                 num_res_units: int = 2, dropout: Optional[float] = 0.1,
                 attention_module: bool = True, dtype=torch.bfloat16,
                 device="cpu", generator: Optional[torch.Generator] = None):
        super().__init__()
        if not (len(channels) == len(kernel_sizes) == len(strides) + 1
                == len(sample_kernel_sizes) + 1):
            raise ValueError("channels/kernel_sizes need one entry more than "
                             "strides/sample_kernel_sizes")
        if num_res_units < 1:
            raise NotImplementedError(
                "num_res_units < 1 mirrors a latently broken reference branch")
        self.out_channels = out_channels
        self.channels = tuple(int(c) for c in channels)
        self.kernel_sizes = tuple(_triple(k) for k in kernel_sizes)
        self.attention_module = attention_module
        self.dtype = dtype
        n = len(strides)
        self.n_levels = n
        common = dict(norm="batch", dropout=dropout, dtype=dtype,
                      device=device, generator=generator)
        cin = in_channels
        for i in range(n):
            self.add_module(f"down_{i}", ResidualUnit(
                cin, channels[i], kernel_sizes[i], subunits=num_res_units,
                **common))
            self.add_module(f"downsample_{i}", Convolution(
                channels[i], channels[i], sample_kernel_sizes[i], strides[i],
                **common))
            cin = channels[i]
        if attention_module:
            self.bottom_att = AttentionBlock1(channels[n - 1], kernel_sizes[n],
                                              dtype=dtype, device=device,
                                              generator=generator)
        self.bottom = ResidualUnit(channels[n - 1], channels[n],
                                   kernel_sizes[n], subunits=num_res_units,
                                   **common)
        for i in reversed(range(n)):
            self.add_module(f"upsample_{i}", Convolution(
                channels[i + 1], channels[i], sample_kernel_sizes[i],
                strides[i], is_transposed=True, **common))
            if attention_module:
                self.add_module(f"upatt_{i}", AttentionBlock1(
                    2 * channels[i], kernel_sizes[i], dtype=dtype,
                    device=device, generator=generator))
            outc = out_channels if i == 0 else channels[i]
            self.add_module(f"up_{i}", ResidualUnit(
                2 * channels[i], outc, kernel_sizes[i], subunits=1,
                last_conv_only=(i == 0), **common))

    def forward(self, x, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None):
        n = self.n_levels
        kw = dict(use_kernels=use_kernels, train=train)
        skips = []
        for i in range(n):
            x = getattr(self, f"down_{i}")(x, generator=generator, **kw)
            skips.append(x)
            x = getattr(self, f"downsample_{i}")(x, generator=generator, **kw)
        att_maps = []
        if self.attention_module:
            att, x = self.bottom_att(x, gate=True, **kw)
            att_maps.append(att)
        x = self.bottom(x, generator=generator, **kw)
        for i in reversed(range(n)):
            x = getattr(self, f"upsample_{i}")(x, generator=generator, **kw)
            pair = (skips[i], x.to(skips[i].dtype))
            outc = self.out_channels if i == 0 else self.channels[i]
            if not train and self._l2block(pair, i, outc):
                x, att = self._l2block_apply(pair, i, use_kernels)
                att_maps.append(att)
                continue
            if self.attention_module:
                att, pair = getattr(self, f"upatt_{i}")(pair, gate=True, **kw)
                att_maps.append(att)
            x = getattr(self, f"up_{i}")(pair, generator=generator, **kw)
        return x, tuple(att_maps)

    def _l2block(self, pair, i: int, outc: int) -> bool:
        """The decoder sites ops/l2block.py takes: (3,3,3) levels i > 0 with
        attention whose output keeps the skip's width C."""
        xa, xb = pair
        return (self.attention_module and i > 0
                and self.kernel_sizes[i] == (3, 3, 3)
                and tuple(xa.shape) == tuple(xb.shape)
                and outc == int(xa.shape[-1]))

    def _l2block_apply(self, pair, i: int, use_kernels: bool):
        att_m = getattr(self, f"upatt_{i}")
        ru = getattr(self, f"up_{i}")
        inv, shift = folded_conv_affine(ru.unit0)
        fn = l2block.l2_block if use_kernels else l2block.l2_block_plain
        return fn(pair[0], pair[1],
                  w1=att_m.conv1.conv.kernel, b1=att_m.conv1.conv.bias,
                  w2=att_m.conv2.conv.kernel, b2=att_m.conv2.conv.bias,
                  w0=ru.unit0.conv.kernel, bn_scale=inv, bn_shift=shift,
                  alpha=ru.unit0.act.alpha, wr=ru.residual.kernel,
                  br=ru.residual.bias)
