"""UNet: the vendored MONAI UNet of the reference's model zoo; the
counterpart of vs_seg_tpu/models/unet.py.

  down_i    ResidualUnit(c_{i-1} -> c_i, stride s_i, `num_res_units`
            subunits), or a strided Convolution when num_res_units == 0
  bottom    the same at stride 1, c_{n-1} -> c_n
  up_i      concat(skip_i, x) on the channel axis -> transpose
            Convolution(stride s_i) to c_{i-1} (out_channels at the top,
            conv-only there when num_res_units == 0)
  upres_i   ResidualUnit(1 subunit), conv-only at the top; only when
            num_res_units > 0

Every kernel is `kernel_size` (3: (3,3,3) even at (2,2,1) strides) and
`up_kernel_size` for the transpose convs; per-dimension stride tuples pass
through unchanged. forward(x, use_kernels=True, train=False,
generator=None, routes=Routes()) takes (N, D, H, W, C) and returns the
logits (N, D, H, W, out_channels); each call of a top-level child runs
under the span model.<child> (core/observability.py:span). The blocks
dispatch to the kernels as nn/blocks.py says: the bottom unit (stride 1,
channels changing) to ops/rublock.py, and under Routes(dsconv=True) every
(3,3,3) stride-(2,2,2) unit0 or down Convolution to ops/dsconv.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.core.observability import span
from vs_seg_tpu_torch.nn.blocks import Convolution, ResidualUnit
from vs_seg_tpu_torch.nn.layers import _triple


class UNet(nn.Module):

    def __init__(self, out_channels: int, channels: Sequence[int], strides,
                 kernel_size=3, up_kernel_size=3, num_res_units: int = 0,
                 dropout: Optional[float] = None, dtype=torch.bfloat16, *,
                 in_channels: int = 1, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(strides)
        if len(channels) != n + 1:
            raise ValueError("channels needs one entry more than strides")
        self.n_levels = n
        self.strides = tuple(strides)
        common = dict(norm="batch", dropout=dropout, dtype=dtype,
                      device=device, generator=generator)
        k, uk = _triple(kernel_size), _triple(up_kernel_size)

        def down_layer(cin, cout, stride):
            if num_res_units > 0:
                return ResidualUnit(cin, cout, k, _triple(stride),
                                    subunits=num_res_units, **common)
            return Convolution(cin, cout, k, _triple(stride), **common)

        cin = in_channels
        for i in range(n):
            self.add_module(f"down_{i}",
                            down_layer(cin, channels[i], strides[i]))
            cin = channels[i]
        self.bottom = down_layer(cin, channels[n], 1)
        x_ch = channels[n]
        for i in reversed(range(n)):
            top = i == 0
            outc = out_channels if top else channels[i - 1]
            self.add_module(f"up_{i}", Convolution(
                channels[i] + x_ch, outc, uk, _triple(strides[i]),
                conv_only=top and num_res_units == 0, is_transposed=True,
                **common))
            if num_res_units > 0:
                self.add_module(f"upres_{i}", ResidualUnit(
                    outc, outc, k, subunits=1, last_conv_only=top,
                    **common))
            x_ch = outc
        self.span_names = {name: f"model.{name}" for name in self._modules}

    def forward(self, x, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                routes: Routes = Routes()) -> torch.Tensor:
        kw = dict(use_kernels=use_kernels, train=train, generator=generator,
                  routes=routes)
        names = self.span_names

        def child(name: str, v):
            with span(names[name]):
                return getattr(self, name)(v, **kw)

        skips = []
        for i in range(self.n_levels):
            x = child(f"down_{i}", x)
            skips.append(x)
        x = child("bottom", x)
        for i in reversed(range(self.n_levels)):
            x = torch.cat([skips[i], x.to(skips[i].dtype)], dim=-1)
            x = child(f"up_{i}", x)
            if hasattr(self, f"upres_{i}"):
                x = child(f"upres_{i}", x)
        return x
