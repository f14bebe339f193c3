"""UNet2d5: the flagship without its attention module, returning the logits
alone; the counterpart of vs_seg_tpu/models/unet2d5.py.

It holds UNet2d5_spvPA(attention_module=False) as the submodule `net`, so
its parameter names carry the `net.` prefix that JAX's `name="net"` gives
them; its spans are `net`'s, model.<child> without the prefix. Without
attention no decoder block route applies (UNet2d5_spvPA._block_route):
the decoder is the plain pair chain with the up_0 headfold, while the
encoder units still go to ops/rublock.py and the blend to ops/blend.py.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.models.unet2d5_spvpa import UNet2d5_spvPA


class UNet2d5(nn.Module):

    def __init__(self, in_channels: int = 1, out_channels: int = 2,
                 channels: Sequence[int] = (16, 32, 48, 64, 80, 96),
                 strides=((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2),
                          (2, 2, 2)),
                 kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3),
                               (3, 3, 3), (3, 3, 3)),
                 sample_kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3),
                                      (3, 3, 3), (3, 3, 3)),
                 num_res_units: int = 2, dropout: Optional[float] = 0.1,
                 dtype=torch.bfloat16, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = UNet2d5_spvPA(
            in_channels, out_channels, channels, strides, kernel_sizes,
            sample_kernel_sizes, num_res_units, dropout,
            attention_module=False, dtype=dtype, device=device,
            generator=generator)

    def forward(self, x, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                routes: Routes = Routes()) -> torch.Tensor:
        logits, _ = self.net(x, use_kernels, train, generator, routes)
        return logits
