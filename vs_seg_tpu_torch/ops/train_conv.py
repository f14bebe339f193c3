"""Train-mode (3,3,3) stride-1 same-padded conv + bias with a hand-written
backward: the counterpart of vs_seg_tpu/ops/experimental/pallas_train.py:
conv333_train (its custom_vjp `_train_conv_fn`).

    forward   y  = conv(x, w) + b, in x.dtype (the library conv: JAX runs it
                   as XLA's plain conv, outside any Pallas kernel)
    backward  dx = conv333(dy, flip(w)^T)   the adjoint of a stride-1 same-pad
                   odd conv is itself one, with the spatially flipped,
                   io-transposed weight (ops/conv333.py, no epilogue)
              dw, db = conv333_dw(x, dy)    float32 (ops/conv333_dw.py)

w and b are the float32 parameters, cast inside, so autograd hands back f32
dw/db without a bf16 rounding. On CPU tensors the same Function runs the
kernels' plain twins; `use_kernels=False` runs plain autograd through the
library conv instead (the all-plain path).
"""

from __future__ import annotations

from typing import Optional

import torch

from vs_seg_tpu_torch.ops.conv333 import conv333
from vs_seg_tpu_torch.ops.conv333_dw import conv333_dw


def _forward(x, w, b):
    from vs_seg_tpu_torch.nn.layers import conv3d
    return conv3d(x, w, b, (1, 1, 1), (1, 1, 1))


class Conv333Train(torch.autograd.Function):
    """conv + bias with the conv333 dgrad and conv333_dw wgrad backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return _forward(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        # autograd may hand over an expanded or strided dy; the kernels take
        # contiguous NDHWC in x's dtype
        dyc = dy.to(x.dtype).contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            w_t = torch.flip(w.float(), (0, 1, 2)).permute(0, 1, 2, 4, 3)
            dx = conv333(dyc, w_t).to(x.dtype)
        dw, db = conv333_dw(x.contiguous(), dyc)
        return dx, dw, (db if ctx.has_bias else None)


def conv333_train(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  use_kernels: bool = True) -> torch.Tensor:
    """x (N, D, H, W, Cin) in the compute dtype, w (3, 3, 3, Cin, Cout) f32
    in the JAX (kh, kw, kd) order, b (Cout,) f32 or None."""
    if not use_kernels:
        return _forward(x, w, b)
    return Conv333Train.apply(x, w, b)
