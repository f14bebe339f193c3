"""(3,3,3) stride-(2,2,2) conv with padding 1 and a fused epilogue: the
encoder's downsample conv.

Replaces vs_seg_tpu/ops/experimental/pallas_dsconv.py:ds_conv. The model
sends the eval (3,3,3) stride-(2,2,2) Convolutions here under
core/config.py:Routes(dsconv=True) (nn/blocks.py:Convolution).

    y   = conv(x, w, stride 2, pad 1)
    out = act(y * scale + shift)           act: PReLU(alpha), ReLU is alpha 0

x is (N, D, H, W, Cin); w is (3, 3, 3, Cin, Cout) in the JAX (kh, kw, kd)
order; the output is (N, (D-1)//2+1, (H-1)//2+1, (W-1)//2+1, Cout). The TPU
kernel's preconditions (Cin, Cout <= 64, even D and H, W % 4, (W//4) % 8,
its VMEM budget, 64-lane padding) are Mosaic tiling rules and are not
copied: any shape is taken.

`ds_conv` runs the hand-written kernel (csrc/dsconv.cu) for CUDA tensors and
`ds_conv_plain`, the PyTorch twin, for CPU tensors; any other device raises.
The CUDA route counts its launches in `ds_conv.launches`. The packed weight
is cached on the weight tensor (ops/conv333.py:packed_weights).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import (_check_act, _pad16, _ptr, _tiles,
                                          _vec, pack_weights, packed_weights)


def ds_conv_plain(x: torch.Tensor, w: torch.Tensor,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PyTorch twin of the ds_conv kernel (any device, any float dtype).

    x: (N, D, H, W, Cin); w: (3, 3, 3, Cin, Cout) in the JAX (kh, kw, kd)
    order; scale/shift: (Cout,) or None; alpha: the PReLU slope ((1,) or
    (Cout,)), or None for no activation. The conv runs in x.dtype, the
    epilogue in float32 on its output; the result has x.dtype."""
    wt = w.to(x.dtype).permute(4, 3, 2, 0, 1)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), wt, stride=2, padding=1)
    y = y.float().permute(0, 2, 3, 4, 1)
    if scale is not None:
        y = y * scale.float()
    if shift is not None:
        y = y + shift.float()
    if alpha is not None:
        y = torch.where(y >= 0, y, alpha.float() * y)
    return y.to(x.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])


def _lib():
    lib = _build.load("dsconv")
    fn = lib.dsconv_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def ds_conv(x: torch.Tensor, w: torch.Tensor,
            scale: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None,
            alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(3,3,3) stride-2 conv + epilogue; see ds_conv_plain for the
    arguments. CUDA tensors go to the hand-written kernel (bf16 activations,
    contiguous NDHWC), CPU tensors to ds_conv_plain."""
    dev = x.device
    if dev.type == "cpu":
        return ds_conv_plain(x, w, scale, shift, alpha)
    if dev.type != "cuda":
        raise ValueError(f"ds_conv: unsupported device {dev}")
    _check_act((x,), "ds_conv")
    cin = int(x.shape[-1])
    if tuple(w.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"ds_conv: weight {tuple(w.shape)} does not match "
                         f"an input with {cin} channels")
    cout = int(w.shape[4])
    nfrag, cop = _tiles(cout)
    wm = packed_weights(w, "ds_conv", [cin], cop, dev, pack=pack_weights)
    eps = torch.stack([_vec(scale, cout, cop, 1.0, dev),
                       _vec(shift, cout, cop, 0.0, dev),
                       _vec(alpha, cout, cop, 1.0, dev)]).contiguous()
    n, d, h, wd = (int(s) for s in x.shape[:4])
    do, ho, wo = ((s - 1) // 2 + 1 for s in (d, h, wd))
    if n * do > 65535:
        raise ValueError(f"ds_conv: N*Dout = {n * do} exceeds the grid limit")
    out = torch.empty((n, do, ho, wo, cout), dtype=torch.bfloat16, device=dev)
    lib = _lib()
    err = lib.dsconv_launch(
        _ptr(x), _ptr(wm), _ptr(eps), _ptr(out), n, d, h, wd, cin, cout,
        nfrag, cop, _pad16(cin),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "ds_conv")
    ds_conv.launches += 1
    return out


ds_conv.launches = 0
