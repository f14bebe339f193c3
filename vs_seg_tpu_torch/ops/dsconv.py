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

`ds_conv` runs the stride-2 instance of conv333's kernel (csrc/conv333.cu:
the same wgmma mainloop, TMA ring and persistent walk, its input viewed as
(N*D, H, W/2, 2, C) so that W's even and odd columns are two planes of the
staged halo) for CUDA tensors, and `ds_conv_plain`, the PyTorch twin, for
CPU tensors; any other device raises. The CUDA route counts its launches in
`ds_conv.launches` (not in conv333's). `plan` is the launch's geometry, as
the kernel computes it. The packed weight is cached on the weight tensor
(ops/conv333.py:packed_weights), the epilogue vectors are read in place.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import (KC, _check_act, _epi, _ntile,
                                          _tma_ready, launch, packed_weights)

# csrc/conv333.cu's stride-2 instances: N widths, tile heights, ring slots
DS_TILES = (48, 64, 80)
TH_CHOICES = (16, 8)
TW = 16                   # output tile width
STAGES = 3
SMEM_MAX = 227 * 1024     # dynamic shared memory a block may use (H100)
H100_SMS = 132


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


class Plan(NamedTuple):
    """One stride-2 launch of csrc/conv333.cu. The input is padded to cp
    channels (a multiple of 8) and an even width wp; its TMA map views it
    as `view` (innermost first: channel, W parity, W/2, H, N*D) with byte
    strides `strides` of dims 1-4, one box of `box` elements per 8-channel
    half plane of a halo, 4 boxes a stage. Tiles are th x TW output voxels
    of one (n, od) plane and one N tile of n_t output channels."""
    n_t: int
    cop: int
    th: int
    cp: int
    wp: int
    out: tuple          # (N, Do, Ho, Wo)
    tiles_w: int
    tiles_h: int
    tiles: int
    view: tuple
    strides: tuple
    box: tuple
    smem: int           # dynamic shared memory of a block, bytes


def smem_bytes(n_t: int, th: int) -> int:
    """csrc/conv333.cu's Cfg<N, false, 2, th / 8>::SMEM."""
    half = (2 * th + 1) * (TW + 1) * 16
    pitch = -(-half // 128) * 128
    return STAGES * (4 * pitch + 9 * KC * n_t * 2) + 2 * STAGES * 8


def pick_th(out, ntiles: int = 1) -> int:
    """The tile height the plan takes for output sizes (N, Do, Ho, Wo) and
    `ntiles` N tiles: 8 where TH = 16 would give fewer than 8 tiles per SM
    (downsample_3/4), where the smaller tile's finer walk (fewer idle SMs,
    less of it past Ho) gains more than its 1.9x halo per output costs;
    else 16 (at downsample_2 the two tie; H100, `attgate_ab --kernel
    ds_conv --ds-th 16,8`)."""
    n, do, ho, wo = out
    tiles16 = n * do * ntiles * -(-ho // 16) * -(-wo // TW)
    return 8 if tiles16 < 8 * H100_SMS else 16


@functools.lru_cache(maxsize=256)
def plan(shape, cin: int, cout: int, th: Optional[int] = None) -> Plan:
    """The launch's geometry for an input (N, D, H, W) with cin channels and
    cout output channels; th None takes pick_th's."""
    n, d, h, w = shape
    n_t, cop = _ntile(cout, DS_TILES)
    out = (n, (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    th = pick_th(out, cop // n_t) if th is None else th
    if th not in TH_CHOICES:
        raise ValueError(f"ds_conv: tile height {th} not in {TH_CHOICES}")
    cp = -(-cin // 8) * 8
    wp = w + w % 2
    tiles_w, tiles_h = -(-out[3] // TW), -(-out[2] // th)
    e = 2                                   # bf16 bytes
    return Plan(n_t=n_t, cop=cop, th=th, cp=cp, wp=wp, out=out,
                tiles_w=tiles_w, tiles_h=tiles_h,
                tiles=n * out[1] * (cop // n_t) * tiles_w * tiles_h,
                view=(cp, 2, wp // 2, h, n * d),
                strides=(cp * e, 2 * cp * e, wp * cp * e, h * wp * cp * e),
                box=(8, 1, TW + 1, 2 * th + 1, 1), smem=smem_bytes(n_t, th))


def ds_conv(x: torch.Tensor, w: torch.Tensor,
            scale: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None,
            alpha: Optional[torch.Tensor] = None, *,
            th: Optional[int] = None) -> torch.Tensor:
    """(3,3,3) stride-2 conv + epilogue; see ds_conv_plain for the
    arguments. CUDA tensors go to the hand-written kernel (bf16 activations,
    contiguous NDHWC), CPU tensors to ds_conv_plain. th: the kernel's tile
    height (8 or 16; None: the plan's)."""
    dev = x.device
    if dev.type == "cpu":
        return ds_conv_plain(x, w, scale, shift, alpha)
    if dev.type != "cuda":
        raise ValueError(f"ds_conv: unsupported device {dev}")
    _check_act((x,), "ds_conv")
    cin = x.shape[-1]
    if w.shape[:4] != (3, 3, 3, cin):
        raise ValueError(f"ds_conv: weight {tuple(w.shape)} does not match "
                         f"an input with {cin} channels")
    if x.numel() == 0:
        raise ValueError(f"ds_conv: empty input {tuple(x.shape)}")
    cout = w.shape[4]
    p = plan(x.shape[:4], cin, cout, th)
    wm = packed_weights(w, "ds_conv", (cin,), p.n_t, dev)
    if x.shape[3] % 2:
        # the W-pair view needs an even W: one zero column on the right,
        # which is the last output's padding tap (and channels to cp)
        x = F.pad(x, (0, p.cp - cin, 0, 1))
    else:
        x = _tma_ready((x,), {})[0]
    out = torch.empty((*p.out, cout), dtype=torch.bfloat16, device=dev)
    launch(out, (x,), wm, p.n_t, p.cop, 3, _epi(scale, cout, dev),
           _epi(shift, cout, dev), _epi(alpha, cout, dev, one=True),
           stride=2, th=p.th, what="ds_conv")
    _build.count(ds_conv)
    return out


ds_conv.launches = 0
