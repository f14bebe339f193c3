"""Composite blocks mirroring vs_seg_tpu/nn/blocks.py.

  Convolution     eval: conv (or transpose conv) -> folded BatchNorm -> act;
                  train: conv -> BatchNorm (batch stats) -> Dropout -> act,
                  with BatchNorm and PReLU on the kernel path as one
                  Function (ops/bnorm_train.py); or conv_only; with
                  Routes.dsconv the eval (3,3,3) stride-(2,2,2) ones run as
                  ops/dsconv.py:ds_conv
  ResidualUnit    `subunits` Convolutions + residual (1x1 conv when the
                  channels change); the conv-only logit head folds its
                  residual into the conv (the JAX `_headfold_apply` algebra);
                  the (3,3,3) two-subunit encoder units dispatch to
                  ops/rublock.py, and with Routes.rublock2d the (3,3,1) ones
                  to ops/block2d.py:ru_block2d (eval only)
  AttentionBlock1 conv(C -> C/2, ReLU) -> conv(C/2 -> 1, sigmoid), with the
                  residual gate att*x + x (`attention_gate`); with
                  Routes.att_fuse the gated eval tail of a pair input (the
                  decoder's upatt_i: conv2 + sigmoid + gate) runs as
                  ops/att.py:fused_attention_gate

Module and parameter names follow the JAX package (unit0, conv, norm, act,
residual, conv1, conv2, kernel, bias, scale, mean, var, alpha), so a JAX
variables tree maps onto the state_dict key for key (compat/from_jax.py).
Every forward takes `train` (default False, eval), `use_kernels` and, for
train-mode dropout, an explicit torch.Generator; ResidualUnit and
AttentionBlock1 also take `routes` (core/config.py:Routes). At train no block
takes the rublock, headfold or fused-gate route, as in the JAX package; the
(3,3,3) stride-1 convs inside run the hand-written backward
(nn/layers.py:Conv3d). Every constructor takes `device` as a required
keyword (no CPU default).

Under nn/layers.py:spatial_sharding (H split over the shards of run_spmd)
the opt-in routes are off, as JAX gates each of them off there (dsconv,
rublock2d, att_fuse), and the (3,3,3) units of more than one shard run
ru_block on the halo-extended block of ops/halo.py:halo_block_input,
keeping the local rows (vs_seg_tpu/nn/blocks.py:_ru_spatial_halo). Under
nn/layers.py:unfused no block takes a fused route or the headfold.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.nn.layers import (
    BatchNorm, Conv3d, ConvTranspose3d, Dropout, PReLU, _triple, block_halo,
    conv3d, is_unfused, same_padding, spatial_shards,
)
from vs_seg_tpu_torch.ops import att as fused_att
from vs_seg_tpu_torch.ops import block2d, bnorm_train, dsconv, halo, rublock

# the conv chain depth in H of ru_block (unit0 then unit1, each 3 rows; the
# 1x1 residual adds none): the halo that keeps its local rows exact
RU_CHAIN = 2


def folded_conv_affine(unit: "Convolution"):
    """Eval BatchNorm folded into a post-conv affine INCLUDING the conv bias:
    conv(x) * scale + shift (vs_seg_tpu/nn/blocks.py:folded_conv_affine)."""
    inv, shift = unit.norm.fold()
    return inv, shift + unit.conv.bias * inv


class Convolution(nn.Module):
    """Conv -> BatchNorm -> Dropout -> Activation, or conv_only."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1, 1), act: Optional[str] = "prelu",
                 norm: Optional[str] = "batch",
                 dropout: Optional[float] = None, conv_only: bool = False,
                 is_transposed: bool = False, dtype=torch.bfloat16, *,
                 device, generator: Optional[torch.Generator] = None):
        super().__init__()
        if act not in ("prelu", "relu", "sigmoid", None):
            raise ValueError(f"unsupported act {act}")
        if norm not in ("batch", None):
            raise ValueError(f"unsupported norm {norm}")
        conv_cls = ConvTranspose3d if is_transposed else Conv3d
        self.conv = conv_cls(in_features, features, kernel_size, strides,
                             dtype=dtype, device=device, generator=generator)
        self.conv_only = conv_only
        self.act_name = None if conv_only else act
        self.norm = (BatchNorm(features, device=device)
                     if norm == "batch" and not conv_only else None)
        self.dropout = (Dropout(dropout) if dropout and not conv_only
                        else None)
        self.act = PReLU(device=device) if self.act_name == "prelu" else None

    def _dsconv(self, x, train: bool, routes: Routes) -> bool:
        """The eval sites ops/dsconv.py takes under routes.dsconv: a (3,3,3)
        stride-(2,2,2) conv on one input, act PReLU/ReLU/none (the
        semantics of vs_seg_tpu/nn/blocks.py:_dsconv_fusable; its Mosaic
        shape gate is not copied)."""
        conv = self.conv
        return (routes.dsconv and not train and not self.conv_only
                and not spatial_shards() and not is_unfused()
                and isinstance(conv, Conv3d)
                and not isinstance(x, (tuple, list))
                and conv.kernel_size == (3, 3, 3)
                and conv.strides == (2, 2, 2) and conv.padding == (1, 1, 1)
                and self.act_name in ("prelu", "relu", None))

    def _fused_train(self, use_kernels: bool) -> bool:
        """The train-mode tails ops/bnorm_train.py takes: BatchNorm, any
        dropout (none included) and PReLU, on the kernel path."""
        return (use_kernels and self.norm is not None
                and self.act_name == "prelu")

    def forward(self, x, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                routes: Routes = Routes()):
        kw = dict(train=train, use_kernels=use_kernels)
        if self.conv_only:
            return self.conv(x, **kw)
        if self._dsconv(x, train, routes):
            if self.norm is not None:
                scale, shift = folded_conv_affine(self)
            else:
                scale, shift = None, self.conv.bias
            alpha = (self.act.alpha if self.act_name == "prelu"
                     else torch.zeros(1, device=x.device)
                     if self.act_name == "relu" else None)
            fn = dsconv.ds_conv if use_kernels else dsconv.ds_conv_plain
            return fn(x.to(self.conv.dtype), self.conv.kernel, scale, shift,
                      alpha)
        if train:
            y = self.conv(x, **kw)
            if self._fused_train(use_kernels):
                drawn = (None if self.dropout is None
                         else self.dropout.draw(y, generator))
                return bnorm_train.bn_dropout_prelu(y, self.norm,
                                                    self.act.alpha, drawn)
            if self.norm is not None:
                y = self.norm(y)
        else:
            y = self.conv(x, affine=None if self.norm is None
                          else self.norm.fold(), **kw)
        if self.dropout is not None:
            y = self.dropout(y, train, generator)
        if self.act_name == "prelu":
            y = self.act(y)
        elif self.act_name == "relu":
            y = torch.relu(y)
        elif self.act_name == "sigmoid":
            y = torch.sigmoid(y)
        return y


class ResidualUnit(nn.Module):
    """`subunits` Convolutions + additive residual.

    Residual branch: identity if same channels and stride 1; otherwise a
    conv (1x1x1 when stride is 1). `last_conv_only` strips norm/act from
    the final subunit (the logit head)."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1, 1), subunits: int = 2,
                 act: Optional[str] = "prelu", norm: Optional[str] = "batch",
                 dropout: Optional[float] = None,
                 last_conv_only: bool = False, dtype=torch.bfloat16, *,
                 device, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.strides = _triple(strides)
        self.subunits = max(1, subunits)
        self.in_features, self.features = in_features, features
        self.act_name, self.norm_name = act, norm
        self.last_conv_only = last_conv_only
        self.dtype = dtype
        cin = in_features
        for su in range(self.subunits):
            self.add_module(f"unit{su}", Convolution(
                cin, features, kernel_size,
                self.strides if su == 0 else (1, 1, 1), act=act, norm=norm,
                dropout=dropout,
                conv_only=last_conv_only and su == self.subunits - 1,
                dtype=dtype, device=device, generator=generator))
            cin = features
        strided = int(np.prod(self.strides)) != 1
        if strided or in_features != features:
            self.residual = Conv3d(
                in_features, features,
                self.kernel_size if strided else (1, 1, 1), self.strides,
                padding=None if strided else (0, 0, 0), dtype=dtype,
                device=device, generator=generator)
        else:
            self.residual = None

    def _headfold(self) -> bool:
        """Conv-only logit head: conv0(x) + b0 + conv1x1(x) + br is linear in
        the kernels, so the residual folds exactly into unit0's conv."""
        return (self.last_conv_only and self.subunits == 1
                and self.strides == (1, 1, 1)
                and self.in_features != self.features)

    def _rublock(self, pair: bool, routes: Routes = Routes(),
                 x_h: int = 0) -> bool:
        """The eval sites a fused block takes: every two-subunit stride-1
        PReLU+BN unit on one input whose channels change, (3,3,3) always
        (ops/rublock.py), (3,3,1) under routes.rublock2d
        (ops/block2d.py:ru_block2d). Under spatial_sharding the (3,3,1)
        route is off, and a (3,3,3) unit of several shards needs a local
        block of at least RU_CHAIN rows for its halo."""
        if not (not pair and self.subunits == 2 and not self.last_conv_only
                and self.strides == (1, 1, 1)
                and self.act_name == "prelu" and self.norm_name == "batch"
                and self.in_features != self.features):
            return False
        if self.kernel_size == (3, 3, 1):
            return routes.rublock2d and not spatial_shards()
        return (self.kernel_size == (3, 3, 3)
                and block_halo(x_h, RU_CHAIN) >= 0)

    def forward(self, x, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                routes: Routes = Routes()):
        pair = isinstance(x, (tuple, list))
        fused = not train and not is_unfused()
        if fused and self._headfold():
            return self._headfold_apply(x)
        if fused and self._rublock(pair, routes, 0 if pair else x.shape[2]):
            if self.kernel_size == (3, 3, 3):
                fn = (rublock.ru_block if use_kernels
                      else rublock.ru_block_plain)
            else:
                fn = (block2d.ru_block2d if use_kernels
                      else block2d.ru_block2d_plain)
            s0, h0 = folded_conv_affine(self.unit0)
            s1, h1 = folded_conv_affine(self.unit1)
            kw = dict(w0=self.unit0.conv.kernel, bn0_scale=s0, bn0_shift=h0,
                      alpha0=self.unit0.act.alpha, w1=self.unit1.conv.kernel,
                      bn1_scale=s1, bn1_shift=h1, alpha1=self.unit1.act.alpha,
                      wr=self.residual.kernel, br=self.residual.bias)
            h = block_halo(x.shape[2], RU_CHAIN)
            if h == 0:
                return fn(x.to(self.dtype), **kw)
            # the local block extended by h neighbour rows a side, the
            # kernel unchanged, the local rows kept
            x_ext, start = halo.halo_block_input(x.to(self.dtype), h)
            halo.count_block("ru_block")
            return fn(x_ext, **kw).narrow(2, start, x.shape[2]).contiguous()
        cx = x
        for su in range(self.subunits):
            cx = getattr(self, f"unit{su}")(cx, use_kernels, train, generator,
                                            routes)
        if self.residual is not None:
            res = self.residual(x, train=train, use_kernels=use_kernels)
        else:
            assert not pair, "identity residual undefined for pair input"
            res = x
        return cx + res

    def _headfold_apply(self, x):
        w0, b0 = self.unit0.conv.kernel, self.unit0.conv.bias
        wr, br = self.residual.kernel, self.residual.bias
        k = self.kernel_size
        wf = w0 + torch.nn.functional.pad(
            wr, (0, 0, 0, 0, k[2] // 2, k[2] // 2, k[1] // 2, k[1] // 2,
                 k[0] // 2, k[0] // 2))
        bf = b0 + br
        pads = same_padding(k)
        if isinstance(x, (tuple, list)):
            xa, xb = (v.to(self.dtype) for v in x)
            ca = xa.shape[-1]
            return (conv3d(xa, wf[..., :ca, :], None, (1, 1, 1), pads)
                    + conv3d(xb, wf[..., ca:, :], bf, (1, 1, 1), pads))
        return conv3d(x.to(self.dtype), wf, bf, (1, 1, 1), pads)


class AttentionBlock1(nn.Module):
    """conv(C -> C/2, ReLU) -> conv(C/2 -> 1, sigmoid); returns (att, x), or
    (att, att*x + x) with gate=True (AttentionBlock2 applied inline)."""

    def __init__(self, in_features: int, kernel_size, dtype=torch.bfloat16,
                 *, device, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = in_features
        self.conv1 = Convolution(c, c // 2, kernel_size, act="relu",
                                 norm=None, dtype=dtype, device=device,
                                 generator=generator)
        self.conv2 = Convolution(c // 2, 1, kernel_size, act="sigmoid",
                                 norm=None, dtype=dtype, device=device,
                                 generator=generator)

    def forward(self, x, gate: bool = False, use_kernels: bool = True,
                train: bool = False, routes: Routes = Routes()):
        a1 = self.conv1(x, use_kernels, train)
        if (gate and not train and routes.att_fuse and not spatial_shards()
                and not is_unfused() and isinstance(x, (tuple, list))):
            # conv2 + sigmoid + gate in one pass (vs_seg_tpu/nn/blocks.py
            # :472-483) on the decoder's pair, each half as wide as a1; the
            # compact map is what the JAX caller keeps. A single input is
            # twice a1's width, and JAX never fuses it (bottom_att).
            fn = (fused_att.fused_attention_gate if use_kernels
                  else fused_att.fused_attention_gate_plain)
            att, gated = fn(a1, tuple(x), self.conv2.conv.kernel,
                            self.conv2.conv.bias)
            return att, gated
        att = self.conv2(a1, use_kernels, train)
        if not gate:
            return att, x
        return att, attention_gate(att, x)


def attention_gate(att: torch.Tensor, x):
    """AttentionBlock2: out = att*x + x; a pair (xa, xb) gates each half."""
    if isinstance(x, (tuple, list)):
        return tuple(att.to(v.dtype) * v + v for v in x)
    return att * x + x
