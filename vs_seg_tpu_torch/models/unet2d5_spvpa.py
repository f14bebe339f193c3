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

forward(x, use_kernels=True, train=False, generator=None, routes=Routes())
takes (N, D, H, W, C) and returns (logits (N, D, H, W, out), att_maps), the
maps coarsest first, each (N, d, h, w, 1); with attention_module=False the
maps are empty. Each call of a top-level child runs under the span
model.<child> (core/observability.py:span; `span_names`), a routed
decoder block under model.up_<i>. The constructor's `device` is a
required keyword (no CPU default). With `remat`, the train forward
rematerialises down_i, downsample_i, upsample_i and up_i at levels 0-1 in
the backward (`remat_block`), the blocks vs_seg_tpu's nn.remat covers.
Train or eval is the explicit `train` argument, as in the JAX package;
torch's module-level train()/eval() state is not read. At train,
BatchNorm uses batch statistics (and updates the running ones), Dropout
draws from `generator` (a torch.Generator on x's device, required when
dropout > 0), no l2block/rublock/headfold route is taken, and every
(3,3,3) stride-1 conv runs the hand-written backward of
ops/train_conv.py (25 conv sites in the flagship, pair halves counted
separately).

Eval dispatch to the hand-written kernels (ops/): the two-subunit (3,3,3)
encoder units go to ops/rublock.py from ResidualUnit; every (3,3,3) decoder
level i > 0 whose output has the skip's width goes to ops/l2block.py here,
as vs_seg_tpu's l2block_fusable/l2block_apply route it. The (3,3,1) levels
run plain PyTorch unless `routes` (core/config.py:Routes, the JAX package's
opt-in env gates) sends them to kernels: rublock2d the encoder units
(ResidualUnit), and at a (3,3,1) decoder level i with attention, tail2d{i}
(ops/tail2d.py: one csrc/tail2d.cu launch, given a1 from the library
conv) before l2block2d
(ops/block2d.py:l2_block2d: one csrc/l2block2d.cu launch for the i == 0
logit head, the conv333 + attgate chain at wider levels). A block route
replaces upatt_i + up_i, whose chain is then not computed; att_fuse takes
the upatt_i sites no block route took (AttentionBlock1), and dsconv the
(3,3,3) stride-(2,2,2) downsample_i (Convolution -> ops/dsconv.py; the
flagship's downsample_2/3/4). As in the JAX package,
the port routes on semantics alone: the TPU kernels' tiling preconditions
are not copied. Under nn/layers.py:spatial_sharding (H split over several
shards, infer/spatial.py) the (3,3,1) block routes are off and l2block runs
on halo-extended blocks (vs_seg_tpu's _l2_spatial_halo: a chain of three
convs in H, so a halo of 3 rows) and keeps the local rows. With use_kernels=False every routed site runs its kernels'
plain PyTorch twins instead; on CPU tensors both choices run the plain
twins. At train the routes are ignored.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.core.observability import span
from vs_seg_tpu_torch.nn.blocks import (
    AttentionBlock1, Convolution, ResidualUnit, folded_conv_affine,
)
from vs_seg_tpu_torch.nn.layers import (_triple, block_halo, is_unfused,
                                       spatial_shards)
from vs_seg_tpu_torch.ops import block2d, halo, l2block, tail2d


# the conv chain depth in H of l2_block (att conv1, conv2, unit0; the 1x1
# residual adds none): the halo that keeps its local rows exact
L2_CHAIN = 3
# the top levels whose blocks --remat rematerialises: they hold the large
# activations (vs_seg_tpu/models/unet2d5_spvpa.py:remat_levels)
REMAT_LEVELS = 2


def remat_block(module: nn.Module, x, generator: Optional[torch.Generator],
                **kwargs):
    """module(x, generator=generator, **kwargs) under torch.utils.checkpoint
    (non-reentrant): its activations are recomputed in the backward.

    The recompute must replay the forward exactly, and two of its effects
    are not the autograd graph's: the dropout masks, drawn from the explicit
    `generator` (checkpoint restores only the global RNG), and the
    BatchNorm running statistics, updated in place at train. So the
    generator's state is taken before the forward; the recompute runs from
    that state and then puts back the state the generator held before it,
    and it puts back the module's buffers as they were before it. The masks
    are the forward's, and the generator and the statistics end the step as
    they would without remat."""
    start = None if generator is None else generator.get_state()
    recompute = False

    def run(v):
        if not recompute:
            return module(v, generator=generator, **kwargs)
        now = None if generator is None else generator.get_state()
        buffers = [b.clone() for b in module.buffers()]
        if generator is not None:
            generator.set_state(start)
        try:
            return module(v, generator=generator, **kwargs)
        finally:
            if generator is not None:
                generator.set_state(now)
            with torch.no_grad():
                for b, saved in zip(module.buffers(), buffers):
                    b.copy_(saved)

    out = checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    recompute = True     # the forward has run: any later call recomputes
    return out


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
                 remat: bool = False, *, device,
                 generator: Optional[torch.Generator] = None):
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
        self.strides = tuple(_triple(s) for s in strides)
        self.attention_module = attention_module
        self.dtype = dtype
        self.remat = remat
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
        self.span_names = {name: f"model.{name}" for name in self._modules}

    def forward(self, x, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                routes: Routes = Routes()):
        n = self.n_levels
        kw = dict(use_kernels=use_kernels, train=train, routes=routes)
        names = self.span_names

        def block(name: str, i: int, v, **kwargs):
            child = f"{name}_{i}"
            m = getattr(self, child)
            with span(names[child]):
                if self.remat and train and i < REMAT_LEVELS:
                    return remat_block(m, v, generator, **kwargs)
                return m(v, generator=generator, **kwargs)

        skips = []
        for i in range(n):
            x = block("down", i, x, **kw)
            skips.append(x)
            x = block("downsample", i, x, **kw)
        att_maps = []
        if self.attention_module:
            with span(names["bottom_att"]):
                att, x = self.bottom_att(x, gate=True, **kw)
            att_maps.append(att)
        with span(names["bottom"]):
            x = self.bottom(x, generator=generator, **kw)
        for i in reversed(range(n)):
            x = block("upsample", i, x, use_kernels=use_kernels, train=train)
            pair = (skips[i], x.to(skips[i].dtype))
            outc = self.out_channels if i == 0 else self.channels[i]
            route = None if train else self._block_route(pair, i, outc,
                                                         routes)
            if route is not None:
                with span(names[f"up_{i}"]):
                    x, att = self._block_apply(route, pair, i, use_kernels)
                att_maps.append(att)
                continue
            if self.attention_module:
                with span(names[f"upatt_{i}"]):
                    att, pair = getattr(self, f"upatt_{i}")(pair, gate=True,
                                                            **kw)
                att_maps.append(att)
            x = block("up", i, pair, **kw)
        return x, tuple(att_maps)

    def _block_route(self, pair, i: int, outc: int, routes: Routes):
        """The eval block route of decoder level i, or None: "l2block" at the
        (3,3,3) levels i > 0 with attention whose output keeps the skip's
        width C (always taken); at the (3,3,1) levels with attention "tail"
        under routes.tail2d(i), else "l2block2d" under routes.l2block2d
        (vs_seg_tpu/models/unet2d5_spvpa.py:l2block_fusable); None under
        nn/layers.py:unfused."""
        xa, xb = pair
        if (not self.attention_module or is_unfused()
                or tuple(xa.shape) != tuple(xb.shape)):
            return None
        k = self.kernel_sizes[i]
        if k == (3, 3, 3):
            return ("l2block" if i > 0 and outc == int(xa.shape[-1])
                    and block_halo(xa.shape[2], L2_CHAIN) >= 0 else None)
        if k != (3, 3, 1) or spatial_shards():
            return None
        if routes.tail2d(i):
            return "tail"
        return "l2block2d" if routes.l2block2d else None

    def _block_apply(self, route: str, pair, i: int, use_kernels: bool):
        """Run decoder level i's upatt_i + up_i as one block; (out, att)."""
        att_m = getattr(self, f"upatt_{i}")
        ru = getattr(self, f"up_{i}")
        if ru.last_conv_only:
            # the conv-only logit head: degenerate epilogue (scale 1, shift =
            # bias, identity activation)
            inv, shift, alpha = None, ru.unit0.conv.bias, None
        else:
            inv, shift = folded_conv_affine(ru.unit0)
            alpha = ru.unit0.act.alpha
        kw = dict(w2=att_m.conv2.conv.kernel, b2=att_m.conv2.conv.bias,
                  w0=ru.unit0.conv.kernel, bn_scale=inv, bn_shift=shift,
                  alpha=alpha, wr=ru.residual.kernel, br=ru.residual.bias)
        if route == "tail":
            # att conv1 stays the library conv on the pair halves (bias on
            # the second half, then ReLU), as in the JAX model
            a1 = att_m.conv1(pair, use_kernels)
            fn = tail2d.tail_block if use_kernels else tail2d.tail_block_plain
            return fn(a1, pair[0], pair[1], **kw)
        kw.update(w1=att_m.conv1.conv.kernel, b1=att_m.conv1.conv.bias)
        if route == "l2block":
            fn = l2block.l2_block if use_kernels else l2block.l2_block_plain
            hl = pair[0].shape[2]
            h = block_halo(hl, L2_CHAIN)
            if h:
                # both halves extended by h neighbour rows a side, the
                # kernels unchanged, the local rows of out and att kept
                (xa, start), (xb, _) = (halo.halo_block_input(v, h)
                                        for v in pair)
                halo.count_block("l2_block")
                return tuple(t.narrow(2, start, hl).contiguous()
                             for t in fn(xa, xb, **kw))
        else:
            fn = (block2d.l2_block2d if use_kernels
                  else block2d.l2_block2d_plain)
        return fn(pair[0], pair[1], **kw)
