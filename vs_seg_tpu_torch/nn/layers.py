"""Low-level NN primitives on (N, D, H, W, C) activations.

Counterpart of vs_seg_tpu/nn/layers.py, with the same semantics:
  - conv padding: MONAI same_padding, (k - 1) // 2 per dim;
  - transpose conv: MONAI output_padding = s + 2p - (k - 1) - 1, so that
    output = input * stride;
  - BatchNorm: torch BatchNorm3d semantics (eps 1e-5, momentum 0.1): at
    train, biased batch statistics in float32 normalise and the unbiased
    variance updates the running var (among data-parallel ranks, the
    global batch's statistics); at eval, folded into a per-channel
    affine inv = scale * rsqrt(var + eps), shift = bias - mean*inv;
  - PReLU: one shared slope, init 0.25;
  - Dropout: inverted (x / keep) at train, identity at eval.

Train or eval is an explicit `train` argument of every forward, as in the JAX
package (not torch's module-level train()/eval() state). At train, every
(3,3,3) stride-1 same-padded conv, each pair half on its own, goes through
ops/train_conv.py (the hand-written backward), as vs_seg_tpu's conv3d routes
it to pallas_train.conv333_train.

Layout: a contiguous NDHWC tensor permuted to (N, C, D, H, W) is an NCDHW
tensor in channels_last_3d memory format, with no copy, so the plain convs
call F.conv3d without moving activations. Kernels keep the JAX parameter
shape (kh, kw, kd, Cin, Cout) in the reference (H, W, D) order; only the
weights are reordered, to torch's (Cout, Cin, kd, kh, kw).

Parameters are float32 and created from an explicit CPU torch.Generator with
torch's default init (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernel and
bias), then moved to `device`. Compute happens in each module's `dtype`.
Every module takes `device` as a required keyword, checked by
core/device.py:resolve_device: there is no CPU default.

Under `spatial_sharding` (inside a shard of parallel/collectives.py:
run_spmd; thread-local, as each shard is a thread) activations are the
shard's LOCAL block of H rows, and conv3d and conv_transpose3d exchange
their H halo with the neighbour shards (ops/halo.py) instead of
zero-padding H, as vs_seg_tpu/nn/layers.py's convs do under its
spatial_sharding context. The result equals the dense conv's rows of the
shard.

Under `unfused` (thread-local too) the blocks take no fused route and no
headfold: every Conv3d and ConvTranspose3d module runs its own conv, which
is the algebra eval/flops.py counts.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vs_seg_tpu_torch.core.device import resolve_device
from vs_seg_tpu_torch.ops import train_conv
from vs_seg_tpu_torch.ops.halo import exchange_halo
from vs_seg_tpu_torch.parallel import collectives, distributed

Shape3 = Tuple[int, int, int]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

_SPATIAL = threading.local()


class spatial_sharding:
    """Within a shard of run_spmd: H of every activation is the shard's
    local block, split over all the shards in rank order, and the convs
    exchange halos (the counterpart of vs_seg_tpu's spatial_sharding)."""

    def __enter__(self):
        self._prev = spatial_shards()
        _SPATIAL.n = collectives.axis_size()
        return self

    def __exit__(self, *exc):
        _SPATIAL.n = self._prev
        return False


def spatial_shards() -> int:
    """The number of shards H is split over in this thread's
    spatial_sharding context, 0 outside one."""
    return getattr(_SPATIAL, "n", 0)


_UNFUSED = threading.local()


class unfused:
    """Within (this thread): every eval block computes its own modules one
    by one, as at train: no fused block route (ru_block, l2_block, the
    Routes ones) and no headfold, whatever the routes. eval/flops.py counts
    the model's convs this way."""

    def __enter__(self):
        self._prev = is_unfused()
        _UNFUSED.on = True
        return self

    def __exit__(self, *exc):
        _UNFUSED.on = self._prev
        return False


def is_unfused() -> bool:
    return getattr(_UNFUSED, "on", False)


def block_halo(local_h: int, chain: int) -> int:
    """The H halo a fused block whose conv chain is `chain` convs deep in H
    runs with on a block of `local_h` rows: 0 outside a context of several
    shards (the block is whole), else `chain` (the port's kernels take any
    extended height; JAX's Mosaic layout limits are not ported), or -1
    where the block is too short to lend one (a halo comes from one
    neighbour; the unfused convs then run)."""
    if spatial_shards() <= 1:
        return 0
    return chain if chain <= local_h else -1


def _triple(v) -> Shape3:
    if isinstance(v, (tuple, list)):
        assert len(v) == 3
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def same_padding(kernel_size, dilation=1) -> Shape3:
    """MONAI same_padding: (k - 1) // 2 * d per dim (odd kernels exact)."""
    k = np.asarray(_triple(kernel_size))
    d = np.asarray(_triple(dilation))
    return tuple(int(p) for p in (k - 1) // 2 * d)


def _dhw(v: Sequence[int]) -> Shape3:
    """(H, W, D) reference order -> torch's (D, H, W) spatial order."""
    return (int(v[2]), int(v[0]), int(v[1]))


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv3d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           strides: Shape3 = (1, 1, 1), padding: Shape3 = (0, 0, 0)
           ) -> torch.Tensor:
    """Convolution of (N, D, H, W, Cin) `x` with (kh, kw, kd, Cin, Cout) `w`.

    `strides` and symmetric `padding` are in reference (H, W, D) order. The
    conv runs in x.dtype; w and b are cast to it. Under spatial_sharding,
    x is the local H block: output row o reads input rows o*sh - ph ..
    o*sh - ph + kh - 1, so the block borrows ph rows below and
    max(kh - ph - sh, 0) above and is not padded in H (the local block must
    divide by sh)."""
    wt = w.to(x.dtype).permute(4, 3, 2, 0, 1)
    padding = tuple(int(p) for p in padding)
    if spatial_shards():
        kh, sh, ph = int(w.shape[0]), int(strides[0]), padding[0]
        x = exchange_halo(x, (ph, max(kh - ph - sh, 0)))
        padding = (0,) + padding[1:]
    y = F.conv3d(_ncdhw(x), wt, None if b is None else b.to(x.dtype),
                 stride=_dhw(strides), padding=_dhw(padding))
    return _ndhwc(y)


def conv_transpose3d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor], strides: Shape3,
                     padding: Shape3, output_padding: Shape3) -> torch.Tensor:
    """Transpose convolution with the (kh, kw, kd, Cin, Cout) JAX kernel.

    The JAX package runs it as an input-dilated conv with the spatially
    flipped kernel; F.conv_transpose3d takes the unflipped kernel as
    (Cin, Cout, kd, kh, kw), which is the same operator.

    Under spatial_sharding x is the local H block of hl rows, global rows
    [a, a + hl). The unpadded transpose conv scatters input row i to full
    rows i*sh .. i*sh + kh - 1, and output row o is full row o + ph; so the
    shard's output rows [a*sh, (a + hl)*sh) read input rows a - (kh - 1 -
    ph) // sh .. a + hl - 1 + ceil(ph / sh). The block borrows those halo
    rows, runs unpadded in H, and keeps hl*sh rows from full row ph +
    lo*sh."""
    wt = w.to(x.dtype).permute(3, 4, 2, 0, 1)
    padding = tuple(int(p) for p in padding)
    output_padding = tuple(int(p) for p in output_padding)
    if not spatial_shards():
        y = F.conv_transpose3d(_ncdhw(x), wt,
                               None if b is None else b.to(x.dtype),
                               stride=_dhw(strides), padding=_dhw(padding),
                               output_padding=_dhw(output_padding))
        return _ndhwc(y)
    kh, sh, ph = int(w.shape[0]), int(strides[0]), padding[0]
    hl = x.shape[2]
    lo = (kh - 1 - ph) // sh
    xe = exchange_halo(x, (lo, -(-ph // sh)))
    b = None if b is None else b.to(x.dtype)
    y = _ndhwc(F.conv_transpose3d(
        _ncdhw(xe), wt, b, stride=_dhw(strides),
        padding=_dhw((0,) + padding[1:]),
        output_padding=_dhw((0,) + output_padding[1:])))
    c0 = ph + lo * sh
    short = c0 + hl * sh - y.shape[2]
    if short > 0:       # kh < sh: rows no input reaches hold the bias
        tail = y.new_zeros((*y.shape[:2], short, *y.shape[3:]))
        y = torch.cat([y, tail if b is None else tail + b], dim=2)
    return y.narrow(2, c0, hl * sh).contiguous()


def fold_affine(w: torch.Tensor, b: Optional[torch.Tensor], affine=None):
    """(kernel, bias) with an optional per-out-channel (inv, shift) folded in,
    in float32: conv(x, w) * inv + shift == conv(x, w * inv) + b * inv + shift.
    """
    if affine is None:
        return w, b
    inv, shift = affine
    return w * inv, (shift if b is None else b * inv + shift)


def _uniform(shape, bound: float, generator: Optional[torch.Generator],
             device) -> torch.Tensor:
    """torch-default U(-bound, bound) init, drawn on the CPU generator and
    then moved, so one seed gives the same weights on every device."""
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=generator)
    return t.to(device)


class Conv3d(nn.Module):
    """Plain 3D convolution with torch-Conv3d init and MONAI same padding.

    `x` may be a PAIR (xa, xb) standing for their channel concat: the conv is
    conv(xa, w[..., :ca, :]) + conv(xb, w[..., ca:, :]) with the same kernel,
    as vs_seg_tpu/nn/layers.py:Conv3d computes it. `affine=(inv, shift)`
    folds a frozen per-channel affine (eval BatchNorm) into the weights in
    float32 before the cast to the compute dtype. With `train`, a (3,3,3)
    stride-1 same-padded conv runs through ops/train_conv.py, one call per
    pair half with the bias on the second (vs_seg_tpu's Conv3d split)."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1, 1), padding=None, use_bias: bool = True,
                 dtype=torch.bfloat16, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.kernel_size = _triple(kernel_size)
        self.strides = _triple(strides)
        self.padding = (same_padding(self.kernel_size) if padding is None
                        else _triple(padding))
        self.dtype = dtype
        bound = 1.0 / np.sqrt(in_features * int(np.prod(self.kernel_size)))
        self.kernel = nn.Parameter(_uniform(
            (*self.kernel_size, in_features, features), bound, generator,
            device))
        self.bias = (nn.Parameter(_uniform((features,), bound, generator,
                                           device))
                     if use_bias else None)

    def train_route(self) -> bool:
        """The convs vs_seg_tpu sends to conv333_train at train."""
        return (self.kernel_size == (3, 3, 3) and self.strides == (1, 1, 1)
                and self.padding == (1, 1, 1))

    def forward(self, x, affine=None, train: bool = False,
                use_kernels: bool = True):
        w, b = fold_affine(self.kernel, self.bias, affine)
        if (train and affine is None and self.train_route()
                and not spatial_shards()):
            def conv(v, wv, bv, strides, padding):
                return train_conv.conv333_train(v, wv, bv, use_kernels)
        else:
            conv = conv3d
        if isinstance(x, (tuple, list)):
            xa, xb = (v.to(self.dtype) for v in x)
            ca = xa.shape[-1]
            return (conv(xa, w[..., :ca, :], None, self.strides,
                         self.padding)
                    + conv(xb, w[..., ca:, :], b, self.strides,
                           self.padding))
        return conv(x.to(self.dtype), w, b, self.strides, self.padding)


class ConvTranspose3d(nn.Module):
    """Transpose conv with torch-ConvTranspose3d init (fan_in = Cout * k) and
    MONAI output_padding, so output = input * stride."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=(1, 1, 1), use_bias: bool = True,
                 dtype=torch.bfloat16, *, device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        k = np.asarray(_triple(kernel_size))
        s = np.asarray(_triple(strides))
        p = np.asarray(same_padding(tuple(k)))
        self.kernel_size = tuple(int(v) for v in k)
        self.strides = tuple(int(v) for v in s)
        self.padding = tuple(int(v) for v in p)
        self.output_padding = tuple(int(v) for v in s + 2 * p - (k - 1) - 1)
        self.dtype = dtype
        bound = 1.0 / np.sqrt(features * int(np.prod(k)))
        self.kernel = nn.Parameter(_uniform(
            (*self.kernel_size, in_features, features), bound, generator,
            device))
        self.bias = (nn.Parameter(_uniform((features,), bound, generator,
                                           device))
                     if use_bias else None)

    def forward(self, x, affine=None, train: bool = False,
                use_kernels: bool = True):
        """`train` and `use_kernels` change nothing here: no transpose conv
        has a kernel route."""
        w, b = fold_affine(self.kernel, self.bias, affine)
        return conv_transpose3d(x.to(self.dtype), w, b, self.strides,
                                self.padding, self.output_padding)


class BatchNorm(nn.Module):
    """BatchNorm3d over the channel axis (the last axis here). At eval it is
    kept folded: `fold()` gives the per-channel affine (inv, shift) that the
    caller folds into the preceding conv. At train `forward` normalises with
    the batch statistics and updates the running ones in place (buffers, no
    gradient). Parameters `scale`/`bias` and running statistics `mean`/`var`
    carry the JAX package's names."""

    def __init__(self, features: int, *, device):
        super().__init__()
        device = resolve_device(device)
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def fold(self):
        inv = torch.rsqrt(self.var + BN_EPS) * self.scale
        return inv, self.bias - self.mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode, as vs_seg_tpu/nn/layers.py:BatchNorm writes it: biased
        stats in float32 as E[x^2] - E[x]^2 (not F.batch_norm, whose variance
        algorithm and bf16 handling differ), running var updated with the
        unbiased n/(n-1) estimate, and for low-precision x one scale/shift
        applied in x's dtype.

        Among several data-parallel ranks with a sharded batch
        (parallel/distributed.py:batch_stats_group), the statistics are the
        global batch's, as GSPMD computes them in JAX: the local sums of x
        and x^2 and the local count in float32, summed over the ranks by one
        differentiable all-reduce, and n in the unbiased factor is the
        global count."""
        axes = tuple(range(x.dim() - 1))
        xf = x.float()
        group = distributed.batch_stats_group()
        if group is None:
            mean = xf.mean(axes)
            var = (xf * xf).mean(axes) - mean * mean
            n = float(np.prod([x.shape[a] for a in axes]))
            factor = n / max(n - 1.0, 1.0)
        else:
            c = x.shape[-1]
            local = torch.cat([xf.sum(axes), (xf * xf).sum(axes),
                               xf.new_full((1,), xf.numel() // c)])
            total = distributed.all_reduce_sum(local, group)
            n = total[2 * c]
            mean = total[:c] / n
            var = total[c:2 * c] / n - mean * mean
            factor = n / torch.clamp_min(n - 1.0, 1.0)
        with torch.no_grad():
            m = BN_MOMENTUM
            unbiased = var * factor
            self.mean.copy_((1 - m) * self.mean + m * mean)
            self.var.copy_((1 - m) * self.var + m * unbiased)
        inv = torch.rsqrt(var + BN_EPS) * self.scale
        if x.dtype == torch.float32:
            return (x - mean) * inv + self.bias
        shift = self.bias - mean * inv
        return x * inv.to(x.dtype) + shift.to(x.dtype)


class PReLU(nn.Module):
    """Single shared slope (torch PReLU num_parameters=1, init 0.25):
    max(x, 0) + alpha * min(x, 0)."""

    def __init__(self, *, device):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25,
                                             device=resolve_device(device)))

    def forward(self, x):
        a = self.alpha.to(x.dtype)
        return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


class Dropout(nn.Module):
    """Inverted dropout at train, the identity at eval. As in the JAX package
    the keep decision thresholds one 16-bit random word per element, so the
    keep probability is quantised to 1/65536 and x is divided by that exact
    keep. The words come from the caller's torch.Generator (on x's device),
    so the masks are not the JAX package's bits."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def draw(self, x, generator: Optional[torch.Generator]
             ) -> Optional[Tuple[torch.Tensor, int]]:
        """The train-mode words of x, one int32 in [0, 65536) per element
        drawn from `generator`, and the threshold below which an element is
        kept; None where the rate keeps every element (nothing is drawn)."""
        if self.rate == 0.0:
            return None
        thresh = int(round((1.0 - self.rate) * 65536.0))
        if thresh >= 65536:
            return None
        if generator is None:
            raise ValueError("train-mode dropout needs an explicit "
                             "torch.Generator")
        bits = torch.randint(0, 65536, x.shape, generator=generator,
                             device=x.device, dtype=torch.int32)
        return bits, thresh

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        drawn = self.draw(x, generator) if train else None
        if drawn is None:
            return x
        bits, thresh = drawn
        keep = thresh / 65536.0
        return (x / keep).masked_fill(bits >= thresh, 0.0)
