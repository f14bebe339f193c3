"""Train-mode BatchNorm -> dropout -> PReLU of a Convolution as one autograd
Function with hand-written passes (csrc/bnorm_train.cu).

Replaces no Pallas kernel: the JAX package leaves the chain to XLA, which
fuses it; the port's eager modules (nn/layers.py:BatchNorm, Dropout, PReLU)
ran it as some 25 full-tensor passes a site. Here, with y the conv's
(N, D, H, W, C) output and the statistics over every axis but C:

    forward   stats       sum y and sum y^2 per channel, f32 (2 launches)
              finish      mean, var = E[y^2] - E[y]^2, the running mean and
                          unbiased var, rstd, inv = rstd * scale: the
                          formulas of nn/layers.py:BatchNorm.forward, on
                          C-length vectors (1 launch)
              apply       z = (y - mean) * inv + bias, z' = z * (1 / keep)
                          where kept and 0 where dropped, out = prelu(z')
                          with the f32 slope, all in f32, rounded once to
                          bf16; the keep mask at 1 bit an element (1
                          launch)
    backward  bwd_reduce  sum gh, sum gh * (y - mean) per channel and
                          sum g * min(z', 0), where gh = dL/dz is g after
                          PReLU's and dropout's backward (2 launches)
              bwd_finish  dscale = rstd * sum gh (y - mean); the two
                          per-channel sums over the global batch give the
                          coefficients c1 = -inv sum gh / n, c2 = -inv
                          rstd^2 sum gh (y - mean) / n (1 launch); dbias =
                          sum gh and dalpha = sum g min(z', 0) are the sums
              bwd_apply   dy = inv * gh + (c2 * (y - mean) + c1) (1 launch)

That is BatchNorm's gradient with batch statistics, inv * (gh - mean(gh) -
yhat * mean(gh * yhat)) with yhat = (y - mean) * rstd, which autograd
formed through the eager chain. Under a batch-stats group
(parallel/distributed.py:batch_stats_group) the raw sums and the count are
summed over the ranks before the forward's finish, and the two per-channel
sums before the backward's coefficients: the global batch's statistics and
their gradient, as the eager chain's differentiable all-reduce gave them;
dscale, dbias and dalpha stay the rank's own, as autograd's were.

The dropout words are the caller's: torch.randint's int32 draw of
nn/layers.py:Dropout.draw, kept where a word is below `thresh`, keep =
thresh / 65536. A kept value is scaled by the f32 reciprocal of keep, as
torch divides a CUDA tensor by a scalar (the eager chain's x / keep on the
card).

Every pass has a plain PyTorch twin here (`*_plain`), which the wrappers run
for CPU tensors (any float dtype); CUDA tensors go to the kernels, which
take contiguous bf16 activations, as conv333 and conv333_dw do (anything
else raises), and any other device raises. The twins round op by op in the
kernels' order, so apply and bwd_apply are bit-equal to their twins given
the same statistics, and the finishes to theirs on the card (torch's own
rounding of each op); the sums differ only in their order. The finishes
are kernels for the host's sake: as torch ops, some ten small launches a
direction, they took a site's host time on an H100 machine from 0.36 to
0.69-0.74 ms (chip_smoke.py's phase 5), and a train step without attention
then waited on its host. `bn_dropout_prelu.launches` counts the kernel
launches: LAUNCHES_PER_SITE a site and step. The launch plan (block size,
grid, shared memory) is the .cu file's alone: it gives the wrapper the
rows of scratch a reduction's partial sums take (bnorm_plan).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vs_seg_tpu_torch.nn.layers import BN_EPS, BN_MOMENTUM
from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.parallel import distributed

# the dropout words' range (nn/layers.py:Dropout)
WORDS = 65536
# stats 2 + finish 1 + apply 1 forward (what --remat's recompute launches
# again), bwd_reduce 2 + bwd_finish 1 + bwd_apply 1 backward
FORWARD_LAUNCHES = 4
LAUNCHES_PER_SITE = 8


# ---------------------------------------------------------------- twins --

def pack_bits(kept: torch.Tensor) -> torch.Tensor:
    """A bool tensor as its flat bits, 8 a byte: byte v holds elements
    8 v .. 8 v + 7, bit j element 8 v + j (the kernel's mask)."""
    k = kept.reshape(-1).to(torch.uint8)
    k = F.pad(k, (0, -k.numel() % 8)).view(-1, 8).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=k.device)
    return (k << shifts).sum(1).to(torch.uint8)


def unpack_bits(bits: torch.Tensor, n: int) -> torch.Tensor:
    """The first n elements of pack_bits' mask, as bools."""
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return ((bits.to(torch.int32)[:, None] >> shifts) & 1).reshape(-1)[:n] \
        .bool()


@functools.lru_cache(maxsize=None)
def _reciprocal(x: float) -> float:
    """1 / x in f32, as torch forms it to divide a CUDA tensor by the Python
    scalar x."""
    return float(np.float32(1.0) / np.float32(x))


def _rkeep(thresh: Optional[int]) -> float:
    """The f32 reciprocal of keep = thresh / 65536 (1 without dropout)."""
    return 1.0 if thresh is None else _reciprocal(thresh / WORDS)


def _centred(y, mean, inv, bias):
    """(y - mean, z = (y - mean) * inv + bias) in f32, (M, C)."""
    d = y.reshape(-1, y.shape[-1]).float() - mean
    return d, d * inv + bias


def _grad_z(g, zp, kept, alpha, rkeep):
    """gh = dL/dz from g: PReLU's slope (1 where z' > 0, else alpha), then
    dropout's mask and 1 / keep."""
    gz = torch.where(zp > 0, g, g * alpha)
    return gz if kept is None else torch.where(kept, gz * rkeep, 0.0)


def stats_plain(y: torch.Tensor) -> torch.Tensor:
    """(2C,) f32: the sum of y per channel, then the sum of y^2."""
    yf = y.reshape(-1, y.shape[-1]).float()
    return torch.cat([yf.sum(0), (yf * yf).sum(0)])


def apply_plain(y, words, thresh, mean, inv, bias, alpha):
    """(out in y's dtype and shape, the keep mask's bits or None)."""
    _, z = _centred(y, mean, inv, bias)
    bits = None
    if words is not None:
        kept = words.reshape(z.shape) < thresh
        z = torch.where(kept, z * _rkeep(thresh), 0.0)
        bits = pack_bits(kept)
    out = torch.clamp_min(z, 0) + alpha * torch.clamp_max(z, 0)
    return out.to(y.dtype).view(y.shape), bits


def _backward_terms(g, y, bits, thresh, mean, inv, bias, alpha):
    d, z = _centred(y, mean, inv, bias)
    kept = None if bits is None else unpack_bits(bits, z.numel()).view(
        z.shape)
    zp = z if kept is None else torch.where(kept, z * _rkeep(thresh), 0.0)
    gf = g.reshape(z.shape).float()
    return gf, d, zp, _grad_z(gf, zp, kept, alpha, _rkeep(thresh))


def bwd_reduce_plain(g, y, bits, thresh, mean, inv, bias, alpha):
    """(2C + 1,) f32: sum gh and sum gh * (y - mean) per channel, then the
    sum of g * min(z', 0)."""
    gf, d, zp, gh = _backward_terms(g, y, bits, thresh, mean, inv, bias,
                                    alpha)
    return torch.cat([gh.sum(0), (gh * d).sum(0),
                      (gf * torch.clamp_max(zp, 0)).sum().reshape(1)])


def bwd_apply_plain(g, y, bits, thresh, mean, inv, bias, alpha, c1, c2):
    """dy = inv * gh + (c2 * (y - mean) + c1), in y's dtype and shape."""
    _, d, _, gh = _backward_terms(g, y, bits, thresh, mean, inv, bias, alpha)
    return (inv * gh + (c2 * d + c1)).to(y.dtype).view(y.shape)


def finish_plain(sums, n, run_mean, run_var, scale):
    """(mean, rstd, inv) from stats' sums (of the global batch under a
    group) and the count n: a float, or a 0-d f32 tensor summed over the
    ranks. The running statistics are updated in place. The formulas are
    nn/layers.py:BatchNorm.forward's."""
    c = scale.numel()
    mean, sq = (sums / n).view(2, c)
    var = sq - mean * mean
    if isinstance(n, torch.Tensor):
        factor = n / torch.clamp_min(n - 1.0, 1.0)
    else:
        factor = n / max(n - 1.0, 1.0)
    # (1 - m) * running + m * batch, each product and the sum rounded, for
    # both statistics in one multi-tensor launch apiece
    m = BN_MOMENTUM
    running = [run_mean, run_var]
    torch._foreach_mul_(running, 1 - m)
    torch._foreach_add_(running, torch._foreach_mul([mean, var * factor], m))
    rstd = torch.rsqrt(var + BN_EPS)
    return mean, rstd, rstd * scale


def bwd_finish_plain(sums, total, n, rstd, inv):
    """(dscale, c1, c2) from bwd_reduce's sums and `total`, their first 2C
    summed over the ranks (sums[:2C] outside a group): dscale = rstd *
    sum gh (y - mean), c1 = -inv sum gh / n, c2 = -inv rstd^2
    sum gh (y - mean) / n."""
    c = rstd.numel()
    scales = torch.stack([inv, inv * rstd * rstd]) / -n
    c1, c2 = total.view(2, c) * scales
    return sums[c:2 * c] * rstd, c1, c2


# -------------------------------------------------------------- kernels --

_ARGS = {
    "bnorm_plan": [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)],
    "bnorm_stats_launch": [ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                   ctypes.c_void_p],
    "bnorm_apply_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                   ctypes.c_float]
    + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
    "bnorm_bwd_reduce_launch": [ctypes.c_void_p] * 3 + [ctypes.c_float]
    + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
    "bnorm_bwd_apply_launch": [ctypes.c_void_p] * 3 + [ctypes.c_float]
    + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "bnorm_finish_launch": [ctypes.c_void_p] * 2 + [ctypes.c_float] * 5
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "bnorm_bwd_finish_launch": [ctypes.c_void_p] * 3 + [ctypes.c_float]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


_FNS = {}


def _fn(name: str):
    """The launcher `name`, bound once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = _build.bind(_build.load("bnorm_train"), name,
                                      _ARGS[name])
    return fn


@functools.lru_cache(maxsize=None)
def rows(c: int, device: int) -> int:
    """The rows of scratch a reduction's partial sums over C channels take
    on the card (csrc/bnorm_train.cu:bnorm_plan, the plan's one number the
    wrapper needs); raises for a C the kernels cannot take."""
    out = ctypes.c_int(0)
    if _fn("bnorm_plan")(c, device, ctypes.byref(out)):
        raise ValueError(f"bnorm_train: the kernels cannot take C = {c} "
                         f"(csrc/bnorm_train.cu:block_threads)")
    return out.value


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _route(name: str, dev: torch.device) -> bool:
    """True for the kernels (a CUDA device), False for the twins (the CPU);
    any other device raises."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _expect(name: str, dev: torch.device, want) -> None:
    """Raise unless each (t, dtype, size) of `want` whose t is not None is
    a contiguous dtype tensor of `size` elements on dev."""
    for t, dtype, size in want:
        if t is not None and (t.device != dev or t.dtype != dtype
                              or t.numel() != size
                              or not t.is_contiguous()):
            raise ValueError(
                f"{name}: expected a contiguous {dtype} tensor of {size} "
                f"elements on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _on_card(name: str, y: torch.Tensor, g=None, words=None, bits=None,
             params=(), alpha=None) -> bool:
    """True for the kernel: CUDA tensors, each checked against what the
    kernels take (g y's dtype and size, the words int32, the mask's bytes,
    the per-channel params f32 of C, alpha f32 of 1, all contiguous on y's
    card); False for the twin: CPU tensors. Any other device raises."""
    dev = y.device
    if not _route(name, dev):
        return False
    if y.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16, got {y.dtype}")
    n, c = y.numel(), y.shape[-1]
    want = [(y, y.dtype, n), (g, y.dtype, n), (words, torch.int32, n),
            (bits, torch.uint8, -(-n // 8)), (alpha, torch.float32, 1)]
    _expect(name, dev, want + [(p, torch.float32, c) for p in params])
    return True


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and on a 16-byte boundary (a view may start off one),
    as the kernels' vector accesses need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(dev: int) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev))


def _geometry(y: torch.Tensor):
    dev = y.device.index
    return y.numel(), y.shape[-1], dev, _stream(dev)


def _check(err: int, what: str, launches: int) -> None:
    if err:
        _build.check(_build.load("bnorm_train"), err, what)
    _build.count(bn_dropout_prelu, n=launches)


def stats(y: torch.Tensor) -> torch.Tensor:
    if not _on_card("bnorm stats", y):
        return stats_plain(y)
    n, c, dev, stream = _geometry(y)
    r = rows(c, dev)
    partials = torch.empty(2 * c * r, dtype=torch.float32, device=y.device)
    sums = torch.empty(2 * c, dtype=torch.float32, device=y.device)
    err = _fn("bnorm_stats_launch")(_ptr(y), n, c, r, _ptr(partials),
                                    _ptr(sums), dev, stream)
    _check(err, "bnorm stats", 2)
    return sums


def apply(y, words, thresh, mean, inv, bias, alpha):
    if not _on_card("bnorm apply", y, words=words, params=(mean, inv, bias),
                    alpha=alpha):
        return apply_plain(y, words, thresh, mean, inv, bias, alpha)
    n, c, dev, stream = _geometry(y)
    out = torch.empty_like(y)
    bits = (None if words is None else
            torch.empty(-(-n // 8), dtype=torch.uint8, device=y.device))
    err = _fn("bnorm_apply_launch")(
        _ptr(y), _ptr(words), 0 if thresh is None else thresh,
        _rkeep(thresh), _ptr(mean), _ptr(inv), _ptr(bias), _ptr(alpha), n,
        c, _ptr(out), _ptr(bits), dev, stream)
    _check(err, "bnorm apply", 1)
    return out, bits


def bwd_reduce(g, y, bits, thresh, mean, inv, bias, alpha):
    if not _on_card("bnorm bwd_reduce", y, g, bits=bits,
                    params=(mean, inv, bias), alpha=alpha):
        return bwd_reduce_plain(g, y, bits, thresh, mean, inv, bias, alpha)
    n, c, dev, stream = _geometry(y)
    r = rows(c, dev)
    partials = torch.empty((2 * c + 1) * r, dtype=torch.float32,
                           device=y.device)
    sums = torch.empty(2 * c + 1, dtype=torch.float32, device=y.device)
    err = _fn("bnorm_bwd_reduce_launch")(
        _ptr(g), _ptr(y), _ptr(bits), _rkeep(thresh), _ptr(mean), _ptr(inv),
        _ptr(bias), _ptr(alpha), n, c, r, _ptr(partials), _ptr(sums), dev,
        stream)
    _check(err, "bnorm bwd_reduce", 2)
    return sums


def bwd_apply(g, y, bits, thresh, mean, inv, bias, alpha, c1, c2):
    if not _on_card("bnorm bwd_apply", y, g, bits=bits,
                    params=(mean, inv, bias, c1, c2), alpha=alpha):
        return bwd_apply_plain(g, y, bits, thresh, mean, inv, bias, alpha,
                               c1, c2)
    n, c, dev, stream = _geometry(y)
    dy = torch.empty_like(y)
    err = _fn("bnorm_bwd_apply_launch")(
        _ptr(g), _ptr(y), _ptr(bits), _rkeep(thresh), _ptr(mean), _ptr(inv),
        _ptr(bias), _ptr(alpha), _ptr(c1), _ptr(c2), n, c, _ptr(dy), dev,
        stream)
    _check(err, "bnorm bwd_apply", 1)
    return dy


def finish(sums, n, run_mean, run_var, scale):
    """finish_plain's (mean, rstd, inv) and running statistics, in one
    launch on the card."""
    dev = sums.device
    if not _route("bnorm finish", dev):
        return finish_plain(sums, n, run_mean, run_var, scale)
    c = scale.numel()
    f32 = torch.float32
    count = n if isinstance(n, torch.Tensor) else None
    _expect("bnorm finish", dev, [(sums, f32, 2 * c), (count, f32, 1)]
            + [(t, f32, c) for t in (run_mean, run_var, scale)])
    # a Python count as torch takes it: sums / n as sums times the f32
    # reciprocal of n, the factor rounded to f32
    rcp, factor = (0.0, 0.0) if count is not None else (
        _reciprocal(n), n / max(n - 1.0, 1.0))
    out = torch.empty(3 * c, dtype=f32, device=dev)
    err = _fn("bnorm_finish_launch")(
        _ptr(sums), _ptr(count), rcp, factor, 1 - BN_MOMENTUM,
        BN_MOMENTUM, BN_EPS, _ptr(scale), _ptr(run_mean), _ptr(run_var),
        _ptr(out), c, dev.index, _stream(dev.index))
    _check(err, "bnorm finish", 1)
    return out.view(3, c).unbind()


def bwd_finish(sums, total, n, rstd, inv):
    """bwd_finish_plain's (dscale, c1, c2), in one launch on the card."""
    dev = sums.device
    if not _route("bnorm bwd_finish", dev):
        return bwd_finish_plain(sums, total, n, rstd, inv)
    c = rstd.numel()
    f32 = torch.float32
    count = n if isinstance(n, torch.Tensor) else None
    _expect("bnorm bwd_finish", dev,
            [(sums, f32, 2 * c + 1), (total, f32, 2 * c), (count, f32, 1),
             (rstd, f32, c), (inv, f32, c)])
    rcp = 0.0 if count is not None else _reciprocal(-n)
    out = torch.empty(3 * c, dtype=f32, device=dev)
    err = _fn("bnorm_bwd_finish_launch")(
        _ptr(sums), _ptr(total), _ptr(count), rcp, _ptr(rstd), _ptr(inv),
        _ptr(out), c, dev.index, _stream(dev.index))
    _check(err, "bnorm bwd_finish", 1)
    return out.view(3, c).unbind()


# ------------------------------------------------------------- autograd --

def batch_stats(y: torch.Tensor, run_mean: torch.Tensor,
                run_var: torch.Tensor, scale: torch.Tensor, group):
    """(mean, rstd, inv, n) of y's batch from one stats pass and the
    finish, with the running statistics updated in place: nn/layers.py:
    BatchNorm.forward's formulas, over the ranks of `group` where it is not
    None (n is then the global count, a 0-d tensor)."""
    c = y.shape[-1]
    sums = stats(y)
    if group is None:
        n = float(y.numel() // c)
    else:
        local = torch.cat([sums, sums.new_full((1,), y.numel() // c)])
        total = distributed.all_reduce_sum(local, group)
        sums, n = total[:2 * c], total[2 * c]
    return (*finish(sums, n, run_mean, run_var, scale), n)


class BNormDropPReLU(torch.autograd.Function):
    """prelu(dropout(batchnorm(y))) given the batch's mean, rstd and inv =
    rstd * scale; see the module doc. Inputs y, scale, bias, alpha take
    gradients."""

    @staticmethod
    def forward(ctx, y, scale, bias, alpha, mean, rstd, inv, n, words,
                thresh, group):
        out, bits = apply(y, words, thresh, mean, inv, bias, alpha)
        ctx.save_for_backward(y, bits, mean, rstd, inv, bias, alpha)
        ctx.n, ctx.thresh, ctx.group = n, thresh, group
        return out

    @staticmethod
    def backward(ctx, g):
        y, bits, mean, rstd, inv, bias, alpha = ctx.saved_tensors
        c = y.shape[-1]
        g = _aligned(g.to(y.dtype))
        sums = bwd_reduce(g, y, bits, ctx.thresh, mean, inv, bias, alpha)
        total = sums[:2 * c]
        if ctx.group is not None:
            total = distributed.all_reduce_sum(total, ctx.group)
        dscale, c1, c2 = bwd_finish(sums, total, ctx.n, rstd, inv)
        dy = bwd_apply(g, y, bits, ctx.thresh, mean, inv, bias, alpha, c1,
                       c2)
        # dbias = sum gh, dalpha = sum g min(z', 0): the rank's own sums
        return (dy, dscale, sums[:c], sums[2 * c:]) + (None,) * 7


def bn_dropout_prelu(y: torch.Tensor, norm, alpha: torch.Tensor,
                     drawn: Optional[Tuple[torch.Tensor, int]]
                     ) -> torch.Tensor:
    """A Convolution's train-mode tail on its conv output y (N, D, H, W, C):
    `norm` (nn/layers.py:BatchNorm, whose running statistics are updated),
    dropout with the words and threshold `drawn` by Dropout.draw (None: no
    dropout), PReLU with the slope `alpha`."""
    y = _aligned(y)
    group = distributed.batch_stats_group()
    with torch.no_grad():
        mean, rstd, inv, n = batch_stats(y.detach(), norm.mean, norm.var,
                                         norm.scale, group)
    words, thresh = drawn if drawn is not None else (None, None)
    return BNormDropPReLU.apply(y, norm.scale, norm.bias, alpha, mean, rstd,
                                inv, n, words, thresh, group)


bn_dropout_prelu.launches = 0
