"""The plain reference of the benchmark: UNet2d5_spvPA (with and without its
attention module), its sliding-window Gaussian blend, the hard Dice, the
Dice-spvPA loss and Adam, written from the published description in plain
PyTorch on (N, C, D, H, W) tensors. It imports nothing of the program and
reads none of its tensors: the benchmark hands it the same weights and
inputs that it hands the program, and it works out again what the program
derives from them (the eval BatchNorm, the dropout masks, the crops).

The network (Wang et al., MICCAI 2019; KCL-BMEIS/VS_Seg params/VSparams.py,
MONAI 0.4 blocks):

  level i: down_i   ResidualUnit(c_{i-1} -> c_i, 2 subunits, kernel k_i)
           downsample_i  Convolution(c_i -> c_i, kernel sk_i, stride s_i)
  bottom:  bottom_att AttentionBlock1(c_{n-1}) with its gate att*x + x,
           bottom   ResidualUnit(c_{n-1} -> c_n, 2 subunits, kernel k_n)
  level i, coarsest first:
           upsample_i  transposed Convolution(c_{i+1} -> c_i, stride s_i)
           cat(skip_i, up) -> upatt_i AttentionBlock1(2 c_i) + gate
           up_i     ResidualUnit(2 c_i -> c_i, 1 subunit; at i = 0 the
                    conv alone, to the out channels)

A Convolution is conv -> BatchNorm -> Dropout -> PReLU; a ResidualUnit adds
a residual conv (1x1x1 where the stride is 1) since its channels change;
AttentionBlock1 is conv(C -> C/2, ReLU) -> conv(C/2 -> 1, sigmoid). Without
the attention module there are no attention blocks and no attention maps.

Weights are stored as the reference's own TensorFlow-style kernels,
(kh, kw, kd, Cin, Cout), and are named as in its Flax/JAX port; sizes and
strides are in the reference's (H, W, D) order. Precision: "f32" computes
everything in float32 with TF32 off (the reference); "bf16" convolves in
bfloat16 (inputs and weights rounded, float32 accumulation, the output
rounded) and does the rest in float32, the configuration's own precision,
whose error is the scale the program's is read against; "fp8" rounds every
conv's input and weight to float8 e4m3 (and, at train, the gradient into
each conv output to e5m2), each with a power-of-two scale per tensor, then
convolves in bfloat16 with float32 accumulation (the control: the nearest
precision below the bfloat16 that the configuration states).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
HARDNESS_LAMBDA = 0.6
DICE_SMOOTH = 1e-5
# The dropout keep decision thresholds one 16-bit word per element, drawn
# over the activation in (N, D, H, W, C) order from the run's generator.
DROPOUT_WORDS = 65536
FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}


def _dhw(v: Sequence[int]) -> Tuple[int, int, int]:
    """(H, W, D) -> (D, H, W)."""
    return (int(v[2]), int(v[0]), int(v[1]))


def same_padding(k: Sequence[int]) -> Tuple[int, int, int]:
    return tuple((int(v) - 1) // 2 for v in k)


# ---------------------------------------------------------------- precision

def _pow2_scale(t: torch.Tensor, fmt: str) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(FP8_MAX[fmt] / amax)))


def fp8_round(t: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """t rounded to float8 `fmt` under a power-of-two scale of the tensor,
    returned in bfloat16 (exact there: e4m3 and e5m2 carry fewer mantissa
    bits than bfloat16)."""
    dtype = torch.float8_e4m3fn if fmt == "e4m3" else torch.float8_e5m2
    s = _pow2_scale(t, fmt)
    q = (t.float() * s).clamp(-FP8_MAX[fmt], FP8_MAX[fmt]).to(dtype)
    return (q.float() / s).to(torch.bfloat16)


class _Fp8(torch.autograd.Function):
    """Forward: e4m3 rounding; backward: the incoming gradient in e5m2."""

    @staticmethod
    def forward(ctx, t):
        return fp8_round(t, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, "e5m2").float()


class _GradFp8(torch.autograd.Function):
    """Identity forward; the gradient through it rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, "e5m2").float()


def conv(x, w, b, stride, padding, prec: str, transposed: bool = False,
         output_padding=(0, 0, 0)):
    """conv (or transposed conv) of NCDHW `x` with the (kh, kw, kd, Cin,
    Cout) kernel `w`; stride, padding, output_padding in (D, H, W)."""
    if transposed:
        wt = w.permute(3, 4, 2, 0, 1)
    else:
        wt = w.permute(4, 3, 2, 0, 1)
    if prec == "bf16":
        bq = None if b is None else b.to(torch.bfloat16)
        xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16)
        if transposed:
            y = F.conv_transpose3d(xb, wb, bq, stride=stride,
                                   padding=padding,
                                   output_padding=output_padding)
        else:
            y = F.conv3d(xb, wb, bq, stride=stride, padding=padding)
        return y.float()
    if prec == "fp8":
        xq, wq = _Fp8.apply(x), _Fp8.apply(wt)
        bq = None if b is None else b.to(torch.bfloat16)
        if transposed:
            y = F.conv_transpose3d(xq, wq, bq, stride=stride,
                                   padding=padding,
                                   output_padding=output_padding)
        else:
            y = F.conv3d(xq, wq, bq, stride=stride, padding=padding)
        return _GradFp8.apply(y.float())
    if transposed:
        return F.conv_transpose3d(x, wt, b, stride=stride, padding=padding,
                                  output_padding=output_padding)
    return F.conv3d(x, wt, b, stride=stride, padding=padding)


class fp32_exact:
    """Within: float32 convolutions and matmuls without TF32."""

    def __enter__(self):
        self._prev = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self._prev
        return False


# ------------------------------------------------------------------ network

class RefNet:
    """The network of a configuration (a dict of the configuration file's
    keys): its parameter list and its forward."""

    def __init__(self, cfg: dict):
        self.in_channels = int(cfg["in_channels"])
        self.out_channels = int(cfg["out_channels"])
        self.channels = [int(c) for c in cfg["channels"]]
        self.strides = [tuple(int(v) for v in s) for s in cfg["strides"]]
        self.kernels = [tuple(int(v) for v in k) for k in cfg["kernel_sizes"]]
        self.sample_kernels = [tuple(int(v) for v in k)
                               for k in cfg["sample_kernel_sizes"]]
        self.subunits = int(cfg["num_res_units"])
        self.dropout = float(cfg["dropout"])
        self.attention = bool(cfg["attention"])
        self.n = len(self.strides)
        self.spec: List[Tuple[str, Tuple[int, ...], str, float]] = []
        self._build()

    # spec: (name, shape, kind, fan) with kind in kernel, bias, scale,
    # shift, mean, var, alpha; `fan` sets a kernel's and a bias's bound
    def _conv(self, name, cin, cout, k, transposed=False):
        fan = (cout if transposed else cin) * int(np.prod(k))
        self.spec.append((f"{name}.kernel", (*k, cin, cout), "kernel", fan))
        self.spec.append((f"{name}.bias", (cout,), "bias", fan))

    def _convolution(self, name, cin, cout, k, norm=True, act=True,
                     transposed=False):
        self._conv(f"{name}.conv", cin, cout, k, transposed)
        if norm:
            self.spec += [(f"{name}.norm.scale", (cout,), "scale", 0),
                          (f"{name}.norm.bias", (cout,), "shift", 0),
                          (f"{name}.norm.mean", (cout,), "mean", 0),
                          (f"{name}.norm.var", (cout,), "var", 0)]
        if act:
            self.spec.append((f"{name}.act.alpha", (1,), "alpha", 0))

    def _resunit(self, name, cin, cout, k, subunits, last_conv_only=False):
        c = cin
        for su in range(subunits):
            only = last_conv_only and su == subunits - 1
            self._convolution(f"{name}.unit{su}", c, cout, k, norm=not only,
                              act=not only)
            c = cout
        self._conv(f"{name}.residual", cin, cout, (1, 1, 1))

    def _attention(self, name, c, k):
        self._convolution(f"{name}.conv1", c, c // 2, k, norm=False,
                          act=False)
        self._convolution(f"{name}.conv2", c // 2, 1, k, norm=False,
                          act=False)

    def _build(self):
        ch, n = self.channels, self.n
        cin = self.in_channels
        for i in range(n):
            self._resunit(f"down_{i}", cin, ch[i], self.kernels[i],
                          self.subunits)
            self._convolution(f"downsample_{i}", ch[i], ch[i],
                              self.sample_kernels[i])
            cin = ch[i]
        if self.attention:
            self._attention("bottom_att", ch[n - 1], self.kernels[n])
        self._resunit("bottom", ch[n - 1], ch[n], self.kernels[n],
                      self.subunits)
        for i in reversed(range(n)):
            self._convolution(f"upsample_{i}", ch[i + 1], ch[i],
                              self.sample_kernels[i], transposed=True)
            if self.attention:
                self._attention(f"upatt_{i}", 2 * ch[i], self.kernels[i])
            outc = self.out_channels if i == 0 else ch[i]
            self._resunit(f"up_{i}", 2 * ch[i], outc, self.kernels[i], 1,
                          last_conv_only=(i == 0))

    def trainable(self) -> List[str]:
        """The names of the parameters (the BatchNorm running statistics
        are state, not parameters)."""
        return [name for name, _, kind, _ in self.spec
                if kind not in ("mean", "var")]

    # ---- forward
    def forward(self, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                prec: str = "f32"):
        """(logits, attention maps coarsest first) of NCDHW `x`. At train
        BatchNorm normalises by the batch's statistics and dropout draws
        its masks from `generator`, in the order of the forward."""
        run = _Run(self, p, train, generator, prec)
        ch, n = self.channels, self.n
        skips = []
        for i in range(n):
            x = run.resunit(f"down_{i}", x, self.kernels[i], self.subunits)
            skips.append(x)
            x = run.convolution(f"downsample_{i}", x, self.sample_kernels[i],
                                self.strides[i])
        atts = []
        if self.attention:
            att = run.attention("bottom_att", x, self.kernels[n])
            atts.append(att)
            x = att * x + x
        x = run.resunit("bottom", x, self.kernels[n], self.subunits)
        for i in reversed(range(n)):
            x = run.convolution(f"upsample_{i}", x, self.sample_kernels[i],
                                self.strides[i], transposed=True)
            x = torch.cat([skips[i], x], dim=1)
            if self.attention:
                att = run.attention(f"upatt_{i}", x, self.kernels[i])
                atts.append(att)
                x = att * x + x
            x = run.resunit(f"up_{i}", x, self.kernels[i], 1,
                            last_conv_only=(i == 0))
        return x, atts


class _Run:
    """One forward's parameters, mode and precision."""

    def __init__(self, net, p, train, generator, prec):
        self.net, self.p, self.train = net, p, train
        self.generator, self.prec = generator, prec

    def conv(self, name, x, k, stride=(1, 1, 1), transposed=False,
             padding=None):
        k = tuple(k)
        pad = same_padding(k) if padding is None else padding
        s = np.asarray(stride)
        outpad = (tuple(int(v) for v in s + 2 * np.asarray(pad)
                        - (np.asarray(k) - 1) - 1)
                  if transposed else (0, 0, 0))
        return conv(x, self.p[f"{name}.kernel"], self.p[f"{name}.bias"],
                    _dhw(stride), _dhw(pad), self.prec, transposed,
                    _dhw(outpad))

    def norm(self, name, y):
        scale, shift = self.p[f"{name}.scale"], self.p[f"{name}.bias"]
        shape = (1, -1, 1, 1, 1)
        if self.train:
            axes = (0, 2, 3, 4)
            mean = y.mean(axes)
            var = (y * y).mean(axes) - mean * mean
        else:
            mean, var = self.p[f"{name}.mean"], self.p[f"{name}.var"]
        inv = torch.rsqrt(var + BN_EPS) * scale
        return (y - mean.view(shape)) * inv.view(shape) + shift.view(shape)

    def drop(self, y):
        if not self.train or self.net.dropout == 0.0:
            return y
        thresh = int(round((1.0 - self.net.dropout) * DROPOUT_WORDS))
        n, c, d, h, w = y.shape
        words = torch.randint(0, DROPOUT_WORDS, (n, d, h, w, c),
                              generator=self.generator, device=y.device,
                              dtype=torch.int32).permute(0, 4, 1, 2, 3)
        keep = thresh / DROPOUT_WORDS
        return torch.where(words < thresh, y / keep, torch.zeros_like(y))

    def convolution(self, name, x, k, stride=(1, 1, 1), transposed=False,
                    norm=True, act="prelu", dropout=True):
        y = self.conv(f"{name}.conv", x, k, stride, transposed)
        if norm:
            y = self.norm(f"{name}.norm", y)
        if dropout:
            y = self.drop(y)
        if act == "prelu":
            a = self.p[f"{name}.act.alpha"]
            y = torch.clamp_min(y, 0) + a * torch.clamp_max(y, 0)
        elif act == "relu":
            y = torch.relu(y)
        elif act == "sigmoid":
            y = torch.sigmoid(y)
        return y

    def resunit(self, name, x, k, subunits, last_conv_only=False):
        y = x
        for su in range(subunits):
            if last_conv_only and su == subunits - 1:
                y = self.conv(f"{name}.unit{su}.conv", y, k)
            else:
                y = self.convolution(f"{name}.unit{su}", y, k)
        return y + self.conv(f"{name}.residual", x, (1, 1, 1),
                             padding=(0, 0, 0))

    def attention(self, name, x, k):
        a1 = self.convolution(f"{name}.conv1", x, k, norm=False, act="relu",
                              dropout=False)
        return self.convolution(f"{name}.conv2", a1, k, norm=False,
                                act="sigmoid", dropout=False)


# ------------------------------------------------------------------ weights

def make_weights(net: RefNet, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of `net` from `seed`, made on `device` by one uniform
    draw: kernels and biases U(-b, b) with torch's default b = 1/sqrt(fan
    in) (a transposed conv's fan is Cout x taps), BatchNorm scale 1 +/- 0.1,
    shift +/- 0.1, running mean +/- 0.2 and variance in [0.5, 1.5), so that
    the eval fold is not the identity, and PReLU slopes in [0.15, 0.35)."""
    sizes = [int(np.prod(shape)) for _, shape, _, _ in net.spec]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=gen, device=device,
                   dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, kind, fan), size in zip(net.spec, sizes):
        v = u[off:off + size].view(shape)
        off += size
        if kind in ("kernel", "bias"):
            b = 1.0 / math.sqrt(fan)
            v = (2.0 * v - 1.0) * b
        elif kind == "scale":
            v = 0.9 + 0.2 * v
        elif kind == "shift":
            v = 0.2 * v - 0.1
        elif kind == "mean":
            v = 0.4 * v - 0.2
        elif kind == "var":
            v = 0.5 + v
        elif kind == "alpha":
            v = 0.15 + 0.2 * v
        out[name] = v.contiguous()
    return out


# ----------------------------------------------------------- sliding window

def window_starts(size: Sequence[int], roi: Sequence[int],
                  overlap: float) -> List[Tuple[int, int, int]]:
    """Window starts over a volume of `size` (MONAI 0.4 dense_patch_slices:
    interval int(roi (1 - overlap)), or roi where the dimension equals it;
    ceil(size / interval) starts a dimension, each moved back to fit)."""
    per_dim = []
    for dim, r in zip(size, roi):
        interval = r if r == dim else int(r * (1 - overlap))
        if interval == 0:
            per_dim.append([0])
            continue
        per_dim.append([min(i * interval, dim - r)
                        for i in range(int(math.ceil(dim / interval)))])
    return [(a, b, c) for a in per_dim[0] for b in per_dim[1]
            for c in per_dim[2]]


def gaussian_map(roi: Sequence[int], sigma_scale: float, device):
    """MONAI 0.4's importance map: a centre impulse through a separable
    Gaussian filter (sigma = sigma_scale * roi, truncated at 4 sigma),
    scaled to a maximum of 1; zeros take the least nonzero value."""
    imp = torch.ones((), dtype=torch.float64, device=device)
    for axis, r in enumerate(roi):
        sigma = sigma_scale * r
        tail = int(4.0 * sigma + 0.5)
        x = torch.arange(r, dtype=torch.float64, device=device) - r // 2
        g = torch.exp(-0.5 * (x / sigma) ** 2)
        g = torch.where(x.abs() > tail, torch.zeros_like(g), g)
        shape = [1] * len(roi)
        shape[axis] = r
        imp = imp * g.view(shape)
    imp = (imp / imp.max()).float()
    if (imp == 0).any():
        imp = torch.where(imp == 0, imp[imp > 0].min(), imp)
    return imp


def blend_volume(net: RefNet, p, image: torch.Tensor, roi, overlap: float,
                 sigma_scale: float, prec: str = "f32") -> torch.Tensor:
    """Blended logits (O, H, W, D) of a (H, W, D) float32 volume at least
    as large as `roi` (H, W, D), one window at a time."""
    size = tuple(image.shape)
    imp = gaussian_map(_dhw(roi), sigma_scale, image.device)
    vol = image.permute(2, 0, 1)                 # (D, H, W)
    acc = w_acc = None
    rd, rh, rw = _dhw(roi)
    with torch.no_grad():
        for h0, w0, d0 in window_starts(size, roi, overlap):
            win = vol[d0:d0 + rd, h0:h0 + rh, w0:w0 + rw][None, None]
            logits, _ = net.forward(p, win.float(), prec=prec)
            if acc is None:
                acc = torch.zeros((logits.shape[1], *vol.shape),
                                  dtype=torch.float32, device=vol.device)
                w_acc = torch.zeros(vol.shape, dtype=torch.float32,
                                    device=vol.device)
            sl = (slice(d0, d0 + rd), slice(h0, h0 + rh),
                  slice(w0, w0 + rw))
            acc[(slice(None),) + sl] += logits[0].float() * imp
            w_acc[sl] += imp
    return (acc / w_acc).permute(0, 2, 3, 1)     # (O, H, W, D)


def hard_dice(labelmap: torch.Tensor, label: torch.Tensor) -> float:
    """Dice of the foreground of a labelmap against a binary label (the
    background left out), with the smoothing term of the metric."""
    p = (labelmap > 0).double()
    t = (label > 0).double()
    inter = (p * t).sum()
    return float((2.0 * inter + DICE_SMOOTH)
                 / (p.sum() + t.sum() + DICE_SMOOTH))


# --------------------------------------------------------------------- loss

def spvpa_loss(logits: torch.Tensor, atts: Sequence[torch.Tensor],
               label: torch.Tensor, supervised_attention: bool,
               hardness: bool) -> torch.Tensor:
    """Dice-spvPA: the soft Dice of each attention map against the label
    max-pooled to its size (finest first, each 1/L), plus the Dice of the
    softmax over both classes, each voxel weighted by 0.6 |p - onehot| +
    0.4 (not detached). NCDHW logits, label (N, 1, D, H, W)."""
    t = label.float()
    att_loss = logits.new_zeros(())
    if supervised_attention and atts:
        n_lv = len(atts)
        g = t[:, 0]
        for level in range(n_lv):
            att = atts[n_lv - level - 1][:, 0].float()
            if att.shape[1:] != g.shape[1:]:
                g = F.max_pool3d(g[:, None], [a // b for a, b in zip(
                    g.shape[1:], att.shape[1:])])[:, 0]
            inter = (g * att).sum((1, 2, 3))
            den = g.sum((1, 2, 3)) + att.sum((1, 2, 3))
            att_loss = att_loss + (1.0 - (2.0 * inter + DICE_SMOOTH)
                                   / (den + DICE_SMOOTH)).mean() / n_lv
    probs = torch.softmax(logits.float(), dim=1)
    onehot = torch.cat([(t == c).float()
                        for c in range(logits.shape[1])], dim=1)
    w = (HARDNESS_LAMBDA * (probs - onehot).abs() + (1.0 - HARDNESS_LAMBDA)
         if hardness else torch.ones_like(probs))
    axes = (2, 3, 4)
    inter = (w * onehot * probs).sum(axes)
    den = (w * onehot).sum(axes) + (w * probs).sum(axes)
    pred_loss = (1.0 - (2.0 * inter + DICE_SMOOTH)
                 / (den + DICE_SMOOTH)).mean()
    return att_loss + pred_loss


def adam_update(p: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: Dict[str, list], step: int, lr: float, wd: float,
                betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One Adam step with L2 weight decay added to the gradient before the
    moments (Kingma & Ba; torch.optim.Adam's coupled decay), in place."""
    b1, b2 = betas
    for name, g in grads.items():
        g = g + wd * p[name]
        m, v = state.setdefault(name, [torch.zeros_like(g),
                                       torch.zeros_like(g)])
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
        p[name] = p[name] - (lr / (1 - b1 ** step)) * m / denom


def train_steps(net: RefNet, p0: Dict[str, torch.Tensor], crops, *,
                seed: int, lr: float, wd: float, supervised_attention: bool,
                hardness: bool, betas=(0.9, 0.999), eps: float = 1e-8,
                prec: str = "f32", device=None):
    """Follow the program's first steps from the same weights: `crops` is
    a list of (image (1, 1, D, H, W), label (1, 1, D, H, W)) float32
    tensors, one a step. Dropout masks come from a generator seeded with
    `seed` on `device`, drawn in forward order. Returns (losses, the first
    gradient of each parameter as Adam takes it (decay included), the
    parameters after the last step)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    names = net.trainable()
    p = {k: v.clone() for k, v in p0.items()}
    state: Dict[str, list] = {}
    losses, first = [], None
    for step, (image, label) in enumerate(crops, start=1):
        leaves = {k: p[k].detach().requires_grad_(True) for k in names}
        cur = dict(p, **leaves)
        logits, atts = net.forward(cur, image, train=True, generator=gen,
                                   prec=prec)
        loss = spvpa_loss(logits, atts, label, supervised_attention,
                          hardness)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        grads = dict(zip(names, grads))
        if first is None:
            first = {k: g + wd * p[k] for k, g in grads.items()}
        with torch.no_grad():
            adam_update(p, grads, state, step, lr, wd, betas, eps)
        losses.append(float(loss.detach()))
    return losses, first, p
