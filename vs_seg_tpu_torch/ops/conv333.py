"""(3,3,kd) stride-1 same-padded conv, kd in {1, 3}, with a fused epilogue
and an optional fused 1x1x1 residual: the conv primitive of the encoder and
decoder blocks. Its kernel's stride-2 instance is ops/dsconv.py's.

Replaces vs_seg_tpu/ops/pallas_conv333.py:conv333. As in the JAX package it
is not dispatched on its own from the model; ops/rublock.py and
ops/l2block.py are built from it at kd = 3, ops/block2d.py and
ops/tail2d.py at kd = 1 (the (3,3,1) "2.5D" levels).

    y   = conv(x, w)                       x a tensor or a pair (xa, xb)
    y   = act(y * scale + shift)           act: PReLU(alpha), ReLU is alpha 0
    out = y + (conv1x1(xr, wr) + br)       optional residual, after the act

With `gate` (an f32 attention map), every input, the residual's included,
is gated first, x -> att * x + x rounded to x.dtype, as the kernel's gated
instance does on its staged halos: ops/l2block.py's conv0 on a pair that
never reaches device memory gated.

`conv333` runs the hand-written kernel (csrc/conv333.cu) for CUDA tensors and
`conv333_plain`, the PyTorch twin, for CPU tensors; any other device raises.
The CUDA route counts its launches in `conv333.launches`, the gated ones
in `conv333.gated_launches`. The kernel reads
its weights in wgmma's core-matrix layout (`pack_weights_gmma`), packed once
per weight tensor and cached on it (`packed_weights`) until the tensor is
changed in place. `launch` is the one call into the kernel's C launcher,
shared with ops/dsconv.py.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from vs_seg_tpu_torch.ops import _build

KC = 16        # the kernels' K chunk: input channels are padded to this
# csrc/conv333.cu: the N widths (output channels per block) it is built
# for; a wider Cout is split into equal N tiles
N_TILES = (8, 16, 32, 48, 64, 80, 96)


def as_pair(x) -> tuple:
    """A tensor or a pair (xa, xb) standing for its channel concat -> tuple."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _conv_sum(xs: Sequence[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
    """sum_i conv(xs[i], w[..., ci, :]) in float32, each conv in x.dtype,
    same-padded (a 1x1x1 w pads nothing).

    w is (kh, kw, kd, sum Ci, Cout); the pair halves read consecutive input
    channel slices, as vs_seg_tpu/nn/layers.py:Conv3d does."""
    pad = (w.shape[2] // 2, w.shape[0] // 2, w.shape[1] // 2)
    y = None
    c0 = 0
    for x in xs:
        ci = x.shape[-1]
        wt = w[..., c0:c0 + ci, :].to(x.dtype).permute(4, 3, 2, 0, 1)
        yi = F.conv3d(x.permute(0, 4, 1, 2, 3), wt, padding=pad).float()
        y = yi if y is None else y + yi
        c0 += ci
    return y.permute(0, 2, 3, 4, 1)


def gate_plain(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """att * x + x in float32, rounded to x.dtype: the gate of csrc/
    attgate.cu and of conv333's gated instance. x (N, D, H, W, C); gate
    (N, D, H, W) float32."""
    g = gate[..., None].float()
    return (g * x.float() + x.float()).to(x.dtype)


def conv333_plain(x, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  alpha: Optional[torch.Tensor] = None,
                  residual=None, gate: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """PyTorch twin of the conv333 kernel (any device, any float dtype).

    x: (N, D, H, W, Cin) or a pair; w: (3, 3, kd, Cin_total, Cout) in the
    JAX (kh, kw, kd) order, kd in {1, 3}; scale/shift: (Cout,) f32 or None;
    alpha: the PReLU slope ((1,) or (Cout,)), or None for no activation;
    residual: None or
    (xr, wr, br) with xr a tensor or pair, wr (1, 1, 1, Cr, Cout), br (Cout,);
    gate: None or the attention map (N, D, H, W) float32, applied to x and
    xr (gate_plain). Convs run in x.dtype; the epilogue runs in
    float32 on the conv outputs; the result has x.dtype."""
    xs = as_pair(x)
    if gate is not None:
        xs = tuple(gate_plain(v, gate) for v in xs)
    y = _conv_sum(xs, w)
    if scale is not None:
        y = y * scale.float()
    if shift is not None:
        y = y + shift.float()
    if alpha is not None:
        y = torch.where(y >= 0, y, alpha.float() * y)
    if residual is not None:
        xr, wr, br = residual
        xr = as_pair(xr)
        if gate is not None:
            xr = tuple(gate_plain(v, gate) for v in xr)
        y = y + (_conv_sum(xr, wr) + br.float())
    return y.to(xs[0].dtype)


def _ntile(cout: int, widths: Sequence[int] = N_TILES):
    """(N, cop): conv333.cu's N width and the padded Cout its N tiles cover:
    Cout split into ceil(Cout / widths[-1]) equal parts, each rounded up to
    the next of `widths` (the widths the kernel is built for)."""
    parts = -(-cout // widths[-1])
    per = -(-cout // parts)
    n = next(t for t in widths if t >= per)
    return n, parts * n


def _pad16(c: int) -> int:
    return -(-c // KC) * KC


def pack_weights_gmma(w: torch.Tensor, cins: Sequence[int], n: int
                      ) -> torch.Tensor:
    """(kh, kw, kd, sum Ci, Cout) -> bf16 (ntiles, chunks, kd, kh*kw, n/8,
    2, 8, 8) as csrc/conv333.cu reads it: per N tile of n output channels,
    per 16-channel chunk (each input's channels zero-padded to a multiple of
    16, the inputs stacked), per depth tap, per tap kh*3 + kw, the 16 x n
    slab as wgmma's K-major core matrices [8 output channels][8-channel
    half][output channel][input channel]. Cout is zero-padded to
    ntiles * n."""
    kh, kw, kd, _, cout = w.shape
    ntiles = -(-cout // n)
    blocks = []
    c0 = 0
    for ci in cins:
        blk = w[:, :, :, c0:c0 + ci, :]
        blocks.append(F.pad(blk, (0, ntiles * n - cout, 0, _pad16(ci) - ci)))
        c0 += ci
    wp = torch.cat(blocks, dim=3)
    chunks = wp.shape[3] // KC
    # (kh, kw, kd, chunk, half, ci, nt, ng, co)
    wp = wp.reshape(kh, kw, kd, chunks, 2, 8, ntiles, n // 8, 8)
    wp = wp.permute(6, 3, 2, 0, 1, 7, 4, 8, 5)
    return wp.reshape(ntiles, chunks, kd, kh * kw, n // 8, 2, 8, 8).to(
        torch.bfloat16).contiguous()


class _PackCache(dict):
    """Packed copies of one weight tensor, by use: (key, packed). A copy or a
    pickle of the tensor starts with an empty cache."""

    def __deepcopy__(self, memo):
        return _PackCache()

    def __reduce__(self):
        return (_PackCache, ())


def packed_weights(w: torch.Tensor, use: str, cins: Sequence[int], n: int,
                   device, pack=None) -> torch.Tensor:
    """w packed for a kernel (`pack(w_on_device, cins, n)`, by default
    pack_weights_gmma), cached on w itself under `use` and keyed by
    (w._version, cins, n, device): an in-place update of w (an optimizer
    step, load_state_dict) repacks; a new tensor starts with no cache."""
    key = (w._version, tuple(cins), n, torch.device(device))
    cache = w.__dict__.get("_vs_packed")
    if cache is None:
        cache = w._vs_packed = _PackCache()
    hit = cache.get(use)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        p = (pack or pack_weights_gmma)(w.detach().to(device), cins, n)
    cache[use] = (key, p)
    return p


def _check_act(xs, name: str, ref_shape=None):
    for v in xs:
        if v.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on the same CUDA "
                             f"device, got {v.device}")
        if v.dtype != torch.bfloat16:
            raise TypeError(f"{name}: kernel takes bfloat16, got {v.dtype}")
        if v.dim() != 5 or not v.is_contiguous():
            raise ValueError(f"{name}: needs contiguous (N, D, H, W, C) "
                             f"tensors, got shape {tuple(v.shape)}")
        if ref_shape is not None and tuple(v.shape[:4]) != tuple(ref_shape):
            raise ValueError(f"{name}: spatial shapes differ: "
                             f"{tuple(v.shape[:4])} vs {tuple(ref_shape)}")


def _epi(v: Optional[torch.Tensor], cout: int, dev, one: bool = False):
    """An epilogue vector as conv333.cu reads it in place: None stays None
    (the kernel's default), else contiguous float32 on `dev` with cout
    entries (or 1, where `one` allows a single value)."""
    if v is None:
        return None
    if v.dim() != 1 or v.dtype != torch.float32 or v.device != dev:
        v = v.reshape(-1).to(dev, torch.float32)
    if v.numel() == 1 and not one:
        v = v.expand(cout)
    if v.numel() not in ((1, cout) if one else (cout,)):
        raise ValueError(f"epilogue vector has {v.numel()} entries, "
                         f"expected 1 or {cout}")
    return v.contiguous()


def _tma_ready(xs, memo: dict):
    """The activations as csrc/conv333.cu's TMA maps take them: channels a
    multiple of 8 (zero-padded, in a copy) and a 16-byte aligned base; a
    tensor met twice (the decoder blocks' residual is the conv's own input)
    is prepared once."""
    out = []
    for v in xs:
        got = memo.get(id(v))
        if got is None:
            c = int(v.shape[-1])
            got = v
            if c % 8:
                got = F.pad(v, (0, 8 - c % 8))
            elif v.data_ptr() % 16:
                got = v.clone()
            memo[id(v)] = got
        out.append(got)
    return out


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's address (None: NULL) for a launcher's c_void_p argument;
    every launcher declares its argtypes, so ctypes converts the int."""
    return None if t is None else t.data_ptr()


def _ch(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.shape[-1]


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] * 4
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 10 + [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p])


def _lib():
    lib = _build.load("conv333")
    _build.bind(lib, "conv333_launch", _ARGTYPES)
    return lib


def launch(out: torch.Tensor, xs, wm: torch.Tensor, n_t: int, cop: int,
           kd: int, scale=None, shift=None, alpha=None, rs=(), wr=None,
           rbias=None, stride: int = 1, th: int = 0, gate=None,
           what: str = "conv333") -> None:
    """One launch of csrc/conv333.cu on the current stream of out's device;
    raises if the launcher refuses it. The arguments are as the kernel
    takes them (prepared by conv333 and ops/dsconv.py:ds_conv, which count
    their own launches): xs/rs up to two TMA-ready inputs each (C % 8 == 0,
    16-byte aligned), wm/wr packed by pack_weights_gmma for N width n_t
    over cop output channels, the epilogue vectors from _epi; out the
    contiguous bf16 output. stride 2 (kd 3, one input, no residual, even
    W) takes th, the tile height (8 or 16); stride 1 takes th = 0. gate:
    None or the contiguous f32 map (N, D, H, W) that the gated instance
    (stride 1) applies to every staged input."""
    xa = xs[0]
    xb = xs[1] if len(xs) > 1 else None
    ra = rs[0] if rs else None
    rb = rs[1] if len(rs) > 1 else None
    n, d, h, w = xa.shape[:4]
    dev = out.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _lib()
    err = lib.conv333_launch(
        _ptr(xa), xa.shape[-1], _ptr(xb), _ch(xb), _ptr(ra), _ch(ra),
        _ptr(rb), _ch(rb), _ptr(wm), _ptr(wr), _ptr(scale), _ptr(shift),
        _ptr(alpha), alpha.numel() if alpha is not None else 1, _ptr(rbias),
        _ptr(out), n, d, h, w, out.shape[-1], n_t, cop, kd, stride, th,
        _ptr(gate), idx, torch._C._cuda_getCurrentRawStream(idx))
    _build.check(lib, err, what)


def conv333(x, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
            shift: Optional[torch.Tensor] = None,
            alpha: Optional[torch.Tensor] = None,
            residual=None, gate: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """(3,3,kd) conv + epilogue (+ residual), optionally gated; see
    conv333_plain for the arguments. CUDA tensors go to the hand-written
    kernel (bf16 activations, contiguous NDHWC, one device, a contiguous
    float32 gate), CPU tensors to conv333_plain."""
    xs = as_pair(x)
    dev = xs[0].device
    if dev.type == "cpu":
        return conv333_plain(x, w, scale, shift, alpha, residual, gate)
    if dev.type != "cuda":
        raise ValueError(f"conv333: unsupported device {dev}")
    if len(xs) > 2:
        raise ValueError("conv333: at most a pair of inputs")
    shape = xs[0].shape[:4]
    _check_act(xs, "conv333", shape)
    cins = [int(v.shape[-1]) for v in xs]
    if tuple(w.shape[:3]) not in ((3, 3, 3), (3, 3, 1)) \
            or w.shape[3] != sum(cins):
        raise ValueError(f"conv333: weight {tuple(w.shape)} does not match "
                         f"inputs with {cins} channels")
    cout = int(w.shape[4])
    n_t, cop = _ntile(cout)
    wm = packed_weights(w, "conv333", cins, n_t, dev)
    scale, shift = _epi(scale, cout, dev), _epi(shift, cout, dev)
    alpha = _epi(alpha, cout, dev, one=True)
    rs, wrp, rbias = (), None, None
    if residual is not None:
        xr, wr, br = residual
        rs = as_pair(xr)
        if len(rs) > 2:
            raise ValueError("conv333: at most a pair of residual inputs")
        _check_act(rs, "conv333 residual", shape)
        crs = [int(v.shape[-1]) for v in rs]
        if tuple(wr.shape) != (1, 1, 1, sum(crs), cout):
            raise ValueError(f"conv333: residual weight {tuple(wr.shape)} "
                             f"does not match {crs} -> {cout}")
        wrp = packed_weights(wr, "conv333", crs, n_t, dev)
        rbias = _epi(br, cout, dev)
    if gate is not None and (
            gate.device != dev or gate.dtype != torch.float32
            or not gate.is_contiguous() or tuple(gate.shape) != tuple(shape)):
        raise ValueError(f"conv333: gate must be a contiguous float32 "
                         f"{tuple(shape)} map on {dev}, got "
                         f"{tuple(gate.shape)} {gate.dtype} on {gate.device}")
    out = torch.empty((*shape, cout), dtype=torch.bfloat16, device=dev)
    memo = {}
    launch(out, _tma_ready(xs, memo), wm, n_t, cop, int(w.shape[2]), scale,
           shift, alpha, _tma_ready(rs, memo), wrp, rbias, gate=gate)
    _build.count(conv333, "launches" if gate is None else "gated_launches")
    return out


conv333.launches = 0
conv333.gated_launches = 0
