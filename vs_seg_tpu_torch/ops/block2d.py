"""The kd = 1 ("2.5D") block forms of the flagship's levels 0-1: one encoder
ResidualUnit (one csrc/rublock2d.cu launch) or one decoder attention block
(one csrc/l2block2d.cu launch where C, Cout <= 16, else conv333 at kd = 1
and attgate launches).

Replaces vs_seg_tpu/ops/experimental/pallas_block2d.py:

  ru_block2d (_ru2d_kernel), down_0 / down_1:
    u0  = prelu(conv0(x) * bn0_scale + bn0_shift; alpha0)      Cin  -> Cout
    out = prelu(conv1(u0) * bn1_scale + bn1_shift; alpha1)     Cout -> Cout
          + (conv1x1(x, wr) + br)
  l2_block2d (_l2_2d_kernel), up_0 / up_1:
    a1     = relu(conv1(xa || xb) + b1)                        2C -> C
    att    = sigmoid(conv2(a1) + b2)                            C -> 1
    ga, gb = att * xa + xa, att * xb + xb
    out    = act(conv0(ga || gb) * bn_scale + bn_shift; alpha)
             + (conv1x1(ga || gb, wr) + br)                    2C -> Cout

every conv (3,3,1), stride 1, same padding. The i == 0 logit head is the
degenerate epilogue bn_scale=None, bn_shift=bias, alpha=None (identity),
Cout = 2. bn*_scale/bn*_shift are folded eval BatchNorm affines that already
include the conv bias (nn/blocks.py:folded_conv_affine).

The TPU kernels compute one H row tile of one plane end to end over banded
Toeplitz matrices at channels padded to cp in {16, 32}, recomputing the H
halo. The port's kernels do the same per 2-D tile in one launch:
ru_block2d (csrc/rublock2d.cu: u0 stays in shared memory, Cin = 1 packs
conv0's 9 taps into one K slice, x is read in place; `plan` is its launch
geometry, as the kernel computes it; Cin, Cout <= 32) and l2_block2d
(csrc/l2block2d.cu: a1, the conv2 tap partials, att and the gated pair
stay in shared memory, the pair gated in place over the staged xa, xb;
`plan_l2`; C, Cout <= 16, which takes the up_0 logit head). A wider
l2_block2d (up_1, 32 || 32 -> 32, under Routes(l2block2d=True) without
tail2d1) runs the conv333 + attgate + conv333 chain, by that shape rule
alone (`l2_fusable`), with a1, ga and gb in device memory; its launches
count under conv333 and attgate, and `l2_block2d.chain_calls` counts it.
The TPU eligibility rules (`can_block2d`, `pick_cp` <= 64, W*cp % 128,
H % 8, the VMEM budget of `pick_ht_2d`) are Mosaic tiling rules: the port
routes on semantics alone, and its kernels take ragged tiles.

Rounding, as the TPU kernels round: u0 and a1 to the working dtype before
the next conv; att in float32 into the gate (returned in the working
dtype); the gated halves rounded before conv0.

What bounds them on the H100: ru_block2d's bound is its output write (down_0)
or about even between bytes and the tensor rate (down_1); l2_block2d's is
the read of xa and xb (bytes); see the kernels' sources. Both are held back
by their instruction streams (PERF.md).

`ru_block2d` and `l2_block2d` run the kernels for CUDA tensors and their
`_plain` twins for CPU tensors, and count their fused CUDA launches in
`.launches`. Returns: ru_block2d the output; l2_block2d (out, att), att the
(N, D, H, W, 1) map, so the model's att_maps stay complete.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from typing import NamedTuple, Optional

import torch

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import (KC, _check_act, _epi, _ptr,
                                          conv333, conv333_plain,
                                          pack_weights_gmma, packed_weights)
from vs_seg_tpu_torch.ops.l2block import attgate, attgate_plain, l2_chain
from vs_seg_tpu_torch.ops.rublock import ru_chain

# csrc/rublock2d.cu's geometry
TW = 64                   # output tile width
PITCH = 72                # row pitch (positions) of every tile grid
# Cin = 1: x staged from column w0 - 8 in rows of XPITCH positions, XOFF of
# them before the halo's first column w0 - 2
XPITCH, XOFF = 80, 6
MAX_C = 32                # the Cin and Cout it takes
# (tile height, x ring slots), in the order the plan prefers them (on the
# H100 the plan's pick was the fastest of the four at down_0 and down_1:
# attgate_ab --kernel ru_block2d --rb-tiles)
TILES = ((16, 2), (16, 1), (8, 2), (8, 1))
SMEM_MAX = 227 * 1024     # dynamic shared memory a block may use (H100)
SMEM_SM = 228 * 1024      # shared memory of an SM, 1 KB of it per block


def check_kd1(name: str, *ws: torch.Tensor) -> None:
    """Raise unless every conv weight is (3, 3, 1, Cin, Cout)."""
    for w in ws:
        if tuple(w.shape[:3]) != (3, 3, 1):
            raise ValueError(f"{name}: expected (3, 3, 1, Cin, Cout) conv "
                             f"weights, got {tuple(w.shape)}")


def ru_block2d_plain(x: torch.Tensor, **params) -> torch.Tensor:
    """PyTorch twin of ru_block2d (any device, any float dtype)."""
    check_kd1("ru_block2d", params["w0"], params["w1"])
    return ru_chain(conv333_plain, x, **params)


class Plan(NamedTuple):
    """One launch of csrc/rublock2d.cu: N width n (Cout rounded up to 16 or
    32), x's 16-channel chunks (0: Cin = 1, conv0's taps packed), tile
    height th and x ring slots; m64 tiles of u0 (m0) and of the output
    (m1), staged x rows xr, the tile counts; whether x can be staged by
    TMA (given a 16-byte aligned base); the shared-memory layout (byte
    offsets, as the kernel's `layout`) and its size."""
    n: int
    chunks: int
    th: int
    stages: int
    m0: int
    m1: int
    xr: int
    tiles_w: int
    tiles_h: int
    tiles: int
    tma: bool
    layout: dict
    smem: int


def smem_layout(n: int, chunks: int, th: int, stages: int) -> dict:
    """csrc/rublock2d.cu's `layout`: the m64 tiles of u0 (m0) and the staged
    x rows (xr) of a tile of height th, then byte offsets and sizes of the x
    slots, the packed taps, u0, the weight slabs, the epilogue vectors and
    the ring's barriers."""
    m0 = -(-(th + 2) * PITCH // 64)
    xr = -(-(m0 * 64 + 2 * PITCH + 2) // PITCH)
    pack = chunks == 0
    xplane = -(-xr * XPITCH * 2 // 128) * 128 if pack else xr * PITCH * 16
    lay = dict(m0=m0, xr=xr, xplane=xplane,
               xslot=xplane if pack else 2 * chunks * xplane,
               upitch=m0 * 64 * 16,
               w0_bytes=(1 if pack else 9 * chunks) * KC * n * 2,
               w1_bytes=(n // KC) * 9 * KC * n * 2,
               wr_bytes=(1 if pack else chunks) * KC * n * 2)
    lay["off_pk"] = stages * lay["xslot"]
    lay["off_u"] = lay["off_pk"] + (2 * lay["upitch"] if pack else 0)
    lay["off_w0"] = lay["off_u"] + (n // 8) * lay["upitch"]
    lay["off_w1"] = lay["off_w0"] + lay["w0_bytes"]
    lay["off_wr"] = lay["off_w1"] + lay["w1_bytes"]
    lay["off_epi"] = lay["off_wr"] + lay["wr_bytes"]
    lay["off_bar"] = lay["off_epi"] + 7 * n * 4      # 7 f32 vectors
    lay["smem"] = lay["off_bar"] + 2 * stages * 8
    return lay


@functools.lru_cache(maxsize=256)
def plan(shape, cin: int, cout: int, th: Optional[int] = None,
         stages: Optional[int] = None) -> Plan:
    """The launch's geometry for an input (N, D, H, W) with cin channels and
    cout output channels. th/stages None: the first of TILES whose block
    leaves room for two per SM, else the first that fits; raises for widths
    the kernel does not take."""
    if not (1 <= cin <= MAX_C and 1 <= cout <= MAX_C):
        raise ValueError(f"ru_block2d: the kernel takes 1 <= Cin, Cout <= "
                         f"{MAX_C}, got {cin} -> {cout}")
    n_, d, h, w = shape
    if h * w * cout >= 2 ** 31:
        raise ValueError(f"ru_block2d: a plane of {h} x {w} x {cout} "
                         f"outputs is past the kernel's 2^31")
    n = 16 if cout <= 16 else 32
    chunks = 0 if cin == 1 else -(-cin // KC)
    if th is not None and stages is not None:
        cands = [(th, stages)]
    else:
        cands = [(t, s) for t, s in TILES
                 if th in (None, t) and stages in (None, s)]
    if not cands or any(t % 8 or not 8 <= t <= 64 or s not in (1, 2)
                        for t, s in cands):
        raise ValueError(f"ru_block2d: no tile of height {th} with {stages} "
                         f"slots")
    lays = [(t, s, smem_layout(n, chunks, t, s)) for t, s in cands]
    fit = [c for c in lays if c[2]["smem"] <= SMEM_MAX]
    if not fit:
        raise ValueError(f"ru_block2d: no tile fits {SMEM_MAX} bytes of "
                         f"shared memory at {cin} -> {cout}")
    two = [c for c in fit if 2 * (c[2]["smem"] + 1024) <= SMEM_SM]
    th, stages, lay = (two or fit)[0]
    tiles_w, tiles_h = -(-w // TW), -(-h // th)
    return Plan(n=n, chunks=chunks, th=th, stages=stages, m0=lay["m0"],
                m1=th * PITCH // 64, xr=lay["xr"], tiles_w=tiles_w,
                tiles_h=tiles_h, tiles=n_ * d * tiles_h * tiles_w,
                tma=(w % 8 == 0) if cin == 1 else cin % 8 == 0,
                layout=lay, smem=lay["smem"])


def pack_w0_taps(w0: torch.Tensor, cins, n: int) -> torch.Tensor:
    """Cin = 1: w0 (3, 3, 1, 1, Cout) as one 16 x n slab whose K lane t is
    tap t = kh*3 + kw (lanes 9-15 zero), in pack_weights_gmma's layout."""
    cout = w0.shape[-1]
    k = w0.new_zeros((1, 1, 1, KC, cout))
    k[0, 0, 0, :9] = w0.reshape(9, cout)
    return pack_weights_gmma(k, [KC], n)


def pack_wr_centre(wr: torch.Tensor, cins, n: int) -> torch.Tensor:
    """Cin = 1: wr (1, 1, 1, 1, Cout) in K lane 4 (the centre tap of the
    packed slice) of one 16 x n slab."""
    cout = wr.shape[-1]
    k = wr.new_zeros((1, 1, 1, KC, cout))
    k[0, 0, 0, 4] = wr.reshape(cout)
    return pack_weights_gmma(k, [KC], n)


def packed_unit(w0, w1, wr, cin: int, n: int, dev):
    """(w0, w1, wr) packed as csrc/rublock2d.cu reads them, cached on each
    weight tensor (ops/conv333.py:packed_weights)."""
    cout = w0.shape[-1]
    if cin == 1:
        w0p = packed_weights(w0, "ru_block2d", (1,), n, dev, pack_w0_taps)
        wrp = packed_weights(wr, "ru_block2d", (1,), n, dev, pack_wr_centre)
    else:
        w0p = packed_weights(w0, "ru_block2d", (cin,), n, dev)
        wrp = packed_weights(wr, "ru_block2d", (cin,), n, dev)
    return w0p, packed_weights(w1, "ru_block2d", (cout,), n, dev), wrp


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])


def _lib():
    lib = _build.load("rublock2d")
    _build.bind(lib, "rublock2d_launch", _ARGTYPES)
    return lib


def ru_block2d(x: torch.Tensor, *, th: Optional[int] = None,
               stages: Optional[int] = None, **params) -> torch.Tensor:
    """Fused eval (3,3,1) ResidualUnit. x: (N, D, H, W, Cin); params as
    ops/rublock.py:ru_chain, with w0 (3,3,1,Cin,Cout), w1 (3,3,1,Cout,Cout),
    wr (1,1,1,Cin,Cout); returns (N, D, H, W, Cout). CUDA tensors (bf16,
    contiguous, Cin and Cout <= 32) take one launch of csrc/rublock2d.cu;
    th/stages force its tile height and x ring slots (None: the plan's)."""
    if x.device.type == "cpu":
        return ru_block2d_plain(x, **params)
    if x.device.type != "cuda":
        raise ValueError(f"ru_block2d: unsupported device {x.device}")
    w0, w1, wr = params["w0"], params["w1"], params["wr"]
    check_kd1("ru_block2d", w0, w1)
    _check_act((x,), "ru_block2d")
    n_, d, h, w, cin = x.shape
    cout = w0.shape[4]
    if (tuple(w0.shape) != (3, 3, 1, cin, cout)
            or tuple(w1.shape) != (3, 3, 1, cout, cout)
            or tuple(wr.shape) != (1, 1, 1, cin, cout)):
        raise ValueError(f"ru_block2d: weights {tuple(w0.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(wr.shape)} do not match "
                         f"an input with {cin} channels")
    if x.numel() == 0:
        raise ValueError(f"ru_block2d: empty input {tuple(x.shape)}")
    p = plan((n_, d, h, w), cin, cout, th, stages)
    dev = x.device
    w0p, w1p, wrp = packed_unit(w0, w1, wr, cin, p.n, dev)
    s0, h0 = _epi(params["bn0_scale"], cout, dev), _epi(params["bn0_shift"],
                                                        cout, dev)
    s1, h1 = _epi(params["bn1_scale"], cout, dev), _epi(params["bn1_shift"],
                                                        cout, dev)
    a0 = _epi(params["alpha0"], cout, dev, one=True)
    a1 = _epi(params["alpha1"], cout, dev, one=True)
    br = _epi(params["br"], cout, dev)
    out = torch.empty((n_, d, h, w, cout), dtype=torch.bfloat16, device=dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _lib()
    err = lib.rublock2d_launch(
        _ptr(x), _ptr(w0p), _ptr(w1p), _ptr(wrp), _ptr(s0), _ptr(h0),
        _ptr(a0), a0.numel() if a0 is not None else 1, _ptr(s1), _ptr(h1),
        _ptr(a1), a1.numel() if a1 is not None else 1, _ptr(br), _ptr(out),
        n_, d, h, w, cin, cout, p.th, p.stages, idx,
        torch._C._cuda_getCurrentRawStream(idx))
    _build.check(lib, err, "ru_block2d")
    _build.count(ru_block2d)
    return out


ru_block2d.launches = 0


def l2_block2d_plain(xa: torch.Tensor, xb: torch.Tensor, **params):
    """PyTorch twin of l2_block2d; returns (out, att)."""
    check_kd1("l2_block2d", params["w1"], params["w2"], params["w0"])
    return l2_chain(conv333_plain, attgate_plain, xa, xb, **params)


# csrc/l2block2d.cu's geometry (TW and PITCH as rublock2d's)
L2_MAX_C = 16             # the C and Cout it takes
# (tile height, x ring slots), in the order the plan prefers them; none
# leaves room for two blocks per SM (on the H100 16 x 1 was the fastest at
# the up_0 head: attgate_ab --kernel l2_block2d --l2-tiles)
L2_TILES = ((16, 1), (8, 2), (8, 1))
L2_EPI = 4                # f32 rows of N after b1's 16: s, h, slope, br


def l2_fusable(c: int, cout: int) -> bool:
    """Whether csrc/l2block2d.cu takes a block of pair halves with c
    channels each and cout outputs (else l2_block2d runs the chain)."""
    return 1 <= c <= L2_MAX_C and 1 <= cout <= L2_MAX_C


class L2Plan(NamedTuple):
    """One launch of csrc/l2block2d.cu: N width n of conv0 (Cout rounded up
    to 8 or 16), whether conv0 runs as kw-shift partials (part: Cout <= 2,
    the logit head), tile height th and x ring slots; m64 tiles of a1 and
    R (ma), of the output (mo) and of the partials Z (mg), staged x rows
    xr, the tile counts; whether xa and xb can be staged by 16-byte
    cp.async copies (given 16-byte aligned bases; else plain loads); the
    shared-memory layout (byte offsets, as the kernel's `layout`) and its
    size."""
    n: int
    part: bool
    th: int
    stages: int
    ma: int
    mo: int
    mg: int
    xr: int
    tiles_w: int
    tiles_h: int
    tiles: int
    vec: bool
    layout: dict
    smem: int


def l2_layout(n: int, th: int, stages: int, part: bool = False) -> dict:
    """csrc/l2block2d.cu's `layout`: the m64 tiles of the output (mo), of
    a1 (ma: every a1 position an att of the gate reads, rows h0 - 2 to
    h0 + th + 1, columns w0 - 2 to w0 + 65) and of the partials (mg: the
    gated positions o + kh * P of every output o) and the staged x rows
    (xr) of a tile of height th, then byte offsets and sizes of the x
    slots (four 8-channel planes: xa, xa, xb, xb), a1's two planes (8 spare
    positions for conv2's kw shift; the partials Z reuse them), R's three
    f32 arrays, the weight slabs w1, w2, w0, wr (part: w0 as 2 x 3 kw
    slabs of 8 columns holding wr too) and the epilogue vectors."""
    mo = th * PITCH // 64
    ma = -(-((th + 3) * PITCH + 68) // 64)
    xr = -(-(ma * 64 + 2 * PITCH + 1) // PITCH)
    lay = dict(mo=mo, ma=ma, mg=-(-((th + 1) * PITCH + 64) // 64), xr=xr,
               xplane=xr * PITCH * 16, apitch=(ma * 64 + 8) * 16,
               rpitch=ma * 64 * 4, w1_bytes=2 * 9 * KC * 16 * 2,
               w2_bytes=3 * KC * 16 * 2,
               w0_bytes=2 * 3 * KC * 8 * 2 if part else 2 * 9 * KC * n * 2,
               wr_bytes=0 if part else 2 * KC * n * 2)
    lay["xslot"] = 4 * lay["xplane"]
    lay["off_a"] = stages * lay["xslot"]
    lay["off_r"] = lay["off_a"] + 2 * lay["apitch"]
    lay["off_w1"] = lay["off_r"] + 3 * lay["rpitch"]
    lay["off_w2"] = lay["off_w1"] + lay["w1_bytes"]
    lay["off_w0"] = lay["off_w2"] + lay["w2_bytes"]
    lay["off_wr"] = lay["off_w0"] + lay["w0_bytes"]
    lay["off_epi"] = lay["off_wr"] + lay["wr_bytes"]
    lay["smem"] = lay["off_epi"] + (16 + L2_EPI * n + 4) * 4
    return lay


@functools.lru_cache(maxsize=256)
def plan_l2(shape, c: int, cout: int, th: Optional[int] = None,
            stages: Optional[int] = None) -> L2Plan:
    """The launch's geometry for pair halves (N, D, H, W) of c channels and
    cout output channels. th/stages None: the first of L2_TILES that fits;
    raises for widths the kernel does not take."""
    if not l2_fusable(c, cout):
        raise ValueError(f"l2_block2d: the kernel takes 1 <= C, Cout <= "
                         f"{L2_MAX_C}, got {c} || {c} -> {cout}")
    n_, d, h, w = shape
    if h * w * cout >= 2 ** 31:
        raise ValueError(f"l2_block2d: a plane of {h} x {w} x {cout} "
                         f"outputs is past the kernel's 2^31")
    n, part = (8 if cout <= 8 else 16), cout <= 2
    if th is not None and stages is not None:
        cands = [(th, stages)]
    else:
        cands = [(t, s) for t, s in L2_TILES
                 if th in (None, t) and stages in (None, s)]
    if not cands or any(t % 8 or not 8 <= t <= 64 or s not in (1, 2)
                        for t, s in cands):
        raise ValueError(f"l2_block2d: no tile of height {th} with {stages} "
                         f"slots")
    lays = [(t, s, l2_layout(n, t, s, part)) for t, s in cands]
    fit = [c_ for c_ in lays if c_[2]["smem"] <= SMEM_MAX]
    if not fit:
        raise ValueError(f"l2_block2d: no tile fits {SMEM_MAX} bytes of "
                         f"shared memory")
    th, stages, lay = fit[0]
    tiles_w, tiles_h = -(-w // TW), -(-h // th)
    return L2Plan(n=n, part=part, th=th, stages=stages, ma=lay["ma"],
                  mo=lay["mo"], mg=lay["mg"], xr=lay["xr"], tiles_w=tiles_w,
                  tiles_h=tiles_h, tiles=n_ * d * tiles_h * tiles_w,
                  vec=c % 8 == 0, layout=lay, smem=lay["smem"])


def pack_w2_hilo(w2: torch.Tensor, cins, n: int) -> torch.Tensor:
    """w2 (3, 3, 1, C, 1) as three 16 x 16 slabs, one per kw, in
    pack_weights_gmma's layout: column kh of slab kw holds rn(w2[kh, kw])
    (bf16 hi) and column 8 + kh holds rn(w2[kh, kw] - hi) (bf16 lo), so
    that hi + lo carries about 16 bits of the f32 weight."""
    c = w2.shape[3]
    w = w2[:, :, 0, :, 0].float()                     # (kh, kw, C)
    hi = w.to(torch.bfloat16).float()
    lo = (w - hi).to(torch.bfloat16).float()
    k = w.new_zeros((1, 3, 1, c, 16))
    k[0, :, 0, :, 0:3] = hi.permute(1, 2, 0)          # (kw, C, kh)
    k[0, :, 0, :, 8:11] = lo.permute(1, 2, 0)
    return pack_weights_gmma(k, [c], 16)


def pack_w0_partials(w0: torch.Tensor, wr: torch.Tensor, c: int
                     ) -> torch.Tensor:
    """Cout <= 2: w0 (3, 3, 1, 2C, Cout) and wr (1, 1, 1, 2C, Cout) as six
    16 x 8 slabs (chunk j = pair half j, then kw), in pack_weights_gmma's
    layout: column kh * 2 + co of slab (j, kw) holds w0[kh, kw, half j,
    co], columns 6 + co of the kw = 1 slabs hold wr[half j, co]."""
    cout = w0.shape[4]
    k = w0.new_zeros((1, 3, 1, 2 * c, 8)).float()
    for kh in range(3):
        k[0, :, 0, :, kh * 2:kh * 2 + cout] = w0[kh, :, 0].float()
    k[0, 1, 0, :, 6:6 + cout] = wr[0, 0, 0].float()
    return pack_weights_gmma(k, [c, c], 8)


def packed_block(w1, w2, w0, wr, c: int, n: int, part: bool, dev):
    """(w1, w2, w0, wr) packed as csrc/l2block2d.cu reads them, cached on
    each weight tensor (ops/conv333.py:packed_weights); part: w0 and wr
    together as pack_w0_partials (cached on w0, keyed by wr's version too),
    returned in wr's place as well (the kernel reads no wr slab then)."""
    pair = (c, c)
    w1p = packed_weights(w1, "l2_block2d", pair, 16, dev)
    w2p = packed_weights(w2, "l2_block2d", (c,), 16, dev, pack_w2_hilo)
    if part:
        w0p = packed_weights(
            w0, "l2_block2d partials", (c, wr._version, id(wr)), 8, dev,
            lambda w, cins, n_: pack_w0_partials(w, wr.to(w.device), c))
        return w1p, w2p, w0p, w0p
    return (w1p, w2p, packed_weights(w0, "l2_block2d", pair, n, dev),
            packed_weights(wr, "l2_block2d", pair, n, dev))


_L2_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                + [ctypes.c_void_p])
_log = logging.getLogger(__name__)


def _l2_lib():
    lib = _build.load("l2block2d")
    _build.bind(lib, "l2block2d_launch", _L2_ARGTYPES)
    return lib


def l2_block2d(xa: torch.Tensor, xb: torch.Tensor, *,
               th: Optional[int] = None, stages: Optional[int] = None,
               **params):
    """Fused eval (3,3,1) decoder block. xa, xb: (N, D, H, W, C) pair halves;
    params as ops/l2block.py:l2_chain, with w1 (3,3,1,2C,C), w2
    (3,3,1,C,1), w0 (3,3,1,2C,Cout), wr (1,1,1,2C,Cout); for the i == 0
    logit head bn_scale=None, bn_shift=bias, alpha=None. Returns (out (N, D,
    H, W, Cout), att (N, D, H, W, 1)). CUDA tensors (bf16, contiguous) take
    one launch of csrc/l2block2d.cu where C, Cout <= 16 (th/stages force
    its tile height and x ring slots; None: the plan's), else the conv333 +
    attgate + conv333 chain."""
    if xa.device.type == "cpu":
        return l2_block2d_plain(xa, xb, **params)
    if xa.device.type != "cuda":
        raise ValueError(f"l2_block2d: unsupported device {xa.device}")
    w1, w2, w0, wr = (params[k] for k in ("w1", "w2", "w0", "wr"))
    check_kd1("l2_block2d", w1, w2, w0)
    _check_act((xa, xb), "l2_block2d", xa.shape[:4])
    n_, d, h, w, c = xa.shape
    cout = int(w0.shape[4])
    if xb.shape[4] != c or (
            tuple(w1.shape) != (3, 3, 1, 2 * c, c)
            or tuple(w2.shape) != (3, 3, 1, c, 1)
            or tuple(w0.shape) != (3, 3, 1, 2 * c, cout)
            or tuple(wr.shape) != (1, 1, 1, 2 * c, cout)):
        raise ValueError(f"l2_block2d: weights {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(w0.shape)}, "
                         f"{tuple(wr.shape)} do not match pair halves of "
                         f"{c} and {int(xb.shape[4])} channels")
    if not l2_fusable(c, cout):
        _log.debug("l2_block2d %s x %d -> %d: conv333 + attgate chain",
                   tuple(xa.shape[:4]), c, cout)
        _build.count(l2_block2d, "chain_calls")
        return l2_chain(conv333, attgate, xa, xb, **params)
    if xa.numel() == 0:
        raise ValueError(f"l2_block2d: empty input {tuple(xa.shape)}")
    p = plan_l2((n_, d, h, w), c, cout, th, stages)
    dev = xa.device
    w1p, w2p, w0p, wrp = packed_block(w1, w2, w0, wr, c, p.n, p.part, dev)
    b1, b2 = _epi(params["b1"], c, dev), _epi(params["b2"], 1, dev, one=True)
    s, sh = (_epi(params["bn_scale"], cout, dev),
             _epi(params["bn_shift"], cout, dev))
    al = _epi(params["alpha"], cout, dev, one=True)
    br = _epi(params["br"], cout, dev)
    out = torch.empty((n_, d, h, w, cout), dtype=torch.bfloat16, device=dev)
    att = torch.empty((n_, d, h, w, 1), dtype=torch.bfloat16, device=dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _l2_lib()
    err = lib.l2block2d_launch(
        _ptr(xa), _ptr(xb), _ptr(w1p), _ptr(w2p), _ptr(w0p), _ptr(wrp),
        _ptr(b1), _ptr(b2), _ptr(s), _ptr(sh), _ptr(al),
        al.numel() if al is not None else 1, _ptr(br), _ptr(out), _ptr(att),
        n_, d, h, w, c, cout, p.th, p.stages, idx,
        torch._C._cuda_getCurrentRawStream(idx))
    _build.check(lib, err, "l2_block2d")
    _build.count(l2_block2d)
    return out, att


l2_block2d.launches = 0
l2_block2d.chain_calls = 0
