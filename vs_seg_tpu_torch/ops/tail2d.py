"""The kd = 1 decoder tail: conv2 + sigmoid + gate + unit0 + 1x1 residual,
given the attention conv1 output a1, as one csrc/tail2d.cu launch.

Replaces vs_seg_tpu/ops/experimental/pallas_tail2d.py:tail_block
(_tail2d_kernel), at up_0 (the logit head) and up_1:

    att    = sigmoid(conv2(a1) + b2)                            Ca -> 1
    ga, gb = att * xa + xa, att * xb + xb
    out    = act(conv0(ga || gb) * bn_scale + bn_shift; alpha)
             + (conv1x1(ga || gb, wr) + br)                    2Ch -> Cout

every conv (3,3,1), stride 1, same padding; the logit head is bn_scale=None,
bn_shift=bias, alpha=None. As in the JAX model the attention conv1 that
makes a1 (relu(conv1(xa || xb) + b1)) stays a library conv.

The TPU kernel tap-packs conv2 and, when 4*Cout <= cp, unit0 with its
residual into the lanes of a few MXU products, and double-buffers the slab
DMAs across grid steps: layout devices for the MXU. The port's kernel
(csrc/tail2d.cu) computes the tail per TH x 64 tile of one (n, d) plane in
one launch: a1 staged in shared memory with its halo, conv2 as kw-shift
tap partials, the gate loading xa and xb itself and keeping att and the
gated pair in shared memory, conv0 and the residual on the tensor cores
with A in registers; `plan_tail` is its launch geometry, as the kernel
computes it. It takes Ca, Ch in {8, 16, 24, 32} and Cout <= 32 (`tail_fusable`: up_1,
32 || 32 -> 32, and the up_0 head, 16 || 16 -> 2); another shape runs the
attgate + conv333 chain (ops/l2block.py:gate_conv0, with ga and gb in device
memory), by that shape rule alone, counted in `tail_block.chain_calls`. The
TPU eligibility rules (`can_tail2d`, `pick_cp`, W*cp % 128, H % 8) are
Mosaic tiling rules: the port routes on semantics alone.

Rounding, as the TPU kernel rounds: att in float32, the gated halves rounded
to the working dtype before conv0. (The TPU kernel also rounds conv2's three
per-row tap partials to the working dtype before summing them: within the
bf16 band.)

What bounds it on the H100: memory (the reads of a1, xa and xb; see the
kernel's source).

`tail_block` runs the kernel for CUDA tensors and `tail_block_plain` for
CPU tensors, and counts its fused CUDA launches in `tail_block.launches`.
It returns (out, att), att the (N, D, H, W, 1) map, so the model's att_maps
stay complete.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.block2d import (PITCH, SMEM_MAX, TW, check_kd1,
                                          pack_w2_hilo)
from vs_seg_tpu_torch.ops.conv333 import (KC, _check_act, _epi, _ptr,
                                          conv333, conv333_plain,
                                          packed_weights)
from vs_seg_tpu_torch.ops.l2block import attgate, attgate_plain, gate_conv0

# csrc/tail2d.cu's geometry (TW and PITCH as block2d's)
WIDTHS = (8, 16, 24, 32)  # the Ca and Ch it takes
MAX_COUT = 32
# tile heights, in the order the plan prefers them: the first that fits
# in shared memory and in the registers (a warpgroup of the four holds
# th / 4 output rows of N / 2 accumulators of conv0 and as many of the
# residual: th * N <= 256)
TAIL_TILES = (16, 8)
NWG = 4
TAIL_EPI = 4              # f32 rows of N: s, h, slope, br (then b2)


def tail_fusable(ca: int, ch: int, cout: int) -> bool:
    """Whether csrc/tail2d.cu takes a tail with a1 of ca channels, pair
    halves of ch channels each and cout outputs (else tail_block runs the
    attgate + conv333 chain)."""
    return ca in WIDTHS and ch in WIDTHS and 1 <= cout <= MAX_COUT


class TailPlan(NamedTuple):
    """One launch of csrc/tail2d.cu: N width n of conv0 (Cout rounded up to
    8, 16 or 32), the 16-channel chunks of a1 (ka) and of each pair half
    (kx), the tile height th; m64 tiles of R (ma) and of the output (mo),
    rows of the x slot (xr), the tile counts; the shared-memory layout
    (byte offsets, as the kernel's `layout`) and its size."""
    n: int
    ka: int
    kx: int
    th: int
    ma: int
    mo: int
    xr: int
    tiles_w: int
    tiles_h: int
    tiles: int
    layout: dict
    smem: int


def tail_layout(n: int, th: int, ka: int, kx: int) -> dict:
    """csrc/tail2d.cu's `layout`: the m64 tiles of the output (mo: one a
    row) and of R (ma: every a1 position of the tap partials an att of the
    gate reads, the gated grid's rows h0 - 1 to h0 + th, columns w0 - 1 to
    w0 + 64, 2 rows on) and the rows of the x slot (xr: the gated grid's),
    then byte offsets and sizes of the x slot (2 kx 8-channel planes per
    pair half), a1's 2 ka planes (8 spare positions for conv2's kw shift),
    R's three f32 arrays, the weight slabs w2, w0, wr and the epilogue
    vectors."""
    mo = th
    ma = -(-((th + 3) * PITCH + 66) // 64)
    xr = th + 2
    lay = dict(mo=mo, ma=ma, xr=xr, xplane=xr * PITCH * 16,
               apitch=(ma * 64 + 8) * 16, rpitch=ma * 64 * 4,
               w2_bytes=ka * 3 * KC * 16 * 2,
               w0_bytes=2 * kx * 9 * KC * n * 2,
               wr_bytes=2 * kx * KC * n * 2)
    lay["off_a"] = 2 * 2 * kx * lay["xplane"]
    lay["off_r"] = lay["off_a"] + 2 * ka * lay["apitch"]
    lay["off_w2"] = lay["off_r"] + 3 * lay["rpitch"]
    lay["off_w0"] = lay["off_w2"] + lay["w2_bytes"]
    lay["off_wr"] = lay["off_w0"] + lay["w0_bytes"]
    lay["off_epi"] = lay["off_wr"] + lay["wr_bytes"]
    lay["smem"] = lay["off_epi"] + (TAIL_EPI * n + 4) * 4
    return lay


@functools.lru_cache(maxsize=256)
def plan_tail(shape, ca: int, ch: int, cout: int,
              th: Optional[int] = None) -> TailPlan:
    """The launch's geometry for a1 (N, D, H, W) of ca channels, pair
    halves of ch channels and cout output channels. th None: the first of
    TAIL_TILES that fits (th * N <= 256, and the shared memory); raises
    for widths the kernel does not take."""
    if not tail_fusable(ca, ch, cout):
        raise ValueError(f"tail_block: the kernel takes Ca, Ch in {WIDTHS} "
                         f"and 1 <= Cout <= {MAX_COUT}, got Ca {ca}, "
                         f"{ch} || {ch} -> {cout}")
    n_, d, h, w = shape
    if h * w * cout >= 2 ** 31:
        raise ValueError(f"tail_block: a plane of {h} x {w} x {cout} "
                         f"outputs is past the kernel's 2^31")
    n = 8 if cout <= 8 else 16 if cout <= 16 else 32
    ka, kx = -(-ca // KC), -(-ch // KC)
    if th is not None and (th not in TAIL_TILES or th * n > 256):
        raise ValueError(f"tail_block: no tile of height {th} at N {n}")
    cands = [t for t in TAIL_TILES if t * n <= 256 and th in (None, t)]
    fit = [(t, lay) for t in cands
           if (lay := tail_layout(n, t, ka, kx))["smem"] <= SMEM_MAX]
    if not fit:
        raise ValueError(f"tail_block: no tile fits {SMEM_MAX} bytes of "
                         f"shared memory")
    th, lay = fit[0]
    tiles_w, tiles_h = -(-w // TW), -(-h // th)
    return TailPlan(n=n, ka=ka, kx=kx, th=th, ma=lay["ma"], mo=lay["mo"],
                    xr=lay["xr"], tiles_w=tiles_w, tiles_h=tiles_h,
                    tiles=n_ * d * tiles_h * tiles_w, layout=lay,
                    smem=lay["smem"])


def packed_tail(w2, w0, wr, ca: int, ch: int, n: int, dev):
    """(w2, w0, wr) packed as csrc/tail2d.cu reads them, cached on each
    weight tensor (ops/conv333.py:packed_weights)."""
    pair = (ch, ch)
    return (packed_weights(w2, "tail_block", (ca,), 16, dev, pack_w2_hilo),
            packed_weights(w0, "tail_block", pair, n, dev),
            packed_weights(wr, "tail_block", pair, n, dev))


_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
             + [ctypes.c_void_p])


def _lib():
    lib = _build.load("tail2d")
    _build.bind(lib, "tail2d_launch", _ARGTYPES)
    return lib


def tail_block_plain(a1: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                     **params):
    """PyTorch twin of tail_block; returns (out, att)."""
    check_kd1("tail_block", params["w2"], params["w0"])
    return gate_conv0(conv333_plain, attgate_plain, a1, xa, xb, **params)


def tail_block(a1: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor, *,
               th: Optional[int] = None, **params):
    """Fused eval kd = 1 decoder tail. a1 (N, D, H, W, Ca) = relu(att
    conv1); xa, xb the pair halves (N, D, H, W, Ch); params as
    ops/l2block.py:gate_conv0: w2 (3,3,1,Ca,1), b2 (1,); w0 (3,3,1,2Ch,Cout)
    with the folded eval BatchNorm affine bn_scale/bn_shift (including the
    conv bias), or the logit head via bn_scale=None, bn_shift=bias,
    alpha=None; wr (1,1,1,2Ch,Cout), br (Cout,). Returns (out (N, D, H, W,
    Cout), att (N, D, H, W, 1)). CUDA tensors (bf16, contiguous, 16-byte
    aligned) take one launch of csrc/tail2d.cu where tail_fusable (th
    forces its tile height; None: the plan's), else the attgate + conv333
    chain."""
    if a1.device.type == "cpu":
        return tail_block_plain(a1, xa, xb, **params)
    if a1.device.type != "cuda":
        raise ValueError(f"tail_block: unsupported device {a1.device}")
    w2, w0, wr = params["w2"], params["w0"], params["wr"]
    check_kd1("tail_block", w2, w0)
    n_, d, h, w, ca = a1.shape
    ch, cout = int(xa.shape[-1]), int(w0.shape[4])
    if xb.shape[-1] != ch or (
            tuple(w2.shape) != (3, 3, 1, ca, 1)
            or tuple(w0.shape) != (3, 3, 1, 2 * ch, cout)
            or tuple(wr.shape) != (1, 1, 1, 2 * ch, cout)):
        raise ValueError(f"tail_block: weights {tuple(w2.shape)}, "
                         f"{tuple(w0.shape)}, {tuple(wr.shape)} do not "
                         f"match a1 of {ca} and pair halves of {ch} and "
                         f"{int(xb.shape[-1])} channels")
    if not tail_fusable(ca, ch, cout):
        _build.count(tail_block, "chain_calls")
        return gate_conv0(conv333, attgate, a1, xa, xb, **params)
    _check_act((a1, xa, xb), "tail_block", a1.shape[:4])
    if any(v.data_ptr() % 16 for v in (a1, xa, xb)):
        raise ValueError("tail_block: the kernel's 16-byte copies need "
                         "16-byte aligned a1, xa and xb")
    if a1.numel() == 0:
        raise ValueError(f"tail_block: empty input {tuple(a1.shape)}")
    p = plan_tail((n_, d, h, w), ca, ch, cout, th)
    dev = a1.device
    w2p, w0p, wrp = packed_tail(w2, w0, wr, ca, ch, p.n, dev)
    b2 = _epi(params["b2"], 1, dev, one=True)
    s, sh = (_epi(params["bn_scale"], cout, dev),
             _epi(params["bn_shift"], cout, dev))
    al = _epi(params["alpha"], cout, dev, one=True)
    br = _epi(params["br"], cout, dev)
    out = torch.empty((n_, d, h, w, cout), dtype=torch.bfloat16, device=dev)
    att = torch.empty((n_, d, h, w, 1), dtype=torch.bfloat16, device=dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = _lib()
    err = lib.tail2d_launch(
        _ptr(a1), _ptr(xa), _ptr(xb), _ptr(w2p), _ptr(w0p), _ptr(wrp),
        _ptr(b2), _ptr(s), _ptr(sh), _ptr(al),
        al.numel() if al is not None else 1, _ptr(br), _ptr(out), _ptr(att),
        n_, d, h, w, ca, ch, cout, p.th, idx,
        torch._C._cuda_getCurrentRawStream(idx))
    _build.check(lib, err, "tail_block")
    _build.count(tail_block)
    return out, att


tail_block.launches = 0
tail_block.chain_calls = 0
