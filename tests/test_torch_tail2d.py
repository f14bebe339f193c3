"""The port's fused (3,3,1) decoder tail kernel (csrc/tail2d.cu, through
ops/tail2d.py:tail_block) held on the CPU by its launch plan and by an
emulation that follows it tile by tile.

The kernel runs only on the card (tests/test_torch_cuda.py and chip_smoke.py
hold it against tail_block_plain there). Here `emulate_tail_block` walks the
plan's tiles as the kernel does, on a NaN-filled copy of a block's shared
memory laid out by tail2d.tail_layout: a1's box of each tile (TH + 4 rows
from h0 - 2, 68 columns from w0 - 2) and the xa and xb boxes (TH + 2 rows
from h0 - 1, 66 columns from w0 - 1), zero-filled outside the image, as
8-channel planes (the planes past Ca or Ch zero, every position the kernel
does not stage left NaN); conv2 as the kernel's tap partials, each m64
tile's A operand read through the kernel's wgmma descriptor arithmetic
(start, LBO, SBO) per 16-channel chunk and kw, B from the packed w2 slabs
(columns kh and 8 + kh the hi and lo terms of w2[kh, kw]), into R's three
f32 arrays; the gate at every position of the (TH + 2) x (TW + 2) grid
that lies in the image (att = sigmoid(b2 + R[0][q] + R[1][q + P] + R[2][q +
2P]), each pair half rounded IN PLACE over its staged planes); conv0 per
tap and chunk and the 1x1 residual at the gated position o + P + 1 from the
gated planes; the epilogue prelu(acc * s + h) + (residual + br) and the
masked store. In float32 it must equal tail_block_plain on the kernel's
weights (w0, wr rounded to bf16, w2 to its hi + lo) to EMU_TOL of the
largest output, and the JAX Pallas tail_block in interpret mode (as
tests/test_torch_block2d.py runs it); with bf16 inputs, the gated pair and
the output rounded as the kernel rounds them, within KERNEL_TOL
(chip_smoke.py's band) of both. Inputs come from numpy with a fixed seed.

The kernel's edge zeroing is checked by mutation: the emulation with a1
staged without its zero fill outside the image (conv2's padding), or with
the pair staged without it (which is at once conv0's padding and the gated
pair's _halo_zero: the gate leaves x's zeros in place), must disagree with
the twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vs_seg_tpu.ops.experimental import pallas_tail2d
from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.models import UNet2d5_spvPA
from vs_seg_tpu_torch.ops import block2d, tail2d

EMU_TOL = 1e-5            # float32 emulation vs twin, relative to max|ref|
KERNEL_TOL = 2e-2         # chip_smoke.py's bf16 band, kernel vs twin


def _params(rng, ca, ch, cout, head, alpha_vec=False):
    def w(k, ci, co):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        return rng.uniform(-b, b, size=(*k, ci, co)).astype(np.float32)

    def v(n, lo, hi):
        return rng.uniform(lo, hi, size=(n,)).astype(np.float32)

    p = dict(w2=w((3, 3, 1), ca, 1), b2=v(1, -.3, .3),
             w0=w((3, 3, 1), 2 * ch, cout), wr=w((1, 1, 1), 2 * ch, cout),
             br=v(cout, -.3, .3))
    if head:     # the conv-only logit head: scale 1, shift = bias, identity
        p.update(bn_scale=None, bn_shift=v(cout, -.3, .3), alpha=None)
    else:
        p.update(bn_scale=v(cout, .5, 1.5), bn_shift=v(cout, -.3, .3),
                 alpha=v(cout if alpha_vec else 1, .1, .4))
    return p


def _hilo(w):
    hi = w.to(torch.bfloat16).float()
    return hi + (w - hi).to(torch.bfloat16).float()


def _torch(p, kernel_weights=True):
    """numpy params -> torch (None stays None); the conv weights as the
    kernel holds them when asked: w0, wr rounded to bf16, w2 to its bf16
    hi + lo."""
    out = {}
    for k, a in p.items():
        t = None if a is None else torch.from_numpy(a)
        if kernel_weights and k in ("w0", "wr"):
            t = t.to(torch.bfloat16).float()
        if kernel_weights and k == "w2":
            t = _hilo(t)
        out[k] = t
    return out


def _jax(p):
    return {k: None if v is None else jnp.asarray(v.numpy())
            for k, v in p.items()}


def _inputs(rng, shape, ca, ch, dtype=torch.float32):
    """a1 = relu(normal) with ca channels, xa and xb with ch."""
    a1 = torch.from_numpy(rng.normal(size=(*shape, ca)).astype(
        np.float32)).relu()
    xa, xb = (torch.from_numpy(rng.normal(size=(*shape, ch)).astype(
        np.float32)) for _ in range(2))
    return a1.to(dtype), xa.to(dtype), xb.to(dtype)


def _desc(flat, starts, lbo, sbo, rows=64):
    """(len(starts), rows, 16): the operands a no-swizzle K-major wgmma
    descriptor reads from `flat` (2-byte elements) at each start: row r,
    column k at byte start + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo
    + (k % 8) * 2."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    off = (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    byte = torch.as_tensor(starts)[:, None, None] + off
    return flat[byte // 2]


def _box(img, h0, w0, rows, cols, fill=True):
    """rows x cols x C of an (H, W, C) image from (h0, w0): zero outside
    the image, or (fill=False) the nearest pixel's value there."""
    h, w, c = img.shape
    if not fill:
        hh = torch.clamp(torch.arange(h0, h0 + rows), 0, h - 1)
        ww = torch.clamp(torch.arange(w0, w0 + cols), 0, w - 1)
        return img[hh][:, ww]
    out = torch.zeros((rows, cols, c), dtype=img.dtype)
    lo_h, hi_h = max(h0, 0), min(h0 + rows, h)
    lo_w, hi_w = max(w0, 0), min(w0 + cols, w)
    if hi_h > lo_h and hi_w > lo_w:
        out[lo_h - h0:hi_h - h0, lo_w - w0:hi_w - w0] = \
            img[lo_h:hi_h, lo_w:hi_w]
    return out


def emulate_tail_block(a1, xa, xb, params, th=None, mutate=None):
    """csrc/tail2d.cu tile by tile, in float32 (see the module docstring);
    the gated pair rounded to xa.dtype, the output and att unrounded.
    mutate: None, "a1" (a1 staged without its zero fill outside the image)
    or "x" (the pair staged without it). Returns (out, att, how often each
    output value was stored)."""
    n, d, h, w, ca = a1.shape
    ch = xa.shape[-1]
    cout = params["w0"].shape[-1]
    p = tail2d.plan_tail((n, d, h, w), ca, ch, cout, th)
    lay, N, P, TW = p.layout, p.n, tail2d.PITCH, tail2d.TW
    w2p, w0p, wrp = (t.float().reshape(-1) for t in tail2d.packed_tail(
        params["w2"], params["w0"], params["wr"], ca, ch, N, "cpu"))
    col_in = torch.clamp(torch.arange(N), max=cout - 1)

    def vec(k, dflt):
        v = params[k]
        v = torch.full((cout,), dflt) if v is None else v.float().reshape(-1)
        return (v if v.numel() == cout else v.expand(cout))[col_in]

    s, sh, al, br = (vec("bn_scale", 1.0), vec("bn_shift", 0.0),
                     vec("alpha", 1.0), vec("br", 0.0))
    b2 = float(params["b2"].reshape(-1)[0])
    a1_in = a1.float().reshape(n * d, h, w, ca)
    xs_in = [x.float().reshape(n * d, h, w, ch) for x in (xa, xb)]
    out = torch.zeros((n * d, h, w, cout))
    att = torch.zeros((n * d, h, w, 1))
    stores = torch.zeros((n * d, h, w, cout), dtype=torch.int32)
    xp, ap, rp = lay["xplane"], lay["apitch"], lay["rpitch"] // 4
    ka, kx = p.ka, p.kx

    def xplane(j, pl):              # byte offset of pair half j's plane pl
        return (j * 2 * kx + pl) * xp

    for t in range(p.tiles):                 # the kernel's walk order
        rest = t // p.tiles_w
        tw0 = (t - rest * p.tiles_w) * TW
        th0 = (rest % p.tiles_h) * p.th
        nd = rest // p.tiles_h
        smem = torch.full((p.smem // 2,), float("nan"))
        rs = torch.full((3 * rp,), float("nan"))     # R: f32 in the kernel

        def put(byte, vals):
            smem[byte // 2:byte // 2 + vals.numel()] = vals.reshape(-1)

        def stage(base, box):
            """box (rows, cols, 8) into a plane at byte `base`, row pitch
            P positions of 16 bytes."""
            rows, cols = box.shape[:2]
            rr, cc = torch.meshgrid(torch.arange(rows), torch.arange(cols),
                                    indexing="ij")
            idx = base // 2 + ((rr * P + cc) * 8)[..., None] \
                + torch.arange(8)
            smem[idx] = box

        for off, wp in (("off_w2", w2p), ("off_w0", w0p), ("off_wr", wrp)):
            put(lay[off], wp)
        # the planes past Ca and Ch, zeroed once per block
        for pl in range(ca // 8, 2 * ka):
            put(lay["off_a"] + pl * ap, torch.zeros(ap // 2))
        for j in range(2):
            for pl in range(ch // 8, 2 * kx):
                put(xplane(j, pl), torch.zeros(xp // 2))
        box = _box(a1_in[nd], th0 - 2, tw0 - 2, p.th + 4, TW + 4,
                   fill=mutate != "a1")
        for pl in range(ca // 8):
            stage(lay["off_a"] + pl * ap, box[..., 8 * pl:8 * pl + 8])
        for j, xi in enumerate(xs_in):
            box = _box(xi[nd], th0 - 1, tw0 - 1, p.th + 2, TW + 2,
                       fill=mutate != "x")
            for pl in range(ch // 8):
                stage(xplane(j, pl), box[..., 8 * pl:8 * pl + 8])

        def wslab(off, j, cols):
            return _desc(smem, [lay[off] + j * 16 * cols * 2], 128, 256,
                         cols)[0]

        # conv2 as tap partials, one MMA per chunk and kw
        tiles = torch.arange(p.ma)
        acc = 0
        for c in range(ka):
            for kw in range(3):
                st = lay["off_a"] + 2 * c * ap + tiles * 1024 + kw * 16
                acc = acc + _desc(smem, st, ap, 128) \
                    @ wslab("off_w2", c * 3 + kw, 16).t()
        acc = acc.reshape(-1, 16)
        for kh in range(3):
            rs[kh * rp:kh * rp + p.ma * 64] = acc[:, kh] + acc[:, 8 + kh]
        # the gate at the (th + 2) x (TW + 2) positions that lie in the
        # image, rows from th0 - 1, columns from tw0 - 1
        gr, gc = torch.meshgrid(torch.arange(p.th + 2), torch.arange(TW + 2),
                                indexing="ij")
        gr, gc = gr.reshape(-1), gc.reshape(-1)
        hh, ww = th0 - 1 + gr, tw0 - 1 + gc
        keep = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
        gr, gc, hh, ww = gr[keep], gc[keep], hh[keep], ww[keep]
        q = gr * P + gc
        z = b2 + rs[q] + rs[rp + q + P] + rs[2 * rp + q + 2 * P]
        sg = torch.sigmoid(z)
        own = (gr >= 1) & (gr <= p.th) & (gc >= 1) & (gc <= TW)
        att[nd, hh[own], ww[own], 0] = sg[own]
        for j in range(2):
            for pl in range(ch // 8):
                idx = xplane(j, pl) // 2 + q[:, None] * 8 + torch.arange(8)
                v = smem[idx]
                smem[idx] = (sg[:, None] * v + v).to(xa.dtype).float()
        # conv0 per chunk and tap from the gated pair, an m64 tile per
        # output row (its 64 columns, the gated positions from r * P), the
        # residual at the gated position o + P + 1, then the masked store
        o = torch.arange(p.mo * 64)
        r, cc = o // 64, o % 64
        ok = (th0 + r < h) & (tw0 + cc < w)
        o, r, cc = o[ok], r[ok], cc[ok]
        stores[nd, th0 + r, tw0 + cc] += 1
        tiles = torch.arange(p.mo)
        acc, racc = 0, 0
        for k in range(2 * kx):
            base = xplane(k // kx, 2 * (k % kx)) + tiles * P * 16
            for tap in range(9):
                st = base + ((tap // 3) * P + tap % 3) * 16
                acc = acc + _desc(smem, st, xp, 128) \
                    @ wslab("off_w0", k * 9 + tap, N).t()
            racc = racc + _desc(smem, base + (P + 1) * 16, xp, 128) \
                @ wslab("off_wr", k, N).t()
        acc, racc = acc.reshape(-1, N), racc.reshape(-1, N)
        y = acc * s + sh
        v = torch.where(y >= 0, y, al * y) + (racc + br)
        out[nd, th0 + r, tw0 + cc] = v[o, :cout]
    return (out.reshape(n, d, h, w, cout), att.reshape(n, d, h, w, 1),
            stores)


def _err(got, ref):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    return float((got - ref).abs().max() / ref.abs().max())


# ---- the plan ----------------------------------------------------------

# (N, D, H, W), Ca, Ch, Cout: the flagship's up_1 and up_0 head (8
# windows), then ragged ones and the GPU tests' widths
UP_1 = ((8, 64, 192, 192), 32, 32, 32)
UP_0 = ((8, 64, 384, 384), 16, 16, 2)
RAGGED = (((2, 3, 10, 13), 16, 16, 16), ((1, 2, 37, 130), 32, 32, 32),
          ((3, 1, 7, 5), 8, 8, 2), ((1, 1, 1, 1), 8, 24, 1),
          ((1, 4, 64, 64), 24, 8, 9), ((1, 1, 19, 70), 32, 16, 17))


@pytest.mark.parametrize("shape,ca,ch,cout", (UP_1, UP_0) + RAGGED)
@pytest.mark.parametrize("th", [None, 8, 16])
def test_tail_plan_covers_every_output_once_within_limits(shape, ca, ch,
                                                          cout, th):
    n, d, h, w = shape
    n16 = 32 if cout > 16 else 16 if cout > 8 else 8
    lay16 = tail2d.tail_layout(n16, 16, -(-ca // 16), -(-ch // 16))
    if th == 16 and (n16 == 32 or lay16["smem"] > block2d.SMEM_MAX):
        with pytest.raises(ValueError, match="no tile"):
            tail2d.plan_tail(shape, ca, ch, cout, th)
        return
    p = tail2d.plan_tail(shape, ca, ch, cout, th)
    P = tail2d.PITCH
    if th:
        assert p.th == th
    # tiles cover H x W, none wholly outside
    assert (p.tiles_h - 1) * p.th < h <= p.tiles_h * p.th
    assert (p.tiles_w - 1) * tail2d.TW < w <= p.tiles_w * tail2d.TW
    assert p.tiles == n * d * p.tiles_h * p.tiles_w < 2 ** 31
    assert p.n == (8 if cout <= 8 else 16 if cout <= 16 else 32)
    assert (p.ka, p.kx) == (-(-ca // 16), -(-ch // 16))
    # the m64 tiles: one per output row, TH / 4 rows a warpgroup holding
    # N / 2 accumulators each for conv0 and for the residual; every read a
    # valid output needs lies inside the grid it reads
    assert p.mo == p.th and p.th * p.n <= 256
    # att at the gate's last position (th + 1, 65) reads R[2] 2 rows on
    assert (p.th + 1) * P + 65 + 2 * P < p.ma * 64
    # conv2's kw shift reads two positions past R's tiles: spare ones; the
    # staged a1 box (th + 4 rows, 68 columns) lies in a1's planes
    lay = p.layout
    assert lay["apitch"] >= (p.ma * 64 + 2) * 16
    assert (p.th + 3) * P + 67 < p.ma * 64 + 8
    # conv0 and the residual on the x slot; the staged box inside it
    assert (p.mo - 1) * P + 63 + 2 * P + 2 < p.xr * P
    assert (p.mo - 1) * P + 63 + P + 1 < p.xr * P
    assert (p.th + 1) * P + 65 < p.xr * P
    assert p.smem == lay["smem"] <= block2d.SMEM_MAX
    for k in ("xplane", "apitch", "rpitch", "off_a", "off_r", "off_w2",
              "off_w0", "off_wr"):
        assert lay[k] % 128 == 0, k
    assert lay["off_epi"] % 16 == 0


def test_tail_plan_flagship():
    """up_1 (32 || 32 -> 32) takes 8-row tiles (16 rows fit neither the
    shared memory nor, at N = 32, the registers), the up_0 head (16 || 16
    -> 2) 16-row tiles; one block per SM either way."""
    p = tail2d.plan_tail(*UP_1)
    assert (p.n, p.ka, p.kx, p.th) == (32, 2, 2, 8)
    assert (p.ma, p.mo, p.xr) == (14, 8, 10)
    assert p.smem == 205328
    assert p.tiles == 8 * 64 * 24 * 3
    assert tail2d.plan_tail(*UP_1) is p                   # cached per shape
    assert tail2d.tail_layout(32, 16, 2, 2)["smem"] > block2d.SMEM_MAX
    q = tail2d.plan_tail(*UP_0)
    assert (q.n, q.ka, q.kx, q.th) == (8, 1, 1, 16)
    assert (q.ma, q.mo, q.xr) == (23, 16, 18)
    assert q.smem == 154768
    assert q.tiles == 8 * 64 * 24 * 6
    for pl in (p, q):
        assert 2 * (pl.smem + 1024) > block2d.SMEM_SM


@pytest.mark.parametrize("ca,ch,cout,th", [
    (12, 16, 16, None), (16, 12, 16, None), (40, 32, 32, None),
    (32, 48, 32, None), (32, 32, 33, None), (32, 32, 0, None),
    (16, 16, 2, 12), (16, 16, 2, 24), (16, 16, 2, 0), (16, 16, 32, 16)])
def test_tail_plan_refuses_what_the_kernel_cannot_take(ca, ch, cout, th):
    with pytest.raises(ValueError, match="tail_block"):
        tail2d.plan_tail((1, 1, 16, 16), ca, ch, cout, th)
    assert tail2d.tail_fusable(ca, ch, cout) == (
        ca in (8, 16, 24, 32) and ch in (8, 16, 24, 32) and 1 <= cout <= 32)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: drives tail_block's CUDA
    routing on the CPU."""

    @property
    def device(self):
        return torch.device("cuda:0")


@pytest.mark.parametrize("ca,ch,cout", [(12, 12, 12), (32, 40, 32),
                                        (16, 16, 48)])
def test_tail_block_takes_the_chain_past_the_kernel(monkeypatch, ca, ch,
                                                    cout):
    """A shape outside tail_fusable runs the attgate + conv333 chain,
    counted in chain_calls and not in launches (the chain's two wrappers
    replaced by recorders that run their twins)."""
    rng = np.random.default_rng(20)
    a1, xa, xb = _inputs(rng, (1, 2, 9, 11), ca, ch)
    p = _torch(_params(rng, ca, ch, cout, False), kernel_weights=False)
    calls = []

    def gate(a1_, w2, b2, xa_, xb_):
        calls.append("attgate")
        return tail2d.attgate_plain(*(v.as_subclass(torch.Tensor)
                                      for v in (a1_,)), w2, b2,
                                    xa_.as_subclass(torch.Tensor),
                                    xb_.as_subclass(torch.Tensor))

    def conv(*args, **kw):
        calls.append("conv333")
        return tail2d.conv333_plain(*args, **kw)

    monkeypatch.setattr(tail2d, "attgate", gate)
    monkeypatch.setattr(tail2d, "conv333", conv)
    n0, k0 = tail2d.tail_block.launches, tail2d.tail_block.chain_calls
    got = tail2d.tail_block(*(v.as_subclass(_OnCard) for v in (a1, xa, xb)),
                            **p)
    assert calls == ["attgate", "conv333"]
    assert (tail2d.tail_block.launches, tail2d.tail_block.chain_calls) == (
        n0, k0 + 1)
    for g, r in zip(got, tail2d.tail_block_plain(a1, xa, xb, **p)):
        assert torch.equal(g.as_subclass(torch.Tensor), r)


def test_tail_w2_partials_reproduce_conv2_at_32_channels():
    """The packed w2 slabs at Ca = 32 (two K chunks) as the kernel uses
    them: per chunk and kw one product of a1 shifted by kw, columns kh (hi)
    + 8 + kh (lo) summed over chunks and kw, then summed over kh at row
    shifts, is conv2 with the f32 weights to ~16 bits."""
    rng = np.random.default_rng(7)
    hh, ww, c = 9, 14, 32
    a1 = torch.from_numpy(rng.normal(size=(hh, ww, c)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(3, 3, 1, c, 1)).astype(
        np.float32))
    flat = block2d.pack_w2_hilo(w2, (c,), 16).float().reshape(-1)
    assert flat.numel() == 2 * 3 * 16 * 16
    pad = F.pad(a1, (0, 0, 1, 1, 1, 1))                    # (hh+2, ww+2, c)
    r = 0
    for ck in range(2):
        for kw in range(3):
            slab = _desc(flat, [(ck * 3 + kw) * 512], 128, 256, 16)[0]
            r = r + pad[:, kw:kw + ww, 16 * ck:16 * ck + 16] @ slab.t()
    part = r[..., :3] + r[..., 8:11]
    got = sum(part[kh:kh + hh, :, kh] for kh in range(3))
    ref = F.conv2d(a1.permute(2, 0, 1)[None],
                   w2[:, :, 0, :, 0].permute(2, 0, 1)[None], padding=1)[0, 0]
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert not r[..., 3:8].any() and not r[..., 11:].any()


# ---- the emulation -----------------------------------------------------

@pytest.mark.parametrize("shape,ca,ch,cout,head,th", [
    ((1, 2, 19, 70), 32, 32, 32, False, None),   # up_1's widths, ragged
    ((2, 1, 9, 13), 32, 32, 32, False, None),    # ... one-tile planes
    ((1, 2, 20, 70), 16, 16, 2, True, None),     # the head, ragged H and W
    ((2, 1, 12, 20), 16, 16, 2, True, 8),        # the head, one tile wide
    ((1, 1, 21, 30), 8, 24, 9, False, None),     # Ca 8, Ch 24, Cout 9
    ((1, 2, 10, 66), 24, 8, 17, False, 8),       # Ca 24, Ch 8, Cout 17
    ((1, 1, 17, 64), 32, 16, 16, True, None),    # a linear unit at N 16
])
def test_tail_emulation_matches_plain(shape, ca, ch, cout, head, th):
    rng = np.random.default_rng(11)
    a1, xa, xb = _inputs(rng, shape, ca, ch)
    p = _torch(_params(rng, ca, ch, cout, head, alpha_vec=cout == 9))
    got, att, stores = emulate_tail_block(a1, xa, xb, p, th)
    assert bool((stores == 1).all())            # every output stored once
    ref, ref_att = tail2d.tail_block_plain(a1, xa, xb, **p)
    assert _err(got, ref) <= EMU_TOL
    assert _err(att, ref_att) <= EMU_TOL


@pytest.mark.parametrize("mutate", ["a1", "x"])
def test_tail_emulation_without_edge_zeroing_disagrees(mutate):
    """Dropping either zero fill at the image's edge breaks the tail:
    without a1's, conv2 reads pixels past the edge as its padding; without
    the pair's, conv0 reads ungated pixels past the edge as its."""
    rng = np.random.default_rng(12)
    shape, c, cout = (1, 1, 19, 70), 32, 32
    a1, xa, xb = _inputs(rng, shape, c, c)
    a1 = a1 + 0.5                               # a1 > 0 at the edge
    p = _torch(_params(rng, c, c, cout, False))
    ref, ref_att = tail2d.tail_block_plain(a1, xa, xb, **p)
    got, att, _ = emulate_tail_block(a1, xa, xb, p)
    assert _err(got, ref) <= EMU_TOL
    bad, bad_att, _ = emulate_tail_block(a1, xa, xb, p, mutate=mutate)
    assert _err(bad, ref) > 100 * EMU_TOL
    if mutate == "a1":
        assert _err(bad_att, ref_att) > 100 * EMU_TOL


# Pallas' tiling rules: W * cp % 128 == 0 with W * cp / 128 % 8 == 0
PALLAS_CASES = [((1, 2, 16, 64), 32, 32, 32, False),    # up_1's widths
                ((2, 1, 16, 64), 16, 16, 2, True)]      # the up_0 head


@pytest.mark.parametrize("shape,ca,ch,cout,head", PALLAS_CASES)
def test_tail_emulation_matches_pallas(shape, ca, ch, cout, head):
    rng = np.random.default_rng(13)
    a1, xa, xb = _inputs(rng, shape, ca, ch)
    p = _torch(_params(rng, ca, ch, cout, head))
    ref = np.array(pallas_tail2d.tail_block(
        *(jnp.asarray(v.numpy()) for v in (a1, xa, xb)), cout=cout,
        cp=pallas_tail2d.pick_cp(ca, ch, cout), interpret=True, **_jax(p)))
    got, _, _ = emulate_tail_block(a1, xa, xb, p)
    assert _err(got, torch.from_numpy(ref)) <= EMU_TOL


@pytest.mark.parametrize("shape,ca,ch,cout,head", PALLAS_CASES)
def test_tail_emulation_bf16_matches_pallas_and_plain(shape, ca, ch, cout,
                                                      head):
    """bf16 activations and weights, the gated pair rounded to bf16 and the
    output rounded once (the kernel's rounding): within KERNEL_TOL of the
    Pallas kernel and of the plain twin."""
    rng = np.random.default_rng(14)
    a1, xa, xb = _inputs(rng, shape, ca, ch, torch.bfloat16)
    p = _torch(_params(rng, ca, ch, cout, head))
    got, att, _ = emulate_tail_block(a1, xa, xb, p)
    got = got.to(torch.bfloat16)
    ref_p = torch.from_numpy(np.asarray(pallas_tail2d.tail_block(
        *(jnp.asarray(v.float().numpy(), jnp.bfloat16) for v in (a1, xa, xb)),
        cout=cout, cp=pallas_tail2d.pick_cp(ca, ch, cout), interpret=True,
        **_jax(p)), np.float32))
    ref_t, ref_att = tail2d.tail_block_plain(a1, xa, xb, **p)
    for ref in (ref_p, ref_t):
        assert _err(got, ref) <= KERNEL_TOL
    assert _err(att.to(torch.bfloat16), ref_att) <= KERNEL_TOL


def test_tail_block_cpu_runs_the_plain_twin_uncounted():
    rng = np.random.default_rng(15)
    for ca, ch, cout, head in ((32, 32, 32, False), (16, 16, 2, True),
                               (12, 12, 12, False)):
        a1, xa, xb = _inputs(rng, (1, 2, 9, 11), ca, ch)
        p = _torch(_params(rng, ca, ch, cout, head), kernel_weights=False)
        n0 = tail2d.tail_block.launches
        k0 = tail2d.tail_block.chain_calls
        got = tail2d.tail_block(a1, xa, xb, **p)
        for g, r in zip(got, tail2d.tail_block_plain(a1, xa, xb, **p)):
            assert torch.equal(g, r)
        assert tail2d.tail_block.launches == n0
        assert tail2d.tail_block.chain_calls == k0


def test_model_hands_the_tail_a_contiguous_a1(monkeypatch):
    """Under Routes(tail2d0, tail2d1) the model's a1 (the library conv1's
    output) reaches tail_block NDHWC-contiguous at both levels, so the
    kernel reads it in place with no copy."""
    seen = []
    plain = tail2d.tail_block_plain

    def spy(a1, xa, xb, **kw):
        seen.append((int(a1.shape[-1]), a1.is_contiguous(),
                     xa.is_contiguous(), xb.is_contiguous()))
        return plain(a1, xa, xb, **kw)

    monkeypatch.setattr(tail2d, "tail_block_plain", spy)
    gen = torch.Generator().manual_seed(0)
    model = UNet2d5_spvPA(channels=(8, 16, 24), strides=((2, 2, 1),
                                                          (2, 2, 1)),
                          kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3)),
                          sample_kernel_sizes=((3, 3, 1), (3, 3, 1)),
                          dropout=None, dtype=torch.float32, device="cpu",
                          generator=gen).eval()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 4, 16, 16, 1)).astype(np.float32))
    with torch.no_grad():
        model(x, routes=Routes(tail2d0=True, tail2d1=True))
    assert sorted(s[0] for s in seen) == [8, 16]
    assert all(all(s[1:]) for s in seen)
