"""The port's fused (3,3,1) decoder block kernel (csrc/l2block2d.cu, through
ops/block2d.py:l2_block2d) held on the CPU by its launch plan and by an
emulation that follows it tile by tile.

The kernel runs only on the card (tests/test_torch_cuda.py and chip_smoke.py
hold it against l2_block2d_plain there). Here `emulate_l2_block2d` walks the
plan's tiles as the kernel does, on a NaN-filled copy of a block's shared
memory laid out by block2d.l2_layout: the xa and xb halo boxes of each tile
(rows from h0 - 3, PITCH columns from w0 - 3, zero-filled outside the image
and past C) as four 8-channel planes; conv1 with each m64 tile's A operand
read through the kernel's wgmma descriptor arithmetic (start, LBO, SBO) and
B from the packed weight slabs the same way; a1 = relu(. + b1) zeroed
outside the image and rounded to the working dtype into its two planes;
conv2 as the kernel's tap partials (one MMA per kw, the A descriptor
shifted by kw, columns kh and 8 + kh the hi and lo terms of w2[kh, kw])
into R's three f32 arrays; the gate at every position of the (TH + 2) x
(TW + 2) grid that lies in the image (att = sigmoid(b2 + R[0][q] + R[1][q +
P] + R[2][q + 2P]), the pair rounded IN PLACE over the staged x); conv0 and
the 1x1 residual from the gated planes; the masked store. In float32 it
must equal l2_block2d_plain on the kernel's weights (w1, w0, wr rounded to
bf16, w2 to its hi + lo) to EMU_TOL of the largest output, and the JAX
Pallas l2_block2d in interpret mode (as tests/test_torch_block2d.py runs
it); with bf16 inputs, a1, the gated pair and the output rounded as the
kernel rounds them, within KERNEL_TOL (chip_smoke.py's band) of both.
Inputs come from numpy with a fixed seed.

The kernel's edge zeroing is checked by mutation: the emulation without
a1's zeroing outside the image, or with the halo staged without its zero
fill outside the image (which is at once conv1's padding and the gated
pair's _halo_zero: the gate leaves x's zeros in place), must disagree with
the twin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vs_seg_tpu.ops.experimental import pallas_block2d
from vs_seg_tpu_torch.ops import block2d

EMU_TOL = 1e-5            # float32 emulation vs twin, relative to max|ref|
KERNEL_TOL = 2e-2         # chip_smoke.py's bf16 band, kernel vs twin


def _params(rng, c, cout, head, alpha_vec=False):
    def w(k, ci, co):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        return rng.uniform(-b, b, size=(*k, ci, co)).astype(np.float32)

    def v(n, lo, hi):
        return rng.uniform(lo, hi, size=(n,)).astype(np.float32)

    p = dict(w1=w((3, 3, 1), 2 * c, c), b1=v(c, -.3, .3),
             w2=w((3, 3, 1), c, 1), b2=v(1, -.3, .3),
             w0=w((3, 3, 1), 2 * c, cout), wr=w((1, 1, 1), 2 * c, cout),
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
    kernel holds them when asked: w1, w0, wr rounded to bf16, w2 to its
    bf16 hi + lo."""
    out = {}
    for k, a in p.items():
        t = None if a is None else torch.from_numpy(a)
        if kernel_weights and k in ("w1", "w0", "wr"):
            t = t.to(torch.bfloat16).float()
        if kernel_weights and k == "w2":
            t = _hilo(t)
        out[k] = t
    return out


def _jax(p):
    return {k: None if v is None else jnp.asarray(v.numpy())
            for k, v in p.items()}


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


def emulate_l2_block2d(xa, xb, params, th=None, stages=None, mutate=None):
    """csrc/l2block2d.cu tile by tile, in float32 (see the module
    docstring); a1 and the gated pair rounded to xa.dtype, the output and
    att unrounded. mutate: None, "a1" (no zeroing of a1 outside the image)
    or "halo" (the halo staged without its zero fill outside the image).
    Returns (out, att, how often each output value was stored)."""
    n, d, h, w, c = xa.shape
    cout = params["w0"].shape[-1]
    p = block2d.plan_l2((n, d, h, w), c, cout, th, stages)
    lay, N, P, TW = p.layout, p.n, block2d.PITCH, block2d.TW
    w1p, w2p, w0p, wrp = (t.float().reshape(-1) for t in block2d.packed_block(
        params["w1"], params["w2"], params["w0"], params["wr"], c, N, p.part,
        "cpu"))
    co_all = torch.arange(N)
    col_in = torch.clamp(co_all, max=cout - 1)

    def vec(k, dflt):
        v = params[k]
        v = torch.full((cout,), dflt) if v is None else v.float().reshape(-1)
        return (v if v.numel() == cout else v.expand(cout))[col_in]

    s, sh, al, br = (vec("bn_scale", 1.0), vec("bn_shift", 0.0),
                     vec("alpha", 1.0), vec("br", 0.0))
    split = params["bn_scale"] is not None or params["alpha"] is not None
    b1 = F.pad(params["b1"].float(), (0, 16 - c))
    b2 = float(params["b2"].reshape(-1)[0])
    xs_in = [x.float().reshape(n * d, h, w, c) for x in (xa, xb)]
    out = torch.zeros((n * d, h, w, cout))
    att = torch.zeros((n * d, h, w, 1))
    stores = torch.zeros((n * d, h, w, cout), dtype=torch.int32)
    xp, ap, rp = lay["xplane"], lay["apitch"], lay["rpitch"] // 4
    q_a = torch.arange(p.ma * 64)
    for t in range(p.tiles):                 # the kernel's walk order
        rest = t // p.tiles_w
        tw0 = (t - rest * p.tiles_w) * TW
        th0 = (rest % p.tiles_h) * p.th
        nd = rest // p.tiles_h
        smem = torch.full((p.smem // 2,), float("nan"))
        rs = torch.full((3 * rp,), float("nan"))     # R: f32 in the kernel

        def put(byte, vals):
            smem[byte // 2:byte // 2 + vals.numel()] = vals.reshape(-1)

        for off, wp in (("off_w1", w1p), ("off_w2", w2p), ("off_w0", w0p),
                        ("off_wr", wrp[:lay["wr_bytes"] // 2])):
            put(lay[off], wp)
        xs = (t % p.stages) * lay["xslot"]
        for i, xi in enumerate(xs_in):
            box = F.pad(_box(xi[nd], th0 - 3, tw0 - 3, p.xr, P,
                             fill=mutate != "halo"), (0, 16 - c))
            for pl in range(2):
                put(xs + (2 * i + pl) * xp, box[..., 8 * pl:8 * pl + 8])

        def wslab(off, j, cols):
            return _desc(smem, [lay[off] + j * 16 * cols * 2], 128, 256,
                         cols)[0]

        def tap(k):
            return ((k // 3) * P + k % 3) * 16

        # conv1 over the a1 positions, rows from th0 - 2, columns tw0 - 2
        tiles = torch.arange(p.ma)
        acc = 0
        for j in range(2):
            for k in range(9):
                st = xs + 2 * j * xp + tiles * 1024 + tap(k)
                acc = acc + _desc(smem, st, xp, 128) \
                    @ wslab("off_w1", j * 9 + k, 16).t()
        r, cc = q_a // P, q_a % P
        inside = ((th0 - 2 + r >= 0) & (th0 - 2 + r < h)
                  & (tw0 - 2 + cc >= 0) & (tw0 - 2 + cc < w))
        a1 = torch.relu(acc.reshape(-1, 16) + b1)
        if mutate != "a1":
            a1 = torch.where(inside[:, None], a1, 0.0)
        a1 = a1.to(xa.dtype).float()
        for co in range(16):
            smem[(lay["off_a"] + (co // 8) * ap) // 2 + q_a * 8 + co % 8] = \
                a1[:, co]
        # conv2 as tap partials, one MMA per kw
        acc = 0
        for kw in range(3):
            st = lay["off_a"] + tiles * 1024 + kw * 16
            acc = acc + _desc(smem, st, ap, 128) \
                @ wslab("off_w2", kw, 16).t()
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
        xq = q + 2 * P + 2
        for pl in range(4):
            base = (xs + pl * xp) // 2
            idx = base + xq[:, None] * 8 + torch.arange(8)[None]
            v = smem[idx]
            smem[idx] = (sg[:, None] * v + v).to(xa.dtype).float()
        o = torch.arange(p.mo * 64)
        r, cc = o // P, o % P
        ok = (cc < TW) & (th0 + r < h) & (tw0 + cc < w)
        o, r, cc = o[ok], r[ok], cc[ok]
        stores[nd, th0 + r, tw0 + cc] += 1
        if p.part:
            # Cout <= 2: kw-shift partials Z over the gated grid (columns kh
            # * 2 + co, the residual in 6 + co of the kw = 1 slabs), then
            # the sum over kh at the output positions
            tiles = torch.arange(p.mg)
            z = 0
            for j in range(2):
                for kw in range(3):
                    st = (xs + 2 * j * xp + (tiles * 64 + 2 * P + 2) * 16
                          + kw * 16)
                    z = z + _desc(smem, st, xp, 128) \
                        @ wslab("off_w0", j * 3 + kw, 8).t()
            z = z.reshape(-1, 8)
            co = torch.arange(cout)
            y = (z[o][:, co] + z[o + P][:, 2 + co] + z[o + 2 * P][:, 4 + co])
            res = z[o + P][:, 6 + co]
            if split:
                y = y * s[:cout] + sh[:cout]
                v = torch.where(y >= 0, y, al[:cout] * y) + res + br[:cout]
            else:
                v = y + res + sh[:cout] + br[:cout]
            out[nd, th0 + r, tw0 + cc] = v
            continue
        # conv0 from the gated pair, the residual at the output positions
        tiles = torch.arange(p.mo)
        acc = 0
        for j in range(2):
            for k in range(9):
                st = xs + 2 * j * xp + (tiles * 64 + 2 * P + 2) * 16 + tap(k)
                acc = acc + _desc(smem, st, xp, 128) \
                    @ wslab("off_w0", j * 9 + k, N).t()
        racc = 0
        for j in range(2):
            st = xs + 2 * j * xp + (tiles * 64 + 3 * P + 3) * 16
            racc = racc + _desc(smem, st, xp, 128) @ wslab("off_wr", j, N).t()
        acc, racc = acc.reshape(-1, N), racc.reshape(-1, N)
        if split:
            y = acc * s + sh
            v = torch.where(y >= 0, y, al * y) + racc + br
        else:
            v = acc + racc + sh + br
        out[nd, th0 + r, tw0 + cc] = v[o, :cout]
    return (out.reshape(n, d, h, w, cout), att.reshape(n, d, h, w, 1),
            stores)


def _err(got, ref):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    return float((got - ref).abs().max() / ref.abs().max())


# ---- the plan ----------------------------------------------------------

# (N, D, H, W), C, Cout: the flagship's up_0 head (8 windows), then ragged
# ones and the GPU tests' widths
FLAGSHIP = ((8, 64, 384, 384), 16, 2)
RAGGED = (((2, 3, 10, 13), 12, 12), ((1, 2, 37, 130), 16, 16),
          ((3, 1, 7, 5), 8, 2), ((1, 1, 1, 1), 1, 1),
          ((1, 4, 64, 64), 16, 9))


@pytest.mark.parametrize("shape,c,cout", (FLAGSHIP,) + RAGGED)
@pytest.mark.parametrize("tile", [None, (8, 1), (8, 2), (16, 1)])
def test_l2_plan_covers_every_output_once_within_limits(shape, c, cout,
                                                        tile):
    th, stages = tile or (None, None)
    n, d, h, w = shape
    p = block2d.plan_l2(shape, c, cout, th, stages)
    P = block2d.PITCH
    if tile:
        assert (p.th, p.stages) == tile
    # tiles cover H x W, none wholly outside
    assert (p.tiles_h - 1) * p.th < h <= p.tiles_h * p.th
    assert (p.tiles_w - 1) * block2d.TW < w <= p.tiles_w * block2d.TW
    assert p.tiles == n * d * p.tiles_h * p.tiles_w < 2 ** 31
    assert p.n == (8 if cout <= 8 else 16)
    assert p.part == (cout <= 2)
    # the m64 tiles: the output rows exactly; every read a valid output
    # needs lies inside the grid it reads
    assert p.mo * 64 == p.th * P
    # att at the gate's last position (th + 1, 65) reads R[2] 2 rows on
    assert (p.th + 1) * P + 65 + 2 * P < p.ma * 64
    # conv2's kw shift reads two positions past a1's tiles: spare ones
    assert p.layout["apitch"] >= (p.ma * 64 + 2) * 16
    assert p.ma * 64 - 1 + 2 * P + 2 < p.xr * P             # conv1 on x
    assert (p.th + 1) * P + 65 + 2 * P + 2 < p.xr * P       # the gate
    assert p.mo * 64 - 1 + 4 * P + 4 < p.xr * P             # conv0 on x
    # the partials: Z at every o + 2P a valid output reads, the kw shift
    # on x, Z in a1's planes
    assert (p.th + 1) * P + 63 < p.mg * 64
    assert p.mg * 64 - 1 + 2 * P + 2 + 2 < p.xr * P
    assert p.mg * 64 * 8 * 4 <= 2 * p.layout["apitch"]
    assert p.xr <= 256                                      # a TMA box
    lay = p.layout
    assert p.smem == lay["smem"] <= block2d.SMEM_MAX
    for k in ("xplane", "xslot", "apitch", "rpitch", "off_a", "off_r",
              "off_w1", "off_w2", "off_w0", "off_wr"):
        assert lay[k] % 128 == 0, k
    assert lay["off_epi"] % 16 == 0
    assert p.vec == (c % 8 == 0)


def test_l2_plan_flagship():
    """The up_0 logit head takes 16-row tiles with one x slot, the first
    of L2_TILES (none leaves room for two blocks per SM)."""
    p = block2d.plan_l2(*FLAGSHIP)
    assert (p.n, p.part, p.th, p.stages, p.vec) == (8, True, 16, 1, True)
    assert (p.ma, p.mo, p.mg, p.xr) == (23, 18, 21, 23)
    assert p.smem == 183504
    assert p.tiles == 8 * 64 * 24 * 6
    assert block2d.plan_l2(*FLAGSHIP) is p                 # cached per shape
    assert all(2 * (block2d.l2_layout(8, t, s, True)["smem"] + 1024)
               > block2d.SMEM_SM for t, s in block2d.L2_TILES)


@pytest.mark.parametrize("c,cout,th,stages", [
    (32, 32, None, None),         # up_1's widths: the chain takes them
    (17, 2, None, None), (16, 17, None, None), (0, 2, None, None),
    (16, 2, 12, 1), (16, 2, 16, 3), (16, 2, 64, 1)])
def test_l2_plan_refuses_what_the_kernel_cannot_take(c, cout, th, stages):
    with pytest.raises(ValueError, match="l2_block2d"):
        block2d.plan_l2((1, 1, 16, 16), c, cout, th, stages)
    assert block2d.l2_fusable(c, cout) == (1 <= c <= 16 and 1 <= cout <= 16)


def test_l2_w2_partials_reproduce_conv2():
    """The packed w2 slabs as the kernel uses them: per kw one product of
    a1 shifted by kw, columns kh (hi) + 8 + kh (lo) summed over kw, then
    summed over kh at row shifts, is conv2 with the f32 weights to ~16
    bits."""
    rng = np.random.default_rng(7)
    hh, ww, c = 9, 14, 16
    a1 = torch.from_numpy(rng.normal(size=(hh, ww, c)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(3, 3, 1, c, 1)).astype(
        np.float32))
    flat = block2d.pack_w2_hilo(w2, (c,), 16).float().reshape(-1)
    pad = F.pad(a1, (0, 0, 1, 1, 1, 1))                    # (hh+2, ww+2, c)
    r = 0
    for kw in range(3):
        slab = _desc(flat, [kw * 512], 128, 256, 16)[0]    # (N, K)
        r = r + pad[:, kw:kw + ww] @ slab.t()              # (hh+2, ww, 16)
    part = r[..., :3] + r[..., 8:11]
    got = sum(part[kh:kh + hh, :, kh] for kh in range(3))
    ref = F.conv2d(a1.permute(2, 0, 1)[None],
                   w2[:, :, 0, :, 0].permute(2, 0, 1)[None], padding=1)[0, 0]
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert not r[..., 3:8].any() and not r[..., 11:].any()


# ---- the emulation -----------------------------------------------------

@pytest.mark.parametrize("shape,c,cout,head,tile", [
    ((1, 2, 20, 70), 16, 2, True, None),     # the head, ragged H and W
    ((2, 1, 9, 13), 16, 2, True, None),      # the head, one tile
    ((1, 2, 19, 70), 16, 16, False, None),   # a PReLU unit, ragged
    ((1, 1, 21, 30), 8, 2, True, (8, 2)),    # C 8, two slots, 3 tile rows
    ((2, 2, 10, 13), 12, 12, False, None),   # the GPU test's widths
    ((1, 1, 17, 66), 5, 9, False, (8, 1)),   # nothing aligned, Cout 9
    ((1, 2, 19, 70), 16, 2, False, None),    # partials under a PReLU
    ((2, 1, 12, 20), 8, 4, True, (8, 2)),    # Cout 4: conv0 per tap, N 8
])
def test_l2_emulation_matches_plain(shape, c, cout, head, tile):
    rng = np.random.default_rng(11)
    xa, xb = (torch.from_numpy(rng.normal(size=(*shape, c)).astype(
        np.float32)) for _ in range(2))
    p = _torch(_params(rng, c, cout, head, alpha_vec=cout == 9))
    th, stages = tile or (None, None)
    got, att, stores = emulate_l2_block2d(xa, xb, p, th, stages)
    assert bool((stores == 1).all())            # every output stored once
    ref, ref_att = block2d.l2_block2d_plain(xa, xb, **p)
    assert _err(got, ref) <= EMU_TOL
    assert _err(att, ref_att) <= EMU_TOL


@pytest.mark.parametrize("mutate", ["a1", "halo"])
def test_l2_emulation_without_edge_zeroing_disagrees(mutate):
    """Dropping either zeroing at the image's edge breaks the block: a1 is
    relu(b1) outside the image without it, and without the halo's zero
    fill conv1 reads pixels past the edge and the gate scales them."""
    rng = np.random.default_rng(12)
    shape, c, cout = (1, 1, 20, 70), 16, 2
    xa, xb = (torch.from_numpy(rng.normal(size=(*shape, c)).astype(
        np.float32)) for _ in range(2))
    p = _torch(_params(rng, c, cout, True))
    p["b1"] = p["b1"].abs() + 0.2               # relu(b1) > 0 outside
    ref, _ = block2d.l2_block2d_plain(xa, xb, **p)
    got, _, _ = emulate_l2_block2d(xa, xb, p)
    assert _err(got, ref) <= EMU_TOL
    bad, _, _ = emulate_l2_block2d(xa, xb, p, mutate=mutate)
    assert _err(bad, ref) > 100 * EMU_TOL


@pytest.mark.parametrize("shape,c,cout,head", [
    ((2, 2, 16, 32), 16, 2, True),      # the flagship head's widths
    ((1, 2, 24, 72), 16, 16, False),    # a PReLU unit, two tile columns
])
def test_l2_emulation_matches_pallas(shape, c, cout, head):
    rng = np.random.default_rng(13)
    xa, xb = (rng.normal(size=(*shape, c)).astype(np.float32)
              for _ in range(2))
    p = _torch(_params(rng, c, cout, head))
    ref = np.array(pallas_block2d.l2_block2d(
        jnp.asarray(xa), jnp.asarray(xb),
        cp=pallas_block2d.pick_cp(c, cout), interpret=True, **_jax(p)))
    got, _, _ = emulate_l2_block2d(torch.from_numpy(xa),
                                   torch.from_numpy(xb), p)
    assert _err(got, torch.from_numpy(ref)) <= EMU_TOL


@pytest.mark.parametrize("shape,c,cout,head", [
    ((2, 2, 16, 32), 16, 2, True),
    ((1, 2, 24, 72), 16, 16, False),
])
def test_l2_emulation_bf16_matches_pallas_and_plain(shape, c, cout, head):
    """bf16 activations and weights, a1 and the gated pair rounded to bf16
    and the output rounded once (the kernel's rounding): within KERNEL_TOL
    of the Pallas kernel and of the plain twin."""
    rng = np.random.default_rng(14)
    xa, xb = (rng.normal(size=(*shape, c)).astype(np.float32)
              for _ in range(2))
    p = _torch(_params(rng, c, cout, head))
    ta, tb = (torch.from_numpy(v).to(torch.bfloat16) for v in (xa, xb))
    got, att, _ = emulate_l2_block2d(ta, tb, p)
    got = got.to(torch.bfloat16)
    ref_p = torch.from_numpy(np.asarray(pallas_block2d.l2_block2d(
        jnp.asarray(xa, jnp.bfloat16), jnp.asarray(xb, jnp.bfloat16),
        cp=pallas_block2d.pick_cp(c, cout), interpret=True, **_jax(p)),
        np.float32))
    ref_t, ref_att = block2d.l2_block2d_plain(ta, tb, **p)
    for ref in (ref_p, ref_t):
        assert _err(got, ref) <= KERNEL_TOL
    assert _err(att.to(torch.bfloat16), ref_att) <= KERNEL_TOL


def test_l2_block2d_cpu_runs_the_plain_twin_uncounted():
    rng = np.random.default_rng(15)
    xa, xb = (torch.from_numpy(rng.normal(size=(1, 2, 9, 11, 8)).astype(
        np.float32)) for _ in range(2))
    for c, head in ((8, True), (32, False)):
        if c == 32:     # past the kernel's widths: the chain's shape
            xa, xb = (torch.from_numpy(rng.normal(
                size=(1, 2, 9, 11, 32)).astype(np.float32)) for _ in range(2))
        p = _torch(_params(rng, c, 2 if head else c, head),
                   kernel_weights=False)
        n0 = block2d.l2_block2d.launches
        k0 = block2d.l2_block2d.chain_calls
        got = block2d.l2_block2d(xa, xb, **p)
        for g, r in zip(got, block2d.l2_block2d_plain(xa, xb, **p)):
            assert torch.equal(g, r)
        assert block2d.l2_block2d.launches == n0
        assert block2d.l2_block2d.chain_calls == k0
