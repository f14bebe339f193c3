"""The port's fused (3,3,1) ResidualUnit kernel (csrc/rublock2d.cu, through
ops/block2d.py:ru_block2d) held on the CPU by its launch plan and by an
emulation that follows it tile by tile.

The kernel runs only on the card (tests/test_torch_cuda.py and chip_smoke.py
hold it against ru_block2d_plain there). Here `emulate_ru_block2d` walks the
plan's tiles as the kernel does, on a NaN-filled copy of a block's shared
memory laid out by block2d.smem_layout: the x halo box of each tile
(zero-filled outside the image, channels past Cin zero; at Cin = 1 rows of
XPITCH columns from w0 - 8, as the kernel's 16-byte aligned box), at Cin = 1 the 9
taps of every u0 position packed into one 16-lane K slice, conv0 with each
m64 tile's A operand read through the kernel's wgmma descriptor arithmetic
(start, LBO, SBO) and B from the packed weight slabs the same way, epilogue
0 with u0 zeroed outside the image and rounded to the working dtype, conv1
from the u0 planes, the 1x1 residual from the staged x (or the packed
slice's centre lane) into a second sum added after the PReLU, and the
masked store. In float32 it must equal ru_block2d_plain on bf16-rounded
weights (the kernel's) to 1e-5 of the largest output, and the JAX Pallas
ru_block2d in interpret mode (as tests/test_torch_block2d.py runs it); with
bf16 inputs, u0 and output rounded as the kernel rounds them, within
KERNEL_TOL (chip_smoke.py's band) of both. Inputs come from numpy with a
fixed seed.
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


def _params(rng, cin, cout, alpha_vec=False):
    def w(k, ci, co):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        return rng.uniform(-b, b, size=(*k, ci, co)).astype(np.float32)

    def v(c, lo, hi):
        return rng.uniform(lo, hi, size=(c,)).astype(np.float32)

    return dict(w0=w((3, 3, 1), cin, cout), bn0_scale=v(cout, .5, 1.5),
                bn0_shift=v(cout, -.3, .3),
                alpha0=v(cout if alpha_vec else 1, .1, .4),
                w1=w((3, 3, 1), cout, cout), bn1_scale=v(cout, .5, 1.5),
                bn1_shift=v(cout, -.3, .3), alpha1=v(1, .1, .4),
                wr=w((1, 1, 1), cin, cout), br=v(cout, -.3, .3))


def _torch(p, bf16_weights=True):
    """numpy params -> torch; the conv weights rounded to bf16 (the
    kernel's) when asked."""
    out = {}
    for k, a in p.items():
        t = torch.from_numpy(a)
        if bf16_weights and k in ("w0", "w1", "wr"):
            t = t.to(torch.bfloat16).float()
        out[k] = t
    return out


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


def _box(img, h0, w0, rows, cols):
    """rows x cols x C of an (H, W, C) image from (h0, w0), zero outside."""
    h, w, c = img.shape
    out = torch.zeros((rows, cols, c), dtype=img.dtype)
    lo_h, hi_h = max(h0, 0), min(h0 + rows, h)
    lo_w, hi_w = max(w0, 0), min(w0 + cols, w)
    if hi_h > lo_h and hi_w > lo_w:
        out[lo_h - h0:hi_h - h0, lo_w - w0:hi_w - w0] = \
            img[lo_h:hi_h, lo_w:hi_w]
    return out


def _affine_prelu(v, s, h, a, co):
    v = v * s[co] + h[co]
    a = a if a.numel() == 1 else a[co]
    return torch.where(v >= 0, v, a * v)


def emulate_ru_block2d(x, params, th=None, stages=None):
    """csrc/rublock2d.cu tile by tile, in float32 (see the module
    docstring); u0 rounded to x.dtype, the output unrounded. Also returns
    how often each output value was stored."""
    n, d, h, w, cin = x.shape
    cout = params["w0"].shape[-1]
    p = block2d.plan((n, d, h, w), cin, cout, th, stages)
    lay, N, P, TW = p.layout, p.n, block2d.PITCH, block2d.TW
    pack = p.chunks == 0
    w0p, w1p, wrp = (t.float().reshape(-1) for t in block2d.packed_unit(
        params["w0"], params["w1"], params["wr"], cin, N, "cpu"))
    s0, h0v, a0 = (params[k].float() for k in ("bn0_scale", "bn0_shift",
                                               "alpha0"))
    s1, h1v, a1 = (params[k].float() for k in ("bn1_scale", "bn1_shift",
                                               "alpha1"))
    br = params["br"].float()
    xf = x.float().reshape(n * d, h, w, cin)
    out = torch.zeros((n * d, h, w, cout))
    stores = torch.zeros((n * d, h, w, cout), dtype=torch.int32)
    up, xp = lay["upitch"], lay["xplane"]
    co_all = torch.arange(N)
    col_in = torch.clamp(co_all, max=cout - 1)
    for t in range(p.tiles):                 # the kernel's walk order
        rest = t // p.tiles_w
        tw0 = (t - rest * p.tiles_w) * TW
        th0 = (rest % p.tiles_h) * p.th
        nd = rest // p.tiles_h
        smem = torch.full((p.smem // 2,), float("nan"))

        def put(byte, vals):
            smem[byte // 2:byte // 2 + vals.numel()] = vals.reshape(-1)

        put(lay["off_w0"], w0p)
        put(lay["off_w1"], w1p)
        put(lay["off_wr"], wrp)
        xs = (t % p.stages) * lay["xslot"]
        if pack:        # rows of XPITCH from column tw0 - 8
            PX = block2d.XPITCH
            put(xs, _box(xf[nd], th0 - 2, tw0 - 8, p.xr, PX)[..., 0])
            img = smem[xs // 2:xs // 2 + p.xr * PX]
            q = torch.arange(p.m0 * 64)
            at = (q // P) * PX + q % P + block2d.XOFF
            taps = torch.stack([img[at + (k // 3) * PX + k % 3]
                                for k in range(9)], 1)
            lanes = torch.cat([taps, torch.zeros(len(q), 7)], 1)
            put(lay["off_pk"], lanes[:, :8])
            put(lay["off_pk"] + up, lanes[:, 8:])
        else:
            box = F.pad(_box(xf[nd], th0 - 2, tw0 - 2, p.xr, P),
                        (0, 16 * p.chunks - cin))
            for pl in range(2 * p.chunks):
                put(xs + pl * xp, box[..., 8 * pl:8 * pl + 8])

        def wslab(off, j):
            return _desc(smem, [off + j * 16 * N * 2], 128, 256, N)[0]

        # conv0 over the u0 positions
        tiles0 = torch.arange(p.m0)
        if pack:
            acc = _desc(smem, lay["off_pk"] + tiles0 * 1024, up, 128) \
                @ wslab(lay["off_w0"], 0).t()
        else:
            acc = 0
            for j in range(p.chunks):
                for tap in range(9):
                    st = (xs + 2 * j * xp + tiles0 * 1024
                          + ((tap // 3) * P + tap % 3) * 16)
                    acc = acc + _desc(smem, st, xp, 128) \
                        @ wslab(lay["off_w0"], j * 9 + tap).t()
        q = torch.arange(p.m0 * 64)
        r, c = q // P, q % P
        hh, ww = th0 - 1 + r, tw0 - 1 + c
        inside = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
        u = _affine_prelu(acc.reshape(-1, N), s0, h0v, a0, col_in)
        u = torch.where(inside[:, None] & (co_all < cout)[None], u, 0.0)
        u = u.to(x.dtype).float()
        for co in range(N):
            smem[(lay["off_u"] + (co // 8) * up) // 2 + q * 8 + co % 8] = \
                u[:, co]
        # conv1 from u0, the residual into its own sum
        tiles1 = torch.arange(p.m1)
        acc = 0
        for j in range(N // 16):
            for tap in range(9):
                st = (lay["off_u"] + 2 * j * up + tiles1 * 1024
                      + ((tap // 3) * P + tap % 3) * 16)
                acc = acc + _desc(smem, st, up, 128) \
                    @ wslab(lay["off_w1"], j * 9 + tap).t()
        if pack:
            racc = _desc(smem, lay["off_pk"] + (tiles1 * 64 + P + 1) * 16,
                         up, 128) @ wslab(lay["off_wr"], 0).t()
        else:
            racc = 0
            for j in range(p.chunks):
                st = xs + 2 * j * xp + (tiles1 * 64 + 2 * P + 2) * 16
                racc = racc + _desc(smem, st, xp, 128) \
                    @ wslab(lay["off_wr"], j).t()
        v = (_affine_prelu(acc.reshape(-1, N), s1, h1v, a1, col_in)
             + racc.reshape(-1, N) + br[col_in])
        o = torch.arange(p.m1 * 64)
        r, c = o // P, o % P
        ok = (c < TW) & (th0 + r < h) & (tw0 + c < w)
        out[nd, th0 + r[ok], tw0 + c[ok]] = v[ok, :cout]
        stores[nd, th0 + r[ok], tw0 + c[ok]] += 1
    return out.reshape(n, d, h, w, cout), stores


# ---- the plan ----------------------------------------------------------

# (N, D, H, W), Cin, Cout: the flagship's two sites (8 windows), then
# ragged ones and the GPU tests' and SMALL models' widths
FLAGSHIP = (((8, 64, 384, 384), 1, 16), ((8, 64, 192, 192), 16, 32))
RAGGED = (((2, 3, 10, 13), 5, 12), ((1, 4, 128, 128), 1, 8),
          ((1, 4, 64, 64), 8, 16), ((1, 2, 37, 130), 16, 32),
          ((3, 1, 7, 5), 1, 32), ((1, 1, 1, 1), 32, 1))


@pytest.mark.parametrize("shape,cin,cout", FLAGSHIP + RAGGED)
@pytest.mark.parametrize("tile", [None, (8, 1), (16, 2)])
def test_rb_plan_covers_every_output_once_within_limits(shape, cin, cout,
                                                        tile):
    th, stages = tile or (None, None)
    n, d, h, w = shape
    if tile and block2d.smem_layout(16 if cout <= 16 else 32,
                                    0 if cin == 1 else -(-cin // 16),
                                    *tile)["smem"] > block2d.SMEM_MAX:
        with pytest.raises(ValueError, match="shared memory"):
            block2d.plan(shape, cin, cout, th, stages)
        return
    p = block2d.plan(shape, cin, cout, th, stages)
    P = block2d.PITCH
    if tile:
        assert (p.th, p.stages) == tile
    # tiles cover H x W, none wholly outside
    assert (p.tiles_h - 1) * p.th < h <= p.tiles_h * p.th
    assert (p.tiles_w - 1) * block2d.TW < w <= p.tiles_w * block2d.TW
    assert p.tiles == n * d * p.tiles_h * p.tiles_w < 2 ** 31
    assert p.n == (16 if cout <= 16 else 32)
    assert p.chunks == (0 if cin == 1 else -(-cin // 16))
    # the m64 tiles: the output rows exactly, u0's (th + 2) rows, every
    # read inside the grid it reads
    assert p.m1 * 64 == p.th * P
    assert (p.m0 - 1) * 64 < (p.th + 2) * P <= p.m0 * 64
    assert p.m1 * 64 - 1 + 2 * P + 2 < p.m0 * 64          # conv1 on u0
    assert p.m0 * 64 - 1 + 2 * P + 2 < p.xr * P           # conv0 on x
    assert p.xr <= 256                                    # a TMA box
    lay = p.layout
    assert p.smem == lay["smem"] <= block2d.SMEM_MAX
    for k in ("xplane", "xslot", "upitch", "off_pk", "off_u", "off_w0",
              "off_w1", "off_wr"):
        assert lay[k] % 128 == 0, k
    assert p.tma == ((w % 8 == 0) if cin == 1 else cin % 8 == 0)


def test_rb_plan_flagship():
    """down_0 takes 16-row tiles with a 2-slot ring (two blocks per SM),
    down_1 8-row tiles with one slot (the largest tile with two blocks per
    SM); both stage x by TMA."""
    got = [block2d.plan(s, ci, co) for s, ci, co in FLAGSHIP]
    assert [(p.n, p.chunks, p.th, p.stages, p.tma) for p in got] == [
        (16, 0, 16, 2, True), (32, 1, 8, 1, True)]
    assert [(p.m0, p.m1, p.xr) for p in got] == [(21, 18, 21), (12, 9, 13)]
    assert [p.smem for p in got] == [99040, 108688]
    assert [p.tiles for p in got] == [8 * 64 * 24 * 6, 8 * 64 * 24 * 3]
    assert block2d.plan(*FLAGSHIP[0]) is got[0]          # cached per shape


@pytest.mark.parametrize("cin,cout,th,stages", [
    (33, 16, None, None), (16, 48, None, None), (0, 16, None, None),
    (16, 32, 12, 1), (16, 32, 16, 3), (32, 32, 64, 2)])
def test_rb_plan_refuses_what_the_kernel_cannot_take(cin, cout, th, stages):
    with pytest.raises(ValueError, match="ru_block2d"):
        block2d.plan((1, 1, 16, 16), cin, cout, th, stages)


def test_rb_tap_packed_w0_reproduces_conv0():
    """Cin = 1: lane t = kh*3 + kw of the packed slice times the packed
    slab is conv0 (kh over H, kw over W), and wr sits in the centre lane."""
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.normal(size=(12, 20)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(3, 3, 1, 1, 16)).astype(
        np.float32)).to(torch.bfloat16).float()
    wr = torch.from_numpy(rng.normal(size=(1, 1, 1, 1, 16)).astype(
        np.float32)).to(torch.bfloat16).float()
    slab = _desc(block2d.pack_w0_taps(w0, (1,), 16).float().reshape(-1),
                 [0], 128, 256, 16)[0]                   # (N, K)
    pad = F.pad(img, (1, 1, 1, 1))
    lanes = torch.stack([pad[kh:kh + 12, kw:kw + 20]
                         for kh in range(3) for kw in range(3)], -1)
    got = F.pad(lanes, (0, 7)) @ slab.t()
    ref = F.conv2d(img[None, None], w0[:, :, 0, 0].permute(2, 0, 1)[:, None],
                   padding=1)[0].permute(1, 2, 0)
    assert torch.allclose(got, ref, atol=1e-5, rtol=1e-5)
    rslab = _desc(block2d.pack_wr_centre(wr, (1,), 16).float().reshape(-1),
                  [0], 128, 256, 16)[0]
    assert torch.equal(rslab[:, 4], wr.reshape(16))
    assert not rslab[:, [k for k in range(16) if k != 4]].any()


@pytest.mark.parametrize("shape,cin,cout,tile", [
    ((1, 2, 20, 70), 1, 16, None),      # Cin = 1, ragged H and W
    ((2, 1, 9, 13), 1, 32, None),       # Cin = 1, Cout 32, one tile
    ((1, 2, 19, 70), 16, 32, None),     # down_1's widths, ragged
    ((1, 1, 21, 30), 16, 16, (16, 2)),  # one tile wide, two tile rows
    ((2, 3, 10, 13), 5, 12, None),      # the GPU test's widths
    ((1, 2, 17, 24), 8, 16, (8, 2)),    # SMALL model down_1, 3 tile rows
    ((1, 1, 9, 66), 24, 20, None),      # Cin 24: two chunks, one past it
])
def test_rb_emulation_matches_plain(shape, cin, cout, tile):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(*shape, cin)).astype(np.float32))
    p = _torch(_params(rng, cin, cout, alpha_vec=cin == 5))
    th, stages = tile or (None, None)
    got, stores = emulate_ru_block2d(x, p, th, stages)
    assert bool((stores == 1).all())            # every output stored once
    ref = block2d.ru_block2d_plain(x, **p)
    assert got.shape == ref.shape
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= EMU_TOL, err


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 3, 32, 32), 1, 16),      # Cin = 1 (flagship down_0)
    ((1, 2, 16, 32), 16, 32),     # down_1's widths
])
def test_rb_emulation_matches_pallas(shape, cin, cout):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    p = _torch(_params(rng, cin, cout))
    ref = np.asarray(pallas_block2d.ru_block2d(
        jnp.asarray(x), cp=pallas_block2d.pick_cp(cin, cout), interpret=True,
        **{k: jnp.asarray(v.numpy()) for k, v in p.items()}))
    got, _ = emulate_ru_block2d(torch.from_numpy(x), p)
    err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
    assert err <= EMU_TOL, err


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 3, 32, 32), 1, 16),
    ((1, 2, 16, 32), 16, 32),
])
def test_rb_emulation_bf16_matches_pallas_and_plain(shape, cin, cout):
    """bf16 activations and weights, u0 rounded to bf16 and the output
    rounded once (the kernel's rounding): within KERNEL_TOL of the Pallas
    kernel and of the plain twin."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    p = _torch(_params(rng, cin, cout))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = emulate_ru_block2d(xb, p)[0].to(torch.bfloat16).float()
    ref_p = np.asarray(pallas_block2d.ru_block2d(
        jnp.asarray(x, jnp.bfloat16), cp=pallas_block2d.pick_cp(cin, cout),
        interpret=True, **{k: jnp.asarray(v.numpy()) for k, v in p.items()}),
        np.float32)
    ref_t = block2d.ru_block2d_plain(xb, **p).float().numpy()
    for ref in (ref_p, ref_t):
        err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
        assert err <= KERNEL_TOL, err


def test_ru_block2d_cpu_runs_the_plain_twin_uncounted():
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(size=(1, 2, 9, 11, 1)).astype(
        np.float32))
    p = _torch(_params(rng, 1, 8), bf16_weights=False)
    n0 = block2d.ru_block2d.launches
    got = block2d.ru_block2d(x, **p)
    assert torch.equal(got, block2d.ru_block2d_plain(x, **p))
    assert block2d.ru_block2d.launches == n0
