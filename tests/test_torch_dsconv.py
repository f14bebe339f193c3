"""Parity of the port's strided downsample conv (ops/dsconv.py) and its
Routes(dsconv=True) dispatch with the JAX package's Pallas kernel
vs_seg_tpu/ops/experimental/pallas_dsconv.py:ds_conv, run as
tests/test_pallas_dsconv.py runs it on the CPU (interpret mode).

On the CPU the port's wrapper runs its plain PyTorch twin (the CUDA kernel
runs only on the card: tests/test_torch_cuda.py and chip_smoke.py hold it
against this twin). Inputs and weights come from numpy with a fixed seed.
Tolerances: float32 atol/rtol 2e-5 (the oracle file's own: only the order
of the sums differs); bfloat16 1e-2 (both sides round the output to bf16);
at model level 2e-4 (tests/test_model.py::test_fused_dsconv_matches_
reference). Shapes the TPU kernel cannot take (odd sizes, Cin > 64) are
held to the JAX package's strided conv3d, which is the semantics.

The kernel itself (csrc/conv333.cu at stride 2) is held here by its launch
plan (dsconv.plan) and by an emulation that follows it stage by stage: the
padded input's (N*D, H, W/2, 2, Cp) view, four zero-filled TMA boxes per
stage laid out as the kernel's ring slot, each tap's A operand read through
the kernel's wgmma descriptor arithmetic (start, LBO, SBO) and its B from
the packed weight slab the same way, depth planes 2 od + kd - 1, the
epilogue and the masked store. In float32 it must equal ds_conv_plain on
bf16-rounded weights (the kernel's) to 1e-5 of the largest output, and the
JAX Pallas ds_conv (interpret mode, at shapes its gate takes); with bf16
inputs, rounded once at the store, within KERNEL_TOL (chip_smoke.py's band).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vs_seg_tpu.models import UNet2d5_spvPA as JUNet
from vs_seg_tpu.nn.layers import conv3d as jconv3d
from vs_seg_tpu.ops.experimental import pallas_dsconv
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.models import UNet2d5_spvPA as TUNet
from vs_seg_tpu_torch.nn import blocks as tblocks
from vs_seg_tpu_torch.ops import conv333, dsconv

TOL = dict(atol=2e-5, rtol=2e-5)
EMU_TOL = 1e-5            # float32 emulation vs twin, relative to max|ref|
KERNEL_TOL = 2e-2         # chip_smoke.py's bf16 band, kernel vs twin


def _xw(rng, shape, cin, cout):
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)
         ).astype(np.float32)
    return x, w


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("shape,cin,cout", [
    ((1, 4, 8, 32), 48, 48),      # downsample_2-like
    ((2, 2, 8, 32), 40, 64),      # channel padding both sides, B > 1
    ((1, 2, 4, 64), 64, 32),      # wider W, Cout < Cin
])
def test_ds_conv_plain_matches_pallas(shape, cin, cout):
    x, w = _xw(np.random.default_rng(0), shape, cin, cout)
    ref = pallas_dsconv.ds_conv(jnp.asarray(x), jnp.asarray(w),
                                interpret=True)
    got = dsconv.ds_conv(torch.from_numpy(x), torch.from_numpy(w))
    B, D, H, W = shape
    assert tuple(got.shape) == (B, D // 2, H // 2, W // 2, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant", ["scale_shift_prelu", "bias_only",
                                     "relu"])
def test_ds_conv_plain_epilogue_matches_pallas(variant):
    rng = np.random.default_rng(1)
    x, w = _xw(rng, (1, 4, 8, 32), 48, 48)
    scale = (rng.normal(size=(48,)) * 0.5 + 1.0).astype(np.float32)
    shift = rng.normal(size=(48,)).astype(np.float32)
    alpha = rng.uniform(0.1, 0.4, size=(48,)).astype(np.float32)
    if variant == "bias_only":          # norm=None Convolution
        scale = alpha = None
    elif variant == "relu":             # ReLU is PReLU with alpha 0
        alpha = np.zeros((1,), np.float32)
    ref = pallas_dsconv.ds_conv(jnp.asarray(x), jnp.asarray(w), _j(scale),
                                _j(shift), _j(alpha), interpret=True)
    got = dsconv.ds_conv(torch.from_numpy(x), torch.from_numpy(w), _t(scale),
                         _t(shift), _t(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if variant == "relu":
        assert float(got.min()) == 0.0


def test_ds_conv_plain_bf16_matches_pallas():
    x, w = _xw(np.random.default_rng(2), (1, 4, 8, 32), 48, 48)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    ref = pallas_dsconv.ds_conv(xb, wb, interpret=True)
    got = dsconv.ds_conv(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(np.asarray(wb, np.float32)).to(
                             torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 5, 7, 9), 3, 5),         # every spatial size odd
    ((1, 3, 6, 13), 80, 80),      # Cin, Cout > 64 (flagship downsample_4)
    ((1, 1, 2, 3), 16, 20),       # a single depth plane
])
def test_ds_conv_plain_odd_sizes_match_lax(shape, cin, cout):
    """Sizes the TPU kernel's gate refuses, held to the JAX package's
    strided conv (nn/layers.py:conv3d, stride 2, padding 1) plus the
    epilogue."""
    rng = np.random.default_rng(3)
    x, w = _xw(rng, shape, cin, cout)
    shift = rng.normal(size=(cout,)).astype(np.float32)
    alpha = np.full((1,), 0.25, np.float32)
    assert not pallas_dsconv.can_ds_conv((*shape, cin), w.shape)
    y = jconv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(shift),
                (2, 2, 2), [(1, 1)] * 3, dtype=jnp.float32)
    ref = np.asarray(jnp.where(y >= 0, y, 0.25 * y))
    got = dsconv.ds_conv(torch.from_numpy(x), torch.from_numpy(w),
                         shift=_t(shift), alpha=_t(alpha))
    assert tuple(got.shape) == (shape[0], *((s - 1) // 2 + 1
                                            for s in shape[1:]), cout)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_ds_conv_cpu_runs_the_plain_twin_uncounted():
    x, w = _xw(np.random.default_rng(4), (1, 3, 5, 7), 4, 6)
    n0 = dsconv.ds_conv.launches
    got = dsconv.ds_conv(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got, dsconv.ds_conv_plain(torch.from_numpy(x),
                                                 torch.from_numpy(w)))
    assert dsconv.ds_conv.launches == n0


# ---- the kernel's plan and decomposition ----------------------------------

# (N, D, H, W), Cin, Cout: the flagship's sites (8 windows), then ragged ones
FLAGSHIP_DS = (((8, 64, 96, 96), 48, 48), ((8, 32, 48, 48), 64, 64),
               ((8, 16, 24, 24), 80, 80))
RAGGED_DS = (((2, 5, 7, 9), 5, 7), ((1, 3, 6, 13), 80, 80),
             ((1, 2, 5, 6), 12, 96), ((1, 3, 34, 21), 24, 20),
             ((3, 1, 2, 3), 16, 1), ((1, 1, 1, 1), 8, 200))


@pytest.mark.parametrize("shape,cin,cout", FLAGSHIP_DS + RAGGED_DS)
@pytest.mark.parametrize("th", [None, 8])
def test_ds_plan_covers_every_output_once_within_limits(shape, cin, cout,
                                                        th):
    p = dsconv.plan(shape, cin, cout, th)
    n, d, h, w = shape
    assert p.out == (n, (d - 1) // 2 + 1, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    assert p.th == (th or dsconv.pick_th(p.out, p.cop // p.n_t))
    assert p.th in dsconv.TH_CHOICES
    # the tiles cover Ho x Wo with no tile wholly outside; the N tiles Cout
    _, do, ho, wo = p.out
    assert (p.tiles_h - 1) * p.th < ho <= p.tiles_h * p.th
    assert (p.tiles_w - 1) * dsconv.TW < wo <= p.tiles_w * dsconv.TW
    assert p.n_t in dsconv.DS_TILES and p.cop % p.n_t == 0
    assert p.cop >= cout and p.cop - p.n_t < cout
    assert p.tiles == n * do * (p.cop // p.n_t) * p.tiles_h * p.tiles_w
    assert p.tiles < 2 ** 31
    # the ring fits a block; the TMA map's box and strides are legal
    assert p.smem <= dsconv.SMEM_MAX
    assert all(1 <= b <= 256 for b in p.box) and p.box[0] * 2 % 16 == 0
    assert all(s % 16 == 0 for s in p.strides)
    # the view is the padded input: channels to a multiple of 8, W even
    # (odd W padded by one column)
    assert p.cp % 8 == 0 and 0 <= p.cp - cin < 8
    assert p.wp == w + (w % 2) and p.wp % 2 == 0
    assert p.view == (p.cp, 2, p.wp // 2, h, n * d)
    elems = torch.empty(n * d, h, p.wp // 2, 2, p.cp).stride()
    assert p.strides == tuple(2 * s for s in reversed(elems[:-1]))


def test_ds_plan_flagship():
    """The three downsample sites: one N tile of Cout, TH = 16 at
    downsample_2 and 8 below, and the ring sizes of csrc/conv333.cu's
    stride-2 instances (3 slots of 4 half planes of (2 TH + 1) x 17 x 16 B
    plus the 9-tap slab)."""
    got = [dsconv.plan(s, ci, co) for s, ci, co in FLAGSHIP_DS]
    assert [(p.n_t, p.cop, p.th) for p in got] == [
        (48, 48, 16), (64, 64, 8), (80, 80, 8)]
    assert [p.smem for p in got] == [150576, 112176, 126000]
    assert [p.tiles for p in got] == [8 * 32 * 3 * 3, 8 * 16 * 3 * 2,
                                      8 * 8 * 2 * 1]
    assert [dsconv.plan(s, ci, co, 16).smem for s, ci, co in FLAGSHIP_DS] \
        == [150576, 164400, 178224]
    assert dsconv.plan(*FLAGSHIP_DS[0]) is got[0]     # cached per shape


def _box(view, start, size):
    """A TMA box of the view (outermost first), zero-filled outside it."""
    out = torch.zeros(size, dtype=view.dtype)
    src, dst = [], []
    for s0, n, dim in zip(start, size, view.shape):
        lo, hi = max(s0, 0), min(s0 + n, dim)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s0, hi - s0))
    out[tuple(dst)] = view[tuple(src)]
    return out


def _desc(flat, start, lbo, sbo, rows):
    """The rows x 16 operand a no-swizzle K-major wgmma descriptor reads
    from `flat` (2-byte elements): row r, column k at byte start + (r // 8)
    * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    byte = start + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    return flat[byte // 2]


def emulate_ds_conv(x, w, scale=None, shift=None, alpha=None, th=None):
    """csrc/conv333.cu at stride 2, stage by stage, in float32 (the output
    unrounded): see the module docstring. Also returns how often each
    output value was stored."""
    n, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    p = dsconv.plan((n, d, h, wd), cin, cout, th)
    HW, HH = dsconv.TW + 1, 2 * p.th + 1
    half = HH * HW * 16
    pitch = -(-half // 128) * 128
    xp = F.pad(x.float(), (0, p.cp - cin, 0, p.wp - wd))
    view = xp.reshape(n * d, h, p.wp // 2, 2, p.cp)
    wm = conv333.pack_weights_gmma(w, [cin], p.n_t).float()
    tap_bytes = 16 * p.n_t * 2          # one tap's 16 x N slab
    _, do, ho, wo = p.out
    out = torch.zeros((*p.out, p.cop))
    stores = torch.zeros((*p.out, p.cop), dtype=torch.int32)
    mt_n = 2 * (p.th // 8)              # m64 tiles of a block
    col_of = torch.arange(p.n_t)
    for tile in range(p.tiles):         # the kernel's walk order
        hw = tile % (p.tiles_h * p.tiles_w)
        rest = tile // (p.tiles_h * p.tiles_w)
        nt, rest = rest % (p.cop // p.n_t), rest // (p.cop // p.n_t)
        od, b = rest % do, rest // do
        oh0, ow0 = (hw // p.tiles_w) * p.th, (hw % p.tiles_w) * dsconv.TW
        plo, phi = max(0, 1 - 2 * od), min(2, d - 1 - 2 * od + 1)
        acc = torch.zeros(mt_n, 64, p.n_t)
        for j in range(wm.shape[1]):
            for pz in range(plo, phi + 1):
                dz = 2 * od + pz - 1
                slot = torch.full((4 * pitch // 2,), float("nan"))
                for q in range(4):      # (parity, half) = divmod(q, 2)
                    bx = _box(view, (b * d + dz, 2 * oh0 - 1, ow0 - 1, q >> 1,
                                     16 * j + 8 * (q & 1)),
                              (1, HH, HW, 1, 8))
                    slot[q * pitch // 2:q * pitch // 2 + half // 2] = \
                        bx.reshape(-1)
                slab = wm[nt, j, pz].reshape(-1)
                for tap in range(9):
                    kh, kw = divmod(tap, 3)
                    plane = 0 if kw == 1 else 2 * pitch
                    col = 1 if kw else 0
                    bmat = _desc(slab, tap * tap_bytes, 128, 256,
                                 p.n_t)             # (N, 16)
                    for mt in range(mt_n):
                        pos = ((mt >> 1) * 16 + kh) * HW + (mt & 1) * 8 + col
                        amat = _desc(slot, plane + pos * 16, pitch,
                                     2 * HW * 16, 64)
                        acc[mt] += amat @ bmat.t()
        co = torch.clamp(nt * p.n_t + col_of, max=cout - 1)
        for mt in range(mt_n):
            v = acc[mt]
            if scale is not None:
                v = v * scale.float()[co]
            if shift is not None:
                v = v + shift.float()[co]
            if alpha is not None:
                a = alpha.float().reshape(-1)
                a = a[co] if a.numel() > 1 else a
                v = torch.where(v >= 0, v, a * v)
            for r in range(64):
                oh = oh0 + (mt >> 1) * 8 + r // 8
                ow = ow0 + (mt & 1) * 8 + r % 8
                if oh < ho and ow < wo:
                    sl = slice(nt * p.n_t, (nt + 1) * p.n_t)
                    out[b, od, oh, ow, sl] = v[r]
                    stores[b, od, oh, ow, sl] += 1
    return out[..., :cout], stores[..., :cout]


def _epilogue(rng, variant, cout):
    scale = torch.from_numpy((rng.normal(size=(cout,)) * .5 + 1).astype(
        np.float32))
    shift = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    slope = rng.uniform(.1, .4, size=(cout,)).astype(np.float32)
    return {"bn": (scale, shift, torch.from_numpy(slope[:1])),
            "alpha_vec": (scale, shift, torch.from_numpy(slope)),
            "bias_relu": (None, shift, torch.zeros(1)),
            "none": (None, None, None)}[variant]


def _bf16_w(w):
    return w.to(torch.bfloat16).float()


@pytest.mark.parametrize("variant", ["bn", "alpha_vec", "bias_relu",
                                     "none"])
@pytest.mark.parametrize("shape,cin,cout,th", [
    ((2, 5, 7, 9), 5, 7, None),       # odd D/H/W, Cin % 8 != 0, tiny Cout
    ((1, 3, 6, 13), 80, 80, None),    # one N tile of 80, odd W
    ((1, 2, 5, 6), 12, 96, None),     # Cout split into two N tiles of 48
    ((1, 3, 34, 21), 24, 20, 8),      # TH = 8: three tile rows, ragged
])
def test_ds_emulation_matches_plain(shape, cin, cout, th, variant):
    rng = np.random.default_rng(11)
    x, w = (torch.from_numpy(a) for a in _xw(rng, shape, cin, cout))
    epi = _epilogue(rng, variant, cout)
    got, stores = emulate_ds_conv(x, w, *epi, th=th)
    assert bool((stores == 1).all())            # every output stored once
    ref = dsconv.ds_conv_plain(x, _bf16_w(w), *epi)
    assert got.shape == ref.shape
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= EMU_TOL, err


@pytest.mark.parametrize("shape,cin,cout", [
    ((1, 4, 8, 32), 48, 48),      # downsample_2-like
    ((2, 2, 8, 32), 40, 64),      # Cin % 16 != 0, B > 1
])
def test_ds_emulation_matches_pallas(shape, cin, cout):
    rng = np.random.default_rng(12)
    x, w = _xw(rng, shape, cin, cout)
    w = np.asarray(_bf16_w(torch.from_numpy(w)))
    scale, shift, alpha = (t.numpy() for t in _epilogue(rng, "alpha_vec",
                                                        cout))
    assert pallas_dsconv.can_ds_conv((*shape, cin), w.shape)
    ref = np.asarray(pallas_dsconv.ds_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(shift), jnp.asarray(alpha), interpret=True))
    got, _ = emulate_ds_conv(torch.from_numpy(x), torch.from_numpy(w),
                             _t(scale), _t(shift), _t(alpha))
    err = float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())
    assert err <= EMU_TOL, err


def test_ds_emulation_bf16_matches_pallas_and_plain():
    """bf16 activations and weights, the output rounded once (the kernel's
    store): within KERNEL_TOL of the Pallas kernel and of the plain twin."""
    rng = np.random.default_rng(13)
    x, w = _xw(rng, (1, 4, 8, 32), 48, 48)
    scale, shift, alpha = _epilogue(rng, "bn", 48)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    got = emulate_ds_conv(xb, wb, scale, shift, alpha)[0].to(torch.bfloat16)
    ref_p = np.asarray(pallas_dsconv.ds_conv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        _j(scale.numpy()), _j(shift.numpy()), _j(alpha.numpy()),
        interpret=True), np.float32)
    ref_t = dsconv.ds_conv_plain(xb, wb, scale, shift, alpha).float()
    for ref in (ref_p, ref_t.numpy()):
        err = float(np.abs(got.float().numpy() - ref).max()
                    / np.abs(ref).max())
        assert err <= KERNEL_TOL, err


# ---- model level ----------------------------------------------------------

# tests/test_model.py::test_fused_dsconv_matches_reference: the level-1
# downsample is (3,3,3) stride (2,2,2); level 0 is (2,2,1)
CFG = dict(channels=(8, 16, 32), strides=((2, 2, 1), (2, 2, 2)),
           kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
           sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))


@pytest.fixture(scope="module")
def models():
    jm = JUNet(out_channels=2, num_res_units=2, dropout=None,
               attention_module=True, dtype=jnp.float32, **CFG)
    x = np.random.default_rng(8).normal(size=(1, 8, 32, 64, 1)).astype(
        np.float32)
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    v = jax.tree.map(lambda a: np.asarray(a + 0.1 if a.ndim == 1 else a,
                                          np.float32), v)
    tm = TUNet(out_channels=2, dropout=None, dtype=torch.float32,
               device="cpu", **CFG)
    load_jax_variables(tm, v)
    return jm, tm.eval(), v, x


def _count(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


def test_model_dsconv_route_matches_jax(monkeypatch, models):
    jm, tm, variables, x = models
    jcalls, tcalls = {}, {}
    _count(monkeypatch, pallas_dsconv, "ds_conv", jcalls)
    pallas_dsconv.FORCE_INTERPRET = True
    try:
        assert pallas_dsconv.fusion_enabled()
        ref, ref_atts = jm.apply(variables, jnp.asarray(x), train=False)
    finally:
        pallas_dsconv.FORCE_INTERPRET = False
    _count(monkeypatch, dsconv, "ds_conv", tcalls)
    with torch.no_grad():
        out, atts = tm(torch.from_numpy(x), routes=Routes(dsconv=True))
    # the one (3,3,3) stride-(2,2,2) site, downsample_1, on both sides
    assert jcalls == {"ds_conv": 1} and tcalls == {"ds_conv": 1}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)
    assert len(atts) == len(ref_atts) == 3
    for a, r in zip(atts, ref_atts):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=2e-4)


def test_model_default_routes_take_no_dsconv(monkeypatch, models):
    _, tm, _, x = models
    calls = {}
    _count(monkeypatch, dsconv, "ds_conv", calls)
    _count(monkeypatch, dsconv, "ds_conv_plain", calls)
    with torch.no_grad():
        tm(torch.from_numpy(x[:, :, :16, :16]))
        tm(torch.from_numpy(x[:, :, :16, :16]), use_kernels=False,
           routes=Routes(rublock2d=True))
    assert calls == {}


def test_model_dsconv_route_plain_twin(monkeypatch, models):
    """use_kernels=False sends the routed site to ds_conv_plain, with the
    same result as the wrapper (which runs that twin on the CPU)."""
    _, tm, _, x = models
    calls = {}
    _count(monkeypatch, dsconv, "ds_conv_plain", calls)
    xs = torch.from_numpy(x[:, :, :16, :32])
    on = Routes(dsconv=True)
    with torch.no_grad():
        ref = tm(xs, routes=on)[0]
        out = tm(xs, use_kernels=False, routes=on)[0]
    assert calls == {"ds_conv_plain": 2} and torch.equal(out, ref)


def test_dsconv_route_ignored_at_train(monkeypatch, models):
    """JAX gates the route on `not train`: so does the port."""
    _, tm, _, x = models
    xs = torch.from_numpy(x[:, :, :16, :16])
    calls = {}
    _count(monkeypatch, dsconv, "ds_conv", calls)
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        with torch.no_grad():
            ref, ref_atts = tm(xs, train=True)
            out, atts = tm(xs, train=True, routes=Routes(dsconv=True))
    finally:
        tm.load_state_dict(state)      # train mode moved the BN statistics
    assert calls == {}
    assert torch.equal(out, ref)
    assert all(torch.equal(a, r) for a, r in zip(atts, ref_atts))


def test_convolution_dsconv_sites():
    """Convolution takes the route only for an eval (3,3,3) stride-(2,2,2)
    conv on one input, and only when routed."""
    on = Routes(dsconv=True)
    kw = dict(dtype=torch.float32, device="cpu")
    x = torch.zeros(1, 2, 4, 4, 8)
    site = tblocks.Convolution(8, 8, (3, 3, 3), (2, 2, 2), **kw)
    assert site._dsconv(x, False, on)
    assert not site._dsconv(x, False, Routes())
    assert not site._dsconv(x, True, on)                  # train
    assert not site._dsconv((x, x), False, on)            # a pair
    relu = tblocks.Convolution(8, 8, (3, 3, 3), (2, 2, 2), act="relu",
                               norm=None, **kw)
    assert relu._dsconv(x, False, on)
    for conv in (tblocks.Convolution(8, 8, (3, 3, 1), (2, 2, 1), **kw),
                 tblocks.Convolution(8, 8, (3, 3, 3), (1, 1, 1), **kw),
                 tblocks.Convolution(8, 8, (3, 3, 3), (2, 2, 2),
                                     act="sigmoid", **kw),
                 tblocks.Convolution(8, 8, (3, 3, 3), (2, 2, 2),
                                     is_transposed=True, **kw),
                 tblocks.Convolution(8, 8, (3, 3, 3), (2, 2, 2),
                                     conv_only=True, **kw)):
        assert not conv._dsconv(x, False, on)


@pytest.mark.parametrize("act,norm", [("prelu", "batch"), ("relu", None),
                                      (None, "batch")])
def test_convolution_dsconv_route_matches_plain_forward(act, norm):
    """The routed Convolution (folded BN scale/shift incl. the conv bias, or
    the bias alone; alpha 0 for ReLU) equals its unrouted eval forward."""
    conv = tblocks.Convolution(6, 10, (3, 3, 3), (2, 2, 2), act=act,
                               norm=norm, dtype=torch.float32, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    if norm is not None:
        with torch.no_grad():
            conv.norm.mean.uniform_(-0.2, 0.2)
            conv.norm.var.uniform_(0.5, 1.5)
    x = torch.randn(2, 5, 7, 9, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = conv(x)
        got = conv(x, routes=Routes(dsconv=True))
    assert got.shape == ref.shape == (2, 3, 4, 5, 10)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)
