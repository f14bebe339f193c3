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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vs_seg_tpu.models import UNet2d5_spvPA as JUNet
from vs_seg_tpu.nn.layers import conv3d as jconv3d
from vs_seg_tpu.ops.experimental import pallas_dsconv
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.models import UNet2d5_spvPA as TUNet
from vs_seg_tpu_torch.nn import blocks as tblocks
from vs_seg_tpu_torch.ops import dsconv

TOL = dict(atol=2e-5, rtol=2e-5)


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
