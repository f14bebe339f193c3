"""Parity of the port's kd = 1 kernel route of eval inference (ops/block2d.py,
ops/tail2d.py, ops/att.py and the Routes dispatch of the model) with the JAX
package's experimental Pallas kernels, run as the JAX tests run them on the
CPU (Pallas interpret mode).

On the CPU each port wrapper runs its plain PyTorch twin (the CUDA kernels
run only on the card: tests/test_torch_cuda.py and chip_smoke.py hold them
against these twins). The kernel tests use the oracle shapes of
tests/test_pallas_block2d.py, test_pallas_tail2d.py and test_pallas_att.py.
Inputs and weights come from numpy with a fixed seed. Tolerances, relative
to max|ref|: float32 1e-4 (only the order of the sums differs); bfloat16
3e-2 (both sides round to bf16, at other points: the TPU kernels round the
gate's att, and the tail's per-row conv2 partials, where the twins do not).

The model-level test forces the JAX gates only by monkeypatching the
modules' FORCE_INTERPRET / fusion_enabled, and wraps every routed JAX Pallas
entry point (and every routed port function) with a call counter: a route
that silently fell back would otherwise compare the plain path with itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vs_seg_tpu.models import UNet2d5_spvPA as JUNet
from vs_seg_tpu.nn.blocks import AttentionBlock1 as JAttentionBlock1
from vs_seg_tpu.ops.experimental import (pallas_att, pallas_block2d,
                                         pallas_tail2d)
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.models import UNet2d5_spvPA as TUNet
from vs_seg_tpu_torch.nn import blocks as tblocks
from vs_seg_tpu_torch.ops import att, block2d, tail2d

F32_TOL = 1e-4
BF16_TOL = 3e-2
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _rel(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _w(rng, k, cin, cout):
    b = 1.0 / np.sqrt(cin * int(np.prod(k)))
    return rng.uniform(-b, b, size=(*k, cin, cout)).astype(np.float32)


def _v(rng, c, lo, hi):
    return rng.uniform(lo, hi, size=(c,)).astype(np.float32)


def _act(rng, shape, dt):
    """Activations rounded to dt identically on both sides."""
    jdt, tdt, _ = DTYPES[dt]
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _both(params):
    """numpy params -> (jnp dict, torch dict); None stays None."""
    j = {k: None if v is None else jnp.asarray(v) for k, v in params.items()}
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in params.items()}
    return j, t


@pytest.mark.parametrize("shape,cin,cout,dt", [
    ((1, 2, 16, 32), 8, 16, "f32"),      # cp16
    ((1, 2, 16, 32), 16, 32, "f32"),     # cp32, mixed channels
    ((2, 3, 32, 32), 1, 16, "f32"),      # Cin = 1 (flagship down_0)
    ((1, 2, 64, 32), 16, 32, "f32"),     # multi-H-tile
    ((1, 2, 16, 32), 16, 32, "bf16"),
])
def test_ru_block2d_matches_pallas(shape, cin, cout, dt):
    rng = np.random.default_rng(0)
    jx, tx = _act(rng, (*shape, cin), dt)
    p = dict(w0=_w(rng, (3, 3, 1), cin, cout),
             bn0_scale=_v(rng, cout, .5, 1.5),
             bn0_shift=_v(rng, cout, -.3, .3), alpha0=_v(rng, 1, .1, .4),
             w1=_w(rng, (3, 3, 1), cout, cout),
             bn1_scale=_v(rng, cout, .5, 1.5),
             bn1_shift=_v(rng, cout, -.3, .3), alpha1=_v(rng, 1, .1, .4),
             wr=_w(rng, (1, 1, 1), cin, cout), br=_v(rng, cout, -.3, .3))
    jp, tp = _both(p)
    ref = pallas_block2d.ru_block2d(
        jx, cp=pallas_block2d.pick_cp(cin, cout), interpret=True, **jp)
    got = block2d.ru_block2d(tx, **tp)
    assert got.dtype == tx.dtype
    assert _rel(got, ref) <= DTYPES[dt][2]


def _l2_params(rng, c, cout, head):
    p = dict(w1=_w(rng, (3, 3, 1), 2 * c, c), b1=_v(rng, c, -.3, .3),
             w2=_w(rng, (3, 3, 1), c, 1), b2=_v(rng, 1, -.3, .3),
             w0=_w(rng, (3, 3, 1), 2 * c, cout),
             wr=_w(rng, (1, 1, 1), 2 * c, cout), br=_v(rng, cout, -.3, .3))
    if head:     # conv-only logit head: scale 1, shift = bias, identity
        p.update(bn_scale=None, bn_shift=_v(rng, cout, -.3, .3), alpha=None)
    else:
        p.update(bn_scale=_v(rng, cout, .5, 1.5),
                 bn_shift=_v(rng, cout, -.3, .3), alpha=_v(rng, 1, .1, .4))
    return p


def _jax_att_map(p, jxa, jxb):
    """The attention map of JAX's AttentionBlock1 with the same convs."""
    jm = JAttentionBlock1((3, 3, 1), dtype=jxa.dtype)
    att_ref, _ = jm.apply(
        {"params": {"conv1": {"conv": {"kernel": p["w1"], "bias": p["b1"]}},
                    "conv2": {"conv": {"kernel": p["w2"], "bias": p["b2"]}}}},
        (jxa, jxb), train=False, gate=False)
    return att_ref


@pytest.mark.parametrize("shape,c,cout,head,dt", [
    ((1, 2, 16, 32), 16, 16, False, "f32"),   # cp16
    ((1, 2, 16, 32), 32, 32, False, "f32"),   # cp32
    ((1, 2, 16, 32), 16, 2, True, "f32"),     # the i == 0 logit head
    ((1, 2, 64, 32), 16, 16, False, "f32"),   # multi-H-tile
    ((2, 3, 32, 64), 16, 16, False, "bf16"),
])
def test_l2_block2d_matches_pallas(shape, c, cout, head, dt):
    rng = np.random.default_rng(1)
    jxa, txa = _act(rng, (*shape, c), dt)
    jxb, txb = _act(rng, (*shape, c), dt)
    p = _l2_params(rng, c, cout, head)
    jp, tp = _both(p)
    ref = pallas_block2d.l2_block2d(
        jxa, jxb, cp=pallas_block2d.pick_cp(c, cout), interpret=True, **jp)
    out, att_map = block2d.l2_block2d(txa, txb, **tp)
    assert out.dtype == txa.dtype and tuple(att_map.shape) == (*shape, 1)
    tol = DTYPES[dt][2]
    assert _rel(out, ref) <= tol
    assert _rel(att_map, _jax_att_map(jp, jxa, jxb)) <= tol


def _tail_params(rng, ca, ch, cout, head):
    p = dict(w2=_w(rng, (3, 3, 1), ca, 1), b2=_v(rng, 1, -.3, .3),
             w0=_w(rng, (3, 3, 1), 2 * ch, cout),
             wr=_w(rng, (1, 1, 1), 2 * ch, cout), br=_v(rng, cout, -.3, .3))
    if head:
        p.update(bn_scale=None, bn_shift=_v(rng, cout, -.3, .3), alpha=None)
    else:
        p.update(bn_scale=_v(rng, cout, .5, 1.5),
                 bn_shift=_v(rng, cout, -.3, .3), alpha=_v(rng, 1, .1, .4))
    return p


@pytest.mark.parametrize("dims,ca,ch,cout,head,dt", [
    ((1, 3, 96, 64), 8, 16, 2, True, "f32"),       # up_0: packed logit head
    ((1, 3, 96, 64), 16, 16, 16, False, "f32"),    # up_1: banded out
    ((1, 1, 48, 64), 8, 8, 2, True, "f32"),        # one tile, one plane
    ((1, 3, 96, 64), 16, 16, 16, False, "bf16"),
])
def test_tail_block_matches_pallas(dims, ca, ch, cout, head, dt):
    rng = np.random.default_rng(2)
    ja1, ta1 = _act(rng, (*dims, ca), dt)
    ja1, ta1 = jnp.maximum(ja1, 0), ta1.clamp_min(0)     # a1 = relu(...)
    jxa, txa = _act(rng, (*dims, ch), dt)
    jxb, txb = _act(rng, (*dims, ch), dt)
    p = _tail_params(rng, ca, ch, cout, head)
    jp, tp = _both(p)
    ref = pallas_tail2d.tail_block(
        ja1, jxa, jxb, cout=cout, cp=pallas_tail2d.pick_cp(ca, ch, cout),
        interpret=True, **jp)
    out, att_map = tail2d.tail_block(ta1, txa, txb, **tp)
    assert out.dtype == txa.dtype and tuple(att_map.shape) == (*dims, 1)
    assert _rel(out, ref) <= DTYPES[dt][2]


@pytest.mark.parametrize("kd,shape,cm,n_x,dt", [
    (1, (1, 3, 16, 32), 4, 2, "f32"),      # L0/L1-like
    (3, (2, 4, 16, 16), 8, 2, "f32"),      # L2-like, depth taps
    (1, (1, 2, 16, 16), 8, 1, "f32"),      # one gated input
    (3, (1, 2, 16, 16), 24, 2, "f32"),     # Cm not a power of two
    (1, (1, 3, 16, 32), 16, 2, "bf16"),
])
def test_fused_attention_gate_matches_pallas(kd, shape, cm, n_x, dt):
    """The port's compact map equals every lane of the JAX "wide" map."""
    rng = np.random.default_rng(3)
    ja1, ta1 = _act(rng, (*shape, cm), dt)
    xs = [_act(rng, (*shape, cm), dt) for _ in range(n_x)]
    w2 = (rng.normal(size=(3, 3, kd, cm, 1)) / np.sqrt(9 * cm)
          ).astype(np.float32)
    b2 = rng.normal(size=(1,)).astype(np.float32)
    att_w, outs_ref = pallas_att.fused_attention_gate(
        ja1, tuple(j for j, _ in xs), jnp.asarray(w2), jnp.asarray(b2),
        kd=kd, ht=shape[2] // 2, interpret=True)
    att_map, outs = att.fused_attention_gate(
        ta1, [t for _, t in xs], torch.from_numpy(w2), torch.from_numpy(b2))
    tol = DTYPES[dt][2]
    assert tuple(att_map.shape) == (*shape, 1)
    assert _rel(att_map.expand(*shape, cm), att_w) <= tol
    assert len(outs) == n_x
    for o, r in zip(outs, outs_ref):
        assert o.dtype == xs[0][1].dtype
        assert _rel(o, r) <= tol


def test_fused_attention_gate_att_out_none():
    rng = np.random.default_rng(4)
    shape, cm = (1, 2, 16, 16), 8
    ja1, ta1 = _act(rng, (*shape, cm), "f32")
    jx, tx = _act(rng, (*shape, cm), "f32")
    w2 = rng.normal(size=(3, 3, 1, cm, 1)).astype(np.float32)
    b2 = np.zeros((1,), np.float32)
    none, outs_ref = pallas_att.fused_attention_gate(
        ja1, (jx,), jnp.asarray(w2), jnp.asarray(b2), kd=1, ht=8,
        att_out="none", interpret=True)
    assert none is None
    att_map, outs = att.fused_attention_gate(
        ta1, (tx,), torch.from_numpy(w2), torch.from_numpy(b2),
        att_out="none")
    assert att_map is None
    assert _rel(outs[0], outs_ref[0]) <= F32_TOL
    with pytest.raises(ValueError, match="att_out"):
        att.fused_attention_gate(ta1, (tx,), torch.from_numpy(w2),
                                 torch.from_numpy(b2), att_out="wide")


def test_kd1_blocks_refuse_kd3_weights():
    rng = np.random.default_rng(5)
    x = torch.zeros((1, 1, 8, 8, 4))
    p = {k: torch.from_numpy(v) for k, v in dict(
        w0=_w(rng, (3, 3, 3), 4, 8), bn0_scale=_v(rng, 8, 1, 1),
        bn0_shift=_v(rng, 8, 0, 0), alpha0=_v(rng, 1, 0, 0),
        w1=_w(rng, (3, 3, 3), 8, 8), bn1_scale=_v(rng, 8, 1, 1),
        bn1_shift=_v(rng, 8, 0, 0), alpha1=_v(rng, 1, 0, 0),
        wr=_w(rng, (1, 1, 1), 4, 8), br=_v(rng, 8, 0, 0)).items()}
    with pytest.raises(ValueError, match=r"\(3, 3, 1, Cin, Cout\)"):
        block2d.ru_block2d(x, **p)


# ---- model level ----------------------------------------------------------

# tests/test_pallas_tail2d.py:90-116: (3,3,1) at levels 0-1, (3,3,3) bottom
CFG = dict(channels=(8, 16, 32), strides=((2, 2, 1), (2, 2, 2)),
           kernel_sizes=((3, 3, 1), (3, 3, 1), (3, 3, 3)),
           sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
X_SHAPE = (1, 4, 128, 128, 1)


@pytest.fixture(scope="module")
def models():
    jm = JUNet(out_channels=2, num_res_units=2, dropout=None,
               attention_module=True, dtype=jnp.float32, **CFG)
    x = np.random.default_rng(5).normal(size=X_SHAPE).astype(np.float32)
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    rng = np.random.default_rng(6)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "var":
            return a * rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        if a.ndim == 1:        # biases, BN affine and means, PReLU slopes
            return a + 0.1 + rng.normal(size=a.shape).astype(np.float32) * .05
        return a

    v = jax.tree_util.tree_map_with_path(perturb, v)
    tm = TUNet(out_channels=2, dropout=None, dtype=torch.float32,
               device="cpu", **CFG)
    load_jax_variables(tm, v)
    return jm, tm.eval(), v, x


def _counted(monkeypatch, module, name, counts, key):
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        counts[key] = counts.get(key, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


def _count_port(monkeypatch, counts):
    """Count the calls of the port's routed wrappers (the model calls them
    at use_kernels=True; on the CPU they run their plain twins)."""
    for mod, names in ((block2d, ("ru_block2d", "l2_block2d")),
                       (tail2d, ("tail_block",)),
                       (att, ("fused_attention_gate",))):
        for n in names:
            _counted(monkeypatch, mod, n, counts, n)


# route name -> (Routes, JAX gates to force, expected calls on both sides)
MODEL_ROUTES = {
    "A": (Routes(rublock2d=True, l2block2d=True, tail2d1=True),
          ("block2d", "tail1"),
          {"ru_block2d": 2, "l2_block2d": 1, "tail_block": 1}),
    # upatt_1 and upatt_0; bottom_att gates one input twice a1's width,
    # which JAX never fuses, and neither does the port
    "B": (Routes(att_fuse=True), ("att",), {"fused_attention_gate": 2}),
    "tail-both": (Routes(tail2d0=True, tail2d1=True), ("tail0", "tail1"),
                  {"tail_block": 2}),
}


def _force_jax(monkeypatch, gates):
    if "block2d" in gates:
        monkeypatch.setattr(pallas_block2d, "FORCE_INTERPRET", True)
    if "att" in gates:
        monkeypatch.setattr(pallas_att, "FORCE_INTERPRET", True)
    levels = {int(g[-1]) for g in gates if g.startswith("tail")}
    if levels:
        monkeypatch.setattr(pallas_tail2d, "FORCE_INTERPRET", True)
        monkeypatch.setattr(pallas_tail2d, "fusion_enabled",
                            lambda level: level in levels)


@pytest.mark.parametrize("name", list(MODEL_ROUTES))
def test_model_routes_match_jax(monkeypatch, models, name):
    jm, tm, variables, x = models
    routes, gates, expect = MODEL_ROUTES[name]
    jcalls, tcalls = {}, {}
    for n in ("ru_block2d", "l2_block2d"):
        _counted(monkeypatch, pallas_block2d, n, jcalls, n)
    _counted(monkeypatch, pallas_tail2d, "tail_block", jcalls, "tail_block")
    _counted(monkeypatch, pallas_att, "fused_attention_gate", jcalls,
             "fused_attention_gate")
    _force_jax(monkeypatch, gates)
    ref, ref_atts = jm.apply(variables, jnp.asarray(x), train=False)
    _count_port(monkeypatch, tcalls)
    with torch.no_grad():
        out, atts = tm(torch.from_numpy(x), routes=routes)
    assert jcalls == expect, jcalls
    assert tcalls == expect, tcalls
    assert _rel(out, ref) <= F32_TOL
    assert len(atts) == len(ref_atts) == 3
    for a, r in zip(atts, ref_atts):
        assert _rel(a, r) <= F32_TOL


def test_model_default_routes_take_no_kd1_block(monkeypatch, models):
    """Routes() is the default forward: no kd = 1 block, tail or fused
    gate."""
    _, tm, _, x = models
    calls = {}
    _count_port(monkeypatch, calls)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x[:, :, :32, :32]))[0]
        out = tm(torch.from_numpy(x[:, :, :32, :32]), routes=Routes())[0]
    assert calls == {} and torch.equal(out, ref)


def test_routes_ignored_at_train(monkeypatch, models):
    """JAX gates every route on `not train`: so does the port."""
    _, tm, _, x = models
    xs = torch.from_numpy(x[:, :, :32, :32])
    all_on = Routes(rublock2d=True, l2block2d=True, tail2d0=True,
                    tail2d1=True, att_fuse=True)
    calls = {}
    _count_port(monkeypatch, calls)
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        with torch.no_grad():
            ref, ref_atts = tm(xs, train=True)
            out, atts = tm(xs, train=True, routes=all_on)
    finally:
        tm.load_state_dict(state)      # train mode moved the BN statistics
    assert calls == {}
    assert torch.equal(out, ref)
    assert all(torch.equal(a, r) for a, r in zip(atts, ref_atts))


def test_residual_unit_rublock2d_route():
    """ResidualUnit takes ops/block2d.py only for the eval two-subunit
    (3,3,1) PReLU+BN unit whose channels change, and only when routed."""
    on = Routes(rublock2d=True)
    kw = dict(subunits=2, dtype=torch.float32, device="cpu")
    down = tblocks.ResidualUnit(1, 8, (3, 3, 1), **kw)
    assert not down._rublock(False)
    assert down._rublock(False, on)
    assert not down._rublock(True, on)                  # a pair
    assert not tblocks.ResidualUnit(8, 8, (3, 3, 1), **kw)._rublock(False, on)
    assert not tblocks.ResidualUnit(1, 8, (3, 3, 1), strides=(2, 2, 1),
                                    **kw)._rublock(False, on)
    # the model's routing helper: level 0 tail before l2block2d
    assert Routes(tail2d0=True).tail2d(0) and not Routes().tail2d(1)
    assert not Routes(tail2d0=True, tail2d1=True).tail2d(2)


def test_model_needs_an_explicit_device():
    with pytest.raises(TypeError, match="device"):
        TUNet(out_channels=2, **CFG)
    with pytest.raises(ValueError, match="explicit device"):
        TUNet(out_channels=2, device=None, **CFG)


def test_routed_model_sites(models):
    """_block_route on the test config's decoder levels."""
    _, tm, _, _ = models
    pair0 = (torch.zeros(1, 4, 8, 8, 8), torch.zeros(1, 4, 8, 8, 8))
    pair1 = (torch.zeros(1, 4, 8, 8, 16), torch.zeros(1, 4, 8, 8, 16))
    r = Routes(l2block2d=True, tail2d1=True)
    assert tm._block_route(pair0, 0, 2, r) == "l2block2d"
    assert tm._block_route(pair1, 1, 16, r) == "tail"
    assert tm._block_route(pair1, 1, 16, Routes()) is None
    assert tm._block_route(pair0, 0, 2, Routes(tail2d0=True)) == "tail"
