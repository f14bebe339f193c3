"""Parity of the port's kernel modules (vs_seg_tpu_torch/ops) with the JAX
package's Pallas kernels, run as the JAX tests run them on the CPU (Pallas
interpret mode).

On the CPU each port wrapper runs its plain PyTorch twin (the CUDA kernels
only run on the card: tests/test_torch_cuda.py and chip_smoke.py hold them
against these twins). Shapes satisfy the TPU kernels' preconditions (W % 16
== 0, H % 8 == 0, C <= 64). Inputs come from numpy with a fixed seed; all
compute is float32. Tolerances are relative to max|ref|: 1e-5 for one conv,
1e-4 for the chained blocks (float32, only the summation order differs),
and exact for the blend, which keeps the reference's f32 operation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vs_seg_tpu.infer.sliding_window import _scatter_accumulate
from vs_seg_tpu.nn.blocks import AttentionBlock1
from vs_seg_tpu.nn.layers import conv3d as jconv3d
from vs_seg_tpu.ops.pallas_blend import pallas_blend_scatter
from vs_seg_tpu.ops.pallas_conv333 import can_conv333
from vs_seg_tpu.ops.pallas_conv333 import conv333 as jconv333
from vs_seg_tpu.ops.pallas_l2block import can_l2_block, l2_block as jl2
from vs_seg_tpu.ops.pallas_rublock import can_ru_block, ru_block as jru
from vs_seg_tpu_torch.ops import (att, blend, block2d, conv333, l2block,
                                  rublock, tail2d)


def _rel_err(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _w(rng, k, cin, cout):
    b = 1.0 / np.sqrt(cin * int(np.prod(k)))
    return rng.uniform(-b, b, size=(*k, cin, cout)).astype(np.float32)


def _v(rng, c, lo, hi):
    return rng.uniform(lo, hi, size=(c,)).astype(np.float32)


T = torch.from_numpy


@pytest.mark.parametrize("shape,cins,cout,epilogue", [
    ((1, 3, 16, 16), (48,), 48, True),      # L2-like single input
    ((2, 2, 16, 16), (40,), 64, False),     # channel padding, plain conv
    ((1, 2, 16, 16), (24, 24), 48, True),   # pair input (decoder concat)
    ((1, 2, 8, 16), (12,), 20, True),       # odd widths
])
def test_conv333_matches_pallas(shape, cins, cout, epilogue):
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(*shape, c)).astype(np.float32) for c in cins]
    w = _w(rng, (3, 3, 3), sum(cins), cout)
    scale = _v(rng, cout, 0.5, 1.5) if epilogue else None
    shift = _v(rng, cout, -0.3, 0.3) if epilogue else None
    alpha = _v(rng, 1, 0.1, 0.4) if epilogue else None
    assert can_conv333([x.shape for x in xs], w.shape)
    jx = tuple(jnp.asarray(x) for x in xs)
    ref = jconv333(jx if len(xs) > 1 else jx[0], jnp.asarray(w),
                   None if scale is None else jnp.asarray(scale),
                   None if shift is None else jnp.asarray(shift),
                   None if alpha is None else jnp.asarray(alpha),
                   interpret=True)
    tx = tuple(T(x) for x in xs)
    got = conv333.conv333(tx if len(xs) > 1 else tx[0], T(w),
                          None if scale is None else T(scale),
                          None if shift is None else T(shift),
                          None if alpha is None else T(alpha))
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("pair", [False, True])
def test_conv333_residual_form(pair):
    """The fused 1x1 residual (added after the activation) equals the JAX
    composition conv333 epilogue + 1x1 conv3d + bias."""
    rng = np.random.default_rng(1)
    shape = (1, 2, 16, 16)
    cins = (16, 16) if pair else (24,)
    cout = 16
    xs = [rng.normal(size=(*shape, c)).astype(np.float32) for c in cins]
    w = _w(rng, (3, 3, 3), sum(cins), cout)
    wr = _w(rng, (1, 1, 1), sum(cins), cout)
    br = _v(rng, cout, -0.3, 0.3)
    s, h, a = (_v(rng, cout, 0.5, 1.5), _v(rng, cout, -0.3, 0.3),
               _v(rng, 1, 0.1, 0.4))
    jx = tuple(jnp.asarray(x) for x in xs)
    y = jconv333(jx if pair else jx[0], jnp.asarray(w), jnp.asarray(s),
                 jnp.asarray(h), jnp.asarray(a), interpret=True)
    r = jconv3d(jnp.concatenate(jx, -1), jnp.asarray(wr), jnp.asarray(br),
                (1, 1, 1), [(0, 0)] * 3, dtype=jnp.float32)
    ref = y + r
    tx = tuple(T(x) for x in xs)
    xin = tx if pair else tx[0]
    got = conv333.conv333(xin, T(w), T(s), T(h), T(a),
                          residual=(xin, T(wr), T(br)))
    assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("cins,cout,kd", [
    ((48,), 48, 3), ((80, 80), 80, 3),
    ((1,), 16, 1),                # Cin 1 (down_0 unit0)
    ((16, 16), 2, 1),             # the logit head: N = 8
    ((5,), 7, 3),                 # nothing aligned
    ((3,), 130, 3),               # two N tiles of 80
])
def test_packed_weights_gmma_layout(cins, cout, kd):
    """The wgmma-layout weight csrc/conv333.cu reads (main and residual),
    contracted in the kernel's order (N tile, 16-channel chunk, depth tap,
    tap, core matrix), equals the plain conv: pins the chunk and tap order,
    the core-matrix layout and the channel/Cout padding."""
    rng = np.random.default_rng(7)
    shape = (1, 3, 5, 6)
    xs = [T(rng.normal(size=(*shape, c)).astype(np.float32)) for c in cins]
    w = T(_w(rng, (3, 3, kd), sum(cins), cout))
    wr = T(_w(rng, (1, 1, 1), sum(cins), cout))
    n_t, cop = conv333._ntile(cout)
    assert n_t in conv333.N_TILES and cop % n_t == 0 and cop >= cout
    assert cop - cout < 16 * (cop // n_t)
    wm = conv333.pack_weights_gmma(w, cins, n_t).float()
    wrm = conv333.pack_weights_gmma(wr, cins, n_t).float()
    chunks = sum(-(-c // 16) for c in cins)
    assert tuple(wm.shape) == (cop // n_t, chunks, kd, 9, n_t // 8, 2, 8, 8)
    assert tuple(wrm.shape) == (cop // n_t, chunks, 1, 1, n_t // 8, 2, 8, 8)
    n, d, h, wd = shape
    out = torch.zeros((*shape, cop))
    res = torch.zeros((*shape, cop))
    for nt in range(cop // n_t):
        cols = slice(nt * n_t, (nt + 1) * n_t)
        j = 0
        for x in xs:
            c = x.shape[-1]
            xc = torch.nn.functional.pad(x, (0, -(-c // 16) * 16 - c))
            xp = torch.nn.functional.pad(xc, (0, 0, 1, 1, 1, 1, kd // 2,
                                              kd // 2))
            for c0 in range(0, xc.shape[-1], 16):
                # [ng, half, row co, ci] -> (16 ci, n_t co)
                def slab(t):
                    return t.permute(1, 3, 0, 2).reshape(16, n_t)
                for p in range(kd):
                    for kh in range(3):
                        for kw in range(3):
                            tap = xp[:, p:p + d, kh:kh + h, kw:kw + wd,
                                     c0:c0 + 16]
                            out[..., cols] += tap @ slab(
                                wm[nt, j, p, kh * 3 + kw])
                res[..., cols] += xc[..., c0:c0 + 16] @ slab(wrm[nt, j, 0, 0])
                j += 1
        assert j == chunks
    xin = tuple(xs) if len(xs) > 1 else xs[0]
    # the plain twin sees bf16-rounded weights, as the kernel does
    ref = conv333.conv333_plain(xin, w.to(torch.bfloat16).float())
    ref_r = conv333.conv333_plain(xin, wr.to(torch.bfloat16).float())
    assert _rel_err(out[..., :cout], ref.numpy()) <= 1e-5
    assert _rel_err(res[..., :cout], ref_r.numpy()) <= 1e-5
    assert not out[..., cout:].any() and not res[..., cout:].any()


def test_packed_weights_cache():
    """The packed weight is cached on the weight tensor: a second call hits,
    an in-place update (w._version) or another N misses, and a deep copy
    of the tensor starts with no cache. Another use (ds_conv's) or another
    pack function shares the cache under its own key."""
    import copy
    rng = np.random.default_rng(8)
    w = T(_w(rng, (3, 3, 3), 16, 32))
    p1 = conv333.packed_weights(w, "conv333", [16], 32, "cpu")
    assert conv333.packed_weights(w, "conv333", [16], 32, "cpu") is p1
    ds = conv333.packed_weights(w, "ds_conv", (16,), 32, "cpu")
    assert ds is not p1 and torch.equal(ds, p1)
    flat = conv333.packed_weights(w, "flat", [16], 32, "cpu",
                                  pack=lambda v, cins, n: v.reshape(-1, n))
    assert tuple(flat.shape) == (27 * 16, 32)
    assert conv333.packed_weights(w, "conv333", [16], 32, "cpu") is p1
    assert conv333.packed_weights(w, "ds_conv", (16,), 32, "cpu") is ds
    assert conv333.packed_weights(w, "conv333", [16], 48, "cpu") is not p1
    w.add_(1)
    p2 = conv333.packed_weights(w, "conv333", [16], 32, "cpu")
    assert p2 is not p1
    assert torch.equal(p2, conv333.pack_weights_gmma(w, [16], 32))
    assert not torch.equal(p2, p1)
    assert conv333.packed_weights(w, "conv333", [16], 32, "cpu") is p2
    wc = copy.deepcopy(w)
    assert not wc._vs_packed
    assert conv333.packed_weights(wc, "conv333", [16], 32, "cpu") is not p2


def _ru_params(rng, cin, cout):
    return dict(w0=_w(rng, (3, 3, 3), cin, cout),
                bn0_scale=_v(rng, cout, 0.5, 1.5),
                bn0_shift=_v(rng, cout, -0.3, 0.3), alpha0=_v(rng, 1, .1, .4),
                w1=_w(rng, (3, 3, 3), cout, cout),
                bn1_scale=_v(rng, cout, 0.5, 1.5),
                bn1_shift=_v(rng, cout, -0.3, 0.3), alpha1=_v(rng, 1, .1, .4),
                wr=_w(rng, (1, 1, 1), cin, cout), br=_v(rng, cout, -.3, .3))


@pytest.mark.parametrize("dims,cout", [((1, 3, 16, 16, 12), 16),
                                       ((2, 2, 16, 16, 32), 48),
                                       ((1, 1, 8, 16, 48), 64)])
def test_ru_block_matches_pallas(dims, cout):
    rng = np.random.default_rng(3)
    x = rng.normal(size=dims).astype(np.float32)
    p = _ru_params(rng, dims[-1], cout)
    assert can_ru_block(x.shape, dims[-1], cout)
    ref = jru(jnp.asarray(x), interpret=True,
              **{k: jnp.asarray(v) for k, v in p.items()})
    got = rublock.ru_block(T(x), **{k: T(v) for k, v in p.items()})
    assert _rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("dims", [(1, 3, 16, 16, 12), (1, 2, 16, 16, 48),
                                  (2, 1, 8, 16, 24)])
def test_l2_block_matches_pallas(dims):
    rng = np.random.default_rng(4)
    C = dims[-1]
    xa = rng.normal(size=dims).astype(np.float32)
    xb = rng.normal(size=dims).astype(np.float32)
    p = dict(w1=_w(rng, (3, 3, 3), 2 * C, C), b1=_v(rng, C, -.3, .3),
             w2=_w(rng, (3, 3, 3), C, 1), b2=_v(rng, 1, -.3, .3),
             w0=_w(rng, (3, 3, 3), 2 * C, C), bn_scale=_v(rng, C, .5, 1.5),
             bn_shift=_v(rng, C, -.3, .3), alpha=_v(rng, 1, .1, .4),
             wr=_w(rng, (1, 1, 1), 2 * C, C), br=_v(rng, C, -.3, .3))
    assert can_l2_block(xa.shape, C)
    ref = jl2(jnp.asarray(xa), jnp.asarray(xb), interpret=True,
              **{k: jnp.asarray(v) for k, v in p.items()})
    out, att = l2block.l2_block(T(xa), T(xb),
                                **{k: T(v) for k, v in p.items()})
    assert _rel_err(out, ref) <= 1e-4
    # the attention map against the JAX AttentionBlock1 with the same convs
    jm = AttentionBlock1((3, 3, 3), dtype=jnp.float32)
    ref_att, _ = jm.apply(
        {"params": {"conv1": {"conv": {"kernel": p["w1"], "bias": p["b1"]}},
                    "conv2": {"conv": {"kernel": p["w2"], "bias": p["b2"]}}}},
        (jnp.asarray(xa), jnp.asarray(xb)), train=False, gate=False)
    assert _rel_err(att, ref_att) <= 1e-5


@pytest.mark.parametrize("oc,preds_dtype", [(2, np.float32), (4, np.float32),
                                            (2, "bf16")])
def test_blend_matches_pallas_and_xla(oc, preds_dtype):
    rng = np.random.default_rng(5)
    D, H, W = 12, 16, 16
    rd, rh, rw = 4, 8, 8
    preds = rng.normal(size=(4, rd, rh, rw, oc)).astype(np.float32)
    if preds_dtype == "bf16":   # values exactly representable in bf16
        preds = T(preds).to(torch.bfloat16).float().numpy()
    # overlapping windows, one masked (a padded batch slot), a duplicate
    starts = np.array([[0, 0, 0], [4, 8, 8], [2, 4, 2], [4, 8, 8]], np.int32)
    mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    imp = (rng.random((rd, rh, rw)) + 0.1).astype(np.float32)
    out0 = rng.normal(size=(D, H, W, oc)).astype(np.float32)
    w0 = rng.random((D, H, W, 1)).astype(np.float32)
    args = (jnp.asarray(preds), jnp.asarray(starts), jnp.asarray(mask),
            jnp.asarray(imp))
    ref_o, ref_w = _scatter_accumulate(jnp.asarray(out0), jnp.asarray(w0),
                                       *args)
    pal_o, pal_w = pallas_blend_scatter(jnp.asarray(out0), jnp.asarray(w0),
                                        *args, interpret=True)
    tp = T(preds).to(torch.bfloat16) if preds_dtype == "bf16" else T(preds)
    got_o, got_w = blend.blend_scatter(T(out0.copy()), T(w0.copy()), tp,
                                       starts, mask, T(imp))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(pal_o), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(pal_w), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["conv333", "attgate", "ru_block",
                                  "l2_block", "blend_scatter", "ru_block2d",
                                  "l2_block2d", "tail_block",
                                  "fused_attention_gate"])
def test_wrappers_refuse_other_devices(name):
    """A wrapper runs its plain twin only for CPU tensors; for any other
    device that is not CUDA it raises instead of falling back."""
    x = torch.zeros((1, 1, 8, 16, 16), device="meta")
    w = torch.zeros((3, 3, 3, 16, 16))
    w1 = torch.zeros((3, 3, 1, 16, 16))
    v = torch.zeros(16)
    l2d = dict(w2=torch.zeros(3, 3, 1, 16, 1), b2=v[:1],
               w0=torch.zeros(3, 3, 1, 32, 16), bn_scale=v, bn_shift=v,
               alpha=v[:1], wr=torch.zeros(1, 1, 1, 32, 16), br=v)
    calls = {
        "conv333": lambda: conv333.conv333(x, w),
        "attgate": lambda: l2block.attgate(x, torch.zeros(3, 3, 3, 16, 1),
                                           torch.zeros(1), x, x),
        "ru_block": lambda: rublock.ru_block(
            x, w0=w, bn0_scale=v, bn0_shift=v, alpha0=v[:1], w1=w,
            bn1_scale=v, bn1_shift=v, alpha1=v[:1],
            wr=torch.zeros(1, 1, 1, 16, 16), br=v),
        "l2_block": lambda: l2block.l2_block(
            x, x, w1=torch.zeros(3, 3, 3, 32, 16), b1=v,
            w2=torch.zeros(3, 3, 3, 16, 1), b2=v[:1],
            w0=torch.zeros(3, 3, 3, 32, 16), bn_scale=v, bn_shift=v,
            alpha=v[:1], wr=torch.zeros(1, 1, 1, 32, 16), br=v),
        "blend_scatter": lambda: blend.blend_scatter(
            torch.zeros((4, 4, 4, 2), device="meta"),
            torch.zeros((4, 4, 4, 1), device="meta"),
            torch.zeros((1, 2, 2, 2, 2), device="meta"), np.zeros((1, 3)),
            np.ones(1), torch.zeros((2, 2, 2), device="meta")),
        "ru_block2d": lambda: block2d.ru_block2d(
            x, w0=w1, bn0_scale=v, bn0_shift=v, alpha0=v[:1], w1=w1,
            bn1_scale=v, bn1_shift=v, alpha1=v[:1],
            wr=torch.zeros(1, 1, 1, 16, 16), br=v),
        "l2_block2d": lambda: block2d.l2_block2d(
            x, x, w1=torch.zeros(3, 3, 1, 32, 16), b1=v, **l2d),
        "tail_block": lambda: tail2d.tail_block(x, x, x, **l2d),
        "fused_attention_gate": lambda: att.fused_attention_gate(
            x, (x, x), torch.zeros(3, 3, 1, 16, 1), v[:1]),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[name]()


def test_no_kernel_launch_on_cpu():
    """The CPU route never counts a launch: counts are CUDA launches only."""
    fns = (conv333.conv333, rublock.ru_block, l2block.attgate,
           block2d.ru_block2d, block2d.l2_block2d, tail2d.tail_block,
           att.fused_attention_gate)
    before = [f.launches for f in fns]
    rng = np.random.default_rng(6)
    x = T(rng.normal(size=(1, 2, 8, 16, 12)).astype(np.float32))
    p = {k: T(v) for k, v in _ru_params(rng, 12, 16).items()}
    rublock.ru_block(x, **p)
    p2d = {k: v[:, :, 1:2] if k in ("w0", "w1") else v for k, v in p.items()}
    block2d.ru_block2d(x, **p2d)
    xa = T(rng.normal(size=(1, 2, 8, 16, 8)).astype(np.float32))
    tail = dict(w2=T(_w(rng, (3, 3, 1), 8, 1)), b2=T(_v(rng, 1, -.3, .3)),
                w0=T(_w(rng, (3, 3, 1), 16, 2)), bn_scale=None,
                bn_shift=T(_v(rng, 2, -.3, .3)), alpha=None,
                wr=T(_w(rng, (1, 1, 1), 16, 2)), br=T(_v(rng, 2, -.3, .3)))
    block2d.l2_block2d(xa, xa, w1=T(_w(rng, (3, 3, 1), 16, 8)),
                       b1=T(_v(rng, 8, -.3, .3)), **tail)
    tail2d.tail_block(xa, xa, xa, **tail)
    att.fused_attention_gate(xa, (xa, xa), tail["w2"], tail["b2"])
    assert [f.launches for f in fns] == before
