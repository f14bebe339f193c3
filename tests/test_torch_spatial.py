"""Spatially sharded inference of the port (one window's H split over the
shards) against the JAX package and the port's dense forward, on the CPU:
the halo exchange (ops/halo.py), the convs under nn/layers.py:
spatial_sharding, pick_gather_level, and infer/spatial.py's predictor with
ru_block and l2_block on halo-extended blocks.

Meshes repeat the CPU device, ("cpu",) * n, n threads of run_spmd; JAX runs
on the 8-device CPU mesh of tests/conftest.py with its (3,3,3) Pallas
blocks in interpret mode (FORCE_INTERPRET), as tests/test_spatial.py runs
them. The model is tests/test_spatial.py's small flagship (channels
8/16/32, H = 128) in float32 on JAX weights with their 1-D leaves shifted
by 0.1. Tolerances: convs 1e-5 against the dense port conv (their sums in
the same order over other buffers); the spatial predictor within 2e-4 of
JAX's make_spatial_predictor and of the dense forward (tests/
test_spatial.py's own tolerance for the fused blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model import SMALL
from vs_seg_tpu.infer.spatial import make_spatial_predictor as jspatial
from vs_seg_tpu.infer.spatial import pick_gather_level as jpick
from vs_seg_tpu.models import UNet2d5_spvPA as JUNet
from vs_seg_tpu.ops import pallas_l2block, pallas_rublock
from vs_seg_tpu.parallel import mesh as jmesh
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.infer.engine import make_predictor
from vs_seg_tpu_torch.infer.sliding_window import sliding_window_inference
from vs_seg_tpu_torch.infer.spatial import (make_spatial_predictor,
                                            pick_gather_level)
from vs_seg_tpu_torch.models import UNet, UNet2d5, UNet2d5_spvPA
from vs_seg_tpu_torch.nn.layers import (ConvTranspose3d, block_halo, conv3d,
                                        same_padding, spatial_sharding)
from vs_seg_tpu_torch.ops import (att, block2d, dsconv, halo, l2block,
                                  rublock, tail2d)
from vs_seg_tpu_torch.parallel import collectives
from vs_seg_tpu_torch.parallel.mesh import make_mesh

T = torch.from_numpy
CFG = dict(channels=(8, 16, 32), strides=((2, 2, 1), (2, 2, 2)),
           kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
           sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
FLAGSHIP_STRIDES = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))
WINS = (1, 8, 128, 32, 1)            # (N, D, H, W, C)


def cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def sharded_h(fn, x, n):
    """fn(local block) on each of n shards under spatial_sharding, the
    outputs concatenated along H."""
    hl = x.shape[2] // n

    def body():
        k = collectives.axis_index()
        with spatial_sharding():
            return fn(x[:, :, k * hl:(k + 1) * hl].contiguous())

    return torch.cat(collectives.run_spmd(body, cpu_mesh(n)), dim=2)


def _close(got, ref, tol):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


# ---- the halo exchange ---------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4])
def test_exchange_halo_and_block_input_match_numpy(n):
    hl, h = 4, 2
    x = np.arange(n * hl, dtype=np.float32).reshape(1, 1, n * hl, 1, 1) + 1

    def body():
        k = collectives.axis_index()
        xs = T(x[:, :, k * hl:(k + 1) * hl])
        return (halo.exchange_halo(xs, (1, 2)),
                *halo.halo_block_input(xs, h))

    for k, (ext, blk, start) in enumerate(collectives.run_spmd(
            body, cpu_mesh(n))):
        rows = x[0, 0, :, 0, 0]
        pad = np.concatenate([[0.0], rows, [0.0, 0.0]])
        np.testing.assert_array_equal(ext[0, 0, :, 0, 0].numpy(),
                                      pad[k * hl:k * hl + hl + 3])
        got = blk[0, 0, :, 0, 0].numpy()
        np.testing.assert_array_equal(got[start:start + hl],
                                      rows[k * hl:(k + 1) * hl])
        if k == 0:       # local rows at the block's start, zeros at its end
            assert start == 0 and (got[-h:] == 0).all()
        elif k == n - 1:
            assert start == 2 * h and (got[:h] == 0).all()
        else:
            assert start == h


def test_spatial_fused_halo():
    """The fused blocks' halo is their chain depth wherever one neighbour
    can lend it, -1 below (the unfused convs run), 0 on a whole block."""
    def body():
        with spatial_sharding():
            return block_halo(8, 2), block_halo(3, 3), block_halo(2, 3)

    assert collectives.run_spmd(body, cpu_mesh(2)) == [(2, 3, -1)] * 2
    assert block_halo(8, 2) == 0
    assert collectives.run_spmd(body, cpu_mesh(1)) == [(0, 0, 0)]


# ---- the convs under the context ------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kernel", [(3, 3, 1), (3, 3, 3), (1, 3, 3)])
def test_halo_conv3d_matches_dense(rng, kernel, n):
    x = T(rng.normal(size=(1, 6, 8 * n, 16, 4)).astype(np.float32))
    w = T((rng.normal(size=(*kernel, 4, 8)) * 0.2).astype(np.float32))
    b = T(rng.normal(size=(8,)).astype(np.float32))
    pads = same_padding(kernel)
    ref = conv3d(x, w, b, (1, 1, 1), pads)
    _close(sharded_h(lambda v: conv3d(v, w, b, (1, 1, 1), pads), x, n), ref,
           1e-5)


@pytest.mark.parametrize("kernel,strides", [((3, 3, 1), (2, 2, 1)),
                                            ((3, 3, 3), (2, 2, 1)),
                                            ((3, 3, 3), (2, 2, 2)),
                                            ((1, 1, 1), (2, 2, 1))])
def test_strided_conv_in_context_matches_dense(rng, kernel, strides):
    x = T(rng.normal(size=(1, 6, 32, 16, 4)).astype(np.float32))
    w = T((rng.normal(size=(*kernel, 4, 8)) * 0.2).astype(np.float32))
    b = T(rng.normal(size=(8,)).astype(np.float32))
    pads = same_padding(kernel)
    ref = conv3d(x, w, b, strides, pads)
    _close(sharded_h(lambda v: conv3d(v, w, b, strides, pads), x, 4), ref,
           1e-5)


@pytest.mark.parametrize("kh,sh", [(3, 2), (5, 2), (3, 3), (2, 2), (4, 2),
                                   (7, 4)])
def test_spatial_transpose_conv_matches_dense(rng, kh, sh):
    """tests/test_spatial.py's (kernel, stride) cases of the MONAI
    transpose conv (output = input * stride)."""
    n, hl = 4, 4
    x = T(rng.normal(size=(1, 3, hl * n, 8, 4)).astype(np.float32))
    tc = ConvTranspose3d(4, 6, (kh, 3, 3), (sh, 2, 1), dtype=torch.float32,
                         device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = tc(x)
        out = sharded_h(tc, x, n)
    _close(out, ref, 1e-5)


# ---- the gather level --------------------------------------------------------------

class _Strides:
    def __init__(self, strides):
        self.strides = strides


@pytest.mark.parametrize("h", [64, 96, 128, 384])
@pytest.mark.parametrize("strides", [FLAGSHIP_STRIDES, SMALL["strides"]],
                         ids=["flagship", "small"])
def test_pick_gather_level_matches_jax(h, strides):
    model = _Strides(tuple(strides))
    for n in (1, 2, 3, 4, 8):
        assert pick_gather_level(model, h, n) == jpick(model, h, n), (h, n)


# ---- the spatial predictor ------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """(JAX model, variables, port model, windows, dense port logits)."""
    jm = JUNet(out_channels=2, num_res_units=2, dropout=None,
               attention_module=True, dtype=jnp.float32, **CFG)
    v = jm.init({"params": jax.random.key(0)}, jnp.zeros(WINS), train=False)
    v = jax.tree.map(lambda a: np.asarray(a + 0.1 if a.ndim == 1 else a,
                                          np.float32), v)
    tm = UNet2d5_spvPA(out_channels=2, dropout=None, dtype=torch.float32,
                       device="cpu", **CFG)
    load_jax_variables(tm, v)
    wins = np.random.default_rng(0).normal(size=WINS).astype(np.float32)
    dense = make_predictor(tm, torch.float32)(T(wins))
    return jm, v, tm, wins, dense


@pytest.fixture(scope="module")
def jax_spatial(small):
    """JAX's make_spatial_predictor on 8 devices with its (3,3,3) Pallas
    blocks in interpret mode."""
    jm, v, _, wins, _ = small
    saved = pallas_rublock.FORCE_INTERPRET, pallas_l2block.FORCE_INTERPRET
    pallas_rublock.FORCE_INTERPRET = pallas_l2block.FORCE_INTERPRET = True
    try:
        return np.array(jspatial(jm, v["params"], v["batch_stats"],
                                 jmesh.make_mesh(),
                                 dtype=jnp.float32)(jnp.asarray(wins)))
    finally:
        pallas_rublock.FORCE_INTERPRET, pallas_l2block.FORCE_INTERPRET = saved


def _counting(monkeypatch, mod, name, calls):
    fn = getattr(mod, name)

    def counted(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(mod, name, counted)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_spatial_predictor_matches_jax_and_dense(small, jax_spatial, n,
                                                 monkeypatch):
    """H = 128 over n shards: every level sharded (local 64/32/16 at level
    0); ru_block at down_1 and the bottom and l2_block at up_1 run on
    halo-extended blocks on every shard."""
    _, _, tm, wins, dense = small
    calls = {}
    _counting(monkeypatch, rublock, "ru_block", calls)
    _counting(monkeypatch, l2block, "l2_block", calls)
    before = dict(halo.BLOCK_CALLS)
    out = make_spatial_predictor(tm, cpu_mesh(n), torch.float32)(T(wins))
    extended = {k: halo.BLOCK_CALLS[k] - before[k] for k in before}
    assert extended == {"ru_block": n, "l2_block": n}, extended
    assert calls["ru_block"] == 2 * n and calls["l2_block"] == n, calls
    _close(out, T(jax_spatial), 2e-4)
    _close(out, dense, 2e-4)


def test_opt_in_routes_are_off_under_the_context(monkeypatch):
    """Each opt-in route, on for a forward of the SMALL flagship (its
    (3,3,1) level 0, its (3,3,3) stride-2 downsample_1/2), launches its
    kernel outside the context and none inside it."""
    model = UNet2d5_spvPA(out_channels=2, dropout=None, dtype=torch.float32,
                          device="cpu", **SMALL)
    calls = {}
    for mod, name in ((block2d, "ru_block2d"), (block2d, "l2_block2d"),
                      (tail2d, "tail_block"), (att, "fused_attention_gate"),
                      (dsconv, "ds_conv")):
        _counting(monkeypatch, mod, name, calls)
    x = T(np.random.default_rng(1).normal(size=(1, 8, 32, 32, 1)).astype(
        np.float32))

    def body(routes):
        k = collectives.axis_index()
        with spatial_sharding():
            return model(x[:, :, 16 * k:16 * (k + 1)].contiguous(),
                         routes=routes)[0]

    fired = set()
    for routes in (Routes(rublock2d=True, tail2d0=True, tail2d1=True,
                          dsconv=True),
                   Routes(l2block2d=True), Routes(att_fuse=True)):
        calls.clear()
        with torch.no_grad():
            model(x, routes=routes)
        fired |= {k for k, v in calls.items() if v}
        calls.clear()
        collectives.run_spmd(body, cpu_mesh(2), routes)
        assert not any(calls.values()), (routes, calls)
    assert fired == {"ru_block2d", "l2_block2d", "tail_block",
                     "fused_attention_gate", "ds_conv"}, fired


def test_spatial_predictor_in_sliding_window(small):
    """Sliding-window inference with the spatial predictor (sw_batch 1, 4
    shards) equals the dense engine."""
    _, _, tm, _, _ = small
    volume = np.random.default_rng(2).normal(size=(40, 36, 10, 1)).astype(
        np.float32)
    roi = (32, 32, 8)
    ref = sliding_window_inference(volume, roi,
                                   make_predictor(tm, torch.float32),
                                   device="cpu", sw_batch_size=1)
    out = sliding_window_inference(
        volume, roi, make_spatial_predictor(tm, cpu_mesh(4), torch.float32),
        device="cpu", sw_batch_size=1)
    _close(out, ref, 1e-5)


def test_gather_level_zero_runs_the_dense_forward(small):
    """H = 36 does not divide over 8 shards: the plain forward, no shard."""
    _, _, tm, _, _ = small
    x = T(np.random.default_rng(3).normal(size=(1, 8, 36, 32, 1)).astype(
        np.float32))
    before = collectives.STATS["all_gather"]
    out = make_spatial_predictor(tm, cpu_mesh(8), torch.float32)(x)
    assert collectives.STATS["all_gather"] == before
    assert torch.equal(out, make_predictor(tm, torch.float32)(x))


def test_unet2d5_runs_spatial_and_unet_refuses():
    m = UNet2d5(out_channels=2, dropout=None, dtype=torch.float32,
                device="cpu", **CFG)
    x = T(np.random.default_rng(4).normal(size=(1, 8, 64, 32, 1)).astype(
        np.float32))
    _close(make_spatial_predictor(m, cpu_mesh(2), torch.float32)(x),
           make_predictor(m, torch.float32)(x), 1e-5)
    u = UNet(out_channels=2, channels=(4, 8), strides=(2,), device="cpu")
    with pytest.raises(NotImplementedError, match="UNet2d5 family"):
        make_spatial_predictor(u, cpu_mesh(2))


def test_a_failing_kernel_in_one_shard_raises(small, monkeypatch):
    _, _, tm, wins, _ = small
    fn = rublock.ru_block

    def fails_on_shard_1(x, **kw):
        if collectives.axis_index() == 1:
            raise RuntimeError("ru_block: launch failed")
        return fn(x, **kw)

    monkeypatch.setattr(rublock, "ru_block", fails_on_shard_1)
    with pytest.raises(RuntimeError, match="launch failed"):
        make_spatial_predictor(tm, cpu_mesh(2), torch.float32)(T(wins))
