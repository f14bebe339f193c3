"""Parity of the port's layers and blocks (vs_seg_tpu_torch/nn) with the JAX
package's modules (vs_seg_tpu/nn) at small sizes, in float32 on the CPU.

Inputs come from numpy with a fixed seed; the JAX module's variables (with
randomised BatchNorm statistics) are loaded into the port's module through
compat/from_jax.py, so the same weights run on both sides. Tolerance: 1e-5
of max|ref| (float32; only the order of the sums differs). CPU convolutions
do not use TF32, so no precision flag is involved.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vs_seg_tpu.nn import blocks as jblocks
from vs_seg_tpu.nn import layers as jlayers
from vs_seg_tpu_torch.compat import jax_state_dict, load_jax_variables
from vs_seg_tpu_torch.nn import blocks as tblocks
from vs_seg_tpu_torch.nn import layers as tlayers

TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _randomise_stats(variables, seed=1):
    """Non-trivial BatchNorm running statistics, so the eval fold matters."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        if path[-1].key == "mean":
            return (a + rng.normal(size=a.shape) * 0.3).astype(np.float32)
        return (a * rng.uniform(0.5, 2.0, size=a.shape)).astype(np.float32)

    out = {"params": _np_tree(variables["params"])}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            one, _np_tree(variables["batch_stats"]))
    return out


def _init(jmod, x, seed=0, **kw):
    xs = tuple(jnp.asarray(v) for v in x) if isinstance(x, tuple) \
        else jnp.asarray(x)
    v = jmod.init({"params": jax.random.key(seed)}, xs, **kw)
    return _randomise_stats(v), xs


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _torch(x):
    return tuple(torch.from_numpy(v) for v in x) if isinstance(x, tuple) \
        else torch.from_numpy(x)


@pytest.mark.parametrize("k,pair", [((3, 3, 1), False), ((3, 3, 3), False),
                                    ((3, 3, 3), True), ((1, 1, 1), True)])
def test_conv3d_matches_jax(k, pair):
    x = (_x((2, 4, 8, 8, 3)), _x((2, 4, 8, 8, 5), 1)) if pair \
        else _x((2, 4, 8, 8, 3))
    jm = jlayers.Conv3d(6, k, dtype=jnp.float32)
    v, xs = _init(jm, x)
    ref = jm.apply(v, xs)
    tm = tlayers.Conv3d(8 if pair else 3, 6, k, dtype=torch.float32,
                        device="cpu")
    load_jax_variables(tm, v)
    _close(tm(_torch(x)), ref)


@pytest.mark.parametrize("k,s", [((3, 3, 1), (2, 2, 1)),
                                 ((3, 3, 3), (2, 2, 2))])
def test_conv_transpose3d_matches_jax(k, s):
    x = _x((2, 3, 4, 5, 4))
    jm = jlayers.ConvTranspose3d(3, k, s, dtype=jnp.float32)
    v, xs = _init(jm, x)
    ref = jm.apply(v, xs)
    tm = tlayers.ConvTranspose3d(4, 3, k, s, dtype=torch.float32,
                                 device="cpu")
    load_jax_variables(tm, v)
    out = tm(_torch(x))
    # output = input * stride in every dim (strides given in (H, W, D))
    assert tuple(out.shape) == (2, 3 * s[2], 4 * s[0], 5 * s[1], 3)
    _close(out, ref)


@pytest.mark.parametrize("act,norm,conv_only", [
    ("prelu", "batch", False), ("relu", None, False),
    ("sigmoid", None, False), ("prelu", "batch", True)])
def test_convolution_matches_jax(act, norm, conv_only):
    x = _x((2, 4, 8, 8, 5))
    jm = jblocks.Convolution(7, (3, 3, 3), act=act, norm=norm, dropout=0.1,
                             conv_only=conv_only, dtype=jnp.float32)
    v, xs = _init(jm, x, train=False)
    ref = jm.apply(v, xs, train=False)
    tm = tblocks.Convolution(5, 7, (3, 3, 3), act=act, norm=norm,
                             dropout=0.1, conv_only=conv_only,
                             dtype=torch.float32, device="cpu")
    load_jax_variables(tm, v)
    _close(tm(_torch(x)), ref)


def test_transposed_convolution_matches_jax():
    x = _x((2, 2, 4, 4, 6))
    jm = jblocks.Convolution(3, (3, 3, 3), (2, 2, 2), is_transposed=True,
                             dtype=jnp.float32)
    v, xs = _init(jm, x, train=False)
    ref = jm.apply(v, xs, train=False)
    tm = tblocks.Convolution(6, 3, (3, 3, 3), (2, 2, 2), is_transposed=True,
                             dtype=torch.float32, device="cpu")
    load_jax_variables(tm, v)
    _close(tm(_torch(x)), ref)


@pytest.mark.parametrize("case", [
    "kd1_two_subunits",       # (3,3,1) encoder unit: plain composite
    "k333_rublock_site",      # (3,3,3) encoder unit: ops/rublock.py route
    "identity_residual",      # Cin == Cout: identity residual
    "headfold_pair",          # conv-only logit head on a pair (up_0)
    "decoder_pair_kd1",       # 1-subunit decoder unit on a pair
    "strided",                # stride 2: full-kernel strided residual conv
])
def test_residual_unit_matches_jax(case):
    if case in ("headfold_pair", "decoder_pair_kd1"):
        x = (_x((2, 4, 8, 8, 4)), _x((2, 4, 8, 8, 4), 1))
        cin = 8
    else:
        x = _x((2, 4, 8, 8, 6 if case == "identity_residual" else 4))
        cin = x.shape[-1]
    k = (3, 3, 3) if case == "k333_rublock_site" else (3, 3, 1)
    feats = {"headfold_pair": 2, "identity_residual": 6}.get(case, 5)
    subunits = 1 if case in ("headfold_pair", "decoder_pair_kd1") else 2
    last = case == "headfold_pair"
    s = (2, 2, 1) if case == "strided" else (1, 1, 1)
    jm = jblocks.ResidualUnit(feats, k, s, subunits=subunits, dropout=0.1,
                              last_conv_only=last, dtype=jnp.float32)
    v, xs = _init(jm, x, train=False)
    ref = jm.apply(v, xs, train=False)
    tm = tblocks.ResidualUnit(cin, feats, k, s, subunits=subunits,
                              dropout=0.1, last_conv_only=last,
                              dtype=torch.float32, device="cpu")
    load_jax_variables(tm, v)
    assert tm._headfold() == last
    assert tm._rublock(isinstance(x, tuple)) == (case == "k333_rublock_site")
    _close(tm(_torch(x)), ref)


@pytest.mark.parametrize("pair,k", [(False, (3, 3, 3)), (True, (3, 3, 1)),
                                    (True, (3, 3, 3))])
def test_attention_block_and_gate_match_jax(pair, k):
    x = (_x((2, 4, 8, 8, 4)), _x((2, 4, 8, 8, 4), 1)) if pair \
        else _x((2, 4, 8, 8, 6))
    jm = jblocks.AttentionBlock1(k, dtype=jnp.float32)
    v, xs = _init(jm, x, train=False, gate=True)
    ref_att, ref_g = jm.apply(v, xs, train=False, gate=True)
    tm = tblocks.AttentionBlock1(8 if pair else 6, k, dtype=torch.float32,
                                 device="cpu")
    load_jax_variables(tm, v)
    att, g = tm(_torch(x), gate=True)
    _close(att, ref_att)
    if pair:
        for a, b in zip(g, ref_g):
            _close(a, b)
    else:
        _close(g, ref_g)


def test_batchnorm_fold_matches_jax():
    jm = jlayers.BatchNorm(features=5)
    v = _randomise_stats(jm.init({"params": jax.random.key(0)}, None, False,
                                 fold=True))
    inv, shift = jm.apply(v, None, False, fold=True)
    tm = tlayers.BatchNorm(5, device="cpu")
    load_jax_variables(tm, v)
    t_inv, t_shift = tm.fold()
    _close(t_inv, inv, 1e-6)
    _close(t_shift, shift, 1e-6)


def test_same_padding_and_init_bounds():
    assert tlayers.same_padding((3, 3, 1)) == jlayers.same_padding((3, 3, 1))
    g = torch.Generator().manual_seed(0)
    conv = tlayers.Conv3d(4, 6, (3, 3, 3), device="cpu", generator=g)
    bound = 1 / np.sqrt(4 * 27)
    assert tuple(conv.kernel.shape) == (3, 3, 3, 4, 6)
    assert float(conv.kernel.detach().abs().max()) <= bound
    again = tlayers.Conv3d(4, 6, (3, 3, 3), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(conv.kernel, again.kernel)   # seeded, reproducible


def test_from_jax_is_strict():
    x = _x((1, 2, 4, 4, 3))
    jm = jblocks.Convolution(4, (3, 3, 1), dtype=jnp.float32)
    v, _ = _init(jm, x, train=False)
    tm = tblocks.Convolution(3, 4, (3, 3, 1), dtype=torch.float32,
                             device="cpu")
    assert set(jax_state_dict(v)) == set(tm.state_dict())
    extra = {"params": dict(v["params"], stray={"kernel": np.zeros(1)}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="unused"):
        load_jax_variables(tm, extra)
    missing = {"params": {k: val for k, val in v["params"].items()
                          if k != "act"},
               "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(tm, missing)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import vs_seg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'vs_seg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'vs_seg_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'vs_seg_tpu_torch.ops.conv333' in sys.modules\n"
        "assert 'vs_seg_tpu_torch.ops.dsconv' in sys.modules\n"
        "assert 'vs_seg_tpu_torch.train.trainer' in sys.modules\n"
        "assert 'vs_seg_tpu_torch.cli.inference' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(__import__("pathlib").Path(__file__).parents[1]))
