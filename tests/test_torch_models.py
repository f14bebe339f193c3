"""The rest of the model zoo and `--remat`, JAX against the port, on the CPU.

UNet2d5 (the flagship without attention, under `net`) and UNet (the vendored
MONAI UNet) at the size of tests/test_model.py:test_alt_models_train_one_step
(channels (4, 8, 12), strides ((2,2,1), (2,2,2)), input 4x16x16), float32:
the eval forward with Routes(dsconv) off and on, the train-mode loss and
its gradient (dropout 0), strict loading of the `net.` tree, build_model
for every name, a Trainer step and run_inference on each; then the flagship
with --remat against itself without it.

JAX variables come from vs_seg_tpu.train.trainer.init_model with randomised
BatchNorm statistics and biases, converted with load_jax_variables.
Tolerances (tests/test_torch_train.py): forward 1e-4 of max|ref| (CPU
convolutions, only the order of the sums differs); loss 1e-5 relative; each
parameter's gradient within 1e-4 of the model's largest gradient (conv
biases in front of a train-mode BatchNorm have a gradient that is zero in
exact arithmetic); BatchNorm running statistics 1e-5 relative. Remat
recomputes the same operations in the same order: the loss, the gradients,
the statistics and the generator's state are equal bit for bit.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model import SMALL
from vs_seg_tpu.core.config import Config as JConfig
from vs_seg_tpu.infer.engine import run_inference as jrun_inference
from vs_seg_tpu.losses.dice import dice_spvpa_loss as jloss
from vs_seg_tpu.models import build_model as jbuild_model
from vs_seg_tpu.train import trainer as jtrainer
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.compat import jax_ckpt
from vs_seg_tpu_torch.core.config import Config, Routes, parse_cli
from vs_seg_tpu_torch.infer.engine import run_inference
from vs_seg_tpu_torch.losses.dice import dice_spvpa_loss
from vs_seg_tpu_torch.models import (UNet, UNet2d5, UNet2d5_spvPA,
                                     build_model)
from vs_seg_tpu_torch.ops import dsconv, rublock, train_conv
from vs_seg_tpu_torch.train import trainer as ttrainer
from vs_seg_tpu_torch.train.checkpoint import (load_model_state,
                                               save_checkpoint)

T = torch.from_numpy
CFG = dict(channels=(4, 8, 12), strides=((2, 2, 1), (2, 2, 2)),
           kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
           sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
X_SHAPE = (2, 4, 16, 16, 1)          # (N, D, H, W, C)
# (cfg.model, num_res_units) of every case
CASES = {"UNet2d5": ("UNet2d5", 2), "UNet-nru0": ("UNet", 0),
         "UNet-nru1": ("UNet", 1), "UNet-nru2": ("UNet", 2)}
# eval sites of each case: ds_conv under Routes(dsconv=True) (UNet2d5's
# downsample_1; UNet's strided down_1, its unit0 when it is a
# ResidualUnit) and ru_block (two-subunit stride-1 units whose channels
# change: UNet2d5's down_1 and bottom, UNet's bottom at nru 2)
EVAL_SITES = {"UNet2d5": (1, 2), "UNet-nru0": (1, 0), "UNet-nru1": (1, 0),
              "UNet-nru2": (1, 1)}
# (3,3,3) stride-1 convs of the train forward (ops/train_conv.py), pair
# halves apart: UNet2d5's down_1 x 2, bottom x 2, up_1's unit0 x 2; UNet's
# unit1 of each strided unit, the bottom's, and each upres unit0
TRAIN_SITES = {"UNet2d5": 6, "UNet-nru0": 1, "UNet-nru1": 3,
               "UNet-nru2": 6}


def _cfgs(case, **kw):
    """(JAX Config, port Config) of a case, float32, dropout 0."""
    name, nru = CASES[case]
    common = dict(model=name, num_res_units=nru, dropout=0.0,
                  compute_dtype="float32", infer_dtype="float32",
                  attention=False, **CFG, **kw)
    return JConfig(**common), Config(device="cpu", **common)


def _variables(jmodel, seed=0):
    v = jtrainer.init_model(jmodel, seed, input_shape=(1, *X_SHAPE[1:]))
    rng = np.random.default_rng(seed + 1)

    def param(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "bias":
            return (a + rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return a

    def stats(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return (a + rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return (a * rng.uniform(0.5, 1.5, size=a.shape)).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(param, v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stats, v["batch_stats"])}


def _pair(case, seed=0):
    jcfg, tcfg = _cfgs(case)
    jm = jbuild_model(jcfg)
    v = _variables(jm, seed)
    tm = build_model(tcfg, device="cpu")
    load_jax_variables(tm, v)
    return jm, tm, v


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return (request.param, *_pair(request.param))


def _rel(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=X_SHAPE).astype(np.float32)
    y = (rng.random(X_SHAPE) > 0.7).astype(np.float32)
    return x, y


# ---- eval -----------------------------------------------------------------

@pytest.mark.parametrize("route", ["default", "dsconv"])
def test_eval_forward_matches_jax(pair, monkeypatch, route):
    """Logits alone (no attention maps) within 1e-4 of JAX; the kernel
    sites each route takes, counted."""
    case, jm, tm, v = pair
    x, _ = _batch(1)
    ref = jm.apply(v, jnp.asarray(x), train=False)
    assert not isinstance(ref, tuple)
    calls = {}
    _counting(monkeypatch, dsconv, "ds_conv", calls)
    _counting(monkeypatch, rublock, "ru_block", calls)
    with torch.no_grad():
        out = tm(T(x), routes=Routes(dsconv=route == "dsconv"))
    assert isinstance(out, torch.Tensor) and out.shape == (*X_SHAPE[:4], 2)
    assert _rel(out, ref) <= 1e-4
    n_ds, n_ru = EVAL_SITES[case]
    assert calls.get("ds_conv", 0) == (n_ds if route == "dsconv" else 0)
    assert calls.get("ru_block", 0) == n_ru


def test_eval_plain_path_equals_the_kernel_path(pair):
    """use_kernels=False runs each site's plain twin, which is what the
    wrappers run on CPU tensors: the same logits."""
    _, _, tm, _ = pair
    x, _ = _batch(2)
    with torch.no_grad():
        for routes in (Routes(), Routes(dsconv=True)):
            assert torch.equal(tm(T(x), routes=routes),
                               tm(T(x), use_kernels=False, routes=routes))


# ---- train ----------------------------------------------------------------

def test_train_loss_and_gradient_match_jax(pair, monkeypatch):
    """dice_spvpa_loss (no attention maps) of the train-mode forward, its
    gradient wrt every parameter, and the updated running statistics."""
    case, jm, tm, v = pair
    x, y = _batch(3)

    def loss_fn(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jloss(out, (), jnp.asarray(y)), mut["batch_stats"]

    (ref, ref_stats), ref_g = jax.value_and_grad(loss_fn, has_aux=True)(
        v["params"])
    calls = {}
    _counting(monkeypatch, train_conv, "conv333_train", calls)
    state = {k: t.clone() for k, t in tm.state_dict().items()}
    try:
        out = tm(T(x), train=True)
        loss = dice_spvpa_loss(out, (), T(y))
        loss.backward()
        got_stats = {k: t.clone() for k, t in tm.state_dict().items()}
        grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    finally:
        tm.load_state_dict(state)      # train mode moved the statistics
        tm.zero_grad(set_to_none=True)
    assert calls == {"conv333_train": TRAIN_SITES[case]}
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    flat = {".".join(k.key for k in path): np.asarray(g) for path, g in
            jax.tree_util.tree_flatten_with_path(ref_g)[0]}
    assert sorted(flat) == sorted(grads)
    scale = max(np.abs(g).max() for g in flat.values())
    for name, g in grads.items():
        err = np.abs(g.numpy() - flat[name]).max()
        assert err <= 1e-4 * scale, (name, err, scale)
    for path, ref_s in jax.tree_util.tree_flatten_with_path(ref_stats)[0]:
        name = ".".join(k.key for k in path)
        assert _rel(got_stats[name], ref_s) <= 1e-5, name


# ---- the net tree, build_model ---------------------------------------------

def test_unet2d5_loads_the_net_tree_strictly(tmp_path):
    """UNet2d5's parameters are the flagship's under `net.`: JAX's tree
    loads key for key, the flagship's own tree (no `net`) does not, and
    load_model_state reads both a JAX and a port checkpoint of it."""
    jm, tm, v = _pair("UNet2d5")
    assert v["params"].keys() == {"net"}
    assert all(k.startswith("net.") for k in tm.state_dict())
    bare = {c: v[c]["net"] for c in v}
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(build_model(_cfgs("UNet2d5")[1], device="cpu"),
                           bare)
    flagship = UNet2d5_spvPA(out_channels=2, attention_module=False,
                             dtype=torch.float32, device="cpu", **CFG)
    load_jax_variables(flagship, bare)
    x, _ = _batch(4)
    with torch.no_grad():
        assert torch.equal(tm(T(x)), flagship(T(x))[0])
    _, tcfg = _cfgs("UNet2d5", data_root=str(tmp_path),
                    results_folder_name="r")
    from vs_seg_tpu.train.checkpoint import save_checkpoint as jsave
    for kind in ("jax", "torch"):
        path = f"{tcfg.model_path}/best_metric_model.ckpt"
        if kind == "jax":
            jsave(path, {"params": v["params"],
                         "batch_stats": v["batch_stats"]})
            assert jax_ckpt.load_jax_checkpoint(path)["params"].keys() \
                == {"net"}
        else:
            save_checkpoint(path, {"model": tm.state_dict()})
        fresh = build_model(tcfg, device="cpu")
        assert load_model_state(tcfg, fresh) == kind
        for k, t in fresh.state_dict().items():
            assert torch.equal(t, tm.state_dict()[k]), (kind, k)


@pytest.mark.parametrize("name,cls", [("UNet2d5_spvPA", UNet2d5_spvPA),
                                      ("UNet2d5", UNet2d5), ("UNet", UNet)])
def test_build_model_builds_each_model(name, cls):
    """Each name builds its class on the device given, in the compute
    dtype, with the parameter tree of JAX's build_model for the same
    Config; --remat reaches the flagship only."""
    common = dict(model=name, **CFG)
    jm = jbuild_model(JConfig(**common))
    jv = jtrainer.init_model(jm, 0, input_shape=(1, *X_SHAPE[1:]))
    tm = build_model(Config(**common), device="cpu")
    assert type(tm) is cls
    shapes = {".".join(k.key for k in path): tuple(a.shape)
              for coll in ("params", "batch_stats") for path, a in
              jax.tree_util.tree_flatten_with_path(jv[coll])[0]}
    assert shapes == {k: tuple(t.shape) for k, t in tm.state_dict().items()}
    assert all(p.device.type == "cpu" for p in tm.parameters())
    if name == "UNet":
        assert tm.strides == jm.strides == ((2, 2, 1), (2, 2, 2))
    cfg = parse_cli(["--device", "cpu", "--remat"])
    assert cfg.remat
    built = build_model(dataclasses.replace(cfg, model=name, **CFG),
                        device="cpu")
    assert getattr(built, "remat", False) is (name == "UNet2d5_spvPA")


def test_build_model_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="unknown cfg.model"):
        build_model(Config(model="nope"), device="cpu")


# ---- the trainer and run_inference on each alt model ---------------------

@pytest.mark.parametrize("case", ["UNet2d5", "UNet-nru2"])
def test_trainer_step_and_fit_on_alt_models(case, tmp_path):
    """One train step of JAX's make_train_step and of the port's, from the
    same converted state (loss 1e-5 relative), then Trainer.fit for one
    epoch with validation: finite losses, a Dice, checkpoints."""
    jm, tm, v = _pair(case, seed=5)
    x, y = _batch(6)
    jopt = jtrainer.make_optimizer(1e-3, 1e-7)
    jstep = jtrainer.make_train_step(jm, jopt, supervised_attention=False,
                                     hardness=True)
    *_, jl = jstep(v["params"], v["batch_stats"], jopt.init(v["params"]),
                   jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    topt = ttrainer.make_optimizer(tm.parameters(), 1e-3, 1e-7)
    tstep = ttrainer.make_train_step(tm, topt, supervised_attention=False,
                                     hardness=True)
    tl = tstep(T(x), T(y), None)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))

    _, cfg = _cfgs(case, data_root=str(tmp_path), results_folder_name="t",
                   num_epochs=1, val_interval=1)
    tr = ttrainer.Trainer(cfg, tm, "cpu", logger=logging.getLogger("t"))
    batch = {"image": np.transpose(x, (0, 4, 2, 3, 1)),
             "label": np.transpose(y, (0, 4, 2, 3, 1))}
    state, losses, metrics = tr.fit(tr.init_state(), [batch, batch],
                                    [batch])
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert len(metrics) == 1 and 0.0 <= metrics[0] <= 1.0
    assert (tmp_path / "results" / "t" / "model"
            / "last_epoch_model.ckpt").is_file()


@pytest.mark.parametrize("case", ["UNet2d5", "UNet-nru2"])
def test_run_inference_on_alt_models_matches_jax(case):
    """run_inference over two small volumes (sliding window at a 16x16x8
    ROI, 2 windows a batch, no export): each volume's Dice equal to JAX's
    run_inference on the same weights within 1e-5."""
    jm, tm, v = _pair(case, seed=7)
    rng = np.random.default_rng(8)
    vols = []
    for shape in ((24, 20, 12), (16, 16, 8)):
        img = rng.normal(size=(1, 1, *shape)).astype(np.float32)
        lab = (img > 0.3).astype(np.float32)
        vols.append({"image": img, "label": lab,
                     "label_meta": [{"affine": np.eye(4)}]})
    jcfg, tcfg = _cfgs(case, sliding_window_inferer_roi_size=(16, 16, 8),
                       sw_batch_size=2, export_inferred_segmentations=False)
    jdice, _ = jrun_inference(jcfg, jm, v["params"], v["batch_stats"], vols,
                              make_figures=False)
    dice, times = run_inference(tcfg, tm, vols, device="cpu",
                                make_figures=False)
    assert len(times) == 2 and np.isfinite(dice).all()
    np.testing.assert_allclose(dice, jdice, atol=1e-5)


# ---- --remat ----------------------------------------------------------------

def _remat_step(remat: bool, x, y, calls):
    """One train forward + backward of the SMALL flagship (dropout 0.1,
    float32) from seed 0 and a generator seeded 3; (loss, gradients,
    state_dict, generator state)."""
    model = UNet2d5_spvPA(out_channels=2, dtype=torch.float32, dropout=0.1,
                          remat=remat, device="cpu",
                          generator=torch.Generator().manual_seed(0),
                          **SMALL)
    for name in ("down_0", "upsample_1", "up_1", "down_2"):
        getattr(model, name).register_forward_pre_hook(
            lambda m, a, name=name: calls.__setitem__(
                name, calls.get(name, 0) + 1))
    gen = torch.Generator().manual_seed(3)
    logits, atts = model(T(x), train=True, generator=gen)
    loss = dice_spvpa_loss(logits, atts, T(y))
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            model.state_dict(), gen.get_state(), model)


def test_remat_is_exact_with_dropout(monkeypatch):
    """--remat recomputes levels 0-1 (down_i, downsample_i, upsample_i,
    up_i) in the backward, with the forward's dropout masks: the loss,
    every gradient, the BatchNorm statistics and the generator's state
    after the step equal those without remat, bit for bit. Level 2 is not
    recomputed; at eval nothing is."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 8, 16, 32, 1)).astype(np.float32)
    y = (rng.random((1, 8, 16, 32, 1)) > 0.8).astype(np.float32)
    runs = {}
    for remat in (False, True):
        calls = {}
        _counting(monkeypatch, train_conv, "conv333_train", calls)
        runs[remat] = _remat_step(remat, x, y, calls)
        runs[remat] += (calls,)
        monkeypatch.undo()
    (l0, g0, s0, r0, _, c0), (l1, g1, s1, r1, model, c1) = (runs[False],
                                                            runs[True])
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert torch.equal(r0, r1)
    assert c0 == {"down_0": 1, "upsample_1": 1, "up_1": 1, "down_2": 1,
                  "conv333_train": 18}
    # level 1's (3,3,3) convs ran again in the recompute: down_1's two
    # units and up_1's unit0 on the pair's two halves
    assert c1 == {"down_0": 2, "upsample_1": 2, "up_1": 2, "down_2": 1,
                  "conv333_train": 18 + 4}
    # at eval each block runs once (up_1 not at all: l2_block takes upatt_1
    # and up_1 as one block)
    before = dict(c1)
    with torch.no_grad():
        model(T(x))
    assert {k: c1[k] - before[k] for k in c1} == {
        "down_0": 1, "upsample_1": 1, "up_1": 0, "down_2": 1,
        "conv333_train": 0}
