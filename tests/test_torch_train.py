"""The port's training path against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages; JAX's
Pallas kernels run in interpret mode, as tests/test_pallas_train.py runs them,
and the port's wrappers run their plain twins (CPU tensors). Tolerances are
relative to max|ref| unless stated otherwise:
  - float32, one conv or reduction: 1e-5 (only the order of the sums differs);
  - bf16 values that both sides round once to bf16: 2^-7 (one bf16 ulp of
    2^-8 relative, twice for rounding at different points);
  - float32 gradients through the SMALL model: 1e-4 (the order of the sums in
    some hundred chained convs and reductions);
  - Adam steps: see test_train_steps_and_train_state_match_jax.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

from tests.test_model import SMALL
from vs_seg_tpu.core.config import Config as JConfig
from vs_seg_tpu.eval.metrics import dice_score as jdice_score
from vs_seg_tpu.losses.dice import dice_spvpa_loss as jloss
from vs_seg_tpu.models import UNet2d5_spvPA as JUNet
from vs_seg_tpu.nn import layers as jlayers
from vs_seg_tpu.ops.experimental import pallas_train
from vs_seg_tpu.train import trainer as jtrainer
from vs_seg_tpu_torch.compat import load_jax_train_state, load_jax_variables
from vs_seg_tpu_torch.core.config import Config
from vs_seg_tpu_torch.eval.metrics import dice_score
from vs_seg_tpu_torch.losses.dice import dice_spvpa_loss
from vs_seg_tpu_torch.models import UNet2d5_spvPA as TUNet
from vs_seg_tpu_torch.nn import layers as tlayers
from vs_seg_tpu_torch.ops import train_conv
from vs_seg_tpu_torch.ops.conv333_dw import conv333_dw, conv333_dw_plain
from vs_seg_tpu_torch.train import trainer as ttrainer

T = torch.from_numpy
BF16_TOL = 2.0 ** -7


def _rel(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ---- (a) conv333_dw ------------------------------------------------------

@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16), (3, 5)])
def test_conv333_dw_plain_matches_pallas_dw(cin, cout):
    """conv333_dw_plain == JAX conv333_dw Gram blocks + dw/db_extract
    (interpret mode), float32: 1e-5."""
    x = _np((1, 3, 16, 32, cin), 0)
    dy = _np((1, 3, 16, 32, cout), 1)
    gm, ge, db = pallas_train.conv333_dw(jnp.asarray(x), jnp.asarray(dy),
                                         interpret=True)
    ref_dw = pallas_train.dw_extract(gm, ge, cin, cout)
    ref_db = pallas_train.db_extract(db, cout)
    got_dw, got_db = conv333_dw(T(x), T(dy))       # CPU: the plain twin
    assert _rel(got_dw, ref_dw) <= 1e-5
    assert _rel(got_db, ref_db) <= 1e-5


def test_conv333_dw_plain_is_the_conv_weight_gradient():
    """At a shape the TPU kernel refuses (odd H and W, Cin > 64): the same
    as autograd's weight gradient of the plain conv, float32: 1e-5."""
    x = _np((2, 3, 5, 7, 70), 2)
    dy = _np((2, 3, 5, 7, 3), 3)
    w = torch.zeros((3, 3, 3, 70, 3), requires_grad=True)
    b = torch.zeros((3,), requires_grad=True)
    tlayers.conv3d(T(x), w, b, (1, 1, 1), (1, 1, 1)).backward(T(dy))
    dw, db = conv333_dw_plain(T(x), T(dy))
    assert _rel(dw, w.grad) <= 1e-5 and _rel(db, b.grad) <= 1e-5


# ---- (b) Conv333Train ----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_conv333_train_matches_pallas_train(dtype, bias):
    """Value and (dx, dw, db) of the port's Function against JAX
    conv333_train(interpret=True) with the same dy. float32: 1e-5. bf16: y
    and dx are bf16 outputs (BF16_TOL); dw and db are f32 sums of the same
    bf16 products on both sides (1e-5)."""
    cin, cout = 12, 20
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    x = _np((1, 4, 8, 32, cin), 4)
    w = _np((3, 3, 3, cin, cout), 5, 0.2)
    b = _np((cout,), 6) if bias else np.zeros((cout,), np.float32)
    dy = _np((1, 4, 8, 32, cout), 7)

    jx = jnp.asarray(x, jdt)
    y_ref, vjp = jax.vjp(lambda x_, w_, b_: pallas_train.conv333_train(
        x_, w_, b_, dtype=jdt, interpret=True), jx, jnp.asarray(w),
        jnp.asarray(b))
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(dy, jdt))

    tx = T(x).to(tdt).requires_grad_()
    tw = T(w).requires_grad_()
    tb = T(b).requires_grad_() if bias else None
    y = train_conv.conv333_train(tx, tw, tb)
    y.backward(T(dy).to(tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt
    assert tw.grad.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    assert _rel(y, y_ref) <= tol
    assert _rel(tx.grad, dx_ref) <= tol
    assert _rel(tw.grad, dw_ref) <= 1e-5
    if bias:
        assert _rel(tb.grad, db_ref) <= 1e-5


def test_conv333_train_plain_route_is_plain_autograd():
    """use_kernels=False is autograd through the library conv: the same
    value, and gradients within float32 summation order (1e-5)."""
    x = T(_np((1, 3, 6, 10, 5), 8)).requires_grad_()
    w = T(_np((3, 3, 3, 5, 4), 9, 0.2)).requires_grad_()
    b = T(_np((4,), 10)).requires_grad_()
    dy = T(_np((1, 3, 6, 10, 4), 11))
    grads = []
    for use_kernels in (True, False):
        y = train_conv.conv333_train(x, w, b, use_kernels)
        grads.append((y.detach(),) + torch.autograd.grad(y, (x, w, b), dy))
    assert torch.equal(grads[0][0], grads[1][0])
    for got, ref in zip(grads[0][1:], grads[1][1:]):
        assert _rel(got, ref.numpy()) <= 1e-5


# ---- (c) BatchNorm at train --------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax(dtype):
    """Output and the updated running statistics (float32 stats: 1e-5; the
    bf16 output is rounded once on each side: BF16_TOL)."""
    x = _np((2, 3, 6, 8, 5), 12, 2.0) + 0.5
    jdt = jnp.dtype(dtype)
    jm = jlayers.BatchNorm()
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x, jdt), True)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(13)
    v = {"params": {"scale": rng.uniform(.5, 1.5, 5).astype(np.float32),
                    "bias": rng.normal(size=5).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=5).astype(np.float32),
                         "var": rng.uniform(.5, 2, 5).astype(np.float32)}}
    ref, mut = jm.apply(v, jnp.asarray(x, jdt), True,
                        mutable=["batch_stats"])
    tm = tlayers.BatchNorm(5, device="cpu")
    load_jax_variables(tm, v)
    out = tm(T(x).to(getattr(torch, dtype)))
    assert _rel(out, ref) <= (1e-5 if dtype == "float32" else BF16_TOL)
    assert _rel(tm.mean, mut["batch_stats"]["mean"]) <= 1e-5
    assert _rel(tm.var, mut["batch_stats"]["var"]) <= 1e-5


def test_dropout_train_keeps_inverted_mean_and_needs_a_generator():
    """The keep rate is JAX's quantised 1 - rate and kept values are x/keep;
    one seed gives one mask; eval is the identity."""
    d = tlayers.Dropout(0.1)
    x = torch.ones(200_000)
    keep = round(0.9 * 65536) / 65536
    y = d(x, True, torch.Generator().manual_seed(3))
    kept = y != 0
    assert torch.all(y[kept] == torch.tensor(1 / keep))
    assert abs(float(kept.float().mean()) - keep) < 4e-3   # ~6 sigma
    assert torch.equal(y, d(x, True, torch.Generator().manual_seed(3)))
    assert d(x) is x
    with pytest.raises(ValueError, match="Generator"):
        d(x, True)


# ---- (d) losses and metric -----------------------------------------------

def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(2, 4, 8, 8, 2)).astype(np.float32)
    atts = tuple(rng.uniform(0.05, 0.95, size=(2, *s, 1)).astype(np.float32)
                 for s in ((1, 2, 2), (2, 4, 4), (4, 8, 8)))
    label = (rng.random((2, 4, 8, 8, 1)) > 0.7).astype(np.float32)
    return logits, atts, label


@pytest.mark.parametrize("hardness", [True, False])
@pytest.mark.parametrize("supervised", [True, False])
def test_dice_spvpa_loss_value_and_grads_match_jax(hardness, supervised):
    """Value and gradient wrt the logits and every attention map, float32:
    1e-5. The hardness weight is not detached on either side."""
    logits, atts, label = _loss_inputs(14)
    kw = dict(supervised_attention=supervised, hardness_weighting=hardness)
    ref, (g_lg, g_at) = jax.value_and_grad(
        lambda lg, at: jloss(lg, at, jnp.asarray(label), **kw),
        argnums=(0, 1))(jnp.asarray(logits), tuple(map(jnp.asarray, atts)))
    tl = T(logits).requires_grad_()
    ta = tuple(T(a).requires_grad_() for a in atts)
    loss = dice_spvpa_loss(tl, ta, T(label), **kw)
    loss.backward()
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    assert _rel(tl.grad, g_lg) <= 1e-5
    for a, g in zip(ta, g_at):
        if supervised:
            assert _rel(a.grad, g) <= 1e-5
        else:
            assert a.grad is None and not np.asarray(g).any()


def test_dice_score_matches_jax():
    logits, _, label = _loss_inputs(15)
    ref = jdice_score(jnp.asarray(logits), jnp.asarray(label))
    got = dice_score(T(logits), T(label))
    assert abs(float(got) - float(ref)) <= 1e-6


def test_config_defaults_match_jax():
    """Every field the port's Config shares with JAX keeps the JAX default
    and debug override (`device` and `routes` are the port's own, standing
    for what JAX selects through its environment); the derived paths are
    the same."""
    for debug in (False, True):
        j, t = JConfig(debug=debug), Config(debug=debug)
        for f in dataclasses.fields(Config):
            if f.name in ("device", "routes"):
                continue
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        for path in ("model_path", "logs_path", "figures_path"):
            assert getattr(t, path) == getattr(j, path)


def test_to_device_batch_matches_jax():
    rng = np.random.default_rng(16)
    batch = {"image": rng.normal(size=(2, 1, 8, 6, 4)).astype(np.float32),
             "label": (rng.random((2, 1, 8, 6, 4)) > 0.5).astype(np.float32)}
    ji, jl = jtrainer.to_device_batch(batch, None)
    ti, tl = ttrainer.to_device_batch(batch, "cpu")
    assert tl.dtype == torch.uint8 and str(jl.dtype) == "uint8"
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


# ---- (e) model-level gradient --------------------------------------------

def _small_pair(seed=0):
    jm = JUNet(out_channels=2, num_res_units=2, dropout=0.0,
               attention_module=True, dtype=jnp.float32, **SMALL)
    v = jtrainer.init_model(jm, seed)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    tm = TUNet(out_channels=2, dtype=torch.float32, dropout=0.0, device="cpu",
               **SMALL)
    load_jax_variables(tm, v)
    return jm, tm, v


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 8, 16, 32, 1)).astype(np.float32)
    y = (rng.random((1, 8, 16, 32, 1)) > 0.8).astype(np.float32)
    return x, y


SMALL_TRAIN_SITES = 18   # levels 1-2 x 7 (3,3,3) convs + bottom 4


def test_model_loss_gradient_matches_jax_train_conv(monkeypatch):
    """dice_spvpa_loss gradient of the train-mode SMALL model, float32,
    dropout 0, JAX with its Pallas train conv forced on (interpret mode, as
    test_pallas_train.py does) against the port's train-conv route (plain
    twins on the CPU). Loss 1e-5; each parameter's gradient 1e-4 of the
    largest gradient of the model (conv biases in front of a train-mode
    BatchNorm have a gradient that is zero in exact arithmetic, so only an
    absolute bound on their rounding noise is meaningful)."""
    jm, tm, v = _small_pair()
    x, y = _batch(17)
    monkeypatch.setattr(pallas_train, "FORCE_INTERPRET", True)

    def loss_fn(params):
        (lg, at), _ = jm.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        return jloss(lg, at, jnp.asarray(y))

    ref, ref_g = jax.value_and_grad(loss_fn)(v["params"])
    calls = []
    real = train_conv.conv333_train

    def counting(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(train_conv, "conv333_train", counting)
    lg, at = tm(T(x), train=True)
    loss = dice_spvpa_loss(lg, at, T(y))
    loss.backward()
    assert len(calls) == SMALL_TRAIN_SITES
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))
    flat = {".".join(k.key for k in path): np.asarray(g) for path, g in
            jax.tree_util.tree_flatten_with_path(ref_g)[0]}
    scale = max(np.abs(g).max() for g in flat.values())
    for name, p in tm.named_parameters():
        err = np.abs(p.grad.numpy() - flat[name]).max()
        assert err <= 1e-4 * scale, (name, err, scale)


def test_model_train_forward_counts_and_updates_bn():
    """The train forward runs every (3,3,3) stride-1 conv through the train
    route, takes no eval kernel site, and moves the running statistics."""
    _, tm, _ = _small_pair()
    x, _ = _batch(18)
    before = tm.down_1.unit0.norm.mean.clone()
    calls = []
    real = train_conv.conv333_train
    try:
        train_conv.conv333_train = lambda *a, **k: (calls.append(1),
                                                    real(*a, **k))[1]
        with torch.no_grad():
            tm(T(x), train=True)
            n_train = len(calls)
            tm(T(x))                        # eval: no train route
    finally:
        train_conv.conv333_train = real
    assert n_train == len(calls) == SMALL_TRAIN_SITES
    assert not torch.equal(before, tm.down_1.unit0.norm.mean)


# ---- (f) train steps and the carried state -------------------------------

LR, WD = 1e-3, 1e-7


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def test_train_steps_and_train_state_match_jax():
    """Three Adam steps (BN statistics included) of JAX make_train_step and
    the port's make_train_step from the same converted state, then the JAX
    state after step 2 carried over with load_jax_train_state and one more
    step on each side. Float32, dropout 0.

    Tolerances: losses 1e-5 relative at every step, on both port models.
    The state is compared after each step taken from a state equal to
    JAX's (step 1, and the carried step 3). The BN running statistics come
    from the forward on equal parameters: 1e-5 relative. Adam moves each
    element by lr * m_hat / (sqrt(v_hat) + eps), so a gradient error d
    moves it by at most about lr * 2d / (sqrt(v_hat) + eps), and never by
    more than 2 lr: an element whose gradient is at rounding-noise level
    (the conv biases in front of a train-mode BatchNorm, exactly zero in
    exact arithmetic, or a kernel tap whose BatchNorm-projected gradient
    cancels to ~eps) may land anywhere in that range. Each parameter
    element is held to that bound with d = 1e-4 of the model's largest
    sqrt(v_hat) (the gradient tolerance of the model-level test), plus 1e-6
    relative for the rounding of the update. Over several independent steps
    the same normalisation lets the trajectories drift apart element by
    element, so the port's own three-step run is held by its losses."""
    jm, tm, v = _small_pair(1)
    jopt = jtrainer.make_optimizer(LR, WD)
    jstep = jtrainer.make_train_step(jm, jopt, supervised_attention=True,
                                     hardness=True)
    params, stats = v["params"], v["batch_stats"]
    opt_state = jopt.init(params)
    rng = jax.random.key(0)
    topt = ttrainer.make_optimizer(tm.parameters(), LR, WD)
    tstep = ttrainer.make_train_step(tm, topt, supervised_attention=True,
                                     hardness=True)
    batches = [_batch(20 + i) for i in range(3)]
    unravel = ravel_pytree(params)[1]

    def check(model, optimizer):
        sd = model.state_dict()
        for name, ref in _flat(stats).items():
            assert _rel(sd[name], ref) <= 1e-5, name
        adam = serialization.to_state_dict(opt_state)["inner_state"]["1"]
        t = int(adam["count"])
        moments = {k: _flat(unravel(adam[k])) for k in ("mu", "nu")}
        rms = {k: np.sqrt(v / (1 - 0.999 ** t))
               for k, v in moments["nu"].items()}
        d = 1e-4 * max(r.max() for r in rms.values())
        for name, ref in _flat(params).items():
            bound = (1e-6 * np.abs(ref).max()
                     + LR * np.minimum(2.0, 2 * d / (rms[name] + 1e-8)))
            diff = np.abs(sd[name].numpy() - ref)
            assert (diff <= bound).all(), (name, diff.max())
        # the moments themselves, against the model's largest: m is linear
        # in the gradients (1e-4, as above), v quadratic (2e-4)
        for key, slot, tol in (("mu", "exp_avg", 1e-4),
                               ("nu", "exp_avg_sq", 2e-4)):
            scale = max(np.abs(v).max() for v in moments[key].values())
            for name, p in model.named_parameters():
                diff = np.abs(optimizer.state[p][slot].numpy()
                              - moments[key][name]).max()
                assert diff <= tol * scale, (key, name, diff, scale)

    for i, (x, y) in enumerate(batches[:2]):
        params, stats, opt_state, rng, jl = jstep(
            params, stats, opt_state, rng, jnp.asarray(x), jnp.asarray(y))
        tl = tstep(T(x), T(y), None)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        if i == 0:
            check(tm, topt)

    # carry the JAX state after step 2 into a fresh port model + optimizer
    tm2 = TUNet(out_channels=2, dtype=torch.float32, dropout=0.0,
                device="cpu", **SMALL)
    topt2 = ttrainer.make_optimizer(tm2.parameters(), 1.0, WD)
    load_jax_train_state(tm2, topt2, {
        "params": _to_np(params), "batch_stats": _to_np(stats),
        "opt_state": _to_np(serialization.to_state_dict(opt_state))})
    assert topt2.param_groups[0]["lr"] == pytest.approx(LR)
    tstep2 = ttrainer.make_train_step(tm2, topt2, supervised_attention=True,
                                      hardness=True)
    x, y = batches[2]
    params, stats, opt_state, rng, jl = jstep(
        params, stats, opt_state, rng, jnp.asarray(x), jnp.asarray(y))
    for model, step in ((tm2, tstep2), (tm, tstep)):
        tl = step(T(x), T(y), None)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    # the carried state continues from JAX's own step-2 state: one step
    check(tm2, topt2)


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_load_jax_train_state_slices_in_ravel_order():
    """mu/nu are sliced in ravel_pytree order (sorted key paths), so each
    parameter gets its own moments; a wrong length raises."""
    _, tm, v = _small_pair(2)
    flat, unravel = ravel_pytree(v["params"])
    mu = np.arange(flat.size, dtype=np.float32)
    opt = {"count": 0, "hyperparams": {"learning_rate": 0.5},
           "inner_state": {"0": {}, "1": {"count": 7, "mu": mu, "nu": mu * 2},
                           "2": {}, "3": {}}}
    mu_tree = _flat(unravel(jnp.asarray(mu)))
    topt = ttrainer.make_optimizer(tm.parameters(), 1.0, 0.0)
    load_jax_train_state(tm, topt, {"params": v["params"],
                                    "batch_stats": v["batch_stats"],
                                    "opt_state": opt, "epoch": 3})
    for name, p in tm.named_parameters():
        st = topt.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu_tree[name])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      2 * mu_tree[name])
        assert float(st["step"]) == 7.0
    opt["inner_state"]["1"]["mu"] = mu[:-1]
    with pytest.raises(ValueError, match="Adam moments"):
        load_jax_train_state(tm, topt, {"params": v["params"],
                                        "batch_stats": v["batch_stats"],
                                        "opt_state": opt})


# ---- the trainer's loop --------------------------------------------------

def test_trainer_fit_checkpoints_and_resumes(tmp_path):
    """Trainer(cfg, model, device).init_state() -> fit on the SMALL model
    with dropout: finite losses, best and last checkpoints, LR schedule, and
    restore_state brings back weights, Adam state and the generator."""
    cfg = Config(data_root=str(tmp_path), results_folder_name="t",
                 num_epochs=2, val_interval=1, epochs_with_const_lr=1,
                 initial_learning_rate=1e-3, compute_dtype="float32",
                 **{k: SMALL[k] for k in SMALL})
    gen = torch.Generator().manual_seed(0)
    model = TUNet(dtype=torch.float32, device="cpu", generator=gen,
                  **cfg.model_kwargs())
    tr = ttrainer.Trainer(cfg, model, "cpu", logger=logging.getLogger("t"))
    state = tr.init_state()
    rng = np.random.default_rng(21)

    def loader(n):
        return [{"image": rng.normal(size=(1, 1, 16, 16, 8)
                                     ).astype(np.float32),
                 "label": (rng.random((1, 1, 16, 16, 8)) > 0.8
                           ).astype(np.float32)} for _ in range(n)]

    state, losses, metrics = tr.fit(state, loader(2), loader(1))
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert len(metrics) == 2 and state["epoch"] == 2
    assert state["optimizer"].param_groups[0]["lr"] == pytest.approx(5e-4)
    last = tmp_path / "results" / "t" / "model" / "last_epoch_model.ckpt"
    assert last.is_file() and last.with_name("best_metric_model.ckpt"
                                              ).is_file()
    saved = {k: t.clone() for k, t in model.state_dict().items()}
    gstate = state["generator"].get_state()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    back = tr.restore_state(str(last))
    for k, t in model.state_dict().items():
        assert torch.equal(t, saved[k]), k
    assert torch.equal(back["generator"].get_state(), gstate)
    assert back["epoch"] == 2
    assert (back["optimizer"].state_dict()["state"].keys()
            == state["optimizer"].state_dict()["state"].keys())
