"""The training CLI's slice of the port against the JAX package, on the CPU:
`vs_seg_tpu_torch.cli.train.main` held to `VS_train.main`, the debug image
grid and the two training figures, `--profile_steps`, resume from either
checkpoint kind, and the CLI's device rule.

The parity run: one synthetic root holding the cases of
params/split_debug.csv (48x48x16, the port's generate_dataset), run from a
working directory that holds a copy of that CSV, `--debug --compute_dtype
float32 --resume`, both CLIs' config_from_args wrapped to the SMALL widths
of tests/test_torch_train.py with dropout 0, a 32x32x8 crop, 4 epochs,
validation every 2 and the learning rate halved every 2. Both sides start
from one JAX `Trainer.init_state()` written as a JAX msgpack
`last_epoch_model.ckpt` at epoch 0, then each resumes from its own
`last_epoch_model.ckpt` for 2 more epochs. A recording fake of
tensorboardX.SummaryWriter stands in on both sides.

Tolerances: epoch losses and the TensorBoard loss scalars LOSS_TOL = 1e-5
relative (float32; only the order of the sums in some hundred chained
convs and reductions differs, over 8 Adam steps a leg); the validation
Dice values and the best metric DICE_TOL = 1e-5 absolute (a hard Dice of
the argmax: a voxel whose two logits sit within rounding of a tie may
flip, which moves these Dice values by ~1e-6 each); the
best epoch, the debug grid, the transform-check PNG and the set of files
written are equal.
"""

import dataclasses
import logging
import os
import shutil
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

import VS_train
from tests.test_model import SMALL
from vs_seg_tpu.core import observability as jobs
from vs_seg_tpu.eval import figures as jfigures
from vs_seg_tpu.models import build_model as jbuild_model
from vs_seg_tpu.train import trainer as jtrainer
from vs_seg_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from vs_seg_tpu_torch.cli import train as ttrain
from vs_seg_tpu_torch.compat import jax_ckpt
from vs_seg_tpu_torch.core import observability as tobs
from vs_seg_tpu_torch.core.config import Config
from vs_seg_tpu_torch.data import synthetic as tsynthetic
from vs_seg_tpu_torch.eval import figures as tfigures
from vs_seg_tpu_torch.models import build_model
from vs_seg_tpu_torch.train import trainer as ttrainer
from vs_seg_tpu_torch.train.checkpoint import checkpoint_kind, load_checkpoint

REPO = Path(__file__).resolve().parents[1]
SHAPE = (48, 48, 16)
CROP = (32, 32, 8)
LOSS_TOL = 1e-5
DICE_TOL = 1e-5
ARGV = ["--debug", "--compute_dtype", "float32", "--resume"]
FILES = ["figures/check_validation_image_and_label.png",
         "figures/epoch_average_loss_and_val_mean_dice.png",
         "logs/training_log.txt", "model/best_metric_model.ckpt",
         "model/last_epoch_model.ckpt"]


def shrink(cfg, num_epochs):
    """The test's configuration on either package's Config. The debug
    overrides of __post_init__ are set after the replace, which re-runs
    them."""
    cfg = dataclasses.replace(cfg, dropout=0.0, **SMALL)
    cfg.pad_crop_shape = CROP
    cfg.num_epochs = num_epochs
    cfg.val_interval = 2
    cfg.epochs_with_const_lr = 2
    return cfg


class RecordingWriter:
    """tensorboardX.SummaryWriter's calls that the trainers make."""

    made = []

    def __init__(self, *args, **kwargs):
        self.calls = []
        RecordingWriter.made.append(self)

    def add_scalars(self, tag, values, step):
        self.calls.append(("scalars", tag, {k: float(v) for k, v in
                                            values.items()}, int(step)))

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, float(value), int(step)))

    def add_image(self, tag, image, step):
        self.calls.append(("image", tag, np.array(image), int(step)))

    def close(self):
        pass


def _files(folder):
    return sorted(str(p.relative_to(folder)) for p in Path(folder).rglob("*")
                  if p.is_file())


def _write_jax_start(cfg, path):
    """JAX's Trainer.init_state() as a JAX last_epoch_model.ckpt at epoch 0
    (JAX's _save stores epoch + 1)."""
    jt = jtrainer.Trainer(cfg, jbuild_model(cfg))
    s = jt.init_state()
    jt._save(s["params"], s["batch_stats"], s["opt_state"],
             jtrainer.wrap_rng_data(s["rng"]), -1, -1.0, -1,
             "last_epoch_model.ckpt")
    shutil.copy(os.path.join(cfg.model_path, "last_epoch_model.ckpt"), path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{side: {"legs": [(losses, dice, writer calls), ...], "files": ...,
    "ckpt": ...}} for side "jax" (VS_train.main) and "torch"
    (cli.train.main), each leg run in turn on the same root."""
    work = tmp_path_factory.mktemp("train_cli")
    (work / "params").mkdir()
    shutil.copy(REPO / "params" / "split_debug.csv", work / "params")
    root = work / "data"
    tsynthetic.generate_dataset(str(root), n_train=2, n_val=2, n_test=2,
                                shape=SHAPE, seed=0)
    start = work / "start.ckpt"
    sides = {"jax": (VS_train, jfigures, ["--data_root", str(root)]),
             "torch": (ttrain, tfigures, ["--data_root", str(root),
                                          "--device", "cpu"])}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        fake = types.ModuleType("tensorboardX")
        fake.SummaryWriter = RecordingWriter
        mp.setitem(sys.modules, "tensorboardX", fake)
        for side, (cli, figs, extra) in sides.items():
            real_cfg = cli.config_from_args
            real_curves = figs.save_loss_and_dice_curves
            curves = []

            def record(losses, dice, *args, _real=real_curves, _out=curves):
                _out.append((list(losses), list(dice)))
                _real(losses, dice, *args)

            mp.setattr(figs, "save_loss_and_dice_curves", record)
            legs = []
            for epochs in (4, 6):
                mp.setattr(cli, "config_from_args",
                           lambda a, _r=real_cfg, _e=epochs: shrink(_r(a), _e))
                cfg = cli.config_from_args(_parse(cli, ARGV + extra))
                if epochs == 4:
                    if not start.exists():
                        _write_jax_start(shrink(_jparse(ARGV + [
                            "--data_root", str(root)]), 4), start)
                    os.makedirs(cfg.model_path, exist_ok=True)
                    shutil.copy(start, Path(cfg.model_path)
                                / "last_epoch_model.ckpt")
                RecordingWriter.made = []
                cli.main(ARGV + extra)
                (writer,) = RecordingWriter.made
                legs.append(curves[-1] + (writer.calls,))
                if epochs == 4:
                    files = _files(cfg.results_folder_path)
                    png = (Path(cfg.figures_path)
                           / "check_validation_image_and_label.png"
                           ).read_bytes()
                    ckpt = _ckpt_scalars(Path(cfg.model_path)
                                         / "last_epoch_model.ckpt")
            os.rename(cfg.results_folder_path, root / "results" / side)
            out[side] = {"legs": legs, "files": files, "png": png,
                         "ckpt": ckpt}
    return out


def _parse(cli, argv):
    import argparse
    parser = argparse.ArgumentParser()
    cli.add_reference_cli_flags(parser)
    return parser.parse_args(argv)


def _jparse(argv):
    from vs_seg_tpu.core.config import parse_cli
    return parse_cli(argv)


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ckpt_scalars(path):
    """(epoch, best_metric, best_metric_epoch) of either checkpoint kind."""
    raw = (jax_ckpt.load_jax_checkpoint(str(path))
           if checkpoint_kind(str(path)) == "jax"
           else load_checkpoint(str(path)))
    return (int(np.asarray(raw["epoch"])), float(np.asarray(
        raw["best_metric"])), int(np.asarray(raw["best_metric_epoch"])))


@pytest.mark.parametrize("kind", ["torch", "jax", "neither"])
def test_checkpoint_kind_by_content(tmp_path, kind):
    """The kind comes from the file's first bytes, never its name: a
    torch.save archive, a JAX package checkpoint (flax msgpack), or a
    ValueError."""
    path = str(tmp_path / "model.pth")
    if kind == "torch":
        torch.save({"epoch": 0}, path)
    elif kind == "jax":
        jsave_checkpoint(path, {"epoch": np.int32(0)})
    else:
        Path(path).write_bytes(b"\x00\x01\x02\x03 not a checkpoint")
        with pytest.raises(ValueError, match="neither"):
            checkpoint_kind(path)
        return
    assert checkpoint_kind(path) == kind


def _rel_close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.all(np.abs(got - ref) <= tol * np.abs(ref)), (got, ref)


@pytest.mark.parametrize("leg", [0, 1])
def test_train_cli_epoch_losses_match_jax(runs, leg):
    """Leg 0: 4 epochs from the JAX-initialised checkpoint; leg 1: 2 more
    epochs, each side from its own last_epoch_model.ckpt."""
    t, j = runs["torch"]["legs"][leg][0], runs["jax"]["legs"][leg][0]
    assert len(t) == len(j) == (4, 2)[leg]
    assert np.isfinite(t).all()
    _rel_close(t, j, LOSS_TOL)


@pytest.mark.parametrize("leg", [0, 1])
def test_train_cli_validation_dice_matches_jax(runs, leg):
    t, j = runs["torch"]["legs"][leg][1], runs["jax"]["legs"][leg][1]
    assert len(t) == len(j) == (2, 1)[leg]
    np.testing.assert_allclose(t, j, rtol=0, atol=DICE_TOL)


def test_train_cli_best_epoch_and_checkpoint_match_jax(runs):
    """The last checkpoint of leg 0: epoch, best metric and best epoch."""
    (te, tm, tb), (je, jm, jb) = runs["torch"]["ckpt"], runs["jax"]["ckpt"]
    assert (te, tb) == (je, jb) == (4, jb) and jb in (2, 4)
    assert abs(tm - jm) <= DICE_TOL


@pytest.mark.parametrize("leg", [0, 1])
def test_train_cli_tensorboard_scalars_match_jax(runs, leg):
    tcalls = [c for c in runs["torch"]["legs"][leg][2] if c[0] != "image"]
    jcalls = [c for c in runs["jax"]["legs"][leg][2] if c[0] != "image"]
    assert [c[:2] + c[3:] for c in tcalls] == [c[:2] + c[3:] for c in jcalls]
    assert len(tcalls) == 2 * (2, 1)[leg]
    for tc, jc in zip(tcalls, jcalls):
        if tc[0] == "scalars":
            assert tc[2].keys() == jc[2].keys() == {"train", "val"}
            for k in ("train", "val"):
                _rel_close(tc[2][k], jc[2][k], LOSS_TOL)
        else:
            assert abs(tc[2] - jc[2]) <= DICE_TOL


def test_train_cli_debug_image_grid_matches_jax(runs):
    """The debug grid walks the training loader once on both sides (so the
    epochs after it draw the same crops): equal arrays."""
    (tc,) = [c for c in runs["torch"]["legs"][0][2] if c[0] == "image"]
    (jc,) = [c for c in runs["jax"]["legs"][0][2] if c[0] == "image"]
    assert tc[1] == jc[1] == "images" and tc[3] == jc[3] == 0
    assert tc[2].shape[0] == 1 and tc[2].dtype == np.float32
    np.testing.assert_array_equal(tc[2], jc[2])


def test_train_cli_writes_the_same_files_as_jax(runs):
    assert runs["torch"]["files"] == runs["jax"]["files"] == FILES
    assert runs["torch"]["png"] == runs["jax"]["png"]


# ---- the pieces ----------------------------------------------------------

def test_make_image_grid_matches_jax():
    rng = np.random.default_rng(3)
    imgs = [rng.normal(size=(8, 6)).astype(np.float32) for _ in range(5)]
    imgs += [np.zeros((7, 6), np.float32), rng.random((8, 5))]
    for kw in ({}, {"ncols": 2, "pad": 1}, {"normalize": False}):
        np.testing.assert_array_equal(tobs.make_image_grid(imgs, **kw),
                                      jobs.make_image_grid(imgs, **kw))
    np.testing.assert_array_equal(tobs.make_image_grid([]),
                                  jobs.make_image_grid([]))


def test_training_figures_match_jax(tmp_path):
    """Both figures, written by each package from the same inputs: the
    same file names and bytes."""
    rng = np.random.default_rng(4)
    image = rng.normal(size=(16, 12, 6)).astype(np.float32)
    label = (rng.random((16, 12, 6)) > 0.8).astype(np.float32)
    losses, dice = [1.5, 1.2, 1.1, 0.9], [0.2, 0.4]
    for pkg in (tfigures, jfigures):
        d = tmp_path / pkg.__name__.split(".")[0]
        d.mkdir()
        pkg.save_transform_check(image, label, str(d))
        pkg.save_loss_and_dice_curves(losses, dice, 2, str(d))
    for name in ("check_validation_image_and_label.png",
                 "epoch_average_loss_and_val_mean_dice.png"):
        assert ((tmp_path / "vs_seg_tpu_torch" / name).read_bytes()
                == (tmp_path / "vs_seg_tpu" / name).read_bytes())


def test_start_trace_writes_a_trace(tmp_path):
    """start_trace traces until stop() and writes one Chrome trace into
    the directory (CPU activity here)."""
    prof = tobs.start_trace(str(tmp_path / "on"), device="cpu")
    torch.ones(4).sum()
    prof.stop()
    assert len(list((tmp_path / "on").glob("*.pt.trace.json"))) == 1


def _small_cfg(tmp_path, **kw):
    return shrink(Config(data_root=str(tmp_path), results_folder_name="p",
                         compute_dtype="float32", **kw), 1)


class _Loader(list):
    """A list of host batches that logs each fetch into `events`."""

    def __init__(self, batches, events):
        super().__init__(batches)
        self.events = events

    def __iter__(self):
        for i, b in enumerate(list.__iter__(self)):
            self.events.append(f"b{i}")
            yield b


@pytest.mark.parametrize("steps,expect", [
    (4, ["b0", "b1", "start", "b2", "stop", "b3"]),
    (2, ["b0", "b1", "start", "stop"]),          # epoch shorter than 1 + N
])
def test_profile_steps_window(tmp_path, monkeypatch, steps, expect):
    """--profile_steps 2 starts before the first epoch's second step and
    stops after two steps, or at the epoch's end when that comes first
    (vs_seg_tpu/train/trainer.py:268-309)."""
    cfg = _small_cfg(tmp_path, profile_steps=2)
    events = []

    class Prof:
        def stop(self):
            events.append("stop")

    def fake_start(log_dir, device):
        assert log_dir == os.path.join(cfg.results_folder_path, "profile")
        events.append("start")
        return Prof()

    monkeypatch.setattr(ttrainer, "start_trace", fake_start)
    rng = np.random.default_rng(5)
    batches = [{"image": rng.normal(size=(1, 1, 32, 32, 8)).astype(
        np.float32), "label": (rng.random((1, 1, 32, 32, 8)) > 0.8).astype(
        np.float32)} for _ in range(steps)]
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tr = ttrainer.Trainer(cfg, model, "cpu")
    tr.fit(tr.init_state(), _Loader(batches, events), [])
    assert events == expect


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    work = tmp_path_factory.mktemp("train_cli_small")
    (work / "params").mkdir()
    shutil.copy(REPO / "params" / "split_debug.csv", work / "params")
    tsynthetic.generate_dataset(str(work / "data"), n_train=2, n_val=2,
                                n_test=2, shape=SHAPE, seed=1)
    return work


def _small_main(monkeypatch, work, argv, epochs=1):
    monkeypatch.chdir(work)
    real = ttrain.config_from_args
    monkeypatch.setattr(ttrain, "config_from_args",
                        lambda a: shrink(real(a), epochs))
    return ttrain.main(["--debug", "--data_root", str(work / "data"),
                        "--compute_dtype", "float32"] + argv,
                       make_figures=False)


def test_train_cli_profile_steps_writes_a_trace(small_root, monkeypatch):
    """--profile_steps 2 on the CPU: a torch.profiler trace under
    <results>/profile/ (the epoch of 2 steps ends the window early)."""
    _small_main(monkeypatch, small_root, ["--device", "cpu",
                                          "--profile_steps", "2"])
    traces = list((small_root / "data" / "results" / "debug" / "profile"
                   ).glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def _legacy_checkpoint(cfg, path, drop=None):
    """A JAX checkpoint as vs_seg_tpu wrote it before optax.flatten: the
    Adam moments are per-parameter trees. One update of that optimizer from
    seeded gradients makes them nonzero (count 1). `drop`: a parameter whose
    moment leaves are removed, which no conversion can take."""
    variables = jtrainer.init_model(jbuild_model(cfg), 0)
    legacy = optax.inject_hyperparams(lambda learning_rate: optax.chain(
        optax.add_decayed_weights(cfg.weight_decay),
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
        optax.scale(-1.0), optax.scale(learning_rate)))(learning_rate=3e-4)
    params = variables["params"]
    rng = np.random.default_rng(11)
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    opt_state = legacy.init(params)
    _, opt_state = legacy.update(grads, opt_state, params)
    raw_opt = serialization.to_state_dict(opt_state)
    if drop is not None:
        for key in ("mu", "nu"):
            del raw_opt["inner_state"]["1"][key][drop]
    jsave_checkpoint(path, {
        "params": params, "batch_stats": variables["batch_stats"],
        "opt_state": raw_opt,
        "rng": jax.random.key_data(jax.random.key(0, impl="rbg")),
        "epoch": 3, "best_metric": 0.25, "best_metric_epoch": 2})


def _step_batch():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(1, 8, 32, 32, 1)).astype(np.float32)
    y = (rng.random((1, 8, 32, 32, 1)) > 0.8).astype(np.float32)
    return x, y


def test_train_cli_refuses_a_legacy_jax_checkpoint(small_root, monkeypatch,
                                                   tmp_path, caplog):
    """A legacy JAX checkpoint (per-parameter Adam moment trees) is
    migrated, as JAX's Trainer.restore_state migrates it, with its warning:
    each parameter's exp_avg / exp_avg_sq equal the moments JAX restores,
    the count and learning rate carry over, and one step after the resume
    matches JAX's (loss 1e-5 relative, the new moments within 1e-4 (mu)
    and 2e-4 (nu) of their largest). The training CLI resumes from it
    under --resume."""
    cfg = shrink(_jparse(["--debug", "--data_root", str(tmp_path),
                          "--compute_dtype", "float32"]), 1)
    path = str(tmp_path / "legacy.ckpt")
    _legacy_checkpoint(cfg, path)
    jt = jtrainer.Trainer(cfg, jbuild_model(cfg))
    jstate = jt.restore_state(path)
    tcfg = _small_cfg(tmp_path)
    model = build_model(tcfg, device="cpu")
    tr = ttrainer.Trainer(tcfg, model, "cpu", logger=logging.getLogger("l"))
    with caplog.at_level("INFO"):
        state = tr.restore_state(path)
    assert "legacy (unflattened) opt_state" in caplog.text
    assert "conversion failed" not in caplog.text
    assert (state["epoch"], state["best_metric"],
            state["best_metric_epoch"]) == (3, 0.25, 2)

    def moments(opt_state):
        adam = serialization.to_state_dict(opt_state)["inner_state"]["1"]
        unravel = ravel_pytree(jstate["params"])[1]
        return int(adam["count"]), {k: _flat(unravel(adam[k]))
                                    for k in ("mu", "nu")}

    count, ref = moments(jstate["opt_state"])
    assert count == 1
    opt = state["optimizer"]
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == 1.0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), ref["mu"][name])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      ref["nu"][name])
    assert opt.param_groups[0]["lr"] == pytest.approx(3e-4)

    # one step on each side from the migrated state
    x, y = _step_batch()
    jstep = jtrainer.make_train_step(jt.model, jt.optimizer,
                                     supervised_attention=True,
                                     hardness=True)
    *_, jopt, _, jl = jstep(jstate["params"], jstate["batch_stats"],
                            jstate["opt_state"],
                            jtrainer.wrap_rng_data(jstate["rng"]),
                            jnp.asarray(x), jnp.asarray(y))
    tstep = ttrainer.make_train_step(model, opt, supervised_attention=True,
                                     hardness=True)
    tl = tstep(torch.from_numpy(x), torch.from_numpy(y), state["generator"])
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    count, ref = moments(jopt)
    assert count == 2
    for key, slot, tol in (("mu", "exp_avg", 1e-4),
                           ("nu", "exp_avg_sq", 2e-4)):
        scale = max(np.abs(v).max() for v in ref[key].values())
        for name, p in model.named_parameters():
            diff = np.abs(opt.state[p][slot].numpy() - ref[key][name]).max()
            assert diff <= tol * scale, (key, name, diff, scale)

    # the CLI: --resume reads it from the model folder
    ccfg = shrink(_jparse(["--debug", "--data_root",
                           str(small_root / "data")]), 1)
    _legacy_checkpoint(ccfg, os.path.join(ccfg.model_path,
                                          "last_epoch_model.ckpt"))
    cfg_epochs = 4          # the checkpoint is at epoch 3: one more epoch
    st, losses, _ = _small_main(monkeypatch, small_root,
                                ["--device", "cpu", "--resume"],
                                epochs=cfg_epochs)
    assert st["epoch"] == cfg_epochs and len(losses) == 1
    assert np.isfinite(losses).all()


def test_legacy_jax_checkpoint_that_cannot_convert_resets_adam(
        tmp_path, caplog):
    """Where the legacy moments do not fit the model (a parameter's leaves
    missing), both packages warn that the conversion failed and start the
    optimizer afresh on the checkpoint's weights."""
    cfg = shrink(_jparse(["--debug", "--data_root", str(tmp_path)]), 1)
    path = str(tmp_path / "legacy.ckpt")
    _legacy_checkpoint(cfg, path, drop="bottom")
    with caplog.at_level("WARNING"):
        jstate = jtrainer.Trainer(cfg, jbuild_model(cfg)).restore_state(path)
    assert caplog.text.count("conversion failed") == 1
    adam = serialization.to_state_dict(jstate["opt_state"])["inner_state"]
    assert int(adam["1"]["count"]) == 0
    caplog.clear()
    tcfg = _small_cfg(tmp_path)
    model = build_model(tcfg, device="cpu")
    tr = ttrainer.Trainer(tcfg, model, "cpu", logger=logging.getLogger("l"))
    with caplog.at_level("WARNING"):
        state = tr.restore_state(path)
    assert "legacy (unflattened) opt_state" in caplog.text
    assert "legacy opt_state conversion failed" in caplog.text
    assert "Adam moments reset" in caplog.text
    opt = state["optimizer"]
    assert not opt.state and opt.param_groups[0]["lr"] == pytest.approx(
        tcfg.initial_learning_rate)
    assert {id(p) for p in opt.param_groups[0]["params"]} == {
        id(p) for p in model.parameters()}
    assert state["epoch"] == 3
    raw = jax_ckpt.load_jax_checkpoint(path)
    np.testing.assert_array_equal(
        model.state_dict()["bottom.unit0.conv.kernel"].numpy(),
        raw["params"]["bottom"]["unit0"]["conv"]["kernel"])


def test_train_cli_resumes_a_jax_checkpoint_with_a_seeded_generator(
        small_root, monkeypatch, tmp_path, caplog):
    """A flattened JAX checkpoint: weights, Adam moments and epoch carried
    in; the dropout generator seeded from cfg.seed, and the log says so."""
    cfg = shrink(_jparse(["--debug", "--data_root", str(tmp_path)]), 1)
    _write_jax_start(cfg, tmp_path / "start.ckpt")
    tcfg = _small_cfg(tmp_path, seed=7)
    model = build_model(tcfg, device="cpu")
    tr = ttrainer.Trainer(tcfg, model, "cpu")
    with caplog.at_level("INFO"):
        state = tr.restore_state(str(tmp_path / "start.ckpt"))
    assert "seeded from seed = 7" in caplog.text
    assert state["epoch"] == 0 and state["best_metric_epoch"] == -1
    assert torch.equal(state["generator"].get_state(),
                       torch.Generator().manual_seed(7).get_state())
    raw = jax_ckpt.load_jax_checkpoint(str(tmp_path / "start.ckpt"))
    np.testing.assert_array_equal(
        model.state_dict()["down_0.unit0.conv.kernel"].numpy(),
        raw["params"]["down_0"]["unit0"]["conv"]["kernel"])
    with open(tmp_path / "junk.ckpt", "wb") as f:
        f.write(b"junk")
    with pytest.raises(ValueError, match="neither"):
        tr.restore_state(str(tmp_path / "junk.ckpt"))


def test_train_cli_defaults_to_the_card(small_root, monkeypatch):
    """Without --device the training CLI runs on cuda; with no card it
    raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _small_main(monkeypatch, small_root, [])
