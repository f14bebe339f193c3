"""Data-parallel training of the port (vs_seg_tpu_torch/parallel/
distributed.py, BatchNorm's global statistics, the loaders' rows, the
Trainer under DistributedDataParallel) on the CPU over gloo, against one
process on the whole batch and against JAX's mesh-sharded step on the
conftest's 8 virtual devices (tests/test_parallel.py's configuration).

The ranks run in spawned processes (distributed.launch) that import
tests/torch_dp_worker.py and no JAX; a few launches serve every test
(module fixtures). Every launch has a timeout after which its ranks are
killed.
"""

import dataclasses
import logging
import time

import jax
import numpy as np
import pytest
import torch

from tests import torch_dp_worker as W
from tests.test_parallel import CFG
from vs_seg_tpu.core.config import Config as JConfig
from vs_seg_tpu.models import build_model as jbuild_model
from vs_seg_tpu.parallel.distributed import \
    shard_files_for_process as jshard_files
from vs_seg_tpu.parallel.mesh import batch_sharding, make_mesh
from vs_seg_tpu.train.trainer import Trainer as JTrainer
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.core.config import Config
from vs_seg_tpu_torch.data.dataset import DataLoader
from vs_seg_tpu_torch.data.device_pipeline import (DeviceCachedDataset,
                                                   DeviceLoader)
from vs_seg_tpu_torch.models import build_model
from vs_seg_tpu_torch.nn.layers import BatchNorm
from vs_seg_tpu_torch.ops import bnorm_train
from vs_seg_tpu_torch.parallel import distributed
from vs_seg_tpu_torch.train import trainer as ttrainer

LAUNCH_TIMEOUT_S = 120.0
BATCH = 8
LR = 1e-4                         # Config's initial_learning_rate
BF16_TOL = 2.0 ** -7              # test_torch_train.py's bf16 band
PORT_KW = dict(train_batch_size=BATCH, dropout=0.0, **CFG)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _port_state(variables):
    """JAX variables -> the port model's state_dict as numpy."""
    model = build_model(Config(**PORT_KW), device="cpu")
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, variables))
    return W.to_np(model.state_dict())


def _launch(nprocs, jobs, nnodes=1):
    return distributed.launch(W.run, nprocs, jobs, nnodes=nnodes,
                              timeout_s=LAUNCH_TIMEOUT_S)


@pytest.fixture(scope="module")
def ref():
    """The batch, the initial weights, JAX's 8-device mesh step and the
    port's one-process step on the whole batch."""
    rng = np.random.default_rng(0)
    image = rng.normal(size=(BATCH, 8, 16, 16, 1)).astype(np.float32)
    label = (rng.random((BATCH, 8, 16, 16, 1)) > 0.7).astype(np.float32)
    jcfg = JConfig(train_batch_size=BATCH, dropout=0.0, **CFG)
    mesh = make_mesh()
    jt = JTrainer(jcfg, jbuild_model(jcfg), mesh=mesh)
    st = jt.init_state()
    weights = _port_state({"params": st["params"],
                           "batch_stats": st["batch_stats"]})
    sharding = batch_sharding(mesh, 5)
    p, bs, _, _, jloss = jt.train_step(
        st["params"], st["batch_stats"], st["opt_state"], jax.random.key(7),
        jax.device_put(image, sharding), jax.device_put(label, sharding))
    cfg = Config(**PORT_KW)
    tr = ttrainer.Trainer(cfg, W.model_of(cfg, weights), "cpu")
    state = tr.init_state()
    loss = tr.make_step(state)(torch.from_numpy(image),
                               torch.from_numpy(label), state["generator"])
    return {"image": image, "label": label, "weights": weights,
            "jax_loss": float(jloss),
            "jax_state": _port_state({"params": p, "batch_stats": bs}),
            "loss": float(loss),
            "state": W.to_np(state["model"].state_dict()),
            "grads": W.to_np({n: p.grad for n, p in
                              state["model"].named_parameters()})}


def _bn_inputs():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(BATCH, 3, 6, 5, 4)) * 2.0 + 0.5).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    params = {"scale": rng.uniform(.5, 1.5, 4).astype(np.float32),
              "bias": rng.normal(size=4).astype(np.float32),
              "mean": rng.normal(size=4).astype(np.float32),
              "var": rng.uniform(.5, 2, 4).astype(np.float32)}
    return x, w, params


def _bnorm_train_inputs():
    """_bn_inputs with a PReLU slope and the global batch's dropout words."""
    x, w, params = _bn_inputs()
    rng = np.random.default_rng(4)
    words = rng.integers(0, 65536, size=x.shape, dtype=np.int32)
    return x, w, words, dict(params, alpha=np.array([0.2], np.float32))


def _fit_inputs(tmp):
    rng = np.random.default_rng(5)

    def arrays(n):
        return (rng.normal(size=(n, 1, 16, 16, 8)).astype(np.float32),
                (rng.random((n, 1, 16, 16, 8)) > 0.7).astype(np.float32))

    kw = dict(PORT_KW, train_batch_size=2, data_root=str(tmp),
              val_interval=1, epochs_with_const_lr=1,
              initial_learning_rate=1e-3)
    # 5 cases in batches of 2: two sharded steps and a replicated one
    return kw, arrays(5), arrays(2), (1, 2)


def _replicated_batches():
    rng = np.random.default_rng(9)
    return [(rng.normal(size=(n, 8, 16, 16, 1)).astype(np.float32),
             (rng.random((n, 8, 16, 16, 1)) > 0.7).astype(np.float32))
            for n in (3, 2)]


@pytest.fixture(scope="module")
def two(ref, tmp_path_factory):
    """One launch of 2 ranks: BatchNorm, the DP step (and --remat), steps
    on replicated batches, and a fit with its resume."""
    tmp = tmp_path_factory.mktemp("dp_fit")
    kw, train, val, epochs = _fit_inputs(tmp)
    jobs = [("batchnorm", _bn_inputs()),
            ("bnorm_train_tail", _bnorm_train_inputs()),
            ("dp_step", (PORT_KW, ref["weights"], ref["image"],
                         ref["label"], True)),
            ("replicated_steps", (PORT_KW, ref["weights"],
                                  _replicated_batches())),
            ("fit", (dict(kw, results_folder_name="dp"), ref["weights"],
                     train, val, epochs))]
    out = _launch(2, jobs)
    return {"bn": [r[0] for r in out], "tail": [r[1] for r in out],
            "step": [r[2] for r in out], "replicated": [r[3] for r in out],
            "fit": [r[4] for r in out], "fit_inputs": (kw, train, val, epochs)}


@pytest.fixture(scope="module")
def four(ref):
    out = _launch(4, [("batchnorm", _bn_inputs()),
                      ("bnorm_train_tail", _bnorm_train_inputs()),
                      ("dp_step", (PORT_KW, ref["weights"], ref["image"],
                                   ref["label"]))])
    return {"bn": [r[0] for r in out], "tail": [r[1] for r in out],
            "step": [r[2] for r in out]}


@pytest.fixture(scope="module")
def nodes(ref):
    """Two nodes of two local ranks."""
    out = _launch(2, [("dp_step", (PORT_KW, ref["weights"], ref["image"],
                                   ref["label"]))], nnodes=2)
    return [r[0] for r in out]


def _runs(request, name):
    return request.getfixturevalue(name)


# ---- (a) the per-node file split --------------------------------------------

@pytest.mark.parametrize("n_files,n_nodes", [(10, 3), (8, 4), (7, 2), (3, 8)])
def test_shard_files_for_process_matches_jax(n_files, n_nodes):
    files = list(range(n_files))
    for node in range(n_nodes):
        assert (distributed.shard_files_for_process(files, node, n_nodes)
                == jshard_files(files, node, n_nodes))


# ---- (b) a rank's rows of a batch -------------------------------------------

def test_local_rows_split_evenly():
    for lr in range(4):
        assert distributed.local_rows(8, lr, 4, 1) == (slice(2 * lr,
                                                             2 * lr + 2),
                                                       False)
        assert distributed.local_rows(8, lr, 4, 2)[1] is False
    assert distributed.local_rows(3, 0, 1, 1) == (slice(0, 3), False)


def test_local_rows_replicate_an_indivisible_batch_on_one_node():
    for lr in range(2):
        assert distributed.local_rows(3, lr, 2, 1) == (slice(0, 3), True)


def test_local_rows_refuse_an_indivisible_batch_across_nodes():
    with pytest.raises(ValueError, match="multiple of the local rank"):
        distributed.local_rows(3, 0, 2, 2)


def _ranks(local_rank, local_world, nnodes=1, node=0):
    return distributed.Ranks(
        rank=node * local_world + local_rank, world=nnodes * local_world,
        local_rank=local_rank, local_world=local_world, node=node,
        nnodes=nnodes, device=torch.device("cpu"), backend="gloo")


class _Samples:
    """A dataset whose samples carry their index and a draw of their rng."""

    def __len__(self):
        return 7

    def get(self, index, rng):
        return {"image": np.full((1, 2, 2, 2), index, np.float32),
                "label": np.full((1, 2, 2, 2), rng.random(), np.float32)}


def test_dataloader_ranks_take_their_rows_of_one_plan():
    """Every rank materialises its rows of the one-process batch, with the
    same per-sample draws; the 7th case runs replicated."""
    whole = list(DataLoader(_Samples(), batch_size=2, shuffle=True, seed=4))
    parts = [list(DataLoader(_Samples(), batch_size=2, shuffle=True, seed=4,
                             ranks=_ranks(r, 2))) for r in range(2)]
    for step, batch in enumerate(whole):
        n = len(batch["image"])
        for r in range(2):
            got = parts[r][step]
            rows, replicated = distributed.local_rows(n, r, 2, 1)
            assert got["replicated"] is replicated is (n == 1)
            for key in ("image", "label"):
                np.testing.assert_array_equal(got[key], batch[key][rows])


def test_device_loader_ranks_take_their_rows_of_one_plan():
    rng = np.random.default_rng(6)
    samples = [{"image": rng.normal(size=(1, 12, 10, 9)).astype(np.float32),
                "label": (rng.random((1, 12, 10, 9)) > .5).astype(np.uint8)}
               for _ in range(5)]
    ds = DeviceCachedDataset(samples, (8, 8, 4), device="cpu")
    whole = list(DeviceLoader(ds, batch_size=2, shuffle=True, seed=1))
    for r in range(2):
        part = list(DeviceLoader(ds, batch_size=2, shuffle=True, seed=1,
                                 ranks=_ranks(r, 2)))
        for (image, label), (pi, pl, replicated) in zip(whole, part):
            rows, rep = distributed.local_rows(len(image), r, 2, 1)
            assert replicated is rep
            assert torch.equal(pi, image[rows])
            assert torch.equal(pl, label[rows])


def test_initialize_outside_torchrun_does_nothing(monkeypatch):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize("cpu") is None
    assert not torch.distributed.is_initialized()
    assert distributed.batch_stats_group() is None


def test_backend_and_device_per_rank():
    assert distributed.pick_backend("cuda", 4) == "nccl"
    assert distributed.pick_backend("cuda:0", 1) == "nccl"
    assert distributed.pick_backend("cuda:0", 2) == "gloo"
    assert distributed.pick_backend("cpu", 2) == "gloo"
    assert distributed.rank_device("cpu", 3) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.rank_device("cuda", 1)


# ---- (c) BatchNorm on the global batch --------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("runs", ["two", "four"])
def test_batchnorm_global_statistics_match_one_process(request, runs,
                                                       dtype):
    """Outputs, running statistics and input gradient of N ranks against
    one process on the concatenated batch: float32 within 1e-6 of the
    largest; bf16 outputs and gradients in the bf16 band, the float32
    statistics within 1e-6."""
    res = [r[f"torch.{dtype}"] for r in _runs(request, runs)["bn"]]
    x, w, params = _bn_inputs()
    bn = BatchNorm(4, device="cpu")
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    y = bn(xt)
    (y.float() * torch.from_numpy(w)).sum().backward()
    tol = 1e-6 if dtype == "float32" else BF16_TOL
    assert _rel(np.concatenate([r["y"] for r in res]), y.float().detach()
                ) <= tol
    assert _rel(np.concatenate([r["gx"] for r in res]), xt.grad.float()
                ) <= tol
    for r in res:
        assert _rel(r["mean"], bn.mean) <= 1e-6
        assert _rel(r["var"], bn.var) <= 1e-6
        np.testing.assert_array_equal(r["mean"], res[0]["mean"])
        np.testing.assert_array_equal(r["var"], res[0]["var"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("runs", ["two", "four"])
def test_bnorm_train_tail_global_statistics_match_one_process(request, runs,
                                                              dtype):
    """ops/bnorm_train.py's Function (its twins) on N ranks against one
    process on the concatenated batch with the same dropout words: outputs
    and input gradients (the global batch's statistics and their gradient)
    as the BatchNorm test above, and the ranks' gradients of scale, bias
    and slope summed over the ranks, float32 within 1e-5 of the largest
    (sums in other orders), bf16 in the bf16 band."""
    res = [r[f"torch.{dtype}"] for r in _runs(request, runs)["tail"]]
    x, w, words, params = _bnorm_train_inputs()
    bn = BatchNorm(4, device="cpu")
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()
                        if k != "alpha"})
    alpha = torch.nn.Parameter(torch.from_numpy(params["alpha"]))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    y = bnorm_train.bn_dropout_prelu(
        xt, bn, alpha, (torch.from_numpy(words), W.BNORM_THRESH))
    (y.float() * torch.from_numpy(w)).sum().backward()
    tol = 1e-6 if dtype == "float32" else BF16_TOL
    assert _rel(np.concatenate([r["y"] for r in res]), y.float().detach()
                ) <= tol
    assert _rel(np.concatenate([r["gx"] for r in res]), xt.grad.float()
                ) <= tol
    for key, ref in (("gscale", bn.scale.grad), ("gbias", bn.bias.grad),
                     ("galpha", alpha.grad)):
        assert _rel(sum(r[key] for r in res), ref) <= max(tol, 1e-5), key
    for r in res:
        assert _rel(r["mean"], bn.mean) <= 1e-6
        assert _rel(r["var"], bn.var) <= 1e-6
        np.testing.assert_array_equal(r["mean"], res[0]["mean"])
        np.testing.assert_array_equal(r["var"], res[0]["var"])


# ---- (d) one DP train step ---------------------------------------------------

def _check_state(got, ref, loss, ref_loss):
    """JAX's bounds (tests/test_parallel.py): loss rtol 1e-5, parameters
    within 3 lr (one Adam step moves each by about lr), BatchNorm
    statistics rtol 1e-3 / atol 1e-4."""
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    for name, value in ref.items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(got[name], value, rtol=1e-3,
                                       atol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], value, atol=3 * LR,
                                       err_msg=name)


@pytest.mark.parametrize("runs", ["two", "four"])
def test_dp_step_matches_one_process(request, ref, runs):
    res = _runs(request, runs)["step"]
    assert not any(r["replicated"] for r in res)
    _check_state(res[0]["plain"]["state"], ref["state"],
                 res[0]["plain"]["loss"], ref["loss"])


@pytest.mark.parametrize("runs", ["two", "four", "nodes"])
def test_dp_step_gradient_is_the_global_batch_gradient(request, ref, runs):
    """The gradient DDP leaves on every rank is the one-process gradient of
    the whole batch, within 1e-3 of the model's largest. Float32: the
    ranks' BatchNorm statistics come from sums and the one process's from
    means, one thread a rank against several, and the rounding grows
    through the backward of some 20 BatchNorms (measured up to 1.2e-4);
    the conv biases before a BatchNorm have a gradient that is rounding
    noise, so the bound is the model's, not each tensor's. Without the
    mean over the ranks each rank keeps its half's gradient, off by
    ~4e-2."""
    res = _runs(request, runs)
    res = res["step"] if isinstance(res, dict) else res
    scale = max(np.abs(g).max() for g in ref["grads"].values())
    for r in res:
        for name, g in ref["grads"].items():
            err = np.abs(r["plain"]["grads"][name] - g).max()
            assert err <= 1e-3 * scale, (name, err, scale)


@pytest.mark.parametrize("runs", ["two", "four", "nodes"])
def test_dp_step_matches_jax_mesh_step(request, ref, runs):
    res = _runs(request, runs)
    res = res["step"] if isinstance(res, dict) else res
    _check_state(res[0]["plain"]["state"], ref["jax_state"],
                 res[0]["plain"]["loss"], ref["jax_loss"])


@pytest.mark.parametrize("runs", ["two", "four", "nodes"])
def test_dp_step_leaves_every_rank_bit_identical(request, runs):
    res = _runs(request, runs)
    res = res["step"] if isinstance(res, dict) else res
    for r in res[1:]:
        assert r["plain"]["loss"] == res[0]["plain"]["loss"]
        for name, value in res[0]["plain"]["state"].items():
            np.testing.assert_array_equal(r["plain"]["state"][name], value,
                                          err_msg=name)


# ---- (e) two nodes of two ranks ---------------------------------------------

def test_two_nodes_shard_files_per_node_and_split_rows(nodes):
    assert [r["files"] for r in nodes] == [
        jshard_files(list(range(10)), n, 2) for n in (0, 0, 1, 1)]
    assert [r["rows"] for r in nodes] == [(0, 2), (2, 4)] * 2


# ---- (f) --remat -------------------------------------------------------------

def test_dp_step_with_remat_equals_the_plain_step(two):
    """Its recompute repeats the forward's all-reduces in the same order on
    every rank and does not move the running statistics twice."""
    for r in two["step"]:
        assert r["remat"]["loss"] == r["plain"]["loss"]
        for name, value in r["plain"]["state"].items():
            np.testing.assert_allclose(r["remat"]["state"][name], value,
                                       rtol=0, atol=1e-7, err_msg=name)


# ---- a replicated batch ------------------------------------------------------

def test_replicated_batch_runs_the_one_device_step(two):
    """A batch of 3 on 2 ranks runs whole on each: the state after the step
    equals one device's (local statistics, same generator), bit for bit,
    on every rank; the batch of 2 after it is sharded, and the ranks stay
    bit-identical."""
    for r in two["replicated"]:
        assert [s["replicated"] for s in r] == [True, False]
        first = r[0]
        assert first["loss"] == first["ref_loss"]
        for name, value in first["ref_state"].items():
            np.testing.assert_array_equal(first["state"][name], value,
                                          err_msg=name)
    for a, b in zip(*two["replicated"]):
        for name, value in a["state"].items():
            np.testing.assert_array_equal(b["state"][name], value)


# ---- (g) Trainer.fit ---------------------------------------------------------

def _one_process_fit(kw, train, val, epochs, weights):
    cfg = Config(num_epochs=epochs[0], **dict(kw, results_folder_name="one"))
    tr = ttrainer.Trainer(cfg, W.model_of(cfg, weights), "cpu",
                          logger=logging.getLogger("one_fit"))
    loader = DataLoader(W.ArrayDataset(*train), batch_size=2, shuffle=True,
                        seed=cfg.seed)
    val_loader = DataLoader(W.ArrayDataset(*val), batch_size=1)
    _, losses, dice = tr.fit(tr.init_state(), loader, val_loader)
    tr.cfg.num_epochs = epochs[1]
    back = tr.restore_state(f"{cfg.model_path}/last_epoch_model.ckpt")
    _, losses2, dice2 = tr.fit(back, loader, val_loader)
    return losses, dice, losses2, dice2


def test_fit_matches_one_process(ref, two):
    """Epoch losses and validation Dice of a 2-rank fit (two sharded steps
    and a replicated one an epoch) and of its resume, against one process
    on the whole batches. Losses 1e-5 relative. The Dice is of hard
    (argmax) labels: a weight that differs in its last bits flips the
    voxels whose two logits tie to that precision, each ~1e-3 of a
    validation crop's Dice, so it is held to 2e-3."""
    kw, train, val, epochs = two["fit_inputs"]
    one = _one_process_fit(kw, train, val, epochs, ref["weights"])
    for r in two["fit"]:
        for key, want in zip(("losses", "dice", "losses2", "dice2"), one):
            if key.startswith("dice"):
                np.testing.assert_allclose(r[key], want, rtol=0, atol=2e-3,
                                           err_msg=key)
            else:
                np.testing.assert_allclose(r[key], want, rtol=1e-5,
                                           err_msg=key)
        assert r["losses"] == two["fit"][0]["losses"]
        assert r["dice"] == two["fit"][0]["dice"]


def test_fit_checkpoints_come_from_rank_0_alone(two):
    r0, r1 = two["fit"]
    names = [p.rsplit("/", 1)[1] for p in r0["written"]]
    assert "last_epoch_model.ckpt" in names
    assert "best_metric_model.ckpt" in names
    assert r1["written"] == []


def test_fit_resumes_on_every_rank(two):
    for r in two["fit"]:
        assert r["epoch"] == two["fit_inputs"][3][0]
        for name, value in two["fit"][0]["saved"].items():
            np.testing.assert_array_equal(r["restored"][name], value)
            np.testing.assert_array_equal(r["saved"][name], value)


# ---- the training CLI --------------------------------------------------------

CLI_OVERRIDES = dict(CFG, dropout=0.0, pad_crop_shape=(32, 32, 8),
                     val_interval=1, epochs_with_const_lr=1)


def _cli_argv(root, split, name):
    return ["--data_root", str(root), "--split", split, "--device", "cpu",
            "--compute_dtype", "float32", "--train_batch_size", "2",
            "--results_folder_name", name]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """cli.train.main at 2 ranks (a launch a run) and in this process, each
    run to 1 epoch and resumed to 2, on 5 synthetic training cases."""
    from vs_seg_tpu_torch.cli import train as cli_train
    from vs_seg_tpu_torch.data.synthetic import generate_dataset
    work = tmp_path_factory.mktemp("dp_cli")
    root = work / "data"
    split = generate_dataset(str(root), n_train=5, n_val=1, n_test=0,
                             shape=(40, 40, 12), seed=2)
    dp, one = [], []
    real = cli_train.config_from_args
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        for n, extra in zip((1, 2), ([], ["--resume"])):
            ov = dict(CLI_OVERRIDES, num_epochs=n)
            dp.append(_launch(2, [("cli", (
                str(work), _cli_argv(root, split, "dp") + extra, ov))]))
            mp.setattr(cli_train, "config_from_args",
                       lambda a, _ov=ov: dataclasses.replace(real(a), **_ov))
            _, losses, dice = cli_train.main(
                _cli_argv(root, split, "one") + extra, make_figures=False)
            one.append((losses, dice))
    return {"dp": dp, "one": one, "results": root / "results"}


def test_train_cli_data_parallel_matches_one_process(cli_runs):
    """Rank 0's epoch losses (1e-5) and Dice values (2e-3, hard labels: see
    test_fit_matches_one_process) of the 2-rank CLI and of its resume; the
    other rank returns none."""
    for run, (l1, d1) in zip(cli_runs["dp"], cli_runs["one"]):
        ((losses, dice),), (rank1,) = run
        assert rank1 is None
        np.testing.assert_allclose(losses, l1, rtol=1e-5)
        np.testing.assert_allclose(dice, d1, rtol=0, atol=2e-3)


def test_train_cli_data_parallel_files_come_from_rank_0(cli_runs):
    """The same files as the one-process run, and one writer of the log."""
    folders = [cli_runs["results"] / name for name in ("dp", "one")]
    files = [sorted(str(p.relative_to(f)) for p in f.rglob("*")
                    if p.is_file()) for f in folders]
    assert files[0] == files[1]
    assert "model/last_epoch_model.ckpt" in files[0]
    log = (folders[0] / "logs" / "training_log.txt").read_text()
    assert log.count("data parallel: 2 ranks on 1 node(s), gloo") == 1
    assert log.count("Resuming full training state") == 1


# ---- (h) a failing rank ------------------------------------------------------

def test_a_failing_rank_ends_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 .*fails on purpose"):
        distributed.launch(W.fail, 2, 1, timeout_s=LAUNCH_TIMEOUT_S)
    assert time.monotonic() - t0 < LAUNCH_TIMEOUT_S


def test_a_launch_past_its_timeout_ends_every_rank():
    with pytest.raises(TimeoutError):
        distributed.launch(W.hang, 2, 60.0, timeout_s=3.0)
