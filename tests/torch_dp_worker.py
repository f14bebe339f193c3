"""The ranks of tests/test_torch_distributed.py. distributed.launch runs these
functions in spawned processes, which import this module and the port, and
no JAX: every argument and result is numpy, so the test process holds the
JAX side. Each rank joins a gloo group on the CPU with a short timeout."""

import dataclasses
import logging
import os
import time

import torch
import torch.distributed as dist

from vs_seg_tpu_torch.core.config import Config
from vs_seg_tpu_torch.data.dataset import DataLoader
from vs_seg_tpu_torch.models import build_model
from vs_seg_tpu_torch.nn.layers import BatchNorm
from vs_seg_tpu_torch.ops import bnorm_train
from vs_seg_tpu_torch.parallel import distributed
from vs_seg_tpu_torch.train import trainer as ttrainer

TIMEOUT_S = 60.0
# the dropout threshold of bnorm_train_tail (rate 0.1, nn/layers.py:Dropout)
BNORM_THRESH = 58982


def init():
    torch.set_num_threads(1)
    return distributed.initialize("cpu", timeout_s=TIMEOUT_S)


def to_np(tensors) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


def model_of(cfg, weights):
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.items()})
    return model


def node_rows(ranks, n: int) -> slice:
    """The node's share of a global batch of n (each node materialises only
    its slice, as make_global_batch's callers do)."""
    per = n // ranks.nnodes
    return slice(ranks.node * per, (ranks.node + 1) * per)


def batchnorm(x, w, params):
    """BatchNorm at train on this rank's rows of x, in float32 and bf16:
    output, running statistics and input gradient of sum(out * w)."""
    ranks = init()
    rows, _ = ranks.rows(len(x))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bn = BatchNorm(x.shape[-1], device="cpu")
        bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                            params.items()})
        xt = torch.from_numpy(x[rows]).to(dtype).requires_grad_()
        y = bn(xt)
        (y.float() * torch.from_numpy(w[rows])).sum().backward()
        out[str(dtype)] = {"y": y.detach().float().numpy(),
                           "gx": xt.grad.float().numpy(),
                           "mean": bn.mean.numpy().copy(),
                           "var": bn.var.numpy().copy()}
    return out


def bnorm_train_tail(x, w, words, params):
    """The train-mode BatchNorm -> dropout -> PReLU Function
    (ops/bnorm_train.py) on this rank's rows of x and of the dropout words,
    in float32 and bf16: output, running statistics, input gradient of
    sum(out * w) and this rank's gradients of scale, bias and the slope."""
    ranks = init()
    rows, _ = ranks.rows(len(x))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        bn = BatchNorm(x.shape[-1], device="cpu")
        bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                            params.items() if k != "alpha"})
        alpha = torch.nn.Parameter(torch.from_numpy(params["alpha"]))
        xt = torch.from_numpy(x[rows]).to(dtype).requires_grad_()
        y = bnorm_train.bn_dropout_prelu(
            xt, bn, alpha, (torch.from_numpy(words[rows]), BNORM_THRESH))
        (y.float() * torch.from_numpy(w[rows])).sum().backward()
        out[str(dtype)] = {"y": y.detach().float().numpy(),
                           "gx": xt.grad.float().numpy(),
                           "mean": bn.mean.numpy().copy(),
                           "var": bn.var.numpy().copy(),
                           "gscale": bn.scale.grad.numpy().copy(),
                           "gbias": bn.bias.grad.numpy().copy(),
                           "galpha": alpha.grad.numpy().copy()}
    return out


def dp_step(cfg_kw, weights, image, label, remat: bool = False):
    """One data-parallel train step of the Trainer on this rank's rows of
    the node's share of (image, label): the global loss (the mean over the
    ranks), the model's state and gradients after it, the node's files of
    ten, and the same step with --remat."""
    ranks = init()
    node = node_rows(ranks, len(image))
    rows, replicated = ranks.rows(node.stop - node.start)
    x = torch.from_numpy(image[node][rows])
    y = torch.from_numpy(label[node][rows])
    out = {"rows": (rows.start, rows.stop), "replicated": replicated,
           "files": distributed.shard_files_for_process(
               list(range(10)), ranks.node, ranks.nnodes)}
    for key, flag in (("plain", False), ("remat", True)):
        if flag and not remat:
            continue
        cfg = Config(remat=flag, **cfg_kw)
        tr = ttrainer.Trainer(cfg, model_of(cfg, weights), "cpu",
                              ranks=ranks)
        state = tr.init_state()
        loss = tr.make_step(state)(x, y, state["generator"], replicated)
        model = state["model"]
        out[key] = {"loss": float(distributed.mean_over_ranks(loss)),
                    "state": to_np(model.state_dict()),
                    "grads": to_np({n: p.grad for n, p in
                                    model.named_parameters()})}
    return out


def replicated_steps(cfg_kw, weights, batches):
    """Steps of the Trainer on whole batches (every rank holds every row,
    replicated when the rank count does not divide them), and the same
    steps of a one-device Trainer in this process on another copy of the
    weights, run with local BatchNorm statistics: the states after each."""
    ranks = init()
    cfg = Config(**cfg_kw)
    tr = ttrainer.Trainer(cfg, model_of(cfg, weights), "cpu", ranks=ranks)
    one = ttrainer.Trainer(cfg, model_of(cfg, weights), "cpu")
    states = [tr.init_state(), one.init_state()]
    steps = [tr.make_step(states[0]), one.make_step(states[1])]
    out = []
    for image, label in batches:
        rows, replicated = ranks.rows(len(image))
        x = torch.from_numpy(image)
        y = torch.from_numpy(label)
        loss = steps[0](x[rows], y[rows], states[0]["generator"], replicated)
        with distributed.replicated_batch():
            ref = steps[1](x, y, states[1]["generator"])
        out.append({"replicated": replicated, "loss": float(loss),
                    "ref_loss": float(ref),
                    "state": to_np(states[0]["model"].state_dict()),
                    "ref_state": to_np(states[1]["model"].state_dict())})
    return out


class ArrayDataset:
    """CacheDataset's interface over (N, C, H, W, D) arrays."""

    def __init__(self, images, labels):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def get(self, index, rng):
        return {"image": self.images[index], "label": self.labels[index]}


def fit(cfg_kw, weights, train, val, epochs):
    """Trainer.fit to epochs[0] on this rank's rows, then every rank
    restores the last checkpoint and fits on to epochs[1]: the losses and
    Dice values of both, the checkpoints this rank wrote, and the states
    before the save and after the restore."""
    ranks = init()
    written = []
    real = ttrainer.save_checkpoint

    def recording(path, state):
        written.append(path)
        real(path, state)

    ttrainer.save_checkpoint = recording
    cfg = Config(num_epochs=epochs[0], **cfg_kw)
    tr = ttrainer.Trainer(cfg, model_of(cfg, weights), "cpu",
                          logger=logging.getLogger("dp_fit"), ranks=ranks)
    loader = DataLoader(ArrayDataset(*train), batch_size=2, shuffle=True,
                        seed=cfg.seed, ranks=ranks)
    val_loader = DataLoader(ArrayDataset(*val), batch_size=1)
    state, losses, dice = tr.fit(tr.init_state(), loader, val_loader)
    saved = to_np(state["model"].state_dict())
    dist.barrier()           # rank 0's last checkpoint is on disk
    tr.cfg.num_epochs = epochs[1]
    back = tr.restore_state(f"{cfg.model_path}/last_epoch_model.ckpt")
    restored = to_np(back["model"].state_dict())
    _, losses2, dice2 = tr.fit(back, loader, val_loader)
    return {"losses": losses, "dice": dice, "losses2": losses2,
            "dice2": dice2, "written": written, "saved": saved,
            "restored": restored, "epoch": back["epoch"]}


def cli(workdir, argv, overrides):
    """cli.train.main in `workdir` on `argv` with the configuration's fields
    replaced by `overrides` (the reference CLI has no flag for them): rank
    0's epoch losses and Dice values (None on the other ranks). main joins
    and leaves the group itself."""
    from vs_seg_tpu_torch.cli import train as cli_train
    torch.set_num_threads(1)
    os.chdir(workdir)
    real = cli_train.config_from_args
    cli_train.config_from_args = (
        lambda a: dataclasses.replace(real(a), **overrides))
    _, losses, dice = cli_train.main(argv, make_figures=False)
    return (losses, dice) if int(os.environ["RANK"]) == 0 else None


def run(jobs):
    """[(name of a function of this module, args)] -> their results, in one
    group of ranks (one spawn for several checks)."""
    return [globals()[name](*args) for name, args in jobs]


def fail(bad_rank: int):
    """Rank `bad_rank` raises; the others wait at a barrier for it."""
    ranks = init()
    if ranks.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails on purpose")
    dist.barrier()


def hang(seconds: float):
    """Every rank sleeps past the launch's timeout."""
    init()
    time.sleep(seconds)
