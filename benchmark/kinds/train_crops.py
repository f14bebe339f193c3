"""Training on random crops from a device-cached set, as the port's
training CLI runs it under --device_cache: the generator of every traffic
mix of kind "train_crops".

Set-up builds the model of the configuration on the card, loads the seeded
weights, caches the pool of seeded volumes on the device
(data/device_pipeline.py:DeviceCachedDataset), and builds one training
state (train/trainer.py:Trainer.init_state) and its step
(Trainer.make_step). It drives that step through its first
`checked_steps` steps on the DeviceLoader's batches (random crops with L-R
flips; each a different volume), reading on the way what the comparison
needs: each step's loss, the first gradient of every parameter from
Adam's first moment after step 1, and each parameter's change after the
last checked step. Those steps build and warm every kernel the step runs.

The window then goes on with the same state, step and loader: the inner
loop of Trainer.fit's later epochs, with no synchronise per step, until
the deadline; one synchronise ends it. train_step_ms is the window's wall
time over the steps enqueued in it.

With --trace 1 a stretch of `trace_steps` steps under torch.profiler
follows the window (busy time a step, elementwise and
reduction ms, the breakdown), after one step that runs under the profiler
outside the stretch.

What is judged: the plain reference (reference.train_steps, float32, TF32
off) follows the checked steps from the same weights, on the same crops
(drawn again from the loader's seed as DeviceLoader draws them) and with
the same dropout masks (drawn again from the generator's seed), once the
window has closed and the program's state is freed.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import common, data, flops, reference
from benchmark.trace import summarise, traced

# a leaf whose first gradient in the reference is under this share of the
# median leaf's is nought to rounding (a conv bias under batch statistics):
# Adam moves it by round-off alone, so its change is not compared
NOUGHT = 1e-3
# the leaves of at least this many dimensions are the conv weights; the
# others (PReLU slopes, BatchNorm scales and shifts, biases) are one number
# a channel summed over every voxel, whose gap is rounding amplified by
# that sum, so the worst-leaf numbers are taken over the conv weights
CONV_NDIM = 2


def samples(cases) -> list:
    """The pool as the training set's cache holds it: (C, H, W, D)."""
    return [{"image": c["image"][0], "label": c["label"][0]} for c in cases]


def batches(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, program_hook=None) -> dict:
    """One run of a training cell. `program_hook(step, optimizer) ->
    step`, for tests, may put a fault under the timed path."""
    from vs_seg_tpu_torch.core.device import DTYPES
    from vs_seg_tpu_torch.data.device_pipeline import (DeviceCachedDataset,
                                                       DeviceLoader)
    from vs_seg_tpu_torch.models import build_model
    from vs_seg_tpu_torch.train.trainer import Trainer

    cfg_file, traffic, dev = cell.config, cell.traffic, device
    cfg = common.program_config(
        cfg_file, seed=seed, device_cache=True,
        pad_crop_shape=tuple(int(v) for v in traffic["crop"]),
        train_batch_size=int(traffic["batch"]))
    net = reference.RefNet(cfg_file)
    model = build_model(cfg, device=dev)
    model.load_state_dict(reference.make_weights(
        net, data.sub_seed(seed, data.WEIGHTS), dev))
    common.note(t_start, "model built, weights loaded")
    cases = data.make_cases(traffic, seed, dev)
    dataset = DeviceCachedDataset(samples(cases), cfg.pad_crop_shape,
                                  device=dev, augment=bool(traffic["flip"]))
    loader = DeviceLoader(dataset, batch_size=cfg.train_batch_size,
                          shuffle=bool(traffic["shuffle"]), seed=seed)
    trainer = Trainer(cfg, model, dev, logger=common.quiet_logger())
    state = trainer.init_state(seed)
    step = trainer.make_step(state)
    if program_hook is not None:
        step = program_hook(step, state["optimizer"])
    gen = state["generator"]
    dtype = DTYPES[cfg.compute_dtype]
    it = batches(loader)

    common.note(t_start, "set cached on the device, step built")
    named = dict(model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in named.items()}
    losses, first = [], None
    for i in range(int(traffic["checked_steps"])):
        image, label = next(it)[:2]
        losses.append(step(image.to(dtype), label, gen))
        if i == 0:
            opt = state["optimizer"].state
            beta1 = float(cfg_file["adam_betas"][0])
            first = leaf_norms({k: opt[v]["exp_avg"] / (1.0 - beta1)
                                if v in opt else torch.zeros_like(v)
                                for k, v in named.items()})
    change = leaf_norms({k: v.detach() - p0[k] for k, v in named.items()})
    losses = [float(v) for v in losses]
    del p0
    common.sync(dev)
    setup_s = time.perf_counter() - t_start
    common.note(t_start, f"set-up done ({setup_s:.2f} s)")

    window = []
    loader_s = 0.0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        t = time.perf_counter()
        image, label = next(it)[:2]
        loader_s += time.perf_counter() - t
        window.append(step(image.to(dtype), label, gen))
        if time.perf_counter() >= deadline:
            break
    common.sync(dev)
    wall = time.perf_counter() - t0
    n = len(window)
    common.note(t_start, f"window: {n} steps in {wall:.3f} s")
    bad = int(sum(not np.isfinite(float(v)) for v in window))

    crop = traffic["crop"]
    ctx = {"kind": "train", "steps": n, "wall_s": wall,
           "loader_ms": 1e3 * loader_s / n,
           "flop_per_step": flops.train_step_flops(
               cfg_file, crop, int(traffic["batch"])),
           "device_kind": common.device_kind(dev),
           "peaks": common.peaks()}
    if trace:
        m = int(traffic["trace_steps"])

        def warm():
            image, label = next(it)[:2]
            step(image.to(dtype), label, gen)

        with traced(dev, warm) as tr:
            for _ in range(m):
                with torch.profiler.record_function("bench.next_batch"):
                    image, label = next(it)[:2]
                with torch.profiler.record_function("bench.train_step"):
                    step(image.to(dtype), label, gen)
        ctx["trace"] = summarise(tr.events)
        ctx["trace_steps"] = m
    peak = common.peak_memory(dev)
    common.note(t_start, f"peak {peak / 2**30:.2f} GiB; reference next")
    del model, state, step, trainer, loader, dataset, it, named, window
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(net, cfg_file, traffic, seed, cases, losses, first,
                     change, dev)
    common.note(t_start, "reference done")
    return {"end_to_end": {"train_step_ms": 1e3 * wall / n,
                           "setup_s": setup_s},
            "attempted": n, "failed": bad, "checks": checks,
            "memory_peak_bytes": peak, "ctx": ctx}


def crops_of(traffic: dict, seed: int, cases, steps: int, dev):
    """The first `steps` batches of the training loader, drawn again as
    DeviceLoader draws them (np.random.default_rng([seed, epoch]): the
    epoch's order, then per batch the (d, h, w) starts, uniform within the
    volume, and the H flips, p = 0.5), cut from the float32 volumes:
    [(image, label)] as (B, 1, D, H, W) tensors."""
    crop = [int(v) for v in traffic["crop"]]
    cdhw = np.asarray((crop[2], crop[0], crop[1]))
    batch = int(traffic["batch"])
    n = len(cases)
    vols = [torch.from_numpy(c["image"][0, 0]).permute(2, 0, 1)
            for c in cases]
    labs = [torch.from_numpy(c["label"][0, 0]).permute(2, 0, 1)
            for c in cases]
    extents = np.asarray([tuple(v.shape) for v in vols], np.int64)
    out, epoch = [], 0
    while len(out) < steps:
        rng = np.random.default_rng([seed, epoch])
        order = (rng.permutation(n) if traffic["shuffle"]
                 else np.arange(n))
        for b in range(-(-n // batch)):
            idx = order[b * batch:(b + 1) * batch]
            starts = rng.integers(0, extents[idx] - cdhw + 1)
            flips = (rng.random(len(idx)) < 0.5 if traffic["flip"]
                     else np.zeros(len(idx), bool))
            imgs, lbls = [], []
            for i, (d0, h0, w0), f in zip(idx, starts, flips):
                sl = (slice(d0, d0 + cdhw[0]), slice(h0, h0 + cdhw[1]),
                      slice(w0, w0 + cdhw[2]))
                im, lb = vols[i][sl], labs[i][sl]
                if f:
                    im, lb = im.flip(1), lb.flip(1)
                imgs.append(im)
                lbls.append(lb)
            out.append((torch.stack(imgs)[:, None].to(dev),
                        torch.stack(lbls)[:, None].to(dev)))
            if len(out) == steps:
                break
        epoch += 1
    return out


def gaps(got: Dict[str, float], ref: Dict[str, float], keep):
    """Each leaf's gap |got - ref| against the larger of its own reference
    norm and the median leaf's."""
    med = float(np.median([ref[k] for k in keep]))
    return [abs(got[k] - ref[k]) / max(ref[k], med) for k in keep]


def reference_numbers(net, cfg_file, traffic, seed, cases, dev,
                      prec="f32"):
    """(losses, first-gradient norms, raw first gradients' norms, change
    norms, the names of the conv weights) of the reference over the
    checked steps."""
    steps = int(traffic["checked_steps"])
    crops = crops_of(traffic, seed, cases, steps, dev)
    p0 = reference.make_weights(net, data.sub_seed(seed, data.WEIGHTS), dev)
    with reference.fp32_exact():
        losses, first, p = reference.train_steps(
            net, p0, crops, seed=seed,
            lr=float(cfg_file["initial_learning_rate"]),
            wd=float(cfg_file["weight_decay"]),
            betas=tuple(float(b) for b in cfg_file["adam_betas"]),
            eps=float(cfg_file["adam_eps"]),
            supervised_attention=bool(cfg_file["attention"]),
            hardness=bool(cfg_file["hardness"]), prec=prec, device=dev)
    wd = float(cfg_file["weight_decay"])
    raw = leaf_norms({k: g - wd * p0[k] for k, g in first.items()})
    change = leaf_norms({k: p[k] - p0[k] for k in first})
    conv = {k for k, v in p0.items() if v.dim() >= CONV_NDIM}
    return losses, leaf_norms(first), raw, change, conv


def numbers(ref, losses, first, change) -> Dict[str, float]:
    """The worst step's relative loss gap; of the first gradient's and of
    the change's leaf norms the median leaf's gap, the worst leaf's, and
    the worst conv weight's."""
    ref_losses, ref_first, ref_raw, ref_change, conv = ref
    med = float(np.median(list(ref_raw.values())))
    keep = [k for k, v in ref_raw.items() if v >= NOUGHT * med]
    grad = gaps(first, ref_first, keep)
    moved = gaps(change, ref_change, keep)
    is_conv = [k in conv for k in keep]
    return {"loss_gap": common.worst(abs(a - b) / abs(b)
                                     for a, b in zip(losses, ref_losses)),
            "grad_gap": common.worst(grad),
            "grad_gap_med": float(np.median(grad)),
            "grad_gap_conv": common.worst(
                g for g, c in zip(grad, is_conv) if c),
            "change_gap": common.worst(moved),
            "change_gap_med": float(np.median(moved)),
            "change_gap_conv": common.worst(
                g for g, c in zip(moved, is_conv) if c)}


def compare(net, cfg_file, traffic, seed, cases, losses, first, change,
            dev) -> Dict[str, float]:
    """The numbers of the program's checked steps against the reference's
    (numbers); the cell's limits name those compared."""
    ref = reference_numbers(net, cfg_file, traffic, seed, cases, dev)
    return numbers(ref, losses, first, change)


def control(cell, seed: int, device) -> Dict[str, float]:
    """The numbers of the control: the reference in float8 in the
    program's place."""
    traffic, dev = cell.traffic, device
    net = reference.RefNet(cell.config)
    cases = data.make_cases(traffic, seed, dev)
    ref = reference_numbers(net, cell.config, traffic, seed, cases, dev)
    q_losses, q_first, _, q_change, _ = reference_numbers(
        net, cell.config, traffic, seed, cases, dev, prec="fp8")
    return numbers(ref, q_losses, q_first, q_change)


# Faults the cell can have, for the tests and the readings: each takes the
# step and its optimizer and returns the step with the fault under it.

def fault_state_unchanged(step, optimizer):
    """A step that returns its state unchanged: no update is applied."""
    optimizer.step = lambda *a, **kw: None
    return step


def fault_half_batch(step, optimizer):
    """Half of the batch left out, the mean taken over the rest: the batch
    is one crop, so the loss is taken over its first half in depth."""
    def half(image, label, gen):
        d = image.shape[1] // 2
        return step(image[:, :d], label[:, :d], gen)
    return half


def fault_altered(step, optimizer):
    """An answer altered where it is produced: each step's loss reads 5 %
    high."""
    return lambda image, label, gen: step(image, label, gen) * 1.05


def fault_dw_site_doubled(step, optimizer):
    """One conv333_dw site's weight gradient counted twice (as a split
    reduce that adds one partial twice would, at the whole site): the
    site whose (x, dy) shapes the first step's first conv333_dw call had,
    in every step; the module's function is put back after each step."""
    from vs_seg_tpu_torch.ops import train_conv

    dw_fn = train_conv.conv333_dw
    site = []

    def doubled(x, dy):
        dw, db = dw_fn(x, dy)
        key = (tuple(x.shape), tuple(dy.shape))
        if not site:
            site.append(key)
        return (dw * 2.0, db) if key == site[0] else (dw, db)

    def faulted(image, label, gen):
        train_conv.conv333_dw = doubled
        try:
            return step(image, label, gen)
        finally:
            train_conv.conv333_dw = dw_fn

    return faulted


FAULTS = {"state_unchanged": fault_state_unchanged,
          "half_batch": fault_half_batch, "altered": fault_altered,
          "dw_site_doubled": fault_dw_site_doubled}
