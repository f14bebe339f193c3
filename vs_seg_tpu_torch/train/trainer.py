"""Training loop: the counterpart of vs_seg_tpu/train/trainer.py, on one
device or data-parallel over several ranks.

  - Adam with torch's coupled L2 weight decay (decay added to the gradient
    before the moments; betas 0.9/0.999, eps 1e-8), on every parameter; the
    BatchNorm running statistics are buffers and take no decay;
  - one train step = train-mode forward (batch-stat BatchNorm, dropout from
    the explicit generator, the (3,3,3) convs' hand-written backward),
    dice_spvpa_loss, backward, Adam step; a model that returns the logits
    alone (UNet2d5, UNet) has no attention maps to supervise;
  - validation every `val_interval` epochs with the eval forward (the eval
    kernels), loss and hard Dice; best and last checkpoints;
  - the learning rate divided by `lr_divisor` every `epochs_with_const_lr`
    epochs.

Loaders yield host dict batches (data/dataset.py:DataLoader) or (image,
label) device tuples (data/device_pipeline.py:DeviceLoader). An optional
TensorBoard writer gets the epoch and validation scalars and, in debug mode,
the image grid of vs_seg_tpu/train/trainer.py; `cfg.profile_steps` traces
that many steady steps of the first epoch into <results>/profile/.

The state is a dict: {"model", "optimizer", "generator", "epoch",
"best_metric", "best_metric_epoch"}; the model and optimizer hold the
tensors. `restore_state` reads the port's checkpoints and the JAX
package's, a legacy one (per-parameter Adam moment trees) included.

Data parallelism (`ranks`, parallel/distributed.py:Ranks; the counterpart
of JAX's mesh-sharded step): each rank runs its rows of the batch (the
loaders pick them) through the model wrapped in DistributedDataParallel
(broadcast_buffers=False: BatchNorm's running statistics come out equal on
every rank from its global statistics), which averages the gradient over
the ranks. The mean is exact because dice_spvpa_loss is a mean of
per-sample terms over equal local batches. Dropout draws on rank r from a
generator of its own (distributed.rank_generator). A batch that every rank
holds whole (replicated) runs the step one device would: local BatchNorm
statistics, the generator of the state (the same on every rank), and rank
0's gradients and statistics broadcast to every rank. The epoch loss is
averaged over the ranks once an epoch; validation runs the whole set on
every rank, with rank 0's metric taken by all, so every rank makes the
same best-checkpoint decision. Only rank 0 writes checkpoints, TensorBoard
scalars, the image grid and the profiler trace; restore_state reads the
checkpoint on every rank.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vs_seg_tpu_torch.compat import jax_ckpt
from vs_seg_tpu_torch.compat.from_jax import (legacy_adam_moments,
                                               load_jax_train_state,
                                               load_jax_variables)
from vs_seg_tpu_torch.core.device import DTYPES, resolve_device
from vs_seg_tpu_torch.core.observability import (make_image_grid, span,
                                                  start_trace)
from vs_seg_tpu_torch.eval.metrics import center_of_mass_slice, dice_score
from vs_seg_tpu_torch.losses.dice import dice_spvpa_loss
from vs_seg_tpu_torch.parallel import distributed
from vs_seg_tpu_torch.train.checkpoint import (checkpoint_kind,
                                               load_checkpoint,
                                               save_checkpoint)


def make_optimizer(params: Iterable[torch.Tensor], learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: the update of vs_seg_tpu's optax chain
    (add_decayed_weights -> scale_by_adam -> -lr)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def _split(output):
    """(logits, attention maps) of a model's output; a model that returns
    the logits alone has no maps (vs_seg_tpu's `output if isinstance(output,
    tuple) else (output, ())`)."""
    return output if isinstance(output, tuple) else (output, ())


def _loss(output, label, supervised_attention: bool, hardness: bool):
    logits, atts = _split(output)
    return dice_spvpa_loss(logits, atts, label,
                           supervised_attention=supervised_attention,
                           hardness_weighting=hardness)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                    supervised_attention: bool, hardness: bool,
                    use_kernels: bool = True,
                    after_backward: Optional[Callable[[], None]] = None
                    ) -> Callable:
    """(image, label, generator) -> loss (a device scalar, not synced).
    Updates the model's parameters, BatchNorm statistics and the optimizer in
    place; `after_backward` runs between the backward and the update. The
    phases run under the spans train.forward, train.loss, train.backward
    (with `after_backward`) and train.optimizer (zero_grad and the
    update)."""

    def step(image, label, generator):
        label = label.float()            # may arrive uint8
        with span("train.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            output = model(image, use_kernels=use_kernels, train=True,
                           generator=generator)
        with span("train.loss"):
            loss = _loss(output, label, supervised_attention, hardness)
        with span("train.backward"):
            loss.backward()
            if after_backward is not None:
                after_backward()
        with span("train.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def make_eval_step(model: nn.Module, *, supervised_attention: bool,
                   hardness: bool, use_kernels: bool = True) -> Callable:
    """(image, label) -> (loss, dice), device scalars."""

    def step(image, label):
        label = label.float()
        with torch.no_grad():
            output = model(image, use_kernels=use_kernels, train=False)
            loss = _loss(output, label, supervised_attention, hardness)
            return loss, dice_score(_split(output)[0].float(), label)

    return step


def to_device_batch(batch, device, image_dtype=None):
    """(B, C, H, W, D) host batch -> (B, D, H, W, C) tensors on `device`.
    Images are cast on the host to `image_dtype`, then transposed (the same
    bytes as transposing first: the cast is elementwise); labels that are
    exact in uint8 travel as uint8 and the steps cast them on the device."""
    label = np.asarray(batch["label"])
    if label.dtype != np.uint8:
        cast = label.astype(np.uint8)
        if np.array_equal(cast, label):
            label = cast
    img = torch.from_numpy(np.asarray(batch["image"]))
    if image_dtype is not None:
        img = img.to(image_dtype)
    img = img.permute(0, 4, 2, 3, 1).contiguous()
    lbl = torch.from_numpy(label).permute(0, 4, 2, 3, 1).contiguous()
    return (img.to(device, non_blocking=True),
            lbl.to(device, non_blocking=True))


class Trainer:
    """Trainer(cfg, model, device).init_state() -> fit(state, train_loader,
    val_loader). Loaders yield dicts of numpy (B, C, H, W, D) "image" and
    "label", or (image, label) device tuples in (B, D, H, W, C).
    `use_kernels=False` runs the all-plain path. `tb_writer` is a
    tensorboardX SummaryWriter or None, used on rank 0 alone. `ranks`
    (distributed.initialize's) trains data-parallel; the loaders then
    yield this rank's rows."""

    def __init__(self, cfg, model: nn.Module, device,
                 logger: Optional[logging.Logger] = None,
                 use_kernels: bool = True, tb_writer=None,
                 ranks: Optional[distributed.Ranks] = None):
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger()
        self.use_kernels = use_kernels
        self.ranks = ranks
        self.tb_writer = tb_writer if self.rank0 else None
        self._ddp = None
        self._transfer_dtype = DTYPES[cfg.compute_dtype]

    @property
    def rank0(self) -> bool:
        """Whether this process writes the run's files."""
        return self.ranks is None or self.ranks.rank == 0

    def _ddp_model(self) -> nn.Module:
        """The model under DistributedDataParallel, made once (its
        constructor broadcasts rank 0's parameters and buffers)."""
        if self._ddp is None:
            from torch.nn.parallel import DistributedDataParallel
            ids = [self.device.index] if self.device.type == "cuda" else None
            self._ddp = DistributedDataParallel(
                self.model, device_ids=ids, broadcast_buffers=False)
        return self._ddp

    def make_step(self, state: Dict[str, Any]) -> Callable:
        """(image, label, generator, replicated=False) -> loss: one train
        step of this rank on its rows of the batch, on the model and
        optimizer of `state`. Without ranks `replicated` is ignored; with
        them a sharded batch goes through DistributedDataParallel, a
        replicated one through the bare model with local BatchNorm
        statistics and rank 0's gradients and statistics broadcast."""
        model, optimizer = state["model"], state["optimizer"]
        kw = dict(supervised_attention=self.cfg.attention,
                  hardness=self.cfg.hardness, use_kernels=self.use_kernels)
        if self.ranks is None:
            single = make_train_step(model, optimizer, **kw)
            return lambda image, label, generator, replicated=False: \
                single(image, label, generator)
        sharded = make_train_step(self._ddp_model(), optimizer, **kw)

        def take_rank0s():
            distributed.broadcast_from_rank0(
                [p.grad for p in model.parameters() if p.grad is not None]
                + [b for b in model.buffers() if b.is_floating_point()])

        whole = make_train_step(model, optimizer, after_backward=take_rank0s,
                                **kw)

        def step(image, label, generator, replicated=False):
            if not replicated:
                return sharded(image, label, generator)
            with distributed.replicated_batch():
                return whole(image, label, generator)

        return step

    def _optimizer(self):
        return make_optimizer(self.model.parameters(),
                              self.cfg.initial_learning_rate,
                              self.cfg.weight_decay)

    def init_state(self, seed: Optional[int] = None) -> Dict[str, Any]:
        """A fresh optimizer and the dropout generator, on the model's
        current weights (seeded by whoever built the model)."""
        seed = self.cfg.seed if seed is None else seed
        return {"model": self.model, "optimizer": self._optimizer(),
                "generator": torch.Generator(self.device).manual_seed(seed),
                "epoch": 0, "best_metric": -1.0, "best_metric_epoch": -1}

    def _device_batch(self, batch):
        """A loader's batch -> (image in the compute dtype, label,
        replicated) on the device; a device tuple is cast there and never
        leaves it."""
        if isinstance(batch, tuple):
            image, label = batch[:2]
            return (image.to(self._transfer_dtype), label,
                    len(batch) > 2 and bool(batch[2]))
        return (*to_device_batch(batch, self.device, self._transfer_dtype),
                bool(batch.get("replicated", False)))

    def _write_image_grid(self, train_loader) -> None:
        """The debug-mode TensorBoard grid of centre-of-mass slices
        (reference params/VSparams.py:417-426). It walks the loader once,
        which advances a host loader's epoch, as JAX's does (every rank
        walks it, so the ranks stay on one epoch; rank 0 draws the grid of
        its rows); a device loader's crops stay on the device and give no
        grid."""
        images = []
        for batch in train_loader:
            if not isinstance(batch, dict):
                break
            for image, label in zip(batch["image"], batch["label"]):
                s = center_of_mass_slice(np.squeeze(label[0]))
                images.append(image[0, :, :, s])
                images.append(label[0, :, :, s])
        if self.tb_writer is not None:
            grid = make_image_grid(images)
            self.tb_writer.add_image("images", grid[None], 0)

    def fit(self, state: Dict[str, Any], train_loader, val_loader
            ) -> Tuple[Dict[str, Any], list, list]:
        cfg, logger = self.cfg, self.logger
        model, optimizer = state["model"], state["optimizer"]
        train_step = self.make_step(state)
        eval_step = make_eval_step(
            model, supervised_attention=cfg.attention, hardness=cfg.hardness,
            use_kernels=self.use_kernels)
        best_metric = float(state.get("best_metric", -1.0))
        best_metric_epoch = int(state.get("best_metric_epoch", -1))
        start_epoch = int(state.get("epoch", 0))
        logger.info("Running the training loop...")
        if cfg.debug and (self.tb_writer is not None
                          or self.ranks is not None):
            self._write_image_grid(train_loader)
        # --profile_steps N: trace N steady steps of the first epoch (from
        # its second step) into <results>/profile/
        profile_steps = cfg.profile_steps if self.rank0 else 0
        prof = None
        epoch_loss_values, metric_values = [], []
        start = time.perf_counter()
        for epoch in range(start_epoch, cfg.num_epochs):
            logger.info("-" * 10)
            logger.info("Epoch %d/%d", epoch + 1, cfg.num_epochs)
            if epoch - start_epoch == cfg.val_interval:
                elapsed = time.perf_counter() - start
                logger.info(
                    "Average duration of first %d epochs = %.2f s. "
                    "Expected total training time = %.2f h",
                    cfg.val_interval, elapsed / cfg.val_interval,
                    elapsed * cfg.num_epochs / cfg.val_interval / 3600)
            lr = cfg.initial_learning_rate / (
                cfg.lr_divisor ** (epoch // cfg.epochs_with_const_lr))
            for group in optimizer.param_groups:
                group["lr"] = lr
            rank_gen = None
            if self.ranks is not None and self.ranks.world > 1:
                rank_gen = distributed.rank_generator(
                    self.device, cfg.seed, epoch, self.ranks.rank)
            step_losses = []
            for batch in train_loader:
                image, label, replicated = self._device_batch(batch)
                if (profile_steps and epoch == start_epoch
                        and len(step_losses) == 1):
                    profile_dir = os.path.join(cfg.results_folder_path,
                                               "profile")
                    logger.info("profiling %d steps -> %s", profile_steps,
                                profile_dir)
                    prof = start_trace(profile_dir, self.device)
                gen = (state["generator"] if rank_gen is None or replicated
                       else rank_gen)
                loss = train_step(image, label, gen, replicated)
                step_losses.append(loss)      # kept on the device: no sync
                if prof is not None and len(step_losses) > profile_steps:
                    float(loss)     # sync: the trace holds the whole step
                    prof.stop()
                    prof, profile_steps = None, 0
                if epoch == start_epoch:
                    logger.info("%d/%d, train_loss: %.4f", len(step_losses),
                                len(train_loader), float(loss))
            if prof is not None:    # the epoch was shorter than the window
                float(step_losses[-1])
                prof.stop()
                prof, profile_steps = None, 0
            epoch_loss = 0.0
            if step_losses:
                mean = torch.stack(step_losses).mean()
                if self.ranks is not None:
                    mean = distributed.mean_over_ranks(mean)
                epoch_loss = float(mean)
            epoch_loss_values.append(epoch_loss)
            logger.info("epoch %d average loss: %.4f", epoch + 1, epoch_loss)

            if (epoch + 1) % cfg.val_interval == 0:
                metric_sum, val_loss, n_val = 0.0, 0.0, 0
                for val_batch in val_loader:
                    image, label, _ = self._device_batch(val_batch)
                    loss, dice = eval_step(image, label)
                    metric_sum += float(dice)
                    val_loss += float(loss)
                    n_val += 1
                metric = metric_sum / max(n_val, 1)
                val_loss /= max(n_val, 1)
                if self.ranks is not None:
                    metric, val_loss = distributed.floats_from_rank0(
                        (metric, val_loss), self.device)
                metric_values.append(metric)
                if self.tb_writer is not None:
                    self.tb_writer.add_scalars(
                        "Loss Train/Val",
                        {"train": epoch_loss, "val": val_loss}, epoch)
                    self.tb_writer.add_scalar("Dice Score Val", metric,
                                              epoch)
                if metric > best_metric:
                    best_metric, best_metric_epoch = metric, epoch + 1
                    self._save(state, epoch + 1, best_metric,
                               best_metric_epoch, "best_metric_model.ckpt")
                    logger.info("saved new best metric model")
                logger.info(
                    "current epoch %d current mean dice: %.4f "
                    "best mean dice: %.4f at epoch %d", epoch + 1, metric,
                    best_metric, best_metric_epoch)

        logger.info("Train completed, best_metric: %.4f  at epoch: %d",
                    best_metric, best_metric_epoch)
        self._save(state, cfg.num_epochs, best_metric, best_metric_epoch,
                   "last_epoch_model.ckpt")
        logger.info("Saved model of the last epoch at: %s",
                    os.path.join(cfg.model_path, "last_epoch_model.ckpt"))
        state = dict(state, epoch=cfg.num_epochs, best_metric=best_metric,
                     best_metric_epoch=best_metric_epoch)
        return state, epoch_loss_values, metric_values

    def _save(self, state, epoch: int, best_metric: float,
              best_metric_epoch: int, name: str) -> None:
        if not self.rank0:
            return
        save_checkpoint(os.path.join(self.cfg.model_path, name), {
            "model": state["model"].state_dict(),
            "optimizer": state["optimizer"].state_dict(),
            "generator": state["generator"].get_state(),
            "epoch": epoch, "best_metric": best_metric,
            "best_metric_epoch": best_metric_epoch})

    def restore_state(self, path: str) -> Dict[str, Any]:
        """A checkpoint back into a training state (true resume): weights,
        BatchNorm statistics, Adam moments, counters, and the generator.
        The kind is told apart by content, as load_model_state does: the
        port's torch.save archive (`_save`) or the JAX package's msgpack
        state (`_restore_jax`)."""
        if checkpoint_kind(path) == "jax":
            return self._restore_jax(path)
        raw = load_checkpoint(path)
        self.model.load_state_dict(raw["model"], strict=True)
        state = self.init_state()
        state["optimizer"].load_state_dict(raw["optimizer"])
        state["generator"].set_state(raw["generator"])
        state.update(epoch=int(raw["epoch"]),
                     best_metric=float(raw["best_metric"]),
                     best_metric_epoch=int(raw["best_metric_epoch"]))
        return state

    def _restore_jax(self, path: str) -> Dict[str, Any]:
        """A vs_seg_tpu training checkpoint: parameters, BatchNorm
        statistics and the Adam state through load_jax_train_state. JAX's
        rbg dropout key cannot seed a torch.Generator, so the generator is
        seeded from cfg.seed.

        A legacy checkpoint, written before vs_seg_tpu flattened its
        optimizer, holds per-parameter `mu`/`nu` trees: they are converted
        as vs_seg_tpu/train/trainer.py:restore_state converts them, with a
        warning; where that fails (ValueError, KeyError, TypeError) a
        second warning says so and the optimizer starts afresh on the
        checkpoint's weights, as there."""
        raw = jax_ckpt.load_jax_checkpoint(path)
        adam = raw["opt_state"].get("inner_state", {}).get("1", {})
        state = self.init_state()
        if isinstance(adam.get("mu"), dict):
            self.logger.warning(
                "checkpoint %s has a legacy (unflattened) opt_state; "
                "converting Adam moments to the flattened layout", path)
            try:
                scalars = load_jax_train_state(
                    self.model, state["optimizer"], raw,
                    moments=legacy_adam_moments)
            except (ValueError, KeyError, TypeError) as e:
                self.logger.warning(
                    "legacy opt_state conversion failed (%s); "
                    "re-initializing the optimizer state - Adam moments "
                    "reset", e)
                # the optimizer is still fresh (load_jax_train_state sets
                # no state before every moment was read); the weights load
                # on their own
                load_jax_variables(self.model, {
                    "params": raw["params"],
                    "batch_stats": raw.get("batch_stats", {})})
                scalars = {k: float(np.asarray(raw[k])) for k in
                           ("epoch", "best_metric", "best_metric_epoch")}
        else:
            scalars = load_jax_train_state(self.model, state["optimizer"],
                                           raw)
        self.logger.info(
            "resumed from the JAX checkpoint %s; its dropout key does not "
            "carry over, the dropout generator is seeded from seed = %d",
            path, self.cfg.seed)
        state.update(epoch=int(scalars["epoch"]),
                     best_metric=float(scalars["best_metric"]),
                     best_metric_epoch=int(scalars["best_metric_epoch"]))
        return state
