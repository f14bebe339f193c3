"""Training loop: the counterpart of vs_seg_tpu/train/trainer.py (single
device).

  - Adam with torch's coupled L2 weight decay (decay added to the gradient
    before the moments; betas 0.9/0.999, eps 1e-8), on every parameter; the
    BatchNorm running statistics are buffers and take no decay;
  - one train step = train-mode forward (batch-stat BatchNorm, dropout from
    the explicit generator, the (3,3,3) convs' hand-written backward),
    dice_spvpa_loss, backward, Adam step;
  - validation every `val_interval` epochs with the eval forward (the eval
    kernels), loss and hard Dice; best and last checkpoints;
  - the learning rate divided by `lr_divisor` every `epochs_with_const_lr`
    epochs.

The state is a dict: {"model", "optimizer", "generator", "epoch",
"best_metric", "best_metric_epoch"}; the model and optimizer hold the
tensors. Multi-GPU, the on-device data cache, profiling and legacy
optimizer-state migration are not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vs_seg_tpu_torch.core.device import DTYPES, resolve_device
from vs_seg_tpu_torch.eval.metrics import dice_score
from vs_seg_tpu_torch.losses.dice import dice_spvpa_loss
from vs_seg_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint


def make_optimizer(params: Iterable[torch.Tensor], learning_rate: float,
                   weight_decay: float) -> torch.optim.Adam:
    """torch.optim.Adam: the update of vs_seg_tpu's optax chain
    (add_decayed_weights -> scale_by_adam -> -lr)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def _loss(output, label, supervised_attention: bool, hardness: bool):
    logits, atts = output
    return dice_spvpa_loss(logits, atts, label,
                           supervised_attention=supervised_attention,
                           hardness_weighting=hardness)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                    supervised_attention: bool, hardness: bool,
                    use_kernels: bool = True) -> Callable:
    """(image, label, generator) -> loss (a device scalar, not synced).
    Updates the model's parameters, BatchNorm statistics and the optimizer in
    place."""

    def step(image, label, generator):
        label = label.float()            # may arrive uint8
        optimizer.zero_grad(set_to_none=True)
        output = model(image, use_kernels=use_kernels, train=True,
                       generator=generator)
        loss = _loss(output, label, supervised_attention, hardness)
        loss.backward()
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
            return loss, dice_score(output[0].float(), label)

    return step


def to_device_batch(batch, device, image_dtype=None):
    """(B, C, H, W, D) host batch -> (B, D, H, W, C) tensors on `device`.
    Images are cast on the host to `image_dtype`; labels that are exact in
    uint8 travel as uint8 and the steps cast them on the device."""
    image = np.ascontiguousarray(np.transpose(batch["image"], (0, 4, 2, 3, 1)))
    label = np.ascontiguousarray(np.transpose(batch["label"], (0, 4, 2, 3, 1)))
    if label.dtype != np.uint8:
        cast = label.astype(np.uint8)
        if np.array_equal(cast, label):
            label = cast
    img = torch.from_numpy(image)
    if image_dtype is not None:
        img = img.to(image_dtype)
    return (img.to(device, non_blocking=True),
            torch.from_numpy(label).to(device, non_blocking=True))


class Trainer:
    """Trainer(cfg, model, device).init_state() -> fit(state, train_loader,
    val_loader). Loaders yield dicts of numpy (B, C, H, W, D) "image" and
    "label". `use_kernels=False` runs the all-plain path."""

    def __init__(self, cfg, model: nn.Module, device,
                 logger: Optional[logging.Logger] = None,
                 use_kernels: bool = True):
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger()
        self.use_kernels = use_kernels
        self._transfer_dtype = DTYPES[cfg.compute_dtype]

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

    def fit(self, state: Dict[str, Any], train_loader, val_loader
            ) -> Tuple[Dict[str, Any], list, list]:
        cfg, logger = self.cfg, self.logger
        model, optimizer = state["model"], state["optimizer"]
        gen = state["generator"]
        train_step = make_train_step(
            model, optimizer, supervised_attention=cfg.attention,
            hardness=cfg.hardness, use_kernels=self.use_kernels)
        eval_step = make_eval_step(
            model, supervised_attention=cfg.attention, hardness=cfg.hardness,
            use_kernels=self.use_kernels)
        best_metric = float(state.get("best_metric", -1.0))
        best_metric_epoch = int(state.get("best_metric_epoch", -1))
        start_epoch = int(state.get("epoch", 0))
        logger.info("Running the training loop...")
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
            step_losses = []
            for batch in train_loader:
                image, label = to_device_batch(batch, self.device,
                                               self._transfer_dtype)
                loss = train_step(image, label, gen)
                step_losses.append(loss)      # kept on the device: no sync
                if epoch == start_epoch:
                    logger.info("%d/%d, train_loss: %.4f", len(step_losses),
                                len(train_loader), float(loss))
            epoch_loss = (float(torch.stack(step_losses).mean())
                          if step_losses else 0.0)
            epoch_loss_values.append(epoch_loss)
            logger.info("epoch %d average loss: %.4f", epoch + 1, epoch_loss)

            if (epoch + 1) % cfg.val_interval == 0:
                metric_sum, val_loss, n_val = 0.0, 0.0, 0
                for val_batch in val_loader:
                    image, label = to_device_batch(val_batch, self.device,
                                                   self._transfer_dtype)
                    loss, dice = eval_step(image, label)
                    metric_sum += float(dice)
                    val_loss += float(loss)
                    n_val += 1
                metric = metric_sum / max(n_val, 1)
                metric_values.append(metric)
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
        state = dict(state, epoch=cfg.num_epochs, best_metric=best_metric,
                     best_metric_epoch=best_metric_epoch)
        return state, epoch_loss_values, metric_values

    def _save(self, state, epoch: int, best_metric: float,
              best_metric_epoch: int, name: str) -> None:
        save_checkpoint(os.path.join(self.cfg.model_path, name), {
            "model": state["model"].state_dict(),
            "optimizer": state["optimizer"].state_dict(),
            "generator": state["generator"].get_state(),
            "epoch": epoch, "best_metric": best_metric,
            "best_metric_epoch": best_metric_epoch})

    def restore_state(self, path: str) -> Dict[str, Any]:
        """A checkpoint of `_save` back into a training state (true resume):
        weights, BatchNorm statistics, Adam moments, generator, counters."""
        raw = load_checkpoint(path)
        self.model.load_state_dict(raw["model"], strict=True)
        state = self.init_state()
        state["optimizer"].load_state_dict(raw["optimizer"])
        state["generator"].set_state(raw["generator"])
        state.update(epoch=int(raw["epoch"]),
                     best_metric=float(raw["best_metric"]),
                     best_metric_epoch=int(raw["best_metric_epoch"]))
        return state
