"""Training entry point of the port: the counterpart of VS_train.py, with the
same flags plus --device and --routes (core/config.py).

    python -m vs_seg_tpu_torch.cli.train --data_root ROOT --split CSV \\
        [--device_cache] [--resume] [--remat] [--profile_steps N] \\
        [--device cuda:0 | --device cpu]

Flow (VS_train.py:38-119): flags -> results folders -> log -> parameter
dump -> split CSV -> transforms -> transform-check figure -> cached
datasets -> loaders (host: DataLoader with prefetch; --device_cache:
DeviceLoader over the training and validation sets cached on the device)
-> model (cfg.model, UNet2d5_spvPA unless the configuration names
UNet2d5 or UNet; --remat rematerialises its levels 0-1 in the backward)
-> TensorBoard writer (skipped without tensorboardX) -> Trainer ->
--resume from <model>/last_epoch_model.ckpt (the port's checkpoint or a
JAX one, a legacy one included) -> fit -> loss and Dice curves. Training
runs through the hand-written kernels. The device defaults to cuda; a
missing card is an error, never a move to the CPU. Multi-host training is
not ported.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from vs_seg_tpu_torch.core.config import (add_reference_cli_flags,
                                          config_from_args)
from vs_seg_tpu_torch.core.device import resolve_device
from vs_seg_tpu_torch.core.runlog import (create_results_folders,
                                          log_parameters, set_up_logger)
from vs_seg_tpu_torch.data.dataset import (CacheDataset, DataLoader,
                                           load_split_csv)
from vs_seg_tpu_torch.data.device_pipeline import (DeviceCachedDataset,
                                                   DeviceLoader)
from vs_seg_tpu_torch.data.transforms import get_transforms
from vs_seg_tpu_torch.eval import figures
from vs_seg_tpu_torch.models import build_model
from vs_seg_tpu_torch.train.trainer import Trainer


def main(argv=None, make_figures: bool = True):
    """Run the CLI on `argv` (sys.argv when None); returns (state, epoch
    losses, validation Dice values) of Trainer.fit."""
    parser = argparse.ArgumentParser(
        description="Train the configured model (UNet2d5_spvPA) on the "
                    "training split of a dataset (PyTorch + CUDA)")
    add_reference_cli_flags(parser)
    cfg = config_from_args(parser.parse_args(argv))
    device = resolve_device(cfg.device)

    create_results_folders(cfg)
    logger = set_up_logger(cfg, "training_log.txt")
    log_parameters(cfg, logger)

    train_files, val_files, _ = load_split_csv(cfg.split_csv, cfg.dataset,
                                               cfg.data_root)
    logger.info("Number of images in training set   = %d", len(train_files))
    logger.info("Number of images in validation set = %d", len(val_files))
    train_t, val_t, _ = get_transforms(cfg.pad_crop_shape)

    # transform sanity figure (reference VSparams.py:266-297)
    check = val_t(dict(val_files[0]), np.random.default_rng(cfg.seed))
    logger.info("Validation image shape = %s", check["image"].shape)
    if make_figures:
        figures.save_transform_check(check["image"][0], check["label"][0],
                                     cfg.figures_path)

    logger.info("Caching training data set...")
    train_ds = CacheDataset(train_files, train_t, num_workers=cfg.num_workers)
    logger.info("Caching validation data set...")
    val_ds = CacheDataset(val_files, val_t, num_workers=cfg.num_workers)
    if cfg.device_cache:
        logger.info("Uploading the training and validation sets to the "
                    "device (crop and flip on the device)")
        train_loader = DeviceLoader(
            DeviceCachedDataset(train_ds.cache, cfg.pad_crop_shape,
                                device=device),
            batch_size=cfg.train_batch_size, shuffle=True, seed=cfg.seed)
        val_loader = DeviceLoader(
            DeviceCachedDataset(val_ds.cache, cfg.pad_crop_shape,
                                device=device, augment=False),
            batch_size=1, seed=cfg.seed + 1)
    else:
        train_loader = DataLoader(train_ds, batch_size=cfg.train_batch_size,
                                  shuffle=True, seed=cfg.seed,
                                  prefetch=2)
        val_loader = DataLoader(val_ds, batch_size=1)

    logger.info("Setting up the model type...")
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))
    tb_writer = None
    try:
        from tensorboardX import SummaryWriter
        tb_writer = SummaryWriter()
    except ImportError:
        logger.info("tensorboardX unavailable; skipping TB logging")

    trainer = Trainer(cfg, model, device, logger=logger, tb_writer=tb_writer)
    resume_path = os.path.join(cfg.model_path, "last_epoch_model.ckpt")
    if cfg.resume and os.path.exists(resume_path):
        logger.info("Resuming full training state from %s", resume_path)
        state = trainer.restore_state(resume_path)
    else:
        state = trainer.init_state()
    state, epoch_loss_values, metric_values = trainer.fit(
        state, train_loader, val_loader)
    if tb_writer is not None:
        tb_writer.close()

    if make_figures:
        figures.save_loss_and_dice_curves(epoch_loss_values, metric_values,
                                          cfg.val_interval, cfg.figures_path)
    return state, epoch_loss_values, metric_values


if __name__ == "__main__":
    main()
