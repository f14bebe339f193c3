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
-> TensorBoard writer (skipped without tensorboardX; figures are skipped
without matplotlib) -> Trainer ->
--resume from <model>/last_epoch_model.ckpt (the port's checkpoint or a
JAX one, a legacy one included) -> fit -> loss and Dice curves. Training
runs through the hand-written kernels. The device defaults to cuda; a
missing card is an error, never a move to the CPU.

Data-parallel training (parallel/distributed.py), VS_train.py:43-66's
counterpart, takes no flag of its own:
  - under torchrun (python -m torch.distributed.run --nproc_per_node N
    -m vs_seg_tpu_torch.cli.train ...) every rank joins the process group,
    takes its device (`--device cuda`: cuda:LOCAL_RANK, NCCL; `--device
    cuda:i`: card i for every rank, gloo; `--device cpu`: gloo) and, across
    nodes, its node's share of the training files;
  - run plainly with `--device cuda` on a host with several visible GPUs,
    it launches one rank per GPU itself (distributed.launch), as JAX's
    plain `python VS_train.py` trains on every local device.
Each rank trains on its rows of every batch; rank 0 alone writes the log
file, the parameter dump, the figures, TensorBoard and the checkpoints.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

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
from vs_seg_tpu_torch.parallel import distributed
from vs_seg_tpu_torch.train.trainer import Trainer


def local_gpus(device) -> int:
    """The ranks a plain run takes: every visible GPU for `cuda` with no
    index, else 1."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def _rank_main(argv, make_figures):
    """One launched rank: main's epoch losses and validation Dice values."""
    return main(argv, make_figures)[1:]


def main(argv=None, make_figures: Optional[bool] = None):
    """Run the CLI on `argv` (sys.argv when None); returns (state, epoch
    losses, validation Dice values) of Trainer.fit (rank 0's losses and
    values, and no state, where it launched the ranks itself). Figures
    are drawn when `make_figures`, by default when matplotlib is
    installed."""
    parser = argparse.ArgumentParser(
        description="Train the configured model (UNet2d5_spvPA) on the "
                    "training split of a dataset (PyTorch + CUDA)")
    add_reference_cli_flags(parser)
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = config_from_args(parser.parse_args(argv))
    n = local_gpus(cfg.device)
    if n > 1 and "RANK" not in os.environ:
        losses, metrics = distributed.launch(_rank_main, n, argv,
                                             make_figures)[0]
        return None, losses, metrics
    ranks = distributed.initialize(cfg.device)
    try:
        return train(cfg, ranks, make_figures)
    finally:
        distributed.shutdown()


def train(cfg, ranks, make_figures: Optional[bool] = None):
    """The flow above on this process's rank (`ranks` None: one process)."""
    rank0 = ranks is None or ranks.rank == 0
    if make_figures is None:
        make_figures = figures.available()
    device = resolve_device(cfg.device) if ranks is None else ranks.device
    if rank0:
        create_results_folders(cfg)
        logger = set_up_logger(cfg, "training_log.txt")
        log_parameters(cfg, logger)
        if not make_figures:
            logger.info("figures off (make_figures=False or no matplotlib)")
    else:
        logger = logging.getLogger(f"{__name__}.rank{ranks.rank}")
        logger.setLevel(logging.WARNING)

    train_files, val_files, _ = load_split_csv(cfg.split_csv, cfg.dataset,
                                               cfg.data_root)
    if ranks is not None:
        logger.info("data parallel: %d ranks on %d node(s), %s backend",
                    ranks.world, ranks.nnodes, ranks.backend)
        if ranks.nnodes > 1:
            train_files = distributed.shard_files_for_process(
                train_files, ranks.node, ranks.nnodes)
            logger.info("multi-node: node %d/%d holds %d training cases",
                        ranks.node, ranks.nnodes, len(train_files))
    logger.info("Number of images in training set   = %d", len(train_files))
    logger.info("Number of images in validation set = %d", len(val_files))
    train_t, val_t, _ = get_transforms(cfg.pad_crop_shape)

    # transform sanity figure (reference VSparams.py:266-297)
    if rank0:
        check = val_t(dict(val_files[0]), np.random.default_rng(cfg.seed))
        logger.info("Validation image shape = %s", check["image"].shape)
        if make_figures:
            figures.save_transform_check(check["image"][0],
                                         check["label"][0], cfg.figures_path)

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
            batch_size=cfg.train_batch_size, shuffle=True, seed=cfg.seed,
            ranks=ranks)
        val_loader = DeviceLoader(
            DeviceCachedDataset(val_ds.cache, cfg.pad_crop_shape,
                                device=device, augment=False),
            batch_size=1, seed=cfg.seed + 1)
    else:
        train_loader = DataLoader(train_ds, batch_size=cfg.train_batch_size,
                                  shuffle=True, seed=cfg.seed,
                                  prefetch=2, ranks=ranks)
        val_loader = DataLoader(val_ds, batch_size=1)

    logger.info("Setting up the model type...")
    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))
    tb_writer = None
    if rank0:
        try:
            from tensorboardX import SummaryWriter
            tb_writer = SummaryWriter()
        except ImportError:
            logger.info("tensorboardX unavailable; skipping TB logging")

    trainer = Trainer(cfg, model, device, logger=logger, tb_writer=tb_writer,
                      ranks=ranks)
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

    if make_figures and rank0:
        figures.save_loss_and_dice_curves(epoch_loss_values, metric_values,
                                          cfg.val_interval, cfg.figures_path)
    return state, epoch_loss_values, metric_values


if __name__ == "__main__":
    main()
