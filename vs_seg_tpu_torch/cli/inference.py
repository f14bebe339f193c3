"""Inference entry point of the port: the counterpart of VS_inference.py,
with the same flags plus --device and --routes (core/config.py).

    python -m vs_seg_tpu_torch.cli.inference --data_root ROOT --split CSV \\
        [--routes dsconv] [--device cuda:0 | --device cpu]

Flow: flags -> logger -> split CSV -> test transforms -> cached test loader
-> model -> weights (train/checkpoint.py:load_model_state: the port's
torch.save checkpoint, a JAX msgpack .ckpt or a reference .pth) ->
sliding-window inference + Dice + NIFTI export + figures
(infer/engine.py:run_inference). The device defaults to cuda; a missing card
is an error, never a move to the CPU.
"""

from __future__ import annotations

import argparse

import torch

from vs_seg_tpu_torch.core.config import (add_reference_cli_flags,
                                          config_from_args)
from vs_seg_tpu_torch.core.device import resolve_device
from vs_seg_tpu_torch.core.runlog import (create_results_folders,
                                          log_parameters, set_up_logger)
from vs_seg_tpu_torch.data.dataset import (CacheDataset, DataLoader,
                                           load_split_csv)
from vs_seg_tpu_torch.data.transforms import get_transforms
from vs_seg_tpu_torch.infer.engine import run_inference
from vs_seg_tpu_torch.models import build_model
from vs_seg_tpu_torch.train.checkpoint import load_model_state


def main(argv=None, make_figures: bool = True):
    """Run the CLI on `argv` (sys.argv when None); returns (dice_scores,
    compute seconds per volume) from run_inference."""
    parser = argparse.ArgumentParser(
        description="Segment the test split of a dataset with the trained "
                    "configured model (UNet2d5_spvPA) (PyTorch + CUDA)")
    add_reference_cli_flags(parser)
    cfg = config_from_args(parser.parse_args(argv))
    device = resolve_device(cfg.device)

    create_results_folders(cfg)
    logger = set_up_logger(cfg, "test_log.txt")
    log_parameters(cfg, logger)

    _, _, test_files = load_split_csv(cfg.split_csv, cfg.dataset,
                                      cfg.data_root)
    logger.info("Number of images in test set = %d", len(test_files))
    _, _, test_t = get_transforms(cfg.pad_crop_shape_test)
    logger.info("Caching test data set...")
    test_ds = CacheDataset(test_files, test_t, num_workers=cfg.num_workers)
    test_loader = DataLoader(test_ds, batch_size=1)

    model = build_model(cfg, device=device,
                        generator=torch.Generator().manual_seed(cfg.seed))
    kind = load_model_state(cfg, model)
    logger.info("loaded the %s checkpoint under %s", kind, cfg.model_path)
    return run_inference(cfg, model, test_loader, device=device,
                         logger=logger, make_figures=make_figures)


if __name__ == "__main__":
    main()
