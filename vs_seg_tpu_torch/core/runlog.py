"""Logging and the results-folder layout: the port's copy of
vs_seg_tpu/core/runlog.py (the reference artifact tree):
  <results>/logs/    text logs
  <results>/model/   checkpoints
  <results>/figures/ PNG artifacts
In a data-parallel run rank 0 alone makes the folders, the log file and the
parameter dump (cli/train.py).
"""

from __future__ import annotations

import dataclasses
import logging
import os


def create_results_folders(cfg) -> None:
    for path in (cfg.logs_path, cfg.model_path, cfg.figures_path):
        if not os.path.exists(path):
            os.makedirs(path, exist_ok=True)
            try:
                os.chmod(path, 0o777)
            except OSError:
                pass


def set_up_logger(cfg, log_file_name: str) -> logging.Logger:
    """The root logger, writing to <logs>/<log_file_name> and the console;
    handlers of an earlier call are closed and dropped."""
    logger = logging.getLogger()
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    file_handler = logging.FileHandler(
        os.path.join(cfg.logs_path, log_file_name), mode="w")
    console_handler = logging.StreamHandler()
    formatter = logging.Formatter("%(asctime)s %(levelname)s        %(message)s")
    file_handler.setFormatter(formatter)
    console_handler.setFormatter(formatter)
    logger.addHandler(file_handler)
    logger.addHandler(console_handler)
    logger.setLevel(logging.INFO)
    logger.info("Created " + log_file_name)
    return logger


def log_parameters(cfg, logger: logging.Logger) -> None:
    """Full hyperparameter dump at start."""
    logger.info("-" * 10)
    logger.info("Parameters: ")
    for field in dataclasses.fields(cfg):
        value = getattr(cfg, field.name)
        logger.info("%s = %s" % (field.name.ljust(34), value))
    logger.info("results_folder_path =              %s" % cfg.results_folder_path)
    logger.info("-" * 10)
