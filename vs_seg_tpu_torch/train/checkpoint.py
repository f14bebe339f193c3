"""Full-state checkpoints: the counterpart of vs_seg_tpu/train/checkpoint.py,
and `load_model_state`, which gives a model its weights for inference as
VS_inference.py:load_model_state does.

A checkpoint is the whole training state -- model state_dict (parameters and
BatchNorm running statistics), Adam state, the dropout generator's state,
epoch and best metric -- so a run can resume where it stopped. It is written
with torch.save to `<path>.tmp` and renamed over `path`, so a crash never
leaves a half-written checkpoint under the real name. In a data-parallel run
rank 0 alone writes (train/trainer.py:Trainer._save, as
vs_seg_tpu/train/trainer.py:369 has process 0 write), and every rank reads
the same file back on resume.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn

from vs_seg_tpu_torch.compat import jax_ckpt, torch_import
from vs_seg_tpu_torch.compat.from_jax import load_jax_variables

ZIP_MAGIC = b"PK\x03\x04"   # torch.save writes a zip archive


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The saved dict, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def checkpoint_kind(path: str) -> str:
    """"torch" (a torch.save zip archive) or "jax" (a flax msgpack map),
    told apart by content, never by name; anything else raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == ZIP_MAGIC:
        return "torch"
    if jax_ckpt.is_msgpack_map(head):
        return "jax"
    raise ValueError(f"{path}: neither a torch.save archive nor a flax "
                     f"msgpack checkpoint (starts {head!r})")


def load_model_state(cfg, model: nn.Module) -> str:
    """Load the inference weights under cfg.model_path into `model`, in
    place; returns the kind read: "torch" or "jax" (best_metric_model.ckpt)
    or "pth" (best_metric_model.pth, a reference state_dict).

    The port's trainer and the JAX trainer both write best_metric_model.ckpt,
    as torch.save and as flax msgpack; the two are told apart by content (a
    zip archive or a msgpack map), never by name. Every loader is strict: a
    tree that does not fit the configured model raises. Raises
    FileNotFoundError when neither file is there."""
    ckpt_path = os.path.join(cfg.model_path, "best_metric_model.ckpt")
    pth_path = os.path.join(cfg.model_path, "best_metric_model.pth")
    if os.path.exists(ckpt_path):
        kind = checkpoint_kind(ckpt_path)
        if kind == "torch":
            model.load_state_dict(load_checkpoint(ckpt_path)["model"],
                                  strict=True)
        else:
            state = jax_ckpt.load_jax_checkpoint(ckpt_path)
            load_jax_variables(model, {
                "params": state["params"],
                "batch_stats": state.get("batch_stats", {})})
        return kind
    if os.path.exists(pth_path):
        params, stats = torch_import.import_unet2d5_spvpa(
            torch_import.load_pth(pth_path), channels=tuple(cfg.channels),
            num_res_units=cfg.num_res_units, attention=cfg.attention)
        load_jax_variables(model, {"params": params, "batch_stats": stats})
        return "pth"
    raise FileNotFoundError(f"no checkpoint under {cfg.model_path}")
