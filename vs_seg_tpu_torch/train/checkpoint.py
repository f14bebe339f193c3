"""Full-state checkpoints: the counterpart of vs_seg_tpu/train/checkpoint.py.

A checkpoint is the whole training state -- model state_dict (parameters and
BatchNorm running statistics), Adam state, the dropout generator's state,
epoch and best metric -- so a run can resume where it stopped. It is written
with torch.save to `<path>.tmp` and renamed over `path`, so a crash never
leaves a half-written checkpoint under the real name.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The saved dict, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
