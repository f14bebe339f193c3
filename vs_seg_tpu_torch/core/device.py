"""Explicit device selection: the caller names the device, and a CUDA device
that is not there is an error, never a silent move to the CPU. `DTYPES` maps
the configuration's dtype names (compute_dtype, infer_dtype) to torch's."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device) -> torch.device:
    """`device` (str or torch.device) -> torch.device, checked.

    Raises for None (the caller must choose) and for a CUDA device when this
    process has no usable card."""
    if device is None:
        raise ValueError("pass an explicit device ('cpu' or 'cuda[:i]')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available in this process")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {dev} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
