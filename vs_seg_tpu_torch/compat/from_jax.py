"""JAX variables -> the port's state: the counterpart of
vs_seg_tpu/compat/torch_import.py.

The JAX package keeps a model's state as `{"params": ..., "batch_stats":
...}`, nested dicts of arrays keyed by module name (down_0 -> unit0 -> conv
-> kernel, ..., down_0 -> unit0 -> norm -> mean). The port's modules carry
the same names and the same parameter shapes, so each leaf maps to the
state_dict entry at its dotted path. The conversion is strict, as
torch_import.py's _TrackingDict check of full consumption is: every leaf must
land on a model entry, and every model entry must be given, or it raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            _flatten(val, path, out)
        else:
            out[path] = np.asarray(val)


def jax_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flatten {"params", "batch_stats"} into dotted keys -> f32 tensors."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unexpected variable collections: {sorted(extra)}")
    flat: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        part: Dict[str, np.ndarray] = {}
        _flatten(variables.get(coll, {}), "", part)
        clash = set(part) & set(flat)
        if clash:
            raise ValueError(f"keys in both params and batch_stats: "
                             f"{sorted(clash)[:8]}")
        flat.update(part)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flat.items()}


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy JAX `variables` into `model` in place (on the model's device);
    raises on any key the model does not use or leaves missing, and on any
    shape that differs."""
    sd = jax_state_dict(variables)
    expected = model.state_dict()
    unexpected = sorted(set(sd) - set(expected))
    missing = sorted(set(expected) - set(sd))
    if unexpected or missing:
        raise KeyError(
            f"JAX variables do not match the model: {len(unexpected)} "
            f"unused key(s) {unexpected[:8]}, {len(missing)} missing key(s) "
            f"{missing[:8]}")
    bad = [(k, tuple(sd[k].shape), tuple(v.shape))
           for k, v in expected.items()
           if tuple(sd[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"shape mismatch (key, jax, model): {bad[:8]}")
    model.load_state_dict(sd, strict=True)
    return model
