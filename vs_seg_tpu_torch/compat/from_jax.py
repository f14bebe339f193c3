"""JAX variables -> the port's state: the counterpart of
vs_seg_tpu/compat/torch_import.py.

The JAX package keeps a model's state as `{"params": ..., "batch_stats":
...}`, nested dicts of arrays keyed by module name (down_0 -> unit0 -> conv
-> kernel, ..., down_0 -> unit0 -> norm -> mean). The port's modules carry
the same names and the same parameter shapes, so each leaf maps to the
state_dict entry at its dotted path. The conversion is strict, as
torch_import.py's _TrackingDict check of full consumption is: every leaf must
land on a model entry, and every model entry must be given, or it raises.
`load_jax_train_state` carries a whole JAX training state (with the Adam
moments, flattened or, from a legacy checkpoint, per-parameter trees) into
a model and its torch optimizer.
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


def _param_order(model: nn.Module):
    """The model's (name, parameter) pairs in the JAX params tree's leaf
    order: nested dicts flatten with their keys sorted at every level, so
    the order is that of the dotted names split into components."""
    return sorted(model.named_parameters(),
                  key=lambda kv: tuple(kv[0].split(".")))


def flat_adam_moments(adam: Mapping, named: Dict[str, torch.Tensor]):
    """({name: mu}, {name: nu}) from the Adam state of vs_seg_tpu's
    optax.flatten optimizer: one `mu` and one `nu` vector each, in
    ravel_pytree order (`named`'s order), sliced per parameter."""
    mu = np.asarray(adam["mu"], np.float32).reshape(-1)
    nu = np.asarray(adam["nu"], np.float32).reshape(-1)
    total = sum(p.numel() for p in named.values())
    if mu.size != total or nu.size != total:
        raise ValueError(f"Adam moments hold {mu.size}/{nu.size} values, the "
                         f"model has {total} parameters")
    out = ({}, {})
    off = 0
    for name, p in named.items():
        k = p.numel()
        for d, v in zip(out, (mu, nu)):
            d[name] = v[off:off + k].reshape(tuple(p.shape))
        off += k
    return out


def legacy_adam_moments(adam: Mapping, named: Dict[str, torch.Tensor]):
    """({name: mu}, {name: nu}) from a legacy Adam state (vs_seg_tpu before
    optax.flatten): `mu` and `nu` are trees shaped like the params, so each
    leaf's dotted path names its parameter. Raises KeyError for a leaf
    missing or left over and ValueError for a shape that differs."""
    out = []
    for key in ("mu", "nu"):
        flat: Dict[str, np.ndarray] = {}
        _flatten(adam[key], "", flat)
        if set(flat) != set(named):
            raise KeyError(
                f"legacy Adam {key} does not match the model: missing "
                f"{sorted(set(named) - set(flat))[:8]}, left over "
                f"{sorted(set(flat) - set(named))[:8]}")
        for name, p in named.items():
            if flat[name].shape != tuple(p.shape):
                raise ValueError(f"legacy Adam {key}[{name}] has shape "
                                 f"{flat[name].shape}, the parameter "
                                 f"{tuple(p.shape)}")
        out.append({k: np.asarray(v, np.float32) for k, v in flat.items()})
    return tuple(out)


def load_jax_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                         state: Mapping, moments=flat_adam_moments
                         ) -> Dict[str, float]:
    """Carry a JAX training state into `model` and its torch.optim.Adam
    `optimizer`, in place.

    `state` holds numpy arrays only: "params" and "batch_stats" as for
    load_jax_variables, and "opt_state" in the form flax's to_state_dict
    gives (the form vs_seg_tpu checkpoints store) of the optimizer that
    vs_seg_tpu/train/trainer.py:make_optimizer builds: inject_hyperparams
    over optax.flatten, so the Adam moments are single `mu`/`nu` vectors in
    ravel_pytree order (`flat_adam_moments`); `moments=legacy_adam_moments`
    reads a legacy state's per-parameter trees instead. They become each
    parameter's exp_avg / exp_avg_sq; `step` is the Adam count and the
    learning rate the injected hyperparameter. The optimizer's state is set
    only once every moment was read. Returns the scalars of the state that
    are not tensors (epoch, best_metric, best_metric_epoch) where
    present."""
    load_jax_variables(model, {"params": state["params"],
                               "batch_stats": state.get("batch_stats", {})})
    opt = state["opt_state"]
    adam = opt["inner_state"]["1"]
    named = dict(_param_order(model))
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if owned != {id(p) for p in named.values()}:
        raise ValueError("the optimizer does not hold exactly the model's "
                         "parameters")
    mu, nu = moments(adam, named)
    step = float(np.asarray(adam["count"]))
    lr = float(np.asarray(opt["hyperparams"]["learning_rate"]))
    for name, p in named.items():
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": torch.from_numpy(mu[name].copy()).to(p.device),
            "exp_avg_sq": torch.from_numpy(nu[name].copy()).to(p.device)}
    for group in optimizer.param_groups:
        group["lr"] = lr
    return {k: float(np.asarray(state[k])) for k in
            ("epoch", "best_metric", "best_metric_epoch") if k in state}
