"""Import reference PyTorch checkpoints (.pth state_dicts) as JAX-layout
numpy trees: the port's copy of vs_seg_tpu/compat/torch_import.py (numpy
only). The trees feed compat/from_jax.py:load_jax_variables.

The reference saves bare `model.state_dict()` files with names produced by
the recursive Sequential construction of its unet2d5_spvPA:

  model.0                      down level 0 (ResidualUnit)
  model.1.submodule.0          downsample level 0 (Convolution)
  model.1.submodule.1          next level block (recursion) or bottom
  model.1.submodule.2          upsample level 0 (ConvTranspose Convolution)
  model.2.0.0 / model.2.1      up attention (AttentionBlock1) / up ResidualUnit
  bottom: <p>.1.0.0 attention, <p>.1.1 ResidualUnit

Weight layout conversions:
  Conv3d          (out,in,kh,kw,kd)  -> (kh,kw,kd,in,out)
  ConvTranspose3d (in,out,kh,kw,kd)  -> (kh,kw,kd,in,out)
  BatchNorm weight/bias/running_* -> scale/bias + batch_stats mean/var
  PReLU weight (1,) -> alpha
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _conv_w(t):
    return np.asarray(t).transpose(2, 3, 4, 1, 0)


def _convt_w(t):
    return np.asarray(t).transpose(2, 3, 4, 0, 1)


def _np(t):
    return np.asarray(t, dtype=np.float32)


def _convolution(sd, p, transposed=False, norm=True, act_prelu=True):
    """Params/stats for one MONAI Convolution block at torch prefix `p`."""
    params = {"conv": {"kernel": (_convt_w if transposed else _conv_w)(sd[f"{p}.conv.weight"]),
                       "bias": _np(sd[f"{p}.conv.bias"])}}
    stats = {}
    if norm:
        params["norm"] = {"scale": _np(sd[f"{p}.norm.weight"]),
                          "bias": _np(sd[f"{p}.norm.bias"])}
        stats["norm"] = {"mean": _np(sd[f"{p}.norm.running_mean"]),
                         "var": _np(sd[f"{p}.norm.running_var"])}
    if act_prelu:
        params["act"] = {"alpha": _np(sd[f"{p}.act.weight"])}
    return params, stats


def _resunit(sd, p, subunits, last_conv_only=False):
    params, stats = {}, {}
    for su in range(subunits):
        conv_only = last_conv_only and su == subunits - 1
        sub_p, sub_s = _convolution(sd, f"{p}.conv.unit{su}",
                                    norm=not conv_only, act_prelu=not conv_only)
        params[f"unit{su}"] = sub_p
        if sub_s:
            stats[f"unit{su}"] = sub_s
    if f"{p}.residual.weight" in sd:
        params["residual"] = {"kernel": _conv_w(sd[f"{p}.residual.weight"]),
                              "bias": _np(sd[f"{p}.residual.bias"])}
    return params, stats


def _attention1(sd, p):
    params = {}
    for name in ("conv1", "conv2"):
        sub_p, _ = _convolution(sd, f"{p}.{name}", norm=False, act_prelu=False)
        params[name] = sub_p
    return params, {}


def unet2d5_spvpa_mapping(n_levels: int, attention: bool
                          ) -> List[Tuple[str, str, str]]:
    """(torch_prefix, kind, flax_name) triples for the reference recursion."""
    triples = []

    def block(tp: str, level: int):
        triples.append((f"{tp}.0", "resunitN", f"down_{level}"))
        sp = f"{tp}.1.submodule"
        triples.append((f"{sp}.0", "convolution", f"downsample_{level}"))
        if level < n_levels - 1:
            block(f"{sp}.1", level + 1)
        else:
            if attention:
                triples.append((f"{sp}.1.0.0", "attention1", "bottom_att"))
                triples.append((f"{sp}.1.1", "resunitN", "bottom"))
            else:
                triples.append((f"{sp}.1", "resunitN", "bottom"))
        triples.append((f"{sp}.2", "convolution_t", f"upsample_{level}"))
        up = f"{tp}.2"
        last = level == 0
        if attention:
            triples.append((f"{up}.0.0", "attention1", f"upatt_{level}"))
            triples.append((f"{up}.1", "resunit1" + ("_top" if last else ""),
                            f"up_{level}"))
        else:
            triples.append((up, "resunit1" + ("_top" if last else ""), f"up_{level}"))

    block("model", 0)
    return triples


class _TrackingDict(dict):
    """Records every key read so the importer can verify FULL consumption of
    a checkpoint (the strict missing/unexpected-keys contract torch's
    load_state_dict(strict=True) gives the reference at VSparams.py:547-550)."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.used = set()

    def __getitem__(self, key):
        self.used.add(key)
        return super().__getitem__(key)

    def __contains__(self, key):
        hit = super().__contains__(key)
        if hit:
            self.used.add(key)
        return hit


def import_unet2d5_spvpa(state_dict: Dict[str, "object"],
                         channels=(16, 32, 48, 64, 80, 96),
                         num_res_units: int = 2,
                         attention: bool = True,
                         strict: bool = True):
    """torch state_dict -> ({'params': ...}, {'batch_stats': ...}) numpy pytrees.

    strict=True (default) enforces the same contract as the reference's
    model.load_state_dict (params/VSparams.py:547-550): every checkpoint key
    must be consumed exactly (no unexpected keys) and every expected key must
    exist (a KeyError names the first missing one). torch's
    `num_batches_tracked` counters are metadata our BN semantics don't use
    and are excluded from the unexpected-keys check."""
    sd = _TrackingDict({k: np.asarray(getattr(v, "numpy", lambda: v)())
                        for k, v in state_dict.items()})
    params, stats = {}, {}
    for torch_prefix, kind, flax_name in unet2d5_spvpa_mapping(
            len(channels) - 1, attention):
        try:
            if kind == "convolution":
                p, s = _convolution(sd, torch_prefix)
            elif kind == "convolution_t":
                p, s = _convolution(sd, torch_prefix, transposed=True)
            elif kind == "resunitN":
                p, s = _resunit(sd, torch_prefix, num_res_units)
            elif kind == "resunit1":
                p, s = _resunit(sd, torch_prefix, 1)
            elif kind == "resunit1_top":
                p, s = _resunit(sd, torch_prefix, 1, last_conv_only=True)
            elif kind == "attention1":
                p, s = _attention1(sd, torch_prefix)
            else:
                raise ValueError(kind)
        except KeyError as e:
            raise KeyError(
                f"checkpoint is missing key {e.args[0]!r} (expected for "
                f"{kind} block {flax_name!r} at torch prefix "
                f"{torch_prefix!r}) — wrong architecture flags "
                f"(channels={channels}, num_res_units={num_res_units}, "
                f"attention={attention})?") from None
        params[flax_name] = p
        if s:
            stats[flax_name] = s
    if strict:
        unexpected = sorted(
            k for k in set(sd) - sd.used
            if not k.endswith("num_batches_tracked"))
        if unexpected:
            raise ValueError(
                f"checkpoint has {len(unexpected)} unexpected key(s) not "
                f"mapped to any model parameter: {unexpected[:8]}"
                f"{' ...' if len(unexpected) > 8 else ''}")
    return params, stats


def load_pth(path: str):
    """Load a torch .pth state_dict onto the CPU (tensors only)."""
    import torch
    return torch.load(path, map_location="cpu", weights_only=True)
