"""The inputs of a run, made from its seed: the weights (reference.py's
make_weights), a pool of cases, and the order in which they are sent.

A case is an MRI-like volume and its label: a smooth random field with
fine noise, a brighter box where the tumour is, normalised to zero mean and
unit variance as the reference's NormalizeIntensity leaves it, and a
binary label of that box. Every case of a traffic mix has the same shape
and the same box size, so every seed gives the same work; the seed moves
the fields, the noise and the box.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

# streams drawn from one run seed: each purpose its own
WEIGHTS, CASES, ORDER = 0, 1, 2


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for `purpose`, independent of the others."""
    state = np.random.SeedSequence([int(seed), purpose]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def make_cases(traffic: dict, seed: int, device) -> List[Dict[str, object]]:
    """traffic["pool"] cases, each {"image", "label": (1, 1, H, W, D)
    float32 host arrays, "affine": (4, 4)}, made on `device` in a few calls
    and copied to the host once."""
    h, w, d = (int(v) for v in traffic["volume"])
    bh, bw, bd = (int(v) for v in traffic["tumour_box"])
    n = int(traffic["pool"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              CASES))
    coarse = torch.randn((n, 1, d // 4, h // 8, w // 8), generator=gen,
                         device=device)
    field = F.interpolate(coarse, size=(d, h, w), mode="trilinear",
                          align_corners=False)
    field += 0.3 * torch.randn((n, 1, d, h, w), generator=gen,
                               device=device)
    corner = torch.rand((n, 3), generator=gen, device=device).cpu().numpy()
    label = torch.zeros_like(field)
    for i in range(n):
        z0 = int(corner[i, 0] * (d - bd))
        y0 = int(corner[i, 1] * (h - bh))
        x0 = int(corner[i, 2] * (w - bw))
        label[i, 0, z0:z0 + bd, y0:y0 + bh, x0:x0 + bw] = 1.0
    image = field + 2.0 * label
    mean = image.mean((1, 2, 3, 4), keepdim=True)
    std = image.std((1, 2, 3, 4), keepdim=True)
    image = (image - mean) / std
    # (N, 1, D, H, W) -> (N, 1, H, W, D), the loaders' order
    image = image.permute(0, 1, 3, 4, 2).contiguous().cpu().numpy()
    label = label.permute(0, 1, 3, 4, 2).contiguous().cpu().numpy()
    affine = np.diag([*(float(v) for v in traffic["spacing_mm"]), 1.0])
    return [{"image": image[i:i + 1], "label": label[i:i + 1],
             "affine": affine} for i in range(n)]


def case_order(n_pool: int, seed: int, count: int) -> np.ndarray:
    """The pool index of each of `count` cases: the pool in a seeded order,
    again and again, so that every case of the pool is sent as often."""
    rng = np.random.default_rng(sub_seed(seed, ORDER))
    reps = -(-count // n_pool)
    return np.concatenate([rng.permutation(n_pool)
                           for _ in range(reps)])[:count]

