"""Evaluation metrics: the counterpart of vs_seg_tpu/eval/metrics.py.

`dice_score`: argmax -> one-hot -> 1 - Dice(include_background=False), the
reference metric. `segmentation_volume_ml` and `center_of_mass_slice` are
numpy (volumetry and the figures' slice choice).
"""

from __future__ import annotations

import numpy as np
import torch

from vs_seg_tpu_torch.losses.dice import dice_loss, one_hot


def dice_score(predicted_probabilities: torch.Tensor,
               label: torch.Tensor) -> torch.Tensor:
    """Hard Dice of argmax vs label, background excluded. pred (B, *S, C);
    label (B, *S, 1)."""
    n_classes = predicted_probabilities.shape[-1]
    y_pred = one_hot(predicted_probabilities.argmax(-1)[..., None], n_classes)
    return 1.0 - dice_loss(y_pred, label, include_background=False,
                           to_onehot_y=True, softmax=False, reduction="mean")


def segmentation_volume_ml(labelmap, affine) -> float:
    """Segmented volume in millilitres: foreground voxel count x
    |det(affine[:3,:3])| mm^3."""
    voxel_mm3 = abs(float(np.linalg.det(np.asarray(affine)[:3, :3])))
    count = float(np.count_nonzero(np.asarray(labelmap)))
    return count * voxel_mm3 / 1000.0


def center_of_mass_slice(label) -> int:
    """Weighted center-of-mass slice index along the last spatial axis;
    uniform weights if the label is empty."""
    label = np.asarray(label)
    num_slices = label.shape[2]
    masses = label.reshape(-1, num_slices).sum(axis=0)
    total = masses.sum()
    weights = ((masses / total) if total > 0
               else np.full(num_slices, 1.0 / num_slices))
    return int(round(float((weights * np.arange(num_slices)).sum())))
