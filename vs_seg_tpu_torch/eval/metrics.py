"""Evaluation metrics: the counterpart of vs_seg_tpu/eval/metrics.py
(`dice_score`; volumetry and figures are not ported yet)."""

from __future__ import annotations

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
