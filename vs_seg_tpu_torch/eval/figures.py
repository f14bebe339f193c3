"""Inference figures: the port's copy of the two run_inference figures of
vs_seg_tpu/eval/figures.py (a 3-panel PNG per case at the label's
centre-of-mass slice, and the Dice histogram).

matplotlib is imported inside each function, so importing the port never
needs it; without it a figure call raises an ImportError that names it.
"""

from __future__ import annotations

import os

import numpy as np

from vs_seg_tpu_torch.eval.metrics import center_of_mass_slice


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("figures need matplotlib, which is not installed; "
                          "run without figures (make_figures=False)") from e
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def save_inference_panel(image, label, pred_argmax, dice: float, index: int,
                         figures_path: str) -> None:
    """image/label/pred_argmax: (H, W, D)."""
    plt = _pyplot()
    slice_idx = center_of_mass_slice(label)
    plt.figure("check", (18, 6))
    plt.clf()
    plt.subplot(1, 3, 1)
    plt.title(f"image {index}, slice = {slice_idx}")
    plt.imshow(image[:, :, slice_idx], cmap="gray", interpolation="none")
    plt.subplot(1, 3, 2)
    plt.title(f"label {index}")
    plt.imshow(label[:, :, slice_idx], interpolation="none")
    plt.subplot(1, 3, 3)
    plt.title(f"output {index}, dice = {dice:.4}")
    plt.imshow(pred_argmax[:, :, slice_idx], interpolation="none")
    plt.savefig(os.path.join(figures_path, f"best_model_output_val{index}.png"))
    plt.close("all")


def save_dice_histogram(dice_scores, figures_path: str) -> None:
    plt = _pyplot()
    plt.figure("dice score histogram")
    plt.clf()
    plt.hist(np.asarray(dice_scores), bins=np.arange(0, 1.01, 0.01))
    plt.savefig(os.path.join(figures_path,
                             "best_model_output_dice_score_histogram.png"))
    plt.close("all")
