"""Figures: the port's copy of vs_seg_tpu/eval/figures.py, the reference's
PNG outputs:
  - the transform check of training (reference params/VSparams.py:266-297)
  - the loss and Dice curves of training (:530-545)
  - a 3-panel PNG per inferred case at the label's centre-of-mass slice
    (:596-612)
  - the Dice histogram of inference (:614-616)

matplotlib is imported inside each function, so importing the port never
needs it; without it a figure call raises an ImportError that names it.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from vs_seg_tpu_torch.eval.metrics import center_of_mass_slice


def available() -> bool:
    """Whether matplotlib is installed."""
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("figures need matplotlib, which is not installed; "
                          "run without figures (make_figures=False)") from e
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    return plt


def save_transform_check(image, label, figures_path: str) -> None:
    """image/label: (H, W, D) arrays after val transforms."""
    plt = _pyplot()
    slice_idx = center_of_mass_slice(label)
    plt.figure("check", (12, 6))
    plt.clf()
    plt.subplot(1, 2, 1)
    plt.title("image")
    plt.imshow(image[:, :, slice_idx], cmap="gray", interpolation="none")
    plt.subplot(1, 2, 2)
    plt.title("label")
    plt.imshow(label[:, :, slice_idx], interpolation="none")
    plt.savefig(os.path.join(figures_path, "check_validation_image_and_label.png"))
    plt.close("all")


def save_loss_and_dice_curves(epoch_loss_values, metric_values, val_interval: int,
                              figures_path: str) -> None:
    plt = _pyplot()
    plt.figure("train", (12, 6))
    plt.clf()
    plt.subplot(1, 2, 1)
    plt.title("Epoch Average Loss")
    plt.xlabel("epoch")
    plt.plot([i + 1 for i in range(len(epoch_loss_values))], epoch_loss_values)
    plt.subplot(1, 2, 2)
    plt.title("Val Mean Dice")
    plt.xlabel("epoch")
    plt.plot([val_interval * (i + 1) for i in range(len(metric_values))],
             metric_values)
    plt.savefig(os.path.join(figures_path,
                             "epoch_average_loss_and_val_mean_dice.png"))
    plt.close("all")


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
