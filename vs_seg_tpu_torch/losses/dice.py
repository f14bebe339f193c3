"""The Dice loss family and the composite supervised-attention loss: the
counterpart of vs_seg_tpu/losses/dice.py (`one_hot`, `dice_loss`,
`masked_dice_loss`, `generalized_dice_loss`,
`generalized_wasserstein_dice_loss`, `dice_spvpa_loss`).

Layout: predictions (B, *spatial, C); targets (B, *spatial, 1) label indices
or (B, *spatial, C) one-hot. The hardness weight carries gradients, as in the
JAX package and the reference (it is NOT detached).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, *S, 1) label indices -> (B, *S, C) float32 one-hot."""
    return F.one_hot(labels[..., 0].long(), num_classes).float()


def _reduce(f: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return f.mean()
    if reduction == "sum":
        return f.sum()
    if reduction == "none":
        return f
    raise ValueError(f"Unsupported reduction: {reduction}")


def _prepare(pred, target, *, sigmoid, softmax, to_onehot_y,
             include_background):
    n_pred_ch = pred.shape[-1]
    if sigmoid:
        pred = torch.sigmoid(pred)
    if softmax and n_pred_ch > 1:
        pred = torch.softmax(pred, dim=-1)
    if to_onehot_y and n_pred_ch > 1:
        target = one_hot(target, n_pred_ch)
    if not include_background and n_pred_ch > 1:
        pred = pred[..., 1:]
        target = target[..., 1:]
    if target.shape != pred.shape:
        raise ValueError(f"ground truth has differing shape "
                         f"({tuple(target.shape)}) from input "
                         f"({tuple(pred.shape)})")
    return pred, target


def dice_loss(pred: torch.Tensor, target: torch.Tensor, *,
              include_background: bool = True, to_onehot_y: bool = False,
              sigmoid: bool = False, softmax: bool = False,
              squared_pred: bool = False, jaccard: bool = False,
              hardness_weight: Optional[torch.Tensor] = None,
              reduction: str = "mean", smooth: float = 1e-5) -> torch.Tensor:
    """Soft Dice with optional hardness weighting."""
    pred, target = _prepare(pred, target, sigmoid=sigmoid, softmax=softmax,
                            to_onehot_y=to_onehot_y,
                            include_background=include_background)
    if (hardness_weight is not None and not include_background
            and pred.shape[-1] != hardness_weight.shape[-1]):
        hardness_weight = hardness_weight[..., 1:]
    axes = tuple(range(1, pred.dim() - 1))       # spatial dims only
    w = hardness_weight if hardness_weight is not None else 1.0
    intersection = torch.sum(w * target * pred, dim=axes)
    if squared_pred:
        target = target * target
        pred = pred * pred
    ground_o = torch.sum(w * target, dim=axes)
    pred_o = torch.sum(w * pred, dim=axes)
    denominator = ground_o + pred_o
    if jaccard:
        denominator = 2.0 * (denominator - intersection)
    f = 1.0 - (2.0 * intersection + smooth) / (denominator + smooth)
    return _reduce(f, reduction)


def masked_dice_loss(pred: torch.Tensor, target: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, **kwargs
                     ) -> torch.Tensor:
    """dice_loss over a binary region mask: prediction and target are
    multiplied by `mask` first (None: the whole volume)."""
    if mask is not None:
        pred = pred * mask
        target = target * mask
    return dice_loss(pred, target, **kwargs)


def generalized_dice_loss(pred: torch.Tensor, target: torch.Tensor, *,
                          include_background: bool = True,
                          to_onehot_y: bool = False, sigmoid: bool = False,
                          softmax: bool = False, w_type: str = "square",
                          reduction: str = "mean", smooth: float = 1e-5
                          ) -> torch.Tensor:
    """Generalised Dice (Sudre et al. 2017). Class weights 1/V ("simple"),
    1/V^2 ("square") or 1 (any other w_type) of each class's target volume
    V; the infinite weight of an empty class becomes the largest finite
    weight of its sample."""
    pred, target = _prepare(pred, target, sigmoid=sigmoid, softmax=softmax,
                            to_onehot_y=to_onehot_y,
                            include_background=include_background)
    axes = tuple(range(1, pred.dim() - 1))
    intersection = torch.sum(target * pred, dim=axes)
    ground_o = torch.sum(target, dim=axes)
    pred_o = torch.sum(pred, dim=axes)
    denominator = ground_o + pred_o
    if w_type == "simple":
        w = 1.0 / ground_o
    elif w_type == "square":
        w = 1.0 / (ground_o * ground_o)
    else:
        w = torch.ones_like(ground_o)
    isinf = torch.isinf(w)
    finite_max = torch.where(isinf, torch.zeros_like(w), w).amax(
        -1, keepdim=True)
    w = torch.where(isinf, finite_max, w)
    f = 1.0 - (2.0 * torch.sum(intersection * w, -1) + smooth) / (
        torch.sum(denominator * w, -1) + smooth)
    return _reduce(f, reduction)


def generalized_wasserstein_dice_loss(pred: torch.Tensor,
                                      target: torch.Tensor, dist_matrix,
                                      smooth: float = 1e-5) -> torch.Tensor:
    """Generalised Wasserstein Dice (Fidon et al. 2017) with GDL-style
    weights: `dist_matrix` (C, C) normalised by its maximum, each voxel's
    Wasserstein distance sum_c M[y, c] p_c on the softmax p, and class
    weights alpha = 1 / (volume + 1). pred (B, *S, C) logits, target
    (B, *S, 1) label indices; the mean over the batch."""
    m = torch.as_tensor(dist_matrix, dtype=torch.float32,
                        device=pred.device)
    m = m / m.max()
    num_classes = m.shape[0]
    b = pred.shape[0]
    flat_pred = pred.reshape(b, -1, pred.shape[-1])           # (B, V, C)
    flat_target = target.reshape(b, -1).long()                # (B, V)
    probs = torch.softmax(flat_pred, dim=-1)
    wass = torch.sum(m[flat_target] * probs, dim=-1)          # (B, V)
    volumes = F.one_hot(flat_target, num_classes).float().sum(1)  # (B, C)
    alpha_map = torch.gather(1.0 / (volumes + 1.0), 1, flat_target)
    true_pos = torch.sum(alpha_map * (1.0 - wass), dim=1)
    denom = torch.sum(alpha_map * (2.0 - wass), dim=1)
    wass_dice = (2.0 * true_pos + smooth) / (denom + smooth)
    return torch.mean(1.0 - wass_dice)


def _maxpool3d_squeezed(x: torch.Tensor, window: Sequence[int]
                        ) -> torch.Tensor:
    """MaxPool3d(kernel = stride = window) on squeezed (B, S0, S1, S2)."""
    return F.max_pool3d(x[:, None], tuple(window), tuple(window))[:, 0]


def _dice_single_channel(pred4: torch.Tensor, target4: torch.Tensor,
                         smooth: float) -> torch.Tensor:
    """dice_loss for one channel on squeezed (B, S0, S1, S2) arrays."""
    ax = (1, 2, 3)
    intersection = torch.sum(target4 * pred4, ax)
    denominator = torch.sum(target4, ax) + torch.sum(pred4, ax)
    f = 1.0 - (2.0 * intersection + smooth) / (denominator + smooth)
    return f.mean()


def dice_spvpa_loss(logits: torch.Tensor, att_maps: Tuple[torch.Tensor, ...],
                    target: torch.Tensor, *, supervised_attention: bool = True,
                    hardness_weighting: bool = True,
                    hardness_lambda: float = 0.6,
                    smooth: float = 1e-5) -> torch.Tensor:
    """Composite loss on (logits, att_maps); att_maps coarsest first.

    The ground-truth pyramid is built finest first by max pooling with the
    shape ratio between consecutive attention maps, each level weighted 1/L.
    The hardness weight w = 0.6 |softmax(x) - onehot(y)| + 0.4 is not
    detached."""
    total_att_loss = 0.0
    if supervised_attention and len(att_maps) > 0:
        n_lv = len(att_maps)
        g = target.float()[..., 0]                   # (B, S0, S1, S2)
        for level in range(n_lv):
            att = att_maps[n_lv - level - 1][..., 0]    # finest first
            total_att_loss = total_att_loss + _dice_single_channel(
                att.float(), g, smooth) / n_lv
            if level < n_lv - 1:
                cur = att_maps[n_lv - level - 1].shape
                nxt = att_maps[n_lv - level - 2].shape
                if any(c % n for c, n in zip(cur, nxt)):
                    raise ValueError(f"attention maps {tuple(cur)} and "
                                     f"{tuple(nxt)} are not nested")
                g = _maxpool3d_squeezed(
                    g, [c // n for c, n in zip(cur[1:4], nxt[1:4])])

    hardness_weight = None
    if hardness_weighting:
        probs = torch.softmax(logits, dim=-1)
        onehot_t = one_hot(target, logits.shape[-1])
        hardness_weight = (hardness_lambda * torch.abs(probs - onehot_t)
                           + (1.0 - hardness_lambda))
    pred_loss = dice_loss(logits, target, to_onehot_y=True, softmax=True,
                          hardness_weight=hardness_weight, smooth=smooth)
    return total_att_loss + pred_loss
