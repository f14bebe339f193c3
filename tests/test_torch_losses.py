"""The masked, generalised and generalised Wasserstein Dice losses, JAX
against the port, on the CPU: value and gradient wrt the prediction.

Inputs are seeded numpy arrays (B, D, H, W, C) logits and (B, D, H, W, 1)
labels, float32. Tolerances: the loss 1e-5 relative; the gradient 1e-5 of
its largest element (float32; only the order of the sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vs_seg_tpu.losses import dice as jdice
from vs_seg_tpu_torch import losses as tlosses

SHAPE = (2, 4, 6, 8)     # (B, D, H, W)


def _inputs(seed, classes=2, empty=None):
    """Logits and label indices; `empty`: a class no voxel of the first
    sample carries."""
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(*SHAPE, classes)).astype(np.float32)
    label = rng.integers(0, classes, size=(*SHAPE, 1)).astype(np.float32)
    if empty is not None:
        first = label[0]
        first[first == empty] = (empty + 1) % classes
    return pred, label


def _check(jfn, tfn, pred, *args):
    ref, ref_g = jax.value_and_grad(jfn)(jnp.asarray(pred), *(
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    tp = torch.from_numpy(pred).requires_grad_()
    loss = tfn(tp, *(torch.from_numpy(a) if isinstance(a, np.ndarray)
                     else a for a in args))
    loss.backward()
    assert np.isfinite(float(ref))
    assert abs(loss.item() - float(ref)) <= 1e-5 * abs(float(ref))
    g = np.asarray(ref_g)
    assert np.abs(tp.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_dice_loss_matches_jax(masked, include_background):
    pred, label = _inputs(0)
    mask = ((np.random.default_rng(1).random((*SHAPE, 1)) > 0.4)
            .astype(np.float32) if masked else None)
    kw = dict(include_background=include_background, to_onehot_y=True,
              softmax=True)
    # the mask multiplies the softmax's input here: softmax and one-hot act
    # inside dice_loss, after the masking, on both sides
    _check(lambda p, m: jdice.masked_dice_loss(p, jnp.asarray(label), m,
                                               **kw),
           lambda p, m: tlosses.masked_dice_loss(p, torch.from_numpy(label),
                                                 m, **kw),
           pred, mask)


def test_masked_dice_loss_on_probabilities_matches_jax():
    """The reference's use: sigmoid probabilities and a one-hot target,
    both masked."""
    pred, label = _inputs(2, classes=3)
    target = np.eye(3, dtype=np.float32)[label[..., 0].astype(int)]
    mask = (np.random.default_rng(3).random((*SHAPE, 1)) > 0.5).astype(
        np.float32)
    _check(lambda p: jdice.masked_dice_loss(jax.nn.sigmoid(p),
                                            jnp.asarray(target),
                                            jnp.asarray(mask)),
           lambda p: tlosses.masked_dice_loss(torch.sigmoid(p),
                                              torch.from_numpy(target),
                                              torch.from_numpy(mask)),
           pred)


@pytest.mark.parametrize("w_type", ["simple", "square", "uniform"])
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("empty", [None, 2])
def test_generalized_dice_loss_matches_jax(w_type, include_background,
                                           empty):
    """Three classes; with `empty`, class 2 is absent from the first
    sample: its infinite weight becomes that sample's largest finite one."""
    pred, label = _inputs(4, classes=3, empty=empty)
    kw = dict(include_background=include_background, to_onehot_y=True,
              softmax=True, w_type=w_type)
    _check(lambda p: jdice.generalized_dice_loss(p, jnp.asarray(label),
                                                 **kw),
           lambda p: tlosses.generalized_dice_loss(
               p, torch.from_numpy(label), **kw),
           pred)


@pytest.mark.parametrize("reduction", ["sum", "none"])
def test_generalized_dice_loss_reductions_match_jax(reduction):
    pred, label = _inputs(5, classes=3, empty=1)
    kw = dict(to_onehot_y=True, softmax=True, reduction=reduction)
    ref = np.asarray(jdice.generalized_dice_loss(
        jnp.asarray(pred), jnp.asarray(label), **kw))
    got = tlosses.generalized_dice_loss(torch.from_numpy(pred),
                                        torch.from_numpy(label), **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("dist,empty", [
    ([[0.0, 1.0], [1.0, 0.0]], None),
    ([[0.0, 2.0, 4.0], [2.0, 0.0, 1.0], [4.0, 1.0, 0.0]], None),
    ([[0.0, 2.0, 4.0], [2.0, 0.0, 1.0], [4.0, 1.0, 0.0]], 0),
])
def test_generalized_wasserstein_dice_loss_matches_jax(dist, empty):
    """dist_matrix normalised by its maximum, alpha = 1/(volume + 1): an
    empty class (class 0 absent from the first sample) keeps alpha 1."""
    pred, label = _inputs(6, classes=len(dist), empty=empty)
    _check(lambda p: jdice.generalized_wasserstein_dice_loss(
               p, jnp.asarray(label), dist),
           lambda p: tlosses.generalized_wasserstein_dice_loss(
               p, torch.from_numpy(label), dist),
           pred)
