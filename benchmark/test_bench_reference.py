"""The plain reference (benchmark/reference.py) against the port's plain
path, in float32 on the CPU at small sizes and full widths, on seeded
weights: the eval forward, the blend, the window placement and one train
step. The reference is written from the published description; these
tests show it computes what the program computes."""

import json

import numpy as np
import pytest
import torch

from benchmark import common, data, reference
from benchmark.conftest import BENCH

WINDOW = (64, 64, 16)       # (H, W, D): every level at least 2 voxels
# a train crop whose bottom level still holds 64 voxels: BatchNorm's batch
# statistics over fewer amplify rounding past the tolerances below
CROP = (128, 128, 32)

# float32 on both sides, summed in other orders by other conv algorithms:
# a logit within 1e-5 of the largest logit's size
FWD_TOL = 1e-5
# the loss is a ratio of sums over the whole crop: 1e-5 relative
LOSS_TOL = 1e-5
# a leaf's gradient against the larger of its own norm and the median
# leaf's: the gradient is a small difference of large sums (the Dice
# ratios over the crop, the PReLU slopes' and BatchNorm scales' sums over
# every voxel), so float32's rounding alone moves the median leaf by
# 3.6e-4 and the worst by 4.7e-3 (the reference itself in float32 against
# float64 at this crop)
LEAF_TOL, MEDIAN_TOL = 1e-2, 1e-3


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def port_model(cfg, seed):
    from vs_seg_tpu_torch.models import build_model
    net = reference.RefNet(cfg)
    model = build_model(common.program_config(cfg, compute_dtype="float32"),
                        device="cpu")
    weights = reference.make_weights(net, seed, "cpu")
    model.load_state_dict(weights, strict=True)
    return net, weights, model


@pytest.mark.parametrize("name", ["vs_unet2d5_spvpa",
                                  "vs_unet2d5_spvpa_noatt"])
def test_eval_forward(name):
    cfg = config(name)
    net, p, model = port_model(cfg, 3)
    h, w, d = WINDOW
    x = torch.randn((2, d, h, w, 1), generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        got, got_atts = model(x, use_kernels=False, train=False)
        ref, ref_atts = net.forward(p, x.permute(0, 4, 1, 2, 3))
    ref = ref.permute(0, 2, 3, 4, 1)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= FWD_TOL, err
    assert len(got_atts) == len(ref_atts) == (6 if cfg["attention"] else 0)
    for a, b in zip(got_atts, ref_atts):
        assert float((a - b.permute(0, 2, 3, 4, 1)).abs().max()) <= FWD_TOL


def test_blend_and_windows():
    from vs_seg_tpu_torch.infer.engine import make_predictor
    from vs_seg_tpu_torch.infer.sliding_window import (
        dense_patch_starts, gaussian_importance_map,
        sliding_window_inference)

    for size, roi in (((448, 448, 80), (384, 384, 64)),
                      ((72, 72, 20), WINDOW), ((64, 90, 33), WINDOW)):
        ours = reference.window_starts(size, roi, 0.25)
        port = dense_patch_starts(size, roi, 0.25)
        assert sorted(ours) == sorted(map(tuple, port.tolist()))
    dhw = (16, 64, 64)
    assert np.array_equal(
        reference.gaussian_map(dhw, 0.125, "cpu").numpy(),
        gaussian_importance_map(dhw, 0.125))

    cfg = config("vs_unet2d5_spvpa")
    net, p, model = port_model(cfg, 5)
    vol = torch.randn((72, 72, 20), generator=torch.Generator()
                      .manual_seed(6))
    got = sliding_window_inference(
        vol[..., None].numpy(), WINDOW,
        make_predictor(model, torch.float32), device="cpu", overlap=0.25,
        sw_batch_size=8)
    ref = reference.blend_volume(net, p, vol, WINDOW, 0.25, 0.125)
    ref = ref.permute(1, 2, 3, 0)
    assert float((got - ref).abs().max() / ref.abs().max()) <= FWD_TOL


@pytest.mark.parametrize("name", ["vs_unet2d5_spvpa",
                                  "vs_unet2d5_spvpa_noatt"])
def test_train_step(name):
    """One train step of the port's Trainer against reference.train_steps
    from the same weights, crop and generator seed: the loss, the first
    gradient as Adam takes it, and the update."""
    from vs_seg_tpu_torch.train.trainer import Trainer

    cfg = config(name)
    net, p0, model = port_model(cfg, 7)
    h, w, d = CROP
    g = torch.Generator().manual_seed(8)
    image = torch.randn((1, d, h, w, 1), generator=g)
    label = torch.zeros((1, d, h, w, 1))
    label[:, 8:20, 40:72, 32:60] = 1.0
    trainer = Trainer(common.program_config(cfg, compute_dtype="float32",
                                            seed=9), model, "cpu")
    state = trainer.init_state(9)
    loss = float(trainer.make_step(state)(image, label.to(torch.uint8),
                                          state["generator"]))
    opt = state["optimizer"].state
    losses, first, p1 = reference.train_steps(
        net, p0, [(image.permute(0, 4, 1, 2, 3),
                   label.permute(0, 4, 1, 2, 3))], seed=9,
        lr=cfg["initial_learning_rate"], wd=cfg["weight_decay"],
        supervised_attention=cfg["attention"], hardness=cfg["hardness"],
        device="cpu")
    assert abs(loss - losses[0]) <= LOSS_TOL * abs(losses[0])
    named = dict(model.named_parameters())
    assert set(named) == set(first)
    norms = {k: float(v.norm()) for k, v in first.items()}
    med = float(np.median(list(norms.values())))
    gaps = {k: float((opt[v]["exp_avg"] / 0.1 - first[k]).norm())
            / max(norms[k], med) for k, v in named.items()}
    assert max(gaps.values()) <= LEAF_TOL, max(gaps.items(),
                                               key=lambda kv: kv[1])
    assert float(np.median(list(gaps.values()))) <= MEDIAN_TOL
    # the first update moves each parameter by lr * g / (|g| + eps), about
    # lr wherever the gradient is not nought to rounding (the conv biases
    # under batch statistics are, and move by round-off alone); an element
    # whose gradient is near eps moves less, by as much as its gradient's
    # rounding (above), so a leaf's move agrees to LEAF_TOL
    for k, v in named.items():
        if norms[k] < 1e-3 * med:
            continue
        moved = float((v.detach() - p0[k]).norm())
        ref_moved = float((p1[k] - p0[k]).norm())
        assert abs(moved - ref_moved) <= LEAF_TOL * ref_moved, k


def test_dropout_masks_follow_the_generator():
    """The reference draws the same keep masks from a generator of the
    same seed as the port's Dropout does, in (N, D, H, W, C) order."""
    from vs_seg_tpu_torch.nn.layers import Dropout

    x = torch.ones((2, 3, 5, 4, 6))          # (N, D, H, W, C)
    got = Dropout(0.1)(x, train=True,
                       generator=torch.Generator().manual_seed(1))
    run = reference._Run(reference.RefNet(config("vs_unet2d5_spvpa")), {},
                         True, torch.Generator().manual_seed(1), "f32")
    ref = run.drop(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert torch.equal(got, ref)


def test_fp8_round():
    t = torch.tensor([1.0, 1.0625, 1.125, 300.0, -0.01])
    q = reference.fp8_round(t, "e4m3").float()
    # e4m3 keeps 3 mantissa bits: 1.0625 rounds to 1.0 (ties to even)
    assert q[0] == 1.0 and q[1] == 1.0 and q[2] == 1.125
    assert float((q - t).abs().max() / t.abs().max()) <= 2 ** -4
    assert data.sub_seed(2 ** 31 + 5, data.WEIGHTS) != data.sub_seed(
        2 ** 31 + 5, data.CASES)
