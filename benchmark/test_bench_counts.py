"""The benchmark's own FLOP and byte counts (benchmark/flops.py) against
the totals PERF.md records and against the port's eval/flops.py, module by
module."""

import json

import pytest

from benchmark import flops
from benchmark.conftest import BENCH

WINDOW = (384, 384, 64)
# PERF.md, PR 22: conv FLOP of one 384x384x64 window (JAX's count with
# VS_HEADFOLD=0 and the port's eval/flops.py)
RECORDED = {"vs_unet2d5_spvpa": 1_248_912_340_992,
            "vs_unet2d5_spvpa_noatt": 883_112_214_528}


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_forward_flops_recorded(name):
    assert flops.forward_flops(config(name), WINDOW) == RECORDED[name]


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_per_module_against_the_port(name):
    from vs_seg_tpu_torch.eval.flops import conv_flops_by_module
    from vs_seg_tpu_torch.models import build_model

    from benchmark.common import program_config
    cfg = config(name)
    model = build_model(program_config(cfg), device="cpu")
    h, w, d = WINDOW
    port = dict(conv_flops_by_module(model, (2, d, h, w, 1)))
    ours = {path: f for path, _, f, *_ in
            flops.conv_modules(cfg, WINDOW, batch=2)}
    assert ours == port


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_train_step_flops(name):
    cfg = config(name)
    mods = flops.conv_modules(cfg, WINDOW)
    image = sum(m[2] for m in mods if m[6])
    assert {m[0] for m in mods if m[6]} == {"down_0.unit0.conv",
                                          "down_0.residual"}
    assert flops.train_step_flops(cfg, WINDOW) == \
        3 * flops.forward_flops(cfg, WINDOW) - image


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_level_groups_cover_the_forward(name):
    cfg = config(name)
    traffic = json.loads((BENCH / "traffic" / "infer_vol448.json")
                         .read_text())
    groups = traffic["level_groups"].values()
    assert sorted(lv for g in groups for lv in g) == list(range(6))
    total = sum(flops.group_work(cfg, WINDOW, 8, g)["flop"]
                for g in groups)
    assert total == 8 * flops.forward_flops(cfg, WINDOW)


def test_group_bytes_by_hand():
    """Levels 0-1 of the flagship at batch 1: the image and the logits,
    downsample_1's output and up_2's, the two attention maps, in bf16,
    and the group's float32 weights."""
    cfg = config("vs_unet2d5_spvpa")
    v0 = 384 * 384 * 64
    v1, v2 = v0 // 4, v0 // 16
    weights = sum(4 * (taps * cin * cout + cout)
                  for _, lv, _, cin, cout, taps, _ in
                  flops.conv_modules(cfg, WINDOW) if lv in (0, 1))
    moved = 2 * (v0 * 1 + v0 * 2 + v2 * 32 + v2 * 48 + v0 + v1)
    assert flops.group_work(cfg, WINDOW, 1, (0, 1))["bytes"] == \
        moved + weights


def test_level_sizes():
    sizes = flops.level_sizes(config("vs_unet2d5_spvpa"), WINDOW)
    assert sizes == [(64, 384, 384), (64, 192, 192), (64, 96, 96),
                     (32, 48, 48), (16, 24, 24), (8, 12, 12)]
