"""The port's conv FLOP count (vs_seg_tpu_torch/eval/flops.py) against the
JAX package's (vs_seg_tpu/eval/flops.py), on the CPU.

JAX's count traces the model with jax.eval_shape: its variables come from
an eval_shape of `init` too, so nothing runs. JAX counts the up_0 logit
head's unit0 and residual convs and, under its default VS_HEADFOLD=1, the
folded conv that replaces them as well; the port counts the model's algebra,
which is JAX's count under VS_HEADFOLD=0. Counts are integers and compared
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model import SMALL
from vs_seg_tpu.core.config import Config as JConfig
from vs_seg_tpu.eval import flops as jflops
from vs_seg_tpu.models import build_model as jbuild_model
from vs_seg_tpu.models.unet2d5_spvpa import UNet2d5_spvPA as JUNet2d5_spvPA
from vs_seg_tpu_torch.core.config import Config, Routes
from vs_seg_tpu_torch.eval.flops import conv_flops_by_module, forward_conv_flops
from vs_seg_tpu_torch.models import UNet2d5_spvPA, build_model
from vs_seg_tpu_torch.nn.layers import Conv3d, ConvTranspose3d, unfused

WINDOW = (1, 64, 384, 384, 1)        # (N, D, H, W, C): one 384x384x64 window
# JAX's counts at WINDOW with VS_HEADFOLD=0
FULL = {"UNet2d5_spvPA": 1_248_912_340_992, "UNet2d5": 883_112_214_528,
        "UNet": 499_990_855_680}
# the folded up_0 head conv JAX also counts under VS_HEADFOLD=1:
# 2 * (16 || 16 -> 2) * (3,3,1) taps over 384*384*64 voxels
HEADFOLD = 2 * 9 * 32 * 2 * 384 * 384 * 64
# a narrow flagship at an odd batch and an anisotropic shape
NARROW = (3, 12, 40, 56, 1)
SMALL_X = (1, 4, 8, 8, 1)            # the narrow flagship's smallest input
ROUTES = {
    "default": Routes(),
    "A": Routes(rublock2d=True, l2block2d=True, tail2d1=True),
    "A+tail2d0": Routes(rublock2d=True, l2block2d=True, tail2d0=True,
                        tail2d1=True),
    "B": Routes(att_fuse=True),
    "C": Routes(dsconv=True),
    "all": Routes(rublock2d=True, l2block2d=True, tail2d0=True,
                  tail2d1=True, att_fuse=True, dsconv=True),
}


def _jax_count(jmodel, input_shape, small=(1, 8, 32, 32, 1)):
    """JAX's forward_conv_flops, its variables from an eval_shape of init
    at the `small` input (a conv's parameters do not depend on the input's
    size)."""
    v = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros(small), train=False))
    return jflops.forward_conv_flops(jmodel, v, input_shape)


def _narrow(dtype=torch.float32, device="cpu"):
    return UNet2d5_spvPA(dtype=dtype, device=device,
                         generator=torch.Generator().manual_seed(0), **SMALL)


def test_flagship_window_equals_jax_without_the_headfold(monkeypatch):
    got = forward_conv_flops(UNet2d5_spvPA(dtype=torch.bfloat16,
                                           device="cpu"), WINDOW)
    jm = JUNet2d5_spvPA(dtype=jnp.bfloat16)
    monkeypatch.setenv("VS_HEADFOLD", "0")
    assert got == _jax_count(jm, WINDOW) == FULL["UNet2d5_spvPA"]
    monkeypatch.setenv("VS_HEADFOLD", "1")
    assert _jax_count(jm, WINDOW) - got == HEADFOLD == 10_871_635_968


@pytest.mark.parametrize("name", ["UNet2d5", "UNet"])
def test_zoo_window_equals_jax(monkeypatch, name):
    monkeypatch.setenv("VS_HEADFOLD", "0")
    got = forward_conv_flops(
        build_model(Config(model=name, device="cpu"), device="cpu"), WINDOW)
    assert got == _jax_count(jbuild_model(JConfig(model=name)), WINDOW)
    assert got == FULL[name]


def test_narrow_flagship_equals_jax_and_is_linear_in_the_batch(monkeypatch):
    monkeypatch.setenv("VS_HEADFOLD", "0")
    model = _narrow()
    got = forward_conv_flops(model, NARROW)
    assert got == _jax_count(JUNet2d5_spvPA(dtype=jnp.float32, **SMALL),
                             NARROW, SMALL_X)
    assert got == NARROW[0] * forward_conv_flops(model, (1, *NARROW[1:]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("routes", list(ROUTES))
def test_count_is_independent_of_routes_kernels_and_dtype(routes,
                                                          use_kernels, dtype):
    """The count after the model ran under each route configuration, with
    and without kernels (their plain twins here), in bf16 and f32, is the
    f32 model's count before any run."""
    want = forward_conv_flops(_narrow(), NARROW)
    model = _narrow(dtype)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=SMALL_X).astype(np.float32))
    with torch.no_grad():
        model(x, use_kernels=use_kernels, routes=ROUTES[routes])
    assert forward_conv_flops(model, NARROW) == want


def test_unfused_forward_is_the_fused_function():
    """Under nn/layers.py:unfused (the algebra the count reads) the eval
    forward computes the same logits and maps as the routed one."""
    model = _narrow()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, *SMALL_X[1:])).astype(np.float32))
    with torch.no_grad():
        ref, ref_att = model(x, routes=ROUTES["all"])
        with unfused():
            got, got_att = model(x, routes=ROUTES["all"])
    for g, r in zip((got, *got_att), (ref, *ref_att)):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


def test_callers_model_is_left_alone():
    model = _narrow(torch.bfloat16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    forward_conv_flops(model, NARROW)
    conv_flops_by_module(model, NARROW)
    after = model.state_dict()
    assert sorted(after) == sorted(before)
    for k, v in after.items():
        assert v.device.type == "cpu", k
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_by_module_sums_to_the_total_one_entry_per_conv():
    model = _narrow()
    by = conv_flops_by_module(model, NARROW)
    assert sum(f for _, f in by) == forward_conv_flops(model, NARROW)
    convs = [n for n, m in model.named_modules()
             if isinstance(m, (Conv3d, ConvTranspose3d))]
    assert sorted(n for n, _ in by) == sorted(convs)
    assert all(f > 0 for _, f in by)
    heads = dict(by)
    vox = int(np.prod(NARROW[:4]))
    assert heads["up_0.unit0.conv"] == 2 * vox * 9 * 2 * 4 * 2
    assert heads["up_0.residual"] == 2 * vox * 2 * 4 * 2
