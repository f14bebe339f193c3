"""The whole slice, JAX against the port, on the CPU: the model's eval forward
and sliding_window_inference(make_predictor(...)) over a small volume, plus
the numpy helpers of the sliding window and the staging.

JAX variables come from vs_seg_tpu.train.trainer.init_model with randomised
BatchNorm statistics and are converted with vs_seg_tpu_torch.compat.from_jax.
Tolerances, relative to max|ref|:
  - SMALL config (tests/test_model.py) in float32: 1e-4 (CPU convolutions,
    no TF32; only the order of the sums differs);
  - flagship channels (16..96) at a 16x32x32 (DxHxW) window in bfloat16:
    3e-2 (a few bf16 ulps of 2^-8 through the network's depth; JAX in bf16
    and JAX in f32 differ by about as much), and argmax agreement >= 0.995.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model import SMALL
from tests.torch_replica import TorchUNet2d5_spvPA
from vs_seg_tpu.compat.torch_import import import_unet2d5_spvpa
from vs_seg_tpu.infer import sliding_window as jsw
from vs_seg_tpu.infer.engine import make_predictor as jmake_predictor
from vs_seg_tpu.models import UNet2d5_spvPA as JUNet
from vs_seg_tpu.train.trainer import init_model
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.infer import sliding_window as tsw
from vs_seg_tpu_torch.infer.engine import make_predictor
from vs_seg_tpu_torch.models import UNet2d5_spvPA as TUNet


def _variables(jmodel, seed=0):
    v = init_model(jmodel, seed)
    rng = np.random.default_rng(seed + 1)

    def stats(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return (a + rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return (a * rng.uniform(0.5, 1.5, size=a.shape)).astype(np.float32)

    return {"params": jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), v["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                stats, v["batch_stats"])}


def _pair(dtype_j, dtype_t, cfg):
    jm = JUNet(out_channels=2, num_res_units=2, dropout=0.1,
               attention_module=True, dtype=dtype_j, **cfg)
    variables = _variables(jm)
    tm = TUNet(out_channels=2, dtype=dtype_t, device="cpu", **cfg)
    load_jax_variables(tm, variables)
    return jm, tm.eval(), variables


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def small():
    return _pair(jnp.float32, torch.float32, SMALL)


def test_small_forward_and_att_maps_match_jax(small):
    jm, tm, variables = small
    x = np.random.default_rng(0).normal(size=(2, 8, 16, 16, 1)
                                        ).astype(np.float32)
    ref, ref_atts = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out, atts = tm(torch.from_numpy(x))
    assert _rel(out, ref) <= 1e-4
    assert len(atts) == len(ref_atts) == len(SMALL["channels"])
    for a, b in zip(atts, ref_atts):    # coarsest first
        assert _rel(a, b) <= 1e-4


@pytest.mark.parametrize("quantize,sw_batch", [
    (False, 2), (True, 2),
    (False, 3),   # 8 windows in 3 batches: one padded, masked window slot
])
def test_small_sliding_window_matches_jax(small, quantize, sw_batch):
    jm, tm, variables = small
    vol = np.random.default_rng(1).normal(size=(24, 20, 12, 1)
                                          ).astype(np.float32)
    roi = (16, 16, 8)
    jpred = jmake_predictor(jm, variables["params"],
                            variables["batch_stats"], dtype=jnp.float32)
    ref = jsw.sliding_window_inference(vol, roi, jpred, overlap=0.25,
                                       sw_batch_size=sw_batch,
                                       quantize=quantize,
                                       predictor_layout="dfirst")
    out = tsw.sliding_window_inference(
        vol, roi, make_predictor(tm, dtype=torch.float32), device="cpu",
        overlap=0.25, sw_batch_size=sw_batch, quantize=quantize)
    assert tuple(out.shape) == (24, 20, 12, 2)
    assert _rel(out.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("mode,sigma_scale", [("constant", 0.125),
                                              ("gaussian", 0.25)])
def test_small_sliding_window_blend_options_match_jax(small, mode,
                                                      sigma_scale):
    """mode="constant" (every window weighted 1) and a Gaussian of
    sigma_scale 0.25 against JAX's sliding_window_inference; the device
    map is cached per (roi, mode, sigma_scale)."""
    jm, tm, variables = small
    vol = np.random.default_rng(3).normal(size=(24, 20, 12, 1)
                                          ).astype(np.float32)
    roi = (16, 16, 8)
    kw = dict(overlap=0.25, sw_batch_size=2, mode=mode,
              sigma_scale=sigma_scale)
    jpred = jmake_predictor(jm, variables["params"],
                            variables["batch_stats"], dtype=jnp.float32)
    ref = jsw.sliding_window_inference(vol, roi, jpred,
                                       predictor_layout="dfirst", **kw)
    out = tsw.sliding_window_inference(
        vol, roi, make_predictor(tm, dtype=torch.float32), device="cpu",
        **kw)
    assert _rel(out.numpy(), ref) <= 1e-4
    default = tsw.sliding_window_inference(
        vol, roi, make_predictor(tm, dtype=torch.float32), device="cpu",
        overlap=0.25, sw_batch_size=2)
    assert not torch.equal(out, default)
    imp = tsw._importance_map_device((8, 16, 16), mode, sigma_scale,
                                     torch.device("cpu"))
    np.testing.assert_array_equal(
        imp.numpy(), np.asarray(jsw._importance_map_device(
            (8, 16, 16), mode, sigma_scale)))
    with pytest.raises(ValueError, match="blend mode"):
        tsw.sliding_window_inference(
            vol, roi, make_predictor(tm, dtype=torch.float32),
            device="cpu", sw_batch_size=2, mode="linear")


def test_flagship_channels_bf16_window_matches_jax():
    """Full flagship widths, one batch of 2 windows of 16x32x32 (DxHxW),
    uint8 staging as on the main path, bf16 compute on both sides."""
    jm, tm, variables = _pair(jnp.bfloat16, torch.bfloat16, {})
    vol = np.random.default_rng(2).normal(size=(32, 40, 16, 1)
                                          ).astype(np.float32)
    roi = (32, 32, 16)
    kw = dict(overlap=0.25, sw_batch_size=2, quantize=True)
    jpred = jmake_predictor(jm, variables["params"],
                            variables["batch_stats"], dtype=jnp.bfloat16)
    ref = np.asarray(jsw.sliding_window_inference(
        vol, roi, jpred, predictor_layout="dfirst", **kw))
    out = tsw.sliding_window_inference(vol, roi, make_predictor(tm),
                                       device="cpu", **kw).numpy()
    assert out.shape == (32, 40, 16, 2) and np.isfinite(out).all()
    assert _rel(out, ref) <= 3e-2
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.995


def test_replica_import_from_jax_three_way():
    """tests/torch_replica.py (reference naming) -> compat/torch_import.py ->
    compat/from_jax.py -> the port, in float32: equals the replica's eval
    forward, logits and attention maps."""
    torch.manual_seed(0)
    rep = TorchUNet2d5_spvPA(1, 2, SMALL["channels"], SMALL["strides"],
                             SMALL["kernel_sizes"],
                             SMALL["sample_kernel_sizes"], num_res_units=2,
                             dropout=0.1, attention=True).eval()
    with torch.no_grad():
        for name, buf in rep.named_buffers():   # non-trivial BN statistics
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.2)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    x = torch.randn(2, 1, 16, 16, 8)             # (N, C, H, W, D)
    with torch.no_grad():
        ref, ref_atts = rep(x)
    params, stats = import_unet2d5_spvpa(
        {k: v.clone() for k, v in rep.state_dict().items()},
        channels=SMALL["channels"], num_res_units=2, attention=True)
    tm = TUNet(out_channels=2, dtype=torch.float32, device="cpu", **SMALL)
    load_jax_variables(tm, {"params": params, "batch_stats": stats})
    with torch.no_grad():
        out, atts = tm.eval()(x.permute(0, 4, 2, 3, 1).contiguous())
    to_ndhwc = (0, 4, 2, 3, 1)
    assert _rel(out.numpy(), ref.permute(*to_ndhwc).numpy()) <= 1e-4
    assert len(atts) == len(ref_atts)
    for a, b in zip(atts, ref_atts):
        assert _rel(a.numpy(), b.permute(*to_ndhwc).numpy()) <= 1e-4


@pytest.mark.parametrize("shape,roi,overlap", [
    ((448, 448, 80), (384, 384, 64), 0.25),
    ((24, 20, 12), (16, 16, 8), 0.25),
    ((16, 16, 8), (16, 16, 8), 0.5),
    ((33, 17, 9), (16, 16, 8), 0.6),
])
def test_window_helpers_match_jax(shape, roi, overlap):
    np.testing.assert_array_equal(
        tsw.dense_patch_starts(shape, roi, overlap),
        jsw.dense_patch_starts(shape, roi, overlap))
    assert (tsw.count_windows(shape, roi, overlap)
            == jsw.count_windows(shape, roi, overlap))
    np.testing.assert_array_equal(tsw.gaussian_importance_map(roi),
                                  jsw.gaussian_importance_map(roi))


@pytest.mark.parametrize("quantize", [True, False])
def test_stage_volume_matches_jax(quantize):
    """Same D-first transfer buffer (uint8 codes incl. the zero-pad code),
    crops, window starts and mask; dequantization equal to the JAX one."""
    vol = (np.random.default_rng(3).normal(size=(20, 14, 6, 1)) * 3 + 1
           ).astype(np.float32)
    kw = dict(overlap=0.25, sw_batch_size=3, quantize=quantize)
    js = jsw.stage_volume(vol, (16, 16, 8), predictor_layout="dfirst", **kw)
    ts = tsw.stage_volume(vol, (16, 16, 8), device="cpu", **kw)
    np.testing.assert_array_equal(ts.vol_dev.numpy(), np.asarray(js.vol_dev))
    assert ts.crops == js.crops and ts.roi_size == js.roi_size
    np.testing.assert_array_equal(ts.starts_padded, js.starts_padded)
    np.testing.assert_array_equal(ts.mask, js.mask)
    if quantize:
        ref = jsw._dequantize(js.vol_dev, jnp.asarray(js.dequant[0]),
                              jnp.asarray(js.dequant[1]))
        got = tsw.dequantize(ts.vol_dev, *ts.dequant)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_stage_volume_needs_an_explicit_device():
    vol = np.zeros((8, 8, 4, 1), np.float32)
    with pytest.raises(ValueError, match="explicit device"):
        tsw.stage_volume(vol, (8, 8, 4), device=None)
