"""ops/bnorm_train.py on the CPU: the train-mode BatchNorm -> dropout ->
PReLU Function (run by its plain twins) against the eager chain of
nn/layers.py (BatchNorm, Dropout, PReLU), its sites in
nn/blocks.py:Convolution, whole train steps with the kernels' route on and
off and under --remat, and the kernels' names under the benchmark's kernel
families.

Both sides of a comparison draw their dropout words from generators seeded
alike, so they hold the same masks. Tolerances: float32 within 1e-6 of the
largest value for outputs and running statistics, and 1e-5 for gradients
(the two sum in other orders, and the Function's input gradient is
BatchNorm's closed form where autograd chained the eager ops). In bf16 the
eager chain rounds three times (BatchNorm's output, dropout's, PReLU's)
and the Function once, both in f32 arithmetic: each is held to the chain
computed in float64 from the same bf16 input and the same bf16 upstream
gradient, the Function within BF16_BAND of the largest value and no
further than the eager chain plus one bf16 ulp of the largest value.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.trace import kernel_family
from vs_seg_tpu_torch.models import UNet2d5_spvPA
from vs_seg_tpu_torch.nn.blocks import AttentionBlock1, Convolution
from vs_seg_tpu_torch.nn.layers import BatchNorm, Dropout, PReLU
from vs_seg_tpu_torch.ops import bnorm_train as bt
from vs_seg_tpu_torch.train import trainer as ttrainer

SHAPE = (2, 3, 5, 4)             # (N, D, H, W)
BF16_BAND = 2.0 ** -7           # the repo's bf16 band (test_torch_train.py)
BF16_ULP = 2.0 ** -8
# test_torch_models.py's small flagship
SMALL = dict(channels=(4, 8, 8, 8), strides=((2, 2, 1), (2, 2, 2), (2, 2, 2)),
             kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
             sample_kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)))
CSRC = Path(bt.__file__).parent / "csrc" / "bnorm_train.cu"


def _params(c, seed=0):
    rng = np.random.default_rng(seed)
    values = {"scale": rng.uniform(0.5, 1.5, c),
              "bias": rng.normal(size=c) * 0.3, "mean": rng.normal(size=c),
              "var": rng.uniform(0.5, 2.0, c),
              "alpha": [rng.uniform(0.1, 0.4)]}
    return {k: torch.tensor(v, dtype=torch.float32)
            for k, v in values.items()}


def _inputs(c, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*SHAPE, c)) * 2.0 + 0.5
    w = rng.normal(size=(*SHAPE, c))
    return torch.tensor(x, dtype=torch.float32), torch.tensor(
        w, dtype=torch.float32)


def _run(x, w, params, rate, fused, dtype=None, gen_seed=5):
    """One forward and backward of sum(out * w): the eager chain or the
    Function, in x's dtype (cast to `dtype` first where given)."""
    c = x.shape[-1]
    bn = BatchNorm(c, device="cpu")
    bn.load_state_dict({k: params[k].clone() for k in
                        ("scale", "bias", "mean", "var")})
    act = PReLU(device="cpu")
    with torch.no_grad():
        act.alpha.copy_(params["alpha"])
    drop = Dropout(rate)
    gen = torch.Generator().manual_seed(gen_seed)
    xt = (x if dtype is None else x.to(dtype)).clone().requires_grad_()
    if fused:
        out = bt.bn_dropout_prelu(xt, bn, act.alpha, drop.draw(xt, gen))
    else:
        out = act(drop(bn(xt), True, gen))
    (out.double() * w.double()).sum().backward()
    return {"out": out.detach().double(), "gx": xt.grad.double(),
            "gscale": bn.scale.grad.double(), "gbias": bn.bias.grad.double(),
            "galpha": act.alpha.grad.double(), "mean": bn.mean.double(),
            "var": bn.var.double(), "gen": gen.get_state()}


def _err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("c", [16, 48, 96, 12])
def test_function_matches_eager_chain_float32(c, rate):
    x, w = _inputs(c)
    params = _params(c)
    ref, got = (_run(x, w, params, rate, fused) for fused in (False, True))
    assert torch.equal(ref["gen"], got["gen"])      # the same one draw
    for k in ("out", "mean", "var"):
        assert _err(got[k], ref[k]) <= 1e-6, k
    for k in ("gx", "gscale", "gbias", "galpha"):
        assert _err(got[k], ref[k]) <= 1e-5, k


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("c", [16, 48, 96, 12])
def test_function_bf16_within_band_and_no_worse_than_eager(c, rate):
    x, w = _inputs(c, seed=2)
    params = _params(c, seed=3)
    # both bf16 sides receive sum(out * w)'s gradient w rounded to bf16
    exact = _run(x.to(torch.bfloat16).double(),
                 w.to(torch.bfloat16).double(), params, rate, False)
    eager = _run(x, w, params, rate, False, torch.bfloat16)
    got = _run(x, w, params, rate, True, torch.bfloat16)
    assert torch.equal(eager["gen"], got["gen"])
    for k in ("out", "gx", "gscale", "gbias", "galpha", "mean", "var"):
        e_got, e_eager = _err(got[k], exact[k]), _err(eager[k], exact[k])
        assert e_got <= BF16_BAND, (k, e_got)
        assert e_got <= e_eager + BF16_ULP, (k, e_got, e_eager)


def test_dropout_rate_one_in_65536_draws_nothing():
    """A rate that rounds to keep-all draws no words on either path."""
    x, w = _inputs(8)
    params = _params(8)
    ref, got = (_run(x, w, params, 1e-6, fused) for fused in (False, True))
    fresh = torch.Generator().manual_seed(5).get_state()
    assert torch.equal(got["gen"], fresh) and torch.equal(ref["gen"], fresh)
    assert _err(got["out"], ref["out"]) <= 1e-6


def test_dropout_forward_is_the_draw_applied():
    """Dropout.forward is x / keep where Dropout.draw's word is below its
    threshold and 0 elsewhere, from one randint draw."""
    x = torch.randn(3, 4, 5, 6)
    d = Dropout(0.25)
    words, thresh = d.draw(x, torch.Generator().manual_seed(1))
    assert words.dtype == torch.int32 and thresh == 49152
    ref = torch.where(words < thresh, x / 0.75, torch.zeros(()))
    got = d(x, True, torch.Generator().manual_seed(1))
    assert torch.equal(got, ref)
    assert d(x, False, None) is x
    with pytest.raises(ValueError, match="explicit"):
        d(x, True, None)


# ---- the twins' mask and devices -----------------------------------------

@pytest.mark.parametrize("n", [1, 8, 13, 64, 101])
def test_mask_bits_round_trip(n):
    kept = torch.rand(n, generator=torch.Generator().manual_seed(n)) < 0.6
    bits = bt.pack_bits(kept)
    assert bits.dtype == torch.uint8 and bits.numel() == -(-n // 8)
    assert torch.equal(bt.unpack_bits(bits, n), kept)
    # byte v holds elements 8 v .. 8 v + 7, bit j element 8 v + j
    assert int(bits[0]) == sum(int(kept[j]) << j for j in range(min(n, 8)))


def test_apply_twin_masks_from_words_and_rounds_once():
    c = 5
    x, _ = _inputs(c)
    y = x.to(torch.bfloat16)
    p = _params(c)
    words = torch.randint(0, bt.WORDS, y.shape, dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2))
    thresh = 58982
    inv = torch.rsqrt(p["var"] + 1e-5) * p["scale"]
    out, bits = bt.apply_plain(y, words, thresh, p["mean"], inv, p["bias"],
                               p["alpha"])
    kept = words < thresh
    assert torch.equal(bt.unpack_bits(bits, y.numel()).view(y.shape), kept)
    z = (y.double() - p["mean"].double()) * inv.double() + p["bias"].double()
    z = torch.where(kept, z / (thresh / bt.WORDS), 0.0)
    ref = torch.where(z > 0, z, p["alpha"].double() * z)
    # one rounding of a value within f32 rounding of the exact one
    assert torch.equal(out, ref.to(torch.bfloat16)) or _err(
        out.double(), ref) <= 2.0 ** -8
    assert out.dtype == torch.bfloat16


def test_wrappers_refuse_devices_without_a_kernel():
    y = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bt.stats(y)
    v = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bt.finish(torch.zeros(16, device="meta"), 4.0, v, v.clone(), v)
    with pytest.raises(ValueError, match="unsupported device"):
        bt.bwd_finish(torch.zeros(17, device="meta"), v, 4.0, v, v)


def _finish_inputs(c, seed=0):
    """sums of y and y^2 over n = 40 rows (var > 0), running statistics,
    the scale, and bwd_reduce-like sums."""
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(40, c, generator=gen) * 1.5 + 0.3
    sums = torch.cat([y.sum(0), (y * y).sum(0)])
    run = [torch.rand(c, generator=gen), torch.rand(c, generator=gen) + 0.5]
    scale = torch.rand(c, generator=gen) + 0.5
    red = torch.randn(2 * c + 1, generator=gen) * 30.0
    return sums, run, scale, red


@pytest.mark.parametrize("c", [16, 96, 7])
def test_finishes_take_the_count_from_the_host_or_the_ranks(c):
    """The finishes on the CPU are their twins; given the count as a float
    (one process) or as the 0-d tensor the ranks summed (a batch-stats
    group), they agree to f32 rounding, and match BatchNorm's closed
    forms: mean, biased var, the unbiased running var, rstd, inv; dscale,
    c1 = -inv sum gh / n, c2 = -inv rstd^2 sum gh yhat / n."""
    sums, run, scale, red = _finish_inputs(c)
    n = 40.0
    outs = []
    for count in (n, torch.tensor(n)):
        r = [t.clone() for t in run]
        fwd = bt.finish(sums, count, *r, scale)
        ref = bt.finish_plain(sums, count, *[t.clone() for t in run], scale)
        assert all(torch.equal(a, b) for a, b in zip(fwd, ref))
        bwd = bt.bwd_finish(red, red[:2 * c], count, fwd[1], fwd[2])
        outs.append([*fwd, *r, *bwd])
    for a, b in zip(*outs):
        assert _err(a.double(), b.double()) <= 1e-6
    mean, rstd, inv, rmean, rvar, dscale, c1, c2 = (t.double()
                                                     for t in outs[0])
    s = sums.double().view(2, c)
    var = s[1] / n - (s[0] / n) ** 2
    d = red.double()
    want = [s[0] / n, (var + 1e-5) ** -0.5, (var + 1e-5) ** -0.5 * scale,
            0.9 * run[0] + 0.1 * s[0] / n, 0.9 * run[1] + 0.1 * var * n / 39,
            d[c:2 * c] * rstd, -inv * d[:c] / n,
            -inv * rstd * rstd * d[c:2 * c] / n]
    for k, (a, b) in enumerate(zip([mean, rstd, inv, rmean, rvar, dscale,
                                    c1, c2], want)):
        assert _err(a, b.double()) <= 1e-5, k


# ---- the sites -------------------------------------------------------------

def _count_sites(monkeypatch):
    calls = []
    real = bt.BNormDropPReLU.apply
    monkeypatch.setattr(bt.BNormDropPReLU, "apply",
                        lambda *a: (calls.append(a[0].shape), real(*a))[1])
    return calls


def test_convolution_takes_the_function_at_train_with_bn_and_prelu(
        monkeypatch):
    calls = _count_sites(monkeypatch)
    x = torch.randn(1, 3, 6, 6, 4)
    gen = torch.Generator().manual_seed(0)
    kw = dict(device="cpu", dtype=torch.float32)
    for dropout in (None, 0.0, 0.2):
        Convolution(4, 8, (3, 3, 1), dropout=dropout, **kw)(
            x, train=True, generator=gen)
    Convolution(4, 8, (3, 3, 3), strides=(2, 2, 2), is_transposed=True,
                **kw)(x, train=True)
    assert len(calls) == 4
    # not: the plain path, eval, no norm, another act, conv-only, attention
    Convolution(4, 8, (3, 3, 1), **kw)(x, train=True, use_kernels=False)
    Convolution(4, 8, (3, 3, 1), **kw)(x)
    Convolution(4, 8, (3, 3, 1), norm=None, **kw)(x, train=True)
    Convolution(4, 8, (3, 3, 1), act="relu", **kw)(x, train=True)
    Convolution(4, 8, (3, 3, 1), conv_only=True, **kw)(x, train=True)
    AttentionBlock1(4, (3, 3, 1), dtype=torch.float32, device="cpu")(
        x, train=True)
    assert len(calls) == 4


def _sites(model) -> int:
    return sum(1 for m in model.modules() if isinstance(m, Convolution)
               and m._fused_train(True))


def test_flagship_train_forward_runs_every_bn_prelu_site(monkeypatch):
    calls = _count_sites(monkeypatch)
    model = UNet2d5_spvPA(out_channels=2, dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(0),
                          **SMALL)
    x = torch.randn(1, 8, 16, 32, 1)
    model(x, train=True, generator=torch.Generator().manual_seed(1))
    # down_i 2 a level + bottom 2, downsample_i, upsample_i, up_1 and up_2
    assert len(calls) == _sites(model) == 3 * 2 + 2 + 3 + 3 + 2


def _step(use_kernels, remat=False, dtype=torch.float32, steps=2):
    """`steps` train steps of the small flagship with dropout 0.1 from seed
    0: (losses, state_dict, gradients of the last step)."""
    model = UNet2d5_spvPA(out_channels=2, dtype=dtype, dropout=0.1,
                          remat=remat, device="cpu",
                          generator=torch.Generator().manual_seed(0),
                          **SMALL)
    opt = ttrainer.make_optimizer(model.parameters(), 1e-3, 1e-7)
    step = ttrainer.make_train_step(model, opt, supervised_attention=True,
                                    hardness=True, use_kernels=use_kernels)
    rng = np.random.default_rng(4)
    gen = torch.Generator().manual_seed(3)
    losses = []
    for _ in range(steps):
        x = torch.tensor(rng.normal(size=(1, 8, 16, 32, 1)),
                         dtype=torch.float32).to(dtype)
        y = torch.tensor(rng.random((1, 8, 16, 32, 1)) > 0.8,
                         dtype=torch.float32)
        losses.append(float(step(x, y, gen)))
    return (losses, {k: v.clone() for k, v in model.state_dict().items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def test_train_step_kernel_route_matches_the_plain_path():
    """One Adam step with dropout, the kernels' route (twins) against
    use_kernels=False (eager chain, library conv backward), float32: loss
    1e-5 relative, gradients 1e-4 of the model's largest (the tolerance of
    test_torch_train.py's model-level gradient test), the BatchNorm
    statistics 1e-5 relative."""
    (l0, s0, g0), (l1, s1, g1) = _step(False, steps=1), _step(True, steps=1)
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    scale = max(float(g.abs().max()) for g in g0.values())
    for name in g0:
        assert float((g1[name] - g0[name]).abs().max()) <= 1e-4 * scale, name
    for k in s0:
        if k.endswith((".mean", ".var")):
            assert _err(s1[k].double(), s0[k].double()) <= 1e-5, k


def test_remat_is_bit_equal_on_the_kernel_route_in_bf16():
    """--remat replays the forward's draws: bf16 losses, state and
    gradients bit-equal with and without it."""
    (l0, s0, g0), (l1, s1, g1) = (_step(True, remat, torch.bfloat16, 1)
                                  for remat in (False, True))
    assert l0 == l1
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_recomputes_the_forward_passes_of_its_levels(monkeypatch,
                                                           remat):
    """Each site runs each pass once a step; under --remat the sites of the
    blocks it rematerialises (down_i, downsample_i, upsample_i and up_i at
    the top REMAT_LEVELS levels) run the forward passes (stats, finish,
    apply: FORWARD_LAUNCHES launches on the card) once more, and the
    backward passes still once."""
    from vs_seg_tpu_torch.models.unet2d5_spvpa import REMAT_LEVELS
    calls = dict.fromkeys(("stats", "finish", "apply", "bwd_reduce",
                           "bwd_finish", "bwd_apply"), 0)
    for name in calls:
        real = getattr(bt, name)

        def counted(*args, _name=name, _real=real):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(bt, name, counted)
    _step(True, remat, steps=1)
    model = UNet2d5_spvPA(out_channels=2, dtype=torch.float32, device="cpu",
                          **SMALL)
    sites = _sites(model)
    again = sum(_sites(getattr(model, f"{k}_{i}"))
                for k in ("down", "downsample", "upsample", "up")
                for i in range(REMAT_LEVELS)) if remat else 0
    assert 0 < again < sites or not remat
    forward = sites + again
    assert calls == {"stats": forward, "finish": forward, "apply": forward,
                     "bwd_reduce": sites, "bwd_finish": sites,
                     "bwd_apply": sites}
    assert bt.FORWARD_LAUNCHES + 4 == bt.LAUNCHES_PER_SITE


# ---- the kernels' names ----------------------------------------------------

def _global_names():
    src = CSRC.read_text()
    return sorted(set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        src)))


def test_kernel_names_land_in_the_elementwise_and_reduction_families():
    """benchmark/trace.py:kernel_family puts each __global__ of
    csrc/bnorm_train.cu, bare and as the profiler names a template
    instance, in "reduction" (elementwise_ms.train reads that family and
    "elementwise")."""
    names = _global_names()
    assert names == ["bnorm_apply_kernel", "bnorm_bwd_apply_kernel",
                     "bnorm_bwd_finish_kernel", "bnorm_bwd_reduce_kernel",
                     "bnorm_finish_kernel", "bnorm_stats_kernel",
                     "bnorm_sum_kernel"]
    for name in names:
        assert "norm" in name
        assert not re.search(r"conv|gemm|copy|memcpy", name, re.I)
        for shown in (name, f"void (anonymous namespace)::{name}<"
                      f"__nv_bfloat16, true>(__nv_bfloat16 const*, int "
                      f"const*, int, float, float const*, float const*, "
                      f"float const*, float const*, long long, int, "
                      f"__nv_bfloat16*, unsigned char*)"):
            assert kernel_family(shown) in ("reduction", "elementwise"), shown
