"""The PReLU slope gradient of a bf16 conv -> BatchNorm -> PReLU unit at train,
the port (vs_seg_tpu_torch/nn/layers.py:PReLU) against the JAX package
(vs_seg_tpu/nn/layers.py:PReLU), on the CPU.

Both units get the same weights (the JAX ones, loaded into the port), the
same bf16 input and the same bf16 upstream gradient. A slope's gradient is
sum(g * min(y, 0)) over the whole activation y. Each is held to two
float64 sums: (a) over its own pre-activation y, which isolates the
reduction's rounding, and (b) over the pre-activation of the whole unit
computed in float64 from the bf16-rounded input and weights. JAX's y is
bf16 and its gradient one bf16 value; the port's train unit
(ops/bnorm_train.py) forms y = (conv - mean) * inv + bias in float32 and
never rounds it, and sums the products in float32. The port's error may
exceed JAX's by at most one bf16 ulp of the result, and its error against
(a) stays within 2^-8 of sum(|g * min(y, 0)|). `pytest -s` prints each
case's values and errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vs_seg_tpu.nn.blocks import Convolution as JConvolution
from vs_seg_tpu.nn.layers import BatchNorm as JBatchNorm
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.nn.blocks import Convolution
from vs_seg_tpu_torch.nn.layers import BN_EPS
from vs_seg_tpu_torch.ops import bnorm_train

SHAPE = (2, 8, 16, 16)       # (N, D, H, W)
CIN, COUT = 4, 8


def _ulp(v: float) -> float:
    """One bf16 ulp (8 significand bits) at |v|."""
    return 2.0 ** (int(np.floor(np.log2(abs(v)))) - 7)


def _bf16(a) -> np.ndarray:
    """float32 numpy copy of a bf16-rounded array."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _case(kernel, seed):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(*SHAPE, CIN)))
    g = _bf16(rng.normal(size=(*SHAPE, COUT)))
    jm = JConvolution(features=COUT, kernel_size=kernel, dtype=jnp.bfloat16)
    v = jm.init({"params": jax.random.key(seed), "dropout": jax.random.key(1)},
                jnp.asarray(x, jnp.bfloat16), train=False)
    params = jax.tree_util.tree_map(lambda a: a, v["params"])
    params["norm"]["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, COUT),
                                          jnp.float32)
    params["norm"]["bias"] = jnp.asarray(rng.normal(size=COUT) * 0.3,
                                         jnp.float32)
    params["act"]["alpha"] = jnp.asarray([rng.uniform(0.1, 0.4)], jnp.float32)
    return x, g, jm, {"params": params, "batch_stats": v["batch_stats"]}


def _jax_slope_grad(x, g, jm, v):
    """(slope gradient, bf16 pre-activation) of the JAX unit at train."""
    def f(params):
        y, state = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(x, jnp.bfloat16), train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JBatchNorm))
        return y, state["intermediates"]["norm"]["__call__"][0]

    _, vjp, pre = jax.vjp(f, v["params"], has_aux=True)
    grads = vjp(jnp.asarray(g, jnp.bfloat16))[0]
    return (float(grads["act"]["alpha"][0]),
            np.asarray(pre.astype(jnp.float32), np.float64))


def _port_slope_grad(x, g, tm, monkeypatch):
    """(slope gradient, float32 pre-activation) of the port's unit at
    train: its apply pass's z, recomputed by the twin from the pass's own
    inputs."""
    pre = {}
    real = bnorm_train.apply

    def apply(y, words, thresh, mean, inv, bias, alpha):
        pre.setdefault("y", bnorm_train._centred(y, mean, inv, bias)[1]
                       .view(y.shape))
        return real(y, words, thresh, mean, inv, bias, alpha)

    monkeypatch.setattr(bnorm_train, "apply", apply)
    out = tm(torch.from_numpy(x).to(torch.bfloat16), train=True)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    return float(tm.act.alpha.grad[0]), pre["y"].double().numpy()


def _float64_preactivation(x, kernel, tm):
    """conv (bf16-rounded kernel and bias, as both packages cast them) ->
    BatchNorm on the batch statistics, in float64."""
    k = tuple(int(v) for v in kernel)
    w = tm.conv.kernel.detach().to(torch.bfloat16).double()
    b = tm.conv.bias.detach().to(torch.bfloat16).double()
    c = F.conv3d(torch.from_numpy(x).double().permute(0, 4, 1, 2, 3),
                 w.permute(4, 3, 2, 0, 1), b,
                 padding=((k[2] - 1) // 2, (k[0] - 1) // 2, (k[1] - 1) // 2))
    c = c.permute(0, 2, 3, 4, 1)
    mean = c.mean((0, 1, 2, 3))
    var = ((c - mean) ** 2).mean((0, 1, 2, 3))
    y = ((c - mean) / torch.sqrt(var + BN_EPS) * tm.norm.scale.detach().double()
         + tm.norm.bias.detach().double())
    return y.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kernel", [(3, 3, 1), (3, 3, 3)])
def test_slope_gradient_rounds_no_worse_than_jax(kernel, seed, monkeypatch):
    x, g, jm, v = _case(kernel, seed)
    j_grad, j_pre = _jax_slope_grad(x, g, jm, v)
    tm = Convolution(CIN, COUT, kernel, act="prelu", norm="batch",
                     dtype=torch.bfloat16, device="cpu")
    load_jax_variables(tm, v)
    t_grad, t_pre = _port_slope_grad(x, g, tm, monkeypatch)
    g64 = g.astype(np.float64)

    def exact(pre):
        return float((g64 * np.minimum(pre, 0.0)).sum())

    own_t, own_j = exact(t_pre), exact(j_pre)
    full = exact(_float64_preactivation(x, kernel, tm))
    err_t, err_j = abs(t_grad - own_t), abs(j_grad - own_j)
    print(f"kernel {kernel} seed {seed}: port {t_grad!r} (own-preactivation "
          f"sum {own_t!r}, error {err_t!r}), JAX {j_grad!r} ({own_j!r}, "
          f"{err_j!r}); float64 unit {full!r}: errors {abs(t_grad - full)!r}"
          f" / {abs(j_grad - full)!r}; bf16 ulp {_ulp(own_t)!r}")
    assert err_t <= err_j + _ulp(own_t), (t_grad, own_t, j_grad, own_j)
    assert abs(t_grad - full) <= abs(j_grad - full) + _ulp(full), (
        t_grad, j_grad, full)
    terms = float(np.abs(g64 * np.minimum(t_pre, 0.0)).sum())
    assert err_t <= 2.0 ** -8 * terms, (err_t, terms)
