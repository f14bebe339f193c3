"""The port's ring probe (vs_seg_tpu_torch/ops/ring_probe.py) against the
Mosaic probe it replaces, tools/ring_probe.py:_kernel, run through
pl.pallas_call in interpret mode on the CPU. Inputs come from numpy with a
fixed seed; the probe is two exact doublings and one f32 add on both sides,
so the outputs must be equal bit for bit.
"""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vs_seg_tpu_torch.ops import ring_probe as rp

_PROBE = Path(__file__).resolve().parents[1] / "tools" / "ring_probe.py"


def _tool():
    spec = importlib.util.spec_from_file_location("ring_probe_tool", _PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_probe(x: np.ndarray, d: int) -> np.ndarray:
    """tools/ring_probe.py:run's pallas_call at any d, interpreted."""
    rows = rp.ROWS
    out = pl.pallas_call(
        partial(_tool()._kernel, rows=rows, d=d),
        grid=(d + 2,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(
            (rows, 128), lambda s: (jnp.clip(s - 2, 0, d - 1), 0),
            memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((d * rows, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((3, rows, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA],
        interpret=True,
    )(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("d", [1, 2, 5, 7])
def test_ring_probe_twin_matches_pallas_bit_for_bit(d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(d * rp.ROWS, rp.LANES)).astype(np.float32)
    ref = _pallas_probe(x, d)
    got = rp.ring_probe(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ring_probe_refuses_other_devices():
    x = torch.zeros((16, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rp.ring_probe(x)


def test_ring_probe_counts_no_launch_on_cpu():
    n0 = rp.ring_probe.launches
    rp.ring_probe(torch.ones((32, 128)))
    assert rp.ring_probe.launches == n0
