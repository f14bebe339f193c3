"""The port's Mosaic probes (vs_seg_tpu_torch/ops/mosaic_probe.py) against
the probes they replace, tools/mosaic_probe.py, run through pl.pallas_call
in interpret mode on the CPU.

Two kinds of input:
- the tool's own all-ones inputs, through the tool's case functions (its
  pl.pallas_call shimmed with interpret=True): every sum is a small integer,
  so the twin's `sum=` must equal the tool's exactly;
- seeded normals from numpy, through the case bodies reproduced below (the
  tool builds its inputs inside each case). Sums of f32 values taken in
  another order agree within PROBE_RTOL of the largest output; repeat,
  dotbcast (one nonzero product per output) and 3droll (the same two adds
  in the same order) are bit-equal.
"""

import importlib.util
import re
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vs_seg_tpu_torch.ops import mosaic_probe as mp

_TOOL = Path(__file__).resolve().parents[1] / "tools" / "mosaic_probe.py"
PROBE_RTOL = 1e-5
# pltpu.roll with shift -1 does not run in interpret mode (jax 0.9: "shift
# must be non-negative"), so case_3droll is held against np.roll instead
INTERPRETABLE = tuple(c for c in mp.CASES if c != "3droll")


def _tool():
    """tools/mosaic_probe.py with its pallas_call in interpret mode."""
    spec = importlib.util.spec_from_file_location("mosaic_probe_tool", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=partial(pl.pallas_call, interpret=True))
    return mod


def _sum_of(report: str) -> float:
    return float(re.search(r"sum=([-0-9.e+]+)", report).group(1))


@pytest.mark.parametrize("case", INTERPRETABLE)
def test_twin_matches_tool_case_on_its_inputs(case):
    tool = _tool()
    report = tool.CASES[case]()
    out = mp.probe(case, *mp.inputs(case))
    assert float(out.sum()) == _sum_of(report)
    if "expect" in report:
        assert float(out.sum()) == float(report.split("expect ")[1][:-1])


def test_3droll_twin_matches_np_roll():
    """The tool's 3droll needs pltpu.roll(x, -1), which interpret mode
    refuses; a circular shift of -1 along W is a shift of W - 1."""
    rng = np.random.default_rng(3)
    for x in (np.ones((mp.HT, mp.W, mp.CM), np.float32),
              rng.standard_normal((mp.HT, mp.W, mp.CM)).astype(np.float32)):
        want = x + np.roll(x, 1, 1) + np.roll(x, mp.W - 1, 1)
        got = mp.probe("3droll", torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)


def _interpret(kernel, out_shape, *args):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(*(jnp.asarray(a) for a in args)))


def _pallas_case(case, ins):
    """The tool's kernel bodies on the given inputs (numpy)."""
    x = ins[0]
    if case in mp.GROUP:
        cm = mp.GROUP[case]
        rows, cols = x.shape[0], int(np.prod(x.shape[1:]))

        def k(x_ref, o_ref):
            o_ref[...] = jnp.sum(x_ref[...].reshape(rows, cols // cm, cm),
                                 axis=-1)
        return _interpret(k, (rows, cols // cm), x.reshape(rows, cols))
    if case in ("dotreduce", "dotbcast"):
        contract = 0 if case == "dotreduce" else 1

        def k(a_ref, m_ref, o_ref):
            o_ref[...] = jax.lax.dot_general(
                a_ref[...], m_ref[...], (((1,), (contract,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
        n = mp.W if case == "dotreduce" else mp.WC
        return _interpret(k, (x.shape[0], n), x, ins[1])
    if case == "repeat":
        def k(a_ref, o_ref):
            o_ref[...] = jnp.repeat(a_ref[...], mp.CM, axis=1)
        return _interpret(k, (x.shape[0], x.shape[1] * mp.CM), x)
    if case == "narrow":
        def k(x_ref, g_ref, o_ref):
            s = jnp.sum(x_ref[...], axis=1, keepdims=True)
            o_ref[...] = s * g_ref[...] + g_ref[...]
        return _interpret(k, x.shape, x, ins[1])
    raise KeyError(case)


@pytest.mark.parametrize("case", INTERPRETABLE)
def test_twin_matches_pallas_body_on_seeded_inputs(case):
    ins = mp.inputs(case, seed=11)
    want = _pallas_case(case, [t.numpy() for t in ins])
    got = mp.probe(case, *ins).numpy()
    assert got.shape == want.shape
    if case in ("repeat", "dotbcast"):
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got - want).max()
        assert err <= PROBE_RTOL * np.abs(want).max(), err


def test_inputs_are_the_tools_and_seeded_inputs_are_reproducible():
    for case in mp.CASES:
        ones = mp.inputs(case)
        assert all(t.dtype == torch.float32 for t in ones)
        assert [tuple(t.shape) for t in ones[:1]] == [mp._shapes(case)[0]]
        a, b = mp.inputs(case, seed=5), mp.inputs(case, seed=5)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    m = mp.group_matrix()
    assert tuple(m.shape) == (mp.WC, mp.W)
    assert torch.equal(m.sum(0), torch.full((mp.W,), float(mp.CM)))


def test_moved_bytes_counts_each_input_once():
    ins = mp.inputs("narrow")          # x passed twice, as in the tool
    out = mp.plain("narrow", *ins)
    assert mp.moved_bytes("narrow", ins, out) == 2 * 512 * mp.CM * 4
    ins = mp.inputs("dotreduce")
    out = mp.plain("dotreduce", *ins)
    assert mp.moved_bytes("dotreduce", ins, out) == 4 * (
        mp.HT * mp.WC + mp.WC * mp.W + mp.HT * mp.W)


def test_probe_refuses_other_devices_and_unknown_cases():
    x = torch.zeros((mp.HT, mp.WC), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mp.probe("reshape3d", x)
    with pytest.raises(KeyError):
        mp.probe("nosuch", torch.zeros(1))
    with pytest.raises(KeyError):
        mp.inputs("nosuch")


def test_probe_counts_no_launch_on_cpu():
    n0 = mp.probe.launches
    for case in mp.CASES:
        mp.probe(case, *mp.inputs(case))
    assert mp.probe.launches == n0


def test_entry_point_on_cpu_prints_the_tools_sums(capsys):
    assert mp.main(["--device", "cpu", "reshape3d", "narrow"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0].split()[-1] for ln in lines] == [
        "reshape3d", "narrow"]
    assert all(ln.startswith("[OK]") for ln in lines)
    assert _sum_of(lines[0]) == mp.HT * mp.WC
    assert _sum_of(lines[1]) == 512 * mp.CM * (mp.CM + 1)


def test_entry_point_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mp.main(["reshape3d"])
