"""The port's core/observability.py against vs_seg_tpu/core/observability.py,
on the CPU: StepTimer on the same step times (time.perf_counter patched,
so both read one sequence), profile_trace disabled and enabled, and
make_image_grid; the same cases as tests/test_observability.py."""

import logging
import time

import numpy as np
import pytest
import torch

from vs_seg_tpu.core import observability as jobs
from vs_seg_tpu_torch.core import observability as tobs

# perf_counter readings, a (start, stop) pair per step
CLOCKS = {
    "even": [0.0, 0.5, 1.0, 1.5, 2.0, 2.5],
    "uneven": [10.0, 10.25, 11.0, 13.0, 13.5, 13.625, 20.0, 20.001],
}


def _run(module, monkeypatch, readings, total_steps, caplog):
    clock = iter(readings)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    t = module.StepTimer(total_steps=total_steps)
    dts = []
    for _ in range(len(readings) // 2):
        t.start()
        dts.append(t.stop())
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="steptimer"):
        t.log(logging.getLogger("steptimer"), prefix="epoch 1 ")
    return (dts, t.avg, t.count, t.steps_per_sec, t.eta_seconds(),
            [r.getMessage() for r in caplog.records])


@pytest.mark.parametrize("total_steps", [None, 12, 3])
@pytest.mark.parametrize("clock", list(CLOCKS))
def test_step_timer_matches_jax(monkeypatch, caplog, clock, total_steps):
    got = _run(tobs, monkeypatch, CLOCKS[clock], total_steps, caplog)
    ref = _run(jobs, monkeypatch, CLOCKS[clock], total_steps, caplog)
    assert got == ref
    assert len(got[5]) == 1 and got[5][0].startswith("epoch 1 avg_step=")
    assert (got[4] is None) == (total_steps is None)


def test_step_timer_eta():
    t = tobs.StepTimer(total_steps=10)
    for _ in range(3):
        t.start()
        time.sleep(0.01)
        t.stop()
    assert t.count == 3
    assert t.avg >= 0.01
    assert t.steps_per_sec > 0
    eta = t.eta_seconds()
    assert eta is not None and eta > 0
    t.log(logging.getLogger(), prefix="test ")


def test_step_timer_before_any_step():
    for module in (tobs, jobs):
        t = module.StepTimer(total_steps=5)
        assert t.steps_per_sec == 0.0 and t.eta_seconds() is None


def test_make_image_grid_matches_jax(rng):
    imgs = [rng.normal(size=(8, 6)) for _ in range(5)] + [np.ones((4, 3))]
    for kw in (dict(ncols=2, pad=1), dict(ncols=8, pad=2, normalize=False)):
        got = tobs.make_image_grid(imgs, **kw)
        np.testing.assert_array_equal(got, jobs.make_image_grid(imgs, **kw))
    grid = tobs.make_image_grid(imgs[:5], ncols=2, pad=1)
    assert grid.shape == (3 * 9 + 1, 2 * 7 + 1)
    tile = grid[1:9, 1:7]
    assert np.isclose(tile.max(), 1.0) and np.isclose(tile.min(), 0.0)


def test_profile_trace_disabled_noop(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the profiler was started")

    monkeypatch.setattr(tobs, "start_trace", refuse)
    with tobs.profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        torch.ones(4).sum()
    assert prof is None
    assert not (tmp_path / "off").exists()


def test_profile_trace_writes_a_trace_on_exit(tmp_path):
    out = tmp_path / "on"
    with tobs.profile_trace(str(out), device="cpu") as prof:
        assert prof is not None
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        assert not list(out.glob("*.pt.trace.json"))
    traces = list(out.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_profile_trace_stops_when_the_body_raises(tmp_path):
    out = tmp_path / "raised"
    with pytest.raises(RuntimeError, match="body"):
        with tobs.profile_trace(str(out), device="cpu"):
            torch.ones(4).sum()
            raise RuntimeError("body")
    assert len(list(out.glob("*.pt.trace.json"))) == 1
    # the profiler was stopped: a second trace can start
    with tobs.profile_trace(str(tmp_path / "again"), device="cpu"):
        torch.ones(4).sum()
    assert len(list((tmp_path / "again").glob("*.pt.trace.json"))) == 1
