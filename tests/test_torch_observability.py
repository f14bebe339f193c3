"""The port's core/observability.py against vs_seg_tpu/core/observability.py,
on the CPU: profile_trace disabled and enabled, and make_image_grid; the
spans are tests/test_torch_spans.py's."""

import numpy as np
import pytest
import torch

from vs_seg_tpu.core import observability as jobs
from vs_seg_tpu_torch.core import observability as tobs


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
