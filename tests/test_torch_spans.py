"""The port's spans (core/observability.py:span) on the CPU: the shared
no-op while nothing records or traces, the host-clock registry (nesting,
reset, threads), the profiler ranges under torch.profiler.profile and
start_trace, and the spans that run_inference, the train step and the
three models open, which change no output."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from vs_seg_tpu_torch.core import observability as obs
from vs_seg_tpu_torch.core.config import Config
from vs_seg_tpu_torch.infer import engine
from vs_seg_tpu_torch.models import UNet, UNet2d5, UNet2d5_spvPA
from vs_seg_tpu_torch.train.trainer import make_optimizer, make_train_step

SMALL = dict(channels=(4, 8, 12), strides=((2, 2, 1), (2, 2, 2)),
             kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
             sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
VOLUME = engine.segmentation_volume_ml
INFER_SPANS = ("infer.stage", "infer.stage_wait", "infer.forward_blend",
               "infer.label_upload", "infer.dice", "infer.argmax_copy",
               "infer.volumetry")


@pytest.fixture(autouse=True)
def _empty_registry():
    obs.reset()
    yield
    obs.reset()


def test_disabled_span_is_the_shared_noop():
    assert obs.span("a") is obs.span("b")
    with obs.span("a") as got:
        torch.ones(2).sum()
    assert got is None and obs.spans() == {}


def test_recording_counts_nested_spans_and_reset_clears():
    with obs.recording():
        for _ in range(3):
            with obs.span("outer"):
                with obs.span("inner"):
                    time.sleep(0.002)
                with obs.span("inner"):
                    pass
    with obs.span("outer"):      # recording is off again
        pass
    got = obs.spans()
    assert set(got) == {"outer", "inner"}
    assert got["outer"]["count"] == 3 and got["inner"]["count"] == 6
    assert got["inner"]["max_ms"] >= 2.0
    assert got["inner"]["total_ms"] >= 6.0
    assert got["outer"]["total_ms"] >= got["inner"]["total_ms"]
    assert got["outer"]["max_ms"] <= got["outer"]["total_ms"]
    obs.reset()
    assert obs.spans() == {}


def test_span_counts_a_body_that_raises_and_recording_restores():
    with obs.recording():
        with obs.recording():
            pass
        with pytest.raises(ValueError, match="body"):
            with obs.span("raised"):
                raise ValueError("body")
    with obs.span("raised"):      # both recordings have ended
        pass
    assert obs.spans()["raised"]["count"] == 1


def test_two_threads_lose_no_count():
    n = 3000
    start = threading.Barrier(2)

    def work():
        start.wait()
        for _ in range(n):
            with obs.span("shared"):
                pass

    with obs.recording():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert obs.spans()["shared"]["count"] == 2 * n


def test_reset_while_a_span_is_open_on_another_thread():
    opened, closing = threading.Event(), threading.Event()

    def work():
        with obs.span("open"):
            opened.set()
            closing.wait(5)
        with obs.span("after"):
            pass

    with obs.recording():
        t = threading.Thread(target=work)
        t.start()
        opened.wait(5)
        obs.reset()
        closing.set()
        t.join()
    got = obs.spans()
    assert "open" not in got
    assert got == {"after": {"count": 1, "total_ms": got["after"]["total_ms"],
                             "max_ms": got["after"]["max_ms"]}}


def _profiled(how: str, tmp_path, body):
    """The complete events of a CPU trace of `body`, taken by
    torch.profiler.profile or start_trace."""
    if how == "profile":
        with torch.profiler.profile() as prof:
            body()
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
    else:
        prof = obs.start_trace(str(tmp_path / "prof"), device="cpu")
        body()
        prof.stop()
        (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


@pytest.mark.parametrize("how", ["profile", "start_trace"])
def test_span_is_one_profiler_range(how, tmp_path):
    def body():
        with obs.span("train.forward"):
            with obs.span("model.down_0"):
                torch.ones(8, 8).sum()
            with obs.span("model.down_1"):
                torch.ones(8, 8).sum()

    events = _profiled(how, tmp_path, body)
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"
           and e["name"].startswith(("train.", "model."))}
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ("train.forward", "model.down_0", "model.down_1"):
        assert names.count(name) == 1
    tids = {e["tid"] for e in ann.values()}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert len(tids) == 1 and tids == {ops[0]["tid"]}
    outer = ann["train.forward"]
    for child in ("model.down_0", "model.down_1"):
        e = ann[child]
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    assert obs.spans() == {}


def _cases(n=2):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        img = rng.normal(size=(1, 1, 18, 18, 8)).astype(np.float32)
        out.append({"image": img, "label": (img > 0.3).astype(np.float32),
                    "label_meta": [{"affine": np.eye(4)}]})
    return out


def _infer(record: bool, monkeypatch):
    """run_inference of a small flagship over two cases: (Dice scores,
    the labelmaps handed to volumetry, the threads each span ran on)."""
    torch.manual_seed(0)
    model = UNet2d5_spvPA(out_channels=2, dtype=torch.float32, device="cpu",
                          **SMALL)
    cfg = Config(device="cpu", compute_dtype="float32", infer_dtype="float32",
                 sliding_window_inferer_roi_size=(16, 16, 8),
                 sw_batch_size=2, export_inferred_segmentations=False,
                 **SMALL)
    labelmaps, threads = [], {}

    def keep(labelmap, affine):
        labelmaps.append(np.array(labelmap))
        return VOLUME(labelmap, affine)

    def seen(name):
        threads.setdefault(name, set()).add(threading.get_ident())
        return obs.span(name)

    monkeypatch.setattr(engine, "segmentation_volume_ml", keep)
    monkeypatch.setattr(engine, "span", seen)
    if record:
        with obs.recording():
            dice, _ = engine.run_inference(cfg, model, _cases(), device="cpu",
                                           make_figures=False)
    else:
        dice, _ = engine.run_inference(cfg, model, _cases(), device="cpu",
                                       make_figures=False)
    return dice, labelmaps, threads


def test_run_inference_spans_once_a_case(monkeypatch):
    dice, labelmaps, threads = _infer(True, monkeypatch)
    got = obs.spans()
    assert {k: v["count"] for k, v in got.items()
            if k.startswith("infer.")} == {k: 2 for k in INFER_SPANS}
    main = threading.get_ident()
    assert main not in threads["infer.stage"]
    for name in INFER_SPANS[1:]:
        assert threads[name] == {main}
    obs.reset()
    dice_off, labelmaps_off, _ = _infer(False, monkeypatch)
    assert obs.spans() == {}
    np.testing.assert_array_equal(dice, dice_off)
    assert len(labelmaps) == len(labelmaps_off) == 4
    for a, b in zip(labelmaps, labelmaps_off):
        np.testing.assert_array_equal(a, b)


def test_profile_trace_of_run_inference_holds_its_ranges(tmp_path):
    """profile_trace around run_inference: the engine thread's infer.*
    ranges once a case, the model's inside infer.forward_blend."""
    torch.manual_seed(0)
    model = UNet2d5_spvPA(out_channels=2, dtype=torch.float32, device="cpu",
                          **SMALL)
    cfg = Config(device="cpu", compute_dtype="float32", infer_dtype="float32",
                 sliding_window_inferer_roi_size=(16, 16, 8),
                 sw_batch_size=2, export_inferred_segmentations=False,
                 **SMALL)
    with obs.profile_trace(str(tmp_path), device="cpu"):
        engine.run_inference(cfg, model, _cases(), device="cpu",
                             make_figures=False)
    (path,) = tmp_path.glob("*.pt.trace.json")
    ann = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = [e["name"] for e in ann]
    for name in INFER_SPANS[1:]:
        assert names.count(name) == 2, name
    blends = [e for e in ann if e["name"] == "infer.forward_blend"]
    models = [e for e in ann if e["name"].startswith("model.")]
    assert models
    for e in models:
        assert any(b["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= b["ts"] + b["dur"] for b in blends)
    assert obs.spans() == {}


def _steps(record: bool):
    """Two train steps of a small flagship (dropout 0.1, float32): (the
    losses, the parameters after, the profiler's events with recording on,
    else None)."""
    torch.manual_seed(0)
    model = UNet2d5_spvPA(out_channels=2, dtype=torch.float32, device="cpu",
                          **SMALL)
    opt = make_optimizer(model.parameters(), 1e-3, 1e-7)
    step = make_train_step(model, opt, supervised_attention=True,
                           hardness=False)
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 4, 8, 8, 1)).astype(
        np.float32))
    y = (x > 0.3).to(torch.uint8)
    losses, events = [], None
    if record:
        with obs.recording(), torch.profiler.profile() as prof:
            for _ in range(2):
                losses.append(step(x, y, gen))
        events = prof.events()
    else:
        for _ in range(2):
            losses.append(step(x, y, gen))
    return losses, dict(model.named_parameters()), events


def test_train_step_spans_and_bit_equal_state():
    losses, params, events = _steps(True)
    got = {k: v["count"] for k, v in obs.spans().items()}
    assert {k: v for k, v in got.items() if k.startswith("train.")} == {
        "train.forward": 2, "train.loss": 2, "train.backward": 2,
        "train.optimizer": 4}
    assert got["model.down_0"] == 2 and got["model.up_0"] == 2
    # every model.* range lies inside a train.forward one
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith(("train.", "model."))]
    forwards = [(s, t) for n, s, t in ranges if n == "train.forward"]
    models = [(s, t) for n, s, t in ranges if n.startswith("model.")]
    assert len(forwards) == 2 and len(models) == got["model.down_0"] * len(
        [k for k in got if k.startswith("model.")])
    for s, t in models:
        assert any(fs <= s and t <= ft for fs, ft in forwards)
    obs.reset()
    losses_off, params_off, _ = _steps(False)
    assert obs.spans() == {}
    for a, b in zip(losses, losses_off):
        assert torch.equal(a, b)
    for name, p in params.items():
        assert torch.equal(p, params_off[name]), name


def _model(name: str):
    torch.manual_seed(0)
    if name == "UNet2d5_spvPA":
        return UNet2d5_spvPA(out_channels=2, dtype=torch.float32,
                             device="cpu", **SMALL)
    if name == "UNet2d5":
        return UNet2d5(out_channels=2, dtype=torch.float32, device="cpu",
                       **SMALL)
    return UNet(out_channels=2, channels=(4, 8, 12),
                strides=((2, 2, 1), (2, 2, 2)), num_res_units=2,
                dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("name", ["UNet2d5_spvPA", "UNet2d5", "UNet"])
def test_model_opens_a_span_per_top_level_child_call(name):
    model = _model(name)
    net = model.net if name == "UNet2d5" else model
    calls = {}
    for child, m in net.named_children():
        m.register_forward_pre_hook(
            lambda mod, args, child=child: calls.__setitem__(
                child, calls.get(child, 0) + 1))
    x = torch.randn(1, 4, 8, 8, 1)
    with obs.recording():
        model(x, train=True, generator=torch.Generator().manual_seed(1))
    got = {k: v["count"] for k, v in obs.spans().items()}
    assert got == {f"model.{k}": v for k, v in calls.items()}
    assert set(calls) == set(dict(net.named_children()))
    assert set(calls.values()) == {1}


def test_routed_decoder_block_is_its_up_span():
    """At eval the (3,3,3) decoder level 1 takes the l2_block route: its
    upatt_1 and up_1 run as one block, under model.up_1 alone."""
    model = _model("UNet2d5_spvPA")
    with obs.recording(), torch.no_grad():
        model(torch.randn(1, 4, 8, 8, 1))
    got = {k: v["count"] for k, v in obs.spans().items()}
    want = {f"model.{k}": 1 for k in dict(model.named_children())
            if k != "upatt_1"}
    assert got == want
