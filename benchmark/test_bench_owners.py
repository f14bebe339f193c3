"""owners.attribute on a small chrome trace built by hand: a kernel owned
through its `correlation` by the span around its launch, a backward kernel
launched from another thread owned through its forward op's `Sequence
number`, the fallback to the main thread, an unowned kernel; and the
readers of the phases and of levels 0-1."""

import pytest

from benchmark import owners

MAIN, AUTOGRAD, OTHER = 1, 2, 3
EW = "void at::native::vectorized_elementwise_kernel<4, X>"
CONV = "sm80_xmma_fprop_implicit_gemm_bf16"


def span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def op(name, ts, dur, tid, seq=None, fwd=0):
    args = {} if seq is None else {"Sequence number": seq,
                                   "Fwd thread id": fwd}
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def launch(corr, ts, tid):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1.0, "tid": tid, "args": {"correlation": corr}}


def kernel(corr, ts, dur, name=EW):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr}}


def trace():
    """One step: forward (model.down_0 then model.up_0), loss, backward on
    autograd's thread, Adam; a batch kernel before the step."""
    return [
        span("bench.traced", 0, 1000),
        span("bench.next_batch", 10, 20),
        launch(1, 15, MAIN), kernel(1, 20, 5),              # unowned
        span("bench.train_step", 40, 900),
        span("train.forward", 50, 300),
        span("model.down_0", 60, 100),
        op("aten::mul", 70, 20, MAIN, seq=11),
        launch(2, 75, MAIN), kernel(2, 80, 10),             # down_0 fwd
        span("model.up_0", 200, 100),
        op("aten::convolution", 210, 30, MAIN, seq=12),
        launch(3, 215, MAIN), kernel(3, 220, 40, CONV),     # up_0 fwd
        op("aten::add", 250, 10, MAIN, seq=13),
        launch(4, 252, MAIN), kernel(4, 262, 8),            # up_0 fwd
        span("train.loss", 360, 40),
        op("aten::mean", 365, 10, MAIN, seq=14),
        launch(5, 366, MAIN), kernel(5, 370, 4),            # loss fwd
        span("train.backward", 420, 300),
        # the backward of aten::add (up_0), aten::mean (loss), aten::mul
        # (down_0), on autograd's thread; then one outside any backward op
        op(owners.BACKWARD + "MeanBackward0", 430, 20, AUTOGRAD, 14, 1),
        op("MeanBackward0", 431, 18, AUTOGRAD, 14, 1),
        launch(6, 435, AUTOGRAD), kernel(6, 440, 6),
        op(owners.BACKWARD + "AddBackward0", 460, 20, AUTOGRAD, 13, 1),
        launch(7, 465, AUTOGRAD), kernel(7, 470, 12),
        op(owners.BACKWARD + "MulBackward0", 500, 20, AUTOGRAD, 11, 1),
        launch(8, 505, AUTOGRAD), kernel(8, 510, 16),
        launch(9, 600, AUTOGRAD), kernel(9, 605, 3),         # fallback
        span("train.optimizer", 750, 100),
        launch(10, 760, OTHER), kernel(10, 770, 20),         # fallback
        launch(11, 990, MAIN), kernel(11, 995, 30),          # half in window
    ]


def test_attribute_by_owner_and_phase():
    att = owners.attribute(trace())
    got = {k: round(v * 1e6, 6) for k, v in att["device_s"].items()}
    assert got == {
        (None, None, "elementwise"): 5.0 + 5.0,
        ("model.down_0", "train.forward", "elementwise"): 10.0,
        ("model.up_0", "train.forward", "library conv"): 40.0,
        ("model.up_0", "train.forward", "elementwise"): 8.0,
        ("train.loss", "train.loss", "elementwise"): 4.0,
        ("train.loss", "train.backward", "elementwise"): 6.0,
        ("model.up_0", "train.backward", "elementwise"): 12.0,
        ("model.down_0", "train.backward", "elementwise"): 16.0,
        ("train.backward", "train.backward", "elementwise"): 3.0,
        ("train.optimizer", "train.optimizer", "elementwise"): 20.0}
    assert att["spans"] == ["model.down_0", "model.up_0", "train.backward",
                            "train.forward", "train.loss", "train.optimizer"]


def test_the_launching_thread_comes_first():
    """A span on the launching thread is taken over the main thread's,
    and a launch inside a backward op whose forward op is not in the
    trace keeps the spans around the launch."""
    events = trace() + [
        span("model.bottom", 590, 30, tid=AUTOGRAD),
        op(owners.BACKWARD + "ReluBackward0", 640, 20, AUTOGRAD, 99, 1),
        launch(12, 645, AUTOGRAD), kernel(12, 650, 2)]
    got = owners.attribute(events)["device_s"]
    assert got[("model.bottom", "model.bottom", "elementwise")] == \
        pytest.approx(3e-6)
    assert got[("train.backward", "train.backward", "elementwise")] == \
        pytest.approx(2e-6)


def test_no_window_no_owners():
    assert owners.attribute([e for e in trace()
                             if e["name"] != "bench.traced"]) is None


def test_readers_and_table():
    att = owners.attribute(trace())
    ms = {ph: owners.phase_ms(att, 2, f"train.{ph}")
          for ph in ("forward", "backward", "loss", "optimizer")}
    assert ms == pytest.approx({"forward": 0.029, "backward": 0.0185,
                                "loss": 0.002, "optimizer": 0.01})
    # down_0 and up_0, forward and backward, elementwise only
    assert owners.elementwise_ms(att, 2, ("0", "1")) == pytest.approx(0.023)
    assert owners.elementwise_ms(att, 2, ("1",)) == 0.0
    assert [owners.level(o) for o in ("model.upatt_1", "model.bottom_att",
                                      "model.down_0", "train.loss", None)] \
        == ["1", "bottom", "0", None, None]
    lines = owners.table(att, 2)
    assert lines[0].startswith("owner model.up_0 in train.forward: 0.024")
    assert lines[-1] == ("elementwise and reduction ms a step by owner: "
                         "model 0.023, train.optimizer 0.010, "
                         "unowned 0.005, train.loss 0.005, "
                         "train.backward 0.002")
    assert owners.table(None, 2) == []


def test_a_trace_without_program_spans_reads_nothing():
    """A program without spans (the parent of the change that adds them)
    leaves every reader empty."""
    events = [e for e in trace() if e.get("cat") != "user_annotation"
              or e["name"].startswith("bench.")]
    att = owners.attribute(events)
    assert owners.phase_ms(att, 2, "train.forward") is None
    assert owners.elementwise_ms(att, 2, ("0", "1")) is None
    assert owners.phase_ms(None, 2, "train.forward") is None
    assert owners.table(att, 2) == []
    assert set(k[:2] for k in att["device_s"]) == {(None, None)}

