"""The parts of a run that only the card has: a traced run of each kind at
tiny sizes on CUDA, whose per-layer metrics come from device events (the
profiler's kernels, CUDA events at the model's modules). Run on the card:
`python -m pytest -m gpu benchmark/test_bench_gpu.py`."""

import pytest

from benchmark import run

SPEC = run.load_spec()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["spvpa.infer.vol448",
                                  "spvpa.train.crop384"])
def test_traced_run_on_the_card(cell, tiny_data):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = run.run_cell(SPEC, cell, 2 ** 31 + 3, 1.0, True, device="cuda",
                       data=tiny_data)
    assert res["correct"], res["checks"]
    names = {m["name"] for m in run.Cell(SPEC, cell).per_layer()}
    assert set(res["metrics"]) == names
    for name, m in res["metrics"].items():
        if "roofline" in name or "mfu" in name or "idle" in name:
            assert 0.0 < m["value"] <= 100.0, (name, m)
    dev = res["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
