"""Window-sharded inference of the port against the JAX package, on the CPU,
with the machinery under it: the mesh, the shards' collectives
(parallel/collectives.py), the thread-safe launch counters and argument
binding of ops/_build.py, and run_inference under --sharded_inference and
--spatial_inference.

A mesh here repeats the CPU device, ("cpu",) * n: n shards, each a thread
of run_spmd, as n shards share one card on a one-GPU machine. JAX runs on
the 8-device CPU mesh of tests/conftest.py. Models are the small flagship
of tests/test_parallel.py (channels 8/16/32) in float32, on JAX weights
(compat/from_jax.py) with their 1-D leaves shifted by 0.1, as
tests/test_spatial.py does. Tolerances: collectives against numpy bit for
bit (copies and an in-order sum); the sharded sliding
window within 1e-5 relative of JAX's sliding_window_inference_sharded and
of the port's single-device sliding_window_inference (only the order of
the blend's sums differs); run_inference's Dice within 1e-5 of JAX's, and
bit-equal to the flagless run on a one-device mesh.
"""

import ctypes
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vs_seg_tpu.core.config import Config as JConfig
from vs_seg_tpu.infer.engine import make_predictor as jmake_predictor
from vs_seg_tpu.infer.engine import run_inference as jrun_inference
from vs_seg_tpu.infer.sharded import \
    sliding_window_inference_sharded as jsharded
from vs_seg_tpu.models import UNet2d5_spvPA as JUNet
from vs_seg_tpu.parallel import mesh as jmesh
from vs_seg_tpu_torch.compat import load_jax_variables
from vs_seg_tpu_torch.core.config import Config
from vs_seg_tpu_torch.infer.engine import make_predictor, run_inference
from vs_seg_tpu_torch.infer.sharded import sliding_window_inference_sharded
from vs_seg_tpu_torch.infer.sliding_window import (sliding_window_inference,
                                                   stage_volume)
from vs_seg_tpu_torch.models import UNet2d5_spvPA
from vs_seg_tpu_torch.ops import _build, blend
from vs_seg_tpu_torch.parallel import collectives
from vs_seg_tpu_torch.parallel.mesh import make_mesh, replicate

REPO = Path(__file__).resolve().parents[1]
CFG = dict(channels=(8, 16, 32), strides=((2, 2, 1), (2, 2, 2)),
           kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
           sample_kernel_sizes=((3, 3, 1), (3, 3, 3)))
ROI = (32, 32, 8)                    # (H, W, D)


def cpu_mesh(n):
    return make_mesh(["cpu"] * n)


# ---- the mesh ---------------------------------------------------------------

def test_make_mesh_takes_repeated_devices():
    assert make_mesh(["cpu", "cpu", "cpu"]) == (torch.device("cpu"),) * 3
    assert make_mesh(device="cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        make_mesh([])


def test_make_mesh_never_moves_a_cuda_request_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(["cuda:0", "cuda:0"])


def test_replicate_shares_one_model_per_device():
    model = torch.nn.Linear(2, 2)
    reps = replicate(model, cpu_mesh(3))
    assert all(r is model for r in reps)


# ---- collectives --------------------------------------------------------------

def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 3, 4)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("op", ["exchange", "all_gather", "reduce"])
def test_collective_matches_numpy(n, op):
    xs = _inputs(n)

    def body():
        k = collectives.axis_index()
        assert collectives.axis_size() == n
        x = torch.from_numpy(xs[k])
        if op == "exchange":
            return collectives.exchange((k, x))
        if op == "all_gather":
            return collectives.all_gather(x, dim=1)
        return collectives.reduce(x)

    outs = collectives.run_spmd(body, cpu_mesh(n))
    for k, o in enumerate(outs):
        if op == "exchange":
            assert [r for r, _ in o] == list(range(n))
            for x, (_, v) in zip(xs, o):
                np.testing.assert_array_equal(v.numpy(), x)
        elif op == "all_gather":
            np.testing.assert_array_equal(o.numpy(),
                                          np.concatenate(xs, axis=1))
        elif k:            # the sum is shard 0's alone
            assert o is None
        else:
            ref = xs[0].copy()
            for x in xs[1:]:
                ref = ref + x
            np.testing.assert_array_equal(o.numpy(), ref)


def test_reduce_leaves_the_operands():
    """Shard 0's sum is a tensor of its own: adding to it touches no
    shard's operand."""
    def body():
        x = torch.full((3,), float(collectives.axis_index() + 1))
        got = collectives.reduce(x)
        if got is not None:
            got.add_(1.0)
        collectives.all_gather(x, dim=0)
        return x

    for k, x in enumerate(collectives.run_spmd(body, cpu_mesh(3))):
        assert torch.equal(x, torch.full((3,), float(k + 1)))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_exception_in_one_shard_raises_in_the_caller(n):
    """The failing shard aborts the barrier: the others stop at their next
    wait, far inside the (long) timeout, and its exception comes out."""
    def body():
        if collectives.axis_index() == n - 1:
            raise ValueError("shard failed")
        collectives.reduce(torch.ones(2))
        return 1

    t = time.perf_counter()
    with pytest.raises(ValueError, match="shard failed"):
        collectives.run_spmd(body, cpu_mesh(n), timeout=60.0)
    assert time.perf_counter() - t < 10.0


def test_a_missing_collective_times_out():
    def body():
        if collectives.axis_index() == 0:
            collectives.reduce(torch.ones(2))
        return 1

    with pytest.raises(TimeoutError, match="barrier"):
        collectives.run_spmd(body, cpu_mesh(2), timeout=0.5)


def test_collectives_outside_run_spmd_raise():
    with pytest.raises(RuntimeError, match="outside run_spmd"):
        collectives.reduce(torch.ones(1))
    assert not collectives.in_spmd()


def test_shards_reuse_their_threads():
    """Shard k runs on the same persistent thread in every call, so that
    PyTorch's per-thread state (cuDNN's plan cache) outlives a window."""
    def body():
        return threading.get_ident()

    first = collectives.run_spmd(body, cpu_mesh(3))
    assert len(set(first)) == 3 and threading.get_ident() not in first
    assert collectives.run_spmd(body, cpu_mesh(3)) == first
    assert collectives.run_spmd(body, cpu_mesh(2)) == first[:2]


def test_shards_run_under_inference_mode_and_count_stats():
    collectives.reset_stats()

    def body():
        collectives.reduce(torch.ones(1))
        return torch.is_inference_mode_enabled()

    assert collectives.run_spmd(body, cpu_mesh(3)) == [True] * 3
    assert collectives.STATS["reduce"] == 3
    assert collectives.STATS["reduce_s"] >= collectives.STATS["barrier_s"] >= 0


# ---- launch counters and argument binding under threads -------------------------

def _run_threads(target, n: int) -> None:
    """n threads of target() started together under a short switch
    interval (so that a lost update would show), each joined with a
    timeout."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=target) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)


def _counter_names():
    import chip_smoke
    return sorted(chip_smoke._counters())


@pytest.mark.parametrize("name", _counter_names())
def test_launch_counter_is_thread_safe(name):
    """Two threads x 1000 counted calls give 2000 on every counter that
    chip_smoke.py reads."""
    import chip_smoke
    fn, attr = chip_smoke._counters()[name]
    saved = getattr(fn, attr)
    setattr(fn, attr, 0)
    try:
        start = threading.Barrier(2)

        def work():
            start.wait(timeout=60)
            for _ in range(1000):
                _build.count(fn, attr)

        _run_threads(work, 2)
        assert getattr(fn, attr) == 2000
    finally:
        setattr(fn, attr, saved)


def test_counting_under_contention_loses_nothing():
    """4 threads x 20000 counts on one counter: enough contention that an
    unlocked read-modify-write loses updates here."""
    from vs_seg_tpu_torch.ops import rublock
    saved = rublock.ru_unit.launches
    rublock.ru_unit.launches = 0
    try:
        _run_threads(lambda: [_build.count(rublock.ru_unit)
                              for _ in range(20000)], 4)
        assert rublock.ru_unit.launches == 80000
    finally:
        rublock.ru_unit.launches = saved


def test_blend_instance_counter_is_thread_safe():
    saved = dict(blend.blend_scatter.instances)
    blend.blend_scatter.instances["v4"] = 0
    try:
        _run_threads(lambda: [
            _build.count(blend.blend_scatter, "instances", "v4")
            for _ in range(1000)], 2)
        assert blend.blend_scatter.instances["v4"] == 2000
    finally:
        blend.blend_scatter.instances.update(saved)


def test_no_wrapper_counts_outside_the_lock():
    for src in (REPO / "vs_seg_tpu_torch" / "ops").glob("*.py"):
        if src.name == "_build.py":
            continue
        text = src.read_text()
        assert ".launches += " not in text, src
        assert "chain_calls += " not in text, src
        assert ".argtypes = " not in text, src     # set through bind


def test_bind_sets_the_types_once_under_threads():
    libc = ctypes.CDLL(None)
    fns = []
    start = threading.Barrier(8)

    def work():
        start.wait(timeout=60)
        fns.append(_build.bind(libc, "labs", [ctypes.c_long], ctypes.c_long))

    _run_threads(work, 8)
    assert len(fns) == 8 and all(f.argtypes == [ctypes.c_long] for f in fns)
    assert all(f(-(2 ** 40)) == 2 ** 40 for f in fns)


# ---- the sharded sliding window ----------------------------------------------

@pytest.fixture(scope="module")
def small():
    """(JAX model, variables, port model) of the small flagship."""
    jm = JUNet(out_channels=2, num_res_units=2, dropout=None,
               attention_module=True, dtype=jnp.float32, **CFG)
    v = jm.init({"params": jax.random.key(0)}, jnp.zeros((1, 8, 32, 32, 1)),
                train=False)
    v = jax.tree.map(lambda a: np.asarray(a + 0.1 if a.ndim == 1 else a,
                                          np.float32), v)
    tm = UNet2d5_spvPA(out_channels=2, dropout=None, dtype=torch.float32,
                       device="cpu", **CFG)
    load_jax_variables(tm, v)
    return jm, v, tm


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def volume():
    # (H, W, D, C): 2 x 2 x 2 windows of ROI
    return np.random.default_rng(3).normal(size=(40, 36, 10, 1)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_sharded(small, volume):
    jm, v, _ = small
    pred = jmake_predictor(jm, v["params"], v["batch_stats"],
                           dtype=jnp.float32)
    return np.asarray(jsharded(volume, ROI, pred, jmesh.make_mesh(),
                               sw_batch_size=1, predictor_layout="dfirst"))


@pytest.mark.parametrize("n,sw", [(2, 1), (2, 3), (3, 1)])
def test_sharded_sliding_window_matches_jax(small, volume, jax_sharded, n,
                                            sw):
    """8 windows over n shards of sw each: (2, 3) and (3, 1) pad the list
    with masked windows (12 and 9 places)."""
    _, _, tm = small
    pred = make_predictor(tm, torch.float32)
    out = sliding_window_inference_sharded(volume, ROI, pred, cpu_mesh(n),
                                           sw_batch_size=sw)
    single = sliding_window_inference(volume, ROI, pred, device="cpu",
                                      sw_batch_size=2)
    assert _rel(out, jax_sharded) < 1e-5
    assert _rel(out, single) < 1e-5


def test_sharded_masked_windows_add_no_weight(volume):
    """A toy predictor: 8 windows over 3 shards of 2 leave 4 masked places
    (duplicates of window 0); the blend equals the single-device one."""
    def toy(wins):
        return torch.cat([wins * 2.0 + 1.0, torch.cumsum(wins, 1) * 0.1],
                         dim=-1)

    staged = stage_volume(volume, ROI, device="cpu", sw_batch_size=6)
    assert staged.starts_padded.shape[0] == 12 and staged.mask.sum() == 8
    out = sliding_window_inference_sharded(staged, ROI, toy, cpu_mesh(3),
                                           sw_batch_size=2)
    ref = sliding_window_inference(volume, ROI, toy, device="cpu",
                                   sw_batch_size=1)
    assert _rel(out, ref) < 1e-5


def test_sharded_takes_one_predictor_per_shard(volume):
    calls = []

    def pred_of(k):
        def pred(wins):
            calls.append(k)
            return wins * 2.0
        return pred

    sliding_window_inference_sharded(volume, ROI, [pred_of(0), pred_of(1)],
                                     cpu_mesh(2), sw_batch_size=1)
    assert sorted(set(calls)) == [0, 1] and len(calls) == 8
    with pytest.raises(ValueError, match="predictors"):
        sliding_window_inference_sharded(volume, ROI, [pred_of(0)],
                                         cpu_mesh(2))


# ---- run_inference under the two flags ----------------------------------------

def _vols():
    rng = np.random.default_rng(8)
    vols = []
    for shape in ((24, 20, 12), (16, 16, 8)):
        img = rng.normal(size=(1, 1, *shape)).astype(np.float32)
        lab = (img > 0.3).astype(np.float32)
        vols.append({"image": img, "label": lab,
                     "label_meta": [{"affine": np.eye(4)}]})
    return vols


def _run_cfgs(**kw):
    common = dict(compute_dtype="float32", infer_dtype="float32",
                  sliding_window_inferer_roi_size=(16, 16, 8),
                  sw_batch_size=2, export_inferred_segmentations=False,
                  dropout=0.0, **CFG, **kw)
    return JConfig(**common), Config(device="cpu", **common)


@pytest.fixture(scope="module")
def flagless(small):
    _, _, tm = small
    _, tcfg = _run_cfgs()
    return run_inference(tcfg, tm, _vols(), device="cpu",
                         make_figures=False)[0]


@pytest.mark.parametrize("flag", ["sharded_inference", "spatial_inference"])
def test_run_inference_one_device_mesh_is_the_flagless_run(small, flagless,
                                                           flag):
    _, _, tm = small
    _, tcfg = _run_cfgs(**{flag: True})
    dice, _ = run_inference(tcfg, tm, _vols(), device="cpu",
                            make_figures=False)
    np.testing.assert_array_equal(dice, flagless)
    dice, _ = run_inference(tcfg, tm, _vols(), device="cpu",
                            make_figures=False, mesh=cpu_mesh(1))
    np.testing.assert_array_equal(dice, flagless)


@pytest.mark.parametrize("flag", ["sharded_inference", "spatial_inference"])
def test_run_inference_two_shards_matches_jax(small, flagless, flag):
    jm, v, tm = small
    jcfg, tcfg = _run_cfgs(**{flag: True})
    jdice, _ = jrun_inference(jcfg, jm, v["params"], v["batch_stats"],
                              _vols(), make_figures=False,
                              mesh=jmesh.make_mesh())
    dice, times = run_inference(tcfg, tm, _vols(), device="cpu",
                                make_figures=False, mesh=cpu_mesh(2))
    assert len(times) == 2 and np.isfinite(dice).all()
    np.testing.assert_allclose(dice, jdice, atol=1e-5)
    np.testing.assert_allclose(dice, flagless, atol=1e-5)
