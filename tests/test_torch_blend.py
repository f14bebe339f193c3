"""blend (ops/blend.py, csrc/blend.cu) on the CPU: the wrapper's plan (the
kernel's instance, the chunks of at most WMAX windows, each chunk's box and
plane step) tested directly, and a numpy emulation of the kernel's
per-thread schedule held bit for bit to the plain twin and to the JAX
reference (vs_seg_tpu/infer/sliding_window.py:_scatter_accumulate), and
within 1e-6 to the Pallas kernel in interpret mode (it multiplies
pred * imp * mask in another order).

The emulation follows csrc/blend.cu: the instance the plan picks (v4: 4
voxels a thread, the bf16 pair of each voxel unpacked from one 32-bit word;
v1: one voxel), the launches in chunk order, each thread decoded from its
index in the kernel's plane order, its coverage tested against the launch's
window table (WMAX slots), every load (accumulators, then each covering
window's predictions and importance) gathered before the first add, then
the adds in window order with a separate f32 multiply and add. Mutations
of that schedule (two windows swapped, the chunks reversed, a fused
multiply-add, the bf16 channels unpacked the other way round) must each
break the bit-equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vs_seg_tpu.infer.sliding_window import _scatter_accumulate
from vs_seg_tpu.ops.pallas_blend import pallas_blend_scatter
from vs_seg_tpu_torch.infer.sliding_window import dense_patch_starts
from vs_seg_tpu_torch.ops import blend

# (volume (D, H, W), roi, starts, mask); windows overlap in every case
CASES = {
    # the flagship's pattern (8 windows at two d, h and w starts, the box
    # the whole volume), scaled down with w-starts, RW and W multiples of 4
    "flagship": ((10, 56, 56), (8, 48, 48),
                 dense_patch_starts((10, 56, 56), (8, 48, 48), 0.25), None),
    # w-starts not multiples of 4, RW = 6
    "unaligned": ((12, 20, 30), (4, 8, 6),
                  [[0, 0, 1], [4, 8, 5], [2, 4, 3], [8, 12, 24]], None),
    # a masked window (a padded batch slot) on a duplicate start
    "masked duplicate": ((12, 16, 16), (4, 8, 8),
                         [[0, 0, 0], [4, 8, 8], [2, 4, 4], [4, 8, 8]],
                         [1, 1, 1, 0]),
    # WMAX + 3 windows: two launches, windows of both overlapping
    "wmax+3": ((12, 16, 24), (4, 8, 8),
               [[d, h, w] for d in (0, 2, 4) for h, w in ((0, 0), (8, 12),
                                                          (4, 16), (8, 4))
                ][:blend.WMAX + 3], None),
    # a box smaller than the volume: the outside is left untouched
    "small box": ((12, 24, 28), (4, 8, 8), [[2, 8, 4], [4, 12, 8]], None),
}


def _inputs(case, o, bf16, seed=0):
    vol, roi, starts, mask = CASES[case]
    rng = np.random.default_rng(seed)
    starts = np.asarray(starts, np.int32)
    n = len(starts)
    mask = np.asarray(mask if mask is not None else [1] * n, np.float32)
    preds = torch.from_numpy(rng.normal(size=(n, *roi, o)).astype(np.float32))
    if bf16:
        preds = preds.to(torch.bfloat16)
    imp = (rng.random(roi) + 0.1).astype(np.float32)
    out0 = rng.normal(size=(*vol, o)).astype(np.float32)
    w0 = (rng.random((*vol, 1)) + 0.5).astype(np.float32)
    return out0, w0, preds, starts, mask, imp


def kernel_order(bd, bh, bwg, dstep):
    """(d, h, group) of the threads of a launch over a box of bd x bh
    planes and rows and bwg groups a row, in launch order (block row q =
    blockIdx.y, then row-major within the plane), decoded as csrc/blend.cu
    does: plane q is d = a * dstep + b, b-major."""
    t = np.arange(bd * bh * bwg)
    g, r = t % bwg, t // bwg
    h, q = r % bh, r // bh
    m0 = bd // dstep
    rem = bd - m0 * dstep
    first = q < rem * (m0 + 1)
    b = np.where(first, q // (m0 + 1), rem + (q - rem * (m0 + 1)) // m0)
    a = np.where(first, q - b * (m0 + 1), q - rem * (m0 + 1) - (b - rem) * m0)
    return a * dstep + b, h, g


def _unpack(raw, bf16, v, swap=False):
    """The f32 predictions (..., V, O) of loaded raw predictions: for bf16
    the 16-bit patterns; at v = 4 (O = 2) each voxel's pair is one 32-bit
    word, channel 0 in its low half."""
    if not bf16:
        return raw
    if v == 1:
        return (raw.astype(np.uint32) << 16).view(np.float32)
    word = raw[..., 0].astype(np.uint32) | (raw[..., 1].astype(np.uint32)
                                            << 16)
    lo = (word << 16).view(np.float32)
    hi = (word & np.uint32(0xFFFF0000)).view(np.float32)
    return np.stack((hi, lo) if swap else (lo, hi), axis=-1)


def emulate(out_acc, w_acc, preds, starts, mask, imp, mutate=None):
    """numpy: csrc/blend.cu's per-thread schedule (module docstring) on
    copies of the accumulators; `mutate` names a schedule mutation."""
    out, wacc = out_acc.copy(), w_acc.copy()
    n, rd, rh, rw, o = preds.shape
    bf16 = preds.dtype == torch.bfloat16
    raw = (preds.view(torch.int16).numpy().view(np.uint16) if bf16
           else preds.numpy())
    p = blend.plan(out.shape, (rd, rh, rw), starts)
    v = 4 if p.instance == "v4" else 1
    chunks = p.chunks[::-1] if mutate == "chunk order" else p.chunks
    for c in chunks:
        slots = list(range(c.lo, c.hi))
        if mutate == "window order":     # swap slot 0 with a window over it
            j = next(j for j in slots[1:] if all(
                abs(a - b) < r for a, b, r in zip(starts[j], starts[c.lo],
                                                  (rd, rh, rw))))
            slots[0], slots[j - c.lo] = j, slots[0]
        d, h, g = kernel_order(c.box[0], c.box[1], c.box[2] // v, c.dstep)
        d, h = d + c.box_lo[0], h + c.box_lo[1]
        w = c.box_lo[2] + v * g
        # each voxel of the box belongs to one thread
        assert len(set(zip(d, h, w))) == len(d)
        assert d.max() < c.box_lo[0] + c.box[0]
        # coverage against the window table: the group's first voxel (a
        # group never straddles a window edge where v4 is picked)
        loc = [(d - starts[s][0], h - starts[s][1], w - starts[s][2])
               for s in slots]
        cov = [(0 <= ld) & (ld < rd) & (0 <= lh) & (lh < rh) & (0 <= lw)
               & (lw < rw) for ld, lh, lw in loc]
        cov += [np.zeros_like(d, bool)] * (blend.WMAX - len(slots))
        act = np.any(cov, axis=0)
        d, h, w = d[act], h[act], w[act]
        cols = w[:, None] + np.arange(v)
        # every load before the first add
        acc = out[d[:, None], h[:, None], cols]
        ws = wacc[d[:, None], h[:, None], cols, 0]
        loads = []
        for i, s in enumerate(slots):
            idx = np.nonzero(cov[i][act])[0]
            ld, lh, lw = (x[act][idx][:, None] for x in loc[i])
            lwv = lw + np.arange(v)
            pv = _unpack(raw[s][ld, lh, lwv], bf16, v,
                         swap=mutate == "channel order")
            loads.append((idx, pv, imp[ld, lh, lwv]))
        # the adds, window by window in slot order
        for i, (idx, pv, iv) in enumerate(loads):
            wt = iv * mask[slots[i]]
            if mutate == "fma":
                acc[idx] = (acc[idx].astype(np.float64) + pv.astype(
                    np.float64) * wt[..., None].astype(np.float64)).astype(
                        np.float32)
            else:
                acc[idx] = acc[idx] + pv * wt[..., None]
            ws[idx] = ws[idx] + wt
        out[d[:, None], h[:, None], cols] = acc
        wacc[d[:, None], h[:, None], cols, 0] = ws
    return out, wacc


@pytest.mark.parametrize("case,o,bf16,instance,launches", [
    ("flagship", 2, True, "v4", 1),
    ("flagship", 2, False, "v4", 1),
    ("unaligned", 2, True, "v1", 1),
    ("unaligned", 3, False, "v1", 1),
    ("masked duplicate", 1, False, "v1", 1),
    ("masked duplicate", 2, True, "v4", 1),
    ("masked duplicate", 2, False, "v4", 1),
    ("masked duplicate", 8, True, "v1", 1),
    ("wmax+3", 2, True, "v4", 2),
    ("wmax+3", 3, False, "v1", 2),
    ("small box", 2, True, "v4", 1),
    ("small box", 3, True, "v1", 1),
])
def test_emulated_kernel_matches_twin_jax_and_pallas(case, o, bf16, instance,
                                                     launches):
    out0, w0, preds, starts, mask, imp = _inputs(case, o, bf16)
    p = blend.plan(out0.shape, preds.shape[1:4], starts)
    assert p.instance == instance and len(p.chunks) == launches
    got_o, got_w = emulate(out0, w0, preds, starts, mask, imp)
    po, pw = blend.blend_scatter_plain(torch.from_numpy(out0.copy()),
                                       torch.from_numpy(w0.copy()), preds,
                                       starts, mask, torch.from_numpy(imp))
    np.testing.assert_array_equal(got_o, po.numpy())
    np.testing.assert_array_equal(got_w, pw.numpy())
    args = (jnp.asarray(preds.float().numpy()), jnp.asarray(starts),
            jnp.asarray(mask), jnp.asarray(imp))
    ref_o, ref_w = _scatter_accumulate(jnp.asarray(out0), jnp.asarray(w0),
                                       *args)
    np.testing.assert_array_equal(got_o, np.asarray(ref_o))
    np.testing.assert_array_equal(got_w, np.asarray(ref_w))
    pal_o, pal_w = pallas_blend_scatter(jnp.asarray(out0), jnp.asarray(w0),
                                        *args, interpret=True)
    np.testing.assert_allclose(got_o, np.asarray(pal_o), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_w, np.asarray(pal_w), rtol=1e-6,
                               atol=1e-6)
    # outside the windows' union nothing changed
    vol, roi = out0.shape[:3], preds.shape[1:4]
    inside = np.zeros(vol, bool)
    for s in starts:
        inside[tuple(slice(a, a + r) for a, r in zip(s, roi))] = True
    np.testing.assert_array_equal(got_o[~inside], out0[~inside])
    np.testing.assert_array_equal(got_w[~inside], w0[~inside])


@pytest.mark.parametrize("mutate,case,o,bf16", [
    ("window order", "flagship", 2, True),
    ("window order", "unaligned", 3, False),
    ("chunk order", "wmax+3", 2, True),
    ("fma", "flagship", 2, False),
    ("fma", "masked duplicate", 8, True),
    ("channel order", "flagship", 2, True),
])
def test_schedule_mutations_break_bit_equality(mutate, case, o, bf16):
    out0, w0, preds, starts, mask, imp = _inputs(case, o, bf16)
    po, pw = blend.blend_scatter_plain(torch.from_numpy(out0.copy()),
                                       torch.from_numpy(w0.copy()), preds,
                                       starts, mask, torch.from_numpy(imp))
    np.testing.assert_array_equal(
        emulate(out0, w0, preds, starts, mask, imp)[0], po.numpy())
    got_o, got_w = emulate(out0, w0, preds, starts, mask, imp, mutate)
    assert not (np.array_equal(got_o, po.numpy())
                and np.array_equal(got_w, pw.numpy()))


@pytest.mark.parametrize("bd,bh,bwg,dstep", [
    (80, 3, 2, 16), (81, 2, 3, 16), (10, 4, 4, 2), (7, 3, 1, 3),
    (5, 2, 2, 1), (6, 1, 1, 6)])
def test_kernel_plane_order_is_a_permutation(bd, bh, bwg, dstep):
    d, h, g = kernel_order(bd, bh, bwg, dstep)
    assert sorted(zip(d, h, g)) == [(a, b, c) for a in range(bd)
                                    for b in range(bh) for c in range(bwg)]
    # consecutive planes of the walk are dstep apart within a run
    planes = d[::bh * bwg]
    if bd >= 2 * dstep > 1:
        assert planes[1] - planes[0] == dstep


def test_plan_flagship_is_one_v4_launch_over_the_volume():
    starts = dense_patch_starts((80, 448, 448), (64, 384, 384), 0.25)
    p = blend.plan((80, 448, 448, 2), (64, 384, 384), starts)
    assert p == blend.Plan("v4", (blend.Chunk(0, 8, (0, 0, 0),
                                              (80, 448, 448), 16),))


@pytest.mark.parametrize("shape,roi,starts,aligned,instance", [
    ((16, 32, 32, 2), (4, 8, 8), [[0, 0, 0], [2, 8, 12]], True, "v4"),
    ((16, 32, 32, 2), (4, 8, 8), [[0, 0, 0], [2, 8, 13]], True, "v1"),
    ((16, 32, 32, 2), (4, 8, 6), [[0, 0, 0], [2, 8, 12]], True, "v1"),
    ((16, 32, 30, 2), (4, 8, 8), [[0, 0, 0], [2, 8, 12]], True, "v1"),
    ((16, 32, 32, 3), (4, 8, 8), [[0, 0, 0], [2, 8, 12]], True, "v1"),
    ((16, 32, 32, 1), (4, 8, 8), [[0, 0, 0], [2, 8, 12]], True, "v1"),
    ((16, 32, 32, 2), (4, 8, 8), [[0, 0, 0], [2, 8, 12]], False, "v1"),
])
def test_plan_instance_choice(shape, roi, starts, aligned, instance):
    assert blend.plan(shape, roi, starts, aligned).instance == instance


def test_plan_chunks_windows_in_index_order():
    starts = [[i % 5, 2 * (i % 3), 4 * (i % 4)] for i in range(2 * blend.WMAX
                                                            + 3)]
    p = blend.plan((16, 32, 32, 2), (4, 8, 8), starts)
    assert [(c.lo, c.hi) for c in p.chunks] == [
        (0, blend.WMAX), (blend.WMAX, 2 * blend.WMAX),
        (2 * blend.WMAX, 2 * blend.WMAX + 3)]
    for c in p.chunks:
        st = np.array(starts[c.lo:c.hi])
        assert c.box_lo == tuple(st.min(axis=0))
        assert c.box == tuple(st.max(axis=0) + (4, 8, 8) - st.min(axis=0))
        ds = np.unique(st[:, 0])
        assert c.dstep == (np.diff(ds).min() if len(ds) > 1 else 1)
    assert blend.plan((16, 32, 32, 2), (4, 8, 8), starts[:0]).chunks == ()


def test_cpu_call_runs_the_twin_and_launches_nothing():
    out0, w0, preds, starts, mask, imp = _inputs("flagship", 2, True)
    n0 = blend.blend_scatter.launches
    got = blend.blend_scatter(torch.from_numpy(out0.copy()),
                              torch.from_numpy(w0.copy()), preds, starts,
                              mask, torch.from_numpy(imp))
    ref = emulate(out0, w0, preds, starts, mask, imp)
    assert blend.blend_scatter.launches == n0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
