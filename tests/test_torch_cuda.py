"""The port's hand-written CUDA kernels against their plain PyTorch twins on
the card, at small and ragged shapes that the flagship path does not reach
(channel counts that are not multiples of 8 or 16, W not a multiple of 16,
H not a multiple of 8, more than 64 output channels, odd sizes for the
stride-2 ds_conv), ru_block at the flagship's four encoder sites, the
inference CLI on a small synthetic dataset, the device-resident
training cache (its loader makes no sync; its crops equal the host
transforms' bit for bit), and the paths of UNet2d5 and UNet (ds_conv at
UNet's strided units, Cin != Cout; the train kernels at 2 channels; each
model's kernel path against its plain path), the flagship's train step
with and without --remat, the blend's constant map and sigma_scale, and
the train-mode BatchNorm -> dropout -> PReLU passes (ops/bnorm_train.py)
at the flagship's level-0 and level-1 shapes and in a train step.

These tests need an NVIDIA GPU and nvcc: they carry the `gpu` marker and
skip without CUDA. They import no JAX, so on the GPU machine they run
without the JAX test setup:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerance: bf16 kernel vs plain twin, max|diff| <= 2e-2 * max|plain| (both
round to bf16 at different points and sum in different orders); the blend
is exact (same f32 operation order), and so is the ring probe; conv333_dw
and its twin sum the same exact bf16 products in float32 in other orders:
1e-4. The Mosaic probes are f32: bit-equal on the tool's all-ones inputs
(and for 3droll and repeat on any input); their other sums, taken in
another order, within PROBE_TOL = 1e-5 of the largest output.
"""

import numpy as np
import pytest
import torch

from vs_seg_tpu_torch.ops import (att, blend, block2d, conv333, conv333_dw,
                                  dsconv, l2block, mosaic_probe, ring_probe,
                                  rublock, tail2d, train_conv)

TOL = 2e-2
DW_TOL = 1e-4
PROBE_TOL = 1e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _g():
    return torch.Generator().manual_seed(0)


def _x(g, dev, *shape):
    return torch.randn(shape, generator=g).to(dev, torch.bfloat16)


def _w(g, dev, k, cin, cout):
    b = 1.0 / np.sqrt(cin * int(np.prod(k)))
    return ((torch.rand((*k, cin, cout), generator=g) * 2 - 1) * b).to(dev)


def _v(g, dev, c, lo, hi):
    return (torch.rand(c, generator=g) * (hi - lo) + lo).to(dev)


def _check(got, ref, tol=TOL):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.parametrize("shape,cins,cout,res", [
    ((2, 3, 9, 13), (5,), 7, False),          # nothing aligned
    ((1, 4, 16, 16), (24, 40), 80, True),     # pair, two Cout tiles
    ((1, 2, 12, 20), (3,), 130, False),       # > 2 Cout tiles
    ((2, 1, 8, 16), (16,), 16, True),         # single depth plane
    ((1, 1, 16, 16), (16,), 32, True),        # a single 16x16 tile
    # 402 tiles: more than the persistent grid and not a multiple of it
    ((1, 67, 32, 48), (32,), 48, True),
])
def test_conv333_kernel_matches_plain(dev, shape, cins, cout, res):
    g = _g()
    xs = tuple(_x(g, dev, *shape, c) for c in cins)
    x = xs if len(xs) > 1 else xs[0]
    w = _w(g, dev, (3, 3, 3), sum(cins), cout)
    args = (w, _v(g, dev, cout, .5, 1.5), _v(g, dev, cout, -.2, .2),
            _v(g, dev, 1, .1, .3))
    residual = ((x, _w(g, dev, (1, 1, 1), sum(cins), cout),
                 _v(g, dev, cout, -.2, .2)) if res else None)
    n0 = conv333.conv333.launches
    got = conv333.conv333(x, *args, residual=residual)
    assert conv333.conv333.launches == n0 + 1
    _check(got, conv333.conv333_plain(x, *args, residual=residual))


def test_conv333_kernel_is_deterministic(dev):
    """Two calls are bit-equal: each output is summed by one block in a
    fixed order, whatever the order in which the persistent blocks run."""
    g = _g()
    x = _x(g, dev, 2, 37, 40, 24, 48)
    w = _w(g, dev, (3, 3, 3), 48, 80)
    args = (w, _v(g, dev, 80, .5, 1.5), _v(g, dev, 80, -.2, .2),
            _v(g, dev, 1, .1, .3))
    residual = (x, _w(g, dev, (1, 1, 1), 48, 80), _v(g, dev, 80, -.2, .2))
    a = conv333.conv333(x, *args, residual=residual)
    b = conv333.conv333(x, *args, residual=residual)
    assert torch.equal(a, b)
    _check(a, conv333.conv333_plain(x, *args, residual=residual))


@pytest.mark.parametrize("d", [1, 2, 5, 64])
def test_ring_probe_kernel_is_bit_equal(dev, d):
    """The TMA ring (slot reuse, zero-filled plane past the end)."""
    x = torch.randn((d * 16, 128), generator=_g()).to(dev)
    n0 = ring_probe.ring_probe.launches
    got = ring_probe.ring_probe(x)
    assert ring_probe.ring_probe.launches == n0 + 1
    assert torch.equal(got, ring_probe.ring_probe_plain(x))


def test_conv333_kernel_rejects_float32(dev):
    x = torch.zeros((1, 1, 8, 16, 4), device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        conv333.conv333(x, torch.zeros((3, 3, 3, 4, 4), device=dev))


@pytest.mark.parametrize("shape,c", [((1, 3, 7, 9), 5), ((2, 2, 8, 16), 24)])
def test_attgate_kernel_matches_plain(dev, shape, c):
    g = _g()
    a1, xa, xb = (_x(g, dev, *shape, c) for _ in range(3))
    w2, b2 = _w(g, dev, (3, 3, 3), c, 1), _v(g, dev, 1, -.2, .2)
    for got, ref in zip(l2block.attgate(a1.abs(), w2, b2, xa, xb),
                        l2block.attgate_plain(a1.abs(), w2, b2, xa, xb)):
        _check(got, ref)


@pytest.mark.parametrize("shape,ca,cx,kd,n_x,att_out", [
    ((1, 3, 7, 9), 5, 5, 3, 2, "compact"),      # odd Ca and Cx (Ca padded)
    ((2, 1, 9, 40), 16, 7, 3, 1, "compact"),    # D = 1, W past one tile
    ((1, 4, 9, 33), 80, 80, 3, 2, "compact"),   # up_4's Ca, ragged W and H
    ((1, 2, 6, 70), 32, 16, 1, 1, "none"),      # kd 1, one input, no map
    ((2, 5, 17, 21), 24, 9, 1, 2, "compact"),   # kd 1, odd Cx
    ((1, 3, 6, 10), 256, 8, 3, 2, "none"),      # the largest Ca
])
def test_attgate_kernel_edge_shapes(dev, shape, ca, cx, kd, n_x, att_out):
    g = _g()
    a1 = _x(g, dev, *shape, ca).abs()
    xs = [_x(g, dev, *shape, cx) for _ in range(n_x)]
    w2, b2 = _w(g, dev, (3, 3, kd), ca, 1), _v(g, dev, 1, -.2, .2)
    got = att.fused_attention_gate(a1, xs, w2, b2, att_out=att_out)
    ref = att.fused_attention_gate_plain(a1, xs, w2, b2, att_out=att_out)
    if att_out == "compact":
        _check(got[0], ref[0])
    for o, r in zip(got[1], ref[1]):
        _check(o, r)


@pytest.mark.parametrize("case", mosaic_probe.CASES)
def test_mosaic_probe_kernels_match_plain(dev, case):
    ones = mosaic_probe.inputs(case, dev)
    seeded = mosaic_probe.inputs(case, dev, seed=7)
    ref1 = mosaic_probe.plain(case, *ones)
    ref = mosaic_probe.plain(case, *seeded)
    for scheme in mosaic_probe.SCHEMES[case]:
        n0 = mosaic_probe.probe.launches
        assert torch.equal(
            mosaic_probe.probe(case, *ones, scheme=scheme), ref1)
        got = mosaic_probe.probe(case, *seeded, scheme=scheme)
        assert mosaic_probe.probe.launches == n0 + 2
        if case in mosaic_probe.EXACT:
            assert torch.equal(got, ref)
        else:
            _check(got, ref, PROBE_TOL)


def test_ru_block_and_l2_block_kernels_match_plain(dev):
    g = _g()
    x = _x(g, dev, 2, 3, 10, 12, 12)
    kw = dict(w0=_w(g, dev, (3, 3, 3), 12, 20),
              bn0_scale=_v(g, dev, 20, .5, 1.5),
              bn0_shift=_v(g, dev, 20, -.2, .2), alpha0=_v(g, dev, 1, .1, .3),
              w1=_w(g, dev, (3, 3, 3), 20, 20),
              bn1_scale=_v(g, dev, 20, .5, 1.5),
              bn1_shift=_v(g, dev, 20, -.2, .2), alpha1=_v(g, dev, 1, .1, .3),
              wr=_w(g, dev, (1, 1, 1), 12, 20), br=_v(g, dev, 20, -.2, .2))
    _check(rublock.ru_block(x, **kw), rublock.ru_block_plain(x, **kw))
    c = 20
    xa, xb = _x(g, dev, 1, 3, 10, 12, c), _x(g, dev, 1, 3, 10, 12, c)
    kw = _l2_params(g, dev, c)
    for got, ref in zip(l2block.l2_block(xa, xb, **kw),
                        l2block.l2_block_plain(xa, xb, **kw)):
        _check(got, ref)


def _ru_params(g, dev, cin, cout):
    return dict(w0=_w(g, dev, (3, 3, 3), cin, cout),
                bn0_scale=_v(g, dev, cout, .5, 1.5),
                bn0_shift=_v(g, dev, cout, -.2, .2),
                alpha0=_v(g, dev, 1, .1, .3),
                w1=_w(g, dev, (3, 3, 3), cout, cout),
                bn1_scale=_v(g, dev, cout, .5, 1.5),
                bn1_shift=_v(g, dev, cout, -.2, .2),
                alpha1=_v(g, dev, 1, .1, .3),
                wr=_w(g, dev, (1, 1, 1), cin, cout),
                br=_v(g, dev, cout, -.2, .2))


@pytest.mark.parametrize("shape,cin,cout", [
    ((1, 3, 40, 20), 32, 48),   # 2 x 2 tiles a plane, ragged H and W
    ((2, 5, 33, 47), 32, 48),   # B > 1, 3 x 3 tiles, more planes
    ((1, 1, 8, 16), 32, 48),    # D = 1: the centre plane only
    ((1, 4, 16, 16), 12, 48),   # Cin padded to 16 in a copy
    ((2, 5, 33, 47), 48, 64),   # slabs staged, TH = 16
    ((1, 4, 16, 16), 64, 80),
    ((2, 3, 20, 9), 80, 96),
])
def test_ru_unit_kernel_matches_parent_chain(dev, shape, cin, cout):
    """ru_block where ops/rublock.py:plan takes the unit: one ru_unit
    launch, no conv333; out bit-equal to the parent chain (two conv333
    launches: the same stage order, wgmma sequence and epilogue) whatever
    the role split and ring depth, two runs bit-equal, within TOL of the
    twin."""
    g = _g()
    x = _x(g, dev, *shape, cin)
    kw = _ru_params(g, dev, cin, cout)
    before = (rublock.ru_unit.launches, conv333.conv333.launches,
              rublock.ru_block.launches)
    got = rublock.ru_block(x, **kw)
    assert (rublock.ru_unit.launches - before[0],
            conv333.conv333.launches - before[1],
            rublock.ru_block.launches - before[2]) == (1, 0, 1)
    chain = rublock.ru_chain(conv333.conv333, x, **kw)
    assert torch.equal(got, chain)
    assert torch.equal(got, rublock.ru_block(x, **kw))
    _check(got, rublock.ru_block_plain(x, **kw))
    grid = rublock.unit_grid(dev, cin, cout)
    for p0 in (1, grid - 1):
        assert torch.equal(rublock.ru_unit(x, p0=p0, **kw), chain), p0


@pytest.mark.parametrize("site,shape,cin,cout", [
    ("down_2", (8, 64, 96, 96), 32, 48), ("down_3", (8, 32, 48, 48), 48, 64),
    ("down_4", (8, 16, 24, 24), 64, 80), ("bottom", (8, 8, 12, 12), 80, 96)])
def test_ru_block_at_the_flagship_sites(dev, site, shape, cin, cout):
    """The flagship's four encoder units, each one launch of the unit
    kernel (its weights resident at down_2, its slabs staged below):
    bit-equal to the parent chain, within TOL of the twin."""
    g = _g()
    x = _x(g, dev, *shape, cin)
    kw = _ru_params(g, dev, cin, cout)
    mode = rublock.plan(shape, cin, cout).mode
    assert mode == ("resident" if site == "down_2" else "streamed")
    n0 = (rublock.ru_unit.launches, conv333.conv333.launches)
    got = rublock.ru_block(x, **kw)
    assert (rublock.ru_unit.launches - n0[0],
            conv333.conv333.launches - n0[1]) == (1, 0)
    assert torch.equal(got, rublock.ru_chain(conv333.conv333, x, **kw))
    _check(got, rublock.ru_block_plain(x, **kw))


def test_ru_unit_kernel_refuses_what_it_cannot_take(dev):
    """No fallback: a shape the plan does not take, a role split outside 1
    .. grid - 1 and float32 raise before a launch; a launch the launcher
    refuses (more conv0 blocks than the grid) raises."""
    g = _g()
    x = _x(g, dev, 1, 2, 16, 16, 32)
    kw = _ru_params(g, dev, 32, 48)
    grid = rublock.unit_grid(dev, 32, 48)
    with pytest.raises(ValueError, match="built for"):
        rublock.ru_unit(_x(g, dev, 1, 2, 16, 16, 32),
                        **_ru_params(g, dev, 32, 32))
    for p0 in (0, grid):
        with pytest.raises(ValueError, match="p0"):
            rublock.ru_unit(x, p0=p0, **kw)
    with pytest.raises(TypeError, match="bfloat16"):
        rublock.ru_unit(x.float(), **kw)
    p = rublock.plan(x.shape[:4], 32, 48, grid, p0=grid + 1)
    u0 = torch.empty((*x.shape[:4], 48), dtype=torch.bfloat16, device=dev)
    cnt = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="ru_unit: CUDA launch failed"):
        rublock.launch_unit(x, u0, torch.empty_like(u0), cnt, p, **kw)


def _l2_params(g, dev, c):
    return dict(w1=_w(g, dev, (3, 3, 3), 2 * c, c), b1=_v(g, dev, c, -.2, .2),
                w2=_w(g, dev, (3, 3, 3), c, 1), b2=_v(g, dev, 1, -.2, .2),
                w0=_w(g, dev, (3, 3, 3), 2 * c, c),
                bn_scale=_v(g, dev, c, .5, 1.5),
                bn_shift=_v(g, dev, c, -.2, .2), alpha=_v(g, dev, 1, .1, .3),
                wr=_w(g, dev, (1, 1, 1), 2 * c, c),
                br=_v(g, dev, c, -.2, .2))


@pytest.mark.parametrize("shape,c", [
    ((1, 3, 10, 20), 48),       # up_2's widths: N = 48, the fused residual
    ((2, 2, 9, 13), 64),        # up_3's: separate residual stages, W % 4
    ((1, 4, 12, 33), 80),       # up_4's: ragged W
    ((1, 2, 7, 9), 20),         # channels padded to 24 in a copy, gated too
])
def test_gated_conv333_kernel_matches_plain(dev, shape, c):
    """conv333's gated instance (gate= an f32 map) on a pair and its fused
    or separate pair residual, against the twin."""
    g = _g()
    xa, xb = _x(g, dev, *shape, c), _x(g, dev, *shape, c)
    p = _l2_params(g, dev, c)
    gate = torch.rand(shape, generator=g).to(dev)
    args = ((xa, xb), p["w0"], p["bn_scale"], p["bn_shift"], p["alpha"])
    res = ((xa, xb), p["wr"], p["br"])
    n0, c0 = conv333.conv333.gated_launches, conv333.conv333.launches
    got = conv333.conv333(*args, residual=res, gate=gate)
    assert (conv333.conv333.gated_launches, conv333.conv333.launches) == (
        n0 + 1, c0)
    assert torch.equal(got, conv333.conv333(*args, residual=res, gate=gate))
    _check(got, conv333.conv333_plain(*args, residual=res, gate=gate))
    # the gate is applied: the ungated conv differs
    assert not torch.equal(got, conv333.conv333(*args, residual=res))


def test_gated_conv333_kernel_refuses_a_bad_gate(dev):
    g = _g()
    x = _x(g, dev, 1, 2, 8, 10, 16)
    w = _w(g, dev, (3, 3, 3), 16, 16)
    for gate in (torch.rand((1, 2, 8, 12), device=dev),       # W
                 torch.rand((1, 2, 10, 8), device=dev).transpose(2, 3),
                 torch.rand((1, 2, 8, 10), device=dev).double()):
        with pytest.raises(ValueError, match="gate"):
            conv333.conv333(x, w, gate=gate)


@pytest.mark.parametrize("shape,c", [((1, 3, 7, 9), 16), ((2, 4, 12, 20), 48)])
def test_att_map_kernel_matches_plain_and_attgate(dev, shape, c):
    """attgate's att-only mode: its f32 map against the twin's, its bf16
    map equal to the gating mode's on the same a1."""
    g = _g()
    a1, xa, xb = (_x(g, dev, *shape, c) for _ in range(3))
    a1 = a1.relu()
    w2, b2 = _w(g, dev, (3, 3, 3), c, 1), _v(g, dev, 1, -.2, .2)
    n0, a0 = l2block.att_map.launches, l2block.attgate.launches
    att32, att_c = l2block.att_map(a1, w2, b2)
    assert (l2block.att_map.launches, l2block.attgate.launches) == (n0 + 1,
                                                                    a0)
    assert att32.dtype == torch.float32 and att32.shape == shape
    ref32, ref_c = l2block.att_map_plain(a1, w2, b2)
    _check(att32, ref32, 1e-4)
    _check(att_c, ref_c)
    assert torch.equal(att_c, att32[..., None].to(torch.bfloat16))
    assert torch.equal(att_c, l2block.attgate(a1, w2, b2, xa, xb)[0])


@pytest.mark.parametrize("shape,c", [
    ((1, 3, 10, 20), 48), ((2, 2, 9, 13), 64), ((1, 4, 12, 33), 80),
    ((1, 3, 16, 16), 16),
])
def test_l2_block_kernel_matches_parent_chain(dev, shape, c):
    """l2_block: conv333 (conv1), attgate's att-only mode and conv333's
    gated instance, one launch each; out and att bit-equal to the parent
    chain (conv333, attgate, conv333: the same stage order and wgmma
    sequence on the same fmaf-gated values) and within TOL of the twin;
    two runs bit-equal."""
    g = _g()
    xa, xb = _x(g, dev, *shape, c), _x(g, dev, *shape, c)
    kw = _l2_params(g, dev, c)
    counters = ((conv333.conv333, "launches"),
                (conv333.conv333, "gated_launches"),
                (l2block.att_map, "launches"), (l2block.attgate, "launches"))
    before = [getattr(o, a) for o, a in counters]
    got = l2block.l2_block(xa, xb, **kw)
    assert [getattr(o, a) - b for (o, a), b in zip(counters, before)] == [
        1, 1, 1, 0]
    again = l2block.l2_block(xa, xb, **kw)
    chain = l2block.l2_chain(conv333.conv333, l2block.attgate, xa, xb, **kw)
    for o, a, r, p in zip(got, again, chain,
                          l2block.l2_block_plain(xa, xb, **kw)):
        assert torch.equal(o, a)
        assert torch.equal(o, r)
        _check(o, p)


def test_l2_block_kernel_allocates_no_gated_pair(dev):
    """The peak memory of l2_block is below the parent chain's by at least
    the gated pair that the chain writes (ga, gb)."""
    g = _g()
    shape, c = (1, 8, 32, 32), 48
    xa, xb = _x(g, dev, *shape, c), _x(g, dev, *shape, c)
    kw = _l2_params(g, dev, c)
    chain = (lambda: l2block.l2_chain(conv333.conv333, l2block.attgate, xa,
                                      xb, **kw))
    peaks = []
    for fn in (lambda: l2block.l2_block(xa, xb, **kw), chain):
        fn()                                  # weights packed and cached
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    pair = 2 * xa.numel() * xa.element_size()
    att32 = 4 * xa[..., 0].numel()               # the f32 map it adds
    assert peaks[0] + pair <= peaks[1] + att32, peaks


def _blend_inputs(case, dtype, dev):
    """(out_acc, w_acc, preds, starts, mask, importance, instance) of a
    blend case: "flagship" (80,448,448,2) <- 8 x (64,384,384,2) at the
    sliding window's starts, "original" (the first case of this test),
    else a row of bench/attgate_ab.py:BLEND_CASES."""
    from vs_seg_tpu_torch.bench.attgate_ab import BLEND_CASES, blend_case
    from vs_seg_tpu_torch.infer.sliding_window import (
        dense_patch_starts, gaussian_importance_map)
    if case == "flagship":
        g = _g()
        starts = dense_patch_starts((80, 448, 448), (64, 384, 384), 0.25)
        imp = torch.from_numpy(gaussian_importance_map((64, 384, 384)))
        return (torch.randn((80, 448, 448, 2), generator=g).to(dev),
                (torch.rand((80, 448, 448, 1), generator=g) + 0.5).to(dev),
                torch.randn((8, 64, 384, 384, 2), generator=g).to(dev, dtype),
                starts, np.ones(8, np.float32), imp.to(dev), "v4")
    if case == "original":
        g = _g()
        starts = np.array([[0, 0, 0], [4, 8, 8], [2, 4, 2], [4, 8, 8]],
                          np.int32)
        mask = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
        preds = torch.randn((4, 4, 8, 8, 3), generator=g).to(dev, dtype)
        imp = (torch.rand((4, 8, 8), generator=g) + 0.1).to(dev)
        out0 = torch.randn((12, 16, 16, 3), generator=g).to(dev)
        w0 = torch.rand((12, 16, 16, 1), generator=g).to(dev)
        return out0, w0, preds, starts, mask, imp, "v1"
    row = next(c for c in BLEND_CASES if c[0] == case)
    return (*blend_case(row, dtype, dev), row[6])


@pytest.mark.parametrize("case", [
    "original", "flagship", "unaligned", "unaligned O=3",
    "masked duplicate O=1", "masked duplicate O=2", "masked duplicate O=8",
    "N=20", "small box"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_blend_kernel_matches_plain_exactly(dev, dtype, case):
    """Bit-equal to the twin and over two runs, on the instance the wrapper
    should pick, one launch per WMAX windows (bench/attgate_ab.py --kernel
    blend holds the same cases to the parent kernel)."""
    out0, w0, preds, starts, mask, imp, inst = _blend_inputs(case, dtype, dev)
    before = dict(blend.blend_scatter.instances)
    runs = [blend.blend_scatter(out0.clone(), w0.clone(), preds, starts,
                                mask, imp) for _ in range(2)]
    took = {k: v - before[k] for k, v in blend.blend_scatter.instances.items()}
    launches = 2 * -(-len(starts) // blend.WMAX)
    assert took == {"v4": 0, "v1": 0, inst: launches}, took
    po, pw = blend.blend_scatter_plain(out0.clone(), w0.clone(), preds,
                                       starts, mask, imp)
    for ko, kw in runs:
        assert torch.equal(ko, po) and torch.equal(kw, pw)


@pytest.mark.parametrize("case", ["masked duplicate O=2", "unaligned",
                                  "N=20"])
def test_blend_replays_from_a_cuda_graph(dev, case):
    """blend_scatter captured in a CUDA graph (its window table in the
    launch's arguments) and replayed twice gives what two eager calls give.
    """
    out0, w0, preds, starts, mask, imp, _ = _blend_inputs(
        case, torch.bfloat16, dev)
    eo, ew = out0.clone(), w0.clone()
    for _ in range(2):
        blend.blend_scatter(eo, ew, preds, starts, mask, imp)
    go, gw = out0.clone(), w0.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        blend.blend_scatter(go, gw, preds, starts, mask, imp)
    go.copy_(out0)       # capture does not run the kernel; reset anyway
    gw.copy_(w0)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(go, eo) and torch.equal(gw, ew)


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 3, 9, 13), 5, 7),            # nothing aligned, N > 1
    ((1, 4, 16, 16), 24, 1),          # Cout = 1 (an attention conv2)
    ((1, 2, 12, 20), 40, 80),         # D = 2, two N tiles of 40
    ((2, 1, 8, 16), 16, 130),         # single depth plane, 3 N tiles
    ((1, 8, 12, 12), 96, 96),         # the bottom site: 2 slabs, 2 N tiles
    ((1, 7, 20, 36), 32, 48),         # steps not a multiple of the splits
    ((1, 1, 8, 16), 16, 16),          # one step: no split, no workspace
    ((1, 32, 48, 48), 64, 64),        # level 3, 44 splits
    ((2, 6, 24, 40), 200, 20),        # 4 slabs, Cin 200
])
def test_conv333_dw_kernel_matches_plain_and_is_deterministic(
        dev, shape, cin, cout):
    g = _g()
    x, dy = _x(g, dev, *shape, cin), _x(g, dev, *shape, cout)
    p = conv333_dw.plan(shape, cin, cout)
    if shape == (1, 7, 20, 36):
        assert p.nsplit > 1 and p.steps % p.nsplit != 0
    if shape == (1, 1, 8, 16):
        assert p.nsplit == 1
    n0 = conv333_dw.conv333_dw.launches
    dw, db = conv333_dw.conv333_dw(x, dy)
    assert conv333_dw.conv333_dw.launches == n0 + 1
    dw2, db2 = conv333_dw.conv333_dw(x, dy)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    pdw, pdb = conv333_dw.conv333_dw_plain(x, dy)
    _check(dw, pdw, DW_TOL)
    _check(db, pdb, DW_TOL)


def test_conv333_train_backward_matches_plain_autograd(dev):
    """The Function's kernel backward against autograd through the library
    conv (whose bf16 dw and db are rounded to bf16: TOL)."""
    g = _g()
    x = _x(g, dev, 1, 3, 10, 20, 12).requires_grad_()
    w = _w(g, dev, (3, 3, 3), 12, 20).requires_grad_()
    b = _v(g, dev, 20, -.2, .2).requires_grad_()
    dy = _x(g, dev, 1, 3, 10, 20, 20)
    n0 = conv333.conv333.launches, conv333_dw.conv333_dw.launches
    y = train_conv.conv333_train(x, w, b)
    got = torch.autograd.grad(y, (x, w, b), dy)
    assert (conv333.conv333.launches, conv333_dw.conv333_dw.launches) == (
        n0[0] + 1, n0[1] + 1)
    y_ref = train_conv.conv333_train(x, w, b, use_kernels=False)
    ref = torch.autograd.grad(y_ref, (x, w, b), dy)
    assert torch.equal(y, y_ref)
    assert got[1].dtype == torch.float32 and got[2].dtype == torch.float32
    for gk, gp in zip(got, ref):
        _check(gk, gp)


@pytest.mark.parametrize("shape,cins,cout,res", [
    ((2, 3, 9, 13), (1,), 16, False),         # Cin = 1 (down_0 unit0)
    ((1, 2, 12, 20), (8, 8), 2, True),        # pair + residual, Cout = 2
    ((1, 3, 16, 16), (16,), 2, False),        # Cout = 2: N = 8
    ((2, 2, 20, 24), (16, 16), 16, True),     # pair + pair residual
])
def test_conv333_kd1_kernel_matches_plain(dev, shape, cins, cout, res):
    g = _g()
    xs = tuple(_x(g, dev, *shape, c) for c in cins)
    x = xs if len(xs) > 1 else xs[0]
    w = _w(g, dev, (3, 3, 1), sum(cins), cout)
    args = (w, _v(g, dev, cout, .5, 1.5), _v(g, dev, cout, -.2, .2),
            _v(g, dev, 1, .1, .3))
    residual = ((x, _w(g, dev, (1, 1, 1), sum(cins), cout),
                 _v(g, dev, cout, -.2, .2)) if res else None)
    _check(conv333.conv333(x, *args, residual=residual),
           conv333.conv333_plain(x, *args, residual=residual))


def _l2d(g, dev, c, cout, head):
    kw = dict(w2=_w(g, dev, (3, 3, 1), c, 1), b2=_v(g, dev, 1, -.2, .2),
              w0=_w(g, dev, (3, 3, 1), 2 * c, cout),
              wr=_w(g, dev, (1, 1, 1), 2 * c, cout),
              br=_v(g, dev, cout, -.2, .2))
    if head:
        kw.update(bn_scale=None, bn_shift=_v(g, dev, cout, -.2, .2),
                  alpha=None)
    else:
        kw.update(bn_scale=_v(g, dev, cout, .5, 1.5),
                  bn_shift=_v(g, dev, cout, -.2, .2),
                  alpha=_v(g, dev, 1, .1, .3))
    return kw


@pytest.mark.parametrize("c,cout,head", [(12, 12, False), (8, 2, True)])
def test_block2d_and_tail_kernels_match_plain(dev, c, cout, head):
    g = _g()
    x = _x(g, dev, 2, 3, 10, 13, 5)
    kw = dict(w0=_w(g, dev, (3, 3, 1), 5, c),
              bn0_scale=_v(g, dev, c, .5, 1.5),
              bn0_shift=_v(g, dev, c, -.2, .2), alpha0=_v(g, dev, 1, .1, .3),
              w1=_w(g, dev, (3, 3, 1), c, c),
              bn1_scale=_v(g, dev, c, .5, 1.5),
              bn1_shift=_v(g, dev, c, -.2, .2), alpha1=_v(g, dev, 1, .1, .3),
              wr=_w(g, dev, (1, 1, 1), 5, c), br=_v(g, dev, c, -.2, .2))
    n0 = block2d.ru_block2d.launches
    _check(block2d.ru_block2d(x, **kw), block2d.ru_block2d_plain(x, **kw))
    assert block2d.ru_block2d.launches == n0 + 1
    xa, xb = _x(g, dev, 1, 3, 10, 13, c), _x(g, dev, 1, 3, 10, 13, c)
    kw = _l2d(g, dev, c, cout, head)
    l2 = dict(kw, w1=_w(g, dev, (3, 3, 1), 2 * c, c),
              b1=_v(g, dev, c, -.2, .2))
    for got, ref in zip(block2d.l2_block2d(xa, xb, **l2),
                        block2d.l2_block2d_plain(xa, xb, **l2)):
        _check(got, ref)
    a1 = _x(g, dev, 1, 3, 10, 13, c).abs()
    n0, k0 = tail2d.tail_block.launches, tail2d.tail_block.chain_calls
    for got, ref in zip(tail2d.tail_block(a1, xa, xb, **kw),
                        tail2d.tail_block_plain(a1, xa, xb, **kw)):
        _check(got, ref)
    # C = 8 takes the fused kernel, C = 12 (not a multiple of 8) the chain
    fused = tail2d.tail_fusable(c, c, cout)
    assert fused == (c == 8)
    assert (tail2d.tail_block.launches, tail2d.tail_block.chain_calls) == (
        n0 + fused, k0 + (not fused))


def _ru2d(g, dev, cin, cout):
    return dict(w0=_w(g, dev, (3, 3, 1), cin, cout),
                bn0_scale=_v(g, dev, cout, .5, 1.5),
                bn0_shift=_v(g, dev, cout, -.2, .2),
                alpha0=_v(g, dev, 1, .1, .3),
                w1=_w(g, dev, (3, 3, 1), cout, cout),
                bn1_scale=_v(g, dev, cout, .5, 1.5),
                bn1_shift=_v(g, dev, cout, -.2, .2),
                alpha1=_v(g, dev, cout, .1, .3),
                wr=_w(g, dev, (1, 1, 1), cin, cout),
                br=_v(g, dev, cout, -.2, .2))


@pytest.mark.parametrize("shape,cin,cout,tile", [
    ((2, 3, 20, 72), 1, 16, None),        # Cin = 1 by TMA, ragged H and W
    ((2, 3, 20, 70), 1, 16, None),        # Cin = 1, W % 8 != 0: plain loads
    ((1, 2, 19, 13), 1, 16, None),        # ... narrower than a tile
    ((1, 600, 16, 64), 1, 16, None),      # more tiles than blocks: the ring
    ((1, 600, 8, 64), 16, 32, None),      # ... wraps, TMA at Cin 16
    ((1, 2, 19, 70), 16, 32, None),       # down_1's widths, ragged
    ((1, 2, 19, 70), 16, 32, (16, 2)),    # ... 16-row tiles, two slots
    ((2, 3, 10, 13), 5, 12, None),        # nothing aligned: plain loads
    ((1, 3, 33, 64), 8, 16, (8, 2)),      # Cin 8, one tile wide
    ((1, 1, 9, 130), 24, 20, None),       # two chunks, Cout 20 (N = 32)
    ((1, 2, 19, 72), 1, 8, None),         # Cout 8 < N = 16
    ((1, 2, 9, 64), 8, 24, None),         # Cout 24 < N = 32
])
def test_ru_block2d_kernel_matches_plain(dev, shape, cin, cout, tile):
    """One csrc/rublock2d.cu launch per unit (no conv333 launch, so no
    padded copy of x), within TOL of the twin, bit-equal when repeated."""
    g = _g()
    x = _x(g, dev, *shape, cin)
    kw = _ru2d(g, dev, cin, cout)
    th, stages = tile or (None, None)
    n0, c0 = block2d.ru_block2d.launches, conv333.conv333.launches
    got = block2d.ru_block2d(x, th=th, stages=stages, **kw)
    again = block2d.ru_block2d(x, th=th, stages=stages, **kw)
    assert block2d.ru_block2d.launches == n0 + 2
    assert conv333.conv333.launches == c0
    assert torch.equal(got, again)
    _check(got, block2d.ru_block2d_plain(x, **kw))


def test_ru_block2d_kernel_refuses_what_it_cannot_take(dev):
    g = _g()
    with pytest.raises(ValueError, match="Cin, Cout <= 32"):
        block2d.ru_block2d(_x(g, dev, 1, 2, 8, 8, 16), **_ru2d(g, dev, 16, 48))
    with pytest.raises(TypeError):                      # not bf16
        block2d.ru_block2d(torch.zeros(1, 2, 8, 8, 1, device=dev),
                           **_ru2d(g, dev, 1, 16))
    with pytest.raises(ValueError, match="do not match"):
        block2d.ru_block2d(_x(g, dev, 1, 2, 8, 8, 2), **_ru2d(g, dev, 1, 16))


@pytest.mark.parametrize("shape,c,cout,head,tile", [
    ((1, 2, 20, 72), 16, 2, True, None),    # the head: TMA, ragged H
    ((1, 2, 19, 70), 16, 16, False, None),  # a PReLU unit, ragged W
    ((2, 3, 10, 13), 12, 12, False, None),  # C 12: plain loads
    ((1, 3, 33, 64), 8, 2, True, (8, 2)),   # C 8, two slots, one tile wide
    ((1, 600, 16, 64), 16, 2, True, None),  # more tiles than blocks
    ((1, 300, 8, 64), 16, 2, True, (8, 2)), # ... the two-slot ring wraps
    ((1, 2, 9, 66), 5, 9, False, (8, 1)),   # nothing aligned, Cout 9
    ((1, 2, 19, 70), 16, 2, False, None),   # partials under a PReLU
    ((2, 1, 12, 20), 8, 4, True, (8, 2)),   # Cout 4: conv0 per tap, N 8
])
def test_l2_block2d_kernel_matches_plain(dev, shape, c, cout, head, tile):
    """One csrc/l2block2d.cu launch per block (no conv333 or attgate
    launch), out and att within TOL of the twin, bit-equal when
    repeated."""
    g = _g()
    xa, xb = _x(g, dev, *shape, c), _x(g, dev, *shape, c)
    kw = dict(_l2d(g, dev, c, cout, head), w1=_w(g, dev, (3, 3, 1), 2 * c, c),
              b1=_v(g, dev, c, -.2, .2))
    if not head and cout == 9:
        kw["alpha"] = _v(g, dev, cout, .1, .3)
    th, stages = tile or (None, None)
    n0, c0 = block2d.l2_block2d.launches, conv333.conv333.launches
    a0 = l2block.attgate.launches
    got = block2d.l2_block2d(xa, xb, th=th, stages=stages, **kw)
    again = block2d.l2_block2d(xa, xb, th=th, stages=stages, **kw)
    assert block2d.l2_block2d.launches == n0 + 2
    assert (conv333.conv333.launches, l2block.attgate.launches) == (c0, a0)
    ref = block2d.l2_block2d_plain(xa, xb, **kw)
    for o, a, r in zip(got, again, ref):
        assert torch.equal(o, a)
        _check(o, r)


def test_l2_block2d_takes_the_chain_past_its_widths(dev):
    """C = 32 (up_1's widths) is past the kernel: the conv333 + attgate +
    conv333 chain runs, counted under those and in chain_calls."""
    g = _g()
    xa, xb = _x(g, dev, 1, 2, 9, 13, 32), _x(g, dev, 1, 2, 9, 13, 32)
    kw = dict(_l2d(g, dev, 32, 32, False),
              w1=_w(g, dev, (3, 3, 1), 64, 32), b1=_v(g, dev, 32, -.2, .2))
    n0, k0 = block2d.l2_block2d.launches, block2d.l2_block2d.chain_calls
    c0, a0 = conv333.conv333.launches, l2block.attgate.launches
    got = block2d.l2_block2d(xa, xb, **kw)
    assert (block2d.l2_block2d.launches, block2d.l2_block2d.chain_calls) == (
        n0, k0 + 1)
    assert (conv333.conv333.launches, l2block.attgate.launches) == (
        c0 + 2, a0 + 1)
    for o, r in zip(got, block2d.l2_block2d_plain(xa, xb, **kw)):
        _check(o, r)


@pytest.mark.parametrize("shape,ca,ch,cout,head,th", [
    ((1, 2, 19, 70), 32, 32, 32, False, None),  # up_1's widths, ragged
    ((2, 1, 9, 13), 32, 32, 32, False, None),   # ... one-tile planes
    ((1, 600, 8, 64), 32, 32, 32, False, None), # more tiles than blocks
    ((1, 2, 20, 72), 16, 16, 2, True, None),    # the head, ragged H
    ((1, 300, 16, 64), 16, 16, 2, True, None),  # ... the walk wraps
    ((1, 3, 33, 64), 16, 16, 2, True, 8),       # ... 8-row tiles
    ((1, 2, 21, 30), 8, 24, 9, False, None),    # Ca 8, Ch 24, Cout 9
    ((2, 2, 10, 66), 24, 8, 17, False, 8),      # Ca 24, Ch 8, Cout 17
    ((1, 1, 17, 64), 32, 16, 16, True, None),   # a linear unit at N 16
])
def test_tail_block_kernel_matches_plain(dev, shape, ca, ch, cout, head, th):
    """One csrc/tail2d.cu launch per tail (no conv333 or attgate launch),
    out and att within TOL of the twin, bit-equal when repeated."""
    g = _g()
    a1 = _x(g, dev, *shape, ca).relu()
    xa, xb = _x(g, dev, *shape, ch), _x(g, dev, *shape, ch)
    kw = dict(_l2d(g, dev, ch, cout, head),
              w2=_w(g, dev, (3, 3, 1), ca, 1), b2=_v(g, dev, 1, -.2, .2))
    if not head and cout == 9:
        kw["alpha"] = _v(g, dev, cout, .1, .3)
    n0, c0 = tail2d.tail_block.launches, conv333.conv333.launches
    a0 = l2block.attgate.launches
    got = tail2d.tail_block(a1, xa, xb, th=th, **kw)
    again = tail2d.tail_block(a1, xa, xb, th=th, **kw)
    assert tail2d.tail_block.launches == n0 + 2
    assert (conv333.conv333.launches, l2block.attgate.launches) == (c0, a0)
    ref = tail2d.tail_block_plain(a1, xa, xb, **kw)
    for o, a, r in zip(got, again, ref):
        assert torch.equal(o, a)
        _check(o, r)


def test_tail_block_kernel_refuses_what_it_cannot_take(dev):
    g = _g()
    a1, xa, xb = (_x(g, dev, 1, 2, 8, 8, 16) for _ in range(3))
    kw = dict(_l2d(g, dev, 16, 2, True), w2=_w(g, dev, (3, 3, 1), 16, 1),
              b2=_v(g, dev, 1, -.2, .2))
    with pytest.raises(TypeError):                      # not bf16
        tail2d.tail_block(a1.float(), xa.float(), xb.float(), **kw)
    with pytest.raises(ValueError, match="do not match"):
        tail2d.tail_block(a1, xa[..., :8], xb[..., :8], **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tail2d.tail_block(a1, *(torch.empty(
            xa.numel() + 1, dtype=xa.dtype, device=dev)[1:].view(xa.shape)
            for _ in range(2)), **kw)


@pytest.mark.parametrize("kd,cm,cx,n_x,att_out", [
    (1, 5, 5, 2, "compact"),        # nothing aligned
    (3, 8, 8, 1, "compact"),        # one gated input, depth taps
    (1, 8, 16, 2, "none"),          # gated inputs wider than a1
])
def test_fused_attention_gate_kernel_matches_plain(dev, kd, cm, cx, n_x,
                                                   att_out):
    g = _g()
    a1 = _x(g, dev, 2, 3, 7, 9, cm).abs()
    xs = [_x(g, dev, 2, 3, 7, 9, cx) for _ in range(n_x)]
    w2, b2 = _w(g, dev, (3, 3, kd), cm, 1), _v(g, dev, 1, -.2, .2)
    n0 = att.fused_attention_gate.launches
    got = att.fused_attention_gate(a1, xs, w2, b2, att_out=att_out)
    ref = att.fused_attention_gate_plain(a1, xs, w2, b2, att_out=att_out)
    assert att.fused_attention_gate.launches == n0 + 1
    if att_out == "none":
        assert got[0] is None and ref[0] is None
    else:
        _check(got[0], ref[0])
    assert len(got[1]) == n_x
    for o, r in zip(got[1], ref[1]):
        _check(o, r)


@pytest.mark.parametrize("shape,cin,cout,th", [
    ((2, 5, 7, 9), 5, 7, None),       # every size odd, nothing aligned
    ((1, 6, 34, 21), 80, 80, None),   # Cout = 80: one N tile; ragged tiles
    ((3, 1, 2, 3), 16, 1, None),      # one depth plane, Cout = 1
    ((1, 4, 10, 15), 12, 48, None),   # odd W (padded), Cin = 12
    ((2, 3, 40, 38), 12, 96, 8),      # TH = 8, Cout = 96: two N tiles
    ((1, 2, 33, 64), 64, 64, 16),     # W = 4 tiles of 16, ragged H
])
def test_ds_conv_kernel_matches_plain(dev, shape, cin, cout, th):
    g = _g()
    x = _x(g, dev, *shape, cin)
    args = (_w(g, dev, (3, 3, 3), cin, cout), _v(g, dev, cout, .5, 1.5),
            _v(g, dev, cout, -.2, .2), _v(g, dev, 1, .1, .3))
    n0 = dsconv.ds_conv.launches
    got = dsconv.ds_conv(x, *args, th=th)
    assert dsconv.ds_conv.launches == n0 + 1
    assert tuple(got.shape) == (shape[0], *((s - 1) // 2 + 1
                                            for s in shape[1:]), cout)
    _check(got, dsconv.ds_conv_plain(x, *args))


def test_ds_conv_kernel_refuses_what_it_cannot_take(dev):
    g = _g()
    w = _w(g, dev, (3, 3, 3), 8, 8)
    with pytest.raises(TypeError):                      # not bf16
        dsconv.ds_conv(torch.zeros(1, 2, 4, 4, 8, device=dev), w)
    with pytest.raises(ValueError):                     # zero-size
        dsconv.ds_conv(_x(g, dev, 1, 0, 4, 4, 8), w)
    with pytest.raises(ValueError):                     # Cin != w's
        dsconv.ds_conv(_x(g, dev, 1, 2, 4, 4, 16), w)


def test_inference_cli_on_the_card(dev, tmp_path, monkeypatch):
    """cli.inference.main on cuda under --routes dsconv over two synthetic
    48x48x16 cases (--debug: the flagship at a 128x128x32 ROI), against
    run_inference's plain path on the same weights."""
    import dataclasses
    from pathlib import Path

    from vs_seg_tpu_torch.cli import inference
    from vs_seg_tpu_torch.core.config import parse_cli
    from vs_seg_tpu_torch.data import nifti
    from vs_seg_tpu_torch.data.dataset import (CacheDataset, DataLoader,
                                               load_split_csv)
    from vs_seg_tpu_torch.data.synthetic import generate_dataset
    from vs_seg_tpu_torch.data.transforms import get_transforms
    from vs_seg_tpu_torch.infer.engine import run_inference
    from vs_seg_tpu_torch.models import build_model
    from vs_seg_tpu_torch.train.checkpoint import save_checkpoint

    monkeypatch.chdir(Path(__file__).resolve().parents[1])  # ./params/
    generate_dataset(str(tmp_path))   # the cases split_debug.csv names
    argv = ["--debug", "--data_root", str(tmp_path), "--device", "cuda",
            "--routes", "dsconv"]
    cfg = parse_cli(argv)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    save_checkpoint(str(Path(cfg.model_path) / "best_metric_model.ckpt"),
                    {"model": model.state_dict()})
    n0 = dsconv.ds_conv.launches
    dice, times = inference.main(argv, make_figures=False)
    assert dsconv.ds_conv.launches == n0 + 3 * 2     # 3 sites x 2 volumes
    assert dice.shape == (2,) and np.isfinite(dice).all() and len(times) == 2
    _, _, files = load_split_csv(cfg.split_csv, cfg.dataset, cfg.data_root)
    for f in files:
        case = Path(f["label"]).parent.name
        out = nifti.load(str(Path(cfg.results_folder_path)
                             / "inferred_segmentations_nifti" / case
                             / Path(f["label"]).name))
        ref = nifti.load(f["label"])
        assert out.data.shape == ref.data.shape
        np.testing.assert_allclose(out.affine, ref.affine)
    loader = DataLoader(CacheDataset(files, get_transforms(
        cfg.pad_crop_shape_test)[2]))
    plain, _ = run_inference(dataclasses.replace(
        cfg, results_folder_name="plain"), model, loader, device=dev,
        export=False, make_figures=False, use_kernels=False)
    np.testing.assert_allclose(dice, plain, atol=1e-2)


def _device_cache_samples(shapes=((40, 36, 20), (44, 36, 24), (40, 40, 20))):
    rng = np.random.default_rng(0)
    return [{"image": rng.normal(size=(1, *s)).astype(np.float32),
             "label": (rng.random((1, *s)) > 0.7).astype(np.float32)}
            for s in shapes]


def test_device_loader_makes_no_sync(dev):
    """Three epochs of a DeviceLoader (heterogeneous volumes, batch 2 with
    a partial last batch) under sync debug mode "error": no host-device
    sync; the mode is live (an .item() raises under it)."""
    from vs_seg_tpu_torch.data.device_pipeline import (DeviceCachedDataset,
                                                       DeviceLoader)

    ds = DeviceCachedDataset(_device_cache_samples(), (32, 32, 16),
                             device=dev)
    loader = DeviceLoader(ds, batch_size=2, shuffle=True, seed=0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        epochs = [list(loader) for _ in range(3)]
        with pytest.raises(RuntimeError):
            ds.images.float().sum().item()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for batches in epochs:
        assert [img.shape[0] for img, _ in batches] == [2, 1]
        for img, lbl in batches:
            assert img.is_cuda and tuple(img.shape[1:]) == (16, 32, 32, 1)
            assert img.dtype == torch.bfloat16 and lbl.dtype == torch.uint8


def test_device_crops_equal_host_crops_on_the_card(dev):
    """The train transforms' random suffix on the host (RandFlip, then
    RandSpatialCrop) against the device cache's crop at the same draws on
    the card (a host flip then a crop at h0 is the crop at H - ch - h0,
    then a flip): bit-equal to to_device_batch of the host crop."""
    from vs_seg_tpu_torch.data.device_pipeline import DeviceCachedDataset
    from vs_seg_tpu_torch.data.transforms import (Compose, RandFlip,
                                                  RandSpatialCrop)
    from vs_seg_tpu_torch.train.trainer import to_device_batch

    crop = (32, 32, 16)
    samples = _device_cache_samples()
    ds = DeviceCachedDataset(samples, crop, device=dev)
    suffix = Compose([RandFlip(prob=0.5, spatial_axis=0),
                      RandSpatialCrop(crop)])
    flips = set()
    for seed in range(12):
        i = seed % len(samples)
        host = suffix(samples[i], np.random.default_rng(seed))
        rng = np.random.default_rng(seed)
        flip = bool(rng.random() < 0.5)
        dims = samples[i]["image"].shape[1:]
        h0, w0, d0 = (int(rng.integers(0, n - c + 1)) for n, c in
                      zip(dims, crop))
        if flip:
            h0 = dims[0] - crop[0] - h0
        img, lbl = ds.crop([i], [(d0, h0, w0)], [flip])
        ref_img, ref_lbl = to_device_batch(
            {"image": host["image"][None], "label": host["label"][None]},
            dev, torch.bfloat16)
        assert torch.equal(img, ref_img) and torch.equal(lbl, ref_lbl)
        flips.add(flip)
    assert flips == {False, True}


# ---- the rest of the model zoo, --remat, the blend's options -------------

@pytest.mark.parametrize("cin,cout", [(32, 48), (48, 64), (64, 80)])
def test_ds_conv_kernel_at_the_unet_strided_units(dev, cin, cout):
    """UNet's strided down_2/3/4 unit0 under Routes(dsconv=True): ds_conv
    with Cin != Cout, at a small window."""
    g = _g()
    x = _x(g, dev, 2, 8, 24, 40, cin)
    args = (_w(g, dev, (3, 3, 3), cin, cout), _v(g, dev, cout, .5, 1.5),
            _v(g, dev, cout, -.2, .2), _v(g, dev, 1, .1, .3))
    n0 = dsconv.ds_conv.launches
    got = dsconv.ds_conv(x, *args)
    assert dsconv.ds_conv.launches == n0 + 1
    _check(got, dsconv.ds_conv_plain(x, *args))


def test_train_kernels_at_two_channels(dev):
    """UNet's upres_0 unit0 (2 -> 2 channels): Conv333Train's conv333
    dgrad and conv333_dw wgrad against plain autograd (TOL), conv333_dw
    bit-equal over two runs and within DW_TOL of its twin."""
    g = _g()
    x = _x(g, dev, 1, 4, 24, 40, 2).requires_grad_()
    w = _w(g, dev, (3, 3, 3), 2, 2).requires_grad_()
    b = _v(g, dev, 2, -.2, .2).requires_grad_()
    dy = _x(g, dev, 1, 4, 24, 40, 2)
    n0 = conv333.conv333.launches, conv333_dw.conv333_dw.launches
    got = torch.autograd.grad(train_conv.conv333_train(x, w, b), (x, w, b),
                              dy)
    assert (conv333.conv333.launches, conv333_dw.conv333_dw.launches) == (
        n0[0] + 1, n0[1] + 1)
    ref = torch.autograd.grad(
        train_conv.conv333_train(x, w, b, use_kernels=False), (x, w, b), dy)
    for gk, gp in zip(got, ref):
        _check(gk, gp)
    dw, db = conv333_dw.conv333_dw(x.detach(), dy)
    dw2, db2 = conv333_dw.conv333_dw(x.detach(), dy)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    pdw, pdb = conv333_dw.conv333_dw_plain(x.detach(), dy)
    _check(dw, pdw, DW_TOL)
    _check(db, pdb, DW_TOL)


def _zoo_model(dev, name, **kw):
    from vs_seg_tpu_torch.core.config import Config
    from vs_seg_tpu_torch.models import build_model
    return build_model(Config(model=name, **kw), device=dev,
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name,ds,n_ru", [
    ("UNet2d5", False, 4), ("UNet", False, 1), ("UNet", True, 1)])
def test_alt_models_kernel_path_matches_plain(dev, name, ds, n_ru):
    """UNet2d5 and UNet at full width over a 16x64x64 window: the kernel
    path against the all-plain path (TOL of the largest logit), ru_block
    at every two-subunit stride-1 encoder unit, ds_conv at UNet's three
    strided (3,3,3) units under Routes(dsconv=True), no decoder block."""
    from vs_seg_tpu_torch.core.config import Routes
    model = _zoo_model(dev, name)
    x = _x(_g(), dev, 2, 16, 64, 64, 1)
    routes = Routes(dsconv=ds)
    names = ("ru_block", "ds_conv", "l2_block")
    fns = (rublock.ru_block, dsconv.ds_conv, l2block.l2_block)
    n0 = [f.launches for f in fns]
    with torch.no_grad():
        got = model(x, routes=routes)
        n1 = [f.launches for f in fns]
        ref = model(x, use_kernels=False, routes=routes)
    assert dict(zip(names, (b - a for a, b in zip(n0, n1)))) == {
        "ru_block": n_ru, "ds_conv": 3 if ds else 0, "l2_block": 0}
    assert got.shape == (2, 16, 64, 64, 2)
    _check(got, ref, 3e-2)


def test_remat_on_the_card(dev):
    """The flagship's train step at full width with dropout 0.1 over a
    16x64x64 crop, with and without --remat: the loss bit-equal, the
    dropout generator's state after the step equal, every gradient within
    TOL of its tensor's largest (cuDNN's backward may sum in another
    order; the conv biases in front of a train-mode BatchNorm, whose
    gradient is rounding noise, against the model's largest)."""
    from vs_seg_tpu_torch.losses.dice import dice_spvpa_loss
    from vs_seg_tpu_torch.nn.blocks import Convolution
    model = _zoo_model(dev, "UNet2d5_spvPA")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    x = _x(_g(), dev, 1, 16, 64, 64, 1)
    y = (torch.rand((1, 16, 64, 64, 1), generator=_g()) > 0.8).float().to(
        dev)
    runs = []
    for remat in (False, True):
        model.remat = remat
        model.load_state_dict(init)
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(dev).manual_seed(3)
        logits, atts = model(x, train=True, generator=gen)
        loss = dice_spvpa_loss(logits, atts, y)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.float() for n, p in
                                     model.named_parameters()},
                     gen.get_state()))
    (l0, g0, r0), (l1, g1, r1) = runs
    assert torch.equal(l0, l1) and torch.equal(r0, r1)
    noise = {f"{n}.conv.bias" for n, m in model.named_modules()
             if isinstance(m, Convolution) and m.norm is not None}
    gmax = max(float(g.abs().max()) for g in g0.values())
    for n, ref in g0.items():
        scale = gmax if n in noise else float(ref.abs().max())
        assert float((g1[n] - ref).abs().max()) <= TOL * scale, n


@pytest.mark.parametrize("mode,sigma_scale", [("constant", 0.125),
                                              ("gaussian", 0.25)])
def test_sliding_window_blend_options_on_the_card(dev, mode, sigma_scale):
    """sliding_window_inference with mode "constant" and a Gaussian of
    sigma_scale 0.25: the blend kernel bit-equal to its twin."""
    from vs_seg_tpu_torch.infer.sliding_window import (
        sliding_window_inference)
    vol = np.random.default_rng(0).normal(size=(80, 72, 36, 1)).astype(
        np.float32)

    def predictor(wins):
        return torch.cat([wins, -wins], -1).to(torch.bfloat16)

    n0 = blend.blend_scatter.launches
    outs = [sliding_window_inference(
        vol, (64, 64, 32), predictor, device=dev, sw_batch_size=2,
        mode=mode, sigma_scale=sigma_scale, use_kernels=k)
        for k in (True, False)]
    assert blend.blend_scatter.launches > n0
    assert torch.equal(outs[0], outs[1])


# ---- bnorm_train: the train-mode BatchNorm -> dropout -> PReLU ------------

# the flagship's level-0 and level-1 train activations at a 384x384x64 crop
BNORM_SHAPES = [(1, 64, 384, 384, 16), (1, 64, 192, 192, 32)]
# a sum of f32 terms in another order: within 1e-5 of the sum of |terms|
SUM_TOL = 1e-5


def _bnorm_case(dev, shape, seed=0):
    """bf16 y (a conv output: mean 0.3, std 2), the dropout words of rate
    0.1, f32 per-channel statistics and parameters, an upstream g."""
    from vs_seg_tpu_torch.ops import bnorm_train as bt
    c = shape[-1]
    gen = torch.Generator(dev).manual_seed(seed)
    y = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.3).to(
        torch.bfloat16)
    g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    words = torch.randint(0, bt.WORDS, shape, generator=gen, device=dev,
                          dtype=torch.int32)
    mean = torch.rand(c, generator=gen, device=dev) * 0.6
    inv = torch.rand(c, generator=gen, device=dev) * 0.5 + 0.25
    bias = torch.randn(c, generator=gen, device=dev) * 0.2
    alpha = torch.full((1,), 0.25, device=dev)
    return y, g, words, 58982, mean, inv, bias, alpha


def _sum_check(got, terms):
    """got (K,) against the float64 sums of terms (M, K) (or (M,) for one
    sum), within SUM_TOL of the sums of |terms|."""
    t = terms.double().reshape(terms.shape[0], -1)
    err = (got.double() - t.sum(0)).abs()
    assert bool((err <= SUM_TOL * t.abs().sum(0)).all()), err.max()


@pytest.mark.parametrize("shape", BNORM_SHAPES)
@pytest.mark.parametrize("drop", [True, False])
def test_bnorm_train_kernels_match_twins(dev, shape, drop):
    """Each pass at the flagship's level-0 and level-1 shapes: stats and
    bwd_reduce within SUM_TOL of float64 sums of the twins' terms and
    bit-equal over two runs (fixed-order sums); apply (output and mask
    bits) and bwd_apply bit-equal to their twins given the same
    statistics and coefficients (the same f32 ops in the same order,
    rounded once)."""
    from vs_seg_tpu_torch.ops import bnorm_train as bt
    y, g, words, thresh, mean, inv, bias, alpha = _bnorm_case(dev, shape)
    if not drop:
        words = thresh = None
    c = shape[-1]
    n0 = bt.bn_dropout_prelu.launches
    s1, s2 = bt.stats(y), bt.stats(y)
    assert torch.equal(s1, s2)
    yf = y.reshape(-1, c).float()
    _sum_check(s1[:c], yf)
    _sum_check(s1[c:], yf * yf)
    out, bits = bt.apply(y, words, thresh, mean, inv, bias, alpha)
    pout, pbits = bt.apply_plain(y, words, thresh, mean, inv, bias, alpha)
    assert torch.equal(out, pout)
    assert (bits is None and pbits is None) or torch.equal(bits, pbits)
    r1 = bt.bwd_reduce(g, y, bits, thresh, mean, inv, bias, alpha)
    r2 = bt.bwd_reduce(g, y, bits, thresh, mean, inv, bias, alpha)
    assert torch.equal(r1, r2)
    gf, d, zp, gh = bt._backward_terms(g, y, pbits, thresh, mean, inv, bias,
                                       alpha)
    _sum_check(r1[:c], gh)
    _sum_check(r1[c:2 * c], gh * d)
    _sum_check(r1[2 * c:], (gf * torch.clamp_max(zp, 0)).reshape(-1, 1))
    del gf, d, zp, gh
    c1 = -(inv * r1[:c]) / (y.numel() // c)
    c2 = -(inv * r1[c:2 * c]) / (y.numel() // c)
    dy = bt.bwd_apply(g, y, bits, thresh, mean, inv, bias, alpha, c1, c2)
    assert torch.equal(dy, bt.bwd_apply_plain(g, y, pbits, thresh, mean, inv,
                                              bias, alpha, c1, c2))
    assert bt.bn_dropout_prelu.launches == n0 + 2 + 2 + 1 + 2 + 2 + 1


@pytest.mark.parametrize("c", [16, 96, 7])
@pytest.mark.parametrize("counted", [False, True])
def test_bnorm_train_finishes_match_twins(dev, c, counted):
    """The finish kernels bit-equal to their twins, the torch ops they
    replace, on the card: the count from the host (one process) and on the
    card (as a batch-stats group sums it); one launch each."""
    from vs_seg_tpu_torch.ops import bnorm_train as bt
    gen = torch.Generator(dev).manual_seed(c)
    y = torch.randn(2 * 64 * 96, c, generator=gen, device=dev) * 1.5 + 0.3
    sums = torch.cat([y.sum(0), (y * y).sum(0)])
    n = float(y.shape[0])
    count = torch.tensor(n, device=dev) if counted else n
    run = [torch.rand(c, generator=gen, device=dev),
           torch.rand(c, generator=gen, device=dev) + 0.5]
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    red = torch.randn(2 * c + 1, generator=gen, device=dev) * 300.0
    total = red[:2 * c] * 3 if counted else red[:2 * c]
    outs = []
    for fn, bwd in ((bt.finish, bt.bwd_finish),
                    (bt.finish_plain, bt.bwd_finish_plain)):
        r = [t.clone() for t in run]
        n0 = bt.bn_dropout_prelu.launches
        fwd = fn(sums, count, *r, scale)
        outs.append([*fwd, *r, *bwd(red, total, count, fwd[1], fwd[2])])
        assert bt.bn_dropout_prelu.launches - n0 == (
            2 if fn is bt.finish else 0)
    for k, (a, b) in enumerate(zip(*outs)):
        assert torch.equal(a, b), (k, float((a - b).abs().max()))


@pytest.mark.parametrize("c", [16, 7])
def test_bnorm_train_function_matches_the_eager_chain(dev, c):
    """The Function on the card (bf16, dropout 0.1) against the eager
    chain in float32 on the same bf16 input and words: output and
    gradients within TOL of each tensor's largest, the running statistics
    within 1e-5."""
    from vs_seg_tpu_torch.nn.layers import BatchNorm, Dropout, PReLU
    from vs_seg_tpu_torch.ops import bnorm_train as bt
    x = _x(_g(), dev, 2, 8, 24, 40, c) * 2
    w = _x(_g(), dev, 2, 8, 24, 40, c).float()
    runs = []
    for dtype, fused in ((torch.bfloat16, True), (torch.float32, False)):
        bn, act = BatchNorm(c, device=dev), PReLU(device=dev)
        gen = torch.Generator(dev).manual_seed(3)
        xt = x.to(dtype).detach().clone().requires_grad_()
        n0 = bt.bn_dropout_prelu.launches
        if fused:
            out = bt.bn_dropout_prelu(xt, bn, act.alpha,
                                      Dropout(0.1).draw(xt, gen))
        else:
            out = act(Dropout(0.1)(bn(xt), True, gen))
        (out.float() * w).sum().backward()
        assert bt.bn_dropout_prelu.launches - n0 == (
            bt.LAUNCHES_PER_SITE if fused else 0)
        runs.append([out.float(), xt.grad.float(), bn.scale.grad,
                     bn.bias.grad, act.alpha.grad, bn.mean, bn.var])
    for k, (a, b) in enumerate(zip(*runs)):
        _check(a, b, 1e-5 if k >= 5 else TOL)


@pytest.mark.parametrize("c", [1, 3, 7, 12, 100, 130, 320, 1000])
def test_bnorm_train_plan_takes_any_width(dev, c):
    """csrc/bnorm_train.cu's plan (block_threads, bnorm_plan) at widths off
    the flagship: rows for at least 4 blocks an SM, and every pass at a
    small shape bit-equal to its twin (stats and bwd_reduce within
    SUM_TOL of float64 sums)."""
    from vs_seg_tpu_torch.ops import bnorm_train as bt
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert bt.rows(c, dev.index or 0) >= 4 * sms
    y, g, words, thresh, mean, inv, bias, alpha = _bnorm_case(
        dev, (3, 5, 7, c), seed=c)
    yf = y.reshape(-1, c).float()
    _sum_check(bt.stats(y)[c:], yf * yf)
    out, bits = bt.apply(y, words, thresh, mean, inv, bias, alpha)
    pout, pbits = bt.apply_plain(y, words, thresh, mean, inv, bias, alpha)
    assert torch.equal(out, pout) and torch.equal(bits, pbits)
    red = bt.bwd_reduce(g, y, bits, thresh, mean, inv, bias, alpha)
    _, d, _, gh = bt._backward_terms(g, y, pbits, thresh, mean, inv, bias,
                                     alpha)
    _sum_check(red[c:2 * c], gh * d)
    c1, c2 = -inv * 0.01, inv * 0.02
    assert torch.equal(
        bt.bwd_apply(g, y, bits, thresh, mean, inv, bias, alpha, c1, c2),
        bt.bwd_apply_plain(g, y, pbits, thresh, mean, inv, bias, alpha, c1,
                           c2))


@pytest.mark.parametrize("c", [1031, 4000])
def test_bnorm_train_plan_refuses_widths_past_the_kernels(dev, c):
    """A C that needs blocks past 512 threads (1031) or more shared memory
    than a block has (4000) raises before any launch."""
    from vs_seg_tpu_torch.ops import bnorm_train as bt
    n0 = bt.bn_dropout_prelu.launches
    with pytest.raises(ValueError, match=f"C = {c}"):
        bt.stats(torch.zeros(2, c, device=dev, dtype=torch.bfloat16))
    assert bt.bn_dropout_prelu.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_bnorm_train_refuses_what_it_cannot_take(dev, dtype):
    """A CUDA tensor never falls back to a twin: another dtype raises, and
    so do parameters of another length."""
    from vs_seg_tpu_torch.ops import bnorm_train as bt
    with pytest.raises(TypeError, match="bfloat16"):
        bt.stats(torch.zeros(4, 8, device=dev, dtype=dtype))
    y = torch.zeros(4, 8, device=dev, dtype=torch.bfloat16)
    v = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="8 elements"):
        bt.apply(y, None, None, v[:4], v, v, v[:1])


def test_bnorm_train_launches_per_train_step(dev):
    """One full-width flagship train step over a 16x64x64 crop:
    bn_dropout_prelu launches LAUNCHES_PER_SITE kernels at every train
    Convolution with BatchNorm and PReLU, counted from the model."""
    from vs_seg_tpu_torch.nn.blocks import Convolution
    from vs_seg_tpu_torch.ops import bnorm_train as bt
    from vs_seg_tpu_torch.train import trainer as ttrainer
    model = _zoo_model(dev, "UNet2d5_spvPA")
    sites = sum(1 for m in model.modules() if isinstance(m, Convolution)
                and m.norm is not None and m.act_name == "prelu")
    opt = ttrainer.make_optimizer(model.parameters(), 1e-4, 1e-7)
    step = ttrainer.make_train_step(model, opt, supervised_attention=True,
                                    hardness=True)
    x = _x(_g(), dev, 1, 16, 64, 64, 1)
    y = (torch.rand((1, 16, 64, 64, 1), generator=_g()) > 0.8).float().to(
        dev)
    n0 = bt.bn_dropout_prelu.launches
    loss = step(x, y, torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert sites == 26
    assert bt.bn_dropout_prelu.launches - n0 == bt.LAUNCHES_PER_SITE * sites
