"""conv333_dw's launch plan and decomposition, on the CPU.

csrc/conv333_dw.cu cannot run here, so its arithmetic is held by an emulation
in torch that follows the kernel block by block: the plan's units (kh, Cin
slab, N tile, split) and split ranges, the stream of ring stages that walks
each column along d (x plane q and dy plane q - 1 per stage, a 5-slot ring
filled as far ahead as the releases allow, so a slot overwritten too early
shows), each warpgroup's three taps as an M = 64 slab x N tile product per
16-voxel row (the rows past the slab staged as NaN, so a stored padding row
shows), db from the blocks of kh = 0 and slab 0, and the splits summed in
split order. It must equal conv333_dw_plain in float32 to 1e-5 (the same
exact products summed in another order) and JAX's pallas_train.conv333_dw
(interpret mode) + dw_extract/db_extract at that kernel's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vs_seg_tpu.ops.experimental import pallas_train
from vs_seg_tpu_torch.ops import conv333_dw as dwm

STAGES = 5        # csrc/conv333_dw.cu's ring slots
TH, TW = dwm.TH, dwm.TW

# the flagship's conv333_dw sites in one train step (batch 1, 384x384x64):
# (N, D, H, W), Cin, Cout
FLAGSHIP_SITES = (
    ((1, 64, 96, 96), 48, 48), ((1, 64, 96, 96), 48, 1),
    ((1, 64, 96, 96), 32, 48), ((1, 32, 48, 48), 64, 64),
    ((1, 32, 48, 48), 64, 1), ((1, 32, 48, 48), 48, 64),
    ((1, 16, 24, 24), 80, 80), ((1, 16, 24, 24), 80, 1),
    ((1, 16, 24, 24), 64, 80), ((1, 8, 12, 12), 96, 96),
    ((1, 8, 12, 12), 80, 96), ((1, 8, 12, 12), 40, 1),
    ((1, 8, 12, 12), 80, 40),
)
RAGGED_SITES = (
    ((2, 3, 9, 13), 5, 7), ((1, 4, 16, 16), 24, 1), ((1, 2, 12, 20), 40, 80),
    ((2, 1, 8, 16), 16, 130), ((1, 7, 20, 36), 32, 48),
    ((1, 1, 8, 16), 16, 16), ((3, 5, 17, 33), 200, 3),
)


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---- the plan -------------------------------------------------------------

@pytest.mark.parametrize("shape,cin,cout", FLAGSHIP_SITES + RAGGED_SITES)
@pytest.mark.parametrize("sms", [132, 16])
def test_plan_covers_every_step_once_within_limits(shape, cin, cout, sms):
    p = dwm.plan(shape, cin, cout, sms)
    n, d, h, w = shape
    assert p.steps == n * d * -(-h // TH) * -(-w // TW)
    # every (n, tile column, d) step in exactly one split, the splits
    # contiguous, non-empty and in order
    ranges = dwm.split_ranges(p)
    assert ranges[0][0] == 0 and ranges[-1][1] == p.steps
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0] for i in range(len(ranges) - 1))
    # the slabs and N tiles cover Cin and Cout within the kernel's widths
    assert p.cs % 8 == 0 and 8 <= p.cs <= dwm.SLAB_MAX
    assert p.nslab * p.cs >= cin and (p.nslab - 1) * p.cs < cin
    assert p.ntile in dwm.N_TILES and p.nnt * p.ntile >= cout
    assert p.cx % 8 == 0 and p.cx >= cin and p.cdy % 8 == 0 and p.cdy >= cout
    # the workspace under its cap, none for one split; the grid within the
    # SMs (the launch is cooperative) and the units
    assert p.ws_floats * 4 <= dwm.WORKSPACE_MAX
    assert (p.ws_floats == 0) == (p.nsplit == 1)
    if p.nsplit > 1:
        assert p.ws_floats == p.nsplit * (27 * cin * cout + cout)
    assert p.groups == 3 * p.nslab * p.nnt
    assert p.units == p.groups * p.nsplit and p.units < 2 ** 31
    assert 1 <= p.grid <= min(p.units, sms)
    assert 1 <= p.nsplit <= p.steps
    if p.groups <= sms and p.nsplit < p.steps:
        assert p.units > sms - p.groups     # the splits fill the SMs


def test_plan_is_cached_per_shape():
    dwm.plan.cache_clear()
    a = dwm.plan((1, 32, 48, 48), 64, 64, 132)
    b = dwm.plan((1, 32, 48, 48), 64, 64, 132)
    assert a is b and dwm.plan.cache_info().hits == 1
    assert dwm.plan((1, 32, 48, 48), 64, 1, 132) is not a


def test_flagship_plans():
    """L3 64->64 fills 132 SMs with 44 splits of 3 kh groups; the bottom
    96->96 cuts Cin and Cout into two 48-wide slabs and N tiles."""
    p = dwm.plan((1, 32, 48, 48), 64, 64)
    assert (p.nslab, p.cs, p.ntile, p.nnt, p.nsplit, p.grid) == \
        (1, 64, 64, 1, 44, 132)
    p = dwm.plan((1, 8, 12, 12), 96, 96)
    assert (p.nslab, p.cs, p.ntile, p.nnt, p.groups) == (2, 48, 48, 2, 12)
    assert dwm.plan((1, 64, 96, 96), 48, 1).ntile == 8


def test_pad_channels_matches_numpy():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2, 3, 4, 5, 5)).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    got = dwm.pad_channels(t, 8)
    ref = np.pad(t.float().numpy(), ((0, 0),) * 4 + ((0, 3),))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert np.array_equal(got.float().numpy(), ref)
    same = torch.from_numpy(rng.normal(size=(1, 2, 3, 4, 8))
                            .astype(np.float32))
    assert dwm.pad_channels(same, 8) is same


# ---- the emulation --------------------------------------------------------

def _walk(p, d, block):
    """The kernel's stream of stages for one block: (unit fields, segment,
    q) in order, as csrc/conv333_dw.cu:Walk makes it."""
    out = []
    for unit in range(block, p.units, p.grid):
        g, split = unit % p.groups, unit // p.groups
        kh, slab, nt = g % 3, (g // 3) % p.nslab, g // (3 * p.nslab)
        t0, t_end = dwm.split_ranges(p)[split]
        t = t0
        while t < t_end:
            c, da = divmod(t, d)
            db = min(d, da + (t_end - t))
            n, hw = divmod(c, p.tiles_h * p.tiles_w)
            col = (n, (hw // p.tiles_w) * TH, (hw % p.tiles_w) * TW)
            for q in range(max(da - 1, 0), db + 1):
                out.append(dict(unit=unit, split=split, kh=kh, slab=slab,
                                nt=nt, col=col, da=da, db=db, q=q,
                                seg_end=q == db,
                                unit_end=q == db and t + db - da >= t_end))
            t += db - da
    return out


def emulate(x, dy, p):
    """(dw, db) through the kernel's decomposition; see the module doc."""
    n, d, h, w, cin = x.shape
    cout = dy.shape[-1]
    # the staged operands: zero outside the volume (the TMA's fill) and
    # past the tensors' channels
    xz = F.pad(x.float(), (0, p.nslab * p.cs - cin, 1, 1 + TW, 1, 1 + TH))
    dyz = F.pad(dy.float(), (0, p.nnt * p.ntile - cout, 0, TW, 0, TH))
    ndw = 27 * cin * cout
    part = torch.full((p.nsplit, ndw + cout), float("nan"))
    for block in range(p.grid):
        stages = _walk(p, d, block)
        slots = [None] * STAGES
        filled = released = 0
        acc = torch.zeros(3, 3, 64, p.ntile)
        dbacc = torch.zeros(p.ntile)
        for k, st in enumerate(stages):
            # the producer, as far ahead as the released slots allow
            while filled < len(stages) and filled < released + STAGES:
                f = stages[filled]
                nb, h0, w0 = f["col"]
                xs = torch.full((TH + 2, TW + 2, 64), float("nan"))
                if f["q"] < d:
                    c0 = f["slab"] * p.cs
                    xs[..., :p.cs] = xz[nb, f["q"], h0:h0 + TH + 2,
                                        w0:w0 + TW + 2, c0:c0 + p.cs]
                ys = None
                if f["q"] - 1 >= f["da"]:
                    n0 = f["nt"] * p.ntile
                    ys = dyz[nb, f["q"] - 1, h0:h0 + TH, w0:w0 + TW,
                             n0:n0 + p.ntile]
                slots[filled % STAGES] = (filled, f["q"], xs, ys)
                filled += 1
            assert slots[k % STAGES][0] == k
            if st["q"] - 1 >= st["da"]:
                ys = slots[k % STAGES][3].reshape(TH, TW, p.ntile)
                for kd in range(3):
                    pl = st["q"] - 2 + kd
                    if not 0 <= pl < d:
                        continue
                    sk, sq, xs, _ = slots[(k - 2 + kd) % STAGES]
                    assert (sk, sq) == (k - 2 + kd, pl)    # not overwritten
                    kh = st["kh"]
                    for r in range(TH):
                        for kw in range(3):
                            a = xs[r + kh, kw:kw + TW, :]          # (16, 64)
                            acc[kd, kw] += a.t() @ ys[r]
                if st["kh"] == 0 and st["slab"] == 0:
                    dbacc += ys.reshape(-1, p.ntile).sum(0)
            if st["seg_end"]:
                released = k + 1
            else:
                released = max(released, k - 1)
            if st["unit_end"]:
                out = part[st["split"]]
                c0, n0 = st["slab"] * p.cs, st["nt"] * p.ntile
                m = min(p.cs, cin - c0)
                nn = min(p.ntile, cout - n0)
                view = out[:ndw].view(3, 3, 3, cin, cout)
                for kd in range(3):
                    for kw in range(3):
                        view[st["kh"], kw, kd, c0:c0 + m, n0:n0 + nn] = \
                            acc[kd, kw, :m, :nn]
                if st["kh"] == 0 and st["slab"] == 0:
                    out[ndw + n0:ndw + n0 + nn] = dbacc[:nn]
                acc.zero_()
                dbacc.zero_()
    assert not torch.isnan(part).any()          # every element written once
    tot = part[0].clone()
    for s in range(1, p.nsplit):                # split order
        tot += part[s]
    return tot[:ndw].view(3, 3, 3, cin, cout), tot[ndw:]


def _inputs(shape, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    dy = rng.normal(size=(*shape, cout)).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(dy).to(torch.bfloat16))


@pytest.mark.parametrize("shape,cin,cout,sms", [
    ((2, 3, 9, 13), 5, 7, 132),       # nothing aligned, N > 1
    ((1, 4, 16, 16), 24, 1, 132),     # Cout = 1
    ((1, 2, 12, 20), 40, 80, 30),     # D = 2, two N tiles
    ((2, 1, 8, 16), 16, 130, 132),    # D = 1, three N tiles
    ((1, 7, 20, 36), 32, 48, 132),    # steps not a multiple of the splits
    ((1, 1, 8, 16), 16, 16, 132),     # one step: no split
    ((1, 5, 8, 16), 96, 96, 12),      # two slabs, more units than blocks
    ((1, 6, 9, 17), 200, 20, 7),      # one split, blocks loop over units
])
def test_emulation_matches_plain(shape, cin, cout, sms):
    x, dy = _inputs(shape, cin, cout, 0)
    p = dwm.plan(shape, cin, cout, sms)
    dw, db = emulate(x, dy, p)
    pdw, pdb = dwm.conv333_dw_plain(x, dy)
    assert _rel(dw, pdw) <= 1e-5 and _rel(db, pdb) <= 1e-5


def test_emulation_cases_cover_the_edges():
    """The cases above reach what they say: a split count that does not
    divide the steps, a plan with no split, and units looped by blocks."""
    assert dwm.plan((1, 7, 20, 36), 32, 48).steps % \
        dwm.plan((1, 7, 20, 36), 32, 48).nsplit != 0
    assert dwm.plan((1, 1, 8, 16), 16, 16).nsplit == 1
    p = dwm.plan((1, 6, 9, 17), 200, 20, 7)
    assert p.nsplit == 1 and p.units > p.grid
    p = dwm.plan((1, 5, 8, 16), 96, 96, 12)
    assert p.nsplit == 1 and p.units == 12


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16), (3, 5)])
def test_emulation_matches_pallas_dw(cin, cout):
    """At the TPU kernel's shapes, the emulation (split into 5 ranges)
    against JAX conv333_dw (interpret mode) + dw_extract/db_extract,
    float32: 1e-5."""
    shape = (1, 3, 16, 32)
    x, dy = _inputs(shape, cin, cout, 1)
    xf, dyf = x.float().numpy(), dy.float().numpy()
    gm, ge, db = pallas_train.conv333_dw(jnp.asarray(xf), jnp.asarray(dyf),
                                         interpret=True)
    ref_dw = pallas_train.dw_extract(gm, ge, cin, cout)
    ref_db = pallas_train.db_extract(db, cout)
    p = dwm.plan(shape, cin, cout, 15)
    assert p.nsplit == 5
    got_dw, got_db = emulate(x, dy, p)
    assert _rel(got_dw, ref_dw) <= 1e-5
    assert _rel(got_db, ref_db) <= 1e-5
