"""The port's (3,3,3) encoder ResidualUnit, ops/rublock.py:ru_block, held on
the CPU against its twin and the JAX package's Pallas kernel, and the unit
kernel of csrc/conv333.cu (ru_unit_kernel, through ops/rublock.py:ru_unit)
by an emulation that follows it block by block and stage by stage.

On a CUDA tensor ru_block is one cooperative launch where ops/rublock.py:
plan takes the shape (the flagship's down_2, 32 -> 48): blocks 0 .. p0 - 1
run conv0's tiles (x -> u0), the others conv1's (u0 -> out, then the
residual's stages on x), each role's packed weights resident in shared
memory; conv0's consumer warps announce their stored rows of a tile on a
per-(n, d) counter, conv1's producer waits on the counters of the u0 planes
a tile reads (d - 1 .. d + 1 inside the volume) before it copies their
halo. Elsewhere it is the parent chain, two conv333 launches. The kernel
runs only on the card (tests/test_torch_cuda.py and chip_smoke.py hold it
against the twin and, bit for bit, against the chain there). Here:

- the plan: the role split, the resident weight sizes (both roles within
  an H100 block's 227 KB at down_2), the shape rule at the four flagship
  sites;
- `UnitEmu` runs the kernel's blocks as coroutines under a scheduler:
  every block walks its role's tiles as the kernel does (first, first +
  step, ...; (h, w) fastest, then d, then n), each stage staged into the
  block's own ring slot (stale contents kept between uses) as the two
  zero-filled TMA boxes of its halo's 8-channel halves, each tap's A
  operand read through the wgmma descriptor arithmetic and B from the
  block's resident weight region (filled by the producer's bulk copies of
  one slab each), the epilogue, and each consumer warp's store of its rows
  (through its staging rows, 16 bytes at a time) followed by its arrival
  on the plane counter (the warps of a tile arrive in a seeded random
  order). u0 and out start as NaN (device memory the
  kernel has not written). A conv1 block suspends where its producer waits
  and resumes only once the counter reads the target; the scheduler (round
  robin, seeded random, or conv1 first with conv0's block 0 starved) must
  finish every block, or the launch would deadlock;
- without the arithmetic, the same schedule for many role splits: every u0
  plane a conv1 stage copies is completely stored when its wait returns,
  every counter ends at its target, every output is stored once;
- in float32 on bf16-rounded weights the emulation matches the twin to
  EMU_TOL of the largest output and the JAX Pallas ru_block in interpret
  mode to OUT_TOL (tests/test_torch_kernels.py's), in bf16 the twin within
  chip_smoke.py's KERNEL_TOL band;
- mutations the emulation must catch: the counter target one short, the
  wait on planes d and d + 1 only, and a u0 halo row above the volume left
  unzeroed;
- on the CPU, ru_block and ru_unit run the twin and count nothing.

Inputs come from numpy with a fixed seed; shapes are small (D <= 5, H, W
<= 40).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vs_seg_tpu.ops.pallas_rublock import can_ru_block, ru_block as jru
from vs_seg_tpu_torch.ops import conv333, rublock

EMU_TOL = 1e-5            # float32 emulation vs twin, relative to max|ref|
OUT_TOL = 1e-4            # vs the Pallas kernel (tests/test_torch_kernels.py)
KERNEL_TOL = 2e-2         # bf16 (chip_smoke.py)
TW = rublock.TW
KC = conv333.KC
T = torch.from_numpy
SITES = {"down_2": ((8, 64, 96, 96), 32, 48),
         "down_3": ((8, 32, 48, 48), 48, 64),
         "down_4": ((8, 16, 24, 24), 64, 80),
         "bottom": ((8, 8, 12, 12), 80, 96)}


def _params(rng, cin, cout):
    def w(k, ci, co):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        return rng.uniform(-b, b, size=(*k, ci, co)).astype(np.float32)

    def v(n, lo, hi):
        return rng.uniform(lo, hi, size=(n,)).astype(np.float32)

    p = dict(w0=w((3, 3, 3), cin, cout), bn0_scale=v(cout, .5, 1.5),
             bn0_shift=v(cout, -.3, .3), alpha0=v(1, .1, .4),
             w1=w((3, 3, 3), cout, cout), bn1_scale=v(cout, .5, 1.5),
             bn1_shift=v(cout, -.3, .3), alpha1=v(1, .1, .4),
             wr=w((1, 1, 1), cin, cout), br=v(cout, -.3, .3))
    # the convs' weights as the kernel reads them (bf16)
    for k in ("w0", "w1", "wr"):
        p[k] = np.asarray(T(p[k]).to(torch.bfloat16).float())
    return p


def _rel(got, ref):
    got = got.detach().float() if isinstance(got, torch.Tensor) else T(got)
    ref = ref.detach().float() if isinstance(ref, torch.Tensor) else T(
        np.array(ref, np.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float((got - ref).abs().max() / ref.abs().max())


def _box(view, start, size):
    """A TMA box of the view (outermost first), zero-filled outside it."""
    out = torch.zeros(size, dtype=view.dtype)
    src, dst = [], []
    for s0, n, dim in zip(start, size, view.shape):
        lo, hi = max(s0, 0), min(s0 + n, dim)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s0, hi - s0))
    out[tuple(dst)] = view[tuple(src)]
    return out


def _desc(flat, starts, lbo, sbo, rows):
    """The rows x 16 operands no-swizzle K-major wgmma descriptors read from
    `flat` (2-byte elements), one per start byte: row r, column k at byte
    start + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2."""
    r = torch.arange(rows)[None, :, None]
    k = torch.arange(16)[None, None, :]
    s = torch.as_tensor(starts)[:, None, None]
    byte = s + (r // 8) * sbo + (r % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    return flat[byte // 2]


class UnitEmu:
    """csrc/conv333.cu's unit kernel at stride 1, block by block: see the
    module docstring. x (N, D, H, W, Cin) float32 or bf16, params as
    ru_block's; p0 conv0 blocks and p1 conv1 blocks; math False keeps only
    the schedule (waits, counters, stored rows); mutate None, "target" (the
    counter target one short), "wait_d_d1" (no wait on plane d - 1) or
    "edge_row" (a u0 halo row above the volume keeps the slot's stale
    contents)."""

    def __init__(self, x, params, p0, p1, math=True, mutate=None, seed=0):
        n, d, h, w, cin = x.shape
        cout = int(params["w0"].shape[-1])
        self.p = rublock.plan((n, d, h, w), cin, cout, grid=p0 + p1, p0=p0)
        assert self.p.fused, self.p.why
        self.x, self.prm, self.math, self.mutate = x, params, math, mutate
        self.dt = x.dtype
        self.shape, self.cin, self.cout, self.nn = (n, d, h, w), cin, cout, \
            self.p.n
        self.p0, self.p1, self.st = p0, p1, rublock.STAGES
        self.rng = np.random.default_rng(seed)
        nan = float("nan")
        self.u0 = torch.full((n, d, h, w, cout), nan)
        self.out = torch.full((n, d, h, w, cout), nan)
        self.written = torch.zeros((n, d, h, w), dtype=torch.bool)
        self.stores = torch.zeros((n, d, h, w), dtype=torch.int32)
        self.cnt = [0] * (n * d)
        self.violations = []        # (n, d') read while incomplete
        self.th = self.p.th
        self.mt = self.th // 8                 # m64 tiles of a warpgroup
        self.resident = self.p.mode == "resident"
        self.hh, self.hw = self.th + 2, TW + 2
        self.half = self.hh * self.hw * 8            # elements
        self.pitch = -(-self.hh * self.hw * 16 // 128) * 128 // 2
        self.xch = -(-(-(-cin // 8) * 8) // KC)
        self.uch = -(-cout // KC)
        self.tiles_w, self.tiles_h = -(-w // TW), -(-h // self.th)
        if math:
            nt = self.nn
            self.xpad = F.pad(x.float(), (0, -(-cin // 8) * 8 - cin))
            pk = {k: conv333.pack_weights_gmma(
                params[k], [cin if k != "w1" else cout], nt).float()
                .reshape(-1) for k in ("w0", "w1", "wr")}
            self.slab = 9 * KC * nt                  # elements
            self.wmain = (self.xch * 3 * self.slab, self.uch * 3 * self.slab)
            self.wres = self.xch * KC * nt
            self.wmax = max(self.wmain[0], self.wmain[1] + self.wres)
            self.packed = ((pk["w0"],), (pk["w1"], pk["wr"]))

    # -- the pieces of a stage ---------------------------------------------

    def _weights(self, role):
        """The producer's bulk copies into a NaN-filled weight region: the
        main weight one stage slab at a time, conv1's residual one chunk
        at a time after it."""
        reg = torch.full((self.wmax,), float("nan"))
        src = self.packed[role][0]
        for off in range(0, self.wmain[role], self.slab):
            reg[off:off + self.slab] = src[off:off + self.slab]
        if role:
            r = self.packed[1][1]
            o = self.wmain[1]
            for off in range(0, self.wres, KC * self.nn):
                reg[o + off:o + off + KC * self.nn] = r[off:off + KC * self.nn]
        return reg

    def _stage(self, slot, src, b, dz, c0, h0, w0):
        """The two TMA boxes of a halo (8-channel halves) into `slot`."""
        for hf in (0, 1):
            bx = _box(src, (b, dz, h0 - 1, w0 - 1, c0 + 8 * hf),
                      (1, 1, self.hh, self.hw, 8))
            o = hf * self.pitch
            old = slot[o:o + self.half].reshape(self.hh, self.hw, 8)
            bx = bx.reshape(self.hh, self.hw, 8)
            if self.mutate == "edge_row" and src is self.u0 and h0 == 0:
                bx[0] = old[0]          # row -1 left as the slot held it
            slot[o:o + self.half] = bx.reshape(-1)

    def _slab(self, slot, role, res, j, q):
        """The stage's weight slab after its halo (the streamed unit): the
        main weight's (chunk j, depth tap q), or conv1's residual chunk j."""
        if res:
            src, o, n = self.packed[1][1], j * KC * self.nn, KC * self.nn
        else:
            src, o, n = self.packed[role][0], (j * 3 + q) * self.slab, \
                self.slab
        slot[2 * self.pitch:2 * self.pitch + n] = src[o:o + n]

    def _mma(self, acc, slot, wflat, wofs, main):
        """The stage's wgmmas: A from the slot's halo, B from `wflat` (the
        resident weights or the slot) at element wofs."""
        nn = self.nn
        taps = range(9) if main else (4,)
        mts = torch.arange(2 * self.mt)
        for i, tap in enumerate(taps):
            kh, kw = divmod(tap, 3)
            bmat = _desc(wflat, [wofs * 2 + i * KC * nn * 2], 128, 256, nn)[0]
            pos = ((mts >> 1) * 8 + kh) * self.hw + (mts & 1) * 8 + kw
            amat = _desc(slot, pos * 16, self.pitch * 2, self.hw * 16, 64)
            acc += amat @ bmat.t()

    def _epi(self, acc, role):
        p, s = self.prm, ("0", "1")[role]
        z = acc * p[f"bn{s}_scale"].float() + p[f"bn{s}_shift"].float()
        al = p[f"alpha{s}"].float().reshape(-1)
        z = torch.where(z >= 0, z, al * z)
        return z + (p["br"].float() if role else 0.0)

    def _store(self, acc, dst, b, dd, h0, w0, g, wi, stg):
        """Consumer warp wi of warpgroup g: rows wi * 16 .. + 15 of each of
        its warpgroup's m64 tiles, rounded to the output's type into its
        staging rows `stg` (16 x N), then out by 16-byte chunks (8
        channels) of the rows inside the volume."""
        n, d, h, w = self.shape
        ch = self.nn // 8
        for mt in range(g * self.mt, g * self.mt + self.mt):
            if self.math:
                stg[:] = acc[mt, wi * 16:wi * 16 + 16].to(self.dt).float()
            for c in range(16 * ch):
                r, q = divmod(c, ch)
                hh = h0 + (mt >> 1) * 8 + (wi * 16 + r) // 8
                ww = w0 + (mt & 1) * 8 + (wi * 16 + r) % 8
                if hh >= h or ww >= w:
                    continue
                if self.math:
                    dst[b, dd, hh, ww, q * 8:q * 8 + 8] = stg[r, q * 8:
                                                              q * 8 + 8]
                if q:
                    continue
                if dst is self.u0:
                    self.written[b, dd, hh, ww] = True
                else:
                    self.stores[b, dd, hh, ww] += 1

    # -- the blocks ----------------------------------------------------------

    def _walk(self, first, step, role):
        n, d, h, w = self.shape
        per = self.tiles_h * self.tiles_w
        tile = first
        while tile < n * d * per:
            hw, rest = tile % per, tile // per
            dd, b = rest % d, rest // d
            h0, w0 = (hw // self.tiles_w) * self.th, (hw % self.tiles_w) * TW
            plo, phi = max(0, 1 - dd), min(2, d - dd)
            nch = self.uch if role else self.xch
            st = [(False, j, q) for j in range(nch)
                  for q in range(plo, phi + 1)]
            if role:
                st += [(True, j, None) for j in range(self.xch)]
            yield tile, b, dd, h0, w0, st
            tile += step

    def block(self, role, first, step):
        """One block's program; it yields None where another block may run
        and a condition where its producer waits."""
        n, d = self.shape[:2]
        target = self.p.target - (self.mutate == "target")
        size = 2 * self.pitch + (0 if self.resident else 9 * KC * self.nn)
        slots = [torch.full((size,), float("nan")) for _ in range(self.st)]
        stg = [torch.full((16, self.nn), float("nan")) for _ in range(8)]
        wreg = self._weights(role) if self.math and self.resident else None
        k = 0
        for tile, b, dd, h0, w0, stages in self._walk(first, step, role):
            acc = torch.zeros(2 * self.mt, 64, self.nn)
            ok = 0
            nmain = sum(not s[0] for s in stages)
            for si, (res, j, q) in enumerate(stages):
                slot = slots[k % self.st]
                k += 1
                if role and not res:
                    dz = dd + q - 1
                    if not (ok >> q) & 1:
                        if not (self.mutate == "wait_d_d1" and q == 0):
                            i = b * d + dz
                            yield (lambda i=i: self.cnt[i] >= target)
                        ok |= 1 << q
                    if not bool(self.written[b, dz].all()):
                        self.violations.append((b, dz))
                if self.math:
                    if res:
                        src, dz = self.xpad, dd
                    else:
                        src, dz = (self.u0 if role else self.xpad), dd + q - 1
                    self._stage(slot, src, b, dz, j * KC, h0, w0)
                    if self.resident:
                        wofs = (self.wmain[1] + j * KC * self.nn if res
                                else (j * 3 + q) * self.slab)
                        self._mma(acc, slot, wreg, wofs, not res)
                    else:
                        self._slab(slot, role, res, j, q)
                        self._mma(acc, slot, slot, 2 * self.pitch, not res)
                    if si == nmain - 1:
                        acc = self._epi(acc, role)
                yield None
            dst = self.out if role else self.u0
            for g, wi in self.rng.permutation(
                    list(itertools.product(range(2), range(4)))):
                self._store(acc, dst, b, dd, h0, w0, g, wi,
                            stg[g * 4 + wi])
                if not role:
                    self.cnt[b * d + dd] += 1
                yield None

    def run(self, policy="round_robin"):
        """Every block to its end under `policy`; raises on a deadlock."""
        blocks = [self.block(0, i, self.p0) for i in range(self.p0)] + [
            self.block(1, i, self.p1) for i in range(self.p1)]
        conds = [None] * len(blocks)
        done = [False] * len(blocks)
        nb, rr = len(blocks), 0
        while not all(done):
            ready = [i for i, c in enumerate(conds)
                     if not done[i] and (c is None or c())]
            if not ready:
                raise RuntimeError("deadlock: every block waits")
            if policy == "round_robin":
                i = next(j for j in ((rr + t) % nb for t in range(nb))
                         if j in ready)
                rr = i + 1
            elif policy == "random":
                i = int(self.rng.choice(ready))
            else:     # conv1 first; conv0 block 0 only when nothing else can
                c1 = [i for i in ready if i >= self.p0]
                i = c1[0] if c1 else max(ready)
            try:
                conds[i] = next(blocks[i])
            except StopIteration:
                done[i] = True
        return self


# ---- the plan ----------------------------------------------------------

def test_plan_at_the_flagship_sites():
    """Every flagship encoder unit takes the unit kernel. At down_2 both
    roles' weights stay resident beside three halo slots and the staging
    rows in an H100 block, conv0 on 60 of 132 blocks; at down_3, down_4 and
    the bottom (conv1's weights alone take 98 % of a block's 227 KB or
    more) each stage stages its slab, conv0 on half the grid."""
    p = rublock.plan(*SITES["down_2"])
    assert p.fused and p.mode == "resident" and p.n == 48 and p.th == 32
    assert p.weights == (2 * 3 * 9 * 16 * 48 * 2,
                         3 * 3 * 9 * 16 * 48 * 2 + 2 * 16 * 48 * 2)
    assert p.weights == (82944, 124416 + 3072)
    assert p.slot == 2 * 9856                  # (32 + 2) x 18 x 16 B, x 2
    assert p.smem[0] < p.smem[1] <= rublock.SMEM_MAX
    assert p.smem[1] == 3 * 19712 + 127488 + 8 * 16 * 48 * 2 + 4 * 384 * 4 \
        + 7 * 8
    assert p.per_plane == 3 * 6 and p.target == 8 * 18
    assert (p.p0, p.grid) == (60, 132)
    for site in ("down_3", "down_4", "bottom"):
        q = rublock.plan(*SITES[site])
        assert q.mode == "streamed" and q.th == 16, site
        assert q.weights[1] > 0.95 * rublock.SMEM_MAX, site
        assert q.slot == 2 * 5248 + 9 * 16 * q.n * 2
        assert max(q.smem) <= rublock.SMEM_MAX and q.p0 == 66
    # down_3's blocks fit twice on an SM
    assert rublock.plan(*SITES["down_3"], grid=264).p0 == 132


@pytest.mark.parametrize("cin,cout,mode", [
    (12, 48, "resident"), (48, 48, "resident"),
    (64, 48, "chain"),         # conv0's weights no longer fit beside the ring
    (96, 48, "chain"), (32, 32, "chain"),      # N = 32: not built
    (16, 64, "streamed"), (96, 96, "streamed"),
    (48, 130, "chain"),        # two N tiles
])
def test_plan_shape_rule(cin, cout, mode):
    """The unit only where one N tile of a built width covers Cout, with
    the weights resident where both roles fit; a p0 given is kept."""
    p = rublock.plan((1, 4, 16, 16), cin, cout, grid=10, p0=3)
    assert p.mode == mode, p.why
    assert p.fused == (mode != "chain")
    assert p.p0 == 3 and p.grid == 10
    if mode == "resident":
        assert max(p.smem) <= rublock.SMEM_MAX < max(
            rublock.plan((1, 4, 16, 16), 96, 48).smem)


def test_resident_weights_are_the_packed_slabs():
    """The producer's bulk copies fill the weight region with the packed
    weights: the slab of (chunk j, depth tap q) at (j * 3 + q) slabs,
    conv1's residual chunk j after the main weight."""
    rng = np.random.default_rng(0)
    p = {k: T(v) for k, v in _params(rng, 32, 48).items()}
    emu = UnitEmu(torch.zeros(1, 2, 8, 16, 32), p, 1, 1)
    w0 = conv333.pack_weights_gmma(p["w0"], [32], 48).float()
    w1 = conv333.pack_weights_gmma(p["w1"], [48], 48).float()
    wr = conv333.pack_weights_gmma(p["wr"], [32], 48).float()
    r0, r1 = emu._weights(0), emu._weights(1)
    for j, q in itertools.product(range(2), range(3)):
        o = (j * 3 + q) * emu.slab
        assert torch.equal(r0[o:o + emu.slab], w0[0, j, q].reshape(-1))
    for j, q in itertools.product(range(3), range(3)):
        o = (j * 3 + q) * emu.slab
        assert torch.equal(r1[o:o + emu.slab], w1[0, j, q].reshape(-1))
    for j in range(2):
        o = emu.wmain[1] + j * 16 * 48
        assert torch.equal(r1[o:o + 16 * 48], wr[0, j, 0].reshape(-1))
    assert torch.isnan(r0[emu.wmain[0]:]).all()
    assert not torch.isnan(r1[:emu.wmain[1] + emu.wres]).any()


# ---- the schedule ------------------------------------------------------

@pytest.mark.parametrize("p0,p1", [(1, 1), (1, 4), (2, 1), (3, 5), (5, 2),
                                   (7, 7)])
@pytest.mark.parametrize("policy", ["round_robin", "random", "conv1_first"])
def test_schedule_waits_for_complete_planes(p0, p1, policy):
    """Any role split and interleaving: the launch ends, every u0 plane a
    conv1 stage copies is complete when its wait returns, every counter
    ends at NWARPS x tiles per plane, every output is stored once."""
    for shape in ((2, 5, 40, 33), (1, 3, 16, 16)):
        x = torch.zeros((*shape, 32))
        emu = UnitEmu(x, {"w0": torch.zeros(3, 3, 3, 32, 48)}, p0, p1,
                      math=False, seed=p0 * 10 + p1).run(policy)
        assert emu.violations == []
        assert emu.cnt == [emu.p.target] * (shape[0] * shape[1])
        assert emu.p.target == 8 * -(-shape[2] // 32) * -(-shape[3] // 16)
        assert bool(emu.written.all()) and bool((emu.stores == 1).all())


@pytest.mark.parametrize("mutate", ["target", "wait_d_d1"])
def test_schedule_mutations_read_incomplete_planes(mutate):
    """A counter target one short, or no wait on plane d - 1: with conv1
    first and conv0's block 0 starved, a conv1 stage copies a plane that is
    not completely stored."""
    x = torch.zeros((1, 4, 32, 16, 32))
    emu = UnitEmu(x, {"w0": torch.zeros(3, 3, 3, 32, 48)}, 3, 2,
                  math=False, mutate=mutate).run("conv1_first")
    assert emu.violations


# ---- the unit, stage by stage --------------------------------------------

@pytest.mark.parametrize("shape,cin,cout,p0,p1,policy", [
    ((1, 3, 16, 16), 32, 48, 1, 1, "round_robin"),   # one tile per plane
    ((1, 4, 40, 20), 32, 48, 2, 3, "random"),        # 2 x 2 tiles, ragged
    ((2, 2, 9, 13), 32, 48, 3, 1, "conv1_first"),    # B > 1, a ragged tile
    ((1, 1, 8, 16), 12, 48, 1, 2, "round_robin"),    # D = 1, Cin padded
    ((1, 3, 20, 20), 48, 64, 2, 2, "random"),        # slabs staged, TH 16
    ((2, 2, 9, 13), 64, 80, 1, 3, "conv1_first"),    # N = 80
    ((1, 2, 16, 16), 80, 96, 2, 1, "round_robin"),   # N = 96
])
def test_unit_emulation_matches_plain(shape, cin, cout, p0, p1, policy):
    rng = np.random.default_rng(1)
    p = {k: T(v) for k, v in _params(rng, cin, cout).items()}
    x = T(rng.normal(size=(*shape, cin)).astype(np.float32))
    emu = UnitEmu(x, p, p0, p1, seed=2).run(policy)
    assert emu.violations == [] and bool((emu.stores == 1).all())
    assert emu.cnt == [emu.p.target] * (shape[0] * shape[1])
    u0 = conv333.conv333_plain(x, p["w0"], p["bn0_scale"], p["bn0_shift"],
                               p["alpha0"])
    assert _rel(emu.u0, u0) <= EMU_TOL
    assert _rel(emu.out, rublock.ru_block_plain(x, **p)) <= EMU_TOL


@pytest.mark.parametrize("shape,cin,cout", [((1, 3, 16, 16), 32, 48),
                                            ((1, 2, 40, 32), 32, 48),
                                            ((2, 2, 16, 16), 48, 48),
                                            ((1, 3, 16, 32), 48, 64)])
def test_unit_emulation_matches_plain_and_pallas(shape, cin, cout):
    rng = np.random.default_rng(3)
    p = _params(rng, cin, cout)
    x = rng.normal(size=(*shape, cin)).astype(np.float32)
    pt = {k: T(v) for k, v in p.items()}
    emu = UnitEmu(T(x), pt, 2, 2).run("random")
    assert _rel(emu.out, rublock.ru_block_plain(T(x), **pt)) <= EMU_TOL
    assert can_ru_block(x.shape, cin, cout)
    ref = jru(jnp.asarray(x), interpret=True,
              **{k: jnp.asarray(v) for k, v in p.items()})
    assert _rel(emu.out, np.asarray(ref)) <= OUT_TOL


def test_unit_emulation_bf16_matches_plain():
    """bf16 activations: u0 and out rounded where the kernel stores them;
    within chip_smoke.py's KERNEL_TOL."""
    rng = np.random.default_rng(4)
    p = {k: T(v) for k, v in _params(rng, 32, 48).items()}
    x = T(rng.normal(size=(1, 3, 24, 20, 32)).astype(np.float32)).to(
        torch.bfloat16)
    emu = UnitEmu(x, p, 2, 2).run("conv1_first")
    ref = rublock.ru_block_plain(x, **p)
    assert ref.dtype == torch.bfloat16
    assert _rel(emu.out.to(torch.bfloat16), ref) <= KERNEL_TOL
    assert torch.equal(emu.out.to(torch.bfloat16).float(), emu.out)


@pytest.mark.parametrize("mutate", ["target", "wait_d_d1", "edge_row"])
def test_unit_emulation_mutations_disagree(mutate):
    """The counter target one short and the wait on d and d + 1 only read a
    u0 plane with rows not yet stored (NaN); a u0 row above the volume left
    as the slot held it is not conv1's zero padding."""
    rng = np.random.default_rng(5)
    p = {k: T(v) for k, v in _params(rng, 32, 48).items()}
    x = T(rng.normal(size=(1, 4, 32, 16, 32)).astype(np.float32))
    ref = rublock.ru_block_plain(x, **p)
    clean = UnitEmu(x, p, 3, 2, seed=6).run("conv1_first")
    assert _rel(clean.out, ref) <= EMU_TOL and clean.violations == []
    emu = UnitEmu(x, p, 3, 2, mutate=mutate, seed=6).run("conv1_first")
    bad = torch.isnan(emu.out).any() or _rel(emu.out, ref) > 100 * EMU_TOL
    assert bad
    if mutate != "edge_row":
        assert emu.violations


# ---- the CPU route -------------------------------------------------------

def test_ru_block_cpu_runs_the_plain_twin_uncounted():
    rng = np.random.default_rng(7)
    p = {k: T(v) for k, v in _params(rng, 32, 48).items()}
    x = T(rng.normal(size=(1, 2, 8, 16, 32)).astype(np.float32))
    counts = (rublock.ru_block.launches, rublock.ru_unit.launches,
              conv333.conv333.launches)
    ref = rublock.ru_block_plain(x, **p)
    assert torch.equal(rublock.ru_block(x, **p), ref)
    assert torch.equal(rublock.ru_unit(x, **p), ref)
    assert torch.equal(ref, rublock.ru_chain(conv333.conv333_plain, x, **p))
    assert counts == (rublock.ru_block.launches, rublock.ru_unit.launches,
                      conv333.conv333.launches)
