"""The port's (3,3,3) decoder block, ops/l2block.py:l2_block, held on the CPU
against its twins and the JAX package's Pallas kernel, and the gated
instance of csrc/conv333.cu (conv333(..., gate=att32), the block's conv0)
by an emulation that follows it stage by stage.

On a CUDA tensor l2_block is three launches: conv333 (conv1), attgate's
att-only mode (att_map: the unrounded f32 map and the compact bf16 one) and
conv333's gated instance, which gates every staged halo of xa and xb in
shared memory, so the gated pair never reaches device memory. The kernels
run only on the card (tests/test_torch_cuda.py and chip_smoke.py hold them
against these twins there). Here:

- the twins: conv333_plain(gate=) equals conv333_plain on an explicitly
  gated pair exactly; att_map_plain's map is fused_attention_gate_plain's;
  the block composed of the gated twins (l2_gated) equals l2_block_plain
  (the parent chain's composition) exactly;
- `emulate_conv333` walks csrc/conv333.cu's stage stream at stride 1 as the
  kernel does, tile by tile (TH x 16 outputs of one (n, d) plane, TH = 24
  in the gated instance, 32 or 16 ungated), each stage (input, 16-channel
  chunk, kd plane) staged as the two zero-filled TMA boxes of its halo's
  8-channel halves laid out as the ring slot, gated (gated instance) in
  place from the att box of that stage's depth plane (rows h0 - 1 ..
  h0 + TH, columns w0 - 1 .. w0 + 16, zero outside the volume) as att * x
  + x rounded to x.dtype, each tap's A operand read through the wgmma
  descriptor arithmetic (start, LBO, SBO) and B from the packed slab, the
  fused 1x1 residual on the centre plane's stages (N <= 48, the residual's
  input the conv's own) or as separate centre-plane stages (N > 48, gated
  with att at the output's plane), the epilogue and the masked store. In
  float32 on bf16-rounded weights (the kernel's) it must equal the twins
  to EMU_TOL of the largest output; conv1 (ungated), att_map_plain and the
  gated conv0 together must equal l2_block_plain to 1e-4 (out) and 1e-5
  (att) of the largest value, and the JAX Pallas l2_block in interpret mode
  (tests/test_torch_kernels.py's tolerances), at shapes its gate takes.
- two mutations of the emulation must disagree with the twin: the att box
  one row or one depth plane off, and the residual left ungated.

Inputs come from numpy with a fixed seed; shapes are small (D <= 4, H, W
<= 16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_dsconv import _box, _desc
from vs_seg_tpu.ops.pallas_l2block import can_l2_block, l2_block as jl2
from vs_seg_tpu_torch.ops import att, conv333, l2block

EMU_TOL = 1e-5            # float32 emulation vs twin, relative to max|ref|
OUT_TOL = 1e-4            # the block (tests/test_torch_kernels.py)
ATT_TOL = 1e-5
TW = 16                   # csrc/conv333.cu's output tile width
T = torch.from_numpy


def _params(rng, c):
    def w(k, ci, co):
        b = 1.0 / np.sqrt(ci * int(np.prod(k)))
        return rng.uniform(-b, b, size=(*k, ci, co)).astype(np.float32)

    def v(n, lo, hi):
        return rng.uniform(lo, hi, size=(n,)).astype(np.float32)

    p = dict(w1=w((3, 3, 3), 2 * c, c), b1=v(c, -.3, .3),
             w2=w((3, 3, 3), c, 1), b2=v(1, -.3, .3),
             w0=w((3, 3, 3), 2 * c, c), bn_scale=v(c, .5, 1.5),
             bn_shift=v(c, -.3, .3), alpha=v(1, .1, .4),
             wr=w((1, 1, 1), 2 * c, c), br=v(c, -.3, .3))
    # the convs' weights as the kernel reads them (bf16)
    for k in ("w1", "w0", "wr"):
        p[k] = np.asarray(T(p[k]).to(torch.bfloat16).float())
    return p


def _pair(rng, shape, c):
    return tuple(rng.normal(size=(*shape, c)).astype(np.float32)
                 for _ in range(2))


def _rel(got, ref):
    got = got.detach().float() if isinstance(got, torch.Tensor) else T(got)
    ref = ref.detach().float() if isinstance(ref, torch.Tensor) else T(
        np.array(ref, np.float32))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float((got - ref).abs().max() / ref.abs().max())


def emulate_conv333(xs, w, scale=None, shift=None, alpha=None,
                    residual=None, gate=None, mutate=None):
    """csrc/conv333.cu at stride 1, stage by stage, in float32 (the output
    unrounded, the gated rows rounded to x.dtype): see the module
    docstring. mutate: None, "att_row" or "att_plane" (the att box one row
    or one depth plane off) or "res_ungated" (the residual reads the
    ungated x). Also returns how often each output value was stored."""
    xs = tuple(xs)
    n, d, h, wd = xs[0].shape[:4]
    dt = xs[0].dtype
    cins = [int(x.shape[-1]) for x in xs]
    kd, cout = int(w.shape[2]), int(w.shape[4])
    n_t, cop = conv333._ntile(cout)
    gated = gate is not None
    mt_n = 2 * (3 if gated else 2 if n_t > 48 else 4)  # m64 tiles, a block
    th = 8 * mt_n // 2
    hw_, hh = TW + 2, th + 2
    half = hh * hw_ * 16
    pitch = -(-half // 128) * 128
    # the inputs as their TMA maps see them: channels padded to 8
    pad8 = [F.pad(x.float(), (0, -(-c // 8) * 8 - c)) for x, c in
            zip(xs, cins)]
    nch = [-(-c // 16) for c in cins]
    wm = conv333.pack_weights_gmma(w, cins, n_t).float()
    rs, wrp, rb, rpad, rch = (), None, None, (), []
    fused = False
    if residual is not None:
        rs, wr, rb = residual
        rs = conv333.as_pair(rs)
        crs = [int(r.shape[-1]) for r in rs]
        rpad = [F.pad(r.float(), (0, -(-c // 8) * 8 - c)) for r, c in
                zip(rs, crs)]
        rch = [-(-c // 16) for c in crs]
        wrp = conv333.pack_weights_gmma(wr, crs, n_t).float()
        fused = n_t <= 48 and len(rs) == len(xs) and all(
            r is x for r, x in zip(rs, xs))
    tap_bytes = 16 * n_t * 2
    tiles_h, tiles_w = -(-h // th), -(-wd // TW)
    out = torch.zeros((n, d, h, wd, cop))
    stores = torch.zeros((n, d, h, wd, cop), dtype=torch.int32)
    cols = torch.arange(n_t)

    def stage(x, b, dz, c0, h0, w0):
        slot = torch.full((pitch,), float("nan"))       # 2 half planes
        for hf in (0, 1):
            bx = _box(x, (b, dz, h0 - 1, w0 - 1, c0 + 8 * hf),
                      (1, 1, hh, hw_, 8))
            o = hf * pitch // 2
            slot[o:o + half // 2] = bx.reshape(-1)
        return slot

    def gate_slot(slot, b, dz, h0, w0):
        dzm, h0m = dz, h0
        if mutate == "att_plane":
            dzm += 1
        if mutate == "att_row":
            h0m += 1
        a = _box(gate.float(), (b, dzm, h0m - 1, w0 - 1),
                 (1, 1, hh, hw_)).reshape(hh, hw_, 1)
        g = slot.clone()
        for hf in (0, 1):
            sl = slice(hf * pitch // 2, hf * pitch // 2 + half // 2)
            v = slot[sl].reshape(hh, hw_, 8)
            g[sl] = (a * v + v).to(dt).float().reshape(-1)
        return g

    def mma(acc, slot, slab, taps):
        for tap in taps:
            kh, kw = divmod(tap, 3)
            bmat = _desc(slab, (tap if len(taps) > 1 else 0) * tap_bytes,
                         128, 256, n_t)                 # (N, 16)
            for mt in range(mt_n):
                pos = ((mt >> 1) * 8 + kh) * hw_ + (mt & 1) * 8 + kw
                amat = _desc(slot, pos * 16, pitch, hw_ * 16, 64)
                acc[mt] += amat @ bmat.t()

    def epi(v, co):
        s = scale.float()[co] if scale is not None else 1.0
        z = v * s + (shift.float()[co] if shift is not None else 0.0)
        if alpha is not None:
            al = alpha.float().reshape(-1)
            al = al[co] if al.numel() > 1 else al
            z = torch.where(z >= 0, z, al * z)
        return z

    c = kd // 2
    for tile in range(n * d * (cop // n_t) * tiles_h * tiles_w):
        hw = tile % (tiles_h * tiles_w)
        rest = tile // (tiles_h * tiles_w)
        nt, rest = rest % (cop // n_t), rest // (cop // n_t)
        dd, b = rest % d, rest // d
        h0, w0 = (hw // tiles_w) * th, (hw % tiles_w) * TW
        plo, phi = max(0, c - dd), min(kd - 1, d - 1 - dd + c)
        acc = torch.zeros(mt_n, 64, n_t)
        racc = torch.zeros(mt_n, 64, n_t)
        for j in range(sum(nch)):
            xi = 0 if j < nch[0] else 1
            c0 = (j - (nch[0] if xi else 0)) * 16
            for p in range(plo, phi + 1):
                dz = dd + p - c
                slot = stage(pad8[xi], b, dz, c0, h0, w0)
                ungated = slot
                if gated:
                    slot = gate_slot(slot, b, dz, h0, w0)
                mma(acc, slot, wm[nt, j, p].reshape(-1), range(9))
                if fused and p == c:
                    mma(racc, ungated if mutate == "res_ungated" else slot,
                        wrp[nt, j, 0, 0].reshape(-1), (4,))
        co = torch.clamp(nt * n_t + cols, max=cout - 1)
        acc = epi(acc, co)
        if residual is not None:
            acc = acc + racc + rb.float()[co]
            if not fused:
                for j in range(sum(rch)):
                    ri = 0 if j < rch[0] else 1
                    c0 = (j - (rch[0] if ri else 0)) * 16
                    slot = stage(rpad[ri], b, dd, c0, h0, w0)
                    if gated and mutate != "res_ungated":
                        slot = gate_slot(slot, b, dd, h0, w0)
                    mma(acc, slot, wrp[nt, j, 0, 0].reshape(-1), (4,))
        for mt in range(mt_n):
            for r in range(64):
                hh_ = h0 + (mt >> 1) * 8 + r // 8
                ww = w0 + (mt & 1) * 8 + r % 8
                if hh_ < h and ww < wd:
                    sl = slice(nt * n_t, (nt + 1) * n_t)
                    out[b, dd, hh_, ww, sl] = acc[mt, r]
                    stores[b, dd, hh_, ww, sl] += 1
    return out[..., :cout], stores[..., :cout]


def emulate_l2_block(xa, xb, p, mutate=None):
    """The block as l2_block launches it on the card: conv1 (ungated
    conv333), att_map (its twin), conv0 (the gated instance), emulated in
    float32."""
    relu = torch.zeros(1)
    a1, s1 = emulate_conv333((xa, xb), p["w1"], None, p["b1"], relu)
    a1 = a1.to(xa.dtype)
    att32, att_c = l2block.att_map_plain(a1, p["w2"], p["b2"])
    out, s0 = emulate_conv333((xa, xb), p["w0"], p["bn_scale"], p["bn_shift"],
                              p["alpha"], residual=((xa, xb), p["wr"],
                                                    p["br"]),
                              gate=att32, mutate=mutate)
    assert bool((s1 == 1).all()) and bool((s0 == 1).all())
    return out, att_c


# ---- the twins ---------------------------------------------------------

@pytest.mark.parametrize("c", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_conv333_plain_is_conv333_plain_on_a_gated_pair(c, dtype):
    rng = np.random.default_rng(0)
    p = _params(rng, c)
    xa, xb = (T(v).to(dtype) for v in _pair(rng, (2, 3, 9, 13), c))
    gate = torch.rand((2, 3, 9, 13), generator=torch.Generator()
                      .manual_seed(1))
    ga, gb = ((gate[..., None] * v.float() + v.float()).to(dtype)
              for v in (xa, xb))
    epi = (T(p["bn_scale"]), T(p["bn_shift"]), T(p["alpha"]))
    got = conv333.conv333_plain((xa, xb), T(p["w0"]), *epi,
                                residual=((xa, xb), T(p["wr"]), T(p["br"])),
                                gate=gate)
    ref = conv333.conv333_plain((ga, gb), T(p["w0"]), *epi,
                                residual=((ga, gb), T(p["wr"]), T(p["br"])))
    assert got.dtype == dtype and torch.equal(got, ref)
    # the CPU route of the wrapper is the twin, and launches nothing
    n0 = conv333.conv333.gated_launches, conv333.conv333.launches
    assert torch.equal(conv333.conv333(
        (xa, xb), T(p["w0"]), *epi, residual=((xa, xb), T(p["wr"]),
                                              T(p["br"])), gate=gate), got)
    assert (conv333.conv333.gated_launches, conv333.conv333.launches) == n0


@pytest.mark.parametrize("c,kd", [(16, 3), (48, 3), (24, 1)])
def test_att_map_plain_is_fused_attention_gate_plain(c, kd):
    rng = np.random.default_rng(1)
    a1 = T(np.maximum(rng.normal(size=(2, 4, 7, 11, c)), 0).astype(
        np.float32))
    x = T(rng.normal(size=(2, 4, 7, 11, 8)).astype(np.float32))
    w2 = T(rng.uniform(-.2, .2, size=(3, 3, kd, c, 1)).astype(np.float32))
    b2 = T(np.array([.1], np.float32))
    ref, (gx,) = att.fused_attention_gate_plain(a1, (x,), w2, b2)
    n0 = l2block.att_map.launches
    att32, att_c = l2block.att_map(a1, w2, b2)
    assert l2block.att_map.launches == n0
    assert att32.dtype == torch.float32 and att32.shape == a1.shape[:4]
    assert torch.equal(att_c, ref) and torch.equal(att32[..., None], ref)
    assert torch.equal(conv333.gate_plain(x, att32), gx)
    att32_b, att_b = l2block.att_map_plain(a1.to(torch.bfloat16), w2, b2)
    assert att32_b.dtype == torch.float32 and att_b.dtype == torch.bfloat16


@pytest.mark.parametrize("c", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_gated_twins_are_l2_block_plain(c, dtype):
    """The block composed as l2_block runs it on the card (conv1, att_map,
    the gated conv0), on the twins, is the parent chain's composition bit
    for bit: the gate is the same f32 expression on the same f32 att."""
    rng = np.random.default_rng(2)
    p = {k: T(v) for k, v in _params(rng, c).items()}
    xa, xb = (T(v).to(dtype) for v in _pair(rng, (1, 4, 10, 12), c))
    got = l2block.l2_gated(conv333.conv333_plain, l2block.att_map_plain, xa,
                           xb, **p)
    for g, r in zip(got, l2block.l2_block_plain(xa, xb, **p)):
        assert g.dtype == dtype and torch.equal(g, r)


# ---- the gated instance, stage by stage --------------------------------

@pytest.mark.parametrize("shape,c", [
    ((1, 3, 16, 16), 16),      # one tile of the gated instance (TH = 24)
    ((2, 2, 13, 11), 48),      # ragged H and W, B > 1, the fused residual
    ((1, 2, 30, 16), 16),      # two tile rows (TH = 24), the second ragged
    ((1, 4, 9, 16), 64),       # N = 64: separate, gated residual stages
    ((1, 1, 16, 16), 12),      # D = 1, channels padded to 16
])
def test_gated_emulation_matches_plain(shape, c):
    rng = np.random.default_rng(3)
    p = {k: T(v) for k, v in _params(rng, c).items()}
    xa, xb = (T(v) for v in _pair(rng, shape, c))
    gate = T(rng.uniform(0, 1, size=shape).astype(np.float32))
    epi = (p["bn_scale"], p["bn_shift"], p["alpha"])
    res = ((xa, xb), p["wr"], p["br"])
    got, stores = emulate_conv333((xa, xb), p["w0"], *epi, residual=res,
                                  gate=gate)
    assert bool((stores == 1).all())
    ref = conv333.conv333_plain((xa, xb), p["w0"], *epi, residual=res,
                                gate=gate)
    assert _rel(got, ref) <= EMU_TOL


@pytest.mark.parametrize("shape,c", [((1, 3, 16, 16), 16),
                                     ((1, 2, 16, 16), 48),
                                     ((2, 1, 8, 16), 48)])
def test_l2_emulation_matches_plain_and_pallas(shape, c):
    rng = np.random.default_rng(4)
    p = _params(rng, c)
    xa, xb = _pair(rng, shape, c)
    pt = {k: T(v) for k, v in p.items()}
    out, att_c = emulate_l2_block(T(xa), T(xb), pt)
    ref_out, ref_att = l2block.l2_block_plain(T(xa), T(xb), **pt)
    assert _rel(out, ref_out) <= OUT_TOL
    assert _rel(att_c, ref_att) <= ATT_TOL
    assert can_l2_block(xa.shape, c)
    ref = jl2(jnp.asarray(xa), jnp.asarray(xb), interpret=True,
              **{k: jnp.asarray(v) for k, v in p.items()})
    assert _rel(out, np.asarray(ref)) <= OUT_TOL


def test_l2_emulation_bf16_matches_plain():
    """bf16 activations: conv1's a1, the gated rows and the output rounded
    where the kernels round them; within chip_smoke.py's KERNEL_TOL."""
    rng = np.random.default_rng(5)
    p = {k: T(v) for k, v in _params(rng, 16).items()}
    xa, xb = (T(v).to(torch.bfloat16) for v in _pair(rng, (1, 2, 12, 16),
                                                     16))
    out, att_c = emulate_l2_block(xa, xb, p)
    ref_out, ref_att = l2block.l2_block_plain(xa, xb, **p)
    assert _rel(out.to(torch.bfloat16), ref_out) <= 2e-2
    assert _rel(att_c, ref_att) <= 2e-2


@pytest.mark.parametrize("shape,c,mutate", [
    ((1, 3, 16, 16), 16, "att_row"),
    ((1, 3, 16, 16), 16, "att_plane"),
    ((1, 3, 16, 16), 16, "res_ungated"),     # the fused residual
    ((1, 2, 9, 16), 64, "res_ungated"),      # separate residual stages
])
def test_gated_emulation_mutations_disagree(shape, c, mutate):
    rng = np.random.default_rng(6)
    p = {k: T(v) for k, v in _params(rng, c).items()}
    xa, xb = (T(v) for v in _pair(rng, shape, c))
    gate = T(rng.uniform(0, 1, size=shape).astype(np.float32))
    epi = (p["bn_scale"], p["bn_shift"], p["alpha"])
    res = ((xa, xb), p["wr"], p["br"])
    ref = conv333.conv333_plain((xa, xb), p["w0"], *epi, residual=res,
                                gate=gate)
    got, _ = emulate_conv333((xa, xb), p["w0"], *epi, residual=res,
                             gate=gate, mutate=mutate)
    assert _rel(got, ref) > 100 * EMU_TOL


def test_l2_block_cpu_runs_the_plain_twin_uncounted():
    rng = np.random.default_rng(7)
    p = {k: T(v) for k, v in _params(rng, 16).items()}
    xa, xb = (T(v) for v in _pair(rng, (1, 2, 8, 8), 16))
    counts = (l2block.l2_block.launches, l2block.att_map.launches,
              l2block.attgate.launches, conv333.conv333.launches,
              conv333.conv333.gated_launches)
    got = l2block.l2_block(xa, xb, **p)
    for g, r in zip(got, l2block.l2_block_plain(xa, xb, **p)):
        assert torch.equal(g, r)
    assert counts == (l2block.l2_block.launches, l2block.att_map.launches,
                      l2block.attgate.launches, conv333.conv333.launches,
                      conv333.conv333.gated_launches)
