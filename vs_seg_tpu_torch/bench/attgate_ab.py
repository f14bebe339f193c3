"""A/B timing of attgate, conv333, conv333_dw, ds_conv, ru_block2d,
l2_block2d, tail_block, l2_block, ru_block or blend builds at their sites,
on one GPU.

    python -m vs_seg_tpu_torch.bench.attgate_ab OTHER.cu [MORE.cu ...]
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel conv333 OLD.cu
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel conv333_dw OTHER.cu
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel ds_conv OLD.cu \
        [--ds-th 16,8]
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel ru_block2d \
        [OTHER.cu ...] [--rb-tiles 16x2,8x1]
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel l2_block2d \
        [OTHER.cu ...] [--l2-tiles 16x1,8x2]
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel tail_block \
        [OTHER.cu ...] [--tail-tiles 8,16]
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel l2_block \
        [OTHER.cu ...]
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel ru_block \
        [OTHER.cu ...] [--ru-p0 56,0.5] [--ru-roles]
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel blend [OLD.cu ...]

Builds each given source (a file with the C interface of the kernel's
csrc/<kernel>.cu: another design, or an earlier commit's kernel, e.g. from
`git show <rev>:vs_seg_tpu_torch/ops/csrc/attgate.cu > build/attgate_old.cu`)
with the repo's nvcc flags into build/vs_seg_tpu_torch/ab/, beside the
tree's source (for ds_conv and l2_block, csrc/conv333.cu: ds_conv is its
stride-2 instance, l2_block's conv0 its gated instance). A source whose C
interface differs from the tree's brings its own wrapper: a .py file of
the same stem beside it (that commit's ops/conv333.py, ops/conv333_dw.py,
ops/dsconv.py or ops/att.py, e.g. `git show <rev>:vs_seg_tpu_torch/ops/
dsconv.py > build/dsconv_old.py`), loaded in place of the tree's. A module that wrapper imports from the package and that has changed
since rides along as STEM.<module>.py (e.g. the parent's ops/conv333.py as
build/dsconv_old.conv333.py); it stands in for the tree's module while the
wrapper is loaded.

Sites: attgate at chip_smoke.ATT_SITES, through ops/l2block.py:attgate (two
gated inputs and the map) or, at its att_map rows, the att-only mode;
conv333 at chip_smoke.CONV_SITES, timed with CUDA events as phase 11 does
(each output also compared with the first source's, bit for bit);
conv333_dw at the sites of one train step of the
flagship (chip_smoke.dw_train_sites); ds_conv at chip_smoke.DS_SITES (each
build with its own copy of the weight, so no packed-weight cache is
shared). At every site each build is held to the plain twin
(chip_smoke.KERNEL_TOL or DW_TOL), then timed in turns: the given sources,
the tree's, then the same reversed (for one earlier source: parent, new,
new, parent). attgate and conv333_dw are timed with CUDA events around
back-to-back calls; ds_conv by CUDA-graph replay (chip_smoke.graph_ms: the
device's time, without the host's enqueue), with the host's enqueue per
call (chip_smoke.host_ms) beside it, one cuDNN strided conv in the same
turns, and --ds-th the tree's kernel at each tile height listed; ru_block2d
at chip_smoke.RB_SITES by graph replay with the host's enqueue, beside the
two conv333 launches it replaced (ops/rublock.py:ru_chain, the parent's
ru_block2d) and the cuDNN chain of its two convs in the same turns (one
earlier source is not needed: tree, chain, cuDNN, cuDNN, chain, tree), and
--rb-tiles the tree's kernel at each (tile height x ring slots) listed;
l2_block2d likewise at chip_smoke.L2_SITES (the up_0 logit head) beside
the conv333 + attgate + conv333 chain it replaced (ops/l2block.py:
l2_chain) and the cuDNN chain of its two convs, --l2-tiles the tree's
kernel at each tile listed; tail_block likewise at chip_smoke.TAIL_SITES
(up_1, configuration A's, and the up_0 head) beside the attgate + conv333
chain it replaced (ops/l2block.py:gate_conv0) and cuDNN's conv0 + 1x1
residual, --tail-tiles the tree's kernel at each tile height listed (the
kernel holds one slot of each input, so the tile height is its only
choice); l2_block at chip_smoke.L2B_SITES (up_2/3/4) likewise, the given
sources as conv333.cu variants (the gated instance is conv0; conv1 and
the chains run the tree's) beside the conv333 + attgate + conv333 chain it
replaced (ops/l2block.py:l2_chain) and the cuDNN chain of its two convs;
ru_block at chip_smoke.RU_SITES (down_2/3/4, the bottom) likewise, the
given sources as conv333.cu variants (the unit kernel is its instance U,
taken where ops/rublock.py:plan takes the shape) beside the two conv333
launches of the parent chain (ops/rublock.py:ru_chain) and the cuDNN chain
of its two convs; where the unit is taken, --ru-p0 times the tree's kernel
at other role splits (blocks on conv0, or below 1 a share of the grid),
and
--ru-roles each role alone with its weights resident (every block on one
role; conv1 on a complete u0, its counters full) beside conv333's launch
of the same conv (time only: the diagnostics write no whole unit);
blend at phase 2's flagship geometry (the 448x448x80 volume, its 8
windows, bf16 predictions, O = 2): each source's blend_launch called
directly (a source without `blend_wmax` has the parent's interface, whose
starts and mask are device arrays: staged once, outside the graph), out_acc
and w_acc held bit-equal to the plain twin, over two runs and to the first
source there and at every BLEND_CASES row in bf16 and f32, then timed at
the flagship geometry by graph replay with the host's enqueue, in turns.
Prints one
line per site with the mean of the two turns of each build, its bound and
the card, the sums over the sites, and a JSON line of all the times last.
Run from the repo root. --time-only skips the comparison, for diagnostic
variants that leave out part of the work on purpose (their times say what
that part costs).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from vs_seg_tpu_torch.ops import (_build, blend, block2d, conv333,
                                  conv333_dw, dsconv, l2block, rublock, tail2d)

REPS = 10
# ru_block2d's sites: a graph of REPS chain calls at down_0 would hold 48 GB
RB_REPS = 5


def _build_lib(kernel: str, name: str, src: Path) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{kernel}_{name}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


# the tree's wrapper module and the libraries it loads, per kernel
TREE = {"attgate": (l2block, ("attgate",)),
        "conv333": (conv333, ("conv333",)),
        "l2_block": (l2block, ("conv333",)),
        "ru_block": (rublock, ("conv333",)),
        "conv333_dw": (conv333_dw, ("conv333_dw",)),
        "ds_conv": (dsconv, ("conv333", "dsconv")),
        "ru_block2d": (block2d, ("rublock2d",)),
        "l2_block2d": (block2d, ("l2block2d",)),
        "tail_block": (tail2d, ("tail2d",)),
        "blend": (blend, ("blend",))}
TREE_SRC = {"attgate": "attgate.cu", "conv333": "conv333.cu",
            "l2_block": "conv333.cu", "ru_block": "conv333.cu",
            "conv333_dw": "conv333_dw.cu",
            "ds_conv": "conv333.cu", "ru_block2d": "rublock2d.cu",
            "l2_block2d": "l2block2d.cu", "tail_block": "tail2d.cu",
            "blend": "blend.cu"}
# the kernels timed by CUDA-graph replay, beside the chains they replaced
FUSED = ("ru_block2d", "l2_block2d", "tail_block", "l2_block", "ru_block")


def _load_py(name: str, py: Path):
    spec = importlib.util.spec_from_file_location(name, py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wrapper(kernel: str, src: Path):
    """The wrapper for a source: OTHER.py beside it (with its OTHER.<mod>.py
    stand-ins in sys.modules while it loads), else the tree's module."""
    py = src.with_suffix(".py")
    if not py.is_file():
        return TREE[kernel][0]
    saved = {}
    try:
        for dep in sorted(src.parent.glob(f"{src.stem}.*.py")):
            full = "vs_seg_tpu_torch.ops." + dep.name.split(".")[1]
            saved[full] = sys.modules.get(full)
            sys.modules[full] = _load_py(f"ab_{dep.stem}", dep)
        return _load_py(f"ab_{src.stem}", py)
    finally:
        for full, mod in saved.items():
            if mod is None:
                sys.modules.pop(full, None)
            else:
                sys.modules[full] = mod


def _attgate_sites(cs, dev):
    """(site, run(wrapper module) -> outputs, the twin's outputs, tolerance,
    bound) per site; _dw_sites likewise."""
    gen = torch.Generator(dev).manual_seed(cs.SEED + 1)
    for site, kind, shape, ca, cx, kd in cs.ATT_SITES:
        a1 = torch.randn((*shape, ca), generator=gen, device=dev,
                         dtype=torch.bfloat16).relu_()
        xa, xb = (torch.randn((*shape, cx), generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        w2 = ((torch.rand((3, 3, kd, ca, 1), generator=gen, device=dev) * 2
               - 1) / np.sqrt(9 * kd * ca))
        b2 = torch.rand(1, generator=gen, device=dev) * .4 - .2
        vox = a1[..., 0].numel()
        name = f"{site} {tuple(shape)} Ca {ca} Cx {cx} kd {kd}"
        if kind == "att_map":
            yield (name, lambda mod: l2block.att_map(a1, w2, b2),
                   l2block.att_map_plain(a1, w2, b2), cs.KERNEL_TOL,
                   cs.bound(cs.nbytes(a1, w2, b2) + vox * 6))
            continue
        b = cs.bound(cs.nbytes(a1, xa, xb, w2, b2) + xa.numel() * 4
                     + vox * 2)
        yield (name, lambda mod: l2block.attgate(a1, w2, b2, xa, xb),
               l2block.attgate_plain(a1, w2, b2, xa, xb), cs.KERNEL_TOL, b)


def _conv_sites(cs, dev):
    """conv333 at CONV_SITES, drawn as phase 11 draws them."""
    gen = torch.Generator(dev).manual_seed(cs.SEED)
    for site, shape, cins, cout, kd, res, epi in cs.CONV_SITES:
        xs, x, w, args, resid, _ = cs.conv_site_inputs(
            dev, gen, shape, cins, cout, kd, res, epi)
        ref = (conv333.conv333_plain(x, w, *args, residual=resid),)
        b = cs.bound(cs.nbytes(*xs, w, ref[0]), 2 * xs[0][..., 0].numel()
                     * cout * 9 * kd * sum(cins))
        yield (f"{site} {tuple(shape)} {cins}->{cout} kd {kd}",
               lambda mod, x=x, w=w, args=args, resid=resid: (
                   mod.conv333(x, w, *args, residual=resid),),
               ref, cs.KERNEL_TOL, b)


def _l2b_sites(cs, dev):
    """l2_block at L2B_SITES: as _l2_sites, with the parent chain and the
    cuDNN chain of its two convs."""
    gen = torch.Generator().manual_seed(cs.SEED + 7)
    for site, shape, c in cs.L2B_SITES:
        xa, xb, kw = cs.l2_site_args(dev, gen, shape, c, c, kd=3)

        def run(mod, xa=xa, xb=xb, kw=kw):
            return mod.l2_block(xa, xb, **kw)

        chain, cudnn = cs.l2_chains(xa, xb, kw)
        extra = {"parent chain": chain, "cudnn chain": lambda cudnn=cudnn: (
            cudnn(),)}
        ref = l2block.l2_block_plain(xa, xb, **kw)
        yield (f"{site} {shape}x{c}x2", run, ref, cs.KERNEL_TOL,
               cs.l2_bound(xa, xb, kw, *ref), extra)


def _ru_sites(cs, dev, p0s, roles):
    """ru_block at RU_SITES: as _l2b_sites; where the unit is taken, the
    tree's kernel at the role splits `p0s`, and
    with `roles` each role alone ("diag" entries, not held to the twin)
    beside conv333's launch of the same conv."""
    gen = torch.Generator().manual_seed(cs.SEED + 9)
    for site, shape, cin, cout in cs.RU_SITES:
        x = torch.randn((*shape, cin), generator=gen).to(dev, torch.bfloat16)
        kw = cs.ru_site_args(dev, gen, cin, cout)

        def run(mod, x=x, kw=kw, **opt):
            if opt:
                return (mod.ru_unit(x, **opt, **kw),)
            return (mod.ru_block(x, **kw),)

        extra = {"parent chain": lambda x=x, kw=kw: (
                     rublock.ru_chain(conv333.conv333, x, **kw),),
                 "cudnn chain": lambda f=cs.ru_cudnn(x, kw): (f(),)}
        p = rublock.plan(shape, cin, cout)
        if p.fused:
            grid = rublock.unit_grid(dev, cin, cout)
            for p0 in p0s:
                n0 = round(p0 * grid) if p0 < 1 else int(p0)
                extra[f"tree p0 {p0}"] = (
                    lambda n0=n0, run=run: run(rublock, p0=n0))
            if roles:
                extra.update(_ru_roles(x, kw, shape, cin, cout, grid))
        ref = (rublock.ru_block_plain(x, **kw),)
        yield (f"{site} {shape}x{cin}->{cout}", run, ref, cs.KERNEL_TOL,
               cs.ru_bound(x, kw, ref[0]), extra)


def _ru_roles(x, kw, shape, cin, cout, grid):
    """The unit kernel with every block on one role, its weights resident
    (conv1 reads a complete u0 with its counters full), beside conv333's
    launch of the same conv: diagnostics, timed only."""
    u0 = conv333.conv333(x, kw["w0"], kw["bn0_scale"], kw["bn0_shift"],
                         kw["alpha0"])
    out = torch.empty_like(u0)
    scratch = torch.empty_like(u0)
    nd = shape[0] * shape[1]

    def alone(role):
        q = rublock.plan(shape, cin, cout, grid, p0=grid if role == 0 else 0)

        def fn():
            if role == 0:
                cnt = torch.zeros(nd, dtype=torch.int32, device=x.device)
                rublock.launch_unit(x, scratch, out, cnt, q, **kw)
            else:
                cnt = torch.full((nd,), q.target, dtype=torch.int32,
                                 device=x.device)
                rublock.launch_unit(x, u0, out, cnt, q, **kw)
            return (out,)
        return fn

    return {"diag conv0 alone": alone(0), "diag conv1 alone": alone(1),
            "diag conv333 conv0": lambda: (conv333.conv333(
                x, kw["w0"], kw["bn0_scale"], kw["bn0_shift"],
                kw["alpha0"]),),
            "diag conv333 conv1": lambda: (conv333.conv333(
                u0, kw["w1"], kw["bn1_scale"], kw["bn1_shift"], kw["alpha1"],
                residual=(x, kw["wr"], kw["br"])),)}


def _dw_sites(cs, dev):
    gen = torch.Generator(dev).manual_seed(cs.SEED + 2)
    for i, (shape, cin, cout) in enumerate(cs.dw_train_sites(dev)):
        x = torch.randn((*shape, cin), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        dy = torch.randn((*shape, cout), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        dw, db = conv333_dw.conv333_dw_plain(x, dy)
        b = cs.bound(cs.nbytes(x, dy, dw, db),
                     2 * 27 * cin * cout * x[..., 0].numel())
        yield (f"site {i:02d} {shape}x{cin}->{cout}",
               lambda mod: mod.conv333_dw(x, dy), (dw, db), cs.DW_TOL, b)


def _ds_sites(cs, dev, ths):
    """ds_conv at DS_SITES: as _attgate_sites, plus cuDNN's strided conv
    and the tree's kernel at the tile heights `ths` (extra entries)."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    for site, shape, c in cs.DS_SITES:
        x, w, s, h, a = cs.ds_site_args(dev, gen, shape, c)
        ws = {}

        def run(mod, th=None, x=x, w=w, s=s, h=h, a=a, ws=ws):
            wc = ws.setdefault(id(mod), w.clone())
            if th is None:
                return (mod.ds_conv(x, wc, s, h, a),)
            return (mod.ds_conv(x, wc, s, h, a, th=th),)

        wt = w.to(torch.bfloat16).permute(4, 3, 2, 0, 1).contiguous()
        hb = h.to(torch.bfloat16)
        extra = {"cudnn": lambda x=x, wt=wt, hb=hb: F.conv3d(
            x.permute(0, 4, 1, 2, 3), wt, hb, stride=2, padding=1)}
        for th in ths:
            extra[f"tree th{th}"] = lambda th=th, run=run: run(dsconv, th)
        ref = (dsconv.ds_conv_plain(x, w, s, h, a),)
        b = cs.bound(cs.nbytes(x, w, s, h, a, ref[0]),
                     2 * 27 * c * c * ref[0][..., 0].numel())
        yield (f"{site} {shape}x{c}->{c}", run, ref, cs.KERNEL_TOL, b, extra)


def _rb_sites(cs, dev, tiles):
    """ru_block2d at RB_SITES: as _ds_sites, with the conv333 chain, the
    cuDNN chain and the tree's kernel at the (th, stages) `tiles`."""
    gen = torch.Generator().manual_seed(cs.SEED + 4)
    for site, shape, cin, cout in cs.RB_SITES:
        x, kw = cs.rb_site_args(dev, gen, shape, cin, cout)

        def run(mod, tile=(None, None), x=x, kw=kw):
            return (mod.ru_block2d(x, th=tile[0], stages=tile[1], **kw),)

        chain, cudnn = cs.rb_chains(x, kw)
        extra = {"conv333 chain": lambda chain=chain: (chain(),),
                 "cudnn chain": lambda cudnn=cudnn: (cudnn(),)}
        for th, st in tiles:
            extra[f"tree th{th}x{st}"] = (
                lambda tile=(th, st), run=run: run(block2d, tile))
        ref = (block2d.ru_block2d_plain(x, **kw),)
        yield (f"{site} {shape}x{cin}->{cout}", run, ref, cs.KERNEL_TOL,
               cs.rb_bound(x, kw, ref[0]), extra)


def _l2_sites(cs, dev, tiles):
    """l2_block2d at L2_SITES: as _rb_sites, with the parent chain, the
    cuDNN chain and the tree's kernel at the (th, stages) `tiles`."""
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    for site, shape, c, cout in cs.L2_SITES:
        xa, xb, kw = cs.l2_site_args(dev, gen, shape, c, cout)

        def run(mod, tile=(None, None), xa=xa, xb=xb, kw=kw):
            return mod.l2_block2d(xa, xb, th=tile[0], stages=tile[1], **kw)

        chain, cudnn = cs.l2_chains(xa, xb, kw)
        extra = {"parent chain": chain, "cudnn chain": lambda cudnn=cudnn: (
            cudnn(),)}
        for th, st in tiles:
            extra[f"tree th{th}x{st}"] = (
                lambda tile=(th, st), run=run: run(block2d, tile))
        ref = block2d.l2_block2d_plain(xa, xb, **kw)
        b = cs.l2_bound(xa, xb, kw, *ref)
        yield (f"{site} {shape}x{c}x2->{cout}", run, ref, cs.KERNEL_TOL, b,
               extra)


def _tail_sites(cs, dev, ths):
    """tail_block at TAIL_SITES: as _l2_sites, with the attgate + conv333
    chain, cuDNN's conv0 + residual and the tree's kernel at the tile
    heights `ths`."""
    gen = torch.Generator().manual_seed(cs.SEED + 6)
    for site, shape, c, cout in cs.TAIL_SITES:
        a1, xa, xb, kw = cs.tail_site_args(dev, gen, shape, c, cout)

        def run(mod, th=None, a1=a1, xa=xa, xb=xb, kw=kw):
            return mod.tail_block(a1, xa, xb, th=th, **kw)

        chain, cudnn = cs.tail_chains(a1, xa, xb, kw)
        extra = {"parent chain": chain,
                 "cudnn conv0+res": lambda cudnn=cudnn: (cudnn(),)}
        for th in ths:
            lay = tail2d.tail_layout(
                tail2d.plan_tail(tuple(shape), c, c, cout).n, th,
                -(-c // 16), -(-c // 16))
            if lay["smem"] <= tail2d.SMEM_MAX:
                extra[f"tree th{th}"] = (
                    lambda th=th, run=run: run(tail2d, th))
        ref = tail2d.tail_block_plain(a1, xa, xb, **kw)
        b = cs.tail_bound(a1, xa, xb, kw, *ref)
        yield (f"{site} {shape}x{c}x2->{cout}", run, ref, cs.KERNEL_TOL, b,
               extra)


# blend's cases beside the flagship geometry, in bf16 and f32 predictions
# (tests/test_torch_cuda.py holds the tree's kernel to its twin at each):
# (name, volume (D, H, W), roi, starts, mask, O, the instance it takes)
BLEND_CASES = (
    # w-starts not multiples of 4 and RW = 6
    ("unaligned", (12, 20, 30), (4, 8, 6),
     ((0, 0, 1), (4, 8, 5), (2, 4, 3), (8, 12, 24)), (1, 1, 1, 1), 2, "v1"),
    ("unaligned O=3", (12, 20, 30), (4, 8, 6),
     ((0, 0, 1), (4, 8, 5), (2, 4, 3), (8, 12, 24)), (1, 1, 1, 1), 3, "v1"),
    # a masked window (a padded batch slot) on a duplicate start
    ("masked duplicate O=1", (12, 16, 16), (4, 8, 8),
     ((0, 0, 0), (4, 8, 8), (2, 4, 2), (4, 8, 8)), (1, 1, 1, 0), 1, "v1"),
    ("masked duplicate O=2", (12, 16, 16), (4, 8, 8),
     ((0, 0, 0), (4, 8, 8), (2, 4, 4), (4, 8, 8)), (1, 1, 1, 0), 2, "v4"),
    ("masked duplicate O=8", (12, 16, 16), (4, 8, 8),
     ((0, 0, 0), (4, 8, 8), (2, 4, 2), (4, 8, 8)), (1, 1, 1, 0), 8, "v1"),
    # N = 20 overlapping windows: three launches in index order
    ("N=20", (16, 24, 32), (8, 8, 8),
     tuple((d, h, w) for d in (0, 4, 6, 8, 2) for h, w in ((0, 0), (8, 12),
                                                          (4, 20), (16, 24))),
     (1,) * 19 + (0,), 2, "v4"),
    # a box smaller than the volume: the outside is left untouched
    ("small box", (16, 32, 36), (4, 8, 8), ((2, 4, 8), (4, 8, 12)), (1, 1),
     2, "v4"),
)


def blend_case(case, dtype, dev, seed=0):
    """Inputs of one BLEND_CASES row: (out_acc, w_acc, preds, starts, mask,
    importance), the accumulators random and nonzero."""
    _, vol, roi, starts, mask, o, _ = case
    g = torch.Generator().manual_seed(seed)
    starts = np.array(starts, np.int64)
    preds = torch.randn((len(starts), *roi, o), generator=g).to(dev, dtype)
    imp = (torch.rand(roi, generator=g) + 0.1).to(dev)
    out0 = torch.randn((*vol, o), generator=g).to(dev)
    w0 = (torch.rand((*vol, 1), generator=g) + 0.5).to(dev)
    return out0, w0, preds, starts, np.array(mask, np.float32), imp


def _blend_parent_call(lib, out_acc, w_acc, preds, starts, starts_d,
                       mask_d, imp):
    """The parent interface's launch: starts and mask as device arrays
    (`starts` their host copy, for the box), one launch over the union box
    of all the windows."""
    fn = lib.blend_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    n, rd, rh, rw, o = preds.shape
    D, H, W, _ = out_acc.shape
    lo = starts.min(axis=0)
    box = (starts + np.array([rd, rh, rw])).max(axis=0) - lo
    dev = out_acc.device
    err = fn(conv333._ptr(out_acc), conv333._ptr(w_acc), conv333._ptr(preds),
             int(preds.dtype == torch.float32), conv333._ptr(starts_d),
             conv333._ptr(mask_d), conv333._ptr(imp), n, D, H, W, o, rd, rh,
             rw, *(int(v) for v in lo), *(int(v) for v in box), dev.index,
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "blend (parent interface)")


def _blend_ab(cs, libs, card, time_only):
    """blend at phase 2's flagship geometry, each source's blend_launch
    called directly; see the module docstring."""
    from vs_seg_tpu_torch.infer.sliding_window import (
        dense_patch_starts, gaussian_importance_map)
    dev = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(cs.SEED)
    vol = (cs.VOLUME[2], cs.VOLUME[0], cs.VOLUME[1])
    roi = (cs.ROI[2], cs.ROI[0], cs.ROI[1])
    starts = dense_patch_starts(vol, roi, 0.25)
    mask = np.ones(len(starts), np.float32)
    imp = torch.from_numpy(gaussian_importance_map(roi)).to(dev)
    preds = torch.randn((len(starts), *roi, 2), generator=gen).to(
        dev, torch.bfloat16)
    out0 = torch.rand((*vol, 2), generator=gen).to(dev)
    w0 = torch.rand((*vol, 1), generator=gen).to(dev)
    # staged once, outside any graph, for sources of the parent interface
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)

    def call(name, oa, wa):
        lib = libs[name]
        if hasattr(lib, "blend_wmax"):
            blend.launch(lib, oa, wa, preds, starts, mask, imp)
        else:
            _blend_parent_call(lib, oa, wa, preds, starts, starts_d, mask_d,
                               imp)

    site = f"full volume {vol}x2 <- {len(starts)} x {roi}x2 bf16"
    names = list(libs)
    if not time_only:
        check = [(site, (out0, w0, preds, starts, mask, imp))] + [
            (f"{c[0]} {str(dt)[6:]}", blend_case(c, dt, dev))
            for c in BLEND_CASES for dt in (torch.bfloat16, torch.float32)]
        for case, (o0, ww0, pr, st, mk, im) in check:
            ref = blend.blend_scatter_plain(o0.clone(), ww0.clone(), pr, st,
                                            mk, im)
            first = None
            for name in names:
                lib = libs[name]
                got = [(o0.clone(), ww0.clone()) for _ in range(2)]
                for oa, wa in got:
                    if hasattr(lib, "blend_wmax"):
                        blend.launch(lib, oa, wa, pr, st, mk, im)
                    else:
                        _blend_parent_call(
                            lib, oa, wa, pr, st,
                            torch.from_numpy(st.astype(np.int32)).to(dev),
                            torch.from_numpy(mk).to(dev), im)
                torch.cuda.synchronize()
                eq = [torch.equal(g, r) for g, r in zip(got[0], ref)]
                eq += [torch.equal(g, r) for g, r in zip(*got)]
                if first is not None:
                    eq += [torch.equal(g, f)
                           for g, f in zip(got[0], first[1])]
                print(f"  {name} {case}: bit-equal to the plain twin, over "
                      "two runs" + ("" if first is None else
                                    f" and to {first[0]}")
                      + f" (out_acc, w_acc each): {eq}", flush=True)
                if not all(eq):
                    raise AssertionError(f"blend {name} {case}: not "
                                         "bit-equal")
                if first is None:
                    first = (name, got[0])
            del ref, first, got
    b = cs.bound(cs.nbytes(preds, imp) + 2 * cs.nbytes(out0, w0),
                 f32_flop=preds[..., 0].numel() * (2 * 2 + 2))
    times, host = {}, {}
    oa, wa = out0.clone(), w0.clone()
    for name in names + names[::-1]:
        fn = (lambda name=name: call(name, oa, wa))
        times.setdefault(name, []).append(cs.graph_ms(fn, REPS))
        host.setdefault(name, []).append(cs.host_ms(fn, REPS))
    print(f"  blend {site}: " + ", ".join(
        f"{n} {sum(v) / len(v)!r} ms {v}" for n, v in times.items())
        + f"; bound {b[0]!r} ms on {card}", flush=True)
    print(f"  blend {site} host enqueue per call: " + ", ".join(
        f"{n} {sum(v) / len(v)!r} ms" for n, v in host.items()), flush=True)
    print(json.dumps({"card": card, "kernel": "blend", "ms": {site: times},
                      "host_enqueue_ms": {site: host},
                      "bound_ms": {site: b[0]}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", type=Path,
                    help="sources to time beside the tree's (at least one, "
                         "but for ru_block2d, l2_block2d, tail_block, "
                         "l2_block, ru_block and blend)")
    ap.add_argument("--kernel", choices=("attgate", "conv333", "conv333_dw",
                                         "ds_conv", *FUSED, "blend"),
                    default="attgate")
    ap.add_argument("--ds-th", default="",
                    help="ds_conv: also time the tree's kernel at these "
                         "tile heights (comma list of 8, 16)")
    ap.add_argument("--rb-tiles", default="",
                    help="ru_block2d: also time the tree's kernel at these "
                         "tiles (comma list of THxSTAGES, e.g. 16x2,8x1)")
    ap.add_argument("--l2-tiles", default="",
                    help="l2_block2d: also time the tree's kernel at these "
                         "tiles (comma list of THxSTAGES, e.g. 16x1,8x2)")
    ap.add_argument("--tail-tiles", default="",
                    help="tail_block: also time the tree's kernel at these "
                         "tile heights (comma list, e.g. 8,16)")
    ap.add_argument("--ru-p0", default="",
                    help="ru_block: also time the tree's unit kernel with "
                         "these blocks on conv0 (comma list; a value below 1 "
                         "is a share of the grid)")
    ap.add_argument("--ru-roles", action="store_true",
                    help="ru_block: also time each role alone beside "
                         "conv333's launch of the same conv")
    ap.add_argument("--time-only", action="store_true",
                    help="time the builds without holding them to the twin")
    args = ap.parse_args(argv)
    if not args.sources and args.kernel not in (*FUSED, "blend"):
        ap.error(f"--kernel {args.kernel} needs a source to time")
    if not torch.cuda.is_available():
        raise RuntimeError("attgate_ab: no CUDA device")
    sys.path.insert(0, str(_build.BUILD_DIR.parents[1]))
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    kernel = args.kernel
    srcs = {**{p.stem: p for p in args.sources},
            "tree": _build.CSRC / TREE_SRC[kernel]}
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(_build_lib, [kernel] * len(srcs),
                                       srcs, srcs.values())))
    if kernel == "blend":
        return _blend_ab(cs, libs, card, args.time_only)
    mods = {name: _wrapper(kernel, src) for name, src in srcs.items()}
    mods["tree"] = TREE[kernel][0]
    keys = TREE[kernel][1]

    def use(name):
        for k in keys:
            _build._LIBS[k] = libs[name]

    dev = torch.device("cuda:0")
    ths = [int(t) for t in args.ds_th.split(",") if t]
    if kernel == "ds_conv":
        sites = _ds_sites(cs, dev, ths)
        timer = cs.graph_ms
    elif kernel in ("ru_block2d", "l2_block2d"):
        spec = args.rb_tiles if kernel == "ru_block2d" else args.l2_tiles
        tiles = [tuple(int(v) for v in t.split("x"))
                 for t in spec.split(",") if t]
        sites = (_rb_sites if kernel == "ru_block2d" else _l2_sites)(
            cs, dev, tiles)
        timer = cs.graph_ms
    elif kernel == "l2_block":
        sites = _l2b_sites(cs, dev)
        timer = cs.graph_ms
    elif kernel == "ru_block":
        sites = _ru_sites(cs, dev, [float(v) for v in args.ru_p0.split(",")
                                    if v],
                          args.ru_roles)
        timer = cs.graph_ms
    elif kernel == "tail_block":
        sites = _tail_sites(cs, dev, [int(t) for t in
                                      args.tail_tiles.split(",") if t])
        timer = cs.graph_ms
    else:
        sites = ((*row, {}) for row in {
            "attgate": _attgate_sites, "conv333": _conv_sites,
            "conv333_dw": _dw_sites}[kernel](cs, dev))
        timer = cs.cuda_ms
    reps = RB_REPS if kernel in FUSED else REPS
    times, bounds, host = {}, {}, {}
    names = list(libs)
    for site, run, ref, tol, b, extra in sites:
        use("tree")
        first = None
        for name in names if not args.time_only else ():
            use(name)
            outs = run(mods[name])
            for j, (g, r) in enumerate(zip(outs, ref)):
                cs.compare(f"{name} {site} output {j}", g, r, tol)
            if first is None:
                first = (name, outs)
            else:
                print(f"  {name} {site}: bit-equal to {first[0]}: " + str(
                    [torch.equal(g, f) for g, f in zip(outs, first[1])]),
                    flush=True)
            del outs
        first = None
        for name, fn in extra.items() if not args.time_only else ():
            if not name.startswith(("cudnn", "diag")):
                use("tree")
                cs.compare(f"{name} {site}", fn()[0], ref[0], tol)
        del ref
        order = names + list(extra)
        for name in order + order[::-1]:
            fn = extra.get(name)
            if fn is None:
                use(name)
                fn = (lambda name=name: run(mods[name]))
            else:
                use("tree")
            times.setdefault(site, {}).setdefault(name, []).append(
                timer(fn, reps))
            if kernel in ("ds_conv", *FUSED):
                host.setdefault(site, {}).setdefault(name, []).append(
                    cs.host_ms(fn, reps))
        bounds[site] = b[0]
        print(f"  {kernel} {site}: " + ", ".join(
            f"{n} {sum(v) / len(v)!r} ms" for n, v in times[site].items())
            + f"; bound {b[0]!r} ms on {card}", flush=True)
        if host:
            print(f"  {kernel} {site} host enqueue per call: " + ", ".join(
                f"{n} {sum(v) / len(v)!r} ms" for n, v in host[site].items()),
                flush=True)
    use("tree")
    entries = [n for n in next(iter(times.values()))
               if all(n in t for t in times.values())]
    print(f"  {kernel} over {len(times)} sites: " + ", ".join(
        f"{n} {sum(sum(t[n]) / len(t[n]) for t in times.values())!r} ms"
        for n in entries) + f"; bound {sum(bounds.values())!r} ms on {card}",
        flush=True)
    print(json.dumps({"card": card, "kernel": kernel, "ms": times,
                      "host_enqueue_ms": host, "bound_ms": bounds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
