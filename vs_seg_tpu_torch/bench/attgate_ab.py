"""A/B timing of attgate or conv333_dw builds at their sites, on one GPU.

    python -m vs_seg_tpu_torch.bench.attgate_ab OTHER.cu [MORE.cu ...]
    python -m vs_seg_tpu_torch.bench.attgate_ab --kernel conv333_dw OTHER.cu

Builds each given source (a file with the C interface of the kernel's
csrc/<kernel>.cu: another design, or an earlier commit's kernel, e.g. from
`git show <rev>:vs_seg_tpu_torch/ops/csrc/attgate.cu > build/attgate_old.cu`)
with the repo's nvcc flags into build/vs_seg_tpu_torch/ab/, beside the
tree's source. A conv333_dw source whose C interface differs from the
tree's brings its own wrapper: a .py file of the same stem beside it (that
commit's ops/conv333_dw.py, e.g. `git show <rev>:vs_seg_tpu_torch/ops/
conv333_dw.py > build/conv333_dw_old.py`), loaded in place of the tree's.

Sites: attgate at chip_smoke.ATT_SITES, through ops/l2block.py:attgate (two
gated inputs and the map); conv333_dw at the sites of one train step of the
flagship (chip_smoke.dw_train_sites). At every site each build is held to
the plain twin (chip_smoke.KERNEL_TOL or DW_TOL), then timed with CUDA events
in turns: the given sources, the tree's, then the same reversed (for one
earlier source: parent, new, new, parent). Prints one line per site with
the mean of the two turns of each build, its bound and the card, the sums
over the sites, and a JSON line of all the times last. Run from the repo
root. --time-only skips the comparison, for diagnostic variants that leave
out part of the work on purpose (their times say what that part costs).
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

from vs_seg_tpu_torch.ops import _build, conv333_dw, l2block

REPS = 10


def _build_lib(kernel: str, name: str, src: Path) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{kernel}_{name}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    if kernel == "attgate":
        lib.attgate_launch.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int] * 8
                                       + [ctypes.c_void_p])
        lib.attgate_launch.restype = ctypes.c_int
    return lib


def _wrapper(src: Path):
    """conv333_dw's wrapper for a source: OTHER.py beside it, else the
    tree's module."""
    py = src.with_suffix(".py")
    if not py.is_file():
        return conv333_dw
    spec = importlib.util.spec_from_file_location(f"ab_{src.stem}", py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _attgate_sites(cs, dev):
    """(site, run(wrapper module) -> outputs, the twin's outputs, tolerance,
    bound) per site; _dw_sites likewise."""
    gen = torch.Generator(dev).manual_seed(cs.SEED + 1)
    for site, _, shape, ca, cx, kd in cs.ATT_SITES:
        a1 = torch.randn((*shape, ca), generator=gen, device=dev,
                         dtype=torch.bfloat16).relu_()
        xa, xb = (torch.randn((*shape, cx), generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        w2 = ((torch.rand((3, 3, kd, ca, 1), generator=gen, device=dev) * 2
               - 1) / np.sqrt(9 * kd * ca))
        b2 = torch.rand(1, generator=gen, device=dev) * .4 - .2
        b = cs.bound(cs.nbytes(a1, xa, xb, w2, b2) + xa.numel() * 4
                     + a1[..., 0].numel() * 2)
        yield (f"{site} {tuple(shape)} Ca {ca} Cx {cx} kd {kd}",
               lambda mod: l2block.attgate(a1, w2, b2, xa, xb),
               l2block.attgate_plain(a1, w2, b2, xa, xb), cs.KERNEL_TOL, b)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=Path,
                    help="sources to time beside the tree's")
    ap.add_argument("--kernel", choices=("attgate", "conv333_dw"),
                    default="attgate")
    ap.add_argument("--time-only", action="store_true",
                    help="time the builds without holding them to the twin")
    args = ap.parse_args(argv)
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
            "tree": _build.CSRC / f"{kernel}.cu"}
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(_build_lib, [kernel] * len(srcs),
                                       srcs, srcs.values())))
    mods = {name: (_wrapper(src) if kernel == "conv333_dw" else None)
            for name, src in srcs.items()}
    mods["tree"] = conv333_dw if kernel == "conv333_dw" else None
    dev = torch.device("cuda:0")
    sites = (_attgate_sites if kernel == "attgate" else _dw_sites)(cs, dev)
    times, bounds = {}, {}
    names = list(libs)
    for site, run, ref, tol, b in sites:
        for name in names if not args.time_only else ():
            _build._LIBS[kernel] = libs[name]
            for j, (g, r) in enumerate(zip(run(mods[name]), ref)):
                cs.compare(f"{name} {site} output {j}", g, r, tol)
        del ref
        for name in names + names[::-1]:
            _build._LIBS[kernel] = libs[name]
            times.setdefault(site, {}).setdefault(name, []).append(
                cs.cuda_ms(lambda: run(mods[name]), REPS))
        bounds[site] = b[0]
        print(f"  {kernel} {site}: " + ", ".join(
            f"{n} {sum(v) / len(v)!r} ms" for n, v in times[site].items())
            + f"; bound {b[0]!r} ms on {card}", flush=True)
    _build._LIBS[kernel] = libs["tree"]
    print(f"  {kernel} over {len(times)} sites: " + ", ".join(
        f"{n} {sum(sum(t[n]) / len(t[n]) for t in times.values())!r} ms"
        for n in names) + f"; bound {sum(bounds.values())!r} ms on {card}",
        flush=True)
    print(json.dumps({"card": card, "kernel": kernel, "ms": times,
                      "bound_ms": bounds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
