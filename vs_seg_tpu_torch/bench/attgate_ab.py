"""A/B timing of attgate builds at its sites, on one GPU.

    python -m vs_seg_tpu_torch.bench.attgate_ab OTHER.cu [MORE.cu ...]

Builds each given source (a file with csrc/attgate.cu's C interface:
another design, or an earlier commit's kernel, e.g. from `git show
<rev>:vs_seg_tpu_torch/ops/csrc/attgate.cu > build/attgate_old.cu`) with
the repo's nvcc flags into build/vs_seg_tpu_torch/ab/, beside the tree's
csrc/attgate.cu. At every site of chip_smoke.ATT_SITES it holds each build
to the plain twin (chip_smoke.KERNEL_TOL), then times them through
ops/l2block.py:attgate (two gated inputs and the map) with CUDA events, in
turns: in order, then reversed. Prints one line per site with the mean of
the two turns of each build, its bound and the card, and a JSON line of
all the times last. Run from the repo root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from vs_seg_tpu_torch.ops import _build, l2block

REPS = 10


def _build_lib(name: str, src: Path) -> ctypes.CDLL:
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"libattgate_{name}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.attgate_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                   + [ctypes.c_void_p])
    lib.attgate_launch.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=Path,
                    help="attgate sources to time beside the tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("attgate_ab: no CUDA device")
    sys.path.insert(0, str(_build.BUILD_DIR.parents[1]))
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    srcs = {"tree": _build.CSRC / "attgate.cu",
            **{p.stem: p for p in args.sources}}
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(_build_lib, srcs, srcs.values())))
    dev = torch.device("cuda:0")
    gen = torch.Generator(dev).manual_seed(cs.SEED + 1)
    times = {}
    for site, _, shape, ca, cx, kd in cs.ATT_SITES:
        a1 = torch.randn((*shape, ca), generator=gen, device=dev,
                         dtype=torch.bfloat16).relu_()
        xa, xb = (torch.randn((*shape, cx), generator=gen, device=dev,
                              dtype=torch.bfloat16) for _ in range(2))
        w2 = ((torch.rand((3, 3, kd, ca, 1), generator=gen, device=dev) * 2
               - 1) / np.sqrt(9 * kd * ca))
        b2 = torch.rand(1, generator=gen, device=dev) * .4 - .2
        ref = l2block.attgate_plain(a1, w2, b2, xa, xb)
        for name, lib in libs.items():
            _build._LIBS["attgate"] = lib
            for part, g, r in zip(("att", "ga", "gb"),
                                  l2block.attgate(a1, w2, b2, xa, xb), ref):
                cs.compare(f"{name} {site} {part}", g, r, cs.KERNEL_TOL)
        del ref
        names = list(libs)
        for name in names + names[::-1]:
            _build._LIBS["attgate"] = libs[name]
            times.setdefault(site, {}).setdefault(name, []).append(
                cs.cuda_ms(lambda: l2block.attgate(a1, w2, b2, xa, xb), REPS))
        b = cs.bound(cs.nbytes(a1, xa, xb, w2, b2) + xa.numel() * 4
                     + a1[..., 0].numel() * 2)
        print(f"  {site} {tuple(shape)} Ca {ca} Cx {cx} kd {kd}: " + ", ".join(
            f"{n} {sum(v) / len(v)!r} ms" for n, v in times[site].items())
            + f"; bound {b[0]!r} ms on {card}", flush=True)
        del a1, xa, xb
    _build._LIBS["attgate"] = libs["tree"]
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
