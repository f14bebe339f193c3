"""mosaic_probe: the nine Mosaic probes of the attention kernel's
channel-group reduction, as Hopper kernels (csrc/mosaic_probe.cu).

Replaces tools/mosaic_probe.py:47-143. Each case computes what the tool's
pallas_call computes, at the tool's shapes (HT = 48, W = 96, CM = 48, so
WC = 4608; float32; the leading size may be scaled, for timing at sizes
where launch overhead does not set the time):

    reshape3d       (48, 4608) -> (48, 96)    sum over groups of 48 lanes
    3dtile          (48, 96, 48) -> (48, 96)  sum over the last axis
    3droll          (48, 96, 48)              x + roll(x, 1, W) + roll(x, -1, W)
    dotreduce       (48, 4608) @ M            M[k, g] = (k // 48 == g)
    dotbcast        (48, 96) @ M^T -> (48, 4608)
    repeat          (48, 96) -> (48, 4608)    repeat each value 48 times
    reshape128      (48, 4608) -> (48, 36)    sum over groups of 128 lanes
    reshape3d_pow2  (48, 4608) -> (48, 288)   reshape3d with cm = 16
    narrow          (512, 48) x 2             s = row sum of x; s * g + g

The group sums (reshape3d, 3dtile, reshape128, reshape3d_pow2) run in three
schemes ("smem", "shuffle", "mma") and the products in two ("mma",
"ffma"); the first scheme is the default. `probe(case, *inputs)` runs the
kernel for CUDA tensors and `plain(case, *inputs)` for CPU tensors; any
other device raises. CUDA launches are counted in `probe.launches`.

    python -m vs_seg_tpu_torch.ops.mosaic_probe [case ...] [--device cpu]

prints `[OK] name: sum=... ms=...` per case (on the card, the device time
of each scheme; with --device cpu, the host time of the twin). A case that
fails to build, launch or agree with its twin raises.
"""

from __future__ import annotations

import argparse
import ctypes
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vs_seg_tpu_torch.ops import _build

HT, W, CM = 48, 96, 48
WC = W * CM
NARROW_ROWS = 512

CASES = ("reshape3d", "3dtile", "3droll", "dotreduce", "dotbcast", "repeat",
         "reshape128", "reshape3d_pow2", "narrow")
# group width of each group-sum case
GROUP = {"reshape3d": CM, "3dtile": CM, "reshape128": 128,
         "reshape3d_pow2": 16}
# first scheme = default: the fastest on the H100 at 226 MB (PERF.md)
_GSUM = ("smem", "shuffle", "mma")
_GSUM_ID = {"shuffle": 0, "smem": 1, "mma": 2}     # mp_group_sum's numbering
_MM = ("mma", "ffma")
SCHEMES: Dict[str, Tuple[str, ...]] = {
    **{c: _GSUM for c in GROUP}, "dotreduce": _MM, "dotbcast": _MM,
    "3droll": ("smem",), "repeat": ("store",), "narrow": ("warp",)}
# Cases whose kernel does the twin's f32 operations in the twin's order
# (or only copies): the result is bit-equal. The sums of the others are
# taken in another order.
EXACT = ("3droll", "repeat")


def group_matrix(device="cpu") -> torch.Tensor:
    """M (WC, W) f32, M[k, g] = 1 where k // CM == g."""
    m = np.arange(WC)[:, None] // CM == np.arange(W)[None, :]
    return torch.from_numpy(m.astype(np.float32)).to(device)


def _shapes(case: str, rows: Optional[int] = None):
    """The shapes of the case's data inputs; `rows` replaces the leading
    dimension (the tool's: 48, or 512 for narrow)."""
    if case in ("reshape3d", "reshape128", "reshape3d_pow2", "dotreduce"):
        shapes = [(HT, WC)]
    elif case in ("3dtile", "3droll"):
        shapes = [(HT, W, CM)]
    elif case in ("dotbcast", "repeat"):
        shapes = [(HT, W)]
    elif case == "narrow":
        shapes = [(NARROW_ROWS, CM), (NARROW_ROWS, CM)]
    else:
        raise KeyError(case)
    return [s if rows is None else (rows, *s[1:]) for s in shapes]


def inputs(case: str, device="cpu", seed: Optional[int] = None,
           rows: Optional[int] = None):
    """The case's inputs: all ones, as the tool makes them, or (seed given)
    standard normals from numpy; the products take M as their last input.
    `rows` scales the leading dimension (the tool's shapes by default)."""
    if case not in CASES:
        raise KeyError(f"unknown case {case!r}; cases: {CASES}")
    rng = None if seed is None else np.random.default_rng(seed)
    ins = [torch.from_numpy(np.ones(s, np.float32) if rng is None else
                            rng.standard_normal(s).astype(np.float32)
                            ).to(device) for s in _shapes(case, rows)]
    if case == "narrow" and rng is None:
        ins = [ins[0], ins[0]]       # the tool passes x twice
    if case in ("dotreduce", "dotbcast"):
        ins.append(group_matrix(device))
    return tuple(ins)


def plain(case: str, *ins: torch.Tensor) -> torch.Tensor:
    """PyTorch twin of the case (any device)."""
    x = ins[0]
    if case in GROUP:
        cm = GROUP[case]
        return x.reshape(*x.shape[:-1], -1, cm).sum(-1).reshape(
            x.shape[0], -1)
    if case == "3droll":
        return x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
    if case == "dotreduce":
        return x @ ins[1]
    if case == "dotbcast":
        return x @ ins[1].T
    if case == "repeat":
        return torch.repeat_interleave(x, CM, dim=1)
    if case == "narrow":
        g = ins[1]
        return x.sum(1, keepdim=True) * g + g
    raise KeyError(case)


def _lib():
    lib = _build.load("mosaic_probe")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("mp_group_sum", [p, p] + [i] * 5 + [p]),
                       ("mp_matmul", [p] * 3 + [i] * 3 + [ll] * 2
                        + [i] * 2 + [p]),
                       ("mp_repeat", [p, p] + [i] * 4 + [p]),
                       ("mp_roll", [p, p] + [i] * 4 + [p]),
                       ("mp_narrow", [p] * 3 + [i] * 3 + [p])):
        _build.bind(lib, name, args)
    return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def probe(case: str, *ins: torch.Tensor,
          scheme: Optional[str] = None) -> torch.Tensor:
    """The case on its inputs (see `inputs`): the kernel for CUDA tensors in
    `scheme` (default: the case's first), the twin for CPU tensors."""
    if case not in CASES:
        raise KeyError(f"unknown case {case!r}; cases: {CASES}")
    x = ins[0]
    if x.device.type == "cpu":
        return plain(case, *ins)
    if x.device.type != "cuda":
        raise ValueError(f"mosaic_probe: unsupported device {x.device}")
    scheme = scheme or SCHEMES[case][0]
    if scheme not in SCHEMES[case]:
        raise ValueError(f"mosaic_probe {case}: scheme {scheme!r} not in "
                         f"{SCHEMES[case]}")
    want = [tuple(s) for s in _shapes(case, x.shape[0])]
    got = [tuple(t.shape) for t in ins[:len(want)]]
    if got != want or x.shape[0] < 1 or any(
            t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != x.device for t in ins):
        raise ValueError(f"mosaic_probe {case}: needs contiguous float32 "
                         f"inputs of {_shapes(case)} (any leading size) on "
                         f"one device, got {got}")
    lib = _lib()
    dev = x.device
    di = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if case in GROUP:
        cm = GROUP[case]
        rows, cols = x.shape[0], x[0].numel()
        out = torch.empty((rows, cols // cm), device=dev)
        err = lib.mp_group_sum(_ptr(x), _ptr(out), rows, cols, cm,
                               _GSUM_ID[scheme], di, stream)
    elif case in ("dotreduce", "dotbcast"):
        m = ins[1]
        if tuple(m.shape) != (WC, W):
            raise ValueError(f"mosaic_probe {case}: M must be ({WC}, {W})")
        # dotreduce B = M (k, n) at [k * W + n]; dotbcast B = M^T at
        # [k + n * W]
        k, n, sbk, sbn = ((WC, W, W, 1) if case == "dotreduce"
                          else (W, WC, 1, W))
        out = torch.empty((x.shape[0], n), device=dev)
        err = lib.mp_matmul(_ptr(x), _ptr(m), _ptr(out), x.shape[0], k, n,
                            sbk, sbn, _MM.index(scheme), di, stream)
    elif case == "repeat":
        out = torch.empty((x.shape[0], x.shape[1] * CM), device=dev)
        err = lib.mp_repeat(_ptr(x), _ptr(out), x.shape[0], x.shape[1], CM,
                            di, stream)
    elif case == "3droll":
        out = torch.empty_like(x)
        err = lib.mp_roll(_ptr(x), _ptr(out), x.shape[0], x.shape[1],
                          x.shape[2], di, stream)
    else:
        out = torch.empty_like(x)
        err = lib.mp_narrow(_ptr(x), _ptr(ins[1]), _ptr(out), x.shape[0],
                            x.shape[1], di, stream)
    _build.check(lib, err, f"mosaic_probe {case} ({scheme})")
    _build.count(probe)
    return out


probe.launches = 0


def moved_bytes(case: str, ins: Sequence[torch.Tensor],
                out: torch.Tensor) -> int:
    """Bytes the case must move: each input read once, the output written
    once (the narrow case's x and g are one tensor in the tool's run)."""
    seen, n = set(), out.numel() * out.element_size()
    for t in ins:
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            n += t.numel() * t.element_size()
    return n


def _device_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", help=f"default: all of {CASES}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) runs the kernels; cpu the twins")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mosaic_probe: no CUDA device (pass --device cpu "
                           "to run the plain twins)")
    for case in args.cases or CASES:
        ins = inputs(case, dev)
        ref = plain(case, *ins)
        if dev.type == "cpu":
            t = time.perf_counter()
            out = probe(case, *ins)
            ms = {"twin": (time.perf_counter() - t) * 1e3}
        else:
            ms = {}
            for scheme in SCHEMES[case]:
                out = probe(case, *ins, scheme=scheme)
                if not torch.equal(out, ref):
                    raise AssertionError(f"{case} ({scheme}): the all-ones "
                                         "input does not give the twin's "
                                         "result exactly")
                ms[scheme] = _device_ms(
                    lambda s=scheme: probe(case, *ins, scheme=s))
        times = " ".join(f"{k}:{v:.4f}" for k, v in ms.items())
        print(f"[OK]   {case}: sum={float(out.sum())} ms={times}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
