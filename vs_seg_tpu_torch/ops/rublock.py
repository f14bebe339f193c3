"""One eval encoder ResidualUnit (2 subunits, (3,3,3), Cin != Cout) in one
cooperative launch of conv333.cu's unit instance.

Replaces vs_seg_tpu/ops/pallas_rublock.py:ru_block (_rublock_kernel):

    u0  = prelu(conv0(x) * bn0_scale + bn0_shift; alpha0)      Cin  -> Cout
    out = prelu(conv1(u0) * bn1_scale + bn1_shift; alpha1)     Cout -> Cout
          + (conv1x1(x, wr) + br)

bn*_scale/bn*_shift are the folded eval BatchNorm affines that already
include each conv's bias (nn/blocks.py:folded_conv_affine). The TPU kernel
keeps u0 in VMEM depth-plane rings; a ring of u0 planes with its halo does
not fit an H100 block's shared memory at these widths (113-169 KB at
down_2 beside the x and weight slots), so u0 passes through device memory
in bf16, and the 1x1 residual runs after conv1's activation.

`ru_unit` (csrc/conv333.cu, U) is the unit in one cooperative launch
whose blocks take roles: `plan(...).p0` blocks run conv0's tiles, the
others conv1's, at the same time on disjoint SMs, and u0 goes from role to
role plane by plane through L2: conv0's warps count their stored rows on a
per-(n, d) counter, conv1's producer waits on the counters of the planes
it reads. Each block stores its outputs through shared memory in whole
rows. `plan` is the shape rule: where one N tile covers Cout, at N = 48
(the flagship's down_2, 32 -> 48) both roles keep their packed weights
resident in shared memory ("resident": a conv333 block re-reads its
weight slab from L2 with every stage); at N = 64, 80 and 96 (down_3,
down_4, the bottom, whose conv1 weights alone take 221-498 KB) each stage
stages its slab with its halo, as conv333 does ("streamed"); the unit beat
the parent chain at all four sites on an H100 (PERF.md). Any other shape
takes `ru_chain`, the two conv333 launches of the parent design. Both give
the same bits: same stage order, wgmma sequence and epilogue.

`ru_block` runs the kernels for CUDA tensors and `ru_block_plain` for CPU
tensors, and counts its CUDA calls in `ru_block.launches` (units, either
route); `ru_unit` counts the unit kernel's launches in `ru_unit.launches`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from vs_seg_tpu_torch.ops import _build
from vs_seg_tpu_torch.ops.conv333 import (KC, _check_act, _epi, _lib, _ntile,
                                          _ptr, _tma_ready, conv333,
                                          conv333_plain, packed_weights)

# csrc/conv333.cu's unit instances: the N widths it keeps the weights of
# resident (tile 32 x 16, MT = 4) and those whose stages stage their weight
# slab with the halo (conv333's tile: 16 x 16 above N = 48), its ring slots
# (4 were no faster at down_2), the consumer warps that each announce a
# tile (and stage 16 output rows each), the epilogue table's column stride;
# an H100 block's shared memory
UNIT_N = (48,)
STREAM_N = (64, 80, 96)
TW = 16
STAGES = 3
NWARPS = 8
GEPI = 384
SMEM_MAX = 232448
# blocks on conv0, as a share of the grid, resident weights: the split at
# which the two roles took the same time at down_2 on an H100 (conv0 alone
# 0.885 ms, conv1 alone 1.065 ms; 60 of 132 blocks beat 56 and 64 in the
# same call). The MACs' share (41472 : 63744, 52 blocks) leaves conv1 the
# longer role: its residual stages and third input chunk stage more halos
# per MAC. With the slabs staged, half the grid: conv1 waits on conv0's
# planes, and conv0 running ahead on half the blocks beat conv0's share of
# the stages (0.375-0.395) at down_3, down_4 and the bottom on an H100
# (0.458 / 0.159 / 0.054 ms against 0.474 / 0.167 / 0.072 in one call).
P0_SHARE = 60 / 132
P0_SHARE_STREAMED = 0.5


def ru_chain(conv, x: torch.Tensor, *, w0, bn0_scale, bn0_shift, alpha0, w1,
             bn1_scale, bn1_shift, alpha1, wr, br) -> torch.Tensor:
    """The unit through `conv` (conv333 or conv333_plain), for (3,3,kd)
    weights of either kd: u0 = conv0(x); out = conv1(u0) + residual."""
    u0 = conv(x, w0, bn0_scale, bn0_shift, alpha0)
    return conv(u0, w1, bn1_scale, bn1_shift, alpha1, residual=(x, wr, br))


def ru_block_plain(x: torch.Tensor, **params) -> torch.Tensor:
    """PyTorch twin of ru_block (any device, any float dtype)."""
    return ru_chain(conv333_plain, x, **params)


@dataclass(frozen=True)
class Plan:
    """The unit kernel's layout at one shape, as csrc/conv333.cu builds it.

    mode: the shape rule's choice, "resident" (the unit kernel, each role's
    weights in shared memory), "streamed" (the unit kernel, each stage's
    slab staged with its halo) or "chain" (two conv333 launches); fused:
    mode is not "chain"; n: the N width; th: the tile height; weights:
    bytes of each role's packed weights (conv0's main; conv1's main +
    residual); slot: bytes of one ring slot; smem: bytes of shared memory
    each role needs (every block of the launch gets the larger);
    per_plane: tiles of one (n, d) plane; target: counter arrivals that
    complete a u0 plane; p0: blocks on conv0 of a grid of `grid`; why: the
    reason."""
    mode: str
    n: int
    th: int
    weights: Tuple[int, int]
    slot: int
    smem: Tuple[int, int]
    per_plane: int
    target: int
    p0: int
    grid: int
    why: str

    @property
    def fused(self) -> bool:
        return self.mode != "chain"


def _chunks(c: int) -> int:
    return -(-(-(-c // 8) * 8) // KC)      # 16-channel chunks of C padded to 8


def plan(shape, cin: int, cout: int, grid: int = 132,
         p0: Optional[int] = None) -> Plan:
    """The unit's plan for x (N, D, H, W, cin) -> cout with a grid of
    `grid` blocks (unit_grid: 132 on an H100 at one block per SM). The
    rule: one N tile must cover Cout; at a width of UNIT_N the weights stay
    resident if both roles fit an H100 block beside the ring and the
    staging rows; at a width of STREAM_N the stages stage their slabs; any
    other shape takes the chain. p0 defaults to P0_SHARE (resident) or
    P0_SHARE_STREAMED of the grid, rounded, within 1 .. grid - 1."""
    h, w = (int(v) for v in shape[2:4])
    n_t, cop = _ntile(cout)
    resident = n_t in UNIT_N
    th = 32 if n_t <= 48 else 16
    xch, uch = _chunks(cin), _chunks(cout)
    slab = 9 * KC * n_t * 2
    w0 = xch * 3 * slab
    w1 = uch * 3 * slab + xch * KC * n_t * 2
    halo = 2 * (-(-(th + 2) * (TW + 2) * 16 // 128) * 128)
    extra = NWARPS * 16 * n_t * 2 + 4 * GEPI * 4 + (2 * STAGES + 1) * 8
    if resident:
        slot = halo
        smem = (STAGES * slot + w0 + extra, STAGES * slot + w1 + extra)
    else:
        slot = halo + slab
        smem = (STAGES * slot + extra,) * 2
    per_plane = -(-h // th) * -(-w // TW)
    grid = int(grid)
    if p0 is None:
        share = P0_SHARE if resident else P0_SHARE_STREAMED
        p0 = min(max(round(grid * share), 1), grid - 1)
    if cop != n_t or n_t not in UNIT_N + STREAM_N:
        mode = "chain"
        why = (f"Cout {cout} takes N tiles of {n_t} x {cop // n_t}; the unit "
               f"is built for one N tile of {UNIT_N + STREAM_N}")
    elif max(smem) > SMEM_MAX:
        mode = "chain"
        why = (f"weights {w0} / {w1} B beside {STAGES} slots of {slot} B "
               f"need {max(smem)} B of shared memory > {SMEM_MAX}")
    elif resident:
        mode = "resident"
        why = (f"both roles' weights resident: {smem[0]} and {smem[1]} B "
               f"<= {SMEM_MAX}")
    else:
        mode = "streamed"
        why = (f"weights {w0} / {w1} B staged a slab a stage in {STAGES} "
               f"slots of {slot} B ({smem[0]} B)")
    return Plan(mode=mode, n=n_t, th=th, weights=(w0, w1),
                slot=slot, smem=smem, per_plane=per_plane,
                target=NWARPS * per_plane, p0=int(p0), grid=grid, why=why)


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
             + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
             + [ctypes.c_void_p] + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
_GRIDS = {}


def _fn():
    lib = _lib()
    return lib, _build.bind(lib, "ru_unit_launch", _ARGTYPES)


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def unit_grid(dev: torch.device, cin: int, cout: int) -> int:
    """The unit kernel's cooperative grid on `dev` for x of cin channels
    and Cout (blocks per SM as the occupancy API gives them x SMs), from
    the launcher; cached per library, device and shape."""
    if cout not in UNIT_N + STREAM_N:
        raise ValueError(f"ru_unit: no instance for Cout {cout}")
    lib, fn = _fn()
    cx = -(-cin // 8) * 8
    key = (id(lib), _index(dev), cx, cout)
    grid = _GRIDS.get(key)
    if grid is None:
        out = ctypes.c_int(0)
        err = fn(None, cx, None, None, None, None, None, None, None, None,
                 None, 1, None, None, None, 1, None, 0, 0, 0, 0, cout, 0,
                 _index(dev), None, ctypes.byref(out))
        _build.check(lib, err, "ru_unit grid")
        grid = _GRIDS[key] = out.value
    return grid


def launch_unit(x: torch.Tensor, u0: torch.Tensor, out: torch.Tensor,
                cnt: torch.Tensor, p: Plan, *, w0, bn0_scale, bn0_shift,
                alpha0, w1, bn1_scale, bn1_shift, alpha1, wr, br) -> None:
    """One launch of the unit kernel on the current stream of x's device,
    into u0 and out (bf16 (N, D, H, W, Cout), u0 scratch), with the
    per-plane counters cnt (N * D int32; zero, or complete when p.p0 is 0,
    which runs conv1 alone); raises if the launcher refuses it. Counts
    nothing: ru_unit is the counted entry point."""
    dev = x.device
    cin, cout = int(x.shape[-1]), int(w0.shape[-1])
    lib, fn = _fn()
    w0p = packed_weights(w0, "conv333", [cin], p.n, dev)
    w1p = packed_weights(w1, "conv333", [cout], p.n, dev)
    wrp = packed_weights(wr, "conv333", [cin], p.n, dev)
    s0, h0 = _epi(bn0_scale, cout, dev), _epi(bn0_shift, cout, dev)
    s1, h1 = _epi(bn1_scale, cout, dev), _epi(bn1_shift, cout, dev)
    a0, a1 = (_epi(a, cout, dev, one=True) for a in (alpha0, alpha1))
    rb = _epi(br, cout, dev)
    (xr,) = _tma_ready((x,), {})
    n, d, h, w = x.shape[:4]
    idx = _index(dev)
    err = fn(_ptr(xr), xr.shape[-1], _ptr(u0), _ptr(out), _ptr(cnt),
             _ptr(w0p), _ptr(w1p), _ptr(wrp), _ptr(s0), _ptr(h0), _ptr(a0),
             a0.numel() if a0 is not None else 1, _ptr(s1), _ptr(h1),
             _ptr(a1), a1.numel() if a1 is not None else 1, _ptr(rb), n, d,
             h, w, cout, p.p0, idx,
             torch._C._cuda_getCurrentRawStream(idx), None)
    _build.check(lib, err, "ru_unit")


def _check_weights(x: torch.Tensor, params) -> Tuple[int, int]:
    cin, cout = int(x.shape[-1]), int(params["w0"].shape[-1])
    want = {"w0": (3, 3, 3, cin, cout), "w1": (3, 3, 3, cout, cout),
            "wr": (1, 1, 1, cin, cout)}
    for k, s in want.items():
        if tuple(params[k].shape) != s:
            raise ValueError(f"ru_unit: {k} {tuple(params[k].shape)}, "
                             f"expected {s}")
    return cin, cout


def ru_unit(x: torch.Tensor, *, p0: Optional[int] = None,
            **params) -> torch.Tensor:
    """The unit kernel: x (N, D, H, W, Cin) bf16 contiguous on a CUDA
    device, params as ru_chain's with (3,3,3) weights; p0 (blocks on conv0)
    overrides plan's. Raises where the plan does not take the shape. A CPU
    tensor runs ru_block_plain (uncounted)."""
    if x.device.type == "cpu":
        return ru_block_plain(x, **params)
    if x.device.type != "cuda":
        raise ValueError(f"ru_unit: unsupported device {x.device}")
    _check_act((x,), "ru_unit")
    cin, cout = _check_weights(x, params)
    p = plan(x.shape[:4], cin, cout)
    if not p.fused:
        raise ValueError(f"ru_unit: {tuple(x.shape)} -> {cout}: {p.why}")
    p = plan(x.shape[:4], cin, cout, unit_grid(x.device, cin, cout), p0)
    if not 1 <= p.p0 < p.grid:
        raise ValueError(f"ru_unit: p0 {p.p0} outside 1 .. {p.grid - 1}")
    n, d = x.shape[:2]
    u0 = torch.empty((*x.shape[:4], cout), dtype=torch.bfloat16,
                     device=x.device)
    out = torch.empty_like(u0)
    cnt = torch.zeros(n * d, dtype=torch.int32, device=x.device)
    launch_unit(x, u0, out, cnt, p, **params)
    _build.count(ru_unit)
    return out


ru_unit.launches = 0


def ru_block(x: torch.Tensor, **params) -> torch.Tensor:
    """Fused eval ResidualUnit. x: (N, D, H, W, Cin); params (ru_chain's
    keywords): w0 (3,3,3,Cin,Cout), w1 (3,3,3,Cout,Cout), wr
    (1,1,1,Cin,Cout), the folded affines and PReLU slopes; returns (N, D, H,
    W, Cout). On CUDA tensors: ru_unit where plan takes the shape, else the
    two conv333 launches of ru_chain."""
    if x.device.type == "cpu":
        return ru_block_plain(x, **params)
    if x.device.type != "cuda":
        raise ValueError(f"ru_block: unsupported device {x.device}")
    p = plan(x.shape[:4], int(x.shape[-1]), int(params["w0"].shape[-1]))
    if p.fused and tuple(params["w0"].shape[:3]) == (3, 3, 3):
        out = ru_unit(x, **params)
    else:
        out = ru_chain(conv333, x, **params)
    _build.count(ru_block)
    return out


ru_block.launches = 0
