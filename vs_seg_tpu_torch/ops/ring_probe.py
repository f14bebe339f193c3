"""ring_probe: the shared-memory ring of csrc/ring.cuh on a toy pipeline.

Replaces the Mosaic probe tools/ring_probe.py:_kernel. x is (d * 16, 128)
float32, d planes of (16, 128); plane p of the output is 2 x[p] + 2 x[p + 1],
the last plane masked to 2 x[d - 1]. The kernel stages every plane once
through a 3-slot ring of TMA copies on mbarriers (csrc/ring.cuh), the plane
past the end zero-filled by the TMA; the result is bit-equal to the twin
(the same two exact doublings and one rounded f32 add).

`ring_probe` runs the kernel (csrc/ring_probe.cu) for CUDA tensors and
`ring_probe_plain` for CPU tensors; any other device raises. The CUDA route
counts its launches in `ring_probe.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from vs_seg_tpu_torch.ops import _build

ROWS, LANES = 16, 128


def ring_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """PyTorch twin of the probe (any device)."""
    planes = x.reshape(-1, ROWS, LANES) * 2.0
    nxt = torch.cat([planes[1:], torch.zeros_like(planes[:1])])
    return (planes + nxt).reshape(x.shape)


def _lib():
    lib = _build.load("ring_probe")
    _build.bind(lib, "ring_probe_launch",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p])
    return lib


def ring_probe(x: torch.Tensor) -> torch.Tensor:
    """x: (d * 16, 128) float32, contiguous; returns the same shape."""
    if x.device.type == "cpu":
        return ring_probe_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"ring_probe: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2 \
            or x.shape[1] != LANES or x.shape[0] % ROWS or x.shape[0] == 0:
        raise ValueError(f"ring_probe: needs contiguous float32 (d*{ROWS}, "
                         f"{LANES}), got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    lib = _lib()
    dev = x.device
    err = lib.ring_probe_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        x.shape[0] // ROWS,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, err, "ring_probe")
    _build.count(ring_probe)
    return out


ring_probe.launches = 0
