"""Build-at-first-use for the hand-written Hopper kernels in ops/csrc/.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc into
its own shared library (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/vs_seg_tpu_torch/lib<name>_<hash>.so

The library lands in `build/vs_seg_tpu_torch/` at the repo root, named by a
hash of its sources and flags, so a changed source rebuilds and an unchanged
one is reused. It is loaded with ctypes; every C launcher returns the value
of cudaGetLastError() after its launch, and the Python wrappers raise on a
non-zero value. Importing this module builds nothing; a failed build raises.

Host code takes the same path: `load(name, src)` with a C++ source (`.cc`)
compiles it with the host's g++ instead,

    g++ -O3 -shared -fPIC <src> -lz -o build/vs_seg_tpu_torch/lib<name>_<hash>.so

(native/decoder.py builds the NIFTI decoder so).

The wrappers may be called from several threads at once (the shards of
parallel/collectives.py:run_spmd): `load` builds and loads under one lock,
`bind` sets a launcher's argument types under it, and `count` adds to the
launch counters under another, so that no count is lost.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vs_seg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# A host source's flags and libraries, those of vs_seg_tpu/native/decoder.py:
# no -march=native and no -ffast-math, so that no multiply-add is contracted.
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
GXX_LIBS = ("-lz",)

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# Seconds spent in nvcc by this process, per library (reported by
# chip_smoke.py as the kernels' build time).
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _source(name: str, src: Optional[Path]) -> Path:
    return CSRC / f"{name}.cu" if src is None else Path(src)


def _cuda(src: Path) -> bool:
    return src.suffix == ".cu"


def _sources(src: Path):
    if not src.is_file():
        raise FileNotFoundError(src)
    return [src] + sorted(src.parent.glob("*.cuh" if _cuda(src) else "*.h"))


def _command(src: Path, out: Path):
    if _cuda(src):
        return [find_nvcc(), *NVCC_FLAGS, "-I", str(src.parent), "-o",
                str(out), str(src)]
    return ["g++", *GXX_FLAGS, str(src), *GXX_LIBS, "-o", str(out)]


def library_path(name: str, src: Optional[Path] = None) -> Path:
    src = _source(name, src)
    flags = NVCC_FLAGS if _cuda(src) else GXX_FLAGS + GXX_LIBS
    h = hashlib.sha256(" ".join(flags).encode())
    for p in _sources(src):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, src: Optional[Path] = None) -> Path:
    """Compile `src` (default csrc/<name>.cu) unless the hashed library
    already exists; a failed compile raises RuntimeError with its output."""
    import time

    src = _source(name, src)
    out = library_path(name, src)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = _command(src, tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed for {src.name} (exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, src: Optional[Path] = None) -> ctypes.CDLL:
    """Build (if needed) and load `src` (default csrc/<name>.cu); cached per
    process under `name`."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, src)))
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        errstr = lib.vs_errstr
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError {err} "
                           f"({errstr(err).decode()})")


def bind(lib: ctypes.CDLL, name: str, argtypes, restype=ctypes.c_int):
    """lib's function `name` with its argument and result types set; set
    once, under the lock, so that no thread calls it half declared."""
    with _LOCK:
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.restype = restype
            fn.argtypes = argtypes
    return fn


def count(fn, attr: str = "launches", key=None, n: int = 1) -> None:
    """Add n to the counter `fn.<attr>` (or to `fn.<attr>[key]`, a dict's
    entry) under the counters' lock."""
    with _COUNT_LOCK:
        if key is None:
            setattr(fn, attr, getattr(fn, attr) + n)
        else:
            getattr(fn, attr)[key] += n
