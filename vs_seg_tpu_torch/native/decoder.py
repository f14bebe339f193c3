"""ctypes bindings for the native NIFTI decoder (csrc/nifti_decode.cc): the
port's copy of vs_seg_tpu/native/decoder.py.

The library is built at first use by the host's g++ with the JAX package's
flags (`g++ -O3 -shared -fPIC nifti_decode.cc -lz`) into
build/vs_seg_tpu_torch/, named by a hash of its source and flags
(ops/_build.py); nothing is written into the package. The C calls run with
the GIL released (ctypes.CDLL), so the threaded CacheDataset and DataLoader
workers decompress volumes in parallel.

`read_file_bytes` and `convert_to_float32` return None where the native
path cannot serve the call; data/nifti.py then takes their plain gzip and
numpy twins, `read_file_bytes_plain` and `convert_to_float32_plain`, which
give the same bytes and the same float32 values. A failed build (no g++, no
zlib headers) logs one WARNING that carries the compiler's output, so that a
machine without a toolchain still reads NIFTI and says why it is slower.
Each call served natively adds one to the function's `native_calls`.
"""

from __future__ import annotations

import ctypes
import gzip
import logging
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from vs_seg_tpu_torch.ops import _build

SRC = Path(__file__).resolve().parent / "csrc" / "nifti_decode.cc"
_LOG = logging.getLogger(__name__)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# NIFTI-1 datatype code -> on-disk dtype: the codes data/nifti.py reads
# and writes, exactly those of the C converter's switch in nifti_decode.cc
DTYPES = {2: np.dtype(np.uint8), 4: np.dtype(np.int16),
          8: np.dtype(np.int32), 16: np.dtype(np.float32),
          64: np.dtype(np.float64), 256: np.dtype(np.int8),
          512: np.dtype(np.uint16), 768: np.dtype(np.uint32),
          1024: np.dtype(np.int64)}


def _load() -> Optional[ctypes.CDLL]:
    """The decoder library, built on the first call; None (and one WARNING)
    when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = _build.load("nifti_decode", SRC)
        except (OSError, RuntimeError) as e:
            _LOG.warning("native NIFTI decoder unavailable; reading with "
                         "gzip and numpy instead: %s", e)
            return None
        _build.bind(lib, "nd_read_file",
                    [ctypes.c_char_p, ctypes.POINTER(_U8P),
                     ctypes.POINTER(ctypes.c_int64)])
        _build.bind(lib, "nd_free", [_U8P], None)
        _build.bind(lib, "nd_to_float32",
                    [_U8P, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                     ctypes.c_float, ctypes.POINTER(ctypes.c_float)])
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def read_file_bytes(path) -> Optional[bytes]:
    """Read a file and inflate it when it is gzip (every member of a
    multi-member file), natively; None if the library is absent or the
    read failed."""
    lib = _load()
    if lib is None:
        return None
    buf = _U8P()
    length = ctypes.c_int64()
    if lib.nd_read_file(os.fsencode(path), ctypes.byref(buf),
                        ctypes.byref(length)) != 0:
        return None
    try:
        data = ctypes.string_at(buf, length.value)
    finally:
        lib.nd_free(buf)
    _build.count(read_file_bytes, "native_calls")
    return data


def read_file_bytes_plain(path) -> bytes:
    """The plain twin: gzip for a `.gz` name, else the file's bytes."""
    opener = gzip.open if os.fspath(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def convert_to_float32(payload: bytes, count: int, datatype: int,
                       slope: float, inter: float) -> Optional[np.ndarray]:
    """`count` voxels of `payload` (datatype code `datatype`) as float32
    times `slope` plus `inter` (slope 0 counts as 1), natively; None if the
    library is absent, the code unknown or the payload short."""
    lib = _load()
    if lib is None:
        return None
    dtype = DTYPES.get(datatype)
    if dtype is None or len(payload) < count * dtype.itemsize:
        # the C converter takes no buffer length and would read past the
        # payload's end; the plain twin raises a clean ValueError
        return None
    out = np.empty(count, dtype=np.float32)
    src = np.frombuffer(payload, dtype=np.uint8)
    if lib.nd_to_float32(src.ctypes.data_as(_U8P), count, datatype, slope,
                         inter, out.ctypes.data_as(
                             ctypes.POINTER(ctypes.c_float))) != 0:
        return None
    _build.count(convert_to_float32, "native_calls")
    return out


def convert_to_float32_plain(payload: bytes, count: int, datatype: int,
                             slope: float, inter: float) -> np.ndarray:
    """The plain twin, the same float32 operations in the same order."""
    slope = np.float32(slope)
    if slope == 0:
        slope = np.float32(1.0)
    flat = np.frombuffer(payload, dtype=DTYPES[datatype], count=count)
    return flat.astype(np.float32) * slope + np.float32(inter)


read_file_bytes.native_calls = 0
convert_to_float32.native_calls = 0
