"""The port's native NIFTI decoder (vs_seg_tpu_torch/native/) against the
JAX package's (vs_seg_tpu/native/) and against its own plain gzip and numpy
twins, on the CPU: the cases of tests/test_native.py on both packages, the
multi-member gzip case, every datatype code of the converter, and the
port's build, fallback and counters. Inputs come from numpy's seeded
generator. Tolerance: none; bytes and float32 arrays are equal
(np.array_equal): both libraries are built from one source with the same
flags, and the twins do the same float32 operations in the same order.
"""

import gzip
import logging
import os
import threading

import numpy as np
import pytest

from vs_seg_tpu.data import nifti as jnifti
from vs_seg_tpu.native import decoder as jdec
from vs_seg_tpu_torch.data import nifti as tnifti
from vs_seg_tpu_torch.native import decoder as tdec
from vs_seg_tpu_torch.ops import _build

CODES = (2, 4, 8, 16, 64, 256, 512, 768, 1024)
# (slope, inter) as load() passes them, and a zero slope, which the
# converter takes as 1
SCALES = ((1.0, 0.0), (2.0, 5.0), (0.0078125, -1024.0), (0.0, 3.5))


def _payload(rng, code, count):
    dt = tdec.DTYPES[code]
    if dt.kind == "f":
        vals = rng.normal(scale=1e3, size=count)
    else:
        info = np.iinfo(dt)
        vals = rng.integers(info.min, info.max, size=count, endpoint=True,
                            dtype=np.int64 if info.min < 0 else np.uint64)
    return vals.astype(dt).tobytes()


def test_both_libraries_build():
    assert jdec.native_available(), "the JAX package's decoder did not build"
    assert tdec.native_available(), "the port's decoder did not build"


def test_library_lands_in_the_build_folder():
    """Built under build/vs_seg_tpu_torch/, named by a hash of the source
    and flags; nothing is written into the package."""
    assert tdec.native_available()
    path = _build.library_path("nifti_decode", tdec.SRC)
    assert path.parent == _build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libnifti_decode_")
    pkg = tdec.SRC.parents[1]
    assert not [p for p in pkg.rglob("*") if p.suffix in (".so", ".o")]
    assert tdec.SRC.read_bytes() == open(
        os.path.join(os.path.dirname(jdec.__file__), "nifti_decode.cc"),
        "rb").read()


@pytest.mark.parametrize("ext", [".nii.gz", ".nii"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
def test_read_file_bytes_equal(tmp_path, ext, dtype):
    """test_native.py's gz read and uncompressed pass-through, on both
    packages and the twin."""
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(9, 7, 5)) * 50).astype(dtype)
    path = str(tmp_path / f"vol{ext}")
    tnifti.save(tnifti.NiftiImage(data, np.eye(4)), path)
    got = tdec.read_file_bytes(path)
    assert got is not None
    assert got == jdec.read_file_bytes(path)
    assert got == tdec.read_file_bytes_plain(path)
    with (gzip.open if ext.endswith(".gz") else open)(path, "rb") as f:
        assert got == f.read()


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("code", CODES)
def test_convert_to_float32_equal(code, scale):
    """Every datatype code: the port's converter, JAX's and the twin give
    one float32 array."""
    rng = np.random.default_rng(code)
    count = 1000
    payload = _payload(rng, code, count)
    got = tdec.convert_to_float32(payload, count, code, *scale)
    ref = jdec.convert_to_float32(payload, count, code, *scale)
    twin = tdec.convert_to_float32_plain(payload, count, code, *scale)
    assert got.dtype == ref.dtype == twin.dtype == np.float32
    assert np.array_equal(got, ref, equal_nan=True)
    assert np.array_equal(got, twin, equal_nan=True)


def test_multi_member_gzip_decodes_fully(tmp_path):
    """bgzip-style concatenated members decode to the end on every path."""
    a, b = b"x" * 70000, bytes(np.random.default_rng(1).integers(
        0, 256, size=50000, dtype=np.uint8))
    path = tmp_path / "multi.gz"
    path.write_bytes(gzip.compress(a) + gzip.compress(b))
    assert tdec.read_file_bytes(str(path)) == a + b
    assert jdec.read_file_bytes(str(path)) == a + b
    assert tdec.read_file_bytes_plain(str(path)) == a + b


@pytest.mark.parametrize("scl", [(1.0, 0.0), (0.5, -3.0), (float("nan"), 2.0),
                                 (0.0, 7.0)])
@pytest.mark.parametrize("dtype", [np.int16, np.uint16, np.float64, np.int8])
def test_load_equal(tmp_path, dtype, scl):
    """nifti.load of both packages through their native paths, with the
    header's scl_slope/scl_inter (NaN or zero slope: no scaling)."""
    rng = np.random.default_rng(2)
    data = (rng.normal(size=(11, 6, 4)) * 100).astype(dtype)
    path = str(tmp_path / "v.nii.gz")
    tnifti.save(tnifti.NiftiImage(data, np.diag([0.5, 0.7, 2.0, 1.0])), path)
    raw = bytearray(gzip.decompress(open(path, "rb").read()))
    raw[112:120] = np.asarray(scl, "<f4").tobytes()
    with open(path, "wb") as f:
        with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
            gz.write(bytes(raw))
    reads, convs = (tdec.read_file_bytes.native_calls,
                    tdec.convert_to_float32.native_calls)
    got, ref = tnifti.load(path), jnifti.load(path)
    assert tdec.read_file_bytes.native_calls == reads + 1
    assert tdec.convert_to_float32.native_calls == convs + 1
    assert got.data.dtype == np.float32
    assert np.array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.affine, ref.affine)
    raw_got = tnifti.load(path, dtype=None)
    assert raw_got.data.dtype == dtype
    assert np.array_equal(raw_got.data, jnifti.load(path, dtype=None).data)


def test_truncated_payload_raises(tmp_path):
    """A payload shorter than its header says: the native converter
    declines it (it takes no length) and both packages raise ValueError."""
    data = np.arange(64, dtype=np.int16).reshape(4, 4, 4)
    path = str(tmp_path / "t.nii")
    tnifti.save(tnifti.NiftiImage(data, np.eye(4)), path)
    with open(path, "r+b") as f:
        f.truncate(352 + 60)
    assert tdec.convert_to_float32(b"\0" * 60, 64, 4, 1.0, 0.0) is None
    with pytest.raises(ValueError):
        tdec.convert_to_float32_plain(b"\0" * 60, 64, 4, 1.0, 0.0)
    for mod in (tnifti, jnifti):
        with pytest.raises(ValueError):
            mod.load(path)


def test_failed_build_warns_once_and_falls_back(tmp_path, monkeypatch,
                                                caplog):
    """A source g++ refuses: one WARNING with the compiler's stderr, then
    the twins serve every call, with the same values, and no native count."""
    bad = tmp_path / "nifti_decode.cc"
    bad.write_text("int nd_read_file( {\n")
    monkeypatch.setattr(tdec, "SRC", bad)
    monkeypatch.setattr(tdec, "_tried", False)
    monkeypatch.setattr(tdec, "_lib", None)
    monkeypatch.delitem(_build._LIBS, "nifti_decode", raising=False)
    data = np.random.default_rng(3).normal(size=(5, 4, 3)).astype(np.float32)
    path = str(tmp_path / "v.nii.gz")
    tnifti.save(tnifti.NiftiImage(data, np.eye(4)), path)
    reads, convs = (tdec.read_file_bytes.native_calls,
                    tdec.convert_to_float32.native_calls)
    with caplog.at_level(logging.WARNING, logger=tdec.__name__):
        a = tnifti.load(path)
        b = tnifti.load(path)
    warns = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warns) == 1
    assert "error" in warns[0].getMessage()
    assert "nifti_decode.cc" in warns[0].getMessage()
    assert not tdec.native_available()
    assert np.array_equal(a.data, data) and np.array_equal(b.data, data)
    assert (tdec.read_file_bytes.native_calls,
            tdec.convert_to_float32.native_calls) == (reads, convs)
    assert not _build.library_path("nifti_decode", bad).exists()


def test_threads_decode_in_parallel_and_count_every_call(tmp_path):
    """More threads than cores, each loading volumes while the GIL is
    released in the C calls: every result is right and no count is lost."""
    rng = np.random.default_rng(4)
    vols = [rng.normal(size=(16, 12, 6)).astype(np.float32) for _ in range(4)]
    paths = []
    for i, v in enumerate(vols):
        paths.append(str(tmp_path / f"v{i}.nii.gz"))
        tnifti.save(tnifti.NiftiImage(v, np.eye(4)), paths[-1])
    n_threads, loads = 2 * (os.cpu_count() or 1), 6
    reads = tdec.read_file_bytes.native_calls
    bad = []

    def work(t):
        for k in range(loads):
            i = (t + k) % len(vols)
            if not np.array_equal(tnifti.load(paths[i]).data, vols[i]):
                bad.append((t, k))

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    assert tdec.read_file_bytes.native_calls == reads + n_threads * loads
