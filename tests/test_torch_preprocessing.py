"""The port's preprocessing toolchain (vs_seg_tpu_torch/preprocessing/)
against the JAX package's, on the CPU.

One synthetic TCIA download (tests/tcia_download.py: two cases, each a T1
and a T2 series of their own shapes and spacings with seeded noise, their
RTSTRUCT, RTPLAN and RTDOSE, and the pair's translation .tfm) goes through
both CLIs' `restructure`, `convert` (no_registration, T1, T2) and `bids`.
The two packages' output trees must hold the same file names and every file
byte-identical: the NIFTIs are gzip with mtime 0, so byte equality is the
tolerance. The functions below the CLIs (DICOM parsing, series assembly,
rasterisation, registration) are held equal the same way, and the CLIs'
exit codes on bad input agree. Finally no module of native/, preprocessing/
or the checkpoint converter imports jax or vs_seg_tpu.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.tcia_download import Grid, write_download, write_transforms
from tests.test_preprocessing import write_mr_slice, write_rtstruct
from vs_seg_tpu.preprocessing import convert as jconvert
from vs_seg_tpu.preprocessing import dicom as jdicom
from vs_seg_tpu.preprocessing import registration as jreg
from vs_seg_tpu.preprocessing.__main__ import main as jmain
from vs_seg_tpu_torch.data import nifti as tnifti
from vs_seg_tpu_torch.preprocessing import convert as tconvert
from vs_seg_tpu_torch.preprocessing import dicom as tdicom
from vs_seg_tpu_torch.preprocessing import registration as treg
from vs_seg_tpu_torch.preprocessing.__main__ import main as tmain

REPO = Path(__file__).resolve().parents[1]
T2 = Grid((24, 24, 8), (1.0, 2.0), (-12.0, -12.0, -8.0))
T1 = Grid((20, 22, 10), (1.25, 1.6), (-13.0, -12.5, -7.0))
CASES = (1, 2)
REGISTER = ("no_registration", "T1", "T2")
MAINS = {"jax": jmain, "port": tmain}


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs over one download: {stage: {package: output folder}}, and
    the pixels written."""
    base = tmp_path_factory.mktemp("tcia")
    pixels = write_download(base / "raw", CASES, T2, T1,
                            rng=np.random.default_rng(0), noise=20)
    out = {}
    for pkg, main in MAINS.items():
        cases = base / f"{pkg}_cases"
        assert main(["restructure", "-i", str(base / "raw"),
                     "-o", str(cases)]) == 0
        out.setdefault("restructure", {})[pkg] = cases
        write_transforms(cases, CASES)
        for reg in REGISTER:
            dst = base / f"{pkg}_convert_{reg}"
            assert main(["convert", "-i", str(cases), "-o", str(dst),
                         "--register", reg]) == 0
            out.setdefault(f"convert_{reg}", {})[pkg] = dst
        dst = base / f"{pkg}_bids"
        assert main(["bids", "-i", str(cases), "-o", str(dst)]) == 0
        out.setdefault("bids", {})[pkg] = dst
    return out, pixels


@pytest.mark.parametrize("stage", ["restructure"]
                         + [f"convert_{r}" for r in REGISTER] + ["bids"])
def test_cli_trees_byte_identical(runs, stage):
    out, _ = runs
    got, ref = _tree(out[stage]["port"]), _tree(out[stage]["jax"])
    assert sorted(got) == sorted(ref)
    assert len(got) > 1
    bad = [name for name in ref if got[name] != ref[name]]
    assert not bad, f"{stage}: files differ: {bad}"


@pytest.mark.parametrize("reg", ["no_registration", "T2"])
def test_converted_t2_is_the_written_pixels(runs, reg):
    out, pixels = runs
    for n in CASES:
        case = out[f"convert_{reg}"]["port"] / f"vs_gk_{n}"
        img = tnifti.load(str(case / "vs_gk_t2_refT2.nii.gz"))
        assert np.array_equal(img.data, pixels[n]["t2"].astype(np.float32))
        seg = tnifti.load(str(case / "vs_gk_seg_refT2.nii.gz"), dtype=None)
        assert seg.data.shape == T2.shape and seg.data.sum() > 0
        # the rasterised contours sit on the tumour (900)
        np.testing.assert_allclose(np.argwhere(seg.data > 0).mean(0),
                                   np.argwhere(pixels[n]["t2"] >= 900
                                               ).mean(0), atol=1.0)


def test_registered_t1_lands_on_the_t2_tumour(runs):
    """--register T2 moves the T1 by the case's .tfm onto the T2 grid: the
    tumour's centroid there is the T2's within a voxel."""
    out, pixels = runs
    for n in CASES:
        case = out["convert_T2"]["port"] / f"vs_gk_{n}"
        moved = tnifti.load(str(case / "vs_gk_t1_refT2.nii.gz")).data
        want = np.argwhere(pixels[n]["t2"] >= 900).mean(0)
        got = np.argwhere(moved > 800).mean(0)
        np.testing.assert_allclose(got, want, atol=1.0)


def test_read_dicom_and_pixel_array_equal(runs):
    out, _ = runs
    case = out["restructure"]["port"] / "vs_gk_1_t1"
    for name in ("IMG0000.dcm", "IMG0007.dcm", "RTSS.dcm", "RTPLAN.dcm",
                 "RTDOSE.dcm"):
        got = tdicom.read_dicom(str(case / name))
        ref = jdicom.read_dicom(str(case / name))
        assert got == ref
        assert (tdicom.read_dicom(str(case / name), headers_only=True)
                == jdicom.read_dicom(str(case / name), headers_only=True))
        if name.startswith("IMG"):
            assert np.array_equal(tdicom.pixel_array(got),
                                  jdicom.pixel_array(ref))


def test_load_series_equal(runs):
    out, pixels = runs
    case = out["restructure"]["port"] / "vs_gk_2_t1"
    files = sorted(str(p) for p in case.glob("IMG*.dcm"))
    vol, aff = tconvert.load_series(files)
    jvol, jaff = jconvert.load_series(files)
    assert np.array_equal(vol, jvol) and np.array_equal(aff, jaff)
    assert np.array_equal(vol, pixels[2]["t1"].astype(np.float32))


def _polygons(rng):
    flip = np.diag([-1.0, -1.0, 1.0])
    outer = np.array([[0.5, 0.5, 0], [10.5, 0.5, 0], [10.5, 10.5, 0],
                      [0.5, 10.5, 0]])
    inner = np.array([[3.5, 3.5, 0], [7.5, 3.5, 0], [7.5, 7.5, 0],
                      [3.5, 7.5, 0]])
    oblique = np.array([[2.0, 2.0, -6.0], [2.0, 13.5, 5.5],
                        [10.0, 13.5, 5.5], [10.0, 2.0, -6.0]])
    theta = np.sort(rng.uniform(0, 2 * np.pi, 11))
    radius = rng.uniform(2.0, 6.0, 11)
    star = np.stack([8 + radius * np.cos(theta), 8 + radius * np.sin(theta),
                     np.full(11, 5.0)], axis=1)
    return {"xor_hole": [(flip @ outer.T).T, (flip @ inner.T).T],
            "oblique": [(flip @ oblique.T).T],
            "seeded_star": [(flip @ star.T).T]}


@pytest.mark.parametrize("name", ["xor_hole", "oblique", "seeded_star"])
def test_rasterize_contours_equal(name):
    contours = _polygons(np.random.default_rng(5))[name]
    got = tconvert.rasterize_contours(contours, np.eye(4), (16, 16, 16))
    ref = jconvert.rasterize_contours(contours, np.eye(4), (16, 16, 16))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert got.sum() > 0
    if name == "xor_hole":
        assert got[5, 5, 0] == 0 and got[2, 5, 0] == 1


def test_convert_case_equal(tmp_path):
    """convert_case on test_preprocessing.py's axial series and circle."""
    rng = np.random.default_rng(6)
    case = tmp_path / "case"
    case.mkdir()
    vol = rng.integers(-50, 200, size=(16, 16, 4)).astype(np.int16)
    for k in range(4):
        write_mr_slice(str(case / f"IMG{k:04d}.dcm"), vol[:, :, k],
                       ipp=(-10.0, -20.0, 5.0 + 2.0 * k),
                       iop=(1, 0, 0, 0, 1, 0), spacing=(1.0, 1.0),
                       series_uid="1.2.9", sop_uid=f"1.2.9.{k}")
    theta = np.linspace(0, 2 * np.pi, 33)[:-1]
    circle = np.stack([-2.0 + 3.0 * np.cos(theta), -12.0 + 3.0 * np.sin(theta),
                       np.full_like(theta, 7.0)], axis=1)
    write_rtstruct(str(case / "RTSS.dcm"), [circle], series_uid="1.2.9")
    got = tconvert.convert_case(str(case), str(tmp_path / "t"), "T1")
    ref = jconvert.convert_case(str(case), str(tmp_path / "j"), "T1")
    assert sorted(got) == sorted(ref) == ["image", "label"]
    for key in got:
        assert Path(got[key]).read_bytes() == Path(ref[key]).read_bytes()


def test_read_itk_tfm_equal(tmp_path):
    rng = np.random.default_rng(7)
    params = rng.normal(size=12)
    fixed = rng.normal(size=3) * 10
    tfm = tmp_path / "t.tfm"
    tfm.write_text("#Insight Transform File V1.0\n#Transform 0\n"
                   "Transform: AffineTransform_double_3_3\n"
                   "Parameters: " + " ".join(repr(float(v)) for v in params) + "\n"
                   "FixedParameters: " + " ".join(repr(float(v)) for v in fixed)
                   + "\n")
    got, ref = treg.read_itk_tfm(str(tfm)), jreg.read_itk_tfm(str(tfm))
    assert np.array_equal(got, ref)
    bad = tmp_path / "b.tfm"
    bad.write_text("Transform: BSplineTransform_double_3_3\nParameters: 1\n")
    for mod in (treg, jreg):
        with pytest.raises(ValueError):
            mod.read_itk_tfm(str(bad))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("with_tfm", [False, True])
def test_resample_to_reference_equal(order, with_tfm):
    rng = np.random.default_rng(8 + order)
    data = rng.normal(size=(14, 12, 9)).astype(np.float32)
    mov_aff = np.diag([-1.1, -0.9, 2.0, 1.0])
    mov_aff[:3, 3] = rng.uniform(-5, 5, 3)
    ref_aff = np.diag([1.0, 1.2, 1.5, 1.0])
    ref_aff[:3, :3] += rng.normal(scale=0.05, size=(3, 3))
    tfm = None
    if with_tfm:
        tfm = np.eye(4)
        tfm[:3, :3] += rng.normal(scale=0.02, size=(3, 3))
        tfm[:3, 3] = rng.normal(size=3)
    shape = (10, 11, 7)
    got = treg.resample_to_reference(
        tnifti.NiftiImage(data, mov_aff),
        tnifti.NiftiImage(np.zeros(shape, np.float32), ref_aff), tfm, order)
    from vs_seg_tpu.data import nifti as jnifti
    ref = jreg.resample_to_reference(
        jnifti.NiftiImage(data, mov_aff),
        jnifti.NiftiImage(np.zeros(shape, np.float32), ref_aff), tfm, order)
    assert got.data.shape == shape and got.data.dtype == np.float32
    assert np.array_equal(got.data, ref.data)
    assert np.array_equal(got.affine, ref.affine)


@pytest.mark.parametrize("argv,code", [
    (["convert", "-i", "{empty}", "-o", "{out}"], 1),
    (["convert", "-i", "{half}", "-o", "{out}", "--register", "T2"], 0),
    (["bids", "-i", "{empty}", "-o", "{out}"], 0),
    (["restructure", "-i", "{empty}", "-o", "{out}"], 0),
    (["convert", "-i", "{empty}", "-o", "{out}", "--register", "T3"], 2),
    (["restructure", "-i", "{empty}", "-o", "{out}", "--on-unclassified",
      "maybe"], 2),
    (["register"], 2),
    ([], 2),
])
def test_cli_exit_codes_equal(tmp_path, runs, argv, code):
    """Exit codes and what is written, on bad or partial input."""
    out, _ = runs
    half = tmp_path / "half"
    half.mkdir()
    os.symlink(out["restructure"]["port"] / "vs_gk_1_t1",
               half / "vs_gk_1_t1")        # a case without its T2
    (tmp_path / "empty").mkdir()
    written = {}
    for pkg, main in MAINS.items():
        args = [a.format(empty=tmp_path / "empty", half=half,
                         out=tmp_path / f"out_{pkg}") for a in argv]
        try:
            rc = main(args)
        except SystemExit as e:
            rc = e.code
        assert rc == code, (pkg, rc)
        written[pkg] = (_tree(tmp_path / f"out_{pkg}")
                        if (tmp_path / f"out_{pkg}").exists() else None)
    if written["jax"] is None:
        assert written["port"] is None
    else:
        assert written["port"] == written["jax"]


PORT_MODULES = sorted(
    "vs_seg_tpu_torch." + ".".join(p.relative_to(REPO / "vs_seg_tpu_torch")
                                   .with_suffix("").parts)
    for d in ("native", "preprocessing")
    for p in (REPO / "vs_seg_tpu_torch" / d).glob("*.py")
) + ["vs_seg_tpu_torch.compat.convert_checkpoint",
     "vs_seg_tpu_torch.core.observability", "vs_seg_tpu_torch.eval.flops"]


@pytest.mark.parametrize("module", PORT_MODULES)
def test_module_imports_neither_jax_nor_the_jax_package(module):
    code = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'vs_seg_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, module], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
