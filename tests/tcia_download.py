"""A synthetic TCIA VS-SEG download: per case a T1 and a T2 MR series, each
with its RTSTRUCT, RTPLAN and RTDOSE, and the pair's ITK translation
transforms. Written with the DICOM writers of tests/test_preprocessing.py,
for the port's preprocessing tests and chip_smoke.py's phase 19.

Those writers use struct and numpy only, but their module imports the JAX
package; `writers()` therefore compiles their definitions out of that file's
source and runs them without its imports, so that this module also loads
where JAX is absent (the GPU machine). It imports neither JAX nor vs_seg_tpu.

Geometry (oblique-free: ImageOrientationPatient (1,0,0,0,1,0)): voxel
(row, col, slice) of a series sits at LPS (x0 + col * sp, y0 + row * sp,
z0 + slice * dz). The anatomy is one phantom in millimetres: a head
ellipsoid with a smooth intensity field and a bright spherical tumour; the
T1 scan sees it moved by `shift` (LPS mm), so the T1 pixel at LPS q is the
phantom at q - shift. inv_T1_LPS_to_T2_LPS.tfm (fixed T2 -> moving T1) is
the translation +shift, inv_T2_LPS_to_T1_LPS.tfm its inverse; restructure
does not copy them, `write_transforms` puts them into the case folders.
"""

import ast
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

WRITERS = ("_el", "_txt", "_item", "write_mr_slice", "write_rtstruct",
           "write_rt_linked")
_SOURCE = Path(__file__).resolve().parent / "test_preprocessing.py"


def writers() -> Dict[str, object]:
    """The DICOM writers of tests/test_preprocessing.py, by name."""
    tree = ast.parse(_SOURCE.read_text(), str(_SOURCE))
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in WRITERS]
    missing = set(WRITERS) - {n.name for n in defs}
    if missing:
        raise ImportError(f"{_SOURCE} lacks {sorted(missing)}")
    ns = {"struct": struct, "np": np}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(_SOURCE),
                 "exec"), ns)
    return {name: ns[name] for name in WRITERS}


@dataclass(frozen=True)
class Grid:
    shape: Tuple[int, int, int]          # rows, columns, slices
    spacing: Tuple[float, float]         # in-plane mm (rows = cols), slice mm
    origin: Tuple[float, float, float]   # LPS mm of voxel (0, 0, 0)

    def lps(self, axis: int) -> np.ndarray:
        """LPS coordinate along x (axis 0, columns), y (rows) or z
        (slices)."""
        n = self.shape[(1, 0, 2)[axis]]
        step = self.spacing[0] if axis < 2 else self.spacing[1]
        return self.origin[axis] + step * np.arange(n)


@dataclass(frozen=True)
class Phantom:
    centre: Tuple[float, float, float]   # head centre, LPS mm
    head: Tuple[float, float, float]     # semi-axes, mm
    tumour: Tuple[float, float, float]   # centre, LPS mm
    radius: float                        # tumour radius, mm


def phantom_for(grid: Grid, case: int = 1) -> Phantom:
    """Case `case`'s phantom, scaled to the field of view of `grid` (the
    T2's): the tumour sits elsewhere in each case."""
    fov = [grid.shape[1] * grid.spacing[0], grid.shape[0] * grid.spacing[0],
           grid.shape[2] * grid.spacing[1]]
    centre = [grid.origin[a] + fov[a] / 2 for a in range(3)]
    return Phantom(centre=tuple(centre),
                   head=(0.4 * fov[0], 0.45 * fov[1], 0.45 * fov[2]),
                   tumour=(centre[0] + (0.1 + 0.05 * (case % 3)) * fov[0],
                           centre[1] - 0.05 * (case % 2) * fov[1],
                           centre[2] + 0.05 * (case % 4 - 1.5) * fov[2]),
                   radius=0.12 * min(fov))


def sample(grid: Grid, ph: Phantom, shift=(0.0, 0.0, 0.0), rng=None,
           noise: int = 0) -> np.ndarray:
    """int16 (rows, cols, slices) pixels of the phantom moved by `shift`,
    plus uniform integer noise in [0, noise] inside the head (from `rng`)."""
    x = grid.lps(0)[None, :, None] - shift[0]
    y = grid.lps(1)[:, None, None] - shift[1]
    z = grid.lps(2)[None, None, :] - shift[2]
    head = (((x - ph.centre[0]) / ph.head[0]) ** 2
            + ((y - ph.centre[1]) / ph.head[1]) ** 2
            + ((z - ph.centre[2]) / ph.head[2]) ** 2) < 1.0
    brain = 300.0 + 150.0 * np.cos(x / 20.0) * np.sin(y / 25.0)
    tumour = ((x - ph.tumour[0]) ** 2 + (y - ph.tumour[1]) ** 2
              + (z - ph.tumour[2]) ** 2) < ph.radius ** 2
    vol = np.where(head, brain, 0.0)
    vol = np.where(tumour, 900.0, vol)
    if noise:
        vol = vol + head * rng.integers(0, noise + 1, size=vol.shape)
    return np.rint(vol).astype(np.int16)


def contours(grid: Grid, ph: Phantom, shift=(0.0, 0.0, 0.0), points=32):
    """LPS polygons of the tumour on each slice plane of `grid` it cuts."""
    cx, cy, cz = (ph.tumour[a] + shift[a] for a in range(3))
    theta = np.linspace(0.0, 2.0 * np.pi, points + 1)[:-1]
    out = []
    for z in grid.lps(2):
        r2 = ph.radius ** 2 - (z - cz) ** 2
        if r2 > (0.25 * ph.radius) ** 2:
            r = np.sqrt(r2)
            out.append(np.stack([cx + r * np.cos(theta), cy + r * np.sin(theta),
                                 np.full_like(theta, z)], axis=1))
    return out


def _tfm(t) -> str:
    return ("#Insight Transform File V1.0\n#Transform 0\n"
            "Transform: AffineTransform_double_3_3\n"
            "Parameters: 1 0 0 0 1 0 0 0 1 "
            + " ".join(f"{v:g}" for v in t) + "\nFixedParameters: 0 0 0\n")


def write_download(root, cases, t2: Grid, t1: Grid, shift=(3.0, -2.0, 1.5),
                   rng=None, noise: int = 0
                   ) -> Dict[int, Dict[str, np.ndarray]]:
    """Cases VS-SEG-<n> under `root`; returns {n: {"t1": pixels, "t2":
    pixels}} as written ((rows, cols, slices) int16)."""
    w = writers()
    out = {}
    for n in cases:
        ph = phantom_for(t2, n)
        case = Path(root) / f"VS-SEG-{n:03d}"
        out[n] = {}
        for tag, grid, s in (("t1", t1, shift), ("t2", t2, (0.0,) * 3)):
            uid = f"1.2.826.0.1.3680043.{n}.{1 if tag == 't1' else 2}"
            series = case / f"1-{tag}"
            series.mkdir(parents=True)
            vol = sample(grid, ph, s, rng, noise)
            for k in range(grid.shape[2]):
                w["write_mr_slice"](
                    str(series / f"1-{k + 1:03d}.dcm"), vol[:, :, k],
                    ipp=(grid.origin[0], grid.origin[1],
                         grid.origin[2] + k * grid.spacing[1]),
                    iop=(1, 0, 0, 0, 1, 0),
                    spacing=(grid.spacing[0], grid.spacing[0]),
                    series_uid=uid, sop_uid=f"{uid}.{k}",
                    desc=f"{tag}_synthetic")
            rt = case / f"rt-{tag}"
            rt.mkdir()
            w["write_rtstruct"](str(rt / "1-1.dcm"), contours(grid, ph, s),
                                series_uid=uid, sop_uid=f"{uid}.rtss")
            w["write_rt_linked"](str(rt / "1-2.dcm"), "RTPLAN",
                                 sop_uid=f"{uid}.plan",
                                 ref_sop_uid=f"{uid}.rtss")
            w["write_rt_linked"](str(rt / "1-3.dcm"), "RTDOSE",
                                 sop_uid=f"{uid}.dose",
                                 ref_sop_uid=f"{uid}.plan")
            out[n][tag] = vol
    return out


def write_transforms(case_root, cases, shift=(3.0, -2.0, 1.5)) -> None:
    """The pair's .tfm files into restructured vs_gk_<n>_{t1,t2} folders."""
    for n in cases:
        (Path(case_root) / f"vs_gk_{n}_t1" / "inv_T1_LPS_to_T2_LPS.tfm"
         ).write_text(_tfm(shift))
        (Path(case_root) / f"vs_gk_{n}_t2" / "inv_T2_LPS_to_T1_LPS.tfm"
         ).write_text(_tfm([-v for v in shift]))
