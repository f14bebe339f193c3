"""NIFTI-1 IO and orientation: the port's copy of vs_seg_tpu/data/nifti.py.

  load()            .nii / .nii.gz -> NiftiImage(data, affine), nibabel
                    get_fdata semantics (scl_slope/scl_inter applied)
  save()            NIFTI-1 with an sform affine; .nii.gz written with gzip
                    mtime 0, so a file's bytes depend on its content only
  io_orientation(), ornt_to_axcodes(), reorient_to()
                    nibabel's orientation arithmetic (MONAI Orientationd)
  write_labelmap()  a labelmap mapped back onto the original on-disk grid
                    (MONAI NiftiSaver), nearest-neighbour resampled with
                    scipy when reorientation alone does not reach it

Bytes are read with gzip and numpy. The JAX package's C++ decoder
(vs_seg_tpu/native/) computes the same values and is host-side work for a
later change (ROADMAP, Queue 1 item 9).
"""

from __future__ import annotations

import gzip
import os
import struct
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

# NIFTI-1 datatype codes <-> numpy dtypes.
_CODE_TO_DTYPE = {
    2: np.dtype(np.uint8),
    4: np.dtype(np.int16),
    8: np.dtype(np.int32),
    16: np.dtype(np.float32),
    64: np.dtype(np.float64),
    256: np.dtype(np.int8),
    512: np.dtype(np.uint16),
    768: np.dtype(np.uint32),
    1024: np.dtype(np.int64),
}
_DTYPE_TO_CODE = {v: k for k, v in _CODE_TO_DTYPE.items()}

_HDR_SIZE = 352  # 348-byte header + 4 pad; the vox_offset written


@dataclass
class NiftiImage:
    data: np.ndarray
    affine: np.ndarray


def _read_bytes(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _quaternion_affine(hdr: bytes) -> np.ndarray:
    """qform affine per the NIFTI-1 quaternion convention."""
    b, c, d, qx, qy, qz = struct.unpack_from("<6f", hdr, 256)
    pixdim = struct.unpack_from("<8f", hdr, 76)
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d,
         2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d,
         2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b,
         a * a + d * d - c * c - b * b],
    ])
    qfac = -1.0 if pixdim[0] == -1.0 else 1.0
    zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * zooms
    aff[:3, 3] = [qx, qy, qz]
    return aff


def load(path: str, dtype=np.float32) -> NiftiImage:
    """Read a .nii / .nii.gz volume.

    dtype=None returns the on-disk dtype unscaled; otherwise the data is
    converted and scl_slope/scl_inter applied (nibabel get_fdata semantics).
    """
    raw = _read_bytes(path)
    hdr = raw[:348]
    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a little-endian NIFTI-1 file "
                         f"(sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from("<8h", hdr, 40)
    ndim = dim[0]
    shape = tuple(int(v) for v in dim[1:1 + ndim])
    (datatype,) = struct.unpack_from("<h", hdr, 70)
    (vox_offset,) = struct.unpack_from("<f", hdr, 108)
    slope, inter = struct.unpack_from("<2f", hdr, 112)
    qform_code, sform_code = struct.unpack_from("<2h", hdr, 252)

    if sform_code > 0:
        srow = struct.unpack_from("<12f", hdr, 280)
        affine = np.eye(4)
        affine[:3, :4] = np.asarray(srow, dtype=np.float64).reshape(3, 4)
    elif qform_code > 0:
        affine = _quaternion_affine(hdr)
    else:
        pixdim = struct.unpack_from("<8f", hdr, 76)
        affine = np.diag([pixdim[1], pixdim[2], pixdim[3], 1.0])

    if datatype not in _CODE_TO_DTYPE:
        raise ValueError(f"{path}: unsupported NIFTI datatype code {datatype}")
    disk_dtype = _CODE_TO_DTYPE[datatype]
    count = int(np.prod(shape)) if shape else 0
    payload = raw[int(vox_offset):int(vox_offset) + count * disk_dtype.itemsize]
    flat = np.frombuffer(payload, dtype=disk_dtype, count=count)

    if dtype is None:
        return NiftiImage(flat.reshape(shape, order="F").copy(), affine)

    # nibabel semantics: a non-finite or zero scl_slope means "no scaling"
    use_scl = np.isfinite(slope) and slope != 0.0 and np.isfinite(inter)
    eff_slope = slope if use_scl else 1.0
    eff_inter = inter if use_scl else 0.0
    flat = (flat.astype(np.float32) * np.float32(eff_slope)
            + np.float32(eff_inter))
    arr = flat.reshape(shape, order="F").astype(dtype, copy=False)
    return NiftiImage(arr, affine)


def save(img: NiftiImage, path: str) -> None:
    """Write a NIFTI-1 file (.nii or .nii.gz by extension), sform affine."""
    data = np.asarray(img.data)
    affine = np.asarray(img.affine, dtype=np.float64)
    if data.dtype not in _DTYPE_TO_CODE:
        data = data.astype(np.float32)
    code = _DTYPE_TO_CODE[data.dtype]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *zooms, *([1.0] * 4))
    struct.pack_into("<f", hdr, 108, float(_HDR_SIZE))  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope / inter
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code=0, sform_code=1
    struct.pack_into("<12f", hdr, 280, *affine[:3, :4].reshape(-1))
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + data.tobytes(order="F")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        if path.endswith(".gz"):
            with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
                gz.write(payload)
        else:
            f.write(payload)


# --- orientation (nibabel io_orientation / apply_orientation arithmetic) ---

_POS_LETTER = {0: "R", 1: "A", 2: "S"}
_LETTER_TO_AXIS = {"R": (0, 1), "L": (0, -1), "A": (1, 1), "P": (1, -1),
                   "S": (2, 1), "I": (2, -1)}


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """(3, 2) array: row j = (world axis that voxel axis j most moves, sign).

    RAS-oriented affines give [[0,1],[1,1],[2,1]] (nibabel convention).
    Greedy max-|cosine| assignment: exact for axis-aligned affines, best fit
    for oblique ones."""
    R = np.asarray(affine, dtype=np.float64)[:3, :3].copy()
    norms = np.sqrt((R ** 2).sum(axis=0))
    norms[norms == 0] = 1.0
    C = np.abs(R / norms)
    ornt = np.zeros((3, 2), dtype=np.int64)
    used_rows, used_cols = set(), set()
    for _ in range(3):
        best, bj, bi = -1.0, -1, -1
        for j in range(3):           # voxel axis (column)
            if j in used_cols:
                continue
            for i in range(3):       # world axis (row)
                if i in used_rows:
                    continue
                if C[i, j] > best:
                    best, bj, bi = C[i, j], j, i
        used_cols.add(bj)
        used_rows.add(bi)
        ornt[bj] = (bi, 1 if R[bi, bj] >= 0 else -1)
    return ornt


def _axcodes_to_ornt(axcodes: str) -> np.ndarray:
    """Desired orientation: row k = (world axis of OUTPUT voxel axis k, sign)."""
    return np.asarray([_LETTER_TO_AXIS[ch] for ch in axcodes], dtype=np.int64)


def ornt_to_axcodes(ornt: np.ndarray) -> str:
    out = []
    for axis, sign in ornt:
        letter = _POS_LETTER[int(axis)]
        if sign < 0:
            letter = {"R": "L", "A": "P", "S": "I"}[letter]
        out.append(letter)
    return "".join(out)


def reorient_to(data: np.ndarray, affine: np.ndarray, axcodes: str = "RAS"
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Permute/flip the first three axes of `data` so the volume is in
    `axcodes` orientation. Returns (new_data, new_affine, original_ornt);
    the new affine maps every voxel to the same world point as before
    (MONAI Orientationd semantics)."""
    ornt = io_orientation(affine)
    dst = _axcodes_to_ornt(axcodes)
    perm = [0, 0, 0]
    flips = [False, False, False]
    for j in range(3):  # input voxel axis j
        w, s = int(ornt[j, 0]), int(ornt[j, 1])
        k = int(np.nonzero(dst[:, 0] == w)[0][0])  # output axis for world w
        perm[k] = j
        flips[k] = s != int(dst[k, 1])

    axes = perm + list(range(3, data.ndim))
    new_data = np.transpose(data, axes)
    for k in range(3):
        if flips[k]:
            new_data = np.flip(new_data, axis=k)
    new_data = np.ascontiguousarray(new_data)

    # T maps new voxel indices -> old voxel indices; new_aff = aff @ T.
    T = np.zeros((4, 4))
    T[3, 3] = 1.0
    for k in range(3):
        j = perm[k]
        if flips[k]:
            T[j, k] = -1.0
            T[j, 3] = data.shape[j] - 1
        else:
            T[j, k] = 1.0
    new_affine = np.asarray(affine, dtype=np.float64) @ T
    return new_data, new_affine, ornt


def write_labelmap(data: np.ndarray, path: str, affine: np.ndarray,
                   target_affine: Optional[np.ndarray] = None,
                   target_shape: Optional[Sequence[int]] = None) -> None:
    """Export a labelmap, mapping it from its current `affine` back onto the
    grid of `target_affine` (the original on-disk affine recorded at load):
    the MONAI NiftiSaver round trip.

    Orientation-only differences are undone exactly by axis permutation and
    flips. If the affines still differ after that (a Spacing transform
    changed the voxel size), the labelmap is resampled nearest-neighbour
    onto the target grid of shape `target_shape` (the recorded original
    spatial shape) or, when absent, the reoriented data shape."""
    arr = np.asarray(data)
    if target_affine is not None:
        axcodes = ornt_to_axcodes(io_orientation(target_affine))
        arr, new_affine, _ = reorient_to(arr, affine, axcodes)
        out_affine = np.asarray(target_affine, dtype=np.float64)
        if not np.allclose(new_affine, out_affine, atol=1e-3):
            # new voxel index -> world (target) -> voxel (data)
            from scipy import ndimage
            vox_map = (np.linalg.inv(np.asarray(new_affine, np.float64))
                       @ out_affine)
            out_shape = tuple(int(s) for s in (
                target_shape if target_shape is not None else arr.shape[:3]))
            chans = arr.reshape(*arr.shape[:3], -1)
            res = np.stack([
                ndimage.affine_transform(
                    chans[..., c].astype(np.float32), vox_map[:3, :3],
                    offset=vox_map[:3, 3], output_shape=out_shape,
                    order=0, mode="constant")
                for c in range(chans.shape[-1])], axis=-1)
            arr = res.reshape(out_shape + arr.shape[3:])
    else:
        out_affine = np.asarray(affine, dtype=np.float64)
    if (arr >= 0).all() and (arr < 256).all() and np.all(np.mod(arr, 1) == 0):
        arr = arr.astype(np.uint8)
    save(NiftiImage(arr, out_affine), path)
