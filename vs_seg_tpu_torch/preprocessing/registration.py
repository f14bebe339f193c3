"""Affine registration application, the port's copy of
vs_seg_tpu/preprocessing/registration.py (replaces the reference's Slicer
`register_and_resample`, data_conversion.py:187-214: harden a .tfm transform +
BRAINSResample CLI).

Reads ITK Insight Transform Files (AffineTransform_double_3_3) and resamples a
moving volume onto a fixed volume's grid with scipy. ITK affine semantics:
physical LPS point mapping y = A (x - c) + c + t from FIXED space to MOVING
space (a resampling transform).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

from vs_seg_tpu_torch.data import nifti

_LPS_FLIP = np.diag([-1.0, -1.0, 1.0, 1.0])


def read_itk_tfm(path: str) -> np.ndarray:
    """Parse an ITK .tfm affine into a 4x4 LPS physical-space matrix."""
    params = fixed = None
    transform_type = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("Transform:"):
                transform_type = line.split(":", 1)[1].strip()
            elif line.startswith("Parameters:"):
                params = [float(v) for v in line.split(":", 1)[1].split()]
            elif line.startswith("FixedParameters:"):
                fixed = [float(v) for v in line.split(":", 1)[1].split()]
    if params is None:
        raise ValueError(f"{path}: no Parameters line")
    if transform_type and "AffineTransform" not in transform_type \
            and "MatrixOffsetTransformBase" not in transform_type:
        raise ValueError(f"{path}: unsupported transform {transform_type}")
    A = np.asarray(params[:9], dtype=np.float64).reshape(3, 3)
    t = np.asarray(params[9:12], dtype=np.float64)
    c = np.asarray(fixed[:3] if fixed else [0.0, 0.0, 0.0], dtype=np.float64)
    # y = A(x - c) + c + t  ->  y = A x + (c + t - A c)
    M = np.eye(4)
    M[:3, :3] = A
    M[:3, 3] = c + t - A @ c
    return M


def resample_to_reference(moving: nifti.NiftiImage,
                          reference: nifti.NiftiImage,
                          tfm_lps: np.ndarray = None,
                          order: int = 1) -> nifti.NiftiImage:
    """Resample `moving` onto `reference`'s grid, optionally applying an ITK
    affine (LPS physical space, fixed->moving). Returns a NiftiImage on the
    reference grid with the reference affine.

    Voxel mapping: ref_idx -> ref_world(RAS) -> LPS -> tfm -> LPS -> RAS
    -> moving_idx.
    """
    if tfm_lps is None:
        tfm_lps = np.eye(4)
    ref_aff = np.asarray(reference.affine)
    mov_aff = np.asarray(moving.affine)
    # full voxel-to-voxel map
    vox_map = (np.linalg.inv(mov_aff) @ _LPS_FLIP @ tfm_lps @ _LPS_FLIP @ ref_aff)
    out = ndimage.affine_transform(
        np.asarray(moving.data, dtype=np.float32),
        vox_map[:3, :3], offset=vox_map[:3, 3],
        output_shape=reference.data.shape[:3], order=order, mode="constant")
    return nifti.NiftiImage(out.astype(np.float32), ref_aff.copy())
