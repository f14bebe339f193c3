"""MONAI-0.4-semantics dictionary transforms (host side, numpy): the port's
copy of vs_seg_tpu/data/transforms.py, the three pipelines of the reference
`get_transforms`:
  train: LoadNiftid -> AddChanneld -> Orientationd(RAS) -> NormalizeIntensityd
         (image only) -> SpatialPadd -> RandFlipd(p=0.5, axis 0)
         -> RandSpatialCropd(random_center, fixed size)
  val:   train minus RandFlipd
  test:  no pad/crop (whole volumes)

Layout is MONAI-style (C, H, W, D) on the host; every array transform keeps
the channel dim first. Randomness is an explicit numpy Generator argument.
Each transform class carries `is_random`; Compose and CacheDataset use it to
split the deterministic (cacheable) prefix from the per-fetch random suffix,
the caching contract of monai.data.CacheDataset.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from vs_seg_tpu_torch.data import nifti

DEFAULT_KEYS = ("image", "label")


class LoadNifti:
    """LoadNiftid: path -> float32 array (H, W, D) + meta dict with the
    affine, original_affine and filename (reference params/VSparams.py:210)."""

    is_random = False

    def __init__(self, keys: Sequence[str] = DEFAULT_KEYS):
        self.keys = tuple(keys)

    def __call__(self, sample: dict, rng=None) -> dict:
        sample = dict(sample)
        for key in self.keys:
            path = sample[key]
            img = nifti.load(path)
            sample[key] = img.data
            sample[f"{key}_meta"] = {
                "affine": img.affine,
                "original_affine": img.affine.copy(),
                "spatial_shape": tuple(img.data.shape[:3]),
                "filename_or_obj": path,
            }
        return sample


class AddChannel:
    """AddChanneld: prepend the channel dim (VSparams.py:211)."""

    is_random = False

    def __init__(self, keys: Sequence[str] = DEFAULT_KEYS):
        self.keys = tuple(keys)

    def __call__(self, sample: dict, rng=None) -> dict:
        sample = dict(sample)
        for key in self.keys:
            sample[key] = sample[key][None]
        return sample


class Orientation:
    """Orientationd(axcodes="RAS"): reorient (C, *spatial) to the requested
    orientation and update the meta affine (VSparams.py:212). The
    original_affine stays untouched for the export round-trip."""

    is_random = False

    def __init__(self, keys: Sequence[str] = DEFAULT_KEYS, axcodes: str = "RAS"):
        self.keys = tuple(keys)
        self.axcodes = axcodes

    def __call__(self, sample: dict, rng=None) -> dict:
        sample = dict(sample)
        for key in self.keys:
            meta = dict(sample[f"{key}_meta"])
            arr = sample[key]
            # channel-first: reorient the spatial dims (move C last, back again)
            spatial_first = np.moveaxis(arr, 0, -1)
            new_data, new_affine, _ = nifti.reorient_to(
                spatial_first, meta["affine"], self.axcodes)
            sample[key] = np.ascontiguousarray(np.moveaxis(new_data, -1, 0))
            meta["affine"] = new_affine
            sample[f"{key}_meta"] = meta
        return sample


class NormalizeIntensity:
    """NormalizeIntensityd, MONAI 0.4 defaults: whole-volume (x - mean) / std,
    nonzero=False, channel_wise=False; image key only (VSparams.py:213)."""

    is_random = False

    def __init__(self, keys: Sequence[str] = ("image",)):
        self.keys = tuple(keys)

    def __call__(self, sample: dict, rng=None) -> dict:
        sample = dict(sample)
        for key in self.keys:
            arr = np.asarray(sample[key], dtype=np.float32)
            std = arr.std()
            sample[key] = (arr - arr.mean()) / (std if std > 0 else 1.0)
        return sample


class SpatialPad:
    """SpatialPadd(method="symmetric"): zero-pad each spatial dim up to at
    least `spatial_size`; no-op on dims already large enough
    (VSparams.py:214). Floor-half before, remainder after (MONAI 0.4)."""

    is_random = False

    def __init__(self, spatial_size: Tuple[int, ...],
                 keys: Sequence[str] = DEFAULT_KEYS):
        self.spatial_size = tuple(spatial_size)
        self.keys = tuple(keys)

    def __call__(self, sample: dict, rng=None) -> dict:
        sample = dict(sample)
        for key in self.keys:
            arr = sample[key]
            pads = [(0, 0)]
            for dim, want in zip(arr.shape[1:], self.spatial_size):
                extra = max(0, want - dim)
                pads.append((extra // 2, extra - extra // 2))
            if any(p != (0, 0) for p in pads):
                arr = np.pad(arr, pads)
            sample[key] = arr
        return sample


class RandFlip:
    """RandFlipd(prob, spatial_axis=0): joint L-R flip of all keys
    (VSparams.py:215)."""

    is_random = True

    def __init__(self, prob: float = 0.5, spatial_axis: int = 0,
                 keys: Sequence[str] = DEFAULT_KEYS):
        self.prob = prob
        self.spatial_axis = spatial_axis
        self.keys = tuple(keys)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        sample = dict(sample)
        if rng.random() < self.prob:
            axis = self.spatial_axis + 1  # channel-first layout
            for key in self.keys:
                sample[key] = np.ascontiguousarray(np.flip(sample[key], axis))
        return sample


class RandSpatialCrop:
    """RandSpatialCropd(roi_size, random_center=True, random_size=False):
    one random fixed-size crop shared by all keys; identity on dims where
    size == roi (VSparams.py:216-218)."""

    is_random = True

    def __init__(self, roi_size: Tuple[int, ...],
                 keys: Sequence[str] = DEFAULT_KEYS):
        self.roi_size = tuple(roi_size)
        self.keys = tuple(keys)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        sample = dict(sample)
        shape = sample[self.keys[0]].shape[1:]
        starts = []
        for dim, roi in zip(shape, self.roi_size):
            roi = min(roi, dim)
            starts.append(int(rng.integers(0, dim - roi + 1)) if dim > roi else 0)
        slices = (slice(None),) + tuple(
            slice(s, s + min(r, d))
            for s, r, d in zip(starts, self.roi_size, shape))
        for key in self.keys:
            sample[key] = np.ascontiguousarray(sample[key][slices])
        return sample


class Spacing:
    """Spacingd-equivalent voxel resampling to isotropic/explicit pixdim:
    linear for images, nearest for labels; updates the meta affine zooms.
    (Not in the reference pipelines, whose dataset is already resampled;
    kept for protocol parity with MONAI pipelines.)"""

    is_random = False

    def __init__(self, pixdim: Tuple[float, float, float],
                 keys: Sequence[str] = DEFAULT_KEYS):
        self.pixdim = tuple(float(v) for v in pixdim)
        self.keys = tuple(keys)

    def __call__(self, sample: dict, rng=None) -> dict:
        from scipy import ndimage
        sample = dict(sample)
        for key in self.keys:
            if key not in sample:
                continue
            arr = sample[key]
            meta = dict(sample[f"{key}_meta"])
            aff = np.asarray(meta["affine"], dtype=np.float64)
            old_zooms = np.sqrt((aff[:3, :3] ** 2).sum(axis=0))
            scale = old_zooms / np.asarray(self.pixdim)
            new_shape = tuple(int(max(1, round(d * s)))
                              for d, s in zip(arr.shape[1:], scale))
            order = 0 if key == "label" else 1
            matrix = np.diag(1.0 / scale)  # output idx -> source idx
            out = np.stack([
                ndimage.affine_transform(np.asarray(c, dtype=np.float32),
                                         matrix, output_shape=new_shape,
                                         order=order, mode="constant")
                for c in arr])
            new_aff = aff.copy()
            new_aff[:3, :3] = aff[:3, :3] / scale[None, :]
            meta["affine"] = new_aff
            sample[key] = out.astype(np.float32)
            sample[f"{key}_meta"] = meta
        return sample


class Compose:
    """Apply transforms in order; random ones receive the numpy Generator."""

    def __init__(self, transforms: Sequence):
        self.transforms = tuple(transforms)

    def __call__(self, sample: dict, rng: Optional[np.random.Generator] = None
                 ) -> dict:
        if rng is None:
            rng = np.random.default_rng()
        for t in self.transforms:
            sample = t(sample, rng) if t.is_random else t(sample)
        return sample

    def deterministic_prefix_split(self) -> Tuple[Tuple, Tuple]:
        """(cacheable prefix, per-fetch suffix): everything before the first
        random transform is deterministic — the CacheDataset contract
        (reference monai.data.CacheDataset, VSparams.py:305-335)."""
        for i, t in enumerate(self.transforms):
            if t.is_random:
                return self.transforms[:i], self.transforms[i:]
        return self.transforms, ()


def get_transforms(pad_crop_shape: Tuple[int, int, int]
                   ) -> Tuple[Compose, Compose, Compose]:
    """The three reference pipelines (params/VSparams.py:205-247)."""
    train = Compose([
        LoadNifti(),
        AddChannel(),
        Orientation(axcodes="RAS"),
        NormalizeIntensity(keys=("image",)),
        SpatialPad(pad_crop_shape),
        RandFlip(prob=0.5, spatial_axis=0),
        RandSpatialCrop(pad_crop_shape),
    ])
    val = Compose([
        LoadNifti(),
        AddChannel(),
        Orientation(axcodes="RAS"),
        NormalizeIntensity(keys=("image",)),
        SpatialPad(pad_crop_shape),
        RandSpatialCrop(pad_crop_shape),
    ])
    test = Compose([
        LoadNifti(),
        AddChannel(),
        Orientation(axcodes="RAS"),
        NormalizeIntensity(keys=("image",)),
    ])
    return train, val, test
