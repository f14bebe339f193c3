"""Device-resident training pipeline: the counterpart of
vs_seg_tpu/data/device_pipeline.py. The (padded) training set is cached on
the device once, and each batch is cropped and L-R flipped there.

Replaces the per-step host path (random crop and flip on the CPU, then a
host-to-device copy of each crop; reference DataLoader + .to(device),
params/VSparams.py:311-318, 456): volumes upload once, and a step moves no
voxel between host and device and waits for nothing on the device. The
crop starts and flips are drawn on the host from a numpy Generator, so they
reach the device only as slice bounds. Semantics match the host transforms
(RandSpatialCrop random_center + RandFlipd axis 0 = H; tests pin both to
the host transforms and to the JAX package's `_gather`).

Heterogeneous volume shapes (SpatialPad only enforces a lower bound) are
end-padded to the elementwise largest shape in one preallocated device
tensor, filled volume by volume; crop starts are drawn within each volume's
true extent, so padding is never sampled. The flip is applied to the
cropped window: flipping the crop at start h0 equals cropping the flipped
volume at start H - ch - h0, so for a uniform start the two orders draw the
same distribution.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from vs_seg_tpu_torch.core.device import resolve_device


class DeviceCachedDataset:
    """Samples ((C, H, W, D) host dicts, e.g. CacheDataset.cache after the
    deterministic pad prefix) cached on `device` as (N, D, H, W, C): images
    in bf16 (JAX's default), labels in uint8.
    `crop_shape` is reference-order (H, W, D), as pad_crop_shape.

    `augment=False` never flips (validation crops at random, like the
    reference val pipeline, but never flips)."""

    def __init__(self, samples: Sequence[dict],
                 crop_shape: Tuple[int, int, int], *, device,
                 augment: bool = True):
        self.device = resolve_device(device)
        shapes = [np.shape(s["image"]) for s in samples]
        # per-volume true extent, (D, H, W)
        self.extents = np.asarray([(s[3], s[1], s[2]) for s in shapes],
                                  np.int64)
        ch, cw, cd = (int(v) for v in crop_shape)
        self.crop_dhw = (cd, ch, cw)
        self.augment = bool(augment)
        for i, ext in enumerate(self.extents):
            if (ext < self.crop_dhw).any():
                raise ValueError(
                    f"volume {i} extent {tuple(ext)} (D, H, W) is smaller "
                    f"than the crop {self.crop_dhw}: SpatialPad should have "
                    "padded it")
        n = len(samples)
        big = tuple(int(v) for v in self.extents.max(axis=0))
        n_lbl = np.shape(samples[0]["label"])[0]
        self.images = torch.zeros((n, *big, shapes[0][0]),
                                  dtype=torch.bfloat16, device=self.device)
        self.labels = torch.zeros((n, *big, n_lbl), dtype=torch.uint8,
                                  device=self.device)
        # volume by volume: the host holds one cast volume at a time
        for i, s in enumerate(samples):
            d, h, w = (int(v) for v in self.extents[i])
            for dst, arr in ((self.images, s["image"]),
                             (self.labels, s["label"])):
                host = torch.from_numpy(np.ascontiguousarray(arr)).permute(
                    3, 1, 2, 0)
                dst[i, :d, :h, :w].copy_(host.to(
                    dst.dtype, memory_format=torch.contiguous_format))

    def __len__(self) -> int:
        return int(self.images.shape[0])

    def draw(self, index, rng: np.random.Generator
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Host draws for the volumes `index`: (B, 3) crop starts (d0, h0,
        w0), each uniform within its volume's true extent, and (B,) flips
        (p = 0.5; none unless augment)."""
        idx = np.atleast_1d(np.asarray(index, np.int64))
        high = self.extents[idx] - np.asarray(self.crop_dhw) + 1
        starts = rng.integers(0, high)
        flips = (rng.random(len(idx)) < 0.5 if self.augment
                 else np.zeros(len(idx), bool))
        return starts, flips

    def crop(self, index, starts, flips) -> Tuple[torch.Tensor, torch.Tensor]:
        """((B, cd, ch, cw, C) image, label) on the device: volume
        index[b] cropped at starts[b] = (d0, h0, w0), then flipped along H
        where flips[b]. The bounds are host integers: no sync, no copy
        from the host."""
        idx = np.atleast_1d(np.asarray(index, np.int64))
        starts = np.asarray(starts, np.int64).reshape(len(idx), 3)
        flips = np.asarray(flips, bool).reshape(len(idx))
        high = self.extents[idx] - np.asarray(self.crop_dhw)
        if (starts < 0).any() or (starts > high).any():
            raise ValueError(f"crop starts {starts.tolist()} outside "
                             f"[0, {high.tolist()}]")
        cd, ch, cw = self.crop_dhw
        images, labels = [], []
        for i, (d0, h0, w0), flip in zip(idx.tolist(), starts.tolist(),
                                         flips.tolist()):
            win = (i, slice(d0, d0 + cd), slice(h0, h0 + ch),
                   slice(w0, w0 + cw))
            img, lbl = self.images[win], self.labels[win]
            if flip:
                img, lbl = img.flip(1), lbl.flip(1)
            images.append(img)
            labels.append(lbl)
        return torch.stack(images), torch.stack(labels)

    def sample(self, index, rng: np.random.Generator):
        """crop(index, *draw(index, rng))."""
        return self.crop(index, *self.draw(index, rng))


class DeviceLoader:
    """Epoch iterable over a DeviceCachedDataset: yields (image, label)
    device tuples. Every epoch takes a fresh shuffle order and fresh crop
    and flip draws from np.random.default_rng([seed, epoch]) (the order is
    JAX's, vs_seg_tpu/data/device_pipeline.py:125). The final partial batch
    is yielded (torch DataLoader drop_last=False semantics).

    With `ranks` (parallel/distributed.py:Ranks) every rank draws the order
    and the crop and flip draws of the whole batch, so the generator
    advances alike on every rank, and crops only its rows (Ranks.rows):
    it yields (image, label, replicated)."""

    def __init__(self, dataset: DeviceCachedDataset, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 0, ranks=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.ranks = ranks
        self._epoch = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        n = len(self.dataset)
        rng = np.random.default_rng([self.seed, epoch])
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.ranks is None:
                yield self.dataset.sample(idx, rng)
                continue
            starts, flips = self.dataset.draw(idx, rng)
            rows, replicated = self.ranks.rows(len(idx))
            yield (*self.dataset.crop(idx[rows], starts[rows], flips[rows]),
                   replicated)
