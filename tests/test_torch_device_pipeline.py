"""The device-resident training cache (data/device_pipeline.py) against the
JAX package's (vs_seg_tpu/data/device_pipeline.py) and the host
transforms, on the CPU.

Everything here is compared bit for bit: the cached volumes, crops and
flips are copies and casts of the same numpy inputs (bf16 by
round-to-nearest-even on both sides), never arithmetic. JAX draws its crop
starts and flips on the device from a key; the port takes them from the
host, so the tests derive JAX's draws from its key by the same
jax.random.split / randint / bernoulli calls as `_gather` and hand them to
the port's `crop`.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model import SMALL
from vs_seg_tpu.data import device_pipeline as jdp
from vs_seg_tpu_torch.core.config import Config
from vs_seg_tpu_torch.data import device_pipeline as tdp
from vs_seg_tpu_torch.data.transforms import Compose, RandFlip, RandSpatialCrop
from vs_seg_tpu_torch.models import build_model
from vs_seg_tpu_torch.train import trainer as ttrainer
from vs_seg_tpu_torch.train.trainer import to_device_batch

CROP = (8, 8, 4)                      # (H, W, D)
SHAPES = [(20, 18, 10), (24, 18, 12), (20, 22, 10)]


def _samples(seed, shapes=SHAPES, offset=0.0):
    """Host (C, H, W, D) samples as CacheDataset.cache holds them."""
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(1, *s)).astype(np.float32) + offset,
             "label": (rng.random((1, *s)) > 0.7).astype(np.float32)}
            for s in shapes]


def _np(t):
    return t.float().numpy()


def _jax_draws(ds, idx, key):
    """The starts (d0, h0, w0) and flips that JAX's _gather draws for
    volumes `idx` under `key` (DeviceCachedDataset.sample)."""
    cd, ch, cw = ds.crop_dhw
    starts, flips = [], []
    for i, k in zip(idx, jax.random.split(key, len(idx))):
        kd, kh, kw, kf = jax.random.split(k, 4)
        d, h, w = (jnp.int32(v) for v in np.asarray(ds.extents)[i])
        starts.append([int(jax.random.randint(kd, (), 0, d - cd + 1)),
                       int(jax.random.randint(kh, (), 0, h - ch + 1)),
                       int(jax.random.randint(kw, (), 0, w - cw + 1))])
        flips.append(bool(jax.random.bernoulli(kf)) and ds.augment)
    return starts, flips


def test_cache_is_the_end_padded_stack_of_jax():
    """Images (bf16) and labels (uint8), end-padded to the largest extent:
    the same bytes as JAX's cached arrays."""
    samples = _samples(0)
    j = jdp.DeviceCachedDataset(samples, CROP)
    t = tdp.DeviceCachedDataset(samples, CROP, device="cpu")
    assert t.images.dtype == torch.bfloat16 and t.labels.dtype == torch.uint8
    assert tuple(t.images.shape) == (3, 12, 24, 22, 1)
    np.testing.assert_array_equal(_np(t.images),
                                  np.asarray(j.images, np.float32))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_array_equal(t.extents, np.asarray(j.extents))


@pytest.mark.parametrize("augment", [True, False])
def test_crop_at_jax_draws_matches_jax_gather(augment):
    """At the draws JAX's key gives, the port's crop and flip equal JAX's
    DeviceCachedDataset.sample bit for bit, on batches of one and three."""
    samples = _samples(1)
    j = jdp.DeviceCachedDataset(samples, CROP, augment=augment)
    t = tdp.DeviceCachedDataset(samples, CROP, device="cpu",
                                augment=augment)
    seen = set()
    for seed in range(8):
        for idx in ([seed % 3], [2, 0, 1]):
            key = jax.random.key(seed)
            ji, jl = j.sample(np.asarray(idx), key)
            starts, flips = _jax_draws(j, idx, key)
            seen.update(flips)
            ti, tl = t.crop(idx, starts, flips)
            assert tuple(ti.shape) == (len(idx), 4, 8, 8, 1)
            np.testing.assert_array_equal(_np(ti), np.asarray(ji, np.float32))
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert seen == ({False, True} if augment else {False})


def test_crop_at_host_draws_matches_the_host_transforms():
    """The train transforms' random suffix (RandFlip, then RandSpatialCrop
    of the flipped volume) against the port's crop at the same draws: a
    host flip then a crop at h0 is the crop at H - ch - h0, then a flip.
    The bf16 cache's crop equals to_device_batch of the host crop cast to
    bf16."""
    samples = _samples(2)
    flip, crop = RandFlip(prob=0.5, spatial_axis=0), RandSpatialCrop(CROP)
    ds = tdp.DeviceCachedDataset(samples, CROP, device="cpu")
    flips = set()
    for seed in range(10):
        i = seed % 3
        host = Compose([flip, crop])(samples[i], np.random.default_rng(seed))
        # the host's draws, read back from a generator in the same state
        # (every dim is larger than the crop, so each takes one draw)
        rng = np.random.default_rng(seed)
        flipped = bool(rng.random() < 0.5)
        _, H, W, D = samples[i]["image"].shape
        h0, w0, d0 = (int(rng.integers(0, n - c + 1))
                      for n, c in zip((H, W, D), CROP))
        if flipped:
            h0 = H - CROP[0] - h0
        flips.add(flipped)
        img, lbl = ds.crop([i], [(d0, h0, w0)], [flipped])
        ref_img, ref_lbl = to_device_batch(
            {"image": host["image"][None], "label": host["label"][None]},
            "cpu", torch.bfloat16)
        assert torch.equal(img, ref_img) and torch.equal(lbl, ref_lbl)
    assert flips == {False, True}


def test_crops_never_touch_the_padding():
    """Heterogeneous extents (SpatialPad only lower-bounds them): every
    draw stays within its own volume's extent, so no crop sees the zero
    end-padding (the images are >> 0)."""
    samples = _samples(3, offset=10.0)
    ds = tdp.DeviceCachedDataset(samples, CROP, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(40):
        idx = rng.integers(0, 3, size=2)
        starts, _ = ds.draw(idx, rng)
        assert (starts <= ds.extents[idx] - (4, 8, 8)).all()
        img, _ = ds.crop(idx, starts, [False, False])
        assert float(img.float().min()) > 1.0
    # the last start the smallest volume allows reaches its edge
    assert float(ds.crop([0], [(6, 12, 10)], [False])[0].float().min()) > 1
    with pytest.raises(ValueError, match="outside"):
        ds.crop([0], [(7, 12, 10)], [False])
    with pytest.raises(ValueError, match="smaller than the crop"):
        tdp.DeviceCachedDataset(samples, (8, 8, 11), device="cpu")


def test_no_augment_never_flips():
    """augment=False (validation): the draws never flip, and each crop is
    the plain window of the cached volume."""
    samples = _samples(4)
    ds = tdp.DeviceCachedDataset(samples, CROP, device="cpu", augment=False)
    loader = tdp.DeviceLoader(ds, batch_size=1, seed=1)
    rng = np.random.default_rng(1)
    for _ in range(20):
        starts, flips = ds.draw([1], rng)
        assert not flips.any()
        d0, h0, w0 = starts[0]
        img, _ = ds.crop([1], starts, flips)
        assert torch.equal(img[0], ds.images[1, d0:d0 + 4, h0:h0 + 8,
                                             w0:w0 + 8])
    for _ in range(3):
        assert len(list(loader)) == 3


def _ids(batch):
    """The volumes a batch's crops came from: volume i is filled with
    i + 1."""
    arr = (batch.float().numpy() if isinstance(batch, torch.Tensor)
           else np.asarray(batch, np.float32))
    return [int(v) for v in arr.reshape(len(arr), -1)[:, 0]]


def test_loader_order_matches_jax_and_epochs_differ():
    """The shuffle order of each epoch is JAX's (np default_rng([seed,
    epoch])); epochs differ; the last partial batch is yielded."""
    n = 7
    samples = [{"image": np.full((1, 10, 10, 6), i + 1, np.float32),
                "label": np.zeros((1, 10, 10, 6), np.float32)}
               for i in range(n)]
    crop = (8, 8, 4)
    j = jdp.DeviceLoader(jdp.DeviceCachedDataset(samples, crop),
                         batch_size=3, shuffle=True, seed=5)
    t = tdp.DeviceLoader(tdp.DeviceCachedDataset(samples, crop, device="cpu"),
                         batch_size=3, shuffle=True, seed=5)
    orders = []
    for _ in range(3):
        jb = [img for img, _ in j]
        tb = [img for img, _ in t]
        assert [b.shape[0] for b in tb] == [b.shape[0] for b in jb] == [3, 3,
                                                                        1]
        order = sum((_ids(b) for b in tb), [])
        jorder = sum((_ids(b) for b in jb), [])
        assert order == jorder and sorted(order) == list(range(1, n + 1))
        orders.append(order)
    assert orders[0] != orders[1] != orders[2]
    assert len(t) == 3


def test_loader_draws_are_seeded_by_seed_and_epoch():
    samples = _samples(5)
    ds = tdp.DeviceCachedDataset(samples, CROP, device="cpu")
    a = [img for img, _ in tdp.DeviceLoader(ds, shuffle=True, seed=2)]
    loader = tdp.DeviceLoader(ds, shuffle=True, seed=2)
    b = [img for img, _ in loader]
    c = [img for img, _ in loader]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(b, c))


def test_trainer_fits_through_the_device_loader(tmp_path):
    """Trainer.fit on the SMALL model through DeviceLoaders (bf16 cache,
    float32 compute: the trainer casts on the device): finite losses, a
    validation Dice, checkpoints."""
    cfg = Config(data_root=str(tmp_path), results_folder_name="dp",
                 num_epochs=2, val_interval=1, epochs_with_const_lr=1,
                 pad_crop_shape=(16, 16, 8), compute_dtype="float32",
                 **SMALL)
    samples = _samples(6, shapes=[(20, 18, 10), (16, 16, 8)])
    train = tdp.DeviceLoader(tdp.DeviceCachedDataset(
        samples, cfg.pad_crop_shape, device="cpu"), batch_size=2,
        shuffle=True, seed=0)
    val = tdp.DeviceLoader(tdp.DeviceCachedDataset(
        samples, cfg.pad_crop_shape, device="cpu", augment=False), seed=1)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tr = ttrainer.Trainer(cfg, model, "cpu", logger=logging.getLogger("dp"))
    state, losses, metrics = tr.fit(tr.init_state(), train, val)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert len(metrics) == 2 and np.isfinite(metrics).all()
    assert state["epoch"] == 2
    assert (tmp_path / "results" / "dp" / "model" / "last_epoch_model.ckpt"
            ).is_file()
