"""The inference CLI's slice of the port against the JAX package, on the CPU:
the data layer (NIFTI IO, orientation, labelmap export, synthetic data,
transforms, the cached loader), the msgpack checkpoint reader, the bucketed
and bf16 staging, `run_inference` and `cli.inference.main`.

Data is written by both packages' `generate_dataset` (48x48x16 cases, a
non-RAS affine). Tolerances: file bytes, arrays, batches and staged buffers
are equal bit for bit (the same numpy arithmetic); run_inference at the
tests/test_end_to_end.py tiny config in float32, the port on weights carried
from JAX: Dice within 1e-5 per case (only the order of the sums differs) and
exported labelmaps agreeing on >= 99.9 % of voxels; the CLI's three
checkpoint kinds, the same weights: the same Dice as run_inference on them.
"""

import dataclasses
import os
import shutil
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tests.torch_replica import TorchUNet2d5_spvPA
from vs_seg_tpu.compat.torch_import import import_unet2d5_spvpa as jimport
from vs_seg_tpu.core.config import Config as JConfig
from vs_seg_tpu.core.config import add_reference_cli_flags as jflags
from vs_seg_tpu.data import dataset as jdataset
from vs_seg_tpu.data import nifti as jnifti
from vs_seg_tpu.data import synthetic as jsynthetic
from vs_seg_tpu.data import transforms as jtransforms
from vs_seg_tpu.infer import sliding_window as jsw
from vs_seg_tpu.infer.engine import run_inference as jrun_inference
from vs_seg_tpu.models import build_model as jbuild_model
from vs_seg_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from vs_seg_tpu.train.trainer import init_model
from vs_seg_tpu_torch.cli import inference
from vs_seg_tpu_torch.compat import jax_ckpt, load_jax_variables
from vs_seg_tpu_torch.core import config as tconfig
from vs_seg_tpu_torch.core.config import Routes
from vs_seg_tpu_torch.core.runlog import create_results_folders
from vs_seg_tpu_torch.data import dataset as tdataset
from vs_seg_tpu_torch.data import nifti as tnifti
from vs_seg_tpu_torch.data import synthetic as tsynthetic
from vs_seg_tpu_torch.data import transforms as ttransforms
from vs_seg_tpu_torch.infer import sliding_window as tsw
from vs_seg_tpu_torch.infer.engine import run_inference
from vs_seg_tpu_torch.models import build_model
from vs_seg_tpu_torch.ops import dsconv
from vs_seg_tpu_torch.train.checkpoint import load_model_state, save_checkpoint

REPO = Path(__file__).resolve().parents[1]
SHAPE = (48, 48, 16)


def _files(root):
    root = Path(root)
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX root, port root): the same synthetic dataset from each
    package's generator."""
    out = []
    for gen in (jsynthetic, tsynthetic):
        root = tmp_path_factory.mktemp("vsdata")
        gen.generate_dataset(str(root), n_train=2, n_val=2, n_test=2,
                             shape=SHAPE, seed=0)
        out.append(root)
    return tuple(out)


# ---- data layer -----------------------------------------------------------

def test_generate_dataset_files_byte_equal(roots):
    jroot, troot = roots
    names = _files(jroot)
    assert names == _files(troot) and len(names) == 6 * 4 + 1
    for n in names:
        assert (jroot / n).read_bytes() == (troot / n).read_bytes(), n


@pytest.mark.parametrize("dtype,ext", [("float32", ".nii.gz"),
                                       ("uint8", ".nii.gz"),
                                       ("int16", ".nii"),
                                       ("float64", ".nii")])
def test_save_byte_equal(tmp_path, dtype, ext):
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(7, 5, 3)) * 40).astype(dtype)
    aff = np.array([[0, -1.2, 0, 3], [0.9, 0, 0, -4], [0, 0, 2.5, 7],
                    [0, 0, 0, 1]])
    # the gzip header holds the file's name: same name, two directories
    jnifti.save(jnifti.NiftiImage(data, aff), str(tmp_path / "j" / f"v{ext}"))
    tnifti.save(tnifti.NiftiImage(data, aff), str(tmp_path / "t" / f"v{ext}"))
    assert (tmp_path / "j" / f"v{ext}").read_bytes() == \
        (tmp_path / "t" / f"v{ext}").read_bytes()


def _edit_header(path: Path, variant: str) -> None:
    """Rewrite a .nii header: qform instead of sform, a scaling, or no
    orientation code at all."""
    raw = bytearray(path.read_bytes())
    if variant == "qform":
        struct.pack_into("<2h", raw, 252, 1, 0)
        struct.pack_into("<6f", raw, 256, 0.2, -0.1, 0.3, 4.0, -5.0, 6.0)
        struct.pack_into("<f", raw, 76, -1.0)               # qfac
    elif variant == "scaled":
        struct.pack_into("<2f", raw, 112, 2.0, 0.5)
    elif variant == "none":
        struct.pack_into("<2h", raw, 252, 0, 0)
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("variant", ["sform", "qform", "scaled", "none"])
def test_load_equal(tmp_path, variant):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 300, size=(6, 5, 4)).astype(np.int16)
    aff = np.diag([-1.0, -1.0, 1.5, 1.0])
    path = tmp_path / "v.nii"
    jnifti.save(jnifti.NiftiImage(data, aff), str(path))
    _edit_header(path, variant)
    for dtype in (None, np.float32):
        j = jnifti.load(str(path), dtype=dtype)
        t = tnifti.load(str(path), dtype=dtype)
        assert t.data.dtype == j.data.dtype
        np.testing.assert_array_equal(t.data, j.data)
        np.testing.assert_array_equal(t.affine, j.affine)


AFFINES = {
    "lps": np.diag([-1.0, -1.0, 1.5, 1.0]),
    "permuted": np.array([[0, 0, -2.0, 5], [1.0, 0, 0, -3], [0, -1.5, 0, 2],
                          [0, 0, 0, 1]]),
    "oblique": np.array([[0.9, 0.3, 0, 1], [-0.3, 0.9, 0, 2],
                         [0, 0, 1.2, 3], [0, 0, 0, 1]]),
}


@pytest.mark.parametrize("name", list(AFFINES))
def test_orientation_equal(name):
    aff = AFFINES[name]
    data = np.arange(4 * 5 * 6 * 2, dtype=np.float32).reshape(4, 5, 6, 2)
    np.testing.assert_array_equal(tnifti.io_orientation(aff),
                                  jnifti.io_orientation(aff))
    assert (tnifti.ornt_to_axcodes(tnifti.io_orientation(aff))
            == jnifti.ornt_to_axcodes(jnifti.io_orientation(aff)))
    for axcodes in ("RAS", "LPI", "PSL"):
        got = tnifti.reorient_to(data, aff, axcodes)
        ref = jnifti.reorient_to(data, aff, axcodes)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("branch", ["reorient", "resample"])
def test_write_labelmap_equal(tmp_path, branch):
    """The export round trip to the original grid: by axis permutation and
    flips alone, and through the nearest-neighbour resample (a voxel size
    changed as a Spacing transform would)."""
    original = AFFINES["permuted"]
    label = (np.random.default_rng(2).random((9, 8, 7)) > 0.6).astype(
        np.float32)
    ras, aff, _ = jnifti.reorient_to(label, original, "RAS")
    shape = None
    if branch == "resample":
        aff = aff.copy()
        aff[:3, :3] *= 1.25
        shape = (9, 8, 7)
    for mod, sub in ((jnifti, "j"), (tnifti, "t")):
        mod.write_labelmap(ras, str(tmp_path / sub / "l.nii.gz"), affine=aff,
                           target_affine=original, target_shape=shape)
    assert (tmp_path / "j" / "l.nii.gz").read_bytes() == \
        (tmp_path / "t" / "l.nii.gz").read_bytes()
    out = tnifti.load(str(tmp_path / "t" / "l.nii.gz"), dtype=None)
    assert out.data.dtype == np.uint8 and out.data.shape == (9, 8, 7)
    if branch == "reorient":
        np.testing.assert_array_equal(out.data, label)


def _assert_samples_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            assert set(got[k]) == set(ref[k])
            for mk, mv in ref[k].items():
                np.testing.assert_array_equal(np.asarray(got[k][mk]),
                                              np.asarray(mv))
        elif isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
        else:
            assert got[k] == ref[k]


@pytest.mark.parametrize("pipeline", ["train", "val", "test", "spacing"])
def test_transforms_equal(roots, pipeline):
    jroot, _ = roots
    _, _, files = jdataset.load_split_csv(
        str(jroot / "split_synthetic.csv"), "T1", str(jroot))
    if pipeline == "spacing":
        def pipe(m):
            return m.Compose([m.LoadNifti(), m.AddChannel(),
                              m.Spacing((1.3, 0.8, 2.0))])
    else:
        i = ("train", "val", "test").index(pipeline)

        def pipe(m):
            return m.get_transforms((40, 56, 12))[i]
    ref = pipe(jtransforms)(files[0], np.random.default_rng(5))
    got = pipe(ttransforms)(files[0], np.random.default_rng(5))
    _assert_samples_equal(got, ref)


def test_dataloader_batches_equal(roots):
    jroot, _ = roots
    csv = str(jroot / "split_synthetic.csv")
    loaders = []
    for dmod, tmod in ((jdataset, jtransforms), (tdataset, ttransforms)):
        train, val, _ = dmod.load_split_csv(csv, "T1", str(jroot))
        ds = dmod.CacheDataset(train + val, tmod.get_transforms(
            (32, 32, 16))[0], num_workers=2)
        loaders.append(dmod.DataLoader(ds, batch_size=2, shuffle=True,
                                       seed=3, prefetch=2))
    assert len(loaders[0]) == len(loaders[1]) == 2
    for _ in range(2):      # two epochs: fresh order and draws each
        for ref, got in zip(*loaders):
            _assert_samples_equal(
                {k: got[k] for k in ("image", "label")},
                {k: ref[k] for k in ("image", "label")})
            assert [m["filename_or_obj"] for m in got["image_meta"]] == \
                [m["filename_or_obj"] for m in ref["image_meta"]]


def test_load_split_csv_checks_files(tmp_path, roots):
    jroot, _ = roots
    train, val, test = tdataset.load_split_csv(
        str(jroot / "split_synthetic.csv"), "T2", str(jroot))
    assert (train, val, test) == jdataset.load_split_csv(
        str(jroot / "split_synthetic.csv"), "T2", str(jroot))
    with pytest.raises(FileNotFoundError):
        tdataset.load_split_csv(str(jroot / "split_synthetic.csv"), "T1",
                                str(tmp_path))


# ---- checkpoints ----------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_msgpack_reader_matches_flax(monkeypatch, chunked):
    """flax.serialization.msgpack_serialize of a nested state, scalars of
    every kind included, read back by the port's own decoder; with a small
    MAX_CHUNK_SIZE flax splits every array into chunks."""
    if chunked:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    state = {
        "params": {"down_0": {"unit0": {
            "conv": {"kernel": rng.normal(size=(3, 3, 1, 1, 4)).astype(
                np.float32), "bias": np.arange(4, dtype=np.float32)}}},
            "wide": rng.normal(size=(300,)).astype(np.float32)},
        "batch_stats": {"down_0": {"mean": np.zeros(3, np.float64)}},
        "opt_state": {"count": np.asarray(7, np.int32),
                      "nested": {"0": {}, "1": {"x": np.ones(2, np.int64)}}},
        "rng": np.array([1, 2, 3, 4], np.uint32),
        "bf16": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16),
        "epoch": 12, "neg": -5, "big": 2 ** 40, "small_neg": -200,
        "best_metric": 0.8125, "f32": np.float32(0.25), "i64": np.int64(-3),
        "flag": True, "off": False, "none": None, "name": "x" * 40,
        "blob": b"\x00\x01\x02", "seq": [1, 2.5, "a"],
    }
    data = serialization.msgpack_serialize(state)
    ref = serialization.msgpack_restore(data)
    got = jax_ckpt.msgpack_restore(data)

    def same(g, r):
        if isinstance(r, dict):
            assert isinstance(g, dict) and set(g) == set(r)
            for k in r:
                same(g[k], r[k])
        elif isinstance(r, (list, tuple)):
            assert len(g) == len(r)
            for a, b in zip(g, r):
                same(a, b)
        elif isinstance(r, (np.ndarray, np.generic, jax.Array)):
            r = np.asarray(r)
            g = np.asarray(g)
            if r.dtype.name == "bfloat16":
                r = r.astype(np.float32)
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        else:
            assert type(g) is type(r) and g == r
    same(got, ref)
    assert jax_ckpt.is_msgpack_map(data[:1])


# ---- staging --------------------------------------------------------------

def test_stage_volume_bucket_and_bf16_match_jax():
    vol = (np.random.default_rng(3).normal(size=(20, 14, 6, 1)) * 3 + 1
           ).astype(np.float32)
    kw = dict(overlap=0.25, sw_batch_size=3, bucket=(16, 8, 4))
    js = jsw.stage_volume(vol, (16, 16, 8), transfer_dtype=jnp.bfloat16,
                          predictor_layout="dfirst", **kw)
    ts = tsw.stage_volume(vol, (16, 16, 8), device="cpu",
                          transfer_dtype=torch.bfloat16, **kw)
    assert ts.vol_dev.dtype == torch.bfloat16
    assert tuple(ts.vol_dev.shape) == tuple(js.vol_dev.shape) == (8, 32, 16, 1)
    np.testing.assert_array_equal(ts.vol_dev.float().numpy(),
                                  np.asarray(js.vol_dev, np.float32))
    assert ts.crops == js.crops
    np.testing.assert_array_equal(ts.starts_padded, js.starts_padded)
    np.testing.assert_array_equal(ts.mask, js.mask)


@pytest.mark.parametrize("quantize", [False, True])
def test_stage_volume_bucket_is_bit_identical(quantize):
    """Bucketing grows the staged array only: window placement stays on the
    unbucketed extent, so the blended logits are equal bit for bit."""
    vol = np.random.default_rng(4).normal(size=(21, 18, 7, 1)).astype(
        np.float32)
    conv = torch.nn.Conv3d(1, 2, 3, padding=1)

    def predictor(wins):
        with torch.no_grad():
            return conv(wins.float().permute(0, 4, 1, 2, 3)).permute(
                0, 2, 3, 4, 1)

    outs = []
    for bucket in (None, (16, 16, 8)):
        staged = tsw.stage_volume(vol, (16, 16, 8), device="cpu",
                                  sw_batch_size=2, bucket=bucket,
                                  quantize=quantize)
        outs.append(tsw.sliding_window_inference(
            staged, (16, 16, 8), predictor, sw_batch_size=2))
    assert tuple(outs[0].shape) == (21, 18, 7, 2)
    assert torch.equal(outs[0], outs[1])


# ---- run_inference against JAX ------------------------------------------

def _tiny(cls, root, name, **extra):
    """tests/test_end_to_end.py:tiny_config, in either package."""
    return cls(data_root=str(root),
               split_csv=os.path.join(root, "split_synthetic.csv"),
               results_folder_name=name,
               pad_crop_shape=(32, 32, 16), pad_crop_shape_test=(32, 32, 16),
               sliding_window_inferer_roi_size=(32, 32, 16),
               channels=(4, 8, 12, 16),
               strides=((2, 2, 1), (2, 2, 2), (2, 2, 2)),
               kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3)),
               sample_kernel_sizes=((3, 3, 1), (3, 3, 3), (3, 3, 3)),
               compute_dtype="float32", infer_dtype="float32",
               sw_batch_size=2, num_workers=2, **extra)


def _test_loader(dmod, tmod, cfg):
    _, _, files = dmod.load_split_csv(cfg.split_csv, cfg.dataset,
                                      cfg.data_root)
    return dmod.DataLoader(dmod.CacheDataset(
        files, tmod.get_transforms(cfg.pad_crop_shape_test)[2], 1))


@pytest.fixture(scope="module")
def jax_run(roots):
    """JAX's run_inference at the tiny config on seeded weights with
    randomised BatchNorm statistics; the head's class-1 bias is shifted so
    that about half the voxels of the first case are foreground."""
    jroot, _ = roots
    cfg = _tiny(JConfig, jroot, "jax")
    model = jbuild_model(cfg)
    v = init_model(model, 0)
    rng = np.random.default_rng(1)

    def stats(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return (a + rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return (a * rng.uniform(0.5, 1.5, size=a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    v["params"])
    bstats = jax.tree_util.tree_map_with_path(stats, v["batch_stats"])
    loader = _test_loader(jdataset, jtransforms, cfg)
    image = next(iter(loader))["image"][0]            # (C, H, W, D)
    x = np.transpose(image, (3, 1, 2, 0))[None, :16, :32, :32]
    logits, _ = model.apply({"params": params, "batch_stats": bstats},
                            jnp.asarray(x), train=False)
    logits = np.asarray(logits)
    params["up_0"]["unit0"]["conv"]["bias"][1] -= np.median(
        logits[..., 1] - logits[..., 0])
    dice, _ = jrun_inference(cfg, model, params, bstats, loader,
                             make_figures=False)
    return cfg, {"params": params, "batch_stats": bstats}, dice


def _exports(cfg):
    root = Path(cfg.results_folder_path) / "inferred_segmentations_nifti"
    return {p.parent.name: tnifti.load(str(p), dtype=None)
            for p in sorted(root.rglob("*.nii.gz"))}


@pytest.mark.parametrize("route", ["none", "dsconv"])
def test_run_inference_matches_jax(roots, jax_run, monkeypatch, route):
    jcfg, variables, jdice = jax_run
    _, troot = roots
    routes = Routes(dsconv=route == "dsconv")
    cfg = _tiny(tconfig.Config, troot, f"port_{route}", routes=routes)
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, variables)
    calls = {}
    fn = dsconv.ds_conv

    def counted(*args, **kwargs):
        calls["ds_conv"] = calls.get("ds_conv", 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(dsconv, "ds_conv", counted)
    create_results_folders(cfg)
    dice, times = run_inference(cfg, model, _test_loader(
        tdataset, ttransforms, cfg), device="cpu", make_figures=True)
    # downsample_1 and downsample_2 per forward; 2 forwards per volume
    assert calls == ({"ds_conv": 2 * 2 * 2} if route == "dsconv" else {})
    # random weights: about half the voxels foreground, a small Dice that
    # is not 0
    assert len(times) == 2 and np.isfinite(jdice).all() and \
        (jdice > 0).all()
    np.testing.assert_allclose(dice, jdice, atol=1e-5)
    ref, got = _exports(jcfg), _exports(cfg)
    assert sorted(got) == sorted(ref) == ["vs_gk_202", "vs_gk_203"]
    for case, img in got.items():
        assert img.data.shape == SHAPE and img.data.dtype == np.uint8
        np.testing.assert_allclose(img.affine, ref[case].affine)
        assert img.affine[0, 0] < 0               # the original non-RAS grid
        assert (img.data == ref[case].data).mean() >= 0.999
    figs = Path(cfg.figures_path)
    assert (figs / "best_model_output_val0.png").is_file()
    assert (figs / "best_model_output_dice_score_histogram.png").is_file()


# ---- the CLI --------------------------------------------------------------

CLI_ARGV = ["--debug", "--device", "cpu", "--compute_dtype", "float32",
            "--infer_dtype", "float32", "--sw_batch_size", "1"]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A synthetic root with the cases split_debug.csv names, and one set of
    flagship weights written as each checkpoint kind: a reference .pth (the
    replica's state_dict), the JAX package's msgpack .ckpt and the port's
    torch.save .ckpt, all holding the same values."""
    root = tmp_path_factory.mktemp("clidata")
    tsynthetic.generate_dataset(str(root), shape=SHAPE)
    kinds = tmp_path_factory.mktemp("ckpts")
    torch.manual_seed(0)
    cfg = tconfig.Config(debug=True, data_root=str(root), device="cpu",
                         compute_dtype="float32", infer_dtype="float32",
                         sw_batch_size=1)
    rep = TorchUNet2d5_spvPA(1, 2, cfg.channels, cfg.strides,
                             cfg.kernel_sizes, cfg.sample_kernel_sizes,
                             num_res_units=2, dropout=0.1, attention=True)
    with torch.no_grad():
        for name, buf in rep.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.2)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    sd = {k: v.clone() for k, v in rep.state_dict().items()}
    torch.save(sd, kinds / "best_metric_model.pth")
    params, stats = jimport(sd, channels=tuple(cfg.channels))
    jsave_checkpoint(str(kinds / "jax.ckpt"), {
        "params": params, "batch_stats": stats, "epoch": 3,
        "best_metric": np.float32(0.5), "rng": np.arange(4, dtype=np.uint32)})
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, {"params": params, "batch_stats": stats})
    save_checkpoint(str(kinds / "torch.ckpt"), {"model": model.state_dict()})
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)                          # ./params/split_debug.csv
        _, _, files = tdataset.load_split_csv(cfg.split_csv, cfg.dataset,
                                              cfg.data_root)
    loader = tdataset.DataLoader(tdataset.CacheDataset(
        files, ttransforms.get_transforms(cfg.pad_crop_shape_test)[2]))
    ref, _ = run_inference(dataclasses.replace(cfg, results_folder_name="x"),
                           model, loader, device="cpu", export=False,
                           make_figures=False)
    return root, kinds, cfg, ref


def _install(cfg, kinds, kind):
    """Leave only checkpoint `kind` under cfg.model_path."""
    shutil.rmtree(cfg.model_path, ignore_errors=True)
    os.makedirs(cfg.model_path)
    src, dst = {"torch": ("torch.ckpt", "best_metric_model.ckpt"),
                "jax": ("jax.ckpt", "best_metric_model.ckpt"),
                "pth": ("best_metric_model.pth", "best_metric_model.pth")
                }[kind]
    shutil.copy(kinds / src, Path(cfg.model_path) / dst)


@pytest.mark.parametrize("kind", ["torch", "jax", "pth"])
def test_cli_reads_each_checkpoint_kind(cli, monkeypatch, kind):
    root, kinds, cfg, ref = cli
    monkeypatch.chdir(REPO)
    _install(cfg, kinds, kind)
    dice, times = inference.main(CLI_ARGV + ["--data_root", str(root)],
                                 make_figures=False)
    assert len(times) == 2
    np.testing.assert_allclose(dice, ref, atol=1e-6)
    assert load_model_state(cfg, build_model(cfg, device="cpu")) == kind
    exported = Path(cfg.results_folder_path) / "inferred_segmentations_nifti"
    assert sorted(p.name for p in exported.iterdir()) == ["vs_gk_202",
                                                          "vs_gk_203"]


@pytest.mark.parametrize("kind", ["torch", "jax", "pth"])
def test_load_model_state_refuses_a_misfit_tree(cli, kind):
    _, kinds, cfg, _ = cli
    _install(cfg, kinds, kind)
    other = dataclasses.replace(cfg, channels=(16, 32, 48, 64, 80, 112))
    with pytest.raises((KeyError, ValueError, RuntimeError)):
        load_model_state(other, build_model(other, device="cpu"))


def test_load_model_state_needs_a_checkpoint(tmp_path):
    cfg = tconfig.Config(data_root=str(tmp_path), results_folder_name="none")
    with pytest.raises(FileNotFoundError):
        load_model_state(cfg, None)


def test_cli_defaults_to_the_card(cli, monkeypatch):
    """Without --device the CLI runs on cuda; with no card it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = cli[0]
    monkeypatch.chdir(REPO)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.main(["--debug", "--data_root", str(root)],
                       make_figures=False)


@pytest.mark.parametrize("flag", ["sharded_inference", "spatial_inference"])
def test_multi_device_flags_select_their_path(roots, jax_run, monkeypatch,
                                              flag):
    """Each flag parses into Config, builds the mesh (two CPU shards here)
    and takes its engine path: the window-sharded loop or the spatial
    predictor; Dice as JAX's at the tiny config within 1e-5."""
    from vs_seg_tpu_torch.infer import engine

    parsed = tconfig.parse_cli(["--device", "cpu", f"--{flag}"])
    assert getattr(parsed, flag) and parsed.device == "cpu"
    other = ({"sharded_inference", "spatial_inference"} - {flag}).pop()
    assert not getattr(parsed, other)
    jcfg, variables, jdice = jax_run
    _, troot = roots
    cfg = _tiny(tconfig.Config, troot, f"port_{flag}", **{flag: True})
    model = build_model(cfg, device="cpu")
    load_jax_variables(model, variables)
    calls = []
    monkeypatch.setattr(engine, "make_mesh",
                        lambda device: (torch.device(device),) * 2)
    for name in ("sliding_window_inference_sharded",
                 "make_spatial_predictor"):
        fn = getattr(engine, name)
        monkeypatch.setattr(engine, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    dice, _ = run_inference(cfg, model, _test_loader(tdataset, ttransforms,
                                                     cfg),
                            device="cpu", make_figures=False, export=False)
    want = ("sliding_window_inference_sharded" if flag == "sharded_inference"
            else "make_spatial_predictor")
    assert set(calls) == {want}, calls
    np.testing.assert_allclose(dice, jdice, atol=1e-5)


def test_cli_flags_match_jax():
    """Every flag of VS_inference.py, with its default; and the port's
    parsed Config equals the JAX one on the fields both have."""
    import argparse

    jp = jflags(argparse.ArgumentParser())
    tp = tconfig.add_reference_cli_flags(argparse.ArgumentParser())
    tacts = {a.dest: a for a in tp._actions}
    for a in jp._actions:
        if a.dest in ("help", "results_folder_name"):
            continue
        assert a.dest in tacts, a.dest
        assert tacts[a.dest].option_strings == a.option_strings
        assert tacts[a.dest].default == a.default, a.dest
    argv = ["--debug", "--dataset", "T2", "--sw_bucket", "32,32,8",
            "--infer_dtype", "float32", "--results_folder_name", "r"]
    from vs_seg_tpu.core.config import parse_cli as jparse
    j, t = jparse(argv), tconfig.parse_cli(argv + ["--routes", "dsconv"])
    for f in dataclasses.fields(t):
        if hasattr(j, f.name):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.routes == Routes(dsconv=True) and t.device == "cuda"


def test_routes_parse():
    assert Routes.parse("dsconv, rublock2d") == Routes(dsconv=True,
                                                       rublock2d=True)
    assert Routes.parse("") == Routes()
    with pytest.raises(ValueError, match="unknown route"):
        Routes.parse("dsconv,warp")
