"""The port's checkpoint converter and train-then-infer pipeline on the CPU.

Converter: one reference state_dict (tests/torch_replica.py at the
flagship's widths, seeded weights, randomised BatchNorm statistics) goes
through `python -m vs_seg_tpu_torch.compat.convert_checkpoint` and through
the JAX package's converter. The port's file reads back as kind "torch"
with the same values as the JAX file read as kind "jax" (bit-equal), and
its float32 forward agrees with JAX's forward of the JAX file within
CONVERT_TOL (relative to max|JAX|: only the order of the sums in the
CPU convolutions differs).

Pipeline: a synthetic TCIA download (tests/tcia_download.py) through the
port's preprocessing (restructure, convert --register T2) into
./data/VS_defaced/input_data, then vs_seg_tpu_torch/cli/vs_pipeline.sh run by
bash from that directory. A `python3` first on PATH runs each of the
script's two commands in-process with the port's CLI config_from_args
wrapped to the SMALL widths of tests/test_model.py (dropout 0, 32x32x8
crops and windows, 2 epochs, validation every epoch) and `--device cpu
--compute_dtype float32 --infer_dtype float32 --sw_batch_size 1` appended,
the way tests/test_torch_train_cli.py shrinks the training CLI.
"""

import os
import stat
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.tcia_download import Grid, write_download, write_transforms
from tests.test_model import SMALL
from tests.torch_replica import TorchUNet2d5_spvPA
from vs_seg_tpu.compat.convert_checkpoint import main as jconvert
from vs_seg_tpu.core.config import Config as JConfig
from vs_seg_tpu.models import build_model as jbuild_model
from vs_seg_tpu.train.checkpoint import load_checkpoint as jload_checkpoint
from vs_seg_tpu_torch.core.config import Config
from vs_seg_tpu_torch.data import nifti
from vs_seg_tpu_torch.models import build_model
from vs_seg_tpu_torch.preprocessing.__main__ import main as preprocess
from vs_seg_tpu_torch.train.checkpoint import (checkpoint_kind,
                                               load_checkpoint,
                                               load_model_state)

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "vs_seg_tpu_torch" / "cli" / "vs_pipeline.sh"
CONVERT_TOL = 1e-5
RESULTS = "UNet2d5_Att_Hard_T2"


def _replica(attention: bool):
    cfg = Config()
    torch.manual_seed(0)
    rep = TorchUNet2d5_spvPA(1, 2, cfg.channels, cfg.strides,
                             cfg.kernel_sizes, cfg.sample_kernel_sizes,
                             num_res_units=2, dropout=0.1,
                             attention=attention)
    with torch.no_grad():
        for name, buf in rep.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.2)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    return rep.state_dict()


@pytest.mark.parametrize("attention", [True, False])
def test_convert_checkpoint_matches_jax(tmp_path, attention):
    src = tmp_path / "best_metric_model.pth"
    torch.save(_replica(attention), src)
    flag = [] if attention else ["--no_attention"]
    jconvert([str(src), str(tmp_path / "jax.ckpt"), *flag])
    proc = subprocess.run(
        [sys.executable, "-m", "vs_seg_tpu_torch.compat.convert_checkpoint",
         str(src), str(tmp_path / "port.ckpt"), *flag], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "converted" in proc.stdout

    port = load_checkpoint(str(tmp_path / "port.ckpt"))
    assert checkpoint_kind(str(tmp_path / "port.ckpt")) == "torch"
    assert {k: port[k] for k in ("epoch", "best_metric",
                                 "best_metric_epoch")} == {
        "epoch": -1, "best_metric": -1.0, "best_metric_epoch": -1}

    models, paths = {}, {}
    for kind in ("port", "jax"):
        cfg = Config(data_root=str(tmp_path), results_folder_name=kind,
                     device="cpu", compute_dtype="float32",
                     attention=attention)
        os.makedirs(cfg.model_path)
        paths[kind] = Path(cfg.model_path) / "best_metric_model.ckpt"
        os.replace(tmp_path / f"{kind}.ckpt", paths[kind])
        models[kind] = build_model(cfg, device="cpu")
        assert load_model_state(cfg, models[kind]) == (
            "torch" if kind == "port" else "jax")
    a, b = models["port"].state_dict(), models["jax"].state_dict()
    assert sorted(a) == sorted(port["model"]) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    x = np.random.default_rng(0).normal(size=(1, 16, 32, 32, 1)
                                        ).astype(np.float32)
    jmodel = jbuild_model(JConfig(compute_dtype="float32",
                                  attention=attention))
    state = jload_checkpoint(str(paths["jax"]))
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": state["params"], "batch_stats": state["batch_stats"]},
        jnp.asarray(x))
    ref = np.asarray(ref[0] if isinstance(ref, tuple) else ref)
    with torch.no_grad():
        got = models["port"].eval()(torch.from_numpy(x))
    got = (got[0] if isinstance(got, tuple) else got).numpy()
    assert got.shape == ref.shape == (1, 16, 32, 32, 2)
    assert np.abs(got - ref).max() <= CONVERT_TOL * np.abs(ref).max()


def test_pipeline_script_runs_the_root_scripts_commands():
    """cli/vs_pipeline.sh: the root vs_pipeline.sh's two commands, on the
    port's CLIs, with its results folder, dataset and stderr logs."""
    def commands(path):
        return [line.split() for line in path.read_text().splitlines()
                if line.startswith("python3")]

    root = commands(REPO / "vs_pipeline.sh")
    port = commands(SCRIPT)
    swap = {"VS_train.py": ["-m", "vs_seg_tpu_torch.cli.train"],
            "VS_inference.py": ["-m", "vs_seg_tpu_torch.cli.inference"]}
    assert [[w for t in c for w in swap.get(t, [t])] for c in root] == port
    assert ('RESULTS_FOLDER_NAME="UNet2d5_Att_Hard_T2"'
            in SCRIPT.read_text().splitlines())


SHIM = """import dataclasses
import importlib
import sys

sys.path.insert(0, {repo!r})
args = sys.argv[1:]
if args[:1] != ["-m"]:
    raise SystemExit("python3 stand-in: expected -m MODULE, got %r" % args)
cli = importlib.import_module(args[1])
real = cli.config_from_args


def shrunk(ns):
    cfg = dataclasses.replace(real(ns), dropout=0.0, **{small!r})
    cfg.pad_crop_shape = (32, 32, 8)
    cfg.sliding_window_inferer_roi_size = (32, 32, 8)
    cfg.num_epochs = 2
    cfg.val_interval = 1
    return cfg


cli.config_from_args = shrunk
cli.main(args[2:] + ["--device", "cpu", "--compute_dtype", "float32",
                     "--infer_dtype", "float32", "--sw_batch_size", "1"])
"""


def test_pipeline_from_dicom_to_labelmaps(tmp_path):
    work = tmp_path / "work"
    data = work / "data" / "VS_defaced"
    t2 = Grid((40, 40, 12), (1.0, 2.0), (-20.0, -20.0, -12.0))
    t1 = Grid((44, 44, 14), (1.0, 1.8), (-22.0, -21.0, -12.0))
    write_download(tmp_path / "raw", (1, 2, 3), t2, t1,
                   rng=np.random.default_rng(0), noise=20)
    cases = tmp_path / "cases"
    assert preprocess(["restructure", "-i", str(tmp_path / "raw"),
                       "-o", str(cases)]) == 0
    write_transforms(cases, (1, 2, 3))
    assert preprocess(["convert", "-i", str(cases), "-o",
                       str(data / "input_data"), "--register", "T2"]) == 0
    (work / "params").mkdir()
    (work / "params" / "split_TCIA.csv").write_text(
        "vs_gk_1,training\nvs_gk_2,training\nvs_gk_3,validation\n"
        "vs_gk_3,test\n")

    shim = tmp_path / "bin"
    shim.mkdir()
    (tmp_path / "entry.py").write_text(SHIM.format(repo=str(REPO),
                                                   small=SMALL))
    py3 = shim / "python3"
    py3.write_text(f"#!/bin/sh\nexec {sys.executable} "
                   f"{tmp_path / 'entry.py'} \"$@\"\n")
    py3.chmod(py3.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{shim}:{os.environ['PATH']}")
    proc = subprocess.run(["bash", str(SCRIPT)], cwd=work, env=env,
                          capture_output=True, text=True, timeout=600)
    errs = {n: (work / n).read_text() for n in ("train_error_log.txt",
                                                "inference_error_log.txt")}
    assert proc.returncode == 0, (proc.stdout, errs)
    assert "Traceback" not in errs["train_error_log.txt"], errs
    assert "Traceback" not in errs["inference_error_log.txt"], errs

    res = data / "results" / RESULTS
    assert (res / "logs" / "training_log.txt").is_file()
    assert (res / "logs" / "test_log.txt").is_file()
    ckpt = res / "model" / "best_metric_model.ckpt"
    assert checkpoint_kind(str(ckpt)) == "torch"
    out = nifti.load(str(res / "inferred_segmentations_nifti" / "vs_gk_3"
                         / "vs_gk_seg_refT2.nii.gz"))
    ref = nifti.load(str(data / "input_data" / "vs_gk_3"
                         / "vs_gk_seg_refT2.nii.gz"))
    assert out.data.shape == ref.data.shape == t2.shape
    np.testing.assert_allclose(out.affine, ref.affine)
    assert set(np.unique(out.data)) <= {0.0, 1.0}
