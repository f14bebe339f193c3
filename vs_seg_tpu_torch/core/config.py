"""The configuration: the fields of vs_seg_tpu/core/config.py:Config that the
port reads, with the same names, defaults, debug overrides and derived paths,
and its CLI flags (`add_reference_cli_flags`, `config_from_args`,
`parse_cli`). (The JAX module cannot be imported here: the vs_seg_tpu package
imports jax.)

Two flags are the port's own, standing for what the JAX package selects
through its environment: `--device` (default cuda: the CLI runs on the card
unless asked for the CPU) and `--routes`, a comma list of `Routes` field
names. Every flag of the JAX CLI is ported; none is ignored. Data-parallel
training adds none: torchrun's environment (or, with `--device cuda`, the
number of visible GPUs) sets the ranks, and `--device` their devices
(parallel/distributed.py); `train_batch_size` is then one node's batch,
split over its ranks.

`Routes` selects the opt-in kernel routes of the eval forward.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from time import strftime
from typing import Optional, Sequence, Tuple

Shape3 = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class Routes:
    """Opt-in kernel routes of the eval forward, one field per environment
    gate of the JAX package (all off by default there too). The port reads
    no environment variable: a caller passes Routes to
    UNet2d5_spvPA.forward or infer/engine.py:make_predictor, and the CLI
    takes them as `--routes`. At train every route is ignored, as JAX gates
    each of them on `not train`.

      rublock2d  VS_RUBLOCK2D  (3,3,1) two-subunit encoder units (down_0,
                               down_1) -> ops/block2d.py:ru_block2d
      l2block2d  VS_L2BLOCK2D  (3,3,1) decoder levels (up_0 head, up_1):
                               upatt_i + up_i -> ops/block2d.py:l2_block2d
      tail2d0    VS_TAIL2D0    level 0 decoder tail -> ops/tail2d.py
      tail2d1    VS_TAIL2D1    level 1 decoder tail -> ops/tail2d.py
      att_fuse   VS_ATT_FUSE   the decoder's gated AttentionBlock1 sites
                               (upatt_i) that no block route took ->
                               ops/att.py
      dsconv     VS_DSCONV     (3,3,3) stride-(2,2,2) Convolutions (the
                               flagship's downsample_2/3/4) ->
                               ops/dsconv.py

    At a (3,3,1) decoder level i, tail2d{i} comes before l2block2d."""

    rublock2d: bool = False
    l2block2d: bool = False
    tail2d0: bool = False
    tail2d1: bool = False
    att_fuse: bool = False
    dsconv: bool = False

    def tail2d(self, level: int) -> bool:
        """The tail route of decoder level `level` (levels 0 and 1 only)."""
        return (self.tail2d0, self.tail2d1)[level] if level < 2 else False

    @classmethod
    def parse(cls, text: str) -> "Routes":
        """A comma list of field names ("dsconv,rublock2d"; "" for none)."""
        names = [s.strip() for s in text.split(",") if s.strip()]
        known = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(names) - known)
        if bad:
            raise ValueError(f"unknown route(s) {bad}; known: {sorted(known)}")
        return cls(**{n: True for n in names})


@dataclasses.dataclass
class Config:
    # --- CLI-exposed flags of the reference ---
    debug: bool = False
    split_csv: str = "./params/split_TCIA.csv"
    dataset: str = "T1"  # "T1" or "T2"
    train_batch_size: int = 1
    initial_learning_rate: float = 1e-4
    attention: bool = True
    hardness: bool = True
    results_folder_name: str = ""

    # --- hardcoded reference hyperparameters ---
    data_root: str = "./data/VS_defaced/"
    pad_crop_shape: Shape3 = (384, 384, 64)
    pad_crop_shape_test: Shape3 = (384, 384, 64)
    num_workers: int = 4
    epochs_with_const_lr: int = 100
    lr_divisor: float = 2.0
    weight_decay: float = 1e-7
    num_epochs: int = 300
    val_interval: int = 2
    model: str = "UNet2d5_spvPA"
    sliding_window_inferer_roi_size: Shape3 = (384, 384, 64)
    export_inferred_segmentations: bool = True

    # --- model architecture ---
    in_channels: int = 1
    out_channels: int = 2
    channels: Sequence[int] = (16, 32, 48, 64, 80, 96)
    strides: Sequence[Shape3] = ((2, 2, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2),
                                 (2, 2, 2))
    kernel_sizes: Sequence[Shape3] = (
        (3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3))
    sample_kernel_sizes: Sequence[Shape3] = (
        (3, 3, 1), (3, 3, 1), (3, 3, 3), (3, 3, 3), (3, 3, 3))
    num_res_units: int = 2
    dropout: float = 0.1

    # --- knobs without a reference counterpart ---
    seed: int = 0
    compute_dtype: str = "bfloat16"   # conv compute dtype; params stay f32
    infer_dtype: str = "bfloat16"     # sliding-window predictor dtype
    sw_batch_size: int = 8            # windows batched per forward
    sw_overlap: float = 0.25          # MONAI 0.4 default overlap
    # Round padded whole-volume shapes up to multiples of this (H, W, D);
    # None disables bucketing. Window placement ignores it, so results are
    # bit-identical with and without.
    sw_bucket: Optional[Shape3] = (64, 64, 16)
    remat: bool = False   # rematerialise levels 0-1 in the backward
    resume: bool = False
    device_cache: bool = False  # training set on the device, crop/flip there
    profile_steps: int = 0      # torch.profiler trace of N steady steps
    quantize_transfer: bool = False   # uint8 volume staging
    sharded_inference: bool = False   # a volume's windows over the mesh
    spatial_inference: bool = False   # ONE window's H over the mesh
    # --- the port's own: what JAX selects through its environment ---
    device: str = "cuda"
    routes: Routes = Routes()

    # --- derived paths ---
    @property
    def results_folder_path(self) -> str:
        name = "debug" if self.debug else (self.results_folder_name or "temp")
        return os.path.join(self.data_root, "results", name)

    @property
    def logs_path(self) -> str:
        return os.path.join(self.results_folder_path, "logs")

    @property
    def model_path(self) -> str:
        return os.path.join(self.results_folder_path, "model")

    @property
    def figures_path(self) -> str:
        return os.path.join(self.results_folder_path, "figures")

    def __post_init__(self):
        # the reference's debug-mode overrides
        if self.debug:
            self.split_csv = "./params/split_debug.csv"
            self.pad_crop_shape = (128, 128, 32)
            self.pad_crop_shape_test = (128, 128, 32)
            self.epochs_with_const_lr = 3
            self.num_epochs = 10
            self.sliding_window_inferer_roi_size = (128, 128, 32)

    def model_kwargs(self) -> dict:
        """Constructor arguments of cfg.model, those that
        vs_seg_tpu/models/__init__.py:build_model gives each model, plus
        the port's in_channels: UNet2d5 takes no attention_module and no
        remat, UNet no kernel sizes (its per-dimension stride tuples pass
        through unchanged)."""
        kw = dict(in_channels=self.in_channels,
                  out_channels=self.out_channels,
                  channels=tuple(self.channels),
                  strides=tuple(tuple(s) if isinstance(s, (tuple, list))
                                else s for s in self.strides),
                  num_res_units=self.num_res_units, dropout=self.dropout)
        if self.model == "UNet":
            return kw
        kw.update(kernel_sizes=tuple(self.kernel_sizes),
                  sample_kernel_sizes=tuple(self.sample_kernel_sizes))
        if self.model == "UNet2d5_spvPA":
            kw.update(attention_module=self.attention, remat=self.remat)
        return kw


def add_reference_cli_flags(parser: argparse.ArgumentParser
                            ) -> argparse.ArgumentParser:
    """The flags of vs_seg_tpu/core/config.py:add_reference_cli_flags, same
    names and defaults, plus the port's --device and --routes."""
    parser.add_argument("--debug", dest="debug", action="store_true",
                        help="activate debugging mode")
    parser.set_defaults(debug=False)
    parser.add_argument("--split", type=str, default="./params/split_TCIA.csv",
                        help="path to CSV file that defines training, "
                             "validation and test datasets")
    parser.add_argument("--dataset", type=str, default="T1",
                        help='(string) use "T1" or "T2" to select dataset')
    parser.add_argument("--train_batch_size", type=int, default=1,
                        help="batch size of the forward pass")
    parser.add_argument("--initial_learning_rate", type=float, default=1e-4,
                        help="learning rate at first epoch")
    parser.add_argument("--no_attention", dest="attention",
                        action="store_false",
                        help="disables the attention module in the network "
                             "and the attention map weighting in the loss "
                             "function")
    parser.set_defaults(attention=True)
    parser.add_argument("--no_hardness", dest="hardness",
                        action="store_false",
                        help="disables the hardness weighting in the loss "
                             "function")
    parser.set_defaults(hardness=True)
    parser.add_argument("--results_folder_name", type=str,
                        default="temp" + strftime("%Y%m%d%H%M%S"),
                        help="name of results folder")
    parser.add_argument("--data_root", type=str, default="./data/VS_defaced/",
                        help="path to data set root")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--infer_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--sw_batch_size", type=int, default=8,
                        help="sliding-window tiles evaluated per forward")
    parser.add_argument("--sw_bucket", type=str, default="64,64,16",
                        help="comma H,W,D multiples to round padded volume "
                             "shapes up to; 'none' disables")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize activations in the backward "
                             "pass")
    parser.add_argument("--resume", action="store_true",
                        help="resume full training state from "
                             "last_epoch_model.ckpt")
    parser.add_argument("--sharded_inference", action="store_true",
                        help="shard each volume's sliding windows across "
                             "all visible devices of --device's type")
    parser.add_argument("--spatial_inference", action="store_true",
                        help="shard each window's H across all visible "
                             "devices of --device's type, with conv halo "
                             "exchange (UNet2d5 family)")
    parser.add_argument("--device_cache", action="store_true",
                        help="cache the training set on the device and "
                             "crop and flip there")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="profile N steady training steps into "
                             "<results>/profile/")
    parser.add_argument("--quantize_transfer", action="store_true",
                        help="stage inference volumes as uint8 (a quarter "
                             "of the float32 host->device bytes; max error "
                             "one 256th of the volume range)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: cuda[:i] (default) "
                             "or cpu")
    parser.add_argument("--routes", type=str, default="",
                        help="comma list of opt-in kernel routes of the "
                             "eval forward (Routes fields), e.g. "
                             "dsconv,rublock2d")
    return parser


def _parse_bucket(s) -> Optional[Shape3]:
    if s is None or (isinstance(s, str) and s.lower() in ("none", "0", "")):
        return None
    if isinstance(s, (tuple, list)):
        return tuple(int(v) for v in s)
    return tuple(int(v) for v in s.split(","))


def config_from_args(args: argparse.Namespace) -> Config:
    """Config of parsed flags."""
    return Config(
        debug=args.debug,
        split_csv=args.split,
        dataset=args.dataset,
        train_batch_size=args.train_batch_size,
        initial_learning_rate=args.initial_learning_rate,
        attention=args.attention,
        hardness=args.hardness,
        results_folder_name=args.results_folder_name,
        data_root=args.data_root,
        compute_dtype=args.compute_dtype,
        infer_dtype=args.infer_dtype,
        sw_batch_size=args.sw_batch_size,
        sw_bucket=_parse_bucket(args.sw_bucket),
        seed=args.seed,
        remat=args.remat,
        resume=args.resume,
        device_cache=args.device_cache,
        profile_steps=args.profile_steps,
        quantize_transfer=args.quantize_transfer,
        sharded_inference=args.sharded_inference,
        spatial_inference=args.spatial_inference,
        device=args.device,
        routes=Routes.parse(args.routes),
    )


def parse_cli(argv=None) -> Config:
    parser = argparse.ArgumentParser()
    add_reference_cli_flags(parser)
    return config_from_args(parser.parse_args(argv))
