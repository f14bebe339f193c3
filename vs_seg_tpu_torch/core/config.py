"""The training configuration: the fields of vs_seg_tpu/core/config.py:Config
that the port's trainer and model read, with the same names, defaults, debug
overrides and derived paths. (The JAX module cannot be imported here: the
vs_seg_tpu package imports jax.) The CLI flags are not ported yet.

`Routes` selects the opt-in kernel routes of the eval forward.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence, Tuple

Shape3 = Tuple[int, int, int]


@dataclasses.dataclass
class Config:
    debug: bool = False
    train_batch_size: int = 1
    initial_learning_rate: float = 1e-4
    attention: bool = True
    hardness: bool = True
    results_folder_name: str = ""
    data_root: str = "./data/VS_defaced/"
    pad_crop_shape: Shape3 = (384, 384, 64)
    epochs_with_const_lr: int = 100
    lr_divisor: float = 2.0
    weight_decay: float = 1e-7
    num_epochs: int = 300
    val_interval: int = 2
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
    seed: int = 0
    compute_dtype: str = "bfloat16"   # conv compute dtype; params stay f32

    @property
    def results_folder_path(self) -> str:
        name = "debug" if self.debug else (self.results_folder_name or "temp")
        return os.path.join(self.data_root, "results", name)

    @property
    def model_path(self) -> str:
        return os.path.join(self.results_folder_path, "model")

    def __post_init__(self):
        if self.debug:
            self.pad_crop_shape = (128, 128, 32)
            self.epochs_with_const_lr = 3
            self.num_epochs = 10

    def model_kwargs(self) -> dict:
        """UNet2d5_spvPA constructor arguments of this configuration."""
        return dict(in_channels=self.in_channels,
                    out_channels=self.out_channels,
                    channels=tuple(self.channels), strides=self.strides,
                    kernel_sizes=self.kernel_sizes,
                    sample_kernel_sizes=self.sample_kernel_sizes,
                    num_res_units=self.num_res_units, dropout=self.dropout,
                    attention_module=self.attention)


@dataclasses.dataclass(frozen=True)
class Routes:
    """Opt-in kernel routes of the eval forward, one field per environment
    gate of the JAX package (all off by default there too). The port reads
    no environment variable: a caller passes Routes to
    UNet2d5_spvPA.forward or infer/engine.py:make_predictor. At train every
    route is ignored, as JAX gates each of them on `not train`.

      rublock2d  VS_RUBLOCK2D  (3,3,1) two-subunit encoder units (down_0,
                               down_1) -> ops/block2d.py:ru_block2d
      l2block2d  VS_L2BLOCK2D  (3,3,1) decoder levels (up_0 head, up_1):
                               upatt_i + up_i -> ops/block2d.py:l2_block2d
      tail2d0    VS_TAIL2D0    level 0 decoder tail -> ops/tail2d.py
      tail2d1    VS_TAIL2D1    level 1 decoder tail -> ops/tail2d.py
      att_fuse   VS_ATT_FUSE   the decoder's gated AttentionBlock1 sites
                               (upatt_i) that no block route took ->
                               ops/att.py

    At a (3,3,1) decoder level i, tail2d{i} comes before l2block2d."""

    rublock2d: bool = False
    l2block2d: bool = False
    tail2d0: bool = False
    tail2d1: bool = False
    att_fuse: bool = False

    def tail2d(self, level: int) -> bool:
        """The tail route of decoder level `level` (levels 0 and 1 only)."""
        return (self.tail2d0, self.tail2d1)[level] if level < 2 else False
