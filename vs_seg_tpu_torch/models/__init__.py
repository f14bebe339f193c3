from vs_seg_tpu_torch.core.device import DTYPES
from vs_seg_tpu_torch.models.unet import UNet
from vs_seg_tpu_torch.models.unet2d5 import UNet2d5
from vs_seg_tpu_torch.models.unet2d5_spvpa import UNet2d5_spvPA

__all__ = ["UNet", "UNet2d5", "UNet2d5_spvPA", "build_model"]

MODELS = {"UNet2d5_spvPA": UNet2d5_spvPA, "UNet2d5": UNet2d5, "UNet": UNet}


def build_model(cfg, *, device, generator=None):
    """The model of `cfg` (vs_seg_tpu/models/__init__.py:build_model), built
    on `device` in cfg.compute_dtype, with the arguments
    Config.model_kwargs gives it."""
    if cfg.model not in MODELS:
        raise ValueError(f"unknown cfg.model {cfg.model!r}; supported: "
                         "UNet2d5_spvPA, UNet2d5, UNet")
    return MODELS[cfg.model](dtype=DTYPES[cfg.compute_dtype], device=device,
                             generator=generator, **cfg.model_kwargs())
