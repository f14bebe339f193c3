from vs_seg_tpu_torch.core.device import DTYPES
from vs_seg_tpu_torch.models.unet2d5_spvpa import UNet2d5_spvPA

__all__ = ["UNet2d5_spvPA", "build_model"]


def build_model(cfg, *, device, generator=None) -> UNet2d5_spvPA:
    """The model of `cfg` (vs_seg_tpu/models/__init__.py:build_model), built
    on `device` in cfg.compute_dtype. Only UNet2d5_spvPA is ported."""
    if cfg.model == "UNet2d5_spvPA":
        return UNet2d5_spvPA(dtype=DTYPES[cfg.compute_dtype], device=device,
                             generator=generator, **cfg.model_kwargs())
    if cfg.model in ("UNet2d5", "UNet"):
        raise NotImplementedError(
            f"{cfg.model} is not ported to vs_seg_tpu_torch yet (ROADMAP, "
            "What remains item 3: models/unet2d5.py and models/unet.py)")
    raise ValueError(f"unknown cfg.model {cfg.model!r}; supported: "
                     "UNet2d5_spvPA, UNet2d5, UNet")
