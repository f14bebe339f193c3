from vs_seg_tpu_torch.models.unet2d5_spvpa import UNet2d5_spvPA

__all__ = ["UNet2d5_spvPA"]
