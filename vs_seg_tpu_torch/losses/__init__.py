from vs_seg_tpu_torch.losses.dice import dice_loss, dice_spvpa_loss, one_hot

__all__ = ["dice_loss", "dice_spvpa_loss", "one_hot"]
