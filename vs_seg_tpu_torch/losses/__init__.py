from vs_seg_tpu_torch.losses.dice import (
    dice_loss, dice_spvpa_loss, generalized_dice_loss,
    generalized_wasserstein_dice_loss, masked_dice_loss, one_hot,
)

__all__ = ["dice_loss", "dice_spvpa_loss", "generalized_dice_loss",
           "generalized_wasserstein_dice_loss", "masked_dice_loss",
           "one_hot"]
