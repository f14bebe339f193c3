from vs_seg_tpu_torch.compat.from_jax import (
    jax_state_dict, load_jax_train_state, load_jax_variables,
)

__all__ = ["jax_state_dict", "load_jax_train_state", "load_jax_variables"]
