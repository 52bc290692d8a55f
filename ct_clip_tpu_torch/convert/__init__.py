from .from_jax import (ctvit_state_dict_from_jax, discriminator_state_dict_from_jax,
                       radbert_state_dict_from_jax, state_dict_from_jax,
                       state_dict_from_train_state)

__all__ = ["ctvit_state_dict_from_jax", "discriminator_state_dict_from_jax",
           "radbert_state_dict_from_jax", "state_dict_from_jax", "state_dict_from_train_state"]
