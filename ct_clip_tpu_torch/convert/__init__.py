from .from_jax import (radbert_state_dict_from_jax, state_dict_from_jax,
                       state_dict_from_train_state)

__all__ = ["radbert_state_dict_from_jax", "state_dict_from_jax", "state_dict_from_train_state"]
