from emap_tpu_torch.ckpt.convert import (
    checkpoint_payload,
    params_from_numpy,
    params_to_numpy,
    rendering_params_from_numpy,
    state_from_payload,
)
from emap_tpu_torch.ckpt.native import load_pytree, save_pytree

__all__ = [
    "checkpoint_payload",
    "params_from_numpy",
    "params_to_numpy",
    "rendering_params_from_numpy",
    "state_from_payload",
    "load_pytree",
    "save_pytree",
]
