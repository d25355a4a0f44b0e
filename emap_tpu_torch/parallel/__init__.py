from emap_tpu_torch.parallel.mesh import (
    RayGroup,
    init_group,
    launch,
    world_size,
)

__all__ = [
    "RayGroup",
    "init_group",
    "launch",
    "world_size",
]
