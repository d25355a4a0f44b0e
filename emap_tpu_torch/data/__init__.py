from emap_tpu_torch.data.dataset import (
    RayPool,
    SceneData,
    color_at,
    edge_at,
    gen_one_ray_at,
    gen_rays_at,
    importance_cdf,
    load_scene,
    rays_at_pixels,
    rays_from_pixels,
    sample_rays,
)
from emap_tpu_torch.data.png import read_png, write_png
from emap_tpu_torch.data.synthetic import make_synthetic_scene

__all__ = [
    "RayPool",
    "SceneData",
    "color_at",
    "edge_at",
    "gen_one_ray_at",
    "gen_rays_at",
    "importance_cdf",
    "load_scene",
    "rays_at_pixels",
    "rays_from_pixels",
    "sample_rays",
    "read_png",
    "write_png",
    "make_synthetic_scene",
]
