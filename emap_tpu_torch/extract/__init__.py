"""Edge extraction (port of emap_tpu/extract): the zero-set point cloud on
the device, then fitting, merging and threshold selection on the host."""

from emap_tpu_torch.extract.parametric import get_parametric_edge
from emap_tpu_torch.extract.pointcloud import (
    extract_fields,
    extract_gradient_fields,
    extract_pointcloud,
    extract_pointcloud_multi,
)

__all__ = [
    "extract_fields",
    "extract_gradient_fields",
    "extract_pointcloud",
    "extract_pointcloud_multi",
    "get_parametric_edge",
]
