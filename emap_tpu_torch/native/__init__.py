"""Native (C++, ctypes) pieces of the extraction's host side."""

from emap_tpu_torch.native.loader import connect_points_native

__all__ = ["connect_points_native"]
