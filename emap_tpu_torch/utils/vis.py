"""Visualization helpers (port of emap_tpu/utils/vis.py::visualize_depth),
without cv2.

The JET lookup table is built the way OpenCV builds COLORMAP_JET
(modules/imgproc/src/colormap.cpp), so it equals it byte for byte.
"""

from __future__ import annotations

import numpy as np

# the Octave "jet" map: control points and each channel's value there
_JET_X = np.array([0, 1, 3, 5, 7, 8]) / 8
_JET_BGR = ([0.5, 1, 1, 0, 0, 0], [0, 0, 1, 1, 0, 0], [0, 0, 0, 1, 1, 0.5])


def _jet_table() -> np.ndarray:
    """(256, 3) uint8 BGR, as cv2.applyColorMap(arange(256), COLORMAP_JET).

    OpenCV stores the map sampled at x = i/255 as float32, interpolates it
    again in float32 at the same points (interp1: y[i-1] + dx * (y[i] -
    y[i-1]) / dx, which is not always y[i]), then scales by 255 and rounds
    half to even."""
    f32 = np.float32
    base = np.stack([np.interp(np.arange(256) / 255, _JET_X, c)
                     for c in _JET_BGR]).astype(f32)
    x = np.arange(256, dtype=f32) * (f32(1) / f32(255))
    dx = x[1:] - x[:-1]
    y = base.copy()
    y[:, 1:] = base[:, :-1] + dx * (base[:, 1:] - base[:, :-1]) / dx
    return np.rint(y.T * f32(255)).astype(np.uint8)


JET_BGR = _jet_table()


def visualize_depth(depth: np.ndarray) -> np.ndarray:
    """Normalize a depth map to [0, 255] and apply the JET colormap.
    Returns an (H, W, 3) uint8 image in OpenCV's BGR channel order, as the
    JAX package's cv2.applyColorMap call does."""
    x = np.nan_to_num(np.asarray(depth, dtype=np.float64))
    mi, ma = float(x.min()), float(x.max())
    x = (x - mi) / max(ma - mi, 1e-8)
    x8 = (255 * x).astype(np.uint8)
    return JET_BGR[x8]
