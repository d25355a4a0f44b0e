"""Visualization helpers (port of emap_tpu/utils/vis.py), without cv2.

The JET lookup table is built the way OpenCV builds COLORMAP_JET
(modules/imgproc/src/colormap.cpp), so it equals it byte for byte. The
angle-field view repeats, in numpy float32, the arithmetic of the three
OpenCV calls the JAX package makes (cartToPolar, normalize NORM_MINMAX,
cvtColor HSV2RGB), fused multiply-adds included, so its bytes equal the
JAX function's.
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


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as a hardware FMA gives it. The
    product is exact in float64; where the float64 sum falls on a float32
    rounding midpoint that it only reached by rounding, the sum's exact
    error (TwoSum) decides the side."""
    a, b, c = (np.asarray(t, np.float32) for t in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bv = s - p
    err = (p - (s - bv)) + (c64 - bv)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.inf, -np.inf).astype(np.float32))
    tie = ((s == (r.astype(np.float64) + other.astype(np.float64)) * 0.5)
           & (err != 0) & (s != r))
    return np.where(tie, np.where(err > 0, np.maximum(r, other),
                                  np.minimum(r, other)), r)


# OpenCV's fastAtan2 polynomial (core/src/mathfuncs_core.simd.hpp), each
# coefficient scaled to degrees in float32
_ATAN_P = [np.float32(np.float32(c) * np.float32(180 / np.pi))
           for c in (0.9997878412794807, -0.3258083974640975,
                     0.1555786518463281, -0.04432655554792128)]
_DBL_EPS = np.float32(np.finfo(np.float64).eps)
# cartToPolar runs its scalar loop on arrays shorter than two vectors
_SIMD_MIN = 16


def _cart_to_polar(x: np.ndarray, y: np.ndarray):
    """cv2.cartToPolar(x, y, angleInDegrees=True) on float32 arrays:
    (magnitude, angle in [0, 360]). The magnitude is sqrt(fma(x, x, y*y));
    the angle a polynomial in c = min/(max + DBL_EPSILON), folded by
    octant. OpenCV's scalar loop, which it takes for arrays of fewer than
    16 elements, also fuses the 90 - p*c of the steep octants."""
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    mag = np.sqrt(_fma32(x, x, y * y))
    ax, ay = np.abs(x), np.abs(y)
    c = np.minimum(ax, ay) / (np.maximum(ax, ay) + _DBL_EPS)
    cc = c * c
    p = _fma32(_fma32(_fma32(cc, _ATAN_P[3], _ATAN_P[2]), cc, _ATAN_P[1]),
               cc, _ATAN_P[0])
    pc = p * c
    steep = (np.float32(90) - pc if x.size >= _SIMD_MIN
             else _fma32(-p, c, np.float32(90)))
    a = np.where(ax >= ay, pc, steep)
    a = np.where(x < 0, np.float32(180) - a, a)
    a = np.where(y < 0, np.float32(360) - a, a)
    return mag, a.astype(np.float32)


def _normalize_minmax(src: np.ndarray) -> np.ndarray:
    """cv2.normalize(src, None, 0, 255, cv2.NORM_MINMAX) on float32: scale
    and shift rounded to float32, then one FMA an element. A constant
    array (max - min <= DBL_EPSILON) maps to 0 everywhere."""
    src = np.asarray(src, np.float32)
    smin, smax = float(src.min()), float(src.max())
    span = smax - smin
    scale = np.float32(255.0 * (1.0 / span if span > np.finfo(
        np.float64).eps else 0.0))
    shift = np.float32(0.0) - np.float32(smin * float(scale))
    return _fma32(src, scale, shift)


# OpenCV's HSV-to-RGB sectors: (b, g, r) as indices into (v, p, q, t)
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])
# cvtColor converts each row 32 pixels a vector step, the rest one by one
_HSV_SIMD_PIXELS = 32


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) on an (H, W, 3) uint8 image
    (hue range 180), in float32 with the sector's fused 1 - s*h terms.
    OpenCV's vector loop truncates to uint8 and its scalar loop, which
    takes the last W mod 32 pixels of each row, folds the hue with fmod
    and rounds half to even; both are reproduced."""
    one = np.float32(1)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180.0)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    width = hsv.shape[1]
    scalar = np.arange(width) >= width - width % _HSV_SIMD_PIXELS
    # the scalar loop's fmod(h, 6) reaches the vector loop's sector mod 6
    h = np.where(scalar, np.fmod(h, np.float32(6)), h)
    sector = np.floor(h)
    h = h - sector
    tab = np.stack([v, v * (one - s), v * _fma32(-s, h, one),
                    v * _fma32(-s, one - h, one)], axis=-1)
    bgr = np.take_along_axis(
        tab, _HSV_SECTORS[sector.astype(np.int64) % 6], axis=-1)
    rgb = bgr[..., ::-1] * np.float32(255)
    rgb = np.where(scalar[:, None], np.rint(rgb), np.trunc(rgb))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def get_flow_vis(ang: np.ndarray, magnitude: float = 5.0) -> np.ndarray:
    """Angle-field view: hue = angle, value = magnitude normalized to
    [0, 255], full saturation; (..., 3) uint8 RGB, byte for byte the JAX
    package's OpenCV version. With a constant magnitude (the default) the
    normalization sees max == min and the value is 0 everywhere, as
    OpenCV's is."""
    u = magnitude * np.cos(ang)
    v = magnitude * np.sin(ang)
    mag, angle = _cart_to_polar(u.astype(np.float32), v.astype(np.float32))
    hsv = np.zeros((*np.shape(ang), 3), dtype=np.uint8)
    hsv[..., 0] = (angle / 2).astype(np.uint8)  # OpenCV hue range 0..180
    hsv[..., 1] = 255
    hsv[..., 2] = _normalize_minmax(mag).astype(np.uint8)
    return _hsv_to_rgb(hsv)


def semantic_color_map(n: int = 256, seed: int = 1) -> np.ndarray:
    """Deterministic categorical color map (n, 3) in [0, 1) for semantic
    visualizations, the JAX package's table."""
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=(n, 3))
