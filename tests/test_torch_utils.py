"""The port's visualization helpers (emap_tpu_torch/utils/vis.py) against
the JAX package's (emap_tpu/utils/vis.py, through OpenCV) on the CPU.

The port draws without cv2; every comparison here is byte for byte (or
bit for bit on float32), on inputs made from a seed with numpy."""

import cv2
import numpy as np
import pytest

from emap_tpu.utils import vis as jvis
from emap_tpu_torch.utils import vis as tvis


def _field(name):
    rng = np.random.default_rng(0)
    if name == "linspace8x8":  # tests/test_utils.py's field
        return np.linspace(0, 2 * np.pi, 64).reshape(8, 8)
    if name == "random256":
        return rng.uniform(-np.pi, 3 * np.pi, (256, 256))
    if name == "random7x9":
        return rng.uniform(0, 2 * np.pi, (7, 9))
    if name == "random3x4":  # below one SIMD pair: OpenCV's scalar loop
        return rng.uniform(0, 2 * np.pi, (3, 4))
    if name == "float32_400":
        return rng.uniform(0, 2 * np.pi, (400, 400)).astype(np.float32)
    raise KeyError(name)


@pytest.mark.parametrize("magnitude", [5.0, 0.37])
@pytest.mark.parametrize("name", ["linspace8x8", "random256", "random7x9",
                                  "random3x4", "float32_400"])
def test_get_flow_vis_equals_jax(name, magnitude):
    ang = _field(name)
    want = jvis.get_flow_vis(ang, magnitude)
    got = tvis.get_flow_vis(ang, magnitude)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_get_flow_vis_constant_magnitude_has_zero_value():
    """On the 8x8 field every magnitude is 5.0 exactly, so NORM_MINMAX sees
    max == min and writes V = 0: the image is black in both packages."""
    ang = _field("linspace8x8")
    mag, _ = tvis._cart_to_polar((5.0 * np.cos(ang)).astype(np.float32),
                                 (5.0 * np.sin(ang)).astype(np.float32))
    assert mag.min() == mag.max() == 5.0
    got = tvis.get_flow_vis(ang)
    assert not got.any()
    np.testing.assert_array_equal(got, jvis.get_flow_vis(ang))


@pytest.mark.parametrize("shape", [(256, 256), (7, 9), (3, 4), (1, 15),
                                   (1, 16), (1, 1)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_cart_to_polar_equals_cv2(shape, scale):
    """The port's cartToPolar on (u, v) fields whose magnitude varies,
    bit for bit (magnitude and angle in degrees)."""
    rng = np.random.default_rng(int(scale * 1000) + shape[0] * 31 + shape[1])
    u = (scale * rng.normal(size=shape)).astype(np.float32)
    v = (scale * rng.normal(size=shape)).astype(np.float32)
    u[0, 0] = 0.0  # an axis point
    mag, ang = tvis._cart_to_polar(u, v)
    want_mag, want_ang = cv2.cartToPolar(u, v, angleInDegrees=True)
    np.testing.assert_array_equal(mag, want_mag)
    np.testing.assert_array_equal(ang, want_ang)


@pytest.mark.parametrize("shape", [(256, 256), (7, 9), (1, 5)])
@pytest.mark.parametrize("offset", [0.0, 37.5])
def test_normalize_minmax_equals_cv2(shape, offset):
    rng = np.random.default_rng(shape[1] + int(offset))
    u = rng.normal(size=shape).astype(np.float32)
    v = rng.normal(size=shape).astype(np.float32)
    mag = cv2.magnitude(u, v) + np.float32(offset)
    got = tvis._normalize_minmax(mag)
    want = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.astype(np.uint8), want.astype(np.uint8))
    const = np.full(shape, 5.0, np.float32)
    np.testing.assert_array_equal(
        tvis._normalize_minmax(const),
        cv2.normalize(const, None, 0, 255, cv2.NORM_MINMAX))


@pytest.mark.parametrize("width", [256, 31])
@pytest.mark.parametrize("s", [255, 0, 1, 128])
def test_hsv_to_rgb_equals_cv2_exhaustively(s, width):
    """Every (h, v) with h 0-180 and v 0-255 at saturation s; s = 255 is
    every pixel get_flow_vis can produce. Rows of 256 pixels go through
    OpenCV's vector loop, rows of 31 through its scalar one."""
    h, v = np.meshgrid(np.arange(181), np.arange(256), indexing="ij")
    hsv = np.stack([h, np.full_like(h, s), v], axis=-1).astype(np.uint8)
    hsv = hsv.reshape(-1, 3)
    hsv = np.concatenate([hsv, hsv[:(-len(hsv)) % width]]).reshape(
        -1, width, 3)
    np.testing.assert_array_equal(tvis._hsv_to_rgb(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_hsv_to_rgb_small_images_equal_cv2():
    """Images of fewer pixels than a SIMD block, where OpenCV may take its
    scalar loop."""
    rng = np.random.default_rng(3)
    for n in range(1, 40):
        hsv = np.stack([rng.integers(0, 181, (1, n)),
                        np.full((1, n), 255), rng.integers(0, 256, (1, n))],
                       axis=-1).astype(np.uint8)
        np.testing.assert_array_equal(tvis._hsv_to_rgb(hsv),
                                      cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("n,seed", [(256, 1), (40, 1), (7, 0), (1000, 42)])
def test_semantic_color_map_equals_jax(n, seed):
    got = tvis.semantic_color_map(n, seed)
    assert got.shape == (n, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jvis.semantic_color_map(n, seed))


def test_semantic_color_map_default_equals_jax():
    np.testing.assert_array_equal(tvis.semantic_color_map(),
                                  jvis.semantic_color_map())


def test_visualize_depth_equals_jax():
    depth = np.random.default_rng(0).uniform(1, 5, (31, 17))
    np.testing.assert_array_equal(tvis.visualize_depth(depth),
                                  jvis.visualize_depth(depth))
