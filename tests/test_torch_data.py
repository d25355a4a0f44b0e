"""The port's scene loading, PNG codec and ray generation
(emap_tpu_torch/data) against the JAX package and cv2 on the CPU.

Scenes are written by the JAX package's `make_synthetic_scene` (cv2) for
the square, non-square and off-centre cameras of tests/test_nonsquare.py;
the port must read them bit for bit as cv2 does and build the same rays."""

import json
import os
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu import config as jconfig
from emap_tpu.data import dataset as jds
from emap_tpu.data import make_synthetic_scene as j_make_scene
from emap_tpu.data import synthetic as jsyn
from emap_tpu_torch import config as tconfig
from emap_tpu_torch.data import dataset as tds
from emap_tpu_torch.data import png
from emap_tpu_torch.data import synthetic as tsyn

SCENES = {
    "square": dict(H=32, W=32, pp_offset=(0.0, 0.0)),
    "nonsquare": dict(H=80, W=48, pp_offset=(0.0, 0.0)),
    "offcentre": dict(H=80, W=48, pp_offset=(3.5, -2.5)),
}


def dataset_conf(module, root):
    return module.Config({"data_dir": root, "scan": "cube000",
                          "dataset_name": "NEF", "detector": "DexiNed",
                          "near": 0.05, "far": 4.5})


@pytest.fixture(scope="module", params=list(SCENES))
def scenes(request, tmp_path_factory):
    """(JAX scene, port scene) loaded from one JAX-written scan."""
    root = str(tmp_path_factory.mktemp(request.param))
    j_make_scene(root, scan="cube000", n_views=3, **SCENES[request.param])
    return (jds.load_scene(dataset_conf(jconfig, root)),
            tds.load_scene(dataset_conf(tconfig, root)))


def test_load_scene_matches_cv2_reader(scenes):
    """Edges and colours bit-identical to cv2's reads; cameras equal."""
    js, ts = scenes
    for path in js.edge_paths:
        np.testing.assert_array_equal(png.read_png(path, gray=True),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    for path in js.color_paths:
        np.testing.assert_array_equal(png.read_png(path), cv2.imread(path))
    np.testing.assert_array_equal(ts.edges, js.edges)
    np.testing.assert_array_equal(ts.colors, js.colors)
    for k in ("intrinsics", "intrinsics_inv", "poses", "aabb"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))
    assert (ts.H, ts.W, ts.n_images, ts.near, ts.far) == (
        js.H, js.W, js.n_images, js.near, js.far)


def test_rays_on_given_pixels(scenes):
    """Corner and interior pixels: rays_o, rays_d, depth_scale vs the JAX
    package's _rays_from_pixels (float32 camera math at HIGHEST)."""
    js, ts = scenes
    jpool = jds.RayPool.from_scene(js)
    tpool = tds.RayPool.from_scene(ts, device="cpu")
    px = np.array([0, js.W - 1, 0, js.W - 1, 13.0], np.float32)
    py = np.array([0, 0, js.H - 1, js.H - 1, 21.0], np.float32)
    for img in range(js.n_images):
        want = jds._rays_from_pixels(jpool, img, jnp.asarray(px),
                                     jnp.asarray(py))
        got = tds.rays_from_pixels(tpool, img, torch.as_tensor(px),
                                   torch.as_tensor(py))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
        batch = tds.rays_at_pixels(tpool, img, torch.as_tensor(px),
                                   torch.as_tensor(py))
        np.testing.assert_array_equal(
            batch["edge"][:, 0].numpy(),
            ts.edges[img, py.astype(int), px.astype(int)])


def test_full_image_rays_match(scenes):
    js, ts = scenes
    for level in (1, 2):
        for g, w in zip(tds.gen_rays_at(ts, 1, level),
                        jds.gen_rays_at(js, 1, level)):
            np.testing.assert_array_equal(g, w)


def test_importance_cdf_and_sampling(scenes):
    """The same inverse-CDF table; the sampler's importance half lands on
    edge pixels with the probability the table gives them."""
    js, ts = scenes
    np.testing.assert_array_equal(tds.importance_cdf(ts.edges),
                                  jds.importance_cdf(js.edges))
    pool = tds.RayPool.from_scene(ts, device="cpu")
    gen = torch.Generator().manual_seed(0)
    n = 8192
    out = tds.sample_rays(pool, 1, gen, n, importance_sample=True)
    uv = out["rays_ndc_uv"].numpy()
    px = np.round((uv[:, 0] + 1.0) * (ts.W - 1) / 2.0).astype(int)
    py = np.round((uv[:, 1] + 1.0) * (ts.H - 1) / 2.0).astype(int)
    np.testing.assert_array_equal(out["edge"][:, 0].numpy(),
                                  ts.edges[1, py, px])
    on_edge = ts.edges[1].reshape(-1) > 0.1
    probs = np.diff(np.concatenate([[0.0], tds.importance_cdf(ts.edges)[1]]))
    p_edge = float(probs[on_edge].sum())
    hits = on_edge[py[n // 2:] * ts.W + px[n // 2:]]
    # binomial: 5 standard deviations
    assert abs(hits.mean() - p_edge) < 5 * np.sqrt(p_edge * (1 - p_edge)
                                                  / (n // 2))
    # the same generator state gives the same batch
    again = tds.sample_rays(pool, 1, torch.Generator().manual_seed(0), n)
    assert torch.equal(again["rays_d"], out["rays_d"])


def _png_with_filters(img: np.ndarray) -> bytes:
    """Encode an (H, W) or (H, W, 3) uint8 image as RGB/gray PNG, row r
    filtered with type r % 5 (None, Sub, Up, Average, Paeth)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 3
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    for r in range(h):
        cur = rows[r]
        up = rows[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        ft = r % 5
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8)
                   .tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         0 if ch == 1 else 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(23, 17), (19, 11, 3)])
def test_png_filters_and_colour(tmp_path, shape):
    """Every filter type decodes to the source pixels, as cv2 decodes it;
    colour comes back BGR and as cv2's gray conversion."""
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_with_filters(img if img.ndim == 2 else img[..., ::-1]))
    np.testing.assert_array_equal(png.read_png(path, gray=img.ndim == 2), img)
    np.testing.assert_array_equal(png.read_png(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(png.read_png(path, gray=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_png_writer_read_by_cv2(tmp_path):
    rng = np.random.default_rng(6)
    gray = rng.integers(0, 256, (13, 29), dtype=np.uint8)
    bgr = rng.integers(0, 256, (13, 29, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "g.png"), gray)
    png.write_png(str(tmp_path / "c.png"), bgr)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "g.png"),
                                             cv2.IMREAD_GRAYSCALE), gray)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "c.png")), bgr)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "x.png"), gray.astype(np.float32))


@pytest.mark.parametrize("obj", ["cube", "rings"])
def test_port_scene_writer_matches_layout(tmp_path, obj):
    """The port's synthetic scene: the JAX package's cameras and layout,
    readable by both loaders, with the edge maps cv2 drew, pixel for
    pixel."""
    kw = dict(scan="cube000", n_views=2 if obj == "cube" else 1, H=48, W=40,
              pp_offset=(2.0, -1.0), obj=obj)
    tsyn.make_synthetic_scene(str(tmp_path / "t"), **kw)
    j_make_scene(str(tmp_path / "j"), **kw)
    ts = tds.load_scene(dataset_conf(tconfig, str(tmp_path / "t")))
    js = jds.load_scene(dataset_conf(jconfig, str(tmp_path / "j")))
    jt = jds.load_scene(dataset_conf(jconfig, str(tmp_path / "t")))
    np.testing.assert_array_equal(jt.edges, ts.edges)
    for k in ("intrinsics", "poses", "aabb"):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))
    assert (ts.edges > 0.3).any()
    np.testing.assert_array_equal(ts.edges, js.edges)


SCENE_WRITES = {
    "cube128": dict(n_views=24, H=128, W=128, obj="cube"),
    "rings128": dict(n_views=24, H=128, W=128, obj="rings"),
    "cube400": dict(n_views=1, H=400, W=400, obj="cube"),
    "offcentre": dict(n_views=6, H=37, W=61, obj="rings",
                      pp_offset=(-7.5, 4.0)),
}


@pytest.mark.parametrize("name", list(SCENE_WRITES))
def test_scene_writer_pixels_equal_cv2(tmp_path, name):
    """Every edge and colour PNG of the port's scene decodes to the pixels
    of the JAX package's cv2-drawn one; the JSON metadata is the same."""
    kw = SCENE_WRITES[name]
    t_dir = tsyn.make_synthetic_scene(str(tmp_path / "t"), **kw)
    j_dir = j_make_scene(str(tmp_path / "j"), **kw)
    with open(os.path.join(t_dir, "meta_data.json")) as f, open(
            os.path.join(j_dir, "meta_data.json")) as g:
        assert json.load(f) == json.load(g)
    lit = 0
    for sub in ("edge_DexiNed", "color"):
        names = sorted(os.listdir(os.path.join(j_dir, sub)))
        assert names == sorted(os.listdir(os.path.join(t_dir, sub)))
        assert len(names) == kw["n_views"]
        for n in names:
            want = cv2.imread(os.path.join(j_dir, sub, n),
                              cv2.IMREAD_UNCHANGED)
            got = cv2.imread(os.path.join(t_dir, sub, n),
                             cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(got, want, err_msg=f"{sub}/{n}")
            lit += int((want > 0).sum())
    assert lit > 0


def test_line_aa_equals_cv2_line():
    """Random integer segments, many clipped at the border or wholly
    outside, drawn into one array in turn: cv2.line(..., 1, LINE_AA) and
    draw_lines_aa agree on every pixel, overlaps included."""
    rng = np.random.default_rng(7)
    for h, w in ((31, 47), (64, 64), (9, 120)):
        p1 = rng.integers(-60, max(h, w) + 60, (400, 2))
        p2 = rng.integers(-60, max(h, w) + 60, (400, 2))
        p2[:40] = p1[:40]  # single points
        p2[40:80, 0] = p1[40:80, 0]  # vertical
        p2[80:120, 1] = p1[80:120, 1]  # horizontal
        p2[120:160] = p1[120:160] + rng.choice(
            [-1, 1], (40, 1)) * rng.integers(1, 30, (40, 1))  # diagonal
        p1[160:170] = [-2 ** 31, 2 ** 31 - 1]  # far outside, as int32 ends
        want = np.zeros((h, w), np.uint8)
        for a, b in zip(p1, p2):
            cv2.line(want, (int(a[0]), int(a[1])), (int(b[0]), int(b[1])),
                     255, 1, lineType=cv2.LINE_AA)
        got = np.zeros((h, w), np.uint8)
        tsyn.draw_lines_aa(got, p1, p2)
        np.testing.assert_array_equal(got, want)
        assert (want > 0).sum() > 0.2 * h * w


def test_scene_writer_thick_lines_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="line_px"):
        tsyn.make_synthetic_scene(str(tmp_path), n_views=1, H=16, W=16,
                                  line_px=2)


def test_gt_samplers_equal():
    for kw in ({}, {"spacing": 0.01}, {"half": 0.3}):
        np.testing.assert_array_equal(tsyn.sample_cube_edge_points(**kw),
                                      jsyn.sample_cube_edge_points(**kw))
    for kw in ({}, {"spacing": 0.02}, {"radius": 0.01}):
        np.testing.assert_array_equal(tsyn.sample_ring_edge_points(**kw),
                                      jsyn.sample_ring_edge_points(**kw))
