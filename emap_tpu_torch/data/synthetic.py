"""Synthetic wireframe scenes (port of emap_tpu/data/synthetic.py).

The wireframe of a cube (or three rings) is projected into 2D edge maps
from cameras on a sphere and written in the reference data layout
(meta_data.json + edge_DexiNed/ + color/), so the production loader reads
it. Lines are drawn by `draw_lines_aa`, a numpy port of OpenCV's
thickness-1 anti-aliased line (`cv2.line(..., 1, cv2.LINE_AA)`, which the
JAX package draws with), pixel for pixel; the images are written with the
port's own PNG codec, so the files' bytes differ from cv2's while the
decoded pixels are equal. The analytic ground-truth samplers score an
extraction against the drawn wireframe.
"""

from __future__ import annotations

import json
import os

import numpy as np

from emap_tpu_torch.data.png import write_png


def cube_edges(half: float = 0.5) -> np.ndarray:
    """12 wireframe segments of the cube [-half, half]^3, (12, 2, 3)."""
    corners = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                        for z in (-half, half)], dtype=np.float64)
    pairs = [(i, j) for i in range(8) for j in range(i + 1, 8)
             if np.sum(np.abs(corners[i] - corners[j]) > 1e-9) == 1]
    return np.stack([np.stack([corners[i], corners[j]]) for i, j in pairs])


def ring_edges(radius: float = 0.5, n_chords: int = 96) -> np.ndarray:
    """Chords of three orthogonal circles, (3*n_chords, 2, 3)."""
    theta = np.linspace(0.0, 2.0 * np.pi, n_chords + 1)
    c, s = radius * np.cos(theta), radius * np.sin(theta)
    z = np.zeros_like(c)
    circles = [np.stack(a, axis=1) for a in ((c, s, z), (c, z, s), (z, c, s))]
    return np.concatenate([np.stack([p[:-1], p[1:]], axis=1) for p in circles])


_OBJECTS = {"cube": cube_edges, "rings": ring_edges}


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world pose, OpenCV convention (z forward, y down)."""
    forward = target - eye
    forward /= np.linalg.norm(forward)
    tmp = np.array([0.0, 0.0, 1.0])
    if abs(forward @ tmp) > 0.98:
        tmp = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, tmp)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, forward, eye
    return pose


# OpenCV's LineAA (imgproc/src/drawing.cpp): coordinates in 16.16 fixed
# point, a 3-pixel-wide filter across the line and end-point corrections.
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_SLOPE_CORR = np.array([
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196,
    198, 201, 203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238,
    242, 246, 250, 254], np.int64)
_FILTER = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8,
    7, 5, 5], np.int64)


def _clip_lines(width, height, x1, y1, x2, y2):
    """OpenCV's clipLine for int64 fixed-point segments against the box
    [0, width) x [0, height), vectorized: (inside, x1, y1, x2, y2). The
    interpolations run in float64 and truncate toward zero, as C's casts do."""
    right, bottom = width - 1, height - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4
                + (y > bottom) * 8).astype(np.int64)

    def shift(move, a, base_a, other, da, db):
        # other + (a - base_a) * db / da where `move`, in C's double math
        with np.errstate(divide="ignore", invalid="ignore"):
            step = (a - base_a).astype(np.float64) * db.astype(
                np.float64) / da.astype(np.float64)
            step = np.where(move, step, 0.0).astype(np.int64)
        return np.where(move, other + step, other)

    c1, c2 = code(x1, y1), code(x2, y2)
    todo = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    move = todo & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = shift(move, a, y1, x1, y2 - y1, x2 - x1)
    y1 = np.where(move, a, y1)
    c1 = np.where(move, code(x1, np.zeros_like(y1)), c1)
    move = todo & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = shift(move, a, y2, x2, y2 - y1, x2 - x1)
    y2 = np.where(move, a, y2)
    c2 = np.where(move, code(x2, np.zeros_like(y2)), c2)
    todo &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    move = todo & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = shift(move, a, x1, y1, x2 - x1, y2 - y1)
    x1 = np.where(move, a, x1)
    c1 = np.where(move, 0, c1)
    move = todo & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = shift(move, a, x2, y2, x2 - x1, y2 - y1)
    x2 = np.where(move, a, x2)
    c2 = np.where(move, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def draw_lines_aa(img: np.ndarray, p1, p2, color: int = 255) -> None:
    """Draw segments p1[i] -> p2[i] ((N, 2) integer pixel (x, y)) into the
    C-contiguous uint8 (H, W) `img` in place, one after the other, exactly
    as N calls of `cv2.line(img, p1[i], p2[i], color, 1, cv2.LINE_AA)`
    would.

    Each segment steps one pixel along its major axis and covers three
    pixels across it, each blended toward `color` by a coverage alpha; the
    blends of all segments are applied per pixel in the segments' order."""
    if img.dtype != np.uint8 or img.ndim != 2 or not img.flags.c_contiguous:
        raise ValueError("draw_lines_aa draws into a C-contiguous (H, W) "
                         "uint8 image")
    h, w = img.shape
    p1 = np.asarray(p1, np.int64).reshape(-1, 2) << XY_SHIFT
    p2 = np.asarray(p2, np.int64).reshape(-1, 2) << XY_SHIFT
    inside, x1, y1, x2, y2 = _clip_lines(w << XY_SHIFT, h << XY_SHIFT,
                                         p1[:, 0], p1[:, 1], p2[:, 0],
                                         p2[:, 1])
    x1, y1, x2, y2 = x1[inside], y1[inside], x2[inside], y2[inside]
    # u: the major axis (x where |dx| > |dy|), v: the minor; then u ascends
    xmajor = np.abs(x2 - x1) > np.abs(y2 - y1)
    u1, v1 = np.where(xmajor, x1, y1), np.where(xmajor, y1, x1)
    u2, v2 = np.where(xmajor, x2, y2), np.where(xmajor, y2, x2)
    flip = u2 < u1
    u1, u2 = np.where(flip, u2, u1), np.where(flip, u1, u2)
    v1, v2 = np.where(flip, v2, v1), np.where(flip, v1, v2)
    du, dv = u2 - u1, v2 - v1
    num = dv << XY_SHIFT
    v_step = np.sign(num) * (np.abs(num) // (du | 1))  # C's truncation
    u2 = u2 + XY_ONE
    ecount = (u2 >> XY_SHIFT) - (u1 >> XY_SHIFT)
    v1 = v1 + ((v_step * -(u1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = ((v_step >> (XY_SHIFT - 5)) & 0x3F) ^ np.where(v_step < 0, 0x3F, 0)
    slope = np.where(slope & 0x20, 0x100, _SLOPE_CORR[slope & 0x1F])
    # end-point correction table, (n, 9)
    i = (u1 >> (XY_SHIFT - 7)) & 0x78
    j = (u2 >> (XY_SHIFT - 7)) & 0x78
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    e13 = (((((j - i) & 0x78) | 4) * slope) >> 8) & 0x1FF
    ep = np.stack([np.zeros_like(slope), e13, (t1 >> 8) & 0x1FF, e13,
                   (((((j - i) + 0x80) | 4) * slope) >> 8) & 0x1FF,
                   ((t1 + t0) >> 8) & 0x1FF, (t2 >> 8) & 0x1FF,
                   ((t2 + t0) >> 8) & 0x1FF, slope], axis=1)

    # every step of every segment, in drawing order
    n_steps = ecount + 1
    seg = np.repeat(np.arange(len(n_steps)), n_steps)
    k = np.arange(len(seg)) - np.repeat(np.cumsum(n_steps) - n_steps, n_steps)
    s_count, e_count = k, ecount[seg] - k
    u = (u1[seg] >> XY_SHIFT) + k
    v_fix = v1[seg] + k * v_step[seg]
    v = (v_fix >> XY_SHIFT) - 1
    dist = (v_fix >> (XY_SHIFT - 5)) & 31
    corr = ep[seg, (((s_count >= 2) + 1) & (s_count | 2)) * 3
              + (((e_count >= 2) + 1) & (e_count | 2))]
    major_size = np.where(xmajor[seg], w, h)
    minor_size = np.where(xmajor[seg], h, w)
    vv = v[:, None] + np.arange(3)
    ok = ((u >= 0) & (u < major_size))[:, None] & (vv >= 0) & (
        vv < minor_size[:, None])
    # boolean indexing keeps the C loop's (step, tap) order
    uu, xm = u[:, None], xmajor[seg][:, None]
    pix = np.where(xm, vv * w + uu, uu * w + vv)[ok]
    taps = np.stack([dist + 32, dist, 63 - dist], axis=1)
    alpha = ((corr[:, None] * _FILTER[taps]) >> 8)[ok] & 0xFF
    # fold each pixel's blends in drawing order: the r-th blend of every
    # pixel at once
    by_pix = np.argsort(pix, kind="stable")
    pix, alpha = pix[by_pix], alpha[by_pix]
    first = np.r_[True, pix[1:] != pix[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(pix)), 0))
    rank = np.arange(len(pix)) - start
    flat = img.reshape(-1)
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = rank == r
        p, a = pix[sel], alpha[sel]
        c = flat[p].astype(np.int64)
        c += ((color - c) * a + 127) >> 8  # the 1-channel blend runs twice
        c += ((color - c) * a + 127) >> 8
        flat[p] = c


def sample_cube_edge_points(half: float = 0.5, spacing: float = 0.005):
    """Densely sampled GT points along the cube's wireframe."""
    pts = []
    for seg in cube_edges(half):
        length = np.linalg.norm(seg[1] - seg[0])
        n = max(int(length / spacing), 2)
        t = np.linspace(0, 1, n)[:, None]
        pts.append(seg[0] * (1 - t) + seg[1] * t)
    return np.concatenate(pts).astype(np.float32)


def sample_ring_edge_points(radius: float = 0.5, spacing: float = 0.005):
    """Densely sampled GT points along the three rings."""
    n = max(int(2.0 * np.pi * radius / spacing), 8)
    theta = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    c, s = radius * np.cos(theta), radius * np.sin(theta)
    z = np.zeros_like(c)
    return np.concatenate([np.stack([c, s, z], axis=1),
                           np.stack([c, z, s], axis=1),
                           np.stack([z, c, s], axis=1)]).astype(np.float32)


def make_synthetic_scene(out_dir: str, scan: str = "cube000", n_views: int = 24,
                         H: int = 96, W: int = 96, cam_radius: float = 2.2,
                         near: float = 0.05, far: float = 4.5,
                         detector: str = "DexiNed", line_px: int = 1,
                         obj: str = "cube",
                         pp_offset: tuple = (0.0, 0.0)) -> str:
    """Write a synthetic wireframe scan under out_dir/<scan>/ (white edges
    on black, golden-spiral cameras); returns the scan directory. The
    principal point sits at (W/2 + dx, H/2 + dy) for pp_offset (dx, dy).
    Only 1-pixel lines (`line_px` 1, the JAX package's default) are
    ported."""
    if line_px != 1:
        raise NotImplementedError(f"line_px {line_px}: only OpenCV's "
                                  "1-pixel anti-aliased line is ported "
                                  "(ROADMAP.md queue 1)")
    scan_dir = os.path.join(out_dir, scan)
    edge_subdir = "edge_PidiNet" if detector == "PidiNet" else "edge_DexiNed"
    os.makedirs(os.path.join(scan_dir, edge_subdir), exist_ok=True)
    os.makedirs(os.path.join(scan_dir, "color"), exist_ok=True)

    focal = 1.4 * max(H, W)
    K = np.array([[focal, 0, W / 2.0 + pp_offset[0], 0],
                  [0, focal, H / 2.0 + pp_offset[1], 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]])
    segments = _OBJECTS[obj](0.5)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    frames = []
    for i in range(n_views):
        z = 1.0 - 2.0 * (i + 0.5) / n_views
        r = np.sqrt(max(1.0 - z * z, 1e-9))
        theta = golden * i
        eye = cam_radius * np.array([r * np.cos(theta), r * np.sin(theta), z])
        pose = _look_at(eye, np.zeros(3))
        worldtocam = np.linalg.inv(pose)
        img = np.zeros((H, W), dtype=np.uint8)
        starts, ends = [], []
        for seg in segments:
            # 63 pieces a segment, each drawn where both ends lie in front
            t = np.linspace(0, 1, 64)[:, None]
            pts3 = seg[0] * (1 - t) + seg[1] * t
            cam = (worldtocam[:3, :3] @ pts3.T + worldtocam[:3, 3:]).T
            valid = cam[:, 2] > 1e-6
            uv = (K[:3, :3] @ cam.T).T
            uv_int = np.round(uv[:, :2] / uv[:, 2:3]).astype(np.int32)
            keep = valid[:-1] & valid[1:]
            starts.append(uv_int[:-1][keep])
            ends.append(uv_int[1:][keep])
        draw_lines_aa(img, np.concatenate(starts), np.concatenate(ends))
        name = f"{i:03d}.png"
        write_png(os.path.join(scan_dir, edge_subdir, name), img)
        write_png(os.path.join(scan_dir, "color", name),
                  np.stack([img] * 3, axis=-1))
        frames.append({"intrinsics": K.tolist(), "camtoworld": pose.tolist(),
                       "rgb_path": name})

    meta = {
        "height": H,
        "width": W,
        "scene_box": {"near": near, "far": far, "radius": 1.0,
                      "aabb": [[-1, -1, -1], [1, 1, 1]]},
        "worldtogt": np.eye(4).tolist(),
        "frames": frames,
    }
    with open(os.path.join(scan_dir, "meta_data.json"), "w") as f:
        json.dump(meta, f)
    return scan_dir
