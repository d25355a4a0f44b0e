"""Synthetic wireframe scenes (port of emap_tpu/data/synthetic.py).

The wireframe of a cube (or three rings) is projected into 2D edge maps
from cameras on a sphere and written in the reference data layout
(meta_data.json + edge_DexiNed/ + color/), so the production loader reads
it. Lines are drawn by `draw_lines_aa`, a numpy port of OpenCV's
anti-aliased line of any thickness (`cv2.line(..., t, cv2.LINE_AA)`, which
the JAX package draws with), pixel for pixel; the images are written with the
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


def _line_aa_events(width: int, height: int, x1, y1, x2, y2):
    """OpenCV's LineAA for the 16.16 fixed-point segments (x1, y1) ->
    (x2, y2) (int64 arrays) on a (height, width) image, as blend events in
    drawing order: (flat pixel index, alpha in 0..256, segment index).

    Each segment steps one pixel along its major axis and covers three
    pixels across it, each blended toward the color by a coverage alpha."""
    n_in = len(x1)
    inside, x1, y1, x2, y2 = _clip_lines(width << XY_SHIFT,
                                         height << XY_SHIFT, x1, y1, x2, y2)
    segment = np.arange(n_in)[inside]
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
    major_size = np.where(xmajor[seg], width, height)
    minor_size = np.where(xmajor[seg], height, width)
    vv = v[:, None] + np.arange(3)
    ok = ((u >= 0) & (u < major_size))[:, None] & (vv >= 0) & (
        vv < minor_size[:, None])
    # boolean indexing keeps the C loop's (step, tap) order
    uu, xm = u[:, None], xmajor[seg][:, None]
    pix = np.where(xm, vv * width + uu, uu * width + vv)[ok]
    taps = np.stack([dist + 32, dist, 63 - dist], axis=1)
    alpha = ((corr[:, None] * _FILTER[taps]) >> 8)[ok] & 0xFF
    return pix, alpha, np.broadcast_to(segment[seg][:, None], ok.shape)[ok]


def _blend(img: np.ndarray, pix, alpha, color: int) -> None:
    """Apply blend events (flat pixel, alpha), given in drawing order, to the
    uint8 image in place: OpenCV's 1-channel blend, which runs twice. An
    alpha of 256 writes `color` outright (a filled span's pixel); as every
    later blend toward `color` leaves it there, a pixel with such an event
    ends at `color` whatever else is drawn over it."""
    flat = img.reshape(-1)
    filled = np.zeros(flat.shape, bool)
    filled[pix[alpha > 255]] = True
    flat[filled] = color
    keep = ~filled[pix]
    pix, alpha = pix[keep], alpha[keep]
    # fold each pixel's blends in drawing order: the r-th blend of every
    # pixel at once
    by_pix = np.argsort(pix, kind="stable")
    pix, alpha = pix[by_pix], alpha[by_pix]
    first = np.r_[True, pix[1:] != pix[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(pix)), 0))
    rank = np.arange(len(pix)) - start
    by_rank = np.argsort(rank, kind="stable")
    pix, alpha = pix[by_rank], alpha[by_rank]
    bounds = np.r_[0, np.cumsum(np.bincount(rank))]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        p, a = pix[lo:hi], alpha[lo:hi]
        c = flat[p].astype(np.int64)
        c += ((color - c) * a + 127) >> 8
        c += ((color - c) * a + 127) >> 8
        flat[p] = c


# OpenCV's SinTable (imgproc/src/drawing.cpp): sin of each whole degree
# 0..450, written to 7 decimals and stored as float
_SIN_TABLE = np.round(np.sin(np.radians(np.arange(451))), 7).astype(
    np.float32).astype(np.float64)


def _fill_events(width: int, height: int, vx: np.ndarray, vy: np.ndarray):
    """OpenCV's FillConvexPoly with LINE_AA at shift 16, for P convex
    polygons of n vertices each ((P, n) int64 16.16 fixed point), without
    its outline: the filled spans as events (flat pixel, polygon index).

    The scan walks a left and a right chain from the top vertex, one row a
    step, each edge's x advanced by a rounded fixed-point slope; a row
    covers the pixels from ceil(left x) to floor(right x). Every polygon
    runs the C loop's steps in lockstep with the others."""
    n_poly, n = vx.shape
    half = XY_ONE >> 1
    imin = np.argmin(vy, axis=1)  # the first of the topmost vertices
    xmin = (vx.min(1) + half) >> XY_SHIFT
    xmax = (vx.max(1) + half) >> XY_SHIFT
    ymin = (vy.min(1) + half) >> XY_SHIFT
    ymax = np.minimum((vy.max(1) + half) >> XY_SHIFT, height - 1)
    active = ((n >= 3) & (xmax >= 0) & (ymax >= 0) & (xmin < width)
              & (ymin < height))
    rows = np.arange(n_poly)
    di = np.array([1, n - 1])
    e_idx = np.stack([imin, imin], 1)
    e_x = np.full((n_poly, 2), -XY_ONE, np.int64)
    e_dx = np.zeros((n_poly, 2), np.int64)
    e_ye = np.stack([ymin, ymin], 1)
    edges = np.full(n_poly, n, np.int64)
    y = ymin.copy()
    spans = []
    while active.any():
        update = active & ((y < ymax) | (y == ymin))
        for i in range(2):
            # find the next edge of chain i that ends below row y
            look = update & (y >= e_ye[:, i])
            idx0 = e_idx[:, i].copy()
            idx = (idx0 + di[i]) % n
            while look.any():
                more = edges > 0  # for (; edges-- > 0; )
                edges = edges - look
                go = look & more
                ty = (vy[rows, idx] + half) >> XY_SHIFT
                hit = go & (ty > y)
                xs, xe = vx[rows, idx0], vx[rows, idx]
                num = (xe - xs) * 2 + (ty - y)
                den = np.where(hit, 2 * (ty - y), 1)
                step = np.sign(num) * (np.abs(num) // den)  # C's truncation
                e_ye[:, i] = np.where(hit, ty, e_ye[:, i])
                e_dx[:, i] = np.where(hit, step, e_dx[:, i])
                e_x[:, i] = np.where(hit, xs, e_x[:, i])
                e_idx[:, i] = np.where(hit, idx, e_idx[:, i])
                look = go & ~hit
                idx0 = np.where(look, idx, idx0)
                idx = np.where(look, (idx + di[i]) % n, idx)
        active &= edges >= 0
        left = np.minimum(e_x[:, 0], e_x[:, 1])
        right = np.maximum(e_x[:, 0], e_x[:, 1])
        xx1 = np.maximum((left + XY_ONE - 1) >> XY_SHIFT, 0)
        xx2 = np.minimum(right >> XY_SHIFT, width - 1)
        draw = active & (y >= 0) & (right >> XY_SHIFT >= 0) & (
            (left + XY_ONE - 1) >> XY_SHIFT < width) & (xx2 >= xx1)
        spans.append(np.stack([rows, y, xx1, xx2], 1)[draw])
        e_x += e_dx
        y = y + 1
        active &= y <= ymax
    spans = np.concatenate(spans) if spans else np.zeros((0, 4), np.int64)
    length = spans[:, 3] - spans[:, 2] + 1
    first = np.repeat(np.cumsum(length) - length, length)
    col = spans[:, 2].repeat(length) + np.arange(length.sum()) - first
    pix = spans[:, 1].repeat(length) * width + col
    return pix, spans[:, 0].repeat(length)


def _cap_polygons(cx: np.ndarray, cy: np.ndarray, radius: int):
    """The vertices ((P, n) each) of OpenCV's filled anti-aliased disc
    (EllipseEx with equal axes `radius`, 16.16) around each 16.16 centre:
    ellipse2Poly's points every `delta` degrees (90, 30, 18 or 5, from the
    radius), rounded to whole fixed-point units the way EllipseEx rounds
    them. EllipseEx drops a point equal to the one before it; at a radius
    of a pixel or more (a thickness of 2 or more) none is."""
    delta = (radius + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    angle = np.minimum(np.arange(0, 360 + delta, delta), 360)
    px = cx[:, None].astype(np.float64) + radius * _SIN_TABLE[450 - angle]
    py = cy[:, None].astype(np.float64) + radius * _SIN_TABLE[angle]

    def fix(p):
        whole = np.rint(p / XY_ONE).astype(np.int64) << XY_SHIFT
        return whole + np.rint(p - whole).astype(np.int64)

    return fix(px), fix(py)


def _thick_line_events(width: int, height: int, p1: np.ndarray,
                       p2: np.ndarray, thickness: int):
    """cv2.line(img, p1[i], p2[i], color, thickness, cv2.LINE_AA) for
    thickness >= 2, for every segment in order, as blend events in drawing
    order: (flat pixel, alpha; 256 for a filled pixel).

    OpenCV clips each segment to the image grown by `thickness` on every
    side, then (ThickLine) fills the 4-point polygon of the segment offset
    by cvRound(d * (thickness + (thickness & 1)) * 2^15 / |d|) along its
    normal, and a disc of radius thickness/2 at each end. Each of these
    three polygons draws its anti-aliased outline (LineAA from the last
    vertex round to the first) and then fills its inside solid."""
    t = thickness
    inside, x1, y1, x2, y2 = _clip_lines(width + 2 * t, height + 2 * t,
                                         p1[:, 0] + t, p1[:, 1] + t,
                                         p2[:, 0] + t, p2[:, 1] + t)
    x1, y1 = (x1[inside] - t) << XY_SHIFT, (y1[inside] - t) << XY_SHIFT
    x2, y2 = (x2[inside] - t) << XY_SHIFT, (y2[inside] - t) << XY_SHIFT
    half_width = t << (XY_SHIFT - 1)
    dx = (x1 - x2) * (1.0 / XY_ONE)
    dy = (y2 - y1) * (1.0 / XY_ONE)
    r2 = dx * dx + dy * dy
    body = np.abs(r2) > np.finfo(np.float64).eps
    with np.errstate(divide="ignore"):
        scale = (half_width + (t & 1) * XY_ONE * 0.5) / np.sqrt(r2)
    dpx = np.rint(dy * np.where(body, scale, 0.0)).astype(np.int64)
    dpy = np.rint(dx * np.where(body, scale, 0.0)).astype(np.int64)
    # polygons: (vx, vy, drawing rank); a segment's body, then its two caps
    polys = [(np.stack([x1 + dpx, x1 - dpx, x2 - dpx, x2 + dpx], 1)[body],
              np.stack([y1 + dpy, y1 - dpy, y2 - dpy, y2 + dpy], 1)[body],
              3 * np.nonzero(body)[0])]
    for end, (cx, cy) in enumerate(((x1, y1), (x2, y2))):
        polys.append((*_cap_polygons(cx, cy, half_width),
                      3 * np.arange(len(cx)) + 1 + end))
    pix, alpha, key = [], [], []
    for vx, vy, rank in polys:
        # the outline: edges (v[n-1], v[0]), (v[0], v[1]), ...
        ex1, ey1 = np.roll(vx, 1, 1).reshape(-1), np.roll(vy, 1, 1).reshape(-1)
        p, a, e = _line_aa_events(width, height, ex1, ey1, vx.reshape(-1),
                                  vy.reshape(-1))
        pix.append(p)
        alpha.append(a)
        key.append(2 * rank[e // vx.shape[1]])
        p, poly = _fill_events(width, height, vx, vy)
        pix.append(p)
        alpha.append(np.full(len(p), 256, np.int64))
        key.append(2 * rank[poly] + 1)
    key = np.concatenate(key)
    order = np.argsort(key, kind="stable")
    return np.concatenate(pix)[order], np.concatenate(alpha)[order]


def draw_lines_aa(img: np.ndarray, p1, p2, color: int = 255,
                  thickness: int = 1) -> None:
    """Draw segments p1[i] -> p2[i] ((N, 2) integer pixel (x, y)) into the
    C-contiguous uint8 (H, W) `img` in place, one after the other, exactly
    as N calls of `cv2.line(img, p1[i], p2[i], color, thickness,
    cv2.LINE_AA)` would."""
    if img.dtype != np.uint8 or img.ndim != 2 or not img.flags.c_contiguous:
        raise ValueError("draw_lines_aa draws into a C-contiguous (H, W) "
                         "uint8 image")
    if thickness < 1:
        raise ValueError(f"thickness {thickness}: OpenCV draws 1 or more")
    h, w = img.shape
    p1 = np.asarray(p1, np.int64).reshape(-1, 2)
    p2 = np.asarray(p2, np.int64).reshape(-1, 2)
    if thickness == 1:
        p1, p2 = p1 << XY_SHIFT, p2 << XY_SHIFT
        pix, alpha, _ = _line_aa_events(w, h, p1[:, 0], p1[:, 1], p2[:, 0],
                                        p2[:, 1])
    else:
        pix, alpha = _thick_line_events(w, h, p1, p2, thickness)
    _blend(img, pix, alpha, color)


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
                         seed: int = 0, obj: str = "cube",
                         pp_offset: tuple = (0.0, 0.0)) -> str:
    """Write a synthetic wireframe scan under out_dir/<scan>/ (white edges
    on black, golden-spiral cameras); returns the scan directory. The
    principal point sits at (W/2 + dx, H/2 + dy) for pp_offset (dx, dy).
    Lines are `line_px` pixels wide, drawn as OpenCV draws them. The scene
    is deterministic: `seed` is accepted for the JAX package's signature,
    whose writer seeds a generator that it never draws from."""
    del seed
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
        draw_lines_aa(img, np.concatenate(starts), np.concatenate(ends),
                      thickness=line_px)
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
