"""Parametric edge fitting: polyline growth, RANSAC 3D lines, cubic Beziers.

The port's copy of emap_tpu/extract/fitting.py, plain numpy, computing the
same results from the same inputs. One difference: above 2000 points the
native growth (emap_tpu_torch/native) is required and raises if it cannot be
built, where the JAX package falls back to the Python growth, which draws
another seed sequence.

CPU/numpy re-implementation of the reference fitting stack
(src/edge_extraction/edge_fitting/): these algorithms are inherently
sequential, data-dependent graph growth over a few thousand points -- seconds
of CPU -- so they intentionally stay off-device (SURVEY.md §7 build plan).

Behavioral parity notes:
* `voxel_downsample_with_colors` reproduces Open3D voxel_down_sample's
  per-voxel attribute averaging (edge_fitting/main.py:321).
* `connect_points` is the greedy bidirectional polyline growth of
  edge_fitting/main.py:93-228 (max direction-dot attach, NMS suppression of
  near-collinear competitors, stop when the attached point's own direction
  disagrees).
* `fit_line_ransac_3d` follows line_fit.py:52-180, including the
  min_inlier_ratio early break and the monotonic-index-run split of leftovers
  into curve candidates and 2-point short lines.
* `bezier_fit` solves the same Bernstein-basis model as bezier_fit.py:5-39 but
  in closed form: with fixed uniform t the cubic-Bezier fit is *linear* least
  squares, so scipy.optimize.curve_fit's iterative solver is unnecessary --
  lstsq gives the same minimizer deterministically.
"""

from __future__ import annotations

import numpy as np

BEZIER_COEFF = np.array(
    [[-1, 3, -3, 1], [3, -6, 3, 0], [-3, 3, 0, 0], [1, 0, 0, 0]],
    dtype=np.float64,
)


def bezier_design_matrix(t: np.ndarray) -> np.ndarray:
    """(n, 4) Bernstein design matrix M with points = M @ ctrl_pts."""
    tt = np.stack([t**3, t**2, t, np.ones_like(t)], axis=-1)
    return tt @ BEZIER_COEFF


def bezier_points(ctrl_pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Evaluate a cubic Bezier; ctrl_pts (4,3) or flat (12,)."""
    return bezier_design_matrix(t) @ np.asarray(ctrl_pts, np.float64).reshape(4, 3)


def bezier_fit(xyz: np.ndarray, error_threshold: float = 1.0):
    """LSQ cubic Bezier through points ordered along the curve; returns the
    flat (12,) control points or None if RMSE exceeds the threshold."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    n = len(xyz)
    if n < 4:
        return None
    t = np.linspace(0.0, 1.0, n)
    M = bezier_design_matrix(t)
    ctrl, *_ = np.linalg.lstsq(M, xyz, rcond=None)
    resid = xyz - M @ ctrl
    rmse = float(np.sqrt(np.mean(np.sum(resid**2, axis=1))))
    if rmse > error_threshold:
        return None
    return ctrl.reshape(-1)


def bezier_curve_length(control_points: np.ndarray, num_samples: int = 100):
    """Arc length of a cubic Bezier by composite Simpson over the derivative
    norm (reference eval_util.py:90-135, same sample counts)."""
    ctl = np.asarray(control_points, np.float64).reshape(4, 3)
    deltas = 3.0 * (ctl[1:] - ctl[:-1])  # derivative control points (3, 3)

    def speed(t):
        b = np.array([(1 - t) ** 2, 2 * (1 - t) * t, t**2])
        return np.linalg.norm(b @ deltas)

    length = 0.0
    for i in range(num_samples):
        t0, t1 = i / num_samples, (i + 1) / num_samples
        h = (t1 - t0) / num_samples
        s = speed(t0) + speed(t1)
        s += 4 * sum(speed(t0 + k * h) for k in range(1, num_samples, 2))
        s += 2 * sum(speed(t0 + k * h) for k in range(2, num_samples - 1, 2))
        length += s * h / 3
    return length


def voxel_downsample_with_colors(
    points: np.ndarray, colors: np.ndarray, voxel_size: float
):
    """Average points and colors per occupied voxel (Open3D semantics)."""
    points = np.asarray(points, np.float64)
    colors = np.asarray(colors, np.float64)
    if len(points) == 0:
        return points, colors
    mn = points.min(axis=0)
    idx = np.floor((points - mn) / voxel_size).astype(np.int64)
    # unique voxel key
    key = (idx[:, 0] << 42) + (idx[:, 1] << 21) + idx[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    p_acc = np.zeros((len(uniq), 3))
    c_acc = np.zeros((len(uniq), 3))
    np.add.at(p_acc, inv, points)
    np.add.at(c_acc, inv, colors)
    return p_acc / counts[:, None], c_acc / counts[:, None]


def line_fitting(points: np.ndarray):
    """Total-least-squares 3D line through `points`; returns the (6,) segment
    [start, end] spanning the projections plus the straightness score
    lambda = s0/sum(s) (reference line_fit.py:183-205)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    center = points.mean(axis=0)
    centered = points - center
    _, s, vh = np.linalg.svd(centered, full_matrices=False)
    lam = s[0] / (s.sum() + 1e-12)
    direction = vh[0] / np.linalg.norm(vh[0])
    proj = centered @ direction
    seg = np.empty(6)
    seg[:3] = center + proj.min() * direction
    seg[3:] = center + proj.max() * direction
    return seg, lam


def lines_fitting(lines: list, lamda_threshold: float):
    """Classify point groups into straight lines vs curve candidates by the
    straightness score lambda (reference line_fit.py:208-236)."""
    straight, curve_segments, curves, lamdas = [], [], [], []
    for endpoints in lines:
        endpoints = np.asarray(endpoints, np.float64).reshape(-1, 3)
        seg, lam = line_fitting(endpoints)
        lamdas.append(lam)
        if lam < lamda_threshold:
            curves.append(endpoints)
            curve_segments.append(
                [
                    np.hstack([endpoints[i], endpoints[i + 1]])
                    for i in range(len(endpoints) - 1)
                ]
            )
            continue
        straight.append(seg)
    return np.asarray(straight), curve_segments, curves, lamdas


def connect_points(
    points_wld: np.ndarray,
    distance_threshold: float,
    angle_threshold: float,
    nms_factor: float,
    keep_short_lines: bool,
    rng: np.random.Generator | None = None,
):
    """Greedy bidirectional polyline growth over (N, 6) [xyz, line-direction]
    points. Returns a list of index lists (each a polyline).

    Algorithm (reference edge_fitting/main.py:93-228): repeatedly seed at a
    random unvisited point; grow forward by attaching, among unvisited
    neighbors within `distance_threshold`, the one whose offset direction best
    aligns with the current point's line direction (dot > 1-angle_threshold);
    suppress closer near-collinear competitors (NMS); stop when the attached
    point's own direction disagrees with the travel direction (dot <= 0.5);
    then grow backward from the seed symmetrically.
    """
    rng = rng or np.random.default_rng(0)
    pts = np.asarray(points_wld, np.float64)
    xyz, ld = pts[:, :3], pts[:, 3:6]
    n = len(pts)
    unvisited = np.ones(n, dtype=bool)
    polylines = []

    def grow(anchor: int, forward: bool, line: list):
        while True:
            cand = np.nonzero(unvisited)[0]
            if len(cand) == 0:
                return
            d = np.linalg.norm(xyz[cand] - xyz[anchor], axis=1)
            near = d < distance_threshold
            cand, d = cand[near], d[near]
            if len(cand) == 0:
                return
            offs = xyz[cand] - xyz[anchor]
            offs /= np.linalg.norm(offs, axis=1, keepdims=True) + 1e-6
            dots = offs @ ld[anchor]

            if forward:
                best = int(np.argmax(dots))
                if dots[best] <= 1.0 - angle_threshold:
                    return
            else:
                best = int(np.argmin(dots))
                if abs(dots[best]) <= 1.0 - angle_threshold or dots[best] >= 0:
                    return

            chosen = int(cand[best])
            if forward:
                line.append(chosen)
                nms = (
                    (d <= d[best])
                    & (dots < dots[best])
                    & (dots >= nms_factor * dots[best])
                )
            else:
                line.insert(0, chosen)
                nms = (
                    (d <= d[best])
                    & (dots > dots[best])
                    & (dots <= nms_factor * dots[best])
                )
            unvisited[cand[nms]] = False

            sign = 1.0 if forward else -1.0
            if sign * (ld[chosen] @ offs[best]) <= 0.5:
                return
            unvisited[chosen] = False
            anchor = chosen

    while unvisited.any():
        seed = int(rng.choice(np.nonzero(unvisited)[0]))
        unvisited[seed] = False
        line = [seed]
        grow(seed, forward=True, line=line)
        grow(seed, forward=False, line=line)
        min_len = 1 if keep_short_lines else 3
        if len(line) > min_len:
            polylines.append(line)

    return polylines


def split_monotonic_runs(indices: list, max_runs: int = 2, min_length: int = 4):
    """Split leftover point indices into consecutive-index runs; the longest
    `max_runs` runs of length >= min_length become curve candidates, the rest
    break into 2-point short lines (reference line_fit.py:4-49)."""
    if not indices:
        return [], []
    runs = []
    cur = [indices[0]]
    for a, b in zip(indices[:-1], indices[1:]):
        if b == a + 1:
            cur.append(b)
        else:
            if len(cur) > 1:
                runs.append(tuple(cur))
            cur = [b]
    if len(cur) > 1:
        runs.append(tuple(cur))
    runs = sorted(set(runs), key=len, reverse=True)

    long_runs, short_runs = runs[:max_runs], runs[max_runs:]
    curves, shorts = [], []
    for run in long_runs:
        (curves if len(run) >= min_length else shorts).append(run)
    short_runs = shorts + short_runs
    lines = []
    for run in short_runs:
        for a, b in zip(run[:-1], run[1:]):
            lines.append([a, b])
    return [list(r) for r in curves], lines


def fit_line_ransac_3d(
    points_wld: np.ndarray,
    voxel_size: float = 256,
    max_iterations: int = 100,
    min_inliers: int = 4,
    max_lines: int = 3,
    max_curves: int = 2,
    keep_short_lines: bool = False,
    rng: np.random.Generator | None = None,
    ransac_with_direction: bool = False,
):
    """Iteratively RANSAC-fit up to max_lines 3D lines to an ordered polyline
    (reference line_fit.py:52-180). `ransac_with_direction` replaces the
    random 2-point hypotheses with each point's own line direction
    (reference :120-136; unused by the pipeline defaults).

    Returns (segments [ (6,) arrays ], inlier_point_lists, curve_candidates).
    """
    rng = rng or np.random.default_rng(0)
    pts = np.asarray(points_wld, np.float64)
    inlier_dist = 1.0 / voxel_size
    n_total = len(pts)
    min_inlier_ratio = 1.0 / max_lines if max_lines else 0.0
    raw = pts.copy()

    segments, split_points = [], []
    remaining_idx = np.arange(n_total)
    budget = max_lines

    while budget and len(pts) >= min_inliers:
        budget -= 1
        best_mask, best_n, best_pair = None, 0, None
        if ransac_with_direction:
            xyz, ld = pts[:, :3], pts[:, 3:6]
            ld = ld / (np.linalg.norm(ld, axis=1, keepdims=True) + 1e-12)
            dist = np.linalg.norm(
                np.cross(xyz[None] - xyz[:, None], ld[:, None]), axis=2
            )  # (N, N): point j to the line through i along ld_i
            masks = dist < inlier_dist
            counts = masks.sum(axis=1)
            i = int(np.argmax(counts))
            best_n = int(counts[i])
            best_mask = masks[i]
            best_pair = (xyz[i], ld[i])
        else:
            for _ in range(max_iterations):
                i, j = rng.choice(len(pts), 2, replace=False)
                p1 = pts[i, :3]
                direction = pts[j, :3] - p1
                norm = np.linalg.norm(direction)
                if norm < 1e-6:
                    continue
                direction = direction / norm
                dist = np.linalg.norm(
                    np.cross(pts[:, :3] - p1, direction), axis=1
                )
                mask = dist < inlier_dist
                n_in = int(mask.sum())
                if n_in > best_n:
                    best_n, best_mask, best_pair = n_in, mask, (p1, direction)

        if best_n < min_inliers:
            break
        if best_n / n_total < min_inlier_ratio:
            break

        p1, _ = best_pair
        inliers = pts[best_mask, :3]
        # refine direction by total least squares over inliers
        center = inliers.mean(axis=0)
        _, _, vh = np.linalg.svd(inliers - center, full_matrices=False)
        direction = vh[0] / np.linalg.norm(vh[0])
        proj = (inliers - p1) @ direction
        seg = np.concatenate(
            [p1 + proj.min() * direction, p1 + proj.max() * direction]
        )
        segments.append(seg)
        split_points.append(inliers.tolist())

        pts = pts[~best_mask]
        remaining_idx = remaining_idx[~best_mask]

    curve_candidates = []
    if len(remaining_idx) > 0:
        curve_runs, short_pairs = split_monotonic_runs(
            remaining_idx.tolist(), max_curves
        )
        curve_candidates = [raw[run, :3] for run in curve_runs]
        if keep_short_lines and short_pairs:
            shorts = raw[np.asarray(short_pairs), :3].reshape(-1, 6)
            segments.extend(list(shorts))
            split_points.extend(shorts.reshape(-1, 2, 3).tolist())

    return segments, split_points, curve_candidates


def fit_polylines(
    polylines_wld: list,
    voxel_size: float = 256,
    max_iterations: int = 100,
    min_inliers: int = 4,
    max_lines: int = 3,
    max_curves: int = 2,
    keep_short_lines: bool = True,
    rng: np.random.Generator | None = None,
):
    """Per-polyline line+curve decomposition (reference edge_fitting
    main.py:231-301). Returns (segments (L,6), raw_points_on_lines,
    curve_params (C,12), raw_points_on_curves)."""
    rng = rng or np.random.default_rng(0)
    segments, raw_on_lines = [], []
    curve_params, raw_on_curves = [], []

    for poly in polylines_wld:
        poly = np.asarray(poly, np.float64)
        if len(poly) < 4 and keep_short_lines:
            for a, b in zip(poly[:-1], poly[1:]):
                seg = np.concatenate([a[:3], b[:3]])
                segments.append(seg)
                raw_on_lines.append(seg.reshape(2, 3).tolist())
            continue

        segs, splits, curve_cands = fit_line_ransac_3d(
            poly, voxel_size, max_iterations, min_inliers,
            max_lines, max_curves, keep_short_lines, rng,
        )
        segments.extend(segs)
        raw_on_lines.extend(splits)
        for cand in curve_cands:
            p = bezier_fit(cand, error_threshold=5.0 / voxel_size)
            if p is None:
                continue
            curve_params.append(p)
            raw_on_curves.append(np.asarray(cand).tolist())

    segments = np.asarray(segments).reshape(-1, 6)
    curve_params = (
        np.asarray(curve_params).reshape(-1, 12)
        if curve_params
        else np.zeros((0, 12))
    )
    return segments, raw_on_lines, curve_params, raw_on_curves


def edge_fit(
    points: np.ndarray,
    ld_colors: np.ndarray,
    resolution: int,
    angle_threshold: float = 0.03,
    nms_factor: float = 0.9,
    fit_distance_threshold: float = 10.0,
    min_inliers: int = 4,
    max_lines: int = 4,
    max_curves: int = 3,
    keep_short_lines: bool = True,
    seed: int = 42,
):
    """Full fitting pass: voxel downsample -> polyline growth -> line/curve
    fits (reference edge_fitting/main.py:304-373). Returns the fitted edge
    dict in the reference's schema."""
    rng = np.random.default_rng(seed)
    res = float(resolution)
    pts_ds, colors_ds = voxel_downsample_with_colors(
        points, ld_colors, voxel_size=2.0 / res
    )
    ld = colors_ds * 2.0 - 1.0
    ld = ld / (np.linalg.norm(ld, axis=1, keepdims=True) + 1e-6)
    pts_wld = np.concatenate([pts_ds, ld], axis=1)

    # the greedy growth is the sequential hot spot at 256^3 resolutions;
    # above 2000 points the grid-hashed C++ implementation runs (it raises
    # if it cannot be built)
    if len(pts_wld) > 2000:
        from emap_tpu_torch.native import connect_points_native

        polyline_idx = connect_points_native(
            pts_wld,
            fit_distance_threshold / res,
            angle_threshold,
            nms_factor,
            keep_short_lines,
            seed=seed,
        )
    else:
        polyline_idx = connect_points(
            pts_wld,
            fit_distance_threshold / res,
            angle_threshold,
            nms_factor,
            keep_short_lines,
            rng,
        )
    polylines = [pts_wld[idx] for idx in polyline_idx]

    segments, raw_on_lines, curve_params, raw_on_curves = fit_polylines(
        polylines,
        voxel_size=res,
        max_iterations=100,
        min_inliers=min_inliers,
        max_lines=max_lines,
        max_curves=max_curves,
        keep_short_lines=keep_short_lines,
        rng=rng,
    )

    return {
        "resolution": int(res),
        "lines_end_pts": segments.tolist() if len(segments) else [],
        "raw_points_on_lines": raw_on_lines,
        "curves_ctl_pts": curve_params.tolist() if len(curve_params) else [],
        "raw_points_on_curves": raw_on_curves,
    }
