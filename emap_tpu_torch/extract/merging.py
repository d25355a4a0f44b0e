"""Merging of fitted primitives: line merging, curve merging, endpoint
snapping. The port's copy of emap_tpu/extract/merging.py, plain numpy and
scipy, computing the same results from the same inputs.

CPU/numpy re-implementation of the reference merging stage
(src/edge_extraction/merging/main.py). Differences from the reference are in
vectorization only:

* pairwise segment distances are computed as one vectorized
  point-to-segment-batch evaluation instead of a double python loop (:37-59),
* connectivity uses scipy.sparse.csgraph.connected_components as upstream.

Default flags mirror the reference orchestrator (:295-385): merge lines and
endpoints, curve merging OFF.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from emap_tpu_torch.extract.fitting import bezier_fit, bezier_points, line_fitting


def point_to_segment_distance(segments: np.ndarray, points: np.ndarray):
    """segments (M, 6), points (K, 3) -> (M, K) min distances."""
    a = segments[:, None, :3]
    b = segments[:, None, 3:]
    ab = b - a
    denom = np.sum(ab * ab, axis=-1, keepdims=True) + 1e-12
    t = np.clip(np.sum((points[None] - a) * ab, axis=-1, keepdims=True) / denom, 0, 1)
    closest = a + t * ab
    return np.linalg.norm(closest - points[None], axis=-1)


def pairwise_segment_distances(segments: np.ndarray) -> np.ndarray:
    """Min distance from each segment to the other's endpoints, symmetrized
    (reference semantics, merging/main.py:37-59)."""
    m = len(segments)
    endpoints = segments.reshape(-1, 3)  # (2m, 3)
    d = point_to_segment_distance(segments, endpoints)  # (m, 2m)
    d = np.minimum(d[:, 0::2], d[:, 1::2])  # (m, m): seg_i vs endpoints of j
    out = np.zeros((m, m))
    iu = np.triu_indices(m, 1)
    out[iu] = d[iu]
    out = out + out.T
    return out


def pairwise_direction_similarity(segments: np.ndarray) -> np.ndarray:
    d = segments[:, 3:] - segments[:, :3]
    d = d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-12)
    return d @ d.T


def _components(adjacency: np.ndarray):
    n, labels = connected_components(csr_matrix(adjacency))
    return n, labels


def merge_line_segments(
    segments: np.ndarray,
    raw_points_on_lines: list,
    distance_threshold: float,
    similarity_threshold: float,
) -> np.ndarray:
    """Group near-parallel, near-touching segments and refit each group by
    total LSQ over the pooled raw inlier points (reference :120-156)."""
    if len(segments) == 0:
        return segments
    dist = pairwise_segment_distances(segments)
    sim = pairwise_direction_similarity(segments)
    adj = (dist <= distance_threshold) & (sim >= similarity_threshold)
    n_comp, labels = _components(adj)

    merged = []
    for c in range(n_comp):
        members = np.nonzero(labels == c)[0]
        if len(members) == 1:
            merged.append(segments[members[0]])
            continue
        pooled = np.concatenate(
            [np.asarray(raw_points_on_lines[i], np.float64).reshape(-1, 3)
             for i in members]
        )
        try:
            seg, _ = line_fitting(pooled)
            merged.append(seg)
        except np.linalg.LinAlgError:
            continue
    return np.asarray(merged).reshape(-1, 6)


def merge_bezier_curves(
    curves: np.ndarray,
    raw_points_on_curves: list,
    distance_threshold: float,
    similarity_threshold: float,
    num_samples: int = 100,
) -> np.ndarray:
    """Curve-merge analog (reference :159-219; OFF by default upstream)."""
    if len(curves) == 0:
        return curves
    t = np.linspace(0, 1, num_samples)
    sampled = np.stack([bezier_points(c, t) for c in curves])  # (C, n, 3)

    c4 = curves.reshape(-1, 4, 3)
    # analytic tangents at the sample ts
    def tangents(ctl):
        p0, p1, p2, p3 = ctl
        return (
            -3 * (1 - t[:, None]) ** 2 * p0
            + 3 * (1 - 4 * t[:, None] + 3 * t[:, None] ** 2) * p1
            + 3 * (2 * t[:, None] - 3 * t[:, None] ** 2) * p2
            + 3 * t[:, None] ** 2 * p3
        )

    tangs = np.stack([tangents(c) for c in c4])

    m = len(curves)
    dist = np.zeros((m, m))
    sim = np.zeros((m, m))
    for i in range(m):
        for j in range(i + 1, m):
            d = np.linalg.norm(
                sampled[i][:, None] - sampled[j][None], axis=-1
            )
            k, l = np.unravel_index(np.argmin(d), d.shape)
            dist[i, j] = d[k, l]
            ti, tj = tangs[i][k], tangs[j][l]
            sim[i, j] = abs(ti @ tj) / (
                np.linalg.norm(ti) * np.linalg.norm(tj) + 1e-12
            )
    dist += dist.T
    sim += sim.T

    adj = (dist <= distance_threshold) & (sim >= similarity_threshold)
    n_comp, labels = _components(adj)
    merged = []
    for c in range(n_comp):
        members = np.nonzero(labels == c)[0]
        if len(members) == 1:
            merged.append(curves[members[0]])
        else:
            pooled = np.concatenate(
                [np.asarray(raw_points_on_curves[i]).reshape(-1, 3)
                 for i in members]
            )
            p = bezier_fit(pooled, error_threshold=np.inf)
            if p is not None:
                merged.append(p)
    return np.asarray(merged).reshape(-1, 12)


def merge_endpoints(
    segments: np.ndarray, curves: np.ndarray, distance_threshold: float
):
    """Cluster all line+curve endpoints within threshold and snap each cluster
    to its mean (reference :222-268)."""
    n_lines, n_curves = len(segments), len(curves)
    if n_lines == 0 and n_curves == 0:
        return segments, curves

    line_eps = segments.reshape(-1, 3) if n_lines else np.zeros((0, 3))
    curve_eps = (
        curves.reshape(-1, 4, 3)[:, [0, 3]].reshape(-1, 3)
        if n_curves
        else np.zeros((0, 3))
    )
    eps = np.concatenate([line_eps, curve_eps])

    d = np.linalg.norm(eps[:, None] - eps[None], axis=-1)
    n_comp, labels = _components(d <= distance_threshold)
    snapped = eps.copy()
    for c in range(n_comp):
        members = np.nonzero(labels == c)[0]
        if len(members) > 1:
            snapped[members] = eps[members].mean(axis=0)

    out_lines = (
        snapped[: n_lines * 2].reshape(-1, 6) if n_lines else segments
    )
    if n_curves:
        out_curves = curves.copy().reshape(-1, 4, 3)
        ce = snapped[n_lines * 2 :].reshape(-1, 2, 3)
        out_curves[:, 0] = ce[:, 0]
        out_curves[:, 3] = ce[:, 1]
        out_curves = out_curves.reshape(-1, 12)
    else:
        out_curves = curves
    return out_lines, out_curves


def merge(
    fitted_edge_dict: dict,
    merge_edge_distance_threshold: float = 5.0,
    merge_endpoints_distance_threshold: float = 1.0,
    merge_similarity_threshold: float = 0.98,
    merge_endpoints_flag: bool = True,
    merge_edge_flag: bool = True,
    merge_curve_flag: bool = False,
) -> dict:
    """Merging orchestrator (reference merging/main.py:295-385); thresholds
    are normalized by the extraction resolution like upstream."""
    resolution = float(fitted_edge_dict["resolution"])
    lines = np.asarray(fitted_edge_dict["lines_end_pts"], np.float64).reshape(
        -1, 6
    )
    curves = np.asarray(
        fitted_edge_dict["curves_ctl_pts"], np.float64
    ).reshape(-1, 12)
    raw_lines = fitted_edge_dict.get("raw_points_on_lines", [])
    raw_curves = fitted_edge_dict.get("raw_points_on_curves", [])

    d_edge = merge_edge_distance_threshold / resolution
    d_end = merge_endpoints_distance_threshold / resolution

    if merge_edge_flag and len(lines) > 0:
        lines = merge_line_segments(
            lines, raw_lines, d_edge / 2.0, merge_similarity_threshold
        )
    if merge_curve_flag and merge_edge_flag and len(curves) > 0:
        curves = merge_bezier_curves(
            curves, raw_curves, d_edge, merge_similarity_threshold
        )
    if merge_endpoints_flag:
        lines, curves = merge_endpoints(lines, curves, d_end)

    return {
        "lines_end_pts": np.asarray(lines).tolist() if len(lines) else [],
        "curves_ctl_pts": np.asarray(curves).tolist() if len(curves) else [],
    }
