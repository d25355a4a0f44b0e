"""Parametric edge orchestration: fit -> merge -> visibility -> sampled points.

The port's copy of emap_tpu/extract/parametric.py (a re-design of
src/edge_extraction/extract_parametric_edge.py), plain numpy; it reads the
edge maps with the port's PNG codec instead of cv2. Hyperparameters
are the reference's fixed constants (:229-237). The visibility check projects
sampled primitive points into every frame and keeps primitives whose projected
edge-map response clears a threshold in enough frames (:137-188); projection
is vectorized over all sample points per frame instead of per-primitive
python loops.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from emap_tpu_torch.data.dataset import edge_map_path, load_meta
from emap_tpu_torch.data.png import read_png
from emap_tpu_torch.extract.fitting import (
    bezier_curve_length,
    bezier_points,
    edge_fit,
)
from emap_tpu_torch.extract.merging import merge

# fixed fitting/merging hyperparameters (reference :229-237)
NMS_FACTOR = 0.95
ANGLE_THRESHOLD = 0.03
FIT_DISTANCE_THRESHOLD = 10.0
MIN_INLIERS = 5
MAX_LINES = 4
MAX_CURVES = 3
MERGE_EDGE_DISTANCE_THRESHOLD = 5.0
MERGE_ENDPOINTS_DISTANCE_THRESHOLD = 2.0
MERGE_SIMILARITY_THRESHOLD = 0.98
EDGE_VISIBILITY_THRESHOLD = 0.5
EDGE_VISIBILITY_FRAMES_RATIO = 0.1


def get_edge_maps(data_dir: str, detector: str):
    """Load edge maps + cameras for visibility checking (reference :25-62).

    Preserves the reference's detector-specific convention: DexiNed maps are
    inverted here (1 - v) while PidiNet maps are used as-is (:55-58).
    """
    meta = load_meta(data_dir)
    h, w = int(meta["height"]), int(meta["width"])
    edges, intrinsics, camtoworld = [], [], []
    for frame in meta["frames"]:
        path = edge_map_path(data_dir, frame["rgb_path"], detector)
        img = read_png(path, gray=True).astype(np.float64) / 255.0
        edges.append(img)
        intrinsics.append(np.asarray(frame["intrinsics"], np.float64))
        camtoworld.append(np.asarray(frame["camtoworld"], np.float64)[:4, :4])
    edges = np.stack(edges)
    if detector == "DexiNed":
        edges = 1.0 - edges
    return edges, np.stack(intrinsics), np.stack(camtoworld), h, w


def sample_primitives(
    curves_ctl_pts: np.ndarray,
    lines_end_pts: np.ndarray,
    sample_resolution: float = 0.005,
    worldtogt: Optional[np.ndarray] = None,
):
    """Sample points every `sample_resolution` along curves then lines
    (reference process_geometry_data :65-134). Returns (points, per-primitive
    point lists) so visibility can be computed per primitive."""
    curves = np.asarray(curves_ctl_pts, np.float64).reshape(-1, 4, 3)
    lines = np.asarray(lines_end_pts, np.float64).reshape(-1, 2, 3)
    if worldtogt is not None:
        R, t = worldtogt[:3, :3], worldtogt[:3, 3]
        curves = curves @ R.T + t
        lines = lines @ R.T + t

    per_curve, per_line = [], []
    for ctl in curves:
        n = int(bezier_curve_length(ctl, num_samples=100) // sample_resolution)
        t_s = np.linspace(0, 1, max(n, 0))
        per_curve.append(bezier_points(ctl, t_s) if n > 0 else np.zeros((0, 3)))
    for seg in lines:
        n = int(np.linalg.norm(seg[0] - seg[1]) // sample_resolution)
        t_s = np.linspace(0, 1, max(n, 0))[:, None]
        per_line.append(
            seg[0] + t_s * (seg[1] - seg[0]) if n > 0 else np.zeros((0, 3))
        )
    all_pts = per_curve + per_line
    points = (
        np.concatenate(all_pts) if all_pts else np.zeros((0, 3))
    ).astype(np.float32)
    return points, per_curve, per_line


def compute_visibility(
    per_primitive_points: list,
    edges: np.ndarray,
    intrinsics: np.ndarray,
    camtoworld: np.ndarray,
    h: int,
    w: int,
    visibility_threshold: float,
    min_visible_frames: int,
) -> np.ndarray:
    """Primitive visibility over frames (reference :137-188): a primitive is
    visible in a frame if the mean projected edge value exceeds the threshold
    AND some projected pixel is a confident edge (>0.5); it survives if
    visible in more than `min_visible_frames` frames."""
    n_prim = len(per_primitive_points)
    if n_prim == 0:
        return np.zeros((0,), bool)
    sizes = [len(p) for p in per_primitive_points]
    flat = (
        np.concatenate([p for p in per_primitive_points if len(p)])
        if sum(sizes)
        else np.zeros((0, 3))
    )
    visible_count = np.zeros(n_prim)

    for edge_map, K, c2w in zip(edges, intrinsics, camtoworld):
        w2c = np.linalg.inv(c2w)
        cam = flat @ w2c[:3, :3].T + w2c[:3, 3]
        uvz = cam @ K[:3, :3].T
        uv = np.round(uvz[:, :2] / uvz[:, 2:3]).astype(np.int64)
        inside = (
            (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        )
        vals = np.zeros(len(flat))
        vals[inside] = edge_map[uv[inside, 1], uv[inside, 0]]

        off = 0
        for i, size in enumerate(sizes):
            if size == 0:
                off += size
                continue
            v = vals[off : off + size]
            m = inside[off : off + size]
            if m.any():
                proj = v[m]
                if proj.mean() > visibility_threshold and proj.max() > 0.5:
                    visible_count[i] += 1
            off += size

    return visible_count > min_visible_frames


def get_parametric_edge(
    points: np.ndarray,
    ld_colors: np.ndarray,
    resolution: int,
    detector: str,
    scan_data_dir: str,
    visible_checking: bool = False,
    seed: int = 42,
    trace: Optional[list] = None,
):
    """Point cloud -> parametric lines + Bezier curves
    (reference get_parametric_edge :216-300).

    Returns (pred_points (M,3) f32, edge_dict with 'curves_ctl_pts' and
    'lines_end_pts'). A `trace` list gets one {"stage": "edge_fit",
    "seconds", "points", "downsampled", "polylines", "lines", "curves"}
    entry (the cloud, the points after the voxel downsample, the polylines
    grown and the primitives fitted) and one {"stage": "merge", "seconds",
    "lines", "curves"}; with visible_checking, also one {"stage":
    "visibility", "seconds", "frames", "kept", "dropped"}: the filter's host
    time (edge maps read included) and its primitive counts.
    """
    t0 = time.perf_counter()
    counts: dict = {}
    fitted = edge_fit(
        points,
        ld_colors,
        resolution,
        angle_threshold=ANGLE_THRESHOLD,
        nms_factor=NMS_FACTOR,
        fit_distance_threshold=FIT_DISTANCE_THRESHOLD,
        min_inliers=MIN_INLIERS,
        max_lines=MAX_LINES,
        max_curves=MAX_CURVES,
        seed=seed,
        counts=counts,
    )
    t1 = time.perf_counter()
    merged = merge(
        fitted,
        merge_edge_distance_threshold=MERGE_EDGE_DISTANCE_THRESHOLD,
        merge_endpoints_distance_threshold=MERGE_ENDPOINTS_DISTANCE_THRESHOLD,
        merge_similarity_threshold=MERGE_SIMILARITY_THRESHOLD,
    )

    curves = np.asarray(merged["curves_ctl_pts"], np.float64).reshape(-1, 12)
    lines = np.asarray(merged["lines_end_pts"], np.float64).reshape(-1, 6)
    if trace is not None:
        trace.append({"stage": "edge_fit", "seconds": t1 - t0,
                      "points": int(len(points)), **counts,
                      "lines": len(fitted["lines_end_pts"]),
                      "curves": len(fitted["curves_ctl_pts"])})
        trace.append({"stage": "merge", "seconds": time.perf_counter() - t1,
                      "lines": len(lines), "curves": len(curves)})

    if visible_checking:
        t0 = time.perf_counter()
        _, per_curve, per_line = sample_primitives(curves, lines)
        edges, intrinsics, camtoworld, h, w = get_edge_maps(
            scan_data_dir, detector
        )
        min_frames = math.ceil(EDGE_VISIBILITY_FRAMES_RATIO * len(edges))
        vis = compute_visibility(
            per_curve + per_line, edges, intrinsics, camtoworld, h, w,
            EDGE_VISIBILITY_THRESHOLD, min_frames,
        )
        n_curves = len(curves)
        curves = curves[vis[:n_curves]]
        lines = lines[vis[n_curves:]]
        if trace is not None:
            trace.append({"stage": "visibility",
                          "seconds": time.perf_counter() - t0,
                          "frames": len(edges), "kept": int(vis.sum()),
                          "dropped": int(len(vis) - vis.sum())})

    pred_points, _, _ = sample_primitives(curves, lines, worldtogt=np.eye(4))
    edge_dict = {
        "curves_ctl_pts": curves.reshape(-1, 4, 3).tolist(),
        "lines_end_pts": lines.reshape(-1, 6).tolist(),
    }
    return pred_points, edge_dict
