"""Evaluation metrics: chamfer, precision/recall/F-score/IOU, voxel-average
downsampling, Bezier arc length, GT loaders, and primitive sampling (port of
emap_tpu/eval/metrics.py).

The reference protocol's eval_util.py with scipy.spatial.cKDTree as the
exact nearest-neighbour search. The metric definitions, thresholds and
normalizations are the reference's, and the numpy and scipy calls run in
the JAX package's order, so both packages score the same input to the same
floats. Host code: nothing here touches a device.
"""

from __future__ import annotations

import json
import os

import numpy as np
from scipy.spatial import cKDTree

from emap_tpu_torch.extract import fitting as _fitting


# ---------------------------------------------------------------------------
# distances / scores
# ---------------------------------------------------------------------------

def _nn_dists(from_pts: np.ndarray, to_pts: np.ndarray) -> np.ndarray:
    tree = cKDTree(np.asarray(to_pts, np.float64))
    d, _ = tree.query(np.asarray(from_pts, np.float64), k=1)
    return d


def chamfer_distance(x: np.ndarray, y: np.ndarray):
    """Returns (chamfer, accuracy, completeness): accuracy = mean NN distance
    x->y, completeness = mean NN distance y->x (reference eval_util.py:20-58;
    note upstream's variable names are swapped but the returned numbers are
    these)."""
    acc = float(_nn_dists(x, y).mean())
    comp = float(_nn_dists(y, x).mean())
    return acc + comp, acc, comp


def f_score(precision: float, recall: float) -> float:
    if precision + recall == 0.0:  # degenerate field: nothing within thresh
        return 0.0
    return 2 * precision * recall / (precision + recall)


def compute_precision_recall_iou(
    pred: np.ndarray,
    gt: np.ndarray,
    metrics: dict | None,
    thresh_list=(0.02,),
    edge_type: str = "all",
):
    """Precision/recall/F/IOU at each threshold (reference :138-191).

    edge_type == 'all': appends into `metrics` dict-of-lists and returns it.
    otherwise: returns (correct_gt_list, num_gt, correct_pred_list, num_pred,
    acc, comp) for the per-type totals protocol.
    """
    if len(pred) == 0:
        # degenerate prediction (nothing extracted): all-zero metrics rather
        # than a division crash (the reference would raise here too; a zero
        # row is the more useful behavior for short-schedule smoke runs)
        if edge_type == "all":
            for thresh in thresh_list:
                for name in ("precision", "recall", "fscore", "IOU"):
                    metrics[f"{name}_{thresh}"].append(0.0)
            return metrics
        # NaN (not inf): the finalize convention (eval_abc.py nan_to_num)
        # zeroes NaN, whereas inf would propagate into aggregate acc/comp
        # means as a ~1e308 garbage value
        return ([0] * len(thresh_list), len(gt), [0] * len(thresh_list), 0,
                float("nan"), float("nan"))

    d_pred_gt = _nn_dists(pred, gt)
    d_gt_pred = _nn_dists(gt, pred)

    if edge_type == "all":
        for thresh in thresh_list:
            correct_pred = int((d_pred_gt < thresh).sum())
            precision = correct_pred / len(d_pred_gt)
            correct_gt = int((d_gt_pred < thresh).sum())
            recall = correct_gt / len(d_gt_pred)
            metrics[f"precision_{thresh}"].append(precision)
            metrics[f"recall_{thresh}"].append(recall)
            metrics[f"fscore_{thresh}"].append(f_score(precision, recall))
            intersection = min(correct_pred, correct_gt)
            union = len(d_pred_gt) + len(d_gt_pred) - max(correct_pred, correct_gt)
            metrics[f"IOU_{thresh}"].append(intersection / union)
        return metrics

    _, acc, comp = chamfer_distance(pred, gt)
    correct_gt_list = [int((d_gt_pred < t).sum()) for t in thresh_list]
    correct_pred_list = [int((d_pred_gt < t).sum()) for t in thresh_list]
    return (
        correct_gt_list,
        len(d_gt_pred),
        correct_pred_list,
        len(d_pred_gt),
        acc,
        comp,
    )


# ---------------------------------------------------------------------------
# downsampling
# ---------------------------------------------------------------------------

def downsample_point_cloud_average(
    points: np.ndarray,
    num_voxels_per_axis: int = 256,
    min_bound=None,
    max_bound=None,
) -> np.ndarray:
    """Average points per occupied voxel of a fixed grid
    (reference :418-456 via pcu.downsample_point_cloud_on_voxel_grid)."""
    points = np.asarray(points, np.float64)
    mn = (
        points.min(axis=0) if min_bound is None else np.asarray(min_bound, float)
    )
    mx = (
        points.max(axis=0) if max_bound is None else np.asarray(max_bound, float)
    )
    voxel = (mx - mn) / num_voxels_per_axis
    voxel = np.where(voxel <= 0, 1.0, voxel)
    idx = np.floor((points - mn) / voxel).astype(np.int64)
    idx = np.clip(idx, 0, num_voxels_per_axis - 1)
    key = (idx[:, 0] * num_voxels_per_axis + idx[:, 1]) * num_voxels_per_axis + idx[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    acc = np.zeros((len(uniq), 3))
    np.add.at(acc, inv, points)
    return (acc / counts[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# Bezier arc length (Simpson) + primitive sampling
# ---------------------------------------------------------------------------

# re-exported from extract.fitting (it is a geometry primitive used by both
# the extraction orchestrator and the eval protocol)
bezier_curve_length = _fitting.bezier_curve_length


def get_pred_points_and_directions(
    json_path: str, sample_resolution: float = 0.005
):
    """Sample prediction primitives every 5mm with analytic directions
    (reference :300-415)."""
    with open(json_path) as f:
        data = json.load(f)
    curves = np.asarray(data["curves_ctl_pts"], np.float64).reshape(-1, 4, 3)
    lines = np.asarray(data["lines_end_pts"], np.float64).reshape(-1, 2, 3)

    curve_pts, curve_dirs = [], []
    for ctl in curves:
        n = int(bezier_curve_length(ctl, 100) // sample_resolution)
        if n <= 0:
            continue
        t = np.linspace(0, 1, n)
        curve_pts.append(_fitting.bezier_points(ctl, t))
        deltas = 3.0 * (ctl[1:] - ctl[:-1])
        b = np.stack([(1 - t) ** 2, 2 * (1 - t) * t, t**2], axis=-1)
        d = b @ deltas
        d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
        curve_dirs.extend(list(d))

    line_pts, line_dirs = [], []
    for seg in lines:
        n = int(np.linalg.norm(seg[0] - seg[1]) // sample_resolution)
        if n <= 0:
            continue
        t = np.linspace(0, 1, n)[:, None]
        line_pts.append(seg[0] + t * (seg[1] - seg[0]))
        d = (seg[1] - seg[0]) / (np.linalg.norm(seg[1] - seg[0]) + 1e-6)
        line_dirs.extend([d] * n)

    curve_points = (
        np.concatenate(curve_pts) if curve_pts else np.zeros((0, 3))
    )
    line_points = np.concatenate(line_pts) if line_pts else np.zeros((0, 3))
    return curve_points, line_points, curve_dirs, line_dirs


# ---------------------------------------------------------------------------
# ABC ground truth
# ---------------------------------------------------------------------------

def get_gt_points_abc(
    scan_name: str,
    edge_type: str = "all",
    interval: float = 0.005,
    return_direction: bool = False,
    data_base_dir: str | None = None,
):
    """Sharp feature curves of the ABC CAD model, normalized into the
    rendering frame (reference :194-297): scale = 1/max bbox range, then
    offset so the bbox center lands at [0.5, 0.5, 0.5]."""
    objs_dir = os.path.join(data_base_dir, "obj")
    obj_names = sorted(os.listdir(objs_dir))
    index_obj = {name[:8]: name for name in obj_names}

    with open(os.path.join(data_base_dir, "chunk_0000_feats.json")) as f:
        feats = json.load(f)
    with open(os.path.join(data_base_dir, "chunk_0000_stats.json")) as f:
        stats = json.load(f)

    bbox = stats[scan_name]["bbox"]
    x_min, y_min, z_min, x_max, y_max, z_max = bbox[:6]
    ranges = bbox[6:9]
    scale = 1.0 / max(ranges)
    center = np.array(
        [(x_min + x_max) / 2, (y_min + y_max) / 2, (z_min + z_max) / 2]
    ) * scale
    offset = np.array([0.5, 0.5, 0.5]) - center

    vertices = []
    with open(os.path.join(objs_dir, index_obj[scan_name]), encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "v":
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
    vertices = np.asarray(vertices)

    rename = {"BSpline": "curve", "Circle": "curve", "Ellipse": "curve", "Line": "line"}
    raw_pts, sampled, directions = [], [], []
    for curve in feats[scan_name]:
        if edge_type != "all" and rename.get(curve["type"]) != edge_type:
            continue
        if not curve["sharp"]:
            continue
        pts = vertices[np.asarray(curve["vert_indices"], int)]
        raw_pts.append(pts)
        for a, b in zip(pts[:-1], pts[1:]):
            num = int(np.linalg.norm(b - a) // interval)
            lin = np.linspace(0, 1, num)[:, None]
            # reference orientation: linspace * current + (1-linspace) * next
            sampled.append(lin * a + (1 - lin) * b)
            if return_direction and num > 0:
                d = (b - a) / np.linalg.norm(b - a)
                directions.extend([d] * num)

    if not raw_pts:
        return None, None, None
    raw = np.concatenate(raw_pts) * scale + offset
    pts = (
        np.concatenate(sampled) * scale + offset
        if sampled
        else np.zeros((0, 3))
    )
    return (
        raw.astype(np.float32),
        pts.astype(np.float32),
        np.asarray(directions),
    )
