"""DTU evaluation driver (port of emap_tpu/eval/eval_dtu.py, the
reference's src/eval/eval_DTU.py).

Per scan: sample predicted primitives, transform to GT coordinates via the
scene's `worldtogt`, voxel-average downsample at 256^3, and score
precision/recall at `threshold` (DTU mm) against the visibility-filtered STL
edge points (edge_points.ply).

Usage: python -m emap_tpu_torch.eval.eval_dtu --base_dir ./exp/DTU \
            --dataset_dir ./data/DTU_Edge --exp_name emap
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from scipy.spatial import cKDTree

from emap_tpu_torch.eval.metrics import (
    downsample_point_cloud_average,
    get_pred_points_and_directions,
)
from emap_tpu_torch.utils.ply import read_ply_points


def process_scan(
    scan_name, base_dir, exp_name, dataset_dir, threshold,
    precision_list, recall_list,
):
    print(f"Processing: {scan_name}")
    json_path = os.path.join(
        base_dir, scan_name, exp_name, "results", "parametric_edges.json"
    )
    if not os.path.exists(json_path):
        print(f"Invalid prediction at {scan_name}")
        return

    meta_path = os.path.join(dataset_dir, "data", scan_name, "meta_data.json")
    with open(meta_path) as f:
        worldtogt = np.asarray(json.load(f)["worldtogt"])

    curve_pts, line_pts, _, _ = get_pred_points_and_directions(json_path)
    pts = np.concatenate([curve_pts, line_pts]).reshape(-1, 3)
    pts = pts @ worldtogt[:3, :3].T + worldtogt[:3, 3]
    pts_down = downsample_point_cloud_average(pts, num_voxels_per_axis=256)

    gt_path = os.path.join(
        dataset_dir, "groundtruth", "edge_points", scan_name, "edge_points.ply"
    )
    gt_points, _ = read_ply_points(gt_path)

    d_pred_gt, _ = cKDTree(gt_points).query(pts_down, k=1)
    precision = float((d_pred_gt <= threshold).sum() / len(d_pred_gt))
    precision_list.append(precision)

    d_gt_pred, _ = cKDTree(pts_down).query(gt_points, k=1)
    recall = float((d_gt_pred <= threshold).sum() / len(d_gt_pred))
    recall_list.append(recall)
    print(f"  Recall: {recall:.4f}, Precision: {precision:.4f}")


def main(base_dir, dataset_dir, exp_name, threshold=5.0, scan_list=None):
    np.random.seed(42)
    if scan_list is None:
        scan_list = os.path.join(os.path.dirname(__file__), "DTU_scans.txt")
    with open(scan_list) as f:
        scans = [line.strip() for line in f if line.strip()]

    precision_list, recall_list = [], []
    for scan in scans:
        process_scan(
            scan, base_dir, exp_name, dataset_dir, threshold,
            precision_list, recall_list,
        )
    print("\nSummary:")
    print(f"  Mean Recall: {np.mean(recall_list):.4f}")
    print(f"  Mean Precision: {np.mean(precision_list):.4f}")
    return precision_list, recall_list


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_dir", type=str, default="./exp/DTU")
    parser.add_argument("--dataset_dir", type=str, default="./data/DTU_Edge")
    parser.add_argument("--exp_name", type=str, default="emap")
    parser.add_argument("--downsample_density", type=float, default=0.5)
    parser.add_argument("--threshold", type=float, default=5)
    parser.add_argument("--scan_list", type=str, default=None)
    args = parser.parse_args()
    main(args.base_dir, args.dataset_dir, args.exp_name, args.threshold,
         args.scan_list)
