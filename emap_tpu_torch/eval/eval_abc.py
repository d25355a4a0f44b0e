"""ABC-NEF evaluation driver (port of emap_tpu/eval/eval_abc.py, the
reference's src/eval/eval_ABC.py).

Per scan: sample the predicted parametric edges every 5mm, voxel-average
downsample to 256^3 in [-1,1]^3, compare against the CAD sharp-feature GT
with chamfer/acc/comp and P/R/F/IOU at 0.005/0.01/0.02, plus per-type
(curve/line) totals.

Usage: python -m emap_tpu_torch.eval.eval_abc --base_dir ./exp/ABC \
            --dataset_dir ./data/ABC-NEF_Edge --exp_name emap
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from emap_tpu_torch.eval.metrics import (
    chamfer_distance,
    compute_precision_recall_iou,
    downsample_point_cloud_average,
    get_gt_points_abc,
    get_pred_points_and_directions,
)

THRESHOLDS = (0.005, 0.01, 0.02)
THRESH_NAMES = ("5", "10", "20")


def new_metrics() -> dict:
    metrics = {"chamfer": [], "acc": [], "comp": []}
    for et in ("curve", "line"):
        metrics[f"comp_{et}"] = []
        metrics[f"acc_{et}"] = []
    for t in THRESHOLDS:
        for name in ("precision", "recall", "fscore", "IOU"):
            metrics[f"{name}_{t}"] = []
    return metrics


def new_totals() -> dict:
    return {
        et: {
            **{f"thre{n}_correct_gt_total": 0 for n in THRESH_NAMES},
            **{f"thre{n}_correct_pred_total": 0 for n in THRESH_NAMES},
            "num_gt_total": 0,
            "num_pred_total": 0,
        }
        for et in ("curve", "line")
    }


def process_scan(scan_name, base_dir, exp_name, dataset_dir, metrics, totals):
    print(f"Processing: {scan_name}")
    json_path = os.path.join(
        base_dir, scan_name, exp_name, "results", "parametric_edges.json"
    )
    if not os.path.exists(json_path):
        print(f"Invalid prediction at {scan_name}")
        return

    curve_pts, line_pts, _, _ = get_pred_points_and_directions(json_path)
    pred_points = np.concatenate([curve_pts, line_pts]).reshape(-1, 3)
    if len(pred_points) == 0:
        print(f"Invalid prediction at {scan_name}")
        return
    pred_sampled = downsample_point_cloud_average(
        pred_points.astype(np.float32),
        num_voxels_per_axis=256,
        min_bound=[-1, -1, -1],
        max_bound=[1, 1, 1],
    )

    gt_base = os.path.join(dataset_dir, "groundtruth")
    gt_raw, gt_points, _ = get_gt_points_abc(
        scan_name, "all", data_base_dir=gt_base
    )
    if gt_raw is None:
        return

    chamfer, acc, comp = chamfer_distance(pred_sampled, gt_points)
    print(
        f"  Chamfer: {chamfer:.4f}, Accuracy: {acc:.4f}, "
        f"Completeness: {comp:.4f}"
    )
    metrics["chamfer"].append(chamfer)
    metrics["acc"].append(acc)
    metrics["comp"].append(comp)
    compute_precision_recall_iou(
        pred_sampled, gt_points, metrics, thresh_list=list(THRESHOLDS),
        edge_type="all",
    )

    for edge_type in ("curve", "line"):
        gt_raw_t, gt_points_t, _ = get_gt_points_abc(
            scan_name, edge_type, return_direction=True, data_base_dir=gt_base
        )
        if gt_raw_t is None:
            continue
        correct_gt, num_gt, correct_pred, num_pred, acc_t, comp_t = (
            compute_precision_recall_iou(
                pred_sampled, gt_points_t, None,
                thresh_list=list(THRESHOLDS), edge_type=edge_type,
            )
        )
        metrics[f"comp_{edge_type}"].append(comp_t)
        metrics[f"acc_{edge_type}"].append(acc_t)
        tot = totals[edge_type]
        for i, n in enumerate(THRESH_NAMES):
            tot[f"thre{n}_correct_gt_total"] += correct_gt[i]
            tot[f"thre{n}_correct_pred_total"] += correct_pred[i]
        tot["num_gt_total"] += num_gt
        tot["num_pred_total"] += num_pred


def finalize(metrics: dict) -> dict:
    out = {}
    for key, vals in metrics.items():
        arr = np.nan_to_num(np.asarray(vals, dtype=np.float64))
        out[key] = round(float(arr.mean()), 4) if len(arr) else 0.0
    return out


def main(base_dir, dataset_dir, exp_name, scan_list=None):
    np.random.seed(42)
    if scan_list is None:
        scan_list = os.path.join(os.path.dirname(__file__), "ABC_scans.txt")
    with open(scan_list) as f:
        scans = [line.strip() for line in f if line.strip()]

    metrics, totals = new_metrics(), new_totals()
    for scan in scans:
        process_scan(scan, base_dir, exp_name, dataset_dir, metrics, totals)
    metrics = finalize(metrics)

    print("Summary:")
    print(f"  Accuracy: {metrics['acc']:.4f}")
    print(f"  Completeness: {metrics['comp']:.4f}")
    for t, mm in zip(THRESHOLDS, THRESH_NAMES):
        print(f"  Recall @ {mm} mm: {metrics[f'recall_{t}']:.4f}")
    for t, mm in zip(THRESHOLDS, THRESH_NAMES):
        print(f"  Precision @ {mm} mm: {metrics[f'precision_{t}']:.4f}")
    for t, mm in zip(THRESHOLDS, THRESH_NAMES):
        print(f"  F-Score @ {mm} mm: {metrics[f'fscore_{t}']:.4f}")
    for et in ("curve", "line"):
        if totals[et]["num_gt_total"] > 0:
            print(f"{et.capitalize()}:")
            print(f"  Completeness: {metrics[f'comp_{et}']}")
            print(f"  Accuracy: {metrics[f'acc_{et}']}")
        else:
            print(f"{et.capitalize()}: No ground truth edges found.")
    return metrics, totals


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_dir", type=str, default="./exp/ABC")
    parser.add_argument("--dataset_dir", type=str, default="./data/ABC-NEF_Edge")
    parser.add_argument("--exp_name", type=str, default="emap")
    parser.add_argument("--scan_list", type=str, default=None)
    args = parser.parse_args()
    main(args.base_dir, args.dataset_dir, args.exp_name, args.scan_list)
