"""Score an extraction of a synthetic wireframe scene against its analytic
ground truth, with the ABC protocol unchanged (the counterpart of
scripts/e2e_synthetic.py::score_extraction): the predicted lines and curves
sampled every 5 mm, averaged on a 256^3 grid over [-1, 1]^3, then chamfer,
accuracy, completeness and P/R/F/IOU at 5, 10 and 20 mm against points
every 5 mm along the cube's edges or the three rings."""

from __future__ import annotations

import os

import numpy as np

from emap_tpu_torch.data.synthetic import (
    sample_cube_edge_points,
    sample_ring_edge_points,
)
from emap_tpu_torch.eval.metrics import (
    chamfer_distance,
    compute_precision_recall_iou,
    downsample_point_cloud_average,
    get_pred_points_and_directions,
)

THRESHOLDS = (0.005, 0.01, 0.02)


def score_extraction(base_exp_dir: str, edge_dict: dict, obj: str) -> dict:
    """Scores of `base_exp_dir`/results/parametric_edges.json against the
    `obj` ("cube" or "rings") wireframe; `edge_dict` (the extraction's
    return value) gives the line and curve counts."""
    json_path = os.path.join(base_exp_dir, "results",
                             "parametric_edges.json")
    curve_pts, line_pts, _, _ = get_pred_points_and_directions(json_path)
    pred = np.concatenate([np.asarray(curve_pts).reshape(-1, 3),
                           np.asarray(line_pts).reshape(-1, 3)])
    pred = downsample_point_cloud_average(pred.astype(np.float32), 256,
                                          [-1, -1, -1], [1, 1, 1])
    gt = (sample_ring_edge_points(0.5, spacing=0.005) if obj == "rings"
          else sample_cube_edge_points(0.5, spacing=0.005))
    metrics = {f"{name}_{t}": [] for name in ("precision", "recall",
                                              "fscore", "IOU")
               for t in THRESHOLDS}
    chamfer, acc, comp = chamfer_distance(pred, gt)
    compute_precision_recall_iou(pred, gt, metrics, list(THRESHOLDS), "all")
    return {
        "chamfer": round(chamfer, 5),
        "acc": round(acc, 5),
        "comp": round(comp, 5),
        **{k: round(v[0], 4) for k, v in metrics.items()},
        "n_lines": len(edge_dict["lines_end_pts"]),
        "n_curves": len(edge_dict["curves_ctl_pts"]),
    }
