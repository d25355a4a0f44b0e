from emap_tpu_torch.eval.metrics import (
    bezier_curve_length,
    chamfer_distance,
    compute_precision_recall_iou,
    downsample_point_cloud_average,
    f_score,
)

__all__ = [
    "bezier_curve_length",
    "chamfer_distance",
    "compute_precision_recall_iou",
    "downsample_point_cloud_average",
    "f_score",
]
