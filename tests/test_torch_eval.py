"""The port's eval (emap_tpu_torch/eval) against the JAX package's on the
CPU: the metrics, the ABC and DTU drivers on small dataset layouts built
in tmp_path, and the synthetic-scene scorer against
scripts/e2e_synthetic.py::score_extraction. Every result must be exactly
equal: both run the same numpy and scipy calls in the same order."""

import importlib.util
import json
import math
import os

import numpy as np
import pytest

from emap_tpu.eval import eval_abc as j_abc
from emap_tpu.eval import eval_dtu as j_dtu
from emap_tpu.eval import metrics as jm
from emap_tpu.utils.ply import write_ply_points
from emap_tpu_torch.eval import eval_abc as t_abc
from emap_tpu_torch.eval import eval_dtu as t_dtu
from emap_tpu_torch.eval import metrics as tm
from emap_tpu_torch.eval.synthetic import score_extraction

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def e2e_synthetic():
    spec = importlib.util.spec_from_file_location(
        "e2e_synthetic", os.path.join(REPO, "scripts", "e2e_synthetic.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same(got, want):
    """Equal structure and equal floats (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got)
    else:
        assert got == want and type(got) is type(want)


def edges_json(rng, n_lines=6, n_curves=4, scale=1.0, offset=0.0):
    """A parametric_edges.json body with lines and cubic Beziers."""
    lines = rng.uniform(-0.6, 0.6, (n_lines, 6)) * scale + offset
    curves = rng.uniform(-0.6, 0.6, (n_curves, 12)) * scale + offset
    return {"lines_end_pts": lines.tolist(),
            "curves_ctl_pts": curves.tolist()}


def test_metrics_equal():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    y = x[:300] + rng.normal(0, 0.01, (300, 3)).astype(np.float32)
    assert_same(tm.chamfer_distance(x, y), jm.chamfer_distance(x, y))
    th = [0.005, 0.01, 0.02]

    def fresh():
        return {f"{n}_{t}": [] for n in ("precision", "recall", "fscore",
                                         "IOU") for t in th}

    assert_same(tm.compute_precision_recall_iou(x, y, fresh(), th),
                jm.compute_precision_recall_iou(x, y, fresh(), th))
    assert_same(tm.compute_precision_recall_iou(x, y, None, th, "line"),
                jm.compute_precision_recall_iou(x, y, None, th, "line"))
    empty = np.zeros((0, 3), np.float32)
    assert_same(tm.compute_precision_recall_iou(empty, y, fresh(), th),
                jm.compute_precision_recall_iou(empty, y, fresh(), th))
    assert_same(tm.compute_precision_recall_iou(empty, y, None, th, "curve"),
                jm.compute_precision_recall_iou(empty, y, None, th, "curve"))
    for bounds in ((None, None), ([-1, -1, -1], [1, 1, 1])):
        assert_same(tm.downsample_point_cloud_average(x, 16, *bounds),
                    jm.downsample_point_cloud_average(x, 16, *bounds))
    assert tm.f_score(0.0, 0.0) == jm.f_score(0.0, 0.0) == 0.0


def test_pred_sampling_equal(tmp_path):
    path = str(tmp_path / "parametric_edges.json")
    with open(path, "w") as f:
        json.dump(edges_json(np.random.default_rng(1)), f)
    for res in (0.005, 0.02):
        assert_same(tm.get_pred_points_and_directions(path, res),
                    jm.get_pred_points_and_directions(path, res))


@pytest.fixture
def abc_layout(tmp_path):
    """A two-scan ABC-NEF layout: predictions with lines and curves, and
    CAD ground truth with sharp lines, a sharp B-spline, a circle and a
    non-sharp curve; one scan has no prediction file."""
    rng = np.random.default_rng(2)
    gt_dir = tmp_path / "dataset" / "groundtruth"
    (gt_dir / "obj").mkdir(parents=True)
    feats, stats, scans = {}, {}, ["00000042", "00000043", "00000044"]
    for s, scan in enumerate(scans):
        verts = rng.uniform(0, 2, (40, 3))
        (gt_dir / "obj" / f"{scan}_model.obj").write_text(
            "\n".join(f"v {a} {b} {c}" for a, b, c in verts))
        feats[scan] = [
            {"type": "Line", "sharp": True, "vert_indices": [0, 1]},
            {"type": "Line", "sharp": True, "vert_indices": [2, 3, 4]},
            {"type": "BSpline", "sharp": True,
             "vert_indices": list(range(5, 20))},
            {"type": "Circle", "sharp": True,
             "vert_indices": list(range(20, 30))},
            {"type": "BSpline", "sharp": False,
             "vert_indices": list(range(30, 40))},
        ]
        lo, hi = verts.min(0), verts.max(0)
        stats[scan] = {"bbox": [*lo, *hi, *(hi - lo)]}
        if s < 2:
            exp = tmp_path / "exp" / scan / "emap" / "results"
            exp.mkdir(parents=True)
            pred = edges_json(rng, scale=0.8, offset=0.5)
            (exp / "parametric_edges.json").write_text(json.dumps(pred))
    (gt_dir / "chunk_0000_feats.json").write_text(json.dumps(feats))
    (gt_dir / "chunk_0000_stats.json").write_text(json.dumps(stats))
    scan_list = tmp_path / "scans.txt"
    scan_list.write_text("\n".join(scans) + "\n")
    return tmp_path, scan_list


def test_eval_abc_equal(abc_layout, capsys):
    root, scan_list = abc_layout
    kw = dict(base_dir=str(root / "exp"), dataset_dir=str(root / "dataset"),
              exp_name="emap", scan_list=str(scan_list))
    got = t_abc.main(**kw)
    out_t = capsys.readouterr().out
    want = j_abc.main(**kw)
    out_j = capsys.readouterr().out
    assert_same(got, want)
    assert out_t == out_j and "F-Score @ 5 mm" in out_t
    assert got[1]["curve"]["num_gt_total"] > 0
    gt_dir = str(root / "dataset" / "groundtruth")
    for scan in ("00000042", "00000044"):
        assert_same(tm.get_gt_points_abc(scan, "curve", 0.005, True, gt_dir),
                    jm.get_gt_points_abc(scan, "curve", 0.005, True, gt_dir))


def test_eval_dtu_equal(tmp_path, capsys):
    rng = np.random.default_rng(3)
    scans = ["scan998", "scan999"]
    for scan in scans:
        exp = tmp_path / "exp" / scan / "emap" / "results"
        exp.mkdir(parents=True)
        (exp / "parametric_edges.json").write_text(json.dumps(
            edges_json(rng, scale=0.5)))
        data = tmp_path / "dataset" / "data" / scan
        data.mkdir(parents=True)
        w2g = np.diag([100.0, 100.0, 100.0, 1.0])
        w2g[:3, 3] = rng.uniform(-5, 5, 3)
        (data / "meta_data.json").write_text(json.dumps(
            {"worldtogt": w2g.tolist()}))
        gt = tmp_path / "dataset" / "groundtruth" / "edge_points" / scan
        gt.mkdir(parents=True)
        write_ply_points(str(gt / "edge_points.ply"),
                         rng.uniform(-40, 40, (400, 3)) + w2g[:3, 3])
    (tmp_path / "scans.txt").write_text("\n".join(scans) + "\n")
    kw = dict(base_dir=str(tmp_path / "exp"),
              dataset_dir=str(tmp_path / "dataset"), exp_name="emap",
              threshold=5.0, scan_list=str(tmp_path / "scans.txt"))
    got = t_dtu.main(**kw)
    out_t = capsys.readouterr().out
    want = j_dtu.main(**kw)
    assert_same(got, want)
    assert out_t == capsys.readouterr().out
    assert 0.0 < got[0][0] < 1.0


def test_scan_lists_are_the_reference_lists():
    for name in ("ABC_scans.txt", "DTU_scans.txt"):
        with open(os.path.join(REPO, "emap_tpu", "eval", name)) as f:
            want = f.read()
        with open(os.path.join(REPO, "emap_tpu_torch", "eval", name)) as f:
            assert f.read() == want


@pytest.mark.parametrize("obj", ["cube", "rings"])
def test_score_extraction_equal(tmp_path, obj):
    """The synthetic scorer on a fixed parametric_edges.json with lines and
    curves near the wireframe: exactly scripts/e2e_synthetic.py's."""
    rng = np.random.default_rng(4)
    if obj == "cube":
        from emap_tpu_torch.data.synthetic import cube_edges

        segs = cube_edges(0.5) + rng.normal(0, 0.004, (12, 2, 3))
        lines = segs.reshape(12, 6).tolist()
        curves = []
    else:
        theta = np.linspace(0, 2 * np.pi, 9)
        curves = []
        for a, b in zip(theta[:-1], theta[1:]):
            t = np.linspace(a, b, 4)
            ctl = np.stack([0.5 * np.cos(t), 0.5 * np.sin(t),
                            np.zeros(4)], 1) + rng.normal(0, 0.003, (4, 3))
            curves.append(ctl.reshape(-1).tolist())
        lines = [[0.5, 0.0, -0.1, 0.5, 0.0, 0.1]]
    edge_dict = {"lines_end_pts": lines, "curves_ctl_pts": curves}
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "parametric_edges.json").write_text(
        json.dumps(edge_dict))
    got = score_extraction(str(tmp_path), edge_dict, obj)
    want = e2e_synthetic().score_extraction(str(tmp_path), edge_dict, obj)
    assert_same(got, want)
    assert got["fscore_0.02"] > 0.3


def test_production_driver_at_toy_size(tmp_path, monkeypatch):
    """scripts/torch_run_production.py on the CPU with a toy net: stopped
    after step 2 and run again, it resumes, extracts and writes the JAX
    driver's report keys, with the score of eval/synthetic.py."""
    from emap_tpu_torch import config
    from emap_tpu_torch.train import runner as trunner

    conf = config.parse_file(os.path.join(REPO, "confs", "ABC.conf"))
    for k, v in {"batch_size": 16, "report_freq": 1, "save_freq": 1,
                 "val_freq": 100}.items():
        conf[f"train.{k}"] = v
    for k, v in {"d_hidden": 16, "n_layers": 4, "skip_in": [2],
                 "multires": 2}.items():
        conf[f"model.udf_network.{k}"] = v
    conf["model.udf_renderer.n_samples"] = 8
    conf["model.udf_renderer.n_importance"] = 5
    for k, v in {"resolution": 16, "sampling_N": 4, "auto_threshold": [],
                 "fit_draws": 1}.items():
        conf[f"edge_extraction.{k}"] = v
    (tmp_path / "toy.conf").write_text(conf.to_hocon())
    monkeypatch.setattr(trunner, "LOSS_WINDOW", 2)
    for k, v in {"PROD_CONF": str(tmp_path / "toy.conf"),
                 "PROD_OUT": str(tmp_path / "out"), "PROD_ITERS": "4",
                 "PROD_STOP_AT": "2", "PROD_DEVICE": "cpu"}.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "torch_run_production",
        os.path.join(REPO, "scripts", "torch_run_production.py"))
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    assert driver.main() == {}  # stopped after step 2
    report = driver.main()
    assert [(p["from"], p["to"]) for p in report["train_parts"]] == [
        (0, 2), (2, 4)]
    assert {"conf", "seed", "iters", "train_wall_s", "extract_wall_s",
            "gates", "score"} <= set(report)
    assert report["iters"] == 4 and report["seed"] == 42
    assert report["gates"]["iter_step"] == 4
    with open(tmp_path / "out" / "report.json") as f:
        assert json.load(f)["score"].keys() == report["score"].keys()
    exp = tmp_path / "out" / "exp" / "00000325" / "emap"
    with open(exp / "results" / "parametric_edges.json") as f:
        edges = json.load(f)
    assert_same(report["score"], e2e_synthetic().score_extraction(
        str(exp), edges, "cube"))
