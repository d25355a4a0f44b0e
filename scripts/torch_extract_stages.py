#!/usr/bin/env python3
"""Stage-by-stage dump of the port's edge extraction on one checkpoint: the
twin of scripts/diag_platform.py's `stage` command, on the card or the CPU.

    python3 scripts/torch_extract_stages.py CONF OUT_DIR [--ckpt PATH]
        [--res N] [--thresholds T,T,...] [--iters N] [--device cuda|cpu]
        [--obj cube|rings] [--seed S] [--no-fit]
    python3 scripts/torch_extract_stages.py CONF OUT_DIR --fit-dump NPZ
        [--res N] [--obj cube|rings]

CONF is a run's conf copy (e.g. RUN_DIR/Replica_standin.conf from
scripts/torch_run_production.py). The port's runner loads the checkpoint
(default: the conf's `train.latest_model_name` in the run's checkpoints)
and extract_pointcloud_multi runs the conf's `edge_extraction` block:
resolution, the thresholds (`auto_threshold`, else `udf_threshold`),
sampling_N, sampling_delta, is_pointshift, iters and is_linedirection,
with the options above put in their place (--seed: the line-direction
jitter's seed, the runner's 42 by default). For each threshold t it writes
OUT_DIR/stages_<t>.npz in the layout that `scripts/diag_platform.py
compare` and `fit` read, with their keys and units (backend, prec, quant,
cand_idx: flat indices of the grid voxels under t; df0, nrm0: the first
sweep's clamped udf and normals there; xyz, line_dirs: the cloud; final_df:
the last sweep's udf at it). Unless --no-fit, each cloud is fitted as the
runner fits it (fit seed 42, the conf's visible_checking, the scene's edge
maps) and scored against the scene's analytic wireframe (`--obj`), and
OUT_DIR/stage_counts.json holds, per threshold: the grid mask count, the
cloud size, the points after the voxel downsample, the polylines grown,
lines and curves before and after the merge, the visibility filter's
kept and dropped, the final counts, the points sampled along them (what
threshold_selection.json calls n_points) and F@5/10/20mm, and for the
field `gt_udf`: |udf| at the scene's analytic edge points (mean, median,
90th percentile, max; scripts/diagnose_seeds.py's statistics). On the card
it prints the card's name and power limit first.

Each fitted row also gives the line directions' sign coherence: the
share of points whose nearest neighbour's direction points the other way,
and the share of the fit's voxels whose averaged direction it has lost.

`--fit-dump NPZ` extracts nothing: it fits the cloud of a stage dump
(either package's) through the port's fit as `diag_platform.py fit` fits
it through the JAX package's (resolution --res, no visibility filter),
scores it and prints the counts, so that each cloud goes through each
package's fit; once with the dump's line directions as they are and once
turned by extract/pointcloud.py::canonical_sign. Each row gives the share
of directions that canonical_sign turns (`signs_changed`).

To diff the port against the JAX package on the same checkpoint, dump the
JAX package's stages with `python tests/test_torch_extract_stages.py CONF
OUT_DIR` (the same options) and run `DP_RES=<res> python
scripts/diag_platform.py compare <jax npz> <port npz>`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def extraction_options(conf, args) -> dict:
    """The conf's edge_extraction block with the command line's overrides."""
    ee = conf.get_config("edge_extraction")
    thresholds = (args.thresholds or list(ee.get_list("auto_threshold", []))
                  or [ee.get_float("udf_threshold")])
    return {
        "resolution": args.res or ee.get_int("resolution"),
        "thresholds": sorted(float(t) for t in thresholds),
        "sampling_N": ee.get_int("sampling_N", 50),
        "sampling_delta": ee.get_float("sampling_delta", 5e-3),
        "is_pointshift": ee.get_bool("is_pointshift", False),
        "iters": args.iters if args.iters is not None else ee.get_int(
            "iters", 1),
        "is_linedirection": ee.get_bool("is_linedirection", False),
        "visible_checking": ee.get_bool("visible_checking", False),
    }


def direction_coherence(points, line_dirs, resolution: int) -> dict:
    """How far the cloud's line directions agree in sign: the share of
    points whose nearest neighbour's direction points the other way, and
    the share of the fit's voxels (its downsample at 2 / resolution) whose
    directions average, through their colours, to a vector shorter than
    0.5 (a direction the averaging has lost)."""
    import numpy as np
    from scipy.spatial import cKDTree

    from emap_tpu_torch.extract.fitting import voxel_downsample_with_colors

    if len(points) < 2:
        return {"nn_opposite": 0.0, "voxels_lost": 0.0}
    _, nn = cKDTree(points).query(points, k=2)
    _, colors = voxel_downsample_with_colors(
        points, (line_dirs + 1.0) / 2.0, 2.0 / resolution)
    return {"nn_opposite": float(np.mean(
                np.sum(line_dirs * line_dirs[nn[:, 1]], axis=1) < 0)),
            "voxels_lost": float(np.mean(
                np.linalg.norm(colors * 2.0 - 1.0, axis=1) < 0.5))}


def fit_counts(points, line_dirs, opts: dict, detector: str, data_dir: str,
               fit_dir: str, obj: str) -> dict:
    """Fit one cloud as the runner does and score it: the fit's, merge's and
    visibility filter's counts, and the F-scores."""
    from emap_tpu_torch.eval.synthetic import score_extraction
    from emap_tpu_torch.extract.parametric import get_parametric_edge

    trace: list = []
    pred, edge_dict = get_parametric_edge(
        points, (line_dirs + 1.0) / 2.0, opts["resolution"], detector,
        data_dir, visible_checking=opts["visible_checking"], seed=42,
        trace=trace)
    by = {t["stage"]: t for t in trace}
    os.makedirs(os.path.join(fit_dir, "results"), exist_ok=True)
    with open(os.path.join(fit_dir, "results", "parametric_edges.json"),
              "w") as f:
        json.dump(edge_dict, f)
    score = score_extraction(fit_dir, edge_dict, obj)
    fit = by["edge_fit"]
    return {
        "downsampled": fit["downsampled"], "polylines": fit["polylines"],
        "lines_fitted": fit["lines"], "curves_fitted": fit["curves"],
        "lines_merged": by["merge"]["lines"],
        "curves_merged": by["merge"]["curves"],
        "visibility_kept": by.get("visibility", {}).get("kept"),
        "visibility_dropped": by.get("visibility", {}).get("dropped"),
        "lines": score["n_lines"], "curves": score["n_curves"],
        "primitive_points": int(len(pred)),
        **{k: score[k] for k in ("fscore_0.005", "fscore_0.01",
                                 "fscore_0.02", "precision_0.005",
                                 "chamfer")},
        "fit_seconds": fit["seconds"],
        **direction_coherence(points, line_dirs, opts["resolution"]),
    }


def gt_udf(params, ucfg, obj: str) -> dict:
    """|udf| at the scene's analytic edge points (every 5 mm along the
    cube's edges or the three rings): the field's own error on the true
    edges, scripts/diagnose_seeds.py's gt_udf statistics."""
    import numpy as np
    import torch

    from emap_tpu_torch.data.synthetic import (
        sample_cube_edge_points,
        sample_ring_edge_points,
    )
    from emap_tpu_torch.kernels.mlp_query import query_value

    gt = (sample_ring_edge_points(0.5, spacing=0.005) if obj == "rings"
          else sample_cube_edge_points(0.5, spacing=0.005))
    with torch.no_grad():
        vals = np.abs(query_value(params, torch.as_tensor(
            gt, device=params["lin0"]["b"].device), ucfg).cpu().numpy())
    return {"mean": float(vals.mean()), "median": float(np.median(vals)),
            "p90": float(np.percentile(vals, 90)), "max": float(vals.max()),
            "frac_above_0.02": float((vals > 0.02).mean())}


def main(argv=None) -> int:
    import numpy as np
    import torch

    from emap_tpu_torch import config
    from emap_tpu_torch.extract.pointcloud import (
        canonical_sign,
        extract_pointcloud_multi,
    )
    from emap_tpu_torch.train.runner import Runner

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("conf")
    p.add_argument("out_dir")
    p.add_argument("--ckpt", default="")
    p.add_argument("--res", type=int, default=0)
    p.add_argument("--thresholds", type=lambda s: [float(t) for t in
                                                   s.split(",")],
                   default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--obj", default="cube", choices=["cube", "rings"])
    p.add_argument("--seed", type=int, default=42,
                   help="the line-direction jitter's seed (the runner's 42)")
    p.add_argument("--no-fit", dest="fit", action="store_false")
    p.add_argument("--fit-dump", default="")
    args = p.parse_args(argv)

    conf = config.parse_file(args.conf)
    opts = extraction_options(conf, args)
    if args.fit_dump:
        dump = np.load(args.fit_dump)
        dirs = dump["line_dirs"].astype(np.float32)
        turned = canonical_sign(torch.as_tensor(dirs)).numpy()
        changed = float(np.mean(np.sum(dirs * turned, axis=1) < 0))
        for signs, d in (("as_dumped", dirs), ("canonical_sign", turned)):
            row = fit_counts(dump["xyz"], d,
                             dict(opts, visible_checking=False),
                             conf.get_string("dataset.detector"), "",
                             os.path.join(args.out_dir, signs), args.obj)
            print(json.dumps({"dump": args.fit_dump, "signs": signs,
                              "backend": str(dump["backend"]),
                              "cloud": int(len(dump["xyz"])),
                              "signs_changed": changed, **row}))
        return 0

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_extract_stages: no CUDA device; pass "
                         "--device cpu for the kernels' plain versions")
    card = ""
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"card: {card}", flush=True)
    runner = Runner(conf, "extract_edge", device=torch.device(args.device))
    runner.load_checkpoint(args.ckpt or None)
    params = runner.state.params["udf"]
    os.makedirs(args.out_dir, exist_ok=True)

    trace: list = []
    stages: dict = {}
    t0 = time.perf_counter()
    clouds = extract_pointcloud_multi(
        params, runner.ucfg, opts["resolution"], opts["thresholds"],
        sampling_N=opts["sampling_N"], sampling_delta=opts["sampling_delta"],
        is_pointshift=opts["is_pointshift"], iters=opts["iters"],
        is_linedirection=opts["is_linedirection"], seed=args.seed,
        trace=trace, stages=stages)
    extract_s = time.perf_counter() - t0
    backend = f"torch-{args.device}"
    rows = {}
    for t in opts["thresholds"]:
        xyz, line_dirs = clouds[t]
        st = stages[t]
        name = f"stages_{t:g}.npz"
        np.savez_compressed(
            os.path.join(args.out_dir, name), backend=backend,
            prec=runner.ucfg.precision, quant=0.0, cand_idx=st["cand_idx"],
            df0=st["df0"], nrm0=st["nrm0"], xyz=xyz, line_dirs=line_dirs,
            final_df=st["final_df"])
        row = {"dump": name, "mask": int(len(st["cand_idx"])),
               "cloud": int(len(xyz))}
        if args.fit:
            row.update(fit_counts(
                xyz, line_dirs, opts, runner.scene.detector,
                runner.scene.data_dir,
                os.path.join(args.out_dir, f"fit_{t:g}"), args.obj))
        rows[f"{t:g}"] = row
        print(f"stages {t:g}: {json.dumps(row)}", flush=True)
    report = {"conf": os.path.abspath(args.conf),
              "checkpoint": args.ckpt or runner.latest_model_name,
              "iter_step": int(runner.state.step), "backend": backend,
              "card": card, "precision": runner.ucfg.precision,
              "options": opts, "extract_seconds": extract_s,
              "gt_udf": gt_udf(params, runner.ucfg, args.obj),
              "device_stages": [t for t in trace if t["stage"] in
                                ("grid", "sweep")],
              "thresholds": rows}
    print(f"gt_udf: {json.dumps(report['gt_udf'])}", flush=True)
    with open(os.path.join(args.out_dir, "stage_counts.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
