#!/usr/bin/env python3
"""A production conf, verbatim, on the synthetic stand-in scene, through
the port's CLI: train -> extract_edge -> score against the analytic
wireframe, with the schedule gates read from the final checkpoint. The
counterpart of scripts/run_production.py for emap_tpu_torch.

    python3 scripts/torch_run_production.py

writes a 128x128, 24-view scene (cube or rings, `far` 4.5: the cameras
orbit at radius 2.2) with the port's scene writer, a copy of
confs/<PROD_CONF>.conf that overrides only `data_dir`, `far` and
`latest_model_name`, runs `emap_tpu_torch.cli.main` in train and then
extract_edge mode, scores the result with the ABC protocol
(emap_tpu_torch/eval/synthetic.py) and writes <PROD_OUT>/report.json with
the JAX driver's keys.

Environment: PROD_CONF (ABC; a path ending in .conf names a conf file,
as for a toy conf on the CPU), PROD_OUT (./e2e_torch_prod_<conf>),
PROD_ITERS (0: the conf's end_iter), PROD_OBJ (cube), PROD_SEED (0: the
conf's seed, 42), PROD_EXTRACT_RES (0: the conf's resolution), PROD_DEVICE
(cuda; cpu runs the kernels' plain versions, for toy runs).
PROD_STOP_AT (0: none) ends the training after that step and exits before
the extraction; running the script again with the same PROD_OUT resumes
the run exactly where it stopped (`--stop_at`, `--is_continue`), so a run
longer than one sitting can be taken in parts. Its train_wall_s sums the
parts.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

CONF = os.environ.get("PROD_CONF", "ABC")
CONF_PATH = (os.path.abspath(CONF) if CONF.endswith(".conf")
             else os.path.join(REPO, "confs", f"{CONF}.conf"))
CONF_NAME = os.path.basename(CONF_PATH)[:-len(".conf")]
OUT = os.path.abspath(os.environ.get("PROD_OUT",
                                     f"./e2e_torch_prod_{CONF_NAME.lower()}"))
ITERS = int(os.environ.get("PROD_ITERS", "0"))
OBJ = os.environ.get("PROD_OBJ", "cube")
SEED = int(os.environ.get("PROD_SEED", "0"))
EXTRACT_RES = int(os.environ.get("PROD_EXTRACT_RES", "0"))
STOP_AT = int(os.environ.get("PROD_STOP_AT", "0"))
DEVICE = os.environ.get("PROD_DEVICE", "cuda")


def write_conf():
    """The scene and the conf copy; returns (conf path, conf)."""
    from emap_tpu_torch import config
    from emap_tpu_torch.data.synthetic import make_synthetic_scene

    conf = config.parse_file(CONF_PATH)
    scan = conf.get_string("dataset.scan")
    data_dir = os.path.join(OUT, "data")
    if not os.path.exists(os.path.join(data_dir, scan, "meta_data.json")):
        make_synthetic_scene(data_dir, scan=scan, n_views=24, H=128, W=128,
                             detector=conf.get_string("dataset.detector"),
                             far=4.5, obj=OBJ)
    conf["general.base_exp_dir"] = os.path.join(OUT, "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.far"] = 4.5
    conf["train.latest_model_name"] = "ckpt_best.npz"
    if ITERS:  # short runs only; production runs the conf's schedule
        conf["train.end_iter"] = ITERS
    if SEED:  # multi-seed suites only; production runs seed 42
        conf["train.seed"] = SEED
    if EXTRACT_RES:
        conf["edge_extraction.resolution"] = EXTRACT_RES
    path = os.path.join(OUT, f"{CONF_NAME}_standin.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path, conf


def launches() -> dict:
    """The kernel wrappers' launch counts so far (0 on the CPU, where they
    run their plain versions)."""
    from emap_tpu_torch.kernels import mlp_query, mlp_train

    return {"mlp_value_and_grad": mlp_query.value_and_grad.launches,
            "mlp_train_bwd": mlp_train.train_bwd.launches,
            "mlp_value": mlp_query.value.launches}


def since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items()}


def main() -> dict:
    import logging

    logging.basicConfig(level=logging.INFO,
                        format="[%(filename)s:%(lineno)s] %(message)s")
    from emap_tpu_torch.ckpt.native import load_pytree
    from emap_tpu_torch.cli import main as cli_main
    from emap_tpu_torch.eval.synthetic import score_extraction
    from emap_tpu_torch.train import schedules

    os.makedirs(OUT, exist_ok=True)
    conf_path, conf = write_conf()
    end_iter = conf.get_int("train.end_iter")
    exp_dir = os.path.join(OUT, "exp", conf.get_string("dataset.scan"),
                           conf.get_string("general.expname"))
    ckpt_dir = os.path.join(exp_dir, "checkpoints")
    stop_file = os.path.join(ckpt_dir, "ckpt_stop.npz")
    parts_file = os.path.join(OUT, "train_parts.json")
    parts = []
    if os.path.exists(stop_file) and os.path.exists(parts_file):
        with open(parts_file) as f:
            parts = json.load(f)

    argv = ["--conf", conf_path, "--mode", "train", "--device", DEVICE]
    resumed = os.path.exists(stop_file)
    if resumed:
        argv.append("--is_continue")
    start = int(load_pytree(stop_file)["iter_step"]) if resumed else 0
    if start < STOP_AT < end_iter:
        argv += ["--stop_at", str(STOP_AT)]
    t0, before = time.time(), launches()
    runner = cli_main(argv)
    parts.append({"from": start, "to": int(runner.state.step),
                  "wall_s": time.time() - t0, "launches": since(before)})
    with open(parts_file, "w") as f:
        json.dump(parts, f, indent=1)
    if runner.state.step < end_iter:
        print(json.dumps({"stopped_at": runner.state.step,
                          "end_iter": end_iter, "parts": parts}))
        return {}
    train_wall = sum(p["wall_s"] for p in parts)

    t1, before = time.time(), launches()
    runner = cli_main(["--conf", conf_path, "--mode", "extract_edge",
                       "--device", DEVICE])
    extract_wall = time.time() - t1
    extract_launches = since(before)

    ckpt = load_pytree(os.path.join(ckpt_dir, "ckpt_best.npz"))
    gates = {
        "iter_step": int(ckpt["iter_step"]),
        **{k: bool(v) for k, v in ckpt["flags"].items()},
        "flip_saturation_at_0": float(schedules.flip_saturation(0, end_iter)),
        "flip_saturation_mid": float(
            schedules.flip_saturation(end_iter // 2, end_iter)),
        "flip_saturation_end": float(
            schedules.flip_saturation(end_iter - 1, end_iter)),
    }
    with open(os.path.join(exp_dir, "results", "parametric_edges.json")) as f:
        edges = json.load(f)
    edge_dict = {"lines_end_pts": edges.get("lines_end_pts", []),
                 "curves_ctl_pts": edges.get("curves_ctl_pts", [])}
    report = {
        "conf": f"{os.path.relpath(CONF_PATH, REPO)} (data_dir/far "
                "overridden)",
        "seed": SEED or 42,
        "iters": end_iter,
        "train_wall_s": round(train_wall, 1),
        "extract_wall_s": round(extract_wall, 1),
        "gates": gates,
        "score": score_extraction(exp_dir, edge_dict, OBJ),
        "train_parts": parts,
        "extract_launches": extract_launches,
        "extract_trace": runner.extract_trace,
    }
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump(report, f, indent=1, default=float)
    print(json.dumps(report, default=float))
    return report


if __name__ == "__main__":
    main()
