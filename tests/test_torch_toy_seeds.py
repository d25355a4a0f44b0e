"""Both packages trained on the CPU from their own random draws, at toy width
on the synthetic cube, compared seed against seed: the test that a fault in
how the port makes its draws (which the matched-step tests, fed one batch,
cannot see) would fail over enough seeds.

The test below trains each package a few steps and checks the comparison's
parts. Run as a script, this file is the comparison itself:

    python tests/test_torch_toy_seeds.py OUT_DIR [--seeds 1,2,3,4,5]
        [--steps 3000] [--pkg jax|torch|both]

Each run trains toy_conf's net (ABC.conf with d_hidden 64, 4 layers,
multires 4, 256 rays of 32 + 20 samples, a schedule scaled to the steps)
on a 24-view 64x64 cube scene through the package's own step
(`emap_tpu.train.step.build_train_step`, donation off, as the JAX
package's Runner.train cannot run on the CPU; the port's Runner.train),
then writes OUT_DIR/run_<pkg>_<seed>.json: the means of the last 200
steps' metrics and the field's statistics on a 64^3 grid (field_stats,
through the port's query for both: the extraction is held equal by
tests/test_torch_extract_stages.py). OUT_DIR/summary.json gives each
statistic's mean and standard deviation over the seeds for each package,
and their difference in units of the pooled standard deviation.
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), ".."))

import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from emap_tpu_torch import config as tconfig  # noqa: E402
from emap_tpu_torch.data.synthetic import (  # noqa: E402
    cube_edges,
    make_synthetic_scene,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("loss", "edge_loss", "gradient_error", "variance", "udf_min",
           "weight_sum")
GRID = 64


def toy_conf(out_dir: str, seed: int, steps: int, pkg: str,
             hw: int = 64) -> str:
    """Write the scene (once) and the run's conf; returns the conf path."""
    data_dir = os.path.join(out_dir, "data")
    if not os.path.exists(os.path.join(data_dir, "cube000",
                                       "meta_data.json")):
        make_synthetic_scene(data_dir, scan="cube000", n_views=24, H=hw,
                             W=hw, detector="DexiNed", far=4.5, obj="cube")
    conf = tconfig.parse_file(os.path.join(REPO, "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = os.path.join(out_dir, f"exp_{pkg}_{seed}")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    conf["dataset.far"] = 4.5
    warm = max(1, steps // 30)
    for k, v in {"end_iter": steps, "batch_size": 256, "seed": seed,
                 "report_freq": min(100, steps), "save_freq": steps,
                 "val_freq": 10 * steps, "warm_up_end": warm,
                 "anneal_end": max(1, steps // 3), "fix_geo_end": warm // 2,
                 "learning_rate_geo": 1e-3,
                 "latest_model_name": "ckpt_best.npz"}.items():
        conf[f"train.{k}"] = v
    for k, v in {"d_hidden": 64, "n_layers": 4, "skip_in": [2],
                 "multires": 4, "precision": "highest"}.items():
        conf[f"model.udf_network.{k}"] = v
    conf["model.udf_renderer.n_samples"] = 32
    conf["model.udf_renderer.n_importance"] = 20
    conf["model.udf_renderer.sampler_precision"] = "highest"
    path = os.path.join(out_dir, f"toy_{pkg}_{seed}.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def train_jax(conf_path: str, steps: int):
    """(udf params as numpy, the last 200 steps' metrics) from the JAX
    package's step on its own draws."""
    from emap_tpu import config as jconfig
    from emap_tpu.train.runner import Runner
    from emap_tpu.train.step import build_train_step

    runner = Runner(jconfig.parse_file(conf_path), mode="train")
    step = build_train_step(runner.tcfg, runner.rcfg, runner.ucfg,
                            runner.scene.n_images, donate=False)
    state, rows = runner.state, []
    for i in range(steps):
        state, m = step(state, runner.pool)
        if i >= steps - 200:
            rows.append({k: float(m[k]) for k in METRICS})
    return jax.tree.map(np.asarray, state.params["udf"]), rows


def train_port(conf_path: str, steps: int):
    """The same from the port's Runner.train on the CPU."""
    from emap_tpu_torch.train.runner import Runner

    runner = Runner(tconfig.parse_file(conf_path), mode="train",
                    device=torch.device("cpu"))
    runner.train()
    assert runner.state.step == steps
    params = {k: {n: t.detach().numpy() for n, t in layer.items()}
              for k, layer in runner.state.params["udf"].items()}
    return params, [{k: h[k] for k in METRICS}
                    for h in runner.history[-200:]]


def field_stats(udf_params, grid: int = GRID) -> dict:
    """The field on a grid over [-1, 1]^3 through the port's query at
    "highest": its least value, its median at the voxels within 0.02 of the
    cube's edges and at those farther than 0.1, and the share of voxels
    under 0.05 and 0.1."""
    from emap_tpu_torch.ckpt.convert import params_from_numpy
    from emap_tpu_torch.extract.pointcloud import grid_points
    from emap_tpu_torch.fields.udf import UDFConfig, udf_value

    cfg = UDFConfig(d_hidden=64, n_layers=4, skip_in=(2,), multires=4,
                    precision="highest")
    scalars = {"variance": {"variance": np.float32(0.3),
                            "second_variance": np.float32(0.3)},
               "beta": {"beta": np.float32(0.5), "gamma": np.float32(0.3),
                        "zeta": np.float32(0.3)}}
    params = params_from_numpy({"udf": udf_params, **scalars}, cfg,
                               device="cpu")["udf"]
    pts = grid_points(0, grid ** 3, grid, "cpu")
    with torch.no_grad():
        u = udf_value(params, pts, cfg).numpy()
    d = edge_distance(pts.numpy().astype(np.float64))
    return {"udf_min": float(u.min()),
            "udf_on_edges": float(np.median(u[d < 0.02])),
            "udf_off_edges": float(np.median(u[d > 0.1])),
            "share_under_0.05": float((u < 0.05).mean()),
            "share_under_0.1": float((u < 0.1).mean())}


def edge_distance(p):
    """Distance from each point (M, 3) to the cube's 12 edges."""
    segs = cube_edges(0.5)
    out = np.full(len(p), np.inf)
    for a, b in segs:
        d = b - a
        t = np.clip((p - a) @ d / (d @ d), 0.0, 1.0)
        out = np.minimum(out, np.linalg.norm(p - a - t[:, None] * d, axis=1))
    return out


def run(out_dir: str, pkg: str, seed: int, steps: int) -> dict:
    conf_path = toy_conf(out_dir, seed, steps, pkg)
    t0 = time.perf_counter()
    params, rows = (train_jax if pkg == "jax" else train_port)(conf_path,
                                                               steps)
    row = {"pkg": pkg, "seed": seed, "steps": steps,
           "seconds": time.perf_counter() - t0,
           **{f"last200_{k}": float(np.mean([r[k] for r in rows]))
              for k in METRICS},
           **field_stats(params)}
    with open(os.path.join(out_dir, f"run_{pkg}_{seed}.json"), "w") as f:
        json.dump(row, f, indent=1)
    return row


def summarize(out_dir: str) -> dict:
    rows = []
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("run_") and name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                rows.append(json.load(f))
    keys = [k for k in rows[0] if k not in ("pkg", "seed", "steps",
                                            "seconds")]
    out = {}
    for k in keys:
        vals = {p: np.array([r[k] for r in rows if r["pkg"] == p])
                for p in ("jax", "torch")}
        if min(len(v) for v in vals.values()) < 2:
            continue
        sd = np.sqrt((vals["jax"].var(ddof=1) + vals["torch"].var(ddof=1))
                     / 2)
        out[k] = {"jax": [float(vals["jax"].mean()),
                          float(vals["jax"].std(ddof=1))],
                  "torch": [float(vals["torch"].mean()),
                            float(vals["torch"].std(ddof=1))],
                  "n": [len(vals["jax"]), len(vals["torch"])],
                  "diff_in_sd": float((vals["torch"].mean()
                                       - vals["jax"].mean()) / (sd + 1e-30))}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def test_both_packages_train_the_toy_and_are_summarized(tmp_path):
    """A few steps of each package at two seeds on the toy scene, the
    field's statistics and the summary: both packages train to finite
    metrics, and the summary holds every statistic with its two seeds a
    package. (Two seeds say nothing of the means: a geometric init's median
    udf away from the edges alone spans 0.23-0.66 over seeds 0-5.)"""
    out = str(tmp_path)
    for pkg in ("jax", "torch"):
        for seed in (1, 2):
            row = run(out, pkg, seed, 6)
            assert all(np.isfinite(row[f"last200_{k}"]) for k in METRICS)
            assert 0.0 <= row["share_under_0.1"] <= 1.0
            assert row["udf_on_edges"] > 0.0
    summary = summarize(out)
    assert set(summary) >= {"udf_min", "udf_on_edges", "share_under_0.1",
                            "last200_loss"}
    for k, row in summary.items():
        assert row["n"] == [2, 2], k
        assert np.isfinite(row["jax"] + row["torch"]).all(), k


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="toy-seed comparison")
    p.add_argument("out_dir")
    p.add_argument("--seeds", default="1,2,3,4,5")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--pkg", default="both", choices=["jax", "torch", "both"])
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    pkgs = ("jax", "torch") if args.pkg == "both" else (args.pkg,)
    for seed in (int(s) for s in args.seeds.split(",")):
        for pkg in pkgs:
            print(json.dumps(run(args.out_dir, pkg, seed, args.steps)),
                  flush=True)
    print(json.dumps(summarize(args.out_dir), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
