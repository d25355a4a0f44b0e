#!/usr/bin/env python3
"""`--mode extract_edge` of one finished run at several world sizes, each
world's result files held byte for byte against one process's.

    python3 scripts/torch_sharded_extract.py RUN [--worlds 1,2,4]
        [--out OUT] [--device cuda|cpu] [--stages]

RUN is a finished run of scripts/torch_run_production.py (its
`<conf>_standin.conf`, `data/` and `exp/.../checkpoints/<latest_model_name>`;
the directory may have been moved since it ran) or a conf file whose
`dataset.data_dir` and `general.base_exp_dir` hold them. For each world w
the conf copy, the scene and the checkpoint are copied into OUT/world<w>
(default OUT: RUN/sharded), and `emap_tpu_torch.cli.main(["--conf", ...,
"--mode", "extract_edge"], n_devices=w)` runs there: one process at world
1, w spawned ranks (NCCL on cards 0..w-1, gloo on the CPU) otherwise,
which share the grid and the sweeps while rank 0 fits and writes. The
world must be what the CLI's rule gives for w devices.

Each world prints its extraction's stage seconds (rank 0's trace summed
by stage), each rank's kernel launches and collectives, and rank 0's peak
device memory; then each world's `results/` files (the two PLYs,
parametric_edges.json and threshold_selection.json where the conf has a
menu) are compared with world 1's. `--stages` also runs each world's
device stages once more with their stage arrays kept
(extract_pointcloud_multi's `stages`: every threshold's grid mask as
candidate indices, the first sweep's udf and normals, the cloud, its line
directions and last udf) and writes them to OUT/world<w>/stages.npz, so
that a difference is named at the first stage it shows in, in pipeline
order: grid masks, first sweep, cloud, line directions, then the files
(cloud written, selector table, fit, the fit's sampled points). The exit
code is 1 on any difference, 0 otherwise; a failing rank ends the run
with its error.
On the card it prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from torch_run_production import stage_seconds  # noqa: E402

# result files in the order the pipeline writes what they hold, each with
# the stage it comes from
RESULT_FILES = {
    "udf_pointcloud_withdirection.ply": "the cloud written (points and "
                                        "line directions at the pick)",
    "threshold_selection.json": "the threshold selector's table",
    "parametric_edges.json": "the fit (parametric_edges.json)",
    "edge_points.ply": "the fit's sampled points (edge_points.ply)",
}
# stage arrays (--stages) in pipeline order
STAGE_ARRAYS = {
    "cand_idx": "grid masks",
    "df0": "first sweep (udf)",
    "nrm0": "first sweep (normals)",
    "xyz": "cloud (shifted points)",
    "line_dirs": "line directions",
    "final_df": "last sweep (udf)",
}


def run_files(run: str) -> tuple:
    """(conf, the scene's data directory, the checkpoint) of a run."""
    from emap_tpu_torch import config

    if os.path.isdir(run):
        confs = (glob.glob(os.path.join(run, "*_standin.conf"))
                 or glob.glob(os.path.join(run, "*.conf")))
        if len(confs) != 1:
            raise SystemExit(f"{run}: expected one conf copy, found {confs}")
        conf_path = confs[0]
    else:
        conf_path, run = run, os.path.dirname(os.path.abspath(run))
    conf = config.parse_file(conf_path)
    data = os.path.join(run, "data")
    if not os.path.isdir(data):
        data = conf.get_string("dataset.data_dir")
    exp = os.path.join(run, "exp")
    if not os.path.isdir(exp):
        exp = conf.get_string("general.base_exp_dir")
    ckpt = os.path.join(exp, str(conf["dataset.scan"]),
                        conf.get_string("general.expname"), "checkpoints",
                        conf.get_string("train.latest_model_name",
                                        "ckpt_best.npz"))
    if ckpt.endswith(".pth") and not os.path.exists(ckpt):
        ckpt = ckpt[:-4] + ".npz"  # the runner's fall-back (load_checkpoint)
    for path in (data, ckpt):
        if not os.path.exists(path):
            raise SystemExit(f"{run}: no {path}")
    return conf, data, ckpt


def world_dir(out: str, world: int) -> str:
    return os.path.join(out, f"world{world}")


def prepare(run: str, out: str, world: int) -> str:
    """OUT/world<w>: the conf copy pointing there, the scene and the
    checkpoint. Returns the conf copy's path."""
    conf, data, ckpt = run_files(run)
    root = world_dir(out, world)
    if os.path.exists(root):
        shutil.rmtree(root)
    shutil.copytree(data, os.path.join(root, "data"))
    conf["dataset.data_dir"] = os.path.join(root, "data")
    conf["general.base_exp_dir"] = os.path.join(root, "exp")
    exp_dir = os.path.join(root, "exp", str(conf["dataset.scan"]),
                           conf.get_string("general.expname"))
    os.makedirs(os.path.join(exp_dir, "checkpoints"))
    shutil.copy(ckpt, os.path.join(exp_dir, "checkpoints",
                                   os.path.basename(ckpt)))
    path = os.path.join(root, "extract.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def extract_world(conf_path: str, world: int, device: str) -> dict:
    """`--mode extract_edge` at `world` through the CLI: its wall seconds
    and, by rank, the extraction trace, launches, collectives and peak
    device memory (bytes; None on the CPU)."""
    import torch

    from emap_tpu_torch import cli
    from emap_tpu_torch.kernels import launch_counts

    argv = ["--conf", conf_path, "--mode", "extract_edge", "--device", device]
    on_card = torch.device(device).type == "cuda"
    before = launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = cli.main(argv, n_devices=world)
    wall = time.perf_counter() - t0
    if world == 1:
        ranks = [{"rank": 0, "world": 1, "extract_trace": got.extract_trace,
                  "launches": {k: v - before[k]
                               for k, v in launch_counts().items()},
                  "collectives": 0,
                  "peak_bytes": (torch.cuda.max_memory_allocated()
                                 if on_card else None)}]
    else:
        ranks = got
    worlds = {r["world"] for r in ranks}
    if worlds != {world}:
        raise SystemExit(f"asked for world {world}, the CLI ran {worlds}")
    return {"wall": wall, "ranks": ranks}


def stage_share(group, conf_path: str, device: str) -> dict | None:
    """The device stages of the conf's extraction with their stage arrays
    (under a `group`, this rank's share; rank 0 returns the arrays)."""
    from emap_tpu_torch import config
    from emap_tpu_torch.extract.pointcloud import extract_pointcloud_multi
    from emap_tpu_torch.train.runner import Runner

    conf = config.parse_file(conf_path)
    runner = Runner(conf, "extract_edge", device=device, group=group)
    runner.load_checkpoint()
    params = {k: {n: t.detach() for n, t in layer.items()}
              for k, layer in runner.state.params["udf"].items()}
    ee = conf.get_config("edge_extraction")
    thresholds = ([float(t) for t in ee.get_list("auto_threshold", [])]
                  or [ee.get_float("udf_threshold")])
    stages: dict = {}
    out = extract_pointcloud_multi(
        params, runner.ucfg, ee.get_int("resolution"), thresholds,
        sampling_N=ee.get_int("sampling_N"),
        sampling_delta=ee.get_float("sampling_delta"),
        is_pointshift=ee.get_bool("is_pointshift"),
        iters=ee.get_int("iters"),
        is_linedirection=ee.get_bool("is_linedirection"), group=group,
        stages=stages)
    if group is not None and group.rank != 0:
        return None
    arrays = {}
    for t, (xyz, dirs) in out.items():
        arrays.update({f"{k}@{t}": v for k, v in stages[t].items()})
        arrays[f"xyz@{t}"], arrays[f"line_dirs@{t}"] = xyz, dirs
    return arrays


def dump_stages(conf_path: str, world: int, device: str, path: str) -> None:
    import numpy as np

    from emap_tpu_torch.parallel.mesh import launch

    if world == 1:
        arrays = stage_share(None, conf_path, device)
    else:
        import torch

        arrays = launch(stage_share, world, torch.device(device).type,
                        conf_path, device)[0]
    np.savez(path, **arrays)


def first_difference(out: str, world: int) -> str | None:
    """The first stage at which world `world` differs from world 1 (stage
    arrays where both worlds dumped them, then the result files), or
    None."""
    import numpy as np

    one, other = world_dir(out, 1), world_dir(out, world)
    dumps = [os.path.join(d, "stages.npz") for d in (one, other)]
    if all(os.path.exists(p) for p in dumps):
        a, b = (np.load(p) for p in dumps)
        if sorted(a.files) != sorted(b.files):
            return (f"stage arrays (keys {sorted(a.files)} vs "
                    f"{sorted(b.files)})")
        thresholds = sorted({k.split("@")[1] for k in a.files}, key=float)
        for name, stage in STAGE_ARRAYS.items():
            for t in thresholds:
                key = f"{name}@{t}"
                if key not in a.files:
                    continue
                x, y = a[key], b[key]
                if x.shape != y.shape or x.tobytes() != y.tobytes():
                    n = (int(np.sum(x != y)) if x.shape == y.shape
                         else f"shape {x.shape} vs {y.shape}")
                    return f"{stage} at threshold {t} ({n} entries differ)"
    results = [glob.glob(os.path.join(d, "exp", "*", "*", "results"))
               for d in (one, other)]
    if not all(len(r) == 1 for r in results):
        return f"results directories {results}"
    names = [sorted(os.listdir(r[0])) for r in results]
    if names[0] != names[1]:
        return f"the result files written ({names[0]} vs {names[1]})"
    for name, stage in RESULT_FILES.items():
        if name not in names[0]:
            continue
        with open(os.path.join(results[0][0], name), "rb") as f:
            want = f.read()
        with open(os.path.join(results[1][0], name), "rb") as f:
            if f.read() != want:
                return stage
    return None


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def report(world: int, got: dict) -> None:
    """Print a world's stage seconds (summed by stage; a stage's seconds
    include those of the stages it calls), rank 0's peak device memory,
    and each rank's launches and collectives."""
    rank0 = got["ranks"][0]
    secs = stage_seconds(rank0["extract_trace"])
    peak = rank0["peak_bytes"]
    print(f"world {world}: {got['wall']:.1f} s through cli.main; rank 0's "
          f"stages " + ", ".join(f"{k} {v['seconds']:.3f} s"
                                 for k, v in secs.items())
          + "; peak device memory of rank 0 "
          + ("-" if peak is None else f"{peak / 2 ** 30:.2f} GiB"),
          flush=True)
    for r in got["ranks"]:
        point_cloud = stage_seconds(r["extract_trace"]).get(
            "pointcloud", {"seconds": 0.0})["seconds"]
        print(f"world {world} rank {r['rank']}: launches "
              f"{ {k: v for k, v in r['launches'].items() if v} }, "
              f"collectives {r['collectives']}, pointcloud "
              f"{point_cloud:.3f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run", help="a finished run's directory or conf copy")
    ap.add_argument("--worlds", default="1,2,4",
                    help="world sizes, comma-separated; world 1 is the "
                         "reference and always runs")
    ap.add_argument("--out", default=None,
                    help="where the worlds run (default RUN/sharded)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--stages", action="store_true",
                    help="dump and compare each world's stage arrays")
    args = ap.parse_args(argv)
    worlds = sorted({1} | {int(w) for w in args.worlds.split(",")})
    run_root = args.run if os.path.isdir(args.run) else os.path.dirname(
        os.path.abspath(args.run))
    out = os.path.abspath(args.out or os.path.join(run_root, "sharded"))
    import logging

    import torch

    logging.basicConfig(level=logging.WARNING,
                        format="[%(filename)s:%(lineno)s] %(message)s")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no card is visible; pass --device cpu")
        print(f"card: {card()}", flush=True)
    for world in worlds:
        conf_path = prepare(args.run, out, world)
        report(world, extract_world(conf_path, world, args.device))
        if args.stages:
            t0 = time.perf_counter()
            dump_stages(conf_path, world, args.device,
                        os.path.join(world_dir(out, world), "stages.npz"))
            print(f"world {world}: stage arrays in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    bad = 0
    for world in worlds[1:]:
        diff = first_difference(out, world)
        if diff is None:
            print(f"world {world}: byte-identical to world 1", flush=True)
        else:
            bad += 1
            print(f"world {world}: DIFFERS from world 1; first differing "
                  f"stage: {diff}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
