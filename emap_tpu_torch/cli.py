"""Conf-driven CLI, the same interface as emap_tpu/cli.py:

    python -m emap_tpu_torch.cli --conf confs/ABC.conf \
        --mode {train,extract_edge} [--scan SCAN] [--is_continue] \
        [--device cuda|cpu] [--stop_at STEP]

Runs on the card unless `--device cpu` is given. `--mode extract_edge`
reads the conf's `edge_extraction` block as emap_tpu/cli.py does and
extracts from the run's checkpoint. `--stop_at` (the port's own) ends a
training run after STEP, with the schedules still set by `train.end_iter`;
`--is_continue` then resumes it exactly.

Several cards: with `train.multi_device` (default true) and more than one
visible card, the mode runs on the largest number of cards that divides
`train.batch_size` (the JAX CLI's rule, parallel/mesh.py::world_size), one
process a card over NCCL, rays sharded and gradients summed; rank 0 writes
the run's files. `train.multi_device = false` keeps one process.
"""

from __future__ import annotations

import argparse
import logging

import torch

from emap_tpu_torch import config
from emap_tpu_torch.parallel.mesh import launch, world_size
from emap_tpu_torch.train.runner import Runner

RUNNERS = {"udf": Runner}


def get_runner(model_type: str):
    if model_type not in RUNNERS:
        raise ValueError(f"unknown model_type: {model_type}")
    return RUNNERS[model_type]


def run_mode(conf, args, device, group=None) -> Runner:
    """Build the runner and run the mode (`group`: this rank's RayGroup,
    or None for one process); returns the runner."""
    logging.info("Run on scan %s", conf["dataset.scan"])
    runner_cls = get_runner(conf["general.model_type"])
    runner = runner_cls(conf, args.mode, args.is_continue, device=device,
                        group=group)
    if args.mode == "train":
        runner.train(stop_at=args.stop_at)
    else:
        ee = conf.get_config("edge_extraction")
        runner.extract_edge(
            resolution=ee.get_int("resolution"),
            udf_threshold=ee.get_float("udf_threshold"),
            sampling_N=ee.get_int("sampling_N"),
            sampling_delta=ee.get_float("sampling_delta"),
            is_pointshift=ee.get_bool("is_pointshift"),
            iters=ee.get_int("iters"),
            is_linedirection=ee.get_bool("is_linedirection"),
            visible_checking=ee.get_bool("visible_checking"),
            auto_threshold=[float(t)
                            for t in ee.get_list("auto_threshold", [])],
            # "" = the runner's device; "cpu" extracts on the CPU
            platform=ee.get_string("platform", ""),
            # > 1 = best-of-K fit draws ranked by the GT-free probe scorer
            fit_draws=ee.get_int("fit_draws", 1),
        )
    return runner


def rank_summary(group, conf, args) -> dict:
    """One rank's run of the mode (parallel/mesh.py::launch): what the
    caller of `main` gets back from each rank. `launches`: the kernels'
    runs by "<kernel>/<tier>" (the wrappers' counts, less the launches the
    CUDA graph's capture counted, plus those its replays ran);
    `extract_trace`: the extraction's stages on this rank;
    `peak_bytes`: the rank's peak device memory (None on the CPU)."""
    from emap_tpu_torch.kernels import launch_counts

    runner = run_mode(conf, args, group.device, group)
    on_card = group.device.type == "cuda"
    return {"rank": group.rank, "world": group.world,
            "extract_trace": runner.extract_trace,
            "peak_bytes": (torch.cuda.max_memory_allocated(group.device)
                           if on_card else None),
            "step": runner.state.step, "history": runner.history,
            "timeline": runner.timeline,
            "params": {k: {n: t.detach().cpu().numpy()
                           for n, t in layer.items()}
                       for k, layer in runner.state.params["udf"].items()},
            "launches": {k: n - runner.captured_launches.get(k, 0)
                         + runner.replayed_launches.get(k, 0)
                         for k, n in launch_counts().items()},
            "collectives": group.collectives}


def main(argv=None, n_devices: int | None = None):
    """Parse `argv` and run the mode. On one device, returns the runner
    (its `history` holds the fetched per-step metrics). When the
    multi-device rule (`n_devices`, default: the visible devices of
    `--device`'s type) gives a world of 2 or more, runs the mode on that
    many spawned ranks and returns each rank's `rank_summary` in rank
    order."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", type=str, default="./confs/ABC.conf")
    parser.add_argument("--mode", type=str, default="train",
                        choices=["train", "extract_edge"])
    parser.add_argument("--scan", type=str, default="null")
    parser.add_argument("--gpu", type=int, default=0,
                        help="unused; kept for CLI parity")
    parser.add_argument("--is_continue", default=False, action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cpu runs the kernels' plain "
                             "versions")
    parser.add_argument("--stop_at", type=int, default=0,
                        help="train mode: stop after this step; "
                             "--is_continue resumes")
    args = parser.parse_args(argv)

    conf = config.parse_file(args.conf)
    if args.scan != "null":
        conf["dataset.scan"] = args.scan

    device_type = torch.device(args.device).type
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device_type == "cuda" else 1
    world = world_size(conf, conf.get_int("train.batch_size"), n_devices)
    if world > 1:
        if device_type == "cuda":
            from emap_tpu_torch.kernels.build import build_all

            build_all()  # once, before the ranks load the libraries
        return launch(rank_summary, world, device_type, conf, args)
    return run_mode(conf, args, args.device)


def run() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(filename)s:%(lineno)s - %(funcName)20s() ] %(message)s")
    main()


if __name__ == "__main__":
    run()
