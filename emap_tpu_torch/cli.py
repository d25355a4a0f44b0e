"""Conf-driven CLI, the same interface as emap_tpu/cli.py:

    python -m emap_tpu_torch.cli --conf confs/ABC.conf \
        --mode {train,extract_edge} [--scan SCAN] [--is_continue] \
        [--device cuda|cpu] [--stop_at STEP]

Runs on the card unless `--device cpu` is given. `--mode extract_edge`
reads the conf's `edge_extraction` block as emap_tpu/cli.py does and
extracts from the run's checkpoint. `--stop_at` (the port's own) ends a
training run after STEP, with the schedules still set by `train.end_iter`;
`--is_continue` then resumes it exactly.
"""

from __future__ import annotations

import argparse
import logging

from emap_tpu_torch import config
from emap_tpu_torch.train.runner import Runner

RUNNERS = {"udf": Runner}


def get_runner(model_type: str):
    if model_type not in RUNNERS:
        raise ValueError(f"unknown model_type: {model_type}")
    return RUNNERS[model_type]


def main(argv=None) -> Runner:
    """Parse `argv`, build the runner and run the mode; returns the runner
    (its `history` holds the fetched per-step metrics)."""
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

    logging.info("Run on scan %s", conf["dataset.scan"])
    runner_cls = get_runner(conf["general.model_type"])
    runner = runner_cls(conf, args.mode, args.is_continue, device=args.device)
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


def run() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(filename)s:%(lineno)s - %(funcName)20s() ] %(message)s")
    main()


if __name__ == "__main__":
    run()
