#!/usr/bin/env python3
"""Chosen phases of chip_smoke.py alone, on one NVIDIA GPU, for the phases
that are slow to reach or need repeating:

    python3 scripts/torch_smoke_phases.py graph [N]    # phase 8, N times
    python3 scripts/torch_smoke_phases.py determinism  # the eager step
    python3 scripts/torch_smoke_phases.py confs        # phases 10 and 11
    python3 scripts/torch_smoke_phases.py parallel     # phase 12
    python3 scripts/torch_smoke_phases.py ranks        # its multi-rank runs
    python3 scripts/torch_smoke_phases.py public       # phase 13
    python3 scripts/torch_smoke_phases.py routes       # phase 9's step times

`graph` trains the smoke conf's 20 steps through the CLI (phase 4) and
runs phase 8 (CUDA graph replays against eager steps, bit for bit) N
times on that runner (default 8). `determinism` runs the eager step twice
from one state on one stream, and on the main stream against a side
stream, with each up-sampler, and lists the ops
`torch.use_deterministic_algorithms` names as nondeterministic in it.
`confs` runs phase 10 (Replica.conf's width) and phase 11 (DTU.conf's
extraction block) with the grid value kernel's 256^3 rows of phase 3.
`parallel` trains phase 4's run, writes phase 6's fixture checkpoint and
runs phase 12 (the multi-device path: a NCCL group of world 1 in the
process, and on a machine with two cards or more the spawned multi-rank
CLI runs). `ranks` runs only those multi-rank CLI runs (training, then
`--mode extract_edge` on phase 6's fixture checkpoint, at 2 and 4 ranks
against one process), so that a four-card machine's time goes to what
needs four cards. `public` runs phase 13 (the JAX package's last public
functions: a thick-line PidiNet scene trained on at Replica width,
udf_gradient, get_flow_vis, semantic_color_map, no cv2). `routes` trains
each of phase 9's kernel routes (the smoke conf with its tier keys pinned)
through the CLI and times its step as CUDA graph replays three times
(chip_smoke.py: replay_ms); run it from two checkouts in turns to compare
their kernels' step time.
A failed check is printed and the run goes on; the exit code is 1 if any
failed. Run from the repository root; needs the card.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import tempfile
import warnings

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)


def attempt(name: str, fn) -> bool:
    """fn() with chip_smoke.py's failures printed, not raised."""
    try:
        fn()
    except SystemExit as e:
        print(f"{name}: {str(e)[:300]}", flush=True)
        return False
    print(f"{name}: passed", flush=True)
    return True


def graph(tmp: str, smi: str, n: int) -> bool:
    import chip_smoke as cs
    from emap_tpu_torch import cli

    runner = cli.main(["--conf", cs.write_run_conf(tmp), "--mode", "train"],
                      n_devices=1)
    passed = [attempt(f"graph attempt {i}",
                      lambda: cs.graph_phase(runner, smi, float("inf")))
              for i in range(n)]
    print(f"graph: {sum(passed)} of {n} attempts passed", flush=True)
    return all(passed)


def determinism(tmp: str) -> bool:
    import torch

    import chip_smoke as cs
    from emap_tpu_torch import config
    from emap_tpu_torch.train.runner import Runner
    from emap_tpu_torch.train.step import build_train_step

    runner = Runner(config.parse_file(cs.write_run_conf(tmp)), "train",
                    device="cuda")
    ok = True
    for kind in ("classical", "mix"):
        step = build_train_step(
            runner.tcfg, dataclasses.replace(runner.rcfg,
                                             upsampling_type=kind),
            runner.ucfg, runner.scene.n_images)
        a, b = cs.copied_state(runner), cs.copied_state(runner)
        for _ in range(3):
            step(a, runner.pool)
            step(b, runner.pool)
        c = cs.copied_state(runner)
        main, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(3):
                step(c, runner.pool)
        main.wait_stream(side)
        torch.cuda.synchronize()
        want = cs.state_snapshot(a)
        twice = cs.differing(cs.state_snapshot(b), want)
        streams = cs.differing(cs.state_snapshot(c), want)
        print(f"determinism {kind}: 3 eager steps from one state, again: "
              f"{len(twice)} differing tensors; on a side stream: "
              f"{len(streams)}", flush=True)
        ok = ok and not twice and not streams
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        build_train_step(runner.tcfg, runner.rcfg, runner.ucfg,
                         runner.scene.n_images)(cs.copied_state(runner),
                                                runner.pool)
        torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message)[:200] for w in caught})
    print(f"determinism: {len(named)} ops named nondeterministic "
          f"{named}", flush=True)
    return ok and not named


def confs(tmp: str, smi: str) -> bool:
    import chip_smoke as cs
    from emap_tpu_torch import config
    from emap_tpu_torch.fields.udf import UDFConfig
    from emap_tpu_torch.render.renderer import RenderConfig

    abc = config.parse_file(os.path.join(REPO, "confs", "ABC.conf"))
    ucfg = UDFConfig.from_conf(abc.get_config("model.udf_network"))
    rcfg = RenderConfig.from_conf(abc.get_config("model.udf_renderer"))
    n = abc.get_int("train.batch_size") * rcfg.total_samples
    chunk = {r["tier"]: r for r in cs.kernel_phase(ucfg, n,
                                                   (cs.GRID_CHUNK_N,))
             if r["n"] == cs.GRID_CHUNK_N}
    data = cs.pidinet_scene(tmp)
    return all([
        attempt("phase 10", lambda: cs.replica_phase(tmp, data, n, smi)),
        attempt("phase 11", lambda: cs.dtu_phase(tmp, data, ucfg,
                                                 chunk["3xtf32"], smi))])


def parallel(tmp: str, smi: str) -> bool:
    import chip_smoke as cs
    from emap_tpu_torch import cli

    conf_path = cs.write_run_conf(tmp)
    runner = cli.main(["--conf", conf_path, "--mode", "train"], n_devices=1)
    cs.fixture_checkpoint(conf_path, runner.ucfg)
    return attempt("phase 12", lambda: cs.parallel_phase(runner, conf_path,
                                                         tmp, smi))


def ranks(tmp: str, smi: str) -> bool:
    import torch

    import chip_smoke as cs
    from emap_tpu_torch import config
    from emap_tpu_torch.fields.udf import UDFConfig

    cs.check(torch.cuda.device_count() >= 2, "the multi-rank runs need 2 "
             "cards or more")
    conf_path = cs.write_run_conf(tmp)
    trained = attempt("phase 12's multi-rank training",
                      lambda: cs.multi_rank_check(conf_path, tmp, smi))
    ucfg = UDFConfig.from_conf(config.parse_file(conf_path).get_config(
        "model.udf_network"))
    cs.fixture_checkpoint(conf_path, ucfg)
    return attempt("phase 12's multi-rank extraction",
                   lambda: cs.multi_rank_extract_check(conf_path, tmp,
                                                       smi)) and trained


def public(tmp: str, smi: str) -> bool:
    import chip_smoke as cs
    from emap_tpu_torch import config
    from emap_tpu_torch.fields.udf import UDFConfig

    abc = config.parse_file(os.path.join(REPO, "confs", "ABC.conf"))
    ucfg = UDFConfig.from_conf(abc.get_config("model.udf_network"))
    return attempt("phase 13",
                   lambda: cs.public_functions_phase(tmp, ucfg, smi))


def routes(tmp: str, smi: str) -> bool:
    import torch

    import chip_smoke as cs
    from emap_tpu_torch import cli

    conf_path = cs.write_run_conf(tmp)
    for name, pins, route, _ in cs.TRAIN_ROUTES:
        if route != "kernels":
            continue
        runner = cli.main(["--conf", cs.route_conf(conf_path, tmp, name, pins),
                           "--mode", "train"], n_devices=1)
        times = [cs.replay_ms(runner) for _ in range(3)]
        print(f"route {name}: {times} ms/step as CUDA graph replays (chains "
              f"of {cs.ROUTE_ITER}) on {smi}", flush=True)
        del runner
        torch.cuda.empty_cache()
    return True


def main() -> int:
    import torch

    import chip_smoke as cs
    from emap_tpu_torch import use_fp32_matmuls
    from emap_tpu_torch.kernels import build

    what = sys.argv[1] if len(sys.argv) > 1 else "graph"
    cs.check(torch.cuda.is_available(), "no CUDA device")
    logging.basicConfig(level=logging.WARNING)
    use_fp32_matmuls()
    smi = cs.smi_line()
    print(f"card: {smi}", flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        if what == "graph":
            ok = graph(tmp, smi, int(sys.argv[2]) if len(sys.argv) > 2
                       else 8)
        elif what == "determinism":
            ok = determinism(tmp)
        elif what == "confs":
            ok = confs(tmp, smi)
        elif what == "parallel":
            ok = parallel(tmp, smi)
        elif what == "ranks":
            ok = ranks(tmp, smi)
        elif what == "public":
            ok = public(tmp, smi)
        elif what == "routes":
            ok = routes(tmp, smi)
        else:
            raise SystemExit(f"unknown phase set {what!r}: graph, "
                             "determinism, confs, parallel, ranks, public or "
                             "routes")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
