#!/usr/bin/env python3
"""Seeds of the production confs through the port, each held against the
JAX package's run of the same conf, object and seed.

    python3 scripts/torch_seed_suite.py run --root OUT [--steps N] JOB ...
    python3 scripts/torch_seed_suite.py compare --root OUT

A JOB is `conf:obj:seed`, e.g. `Replica:cube:3`.

`run` trains and scores every job through scripts/torch_run_production.py,
each job as its own process on one visible card (CUDA_VISIBLE_DEVICES=<i>,
PROD_OUT=<root>/<conf>_<obj>_s<seed>, its output appended to run.log
there). Jobs are dealt to the cards in turn, job i to card i mod n, and a
card runs its jobs one after another, so no card ever holds two. `--steps`
caps the training steps a card takes in this call: a job that would pass
the cap stops at a step the runner accepts (a multiple of 5,000) with
PROD_STOP_AT, and the same command line run again, with the root carried
over, resumes every job where it stopped; a job with its report is done
and is skipped. It exits non-zero when there is no card, when a job's
process fails (the card's later jobs are not started) and when a job that
ran its last part has no report. It never runs on the CPU.

`compare` reads every port report under the root (<dir>/report.json, with
the training rows of <dir>/run.log) and pairs it with the JAX run of the
same conf, object and seed (JAX_RUNS below: its report, the threshold
selector's table, and the `runner.py:420` rows of its log). For each pair
it prints the picked threshold, F@5/10mm, precision and recall at 5 mm,
lines, curves and primitive points; the selector's table candidate by
candidate; and the training metrics at STEPS. For each conf and object
(the ABC cube apart from the ABC rings) it prints the port's mean and sd
of F@5mm over its seeds beside the JAX band of RESULTS.md and the bar
(mean less two sd), and Welch's t of the two means. Each pair's header
row gives the port's primitive points as a percentage of the JAX run's,
and its lines + curves beside the JAX run's and as a ratio of them; a
last pooled row counts, over every pair with points on both sides, the
pairs above JAX, the mean and median excess, how many of those above JAX
also have the lower precision at 5 mm (where both are known), and the
exact one-sided sign test's p of so many above (ties with JAX left out).
Where both runs left a selector table, the pair also gives both sides'
points at the JAX run's picked threshold, each the mean over its fit
draws, and a second pooled row counts those (a pick that differs moves
the points at the pick by the threshold alone).
The port's runs whose directories are not under the root enter with the
summaries recorded for them (PORT_RECORDED, marked "recorded"); a report
under the root replaces the recorded row of its seed. The JAX run of
Replica seed 42 left no report of its own pick, so that seed has no
same-seed table.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
PRODUCTION = os.path.join(REPO, "scripts", "torch_run_production.py")

STOP_EVERY = 5000  # lcm(chain 500, save_freq 5,000): the stops the runner takes
STEPS = (1000, 10000, 50000, 100000, 150000, 200000)
METRICS = ("loss", "edge", "eik", "psnr", "s_val", "beta", "gamma", "w_sum",
           "udf_min")

# The JAX package's runs of the shipped confs on the 128x128 scenes:
# directory (report.json, threshold_selection.json or the report's own
# table) and log.
JAX_RUNS = {
    **{("ABC", "cube", s): (f"prod_suite_r4/final_s{s}",
                            f"prod_suite_r4/final_s{s}.log")
       for s in (42, 7, 99, 3, 1234)},
    **{("ABC", "rings", s): (f"prod_rings_r5/s{s}", f"prod_rings_r5/s{s}.log")
       for s in (42, 7, 99, 3, 1234)},
    ("Replica", "cube", 7): ("e2e_replica200k_s7", "e2e_replica200k_s7.log"),
    ("Replica", "cube", 99): ("r5_200k/replica_s99", "r5_200k/replica_s99.log"),
    ("Replica", "cube", 3): ("r5_200k/replica_s3", "r5_200k/replica_s3.log"),
    ("Replica", "cube", 1234): ("r5_200k/replica_s1234",
                                "r5_200k/replica_s1234.log"),
    ("DTU", "cube", 7): ("e2e_dtu200k_s7", "e2e_dtu200k_s7.log"),
    ("DTU", "cube", 99): ("r5_200k/dtu_s99", "r5_200k/dtu_s99.log"),
    ("DTU", "cube", 3): ("r5_200k/dtu_s3", "r5_200k/dtu_s3.log"),
}
# RESULTS.md:19-22: the JAX band's F@5mm by (conf, obj) and seed (42 is
# the "orig" run; the ABC cube's band adds five fresh seeds).
JAX_BAND = {
    ("ABC", "cube"): {42: 0.8149, 7: 0.8715, 99: 0.9548, 3: 0.9222,
                      1234: 0.8449, 11: 0.8957, 17: 0.9624, 23: 0.7355,
                      31: 0.8359, 57: 0.8800},
    ("ABC", "rings"): {42: 0.4122, 7: 0.3958, 99: 0.3131, 3: 0.3733,
                       1234: 0.4264},
    ("Replica", "cube"): {42: 0.7126, 7: 0.7164, 99: 0.6692, 3: 0.7506,
                          1234: 0.6816},
    ("DTU", "cube"): {42: 0.9424, 7: 0.9375, 99: 0.9253, 3: 0.9246},
}
# The port's runs recorded in PERF.md section 5 (on an NVIDIA H100 80GB
# HBM3 at 700 W, after the sign repair), whose directories are not in the
# repo: each (conf, obj, seed)'s summary, None where not recorded.
PORT_RECORDED = {
    ("Replica", "cube", 42): {"picked": 0.005, "f5": 0.6346, "f10": 0.8147,
                              "p5": 0.486, "r5": None, "lines": 221,
                              "curves": 79, "points": 5735},
    ("Replica", "cube", 3): {"picked": 0.005, "f5": 0.7300, "f10": None,
                             "p5": None, "r5": None, "lines": 183,
                             "curves": 64, "points": 4943},
    ("Replica", "cube", 7): {"picked": 0.005, "f5": 0.7631, "f10": None,
                             "p5": None, "r5": None, "lines": 173,
                             "curves": 62, "points": 4492},
    ("DTU", "cube", 7): {"picked": 0.005, "f5": 0.9286, "f10": 0.9979,
                         "p5": 0.8927, "r5": 0.9675, "lines": 107,
                         "curves": 41, "points": 3617},
    ("DTU", "cube", 99): {"picked": 0.005, "f5": 0.9335, "f10": 0.9950,
                          "p5": 0.9004, "r5": 0.9692, "lines": 82,
                          "curves": 46, "points": 3503},
    ("DTU", "cube", 3): {"picked": 0.005, "f5": 0.9426, "f10": 0.9961,
                         "p5": 0.9231, "r5": 0.9629, "lines": 89,
                         "curves": 43, "points": 3327},
    ("ABC", "rings", 42): {"picked": 0.02, "f5": 0.3845, "f10": 0.9028,
                           "p5": 0.3169, "r5": 0.4889, "lines": 58,
                           "curves": 31, "points": 3949},
    ("ABC", "cube", 42): {"picked": None, "f5": 0.9187, "f10": 0.990,
                          "p5": None, "r5": None, "lines": 29, "curves": 4,
                          "points": None},
}


def parse_job(text: str) -> tuple:
    conf, obj, seed = text.split(":")
    return conf, obj, int(seed)


def job_dir(root: str, job: tuple) -> str:
    conf, obj, seed = job
    return os.path.join(root, f"{conf}_{obj}_s{seed}")


def end_iter(conf: str) -> int:
    from emap_tpu_torch import config

    return config.parse_file(os.path.join(REPO, "confs", f"{conf}.conf")
                             ).get_int("train.end_iter")


def job_state(out: str, end: int) -> dict:
    """Where a job stands: the step its next part starts from (as the
    production script will resume it) and whether its report exists."""
    step = 0
    parts_file = os.path.join(out, "train_parts.json")
    if os.path.exists(parts_file):
        with open(parts_file) as f:
            parts = json.load(f)
        stopped = glob.glob(os.path.join(out, "exp", "*", "*", "checkpoints",
                                         "ckpt_stop.npz"))
        if parts and (stopped or parts[-1]["to"] >= end):
            step = int(parts[-1]["to"])
    return {"step": step, "end": end,
            "done": step >= end
            and os.path.exists(os.path.join(out, "report.json"))}


def plan_part(state: dict, budget: int | None) -> int | None:
    """The stop of a job's next part under a card's remaining step budget:
    0 to run to the end (extraction and score included), a step to stop
    at, or None when the budget leaves it no part."""
    if state["done"]:
        return None
    todo = state["end"] - state["step"]
    if budget is None or budget >= todo:
        return 0
    take = budget // STOP_EVERY * STOP_EVERY
    return state["step"] + take if take > 0 else None


def count_cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def run_card(card: int, jobs: list, root: str, steps: int | None,
             script: str, results: dict) -> None:
    budget = steps
    for job in jobs:
        out = job_dir(root, job)
        state = job_state(out, end_iter(job[0]))
        stop = plan_part(state, budget)
        row = results[job] = {"card": card, "from": state["step"],
                              "stop": stop, "state": "left"}
        if state["done"]:
            row["state"] = "done before"
            continue
        if stop is None:
            continue
        os.makedirs(out, exist_ok=True)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")  # card i of these
        device = visible.split(",")[card] if visible else str(card)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=device,
                   PROD_CONF=job[0], PROD_OBJ=job[1], PROD_SEED=str(job[2]),
                   PROD_OUT=os.path.abspath(out), PROD_STOP_AT=str(stop))
        with open(os.path.join(out, "run.log"), "a") as log:
            log.write(f"# torch_seed_suite part: card {card}, from "
                      f"{state['step']}, stop {stop or 'end'}\n")
            log.flush()
            rc = subprocess.run([sys.executable, script], env=env, stdout=log,
                                stderr=subprocess.STDOUT, cwd=REPO).returncode
        after = job_state(out, state["end"])
        row["to"] = after["step"]
        if rc != 0:
            row["state"] = f"failed (exit {rc}; see {out}/run.log)"
        elif stop == 0 and not after["done"]:
            row["state"] = f"failed (no report after its last part; {out})"
        elif stop and after["step"] != stop:
            row["state"] = f"failed (stopped at {after['step']}, not {stop})"
        else:
            row["state"] = "done" if after["done"] else "stopped"
            if budget is not None:
                budget -= after["step"] - state["step"]
            continue
        return  # the card's later jobs wait for the fault to be looked at


def run(args, script: str = PRODUCTION, n_cards: int | None = None) -> int:
    jobs = [parse_job(j) for j in args.jobs]
    if len(set(jobs)) != len(jobs):
        raise SystemExit(f"a job is listed twice: {args.jobs}")
    n = count_cards() if n_cards is None else n_cards
    if n < 1:
        print("torch_seed_suite run: no card is visible; the suite never "
              "runs on the CPU", file=sys.stderr)
        return 2
    queues = [jobs[i::n] for i in range(n)]
    results: dict = {}
    threads = [threading.Thread(target=run_card, args=(i, q, args.root,
                                                       args.steps, script,
                                                       results))
               for i, q in enumerate(queues) if q]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for job in jobs:  # a card that stopped on a fault never reached these
        results.setdefault(job, {"state": "not started (an earlier job on "
                                          "its card failed)"})
    summary = {":".join(map(str, j)): results[j] for j in jobs}
    print(json.dumps({"suite": summary}))
    bad = [k for k, v in summary.items()
           if v["state"].startswith(("failed", "not started"))]
    if bad:
        print(f"torch_seed_suite run: failed: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    return 0


ROW = re.compile(r"\biter (\d+) ((?:[\w/]+=\S+\s*)+)")


def log_rows(path: str) -> dict:
    """The training metrics rows of a log, by step: the JAX runner's
    `runner.py:420` rows and the port runner's, which share their keys. A
    step logged twice (a resumed part) keeps its last row."""
    rows = {}
    with open(path, errors="replace") as f:
        for line in f:
            for m in ROW.finditer(line):
                rows[int(m.group(1))] = {
                    k: float(v) for k, v in
                    (kv.split("=", 1) for kv in m.group(2).split())}
    return rows


def summary(report: dict, selection: dict | None) -> dict:
    score = report["score"]
    picked = selection["picked"] if selection else None
    points = None
    if selection:  # older tables mark no row: the picked threshold's
        rows = selection["candidates"]
        points = next((c["n_points"] for c in rows if c.get("picked")),
                      next((c["n_points"] for c in rows
                            if c["udf_threshold"] == picked), None))
    return {"picked": picked, "f5": score["fscore_0.005"],
            "f10": score["fscore_0.01"], "p5": score["precision_0.005"],
            "r5": score["recall_0.005"], "lines": score["n_lines"],
            "curves": score["n_curves"], "points": points}


PICKED = re.compile(r"auto_threshold picked (\S+) from")


def load_run(directory: str, log: str | None) -> dict:
    """A run's summary, selector table and training rows. A run that left
    no table of its selector (the JAX ABC runs of seeds 99, 3 and 1234)
    takes its pick from the runner's `picked ... from` line in its log."""
    with open(os.path.join(directory, "report.json")) as f:
        report = json.load(f)
    selection = report.get("threshold_selection")
    sel_file = os.path.join(directory, "threshold_selection.json")
    if not selection and os.path.exists(sel_file):
        with open(sel_file) as f:
            selection = json.load(f)
    has_log = bool(log) and os.path.exists(log)
    out = {"summary": summary(report, selection),
           "candidates": selection["candidates"] if selection else [],
           "rows": log_rows(log) if has_log else {}}
    if selection is None and has_log:
        with open(log, errors="replace") as f:
            picks = PICKED.findall(f.read())
        if picks:
            out["summary"]["picked"] = float(picks[-1])
    return out


def jax_run(conf: str, obj: str, seed: int) -> dict | None:
    if (conf, obj, seed) not in JAX_RUNS:
        return None
    directory, log = JAX_RUNS[(conf, obj, seed)]
    return load_run(os.path.join(REPO, directory), os.path.join(REPO, log))


def port_runs(root: str) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "*", "report.json"))):
        directory = os.path.dirname(path)
        m = re.fullmatch(r"(\w+?)_(\w+)_s(\d+)", os.path.basename(directory))
        if m:
            out[(m.group(1), m.group(2), int(m.group(3)))] = load_run(
                directory, os.path.join(directory, "run.log"))
    return out


def mean_sd(values: list) -> tuple:
    n = len(values)
    mean = sum(values) / n
    sd = (math.sqrt(sum((v - mean) ** 2 for v in values) / (n - 1))
          if n > 1 else float("nan"))
    return mean, sd


def welch(a: list, b: list) -> dict:
    """Welch's t of mean(a) - mean(b), its degrees of freedom and two-sided
    p (nan below two values a side)."""
    if len(a) < 2 or len(b) < 2:
        return {"t": float("nan"), "df": float("nan"), "p": float("nan")}
    (ma, sa), (mb, sb) = mean_sd(a), mean_sd(b)
    va, vb = sa * sa / len(a), sb * sb / len(b)
    t = (ma - mb) / math.sqrt(va + vb)
    df = (va + vb) ** 2 / (va * va / (len(a) - 1) + vb * vb / (len(b) - 1))
    from scipy import stats

    return {"t": t, "df": df, "p": float(2 * stats.t.sf(abs(t), df))}


def fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.5g}"
    return str(v)


def compare(root: str) -> dict:
    """Print the tables; return each (conf, obj)'s seeds, mean, band and
    t."""
    ports = port_runs(root)
    for key, recorded in PORT_RECORDED.items():
        ports.setdefault(key, {"summary": recorded, "candidates": [],
                               "rows": {}, "recorded": True})
    out: dict = {}
    pairs, same_pairs = [], []
    keys = ("picked", "f5", "f10", "p5", "r5", "lines", "curves", "points")
    for key in sorted(ports):
        conf, obj, seed = key
        port, jax = ports[key], jax_run(*key)
        pct = points_pct(port["summary"], jax["summary"]) if jax else None
        if pct is not None:
            pairs.append({"key": key, "pct": pct,
                          "p5": (port["summary"]["p5"], jax["summary"]["p5"])})
        same = (same_threshold(port["candidates"], jax["candidates"],
                               jax["summary"]["picked"]) if jax else None)
        if same is not None:
            same_pairs.append({"key": key, "pct": same["pct"]})
        prims = (primitives(port["summary"], jax["summary"]) if jax
                 else None)
        if prims is not None:
            out.setdefault("primitives", {})[":".join(map(str, key))] = prims
        print(f"\n== {conf} {obj} seed {seed} =="
              + (" (recorded)" if port.get("recorded") else "")
              + (f" points {pct:.1f}% of JAX's ({pct - 100:+.1f}%)"
                 if pct is not None else "")
              + (f" lines + curves {prims[0]} / {prims[1]} "
                 f"({prims[0] / prims[1]:.2f}x JAX's)"
                 if prims is not None else ""))
        print(f"{'':8}" + "".join(f"{k:>9}" for k in keys))
        print(f"{'port':8}" + "".join(f"{fmt(port['summary'][k]):>9}"
                                      for k in keys))
        if jax is None:
            print("JAX: no report of this seed's own pick in the repo "
                  "(no same-seed table)")
        else:
            print(f"{'JAX':8}" + "".join(f"{fmt(jax['summary'][k]):>9}"
                                         for k in keys))
            cols = ("udf_threshold", "n_points", "n_lines", "n_curves",
                    "precision3d", "f3d")
            if same is not None:
                print(f"at JAX's pick {same['threshold']:g}, mean of the fit "
                      f"draws: port {same['port']:.1f} points, JAX "
                      f"{same['jax']:.1f} ({same['pct']:.1f}%)")
            print("selector: " + " ".join(f"{c:>13}" for c in cols))
            for side, run_ in (("port", port), ("JAX", jax)):
                for c in run_["candidates"]:
                    print(f"{side:>9} " + " ".join(
                        f"{fmt(c.get(k)):>13}" for k in cols)
                        + ("  picked" if c.get("picked") else ""))
            print("training: step side " + " ".join(f"{m:>8}"
                                                   for m in METRICS))
            for step in STEPS:
                for side, run_ in (("port", port), ("JAX", jax)):
                    row = run_["rows"].get(step)
                    if row:
                        print(f"{step:>14} {side:>4} " + " ".join(
                            f"{fmt(row.get(m)):>8}" for m in METRICS))
    for (conf, obj), band in JAX_BAND.items():
        mine = [ports[k]["summary"]["f5"] for k in sorted(ports)
                if k[:2] == (conf, obj)]
        if not mine:
            continue
        jmean, jsd = mean_sd(list(band.values()))
        pmean, psd = mean_sd(mine)
        res = {"port_seeds": [k[2] for k in sorted(ports)
                              if k[:2] == (conf, obj)],
               "port_f5": mine, "port_mean": pmean, "port_sd": psd,
               "jax_mean": jmean, "jax_sd": jsd, "bar": jmean - 2 * jsd,
               "met": pmean >= jmean - 2 * jsd,
               "welch": welch(mine, list(band.values()))}
        out[(conf, obj)] = res
        print(f"\n{conf} {obj}: port F@5mm {pmean:.4f} ± {psd:.4f} over seeds "
              f"{res['port_seeds']} ({', '.join(f'{v:.4f}' for v in mine)}); "
              f"JAX {jmean:.4f} ± {jsd:.4f} (n={len(band)}); bar "
              f"{res['bar']:.4f}: {'met' if res['met'] else 'NOT met'}; "
              f"Welch t {res['welch']['t']:.3f}, df {res['welch']['df']:.2f}, "
              f"p {res['welch']['p']:.3g}")
    if same_pairs:
        row = out["pooled_same_threshold"] = pooled(same_pairs)
        print(f"\npooled points at JAX's pick, mean of the fit draws, over "
              f"{row['n']} pairs with both tables: {row['above']} above "
              f"JAX's; excess mean {row['mean_excess']:+.1f}%, median "
              f"{row['median_excess']:+.1f}%; one-sided sign test p = "
              f"{row['sign_p'][0]}/{row['sign_p'][1]}")
    if pairs:
        row = out["pooled"] = pooled(pairs)
        print(f"\npooled points over {row['n']} pairs: {row['above']} above "
              f"JAX's; excess mean {row['mean_excess']:+.1f}%, median "
              f"{row['median_excess']:+.1f}%; of {row['above_with_p5']} above"
              f" with P@5mm on both sides, {row['above_lower_p5']} with the "
              f"lower P@5mm; one-sided sign test p = {row['sign_p'][0]}/"
              f"{row['sign_p'][1]} ≈ {row['sign_p'][0] / row['sign_p'][1]:.3g}"
              f" over {row['sign_n']} untied pairs")
    return out


def points_pct(port: dict, jax: dict) -> float | None:
    """The port's primitive points as a percentage of the JAX run's."""
    if port["points"] is None or not jax["points"]:
        return None
    return 100.0 * port["points"] / jax["points"]


def same_threshold(port_rows: list, jax_rows: list,
                   threshold: float | None) -> dict | None:
    """Both selector tables at the JAX run's picked threshold: each side's
    points as the mean over its fit draws there, and the port's as a
    percentage of JAX's. A pick that differs moves the points at the pick
    (a higher threshold keeps more voxels); this holds the threshold."""
    def mean_points(rows):
        vals = [r["n_points"] for r in rows
                if r["udf_threshold"] == threshold]
        return statistics.fmean(vals) if vals else None

    if threshold is None:
        return None
    port, jax = mean_points(port_rows), mean_points(jax_rows)
    if port is None or not jax:
        return None
    return {"threshold": threshold, "port": port, "jax": jax,
            "pct": 100.0 * port / jax}


def primitives(port: dict, jax: dict) -> tuple | None:
    """The port's and the JAX run's lines + curves, where both are known."""
    if None in (port["lines"], port["curves"], jax["lines"], jax["curves"]):
        return None
    return port["lines"] + port["curves"], jax["lines"] + jax["curves"]


def sign_test(above: int, n: int) -> tuple:
    """The exact one-sided sign test: the chance of `above` or more of `n`
    pairs above JAX were each pair a fair coin, as (numerator, 2**n)."""
    return sum(math.comb(n, k) for k in range(above, n + 1)), 2 ** n


def pooled(pairs: list) -> dict:
    """Over every pair with points on both sides: how many run above JAX,
    the mean and median excess (%), of those above JAX whose P@5mm is known
    on both sides how many have the lower one, and the sign test's p over
    the pairs not tied with JAX."""
    excess = [p["pct"] - 100.0 for p in pairs]
    above = [p for p in pairs if p["pct"] > 100.0]
    known = [p for p in above if None not in p.get("p5", (None,))]
    untied = sum(p["pct"] != 100.0 for p in pairs)
    return {"pct": {":".join(map(str, p["key"])): p["pct"] for p in pairs},
            "n": len(excess), "above": len(above),
            "mean_excess": statistics.fmean(excess),
            "median_excess": statistics.median(excess),
            "above_with_p5": len(known),
            "above_lower_p5": sum(p["p5"][0] < p["p5"][1] for p in known),
            "sign_n": untied, "sign_p": sign_test(len(above), untied)}


def main(argv=None, script: str = PRODUCTION,
         n_cards: int | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="train and score jobs, one card each")
    r.add_argument("--root", required=True)
    r.add_argument("--steps", type=int, default=None,
                   help="training steps a card may take in this call")
    r.add_argument("jobs", nargs="+", help="conf:obj:seed")
    c = sub.add_parser("compare", help="the port's runs beside JAX's")
    c.add_argument("--root", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "run":
        return run(args, script, n_cards)
    compare(args.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
