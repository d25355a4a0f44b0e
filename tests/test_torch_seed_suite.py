"""scripts/torch_seed_suite.py on the CPU: `compare` on the JAX package's own
Replica, ABC cube and ABC rings runs, the log parser, and `run`'s planner
with a stub in place of scripts/torch_run_production.py (no training)."""

import json
import os
import statistics
import sys
import textwrap

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_seed_suite as suite  # noqa: E402

# RESULTS.md:22, the JAX band's Replica seeds
RESULTS_REPLICA = {7: 0.7164, 99: 0.6692, 3: 0.7506, 1234: 0.6816}
# RESULTS.md:19-20, the JAX ABC runs of seeds 42/7/99/3/1234: F@5mm, the
# picked threshold, lines and curves (report.json; a pick from the log
# where the run left no selector table)
RESULTS_ABC = {
    ("cube", 42): (0.8149, 0.02, 21, 6), ("cube", 7): (0.8715, 0.03, 25, 3),
    ("cube", 99): (0.9548, 0.02, 23, 6), ("cube", 3): (0.9222, 0.02, 29, 7),
    ("cube", 1234): (0.8449, 0.02, 31, 7),
    ("rings", 42): (0.4122, 0.02, 62, 30),
    ("rings", 7): (0.3958, 0.02, 50, 35),
    ("rings", 99): (0.3131, 0.02, 72, 35),
    ("rings", 3): (0.3733, 0.02, 55, 37),
    ("rings", 1234): (0.4264, 0.02, 57, 39),
}


@pytest.mark.parametrize("seed", sorted(RESULTS_REPLICA))
def test_compare_reads_the_jax_replica_runs(seed):
    run = suite.jax_run("Replica", "cube", seed)
    assert run["summary"]["f5"] == RESULTS_REPLICA[seed]
    assert run["summary"]["picked"] == 0.005
    assert run["summary"]["points"] > 4000
    assert len(run["candidates"]) == 6
    assert set(suite.STEPS) <= set(run["rows"])


@pytest.mark.parametrize("obj,seed", sorted(RESULTS_ABC))
def test_compare_reads_the_jax_abc_runs(obj, seed):
    """The ABC cube's runs of prod_suite_r4/final_s* and the rings' of
    prod_rings_r5/s*: score, pick and counts, the selector's 4 thresholds x
    4 fit draws where the run wrote them, the training rows to 50,000."""
    run = suite.jax_run("ABC", obj, seed)
    f5, picked, lines, curves = RESULTS_ABC[(obj, seed)]
    got = run["summary"]
    assert (got["f5"], got["picked"], got["lines"], got["curves"]) == (
        f5, picked, lines, curves)
    assert len(run["candidates"]) in ((0,) if got["points"] is None
                                      else (16,))
    assert {1000, 10000, 50000} <= set(run["rows"])
    assert run["rows"][50000]["udf_min"] > 0


def _port_report(root, name, f5):
    os.makedirs(root / name)
    (root / name / "report.json").write_text(json.dumps({"score": {
        "fscore_0.005": f5, "fscore_0.01": 0.99, "precision_0.005": 0.9,
        "recall_0.005": 0.9, "n_lines": 20, "n_curves": 5}}))


def test_compare_keeps_the_rings_apart_from_the_cube(tmp_path, capsys):
    """Port runs of the ABC cube and the rings are held against their own
    bands (RESULTS.md:19-20: 0.8718 ± 0.0684, bar 0.735; 0.384 ± 0.044,
    bar 0.296), each beside its same-seed JAX run."""
    _port_report(tmp_path, "ABC_cube_s7", 0.90)
    _port_report(tmp_path, "ABC_rings_s42", 0.40)
    _port_report(tmp_path, "ABC_rings_s7", 0.36)
    out = suite.compare(str(tmp_path))
    cube, rings = out[("ABC", "cube")], out[("ABC", "rings")]
    assert (round(cube["jax_mean"], 4), round(cube["jax_sd"], 4),
            round(cube["bar"], 3)) == (0.8718, 0.0684, 0.735)
    assert cube["port_seeds"] == [7, 42] and cube["met"]  # 42 recorded
    assert cube["port_f5"] == [0.90, 0.9187]
    assert (round(rings["jax_mean"], 3), round(rings["jax_sd"], 3),
            round(rings["bar"], 3)) == (0.384, 0.044, 0.295)
    assert rings["port_seeds"] == [7, 42] and rings["port_f5"] == [0.36, 0.40]
    text = capsys.readouterr().out
    assert "== ABC rings seed 42 ==" in text and "ABC rings: port" in text
    assert "ABC cube: port" in text


def test_compare_band_and_seed_42(tmp_path, capsys):
    """With nothing under the root the Replica band holds the port's
    recorded seeds 42/3/7 (PR 19's gate: 0.7092 ± 0.0667)."""
    out = suite.compare(str(tmp_path))
    rep = out[("Replica", "cube")]
    assert round(rep["jax_mean"], 4) == 0.7061
    assert round(rep["jax_sd"], 4) == 0.0320
    assert round(rep["bar"], 4) == 0.6421
    assert rep["port_seeds"] == [3, 7, 42]
    assert rep["port_f5"] == [0.7300, 0.7631, 0.6346]
    assert (round(rep["port_mean"], 4), round(rep["port_sd"], 4)) == (
        0.7092, 0.0667)
    assert "no same-seed table" in capsys.readouterr().out


# The JAX DTU runs' primitive points at their pick, 0.005
# (e2e_dtu200k_s7/report.json's threshold_selection,
# r5_200k/dtu_s{99,3}/threshold_selection.json) and P@5mm (report.json)
JAX_DTU = {7: (3171, 0.918), 99: (3486, 0.8923), 3: (3246, 0.8921)}


def _port_run(root, name, f5, points, p5):
    """A port report with a one-row selector table at the pick 0.005."""
    os.makedirs(root / name)
    (root / name / "report.json").write_text(json.dumps({
        "score": {"fscore_0.005": f5, "fscore_0.01": 0.99,
                  "precision_0.005": p5, "recall_0.005": 0.96,
                  "n_lines": 100, "n_curves": 40},
        "threshold_selection": {"picked": 0.005, "candidates": [
            {"udf_threshold": 0.005, "n_points": points, "picked": True}]}}))


@pytest.mark.parametrize("seed", sorted(JAX_DTU))
def test_compare_reads_the_jax_dtu_points(seed):
    got = suite.jax_run("DTU", "cube", seed)["summary"]
    assert (got["points"], got["p5"]) == JAX_DTU[seed]
    assert got["picked"] == 0.005


# The JAX DTU runs' lines + curves (report.json)
JAX_DTU_PRIMITIVES = {7: 131, 99: 143, 3: 124}


@pytest.mark.parametrize("seed,points", [(99, 4009), (3, 3246), (99, 3137)])
def test_compare_prints_points_as_a_percentage_of_jax(tmp_path, capsys,
                                                      seed, points):
    """Each pair's header: the port's points as a percentage of JAX's and
    its lines + curves (here 100 + 40) beside JAX's, with their ratio."""
    _port_run(tmp_path, f"DTU_cube_s{seed}", 0.92, points, 0.9)
    out = suite.compare(str(tmp_path))
    pct = 100.0 * points / JAX_DTU[seed][0]
    assert out["pooled"]["pct"][f"DTU:cube:{seed}"] == pytest.approx(pct)
    jax_prims = JAX_DTU_PRIMITIVES[seed]
    assert out["primitives"][f"DTU:cube:{seed}"] == (140, jax_prims)
    text = capsys.readouterr().out
    assert (f"== DTU cube seed {seed} == points {pct:.1f}% of JAX's "
            f"({pct - 100:+.1f}%) lines + curves 140 / {jax_prims} "
            f"({140 / jax_prims:.2f}x JAX's)") in text


def test_compare_pools_the_recorded_pairs_on_an_empty_root(tmp_path, capsys):
    """Every recorded pair enters without its run directory: DTU 7/99/3,
    rings 42 and Replica 3/7 pool (5 above JAX, sign test p = 7/64), and
    the ABC cube's gate row holds its recorded seed 42 (no points)."""
    out = suite.compare(str(tmp_path))
    pool = out["pooled"]
    assert sorted(pool["pct"]) == ["ABC:rings:42", "DTU:cube:3", "DTU:cube:7",
                                   "DTU:cube:99", "Replica:cube:3",
                                   "Replica:cube:7"]
    assert (pool["n"], pool["above"], pool["sign_n"]) == (6, 5, 6)
    assert pool["sign_p"] == (7, 64)
    assert pool["mean_excess"] == pytest.approx(5.0, abs=0.05)
    cube = out[("ABC", "cube")]
    assert (cube["port_seeds"], cube["port_f5"]) == ([42], [0.9187])
    dtu = out[("DTU", "cube")]
    assert (round(dtu["port_mean"], 4), round(dtu["port_sd"], 4)) == (
        0.9349, 0.0071)
    assert out["primitives"]["ABC:cube:42"] == (33, 27)
    assert "Replica:cube:42" not in out["primitives"]  # no JAX run
    text = capsys.readouterr().out
    assert ("== ABC cube seed 42 == (recorded) lines + curves 33 / 27 "
            "(1.22x JAX's)") in text
    assert "== Replica cube seed 42 == (recorded)\n" in text
    assert ("pooled points over 6 pairs: 5 above JAX's" in text
            and "one-sided sign test p = 7/64 ≈ 0.109 over 6 untied pairs"
            in text)


@pytest.mark.parametrize("above,n,p", [
    (5, 6, (7, 64)), (9, 11, (67, 2048)), (8, 11, (232, 2048)),
    (0, 3, (8, 8)), (3, 3, (1, 8))])
def test_sign_test_is_the_exact_binomial_tail(above, n, p):
    assert suite.sign_test(above, n) == p


def test_compare_prints_primitives_where_jax_has_no_points(tmp_path,
                                                           capsys):
    """The JAX cube run of seed 99 left no selector table: its pair has
    lines + curves (23 + 6) but no points, and enters no pooled row."""
    _port_report(tmp_path, "ABC_cube_s99", 0.93)  # 20 lines + 5 curves
    out = suite.compare(str(tmp_path))
    assert out["primitives"]["ABC:cube:99"] == (25, 29)
    assert "ABC:cube:99" not in out["pooled"]["pct"]
    text = capsys.readouterr().out
    assert "== ABC cube seed 99 == lines + curves 25 / 29 (0.86x JAX's)" in text


def test_compare_pools_recorded_and_rooted_pairs(tmp_path, capsys):
    """The pooled row over the recorded pairs (DTU 7 +14.1%, rings 42
    +10.0%, Replica 3 +7.6%, Replica 7 -4.8%) and two rooted DTU seeds; the
    DTU band over 7 (recorded), 99 and 3."""
    _port_run(tmp_path, "DTU_cube_s99", 0.93, 3835, 0.88)  # +10.0%, lower P
    _port_run(tmp_path, "DTU_cube_s3", 0.91, 3084, 0.90)   # -5.0%
    out = suite.compare(str(tmp_path))
    pool = out["pooled"]
    want = {"ABC:rings:42": 3949 / 3589, "DTU:cube:7": 3617 / 3171,
            "DTU:cube:99": 3835 / 3486, "DTU:cube:3": 3084 / 3246,
            "Replica:cube:3": 4943 / 4596, "Replica:cube:7": 4492 / 4720}
    assert pool["pct"] == pytest.approx({k: 100 * v for k, v in want.items()})
    excess = sorted(100 * v - 100 for v in want.values())
    assert (pool["n"], pool["above"]) == (6, 4)
    assert pool["mean_excess"] == pytest.approx(sum(excess) / 6)
    assert pool["median_excess"] == pytest.approx((excess[2] + excess[3]) / 2)
    # above JAX: rings 42, DTU 7 and 99 with P@5mm on both sides, each
    # lower; Replica 3 has no recorded P@5mm
    assert (pool["above_with_p5"], pool["above_lower_p5"]) == (3, 3)
    dtu = out[("DTU", "cube")]
    assert dtu["port_seeds"] == [3, 7, 99]
    assert dtu["port_f5"] == [0.91, 0.9286, 0.93]
    text = capsys.readouterr().out
    assert "== DTU cube seed 7 == (recorded) points 114.1%" in text
    assert "pooled points over 6 pairs: 4 above JAX's" in text


def test_compare_a_rooted_run_replaces_the_recorded_one(tmp_path, capsys):
    _port_run(tmp_path, "DTU_cube_s7", 0.95, 3171, 0.93)
    out = suite.compare(str(tmp_path))
    # seeds 3, 7 (rooted), 99: the rooted 7 in place of its recorded row
    assert out[("DTU", "cube")]["port_f5"] == [0.9426, 0.95, 0.9335]
    assert out["pooled"]["pct"]["DTU:cube:7"] == pytest.approx(100.0)
    # rings 42, Replica 3, DTU 99 and 3 (recorded); DTU 7 ties, so the
    # sign test leaves it out: 4 of 5 above, p = 6/32
    assert out["pooled"]["above"] == 4
    assert out["pooled"]["above_lower_p5"] == 1  # rings 42
    assert (out["pooled"]["sign_n"], out["pooled"]["sign_p"]) == (5, (6, 32))
    text = capsys.readouterr().out
    assert "== DTU cube seed 7 == points 100.0% of JAX's (+0.0%)" in text
    assert "DTU cube seed 7 == (recorded)" not in text


def test_log_parser_reads_the_jax_runner_rows():
    rows = suite.log_rows(os.path.join(REPO, "r5_200k", "replica_s3.log"))
    assert rows[41000]["s_val"] == 0.00349
    assert rows[41000]["udf_min"] == 0.02656
    assert len(rows) == 200


STUB = textwrap.dedent("""
    import json, os, sys, time
    out = os.environ["PROD_OUT"]
    stop = int(os.environ["PROD_STOP_AT"])
    end = 200000
    ckpt = os.path.join(out, "exp", "room0", "emap", "checkpoints")
    stop_file = os.path.join(ckpt, "ckpt_stop.npz")
    parts_file = os.path.join(out, "train_parts.json")
    parts = json.load(open(parts_file)) if os.path.exists(parts_file) else []
    start = parts[-1]["to"] if os.path.exists(stop_file) else 0
    t0 = time.time()
    time.sleep(0.3)
    to = stop if start < stop < end else end
    print(f"[runner.py:357] iter {to} loss=0.0041 s_val=0.00200 "
          f"udf_min=0.02097 ms/step=20.4 rays/s=50000")
    with open(os.path.join(out, "calls.jsonl"), "a") as f:
        f.write(json.dumps({"card": os.environ["CUDA_VISIBLE_DEVICES"],
                            "from": start, "to": to, "t0": t0,
                            "t1": time.time()}) + "\\n")
    if to > start:
        parts.append({"from": start, "to": to})
        json.dump(parts, open(parts_file, "w"))
    os.makedirs(ckpt, exist_ok=True)
    if to < end:
        open(stop_file, "w").close()
        sys.exit(0)
    if os.path.exists(stop_file):
        os.remove(stop_file)
    if os.environ["PROD_SEED"] != "13":
        json.dump({"score": {}}, open(os.path.join(out, "report.json"), "w"))
""")


@pytest.fixture(autouse=True)
def _all_cards_visible(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)


def _suite(tmp_path, *args, n_cards=2):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    return suite.main(["run", "--root", str(tmp_path / "runs"), *args],
                      script=str(stub), n_cards=n_cards)


def _calls(tmp_path):
    calls = []
    for job in os.listdir(tmp_path / "runs"):
        path = tmp_path / "runs" / job / "calls.jsonl"
        calls += [dict(json.loads(line), job=job)
                  for line in path.read_text().splitlines()]
    return calls


def test_run_puts_one_job_on_a_card_and_resumes(tmp_path, capsys):
    jobs = ["Replica:cube:3", "Replica:cube:7", "Replica:cube:99"]
    for _ in range(4):  # the same command line every call
        assert _suite(tmp_path, "--steps", "150000", *jobs) == 0
    calls = _calls(tmp_path)
    for card in {c["card"] for c in calls}:
        spans = sorted((c["t0"], c["t1"]) for c in calls if c["card"] == card)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert {c["card"] for c in calls} == {"0", "1"}
    by_job = {j: [(c["from"], c["to"]) for c in calls if c["job"] == j]
              for j in {c["job"] for c in calls}}
    # seeds 3 and 99 share card 0 at 150,000 steps a call; 7 has card 1
    assert by_job["Replica_cube_s3"] == [(0, 150000), (150000, 200000)]
    assert by_job["Replica_cube_s99"] == [(0, 100000), (100000, 200000)]
    assert by_job["Replica_cube_s7"] == [(0, 150000), (150000, 200000)]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {v["state"] for v in last["suite"].values()} == {"done before"}
    log = (tmp_path / "runs" / "Replica_cube_s99" / "run.log").read_text()
    assert suite.log_rows(str(tmp_path / "runs" / "Replica_cube_s99"
                              / "run.log"))[200000]["s_val"] == 0.002
    assert log.count("torch_seed_suite part") == 2


def test_run_fails_on_a_missing_report_and_without_a_card(tmp_path, capsys):
    assert _suite(tmp_path, "Replica:cube:13", "Replica:cube:3") == 1
    state = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert state["suite"]["Replica:cube:13"]["state"].startswith(
        "failed (no report")
    assert state["suite"]["Replica:cube:3"]["state"] == "done"
    assert _suite(tmp_path, "Replica:cube:3", n_cards=0) == 2


def _port_table(root, name, rows):
    """A port report whose selector table has the given (threshold, points)
    rows, one a fit draw, the first picked."""
    os.makedirs(root / name)
    cands = [{"udf_threshold": t, "n_points": n} for t, n in rows]
    cands[0]["picked"] = True
    (root / name / "report.json").write_text(json.dumps({
        "score": {"fscore_0.005": 0.4, "fscore_0.01": 0.9,
                  "precision_0.005": 0.3, "recall_0.005": 0.5,
                  "n_lines": 60, "n_curves": 30},
        "threshold_selection": {"picked": rows[0][0], "candidates": cands}}))


# JAX's pick and its fit draws' mean points there: rings seed 7 at 0.02
# (3839, 3895, 3836, 4185) and the cube's seed 7 at 0.03 (3404, 3313,
# 3119, 3416); the cube's seed 99 left no table
@pytest.mark.parametrize("obj,seed,rows,jax_mean", [
    ("rings", 7, [(0.03, 4400), (0.02, 3500), (0.02, 3700)], 3938.75),
    ("cube", 7, [(0.03, 3500), (0.03, 3600), (0.04, 5000)], 3313.0),
    ("cube", 99, [(0.02, 3000)], None)])
def test_compare_holds_points_at_the_jax_pick(tmp_path, capsys, obj, seed,
                                              rows, jax_mean):
    """Points at JAX's picked threshold, each side the mean over its fit
    draws there, so that a pick that differs does not count as an excess
    of points; pooled in a row of their own."""
    _port_table(tmp_path, f"ABC_{obj}_s{seed}", rows)
    out = suite.compare(str(tmp_path))
    text = capsys.readouterr().out
    if jax_mean is None:
        assert "pooled_same_threshold" not in out
        assert "at JAX's pick" not in text
        return
    thr = suite.jax_run("ABC", obj, seed)["summary"]["picked"]
    port = statistics.fmean(n for t, n in rows if t == thr)
    pct = 100.0 * port / jax_mean
    row = out["pooled_same_threshold"]
    assert row["pct"] == pytest.approx({f"ABC:{obj}:{seed}": pct})
    assert (row["n"], row["above"]) == (1, int(pct > 100))
    assert (f"at JAX's pick {thr:g}, mean of the fit draws: port "
            f"{port:.1f} points, JAX {jax_mean:.1f} ({pct:.1f}%)") in text
    assert "pooled points at JAX's pick, mean of the fit draws, over 1 " in text
