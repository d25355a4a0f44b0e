"""scripts/torch_seed_suite.py on the CPU: `compare` on the JAX package's own
Replica runs, the log parser, and `run`'s planner with a stub in place of
scripts/torch_run_production.py (no training)."""

import json
import os
import sys
import textwrap

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_seed_suite as suite  # noqa: E402

# RESULTS.md:22, the JAX band's Replica seeds
RESULTS_REPLICA = {7: 0.7164, 99: 0.6692, 3: 0.7506, 1234: 0.6816}


@pytest.mark.parametrize("seed", sorted(RESULTS_REPLICA))
def test_compare_reads_the_jax_replica_runs(seed):
    run = suite.jax_run("Replica", "cube", seed)
    assert run["summary"]["f5"] == RESULTS_REPLICA[seed]
    assert run["summary"]["picked"] == 0.005
    assert run["summary"]["points"] > 4000
    assert len(run["candidates"]) == 6
    assert set(suite.STEPS) <= set(run["rows"])


def test_compare_band_and_seed_42(tmp_path, capsys):
    out = suite.compare(str(tmp_path))
    rep = out["Replica"]
    assert round(rep["jax_mean"], 4) == 0.7061
    assert round(rep["jax_sd"], 4) == 0.0320
    assert round(rep["bar"], 4) == 0.6421
    assert rep["port_seeds"] == [42] and rep["port_f5"] == [0.6346]
    assert "no same-seed table" in capsys.readouterr().out


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
