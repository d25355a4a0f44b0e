"""scripts/torch_sharded_extract.py on the CPU: a toy run's `--mode
extract_edge` at world 1 and on two gloo ranks, its result files and stage
arrays byte for byte, and a difference named at the stage it shows in.
Ranks run in spawned processes, which import this module."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_sharded_extract as sharded  # noqa: E402
from emap_tpu_torch import config  # noqa: E402
from emap_tpu_torch.ckpt import convert, native  # noqa: E402
from emap_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from emap_tpu_torch.fields import udf as tudf  # noqa: E402
from emap_tpu_torch.train.runner import Runner  # noqa: E402

NET = dict(d_hidden=64, n_layers=4, skip_in=(2,), multires=4)


def _circle_params():
    """NET regressed onto the UDF of a circle of radius 0.5 in z = 0 (300
    Adam steps from a seed)."""
    cfg = tudf.UDFConfig(**NET)
    p = tudf.init_udf_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    leaves = [t.requires_grad_(True) for layer in p.values()
              for t in layer.values()]
    opt = torch.optim.Adam(leaves, lr=2e-3)
    gen = torch.Generator().manual_seed(1)
    for _ in range(300):
        pts = torch.rand(512, 3, generator=gen) * 2.0 - 1.0
        r = torch.linalg.norm(pts[:, :2], dim=-1)
        target = torch.sqrt((r - 0.5) ** 2 + pts[:, 2] ** 2)
        loss = torch.mean((tudf.udf_value(p, pts, cfg) - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
    return {k: {n: t.detach() for n, t in layer.items()}
            for k, layer in p.items()}


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A finished run in scripts/torch_run_production.py's layout: the ABC
    conf at toy size (a 32^3 grid, a two-threshold menu, one fit draw) on
    a 32x32, 3-view cube, and the circle field as its checkpoint (an .npz
    beside the conf's `ckpt_best.pth`, which the runner falls back to)."""
    root = str(tmp_path_factory.mktemp("run"))
    make_synthetic_scene(os.path.join(root, "data"), scan="cube000",
                         n_views=3, H=32, W=32)
    conf = config.parse_file(os.path.join(REPO, "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = os.path.join(root, "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = os.path.join(root, "data")
    conf["dataset.scan"] = "cube000"
    conf["train.batch_size"] = 16
    for k, v in NET.items():
        conf[f"model.udf_network.{k}"] = list(v) if k == "skip_in" else v
    for k, v in {"resolution": 32, "sampling_N": 8, "fit_draws": 1,
                 "auto_threshold": [0.08, 0.1]}.items():
        conf[f"edge_extraction.{k}"] = v
    path = os.path.join(root, "ABC_standin.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    trainer = Runner(config.parse_file(path), "train", device="cpu")
    trainer.state.params["udf"] = _circle_params()
    native.save_pytree(os.path.join(trainer._ckpt_dir(), "ckpt_best.npz"),
                       convert.checkpoint_payload(trainer.state, 0.1))
    return root


@pytest.fixture(scope="module")
def worlds(run_dir, tmp_path_factory):
    """Worlds 1 and 2 with their stage arrays; the exit code and output."""
    out = str(tmp_path_factory.mktemp("sharded"))
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = sharded.main([run_dir, "--worlds", "1,2", "--out", out,
                           "--device", "cpu", "--stages"])
    return out, rc, text.getvalue()


def test_two_ranks_extract_like_one(worlds):
    """Exit 0: world 2's four result files and every stage array equal
    world 1's; each world reports its stages and its ranks."""
    out, rc, text = worlds
    assert rc == 0, text
    assert "world 2: byte-identical to world 1" in text
    assert "world 2 rank 1: launches" in text
    results = [os.path.join(out, f"world{w}", "exp", "cube000", "emap",
                            "results") for w in (1, 2)]
    names = sorted(os.listdir(results[0]))
    assert names == sorted(sharded.RESULT_FILES)
    for name in names:
        with open(os.path.join(results[0], name), "rb") as a, \
                open(os.path.join(results[1], name), "rb") as b:
            assert a.read() == b.read()
    stages = np.load(os.path.join(out, "world2", "stages.npz"))
    assert {k.split("@")[0] for k in stages.files} == set(
        sharded.STAGE_ARRAYS)
    assert 0 < len(stages["xyz@0.08"]) < len(stages["xyz@0.1"])


def _altered(fn, world2_file, alter):
    """`fn` (extract_world or dump_stages), then `alter` on world 2's
    `world2_file` once world 2 has written it."""
    def wrapped(conf_path, world, *args):
        out = fn(conf_path, world, *args)
        if world == 2:
            alter(os.path.join(os.path.dirname(conf_path), world2_file))
        return out
    return wrapped


def _append_space(path):
    with open(path, "a") as f:
        f.write(" ")


def _drop_last_voxel(path):
    arrays = dict(np.load(path))
    arrays["cand_idx@0.1"] = arrays["cand_idx@0.1"][:-1]
    np.savez(path, **arrays)


@pytest.mark.parametrize("step,world2_file,alter,stage", [
    ("extract_world", "exp/cube000/emap/results/parametric_edges.json",
     _append_space, "the fit (parametric_edges.json)"),
    ("dump_stages", "stages.npz", _drop_last_voxel,
     "grid masks at threshold 0.1"),
])
def test_an_altered_world_fails_at_its_stage(run_dir, tmp_path, capsys,
                                             monkeypatch, step, world2_file,
                                             alter, stage):
    """World 2's fit (or its grid mask at 0.1) altered after world 2
    wrote it: the script exits 1 and names that stage as the first that
    differs."""
    monkeypatch.setattr(sharded, step, _altered(getattr(sharded, step),
                                                world2_file, alter))
    rc = sharded.main([run_dir, "--worlds", "1,2", "--out",
                       str(tmp_path / "out"), "--device", "cpu", "--stages"])
    text = capsys.readouterr().out
    assert rc == 1
    assert f"world 2: DIFFERS from world 1; first differing stage: {stage}" \
        in text
