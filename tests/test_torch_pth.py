"""The port's `.pth` import (emap_tpu_torch/ckpt/pth_import.py) and the
runner's `.pth` load against the JAX package's importer on the CPU: the
released-format fixture dtu_control/ref_final.pth and reference-style
checkpoints built from torch modules."""

import os
import pickle

import numpy as np
import pytest
import torch

from emap_tpu.ckpt import pth_import as jpth
from emap_tpu_torch import config
from emap_tpu_torch.ckpt import native as tnative
from emap_tpu_torch.ckpt import pth_import as tpth
from emap_tpu_torch.ckpt.convert import params_from_numpy, params_to_numpy
from emap_tpu_torch.data import make_synthetic_scene
from emap_tpu_torch.fields.udf import UDFConfig
from emap_tpu_torch.train.optim import tree_leaves
from emap_tpu_torch.train.runner import Runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "dtu_control", "ref_final.pth")
# the fixture's net: 4 weight-norm layers of 64, skip into layer 2, PE 6
FIXTURE_NET = dict(d_hidden=64, n_layers=4, skip_in=[2], multires=6)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_fixture_import_equals_jax_package():
    """params, Adam mu/nu/count and iter_step of ref_final.pth: exactly the
    JAX package's import, also after the port's weight converter."""
    got = tpth.import_reference_checkpoint(FIXTURE)
    want = jpth.import_reference_checkpoint(FIXTURE)
    assert got["iter_step"] == want["iter_step"] == 8000
    assert_trees_equal(got["params"], want["params"])
    for k in ("mu", "nu", "count"):
        assert_trees_equal(got["opt"][k], want["opt"][k])
    ucfg = UDFConfig(**FIXTURE_NET)
    on_port = params_from_numpy(got["params"], ucfg, "cpu")
    assert_trees_equal(params_to_numpy(on_port), want["params"])


def test_fixture_needs_the_numpy_globals():
    """The fixture loads weights-only with numpy's scalar types allowed by
    name; without them torch's weights-only unpickler refuses it."""
    with pytest.raises(pickle.UnpicklingError):
        torch.load(FIXTURE, map_location="cpu", weights_only=True)
    assert set(tpth.load_raw(FIXTURE)) == {
        "udf_network_fine", "variance_network_fine", "beta_network",
        "optimizer", "iter_step"}


def test_pickled_code_is_refused(tmp_path):
    """weights_only stays on: a checkpoint that pickles a callable is not
    executed."""
    path = str(tmp_path / "evil.pth")
    torch.save({"iter_step": 1, "hook": os.getcwd}, path)
    with pytest.raises(pickle.UnpicklingError):
        tpth.load_raw(path)


@pytest.mark.parametrize("naming", ["parametrizations", "weight_g", "plain"])
def test_reference_style_checkpoint(tmp_path, naming):
    """A checkpoint in the reference's save format from torch modules (the
    three weight namings, a stepped Adam): equal to the JAX import."""
    torch.manual_seed(0)
    lins = [torch.nn.Linear(5, 4), torch.nn.Linear(4, 1)]
    if naming == "parametrizations":
        lins = [torch.nn.utils.parametrizations.weight_norm(m) for m in lins]
    udf = torch.nn.ModuleDict({f"lin{i}": m for i, m in enumerate(lins)})
    var = torch.nn.ParameterDict({
        "variance": torch.nn.Parameter(torch.tensor([0.3])),
        "second_variance": torch.nn.Parameter(torch.tensor([0.2]))})
    beta = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.tensor([v]))
        for k, v in (("beta", 0.5), ("gamma", 0.3), ("zeta", 0.1))})
    opt = torch.optim.Adam([{"params": udf.parameters()},
                            {"params": list(var.parameters())
                             + list(beta.parameters())[:2]}], lr=1e-2)
    for _ in range(3):
        opt.zero_grad()
        x = torch.randn(8, 5)
        loss = (lins[1](torch.relu(lins[0](x))) ** 2).mean() + sum(
            (p ** 2).sum() for p in list(var.parameters())
            + list(beta.parameters()))
        loss.backward()
        opt.step()
    udf_sd, opt_sd = udf.state_dict(), opt.state_dict()
    if naming == "weight_g":  # the old naming; its Adam state is not kept
        udf_sd = {}
        for i, m in enumerate(lins):
            w = m.weight.detach()
            g = w.norm(dim=1, keepdim=True)
            udf_sd.update({f"lin{i}.bias": m.bias.detach(),
                           f"lin{i}.weight_g": g, f"lin{i}.weight_v": w})
        opt_sd = {}
    path = str(tmp_path / "ckpt_best.pth")
    torch.save({"udf_network_fine": udf_sd,
                "variance_network_fine": var.state_dict(),
                "beta_network": beta.state_dict(),
                "optimizer": opt_sd, "iter_step": 321}, path)
    got = tpth.import_reference_checkpoint(path)
    want = jpth.import_reference_checkpoint(path)
    assert got["iter_step"] == want["iter_step"] == 321
    assert_trees_equal(got["params"], want["params"])
    for k in ("mu", "nu", "count"):
        assert_trees_equal(got["opt"][k], want["opt"][k])
    # zeta is in no param group: no Adam state, count 0
    assert float(got["opt"]["count"]["beta"]["zeta"]) == 0.0


def _fixture_conf(tmp_path):
    data_dir = str(tmp_path / "data")
    make_synthetic_scene(data_dir, scan="cube000", n_views=2, H=16, W=16)
    conf = config.parse_file(os.path.join(REPO, "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = str(tmp_path / "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    conf["train.batch_size"] = 16
    for k, v in FIXTURE_NET.items():
        conf[f"model.udf_network.{k}"] = v
    conf["model.udf_renderer.n_samples"] = 8
    conf["model.udf_renderer.n_importance"] = 5
    path = str(tmp_path / "fixture_net.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def test_runner_loads_the_fixture(tmp_path):
    """Runner.load_checkpoint of ref_final.pth on the CPU: the imported
    params, Adam state and step; the fresh state's trainability flags; a
    file with no optimizer starts a fresh Adam state; a missing .pth falls
    back to the .npz beside it."""
    path = _fixture_conf(tmp_path)
    runner = Runner(config.parse_file(path), "train", device="cpu")
    flags = {k: bool(getattr(runner.state, k)) for k in (
        "beta_trainable", "gamma_trainable", "zeta_trainable",
        "variance_trainable", "beta_gate_armed")}
    runner.load_checkpoint(FIXTURE)
    want = jpth.import_reference_checkpoint(FIXTURE)
    assert runner.state.step == 8000
    assert_trees_equal(params_to_numpy(runner.state.params), want["params"])
    for k in ("mu", "nu", "count"):
        assert_trees_equal(params_to_numpy(getattr(runner.state.opt, k)),
                           want["opt"][k])
    assert flags == {k: bool(getattr(runner.state, k)) for k in flags}
    assert all(t.requires_grad for t in tree_leaves(runner.state.params))

    raw = torch.load(FIXTURE, map_location="cpu", weights_only=False)
    del raw["optimizer"]
    bare = str(tmp_path / "bare.pth")
    torch.save(raw, bare)
    runner.load_checkpoint(bare)
    assert runner.state.step == 8000
    assert all(float(t.abs().max()) == 0.0 for k in ("mu", "nu", "count")
               for t in tree_leaves(getattr(runner.state.opt, k)))

    # a missing .pth with the .npz beside it
    runner.save_checkpoint(0.0)
    os.replace(os.path.join(runner._ckpt_dir(), "ckpt_best.npz"),
               os.path.join(runner._ckpt_dir(), "moved.npz"))
    runner.load_checkpoint("moved.pth")
    assert runner.state.step == 8000
    assert tnative.load_pytree(os.path.join(
        runner._ckpt_dir(), "moved.npz"))["iter_step"] == 8000
