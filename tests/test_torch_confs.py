"""confs/DTU.conf and confs/Replica.conf in the port against the JAX
package on the CPU, at toy width.

* What each package's Runner and CLI make of the two confs: the chain of
  steps a dispatch, the cadences, the schedule ends, the matmul tiers and
  the `edge_extraction` block the CLI hands to `Runner.extract_edge` (the
  6-threshold menu, `iters = 1`, `visible_checking`, the `fit_draws`
  default).
* `--mode extract_edge` with DTU.conf's `edge_extraction` block (the menu,
  `iters = 1`, the visibility filter over a PidiNet scene) at resolution
  48, through both CLIs, on one field: a toy net regressed onto the UDF of
  the synthetic cube's edges and converted to the port.
* One training step at Replica.conf's `multires = 6` with the skip layer,
  at the confs' bf16 tiers, against the JAX `build_train_step(donate=
  False)` with its fused kernels in interpret mode.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu import cli as jcli
from emap_tpu import config as jconfig
from emap_tpu.data import dataset as jds
from emap_tpu.data.synthetic import cube_edges
from emap_tpu.data.synthetic import make_synthetic_scene as jax_scene
from emap_tpu.fields import udf as judf
from emap_tpu.render import renderer as jr
from emap_tpu.train import runner as jrunner
from emap_tpu.train import state as jstate
from emap_tpu.train import step as jstep
from emap_tpu_torch import cli, config
from emap_tpu_torch.ckpt import convert
from emap_tpu_torch.ckpt.native import save_pytree
from emap_tpu_torch.data import make_synthetic_scene
from emap_tpu_torch.extract import parametric as tparam
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.render import renderer as tr
from emap_tpu_torch.train import runner as trunner
from emap_tpu_torch.train import step as tstep
from emap_tpu_torch.train.runner import Runner
from emap_tpu_torch.utils.ply import read_ply_points
from test_torch_precision import (
    B,
    _batch,
    _field_errors,
    jax_resolved,
    tpu_default_udf_value,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = ("DTU", "Replica")
# toy width; multires, skip_in and the tiers stay the conf's
TOY = dict(d_hidden=64, n_layers=4, skip_in=[2])
ZEROS = {"variance": {"variance": np.float32(0.3),
                      "second_variance": np.float32(0.3)},
         "beta": {"beta": np.float32(0.5), "gamma": np.float32(0.3),
                  "zeta": np.float32(0.3)}}


class Stop(Exception):
    """Raised by a recording stand-in to end a call once it has been read."""


def conf_pair(name, base_exp_dir, data_dir, scan, **overrides):
    """confs/<name>.conf parsed by each package, pointed at a scene and a
    directory, at toy width, with the same overrides."""
    text = open(os.path.join(REPO, "confs", f"{name}.conf")).read()
    out = []
    for parse in (config.parse_string, jconfig.parse_string):
        conf = parse(text)
        conf["general.base_exp_dir"] = base_exp_dir
        conf["general.recording"] = []
        conf["dataset.data_dir"] = data_dir
        conf["dataset.scan"] = scan
        conf["dataset.far"] = 4.5
        conf["train.multi_device"] = False  # the JAX CLI's mesh: one device
        for k, v in TOY.items():
            conf[f"model.udf_network.{k}"] = v
        for k, v in overrides.items():
            conf[k] = v
        out.append(conf)
    return out


def write_conf(conf, path):
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A tiny scene for each conf, written by the port with the conf's
    detector."""
    tmp = tmp_path_factory.mktemp("confs")
    out = {}
    for name in CONFS:
        conf = config.parse_file(os.path.join(REPO, "confs", f"{name}.conf"))
        data_dir = str(tmp / name / "data")
        make_synthetic_scene(data_dir, scan="cube000", n_views=3, H=16, W=16,
                             detector=conf.get_string("dataset.detector"))
        out[name] = (tmp / name, data_dir)
    return out


def chain_of(module, runner, monkeypatch) -> int:
    """The steps a dispatch that `runner.train()` builds its chained step
    with, read from the package's own train loop."""
    seen = {}

    def record(*args, **kwargs):
        seen["chain"] = args[4]
        raise Stop

    with monkeypatch.context() as m:
        m.setattr(module, "build_chained_train_step", record)
        with pytest.raises(Stop):
            runner.train()
    return seen["chain"]


@pytest.mark.parametrize("name", CONFS)
def test_conf_trains_as_the_jax_runner_resolves_it(name, scenes,
                                                   monkeypatch):
    """The chain, the cadences, every training setting with its schedule
    ends, the field's shape and the tiers of each site, from both
    packages' Runner on the same conf."""
    tmp, data_dir = scenes[name]
    tconf, jconf = conf_pair(name, str(tmp / "exp_train"), data_dir,
                             "cube000")
    port = Runner(tconf, "train", device="cpu")
    ref = jrunner.Runner(jconf, "train")
    assert chain_of(trunner, port, monkeypatch) == chain_of(
        jrunner, ref, monkeypatch)
    for key in ("end_iter", "report_freq", "save_freq", "val_freq",
                "batch_size", "validate_resolution_level"):
        assert getattr(port, key) == getattr(ref, key), key
    assert vars(port.tcfg) == vars(ref.tcfg)
    for key in ("multires", "d_in", "d_out", "d_hidden", "n_layers",
                "skip_in", "scale", "udf_type", "precision", "bwd_precision"):
        assert getattr(port.ucfg, key) == getattr(ref.ucfg, key), key
    assert port.tiers == jax_resolved(ref, monkeypatch)
    # what the conf sets, so that both sides are held to it
    assert port.end_iter == 200_000 and port.save_freq == 5_000
    assert port.tcfg.igr_weight == 0.01
    assert port.tiers == {"field": "default", "adjoint": "default",
                          "sampler": "default", "extraction": "high",
                          "route": "kernels"}
    assert port.ucfg.multires == {"DTU": 10, "Replica": 6}[name]


@pytest.mark.parametrize("name", CONFS)
def test_conf_extracts_with_the_jax_cli_block(name, scenes, monkeypatch):
    """The keyword arguments each CLI's `--mode extract_edge` hands to
    `Runner.extract_edge` from the conf's `edge_extraction` block: the
    6-threshold menu, `iters = 1`, `visible_checking`, resolution 256 and
    the `fit_draws` default of one fit a threshold."""
    tmp, data_dir = scenes[name]
    tconf, jconf = conf_pair(name, str(tmp / "exp_block"), data_dir,
                             "cube000")
    seen = {}

    def recorder(key):
        def extract_edge(self, **kwargs):
            seen[key] = kwargs
        return extract_edge

    monkeypatch.setattr(trunner.Runner, "extract_edge", recorder("port"))
    monkeypatch.setattr(jrunner.Runner, "extract_edge", recorder("jax"))
    cli.main(["--conf", write_conf(tconf, str(tmp / "port_block.conf")),
              "--mode", "extract_edge", "--device", "cpu"])
    jcli.main(["--conf", write_conf(jconf, str(tmp / "jax_block.conf")),
               "--mode", "extract_edge"])
    assert seen["port"] == seen["jax"]
    assert seen["port"]["auto_threshold"] == [0.005, 0.0075, 0.01, 0.015,
                                              0.02, 0.03]
    assert seen["port"]["iters"] == 1 and seen["port"]["fit_draws"] == 1
    assert seen["port"]["visible_checking"] is True
    assert seen["port"]["resolution"] == 256


def cube_udf(p):
    """Distance from points (N, 3) to the nearest of the synthetic cube's
    12 edges (half-size 0.5)."""
    edges = jnp.asarray(cube_edges(0.5))
    a, b = edges[:, 0], edges[:, 1]
    ab = b - a
    t = jnp.clip(jnp.sum((p[:, None] - a[None]) * ab[None], -1)
                 / jnp.sum(ab * ab, -1)[None], 0.0, 1.0)
    closest = a[None] + t[..., None] * ab[None]
    return jnp.min(jnp.linalg.norm(p[:, None] - closest, axis=-1), axis=1)


@pytest.fixture(scope="module")
def cube_field():
    """(JAX params as numpy, port UDFConfig): the DTU conf's net at toy
    width regressed onto the cube's edge UDF by Adam in the JAX package;
    half the samples uniform in [-1, 1]^3, half within 0.1 of an edge."""
    from emap_tpu.train.optim import adam_init, adam_update

    net = dict(TOY, skip_in=tuple(TOY["skip_in"]), multires=10)
    jcfg = judf.UDFConfig(precision="highest", **net)
    params = judf.init_udf_params(jax.random.key(0), jcfg)
    opt = adam_init(params)
    lr = jax.tree.map(lambda _: jnp.float32(1e-3), params)
    mask = jax.tree.map(lambda _: jnp.float32(1.0), params)
    edges = jnp.asarray(cube_edges(0.5))

    @jax.jit
    def step(params, opt, key):
        k0, k1, k2, k3 = jax.random.split(key, 4)
        uni = jax.random.uniform(k0, (256, 3), minval=-1, maxval=1)
        seg = edges[jax.random.randint(k1, (256,), 0, 12)]
        t = jax.random.uniform(k2, (256, 1))
        near = (seg[:, 0] + t * (seg[:, 1] - seg[:, 0])
                + 0.1 * jax.random.normal(k3, (256, 3))
                * jax.random.uniform(k3, (256, 1)))
        pts = jnp.concatenate([uni, near])

        def loss_fn(p):
            return jnp.mean((judf.apply_udf(p, pts, jcfg)[:, 0]
                             - cube_udf(pts)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt = adam_update(params, grads, opt, lr, mask)
        return params, opt, loss

    key = jax.random.key(1)
    for _ in range(1500):
        key, k = jax.random.split(key)
        params, opt, loss = step(params, opt, k)
    assert float(loss) < 5e-4
    return jax.tree.map(np.asarray, params), tudf.UDFConfig(**net)


def edge_points(edges):
    """Points every 5 mm along a parametric_edges.json's primitives."""
    return tparam.sample_primitives(
        np.asarray(edges["curves_ctl_pts"], np.float64).reshape(-1, 12),
        np.asarray(edges["lines_end_pts"], np.float64).reshape(-1, 6))[0]


def test_dtu_extract_edge_matches_jax(tmp_path, cube_field):
    """`--mode extract_edge` through both CLIs with DTU.conf's
    edge_extraction block (resolution 48 in place of 256) on a 24-view
    PidiNet cube scene, from one checkpoint: the same threshold picked
    from the same 6-threshold menu, and the point cloud at it within the
    roundoff class of tests/test_torch_extract.py (1.6e-3; measured
    2.6e-7). The line directions come from jittered samples that each
    package draws from its own generator (torch.Generator, jax.random), and
    the fit's line growth follows them, so the primitives are held twice:
    the port's fit and visibility filter on the JAX package's cloud and
    colours give the JAX package's primitives exactly, and end to end the
    two sets of primitives lie within one voxel of each other (chamfer of
    points sampled every 5 mm; measured 0.030 of the voxel's 0.043). The
    visibility filter ran once a threshold and dropped primitives (measured
    1 to 16 of 12 to 96)."""
    from emap_tpu.extract import parametric as jparam

    jp, tcfg = cube_field
    data_dir = str(tmp_path / "data")
    jax_scene(data_dir, scan="cube000", n_views=24, H=64, W=64,
              detector="PidiNet")
    res = 48
    base = {"edge_extraction.resolution": res}
    tconf, _ = conf_pair("DTU", str(tmp_path / "port"), data_dir, "cube000",
                         **base)
    _, jconf = conf_pair("DTU", str(tmp_path / "jax"), data_dir, "cube000",
                         **base)
    trainer = Runner(tconf, "train", device="cpu")
    trainer.state.params["udf"] = convert.params_from_numpy(
        {"udf": jp, **ZEROS}, tcfg, device="cpu")["udf"]
    payload = convert.checkpoint_payload(trainer.state, 0.1)
    runs = {}
    for key, conf in (("port", tconf), ("jax", jconf)):
        exp = os.path.join(conf["general.base_exp_dir"], "cube000",
                           conf["general.expname"])
        save_pytree(os.path.join(exp, "checkpoints", "ckpt_best.npz"),
                    payload)
        path = write_conf(conf, str(tmp_path / f"{key}.conf"))
        if key == "port":
            runner = cli.main(["--conf", path, "--mode", "extract_edge",
                               "--device", "cpu"])
        else:
            jcli.main(["--conf", path, "--mode", "extract_edge"])
        out = os.path.join(exp, "results")
        with open(os.path.join(out, "threshold_selection.json")) as f:
            sel = json.load(f)
        with open(os.path.join(out, "parametric_edges.json")) as f:
            edges = json.load(f)
        runs[key] = (sel, edges, read_ply_points(
            os.path.join(out, "udf_pointcloud_withdirection.ply")))
    (tsel, tedges, (tpts, tcol)), (jsel, jedges, (jpts, jcol)) = (
        runs["port"], runs["jax"])

    assert [r["udf_threshold"] for r in tsel["candidates"]] == [
        r["udf_threshold"] for r in jsel["candidates"]] == [
        0.005, 0.0075, 0.01, 0.015, 0.02, 0.03]
    assert tsel["picked"] == jsel["picked"]
    assert len(jpts) > 20 and abs(len(tpts) - len(jpts)) <= max(
        2, len(jpts) // 200)
    d = np.linalg.norm(tpts[:, None] - jpts[None], axis=-1)
    assert d.min(axis=1).max() <= 1.6e-3 and d.min(axis=0).max() <= 1.6e-3
    # the fit stage on the JAX package's cloud: the same primitives
    want_pts, want = jparam.get_parametric_edge(
        jpts, jcol, res, "PidiNet", os.path.join(data_dir, "cube000"),
        visible_checking=True)
    got_pts, got = tparam.get_parametric_edge(
        jpts, jcol, res, "PidiNet", os.path.join(data_dir, "cube000"),
        visible_checking=True)
    np.testing.assert_array_equal(got_pts, want_pts)
    assert got == want and len(got["lines_end_pts"]) > 0

    # end to end: the two fits of clouds that differ in line-direction
    # signs lie within one voxel of each other
    a, b = edge_points(tedges), edge_points(jedges)
    assert len(a) and len(b)
    dab = np.linalg.norm(a[:, None] - b[None], axis=-1)
    chamfer = 0.5 * (dab.min(axis=1).mean() + dab.min(axis=0).mean())
    assert chamfer < 2.0 / (res - 1), chamfer

    vis = [t for t in runner.extract_trace if t["stage"] == "visibility"]
    assert len(vis) == 6 and all(t["frames"] == 24 for t in vis)
    assert sum(t["kept"] for t in vis) > 0
    assert sum(t["dropped"] for t in vis) > 0


def test_replica_width_train_step_matches_jax(monkeypatch):
    """One training step with Replica.conf's field (multires 6: d0 39,
    padded to 40; the skip layer at 4 of 8 takes 25 + 39 inputs at this
    width) at the confs' tiers (field, adjoint and up-sampler "default",
    model "high") against the JAX build_train_step(donate=False) with its
    fused kernels forced on (interpret mode) and the up-sampler at the
    TPU's DEFAULT. Field gradients read from Adam's first moment, held as
    tests/test_torch_precision.py holds ABC's: 2e-3 of the field's largest
    and 5e-3 in the worst leaf, and 5x nearer than the JAX step at
    "highest"."""
    conf = config.parse_file(os.path.join(REPO, "confs", "Replica.conf"))
    net = dict(d_hidden=64, n_layers=8, skip_in=(4,),
               multires=conf.get_int("model.udf_network.multires"))
    assert net["multires"] == 6
    render_kw = dict(n_samples=8, n_importance=5, up_sample_steps=5,
                     perturb=0.0)
    train_kw = dict(batch_size=B, end_iter=100, learning_rate=0.0,
                    warm_up_end=1.0, anneal_end=2.0, fix_geo_end=0.0,
                    near=0.05, far=2.5,
                    igr_weight=conf.get_float("train.igr_weight"))
    init = dict(variance_init=0.5, beta_init=0.5, gamma_init=0.3,
                zeta_init=0.3, requires_grad_beta=False,
                requires_grad_zeta=False)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jpool = jds.RayPool(edges=jnp.zeros((1, 4)), cdf=jnp.zeros((1, 4)),
                        intrinsics_inv=jnp.eye(3)[None], rot=jnp.eye(3)[None],
                        origin=jnp.zeros((1, 3)), H=2, W=2, n_images=1)
    tucfg = tudf.UDFConfig(**net)
    trcfg = tr.RenderConfig(**render_kw, field_precision="default")
    assert tr.resolved_tiers(trcfg, tucfg)["field"] == "default"

    def jax_step(prec, sampler, field, pallas):
        jucfg = judf.UDFConfig(precision=prec, pallas_train=pallas,
                               tile_fwd=128, tile_bwd=128, **net)
        jrcfg = jr.RenderConfig(sampler_precision=sampler,
                                field_precision=field, **render_kw)
        jst = jstate.init_train_state(0, jucfg, **init)
        jfn = jstep.build_train_step(
            jstep.TrainConfig(**train_kw), jrcfg, jucfg, 1, donate=False,
            sample_fn=lambda s, p, k: (jbatch, jnp.int32(0)))
        with monkeypatch.context() as m:
            m.setattr(jr, "udf_value", tpu_default_udf_value)
            jst, jm = jfn(jst, jpool)
        return jst, jm

    jst, jm = jax_step("high", "default", "default", "on")
    jst_hi, _ = jax_step("highest", "highest", "", "auto")
    flags = {k: bool(getattr(jst, k)) for k in convert.FLAG_KEYS}
    tst = convert.make_state(convert.params_from_numpy(
        jax.tree.map(np.asarray, jstate.init_train_state(
            0, judf.UDFConfig(**net), **init).params), tucfg, device="cpu"),
        0, "cpu", flags=flags)
    tfn = tstep.build_train_step(tstep.TrainConfig(**train_kw), trcfg, tucfg,
                                 1, sample_fn=lambda s, p: (tbatch, 0))
    tm = tfn(tst, None)
    loss, want = float(tm["loss"]), float(jm["loss"])
    assert np.isfinite(loss) and abs(loss - want) < 1e-5 * abs(want)
    whole, leaf = _field_errors(tst.opt.mu["udf"], jax.tree.map(
        np.asarray, jst.opt.mu["udf"]))
    assert whole < 2e-3 and leaf < 5e-3
    whole_hi, _ = _field_errors(tst.opt.mu["udf"], jax.tree.map(
        np.asarray, jst_hi.opt.mu["udf"]))
    assert whole_hi > 5 * whole


def test_production_script_takes_dtu_in_three_parts(tmp_path, monkeypatch):
    """scripts/torch_run_production.py with DTU.conf at toy size on the CPU
    (its menu, iters 1, the visibility filter over the PidiNet scene the
    script writes), in three calls as the 200k gate takes it: stopped at
    steps 2 and 4 of 6, then resumed to the end, extracted and scored. The
    parts are contiguous and sum to the schedule; the report carries the
    selector's table with each candidate's f3d, and the extraction's
    seconds by stage, the visibility filter's included."""
    import importlib.util

    conf = config.parse_file(os.path.join(REPO, "confs", "DTU.conf"))
    for k, v in {"batch_size": 16, "report_freq": 1, "save_freq": 1,
                 "val_freq": 100}.items():
        conf[f"train.{k}"] = v
    for k, v in {"d_hidden": 16, "n_layers": 4, "skip_in": [2],
                 "multires": 2}.items():
        conf[f"model.udf_network.{k}"] = v
    conf["model.udf_renderer.n_samples"] = 8
    conf["model.udf_renderer.n_importance"] = 5
    conf["edge_extraction.resolution"] = 16
    conf["edge_extraction.sampling_N"] = 4
    (tmp_path / "DTU.conf").write_text(conf.to_hocon())
    monkeypatch.setattr(trunner, "LOSS_WINDOW", 2)
    for k, v in {"PROD_CONF": str(tmp_path / "DTU.conf"),
                 "PROD_OUT": str(tmp_path / "out"), "PROD_ITERS": "6",
                 "PROD_DEVICE": "cpu"}.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "torch_run_production",
        os.path.join(REPO, "scripts", "torch_run_production.py"))
    report = None
    for stop in ("2", "4", "0"):
        monkeypatch.setenv("PROD_STOP_AT", stop)
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        report = script.main()
    parts = report["train_parts"]
    assert [(p["from"], p["to"]) for p in parts] == [(0, 2), (2, 4), (4, 6)]
    assert sum(p["to"] - p["from"] for p in parts) == report["iters"] == 6
    assert all(p["card"] == "" for p in parts)
    sel = report["threshold_selection"]
    assert [r["udf_threshold"] for r in sel["candidates"]] == [
        0.005, 0.0075, 0.01, 0.015, 0.02, 0.03]
    assert sel["picked"] in [r["udf_threshold"] for r in sel["candidates"]]
    assert all("f3d" in r for r in sel["candidates"])
    stages = report["extract_stages"]
    assert stages["grid"]["count"] >= 1 and stages["fit"]["count"] == 6
    assert stages["visibility"]["count"] == 6
    assert {"fscore_0.005", "fscore_0.01", "fscore_0.02", "n_lines",
            "n_curves"} <= set(report["score"])
