"""The port's multi-device path (emap_tpu_torch/parallel/mesh.py and the
group paths of the step, runner, CLI and extraction) against the JAX
package's mesh paths and against one process, on the CPU: gloo over
spawned ranks; and the last ported modules (the dense-field helpers, the
dataset's debug helpers, the rendering net, the optimizer factory) against
their JAX functions.

The oracle for the sharded step is the JAX package's
`_build_train_step_fn(..., mesh=make_mesh(n), sample_fn=...)` on n of the 8
virtual CPU devices (tests/conftest.py), with the toy nets of
tests/test_parallel.py, perturb 0 and one prescribed batch (as
tests/test_torch_train.py feeds both steps), at tests/test_parallel.py's
tolerances. Ranks run in spawned processes, which import this module, so
the functions they run live at its top level."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu import cli as jcli
from emap_tpu import config as jconfig
from emap_tpu.data import dataset as jds
from emap_tpu.data import synthetic as jsyn
from emap_tpu.extract import pointcloud as jpc
from emap_tpu.fields import rendering_net as jrn
from emap_tpu.fields import udf as judf
from emap_tpu.parallel import make_mesh, replicate
from emap_tpu.render import renderer as jr
from emap_tpu.train import state as jstate
from emap_tpu.train import step as jstep
from emap_tpu.utils import optim_factory as jof
from emap_tpu_torch import cli, config
from emap_tpu_torch.ckpt import convert, native
from emap_tpu_torch.data import dataset as tds
from emap_tpu_torch.data import make_synthetic_scene
from emap_tpu_torch.extract import pointcloud as tpc
from emap_tpu_torch.fields import rendering_net as trn
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.parallel import mesh
from emap_tpu_torch.render import renderer as tr
from emap_tpu_torch.train import step as tstep
from emap_tpu_torch.train.optim import tree_leaves
from emap_tpu_torch.train.runner import Runner
from emap_tpu_torch.utils import optim_factory as tof

# tests/test_parallel.py's toy field, sampler and schedule
NET = dict(d_hidden=32, n_layers=2, skip_in=(1,), multires=2)
RENDER = dict(n_samples=8, n_importance=5, up_sample_steps=5, perturb=0.0,
              sampler_precision="highest")
B = 32
TRAIN = dict(batch_size=B, end_iter=100, warm_up_end=5.0, anneal_end=10.0,
             fix_geo_end=2.0, near=0.05, far=4.5)
STEPS = 3
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-6


def _batch():
    """One batch of B rays through the unit box, made with numpy."""
    rng = np.random.default_rng(3)
    origin = np.array([0.4, -2.1, 0.6], np.float32)
    target = rng.uniform(-0.6, 0.6, (B, 3)).astype(np.float32)
    rays_d = target - origin
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return {"rays_o": np.broadcast_to(origin, rays_d.shape).copy(),
            "rays_d": rays_d,
            "edge": rng.uniform(0, 1, (B, 1)).astype(np.float32),
            "depth_scale": rng.uniform(0.8, 1.0, (B, 1)).astype(np.float32),
            "rays_ndc_uv": np.zeros((B, 2), np.float32)}


def _jax_state():
    jst = jstate.init_train_state(3, judf.UDFConfig(**NET))
    return jst, {k: bool(getattr(jst, k)) for k in convert.FLAG_KEYS}


def port_steps(group, params, flags, chain=False):
    """STEPS steps of the port's step from the JAX state's numpy `params`
    on `_batch()`, per step, and with `chain` also as one ChainedStep call
    from the same state: [(metric rows, params as numpy)] per run, and the
    group's collective calls in the per-step run."""
    ucfg = tudf.UDFConfig(**NET)
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    args = (tstep.TrainConfig(**TRAIN), tr.RenderConfig(**RENDER), ucfg, 1)
    sample_fn = lambda s, p: (batch, 0)  # noqa: E731

    def state():
        return convert.make_state(convert.params_from_numpy(
            params, ucfg, "cpu"), 0, "cpu", flags=flags)

    def done(st, rows):
        return rows.numpy(), [p.detach().numpy()
                              for p in tree_leaves(st.params)]

    st = state()
    fn = tstep.build_train_step(*args, sample_fn=sample_fn, group=group)
    runs = [done(st, torch.stack([tstep.pack_metrics(fn(st, None))
                                  for _ in range(STEPS)]))]
    collectives = 0 if group is None else group.collectives
    if chain:
        st = state()
        runs.append(done(st, tstep.build_chained_train_step(
            *args, STEPS, sample_fn=sample_fn, group=group)(st, None)))
    return runs, collectives


def jax_sharded_steps(n_dev):
    """STEPS steps of the JAX package's step over an n_dev mesh on
    `_batch()`: (losses, params in tree order)."""
    jst, _ = _jax_state()
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}
    m = make_mesh(n_dev)
    pool = jds.RayPool(edges=jnp.zeros((1, 4)), cdf=jnp.zeros((1, 4)),
                       intrinsics_inv=jnp.eye(3)[None], rot=jnp.eye(3)[None],
                       origin=jnp.zeros((1, 3)), H=2, W=2, n_images=1)
    fn = jax.jit(jstep._build_train_step_fn(
        jstep.TrainConfig(**TRAIN), jr.RenderConfig(**RENDER),
        judf.UDFConfig(**NET), 1, mesh=m,
        sample_fn=lambda s, p, k: (jbatch, jnp.int32(0))))
    st, pool = replicate(jst, m), replicate(pool, m)
    losses = []
    for _ in range(STEPS):
        st, metrics = fn(st, pool)
        losses.append(float(metrics["loss"]))
    return losses, [np.asarray(p) for p in jax.tree.leaves(st.params)]


# -- the multi-device rule ---------------------------------------------------

@pytest.mark.parametrize("n_dev,batch,multi", [
    (8, 32, True),    # every device
    (8, 12, True),    # 12 % 8, % 7 != 0: six devices
    (8, 13, True),    # prime: one process, with a warning
    (8, 32, False),   # multi_device = false
    (1, 32, True),    # one device
])
def test_world_rule_matches_jax_cli(monkeypatch, caplog, n_dev, batch,
                                    multi):
    """parallel/mesh.py::world_size against the JAX CLI's
    build_mesh_from_conf (tests/test_parallel.py::TestCliMeshFallback's
    cases), with JAX's device count patched to n_dev."""
    monkeypatch.setattr(jax, "local_device_count", lambda: n_dev)
    tree = {"train": {"multi_device": multi}}
    with caplog.at_level("WARNING"):
        jmesh = jcli.build_mesh_from_conf(jconfig.Config(tree), batch)
    jax_warned = any("no usable device split" in r.message
                     for r in caplog.records)
    caplog.clear()
    with caplog.at_level("WARNING"):
        got = mesh.world_size(config.Config(tree), batch, n_dev)
    assert got == (1 if jmesh is None else jmesh.devices.size)
    assert jax_warned == any("no usable device split" in r.message
                             for r in caplog.records)


def test_group_bounds_cover_the_rows():
    """shard and padded_shard split rows as the gathers reassemble them."""
    x = torch.arange(10.0)[:, None]
    for world in (1, 2, 3, 4, 8):
        parts = [mesh.RayGroup(r, world, torch.device("cpu")).padded_shard(x)
                 for r in range(world)]
        assert len({p.shape for p in parts}) == 1
        assert torch.equal(torch.cat(parts)[:10], x)
    with pytest.raises(ValueError):
        mesh.RayGroup(0, 3, torch.device("cpu")).shard(x)
    halves = [mesh.RayGroup(r, 2, torch.device("cpu")).shard(x)
              for r in range(2)]
    assert torch.equal(torch.cat(halves), x)


# -- the sharded step --------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_jax_mesh_step(world):
    """The port's step at world 2 and 4 (gloo ranks) against the JAX
    package's step over a mesh of as many devices: 3 steps, loss rtol 1e-4,
    params rtol 2e-4 / atol 2e-6 (tests/test_parallel.py's tolerances);
    every rank ends on the same parameters bit for bit, through two
    collectives a step (the eikonal counts; the gradients with the
    metrics). Every metric is the group's: one process's to float32
    roundoff, the replicated scalars (variance, beta, gamma, the learning
    rates) exactly. A ChainedStep of the group (eager on the CPU) gives
    one process's per-step trajectory at the same tolerances."""
    jst, flags = _jax_state()
    params = jax.tree.map(np.asarray, jst.params)
    ranks = mesh.launch(port_steps, world, "cpu", params, flags, True)
    losses, jparams = jax_sharded_steps(world)
    (rows, tparams), chained = ranks[0][0]
    loss = tstep.METRIC_KEYS.index("loss")
    np.testing.assert_allclose(rows[:, loss], losses, rtol=LOSS_RTOL)
    for got, want in zip(tparams, jparams):
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)
    for other, _ in ranks[1:]:
        for run, want in zip(other, ranks[0][0]):
            np.testing.assert_array_equal(run[0], want[0])
            for a, b in zip(run[1], want[1]):
                np.testing.assert_array_equal(a, b)
    assert ranks[0][1] == 2 * STEPS

    one, one_params = port_steps(None, params, flags)[0][0]
    exact = [tstep.METRIC_KEYS.index(k)
             for k in ("variance", "beta", "gamma", "lr", "lr_geo")]
    np.testing.assert_array_equal(rows[:, exact], one[:, exact])
    for got_rows, got_params in ((rows, tparams), chained):
        np.testing.assert_allclose(got_rows, one, rtol=1e-5, atol=1e-7)
        for got, want in zip(got_params, one_params):
            np.testing.assert_allclose(got, want, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL)


def test_step_refuses_a_batch_that_does_not_split():
    jst, flags = _jax_state()
    ucfg = tudf.UDFConfig(**NET)
    st = convert.make_state(convert.params_from_numpy(
        jax.tree.map(np.asarray, jst.params), ucfg, "cpu"), 0, "cpu",
        flags=flags)
    group = mesh.RayGroup(0, 3, torch.device("cpu"))
    fn = tstep.build_train_step(tstep.TrainConfig(**TRAIN),
                                tr.RenderConfig(**RENDER), ucfg, 1,
                                group=group)
    with pytest.raises(ValueError, match="does not split"):
        fn(st, None)


# -- the runner: validation and the CLI --------------------------------------

def _tiny_conf(root, end_iter=4, val_freq=100):
    """confs/ABC.conf at toy size on a 32x32, 3-view cube."""
    data_dir = os.path.join(root, "data")
    make_synthetic_scene(data_dir, scan="cube000", n_views=3, H=32, W=32)
    conf = config.parse_file(os.path.join(os.path.dirname(os.path.dirname(
        __file__)), "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = os.path.join(root, "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    for k, v in {"end_iter": end_iter, "batch_size": 16, "report_freq": 2,
                 "save_freq": 2, "val_freq": val_freq,
                 "validate_resolution_level": 2}.items():
        conf[f"train.{k}"] = v
    for k, v in NET.items():
        conf[f"model.udf_network.{k}"] = v
    # fp32 sites throughout, so that the CPU's sums alone differ
    conf["model.udf_network.precision"] = "high"
    conf["model.udf_renderer.sampler_precision"] = "high"
    conf["model.udf_renderer.n_samples"] = 8
    conf["model.udf_renderer.n_importance"] = 5
    path = os.path.join(root, "tiny.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def render_view(group, conf_path):
    """One validation view of a fresh runner (perturb on: the jitter is
    drawn for whole chunks) and what validate writes."""
    runner = Runner(config.parse_file(conf_path), "train", device="cpu",
                    group=group)
    images = runner.render_image(1, 2)
    return images, runner.validate(idx=1)


def test_validate_sharded_matches_one_process(tmp_path):
    """Runner.validate at world 2 renders each chunk's rows on two ranks
    and gathers them: the view equals world 1's to float32 roundoff
    (tests/test_runner.py::test_runner_validate_sharded_matches_single's
    counterpart); rank 0 alone writes the images."""
    path = _tiny_conf(str(tmp_path))
    one, _ = render_view(None, path)
    ranks = mesh.launch(render_view, 2, "cpu", path)
    for got, want in zip(ranks[0][0], one):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert sorted(ranks[0][1]) == ["depths", "edge_maps", "normals"]
    assert ranks[1][1] == {}
    for a, b in zip(ranks[0][0], ranks[1][0]):
        np.testing.assert_array_equal(a, b)


def test_cli_trains_on_two_ranks_like_one(tmp_path):
    """`cli.main` with a world of 2 (the rule given two devices) trains on
    two gloo ranks: losses and parameters as one process's, the same on
    both ranks, checkpoints and the last validation written once."""
    path = _tiny_conf(str(tmp_path / "one"), val_freq=4)
    one = cli.main(["--conf", path, "--device", "cpu"])
    path2 = _tiny_conf(str(tmp_path / "two"), val_freq=4)
    ranks = cli.main(["--conf", path2, "--device", "cpu"], n_devices=2)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert ranks[0]["step"] == 4
    np.testing.assert_allclose([h["loss"] for h in ranks[0]["history"]],
                               [h["loss"] for h in one.history],
                               rtol=LOSS_RTOL)
    want = convert.params_to_numpy(one.state.params)["udf"]
    for layer, leaves in ranks[0]["params"].items():
        for name, got in leaves.items():
            np.testing.assert_allclose(got, want[layer][name],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)
            np.testing.assert_array_equal(ranks[1]["params"][layer][name],
                                          got)
    assert ranks[0]["history"] == ranks[1]["history"]
    exp = os.path.join(str(tmp_path / "two"), "exp", "cube000",
                       one.conf["general.expname"])
    assert os.path.exists(os.path.join(exp, "checkpoints", "ckpt_best.npz"))
    assert len(os.listdir(os.path.join(exp, "edge_maps"))) == 1


# -- sharded extraction ------------------------------------------------------

EX_NET = dict(d_hidden=64, n_layers=4, skip_in=(2,), multires=4)
EX_RES = 24


def _extract_params():
    """A perturbed geometric-init field (numpy) and thresholds at small
    quantiles of its grid values."""
    cfg = tudf.UDFConfig(**EX_NET)
    p = tudf.init_udf_params(torch.Generator().manual_seed(5), cfg,
                             device="cpu")
    rng = np.random.default_rng(5)
    p = {k: {n: (t.numpy() + 0.05 * rng.normal(size=t.shape)).astype(
        np.float32) for n, t in layer.items()} for k, layer in p.items()}
    pts = tpc.grid_points(0, EX_RES ** 3, EX_RES, "cpu")
    vals = torch.clamp(tpc.query_value(_tensors(p), pts, cfg), min=0.0)
    return p, [float(torch.quantile(vals, q)) for q in (0.02, 0.05)]


def _tensors(p):
    return {k: {n: torch.from_numpy(np.array(a)) for n, a in layer.items()}
            for k, layer in p.items()}


def extract_share(group, p, thresholds):
    """The grid masks (grid chunks of 1,000 points, which do not split
    evenly) and a multi-threshold extraction with point shift and line
    directions (point batches of 100)."""
    cfg = tudf.UDFConfig(**EX_NET)
    params = _tensors(p)
    masks = tpc.grid_masks(params, cfg, EX_RES, thresholds, grid_chunk=1000,
                           group=group)
    out = tpc.extract_pointcloud_multi(
        params, cfg, EX_RES, thresholds, sampling_N=6, is_pointshift=True,
        iters=1, is_linedirection=True, grid_chunk=1000, point_batch=100,
        group=group)
    return masks, out


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_extraction_equals_one_process(world):
    """Grid masks bit for bit, and the candidates, shifted points and line
    directions of every threshold, at world 2 and 3 against one process
    (ragged chunks and batches included)."""
    p, thresholds = _extract_params()
    masks, out = extract_share(None, p, thresholds)
    assert 0 < masks[0].sum() < masks[1].sum() < masks.shape[1] // 4
    ranks = mesh.launch(extract_share, world, "cpu", p, thresholds)
    for got_masks, got in ranks:
        np.testing.assert_array_equal(got_masks, masks)
        assert sorted(got) == sorted(out)
        for t in out:
            for g, w in zip(got[t], out[t]):
                np.testing.assert_array_equal(g, w)


def _circle_params():
    """EX_NET regressed onto the UDF of a circle of radius 0.5 in z = 0
    (300 Adam steps from a seed)."""
    cfg = tudf.UDFConfig(**EX_NET)
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


def test_cli_extracts_on_two_ranks_like_one(tmp_path):
    """`--mode extract_edge` with a world of 2: the ranks share the grid and
    the sweeps, rank 0 fits and writes, and the four result files equal one
    process's byte for byte."""
    path = _tiny_conf(str(tmp_path))
    conf = config.parse_file(path)
    for k, v in {"resolution": 32, "sampling_N": 8, "auto_threshold": [],
                 "fit_draws": 1, "udf_threshold": 0.1}.items():
        conf[f"edge_extraction.{k}"] = v
    for k, v in EX_NET.items():
        conf[f"model.udf_network.{k}"] = list(v) if k == "skip_in" else v
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    trainer = Runner(config.parse_file(path), "train", device="cpu")
    trainer.state.params["udf"] = _circle_params()
    native.save_pytree(os.path.join(trainer._ckpt_dir(), "ckpt_best.npz"),
                       convert.checkpoint_payload(trainer.state, 0.1))
    argv = ["--conf", path, "--mode", "extract_edge", "--device", "cpu"]
    results = os.path.join(trainer.base_exp_dir, "results")

    def written():
        out = {}
        for name in sorted(os.listdir(results)):
            with open(os.path.join(results, name), "rb") as f:
                out[name] = f.read()
        return out

    cli.main(argv)
    one = written()
    shutil.rmtree(results)
    ranks = cli.main(argv, n_devices=2)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert sorted(one) == ["edge_points.ply", "parametric_edges.json",
                           "udf_pointcloud_withdirection.ply"]
    assert json.loads(one["parametric_edges.json"])["lines_end_pts"] or (
        json.loads(one["parametric_edges.json"])["curves_ctl_pts"])
    assert written() == one


# -- the dense-field helpers -------------------------------------------------

def _field(seed=2):
    jcfg = judf.UDFConfig(precision="highest", **EX_NET)
    jp = jax.tree.map(np.asarray, judf.init_udf_params(jax.random.key(seed),
                                                       jcfg))
    return jcfg, jp, tudf.UDFConfig(**EX_NET), _tensors(jp)


def test_extract_fields_match_jax():
    """extract_fields through the grid value kernel's plain version against
    the JAX package's over an off-centre box, ragged chunks: fp32 sums in
    another order, 2e-6 of the field's largest."""
    jcfg, jp, tcfg, tp = _field()
    box = ([-0.9, -0.7, -1.0], [0.8, 1.0, 0.6])
    want = jpc.extract_fields(jax.tree.map(jnp.asarray, jp), jcfg, *box, 13,
                              chunk=1000)
    got = tpc.extract_fields(tp, tcfg, *box, 13, chunk=1000)
    assert got.shape == want.shape == (13, 13, 13)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_extract_gradient_fields_match_jax():
    """extract_gradient_fields through the sliced value-and-gradient
    kernel's plain version against the JAX package's: 1e-5 of the largest
    component (the hand-derived reverse pass against autodiff)."""
    jcfg, jp, tcfg, tp = _field(3)
    box = ([-1.0, -1.0, -1.0], [1.0, 0.9, 0.8])
    want = jpc.extract_gradient_fields(jax.tree.map(jnp.asarray, jp), jcfg,
                                       *box, 11, chunk=500)
    got = tpc.extract_gradient_fields(tp, tcfg, *box, 11, chunk=500)
    assert got.shape == want.shape == (11, 11, 11, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# -- the dataset's debug helpers ---------------------------------------------

@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """One non-square cube scene read by both packages."""
    root = str(tmp_path_factory.mktemp("scene"))
    jsyn.make_synthetic_scene(root, scan="c", n_views=3, H=36, W=44)
    conf = {"data_dir": root, "scan": "c", "detector": "DexiNed"}
    return (jds.load_scene(jconfig.Config(conf)),
            tds.load_scene(config.Config(conf)))


def test_masks_and_one_ray_match_jax(scenes):
    """SceneData.masks and gen_one_ray_at equal the JAX package's (the
    rays through one float32 path: 1e-6)."""
    js, ts = scenes
    np.testing.assert_array_equal(ts.masks, js.masks)
    assert ts.masks.dtype == np.float32 and 0 < ts.masks.sum()
    for img, x, y in ((0, 0, 0), (1, 43, 35), (2, 17, 9)):
        want, got = jds.gen_one_ray_at(js, img, x, y), tds.gen_one_ray_at(
            ts, img, x, y)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_color_at_matches_cv2_nearest(scenes, level):
    """color_at equals the JAX package's cv2.resize(INTER_NEAREST) byte for
    byte."""
    js, ts = scenes
    for idx in range(3):
        np.testing.assert_array_equal(tds.color_at(ts, idx, level),
                                      jds.color_at(js, idx, level))


# -- the rendering net -------------------------------------------------------

@pytest.mark.parametrize("mode,d_in,multires_view,weight_norm,squeeze_out", [
    ("idr", 12, 0, True, True),
    ("idr", 12, 4, True, False),
    ("no_view_dir", 9, 0, True, True),
    ("no_normal", 6, 4, False, True),
])
def test_rendering_net_matches_jax(mode, d_in, multires_view, weight_norm,
                                   squeeze_out):
    """The JAX package's weights carried over (ckpt/convert.py) give its
    colours in every mode of tests/test_rendering_net.py: fp32 products in
    another order, 2e-6 absolute."""
    cfg = dict(d_feature=32, mode=mode, d_in=d_in, d_out=3, d_hidden=48,
               n_layers=3, weight_norm=weight_norm,
               multires_view=multires_view, squeeze_out=squeeze_out)
    jcfg, tcfg = jrn.RenderingNetConfig(**cfg), trn.RenderingNetConfig(**cfg)
    assert tcfg.dims == jcfg.dims
    jp = jax.tree.map(np.asarray, jrn.init_rendering_params(
        jax.random.key(0), jcfg))
    tp = convert.rendering_params_from_numpy(jp, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    ins = [rng.uniform(-1, 1, (64, 3)), rng.standard_normal((64, 3)),
           rng.standard_normal((64, 3)), rng.standard_normal((64, 32))]
    ins = [a.astype(np.float32) for a in ins]
    want = np.asarray(jrn.apply_rendering_net(
        jax.tree.map(jnp.asarray, jp), *map(jnp.asarray, ins), jcfg))
    got = trn.apply_rendering_net(tp, *map(torch.as_tensor, ins), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    back = convert.params_to_numpy(tp)
    for layer in jp:
        for name in jp[layer]:
            np.testing.assert_array_equal(back[layer][name], jp[layer][name])


def test_rendering_net_init_and_normals():
    """Fresh weights have the JAX init's shapes and bounds, the normals
    carry no gradient, a sigmoid head stays in (0, 1), and a tree of the
    wrong shape or an unknown mode is refused."""
    cfg = trn.RenderingNetConfig(d_feature=16, mode="idr", d_in=12,
                                 d_hidden=32, n_layers=2)
    jp = jrn.init_rendering_params(jax.random.key(1), jrn.RenderingNetConfig(
        d_feature=16, mode="idr", d_in=12, d_hidden=32, n_layers=2))
    tp = trn.init_rendering_params(torch.Generator().manual_seed(1), cfg,
                                   device="cpu")
    for layer in jp:
        assert set(tp[layer]) == set(jp[layer])
        for name in jp[layer]:
            assert tuple(tp[layer][name].shape) == jp[layer][name].shape
        bound = np.sqrt(6.0 / cfg.dims[int(layer[3:])]) / np.sqrt(2.0)
        assert float(tp[layer]["v"].abs().max()) <= bound
    nrm = torch.randn(5, 3, requires_grad=True)
    out = trn.apply_rendering_net(tp, torch.zeros(5, 3), nrm,
                                  torch.ones(5, 3), torch.zeros(5, 16), cfg)
    assert out.shape == (5, 3) and 0 < float(out.min()) < float(out.max()) < 1
    assert not out.requires_grad
    with pytest.raises(ValueError):
        convert.rendering_params_from_numpy(
            {"lin0": {"w": np.zeros((3, 3)), "b": np.zeros(3)}}, cfg, "cpu")
    with pytest.raises(ValueError, match="unknown rendering mode"):
        trn.apply_rendering_net(tp, torch.zeros(5, 3), nrm, torch.ones(5, 3),
                                torch.zeros(5, 16), trn.RenderingNetConfig(
                                    d_feature=16, mode="rgb", d_in=12,
                                    d_hidden=32, n_layers=2))


# -- the optimizer factory ---------------------------------------------------

@pytest.mark.parametrize("kind", ["steplr", "cosine", "poly"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedules_match_optax(kind, warmup):
    """Every 7th step of a 1,000-step schedule against the optax version's
    (float32 there, float64 here: rtol 1e-6, and 1e-7 of the base rate
    where a cosine near its end keeps few float32 digits)."""
    kw = dict(decay_step=100, warmup_steps=warmup, warmup_multiplier=2.0,
              lr_min=1e-5)
    want = jof.get_scheduler(kind, 1e-3, 1000, **kw)
    got = tof.get_scheduler(kind, 1e-3, 1000, **kw)
    for step in range(0, 1001, 7):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-10), step
    if warmup:
        assert got(0) == pytest.approx(5e-4) and got(10) == pytest.approx(
            1e-3)
    with pytest.raises(ValueError):
        tof.get_scheduler("linear", 1e-3, 10)


@pytest.mark.parametrize("kind", ["sgd", "adam", "adamw", "radam"])
def test_optimizers_match_optax(kind):
    """Eight updates of each optimizer, with weight decay and a cosine
    schedule driving the learning rate, against the optax version's: the
    same rule in float32 with its terms in another order, so the moves
    agree to 1e-4 of the largest move."""
    rng = np.random.default_rng(1)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(8)]
    jsched = jof.get_scheduler("cosine", 1e-2, 20)
    tx = jof.get_optimizer(kind, jsched, weight_decay=1e-2)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = {"w": params["w"] + updates["w"]}
    w = torch.nn.Parameter(torch.as_tensor(w0.copy()))
    opt = tof.get_optimizer(kind, [w], 1e-2, weight_decay=1e-2)
    sched = tof.scheduled(opt, tof.get_scheduler("cosine", 1e-2, 20))
    for g in grads:
        w.grad = torch.as_tensor(g)
        opt.step()
        sched.step()
    want = np.asarray(params["w"]) - w0
    np.testing.assert_allclose(w.detach().numpy() - w0, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    with pytest.raises(ValueError):
        tof.get_optimizer("lamb", [w], 1e-2)
