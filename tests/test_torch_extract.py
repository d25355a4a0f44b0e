"""The port's extraction path (emap_tpu_torch/extract, native, utils, and the
runner's extract_edge and validate) against the JAX package on the CPU.

Device side: the kernels' plain versions (kernels/mlp_query.py) against the
Pallas kernels in interpret mode, and the point-cloud stages against JAX's
on one field, a toy net regressed onto the analytic UDF of a circle
(tests/test_extract.py::circle_field) and carried across as numpy. Host
side: fitting, merging, parametric edges, PLY bytes and the threshold
selector on identical numpy inputs, compared exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu import config as jconfig
from emap_tpu.data.synthetic import cube_edges, make_synthetic_scene
from emap_tpu.extract import autothresh as jat
from emap_tpu.extract import fitting as jfit
from emap_tpu.extract import merging as jmerge
from emap_tpu.extract import parametric as jparam
from emap_tpu.extract import pointcloud as jpc
from emap_tpu.fields import udf as judf
from emap_tpu.kernels import mlp_query as jq
from emap_tpu.utils import ply as jply
from emap_tpu_torch import cli, config
from emap_tpu_torch.ckpt.convert import checkpoint_payload, params_from_numpy
from emap_tpu_torch.ckpt.native import save_pytree
from emap_tpu_torch.data.png import read_png
from emap_tpu_torch.extract import autothresh as tat
from emap_tpu_torch.extract import fitting as tfit
from emap_tpu_torch.extract import merging as tmerge
from emap_tpu_torch.extract import parametric as tparam
from emap_tpu_torch.extract import pointcloud as tpc
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.kernels import mlp_query as tq
from emap_tpu_torch.utils import ply as tply
from emap_tpu_torch.utils.vis import JET_BGR, visualize_depth

NET = dict(d_hidden=64, n_layers=4, skip_in=(2,), multires=6)
ZEROS = {"variance": {"variance": np.float32(0.3),
                      "second_variance": np.float32(0.3)},
         "beta": {"beta": np.float32(0.5), "gamma": np.float32(0.3),
                  "zeta": np.float32(0.3)}}
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "autothresh_tables")


def circle_udf(p):
    r = np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
    return np.sqrt((r - 0.5) ** 2 + p[:, 2] ** 2)


@pytest.fixture(scope="module")
def circle():
    """(JAX cfg at "highest", port cfg, JAX params, port params): the toy
    net regressed onto the UDF of a circle of radius 0.5 in z = 0."""
    from emap_tpu.train.optim import adam_init, adam_update

    jcfg = judf.UDFConfig(precision="highest", **NET)
    params = judf.init_udf_params(jax.random.key(0), jcfg)
    opt = adam_init(params)
    lr = jax.tree.map(lambda _: jnp.float32(1e-3), params)
    mask = jax.tree.map(lambda _: jnp.float32(1.0), params)

    def target(p):
        r = jnp.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
        return jnp.sqrt((r - 0.5) ** 2 + p[:, 2] ** 2)

    @jax.jit
    def step(params, opt, key):
        pts = jax.random.uniform(key, (512, 3), minval=-1, maxval=1)

        def loss_fn(p):
            return jnp.mean((judf.apply_udf(p, pts, jcfg)[:, 0]
                             - target(pts)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt = adam_update(params, grads, opt, lr, mask)
        return params, opt, loss

    key = jax.random.key(1)
    for _ in range(800):
        key, k = jax.random.split(key)
        params, opt, loss = step(params, opt, k)
    assert float(loss) < 5e-4
    jp = jax.tree.map(np.asarray, params)
    tcfg = tudf.UDFConfig(**NET)
    tp = params_from_numpy({"udf": jp, **ZEROS}, tcfg, device="cpu")["udf"]
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def random_net(seed, multires=4):
    """A perturbed geometric-init toy net in both packages."""
    jcfg = judf.UDFConfig(precision="highest", d_hidden=64, n_layers=4,
                          skip_in=(2,), multires=multires)
    tcfg = tudf.UDFConfig(d_hidden=64, n_layers=4, skip_in=(2,),
                          multires=multires)
    jp = jax.tree.map(np.asarray, judf.init_udf_params(jax.random.key(seed),
                                                       jcfg))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape))
                      .astype(np.float32), jp)
    tp = params_from_numpy({"udf": jp, **ZEROS}, tcfg, device="cpu")["udf"]
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


# -- the field queries: kernel #3 and the extraction variant of #1 ---------

def test_value_matches_pallas_value_and_jax_udf():
    """query_value (value_plain on the CPU) against pallas_udf_value in
    interpret mode and the plain JAX field, at JAX's own kernel-test
    tolerance (tests/test_kernels.py)."""
    jcfg, tcfg, jp, tp = random_net(0)
    pts = np.random.default_rng(0).uniform(-1, 1, (70, 3)).astype(np.float32)
    got = tq.query_value(tp, torch.as_tensor(pts), tcfg).numpy()
    assert got.shape == (70,)
    pallas = np.asarray(jq.pallas_udf_value(jp, jnp.asarray(pts), jcfg,
                                            tile=64, interpret=True))
    ref = np.asarray(judf.udf_value(jp, jnp.asarray(pts), jcfg))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cap", [64, 192, tq.SLICE_CAP])
def test_sliced_value_and_grad_matches_pallas(cap):
    """The extraction's value + spatial gradient through the slicing wrapper
    (one launch per `cap` points on the card) against
    pallas_udf_value_and_grad in interpret mode: udf to 1e-5 / 1e-6,
    gradient to 2e-4 / 2e-5 (tests/test_kernels.py). The slices
    concatenate to the unsliced result."""
    jcfg, tcfg, jp, tp = random_net(1)
    pts = np.random.default_rng(1).uniform(-0.9, 0.9, (300, 3)).astype(
        np.float32)
    u, g = tq.query_value_and_grad(tp, torch.as_tensor(pts), tcfg, cap=cap)
    assert u.shape == (300,) and g.shape == (300, 3)
    uj, gj = jq.pallas_udf_value_and_grad(jp, jnp.asarray(pts), jcfg,
                                          tile=64, interpret=True)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=2e-4,
                               atol=2e-5)
    u1, g1 = tq.query_value_and_grad(tp, torch.as_tensor(pts), tcfg,
                                     cap=tq.SLICE_CAP)
    assert torch.equal(u, u1) and torch.equal(g, g1)


def test_slicing_wrapper_launch_plan():
    """value_and_grad_sliced cuts N into ceil(N / cap) slices and refuses a
    cap that is not a multiple of the tile."""
    _, tcfg, _, tp = random_net(2)
    w, b = (t.detach() for t in tq.pack_weights(tp, tcfg))
    x = torch.zeros(8, 320)
    x[:3] = torch.rand(3, 320, generator=torch.Generator().manual_seed(0))
    calls = []
    real = tq.value_and_grad
    try:
        tq.value_and_grad = lambda xs, *a: (calls.append(xs.shape[1])
                                            or real(xs, *a))
        u, g = tq.value_and_grad_sliced(x, w, b, tcfg, cap=128)
    finally:
        tq.value_and_grad = real
    assert calls == [128, 128, 64]
    assert u.shape == (320,) and g.shape == (8, 320)
    with pytest.raises(ValueError, match="multiple"):
        tq.value_and_grad_sliced(x, w, b, tcfg, cap=100)


def test_extraction_refuses_nets_the_kernels_do_not_take(circle):
    """The extraction's queries take the kernels' path on every device; a
    net they do not take raises instead of taking another path."""
    import dataclasses

    _, tcfg, _, tp = circle
    for bad in (dataclasses.replace(tcfg, multires=0),
                dataclasses.replace(tcfg, d_hidden=320)):
        with pytest.raises(ValueError, match="fused kernels"):
            tpc.extract_pointcloud(tp, bad, resolution=8)


@pytest.mark.parametrize("with_linedir", [False, True])
def test_point_batch_features_match_jax(circle, with_linedir):
    """udf and normals to 1e-5 from the same points; line directions from
    the same numpy jitter, compared up to sign (each eigensolver picks its
    own) and to 1e-3: the eigenvector amplifies the gradients' ~1e-5
    roundoff by the inverse gap between the Gram matrix's two smallest
    eigenvalues (measured 1.3e-4 here)."""
    jcfg, tcfg, jp, tp = circle
    rng = np.random.default_rng(3)
    th = rng.uniform(0, 2 * np.pi, 64)
    pts = np.stack([0.5 * np.cos(th), 0.5 * np.sin(th),
                    rng.normal(0, 0.01, 64)], 1).astype(np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    jitter = (0.005 * rng.normal(size=(64, 20, 3))).astype(np.float32)
    uj, nj, lj = (np.asarray(a) for a in jpc._point_batch_features(
        jp, jnp.asarray(pts), jnp.asarray(jitter), jcfg, 20, with_linedir))
    ut, nt, lt = (a.numpy() for a in tpc._point_batch_features(
        tp, torch.as_tensor(pts), torch.as_tensor(jitter), tcfg, 20,
        with_linedir))
    np.testing.assert_allclose(ut, uj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-5)
    if not with_linedir:
        assert not lt.any() and not lj.any()
        return
    sign = np.sign(np.sum(lt * lj, axis=1, keepdims=True))
    np.testing.assert_allclose(lt * sign, lj, atol=1e-3)


def test_grid_masks_match_jax(circle):
    """One grid pass, K thresholds: the same bits as JAX's
    _grid_mask_chunk_multi, except voxels whose udf lies within 1e-6 of a
    threshold."""
    jcfg, tcfg, jp, tp = circle
    N, chunk, thresholds = 24, 4608, (0.015, 0.03, 0.05)
    total = N ** 3
    got = tpc.grid_masks(tp, tcfg, N, thresholds, grid_chunk=chunk)
    assert got.shape == (3, total) and got.dtype == bool
    want = np.concatenate([
        np.asarray(jpc._grid_mask_chunk_multi(jp, jnp.int32(s), thresholds,
                                              chunk, N, jcfg))
        for s in range(0, total, chunk)], axis=1)
    want = np.stack([np.unpackbits(w, count=total).astype(bool)
                     for w in want])
    pts = tpc.grid_points(0, total, N, "cpu")
    vals = np.maximum(tudf.udf_value(tp, pts, tcfg).detach().numpy(), 0.0)
    for k, t in enumerate(thresholds):
        differ = got[k] != want[k]
        assert want[k].sum() > 0
        assert (np.abs(vals[differ] - t) <= 1e-6).all(), (t, differ.sum())
    assert (got[0] <= got[1]).all() and (got[1] <= got[2]).all()


@pytest.mark.parametrize("multi", [False, True])
def test_extract_pointcloud_matches_jax(circle, multi):
    """The point sets of the port and the JAX package on one field, without
    line directions: the same points up to the roundoff class the JAX
    package documents across backends (udf within ~3e-6, so only points
    within that of a keep threshold may differ; clouds within 1.6e-3)."""
    jcfg, tcfg, jp, tp = circle
    thresholds = [0.015, 0.03, 0.05]
    kw = dict(sampling_N=10, sampling_delta=0.01, is_pointshift=True,
              iters=2, is_linedirection=False, grid_chunk=110592,
              point_batch=2048)
    if multi:
        want = jpc.extract_pointcloud_multi(jp, jcfg, resolution=32,
                                            thresholds=thresholds, **kw)
        got = tpc.extract_pointcloud_multi(tp, tcfg, resolution=32,
                                           thresholds=thresholds, **kw)
    else:
        want = {0.03: jpc.extract_pointcloud(jp, jcfg, resolution=32,
                                             udf_threshold=0.03, **kw)}
        got = {0.03: tpc.extract_pointcloud(tp, tcfg, resolution=32,
                                            udf_threshold=0.03, **kw)}
    assert set(got) == set(want)
    for t in want:
        (pw, dw), (pg, dg) = want[t], got[t]
        assert pg.dtype == np.float32 and pg.shape[1] == 3
        assert len(pw) > 20
        assert abs(len(pg) - len(pw)) <= max(2, len(pw) // 200), t
        d = np.linalg.norm(pg[:, None] - pw[None], axis=-1)
        assert d.min(axis=1).max() <= 1.6e-3 and d.min(axis=0).max() <= 1.6e-3
        assert not dg.any() and not dw.any()
        # the regressed field's zero set is within ~0.03 of the circle
        # (its loss is 5e-4), as in tests/test_extract.py
        assert np.median(circle_udf(pg)) < 0.05


def test_multi_with_one_threshold_equals_standalone(circle):
    """Within the port, K = 1 reproduces extract_pointcloud bit for bit,
    line directions included (the same jitter draws)."""
    _, tcfg, _, tp = circle
    kw = dict(sampling_N=10, sampling_delta=0.01, is_pointshift=True,
              iters=2, is_linedirection=True, point_batch=512)
    pts, dirs = tpc.extract_pointcloud(tp, tcfg, resolution=32,
                                       udf_threshold=0.03, **kw)
    out = tpc.extract_pointcloud_multi(tp, tcfg, resolution=32,
                                       thresholds=[0.03], **kw)
    np.testing.assert_array_equal(out[0.03][0], pts)
    np.testing.assert_array_equal(out[0.03][1], dirs)
    # the directions are unit and tangent to the circle
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, atol=1e-3)
    r = np.linalg.norm(pts[:, :2], axis=1, keepdims=True)
    radial = np.concatenate([pts[:, :2] / r, np.zeros((len(pts), 1))], 1)
    assert np.median(np.abs(np.sum(dirs * radial, axis=1))) < 0.3


def test_point_batches_query_only_live_rows(circle, monkeypatch):
    """A short last batch queries only its own rows (and their jitter
    samples), and gives what the batch zero-padded to full size gives: the
    jitter is drawn at the full batch shape either way."""
    _, tcfg, _, tp = circle
    m, batch, n_jit, delta, seed, sweep = 600, 256, 5, 0.01, 42, 1
    rng = np.random.default_rng(8)
    th = rng.uniform(0, 2 * np.pi, m)
    pts = np.stack([0.5 * np.cos(th), 0.5 * np.sin(th),
                    rng.normal(0, 0.02, m)], 1).astype(np.float32)
    sizes = []
    query = tpc.query_value_and_grad

    def spy(params, p, cfg):
        sizes.append(p.shape[0])
        return query(params, p, cfg)

    monkeypatch.setattr(tpc, "query_value_and_grad", spy)
    udf, nrm, ld = tpc._run_point_batches(tp, tcfg, pts, seed, sweep, n_jit,
                                          delta, True, batch)
    assert sizes == [256, 256 * n_jit, 256, 256 * n_jit, 88, 88 * n_jit]

    padded = np.zeros((3 * batch, 3), np.float32)
    padded[:m] = pts
    want = []
    for b in range(3):
        gen = torch.Generator().manual_seed(tpc.batch_seed(seed, sweep, b))
        jitter = delta * torch.randn((batch, n_jit, 3), generator=gen)
        want.append(tpc._point_batch_features(
            tp, torch.as_tensor(padded[b * batch: (b + 1) * batch]), jitter,
            tcfg, n_jit, True))
    uw, nw, lw = (torch.cat([w[i] for w in want]).numpy()[:m]
                  for i in range(3))
    np.testing.assert_allclose(udf, uw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(nrm, nw, rtol=1e-6, atol=1e-6)
    sign = np.sign(np.sum(ld * lw, axis=1, keepdims=True))
    np.testing.assert_allclose(ld * sign, lw, atol=1e-3)


def test_extraction_trace_counts_the_sweeps(circle):
    _, tcfg, _, tp = circle
    trace = []
    tpc.extract_pointcloud_multi(tp, tcfg, resolution=24,
                                 thresholds=[0.02, 0.04], sampling_N=5,
                                 is_pointshift=True, iters=2,
                                 is_linedirection=True, point_batch=256,
                                 trace=trace)
    assert [t["stage"] for t in trace] == ["grid", "sweep", "sweep", "sweep"]
    assert trace[0]["points"] == 24 ** 3
    assert [t["linedir"] for t in trace[1:]] == [False, False, True]
    assert trace[1]["points"] >= trace[2]["points"] >= trace[3]["points"] > 0


# -- host side: identical numpy inputs, identical outputs ------------------

def cube_cloud(n_per_edge, seed=0, noise=2e-3):
    """Points along the cube's 12 edges with their line directions encoded
    as colours in [0, 1], as the extraction hands them to the fit."""
    rng = np.random.default_rng(seed)
    pts, cols = [], []
    for a, b in cube_edges(0.5):
        t = rng.uniform(0, 1, (n_per_edge, 1))
        pts.append(a + t * (b - a) + rng.normal(0, noise, (n_per_edge, 3)))
        d = (b - a) / np.linalg.norm(b - a)
        cols.append(np.tile((d + 1.0) / 2.0, (n_per_edge, 1)))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(cols).astype(np.float32))


@pytest.mark.parametrize("growth", ["python", "native"])
def test_edge_fit_matches_jax(growth, tmp_path, monkeypatch):
    """edge_fit on the same cloud: the Python growth below 2000
    downsampled points, the native C++ growth (the port's own build of the
    same source) above. The JAX package's loader builds its library in
    place and takes the Python growth when that fails, so here it builds a
    private copy, out of reach of other test processes' builds."""
    from emap_tpu.native import loader as jloader

    monkeypatch.setattr(jloader, "_LIB", str(tmp_path / "emap_native.so"))
    monkeypatch.setattr(jloader, "_lib", None)
    monkeypatch.setattr(jloader, "_build_failed", False)
    assert jloader.native_available()
    if growth == "python":
        pts, cols = cube_cloud(40)
        resolution = 128
    else:
        pts, cols = cube_cloud(600)
        resolution = 1024
    want = jfit.edge_fit(pts, cols, resolution, seed=7)
    got = tfit.edge_fit(pts, cols, resolution, seed=7)
    n_ds = len(jfit.voxel_downsample_with_colors(pts, cols,
                                                 2.0 / resolution)[0])
    assert (n_ds > 2000) == (growth == "native")
    assert got == want
    assert len(got["lines_end_pts"]) >= 12


def test_merge_and_parametric_edge_match_jax(tmp_path):
    pts, cols = cube_cloud(40, seed=1)
    fitted = jfit.edge_fit(pts, cols, 128)
    for kw in ({}, {"merge_curve_flag": True,
                    "merge_endpoints_distance_threshold": 2.0}):
        assert tmerge.merge(fitted, **kw) == jmerge.merge(fitted, **kw)
    scan = make_synthetic_scene(str(tmp_path), n_views=4, H=48, W=48)
    for visible in (False, True):
        pj, dj = jparam.get_parametric_edge(pts, cols, 128, "DexiNed", scan,
                                            visible_checking=visible)
        pt, dt = tparam.get_parametric_edge(pts, cols, 128, "DexiNed", scan,
                                            visible_checking=visible)
        np.testing.assert_array_equal(pt, pj)
        assert dt == dj


@pytest.mark.parametrize("ascii_format", [True, False])
def test_ply_bytes_match_jax(tmp_path, ascii_format):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (57, 3))
    for colors in (None, cols):
        a, b = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
        jply.write_ply_points(a, pts, colors, ascii_format=ascii_format)
        tply.write_ply_points(b, pts, colors, ascii_format=ascii_format)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        p, c = tply.read_ply_points(b)
        np.testing.assert_allclose(p, pts, rtol=1e-9)
        if colors is not None:
            np.testing.assert_allclose(c, np.round(cols * 255) / 255)


@pytest.fixture(scope="module")
def cube_scene(tmp_path_factory):
    """A cube scene written by the JAX package (cv2-drawn maps)."""
    data_dir = str(tmp_path_factory.mktemp("cube_scene"))
    return make_synthetic_scene(data_dir, n_views=6, H=96, W=96)


def test_edge_maps_read_as_cv2_reads_them(cube_scene):
    cv2 = pytest.importorskip("cv2")

    for d in ("edge_DexiNed", "color"):
        for name in sorted(os.listdir(os.path.join(cube_scene, d))):
            p = os.path.join(cube_scene, d, name)
            np.testing.assert_array_equal(read_png(p, gray=True),
                                          cv2.imread(p, 0))


def test_score_edges_match_jax(cube_scene):
    """The 2D score (chamfer transform included) and the 3D score of true,
    displaced and empty wireframes."""
    from emap_tpu.data.synthetic import sample_cube_edge_points

    probe = sample_cube_edge_points(0.5, spacing=0.01)
    for lines in (cube_edges(0.5), cube_edges(0.5)[:5] + 0.02,
                  np.zeros((0, 2, 3))):
        ed = {"curves_ctl_pts": [],
              "lines_end_pts": lines.reshape(-1, 6).tolist()}
        assert tat.score_edges_2d(ed, cube_scene, "DexiNed") == \
            jat.score_edges_2d(ed, cube_scene, "DexiNed")
        assert tat.score_edges_3d(ed, probe) == jat.score_edges_3d(ed, probe)


def test_chamfer_distance_matches_cv2():
    """OpenCV's 3x3 chamfer (not the exact Euclidean transform) on random
    masks: values to 1e-5 relative (float64 sums against OpenCV's float32)
    and identical <= 3.0 masks, the scorer's test."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    for _ in range(12):
        h, w = rng.integers(3, 90, 2)
        m = (rng.random((h, w)) > rng.choice([0.002, 0.05, 0.5])).astype(
            np.uint8)
        m[rng.integers(h), rng.integers(w)] = 0
        want = cv2.distanceTransform(m, cv2.DIST_L2, 3)
        got = tat.chamfer_distance(m)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got <= 3.0, want <= 3.0)


def _fixture_rows():
    out = []
    for fn in sorted(os.listdir(FIXTURES)):
        with open(os.path.join(FIXTURES, fn)) as f:
            table = json.load(f)
        for res in table["results"]:
            out.append((fn, res["rows"], table.get("default_threshold")))
    return out


@pytest.mark.parametrize("default_thr", [None, 0.02])
def test_picks_match_jax_on_archived_tables(default_thr):
    """pick_candidate and pick_candidate_draws pick the same row as the JAX
    package on every archived selector table."""
    rows_all = _fixture_rows()
    assert len(rows_all) >= 30
    for fn, rows, table_thr in rows_all:
        thr = table_thr if table_thr is not None else default_thr
        assert tat.pick_candidate(rows, default_thr=thr) == \
            jat.pick_candidate(rows, default_thr=thr), fn
        if any("fit_seed" in r for r in rows):
            assert tat.pick_candidate_draws(rows, default_thr=thr) == \
                jat.pick_candidate_draws(rows, default_thr=thr), fn


def test_certify_probe_matches_jax():
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(500, 3)).astype(np.float32)
    for scale in (1e-3, 1e-2, 0.2):
        vals = np.abs(rng.normal(0, scale, 500)).astype(np.float32)
        vals[3] = np.nan
        np.testing.assert_array_equal(
            tat._certify_probe(xyz, vals, 2e-3, 0.05, max_points=100),
            jat._certify_probe(xyz, vals, 2e-3, 0.05, max_points=100))


# -- the runner: extract_edge and validate ---------------------------------

def _conf(tmp_path, **overrides):
    data_dir = str(tmp_path / "data")
    make_synthetic_scene(data_dir, scan="cube000", n_views=3, H=32, W=40)
    conf = config.parse_file(os.path.join(os.path.dirname(os.path.dirname(
        __file__)), "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = str(tmp_path / "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    conf["train.batch_size"] = 64
    for k, v in NET.items():
        conf[f"model.udf_network.{k}"] = list(v) if k == "skip_in" else v
    conf["model.udf_renderer.n_samples"] = 8
    conf["model.udf_renderer.n_importance"] = 5
    for k, v in overrides.items():
        conf[k] = v
    path = str(tmp_path / "tiny.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def test_runner_extract_edge_end_to_end(tmp_path, circle):
    """`--mode extract_edge` on the CPU from an .npz written by the
    converter: the four result files, and the points lie on the field's
    zero set. The selector runs as the ABC conf sets it (4 thresholds, 2
    fit draws here)."""
    from emap_tpu_torch.train.runner import Runner

    _, _, _, tp = circle
    path = _conf(tmp_path, **{"edge_extraction.resolution": 32,
                              "edge_extraction.sampling_N": 8,
                              "edge_extraction.fit_draws": 2})
    trainer = Runner(config.parse_file(path), "train", device="cpu")
    trainer.state.params["udf"] = tp
    save_pytree(os.path.join(trainer._ckpt_dir(), "ckpt_best.npz"),
                checkpoint_payload(trainer.state, 0.1))
    runner = cli.main(["--conf", path, "--mode", "extract_edge",
                       "--device", "cpu"])
    res = os.path.join(runner.base_exp_dir, "results")
    assert sorted(os.listdir(res)) == [
        "edge_points.ply", "parametric_edges.json", "threshold_selection.json",
        "udf_pointcloud_withdirection.ply"]
    cloud, colors = tply.read_ply_points(
        os.path.join(res, "udf_pointcloud_withdirection.ply"))
    assert len(cloud) > 50 and colors is not None
    assert np.median(circle_udf(cloud)) < 0.05
    with open(os.path.join(res, "threshold_selection.json")) as f:
        sel = json.load(f)
    assert sel["picked"] in (0.02, 0.03, 0.04, 0.05)
    assert len(sel["candidates"]) == 8 and sel["fit_draws"] == 2
    stages = [t["stage"] for t in runner.extract_trace]
    assert stages.count("grid") == 2 and "certify" in stages
    assert stages.count("fit") == 8 and stages[-1] == "fit_score"


def test_runner_extract_edge_platform_key(tmp_path, circle):
    """edge_extraction.platform: "cpu" extracts on the CPU through the
    kernels' plain versions (no launch counted) and writes the four files;
    any value other than "" and "cpu" raises."""
    from emap_tpu_torch.train.runner import Runner

    _, _, _, tp = circle
    path = _conf(tmp_path)
    trainer = Runner(config.parse_file(path), "train", device="cpu")
    trainer.state.params["udf"] = tp
    save_pytree(os.path.join(trainer._ckpt_dir(), "ckpt_best.npz"),
                checkpoint_payload(trainer.state, 0.1))

    runner = Runner(config.parse_file(path), "extract_edge", device="cpu")
    with pytest.raises(ValueError, match="platform"):
        runner.extract_edge(platform="tpu")
    launches = (tq.value.launches, tq.value_and_grad.launches)
    # one threshold, two fit draws: the selector runs and writes its table
    runner.extract_edge(resolution=24, udf_threshold=0.03, sampling_N=5,
                        is_pointshift=True, iters=1, is_linedirection=True,
                        platform="cpu", fit_draws=2)
    assert (tq.value.launches, tq.value_and_grad.launches) == launches
    assert sorted(os.listdir(os.path.join(runner.base_exp_dir, "results"))) \
        == ["edge_points.ply", "parametric_edges.json",
            "threshold_selection.json", "udf_pointcloud_withdirection.ply"]
    assert [t["stage"] for t in runner.extract_trace][:2] == ["grid", "sweep"]


def test_validate_matches_jax_render(tmp_path):
    """One view rendered by the port's validate path against the JAX
    runner's _build_render_chunk on the same weights and rays, with
    perturb = 0 (the stratified samples are then fixed); then the three
    PNGs the port writes."""
    from emap_tpu.data.dataset import gen_rays_at
    from emap_tpu.train import runner as jrunner
    from emap_tpu_torch.train.runner import Runner

    path = _conf(tmp_path, **{
        "model.udf_renderer.perturb": 0.0,
        "model.udf_network.precision": "highest",
        "model.udf_renderer.sampler_precision": "highest",
        "model.udf_renderer.field_precision": "highest"})
    jr = jrunner.Runner(jconfig.parse_file(path), "train")
    tr = Runner(config.parse_file(path), "train", device="cpu")
    tr.state.params = params_from_numpy(
        jax.tree.map(np.asarray, jr.state.params), tr.ucfg, device="cpu")
    idx, level = 1, 1
    edge, depth, normals = tr.render_image(idx, level)
    h, w = edge.shape
    assert (h, w) == (32, 40) and normals.shape == (h * w, 3)

    rays_o, rays_d, ds = gen_rays_at(jr.scene, idx, level)
    fn = jr._build_render_chunk(jr.batch_size)
    b = jr.batch_size
    assert (h * w) % b == 0  # no padding: both sides see the same chunks
    out = {k: [] for k in ("edge", "depth", "normals")}
    for c in range(0, h * w, b):
        res = fn(jr.state.params, jnp.asarray(rays_o.reshape(-1, 3)[c:c + b]),
                 jnp.asarray(rays_d.reshape(-1, 3)[c:c + b]),
                 jnp.asarray(ds.reshape(-1, 1)[c:c + b]),
                 jax.random.key(0), jnp.float32(0.0))
        for k in out:
            out[k].append(np.asarray(res[k]))
    want = {k: np.concatenate(v) for k, v in out.items()}
    # the tolerance of test_torch_render.py::test_render_matches: the
    # sampler's z values agree to 2e-4, which moves the composited sums by
    # up to ~5e-4 of their largest entry (measured on the normals)
    for k, got in (("edge", edge), ("depth", depth), ("normals", normals)):
        ref = want[k].reshape(got.shape)
        np.testing.assert_allclose(got, ref, rtol=1e-3,
                                   atol=1e-3 * np.abs(ref).max(), err_msg=k)

    paths = tr.validate(idx=idx)
    shapes = {"edge_maps": (2 * h, w, 3), "normals": (h, w, 3),
              "depths": (h, w, 3)}
    for kind, p in paths.items():
        assert os.path.basename(p) == f"00000000_{idx}.png"
        assert read_png(p).shape == shapes[kind]
    gt = read_png(paths["edge_maps"])[h:, :, 0]
    np.testing.assert_array_equal(
        gt, (tr.scene.edges[idx] * 255.0).astype(np.uint8))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_edge_at_matches_cv2_resize(tmp_path, level):
    """The ground-truth panel of a validation image: cv2.resize's own size
    at level 1 (bit for bit), within one grey level of its INTER_LINEAR
    above."""
    cv2 = pytest.importorskip("cv2")
    from emap_tpu_torch.data.dataset import edge_at, load_scene

    path = _conf(tmp_path)
    scene = load_scene(config.parse_file(path).get_config("dataset"))
    for idx in range(scene.n_images):
        edge = (scene.edges[idx] * 255.0).astype(np.uint8)
        h, w = scene.H // level, scene.W // level
        want = cv2.resize(edge, (w, h)).clip(0, 255)
        got = edge_at(scene, idx, level)
        assert got.shape == want.shape == (h, w)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= (0 if level == 1 else 1)


def test_visualize_depth_matches_cv2():
    """The JET table byte for byte against cv2, and the whole depth image
    against the JAX package's (which calls cv2)."""
    cv2 = pytest.importorskip("cv2")
    from emap_tpu.utils.vis import visualize_depth as jvis

    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_JET)[:, 0, :]
    np.testing.assert_array_equal(JET_BGR, lut)
    depth = np.random.default_rng(8).uniform(0.5, 4.0, (30, 41))
    depth[0, 0] = np.nan
    np.testing.assert_array_equal(visualize_depth(depth), jvis(depth))
