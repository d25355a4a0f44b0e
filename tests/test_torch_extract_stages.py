"""The extraction's stages, one by one, in both packages on one trained toy
field: the grid masks (stage 1), the first sweep (stage 2) and the shifted
cloud (stage 3) of emap_tpu_torch/extract/pointcloud.py against the JAX
package's (emap_tpu/extract/pointcloud.py), at several thresholds, with the
grid's chunks, the sweeps' batches and the line-direction query's slices
made small enough that their boundaries fall inside a 64^3 grid.

The JAX side is `jax_stages`: extract_pointcloud_multi's orchestration with
its stage arrays kept (the layout of scripts/diag_platform.py's dumps),
held here against extract_pointcloud_multi itself. Run as a script, this
file dumps the JAX package's stages of a run's checkpoint on the CPU, the
twin of scripts/torch_extract_stages.py:

    python tests/test_torch_extract_stages.py CONF OUT_DIR [--ckpt PATH]
        [--res N] [--thresholds T,T,...] [--iters N] [--prec TIER]
        [--obj cube|rings] [--seed S] [--no-fit]

It writes OUT_DIR/stages_<t>.npz (the keys and units of
`diag_platform.py compare`) and OUT_DIR/stage_counts.json (the grid mask
count, the cloud size, lines and curves before and after the merge, the
final counts, the primitives' sample points and F@5/10/20mm from the JAX
package's fit and scoring, and |udf| at the scene's analytic edge points).
`--prec` pins the model tier ("" keeps the conf's); `--seed` is the
line-direction jitter's seed (42, the runner's, by default).
"""

import argparse
import dataclasses
import functools
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), ".."))

import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from emap_tpu.extract import pointcloud as jpc  # noqa: E402
from emap_tpu.fields import udf as judf  # noqa: E402
from emap_tpu_torch.ckpt.convert import params_from_numpy  # noqa: E402
from emap_tpu_torch.data.synthetic import cube_edges  # noqa: E402
from emap_tpu_torch.extract import pointcloud as tpc  # noqa: E402
from emap_tpu_torch.fields import udf as tudf  # noqa: E402
from emap_tpu_torch.kernels import mlp_query as tq  # noqa: E402

NET = dict(d_hidden=64, n_layers=4, skip_in=(2,), multires=4)
ZEROS = {"variance": {"variance": np.float32(0.3),
                      "second_variance": np.float32(0.3)},
         "beta": {"beta": np.float32(0.5), "gamma": np.float32(0.3),
                  "zeta": np.float32(0.3)}}
N = 64
THRESHOLDS = (0.01, 0.02, 0.04)
# a grid chunk, a sweep batch and a line-direction slice, each well under
# what a 64^3 grid and its candidates fill, so every boundary is crossed
GRID_CHUNK = 50_000
POINT_BATCH = 300
SLICE_CAP = 11 * tq.POINT_TILE


def jax_stages(params, ucfg, resolution, thresholds, sampling_N=50,
               sampling_delta=5e-3, is_pointshift=True, iters=1,
               is_linedirection=True, seed=42, grid_chunk=1 << 22,
               point_batch=4096):
    """emap_tpu/extract/pointcloud.py::extract_pointcloud_multi on the CPU
    (XLA, no Pallas), returning (clouds {t: (xyz, line_dirs)}, stages {t:
    {"cand_idx", "df0", "nrm0", "final_df"}}): the grid voxels under t, the
    first sweep's clamped udf and normals there, and the last sweep's udf
    at the cloud."""
    thresholds = sorted(float(t) for t in thresholds)
    key = jax.random.key(seed)
    total = resolution ** 3
    chunk = min(grid_chunk, total)
    chunk += (-chunk) % 8
    masks = jpc._grid_masks(params, list(range(0, total, chunk)),
                            tuple(thresholds), chunk, resolution, ucfg,
                            False)
    near = [np.unpackbits(masks[k], count=total).astype(bool)
            for k in range(len(thresholds))]
    cand_idx = np.nonzero(near[-1])[0]
    voxel = 2.0 / (resolution - 1)
    xyz = np.stack([(cand_idx // (resolution * resolution)) % resolution,
                    (cand_idx // resolution) % resolution,
                    cand_idx % resolution], axis=-1).astype(
        np.float32) * voxel - 1.0
    alive = np.stack([m[cand_idx] for m in near])

    def sweep(pts, i, with_linedir):
        return jpc._run_point_batches(
            params, ucfg, pts, jax.random.fold_in(key, i), sampling_N,
            sampling_delta, with_linedir, point_batch, False)

    want_dirs_now = is_linedirection and not (is_pointshift and iters > 0)
    df, normals, line_dirs = sweep(xyz, 0, want_dirs_now)
    df = np.maximum(df, 0.0)
    stages = {t: {"cand_idx": cand_idx[alive[k]], "df0": df[alive[k]],
                  "nrm0": normals[alive[k]]}
              for k, t in enumerate(thresholds)}
    rows = np.arange(len(cand_idx))
    if is_pointshift and iters > 0:
        for it in range(iters):
            xyz = xyz + df[:, None] * normals
            df, normals, line_dirs = sweep(xyz, it + 1,
                                           is_linedirection
                                           and it == iters - 1)
            for k, t in enumerate(thresholds):
                alive[k, rows] &= df <= t
            keep = df <= thresholds[-1]
            xyz, df, normals, line_dirs, rows = (
                xyz[keep], df[keep], normals[keep], line_dirs[keep],
                rows[keep])
    clouds = {}
    for k, t in enumerate(thresholds):
        sel = alive[k, rows]
        clouds[t] = (xyz[sel].astype(np.float32),
                     line_dirs[sel].astype(np.float32))
        stages[t]["final_df"] = df[sel]
    return clouds, stages


def nn_distances(a, b):
    """For each point of `a`, the distance to its nearest point of `b`."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros(0)
    d2 = ((a[:, None, :].astype(np.float64)
           - b[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return np.sqrt(d2.min(axis=1))


def wireframe_udf(p):
    """Distance from each point (M, 3) to the cube's 12 edges."""
    segs = cube_edges(0.5)
    a, d = segs[:, 0], segs[:, 1] - segs[:, 0]
    rel = p[:, None, :] - a[None]
    t = np.clip((rel * d[None]).sum(-1) / (d * d).sum(-1)[None], 0.0, 1.0)
    return np.linalg.norm(rel - t[..., None] * d[None], axis=-1).min(axis=1)


@pytest.fixture(scope="module")
def cube_field():
    """(JAX params, JAX cfg, port params, port cfg) at "highest": a toy net
    trained onto the UDF of the cube's wireframe, half of each batch drawn
    within 0.1 of an edge, carried across as numpy."""
    from emap_tpu.train.optim import adam_init, adam_update

    jcfg = judf.UDFConfig(precision="highest", **NET)
    params = judf.init_udf_params(jax.random.key(0), jcfg)
    opt = adam_init(params)
    lr = jax.tree.map(lambda _: jnp.float32(2e-3), params)
    mask = jax.tree.map(lambda _: jnp.float32(1.0), params)

    @jax.jit
    def step(params, opt, pts, target):
        def loss_fn(p):
            return jnp.mean(jnp.abs(judf.apply_udf(p, pts, jcfg)[:, 0]
                                    - target))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt = adam_update(params, grads, opt, lr, mask)
        return params, opt, loss

    rng = np.random.default_rng(0)
    segs = cube_edges(0.5)
    for _ in range(1500):
        seg = segs[rng.integers(0, 12, 256)]
        on = seg[:, 0] + rng.uniform(0, 1, (256, 1)) * (seg[:, 1] - seg[:, 0])
        pts = np.concatenate([on + rng.normal(0, 0.05, (256, 3)),
                              rng.uniform(-1, 1, (256, 3))]).astype(
            np.float32)
        params, opt, loss = step(params, opt, jnp.asarray(pts),
                                 jnp.asarray(wireframe_udf(pts),
                                             jnp.float32))
    assert float(loss) < 0.02
    jp = jax.tree.map(np.asarray, params)
    tcfg = tudf.UDFConfig(precision=jcfg.precision, **NET)
    tp = params_from_numpy({"udf": jp, **ZEROS}, tcfg, device="cpu")["udf"]
    return jax.tree.map(jnp.asarray, jp), jcfg, tp, tcfg


@pytest.fixture(scope="module")
def both(cube_field, request):
    """Both packages' stages at 64^3 and THRESHOLDS with small chunks,
    batches and slices, two shift iterations, at the tier named by the
    parametrisation ("highest", or "high": the port's line-direction
    queries then round their sigmoid residuals to bf16 as the JAX
    package's extraction kernel does)."""
    jp, jcfg, tp, tcfg = cube_field
    tier = getattr(request, "param", "highest")
    jcfg = dataclasses.replace(jcfg, precision=tier)
    tcfg = dataclasses.replace(tcfg, precision=tier)
    kw = dict(sampling_N=8, sampling_delta=0.01, is_pointshift=True,
              iters=2, is_linedirection=True)
    jclouds, jst = jax_stages(jp, jcfg, N, THRESHOLDS, grid_chunk=GRID_CHUNK,
                              point_batch=POINT_BATCH, **kw)
    tst: dict = {}
    trace: list = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpc, "query_value_and_grad", functools.partial(
            tq.query_value_and_grad, cap=SLICE_CAP))
        tclouds = tpc.extract_pointcloud_multi(
            tp, tcfg, N, THRESHOLDS, grid_chunk=GRID_CHUNK,
            point_batch=POINT_BATCH, trace=trace, stages=tst, **kw)
    return jclouds, jst, tclouds, tst, trace


def test_the_sizes_put_boundaries_inside_the_grid(both):
    """The grid pass takes several chunks, the superset's sweep several
    batches, and its line-direction query (batch x sampling_N points)
    several slices."""
    _, _, _, tst, trace = both
    assert N ** 3 > 5 * GRID_CHUNK
    n_super = len(tst[max(THRESHOLDS)]["cand_idx"])
    assert n_super > 3 * POINT_BATCH
    assert POINT_BATCH * 8 > 3 * SLICE_CAP
    sweeps = [t for t in trace if t["stage"] == "sweep"]
    assert [t["linedir"] for t in sweeps] == [False, False, True]


def test_jax_stages_match_extract_pointcloud_multi(cube_field):
    """The JAX side of these tests (and of the script) is the JAX package's
    own extraction: jax_stages' clouds equal extract_pointcloud_multi's."""
    jp, jcfg, _, _ = cube_field
    kw = dict(sampling_N=8, sampling_delta=0.01, is_pointshift=True,
              iters=1, is_linedirection=True, grid_chunk=GRID_CHUNK,
              point_batch=POINT_BATCH)
    clouds, stages = jax_stages(jp, jcfg, 32, THRESHOLDS, **kw)
    want = jpc.extract_pointcloud_multi(jp, jcfg, 32, THRESHOLDS,
                                        use_pallas=False, **kw)
    for t in THRESHOLDS:
        np.testing.assert_array_equal(clouds[t][0], want[t][0])
        np.testing.assert_array_equal(clouds[t][1], want[t][1])
        assert len(stages[t]["final_df"]) == len(want[t][0])


@pytest.mark.parametrize("both", ["highest", "high"], indirect=True)
@pytest.mark.parametrize("t", THRESHOLDS)
def test_stage1_grid_masks_match_jax(both, t):
    """Stage 1: the voxels under t, off JAX's by at most 0.01% of the grid
    (a voxel within float roundoff of t may fall either way)."""
    _, jst, _, tst, _ = both
    a, b = jst[t]["cand_idx"], tst[t]["cand_idx"]
    assert len(a) > 20
    flips = len(np.setxor1d(a, b))
    assert flips <= 1e-4 * N ** 3, (len(a), len(b), flips)


@pytest.mark.parametrize("both", ["highest", "high"], indirect=True)
@pytest.mark.parametrize("t", THRESHOLDS)
def test_stage2_first_sweep_matches_jax(both, t):
    """Stage 2: the first sweep's udf and normals at the common voxels."""
    _, jst, _, tst, _ = both
    common, ia, ib = np.intersect1d(jst[t]["cand_idx"], tst[t]["cand_idx"],
                                    return_indices=True)
    assert len(common) > 20
    np.testing.assert_allclose(tst[t]["df0"][ib], jst[t]["df0"][ia],
                               rtol=0, atol=1e-5)
    cos = np.abs(np.sum(tst[t]["nrm0"][ib] * jst[t]["nrm0"][ia], axis=-1))
    assert np.percentile(cos, 1) > 0.9999, np.percentile(cos, 1)


@pytest.mark.parametrize("both", ["highest", "high"], indirect=True)
@pytest.mark.parametrize("t", THRESHOLDS)
def test_stage3_cloud_matches_jax(both, t):
    """Stage 3: the shifted cloud after two iterations. Its size within
    0.5% of JAX's, and every point within 1e-4 of one of JAX's (the
    nearest-neighbour distance of diag_platform.py's stage3_cloud); the
    line directions, which come from differently drawn jitter, agree in
    direction up to their sign."""
    jclouds, jst, tclouds, tst, _ = both
    (jx, jd), (tx, td) = jclouds[t], tclouds[t]
    assert len(jx) > 20
    assert abs(len(tx) - len(jx)) <= max(1, 0.005 * len(jx)), (len(tx),
                                                                len(jx))
    assert len(tst[t]["final_df"]) == len(tx)
    assert np.all(tst[t]["final_df"] <= t)
    d_tj, d_jt = nn_distances(tx, jx), nn_distances(jx, tx)
    assert max(d_tj.max(), d_jt.max()) < 1e-4, (d_tj.max(), d_jt.max())
    assert np.median(np.abs(np.sum(td[:len(jd)] * jd[:len(td)], axis=-1))
                     ) > 0.9


# -- stage 3's line-direction sign: the reference runs' -----------------------

DIAG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "diag_platform")


def voxel_direction_loss(xyz, line_dirs, res):
    """The share of the fit's voxels (fitting.py's downsample at 2 / res)
    whose points' line directions average, through their colours, to a
    vector shorter than 0.5: directions that the averaging has lost."""
    from emap_tpu_torch.extract.fitting import voxel_downsample_with_colors

    _, colors = voxel_downsample_with_colors(xyz, (line_dirs + 1.0) / 2.0,
                                             2.0 / res)
    return float(np.mean(np.linalg.norm(colors * 2.0 - 1.0, axis=1) < 0.5))


def test_line_directions_take_the_largest_component_positive(both):
    """Every line direction the port's extraction returns has its
    largest-magnitude component positive, whichever solver (LAPACK here,
    cuSOLVER on the card) computed it."""
    _, _, tclouds, _, _ = both
    for t in THRESHOLDS:
        d = tclouds[t][1]
        assert len(d) > 20
        largest = d[np.arange(len(d)), np.abs(d).argmax(axis=1)]
        assert np.all(largest > 0), (t, float(np.mean(largest <= 0)))


@pytest.mark.parametrize("seed", [42, 3, 99])
def test_canonical_sign_gives_the_reference_runs_signs(seed):
    """The JAX package's own stage dumps of one rings field on the TPU, the
    platform of its reference runs, and on the CPU (the same candidates,
    jitter and cloud; diag_platform/rings_s<seed>_{tpu,cpu}.npz): the CPU's
    LAPACK line directions agree in sign with the TPU's at ~4 points in 5,
    and the fit's voxel averaging loses ~19% of its directions on the CPU's
    against ~3% on the TPU's. Turned by canonical_sign, the CPU's agree
    with the TPU's at >= 98% of the points and lose what the TPU's lose."""
    cpu = np.load(os.path.join(DIAG, f"rings_s{seed}_cpu.npz"))
    tpu = np.load(os.path.join(DIAG, f"rings_s{seed}_tpu.npz"))
    xyz, raw, want = cpu["xyz"], cpu["line_dirs"], tpu["line_dirs"]
    assert len(raw) == len(want) > 2000
    np.testing.assert_allclose(xyz, tpu["xyz"], atol=2e-3)
    got = tpc.canonical_sign(torch.as_tensor(raw)).numpy()
    assert np.mean(np.sum(raw * want, axis=1) > 0) < 0.9
    assert np.mean(np.sum(got * want, axis=1) > 0) >= 0.98
    lost_raw = voxel_direction_loss(xyz, raw, 96)
    lost_tpu = voxel_direction_loss(xyz, want, 96)
    lost_got = voxel_direction_loss(xyz, got, 96)
    assert lost_raw > 0.15 and lost_tpu < 0.05
    assert lost_got <= lost_tpu + 0.01, (lost_raw, lost_got, lost_tpu)


# -- the script: the JAX package's stages of a run's checkpoint -------------

def _jax_fit_counts(xyz, line_dirs, opts, data_dir, detector, fit_dir, obj):
    """The JAX package's fit, merge and visibility filter on one cloud
    (emap_tpu/extract/parametric.py::get_parametric_edge, fit seed 42) and
    its score (scripts/e2e_synthetic.py::score_extraction)."""
    from emap_tpu.extract import merging as jmerge
    from emap_tpu.extract import parametric as jparam

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    from e2e_synthetic import score_extraction

    colors = (line_dirs + 1.0) / 2.0
    fitted = jparam.edge_fit(
        xyz, colors, opts["resolution"],
        angle_threshold=jparam.ANGLE_THRESHOLD,
        nms_factor=jparam.NMS_FACTOR,
        fit_distance_threshold=jparam.FIT_DISTANCE_THRESHOLD,
        min_inliers=jparam.MIN_INLIERS, max_lines=jparam.MAX_LINES,
        max_curves=jparam.MAX_CURVES, seed=42)
    merged = jmerge.merge(
        fitted,
        merge_edge_distance_threshold=jparam.MERGE_EDGE_DISTANCE_THRESHOLD,
        merge_endpoints_distance_threshold=(
            jparam.MERGE_ENDPOINTS_DISTANCE_THRESHOLD),
        merge_similarity_threshold=jparam.MERGE_SIMILARITY_THRESHOLD)
    pred, edge_dict = jparam.get_parametric_edge(
        xyz, colors, opts["resolution"], detector, data_dir,
        visible_checking=opts["visible_checking"], seed=42)
    os.makedirs(os.path.join(fit_dir, "results"), exist_ok=True)
    with open(os.path.join(fit_dir, "results", "parametric_edges.json"),
              "w") as f:
        json.dump(edge_dict, f)
    score = score_extraction(fit_dir, edge_dict, obj)
    n_merged = len(merged["lines_end_pts"]) + len(merged["curves_ctl_pts"])
    n_kept = score["n_lines"] + score["n_curves"]
    return {
        "lines_fitted": len(fitted["lines_end_pts"]),
        "curves_fitted": len(fitted["curves_ctl_pts"]),
        "lines_merged": len(merged["lines_end_pts"]),
        "curves_merged": len(merged["curves_ctl_pts"]),
        "visibility_dropped": (n_merged - n_kept
                               if opts["visible_checking"] else None),
        "lines": score["n_lines"], "curves": score["n_curves"],
        "primitive_points": int(len(pred)),
        **{k: score[k] for k in ("fscore_0.005", "fscore_0.01",
                                 "fscore_0.02", "precision_0.005",
                                 "chamfer")},
    }


def main(argv=None) -> int:
    """Dump the JAX package's extraction stages of a run's checkpoint on the
    CPU (see the module docstring)."""
    import time

    from emap_tpu import config
    from emap_tpu.ckpt.native import load_pytree

    p = argparse.ArgumentParser(description="the JAX package's stages")
    p.add_argument("conf")
    p.add_argument("out_dir")
    p.add_argument("--ckpt", default="")
    p.add_argument("--res", type=int, default=0)
    p.add_argument("--thresholds", type=lambda s: [float(t) for t in
                                                   s.split(",")],
                   default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--prec", default="")
    p.add_argument("--obj", default="cube", choices=["cube", "rings"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-fit", dest="fit", action="store_false")
    args = p.parse_args(argv)

    conf = config.parse_file(args.conf)
    ee = conf.get_config("edge_extraction")
    thresholds = (args.thresholds or list(ee.get_list("auto_threshold", []))
                  or [ee.get_float("udf_threshold")])
    opts = {"resolution": args.res or ee.get_int("resolution"),
            "thresholds": sorted(float(t) for t in thresholds),
            "sampling_N": ee.get_int("sampling_N", 50),
            "sampling_delta": ee.get_float("sampling_delta", 5e-3),
            "is_pointshift": ee.get_bool("is_pointshift", False),
            "iters": (args.iters if args.iters is not None
                      else ee.get_int("iters", 1)),
            "is_linedirection": ee.get_bool("is_linedirection", False),
            "visible_checking": ee.get_bool("visible_checking", False)}
    ucfg = judf.UDFConfig.from_conf(conf.get_config("model.udf_network"))
    if args.prec:
        ucfg = dataclasses.replace(ucfg, precision=args.prec)
    exp_dir = os.path.join(conf["general.base_exp_dir"],
                           str(conf["dataset.scan"]),
                           conf["general.expname"])
    ckpt = args.ckpt or os.path.join(
        exp_dir, "checkpoints", conf.get_string("train.latest_model_name"))
    payload = load_pytree(ckpt)
    params = jax.tree.map(jnp.asarray, payload["params"]["udf"])
    os.makedirs(args.out_dir, exist_ok=True)

    t0 = time.perf_counter()
    clouds, stages = jax_stages(
        params, ucfg, opts["resolution"], opts["thresholds"],
        sampling_N=opts["sampling_N"], sampling_delta=opts["sampling_delta"],
        is_pointshift=opts["is_pointshift"], iters=opts["iters"],
        is_linedirection=opts["is_linedirection"], seed=args.seed)
    extract_s = time.perf_counter() - t0
    data_dir = os.path.join(conf["dataset.data_dir"],
                            str(conf["dataset.scan"]))
    rows = {}
    for t in opts["thresholds"]:
        xyz, line_dirs = clouds[t]
        st = stages[t]
        name = f"stages_{t:g}.npz"
        np.savez_compressed(
            os.path.join(args.out_dir, name), backend="jax-cpu",
            prec=ucfg.precision, quant=0.0, cand_idx=st["cand_idx"],
            df0=st["df0"], nrm0=st["nrm0"], xyz=xyz, line_dirs=line_dirs,
            final_df=st["final_df"])
        row = {"dump": name, "mask": int(len(st["cand_idx"])),
               "cloud": int(len(xyz))}
        if args.fit:
            row.update(_jax_fit_counts(
                xyz, line_dirs, opts, data_dir,
                conf.get_string("dataset.detector"),
                os.path.join(args.out_dir, f"fit_{t:g}"), args.obj))
        rows[f"{t:g}"] = row
        print(f"stages {t:g}: {json.dumps(row)}", flush=True)
    from emap_tpu.data.synthetic import (
        sample_cube_edge_points,
        sample_ring_edge_points,
    )

    gt = (sample_ring_edge_points(0.5, spacing=0.005) if args.obj == "rings"
          else sample_cube_edge_points(0.5, spacing=0.005))
    vals = np.abs(np.asarray(judf.udf_value(params, jnp.asarray(gt), ucfg)))
    gt_udf = {"mean": float(vals.mean()), "median": float(np.median(vals)),
              "p90": float(np.percentile(vals, 90)),
              "max": float(vals.max()),
              "frac_above_0.02": float((vals > 0.02).mean())}
    print(f"gt_udf: {json.dumps(gt_udf)}", flush=True)
    with open(os.path.join(args.out_dir, "stage_counts.json"), "w") as f:
        json.dump({"conf": os.path.abspath(args.conf), "checkpoint": ckpt,
                   "gt_udf": gt_udf,
                   "iter_step": int(payload["iter_step"]),
                   "backend": "jax-cpu", "precision": ucfg.precision,
                   "options": opts, "extract_seconds": extract_s,
                   "thresholds": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
