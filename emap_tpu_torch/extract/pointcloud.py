"""UDF zero-level-set point extraction (port of
emap_tpu/extract/pointcloud.py): dense grid query, gradient normals,
line directions from jittered gradients, and point shifting.

* The grid's UDF values are computed on the device in chunks of
  `grid_chunk` points through the value kernel (kernels/mlp_query.py::
  query_value) and never leave it: only the near-surface masks, one per
  threshold, come to the host.
* Candidate points are processed in batches of at most POINT_BATCH through
  the sliced value-and-gradient kernel (query_value_and_grad): udf, normals
  -g/(|g|+1e-5), and optionally line directions, the smallest-eigenvalue
  eigenvector of the 3x3 Gram matrix of the normalized gradients at
  `sampling_N` jittered samples (torch.linalg.eigh; a closed-form
  eigensolver cost F@5mm 0.62 -> 0.41 in the JAX package).
* The jitter is drawn per batch from a torch.Generator seeded from
  (seed, sweep, batch), so it does not depend on how a batch is computed.
  Torch and jax draw different numbers: line directions match the JAX
  package in distribution, not bit for bit.

On a CUDA device every field query launches a kernel; a net the kernels do
not take raises from check_kernel_cfg. On the CPU the kernels' plain
versions run.

`trace`, where given, is a list that receives one dict per device stage:
{"stage": "grid" | "sweep", "points": ..., "seconds": ...} (sweeps also
"linedir"), timed on the host clock after the results reach the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from emap_tpu_torch.fields.udf import UDFConfig
from emap_tpu_torch.kernels.mlp_query import query_value, query_value_and_grad

GRID_CHUNK = 1 << 22
# torch.linalg.eigh takes cusolverDnXsyevBatched for a batch of small
# matrices on the card, which refuses batches of 32,768 and more
# (CUSOLVER_STATUS_INVALID_VALUE; measured on the H100 with torch 2.11 and
# CUDA 12.8): the Gram matrices go to it 16,384 at a time. Each matrix is
# solved alone, so the split does not change the result.
EIGH_BATCH = 16384
# candidates a feature batch takes at most: the JAX package's kernel-path
# batch. The jitter is drawn at this size for every batch, so a candidate's
# jitter does not depend on how full its batch is.
POINT_BATCH = 65536


def params_device(params) -> torch.device:
    return params["lin0"]["b"].device


def grid_points(start: int, chunk: int, N: int, device) -> torch.Tensor:
    """Grid points for flat indices [start, start+chunk) in x-major order
    (x = idx // N^2, y = (idx // N) % N, z = idx % N), coords in [-1, 1]."""
    idx = start + torch.arange(chunk, device=device)
    z = idx % N
    y = (idx // N) % N
    x = (idx // (N * N)) % N
    voxel = 2.0 / (N - 1)
    return torch.stack([x, y, z], dim=-1).to(torch.float32) * voxel - 1.0


def grid_masks(params, ucfg: UDFConfig, N: int, thresholds,
               grid_chunk: int = GRID_CHUNK, trace=None) -> np.ndarray:
    """(K, N^3) bool near-surface masks, one per threshold, from ONE grid
    evaluation: max(udf, 0) <= t (clip to 0, then compare)."""
    t0 = time.perf_counter()
    dev = params_device(params)
    total = N ** 3
    chunk = min(grid_chunk, total)
    out = []
    for start in range(0, total, chunk):
        n = min(chunk, total - start)
        vals = torch.clamp(query_value(params, grid_points(start, n, N, dev),
                                       ucfg), min=0.0)
        out.append(torch.stack([vals <= float(t) for t in thresholds]))
    masks = torch.cat(out, dim=1).cpu().numpy()
    if trace is not None:
        trace.append({"stage": "grid", "points": total,
                      "seconds": time.perf_counter() - t0})
    return masks


def _point_batch_features(params, pts, jitter, ucfg: UDFConfig,
                          sampling_n: int, with_linedir: bool):
    """udf, normals (-unit grad) and optional line directions for a (B, 3)
    batch of points. `jitter` is the pre-scaled (B, sampling_n, 3) offsets,
    drawn by the caller."""
    udf, grad = query_value_and_grad(params, pts, ucfg)
    normals = -grad / (torch.linalg.norm(grad, dim=-1, keepdim=True) + 1e-5)
    if not with_linedir:
        return udf, normals, torch.zeros_like(pts)

    samples = pts[:, None, :] + jitter
    g = query_value_and_grad(params, samples.reshape(-1, 3), ucfg)[1]
    g = g.reshape(pts.shape[0], sampling_n, 3)
    g = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + 1e-5)
    # null space of the gradient bundle: the smallest-eigenvalue eigenvector
    # of the 3x3 Gram matrix (== the last right-singular vector of the
    # (n, 3) gradient matrix)
    gram = torch.einsum("bni,bnj->bij", g, g)
    # ascending eigenvalues: column 0 belongs to the smallest
    line_dir = torch.cat([torch.linalg.eigh(m)[1][:, :, 0]
                          for m in gram.split(EIGH_BATCH)])
    return udf, normals, line_dir / (
        torch.linalg.norm(line_dir, dim=-1, keepdim=True) + 1e-5)


def batch_seed(seed: int, sweep: int, batch: int) -> int:
    """The jitter generator's seed for one batch of one sweep."""
    return int(np.random.SeedSequence([seed, sweep, batch]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _run_point_batches(params, ucfg: UDFConfig, pts_np: np.ndarray,
                       seed: int, sweep: int, sampling_n: int,
                       sampling_delta: float, with_linedir: bool, batch: int,
                       trace=None):
    """Loop over batches of at most `batch` points, querying only the live
    rows; every batch is queued on the device before any result is
    fetched."""
    t0 = time.perf_counter()
    m = len(pts_np)
    if m == 0:
        return (np.zeros((0,), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32))
    dev = params_device(params)
    pts = torch.as_tensor(np.ascontiguousarray(pts_np, np.float32),
                          device=dev)
    pending = []
    for b, start in enumerate(range(0, m, batch)):
        chunk = pts[start: start + batch]
        jitter = None
        if with_linedir:
            gen = torch.Generator(device=dev).manual_seed(
                batch_seed(seed, sweep, b))
            jitter = sampling_delta * torch.randn(
                (batch, sampling_n, 3), generator=gen, device=dev,
                dtype=torch.float32)[:len(chunk)]
        pending.append(_point_batch_features(params, chunk, jitter, ucfg,
                                             sampling_n, with_linedir))
    udf, nrm, ld = (torch.cat([p[i] for p in pending]).cpu().numpy()
                    for i in range(3))
    if trace is not None:
        trace.append({"stage": "sweep", "points": m, "linedir": with_linedir,
                      "seconds": time.perf_counter() - t0})
    return udf, nrm, ld


def _candidates(cand_idx: np.ndarray, N: int) -> np.ndarray:
    voxel = 2.0 / (N - 1)
    return np.stack([(cand_idx // (N * N)) % N, (cand_idx // N) % N,
                     cand_idx % N], axis=-1).astype(np.float32) * voxel - 1.0


def extract_pointcloud(params, ucfg: UDFConfig, resolution: int = 128,
                       udf_threshold: float = 0.02, sampling_N: int = 50,
                       sampling_delta: float = 5e-3,
                       is_pointshift: bool = False, iters: int = 1,
                       is_linedirection: bool = False, seed: int = 42,
                       grid_chunk: int = GRID_CHUNK,
                       point_batch: int = POINT_BATCH, trace=None):
    """Edge point cloud from the UDF `params` (on the device the queries run
    on). Returns (points (M, 3), line_directions (M, 3)) numpy float32."""
    with torch.no_grad():
        return _extract(params, ucfg, resolution, [float(udf_threshold)],
                        sampling_N, sampling_delta, is_pointshift, iters,
                        is_linedirection, seed, grid_chunk,
                        int(point_batch), trace)[
            float(udf_threshold)]


def extract_pointcloud_multi(params, ucfg: UDFConfig, resolution: int,
                             thresholds, sampling_N: int = 50,
                             sampling_delta: float = 5e-3,
                             is_pointshift: bool = False, iters: int = 1,
                             is_linedirection: bool = False, seed: int = 42,
                             grid_chunk: int = GRID_CHUNK,
                             point_batch: int = POINT_BATCH, trace=None):
    """Extraction at K candidate thresholds for ONE grid + feature cost.

    Only the membership tests (grid mask, per-iteration keep) depend on the
    threshold, and for t <= t_max they are row filters of the t_max run, so
    one run at max(thresholds) with a per-candidate alive mask reproduces
    each standalone run's point set exactly; with K = 1 the result equals
    extract_pointcloud bit for bit. Returns {float(thr): (points,
    line_dirs)}."""
    with torch.no_grad():
        return _extract(params, ucfg, resolution,
                        sorted(float(t) for t in thresholds), sampling_N,
                        sampling_delta, is_pointshift, iters,
                        is_linedirection, seed, grid_chunk,
                        int(point_batch), trace)


def _extract(params, ucfg, N, thresholds, sampling_N, sampling_delta,
             is_pointshift, iters, is_linedirection, seed, grid_chunk,
             point_batch, trace):
    t_max = thresholds[-1]
    near = grid_masks(params, ucfg, N, thresholds, grid_chunk, trace)

    # superset candidates (t_max) + first feature sweep
    cand_idx = np.nonzero(near[-1])[0]
    xyz = _candidates(cand_idx, N)
    # alive[k, i]: superset row i is in candidate k's extraction so far
    alive = near[:, cand_idx]

    def sweep(pts, i, with_linedir):
        return _run_point_batches(params, ucfg, pts, seed, i, sampling_N,
                                  sampling_delta, with_linedir, point_batch,
                                  trace)

    want_dirs_now = is_linedirection and not (is_pointshift and iters > 0)
    df, normals, line_dirs = sweep(xyz, 0, want_dirs_now)
    df = np.maximum(df, 0.0)

    # shared shift trajectories toward the zero set, per-candidate keeps
    rows = np.arange(len(cand_idx))  # superset row of each live point
    if is_pointshift and iters > 0:
        for it in range(iters):
            xyz = xyz + df[:, None] * normals
            last = it == iters - 1
            df, normals, line_dirs = sweep(xyz, it + 1,
                                           is_linedirection and last)
            for k, t in enumerate(thresholds):
                alive[k, rows] &= df <= t
            keep = df <= t_max
            xyz, df, normals, line_dirs, rows = (
                xyz[keep], df[keep], normals[keep], line_dirs[keep],
                rows[keep])

    out = {}
    for k, t in enumerate(thresholds):
        sel = alive[k, rows]
        out[t] = (xyz[sel].astype(np.float32),
                  line_dirs[sel].astype(np.float32))
    return out


__all__ = ["extract_pointcloud", "extract_pointcloud_multi", "grid_masks",
           "grid_points", "GRID_CHUNK", "POINT_BATCH"]
