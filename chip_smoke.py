#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (emap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from emap_tpu_torch/csrc with nvcc, in parallel,
     and count the tensor-core instructions (HMMA) in every kernel
     library's SASS;
  3. hold each kernel against its plain PyTorch version on the card, output
     block by block, and time both at the shapes its path gives it, beside
     the reckoned bounds (fp32 FMA; the tensor cores at one TF32 pass and
     at the design's three) and the achieved rate: the training query and backward at the step's
     N = 1024 rays x 114 samples = 116,736 points, and the extraction's
     grid value query at its two launch shapes, a 128^3 grid pass
     (2,097,152 points, the ABC conf) and one GRID_CHUNK of a 256^3 pass
     (4,194,304 points, the DTU and Replica confs); two launches of each
     kernel on the same inputs must agree bit for bit;
  4. write a synthetic cube scene and a copy of confs/ABC.conf pointing at
     it, train END_ITER steps at full ABC width through
     `emap_tpu_torch.cli.main(... --mode train)` with one validation at the
     last step, check that the training kernels launched once per step
     (the forward once more per validation chunk), that every loss is
     finite, that the three validation images decode at the view's size,
     that the checkpoint reloads, and that the first step's loss and
     gradients match the plain autograd path from the same state and batch;
  5. the step on the kernels against the step on the plain autograd path,
     and a profiler breakdown of two steps by kernel;
  6. regress the ABC-width field onto the analytic UDF of the cube's 12
     edges, save it as the run's checkpoint and run
     `emap_tpu_torch.cli.main(... --mode extract_edge)` with the ABC conf's
     edge_extraction block unchanged, after counting, for each candidate
     threshold, the grid points whose near-surface masks differ between the
     grid value kernel and its plain version; check that the extraction kernels
     launched as often as the candidate counts reckon, that the four result
     files exist, and that the fitted edges lie on the cube's edges; then
     hold the sliced value-and-gradient query against its plain version at
     the largest line-direction call of that run (a feature batch's live
     candidates x sampling_N points, launched over slices of SLICE_CAP);
     and solve the first EIGH_BATCH Gram matrices of its line-direction
     sweep again with LAPACK on the host, counting the smallest
     eigenvectors whose sign differs from cuSOLVER's (a measurement only);
  7. score phase 6's parametric_edges.json against the cube's analytic
     edges with the ABC protocol (emap_tpu_torch/eval/synthetic.py):
     F@5/10/20 mm, chamfer, the line and curve counts; F@20mm must reach
     F20_MIN.
The last two lines are the {"kernels": [...]} record and
{"ok": true, "device": {...}}. There is no CPU fallback: without CUDA the
script fails.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

END_ITER = 20
FP32_PEAK = 67e12  # H100 SXM fp32 FMA peak, FLOP/s (NVIDIA data sheet)
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core peak, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
# The training kernels run each product as three TF32 passes (3xTF32, fp32
# accuracy). Beside the row's bound_ms (fp32 FMA) the kernel line prints two
# tensor-core times for reference: the function's own, FLOP / TF32_PEAK,
# and the design's, TC_PASSES x FLOP / TF32_PEAK, which counts its passes.
TC_PASSES = 3
# Kernel vs plain version on the same inputs: 3xTF32 tensor-core products
# (fp32-accurate) summed in another order (256-long dot products in the
# forward; sums over 116,736 points in the weight gradient); measured ~2e-6
# (forward) and ~5e-6 (backward) max relative error, so 1e-4 leaves a wide
# margin while catching a wrong term.
# Each output is held block by block, each block against its own largest
# entry: udf and the spatial gradient, and each layer's weight and bias
# gradient (the packed W-bar spans 5 orders of magnitude across layers).
KERNEL_RTOL = 1e-4
# Kernel path vs autograd (cuBLAS) path through the whole step: the same
# math with other roundoff, amplified by the renderer's steep sigmoids
# and the abs head's sign; measured ~1e-5 max relative error on the first
# step. 3e-4 is the bound the JAX package's own kernel-vs-autodiff test
# holds its fused kernels to.
STEP_GRAD_RTOL = 3e-4
STEP_LOSS_RTOL = 1e-5
GRID_N = 128 ** 3  # confs/ABC.conf edge_extraction.resolution
# Phase 6's fixture: Adam steps of the field regression onto the cube's
# edge UDF, and the bar for the fitted edges: under one voxel of the
# 128^3 grid from the true edges (median).
REGRESS_STEPS = 1500
EDGE_MEDIAN_MAX = 2.0 / 127
# Grid points whose near-surface mask (udf <= threshold) may differ between
# the grid value kernel and its plain version, as a share of the grid: only
# points within the two's ~1e-6 relative roundoff of a threshold can flip.
MASK_DIFF_MAX = 1e-4
# Phase 7's bar: F@20mm of the regressed field's edges against the cube's.
# The fitted edges lie a median of under one 5 mm threshold from the cube's
# edges (phase 6), so at 20 mm nearly every point should count.
F20_MIN = 0.95


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> tuple:
    """(ms a call over `reps` calls, the output of a first, untimed call)."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, out


def errors(got: dict, want: dict) -> tuple:
    """(max abs error, worst block's max abs error / its max |want|, that
    block's name) over named blocks."""
    abs_err, rel, worst = 0.0, -1.0, ""
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        abs_err = max(abs_err, err)
        r = err / (float(w.abs().max()) + 1e-30)
        if r > rel:
            rel, worst = r, name
    return abs_err, rel, worst


def named_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in named_leaves(tree[key], f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sliced_plain(x, w, b, ucfg):
    """The plain value-and-gradient over the slicing wrapper's slices: the
    same function on the same inputs, with its residuals held for one
    slice at a time."""
    import torch

    from emap_tpu_torch.kernels import mlp_query

    cap = mlp_query.SLICE_CAP
    parts = [mlp_query.value_and_grad_plain(x[:, s: s + cap], w, b, ucfg)
             for s in range(0, x.shape[1], cap)]
    return (torch.cat([u for u, _ in parts]),
            torch.cat([g for _, g in parts], dim=1))


def raw_points(gen, count):
    import torch

    x = torch.zeros(8, count, device="cuda")
    x[:3] = torch.rand(3, count, generator=gen, device="cuda") * 2.0 - 1.0
    return x


def query_blocks(out):
    udf, grad = out
    return {"udf": udf, "grad": grad}


def kernel_row(name, kern, plain, blocks, args, ucfg, src, replaces,
               nbytes, flops) -> dict:
    """One kernel against its plain version on the same inputs, block by
    block, both timed on those inputs, beside the bound for that work."""
    import torch

    ms, got = time_ms(lambda: kern(*args, ucfg), 3)
    plain_ms, want = time_ms(lambda: plain(*args, ucfg), 2)
    got, want = blocks(got), blocks(want)
    abs_err, rel_err, worst = errors(got, want)
    t_bytes, t_ops = nbytes / HBM_RATE, flops / FP32_PEAK
    bound_ms = 1e3 * max(t_bytes, t_ops)
    tf32_ms = 1e3 * max(t_bytes, flops / TF32_PEAK)
    tc_ms = 1e3 * max(t_bytes, TC_PASSES * flops / TF32_PEAK)
    print(f"kernel {name}: max abs err {abs_err:.3e}, max rel err "
          f"{rel_err:.3e} in block {worst} of {len(want)} (tolerance "
          f"{KERNEL_RTOL:g}); {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms fp32 FMA; tensor cores {tf32_ms:.3f} ms at one "
          f"TF32 pass, {tc_ms:.3f} ms at the design's {TC_PASSES} "
          f"({flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB; "
          f"{flops / (ms * 1e9):.1f} TFLOP/s achieved), "
          f"N={args[0].shape[1]}", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          f"{name} gave non-finite values")
    check(rel_err <= KERNEL_RTOL, f"{name} disagrees with its plain "
          f"version: max rel err {rel_err:.3e} in block {worst}")
    return {
        "name": name, "route": "cuda", "source": src,
        "replaces": replaces, "launches": 0, "max_abs_err": abs_err,
        "max_rel_err": rel_err, "worst_block": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "n": args[0].shape[1],
    }


def same_bits(name, kern, args, ucfg) -> None:
    """Two launches of a kernel on the same inputs agree in every bit (no
    atomics, sums in a fixed order)."""
    import torch

    first, second = kern(*args, ucfg), kern(*args, ucfg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"kernel {name}: two launches bit-identical: {same}", flush=True)
    check(same, f"two launches of {name} on the same inputs differ")


def tensor_core_sass(names) -> None:
    """Count the tensor-core instructions (HMMA) in each library's SASS;
    fail if one has none."""
    import shutil

    from emap_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in names:
        sass = subprocess.run([tool, "-sass", build.lib_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        kinds = sorted({w for line in sass.splitlines() for w in line.split()
                        if w.startswith("HMMA")})
        count = sum(line.count("HMMA") for line in sass.splitlines())
        print(f"sass {name}: {count} HMMA instructions {kinds}", flush=True)
        check(count > 0, f"{name} has no tensor-core instruction")


def packed_weights(ucfg):
    import torch

    from emap_tpu_torch.fields.udf import init_udf_params
    from emap_tpu_torch.kernels import mlp_query

    params = init_udf_params(torch.Generator().manual_seed(0), ucfg,
                             device="cuda")
    w, b = mlp_query.pack_weights(params, ucfg)
    return w.contiguous(), b.contiguous()


def kernel_phase(ucfg, n: int) -> list:
    """The training kernels at the step's shape and the grid value kernel
    at its two launch shapes, each against its plain version."""
    import torch

    from emap_tpu_torch.extract.pointcloud import GRID_CHUNK
    from emap_tpu_torch.kernels import mlp_query, mlp_train

    w, b = packed_weights(ucfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = raw_points(gen, n)
    ubar = torch.randn(1, n, generator=gen, device="cuda")
    gbar = torch.zeros(8, n, device="cuda")
    gbar[:3] = torch.randn(3, n, generator=gen, device="cuda")
    grid_x = raw_points(gen, GRID_N)

    def value_blocks(out):
        return {"udf": out}

    def bwd_blocks(out):
        layers = mlp_query.unpack_weights(*out, ucfg)
        return {f"lin{l}/{k}": t for l, (wl, bl) in enumerate(layers)
                for k, t in (("W", wl), ("b", bl))}

    same_bits("mlp_value_and_grad", mlp_query.value_and_grad, (x, w, b),
              ucfg)
    same_bits("mlp_train_bwd", mlp_train.train_bwd, (x, w, b, ubar, gbar),
              ucfg)
    same_bits("mlp_value", lambda *a: (mlp_query.value(*a),), (grid_x, w, b),
              ucfg)
    f32 = 4
    pack_bytes = f32 * (w.numel() + b.numel())

    def value_row(points):
        count = points.shape[1]
        return kernel_row("mlp_value", mlp_query.value, mlp_query.value_plain,
                          value_blocks, (points, w, b), ucfg,
                          "emap_tpu_torch/csrc/mlp_value.cu",
                          "emap_tpu/kernels/mlp_query.py:328",
                          f32 * (8 * count + count) + pack_bytes,
                          mlp_query.value_flops(ucfg) * count)

    rows = [
        kernel_row("mlp_value_and_grad", mlp_query.value_and_grad,
                   mlp_query.value_and_grad_plain, query_blocks, (x, w, b),
                   ucfg, "emap_tpu_torch/csrc/mlp_query.cu",
                   "emap_tpu/kernels/mlp_query.py:363",
                   f32 * (8 * n + n + 8 * n) + pack_bytes,
                   mlp_query.query_flops(ucfg) * n),
        kernel_row("mlp_train_bwd", mlp_train.train_bwd,
                   mlp_train.train_bwd_plain, bwd_blocks,
                   (x, w, b, ubar, gbar), ucfg,
                   "emap_tpu_torch/csrc/mlp_train.cu",
                   "emap_tpu/kernels/mlp_train.py:417",
                   f32 * (8 * n + n + 8 * n) + 2 * pack_bytes,
                   mlp_train.train_bwd_flops(ucfg) * n),
        value_row(grid_x),
    ]
    # one GRID_CHUNK of a 256^3 pass: printed beside its bounds; the kernels
    # line keeps the ABC pass, the shape this run's extraction launches
    value_row(raw_points(gen, GRID_CHUNK))
    return rows


def sliced_row(ucfg, n: int) -> dict:
    """The sliced value-and-gradient query at n points (one line-direction
    call of the extraction) against its plain version."""
    import torch

    from emap_tpu_torch.kernels import mlp_query

    w, b = packed_weights(ucfg)
    x = raw_points(torch.Generator(device="cuda").manual_seed(2), n)
    f32 = 4
    return kernel_row(
        "mlp_value_and_grad_sliced", mlp_query.value_and_grad_sliced,
        sliced_plain, query_blocks, (x, w, b), ucfg,
        "emap_tpu_torch/csrc/mlp_query.cu",
        "emap_tpu/kernels/mlp_query.py:363",
        f32 * (8 * n + n + 8 * n + w.numel() + b.numel()),
        mlp_query.query_flops(ucfg) * n)


def write_run_conf(tmp: str) -> str:
    """A copy of confs/ABC.conf training END_ITER steps on a synthetic cube
    written by the port's scene writer (the JAX package's cv2 lines, pixel
    for pixel, in the port's own PNG codec)."""
    from emap_tpu_torch import config
    from emap_tpu_torch.data import make_synthetic_scene

    data_dir = os.path.join(tmp, "data")
    make_synthetic_scene(data_dir, scan="cube000", n_views=24, H=400, W=400)
    conf = config.parse_file(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = os.path.join(tmp, "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    conf["train.end_iter"] = END_ITER
    conf["train.report_freq"] = 5
    conf["train.save_freq"] = 10
    conf["train.val_freq"] = END_ITER
    path = os.path.join(tmp, "ABC_smoke.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def first_step_check(conf_path: str, cli_loss: float) -> None:
    """The first step's loss and grads from a fresh state: kernel path vs
    the CLI's first step and vs the plain autograd path."""
    import dataclasses

    import torch

    from emap_tpu_torch import config
    from emap_tpu_torch.data.dataset import sample_rays
    from emap_tpu_torch.train.runner import Runner
    from emap_tpu_torch.train.step import image_index, loss_and_grads

    runner = Runner(config.parse_file(conf_path), "train", device="cuda")
    st, tcfg = runner.state, runner.tcfg
    batch = sample_rays(runner.pool, image_index(st, runner.scene.n_images),
                        st.generator, tcfg.batch_size,
                        importance_sample=tcfg.importance_sample)
    gen_state = st.generator.get_state()
    loss_k, _, grads_k = loss_and_grads(st.params, batch, 0, st.generator,
                                        tcfg, runner.rcfg, runner.ucfg)
    st.generator.set_state(gen_state)
    plain_cfg = dataclasses.replace(runner.ucfg, pallas_train="off")
    loss_p, _, grads_p = loss_and_grads(st.params, batch, 0, st.generator,
                                        tcfg, runner.rcfg, plain_cfg)
    loss_k, loss_p = float(loss_k), float(loss_p)
    gk, gp = named_leaves(grads_k), named_leaves(grads_p)
    _, grad_rel, worst = errors(gk, gp)
    print(f"first step: CLI loss {cli_loss:.7f}, kernel path {loss_k:.7f}, "
          f"autograd path {loss_p:.7f}; grads max rel err {grad_rel:.3e} in "
          f"{worst} (tolerance {STEP_GRAD_RTOL:g})", flush=True)
    check(abs(loss_k - cli_loss) <= STEP_LOSS_RTOL * abs(cli_loss),
          "the CLI's first step differs from the kernel path's replay")
    check(abs(loss_k - loss_p) <= STEP_LOSS_RTOL * abs(loss_p),
          "kernel-path loss differs from the autograd path")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values()),
          "non-finite gradients")
    check(grad_rel <= STEP_GRAD_RTOL,
          f"kernel-path grads differ from autograd: {grad_rel:.3e}")


def step_phase(runner, smi: str) -> None:
    """The step on the kernels vs the step on the plain autograd path (in
    turns, kernel-plain-plain-kernel), then device time by kernel over two
    kernel-path steps from torch.profiler. These steps continue training
    the runner's state; the launch counts were read before."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from emap_tpu_torch.train.step import build_train_step

    def steps(ucfg):
        return build_train_step(runner.tcfg, runner.rcfg, ucfg,
                                runner.scene.n_images)

    fns = {"kernels": steps(runner.ucfg), "plain": steps(
        dataclasses.replace(runner.ucfg, pallas_train="off"))}
    times = {"kernels": [], "plain": []}
    for name in ("kernels", "plain", "plain", "kernels"):
        fns[name](runner.state, runner.pool)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fns[name](runner.state, runner.pool)
        torch.cuda.synchronize()
        times[name].append(1e3 * (time.perf_counter() - t0) / 5)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"step: kernels {times['kernels']} ms, plain autograd "
          f"{times['plain']} ms per step on {smi}", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fns["kernels"](runner.state, runner.pool)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 2e3
    print(f"profile: {busy_ms:.2f} ms/step of kernel time on the device, "
          f"{len(kernels)} kernel names, "
          f"{sum(e.count for e in kernels) // 2} launches/step; idle share "
          f"{1.0 - busy_ms / ms['kernels']:.3f} of the un-profiled "
          f"{ms['kernels']:.2f} ms/step", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"profile:   {dev_us(e) / 2e3:9.3f} ms/step  "
              f"{e.count // 2:5d}/step  {e.key[:100]}", flush=True)


def validation_check(runner, h: int, w: int, smi: str) -> None:
    """The CLI run's validation images decode at the view's size and the
    rendered edge map is not constant; then one more validation, timed."""
    import glob

    import torch

    from emap_tpu_torch.data.png import read_png

    shapes = {"edge_maps": (2 * h, w, 3), "normals": (h, w, 3),
              "depths": (h, w, 3)}
    for kind, shape in shapes.items():
        files = glob.glob(os.path.join(runner.base_exp_dir, kind,
                                       f"{END_ITER:08d}_*.png"))
        check(len(files) == 1, f"{kind}: {len(files)} images of step "
              f"{END_ITER}")
        img = read_png(files[0])
        check(img.shape == shape, f"{kind} image is {img.shape}, not {shape}")
        if kind == "edge_maps":
            rendered = img[:h, :, 0]
            check(int(rendered.max()) > int(rendered.min()),
                  "the rendered edge map is constant")
            print(f"validate: rendered edge map spans {rendered.min()}-"
                  f"{rendered.max()}, mean {rendered.mean():.1f}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.validate(idx=0)
    torch.cuda.synchronize()
    print(f"validate: one {h}x{w} view in {time.perf_counter() - t0:.2f} s "
          f"({-(-h * w // runner.batch_size)} chunks of "
          f"{runner.batch_size} rays) on {smi}", flush=True)


def cube_edge_distance(pts, edges):
    """Distance of each point (N, 3) to the nearest of the segments
    (S, 2, 3), all torch tensors on one device."""
    import torch

    a, b = edges[:, 0], edges[:, 1]
    ab = b - a
    t = torch.clamp(((pts[:, None] - a[None]) * ab[None]).sum(-1)
                    / (ab * ab).sum(-1)[None], 0.0, 1.0)
    closest = a[None] + t[..., None] * ab[None]
    return torch.linalg.norm(pts[:, None] - closest, dim=-1).min(dim=1)[0]


def regress_cube_field(ucfg):
    """The ABC-width field regressed onto the analytic UDF of the cube's 12
    edges by plain autograd and Adam: uniform samples in [-1, 1]^3 and
    samples within 0.1 of the edges, from a seed."""
    import torch

    from emap_tpu_torch.data.synthetic import cube_edges
    from emap_tpu_torch.fields.udf import init_udf_params, udf_value

    gen = torch.Generator(device="cuda").manual_seed(3)
    params = init_udf_params(torch.Generator().manual_seed(0), ucfg,
                             device="cuda")
    leaves = [t.requires_grad_(True) for layer in params.values()
              for t in layer.values()]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, REGRESS_STEPS,
                                                       eta_min=5e-5)
    edges = torch.as_tensor(cube_edges(0.5), dtype=torch.float32,
                            device="cuda")
    for step in range(REGRESS_STEPS):
        uni = torch.rand(4096, 3, generator=gen, device="cuda") * 2.0 - 1.0
        seg = edges[torch.randint(0, 12, (4096,), generator=gen,
                                  device="cuda")]
        t = torch.rand(4096, 1, generator=gen, device="cuda")
        near = seg[:, 0] + t * (seg[:, 1] - seg[:, 0]) + 0.1 * torch.randn(
            4096, 3, generator=gen, device="cuda") * torch.rand(
            4096, 1, generator=gen, device="cuda")
        pts = torch.cat([uni, near])
        loss = torch.mean((udf_value(params, pts, ucfg)
                           - cube_edge_distance(pts, edges)) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
    print(f"extract: cube field regressed in {REGRESS_STEPS} Adam steps, "
          f"final loss {float(loss.detach()):.3e}", flush=True)
    return {k: {n: t.detach() for n, t in layer.items()}
            for k, layer in params.items()}


def mask_disagreement(params, ucfg, res: int, thresholds) -> None:
    """For each candidate threshold, the grid points whose near-surface mask
    (max(udf, 0) <= t, as extract/pointcloud.py::grid_masks makes it)
    differs between the grid value kernel and its plain version on the same
    field and grid; fails above MASK_DIFF_MAX of the grid."""
    import torch

    from emap_tpu_torch.extract.pointcloud import grid_points
    from emap_tpu_torch.kernels import mlp_query

    count = res ** 3
    w, b = (t.contiguous() for t in mlp_query.pack_weights(params, ucfg))
    x = torch.zeros(8, count, device="cuda")
    x[:3] = grid_points(0, count, res, "cuda").T
    got = torch.clamp(mlp_query.value(x, w, b, ucfg), min=0.0)
    want = torch.clamp(mlp_query.value_plain(x, w, b, ucfg), min=0.0)
    diffs = {t: int(((got <= t) != (want <= t)).sum()) for t in thresholds}
    print(f"extract: grid points of {count:,} whose mask differs between "
          f"the grid value kernel and its plain version, by threshold: "
          f"{diffs} (bar {MASK_DIFF_MAX * count:.0f})", flush=True)
    check(max(diffs.values()) <= MASK_DIFF_MAX * count,
          f"the grid value kernel's masks differ from its plain version's "
          f"at {max(diffs.values())} grid points")
    # the plain pass leaves ~10 GB in PyTorch's cache; hand it back so the
    # extraction starts from the memory state it would have without it
    del x, got, want
    torch.cuda.empty_cache()


def extract_phase(conf_path: str, ucfg, row_of: dict, smi: str) -> dict:
    """Phase 6: `--mode extract_edge` with the ABC conf's edge_extraction
    block on the regressed cube field; the launches against a reckoning
    from the trace's candidate counts, the result files, the geometry.
    Returns the sliced value-and-gradient kernel's row, checked at the
    largest line-direction call of the run."""
    import numpy as np
    import torch

    from emap_tpu_torch import cli, config
    from emap_tpu_torch.ckpt.convert import checkpoint_payload
    from emap_tpu_torch.ckpt.native import save_pytree
    from emap_tpu_torch.data.synthetic import cube_edges
    from emap_tpu_torch.extract import pointcloud
    from emap_tpu_torch.extract.pointcloud import GRID_CHUNK, POINT_BATCH
    from emap_tpu_torch.kernels import mlp_query, mlp_train
    from emap_tpu_torch.train.runner import Runner
    from emap_tpu_torch.utils.ply import read_ply_points

    t0 = time.perf_counter()
    params = regress_cube_field(ucfg)
    conf = config.parse_file(conf_path)
    trainer = Runner(conf, "train", device="cuda")
    trainer.state.params["udf"] = params
    ckpt = os.path.join(trainer._ckpt_dir(), "ckpt_best.npz")
    save_pytree(ckpt, checkpoint_payload(trainer.state, 0.01))
    del trainer
    print(f"extract: fixture and checkpoint in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)

    ee = conf.get_config("edge_extraction")
    res, n_jitter = ee.get_int("resolution"), ee.get_int("sampling_N")
    mask_disagreement(params, ucfg, res,
                      [float(t) for t in ee.get_list("auto_threshold")])
    # what sets the peak: how far each device stage raises the running peak
    rises = {}

    def watched(fn):
        def run(*args, **kwargs):
            stage = ("grid" if fn is grid else
                     "sweep with line directions" if args[7] else "sweep")
            torch.cuda.synchronize()
            before = torch.cuda.max_memory_allocated()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rises[stage] = (rises.get(stage, 0)
                            + torch.cuda.max_memory_allocated() - before)
            return out
        return run

    grid, batches = pointcloud.grid_masks, pointcloud._run_point_batches
    pointcloud.grid_masks = watched(grid)
    pointcloud._run_point_batches = watched(batches)
    # the first Gram matrices the line-direction sweep hands to eigh
    eigh, grams = torch.linalg.eigh, []

    def recording_eigh(m, *args, **kwargs):
        if not grams:
            grams.append(m.detach().clone())
        return eigh(m, *args, **kwargs)

    torch.linalg.eigh = recording_eigh
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rises["held before the extraction"] = torch.cuda.memory_allocated()
    mlp_query.value.launches = 0
    mlp_query.value_and_grad.launches = 0
    mlp_train.train_bwd.launches = 0
    t0 = time.perf_counter()
    try:
        runner = cli.main(["--conf", conf_path, "--mode", "extract_edge"])
        torch.cuda.synchronize()
    finally:
        pointcloud.grid_masks, pointcloud._run_point_batches = grid, batches
        torch.linalg.eigh = eigh
    wall = time.perf_counter() - t0
    launches = {"mlp_value": mlp_query.value.launches,
                "mlp_value_and_grad_sliced":
                    mlp_query.value_and_grad.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(mlp_train.train_bwd.launches == 0, "extraction ran the backward")
    rises["elsewhere"] = peak * 2 ** 30 - sum(rises.values())
    print("extract: peak device memory by what raised it, GiB: "
          + ", ".join(f"{k} {v / 2 ** 30:.3f}" for k, v in rises.items()),
          flush=True)
    # the line-direction sweep's batched eigh alone, at the sweep's batch
    a = torch.randn(pointcloud.EIGH_BATCH, 3, 3, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    gram = a @ a.mT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    torch.linalg.eigh(gram)
    torch.cuda.synchronize()
    print(f"extract: one eigh of {pointcloud.EIGH_BATCH:,} 3x3 matrices "
          f"raises the peak device memory by "
          f"{(torch.cuda.max_memory_allocated() - held) / 2 ** 30:.3f} GiB",
          flush=True)
    del a, gram

    # the reckoning: one value launch per grid chunk and per probe
    # certification; per feature batch of m live candidates one
    # value-and-gradient launch, plus one per SLICE_CAP of its m * sampling_N
    # line-direction samples (padded to the tile)
    trace = runner.extract_trace

    def linedir_points(m):
        return mlp_query.round_up(m * n_jitter, mlp_query.POINT_TILE)

    def sweep_launches(t):
        sizes = [min(POINT_BATCH, t["points"] - s)
                 for s in range(0, t["points"], POINT_BATCH)]
        return sum(1 + (-(-linedir_points(m) // mlp_query.SLICE_CAP)
                        if t["linedir"] else 0) for m in sizes)

    want_value = sum(-(-t["points"] // GRID_CHUNK) for t in trace
                     if t["stage"] == "grid") + sum(
        1 for t in trace if t["stage"] == "certify")
    sweeps = [t for t in trace if t["stage"] == "sweep"]
    want_vg = sum(sweep_launches(t) for t in sweeps)
    linedir_n = max(linedir_points(min(POINT_BATCH, t["points"]))
                    for t in sweeps if t["linedir"])
    stages = {}
    for t in trace:
        stages.setdefault(t["stage"], []).append(t)
    for name in ("grid", "sweep", "certify", "pointcloud", "probe", "fit",
                 "fit_score"):
        ts = stages.get(name, [])
        print(f"extract: stage {name}: {len(ts)} x, "
              f"{sum(t['seconds'] for t in ts):.3f} s "
              f"{[round(t['seconds'], 3) for t in ts]}"
              + (f", points {[t['points'] for t in ts]}"
                 if ts and "points" in ts[0] else ""), flush=True)
    fit_s = sum(t["seconds"] for t in stages.get("fit", []))
    print(f"extract: host fits {fit_s:.1f} s, selector scoring "
          f"{sum(t['seconds'] for t in stages['fit_score']) - fit_s:.1f} s",
          flush=True)
    print(f"extract: {wall:.1f} s through emap_tpu_torch.cli (set-up "
          f"included) on {smi}; peak device memory {peak:.2f} GiB; launches "
          f"{launches}, reckoned mlp_value {want_value}, "
          f"mlp_value_and_grad_sliced {want_vg}", flush=True)
    check(launches["mlp_value"] == want_value > 0,
          f"mlp_value launched {launches['mlp_value']} times, reckoned "
          f"{want_value}")
    check(launches["mlp_value_and_grad_sliced"] == want_vg > 0,
          f"the sliced value-and-gradient launched "
          f"{launches['mlp_value_and_grad_sliced']} times, reckoned {want_vg}")
    row_of["mlp_value"]["launches"] = launches["mlp_value"]

    results = os.path.join(runner.base_exp_dir, "results")
    for fn in ("udf_pointcloud_withdirection.ply", "edge_points.ply",
               "parametric_edges.json", "threshold_selection.json"):
        check(os.path.exists(os.path.join(results, fn)), f"no {fn}")
    cloud, _ = read_ply_points(os.path.join(results,
                                            "udf_pointcloud_withdirection.ply"))
    edge_pts, _ = read_ply_points(os.path.join(results, "edge_points.ply"))
    with open(os.path.join(results, "threshold_selection.json")) as f:
        picked = json.load(f)
    check(len(cloud) > 0 and len(edge_pts) > 0, f"empty extraction: "
          f"{len(cloud)} cloud points, {len(edge_pts)} edge points")
    check(bool(np.isfinite(edge_pts).all()), "non-finite edge points")
    dist = cube_edge_distance(
        torch.as_tensor(edge_pts, dtype=torch.float32, device="cuda"),
        torch.as_tensor(cube_edges(0.5), dtype=torch.float32, device="cuda"))
    median = float(dist.median())
    print(f"extract: {len(cloud)} cloud points, {len(edge_pts)} edge points "
          f"(picked threshold {picked['picked']}, fit seed "
          f"{picked['picked_fit_seed']}); edge points to the cube's edges: "
          f"median {median:.5f}, 90th percentile "
          f"{float(dist.quantile(0.9)):.5f} (bar {EDGE_MEDIAN_MAX:.5f}, "
          f"resolution {res})", flush=True)
    check(median < EDGE_MEDIAN_MAX, f"edge points lie {median:.5f} from the "
          f"cube's edges (median), over one voxel")
    row = sliced_row(ucfg, linedir_n)
    row["launches"] = launches["mlp_value_and_grad_sliced"]
    check(len(grams) == 1, "the extraction solved no line directions")
    eigen_signs(grams[0])
    return row


def eigen_signs(gram) -> None:
    """The smallest eigenvectors of (B, 3, 3) Gram matrices from cuSOLVER
    (on the card) against LAPACK's (torch on the host): how many point the
    other way. Printed, not held to a bar."""
    import torch

    on_card = torch.linalg.eigh(gram)[1][:, :, 0].cpu()
    on_host = torch.linalg.eigh(gram.cpu())[1][:, :, 0]
    dots = (on_card * on_host).sum(-1)
    flipped = int((dots < 0).sum())
    # |dot| well below 1: the two solvers return different directions, not
    # only different signs (a near-degenerate smallest eigenvalue)
    apart = int((dots.abs() < 0.99).sum())
    print(f"extract: line directions of the first {len(gram):,} Gram "
          f"matrices of the line-direction sweep: cuSOLVER and LAPACK "
          f"smallest eigenvectors differ in sign for {flipped:,} "
          f"({flipped / len(gram):.4f}); {apart:,} of them are more than "
          f"sign apart (|dot| < 0.99)", flush=True)


def score_phase(conf_path: str, smi: str) -> None:
    """Phase 7: phase 6's parametric edges against the cube's analytic
    edges with the ABC protocol."""
    from emap_tpu_torch import config
    from emap_tpu_torch.eval.synthetic import score_extraction

    conf = config.parse_file(conf_path)
    exp_dir = os.path.join(conf["general.base_exp_dir"],
                           str(conf["dataset.scan"]),
                           conf["general.expname"])
    with open(os.path.join(exp_dir, "results", "parametric_edges.json")) as f:
        edges = json.load(f)
    t0 = time.perf_counter()
    score = score_extraction(exp_dir, edges, "cube")
    print(f"score: the regressed cube field's edges against the cube's, "
          f"ABC protocol: F@5mm {score['fscore_0.005']}, F@10mm "
          f"{score['fscore_0.01']}, F@20mm {score['fscore_0.02']}, chamfer "
          f"{score['chamfer']} (acc {score['acc']}, comp {score['comp']}); "
          f"{score['n_lines']} lines, {score['n_curves']} curves; scored in "
          f"{time.perf_counter() - t0:.1f} s on the host of {smi}",
          flush=True)
    check(score["fscore_0.02"] >= F20_MIN, f"F@20mm {score['fscore_0.02']} "
          f"under {F20_MIN}")


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "no CUDA device: the port's smoke test "
          "runs on the GPU only")
    try:
        import emap_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: FAILED: the emap_tpu_torch package is "
                         f"not beside this script ({e})")
    logging.basicConfig(level=logging.INFO,
                        format="[%(filename)s:%(lineno)s] %(message)s")
    from emap_tpu_torch import cli, config, use_fp32_matmuls
    from emap_tpu_torch.fields.udf import UDFConfig
    from emap_tpu_torch.kernels import build, mlp_query, mlp_train
    from emap_tpu_torch.render.renderer import RenderConfig

    use_fp32_matmuls()
    smi = smi_line()
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    times = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in times.items())})",
          flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    tensor_core_sass(build.SOURCES)

    abc = config.parse_file(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "confs", "ABC.conf"))
    ucfg = UDFConfig.from_conf(abc.get_config("model.udf_network"))
    rcfg = RenderConfig.from_conf(abc.get_config("model.udf_renderer"))
    n = abc.get_int("train.batch_size") * rcfg.total_samples
    rows = kernel_phase(ucfg, n)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        conf_path = write_run_conf(tmp)
        print(f"scene + conf written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        mlp_query.value_and_grad.launches = 0
        mlp_train.train_bwd.launches = 0
        t0 = time.perf_counter()
        runner = cli.main(["--conf", conf_path, "--mode", "train"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"mlp_value_and_grad": mlp_query.value_and_grad.launches,
                    "mlp_train_bwd": mlp_train.train_bwd.launches}
        row_of = {row["name"]: row for row in rows}
        for name, count in launches.items():
            row_of[name]["launches"] = count
        # the one validation renders the view in batch_size-ray chunks, one
        # forward launch each
        h, w = (runner.scene.H // runner.validate_resolution_level,
                runner.scene.W // runner.validate_resolution_level)
        val_chunks = -(-h * w // runner.batch_size)
        print(f"train: {END_ITER} steps and one validation through "
              f"emap_tpu_torch.cli in {wall:.1f} s (set-up and first step "
              f"included); launches {launches}, {val_chunks} of them "
              f"validation chunks", flush=True)
        check(runner.state.step == END_ITER, f"trained to step "
              f"{runner.state.step}, not {END_ITER}")
        check(launches["mlp_train_bwd"] == END_ITER, "mlp_train_bwd "
              f"launched {launches['mlp_train_bwd']} times in {END_ITER} "
              "steps")
        check(launches["mlp_value_and_grad"] == END_ITER + val_chunks,
              f"mlp_value_and_grad launched "
              f"{launches['mlp_value_and_grad']} times, not {END_ITER} "
              f"steps + {val_chunks} validation chunks")
        validation_check(runner, h, w, smi)
        losses = [h["loss"] for h in runner.history]
        check(len(losses) == END_ITER and all(map(math.isfinite, losses)),
              f"non-finite or missing losses: {losses}")
        (s0, t_first), (s1, t_last) = runner.timeline[1], runner.timeline[-1]
        ms_step = 1e3 * (t_last - t_first) / (s1 - s0)
        print(f"train: {ms_step:.2f} ms/step, "
              f"{runner.batch_size * 1e3 / ms_step:.0f} rays/s over steps "
              f"{s0 + 1}-{s1} on {smi}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"losses {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

        ckpt = os.path.join(runner.base_exp_dir, "checkpoints",
                            "ckpt_best.npz")
        check(os.path.exists(ckpt), "no checkpoint written")
        runner.load_checkpoint("ckpt_best.npz")
        check(runner.state.step == END_ITER, "checkpoint reloads at step "
              f"{runner.state.step}")

        first_step_check(conf_path, losses[0])
        step_phase(runner, smi)
        rows.append(extract_phase(conf_path, ucfg, row_of, smi))
        score_phase(conf_path, smi)

    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
