#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (emap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from emap_tpu_torch/csrc with nvcc, in parallel,
     print each kernel's ptxas registers and spills, hold the value
     kernels' planned registers against ptxas' report (no spill), count the
     tensor-core instructions in every kernel library's SASS: HGMMA
     (wgmma; HGMMA.*.TF32 in mlp_query_tf32, mlp_value_tf32 and
     mlp_train_tf32) in mlp_query_tf32, mlp_value_tf32, mlp_train_tf32,
     mlp_query_wgmma, mlp_train_wgmma and mlp_value_wgmma, HMMA (mma.sync)
     in the others;
  3. hold each kernel, at each matmul tier a path runs it at (KERNEL_TIERS),
     against its plain PyTorch version at that tier on the card, output
     block by block, and time both at the shapes its path gives it, beside
     the reckoned bound (the least time for fp32-accurate products, three
     TF32 passes on the tensor cores, at the fp32 tiers; bf16 tensor cores
     at the bf16 tier) and the achieved rate: the training query and
     backward at the step's
     N = 1024 rays x 114 samples = 116,736 points, and the extraction's
     grid value query at its two launch shapes, a 128^3 grid pass
     (2,097,152 points, the ABC conf) and one GRID_CHUNK of a 256^3 pass
     (4,194,304 points, the DTU and Replica confs); a bf16-tier kernel is
     also held against the fp32 plain version, and must sit nearer its own
     tier's; two launches of each kernel on the same inputs must agree bit
     for bit; #1a at the bf16 tier runs on the wgmma kernels of
     csrc/mlp_query_wgmma.cu, whose two launches (prologue, chain kernel)
     get rows of their own: device time from torch.profiler, bound, the
     chain kernel's sigmoid side-array bytes, each held against the plain
     version of that launch; #1 at the 3xTF32 tier ("high", "highest")
     runs on csrc/mlp_query_tf32.cu (wgmma .tf32 fed by TMA), whose two
     launches (prologue, chain kernel) get rows of their own likewise, the
     prologue's pre-split pack held bit for bit, and whose chain kernel is
     also held with the extraction's bf16 sigmoid residuals (against the
     plain version given the kernel's own residuals, and those within one
     bf16 rounding of the plain sigmoids); #3 at the 3xTF32 tier runs on
     csrc/mlp_value_tf32.cu (wgmma .tf32 fed by TMA), whose two launches
     (prologue, value kernel) get rows of their own likewise at both grid
     shapes, the prologue's forward-only pack held bit for bit; #3 at the
     bf16 tier runs on csrc/mlp_value_wgmma.cu (wgmma fed by TMA), whose
     two launches (prologue, value kernel) get rows of their own likewise
     at both grid shapes, the prologue's bf16 pack held bit for bit, and
     a log line with the design's reckoned floors (products, the
     softplus's special-function operations) and the plan's weight chunks
     from L2 over the launch's time; #2 at the
     (bf16, bf16) pair runs on those of
     csrc/mlp_train_wgmma.cu, whose four launches (prologue, per-point,
     GEMM, reduce) get rows of their own likewise, with the GEMM's
     library_ms (torch.bmm on the same bf16 factors); #2 at the 3xTF32 and
     mixed (3xTF32 primal, bf16 adjoint) pairs runs on those of
     csrc/mlp_train_tf32.cu (wgmma .tf32 and bf16 fed by TMA), whose
     launches (the 3xTF32 pack, at the mixed pair the bf16 pack, per-point,
     GEMM, reduce) get rows of their own likewise, the packs held bit for
     bit, with the GEMM's library_ms (torch.bmm on the same factors: fp32
     with TF32 off at the 3xTF32 pair, bf16 at the mixed one); for each,
     the mma.sync design it replaced (csrc/mlp_query.cu at the kernel's
     tier, csrc/mlp_train.cu at the kernel's pair, csrc/mlp_value.cu at
     the kernel's tier) and the wgmma kernels are timed in turns (old, new,
     new, old), and the wgmma kernels must be the faster;
  4. write a synthetic cube scene and a copy of confs/ABC.conf pointing at
     it (its tiers: the training field query and the up-sampler at the bf16
     tier "default", extraction at "high"), train END_ITER steps at full
     ABC width through
     `emap_tpu_torch.cli.main(... --mode train)` with one validation at the
     last step (the runner's default chain for these cadences, 5: a warm-up
     step and a capture, then CUDA graph replays), check that the training
     kernels ran once per step (the forward once more per validation
     chunk), reckoned from the wrappers' counts and the replays, that
     every loss is finite, that the three validation images decode at the
     view's size, that the checkpoint reloads, and that the first step's
     loss and gradients match the plain autograd path from the same state
     and batch;
  5. the eager step on the kernels against the eager step on the plain
     autograd path, and a profiler breakdown of two eager steps by kernel,
     with the host's launch calls a step;
  8. (run after 5) the CUDA graph of the step at ABC width: from one copied
     state, 2 x GRAPH_CHAIN eager steps against as many steps of the
     chained step (a warm-up step, the capture and replays), bit for bit
     in every state tensor and metric row, with `classical` and with `mix`
     up-sampling; a capture that leaves the state of one eager step; the
     replays' ms/step, and a profile of two replays (device time a step,
     idle share, the host's launch calls a step against the eager step's);
  6. regress the ABC-width field onto the analytic UDF of the cube's 12
     edges, save it as the run's checkpoint and run
     `emap_tpu_torch.cli.main(... --mode extract_edge)` with the ABC conf's
     edge_extraction block (unchanged but for one fit draw a threshold in
     place of 4: a cut of depth that keeps the run inside half its time
     with phases 10 and 11), after counting, for each candidate
     threshold, the grid points whose near-surface masks differ between the
     grid value kernel and its plain version; check that the extraction kernels
     launched as often as the candidate counts reckon, that the four result
     files exist, and that the fitted edges lie on the cube's edges; then
     hold the sliced value-and-gradient query against its plain version at
     the largest line-direction call of that run (a feature batch's live
     candidates x sampling_N points, launched over slices of SLICE_CAP);
     and solve the first EIGH_BATCH Gram matrices of its line-direction
     sweep again with LAPACK on the host, counting the smallest
     eigenvectors whose sign differs from cuSOLVER's, and holding them to
     one sign once turned as the extraction turns them (canonical_sign:
     none apart away from a tie between their two largest components);
  7. score phase 6's parametric_edges.json against the cube's analytic
     edges with the ABC protocol (emap_tpu_torch/eval/synthetic.py):
     F@5/10/20 mm, chamfer, the line and curve counts; F@20mm must reach
     F20_MIN;
  9. the routes the tier keys select, each a run of the CLI on a copy of
     the smoke conf with the keys pinned: `precision = "highest"` trains
     through plain autograd (no kernel launch); `field_precision = "high"`
     through the 3xTF32 kernels, and from one copied state 2 x ROUTE_ITER
     of its steps as CUDA graph replays equal as many eager ones bit for
     bit; `field_precision = "high"` with
     `bwd_precision = "default"` through #2 at that mixed pair; each
     kernel route's ms/step over chained calls of its step (CUDA graph
     replays) from a copy of its state;
     `precision = "default"` extracts phase 6's field through the bf16
     grid and sweep kernels (one threshold, one fit), after which the bf16
     grid kernel's masks on that field are held against the plain
     version's as phase 6 holds them, and the sliced value-and-gradient
     query against its plain version;
 10. confs/Replica.conf's field at full width (multires 6: the encoded
     input 39 wide, padded to 40; the skip layer takes 217 + 39 inputs):
     the rows of phase 3 at that width, at both tiers (the grid value
     kernel at one GRID_CHUNK of a 256^3 pass), then REPLICA_ITER steps of
     the conf through the CLI on a PidiNet cube scene (a warm-up step, a
     capture and replays at chain 5) with one validation, its launches
     reckoned and its first step held against plain autograd as phase 4's
     is, then the grid masks of the conf's 256^3 grid at its 6-threshold
     menu against the plain version's, as phase 6 holds them, and the conf's
     extraction device stages (256^3 grid, the 6-threshold menu, point
     shift, line directions) on that field, their launches reckoned from
     their trace;
 11. `emap_tpu_torch.cli.main(... --mode extract_edge)` with
     confs/DTU.conf's edge_extraction block unchanged (256^3 grid, 4
     launches of the grid value kernel a pass; 6 thresholds; iters 1; one
     fit a threshold; the visibility filter over the scene's 24 PidiNet
     frames) on a cube field regressed with a loss relative to the
     distance (DTU_FIXTURE_REL), whose valley along the edges the menu's
     0.005 threshold needs: its grid masks held as phase 6 holds them,
     the launches reckoned from the trace, the stage times, the peak
     device memory, the primitives the
     filter kept and dropped, and the edges scored against the cube's as
     in phase 7, F@20mm at least F20_MIN;
 12. the multi-device path (emap_tpu_torch/parallel/mesh.py): a NCCL
     group of world 1 in this process; from one copied state, 2 x
     GRAPH_CHAIN steps without a group (which call no collective), as
     many eager steps of the group and two chained calls of the group
     (its two collectives a step captured in the CUDA graph with the
     step), all three bit for bit, with the NCCL version, the collectives
     a replay, the replays' ms/step and a profile; the ABC block's
     extraction device stages on phase 6's field with and without the
     group, bit for bit; extract_fields and extract_gradient_fields, their
     launches of #3 and #1b counted and held against plain autograd; and,
     where the machine has two cards or more, phase 4's run through the
     CLI on 2 (and 4) spawned NCCL ranks against one process (losses rtol
     1e-4, parameters rtol 2e-4 / atol 2e-6, ranks bit-identical), and
     `--mode extract_edge` on phase 6's checkpoint through the CLI on 2
     (and 4) spawned NCCL ranks, its result files byte for byte against
     one process's, else a line saying each was not run;
 13. the JAX package's last public functions: a 400x400, 24-view PidiNet
     cube scene with 3-pixel lines (the port's OpenCV thick anti-aliased
     line) written and timed; REPLICA_ITER steps of confs/Replica.conf on
     it through the CLI (chain 5, one validation), the launches of #1a and
     #2 reckoned as in phase 10 and every loss finite; udf_gradient at
     GRAD_N points at ABC and at Replica width: bit-equal to
     udf_value_and_gradient's gradient, within KERNEL_RTOL of the sliced
     3xTF32 value-and-gradient kernel with fp32 residuals up to the abs
     head's sign, and a
     loss on it back-propagating to finite parameter gradients;
     get_flow_vis on a 400x400 angle field and semantic_color_map, their
     shapes and dtypes; and cv2 absent from sys.modules.
Each kernel row's `launches` is its kernel and tier's count in the run of
the path that runs it (a launch row of the wgmma kernels, named
"mlp_value_and_grad/bf16:<launch>", "mlp_value/<tier>:<launch>" or
"mlp_train_bwd/<pair>:<launch>", its wrapper row's): the main path (phases 4
and 6), a phase 9 run, or
the Replica and DTU paths of phases 10 and 11 (rows named ".../multires6"
and ".../256^3"; phase 10's rows of tiers no path of the conf runs are
printed and held, not listed).
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
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core peak, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
# The fp32 tiers ("high", "highest") run each product as three TF32 passes
# (3xTF32, fp32 accuracy): the least time in which the card does
# fp32-accurate products is TC_PASSES x FLOP / TF32_PEAK, so a row's
# bound_ms counts the FLOP of its fp32 tiers at TF32_PEAK / TC_PASSES and
# those of its bf16 tier at BF16_PEAK. The kernel line also prints the
# function's time at one TF32 pass and at the fp32 FMA peak, for reference.
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
# The extraction query's sigmoid residuals rounded to bf16 (the JAX
# package's pallas_udf_value_and_grad, f32_residuals=False): sigmoid(100 z)
# carries z's fp32 roundoff a hundredfold (the 3xTF32 kernel's fp32
# residuals lie up to 1.7e-5 from the plain version's on an H100 at ABC
# width), so at some points the kernel and its plain version round a
# sigmoid to neighbouring bf16 values, which moves the gradient by up to
# 5.3e-4 of the block's largest (H100, ABC width, 262,144 points; 5.8e-4
# on the CPU at 32,768). Held against the plain version given the kernel's
# own residuals at KERNEL_RTOL, each of those within one bf16 rounding
# (2^-8) and RESIDUAL_ATOL of the plain sigmoid; against the plain version's
# own bf16 residuals at about 4x the measured flips.
RESIDUAL_ATOL = 1e-4
RESIDUAL_FLIP_RTOL = 2e-3
# The bf16 tier ("default": one bf16 pass, operands rounded to nearest
# even) against its plain version at the same tier. Both round the same
# operands, but each operand of a layer past the first is computed in fp32
# with sums in another order, and where that roundoff straddles a bf16
# rounding boundary the two round it to neighbouring bf16 values: a flip,
# one bf16 ulp, 2^-8 to 2^-7 of the operand. A flip moves its product term
# by up to 2^-7 = 7.8e-3 of that term and the layers after it carry the
# change on. Flips are rare (fp32 roundoff ~1e-7 against a bf16 half-ulp
# ~2e-3) but a block's max finds them: on the CPU at ABC width, the same
# bf16 tier summed in fp32 against fp64 differs by 2.1e-3 (udf), 3.5e-3
# (gradient) of the block's largest at 65,536 points and 2.1e-3 in the
# worst W-bar block at 4,096 (geometric init, the weights of this phase).
# The bound, 1e-2, is a little above one flip's 2^-7 and ~3x the largest
# measured; it is looser than KERNEL_RTOL because a flip is one bf16 ulp,
# not fp32 roundoff. A tier that silently computes fp32 passes that bound
# (its error against the bf16 plain version is the tier's own, ~5e-3), so
# each bf16-tier row must also sit nearer its own tier's plain version than
# the fp32 one: its mean error against the bf16 plain version (flips alone:
# sparse) at most 1/BF16_SEPARATION of the mean error against the fp32
# plain version (the tier's error: everywhere). Measured on the CPU against
# the JAX package's kernels (tests/test_torch_precision.py): 41x to 640x,
# 2.6x for #2 at an fp32 primal and a bf16 adjoint.
BF16_KERNEL_RTOL = 1e-2
BF16_SEPARATION = 2.0
# The tiers a path runs each kernel at (conf names: precision or the
# (primal, adjoint) pair): the ABC conf's bf16 training query, the fp32
# extraction, and what phase 9's pinned confs select.
KERNEL_TIERS = {
    "mlp_value_and_grad": (("default", ""), ("high", "")),
    "mlp_train_bwd": (("default", ""), ("high", ""), ("high", "default")),
    "mlp_value": (("default", ""), ("high", "")),
}
# Kernel path vs autograd (cuBLAS) path through the whole step: the same
# math with other roundoff, amplified by the renderer's steep sigmoids
# and the abs head's sign; measured ~1e-5 max relative error on the first
# step. 3e-4 is the bound the JAX package's own kernel-vs-autodiff test
# holds its fused kernels to.
STEP_GRAD_RTOL = 3e-4
STEP_LOSS_RTOL = 1e-5
# The same at the bf16 tier: both paths round the same operands to bf16, so
# they differ by flips (above), and the more points, the more flips meet the
# renderer's steep sigmoids: at ABC width the worst leaf measured 1.9e-4
# with 32 rays and 1.4e-2 with 128 on the CPU, 3.0e-2 (udf/lin0/v) with
# 1,024 on an H100; the loss 2.8e-7, 1.0e-5 and 1.1e-5. The kernel path at
# the fp32 tier sits 0.24 away (H100, 1,024 rays), so the bf16 kernel path
# must also sit STEP_SEPARATION times nearer the bf16 autograd path.
STEP_GRAD_RTOL_BF16 = 0.1
STEP_LOSS_RTOL_BF16 = 1e-4
STEP_SEPARATION = 3.0
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
# Phase 8: the CUDA graph's replays against eager steps, two chained calls
# of this many steps from one state.
GRAPH_CHAIN = 20
# Phase 9: steps of each training route's run (one chained call).
ROUTE_ITER = 5
# Phases 10 and 13: steps of the Replica conf's run (chain 5).
REPLICA_ITER = 10
# Phase 13: points of the udf_gradient check.
GRAD_N = 1 << 16
# Phase 11's fixture: the cube field regressed with the squared error
# relative to (distance + DTU_FIXTURE_REL). DTU.conf's menu reaches down to
# a 0.005 threshold on a 256^3 grid, which needs the field's valley within
# 0.005 of 0 along the edges. Regressed by the plain squared error (phase
# 6's fixture), the valley rises above it in places and the 0.005 cloud
# breaks up: F@20mm 0.859 on an H100.
DTU_FIXTURE_REL = 0.02
# One GRID_CHUNK of a 256^3 grid pass (extract/pointcloud.py), the launch
# shape of the DTU and Replica confs' grid.
GRID_CHUNK_N = 1 << 22


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


def mean_error(got: dict, want: dict) -> float:
    """The largest over named blocks of mean |got - want| / max |want|."""
    return max(float((got[k] - w).abs().mean()) / (float(w.abs().max())
                                                  + 1e-30)
               for k, w in want.items())


def at_tier(ucfg, tier: tuple):
    """ucfg at a (precision, bwd_precision) pair of conf tier names."""
    import dataclasses

    return dataclasses.replace(ucfg, precision=tier[0], bwd_precision=tier[1])


def tier_name(kernel: str, ucfg) -> str:
    """The wrappers' tier name of `kernel` at ucfg's tiers (the key of its
    tier_launches): "bf16", "3xtf32", or #2's (primal, adjoint) pair."""
    from emap_tpu_torch.fields.udf import adjoint_tier
    from emap_tpu_torch.kernels import mlp_query, mlp_train

    primal = mlp_query.kernel_tier(ucfg.precision)
    if kernel == "mlp_train_bwd":
        return mlp_train.pair_name(
            primal, mlp_query.kernel_tier(adjoint_tier(ucfg)))
    return mlp_query.TIER_NAMES[primal]


def zero_counts() -> None:
    """Every kernel wrapper's launch counts to 0."""
    from emap_tpu_torch.kernels import mlp_query, mlp_train

    for fn in (mlp_query.value_and_grad, mlp_query.value, mlp_train.train_bwd):
        fn.launches = 0
        fn.tier_launches = dict.fromkeys(fn.tier_launches, 0)


def ran(runner=None) -> dict:
    """The kernels' runs since zero_counts(), by "<kernel>/<tier>": the
    wrappers' counts, less the launches that the runner's CUDA graph
    captures counted without running them, plus those its replays ran."""
    from emap_tpu_torch.kernels import launch_counts

    out = launch_counts()
    if runner is not None:
        for k in out:
            out[k] += (runner.replayed_launches.get(k, 0)
                       - runner.captured_launches.get(k, 0))
    return out


def named_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in named_leaves(tree[key], f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): tree}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sliced_plain(x, w, b, ucfg, f32_residuals=False):
    """The plain value-and-gradient over the slicing wrapper's slices: the
    same function on the same inputs (the extraction's bf16 residuals unless
    f32_residuals), with its residuals held for one slice at a time."""
    import torch

    from emap_tpu_torch.kernels import mlp_query

    cap = mlp_query.SLICE_CAP
    parts = [mlp_query.value_and_grad_plain(x[:, s: s + cap], w, b, ucfg,
                                            f32_residuals)
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


def tier_seconds(flops, tiers) -> float:
    """The least time the card does `flops` (a FLOP count per tier) at
    those tiers: bf16 tensor cores for "default", three TF32 passes for the
    fp32 tiers."""
    return sum(f / (BF16_PEAK if t == "default" else TF32_PEAK / TC_PASSES)
               for f, t in zip(flops, tiers))


def kernel_row(name, kern, plain, blocks, args, ucfg, src, replaces,
               nbytes, flops, tols=None) -> dict:
    """One kernel against its plain version on the same inputs at ucfg's
    tier(s), block by block, both timed on those inputs, beside the bound
    for that work. `flops` is (FLOP at the primal tier, FLOP at the adjoint
    tier). At a bf16 tier the kernel is also held against the fp32 plain
    version (BF16_SEPARATION); the bound counts each tier's FLOP at its
    least time (tier_seconds). `tols` overrides the tier's tolerance for
    named blocks."""
    import torch

    from emap_tpu_torch.fields.udf import adjoint_tier

    tier = tier_name(name, ucfg)
    tiers = (ucfg.precision, adjoint_tier(ucfg))
    ms, got = time_ms(lambda: kern(*args, ucfg), 3)
    plain_ms, want = time_ms(lambda: plain(*args, ucfg), 2)
    got, want = blocks(got), blocks(want)
    bf16 = "default" in tiers
    tol = BF16_KERNEL_RTOL if bf16 else KERNEL_RTOL
    if bf16:
        want32 = blocks(plain(*args, at_tier(ucfg, ("high", ""))))
        _, rel32, worst32 = errors(got, want32)
        own, fp32 = mean_error(got, want), mean_error(got, want32)
    got, flips = head_signs(got, want, tol)
    tols = dict.fromkeys(want, tol) | (tols or {})
    abs_err, rel_err, worst = errors(got, want)
    rel_by = {k: errors({k: got[k]}, {k: want[k]})[1] for k in want}
    over = {k: r for k, r in rel_by.items() if r > tols[k]}
    t_ops = tier_seconds(flops, tiers)
    t_bytes, total = nbytes / HBM_RATE, sum(flops)
    bound_ms = 1e3 * max(t_bytes, t_ops)
    tf32_ms = 1e3 * max(t_bytes, total / TF32_PEAK)
    fma_ms = 1e3 * max(t_bytes, total / FP32_PEAK)
    bf16_ms = 1e3 * max(t_bytes, total / BF16_PEAK)
    row = {
        "name": f"{name}/{tier}", "route": "cuda", "source": src,
        "replaces": replaces, "tier": tier, "launches": 0,
        "max_abs_err": abs_err, "max_rel_err": rel_err, "worst_block": worst,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "n": args[0].shape[1], "head_sign_flips": flips,
    }
    by_block = "" if set(tols.values()) == {tol} else f", by block {tols}"
    line = (f"kernel {name}/{tier}: max abs err {abs_err:.3e}, max rel err "
            f"{rel_err:.3e} in block {worst} of {len(want)} (tolerance "
            f"{tol:g}{by_block}); {flips} points of opposite head sign")
    if bf16:
        row.update(max_rel_err_vs_fp32=rel32, mean_err=own,
                   mean_err_vs_fp32=fp32)
        line += (f"; against the fp32 "
                 f"plain version {rel32:.3e} in block {worst32}; mean err "
                 f"{own:.3e}, against fp32 {fp32:.3e} (separation "
                 f"{BF16_SEPARATION:g})")
    print(f"{line}; {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms (bf16 tensor cores, or {TC_PASSES} TF32 passes "
          f"at the fp32 tiers); at one bf16 pass {bf16_ms:.3f} ms, one TF32 "
          f"pass {tf32_ms:.3f} ms, fp32 FMA {fma_ms:.3f} ms "
          f"({total / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB; "
          f"{total / (ms * 1e9):.1f} TFLOP/s achieved), "
          f"N={args[0].shape[1]}", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          f"{name}/{tier} gave non-finite values")
    check(not over, f"{name}/{tier} disagrees with its plain version: max "
          f"rel err by block {over} (tolerances {tols})")
    if bf16:
        check(BF16_SEPARATION * row["mean_err"] <= row["mean_err_vs_fp32"],
              f"{name}/{tier} is no nearer its tier's plain version than the "
              f"fp32 one: mean err {row['mean_err']:.3e} against "
              f"{row['mean_err_vs_fp32']:.3e}")
    return row


def head_signs(got: dict, want: dict, tol: float) -> tuple:
    """(got with its spatial gradient's sign taken from want at the points
    where the two have opposite signs, the count of those points). The abs
    head's d|y0|/dy0 = sign(y0) turns over at the surface, so where y0 lies
    within the tier's roundoff of 0 the kernel and its plain version may
    take opposite signs (at bf16 a flip's size; at 3xTF32 fp32 roundoff,
    which a few million points of a field through the surface reach): the
    gradient is held up to that sign, and a point may differ in sign only
    where its udf is within the tier's udf bound (`tol` of the block's
    largest) of 0."""
    import torch

    if "grad" not in want:
        return got, 0
    g, w = got["grad"], want["grad"]
    flip = (g + w).abs().amax(0) < (g - w).abs().amax(0)
    far = want["udf"][flip] > tol * float(want["udf"].max())
    check(not bool(far.any()), f"{int(far.sum())} points take the opposite "
          f"head sign away from the surface")
    return dict(got, grad=torch.where(flip, -g, g)), int(flip.sum())


def same_bits(name, kern, args, ucfg) -> None:
    """Two launches of a kernel on the same inputs agree in every bit (no
    atomics, sums in a fixed order)."""
    import torch

    name = f"{name}/{tier_name(name, ucfg)}"
    first, second = kern(*args, ucfg), kern(*args, ucfg)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"kernel {name}: two launches bit-identical: {same}", flush=True)
    check(same, f"two launches of {name} on the same inputs differ")


# The tensor-core instruction each library must hold: wgmma (HGMMA) in the
# Hopper libraries (#1, #2 and #3 at every tier), mma.sync (HMMA) in the
# others.
WGMMA_LIBS = ("mlp_query_tf32", "mlp_query_wgmma", "mlp_train_tf32",
              "mlp_train_wgmma", "mlp_value_tf32", "mlp_value_wgmma")


def plan_registers(ucfg) -> None:
    """The registers a thread that value_tf32_plan and value_wgmma_plan
    give their kernels as compiled, held against ptxas' report of this
    build; fail if they differ or a byte spills."""
    from emap_tpu_torch.kernels import build, mlp_query

    for lib, kernel, plan in (
            ("mlp_value_tf32", "value_tf32_kernel", mlp_query.value_tf32_plan),
            ("mlp_value_wgmma", "value_wgmma_kernel",
             mlp_query.value_wgmma_plan)):
        report = build.parse_ptxas(build.build_log(lib))
        got = [v for k, v in report.items() if kernel in k]
        want = {"registers": plan(ucfg, GRID_N)["registers"]["compiled"],
                "spill_bytes": 0}
        check(got == [want], f"{lib}: ptxas reports {got} for {kernel}, "
              f"the plan {want}")
        print(f"ptxas {lib}: {kernel} as its plan: {want}", flush=True)


def tensor_core_sass(names) -> None:
    """Count the tensor-core instructions, HMMA (mma.sync) and HGMMA
    (wgmma), in each library's SASS; fail if one lacks its kind."""
    import shutil

    from emap_tpu_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in names:
        sass = subprocess.run([tool, "-sass", build.lib_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {}
        for op in ("HMMA", "HGMMA"):
            kinds = sorted({w for line in sass.splitlines()
                            for w in line.split() if w.startswith(op)})
            counts[op] = sum(w.startswith(op) for line in sass.splitlines()
                             for w in line.split())
            print(f"sass {name}: {counts[op]} {op} instructions {kinds}",
                  flush=True)
        need = "HGMMA" if name in WGMMA_LIBS else "HMMA"
        check(counts[need] > 0, f"{name} has no {need} instruction")


def packed_weights(ucfg):
    import torch

    from emap_tpu_torch.fields.udf import init_udf_params
    from emap_tpu_torch.kernels import mlp_query

    params = init_udf_params(torch.Generator().manual_seed(0), ucfg,
                             device="cuda")
    w, b = mlp_query.pack_weights(params, ucfg)
    return w.contiguous(), b.contiguous()


def bwd_flops(ucfg) -> tuple:
    """#2's FLOP a point at its (primal, adjoint) tiers: the forward
    recompute and the gradient chain, then the ascend, descend and both
    weight-gradient products (kernels/mlp_train.py::train_bwd_flops)."""
    from emap_tpu_torch.kernels import mlp_train

    shapes = [(i, o) for _, i, o in ucfg.layer_shapes()]
    total = sum(i * o for i, o in shapes)
    first = shapes[0][0] * shapes[0][1]
    primal = 2 * (2 * total - first)
    return primal, mlp_train.train_bwd_flops(ucfg) - primal


def query_source(ucfg) -> str:
    """The source of #1's kernel at ucfg's tier: the bf16 wgmma kernel, or
    the 3xTF32 one."""
    from emap_tpu_torch.kernels import mlp_query

    if mlp_query.kernel_tier(ucfg.precision) == 1:
        return "emap_tpu_torch/csrc/mlp_query_wgmma.cu"
    return "emap_tpu_torch/csrc/mlp_query_tf32.cu"


def kernel_phase(ucfg, n: int, grid_shapes=(GRID_N,)) -> list:
    """The training kernels at the step's shape and the grid value kernel
    at each of `grid_shapes` (points a launch: a 128^3 pass, GRID_CHUNK of a
    256^3 pass), each at each of its KERNEL_TIERS against its plain version
    at that tier; the rows in that order."""
    import torch

    from emap_tpu_torch.fields.udf import adjoint_tier
    from emap_tpu_torch.kernels import mlp_query, mlp_train

    w, b = packed_weights(ucfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = raw_points(gen, n)
    ubar = torch.randn(1, n, generator=gen, device="cuda")
    gbar = torch.zeros(8, n, device="cuda")
    gbar[:3] = torch.randn(3, n, generator=gen, device="cuda")
    grids = [raw_points(gen, count) for count in grid_shapes]

    def value_blocks(out):
        return {"udf": out}

    def bwd_blocks(out):
        return blocks_of(out, ucfg)

    f32 = 4
    pack_bytes = f32 * (w.numel() + b.numel())

    def value_row(points, cfg):
        count = points.shape[1]
        tf32 = mlp_query.kernel_tier(cfg.precision) == 0
        return kernel_row("mlp_value", mlp_query.value, mlp_query.value_plain,
                          value_blocks, (points, w, b), cfg,
                          "emap_tpu_torch/csrc/mlp_value_tf32.cu" if tf32
                          else "emap_tpu_torch/csrc/mlp_value_wgmma.cu",
                          "emap_tpu/kernels/mlp_query.py:328",
                          f32 * (8 * count + count) + pack_bytes,
                          (mlp_query.value_flops(cfg) * count, 0))

    rows = []
    for tier in KERNEL_TIERS["mlp_value_and_grad"]:
        cfg = at_tier(ucfg, tier)
        same_bits("mlp_value_and_grad", mlp_query.value_and_grad, (x, w, b),
                  cfg)
        wgmma = mlp_query.kernel_tier(cfg.precision) == 1
        rows.append(kernel_row(
            "mlp_value_and_grad", mlp_query.value_and_grad,
            mlp_query.value_and_grad_plain, query_blocks, (x, w, b), cfg,
            query_source(cfg), "emap_tpu/kernels/mlp_query.py:363",
            f32 * (8 * n + n + 8 * n) + pack_bytes,
            (mlp_query.query_flops(cfg) * n, 0)))
        rows += (query_wgmma_rows if wgmma else query_tf32_rows)(
            (x, w, b), cfg, rows[-1])
    for tier in KERNEL_TIERS["mlp_train_bwd"]:
        cfg = at_tier(ucfg, tier)
        same_bits("mlp_train_bwd", mlp_train.train_bwd,
                  (x, w, b, ubar, gbar), cfg)
        wgmma = mlp_train.pair_name(*(mlp_query.kernel_tier(t) for t in (
            cfg.precision, adjoint_tier(cfg)))) == "bf16"
        rows.append(kernel_row(
            "mlp_train_bwd", mlp_train.train_bwd, mlp_train.train_bwd_plain,
            bwd_blocks, (x, w, b, ubar, gbar), cfg,
            "emap_tpu_torch/csrc/mlp_train_wgmma.cu" if wgmma
            else "emap_tpu_torch/csrc/mlp_train_tf32.cu",
            "emap_tpu/kernels/mlp_train.py:417",
            f32 * (8 * n + n + 8 * n) + 2 * pack_bytes,
            tuple(f * n for f in bwd_flops(cfg))))
        rows += (wgmma_rows if wgmma else train_tf32_rows)(
            (x, w, b, ubar, gbar), cfg, rows[-1])
    for grid_x in grids:
        for tier in KERNEL_TIERS["mlp_value"]:
            cfg = at_tier(ucfg, tier)
            same_bits("mlp_value", lambda *a: (mlp_query.value(*a),),
                      (grid_x, w, b), cfg)
            rows.append(value_row(grid_x, cfg))
            rows += (value_tf32_rows if mlp_query.kernel_tier(
                cfg.precision) == 0 else value_wgmma_rows)(
                (grid_x, w, b), cfg, rows[-1])
    return rows


WGMMA_LAUNCHES = {  # kernel name in the profile: launch
    "pack_kernel": "pack", "per_point_kernel": "per_point",
    "wbar_kernel": "gemm", "reduce_kernel": "reduce"}


def launch_times(fn, reps: int, names) -> dict:
    """Device ms a launch of each kernel whose name holds one of `names`,
    from torch.profiler over `reps` calls of fn after a warm-up: each
    kernel's device time over the launches the profiler recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a window in which the profiler recorded none of the launches is
    # taken again (seen on an H100 with launches of ~60 ms), up to 3 times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0.0)
            for name in names:
                if name in e.key:
                    total[name] += us
                    count[name] += e.count
        if all(count.values()):
            break
    check(all(count.values()), f"the profiler recorded no launch of "
          f"{[k for k, v in count.items() if not v]}")
    return {k: total[k] / (1e3 * count[k]) for k in names}


def gemm_library_ms(factors, ucfg) -> tuple:
    """(ms, form) of one PyTorch call computing the GEMM's function on the
    same factors: torch.bmm over the layers, each layer's [R; Z-hat]
    (out_l x 2N, zero-padded to the widest) against [Q-hat; U]^T; for bf16
    factors an fp32 result where torch takes out_dtype (else a bf16
    result), for fp32 factors fp32 products with TF32 off (the port's
    use_fp32_matmuls). Timed here only; the port never calls it."""
    import torch

    from emap_tpu_torch.kernels import mlp_train

    lay = mlp_train.wgmma_layout(ucfg)
    n = factors.shape[1]
    a = torch.zeros(len(lay["dims"]), 256, 2 * n, dtype=factors.dtype,
                    device="cuda")
    bt = torch.zeros_like(a)
    for l, (i, o) in enumerate(lay["dims"]):
        for k, (ra, rb) in enumerate((("R", "Q"), ("Z", "U"))):
            a[l, :o, k * n: (k + 1) * n] = factors[
                lay["rows"][ra][l]: lay["rows"][ra][l] + o]
            bt[l, :i, k * n: (k + 1) * n] = factors[
                lay["rows"][rb][l]: lay["rows"][rb][l] + i]
    b = bt.transpose(1, 2)
    if factors.dtype == torch.float32:
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls on")
        ms, _ = time_ms(lambda: torch.bmm(a, b), 5)
        return ms, "torch.bmm fp32 (TF32 off)"
    try:
        torch.bmm(a, b, out_dtype=torch.float32)
        form = "torch.bmm bf16 -> fp32 (out_dtype)"
        ms, _ = time_ms(lambda: torch.bmm(a, b, out_dtype=torch.float32), 5)
    except (TypeError, RuntimeError):
        form = "torch.bmm bf16 -> bf16 (no out_dtype in this torch)"
        ms, _ = time_ms(lambda: torch.bmm(a, b), 5)
    return ms, form


def in_order(part):
    """A kernel set's range or block partials summed in their order (the
    reduce's order of the range partials)."""
    out = part[0]
    for k in range(1, part.shape[0]):
        out = out + part[k]
    return out


def plain_reduce(parts, ucfg) -> tuple:
    """The reduce launch's plain version: (W-bar, b-bar) as the in-order sums
    of a kernel set's wpart and bpart, W-bar 0 outside every layer's
    block."""
    import torch

    from emap_tpu_torch.kernels import mlp_train

    mask = torch.zeros_like(parts["wbar"], dtype=torch.bool)
    off = 0
    for i, o in mlp_train.wgmma_layout(ucfg)["dims"]:
        mask[:o, off: off + i] = True
        off += i
    return (torch.where(mask, in_order(parts["wpart"]), 0.0),
            in_order(parts["bpart"]))


def grad_blocks(parts, ucfg, wbar, bbar=None) -> dict:
    """blocks_of (wbar, bbar); without a bbar, W-bar's blocks beside a zero
    b-bar (whose blocks agree with themselves)."""
    import torch

    return blocks_of((wbar, torch.zeros_like(parts["bbar"]) if bbar is None
                      else bbar), ucfg)


def wgmma_rows(args, ucfg, whole: dict) -> list:
    """#2's wgmma kernels at the bf16 pair, launch by launch, on the inputs
    of `whole` (their row as one function): each launch's device time
    (torch.profiler), its bound from train_bwd_launch_costs, and its output
    against the plain version of that launch on the same inputs: the
    prologue against pack_weights_bf16 (bit for bit); the per-point
    kernel's factors through wbar_from_factors, and its bias partials'
    sum, against the plain factors' (BF16_KERNEL_RTOL a block); the GEMM's
    range partials in order against wbar_from_factors of the kernel's own
    factors, and the reduce against the in-order sums of the partials
    (KERNEL_RTOL: fp32 sums in another order). The GEMM's row has a
    library_ms. Then mlp_train.cu's mma.sync bf16 instantiation and the
    wgmma kernels timed in turns (old, new, new, old)."""
    import torch

    from emap_tpu_torch.kernels import mlp_train

    x, w = args[:2]
    n = x.shape[1]
    parts = mlp_train.train_bwd_wgmma_parts(*args, ucfg)
    torch.cuda.synchronize()
    costs = mlp_train.train_bwd_launch_costs(ucfg, n)
    times = launch_times(lambda: mlp_train.train_bwd_wgmma_parts(*args, ucfg),
                         5, tuple(WGMMA_LAUNCHES))

    def wblocks(wbar, bbar=None):
        return grad_blocks(parts, ucfg, wbar, bbar)

    plain_ms = {
        "pack": time_ms(lambda: mlp_train.pack_weights_bf16(w, ucfg), 2)[0],
        "per_point": time_ms(lambda: mlp_train.train_bwd_factors(
            *args, ucfg), 2)[0],
        "gemm": time_ms(lambda: mlp_train.wbar_from_factors(
            parts["factors"], ucfg), 2)[0],
        "reduce": time_ms(lambda: plain_reduce(parts, ucfg), 2)[0],
    }
    factors, bbar = mlp_train.train_bwd_factors(*args, ucfg)
    wb_plain = mlp_train.pack_weights_bf16(w, ucfg)
    held = {  # launch: (got blocks, want blocks, tolerance)
        "pack": ({"wb": parts["wb"].float()}, {"wb": wb_plain.float()}, 0.0),
        "per_point": (
            wblocks(mlp_train.wbar_from_factors(parts["factors"], ucfg),
                    in_order(parts["bpart"])),
            wblocks(mlp_train.wbar_from_factors(factors, ucfg), bbar),
            BF16_KERNEL_RTOL),
        "gemm": (wblocks(plain_reduce(parts, ucfg)[0]),
                 wblocks(mlp_train.wbar_from_factors(parts["factors"], ucfg)),
                 KERNEL_RTOL),
        "reduce": (wblocks(parts["wbar"], parts["bbar"]),
                   wblocks(*plain_reduce(parts, ucfg)), KERNEL_RTOL),
    }
    lib_ms, lib_form = gemm_library_ms(parts["factors"], ucfg)
    rows = launch_rows(whole, WGMMA_LAUNCHES, times, plain_ms, held, costs,
                       {"gemm": (lib_ms, lib_form)})
    in_turns(
        whole, "mma.sync bf16 (csrc/mlp_train.cu)",
        lambda: mlp_train.train_bwd_mma_sync(*args, ucfg),
        lambda: mlp_train.train_bwd_wgmma_parts(*args, ucfg))
    old = blocks_of(mlp_train.train_bwd_mma_sync(*args, ucfg), ucfg)
    new = blocks_of((parts["wbar"], parts["bbar"]), ucfg)
    want = blocks_of(mlp_train.train_bwd_plain(*args, ucfg), ucfg)
    print(f"kernel {whole['name']}: max rel err against the plain version "
          f"{errors(old, want)[1]:.3e} (mma.sync), "
          f"{errors(new, want)[1]:.3e} (wgmma)", flush=True)
    return rows


def train_tf32_rows(args, ucfg, whole: dict) -> list:
    """#2 at a pair with a 3xTF32 tier on csrc/mlp_train_tf32.cu, launch by
    launch, on the inputs of `whole` (their row as one function): each
    launch's device time (torch.profiler), its bound from
    train_tf32_launch_costs (each tier's FLOP at its peak), and its output
    against the plain version of that launch on the same inputs: the packs
    against pack_weights_tf32 and pack_weights_bf16, bit for bit; the
    per-point kernel's factors through wbar_from_factors, and its bias
    partials' sum, against the plain factors' (KERNEL_RTOL a block, or
    BF16_KERNEL_RTOL at a bf16 tier); the GEMM's range partials in order
    against wbar_from_factors of the kernel's own factors and the reduce
    against the in-order sums of the partials (KERNEL_RTOL: fp32 sums in
    another order). The GEMM's row has a library_ms. Then mlp_train.cu's
    mma.sync design at the pair and these kernels timed in turns (old, new,
    new, old)."""
    import torch

    from emap_tpu_torch.kernels import mlp_query, mlp_train

    x, w = args[:2]
    n = x.shape[1]
    primal, adjoint = (mlp_query.kernel_tier(t) for t in (
        ucfg.precision, ucfg.bwd_precision or ucfg.precision))
    parts = mlp_train.train_bwd_tf32_parts(*args, ucfg)
    torch.cuda.synchronize()
    costs = mlp_train.train_tf32_launch_costs(ucfg, n)
    launches = {"pack_tf32_kernel": "pack", "train_tf32_kernel": "per_point",
                "wbar_kernel" if adjoint else "wbar_tf32_kernel": "gemm",
                "reduce_kernel": "reduce"}
    if parts["wb"] is not None:
        launches["pack_kernel"] = "pack_bf16"
    times = launch_times(lambda: mlp_train.train_bwd_tf32_parts(*args, ucfg),
                         5, tuple(launches))
    p3 = TF32_PEAK / TC_PASSES
    tier_peak = (p3, BF16_PEAK)
    peaks = {"per_point": (tier_peak[primal], tier_peak[adjoint]),
             "gemm": tier_peak[adjoint]}

    def wblocks(wbar, bbar=None):
        return grad_blocks(parts, ucfg, wbar, bbar)

    plain_ms = {
        "pack": time_ms(lambda: mlp_query.pack_weights_tf32(w, ucfg), 2)[0],
        "pack_bf16": time_ms(lambda: mlp_train.pack_weights_bf16(w, ucfg),
                             2)[0],
        "per_point": time_ms(lambda: mlp_train.train_bwd_factors(
            *args, ucfg), 2)[0],
        "gemm": time_ms(lambda: mlp_train.wbar_from_factors(
            parts["factors"], ucfg), 2)[0],
        "reduce": time_ms(lambda: plain_reduce(parts, ucfg), 2)[0],
    }
    factors, bbar = mlp_train.train_bwd_factors(*args, ucfg)
    pack = mlp_query.pack_weights_tf32(w, ucfg)
    check(torch.equal(parts["pack"], pack), f"{whole['name']}: the pack "
          f"differs from pack_weights_tf32")
    held = {  # launch: (got blocks, want blocks, tolerance)
        "pack": ({"pack": parts["pack"]}, {"pack": pack}, 0.0),
        "per_point": (
            wblocks(mlp_train.wbar_from_factors(parts["factors"], ucfg),
                    in_order(parts["bpart"])),
            wblocks(mlp_train.wbar_from_factors(factors, ucfg), bbar),
            BF16_KERNEL_RTOL if 1 in (primal, adjoint) else KERNEL_RTOL),
        "gemm": (wblocks(plain_reduce(parts, ucfg)[0]),
                 wblocks(mlp_train.wbar_from_factors(parts["factors"], ucfg)),
                 KERNEL_RTOL),
        "reduce": (wblocks(parts["wbar"], parts["bbar"]),
                   wblocks(*plain_reduce(parts, ucfg)), KERNEL_RTOL),
    }
    if parts["wb"] is not None:
        held["pack_bf16"] = ({"wb": parts["wb"].float()}, {
            "wb": mlp_train.pack_weights_bf16(w, ucfg).float()}, 0.0)
    lib_ms, lib_form = gemm_library_ms(parts["factors"], ucfg)
    del factors
    rows = launch_rows(whole, launches, times, plain_ms, held, costs,
                       {"gemm": (lib_ms, lib_form)}, peak=p3, peaks=peaks)
    del parts
    torch.cuda.empty_cache()
    tier = whole["tier"]
    in_turns(whole, f"mma.sync {tier} (csrc/mlp_train.cu)",
             lambda: mlp_train.train_bwd_mma_sync(*args, ucfg),
             lambda: mlp_train.train_bwd_tf32_parts(*args, ucfg))
    old = blocks_of(mlp_train.train_bwd_mma_sync(*args, ucfg), ucfg)
    again = mlp_train.train_bwd_tf32_parts(*args, ucfg)
    new = blocks_of((again["wbar"], again["bbar"]), ucfg)
    del again
    want = blocks_of(mlp_train.train_bwd_plain(*args, ucfg), ucfg)
    print(f"kernel {whole['name']}: max rel err against the plain version "
          f"{errors(old, want)[1]:.3e} (mma.sync), "
          f"{errors(new, want)[1]:.3e} (wgmma)", flush=True)
    return rows


def launch_rows(whole, launches, times, plain_ms, held, costs,
                library=None, peak=BF16_PEAK, peaks=None) -> list:
    """A row for each launch of a kernel set (`launches`: its kernel's name
    in the profile -> launch), beside the row of the whole function: the
    launch's device time, its plain version's time and the bound from its
    cost (FLOP at `peak`: bf16 tensor cores, or TF32_PEAK / TC_PASSES for
    the 3xTF32 kernels; a launch in `peaks` at its own, and a cost's
    `tier_flops` each at its tier's peak there), its output held against
    that plain version
    (held[launch]: got blocks, want blocks, tolerance), the side arrays'
    bytes where it moves any, the weight chunks its blocks stream from L2
    where it reckons them, and a library call's time where `library` names
    one."""
    import torch

    library = library or {}
    rows = []
    for kernel, launch in launches.items():
        got, want, tol = held[launch]
        abs_err, rel_err, worst = errors(got, want)
        cost = costs[launch]
        at = (peaks or {}).get(launch, peak)
        t_ops = (sum(f / p for f, p in zip(cost["tier_flops"], at))
                 if "tier_flops" in cost else cost["flops"] / at)
        t_bytes = cost["bytes"] / HBM_RATE
        lib_ms, lib_form = library.get(launch, (None, ""))
        row = dict(whole, name=f"{whole['name']}:{launch}",
                   part_of=whole["name"], max_abs_err=abs_err,
                   max_rel_err=rel_err, worst_block=worst,
                   ms=times[kernel], plain_ms=plain_ms[launch],
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=lib_ms, flops=cost["flops"],
                   bytes=cost["bytes"])
        for k in ("max_rel_err_vs_fp32", "mean_err", "mean_err_vs_fp32",
                  "head_sign_flips"):
            row.pop(k, None)
        extra = ""
        if "side_bytes" in cost:
            row["side_bytes"] = cost["side_bytes"]
            extra = (f"; side arrays {cost['side_bytes'] / 1e9:.2f} GB "
                     f"({1e3 * cost['side_bytes'] / HBM_RATE:.3f} ms at the "
                     f"memory rate)")
        if "stream_bytes" in cost:
            row["stream_bytes"] = cost["stream_bytes"]
            extra += (f"; weight chunks streamed from L2 "
                      f"{cost['stream_bytes'] / 1e9:.2f} GB")
        if lib_ms is not None:
            extra += f"; library {lib_ms:.3f} ms ({lib_form})"
        print(f"kernel {row['name']}: {kernel}, {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}: {cost['flops'] / 1e12:.3f} TFLOP, "
              f"{cost['bytes'] / 1e6:.1f} MB); max abs err {abs_err:.3e}, "
              f"max rel err {rel_err:.3e} in block {worst} (tolerance "
              f"{tol:g}){extra}", flush=True)
        check(all(bool(torch.isfinite(g).all()) for g in got.values()),
              f"{row['name']} gave non-finite values")
        check(rel_err <= tol, f"{row['name']} disagrees with its plain "
              f"version: max rel err {rel_err:.3e} in block {worst}")
        rows.append(row)
    total = sum(times.values())
    print(f"kernel {whole['name']}: launches by device time "
          f"{ {k: round(v, 3) for k, v in times.items()} }, {total:.3f} ms "
          f"in all", flush=True)
    return rows


def in_turns(whole, old_name, old_fn, new_fn) -> None:
    """The mma.sync design (`old_fn`) and the wgmma one (`new_fn`) timed in
    turns (old, new, new, old) on the same inputs, the times into `whole`
    (in_turns_ms); the wgmma kernels must be the faster. No call's output
    outlives it, so every timed call takes its scratch (gigabytes of side
    arrays) from the allocator's cache, not from a fresh cudaMalloc."""
    turns = {"old": [], "new": []}
    fns = {"old": lambda: (old_fn(), None)[1],
           "new": lambda: (new_fn(), None)[1]}
    for name in ("old", "new", "new", "old"):
        turns[name].append(time_ms(fns[name], 5)[0])
    print(f"kernel {whole['name']}: in turns (old, new, new, old): "
          f"{old_name} {turns['old']} ms, wgmma {turns['new']} ms", flush=True)
    check(max(turns["new"]) < min(turns["old"]),
          f"{whole['name']}: the wgmma kernels ({turns['new']} ms) do not "
          f"beat the {old_name} ({turns['old']} ms)")
    whole["in_turns_ms"] = {old_name: turns["old"], "wgmma": turns["new"]}


QUERY_WGMMA_LAUNCHES = {  # kernel name in the profile: launch
    "pack_kernel": "pack", "query_kernel": "query"}


def query_wgmma_rows(args, ucfg, whole: dict) -> list:
    """#1a's wgmma kernels at the bf16 tier, launch by launch, on the
    inputs of `whole` (their row as one function): each launch's device
    time (torch.profiler), its bound from query_wgmma_launch_costs, and its
    output against the plain version of that launch on the same inputs:
    the prologue against pack_weights_bf16 (bit for bit), the chain kernel's
    udf and grad against value_and_grad_plain (BF16_KERNEL_RTOL a block, the
    gradient up to the abs head's sign at the surface). Then
    csrc/mlp_query.cu's mma.sync bf16 instantiation and the wgmma kernels
    timed in turns (old, new, new, old)."""
    import torch

    from emap_tpu_torch.kernels import mlp_query

    x, w = args[:2]
    n = x.shape[1]
    parts = mlp_query.value_and_grad_wgmma_parts(*args, ucfg)
    torch.cuda.synchronize()
    costs = mlp_query.query_wgmma_launch_costs(ucfg, n)
    times = launch_times(
        lambda: mlp_query.value_and_grad_wgmma_parts(*args, ucfg), 5,
        tuple(QUERY_WGMMA_LAUNCHES))
    plain_ms = {
        "pack": time_ms(lambda: mlp_query.pack_weights_bf16(w, ucfg), 2)[0],
        "query": time_ms(lambda: mlp_query.value_and_grad_plain(
            *args, ucfg), 2)[0],
    }
    want = query_blocks(mlp_query.value_and_grad_plain(*args, ucfg))
    got, _ = head_signs({"udf": parts["udf"], "grad": parts["grad"]}, want,
                        BF16_KERNEL_RTOL)
    held = {
        "pack": ({"wb": parts["wb"].float()},
                 {"wb": mlp_query.pack_weights_bf16(w, ucfg).float()}, 0.0),
        "query": (got, want, BF16_KERNEL_RTOL),
    }
    rows = launch_rows(whole, QUERY_WGMMA_LAUNCHES, times, plain_ms, held,
                       costs)
    in_turns(whole, "mma.sync bf16 (csrc/mlp_query.cu)",
             lambda: mlp_query.value_and_grad_mma_sync(*args, ucfg),
             lambda: mlp_query.value_and_grad_wgmma_parts(*args, ucfg))
    old, _ = head_signs(query_blocks(mlp_query.value_and_grad_mma_sync(
        *args, ucfg)), want, BF16_KERNEL_RTOL)
    print(f"kernel {whole['name']}: max rel err against the plain version "
          f"{errors(old, want)[1]:.3e} (mma.sync), "
          f"{errors(got, want)[1]:.3e} (wgmma)", flush=True)
    return rows


QUERY_TF32_LAUNCHES = {  # kernel name in the profile: launch
    "pack_tf32_kernel": "pack", "query_tf32_kernel": "query"}


def query_tf32_rows(args, ucfg, whole: dict) -> list:
    """#1 at the 3xTF32 tier on csrc/mlp_query_tf32.cu, launch by launch, on
    the inputs of `whole` (their row as one function, fp32 residuals): each
    launch's device time (torch.profiler), its bound from
    query_tf32_launch_costs (three TF32 passes), and its output against the
    plain version of that launch on the same inputs: the prologue against
    pack_weights_tf32 bit for bit, the chain kernel's udf and grad against
    value_and_grad_plain (KERNEL_RTOL a block, the gradient up to the abs
    head's sign at the surface). Then the extraction's bf16 residuals: the
    kernel's own (side_residuals) each within one bf16 rounding of the
    plain sigmoid (how many round the other way is counted), its udf and
    grad against the plain version given them (KERNEL_RTOL) and against
    the plain version's own bf16 residuals (RESIDUAL_FLIP_RTOL), and its
    time. Then csrc/mlp_query.cu's mma.sync design and the wgmma kernels
    timed in turns (old, new, new, old)."""
    import torch

    from emap_tpu_torch.fields.udf import round_bf16
    from emap_tpu_torch.kernels import mlp_query

    x, w = args[:2]
    n = x.shape[1]
    parts = mlp_query.value_and_grad_tf32_parts(*args, ucfg)
    torch.cuda.synchronize()
    costs = mlp_query.query_tf32_launch_costs(ucfg, n)
    times = launch_times(
        lambda: mlp_query.value_and_grad_tf32_parts(*args, ucfg), 5,
        tuple(QUERY_TF32_LAUNCHES))
    plain_ms = {
        "pack": time_ms(lambda: mlp_query.pack_weights_tf32(w, ucfg), 2)[0],
        "query": time_ms(lambda: mlp_query.value_and_grad_plain(
            *args, ucfg), 2)[0],
    }
    want = query_blocks(mlp_query.value_and_grad_plain(*args, ucfg))
    got, _ = head_signs({"udf": parts["udf"], "grad": parts["grad"]}, want,
                        KERNEL_RTOL)
    pack = mlp_query.pack_weights_tf32(w, ucfg)
    check(torch.equal(parts["pack"], pack), f"{whole['name']}: the pack "
          f"differs from pack_weights_tf32")
    held = {
        "pack": ({"pack": parts["pack"]}, {"pack": pack}, 0.0),
        "query": (got, want, KERNEL_RTOL),
    }
    rows = launch_rows(whole, QUERY_TF32_LAUNCHES, times, plain_ms, held,
                       costs, peak=TF32_PEAK / TC_PASSES)

    bf = mlp_query.value_and_grad_tf32_parts(*args, ucfg, f32_residuals=False)
    res = mlp_query.side_residuals(bf["side"], ucfg, n)
    sig = mlp_query.plain_residuals(*args, ucfg)
    flips = sum(int((r != round_bf16(s)).sum()) for r, s in zip(res, sig))
    count = sum(s.numel() for s in sig)
    off = max(float(((r - s).abs() - 2.0 ** -8 * s.abs()).max())
              for r, s in zip(res, sig))
    want16 = query_blocks(mlp_query.value_and_grad_plain(*args, ucfg,
                                                         residuals=res))
    got16, _ = head_signs(query_blocks((bf["udf"], bf["grad"])), want16,
                          KERNEL_RTOL)
    _, rel16, worst16 = errors(got16, want16)
    own16 = query_blocks(mlp_query.value_and_grad_plain(
        *args, ucfg, f32_residuals=False))
    _, rel_own, worst_own = errors(head_signs(query_blocks(
        (bf["udf"], bf["grad"])), own16, KERNEL_RTOL)[0], own16)
    ms16, _ = time_ms(lambda: mlp_query.value_and_grad(
        *args, ucfg, f32_residuals=False), 5)
    print(f"kernel {whole['name']}, bf16 residuals: {ms16:.3f} ms; "
          f"{flips} of {count} residuals round to the other bf16 neighbour "
          f"of the plain sigmoid, each within one bf16 rounding of it "
          f"(excess {off:.2e}, allowance {RESIDUAL_ATOL:g}); max rel err "
          f"against the plain version given the kernel's residuals "
          f"{rel16:.3e} in block {worst16} (tolerance {KERNEL_RTOL:g}), "
          f"given its own {rel_own:.3e} in block {worst_own} (tolerance "
          f"{RESIDUAL_FLIP_RTOL:g})", flush=True)
    check(off <= RESIDUAL_ATOL, f"{whole['name']}: a bf16 residual lies "
          f"past one rounding of the plain sigmoid")
    check(rel16 <= KERNEL_RTOL and rel_own <= RESIDUAL_FLIP_RTOL,
          f"{whole['name']} with bf16 residuals disagrees with its plain "
          f"version: {rel16:.3e}, {rel_own:.3e}")
    whole["bf16_residuals"] = {"ms": ms16, "max_rel_err": rel16,
                               "max_rel_err_vs_plain_residuals": rel_own,
                               "residual_flips": flips}
    in_turns(whole, "mma.sync 3xTF32 (csrc/mlp_query.cu)",
             lambda: mlp_query.value_and_grad_mma_sync(*args, ucfg),
             lambda: mlp_query.value_and_grad_tf32_parts(*args, ucfg))
    old, _ = head_signs(query_blocks(mlp_query.value_and_grad_mma_sync(
        *args, ucfg)), want, KERNEL_RTOL)
    print(f"kernel {whole['name']}: max rel err against the plain version "
          f"{errors(old, want)[1]:.3e} (mma.sync), "
          f"{errors(got, want)[1]:.3e} (wgmma)", flush=True)
    return rows


VALUE_TF32_LAUNCHES = {  # kernel name in the profile: launch
    "pack_tf32_kernel": "pack", "value_tf32_kernel": "value"}


def value_tf32_rows(args, ucfg, whole: dict) -> list:
    """#3 at the 3xTF32 tier on csrc/mlp_value_tf32.cu, launch by launch,
    on the inputs of `whole` (their row as one function): each launch's
    device time (torch.profiler), its bound from value_tf32_launch_costs
    (three TF32 passes) and its output against the plain version of that
    launch on the same inputs: the prologue against pack_weights_tf32's
    forward-only pack bit for bit, the value kernel's udf against
    value_plain (KERNEL_RTOL). Then csrc/mlp_value.cu's mma.sync design and
    the wgmma kernels timed in turns (old, new, new, old)."""
    import torch

    from emap_tpu_torch.kernels import mlp_query

    x, w = args[:2]
    n = x.shape[1]
    parts = mlp_query.value_tf32_parts(*args, ucfg)
    torch.cuda.synchronize()
    costs = mlp_query.value_tf32_launch_costs(ucfg, n)
    times = launch_times(lambda: mlp_query.value_tf32_parts(*args, ucfg), 3,
                         tuple(VALUE_TF32_LAUNCHES))
    plain_ms = {
        "pack": time_ms(lambda: mlp_query.pack_weights_tf32(
            w, ucfg, transposed=False), 2)[0],
        "value": time_ms(lambda: mlp_query.value_plain(*args, ucfg), 2)[0],
    }
    pack = mlp_query.pack_weights_tf32(w, ucfg, transposed=False)
    check(torch.equal(parts["pack"], pack), f"{whole['name']}: the pack "
          f"differs from pack_weights_tf32's forward blocks")
    want = {"udf": mlp_query.value_plain(*args, ucfg)}
    held = {
        "pack": ({"pack": parts["pack"]}, {"pack": pack}, 0.0),
        "value": ({"udf": parts["udf"]}, want, KERNEL_RTOL),
    }
    rows = launch_rows(whole, VALUE_TF32_LAUNCHES, times, plain_ms, held,
                       costs, peak=TF32_PEAK / TC_PASSES)
    flops, ms = costs["value"]["flops"], times["value_tf32_kernel"]
    print(f"kernel {whole['name']}: value kernel at "
          f"{flops / (ms * 1e9):.1f} TFLOP/s ({flops / 1e12:.3f} TFLOP; the "
          f"3xTF32 bound {TF32_PEAK / TC_PASSES / 1e12:.0f} TFLOP/s), weight "
          f"entries streamed from L2 at "
          f"{costs['value']['stream_bytes'] / (ms * 1e6):.0f} GB/s",
          flush=True)
    in_turns(whole, "mma.sync 3xTF32 (csrc/mlp_value.cu)",
             lambda: mlp_query.value_mma_sync(*args, ucfg),
             lambda: mlp_query.value_tf32_parts(*args, ucfg))
    old = {"udf": mlp_query.value_mma_sync(*args, ucfg)}
    print(f"kernel {whole['name']}: max rel err against the plain version "
          f"{errors(old, want)[1]:.3e} (mma.sync), "
          f"{errors({'udf': parts['udf']}, want)[1]:.3e} (wgmma)", flush=True)
    return rows


VALUE_WGMMA_LAUNCHES = {  # kernel name in the profile: launch
    "pack_kernel": "pack", "value_wgmma_kernel": "value"}


def max_sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def value_wgmma_rows(args, ucfg, whole: dict) -> list:
    """#3 at the bf16 tier on csrc/mlp_value_wgmma.cu, launch by launch, on
    the inputs of `whole` (their row as one function): each launch's device
    time (torch.profiler), its bound from value_wgmma_launch_costs and its
    output against the plain version of that launch on the same inputs:
    the prologue against pack_weights_bf16 bit for bit, the value kernel's
    udf against value_plain (BF16_KERNEL_RTOL). A log line, not the rows,
    gives beside the value launch the design's floors, reckoned from counts
    and rates (its products at the bf16 peak; its softplus's
    special-function operations at SFU_PER_SM_CLOCK an SM at the card's
    largest SM clock), and the weight chunks it streams from L2 by the plan
    over the launch's time. Then csrc/mlp_value.cu's mma.sync design and
    the wgmma kernels timed in turns (old, new, new, old)."""
    import torch

    from emap_tpu_torch.kernels import mlp_query

    x, w = args[:2]
    n = x.shape[1]
    parts = mlp_query.value_wgmma_parts(*args, ucfg)
    torch.cuda.synchronize()
    costs = mlp_query.value_wgmma_launch_costs(ucfg, n)
    times = launch_times(lambda: mlp_query.value_wgmma_parts(*args, ucfg), 3,
                         tuple(VALUE_WGMMA_LAUNCHES))
    plain_ms = {
        "pack": time_ms(lambda: mlp_query.pack_weights_bf16(w, ucfg), 2)[0],
        "value": time_ms(lambda: mlp_query.value_plain(*args, ucfg), 2)[0],
    }
    wb = mlp_query.pack_weights_bf16(w, ucfg)
    check(torch.equal(parts["wb"], wb), f"{whole['name']}: the pack "
          f"differs from pack_weights_bf16")
    want = {"udf": mlp_query.value_plain(*args, ucfg)}
    held = {
        "pack": ({"wb": parts["wb"].float()}, {"wb": wb.float()}, 0.0),
        "value": ({"udf": parts["udf"]}, want, BF16_KERNEL_RTOL),
    }
    rows = launch_rows(whole, VALUE_WGMMA_LAUNCHES, times, plain_ms, held,
                       costs)
    cost, ms = costs["value"], times["value_wgmma_kernel"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    floors = {
        "products": 1e3 * cost["flops"] / BF16_PEAK,
        "special_function_unit": 1e3 * cost["sfu_ops"] / (
            mlp_query.SFU_PER_SM_CLOCK * sms * clock)}
    stream = cost["stream_bytes"] / (ms * 1e6)
    print(f"kernel {whole['name']}: value kernel at "
          f"{cost['flops'] / (ms * 1e9):.1f} TFLOP/s "
          f"({cost['flops'] / 1e12:.3f} TFLOP; the bf16 bound "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s); the design's floors: products "
          f"{floors['products']:.3f} ms, softplus "
          f"{floors['special_function_unit']:.3f} ms "
          f"({cost['sfu_ops'] / 1e9:.2f} G special-function operations at "
          f"{mlp_query.SFU_PER_SM_CLOCK} a clock on each of {sms} SMs at "
          f"{clock / 1e6:.0f} MHz); the plan's weight chunks from L2 "
          f"({cost['stream_bytes'] / 1e9:.2f} GB) over the launch's time: "
          f"{stream:.0f} GB/s",
          flush=True)
    in_turns(whole, "mma.sync bf16 (csrc/mlp_value.cu)",
             lambda: mlp_query.value_mma_sync(*args, ucfg),
             lambda: mlp_query.value_wgmma_parts(*args, ucfg))
    old = {"udf": mlp_query.value_mma_sync(*args, ucfg)}
    print(f"kernel {whole['name']}: max rel err against the plain version "
          f"{errors(old, want)[1]:.3e} (mma.sync), "
          f"{errors({'udf': parts['udf']}, want)[1]:.3e} (wgmma)", flush=True)
    return rows


def blocks_of(out, ucfg) -> dict:
    from emap_tpu_torch.kernels import mlp_query

    layers = mlp_query.unpack_weights(*out, ucfg)
    return {f"lin{l}/{k}": t for l, (wl, bl) in enumerate(layers)
            for k, t in (("W", wl), ("b", bl))}


def sliced_row(ucfg, n: int) -> dict:
    """The sliced value-and-gradient query at n points (one line-direction
    call of the extraction) against its plain version, at ucfg's tier, with
    the extraction's residuals (bf16 at "default" and "high": the gradient
    held to RESIDUAL_FLIP_RTOL at "high"); at an fp32 tier also with fp32
    residuals against the plain version's at KERNEL_RTOL, and timed in
    turns with csrc/mlp_query.cu's mma.sync design over the same slices."""
    import torch

    from emap_tpu_torch.kernels import mlp_query

    w, b = packed_weights(ucfg)
    x = raw_points(torch.Generator(device="cuda").manual_seed(2), n)
    f32 = 4
    fp32_tier = mlp_query.kernel_tier(ucfg.precision) == 0
    flips = fp32_tier and mlp_query.bf16_residuals(ucfg, False)
    row = kernel_row(
        "mlp_value_and_grad", mlp_query.value_and_grad_sliced,
        sliced_plain, query_blocks, (x, w, b), ucfg, query_source(ucfg),
        "emap_tpu/kernels/mlp_query.py:363",
        f32 * (8 * n + n + 8 * n + w.numel() + b.numel()),
        (mlp_query.query_flops(ucfg) * n, 0),
        tols={"grad": RESIDUAL_FLIP_RTOL} if flips else None)
    row["name"] = f"mlp_value_and_grad_sliced/{row['tier']}"
    if fp32_tier:
        got = query_blocks(mlp_query.value_and_grad_sliced(
            x, w, b, ucfg, f32_residuals=True))
        want = query_blocks(sliced_plain(x, w, b, ucfg, f32_residuals=True))
        got, _ = head_signs(got, want, KERNEL_RTOL)
        _, rel, worst = errors(got, want)
        print(f"kernel {row['name']}, fp32 residuals: max rel err {rel:.3e} "
              f"in block {worst} (tolerance {KERNEL_RTOL:g})", flush=True)
        check(rel <= KERNEL_RTOL, f"{row['name']} with fp32 residuals "
              f"disagrees with its plain version: {rel:.3e} in {worst}")
        # the mma.sync design over the same slices, fp32 residuals on both
        cap = mlp_query.SLICE_CAP
        in_turns(row, "mma.sync 3xTF32 (csrc/mlp_query.cu), sliced",
                 lambda: [mlp_query.value_and_grad_mma_sync(
                     x[:, s: s + cap].contiguous(), w, b, ucfg)
                     for s in range(0, n, cap)],
                 lambda: mlp_query.value_and_grad_sliced(
                     x, w, b, ucfg, f32_residuals=True))
    return row


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
    # phase 6 at one fit draw a threshold (the conf: 4), to keep the run
    # inside its time with phases 10 and 11
    conf["edge_extraction.fit_draws"] = 1
    path = os.path.join(tmp, "ABC_smoke.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def first_step_check(conf_path: str, cli_loss: float) -> None:
    """The first step's loss and grads from a fresh state: kernel path vs
    the CLI's first step and vs the plain autograd path, both at the conf's
    tiers; at the bf16 tier the kernel path must also sit nearer the
    autograd path than the kernel path at the fp32 tier."""
    import dataclasses

    import torch

    from emap_tpu_torch import config
    from emap_tpu_torch.data.dataset import sample_rays
    from emap_tpu_torch.train import schedules
    from emap_tpu_torch.train.runner import Runner
    from emap_tpu_torch.train.step import image_index, loss_and_grads

    runner = Runner(config.parse_file(conf_path), "train", device="cuda")
    st, tcfg = runner.state, runner.tcfg
    batch = sample_rays(runner.pool, image_index(st, runner.scene.n_images),
                        st.generator, tcfg.batch_size,
                        importance_sample=tcfg.importance_sample)
    at_0 = (schedules.cos_anneal_ratio(0, tcfg.anneal_end),
            schedules.flip_saturation(0, float(tcfg.end_iter)))
    gen_state = st.generator.get_state()
    loss_k, _, grads_k = loss_and_grads(st.params, batch, st.generator,
                                        tcfg, runner.rcfg, runner.ucfg, *at_0)
    st.generator.set_state(gen_state)
    plain_cfg = dataclasses.replace(runner.ucfg, pallas_train="off")
    loss_p, _, grads_p = loss_and_grads(st.params, batch, st.generator,
                                        tcfg, runner.rcfg, plain_cfg, *at_0)
    loss_k, loss_p = float(loss_k), float(loss_p)
    gk, gp = named_leaves(grads_k), named_leaves(grads_p)
    _, grad_rel, worst = errors(gk, gp)
    bf16 = "default" in (runner.tiers["field"], runner.tiers["adjoint"])
    tol = STEP_GRAD_RTOL_BF16 if bf16 else STEP_GRAD_RTOL
    loss_tol = STEP_LOSS_RTOL_BF16 if bf16 else STEP_LOSS_RTOL
    print(f"first step at the tiers {runner.tiers}: CLI loss "
          f"{cli_loss:.7f}, kernel path {loss_k:.7f}, autograd path "
          f"{loss_p:.7f}; grads max rel err {grad_rel:.3e} in {worst} "
          f"(tolerance {tol:g})", flush=True)
    if bf16:
        st.generator.set_state(gen_state)
        fp32 = dataclasses.replace(runner.rcfg, field_precision="high",
                                   sampler_precision="high")
        loss_f, _, grads_f = loss_and_grads(
            st.params, batch, st.generator, tcfg, fp32,
            dataclasses.replace(runner.ucfg, bwd_precision=""), *at_0)
        _, rel_f, worst_f = errors(gk, named_leaves(grads_f))
        print(f"first step: the kernel path at the fp32 tier, loss "
              f"{float(loss_f):.7f}, grads max rel err {rel_f:.3e} in "
              f"{worst_f} from the bf16 kernel path", flush=True)
        check(STEP_SEPARATION * grad_rel < rel_f, "the bf16 kernel path is "
              "not nearer the bf16 autograd path than the fp32 kernel path")
    check(abs(loss_k - cli_loss) <= STEP_LOSS_RTOL * abs(cli_loss),
          "the CLI's first step differs from the kernel path's replay")
    check(abs(loss_k - loss_p) <= loss_tol * abs(loss_p),
          f"kernel-path loss differs from the autograd path (tolerance "
          f"{loss_tol:g})")
    check(all(bool(torch.isfinite(g).all()) for g in gk.values()),
          "non-finite gradients")
    check(grad_rel <= tol,
          f"kernel-path grads differ from autograd: {grad_rel:.3e}")


# the host-side CUDA calls that put work on the device
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemsetAsync",
                     "cudaMemcpyAsync")


def profile_window(fn, steps: int) -> dict:
    """torch.profiler over `fn()`, which runs `steps` training steps:
    kernel time and kernel launches on the device a step, the host's CUDA
    launch calls a step, and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    host = {e.key: e.count for e in events
            if e.device_type == DeviceType.CPU and e.key in HOST_LAUNCH_CALLS}
    return {
        "busy_ms": sum(dev_us(e) for e in kernels) / (1e3 * steps),
        "kernel_names": len(kernels),
        "launches": sum(e.count for e in kernels) / steps,
        "host_calls": sum(host.values()) / steps,
        "host_by_call": {k: v / steps for k, v in sorted(host.items())},
        "top": [(dev_us(e) / (1e3 * steps), e.count / steps, e.key)
                for e in sorted(kernels, key=dev_us, reverse=True)[:12]],
    }


def print_profile(name: str, prof: dict, ms: float) -> None:
    print(f"profile {name}: {prof['busy_ms']:.2f} ms/step of kernel time on "
          f"the device, {prof['kernel_names']} kernel names, "
          f"{prof['launches']:.0f} kernel launches/step on the device, "
          f"{prof['host_calls']:.1f} host launch calls/step "
          f"{prof['host_by_call']}; idle share "
          f"{1.0 - prof['busy_ms'] / ms:.3f} of the un-profiled "
          f"{ms:.2f} ms/step", flush=True)
    for busy, count, key in prof["top"]:
        print(f"profile {name}:   {busy:9.3f} ms/step  {count:7.1f}/step  "
              f"{key[:100]}", flush=True)


def step_phase(runner, smi: str) -> float:
    """The eager step on the kernels vs the eager step on the plain
    autograd path (in turns, kernel-plain-plain-kernel), then device time
    by kernel over two kernel-path steps from torch.profiler. These steps
    continue training the runner's state; the launch counts were read
    before. Returns the eager step's host launch calls a step."""
    import dataclasses

    import torch

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
    print(f"step: eager, kernels {times['kernels']} ms, plain autograd "
          f"{times['plain']} ms per step on {smi}", flush=True)

    def two_steps():
        for _ in range(2):
            fns["kernels"](runner.state, runner.pool)

    prof = profile_window(two_steps, 2)
    print_profile("eager step", prof, ms["kernels"])
    return prof["host_calls"]


def train_keys(runner) -> dict:
    """The launch-count keys of the training kernels at the runner's
    resolved tiers (its training field query's config)."""
    from emap_tpu_torch.render.renderer import field_config

    field = field_config(runner.rcfg, runner.ucfg)
    return {k: f"{k}/{tier_name(k, field)}"
            for k in ("mlp_value_and_grad", "mlp_train_bwd")}


def copied_state(runner, rcfg=None):
    """A new TrainState equal to the runner's, its generator's state
    included (through the host, as a checkpoint would)."""
    from emap_tpu_torch.ckpt.convert import (
        checkpoint_payload,
        state_from_payload,
    )

    st = state_from_payload(checkpoint_payload(runner.state, 1.0),
                            runner.ucfg, runner.tcfg.seed, "cuda")
    st.generator.set_state(runner.state.generator.get_state())
    return st


def state_snapshot(state) -> dict:
    """Every tensor of a TrainState on the host, by name: parameters, Adam
    moments and counts, gates, the step and the generator's state."""
    import numpy as np

    from emap_tpu_torch.ckpt.convert import checkpoint_payload

    out = {k: np.asarray(v) for k, v in named_leaves(
        checkpoint_payload(state, 0.0)).items()}
    out["generator"] = state.generator.get_state().numpy()
    return out


def differing(got: dict, want: dict) -> list:
    import numpy as np

    return [k for k in want if not np.array_equal(got[k], want[k])]


def replays_equal_eager(runner, rcfg, chain: int, label: str) -> tuple:
    """From one copied state of the runner: 2 x chain eager steps against
    two chained calls of `chain` steps (a warm-up step, the capture, then 2
    x chain - 1 replays) at rcfg, every state tensor and metric row bit for
    bit. Returns (the chained step, its state)."""
    import torch

    from emap_tpu_torch.train.step import (
        build_chained_train_step,
        build_train_step,
        pack_metrics,
    )

    pool = runner.pool
    args = (runner.tcfg, rcfg, runner.ucfg, runner.scene.n_images)
    eager_st, graph_st = copied_state(runner), copied_state(runner)
    single = build_train_step(*args)
    want = torch.stack([pack_metrics(single(eager_st, pool))
                        for _ in range(2 * chain)])
    chained = build_chained_train_step(*args, chain)
    got = torch.cat([chained(graph_st, pool) for _ in range(2)])
    torch.cuda.synchronize()
    leaves = differing(state_snapshot(graph_st), state_snapshot(eager_st))
    bad = torch.nonzero(got != want)
    bad_rows = sorted({int(i) for i in bad[:, 1]})
    print(f"{label}: {2 * chain} steps, eager vs a warm-up step + "
          f"{2 * chain - 1} replays: differing state tensors "
          f"{leaves or 'none'}; differing metric columns {bad_rows or 'none'}"
          + (f" from step {int(bad[:, 0].min())} of the chained calls"
             if len(bad) else "") + "; capture counted "
          f"{chained.captured_launches}, replays ran "
          f"{chained.replayed_launches}", flush=True)
    check(not leaves and not bad_rows, f"{label}: graph replays differ from "
          f"eager steps in {leaves} and metric columns {bad_rows}")
    return chained, graph_st


def graph_phase(runner, smi: str, eager_host_calls: float) -> None:
    """The CUDA graph of the step (train/step.py::ChainedStep) at ABC
    width. From one copied state, for `classical` and then `mix`
    up-sampling: 2 x GRAPH_CHAIN eager steps against two chained calls of
    GRAPH_CHAIN (a warm-up step, the capture, then 2 x GRAPH_CHAIN - 1
    replays), every state tensor and metric row bit for bit, and the
    kernel launches as reckoned; a capture alone (a chain of 1) leaves the
    state of one eager step. Then the replays' ms/step and a profile of two
    replays: device time a step, idle share, and the host's launch calls a
    step against the eager step's."""
    import dataclasses

    import torch

    from emap_tpu_torch.train.step import (
        build_chained_train_step,
        build_train_step,
    )

    pool, n_images = runner.pool, runner.scene.n_images
    timed = None
    for kind in ("classical", "mix"):
        rcfg = dataclasses.replace(runner.rcfg, upsampling_type=kind)
        chained, graph_st = replays_equal_eager(runner, rcfg, GRAPH_CHAIN,
                                                f"graph {kind}")
        check(chained.replayed_launches[train_keys(runner)["mlp_train_bwd"]]
              == 2 * GRAPH_CHAIN - 1, "the replays' launches are not "
              "reckoned")
        if kind == "classical":
            timed = (chained, graph_st)
        else:
            chained.release()

    # a capture alone: the state of one eager step
    eager_st, graph_st = copied_state(runner), copied_state(runner)
    args = (runner.tcfg, runner.rcfg, runner.ucfg, n_images)
    build_train_step(*args)(eager_st, pool)
    once = build_chained_train_step(*args, 1)
    once(graph_st, pool)
    torch.cuda.synchronize()
    leaves = differing(state_snapshot(graph_st), state_snapshot(eager_st))
    print(f"graph: a warm-up step and a capture leave the state of one eager "
          f"step: differing state tensors {leaves or 'none'}", flush=True)
    check(not leaves, f"the capture changed the state: {leaves}")
    once.release()

    chained, st = timed
    ms, host_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chained(st, pool)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ms.append(1e3 * (t2 - t0) / GRAPH_CHAIN)
        host_ms.append(1e3 * (t1 - t0) / GRAPH_CHAIN)
    chained.release()
    print(f"graph: {GRAPH_CHAIN} replays a call, {ms} ms/step, host "
          f"enqueue {host_ms} ms/step, on {smi}", flush=True)

    two = build_chained_train_step(*args, 2)
    two(st, pool)  # warm-up step, capture, one replay
    prof = profile_window(lambda: two(st, pool), 2)
    two.release()
    print_profile("graph replay", prof, sum(ms) / len(ms))
    print(f"graph: host launch calls a step {eager_host_calls:.1f} eager -> "
          f"{prof['host_calls']:.1f} replayed", flush=True)
    check(prof["host_calls"] < eager_host_calls, "the graph did not cut the "
          "host's launches")


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


def regress_cube_field(ucfg, rel: float = 0.0):
    """The ABC-width field regressed onto the analytic UDF of the cube's 12
    edges by plain autograd and Adam: uniform samples in [-1, 1]^3 and
    samples within 0.1 of the edges, from a seed. The loss is the mean
    squared error, or with `rel` > 0 the mean squared error relative to
    (distance + rel), which spends the net's capacity on the valley along
    the edges (phase 11)."""
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
        dist = cube_edge_distance(pts, edges)
        err = udf_value(params, pts, ucfg) - dist
        loss = torch.mean((err / (dist + rel) if rel else err) ** 2)
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
    diffs = dict.fromkeys(thresholds, 0)
    # a GRID_CHUNK_N of the grid at a time, as the extraction launches it
    for start in range(0, count, GRID_CHUNK_N):
        m = min(GRID_CHUNK_N, count - start)
        x = torch.zeros(8, m, device="cuda")
        x[:3] = grid_points(start, m, res, "cuda").T
        got = torch.clamp(mlp_query.value(x, w, b, ucfg), min=0.0)
        want = torch.clamp(mlp_query.value_plain(x, w, b, ucfg), min=0.0)
        for t in thresholds:
            diffs[t] += int(((got <= t) != (want <= t)).sum())
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


def extraction_launches(trace: list, ucfg, n_jitter: int, wall: float,
                        smi: str) -> int:
    """Phases 6, 9, 10 and 11's reckoning of an extraction's launches at ucfg's
    tier from its trace: one value launch per grid chunk and per probe
    certification; per feature batch of m live candidates one
    value-and-gradient launch, plus one per SLICE_CAP of its m * sampling_N
    line-direction samples (padded to the tile). Checks the kernels' runs
    since zero_counts() against it, no launch at another tier and none of
    the backward; prints the stages. Returns the points of the largest
    line-direction call."""
    from emap_tpu_torch.extract.pointcloud import GRID_CHUNK, POINT_BATCH
    from emap_tpu_torch.kernels import mlp_query

    launches = ran()
    value_key = f"mlp_value/{tier_name('mlp_value', ucfg)}"
    vg_key = f"mlp_value_and_grad/{tier_name('mlp_value_and_grad', ucfg)}"

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
    if "fit_score" in stages:
        print(f"extract: host fits {fit_s:.1f} s, selector scoring "
              f"{sum(t['seconds'] for t in stages['fit_score']) - fit_s:.1f}"
              f" s", flush=True)
    print(f"extract: {wall:.1f} s through emap_tpu_torch.cli (set-up "
          f"included) on {smi}; launches "
          f"{ {k: v for k, v in launches.items() if v} }, reckoned "
          f"{value_key} {want_value}, {vg_key} {want_vg}", flush=True)
    check(launches[value_key] == want_value > 0,
          f"{value_key} launched {launches[value_key]} times, reckoned "
          f"{want_value}")
    check(launches[vg_key] == want_vg > 0,
          f"{vg_key} launched {launches[vg_key]} times, reckoned {want_vg}")
    others = {k: v for k, v in launches.items()
              if v and k not in (value_key, vg_key)}
    check(not others, f"the extraction launched other kernels or tiers: "
          f"{others}")
    return max(linedir_points(min(POINT_BATCH, t["points"]))
               for t in sweeps if t["linedir"])


def fixture_checkpoint(conf_path: str, ucfg) -> dict:
    """Phase 6's fixture: the cube field (regress_cube_field) saved as the
    smoke run's checkpoint, from which `--mode extract_edge` reads it.
    Returns its params."""
    from emap_tpu_torch import config
    from emap_tpu_torch.ckpt.convert import checkpoint_payload
    from emap_tpu_torch.ckpt.native import save_pytree
    from emap_tpu_torch.train.runner import Runner

    t0 = time.perf_counter()
    params = regress_cube_field(ucfg)
    trainer = Runner(config.parse_file(conf_path), "train", device="cuda")
    trainer.state.params["udf"] = params
    save_pytree(os.path.join(trainer._ckpt_dir(), "ckpt_best.npz"),
                checkpoint_payload(trainer.state, 0.01))
    print(f"extract: fixture and checkpoint in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    return params


def extract_phase(conf_path: str, ucfg, row_of: dict, smi: str) -> dict:
    """Phase 6: `--mode extract_edge` with the ABC conf's edge_extraction
    block on the regressed cube field; the launches against a reckoning
    from the trace's candidate counts, the result files, the geometry.
    Returns the sliced value-and-gradient kernel's row, checked at the
    largest line-direction call of the run."""
    import numpy as np
    import torch

    from emap_tpu_torch import cli, config
    from emap_tpu_torch.data.synthetic import cube_edges
    from emap_tpu_torch.extract import pointcloud
    from emap_tpu_torch.utils.ply import read_ply_points

    params = fixture_checkpoint(conf_path, ucfg)
    conf = config.parse_file(conf_path)
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
    zero_counts()
    t0 = time.perf_counter()
    try:
        runner = cli.main(["--conf", conf_path, "--mode", "extract_edge"],
                          n_devices=1)
        torch.cuda.synchronize()
    finally:
        pointcloud.grid_masks, pointcloud._run_point_batches = grid, batches
        torch.linalg.eigh = eigh
    wall = time.perf_counter() - t0
    launches = ran()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"extract: peak device memory {peak:.2f} GiB", flush=True)
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

    linedir_n = extraction_launches(runner.extract_trace, ucfg, n_jitter,
                                    wall, smi)
    row_of[f"mlp_value/{tier_name('mlp_value', ucfg)}"]["launches"] = (
        launches[f"mlp_value/{tier_name('mlp_value', ucfg)}"])

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
    row["launches"] = launches[
        f"mlp_value_and_grad/{tier_name('mlp_value_and_grad', ucfg)}"]
    check(len(grams) == 1, "the extraction solved no line directions")
    eigen_signs(grams[0])
    return row


def eigen_signs(gram) -> None:
    """The smallest eigenvectors of (B, 3, 3) Gram matrices from cuSOLVER
    (on the card) against LAPACK's (torch on the host): how many point the
    other way as the solvers return them (printed), and, turned by
    extract/pointcloud.py::canonical_sign as the extraction turns them,
    none where the two solvers agree on the axis (|dot| >= 0.99) and its
    two largest components are not within 1e-3 of a tie."""
    import torch

    from emap_tpu_torch.extract.pointcloud import canonical_sign

    on_card = torch.linalg.eigh(gram)[1][:, :, 0]
    on_host = torch.linalg.eigh(gram.cpu())[1][:, :, 0]
    dots = (on_card.cpu() * on_host).sum(-1)
    flipped = int((dots < 0).sum())
    # |dot| well below 1: the two solvers return different directions, not
    # only different signs (a near-degenerate smallest eigenvalue)
    apart = dots.abs() < 0.99
    top2 = on_host.abs().sort(dim=-1).values[:, 1:]
    tie = (top2[:, 1] - top2[:, 0]) < 1e-3
    turned = ((canonical_sign(on_card).cpu() * canonical_sign(on_host))
              .sum(-1) < 0) & ~apart & ~tie
    print(f"extract: line directions of the first {len(gram):,} Gram "
          f"matrices of the line-direction sweep: cuSOLVER and LAPACK "
          f"smallest eigenvectors differ in sign for {flipped:,} "
          f"({flipped / len(gram):.4f}); {int(apart.sum()):,} of them are "
          f"more than sign apart (|dot| < 0.99); after canonical_sign "
          f"{int(turned.sum())} differ in sign away from a tie", flush=True)
    check(int(turned.sum()) == 0, "canonical_sign leaves cuSOLVER's and "
          "LAPACK's line directions pointing apart")


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


def route_conf(conf_path: str, tmp: str, name: str, pins: dict,
               extract: bool = False) -> str:
    """A copy of the smoke conf with the keys `pins` set: training
    ROUTE_ITER steps (one chained call, no validation) in an experiment
    directory of its own; or, with `extract`, in the smoke run's, whose
    checkpoint (phase 6's field) it extracts at the conf's udf_threshold
    with one fit."""
    from emap_tpu_torch import config

    conf = config.parse_file(conf_path)
    for k, v in pins.items():
        conf[k] = v
    if extract:
        conf["edge_extraction.auto_threshold"] = []
        conf["edge_extraction.fit_draws"] = 1
    else:
        conf["general.base_exp_dir"] = os.path.join(tmp, f"route_{name}")
        for k in ("end_iter", "report_freq", "save_freq"):
            conf[f"train.{k}"] = ROUTE_ITER
        conf["train.val_freq"] = 100 * ROUTE_ITER
    path = os.path.join(tmp, f"route_{name}.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


# Phase 9's training routes: the pinned keys, the route and the kernel
# tiers (launch-count keys) each must take.
TRAIN_ROUTES = (
    ("precision_highest", {"model.udf_network.precision": "highest"},
     "autograd", ()),
    ("field_high", {"model.udf_renderer.field_precision": "high"}, "kernels",
     ("mlp_value_and_grad/3xtf32", "mlp_train_bwd/3xtf32")),
    ("field_high_bwd_default", {"model.udf_renderer.field_precision": "high",
                                "model.udf_network.bwd_precision": "default"},
     "kernels", ("mlp_value_and_grad/3xtf32", "mlp_train_bwd/3xtf32+bf16")),
)


def replay_ms(runner, calls: int = 2) -> float:
    """ms a step of the runner's step as CUDA graph replays: from a copy of
    its state, one chained call of ROUTE_ITER steps (a warm-up step, the
    capture, replays), then `calls` more timed (replays alone)."""
    import torch

    from emap_tpu_torch.train.step import build_chained_train_step

    st = copied_state(runner)
    chained = build_chained_train_step(runner.tcfg, runner.rcfg, runner.ucfg,
                                       runner.scene.n_images, ROUTE_ITER)
    chained(st, runner.pool)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        chained(st, runner.pool)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (calls * ROUTE_ITER)
    chained.release()
    return ms


def route_phase(conf_path: str, tmp: str, row_of: dict, smi: str,
                sweep_n: int) -> dict:
    """Phase 9: the routes the tier keys select, each through the CLI with
    the counts set to 0 before it and read after it; the kernel rows of
    tiers off the main path take their launches from these runs. Returns
    the sliced value-and-gradient query's row at the bf16 tier, held and
    timed at sweep_n points, phase 6's line-direction call (this run's own,
    at one threshold, is smaller)."""
    import numpy as np
    import torch

    from emap_tpu_torch import cli, config
    from emap_tpu_torch.data.synthetic import cube_edges
    from emap_tpu_torch.utils.ply import read_ply_points

    for name, pins, route, keys in TRAIN_ROUTES:
        path = route_conf(conf_path, tmp, name, pins)
        zero_counts()
        t0 = time.perf_counter()
        runner = cli.main(["--conf", path, "--mode", "train"], n_devices=1)
        torch.cuda.synchronize()
        launches = ran(runner)
        got = {k: v for k, v in launches.items() if v}
        losses = [h["loss"] for h in runner.history]
        print(f"route {name} ({pins}): tiers {runner.tiers}; "
              f"{runner.state.step} steps in {time.perf_counter() - t0:.1f} "
              f"s, losses {[round(x, 5) for x in losses]}; kernel runs "
              f"{got or 'none'}", flush=True)
        check(runner.tiers["route"] == route, f"{name} took the "
              f"{runner.tiers['route']} route, not {route}")
        check(runner.state.step == ROUTE_ITER and len(losses) == ROUTE_ITER
              and all(map(math.isfinite, losses)),
              f"{name}: non-finite or missing losses {losses}")
        check(got == {k: ROUTE_ITER for k in keys},
              f"{name} ran {got}, not {keys} once a step")
        for k in keys:
            row_of[k]["launches"] = row_of[k]["launches"] or launches[k]
        if route == "kernels":
            print(f"route {name}: {replay_ms(runner):.2f} ms/step as CUDA "
                  f"graph replays (chains of {ROUTE_ITER}) on {smi}",
                  flush=True)
        if name == "field_high":
            # #1a's 3xTF32 kernel in the step's CUDA graph
            chained, _ = replays_equal_eager(runner, runner.rcfg, ROUTE_ITER,
                                             f"route {name} graph")
            check(chained.replayed_launches["mlp_value_and_grad/3xtf32"]
                  == 2 * ROUTE_ITER - 1, f"{name}: the replays did not run "
                  f"the 3xTF32 query kernel")
            chained.release()
        del runner
        torch.cuda.empty_cache()

    pins = {"model.udf_network.precision": "default"}
    path = route_conf(conf_path, tmp, "extract_default", pins, extract=True)
    zero_counts()
    t0 = time.perf_counter()
    runner = cli.main(["--conf", path, "--mode", "extract_edge"], n_devices=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran()
    print(f"route extract_default ({pins}): tiers {runner.tiers}", flush=True)
    check(runner.tiers["extraction"] == "default", "the extraction does not "
          "run at the pinned tier")
    ucfg = runner.ucfg
    linedir_n = extraction_launches(
        runner.extract_trace, ucfg,
        runner.conf.get_int("edge_extraction.sampling_N"), wall, smi)
    print(f"route extract_default: largest line-direction call {linedir_n} "
          f"points", flush=True)
    row_of["mlp_value/bf16"]["launches"] = launches["mlp_value/bf16"]
    # the bf16 grid kernel's masks on this field at the ABC block's menu
    ee = config.parse_file(conf_path).get_config("edge_extraction")
    mask_disagreement(
        {k: {m: t.detach() for m, t in layer.items()}
         for k, layer in runner.state.params["udf"].items()}, ucfg,
        ee.get_int("resolution"),
        [float(t) for t in ee.get_list("auto_threshold")])
    results = os.path.join(runner.base_exp_dir, "results")
    edge_pts, _ = read_ply_points(os.path.join(results, "edge_points.ply"))
    check(len(edge_pts) > 0 and bool(np.isfinite(edge_pts).all()),
          f"route extract_default: {len(edge_pts)} edge points, or "
          f"non-finite ones")
    dist = cube_edge_distance(
        torch.as_tensor(edge_pts, dtype=torch.float32, device="cuda"),
        torch.as_tensor(cube_edges(0.5), dtype=torch.float32, device="cuda"))
    print(f"route extract_default: {len(edge_pts)} edge points, to the "
          f"cube's edges: median {float(dist.median()):.5f}, 90th percentile "
          f"{float(dist.quantile(0.9)):.5f}", flush=True)
    row = sliced_row(ucfg, sweep_n)
    row["launches"] = launches["mlp_value_and_grad/bf16"]
    return row


def pidinet_scene(tmp: str) -> str:
    """Phases 10 and 11's scene: phase 4's cube and cameras with PidiNet
    edge maps, the detector confs/DTU.conf and confs/Replica.conf read (the
    visibility filter reads them as they are, without DexiNed's
    inversion)."""
    from emap_tpu_torch.data import make_synthetic_scene

    data_dir = os.path.join(tmp, "data_pidinet")
    t0 = time.perf_counter()
    make_synthetic_scene(data_dir, scan="cube000", n_views=24, H=400, W=400,
                         detector="PidiNet")
    print(f"PidiNet scene written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return data_dir


def conf_copy(name: str, tmp: str, data_dir: str, tag: str = "",
              **overrides) -> str:
    """A copy of confs/<name>.conf on the PidiNet scene, in an experiment
    directory of its own (named after `name` and `tag`), with `far` 4.5
    (the scene's cameras orbit at radius 2.2, as in
    scripts/torch_run_production.py) and `overrides`."""
    from emap_tpu_torch import config

    conf = config.parse_file(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "confs", f"{name}.conf"))
    conf["general.base_exp_dir"] = os.path.join(tmp, f"{name}{tag}_exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    conf["dataset.far"] = 4.5
    for k, v in overrides.items():
        conf[k] = v
    path = os.path.join(tmp, f"{name}{tag}_smoke.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def renamed(row: dict, suffix: str) -> dict:
    row["name"] = f"{row['name']}/{suffix}"
    if "part_of" in row:
        row["part_of"] = f"{row['part_of']}/{suffix}"
    return row


def part_launches(rows) -> None:
    """Each launch row of a kernel set takes its wrapper row's launches."""
    row_of = {r["name"]: r for r in rows}
    for r in rows:
        if "part_of" in r:
            r["launches"] = row_of[r["part_of"]]["launches"]


def replica_train_run(path: str, label: str, smi: str) -> tuple:
    """REPLICA_ITER steps of a copy of confs/Replica.conf (chain 5: a
    warm-up step, a capture, replays) with one validation, through the CLI:
    the tiers the conf resolves to, the training kernels' runs reckoned
    (#2 once a step, #1a once a step and once a validation chunk, nothing
    else) and every loss finite. Returns (runner, launches, keys)."""
    import torch

    from emap_tpu_torch import cli

    zero_counts()
    t0 = time.perf_counter()
    runner = cli.main(["--conf", path, "--mode", "train"], n_devices=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran(runner)
    keys = train_keys(runner)
    h, w = (runner.scene.H // runner.validate_resolution_level,
            runner.scene.W // runner.validate_resolution_level)
    val_chunks = -(-h * w // runner.batch_size)
    losses = [r["loss"] for r in runner.history]
    (s0, t_first), (s1, t_last) = runner.timeline[1], runner.timeline[-1]
    print(f"{label}: {REPLICA_ITER} steps and one validation through "
          f"emap_tpu_torch.cli in {wall:.1f} s at the tiers {runner.tiers}; "
          f"{1e3 * (t_last - t_first) / (s1 - s0):.2f} ms/step over steps "
          f"{s0 + 1}-{s1} on {smi}; launches "
          f"{ {k: v for k, v in launches.items() if v} }, {val_chunks} of "
          f"them validation chunks; losses "
          f"{[round(x, 5) for x in losses]}", flush=True)
    check(runner.tiers == {"field": "default", "adjoint": "default",
                           "sampler": "default", "extraction": "high",
                           "route": "kernels"},
          f"Replica.conf resolved to the tiers {runner.tiers}")
    check(runner.replayed_launches.get(keys["mlp_train_bwd"], 0) > 0,
          f"the {label} run did not go through the kernels and the graph")
    check(runner.state.step == REPLICA_ITER and len(losses) == REPLICA_ITER
          and all(map(math.isfinite, losses)),
          f"{label} run: step {runner.state.step}, losses {losses}")
    check(launches[keys["mlp_train_bwd"]] == REPLICA_ITER,
          f"{keys['mlp_train_bwd']} ran {launches[keys['mlp_train_bwd']]} "
          f"times in {REPLICA_ITER} steps")
    check(launches[keys["mlp_value_and_grad"]] == REPLICA_ITER + val_chunks,
          f"{keys['mlp_value_and_grad']} ran "
          f"{launches[keys['mlp_value_and_grad']]} times, not "
          f"{REPLICA_ITER} steps + {val_chunks} validation chunks")
    others = {k: v for k, v in launches.items()
              if v and k not in keys.values()}
    check(not others, f"the {label} run launched other kernels: {others}")
    return runner, launches, keys


def replica_phase(tmp: str, data_dir: str, n: int, smi: str) -> list:
    """Phase 10: confs/Replica.conf's field at full width (multires 6: the
    encoded input is d0 = 39 wide, padded to 40; the skip layer takes
    217 + 39 inputs). Each kernel at each of its KERNEL_TIERS against its
    plain version at the step's N and, for the grid value kernel, one
    GRID_CHUNK of a 256^3 pass; then REPLICA_ITER steps of the conf through
    the CLI (chain 5: a warm-up step, a capture, replays) with one
    validation, the first step against plain autograd, and the conf's
    extraction device stages (256^3 grid, the 6-threshold menu, the point
    shift and line directions) on the trained field, their launches
    against the reckoning from their trace. Returns the rows of the
    kernels and tiers these runs launch; the other tiers' rows are printed
    and held, not listed."""
    import numpy as np
    import torch

    from emap_tpu_torch import config
    from emap_tpu_torch.extract import pointcloud
    from emap_tpu_torch.fields.udf import UDFConfig
    from emap_tpu_torch.kernels import mlp_query

    path = conf_copy("Replica", tmp, data_dir, **{
        "train.end_iter": REPLICA_ITER, "train.report_freq": 5,
        "train.save_freq": REPLICA_ITER, "train.val_freq": REPLICA_ITER})
    conf = config.parse_file(path)
    rucfg = UDFConfig.from_conf(conf.get_config("model.udf_network"))
    layout = mlp_query.kernel_layout(rucfg)
    print(f"replica: multires {rucfg.multires}, d0 {layout[1]} padded to "
          f"{layout[2]}, layer inputs {list(layout[7::4])}", flush=True)
    check(rucfg.multires == 6 and layout[2] == 40,
          f"Replica.conf's field is not multires 6 at d0p 40: {layout[:8]}")
    rows = [renamed(r, "multires6") for r in kernel_phase(
        rucfg, n, (GRID_CHUNK_N,))]
    row_of = {r["name"]: r for r in rows}

    runner, launches, keys = replica_train_run(path, "replica", smi)
    for key in keys.values():
        row_of[f"{key}/multires6"]["launches"] = launches[key]
    part_launches(rows)
    first_step_check(path, runner.history[0]["loss"])

    # the conf's extraction device stages on the trained field
    ee = conf.get_config("edge_extraction")
    params = {k: {m: t.detach() for m, t in layer.items()}
              for k, layer in runner.state.params["udf"].items()}
    del runner
    torch.cuda.empty_cache()
    mask_disagreement(params, rucfg, ee.get_int("resolution"),
                      [float(t) for t in ee.get_list("auto_threshold")])
    trace = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    clouds = pointcloud.extract_pointcloud_multi(
        params, rucfg, ee.get_int("resolution"),
        [float(t) for t in ee.get_list("auto_threshold")],
        sampling_N=ee.get_int("sampling_N"),
        sampling_delta=ee.get_float("sampling_delta"),
        is_pointshift=ee.get_bool("is_pointshift"),
        iters=ee.get_int("iters"),
        is_linedirection=ee.get_bool("is_linedirection"), trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran()
    print(f"replica: extraction device stages at {ee.get_int('resolution')}"
          f"^3 on the {REPLICA_ITER}-step field: points by threshold "
          f"{ {t: len(p) for t, (p, _) in clouds.items()} }, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    check(all(bool(np.isfinite(p).all()) and bool(np.isfinite(d).all())
              for p, d in clouds.values()), "non-finite points or directions")
    linedir_n = extraction_launches(trace, rucfg, ee.get_int("sampling_N"),
                                    wall, smi)
    value_key = f"mlp_value/{tier_name('mlp_value', rucfg)}"
    row_of[f"{value_key}/multires6"]["launches"] = launches[value_key]
    part_launches(rows)
    row = renamed(sliced_row(rucfg, linedir_n), "multires6")
    row["launches"] = launches[
        f"mlp_value_and_grad/{tier_name('mlp_value_and_grad', rucfg)}"]
    return [r for r in rows if r["launches"]] + [row]


def dtu_phase(tmp: str, data_dir: str, ucfg, value_rows: list,
              smi: str) -> list:
    """Phase 11: `--mode extract_edge` with confs/DTU.conf's edge_extraction
    block unchanged (256^3 grid: 4 launches of the grid value kernel a
    pass; 6 thresholds; iters 1; one fit a threshold; the visibility filter
    over the 24 PidiNet frames) on the cube field regressed with the
    relative loss (DTU_FIXTURE_REL; the DTU conf's net is the ABC conf's);
    the launches against the reckoning from
    the trace, the stage times, the peak device memory, the primitives the
    filter kept and dropped; then the edges scored against the cube's as
    phase 7 scores them, F@20mm at least F20_MIN. Returns the grid value
    kernel's rows at one GRID_CHUNK (`value_rows` from phase 3: the
    function's and its launches') and the sliced value-and-gradient query's
    row at this run's largest line-direction call, with this run's
    launches."""
    import torch

    from emap_tpu_torch import cli, config
    from emap_tpu_torch.ckpt.convert import checkpoint_payload
    from emap_tpu_torch.ckpt.native import save_pytree
    from emap_tpu_torch.eval.synthetic import score_extraction
    from emap_tpu_torch.extract.pointcloud import GRID_CHUNK
    from emap_tpu_torch.train.runner import Runner

    params = regress_cube_field(ucfg, rel=DTU_FIXTURE_REL)
    path = conf_copy("DTU", tmp, data_dir)
    conf = config.parse_file(path)
    ee = conf.get_config("edge_extraction")
    res = ee.get_int("resolution")
    print(f"dtu: edge_extraction {dict(ee.items())}", flush=True)
    trainer = Runner(conf, "train", device="cuda")
    check(trainer.ucfg == ucfg, "DTU.conf's field is not the ABC conf's")
    trainer.state.params["udf"] = params
    save_pytree(os.path.join(trainer._ckpt_dir(), "ckpt_best.npz"),
                checkpoint_payload(trainer.state, 0.01))
    del trainer
    torch.cuda.empty_cache()
    mask_disagreement(params, ucfg, res,
                      [float(t) for t in ee.get_list("auto_threshold")])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    runner = cli.main(["--conf", path, "--mode", "extract_edge"], n_devices=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ran()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trace = runner.extract_trace
    passes = [t for t in trace if t["stage"] == "grid"]
    per_pass = -(-res ** 3 // GRID_CHUNK)
    vis = [t for t in trace if t["stage"] == "visibility"]
    print(f"dtu: {len(passes)} grid passes of {res}^3 points, {per_pass} "
          f"launches of the grid value kernel a pass (GRID_CHUNK "
          f"{GRID_CHUNK:,}); peak device memory {peak:.2f} GiB", flush=True)
    print(f"dtu: visibility filter over {[t['frames'] for t in vis][:1]} "
          f"frames, kept / dropped a fit {[(t['kept'], t['dropped']) for t in vis]}"
          f", {sum(t['seconds'] for t in vis):.2f} s", flush=True)
    check(all(t["points"] == res ** 3 for t in passes) and passes,
          f"the grid passes are not {res}^3: {passes}")
    check(len(vis) == len(ee.get_list("auto_threshold")),
          f"{len(vis)} visibility passes, not one a threshold")
    linedir_n = extraction_launches(trace, ucfg, ee.get_int("sampling_N"),
                                    wall, smi)
    value_key = f"mlp_value/{tier_name('mlp_value', ucfg)}"
    check(launches[value_key] >= per_pass * len(passes), "fewer grid "
          "launches than passes x chunks")
    value_rows[0]["launches"] = launches[value_key]
    part_launches(value_rows)
    with open(os.path.join(runner.base_exp_dir, "results",
                           "parametric_edges.json")) as f:
        edges = json.load(f)
    with open(os.path.join(runner.base_exp_dir, "results",
                           "threshold_selection.json")) as f:
        picked = json.load(f)
    score = score_extraction(runner.base_exp_dir, edges, "cube")
    print(f"dtu: picked threshold {picked['picked']} of "
          f"{[r['udf_threshold'] for r in picked['candidates']]} (f3d "
          f"{[r.get('f3d') for r in picked['candidates']]}); F@5mm "
          f"{score['fscore_0.005']}, F@10mm {score['fscore_0.01']}, F@20mm "
          f"{score['fscore_0.02']}, chamfer {score['chamfer']}; "
          f"{score['n_lines']} lines, {score['n_curves']} curves", flush=True)
    check(score["fscore_0.02"] >= F20_MIN, f"DTU extraction F@20mm "
          f"{score['fscore_0.02']} under {F20_MIN}")
    row = renamed(sliced_row(ucfg, linedir_n), "256^3")
    row["launches"] = launches[
        f"mlp_value_and_grad/{tier_name('mlp_value_and_grad', ucfg)}"]
    return [renamed(r, "256^3") for r in value_rows] + [row]


def nccl_version() -> str:
    import torch

    v = torch.cuda.nccl.version()
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


def counted_collectives(fn) -> tuple:
    """(fn(), the torch.distributed collectives it called)."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "barrier", "broadcast")
    saved = {n: getattr(dist, n) for n in names}
    calls = []

    def counting(name):
        def call(*args, **kwargs):
            calls.append(name)
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, counting(n))
    try:
        return fn(), calls
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def group_step_check(runner, group, smi: str) -> None:
    """Phase 12, the step through a NCCL group of world 1 at ABC width:
    from one copied state, 2 x GRAPH_CHAIN steps without a group, as many
    eager steps of the group, and two chained calls of GRAPH_CHAIN of the
    group (a warm-up step, the capture with its collectives, then
    replays): the three bit for bit in every state tensor and metric row.
    The steps without a group call no collective."""
    import torch

    from emap_tpu_torch.train.step import (
        build_chained_train_step,
        build_train_step,
        pack_metrics,
    )

    pool = runner.pool
    args = (runner.tcfg, runner.rcfg, runner.ucfg, runner.scene.n_images)
    alone_st, eager_st, graph_st = (copied_state(runner) for _ in range(3))
    single = build_train_step(*args)
    want, calls = counted_collectives(lambda: torch.stack(
        [pack_metrics(single(alone_st, pool))
         for _ in range(2 * GRAPH_CHAIN)]))
    check(not calls, f"the step without a group called {calls}")
    grouped = build_train_step(*args, group=group)
    before = group.collectives
    eager = torch.stack([pack_metrics(grouped(eager_st, pool))
                         for _ in range(2 * GRAPH_CHAIN)])
    per_eager = (group.collectives - before) / (2 * GRAPH_CHAIN)
    chained = build_chained_train_step(*args, GRAPH_CHAIN, group=group)
    got = torch.cat([chained(graph_st, pool) for _ in range(2)])
    torch.cuda.synchronize()
    snap = state_snapshot(eager_st)
    vs_eager = differing(state_snapshot(graph_st), snap)
    vs_alone = differing(snap, state_snapshot(alone_st))
    rows_eager = sorted({int(i) for i in torch.nonzero(got != eager)[:, 1]})
    rows_alone = sorted({int(i) for i in torch.nonzero(eager != want)[:, 1]})
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chained(graph_st, pool)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / GRAPH_CHAIN)
    prof = profile_window(lambda: chained(graph_st, pool), GRAPH_CHAIN)
    chained.release()
    nccl_kernels = [(round(t, 4), round(c, 2), k) for t, c, k in prof["top"]
                    if "nccl" in k.lower()]
    print(f"parallel: NCCL {nccl_version()}, a group of world 1 on {smi}: "
          f"{per_eager:g} collectives an eager step; the captured step "
          f"holds {chained.collectives_per_step} (a replay runs them); "
          f"{2 * GRAPH_CHAIN} steps, the group's eager steps vs a warm-up "
          f"step + {2 * GRAPH_CHAIN - 1} replays: differing state tensors "
          f"{vs_eager or 'none'}, metric columns {rows_eager or 'none'}; "
          f"the group's eager steps vs the steps without a group: "
          f"{vs_alone or 'none'}, {rows_alone or 'none'}; replays "
          f"{ms} ms/step; NCCL kernels among a replay's top kernels "
          f"{nccl_kernels or 'none'}", flush=True)
    print_profile("group replay", prof, sum(ms) / len(ms))
    check(chained.collectives_per_step == per_eager == 2,
          f"the step made {per_eager} collectives eagerly and "
          f"{chained.collectives_per_step} in its capture, not 2")
    check(not vs_eager and not rows_eager, f"the group's replays differ "
          f"from its eager steps in {vs_eager}, columns {rows_eager}")
    check(not vs_alone and not rows_alone, f"the group's steps differ from "
          f"the steps without a group in {vs_alone}, columns {rows_alone}")


def group_extract_check(conf_path: str, group, smi: str) -> None:
    """Phase 12, extraction through the group: the ABC conf's device stages
    (extract_pointcloud_multi: 128^3 grid masks, point shift, line
    directions) on phase 6's field, with and without the group, bit for
    bit, with the same launches."""
    import numpy as np
    import torch

    from emap_tpu_torch import config
    from emap_tpu_torch.extract.pointcloud import extract_pointcloud_multi
    from emap_tpu_torch.train.runner import Runner

    conf = config.parse_file(conf_path)
    runner = Runner(conf, "extract_edge", device="cuda")
    runner.load_checkpoint()
    params = {k: {n: t.detach() for n, t in layer.items()}
              for k, layer in runner.state.params["udf"].items()}
    ee = conf.get_config("edge_extraction")
    kw = dict(resolution=ee.get_int("resolution"),
              thresholds=[float(t) for t in ee.get_list("auto_threshold")],
              sampling_N=ee.get_int("sampling_N"),
              sampling_delta=ee.get_float("sampling_delta"),
              is_pointshift=ee.get_bool("is_pointshift"),
              iters=ee.get_int("iters"),
              is_linedirection=ee.get_bool("is_linedirection"))
    out, launches, secs = [], [], []
    before = group.collectives
    # in turns: alone, group, group, alone
    for grp in (None, group, group, None):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(extract_pointcloud_multi(params, runner.ucfg, group=grp,
                                            **kw))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches.append({k: v for k, v in ran().items() if v})
    gathers = (group.collectives - before) // 2
    same = all(sorted(o) == sorted(out[0]) and all(
        np.array_equal(g, w) for t in out[0] for g, w in zip(o[t], out[0][t]))
        for o in out[1:])
    sizes = {t: len(p) for t, (p, _) in out[0].items()}
    print(f"parallel: the ABC block's device stages on phase 6's field, "
          f"alone {secs[0]:.3f} / {secs[3]:.3f} s, through the group "
          f"{secs[1]:.3f} / {secs[2]:.3f} s ({gathers} gathers) on {smi}; "
          f"points by threshold {sizes}; equal bit for bit: {same}; "
          f"launches {launches[0]} / {launches[1]}", flush=True)
    check(same, "the extraction through the group differs from the "
          "extraction without it")
    check(all(x == launches[0] for x in launches),
          "the group changed the launches")


def dense_fields_check(ucfg) -> None:
    """Phase 12, the dense-field helpers on the card: extract_fields through
    the grid value kernel (#3) and extract_gradient_fields through the
    sliced value-and-gradient kernel (#1b), their launches counted, held
    against the field's plain autograd query on the same points (fp32 at
    the model tier: 1e-4 of the largest value; the gradient away from the
    zero set, where the abs head's sign may differ, as in head_signs)."""
    import numpy as np
    import torch

    from emap_tpu_torch.extract.pointcloud import (
        _box_points,
        extract_fields,
        extract_gradient_fields,
    )
    from emap_tpu_torch.fields.udf import (
        init_udf_params,
        udf_value,
        udf_value_and_gradient,
    )

    params = init_udf_params(torch.Generator().manual_seed(7), ucfg,
                             device="cuda")
    box, res = ([-1.0, -0.9, -0.8], [0.9, 1.0, 0.7]), 48
    pts = torch.as_tensor(_box_points(*box, res), device="cuda")
    zero_counts()
    vals = extract_fields(params, ucfg, *box, res, chunk=32768)
    grads = extract_gradient_fields(params, ucfg, *box, res, chunk=32768)
    launches = {k: v for k, v in ran().items() if v}
    with torch.no_grad():
        want_v = udf_value(params, pts, ucfg).cpu().numpy()
    want_g = udf_value_and_gradient(params, pts, ucfg)[1].detach()
    want_g = want_g.cpu().numpy()
    err_v = float(np.abs(vals.ravel() - want_v.ravel()).max()
                  / np.abs(want_v).max())
    off = np.abs(want_v.ravel()) > 1e-4
    err_g = float(np.abs(grads.reshape(-1, 3) - want_g)[off].max()
                  / np.abs(want_g).max())
    n_chunks = -(-res ** 3 // 32768)
    print(f"parallel: extract_fields / extract_gradient_fields at {res}^3 "
          f"in {n_chunks} chunks: launches {launches}; against plain "
          f"autograd {err_v:.2e} / {err_g:.2e} of the largest", flush=True)
    tier = tier_name("mlp_value", ucfg)
    check(launches == {f"mlp_value/{tier}": n_chunks,
                       f"mlp_value_and_grad/{tier}": n_chunks},
          f"the dense-field helpers launched {launches}")
    check(err_v < 1e-4 and err_g < 1e-4, "the dense fields differ from the "
          "plain query")


def multi_rank_check(conf_path: str, tmp: str, smi: str) -> None:
    """Phase 12 where the machine has two cards or more: the smoke conf's
    END_ITER steps and validation through `cli.main` on 2 (and, with four
    cards, 4) spawned NCCL ranks against one process: losses rtol 1e-4,
    parameters rtol 2e-4 / atol 2e-6 (the CPU tests' tolerances), every
    rank's parameters bit for bit, each rank's launches."""
    import numpy as np
    import torch

    from emap_tpu_torch import cli, config

    cards = torch.cuda.device_count()
    worlds = [w for w in (2, 4) if w <= cards]
    if not worlds:
        print(f"parallel: the spawned multi-rank CLI run was not run: it "
              f"needs 2 cards, this machine has {cards}", flush=True)
        return

    def conf_for(world):
        conf = config.parse_file(conf_path)
        conf["general.base_exp_dir"] = os.path.join(tmp, f"world{world}")
        path = os.path.join(tmp, f"world{world}.conf")
        with open(path, "w") as f:
            f.write(conf.to_hocon())
        return path

    one = cli.main(["--conf", conf_for(1), "--mode", "train"], n_devices=1)
    (s0, ta), (s1, tb) = one.timeline[1], one.timeline[-1]
    print(f"parallel: world 1: {1e3 * (tb - ta) / (s1 - s0):.2f} ms/step "
          f"over steps {s0 + 1}-{s1} on {smi}", flush=True)
    losses = np.array([h["loss"] for h in one.history])
    params = {f"{k}/{n}": t.detach().cpu().numpy()
              for k, layer in one.state.params["udf"].items()
              for n, t in layer.items()}
    for world in worlds:
        t0 = time.perf_counter()
        ranks = cli.main(["--conf", conf_for(world), "--mode", "train"],
                         n_devices=world)
        wall = time.perf_counter() - t0
        got = np.array([h["loss"] for h in ranks[0]["history"]])
        loss_err = float(np.max(np.abs(got - losses) / np.abs(losses)))
        worst, over = 0.0, []
        for r in ranks:
            for key, want in params.items():
                layer, name = key.split("/")
                g = r["params"][layer][name]
                worst = max(worst, float(np.max(np.abs(g - want)
                                                 / (np.abs(want) + 1e-30))))
                if not np.allclose(g, want, rtol=2e-4, atol=2e-6):
                    over.append(f"rank {r['rank']} {key}")
        same = all(np.array_equal(r["params"][k][n], ranks[0]["params"][k][n])
                   for r in ranks for k in ranks[0]["params"]
                   for n in ranks[0]["params"][k])
        (s0, ta), (s1, tb) = ranks[0]["timeline"][1], ranks[0]["timeline"][-1]
        print(f"parallel: world {world}: {END_ITER} steps and a validation "
              f"through cli.main in {wall:.1f} s (spawn and set-up "
              f"included), {1e3 * (tb - ta) / (s1 - s0):.2f} ms/step over "
              f"steps {s0 + 1}-{s1} on {smi}; losses vs one process: max "
              f"relative {loss_err:.2e}; parameters: max relative "
              f"{worst:.2e}, outside rtol 2e-4 / atol 2e-6: "
              f"{over[:6] or 'none'}; ranks bit-identical: {same}; "
              f"launches by rank "
              f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}"
              f"; collectives by rank {[r['collectives'] for r in ranks]}",
              flush=True)
        check(loss_err <= 1e-4 and not over and same,
              f"world {world} differs from one process")


def multi_rank_extract_check(conf_path: str, tmp: str, smi: str) -> None:
    """Phase 12 where the machine has two cards or more: `--mode
    extract_edge` through `cli.main` on phase 6's checkpoint (the ABC
    block at 128^3) in one process and on 2 (and, with four cards, 4)
    spawned NCCL ranks, each world in its own copy of the run
    (scripts/torch_sharded_extract.py); every result file byte for byte
    against one process's, every rank through the grid and sweep
    kernels."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_sharded_extract as sharded

    cards = torch.cuda.device_count()
    worlds = [w for w in (2, 4) if w <= cards]
    if not worlds:
        print(f"parallel: the spawned multi-rank extraction was not run: it "
              f"needs 2 cards, this machine has {cards}", flush=True)
        return
    out = os.path.join(tmp, "sharded")
    for world in [1] + worlds:
        path = sharded.prepare(conf_path, out, world)
        got = sharded.extract_world(path, world, "cuda")
        print(f"parallel: extract_edge at world {world} on {smi}:",
              flush=True)
        sharded.report(world, got)
        for r in got["ranks"]:
            idle = [k for k in ("mlp_value", "mlp_value_and_grad")
                    if not any(v for key, v in r["launches"].items()
                               if key.startswith(f"{k}/"))]
            check(not idle, f"world {world} rank {r['rank']} launched no "
                  f"{idle}")
    for world in worlds:
        diff = sharded.first_difference(out, world)
        print(f"parallel: extract_edge at world {world} against one "
              f"process: {diff or 'every result file byte for byte equal'}",
              flush=True)
        check(diff is None, f"the extraction at world {world} differs from "
              f"one process's, first at {diff}")


def parallel_phase(runner, conf_path: str, tmp: str, smi: str) -> None:
    """Phase 12: the multi-device path (parallel/mesh.py). A NCCL group of
    world 1 in this process: the ABC-width step with its collectives
    captured in the CUDA graph, and the extraction's device stages,
    through it (group_step_check, group_extract_check); the dense-field
    helpers' launches; and, on a machine with two cards or more, spawned
    multi-rank runs of the CLI (multi_rank_check)."""
    import torch

    from emap_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    group = mesh.init_group(0, 1, torch.device("cuda", 0))
    print(f"parallel: NCCL group of world 1 made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    try:
        group_step_check(runner, group, smi)
        group_extract_check(conf_path, group, smi)
    finally:
        torch.distributed.destroy_process_group()
    dense_fields_check(runner.ucfg)
    multi_rank_check(conf_path, tmp, smi)
    multi_rank_extract_check(conf_path, tmp, smi)


def gradient_check(ucfg, label: str) -> None:
    """udf_gradient on GRAD_N points of a field at ucfg's width on the card:
    the same bits as udf_value_and_gradient's gradient; against the sliced
    value-and-gradient kernel (#1b) at the 3xTF32 tier with fp32 residuals
    within KERNEL_RTOL of the block's largest, up to the abs head's sign;
    and a loss on it
    back-propagates to finite parameter gradients."""
    import torch

    from emap_tpu_torch.fields.udf import (init_udf_params, udf_gradient,
                                           udf_value_and_gradient)
    from emap_tpu_torch.kernels import mlp_query

    ucfg = at_tier(ucfg, ("high", ""))
    params = init_udf_params(torch.Generator().manual_seed(0), ucfg,
                             device="cuda")
    w, b = mlp_query.pack_weights(params, ucfg)
    x = raw_points(torch.Generator(device="cuda").manual_seed(3), GRAD_N)
    pts = x[:3].T.contiguous()
    before = ran()
    t0 = time.perf_counter()
    grad = udf_gradient(params, pts, ucfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(ran() == before, f"{label}: udf_gradient launched a kernel")
    udf, grad2 = udf_value_and_gradient(params, pts, ucfg)
    check(grad.shape == (GRAD_N, 3) and torch.equal(grad, grad2),
          f"{label}: udf_gradient differs from udf_value_and_gradient's "
          f"gradient")
    # fp32 residuals: udf_gradient's autograd keeps fp32 sigmoids
    kern = mlp_query.value_and_grad_sliced(x.contiguous(), w.contiguous(),
                                           b.contiguous(), ucfg,
                                           f32_residuals=True)
    got = {"udf": udf.detach(), "grad": grad.detach().T}
    want = {"udf": kern[0], "grad": kern[1][:3]}  # rows 3-7 are padding
    got, flips = head_signs(got, want, KERNEL_RTOL)
    _, rel, worst = errors(got, want)
    leaves = [t.requires_grad_(True) for layer in params.values()
              for t in layer.values()]
    g = udf_gradient(params, pts, ucfg)
    loss = ((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).mean()
    pgrads = torch.autograd.grad(loss, leaves)
    finite = all(bool(torch.isfinite(t).all()) for t in pgrads)
    print(f"{label}: udf_gradient at {GRAD_N} points in {1e3 * wall:.1f} ms"
          f" (first call), bit-equal to udf_value_and_gradient's; against "
          f"{mlp_query.TIER_NAMES[mlp_query.kernel_tier(ucfg.precision)]} "
          f"value_and_grad_sliced max rel err {rel:.3e} in block {worst} "
          f"(tolerance {KERNEL_RTOL:g}), {flips} points of opposite head "
          f"sign; eikonal loss {float(loss.detach()):.5f}, parameter "
          f"gradients finite: {finite}", flush=True)
    check(rel <= KERNEL_RTOL, f"{label}: udf_gradient disagrees with the "
          f"sliced kernel: {rel:.3e} in block {worst}")
    check(finite, f"{label}: non-finite parameter gradients through "
          f"udf_gradient")


def public_functions_phase(tmp: str, ucfg, smi: str) -> None:
    """Phase 13: the JAX package's last public functions on the card. A
    400x400, 24-view PidiNet cube scene with 3-pixel lines (OpenCV's thick
    anti-aliased line, ported) is written and timed; REPLICA_ITER steps of
    confs/Replica.conf train on it through the CLI (chain 5) with the
    launches reckoned and every loss finite (replica_train_run);
    udf_gradient is held at ABC and at Replica width (gradient_check);
    get_flow_vis and semantic_color_map run; and no module of the run has
    imported cv2."""
    import numpy as np

    from emap_tpu_torch import config
    from emap_tpu_torch.data import make_synthetic_scene
    from emap_tpu_torch.fields.udf import UDFConfig
    from emap_tpu_torch.utils.vis import get_flow_vis, semantic_color_map

    t_phase = time.perf_counter()
    data_dir = os.path.join(tmp, "data_thick")
    t0 = time.perf_counter()
    make_synthetic_scene(data_dir, scan="cube000", n_views=24, H=400, W=400,
                         detector="PidiNet", line_px=3)
    print(f"public: PidiNet scene with 3-pixel lines written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    path = conf_copy("Replica", tmp, data_dir, tag="_thick", **{
        "train.end_iter": REPLICA_ITER, "train.report_freq": 5,
        "train.save_freq": REPLICA_ITER, "train.val_freq": REPLICA_ITER})
    runner, _, _ = replica_train_run(path, "public", smi)
    del runner
    rucfg = UDFConfig.from_conf(config.parse_file(path).get_config(
        "model.udf_network"))
    gradient_check(ucfg, "public abc")
    gradient_check(rucfg, "public replica")

    ang = np.random.default_rng(0).uniform(0.0, 2.0 * np.pi, (400, 400))
    t0 = time.perf_counter()
    flow = get_flow_vis(ang, magnitude=2.0)
    wall = time.perf_counter() - t0
    cmap = semantic_color_map()
    print(f"public: get_flow_vis of a 400x400 field in {1e3 * wall:.1f} ms, "
          f"{flow.shape} {flow.dtype}, {len(np.unique(flow[..., 0]))} red "
          f"levels; semantic_color_map {cmap.shape} {cmap.dtype}", flush=True)
    check(flow.shape == (400, 400, 3) and flow.dtype == np.uint8,
          f"get_flow_vis gave {flow.shape} {flow.dtype}")
    check(cmap.shape == (256, 3) and cmap.dtype == np.float64
          and bool(((cmap >= 0) & (cmap < 1)).all()),
          f"semantic_color_map gave {cmap.shape} {cmap.dtype}")
    check("cv2" not in sys.modules, "a module of the port imported cv2")
    print(f"public: phase 13 in {time.perf_counter() - t_phase:.1f} s; cv2 "
          f"not imported", flush=True)


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
    from emap_tpu_torch.kernels import build
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
            if any(k in line for k in ("registers", "spill",
                                       "entry function")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    tensor_core_sass(build.SOURCES)

    abc = config.parse_file(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "confs", "ABC.conf"))
    ucfg = UDFConfig.from_conf(abc.get_config("model.udf_network"))
    plan_registers(ucfg)
    rcfg = RenderConfig.from_conf(abc.get_config("model.udf_renderer"))
    n = abc.get_int("train.batch_size") * rcfg.total_samples
    rows = kernel_phase(ucfg, n, (GRID_N, GRID_CHUNK_N))
    # the 256^3 chunk rows wait for phase 11, which launches the 3xTF32 one
    # (its row and its launch rows)
    chunk_rows = [r for r in rows if r["n"] == GRID_CHUNK_N
                  and r["tier"] == "3xtf32"]
    rows = [r for r in rows if r["n"] != GRID_CHUNK_N]

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        conf_path = write_run_conf(tmp)
        print(f"scene + conf written in {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        runner = cli.main(["--conf", conf_path, "--mode", "train"],
                          n_devices=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = {k: v for k, v in ran().items() if v}
        # the steps ran as CUDA graph replays: a kernel ran its wrapper's
        # count, less the launches its capture counted without running
        # them, plus those the replays ran without counting
        launches = ran(runner)
        keys = train_keys(runner)
        row_of = {row["name"]: row for row in rows}
        for key in keys.values():
            row_of[key]["launches"] = launches[key]
        part_launches(rows)
        # the one validation renders the view in batch_size-ray chunks, one
        # forward launch each
        h, w = (runner.scene.H // runner.validate_resolution_level,
                runner.scene.W // runner.validate_resolution_level)
        val_chunks = -(-h * w // runner.batch_size)
        print(f"train: {END_ITER} steps and one validation through "
              f"emap_tpu_torch.cli in {wall:.1f} s (set-up and first step "
              f"included) at the tiers {runner.tiers}; wrapper counts "
              f"{counted}, of them captured "
              f"{ {k: v for k, v in runner.captured_launches.items() if v} }; "
              f"replays ran "
              f"{ {k: v for k, v in runner.replayed_launches.items() if v} }; "
              f"launches { {k: v for k, v in launches.items() if v} }, "
              f"{val_chunks} of them validation chunks", flush=True)
        check(runner.tiers == {"field": "default", "adjoint": "default",
                               "sampler": "default", "extraction": "high",
                               "route": "kernels"},
              f"the ABC conf resolved to the tiers {runner.tiers}")
        check(runner.replayed_launches.get(keys["mlp_train_bwd"], 0) > 0,
              "the CLI run did not go through the kernels and the graph")
        check(runner.state.step == END_ITER, f"trained to step "
              f"{runner.state.step}, not {END_ITER}")
        check(launches[keys["mlp_train_bwd"]] == END_ITER,
              f"{keys['mlp_train_bwd']} launched "
              f"{launches[keys['mlp_train_bwd']]} times in {END_ITER} steps")
        check(launches[keys["mlp_value_and_grad"]] == END_ITER + val_chunks,
              f"{keys['mlp_value_and_grad']} launched "
              f"{launches[keys['mlp_value_and_grad']]} times, not {END_ITER} "
              f"steps + {val_chunks} validation chunks")
        others = {k: v for k, v in launches.items()
                  if v and k not in keys.values()}
        check(not others, f"the training launched other kernels or tiers: "
              f"{others}")
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
        eager_host_calls = step_phase(runner, smi)
        graph_phase(runner, smi, eager_host_calls)
        rows.append(extract_phase(conf_path, ucfg, row_of, smi))
        score_phase(conf_path, smi)
        rows.append(route_phase(conf_path, tmp, row_of, smi, rows[-1]["n"]))
        # the 3xTF32 query's launch rows take the field_high route's runs
        part_launches(rows)
        data_pidinet = pidinet_scene(tmp)
        rows += replica_phase(tmp, data_pidinet, n, smi)
        rows += dtu_phase(tmp, data_pidinet, ucfg, chunk_rows, smi)
        parallel_phase(runner, conf_path, tmp, smi)
        public_functions_phase(tmp, ucfg, smi)

    idle = [row["name"] for row in rows if not row["launches"]]
    check(not idle, f"no path launched {idle}")
    print(f"card: {smi}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
