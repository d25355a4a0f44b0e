#!/usr/bin/env python3
"""The training step's device work at a trained field, on the card against
the CPU: does any part of the step part from its plain version only once
the field is trained?

    python3 scripts/torch_trained_step.py CONF [--ckpt PATH] [--rays N]
        [--sampler-batches N] [--time-steps N] [--out OUT.json]

CONF is a run's conf copy (scripts/torch_run_production.py), and the
checkpoint (default: the run's `train.latest_model_name`) gives the field.
On N rays of one view (drawn on the host from a fixed seed) the host
places the samples once (the up-sampler at fp32, perturb 0), then
render_core, the edge loss plus the eikonal term and their gradients run
with those samples at each tier: "highest" (plain autograd), "high" (the
3xTF32 kernels) and "default" (the bf16 kernels), on the card and on the
CPU (the kernels' plain versions). The up-sampler is left out on purpose:
at a trained field it turns float roundoff into sample positions that
differ by up to 1e-2 between any two float32 computations, which would hide
the step's own agreement. Each line compares two of these runs: the loss,
the largest udf and spatial-gradient differences, the share of points whose
spatial gradients point apart, and each parameter gradient's largest
difference over its largest value (median and maximum over the field's
leaves).

It then draws `--sampler-batches` training batches of 1,024 rays on the
card's generator and on the CPU's (sample_rays, importance sampling on)
and prints the share of rays on edge pixels (edge > 0.1) and the mean and
correlation of the pixel coordinates, and with `--time-steps N` times N
eager training steps at "highest" (plain autograd) after three warm-up
steps. The card's name and power limit print first; OUT.json keeps it all.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

TIERS = ("highest", "high", "default")
PAIRS = ((("cuda", "highest"), ("cpu", "highest")),
         (("cuda", "high"), ("cpu", "high")),
         (("cuda", "high"), ("cpu", "highest")),
         (("cuda", "default"), ("cpu", "default")),
         (("cpu", "default"), ("cpu", "highest")),
         (("cuda", "default"), ("cpu", "highest")))


def leaf_names(tree, prefix: str = "") -> list:
    out = []
    for k, v in tree.items():
        out += (leaf_names(v, f"{prefix}{k}/") if isinstance(v, dict)
                else [prefix + k])
    return out


def step_at(ck_params, batch, z, sample_dist, igr_weight, ucfg, rcfg,
            device, tier):
    """render_core's loss (edge MSE + eikonal at the conf's weight) and its
    gradients at `tier` on `device`, on the given samples."""
    import torch

    from emap_tpu_torch.ckpt import convert
    from emap_tpu_torch.render import renderer as tr
    from emap_tpu_torch.train.optim import tree_leaves

    u = dataclasses.replace(ucfg, precision=tier)
    r = dataclasses.replace(rcfg, perturb=0.0, field_precision=tier,
                            sampler_precision=tier)

    def leaf(t):
        return ({k: leaf(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().requires_grad_(True))

    params = leaf(convert.params_from_numpy(ck_params, u, device=device))
    b = {k: v.to(device) for k, v in batch.items()}
    out = tr.render_core(params, b["rays_o"], b["rays_d"], z.to(device),
                         sample_dist, r, u, 1.0, 1.0)
    loss = (torch.mean((out["edge"] - b["edge"]) ** 2)
            + igr_weight * out["gradient_error"])
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)

    def host(t):
        return t.detach().cpu().double().numpy()

    return {"loss": float(loss), "udf": host(out["udf"]),
            "grad_x": host(out["gradients"]),
            "grads": {n: None if g is None else host(g)
                      for n, g in zip(leaf_names(params), grads)},
            "route": tr.resolved_tiers(r, u)["route"]}


def compare(a: dict, b: dict) -> dict:
    import numpy as np

    rel = [float(np.abs(a["grads"][k] - g).max()
                 / (np.abs(g).max() + 1e-30))
           for k, g in b["grads"].items()
           if k.startswith("udf/") and g is not None and g.size > 1]
    return {"loss": [a["loss"], b["loss"]],
            "udf_max_diff": float(np.abs(a["udf"] - b["udf"]).max()),
            "grad_x_max_diff": float(np.abs(a["grad_x"]
                                            - b["grad_x"]).max()),
            "grad_x_apart_share": float(np.mean(
                np.sum(a["grad_x"] * b["grad_x"], -1) < 0)),
            "param_grad_rel_median": float(np.median(rel)),
            "param_grad_rel_max": float(max(rel))}


def sampler_stats(pool, device, batches: int) -> dict:
    import numpy as np
    import torch

    from emap_tpu_torch.data.dataset import sample_rays

    gen = torch.Generator(device=device).manual_seed(1)
    edge, uv = [], []
    for s in range(batches):
        b = sample_rays(pool, s % pool.n_images, gen, 1024, True)
        edge.append(float((b["edge"] > 0.1).float().mean()))
        uv.append(b["rays_ndc_uv"].cpu().numpy())
    uv = np.concatenate(uv)
    return {"edge_share": float(np.mean(edge)),
            "edge_share_sem": float(np.std(edge) / np.sqrt(len(edge))),
            "uv_mean": uv.mean(0).tolist(),
            "uv_corr": float(np.corrcoef(uv[:, 0], uv[:, 1])[0, 1])}


def time_steps(conf, ckpt: str, steps: int) -> dict:
    """ms/step of eager training steps at "highest" (plain autograd) from
    the checkpoint, after three warm-up steps."""
    import torch

    from emap_tpu_torch.train.runner import Runner
    from emap_tpu_torch.train.step import train_step

    conf["model.udf_network.precision"] = "highest"
    conf["model.udf_renderer.sampler_precision"] = "highest"
    runner = Runner(conf, "train", device=torch.device("cuda"))
    runner.load_checkpoint(ckpt)

    def one():
        train_step(runner.state, runner.pool, runner.tcfg, runner.rcfg,
                   runner.ucfg, runner.scene.n_images)

    for _ in range(3):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        one()
    torch.cuda.synchronize()
    return {"tiers": runner.tiers, "steps": steps,
            "ms_per_step": 1e3 * (time.perf_counter() - t0) / steps}


def main(argv=None) -> int:
    import torch

    from emap_tpu_torch import config
    from emap_tpu_torch.ckpt import convert
    from emap_tpu_torch.ckpt.native import load_pytree
    from emap_tpu_torch.data.dataset import RayPool, load_scene, sample_rays
    from emap_tpu_torch.fields import udf as tudf
    from emap_tpu_torch.render import renderer as tr
    from emap_tpu_torch.render import sampling as ts

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("conf")
    p.add_argument("--ckpt", default="")
    p.add_argument("--rays", type=int, default=1024)
    p.add_argument("--sampler-batches", type=int, default=2000)
    p.add_argument("--time-steps", type=int, default=0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_trained_step: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    conf = config.parse_file(args.conf)
    exp_dir = os.path.join(conf["general.base_exp_dir"],
                           str(conf["dataset.scan"]), conf["general.expname"])
    ckpt = os.path.abspath(args.ckpt or os.path.join(
        exp_dir, "checkpoints", conf.get_string("train.latest_model_name")))
    ck_params = load_pytree(ckpt)["params"]
    ucfg = tudf.UDFConfig.from_conf(conf.get_config("model.udf_network"))
    rcfg = tr.RenderConfig.from_conf(conf.get_config("model.udf_renderer"))
    scene = load_scene(conf.get_config("dataset"))
    near, far = scene.near, scene.far
    sample_dist = (far - near) / rcfg.n_samples

    host_pool = RayPool.from_scene(scene, device="cpu")
    batch = sample_rays(host_pool, 5, torch.Generator().manual_seed(3),
                        args.rays, True)
    fp32 = dataclasses.replace(ucfg, precision="highest")
    field = convert.params_from_numpy(ck_params, fp32, device="cpu")["udf"]
    with torch.no_grad():
        z = ts.importance_sample(
            lambda x: tudf.udf_value(field, x, fp32), batch["rays_o"],
            batch["rays_d"],
            ts.stratified_z_vals(None, args.rays, near, far, rcfg.n_samples,
                                 0.0, device="cpu"),
            sample_dist, rcfg.n_importance, rcfg.up_sample_steps,
            use_unbias=rcfg.use_unbias_render)
    igr_weight = conf.get_float("train.igr_weight")

    runs = {}
    for device in ("cpu", "cuda"):
        for tier in TIERS:
            runs[(device, tier)] = step_at(ck_params, batch, z, sample_dist,
                                           igr_weight, ucfg, rcfg, device,
                                           tier)
    report = {"card": smi, "conf": os.path.abspath(args.conf),
              "checkpoint": ckpt, "rays": args.rays, "pairs": []}
    for a, b in PAIRS:
        row = {"a": "/".join(a), "b": "/".join(b),
               "routes": [runs[a]["route"], runs[b]["route"]],
               **compare(runs[a], runs[b])}
        report["pairs"].append(row)
        print(f"pair {json.dumps(row)}", flush=True)

    report["sampler"] = {
        dev: sampler_stats(RayPool.from_scene(scene, device=dev), dev,
                           args.sampler_batches) for dev in ("cpu", "cuda")}
    print(f"sampler {json.dumps(report['sampler'])}", flush=True)
    if args.time_steps:
        report["timing"] = time_steps(conf, ckpt, args.time_steps)
        print(f"timing {json.dumps(report['timing'])}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
