"""Training and extraction orchestration (port of
emap_tpu/train/runner.py): Runner(conf, mode, is_continue, device) with
.train(), .validate(), .extract_edge(), checkpoints and the
report/save/validation cadences.

The loop dispatches as the JAX runner does: `chain` steps a call through
the chained step (train/step.py::ChainedStep, a CUDA graph of the step on
the card) wherever a whole chain fits before the run's end, single eager
steps elsewhere. The chain divides every event cadence (`dispatch_chain`,
`train.steps_per_dispatch`), so checkpoints, validations and the loss
window land on the same steps whatever its length; a chain of 1 is the
per-step eager path. Each step's metrics stay on the device as one packed
vector; the loop fetches the pending vectors in one copy only at the
logging cadences, so steps between them make no host sync.
`train.profile_steps` traces that many steps with torch.profiler from the
run's sixth step into <base_exp_dir>/profile, with the chain forced to 1.

Matmul tiers (`self.tiers`): training queries the field at
`field_precision` (the bf16 tier unless the conf sets it) and up-samples
at `sampler_precision`; extraction runs at the model's `precision`. A conf
that pins `precision` and not `field_precision` trains at the pinned tier
too, as the JAX runner has it.

Checkpoints: native .npz (ckpt/native.py) with the JAX package's layout,
saved only when the rolling 500-step edge-loss average improves. One
deliberate difference: the last step of a run closes a partial window (a run
shorter than 500 steps, or one whose end is not on the 500 grid) and saves on
it under the same improve-only rule, so a short run still leaves its
checkpoint. `load_checkpoint` also reads a reference `.pth`
(ckpt/pth_import.py). `train(stop_at=...)` ends a run early with its exact
state in ckpt_stop.npz, which `is_continue` resumes from.

`validate` renders one view in `batch_size`-ray chunks under no_grad (the
fused training query serves its field queries) and writes the edge | GT,
camera-frame normal and JET depth images with the port's PNG writer. The
views come from the JAX package's stream (numpy's MT19937 seeded 42).
`extract_edge` extracts the zero-set point cloud on the runner's device
through the grid and sweep kernels, fits and merges lines and curves on the
host, and, with `auto_threshold` or `fit_draws > 1`, picks the threshold and
fit draw by the GT-free scorer (extract/autothresh.py). It writes the same
four result files as the JAX package.

With a `group` (parallel/mesh.py::RayGroup; the CLI makes one a rank when
`train.multi_device` finds several devices) every rank holds the same
state (the same seed and init), trains on its rows of each batch with the
gradients summed over the ranks (train/step.py), renders its rows of each
validation chunk, and takes its share of the extraction's grid and sweeps
(extract/pointcloud.py); the rows are gathered back in order. Rank 0 alone
writes: the run's files, checkpoints, validation images, logs, and the
extraction's fit, selection and results.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import shutil
import time

import numpy as np
import torch

from emap_tpu_torch import default_device, use_fp32_matmuls
from emap_tpu_torch.ckpt.convert import (
    FLAG_KEYS,
    adam_from_numpy,
    checkpoint_payload,
    params_from_numpy,
    state_from_payload,
)
from emap_tpu_torch.ckpt.native import load_pytree, save_pytree
from emap_tpu_torch.ckpt.pth_import import import_reference_checkpoint
from emap_tpu_torch.data.dataset import (
    RayPool,
    edge_at,
    gen_rays_at,
    load_scene,
)
from emap_tpu_torch.data.png import write_png
from emap_tpu_torch.extract.parametric import get_parametric_edge
from emap_tpu_torch.fields.udf import UDFConfig
from emap_tpu_torch.render.renderer import RenderConfig, render, resolved_tiers
from emap_tpu_torch.train import schedules
from emap_tpu_torch.train.state import init_train_state, make_state
from emap_tpu_torch.train.step import (
    TrainConfig,
    build_chained_train_step,
    build_train_step,
    pack_metrics,
    unpack_metrics,
)
from emap_tpu_torch.utils.vis import visualize_depth

logger = logging.getLogger(__name__)

# steps in the rolling edge-loss average that decides a checkpoint save
LOSS_WINDOW = 500


class TrainingDiverged(RuntimeError):
    pass


def dispatch_chain(steps_per_dispatch: int, report_freq: int, save_freq: int,
                   val_freq: int, profile_steps: int = 0) -> int:
    """Steps a dispatch, by the JAX runner's rule: the conf's
    `train.steps_per_dispatch`, or, at 0 or below, the largest chain that
    divides the loss window and every event cadence; a chain that does not
    divide them is rounded down to one that does, with a warning, so that
    checkpoints and validations keep their exact steps. The gcd with the
    500-step window keeps it in [1, 500], the JAX rule's clamp. A profiler
    window forces per-step dispatch."""
    aligned = math.gcd(math.gcd(LOSS_WINDOW, report_freq),
                       math.gcd(save_freq, val_freq))
    chain = steps_per_dispatch
    if chain <= 0:
        chain = aligned
    elif aligned % chain:
        logger.warning(
            "train.steps_per_dispatch=%d does not divide the event cadences "
            "(gcd %d); rounding down so checkpoints/validation stay on their "
            "exact steps", chain, aligned)
        chain = math.gcd(chain, aligned)
    return 1 if profile_steps else chain


class Runner:
    """UDF edge-field trainer."""

    def __init__(self, conf, mode: str = "train", is_continue: bool = False,
                 device=None, group=None):
        use_fp32_matmuls()
        self.conf = conf
        self.mode = mode
        self.is_continue = is_continue
        self.group = group
        if group is not None:
            self.device = group.device
        else:
            self.device = torch.device(device) if device else default_device()

        self.base_exp_dir = os.path.join(conf["general.base_exp_dir"],
                                         str(conf["dataset.scan"]),
                                         conf["general.expname"])
        os.makedirs(self.base_exp_dir, exist_ok=True)

        self.scene = load_scene(conf.get_config("dataset"))
        self.near, self.far = self.scene.near, self.scene.far
        self.ucfg = UDFConfig.from_conf(conf.get_config("model.udf_network"))
        self.rcfg = RenderConfig.from_conf(
            conf.get_config("model.udf_renderer"))
        if ("model.udf_network.precision" in conf
                and "model.udf_renderer.field_precision" not in conf):
            # a pinned model tier governs the training query too, unless the
            # conf pins field_precision as well (whose conf default is the
            # bf16 tier): the JAX runner's rule, emap_tpu/train/runner.py:85-93
            self.rcfg = dataclasses.replace(self.rcfg, field_precision="")
        # the tier each site computes at (render/renderer.py::resolved_tiers)
        self.tiers = resolved_tiers(self.rcfg, self.ucfg)
        logger.info("matmul tiers: %s", self.tiers)
        self.tcfg = TrainConfig.from_conf(conf, self.near, self.far)

        self.end_iter = conf.get_int("train.end_iter")
        self.save_freq = conf.get_int("train.save_freq")
        self.report_freq = conf.get_int("train.report_freq")
        self.val_freq = conf.get_int("train.val_freq")
        self.batch_size = conf.get_int("train.batch_size")
        self.validate_resolution_level = conf.get_int(
            "train.validate_resolution_level")
        self.use_white_bkgd = conf.get_bool("train.use_white_bkgd")
        self.latest_model_name = conf.get_string("train.latest_model_name",
                                                 "ckpt_best.npz")

        beta_conf = conf.get_config("model.beta_network")
        self.state = init_train_state(
            seed=self.tcfg.seed,
            udf_cfg=self.ucfg,
            variance_init=conf.get_float("model.variance_network.init_val"),
            beta_init=beta_conf.get_float("init_var_beta", 0.1),
            gamma_init=beta_conf.get_float("init_var_gamma", 0.1),
            zeta_init=beta_conf.get_float("init_var_zeta", 0.05),
            requires_grad_beta=beta_conf.get_bool("requires_grad_beta", True),
            requires_grad_gamma=beta_conf.get_bool("requires_grad_gamma", True),
            requires_grad_zeta=beta_conf.get_bool("requires_grad_zeta", True),
            device=self.device,
        )
        self.pool = RayPool.from_scene(self.scene, device=self.device)
        self.best_loss = 1.0
        # per fetched step: {"step", metrics...}; and (step, host seconds)
        # at each fetch, which follows a device sync
        self.history: list = []
        self.timeline: list = []
        # validation views: the stream the JAX package draws them from
        # (np.random.seed(42) in its CLI, then np.random.randint), without
        # touching numpy's global state
        self.val_rng = np.random.RandomState(42)
        # per extraction: one dict per stage ({"stage", "seconds", ...})
        self.extract_trace: list = []
        # kernel launches of the chained steps' CUDA graphs, by kernel: the
        # wrappers count at capture what the graph holds without running
        # it, and replays run it uncounted, so a kernel ran its wrapper's
        # count - captured + replayed times
        self.captured_launches: dict = {}
        self.replayed_launches: dict = {}

    @property
    def is_main(self) -> bool:
        """Whether this process writes the run's files: rank 0, or the one
        process without a group."""
        return self.group is None or self.group.rank == 0

    # -- checkpoints -------------------------------------------------------
    def _ckpt_dir(self) -> str:
        return os.path.join(self.base_exp_dir, "checkpoints")

    def save_checkpoint(self, loss_val: float) -> None:
        """Save only when the rolling loss improves."""
        if loss_val >= self.best_loss:
            return
        self.best_loss = loss_val
        if not self.is_main:
            return
        path = os.path.join(self._ckpt_dir(), "ckpt_best.npz")
        save_pytree(path, checkpoint_payload(self.state, self.best_loss))
        logger.info("saved checkpoint (best loss %.4f) -> %s", loss_val, path)

    def load_checkpoint(self, name: str | None = None) -> None:
        """Load a checkpoint: an .npz written by either package, or a
        reference `.pth` (ckpt/pth_import.py). A missing `.pth` falls back
        to the .npz beside it. A `.pth` keeps this state's trainability
        flags, and starts a fresh Adam state when it holds no optimizer."""
        name = name or self.latest_model_name
        path = name if os.path.isabs(name) else os.path.join(
            self._ckpt_dir(), name)
        if path.endswith(".pth") and not os.path.exists(path) and (
                os.path.exists(path[:-4] + ".npz")):
            path = path[:-4] + ".npz"
        if path.endswith(".pth"):
            imported = import_reference_checkpoint(path)
            params = params_from_numpy(imported["params"], self.ucfg,
                                       self.device)
            opt = (None if imported["opt"] is None
                   else adam_from_numpy(imported["opt"], self.device))
            flags = {k: bool(getattr(self.state, k)) for k in FLAG_KEYS}
            self.state = make_state(params, self.tcfg.seed, self.device,
                                    opt=opt, step=imported["iter_step"],
                                    flags=flags)
        else:
            payload = load_pytree(path)
            self.state = state_from_payload(payload, self.ucfg,
                                            self.tcfg.seed, self.device)
            self.best_loss = float(payload.get("best_loss", 1.0))
        logger.info("loaded checkpoint %s (iter %d)", path, self.state.step)

    def file_backup(self) -> None:
        """Snapshot the conf's recording dirs and the conf into the run."""
        if not self.is_main:
            return
        rec_dir = os.path.join(self.base_exp_dir, "recording")
        os.makedirs(rec_dir, exist_ok=True)
        for dir_name in self.conf.get_list("general.recording", []):
            if os.path.isdir(dir_name):
                dst = os.path.join(rec_dir,
                                   os.path.basename(dir_name.rstrip("/")))
                shutil.copytree(dir_name, dst, dirs_exist_ok=True,
                                ignore=shutil.ignore_patterns("__pycache__"))
        with open(os.path.join(rec_dir, "config.conf"), "w") as f:
            f.write(self.conf.to_hocon())

    # -- training ----------------------------------------------------------
    def train(self, stop_at: int = 0) -> None:
        """Train to `end_iter`; or, with `stop_at`, stop after that step and
        keep the exact state (the random generator's included) in
        checkpoints/ckpt_stop.npz, from which `is_continue` resumes the run
        as if it had not stopped. `stop_at` must lie on the grid of the
        loss window and the saves, so that stopping changes nothing."""
        grid = math.lcm(LOSS_WINDOW, self.save_freq)
        if stop_at and stop_at % grid:
            raise ValueError(f"stop_at {stop_at} is not a multiple of {grid}"
                             " (the loss window and save_freq)")
        if self.is_continue:
            if os.path.exists(self._stop_path()):
                self._resume_stopped()
            else:
                self.load_checkpoint()
        if self.mode.startswith("train"):
            self.file_backup()

        profile_steps = self.conf.get_int("train.profile_steps", 0)
        chain = dispatch_chain(
            self.conf.get_int("train.steps_per_dispatch", 0),
            self.report_freq, self.save_freq, self.val_freq, profile_steps)
        step_fn = build_train_step(self.tcfg, self.rcfg, self.ucfg,
                                   self.scene.n_images, group=self.group)
        # built after the resume above: a graph holds the state's addresses
        chained = (build_chained_train_step(self.tcfg, self.rcfg, self.ucfg,
                                            self.scene.n_images, chain,
                                            group=self.group)
                   if chain > 1 else None)
        loss_window: list = []
        loss_avg = None
        pending: list = []  # (k, M) packed metric rows not yet fetched
        start_step = self.state.step
        end = min(stop_at, self.end_iter) if stop_at else self.end_iter
        profile_start = start_step + 5
        prof = None
        t0 = time.perf_counter()
        self.timeline.append((start_step, t0))
        logger.info("dispatching %d step(s) a call", chain)

        try:
            while self.state.step < end:
                it = self.state.step
                if profile_steps and it == profile_start:
                    prof = self._start_profile()
                if prof is not None and it == profile_start + profile_steps:
                    self._stop_profile(prof)
                    prof = None
                if chained is not None and it % chain == 0 and (
                        it + chain <= end):
                    pending.append(chained(self.state, self.pool))
                else:
                    pending.append(
                        pack_metrics(step_fn(self.state, self.pool))[None])
                step = self.state.step
                last_step = step == self.end_iter
                if not (step % LOSS_WINDOW == 0 or step % self.report_freq == 0
                        or step % self.save_freq == 0
                        or step % self.val_freq == 0 or last_step):
                    continue

                rows = torch.cat(pending).cpu().numpy()  # the one sync
                now = time.perf_counter()
                self.timeline.append((step, now))
                first = step - len(rows) + 1
                pending = []
                for i, vec in enumerate(rows):
                    m = unpack_metrics(vec)
                    self.history.append({"step": first + i, **m})
                    loss_window.append(m["edge_loss"])
                last = self.history[-1]
                bad = {k: last[k] for k in ("loss", "edge_loss", "psnr")
                       if not math.isfinite(last[k])}
                if bad:
                    raise TrainingDiverged(
                        f"non-finite metrics at step {step}: {bad}")

                if (step % LOSS_WINDOW == 0 or last_step) and loss_window:
                    loss_avg = float(np.mean(loss_window))
                    loss_window = []

                if step % self.report_freq == 0:
                    seconds = now - t0
                    logger.info(
                        "iter %d loss=%.4f edge=%.4f eik=%.4f psnr=%.2f "
                        "s_val=%.5f beta=%.5f gamma=%.3f lr=%.2e lr_geo=%.2e "
                        "w_sum=%.3f udf_min=%.5f ms/step=%.1f rays/s=%.0f",
                        step, last["loss"], last["edge_loss"],
                        last["gradient_error"], last["psnr"],
                        last["variance"], last["beta"], last["gamma"],
                        last["lr"], last["lr_geo"], last["weight_sum"],
                        last["udf_min"], 1e3 * seconds / (step - start_step),
                        self.batch_size * (step - start_step) / seconds)

                if (step % self.save_freq == 0 or last_step) and (
                        loss_avg is not None):
                    self.save_checkpoint(loss_avg)
                if step % self.val_freq == 0:
                    self.validate()
        finally:
            if prof is not None:
                self._stop_profile(prof)
            if chained is not None:
                for mine, its in ((self.captured_launches,
                                   chained.captured_launches),
                                  (self.replayed_launches,
                                   chained.replayed_launches)):
                    for k, v in its.items():
                        mine[k] = mine.get(k, 0) + v
                # the graph and its memory pool go before an extraction
                chained.release()
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()

        if not self.is_main:
            return
        if self.state.step < self.end_iter:
            payload = checkpoint_payload(self.state, self.best_loss)
            payload["generator"] = self.state.generator.get_state().numpy()
            save_pytree(self._stop_path(), payload)
            logger.info("stopped at step %d of %d -> %s", self.state.step,
                        self.end_iter, self._stop_path())
        elif os.path.exists(self._stop_path()):
            os.remove(self._stop_path())

    def _start_profile(self):
        """A torch.profiler trace of the host and, on the card, the
        device."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        prof.stop()
        if not self.is_main:
            return
        out = os.path.join(self.base_exp_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        logger.info("profiler trace written to %s", out)

    def _stop_path(self) -> str:
        return os.path.join(self._ckpt_dir(), "ckpt_stop.npz")

    def _resume_stopped(self) -> None:
        """Continue a run that `train(stop_at=...)` stopped: its state, its
        random generator, and the validation views it has drawn."""
        payload = load_pytree(self._stop_path())
        self.state = state_from_payload(payload, self.ucfg, self.tcfg.seed,
                                        self.device)
        self.state.generator.set_state(torch.from_numpy(
            np.asarray(payload["generator"], np.uint8)))
        self.best_loss = float(payload["best_loss"])
        for _ in range(self.state.step // self.val_freq):
            self.val_rng.randint(self.scene.n_images)
        logger.info("resumed the stopped run at step %d", self.state.step)

    # -- validation ----------------------------------------------------------
    def render_image(self, idx: int, resolution_level: int):
        """One view rendered in `batch_size`-ray chunks under no_grad, with
        flip_saturation 0 as the JAX package validates: (edge (h, w),
        depth (h, w), normals (h*w, 3)) numpy. The rays are padded to whole
        chunks as in the JAX package (origin 0, direction +z, scale 1).
        Under a group each rank renders its rows of every chunk and the
        rows are gathered back in order (the JAX package's sharded
        validation)."""
        rays_o, rays_d, depth_scale = gen_rays_at(self.scene, idx,
                                                  resolution_level)
        h, w, _ = rays_o.shape
        flat_o = rays_o.reshape(-1, 3)
        flat_d = rays_d.reshape(-1, 3)
        flat_ds = depth_scale.reshape(-1, 1)
        chunk = self.batch_size
        n = len(flat_o)
        pad = (-n) % chunk
        if pad:
            flat_o = np.concatenate([flat_o, np.zeros((pad, 3), np.float32)])
            flat_d = np.concatenate(
                [flat_d, np.tile(np.array([[0, 0, 1]], np.float32), (pad, 1))])
            flat_ds = np.concatenate([flat_ds, np.ones((pad, 1), np.float32)])

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=self.device)

        o, d, ds = put(flat_o), put(flat_d), put(flat_ds)
        group = self.group
        if group is not None:
            # (chunks, world, rows a rank, k) -> this rank's rows of each
            o, d, ds = (t.reshape(-1, group.world, chunk // group.world,
                                  t.shape[-1])[:, group.rank].reshape(
                                      -1, t.shape[-1]) for t in (o, d, ds))
            chunk //= group.world
        step = int(self.state.step)
        anneal = schedules.cos_anneal_ratio(step, self.tcfg.anneal_end)
        gen = torch.Generator(device=self.device).manual_seed(step)
        bg = 1.0 if self.use_white_bkgd else None
        n_total = self.rcfg.total_samples
        edges, depths, normals = [], [], []
        with torch.no_grad():
            for c in range(0, len(o), chunk):
                out = render(self.state.params, o[c: c + chunk],
                             d[c: c + chunk], self.near, self.far,
                             ds[c: c + chunk], gen, self.rcfg, self.ucfg,
                             cos_anneal_ratio=anneal, flip_saturation=0.0,
                             background_rgb=bg, group=group)
                edges.append(out["edge"])
                depths.append(out["depth"])
                normals.append(torch.sum(
                    out["gradients_flip"] * out["weights"][:, :n_total, None],
                    dim=1))

        def fetch(parts):
            rows = torch.cat(parts)
            if group is not None:
                # (world, chunks, rows a rank, k) back to the chunks' order
                k = rows.shape[-1]
                rows = group.gather_rows(rows).reshape(
                    group.world, -1, chunk, k).transpose(0, 1).reshape(-1, k)
            return rows[:n].cpu().numpy()

        return (fetch(edges).reshape(h, w), fetch(depths).reshape(h, w),
                fetch(normals))

    def validate(self, idx: int = -1, resolution_level: int = -1) -> dict:
        """Render one view (a random one unless `idx` is given) and write
        edge_maps/ (rendered | GT), normals/ (camera frame) and depths/
        (JET) PNGs named <step>_<idx>.png; returns {kind: path}. Under a
        group every rank renders its share and rank 0 writes (the others
        return {})."""
        if idx < 0:
            idx = int(self.val_rng.randint(self.scene.n_images))
        if resolution_level < 0:
            resolution_level = self.validate_resolution_level
        edge, depth, normals = self.render_image(idx, resolution_level)
        if not self.is_main:
            return {}
        h, w = edge.shape
        name = f"{int(self.state.step):08d}_{idx}.png"
        paths = {}

        def write(kind, img):
            os.makedirs(os.path.join(self.base_exp_dir, kind), exist_ok=True)
            paths[kind] = os.path.join(self.base_exp_dir, kind, name)
            write_png(paths[kind], img)

        # edge map: rendered over ground truth
        edge_img = (edge * 255).clip(0, 255).astype(np.uint8)
        gt = edge_at(self.scene, idx, resolution_level).astype(np.uint8)
        write("edge_maps", np.concatenate([np.stack([edge_img] * 3, axis=-1),
                                           np.stack([gt] * 3, axis=-1)]))
        # normals rotated into the camera frame
        rot = np.linalg.inv(self.scene.poses[idx, :3, :3])
        normal_img = ((normals @ rot.T).reshape(h, w, 3) * 128 + 128).clip(
            0, 255).astype(np.uint8)
        write("normals", normal_img[:, :, ::-1])
        write("depths", visualize_depth(depth)[:, :, ::-1])
        return paths

    # -- extraction ----------------------------------------------------------
    def extract_edge(self, resolution: int = 256, udf_threshold: float = 1.0,
                     sampling_N: int = 50, sampling_delta: float = 5e-3,
                     is_pointshift: bool = False, iters: int = 1,
                     is_linedirection: bool = False,
                     visible_checking: bool = False,
                     auto_threshold=None, platform: str = "",
                     fit_draws: int = 1) -> dict:
        """Extract parametric edges from the checkpointed UDF; the options
        are the JAX package's (emap_tpu/train/runner.py::extract_edge).
        `platform`: "" extracts on the runner's device, "cpu" on the CPU
        (the kernels' plain versions); any other value raises. Stage times
        and sizes land in `self.extract_trace`. Under a group every rank
        takes its share of the grid and the sweeps on its device and rank 0
        alone fits, selects and writes (the others return None); with
        `platform = "cpu"` rank 0 extracts alone."""
        if platform not in ("", "cpu"):
            raise ValueError(f"edge_extraction.platform {platform!r}: the "
                             'port extracts on "" (the runner\'s device) or '
                             '"cpu"')
        self.load_checkpoint()
        device = torch.device("cpu") if platform == "cpu" else self.device
        params = {k: {n: t.detach().to(device) for n, t in layer.items()}
                  for k, layer in self.state.params["udf"].items()}
        self.extract_trace = []
        group = self.group if device == self.device else None
        if group is None and not self.is_main:
            return None
        return self._extract_edge_impl(
            params, resolution, udf_threshold, sampling_N, sampling_delta,
            is_pointshift, iters, is_linedirection, visible_checking,
            auto_threshold, fit_draws, group)

    def _extract_edge_impl(self, params, resolution, udf_threshold,
                           sampling_N, sampling_delta, is_pointshift, iters,
                           is_linedirection, visible_checking,
                           auto_threshold, fit_draws=1, group=None):
        from emap_tpu_torch.extract.pointcloud import (
            extract_pointcloud,
            extract_pointcloud_multi,
        )
        from emap_tpu_torch.utils.ply import write_ply_points

        trace = self.extract_trace
        extract_kw = dict(resolution=resolution, sampling_N=sampling_N,
                          sampling_delta=sampling_delta,
                          is_pointshift=is_pointshift, iters=iters,
                          is_linedirection=is_linedirection, trace=trace,
                          group=group)

        def fit(points, line_dirs, seed=42):
            ld_colors = (line_dirs + 1.0) / 2.0
            pred_points, edge_dict = get_parametric_edge(
                points, ld_colors, resolution, self.scene.detector,
                self.scene.data_dir, visible_checking=visible_checking,
                seed=seed, trace=trace)
            return points, ld_colors, pred_points, edge_dict

        def timed(stage, fn):
            t0 = time.perf_counter()
            out = fn()
            trace.append({"stage": stage,
                          "seconds": time.perf_counter() - t0})
            return out

        result_dir = os.path.join(self.base_exp_dir, "results")
        os.makedirs(result_dir, exist_ok=True)

        if auto_threshold or fit_draws > 1:
            from emap_tpu_torch.extract.autothresh import (
                build_probe_points,
                select_udf_threshold,
            )

            # fit_draws > 1 without auto_threshold still routes through the
            # selector: one candidate threshold, K fit draws
            candidates = (list(auto_threshold) if auto_threshold
                          else [udf_threshold])
            # 42 first, so draw 0 is the reference's fixed fit seed
            fit_seeds = ([42] + [s for s in range(int(fit_draws))
                                 if s != 42][:int(fit_draws) - 1]
                         if fit_draws > 1 else None)
            # one shared grid + feature + shift pass serves every candidate
            multi = timed("pointcloud", lambda: extract_pointcloud_multi(
                params, self.ucfg, thresholds=candidates, **extract_kw))
            if not self.is_main:
                return None
            cache: dict = {}

            def edge_dict_at(thr: float, seed: int = 42) -> dict:
                # the fits are timed apart from the selector's scoring
                cache[(thr, seed)] = timed(
                    "fit", lambda: fit(*multi[float(thr)], seed=seed))
                return cache[(thr, seed)][3]

            # the field's own certified zero set stands in for GT when
            # ranking candidates (autothresh.pick_candidate)
            probe = timed("probe", lambda: build_probe_points(
                params, self.ucfg, resolution,
                loose_threshold=max(candidates), sampling_N=sampling_N,
                sampling_delta=sampling_delta, trace=trace))
            best_thr, _, rows = timed("fit_score", lambda: select_udf_threshold(
                edge_dict_at, candidates, self.scene.data_dir,
                self.scene.detector, default_thr=udf_threshold,
                # a probe under 64 points quantizes recall3d in steps of
                # 1/n: rank by the 2D score and the conf anchor instead
                probe_points=probe if len(probe) >= 64 else None,
                fit_seeds=fit_seeds))
            picked_seed = next(r for r in rows if r.get("picked")).get(
                "fit_seed", 42)
            points, ld_colors, pred_points, edge_dict = cache[
                (best_thr, picked_seed)]
            with open(os.path.join(result_dir, "threshold_selection.json"),
                      "w") as f:
                json.dump({"picked": best_thr, "picked_fit_seed": picked_seed,
                           "fit_draws": fit_draws, "candidates": rows}, f,
                          indent=1)
            logger.info("%s picked %.3g from %s (fit seed %d, %d draws)",
                        "auto_threshold" if auto_threshold
                        else "fit_draws at fixed threshold",
                        best_thr, candidates, picked_seed, max(fit_draws, 1))
        else:
            points, line_dirs = timed("pointcloud", lambda: extract_pointcloud(
                params, self.ucfg, udf_threshold=udf_threshold, **extract_kw))
            if not self.is_main:
                return None
            points, ld_colors, pred_points, edge_dict = timed(
                "fit_score", lambda: fit(points, line_dirs))

        write_ply_points(
            os.path.join(result_dir, "udf_pointcloud_withdirection.ply"),
            points, ld_colors)
        write_ply_points(os.path.join(result_dir, "edge_points.ply"),
                         pred_points)
        with open(os.path.join(result_dir, "parametric_edges.json"), "w") as f:
            json.dump(edge_dict, f)
        logger.info("extracted %d curves + %d lines -> %s",
                    len(edge_dict["curves_ctl_pts"]),
                    len(edge_dict["lines_end_pts"]), result_dir)
        return edge_dict
