"""The training step: ray sampling -> render -> loss -> masked Adam (port of
emap_tpu/train/step.py), and the chained step that advances a run by K
steps a call (the counterpart of the JAX package's
build_chained_train_step).

The JAX package compiles the step into one XLA program and chains steps
with `lax.scan`. Here the step is plain Python over eager tensors, split in
two: the host works out the step's values (image index, schedules, the
step counter) and writes them into 0-d device tensors (`StepInputs`, one
`fill_` each: a launch, not a copy), and `step_body` does all of the
device work reading only those tensors and the state. The state is updated
in place (parameters, Adam moments and counts, trainability gates), so the
body makes no host sync and a CUDA graph can hold it: the chained step
captures one body on the card and replays it K times. Metrics stay on the
device and the runner fetches them at its logging cadence.

Gate semantics (as in the JAX package): the gates fire from the current
step's rendered s_val/beta and take effect on the next step's update.
"""

from __future__ import annotations

import dataclasses

import torch

from emap_tpu_torch.data.dataset import RayPool, sample_rays
from emap_tpu_torch.fields.udf import UDFConfig
from emap_tpu_torch.render.renderer import RenderConfig, render
from emap_tpu_torch.train import schedules
from emap_tpu_torch.train.optim import adam_update, tree_leaves, tree_map
from emap_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 1024
    end_iter: int = 50000
    learning_rate: float = 5e-4
    learning_rate_geo: float = 1e-4
    learning_rate_alpha: float = 0.05
    warm_up_end: float = 1000.0
    anneal_end: float = 10000.0
    fix_geo_end: float = 200.0
    igr_weight: float = 0.1
    igr_ns_weight: float = 0.0
    edge_weight: float = 1.0
    loss_type: str = "mse"
    importance_sample: bool = True
    same_lr: bool = False
    near: float = 0.05
    far: float = 6.0
    seed: int = 42

    @classmethod
    def from_conf(cls, conf, near: float, far: float) -> "TrainConfig":
        t = conf.get_config("train")
        return cls(
            batch_size=t.get_int("batch_size"),
            end_iter=t.get_int("end_iter"),
            learning_rate=t.get_float("learning_rate"),
            learning_rate_geo=t.get_float("learning_rate_geo"),
            learning_rate_alpha=t.get_float("learning_rate_alpha"),
            warm_up_end=t.get_float("warm_up_end", 0.0),
            anneal_end=t.get_float("anneal_end", 0.0),
            fix_geo_end=t.get_float("fix_geo_end", 200.0),
            igr_weight=t.get_float("igr_weight"),
            igr_ns_weight=t.get_float("igr_ns_weight", 0.0),
            edge_weight=conf.get_float("edge_loss.edge_weight", 0.0),
            loss_type=conf.get_string("edge_loss.loss_type", "mse"),
            importance_sample=t.get_bool("importance_sample"),
            same_lr=t.get_bool("same_lr", False),
            near=near,
            far=far,
            seed=t.get_int("seed", 42),
        )


METRIC_KEYS = (
    "loss", "edge_loss", "psnr", "gradient_error",
    "gradient_error_near_surface", "variance", "beta", "gamma", "udf_min",
    "udf_mean", "weight_sum", "weight_sum_fg_bg", "lr", "lr_geo",
)


def edge_loss_fn(pred, target, loss_type: str):
    if loss_type == "mse":
        return torch.mean((pred - target) ** 2)
    if loss_type == "l1":
        return torch.mean(torch.abs(pred - target))
    raise ValueError(f"unknown loss_type {loss_type!r}")


# Metrics that are means over the rays: under a group, each rank's mean
# over its equal share, summed over the ranks and divided by the world.
RAY_MEANS = ("udf_min", "udf_mean", "weight_sum", "weight_sum_fg_bg",
             "sparse_error", "mse")
# Metrics that are already each rank's share of the group's value.
SHARES = ("loss", "edge_loss", "gradient_error", "gradient_error_near_surface")


def loss_and_grads(params, batch, generator, tcfg: TrainConfig,
                   rcfg: RenderConfig, ucfg: UDFConfig, cos_anneal_ratio,
                   flip_saturation, group=None):
    """(loss, aux, grads) of the step's loss at `params` for a ray batch;
    grads has the params' tree layout (zeros for unused leaves). The render
    jitter is drawn from `generator`; the two schedules are python floats
    or 0-d tensors on the rays' device.

    With a `group` (parallel/mesh.py::RayGroup) the batch is this rank's
    rows of the group's: the loss differentiated is this rank's share of
    the group's loss (the edge loss's mean over the group's rays, the
    eikonal terms over the group's masks, render_core), and ONE flat
    all-reduce sums the gradient tree and the metric shares over the ranks,
    so every rank returns the group's loss, metrics and gradients (the
    JAX package's psum). variance, beta and gamma are replicated scalars
    and stay out of the sum. At world 1 each share is the whole (a factor
    of exactly 1.0) and the all-reduce is the identity, so the numbers
    equal the step without a group bit for bit."""
    out = render(params, batch["rays_o"], batch["rays_d"], tcfg.near,
                 tcfg.far, batch["depth_scale"], generator, rcfg, ucfg,
                 cos_anneal_ratio=cos_anneal_ratio,
                 flip_saturation=flip_saturation, group=group)
    true_edge = batch["edge"]
    e_loss = edge_loss_fn(out["edge"], true_edge, tcfg.loss_type)
    share = 1.0 if group is None else 1.0 / group.world
    if group is not None:
        e_loss = e_loss * share
    loss = (e_loss * tcfg.edge_weight
            + out["gradient_error_near_surface"] * tcfg.igr_ns_weight
            + out["gradient_error"] * tcfg.igr_weight)

    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]

    with torch.no_grad():
        aux = {
            "loss": loss,
            "edge_loss": e_loss * tcfg.edge_weight,
            "mse": torch.mean((out["edge"] - true_edge) ** 2),
            "gradient_error": out["gradient_error"],
            "gradient_error_near_surface": out["gradient_error_near_surface"],
            "variance": torch.mean(out["variance"]),
            "beta": out["beta"].reshape(()),
            "gamma": out["gamma"].reshape(()),
            "udf_min": torch.mean(torch.min(out["udf"], dim=-1).values),
            "udf_mean": torch.mean(out["udf"]),
            "weight_sum": torch.mean(out["weight_sum"]),
            "weight_sum_fg_bg": torch.mean(out["weight_sum_fg_bg"]),
            "sparse_error": out["sparse_error"],
        }
        aux = {k: v.detach() for k, v in aux.items()}
        if group is not None:
            summed = SHARES + RAY_MEANS
            flat = torch.cat(
                [g.reshape(-1) for g in grads]
                + [torch.stack([aux[k] * share if k in RAY_MEANS else aux[k]
                                for k in summed])])
            group.all_reduce_sum(flat)
            parts = flat.split([g.numel() for g in grads] + [len(summed)])
            grads = [p.view_as(g) for p, g in zip(parts, grads)]
            aux.update(zip(summed, parts[-1].unbind()))
        aux["psnr"] = 20.0 * torch.log10(1.0 / torch.sqrt(aux.pop("mse")))
    it = iter(grads)
    grad_tree = tree_map(lambda _: next(it), params)
    return aux.pop("loss"), aux, grad_tree


def learning_rates(step: int, tcfg: TrainConfig):
    """(lr, lr_geo) for the step: the two schedules of the JAX package."""
    factor = schedules.lr_factor(step, tcfg.warm_up_end, float(tcfg.end_iter),
                                 tcfg.learning_rate_alpha)
    lr = tcfg.learning_rate * factor
    if tcfg.same_lr:
        return lr, lr
    return lr, tcfg.learning_rate_geo * schedules.lr_factor_geo(
        step, tcfg.fix_geo_end, tcfg.warm_up_end, float(tcfg.end_iter),
        tcfg.learning_rate_alpha)


def image_index(state: TrainState, n_images: int) -> int:
    """The epoch-wise image permutation: a host-side draw per epoch, seeded
    from the state's permutation root."""
    epoch, pos = divmod(state.step, n_images)
    gen = torch.Generator().manual_seed(state.perm_seed * 1_000_003 + epoch)
    return int(torch.randperm(n_images, generator=gen)[pos])


class StepInputs:
    """What the host works out for a step, as 0-d tensors on the step's
    device: the step counter (the variance gate), the image index, the two
    render schedules and the two learning rates. `set` refreshes them in
    place, one `fill_` each, which on the card is a launch and not a copy,
    so a step captured in a CUDA graph reads the values of each replay."""

    def __init__(self, device):
        def zero(dtype=torch.float32):
            return torch.zeros((), dtype=dtype, device=device)

        self.step = zero(torch.int64)
        self.img_idx = zero(torch.int64)
        self.cos_anneal_ratio = zero()
        self.flip_saturation = zero()
        self.lr = zero()
        self.lr_geo = zero()
        # the field's trainability mask: always on
        self.one = torch.ones((), dtype=torch.float32, device=device)

    def set(self, step: int, img_idx: int, tcfg: TrainConfig) -> None:
        lr, lr_geo = learning_rates(step, tcfg)
        for t, v in ((self.step, step), (self.img_idx, img_idx),
                     (self.cos_anneal_ratio,
                      schedules.cos_anneal_ratio(step, tcfg.anneal_end)),
                     (self.flip_saturation,
                      schedules.flip_saturation(step, float(tcfg.end_iter))),
                     (self.lr, lr), (self.lr_geo, lr_geo)):
            t.fill_(v)


def _label_trees(params, state: TrainState, inputs: StepInputs):
    """Per-leaf learning rates and trainability masks matching `params`,
    all 0-d tensors on the step's device."""
    lr_tree = {
        "udf": tree_map(lambda _: inputs.lr_geo, params["udf"]),
        "variance": tree_map(lambda _: inputs.lr, params["variance"]),
        "beta": tree_map(lambda _: inputs.lr, params["beta"]),
    }
    var_mask = state.variance_trainable.to(torch.float32)
    mask_tree = {
        "udf": tree_map(lambda _: inputs.one, params["udf"]),
        "variance": tree_map(lambda _: var_mask, params["variance"]),
        "beta": {
            "beta": state.beta_trainable.to(torch.float32),
            "gamma": state.gamma_trainable.to(torch.float32),
            "zeta": state.zeta_trainable.to(torch.float32),
        },
    }
    return lr_tree, mask_tree


def step_body(state: TrainState, pool: RayPool, inputs: StepInputs,
              tcfg: TrainConfig, rcfg: RenderConfig, ucfg: UDFConfig,
              sample_fn=None, group=None) -> dict:
    """The device work of one step, updating the state's tensors in place
    and reading the step's values from `inputs` only: no host sync, no
    copy from the host, so a CUDA graph can hold it. Returns the metrics
    as 0-d device tensors. `state.step` is the caller's to advance.

    With a `group` (parallel/mesh.py::RayGroup) this rank takes its rows
    of the `batch_size` batch and the group's summed gradients
    (loss_and_grads), so every rank makes the same update.

    `sample_fn` (tests only): `(state, pool) -> (batch, img_idx)` replaces
    the ray sampling, so a prescribed batch (the group's, under a group)
    goes through the unchanged step."""
    if tcfg.batch_size % (1 if group is None else group.world):
        raise ValueError(f"batch_size {tcfg.batch_size} does not split over "
                         f"{group.world} ranks")
    if sample_fn is not None:
        batch, _ = sample_fn(state, pool)
        if group is not None:
            batch = {k: group.shard(v) for k, v in batch.items()}
    else:
        batch = sample_rays(pool, inputs.img_idx, state.generator,
                            tcfg.batch_size,
                            importance_sample=tcfg.importance_sample,
                            group=group)

    loss, aux, grads = loss_and_grads(state.params, batch, state.generator,
                                      tcfg, rcfg, ucfg,
                                      inputs.cos_anneal_ratio,
                                      inputs.flip_saturation, group)
    lr_tree, mask_tree = _label_trees(state.params, state, inputs)
    adam_update(state.params, grads, state.opt, lr_tree, mask_tree)

    # trainability gates, effective next step (in place: a captured step
    # writes the state's own tensors)
    trigger = ((aux["variance"] < 2.0 * aux["beta"]) & (aux["variance"] < 0.01)
               & state.beta_gate_armed & state.variance_trainable)
    state.beta_trainable |= trigger
    state.beta_gate_armed &= ~trigger
    state.variance_trainable |= inputs.step > 20000

    metrics = dict(aux)
    metrics.update(loss=loss, lr=inputs.lr.clone(),
                   lr_geo=inputs.lr_geo.clone(),
                   beta_trainable=state.beta_trainable.clone())
    return metrics


def train_step(state: TrainState, pool: RayPool, tcfg: TrainConfig,
               rcfg: RenderConfig, ucfg: UDFConfig, n_images: int,
               sample_fn=None, group=None) -> dict:
    """One eager step, updating `state` in place. Returns the metrics as
    0-d device tensors."""
    inputs = StepInputs(state.generator.device)
    inputs.set(state.step, image_index(state, n_images), tcfg)
    metrics = step_body(state, pool, inputs, tcfg, rcfg, ucfg, sample_fn,
                        group)
    state.step += 1
    return metrics


def pack_metrics(metrics: dict) -> torch.Tensor:
    """The METRIC_KEYS of a step (0-d device tensors) as one float32 device
    vector."""
    return torch.stack([metrics[k].to(torch.float32).reshape(())
                        for k in METRIC_KEYS])


def unpack_metrics(vec) -> dict:
    return {k: float(vec[i]) for i, k in enumerate(METRIC_KEYS)}


def build_train_step(tcfg: TrainConfig, rcfg: RenderConfig, ucfg: UDFConfig,
                     n_images: int, sample_fn=None, group=None):
    """train_step(state, pool) -> metrics dict, with the configs bound (the
    counterpart of the JAX package's build_train_step; `group` is its
    `mesh`)."""
    def step_fn(state: TrainState, pool: RayPool) -> dict:
        return train_step(state, pool, tcfg, rcfg, ucfg, n_images,
                          sample_fn=sample_fn, group=group)

    return step_fn


class ChainedStep:
    """`chain` training steps a call: the counterpart of the JAX package's
    build_chained_train_step (`lax.scan` over the step). A call advances
    the state by `chain` steps and returns their metric rows, a
    (chain, len(METRIC_KEYS)) device tensor, with no host sync.

    On the card the first call runs one eager step on a side stream (the
    warm-up: cuBLAS, the kernel libraries and the allocator set themselves
    up outside the capture), then captures one `step_body` into a
    torch.cuda.CUDAGraph on that stream, with the state's generator
    registered, and replays it for the chain's other steps; later calls
    replay it `chain` times. Before each replay the host refreshes the
    step's `StepInputs`; after it the graph's metric vector is copied out,
    since the next replay overwrites it. The graph holds the addresses of
    the state's tensors: a call with another state object captures again.
    A capture or replay that fails raises; nothing falls back to eager
    dispatch on the card. On the CPU the same step runs eagerly. The step
    computes at the tiers its configs resolve to
    (render/renderer.py::resolved_tiers): the capture records the
    up-sampler's TF32 matmuls (its bf16 tier) and the kernels launched at
    their tiers, so a replay computes what an eager step computes.

    The kernel wrappers count a launch where they launch: the capture
    counts the launches that the graph holds without running them, and a
    replay runs them without counting. `captured_launches` and
    `replayed_launches` keep both, so the kernels' runs are the wrappers'
    counts less the one and plus the other.

    With a `group` (parallel/mesh.py::RayGroup, NCCL on the card) the
    step's collectives are captured in the graph with the rest: the
    warm-up step makes them once eagerly on the capture stream first, as
    NCCL wants, and `collectives_per_step` counts those a replay runs. The
    capture then runs in the thread-local capture mode, so that the
    process group's watchdog thread may query its events meanwhile."""

    def __init__(self, tcfg: TrainConfig, rcfg: RenderConfig,
                 ucfg: UDFConfig, n_images: int, chain: int, sample_fn=None,
                 group=None):
        if chain < 1:
            raise ValueError(f"chain must be at least 1, got {chain}")
        self.tcfg, self.rcfg, self.ucfg = tcfg, rcfg, ucfg
        self.n_images, self.chain, self.sample_fn = n_images, chain, sample_fn
        self.group = group
        self.collectives_per_step = 0
        self.graph = None
        self.inputs = None
        self.vec = None  # the graph's metric vector
        self._state = None
        self.captured_launches: dict = {}
        self.replayed_launches: dict = {}
        self._per_replay: dict = {}

    def _body(self, state, pool) -> dict:
        return step_body(state, pool, self.inputs, self.tcfg, self.rcfg,
                         self.ucfg, self.sample_fn, self.group)

    def __call__(self, state: TrainState, pool: RayPool) -> torch.Tensor:
        dev = state.generator.device
        rows = torch.empty((self.chain, len(METRIC_KEYS)), dtype=torch.float32,
                           device=dev)
        if dev.type != "cuda":
            for k in range(self.chain):
                rows[k] = pack_metrics(train_step(
                    state, pool, self.tcfg, self.rcfg, self.ucfg,
                    self.n_images, self.sample_fn, self.group))
            return rows
        first = 0
        if self.graph is None or self._state is not state:
            self._capture(state, pool, rows[0])
            first = 1
        for k in range(first, self.chain):
            self.inputs.set(state.step, image_index(state, self.n_images),
                            self.tcfg)
            self.graph.replay()
            rows[k].copy_(self.vec)
            state.step += 1
            for name, n in self._per_replay.items():
                self.replayed_launches[name] = (
                    self.replayed_launches.get(name, 0) + n)
        return rows

    def _capture(self, state: TrainState, pool: RayPool, row) -> None:
        """The warm-up step (a real step of the run, written to `row`) and
        the capture of the next, which leaves the state as it was: a
        capture records the work and runs none of it."""
        from emap_tpu_torch.kernels import launch_counts

        self.release()
        dev = state.generator.device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        # made (zero-filled) on the main stream before the side stream waits
        # on it: otherwise the zero fills may land after the side stream's
        # `set`, and the warm-up step reads zeros
        self.inputs = StepInputs(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.inputs.set(state.step, image_index(state, self.n_images),
                            self.tcfg)
            row.copy_(pack_metrics(self._body(state, pool)))
        main.wait_stream(side)
        state.step += 1
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        before = launch_counts()
        collectives = 0 if self.group is None else self.group.collectives
        mode = "global" if self.group is None else "thread_local"
        with torch.cuda.graph(graph, stream=side, capture_error_mode=mode):
            vec = pack_metrics(self._body(state, pool))
        if self.group is not None:
            self.collectives_per_step = self.group.collectives - collectives
        self._per_replay = {k: v - before[k]
                            for k, v in launch_counts().items()}
        for name, n in self._per_replay.items():
            self.captured_launches[name] = (
                self.captured_launches.get(name, 0) + n)
        self.graph, self.vec, self._state = graph, vec, state

    def release(self) -> None:
        """Drop the graph, and with it its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.vec = self._state = None


def build_chained_train_step(tcfg: TrainConfig, rcfg: RenderConfig,
                             ucfg: UDFConfig, n_images: int, chain: int,
                             sample_fn=None, group=None) -> ChainedStep:
    """`chain` steps a call, with the configs bound (the counterpart of the
    JAX package's build_chained_train_step): see ChainedStep."""
    return ChainedStep(tcfg, rcfg, ucfg, n_images, chain, sample_fn, group)
