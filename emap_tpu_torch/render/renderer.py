"""Unbiased two-sided UDF volume renderer (port of
emap_tpu/render/renderer.py).

One call renders a batch of rays: stratified base samples -> no-grad
importance up-sampling ("classical": 5 rounds; "mix": 5 occlusion-blind
rounds with the learned gamma, then one unbiased round) -> field value +
spatial gradient at the mid-points -> occlusion/visibility cumprod ->
two-sided alpha blend -> weights -> edge/depth/normal integration and the
eikonal terms. The train step differentiates the result with autograd; the
loss depends on the spatial gradient, so the field query is differentiated
twice. The field query runs at the tiers `resolved_tiers` names: the
up-sampler's at `sampler_precision`, render_core's at `field_precision`
where it is set (else the model's `precision`), as in the JAX package.
The two schedules (`cos_anneal_ratio`, `flip_saturation`) may be
python floats or 0-d tensors on the rays' device.
"""

from __future__ import annotations

import dataclasses

import torch

from emap_tpu_torch.fields.scalars import beta_gamma_zeta, inv_s_value
from emap_tpu_torch.fields.udf import (
    UDFConfig,
    adjoint_tier,
    check_tier,
    udf_value,
    udf_value_and_gradient,
)
from emap_tpu_torch.render import sampling


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_samples: int = 64
    n_importance: int = 50
    n_outside: int = 0
    up_sample_steps: int = 5
    perturb: float = 1.0
    sdf2alpha_type: str = "numerical"
    upsampling_type: str = "classical"
    use_unbias_render: bool = True
    sparse_scale_factor: float = 25000.0
    use_norm_grad_for_cosine: bool = False
    near_surface: float = 0.05
    beta_min: float = 0.00005
    # The matmul tier (fields/udf.py::TIERS) of the up-sampler's no-grad
    # field queries: they only place samples, which render_core queries
    # again.
    sampler_precision: str = "default"
    # The tier of render_core's field query, the training query: "" keeps
    # the model's `precision`; a tier replaces it for that query alone
    # (extraction stays at the model's). from_conf defaults it to "default",
    # the JAX package's production tier (train/runner.py keeps the model's
    # where a conf pins only `precision`).
    field_precision: str = ""

    def __post_init__(self):
        if self.n_outside != 0:
            raise NotImplementedError(
                "n_outside > 0 (NeRF++ background) is dead in the reference "
                "and not supported.")
        if self.sdf2alpha_type not in ("numerical", "theorical"):
            raise ValueError(f"unknown sdf2alpha_type {self.sdf2alpha_type!r}")
        if self.upsampling_type not in ("classical", "mix"):
            raise ValueError(
                f"unknown upsampling_type {self.upsampling_type!r}")
        check_tier(self.sampler_precision, "sampler_precision")
        check_tier(self.field_precision, "field_precision", allow_empty=True)

    @classmethod
    def from_conf(cls, conf) -> "RenderConfig":
        return cls(
            n_samples=conf.get_int("n_samples", 64),
            n_importance=conf.get_int("n_importance", 50),
            n_outside=conf.get_int("n_outside", 0),
            up_sample_steps=conf.get_int("up_sample_steps", 5),
            perturb=conf.get_float("perturb", 1.0),
            sdf2alpha_type=conf.get_string("sdf2alpha_type", "numerical"),
            upsampling_type=conf.get_string("upsampling_type", "classical"),
            use_unbias_render=conf.get_bool("use_unbias_render", True),
            sparse_scale_factor=conf.get_float("sparse_scale_factor", 25000.0),
            use_norm_grad_for_cosine=conf.get_bool(
                "use_norm_grad_for_cosine", False),
            near_surface=conf.get_float("near_surface", 0.05),
            sampler_precision=conf.get_string("sampler_precision", "default"),
            field_precision=conf.get_string("field_precision", "default"),
        )

    @property
    def n_importance_delivered(self) -> int:
        """Extra samples the up-sampler produces: "classical" delivers
        steps * (n // steps), "mix" (steps + 1) * (n // (steps + 1)), the
        reference's under-delivery (the JAX package keeps it)."""
        if self.n_importance == 0:
            return 0
        rounds = self.up_sample_steps + (self.upsampling_type == "mix")
        return (self.n_importance // rounds) * rounds

    @property
    def total_samples(self) -> int:
        return self.n_samples + self.n_importance_delivered


class _CumprodOfPositives(torch.autograd.Function):
    """torch.cumprod over the last dim of a tensor with no zero, with the
    backward PyTorch takes for such an input: (out * g) summed from the
    right, divided by x. PyTorch's own cumprod backward (2.11) first asks
    on the host whether the input holds a zero, a sync that a CUDA graph of
    the step cannot hold. render_core's factors are never zero: each is 1,
    clamp(.., 0, 1) + 1e-7, or 1 - alpha + 1e-7 with alpha a blend of
    values in [0, 1]."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return (out * g).flip(-1).cumsum(-1).flip(-1).div(x)


def cumprod_of_positives(x: torch.Tensor) -> torch.Tensor:
    return _CumprodOfPositives.apply(x)


def safe_l2norm(x, dim=-1, keepdim=False):
    """L2 norm whose gradient is 0 at x == 0 (torch.linalg.norm's
    subgradient, without the 0/0 of a plain sqrt): the spatial gradient can
    be exactly zero (abs head at y0 == 0)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    nz = sq > 0
    norm = torch.sqrt(torch.where(nz, sq, torch.ones_like(sq)))
    return torch.where(nz, norm, torch.zeros_like(norm))


def field_config(cfg: RenderConfig, udf_cfg: UDFConfig) -> UDFConfig:
    """The UDFConfig of render_core's field query: the model's, with
    `precision` replaced by `field_precision` where that is set and differs
    (emap_tpu/render/renderer.py:220-225). An empty `bwd_precision` then
    inherits the replaced tier."""
    if cfg.field_precision and cfg.field_precision != udf_cfg.precision:
        return dataclasses.replace(udf_cfg, precision=cfg.field_precision)
    return udf_cfg


def sampler_config(cfg: RenderConfig, udf_cfg: UDFConfig) -> UDFConfig:
    """The UDFConfig of the up-sampler's field queries
    (emap_tpu/render/renderer.py:386-388)."""
    return dataclasses.replace(udf_cfg, precision=cfg.sampler_precision)


def uses_kernels(udf_cfg: UDFConfig) -> bool:
    """Whether render_core's field query takes the fused kernels (at
    udf_cfg's tiers) or plain autograd: "off" never, "on" always, "auto"
    unless the field or adjoint tier is "highest", where the JAX package
    takes XLA autodiff at HIGHEST (emap_tpu/render/renderer.py:147-156) and
    the port plain autograd in fp32."""
    if udf_cfg.pallas_train == "off":
        return False
    if udf_cfg.pallas_train == "on":
        return True
    return "highest" not in (udf_cfg.precision, udf_cfg.bwd_precision)


def resolved_tiers(cfg: RenderConfig, udf_cfg: UDFConfig) -> dict:
    """The tier each site computes at, and the training query's route: the
    training field query (primal and adjoint), the up-sampler, extraction
    (the model's tier)."""
    field = field_config(cfg, udf_cfg)
    return {"field": field.precision, "adjoint": adjoint_tier(field),
            "sampler": cfg.sampler_precision,
            "extraction": udf_cfg.precision,
            "route": "kernels" if uses_kernels(field) else "autograd"}


def query_field(params, pts_flat, udf_cfg: UDFConfig):
    """Value + spatial gradient at render_core's no-grad sample points, at
    udf_cfg's tiers: the fused kernels (CUDA on the card, their plain
    versions on the CPU), or plain autograd (uses_kernels). The kernels
    refuse a net they do not take (kernels/mlp_query.py::check_kernel_cfg)."""
    if not uses_kernels(udf_cfg):
        return udf_value_and_gradient(params["udf"], pts_flat, udf_cfg)
    from emap_tpu_torch.kernels.mlp_train import udf_train_value_and_gradient

    return udf_train_value_and_gradient(params["udf"], pts_flat, udf_cfg)


def render_core(params, rays_o, rays_d, z_vals, sample_dist: float,
                cfg: RenderConfig, udf_cfg: UDFConfig, cos_anneal_ratio,
                flip_saturation, background_rgb=None, group=None):
    """One batch of rays at given samples. With a `group`
    (parallel/mesh.py::RayGroup) the rays are this rank's rows of the
    group's batch: the two eikonal terms are ratios of sums whose
    denominators count the group's points inside the masks, so those
    counts are summed over the ranks (one detached all-reduce) and each
    rank's term is its share of the group's, which sums to it over the
    ranks (the JAX package's sharded mean)."""
    batch, n = z_vals.shape
    ones = torch.ones((batch, 1), dtype=z_vals.dtype, device=z_vals.device)

    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], sample_dist)],
                      dim=-1)
    mid_z_vals = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., None]
    dirs = rays_d[:, None, :].expand(pts.shape)

    udf_flat, gradients_flat = query_field(params, pts.reshape(-1, 3),
                                           field_config(cfg, udf_cfg))
    udf = udf_flat.reshape(batch, n)
    gradients = gradients_flat.reshape(batch, n, 3)

    gradients_mag = safe_l2norm(gradients, dim=-1, keepdim=True)
    gradients_norm = gradients / (gradients_mag + 1e-5)

    inv_s = torch.clamp(inv_s_value(params["variance"])[0], 1e-6, 1e6)
    beta, gamma, _ = beta_gamma_zeta(params["beta"], cfg.beta_min)
    beta = torch.clamp(beta[0], 1e-6, 1e6)
    gamma = torch.clamp(gamma[0], 1e-6, 1e6)

    if cfg.use_unbias_render:
        grad_for_cos = (gradients_norm if cfg.use_norm_grad_for_cosine
                        else gradients)
        true_cos = torch.sum(dirs * grad_for_cos, dim=-1)
        cos_sign = torch.sum(dirs * gradients_norm, dim=-1).detach()
        flip_sign = -torch.sign(cos_sign)
        flip_sign = torch.where(flip_sign == 0, torch.ones_like(flip_sign),
                                flip_sign)

        raw_occ = sampling.udf2logistic(udf, beta, 1.0, 1.0)
        alpha_occ = 1.0 - torch.exp(-torch.relu(raw_occ) * gamma * dists)
        vis_mask = (true_cos < 0.01).to(z_vals.dtype)
        vis_mask = torch.cat([vis_mask[:, 1:], ones], dim=-1)
        vis_prob = cumprod_of_positives(torch.cat(
            [ones, torch.clamp(1.0 - alpha_occ + flip_saturation * vis_mask,
                               0.0, 1.0) + 1e-7], dim=-1))[:, :-1]
        vis_prob = torch.clamp(vis_prob, 0.0, 1.0)

        neg_abs_cos = -torch.abs(true_cos)
        sdf2alpha = (sampling.sdf2alpha_numerical
                     if cfg.sdf2alpha_type == "numerical"
                     else sampling.sdf2alpha_theorical)
        alpha_plus = sdf2alpha(udf, neg_abs_cos, dists, inv_s, cos_anneal_ratio)
        alpha_minus = sdf2alpha(-udf, neg_abs_cos, dists, inv_s,
                                cos_anneal_ratio)
        alpha = alpha_plus * vis_prob + alpha_minus * (1.0 - vis_prob)
    else:
        flip_sign = None
        raw_occ = sampling.udf2logistic(udf, beta, 1.0, 1.0)
        alpha = 1.0 - torch.exp(-torch.relu(raw_occ) * gamma * dists)

    weights = alpha * cumprod_of_positives(
        torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1))[:, :-1]
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)

    edge = weights_sum  # the edge "appearance" is a constant 1
    depth = torch.sum(mid_z_vals * weights, dim=-1, keepdim=True)
    if background_rgb is not None:
        edge = edge + background_rgb * (1.0 - weights_sum)

    with torch.no_grad():
        pts_norm = torch.linalg.norm(pts, dim=-1)
        relax_inside_sphere = (pts_norm < 2.4).to(z_vals.dtype)
        inside_sphere = (pts_norm < 2.0).to(z_vals.dtype)
        near_surface = (udf < cfg.near_surface).to(z_vals.dtype)

        n_relax, n_near = torch.sum(relax_inside_sphere), torch.sum(
            near_surface)
        if group is not None:
            counts = group.all_reduce_sum(torch.stack([n_relax, n_near]))
            n_relax, n_near = counts[0], counts[1]

    gradient_error_pt = (safe_l2norm(gradients, dim=-1) - 1.0) ** 2
    gradient_error = torch.sum(relax_inside_sphere * gradient_error_pt) / (
        n_relax + 1e-5)
    gradient_error_near_surface = torch.sum(
        near_surface * gradient_error_pt) / (n_near + 1e-5)

    gradients_flip = (flip_sign[..., None] * gradients
                      if flip_sign is not None else gradients)
    sparse_error = torch.mean(torch.sum(
        torch.exp(-cfg.sparse_scale_factor * udf), dim=-1))
    normals = torch.sum(gradients_flip * weights[..., None], dim=1)

    return {
        "udf": udf,
        "edge": edge,
        "weights": weights,
        "s_val": 1.0 / inv_s,
        "beta": 1.0 / beta,
        "gamma": gamma,
        "depth": depth,
        "gradient_error": gradient_error,
        "gradient_error_near_surface": gradient_error_near_surface,
        "normals": normals,
        "gradients": gradients,
        "gradients_flip": gradients_flip,
        "inside_sphere": inside_sphere,
        "gradient_mag": gradients_mag.reshape(batch, n),
        "alpha": alpha,
        "mid_z_vals": mid_z_vals,
        "dists": dists,
        "sparse_error": sparse_error,
    }


def render(params, rays_o, rays_d, near: float, far: float, depth_scale,
           generator, cfg: RenderConfig, udf_cfg: UDFConfig,
           cos_anneal_ratio=1.0, flip_saturation=0.0,
           perturb_overwrite: float = -1.0, background_rgb=None, group=None):
    """Render a batch of rays. params: {"udf", "variance", "beta"};
    depth_scale (B, 1); `generator` (on the rays' device) draws the
    stratified jitter. With a `group` (parallel/mesh.py::RayGroup) the
    rays are this rank's rows of a batch of B x world rays: the jitter is
    drawn for the whole batch and sliced, as every rank draws it, and
    render_core sums the eikonal terms' counts over the ranks."""
    batch = rays_o.shape[0]
    sample_dist = (far - near) / cfg.n_samples
    perturb = cfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    z_vals = sampling.stratified_z_vals(
        generator, batch if group is None else batch * group.world, near,
        far, cfg.n_samples, perturb, device=rays_o.device)
    if group is not None:
        z_vals = group.shard(z_vals)

    if cfg.n_importance > 0:
        sampler_cfg = sampler_config(cfg, udf_cfg)

        def udf_fn(p):
            return udf_value(params["udf"], p, sampler_cfg)

        if cfg.upsampling_type == "classical":
            z_vals = sampling.importance_sample(
                udf_fn, rays_o, rays_d, z_vals, sample_dist, cfg.n_importance,
                cfg.up_sample_steps, use_unbias=cfg.use_unbias_render)
        else:
            beta, gamma, _ = beta_gamma_zeta(params["beta"], cfg.beta_min)
            z_vals = sampling.importance_sample_mix(
                udf_fn, rays_o, rays_d, z_vals, sample_dist, cfg.n_importance,
                cfg.up_sample_steps, torch.clamp(beta[0], 1e-6, 1e6),
                torch.clamp(gamma[0], 1e-6, 1e6))

    ret = render_core(params, rays_o, rays_d, z_vals, sample_dist, cfg,
                      udf_cfg, cos_anneal_ratio, flip_saturation,
                      background_rgb=background_rgb, group=group)
    n_total = cfg.total_samples
    return {
        "udf": ret["udf"],
        "edge": ret["edge"],
        "weight_sum": torch.sum(ret["weights"][:, :n_total], dim=-1,
                                keepdim=True),
        "weight_sum_fg_bg": torch.sum(ret["weights"], dim=-1, keepdim=True),
        "depth": ret["depth"] * depth_scale,
        "variance": ret["s_val"],
        "beta": ret["beta"],
        "gamma": ret["gamma"],
        "normals": ret["normals"],
        "gradients": ret["gradients"],
        "gradients_flip": ret["gradients_flip"],
        "weights": ret["weights"],
        "gradient_error": ret["gradient_error"],
        "gradient_error_near_surface": ret["gradient_error_near_surface"],
        "inside_sphere": ret["inside_sphere"],
        "gradient_mag": ret["gradient_mag"],
        "mid_z_vals": ret["mid_z_vals"],
        "dists": ret["dists"],
        "sparse_error": ret["sparse_error"],
    }
