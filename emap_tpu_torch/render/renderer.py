"""Unbiased two-sided UDF volume renderer (port of
emap_tpu/render/renderer.py).

One call renders a batch of rays: stratified base samples -> 5 rounds of
no-grad importance up-sampling -> field value + spatial gradient at the
mid-points -> occlusion/visibility cumprod -> two-sided alpha blend ->
weights -> edge/depth/normal integration and the eikonal terms. The train
step differentiates the result with autograd; the loss depends on the
spatial gradient, so the field query is differentiated twice.
"""

from __future__ import annotations

import dataclasses

import torch

from emap_tpu_torch.fields.scalars import beta_gamma_zeta, inv_s_value
from emap_tpu_torch.fields.udf import UDFConfig, udf_value, udf_value_and_gradient
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
    # Parsed for conf compatibility; the port samples and trains in float32
    # for now, so neither selects a tier yet.
    sampler_precision: str = "default"
    field_precision: str = ""

    def __post_init__(self):
        if self.n_outside != 0:
            raise NotImplementedError(
                "n_outside > 0 (NeRF++ background) is dead in the reference "
                "and not supported.")
        if self.sdf2alpha_type not in ("numerical", "theorical"):
            raise ValueError(f"unknown sdf2alpha_type {self.sdf2alpha_type!r}")
        if self.upsampling_type != "classical":
            raise NotImplementedError(
                f"upsampling_type {self.upsampling_type!r}: only \"classical\" "
                "is ported (ROADMAP.md queue 1).")

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
        if self.n_importance == 0:
            return 0
        return (self.n_importance // self.up_sample_steps) * self.up_sample_steps

    @property
    def total_samples(self) -> int:
        return self.n_samples + self.n_importance_delivered


def safe_l2norm(x, dim=-1, keepdim=False):
    """L2 norm whose gradient is 0 at x == 0 (torch.linalg.norm's
    subgradient, without the 0/0 of a plain sqrt): the spatial gradient can
    be exactly zero (abs head at y0 == 0)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    nz = sq > 0
    norm = torch.sqrt(torch.where(nz, sq, torch.ones_like(sq)))
    return torch.where(nz, norm, torch.zeros_like(norm))


def query_field(params, pts_flat, udf_cfg: UDFConfig):
    """Value + spatial gradient at render_core's no-grad sample points: the
    fused kernels (CUDA on the card, their plain versions on the CPU), or
    plain autograd with `pallas_train = "off"`. The kernels refuse a net
    they do not take (kernels/mlp_query.py::check_kernel_cfg)."""
    if udf_cfg.pallas_train == "off":
        return udf_value_and_gradient(params["udf"], pts_flat, udf_cfg)
    from emap_tpu_torch.kernels.mlp_train import udf_train_value_and_gradient

    return udf_train_value_and_gradient(params["udf"], pts_flat, udf_cfg)


def render_core(params, rays_o, rays_d, z_vals, sample_dist: float,
                cfg: RenderConfig, udf_cfg: UDFConfig, cos_anneal_ratio,
                flip_saturation, background_rgb=None):
    batch, n = z_vals.shape
    ones = torch.ones((batch, 1), dtype=z_vals.dtype, device=z_vals.device)

    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], sample_dist)],
                      dim=-1)
    mid_z_vals = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., None]
    dirs = rays_d[:, None, :].expand(pts.shape)

    udf_flat, gradients_flat = query_field(params, pts.reshape(-1, 3), udf_cfg)
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
        vis_prob = torch.cumprod(torch.cat(
            [ones, torch.clamp(1.0 - alpha_occ + flip_saturation * vis_mask,
                               0.0, 1.0) + 1e-7], dim=-1), dim=-1)[:, :-1]
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

    weights = alpha * torch.cumprod(
        torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1), dim=-1)[:, :-1]
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

    gradient_error_pt = (safe_l2norm(gradients, dim=-1) - 1.0) ** 2
    gradient_error = torch.sum(relax_inside_sphere * gradient_error_pt) / (
        torch.sum(relax_inside_sphere) + 1e-5)
    gradient_error_near_surface = torch.sum(
        near_surface * gradient_error_pt) / (torch.sum(near_surface) + 1e-5)

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
           perturb_overwrite: float = -1.0, background_rgb=None):
    """Render a batch of rays. params: {"udf", "variance", "beta"};
    depth_scale (B, 1); `generator` (on the rays' device) draws the
    stratified jitter."""
    batch = rays_o.shape[0]
    sample_dist = (far - near) / cfg.n_samples
    perturb = cfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    z_vals = sampling.stratified_z_vals(generator, batch, near, far,
                                        cfg.n_samples, perturb,
                                        device=rays_o.device)

    if cfg.n_importance > 0:
        def udf_fn(p):
            return udf_value(params["udf"], p, udf_cfg)

        z_vals = sampling.importance_sample(
            udf_fn, rays_o, rays_d, z_vals, sample_dist, cfg.n_importance,
            cfg.up_sample_steps, use_unbias=cfg.use_unbias_render)

    ret = render_core(params, rays_o, rays_d, z_vals, sample_dist, cfg,
                      udf_cfg, cos_anneal_ratio, flip_saturation,
                      background_rgb=background_rgb)
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
