"""Ray sampling: stratified base samples, inverse-CDF PDF sampling and the
UDF-aware hierarchical up-sampling, "classical" and "mix" (port of
emap_tpu/render/sampling.py).

The JAX package gathers and merges with one-hot matmuls, a TPU workaround;
here `torch.searchsorted`, `torch.gather` and a stable `torch.sort` do the
same selections exactly.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def stratified_z_vals(generator, batch: int, near: float, far: float,
                      n_samples: int, perturb: float,
                      device="cuda") -> torch.Tensor:
    """linspace(near, far) with a per-ray jitter of +-1/n_samples of the
    range, drawn from `generator` (on `device`) when perturb > 0."""
    z = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=device)
    z_vals = (near + (far - near) * z[None, :]).expand(batch, n_samples)
    if perturb > 0:
        t_rand = torch.rand((batch, 1), generator=generator,
                            device=device) - 0.5
        z_vals = z_vals + t_rand * 2.0 / n_samples
    return z_vals.contiguous()


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = True, generator=None,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling. bins (B, M) sorted; weights (B, M-1).
    det=True takes the midpoints of a uniform grid on [0, 1]; det=False
    draws from `generator`; `u` injects the uniforms (tests)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (B, M)
    batch = bins.shape[0]
    if u is not None:
        u = torch.as_tensor(u, dtype=bins.dtype, device=bins.device)
        u = u.expand(batch, n_samples)
    elif det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=bins.dtype, device=bins.device)
        u = u[None, :].expand(batch, n_samples)
    else:
        if generator is None:
            raise ValueError("stochastic sample_pdf needs a generator")
        u = torch.rand((batch, n_samples), generator=generator,
                       dtype=bins.dtype, device=bins.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    m = cdf.shape[-1]
    below = torch.clamp(inds - 1, 0, m - 1)
    above = torch.clamp(inds, 0, m - 1)
    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bins_below = torch.gather(bins, 1, below)
    bins_above = torch.gather(bins, 1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_pdf_det(bins, weights, n_samples: int) -> torch.Tensor:
    return sample_pdf(bins, weights, n_samples, det=True)


def udf2logistic(udf, inv_s, gamma=1.0, abs_cos_val=1.0):
    """Logistic-density bump at udf = 0."""
    e = torch.exp(-inv_s * udf)
    return abs_cos_val * inv_s * e / (1.0 + e) ** 2 * gamma


def _anneal_cos(true_cos, cos_anneal_ratio):
    if cos_anneal_ratio is None:
        return true_cos
    return -(
        torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - cos_anneal_ratio)
        + torch.relu(-true_cos) * cos_anneal_ratio
    )


def sdf2alpha_numerical(sdf, true_cos, dists, inv_s, cos_anneal_ratio=None):
    """NeuS section-integral alpha ("numerical")."""
    iter_cos = _anneal_cos(true_cos, cos_anneal_ratio)
    est_next = sdf + iter_cos * dists * 0.5
    est_prev = sdf - iter_cos * dists * 0.5
    prev_cdf = torch.sigmoid(est_prev * inv_s)
    next_cdf = torch.sigmoid(est_next * inv_s)
    p = prev_cdf - next_cdf
    c = prev_cdf
    return torch.clamp((p + 1e-5) / (c + 1e-5), 0.0, 1.0)


def sdf2alpha_theorical(sdf, true_cos, dists, inv_s, cos_anneal_ratio=None):
    """alpha = 1 - exp(-relu(|cos| inv_s (1 - sigmoid(sdf inv_s))) dist)."""
    iter_cos = _anneal_cos(true_cos, cos_anneal_ratio)
    raw = torch.abs(iter_cos) * inv_s * (1.0 - torch.sigmoid(sdf * inv_s))
    return 1.0 - torch.exp(-torch.relu(raw) * dists)


def _pad_dists(z_vals, sample_dist: float):
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    return torch.cat([dists, torch.full_like(dists[..., :1], sample_dist)],
                     dim=-1)


def _ones(batch, like):
    return torch.ones((batch, 1), dtype=like.dtype, device=like.device)


def up_sample_unbias(rays_o, rays_d, z_vals, udf, sample_dist, n_importance,
                     inv_s, beta, gamma):
    """Occlusion-aware first-intersection up-sampler."""
    batch = z_vals.shape[0]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = ((radius[:, :-1] < 1.0) | (radius[:, 1:] < 1.0)).to(
        z_vals.dtype)
    dists_raw = _pad_dists(z_vals, sample_dist)

    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    prev_udf, next_udf = udf[:, :-1], udf[:, 1:]
    mid_udf = (prev_udf + next_udf) * 0.5
    dists = next_z - prev_z

    true_cos = (next_udf - prev_udf) / (next_z - prev_z + 1e-5)
    cos_val = -torch.abs(true_cos)
    prev_cos_val = torch.cat([torch.zeros_like(cos_val[:, :1]),
                              cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos_val, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    vis_mask = (true_cos < 0.05).to(z_vals.dtype)
    vis_mask = torch.cat([_ones(batch, z_vals), vis_mask], dim=-1)

    raw_occ = udf2logistic(udf, beta, 1.0, 1.0)
    alpha_occ = 1.0 - torch.exp(-torch.relu(raw_occ) * gamma * dists_raw)
    vis_prob = torch.cumprod(torch.cat(
        [_ones(batch, z_vals),
         torch.clamp(1.0 - alpha_occ + vis_mask, 0.0, 1.0) + 1e-7], dim=-1),
        dim=-1)[:, :-1]

    signs_prob = vis_prob[:, :-1]
    alpha_plus = sdf2alpha_numerical(mid_udf, cos_val, dists, inv_s)
    alpha_minus = sdf2alpha_numerical(-mid_udf, cos_val, dists, inv_s)
    alpha = alpha_plus * signs_prob + alpha_minus * (1.0 - signs_prob)
    weights = alpha * torch.cumprod(
        torch.cat([_ones(batch, z_vals), 1.0 - alpha + 1e-7], dim=-1),
        dim=-1)[:, :-1]
    return sample_pdf_det(z_vals, weights, n_importance)


def up_sample_no_occ_aware(rays_o, rays_d, z_vals, udf, sample_dist,
                           n_importance, inv_s, beta, gamma):
    """Samples at every near-zero UDF region."""
    dists = _pad_dists(z_vals, sample_dist)
    raw_occ = udf2logistic(udf, beta, 1.0, 1.0)
    alpha_occ = 1.0 - torch.exp(-torch.relu(raw_occ) * gamma * dists)
    return sample_pdf_det(z_vals, alpha_occ[:, :-1], n_importance)


def merge_z_vals(z_vals, new_z_vals, udf, new_udf):
    """Sorted merge of z values and (optionally) their udf values; ties put
    the old samples first (a stable sort of [z | new])."""
    z_all, order = torch.sort(torch.cat([z_vals, new_z_vals], dim=-1),
                              dim=-1, stable=True)
    if new_udf is None:
        return z_all, None
    return z_all, torch.gather(torch.cat([udf, new_udf], dim=-1), 1, order)


def _query(udf_fn, rays_o, rays_d, z):
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    return udf_fn(pts.reshape(-1, 3)).reshape(z.shape)


@torch.no_grad()
def importance_sample(udf_fn: Callable, rays_o, rays_d, z_vals, sample_dist,
                      n_importance: int, up_sample_steps: int,
                      use_unbias: bool = True) -> torch.Tensor:
    """Hierarchical importance sampling without gradients; round i uses
    inv_s = 64*2^i, beta = 64*2^(i+1), gamma = clip(20*2^(steps-i), 20, 320)."""
    up_sample = up_sample_unbias if use_unbias else up_sample_no_occ_aware
    n_per_step = n_importance // up_sample_steps
    udf = _query(udf_fn, rays_o, rays_d, z_vals)
    for i in range(up_sample_steps):
        new_z = up_sample(
            rays_o, rays_d, z_vals, udf, sample_dist, n_per_step,
            64 * 2 ** i, 64 * 2 ** (i + 1),
            float(np.clip(20 * 2 ** (up_sample_steps - i), 20, 320)),
        )
        last = i + 1 == up_sample_steps
        new_udf = None if last else _query(udf_fn, rays_o, rays_d, new_z)
        z_vals, udf = merge_z_vals(z_vals, new_z, udf, new_udf)
    return z_vals



@torch.no_grad()
def importance_sample_mix(udf_fn: Callable, rays_o, rays_d, z_vals,
                          sample_dist, n_importance: int,
                          up_sample_steps: int, beta, gamma) -> torch.Tensor:
    """The "mix" strategy: `up_sample_steps` rounds of the occlusion-blind
    up-sampler with the learned gamma (round i: inv_s = 64*2^i, its beta
    argument 64*2^(i+1); the learned `beta` is taken and not used, as in
    the reference), then one unbiased round at the last round's inv_s.
    Delivers (steps+1) * (n_importance // (steps+1)) samples, fewer than
    n_importance: the reference's under-delivery, which the JAX package
    keeps."""
    n_per = n_importance // (up_sample_steps + 1)
    udf = _query(udf_fn, rays_o, rays_d, z_vals)
    for i in range(up_sample_steps):
        new_z = up_sample_no_occ_aware(rays_o, rays_d, z_vals, udf,
                                       sample_dist, n_per, 64 * 2 ** i,
                                       64 * 2 ** (i + 1), gamma)
        z_vals, udf = merge_z_vals(z_vals, new_z, udf,
                                   _query(udf_fn, rays_o, rays_d, new_z))
    i = up_sample_steps - 1
    new_z = up_sample_unbias(rays_o, rays_d, z_vals, udf, sample_dist, n_per,
                             64 * 2 ** i, 64 * 2 ** (i + 1),
                             20.0 if i < 4 else 10.0)
    z_vals, _ = merge_z_vals(z_vals, new_z, udf, None)
    return z_vals
