"""UDF field: an 8x256 MLP over positional-encoded points, as plain
functions on a parameter dict (port of emap_tpu/fields/udf.py).

* geometric (SAL-style) init: last layer ~N(sqrt(pi)/sqrt(d), 1e-4) with
  bias -`bias`; PE-frequency input columns zeroed at lin0 and the skip layer;
* weight norm kept as explicit (g, v) with w = g * v / ||v||_row, so Adam
  sees the same parameterization as the JAX package and torch weight_norm;
* softplus(100 x)/100 activations, the skip concat scaled by 1/sqrt(2),
  and the abs/square/sdf head;
* the spatial gradient through torch.autograd.grad(create_graph=True), so
  an outer loss can differentiate through it (double backward);
* the JAX package's matmul tiers (`TIERS`): `precision` selects the tier of
  every product of apply_udf, and of its backward to any order.

Parameters are {"lin{l}": {"g", "v", "b"}} (or {"w", "b"} without weight
norm) with the JAX package's key names and shapes, so checkpoints map 1:1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

from emap_tpu_torch.fields.embedder import pe_dim, positional_encoding

Params = Dict[str, Any]

# The matmul tiers of the conf keys `precision` and `bwd_precision` (here)
# and `sampler_precision` and `field_precision` (render/renderer.py), by the
# JAX package's names. "default" is one bf16 pass: both operands rounded to
# bf16 (to nearest, ties to even), products and sums in fp32, an fp32
# result, as the TPU's MXU takes one. "high" and "highest" are fp32: the JAX
# package's "high" is a 3-pass bf16 emulation of fp32 for the MXU; on the
# H100 the kernels get fp32 from 3xTF32 and other matmuls run in fp32.
# jax.lax.Precision's aliases ("fastest", "bfloat16", ...) are not taken.
TIERS = ("default", "high", "highest")


def check_tier(name: str, key: str, allow_empty: bool = False) -> str:
    """`name` if it is a tier (or "" where the key may inherit), else
    ValueError naming the conf key."""
    if name in TIERS or (allow_empty and name == ""):
        return name
    raise ValueError(f"unknown matmul tier {key} = {name!r}: one of "
                     f"{', '.join(TIERS)}" + (' or ""' if allow_empty else ""))


def adjoint_tier(cfg: "UDFConfig") -> str:
    """The tier of the fused backward's adjoint products (the JAX package's
    `bwd_precision or precision`); the primal recompute runs at
    cfg.precision."""
    return cfg.bwd_precision or cfg.precision


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 value (ties to even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def tf32_matmuls():
    """cuBLAS may multiply fp32 matrices in TF32 inside the block; the flag is
    restored after it (the port's setting stays `use_fp32_matmuls`). A bf16
    value is exact in TF32 and a product of two is exact in fp32, so a TF32
    matmul of bf16-rounded operands is the bf16 tier's one pass with fp32
    sums and an fp32 result (a bf16 matmul would round the result to bf16,
    which the TPU does not). The flag is read when a matmul is dispatched,
    so a CUDA graph captured inside the block holds TF32 kernels."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _Bf16Matmul(torch.autograd.Function):
    """a @ b (2-D) at the bf16 tier, with the products of its backward at the
    same tier to any order, as XLA's transposed dots keep their precision."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with tf32_matmuls():
            return torch.matmul(round_bf16(a), round_bf16(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = _Bf16Matmul.apply(g, b.mT) if ctx.needs_input_grad[0] else None
        gb = _Bf16Matmul.apply(a.mT, g) if ctx.needs_input_grad[1] else None
        return ga, gb


def tier_linear(x: torch.Tensor, w: torch.Tensor, tier: str) -> torch.Tensor:
    """x (..., in) @ w.T for w (out, in) at a matmul tier."""
    if check_tier(tier, "precision") != "default":
        return torch.matmul(x, w.T)
    y = _Bf16Matmul.apply(x.reshape(-1, x.shape[-1]), w.T)
    return y.reshape(*x.shape[:-1], w.shape[0])


@dataclasses.dataclass(frozen=True)
class UDFConfig:
    d_in: int = 3
    d_out: int = 1
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: tuple = (4,)
    multires: int = 10
    bias: float = 0.5
    scale: float = 1.0
    geometric_init: bool = True
    weight_norm: bool = True
    udf_type: str = "abs"
    # The model's matmul tier (TIERS): apply_udf's products, and the fused
    # kernels' (extraction, and the training query unless the renderer's
    # field_precision replaces it).
    precision: str = "high"
    # "off" keeps the plain autograd field query in render_core; "on" uses
    # the fused kernel pair (kernels/mlp_train.py); "auto" uses it except at
    # "highest" (render/renderer.py::uses_kernels).
    pallas_train: str = "auto"
    # The tier of the fused backward's adjoint products; "" inherits
    # `precision` (adjoint_tier).
    bwd_precision: str = ""
    # Parsed for conf compatibility with emap_tpu: the experiment knobs below
    # (`chain_split`, `chain_mode`, `cache_acts`, `tile_fwd`, `tile_bwd`)
    # have no CUDA counterpart. `fuse_pe` is what the CUDA kernels always do.
    fuse_pe: bool = True
    chain_split: int = 1
    chain_mode: str = "seq"
    cache_acts: bool = False
    tile_fwd: int = 0
    tile_bwd: int = 0

    def __post_init__(self):
        check_tier(self.precision, "precision")
        check_tier(self.bwd_precision, "bwd_precision", allow_empty=True)

    @classmethod
    def from_conf(cls, conf) -> "UDFConfig":
        return cls(
            precision=conf.get_string("precision", "high"),
            bwd_precision=conf.get_string("bwd_precision", ""),
            pallas_train=conf.get_string("pallas_train", "auto"),
            fuse_pe=conf.get_bool("fuse_pe", True),
            chain_split=conf.get_int("chain_split", 1),
            chain_mode=conf.get_string("chain_mode", "seq"),
            cache_acts=conf.get_bool("cache_acts", False),
            tile_fwd=conf.get_int("tile_fwd", 0),
            tile_bwd=conf.get_int("tile_bwd", 0),
            d_in=conf.get_int("d_in", 3),
            d_out=conf.get_int("d_out", 1),
            d_hidden=conf.get_int("d_hidden", 256),
            n_layers=conf.get_int("n_layers", 8),
            skip_in=tuple(conf.get_list("skip_in", [4])),
            multires=conf.get_int("multires", 0),
            bias=conf.get_float("bias", 0.5),
            scale=conf.get_float("scale", 1.0),
            geometric_init=conf.get_bool("geometric_init", True),
            weight_norm=conf.get_bool("weight_norm", True),
            udf_type=conf.get_string("udf_type", "abs"),
        )

    @property
    def dims(self) -> tuple:
        d0 = pe_dim(self.multires, self.d_in) if self.multires > 0 else self.d_in
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)

    def layer_shapes(self):
        """Yield (layer_index, in_dim, out_dim) honoring skip shrinkage."""
        dims = self.dims
        for l in range(len(dims) - 1):
            out_dim = dims[l + 1]
            if (l + 1) in self.skip_in:
                out_dim -= dims[0]
            yield l, dims[l], out_dim


def init_udf_params(generator: torch.Generator, cfg: UDFConfig,
                    device="cuda") -> Params:
    """Geometric initialization; random draws come from `generator` (a CPU
    generator, so the same seed gives the same weights on any device)."""
    dims = cfg.dims
    d0 = dims[0]
    n_linear = len(dims) - 1

    def normal(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float64)

    def uniform(lo, hi, *shape):
        u = torch.rand(*shape, generator=generator, dtype=torch.float64)
        return lo + (hi - lo) * u

    params: Params = {}
    for l, in_dim, out_dim in cfg.layer_shapes():
        if cfg.geometric_init:
            std = math.sqrt(2.0) / math.sqrt(out_dim)
            if l == n_linear - 1:
                w = math.sqrt(math.pi) / math.sqrt(in_dim) + 1e-4 * normal(
                    out_dim, in_dim)
                b = torch.full((out_dim,), -cfg.bias, dtype=torch.float64)
            elif cfg.multires > 0 and l == 0:
                w = torch.zeros(out_dim, in_dim, dtype=torch.float64)
                w[:, :3] = normal(out_dim, 3) * std
                b = torch.zeros(out_dim, dtype=torch.float64)
            elif cfg.multires > 0 and l in cfg.skip_in:
                w = normal(out_dim, in_dim) * std
                w[:, -(d0 - 3):] = 0.0
                b = torch.zeros(out_dim, dtype=torch.float64)
            else:
                w = normal(out_dim, in_dim) * std
                b = torch.zeros(out_dim, dtype=torch.float64)
        else:
            lim = np.sqrt(6.0 / in_dim) / np.sqrt(2.0)
            w = uniform(-lim, lim, out_dim, in_dim)
            bound = 1.0 / np.sqrt(in_dim)
            b = uniform(-bound, bound, out_dim)
        w = w.to(torch.float32)
        layer: Params = {"b": b.to(device=device, dtype=torch.float32)}
        if cfg.weight_norm:
            layer["g"] = torch.linalg.norm(w, dim=1).to(device)
            layer["v"] = w.to(device)
        else:
            layer["w"] = w.to(device)
        params[f"lin{l}"] = layer
    return params


def effective_weight(layer: Params) -> torch.Tensor:
    """w = g * v / ||v||_row (weight norm), or the plain weight."""
    if "g" in layer:
        v = layer["v"]
        vn = torch.linalg.norm(v, dim=1, keepdim=True)
        return layer["g"][:, None] * v / vn
    return layer["w"]


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """softplus(100 x)/100 in the JAX package's stable form
    (max(t, 0) + log1p(exp(-|t|)), no threshold branch)."""
    t = x * 100.0
    return (torch.clamp(t, min=0.0) + torch.log1p(torch.exp(-t.abs()))) / 100.0


def udf_head(x: torch.Tensor, udf_type: str) -> torch.Tensor:
    if udf_type == "abs":
        return torch.abs(x)
    if udf_type == "square":
        return x ** 2
    if udf_type == "sdf":
        return x
    raise ValueError(f"unknown udf_type {udf_type!r}")


def apply_udf(params: Params, pts: torch.Tensor, cfg: UDFConfig) -> torch.Tensor:
    """pts (..., 3) -> (..., d_out); channel 0 is the UDF value. Every
    product runs at cfg.precision (tier_linear)."""
    inputs = pts * cfg.scale
    if cfg.multires > 0:
        inputs = positional_encoding(inputs, cfg.multires)
    x = inputs
    n_linear = len(cfg.dims) - 1
    for l in range(n_linear):
        if l in cfg.skip_in:
            x = torch.cat([x, inputs], dim=-1) / math.sqrt(2.0)
        layer = params[f"lin{l}"]
        x = tier_linear(x, effective_weight(layer), cfg.precision) + layer["b"]
        if l < n_linear - 1:
            x = softplus100(x)
    head = udf_head(x[..., :1], cfg.udf_type) / cfg.scale
    return torch.cat([head, x[..., 1:]], dim=-1)


def udf_value(params: Params, pts: torch.Tensor, cfg: UDFConfig) -> torch.Tensor:
    """pts (..., 3) -> (...,) UDF values."""
    return apply_udf(params, pts, cfg)[..., 0]


def udf_gradient(params: Params, pts: torch.Tensor,
                 cfg: UDFConfig) -> torch.Tensor:
    """d udf / d pts, shape (..., 3): the gradient of
    udf_value_and_gradient, with its graph kept, so a loss on it
    differentiates w.r.t. params (the eikonal term's double backward)."""
    return udf_value_and_gradient(params, pts, cfg)[1]


def udf_value_and_gradient(params: Params, pts: torch.Tensor,
                           cfg: UDFConfig):
    """(udf (...,), d udf / d pts (..., 3)). The gradient keeps its graph
    (create_graph=True), so a loss on it differentiates w.r.t. params."""
    with torch.enable_grad():
        x = pts if pts.requires_grad else pts.detach().requires_grad_(True)
        vals = udf_value(params, x, cfg)
        (grads,) = torch.autograd.grad(vals, x, torch.ones_like(vals),
                                       create_graph=True)
    return vals, grads
