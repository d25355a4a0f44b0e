"""IDR-style rendering (colour) network (port of
emap_tpu/fields/rendering_net.py).

The EMAP pipeline never builds it: an edge's "appearance" is the constant
1. It belongs to the model's surface (the confs carry
`model.rendering_network`), so it is here as plain functions over a params
dict with the JAX package's layout ({"lin{l}": {"g", "v", "b"}} with weight
norm, {"w", "b"} without), which ckpt/convert.py carries between the two
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from emap_tpu_torch.fields.embedder import pe_dim, positional_encoding

MODES = ("idr", "no_view_dir", "no_normal")


@dataclasses.dataclass(frozen=True)
class RenderingNetConfig:
    d_feature: int = 256
    mode: str = "idr"  # idr | no_view_dir | no_normal
    d_in: int = 9
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    weight_norm: bool = True
    multires_view: int = 0
    squeeze_out: bool = True

    @classmethod
    def from_conf(cls, conf) -> "RenderingNetConfig":
        return cls(
            d_feature=conf.get_int("d_feature", 256),
            mode=conf.get_string("mode", "idr"),
            d_in=conf.get_int("d_in", 9),
            d_out=conf.get_int("d_out", 3),
            d_hidden=conf.get_int("d_hidden", 256),
            n_layers=conf.get_int("n_layers", 4),
            weight_norm=conf.get_bool("weight_norm", True),
            multires_view=conf.get_int("multires_view", 0),
            squeeze_out=conf.get_bool("squeeze_out", True),
        )

    @property
    def dims(self) -> tuple:
        d0 = self.d_in + self.d_feature
        if self.multires_view > 0 and self.mode != "no_view_dir":
            d0 += pe_dim(self.multires_view, 3) - 3
        return (d0,) + (self.d_hidden,) * self.n_layers + (self.d_out,)


def init_rendering_params(generator: torch.Generator,
                          cfg: RenderingNetConfig, device="cuda") -> Dict:
    """torch nn.Linear's default init (uniform weights and biases) split
    for weight norm, drawn from `generator` (a CPU generator, so the same
    seed gives the same weights on any device)."""
    dims = cfg.dims
    params: Dict = {}
    for l in range(len(dims) - 1):
        in_dim, out_dim = dims[l], dims[l + 1]
        bound_w = np.sqrt(6.0 / in_dim) / np.sqrt(2.0)
        bound_b = 1.0 / np.sqrt(in_dim)
        w = (torch.rand(out_dim, in_dim, generator=generator,
                        dtype=torch.float64) * 2.0 - 1.0) * bound_w
        b = (torch.rand(out_dim, generator=generator, dtype=torch.float64)
             * 2.0 - 1.0) * bound_b
        w = w.to(torch.float32)
        layer = {"b": b.to(device=device, dtype=torch.float32)}
        if cfg.weight_norm:
            layer["g"] = torch.linalg.norm(w, dim=1).to(device)
            layer["v"] = w.to(device)
        else:
            layer["w"] = w.to(device)
        params[f"lin{l}"] = layer
    return params


def apply_rendering_net(params: Dict, points: torch.Tensor,
                        normals: torch.Tensor, view_dirs: torch.Tensor,
                        feature_vectors: torch.Tensor,
                        cfg: RenderingNetConfig) -> torch.Tensor:
    """Colours (..., d_out) of the net at (..., 3) points, normals and view
    directions and (..., d_feature) features. The normals carry no
    gradient (the reference detaches them)."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown rendering mode {cfg.mode!r}")
    if cfg.multires_view > 0 and cfg.mode != "no_view_dir":
        view_dirs = positional_encoding(view_dirs, cfg.multires_view)
    normals = normals.detach()
    if cfg.mode == "idr":
        parts = [points, view_dirs, normals, -normals, feature_vectors]
    elif cfg.mode == "no_view_dir":
        parts = [points, normals, -normals, feature_vectors]
    else:
        parts = [points, view_dirs, feature_vectors]
    x = torch.cat(parts, dim=-1)

    n_linear = len(cfg.dims) - 1
    for l in range(n_linear):
        layer = params[f"lin{l}"]
        if "g" in layer:
            v = layer["v"]
            w = layer["g"][:, None] * v / torch.linalg.norm(v, dim=1,
                                                             keepdim=True)
        else:
            w = layer["w"]
        x = x @ w.T + layer["b"]
        if l < n_linear - 1:
            x = torch.relu(x)

    color = x[..., :cfg.d_out]
    return torch.sigmoid(color) if cfg.squeeze_out else color
