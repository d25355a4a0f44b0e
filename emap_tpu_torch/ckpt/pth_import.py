"""Import a released reference checkpoint (`ckpt_best.pth`), the port of
emap_tpu/ckpt/pth_import.py.

The reference saves a torch dict of three state_dicts, the Adam state and
`iter_step` (its runner_udf.py save format). They map onto the params
tree the port shares with the JAX package (ckpt/convert.py):

* `udf_network_fine.linN.parametrizations.weight.original0` -> g (out,) and
  `...original1` -> v (out, in), or the older `weight_g`/`weight_v`: the
  field keeps the same (g, v) weight-norm parameterization, so the mapping
  is lossless; a layer without weight norm (`linN.weight`) maps to w;
* the variance and beta networks map 1:1 onto (1,) scalars;
* torch's Adam state is keyed by a global parameter index in
  `named_parameters` order; it is remapped onto (mu, nu, count) trees.

The file is read with `torch.load(weights_only=True)`; the reference's
optimizer param groups hold numpy scalars, which are allowed by name.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _numpy_globals() -> list:
    """The numpy types a reference checkpoint pickles (its param groups'
    float64 scalars), for torch's weights-only unpickler."""
    core = getattr(np, "_core", None) or np.core
    return [core.multiarray.scalar, np.dtype] + [
        type(np.dtype(t)) for t in (np.float64, np.float32, np.int64,
                                    np.int32, np.bool_)]


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def load_raw(path: str) -> Dict[str, Any]:
    """The checkpoint's dict with tensors as numpy arrays."""
    with torch.serialization.safe_globals(_numpy_globals()):
        raw = torch.load(path, map_location="cpu", weights_only=True)
    return _to_numpy(raw)


def _layer_names(udf_sd) -> list:
    return sorted({k.split(".")[0] for k in udf_sd if k.startswith("lin")},
                  key=lambda s: int(s[3:]))


def _convert_udf_state(sd) -> Dict[str, Any]:
    params: Dict[str, Any] = {}
    for lin in _layer_names(sd):
        layer: Dict[str, np.ndarray] = {}
        bias = sd.get(f"{lin}.bias")
        if bias is not None:
            layer["b"] = np.asarray(bias, dtype=np.float32)
        g = sd.get(f"{lin}.parametrizations.weight.original0")
        v = sd.get(f"{lin}.parametrizations.weight.original1")
        if g is None:  # older torch weight_norm naming
            g, v = sd.get(f"{lin}.weight_g"), sd.get(f"{lin}.weight_v")
        if g is not None:
            layer["g"] = np.asarray(g, dtype=np.float32).reshape(-1)
            layer["v"] = np.asarray(v, dtype=np.float32)
        else:
            layer["w"] = np.asarray(sd[f"{lin}.weight"], dtype=np.float32)
        params[lin] = layer
    return params


def _param_index_order(udf_sd) -> list:
    """Params-tree paths in torch's global parameter-index order: the UDF
    net's group, then the variance and beta nets'. A weight-norm layer
    enumerates (bias, g, v): its (g, v) live on a parametrization submodule,
    so the layer's own bias comes first; a plain Linear enumerates (w, b)."""
    order = []
    for lin in _layer_names(udf_sd):
        if (f"{lin}.parametrizations.weight.original0" in udf_sd
                or f"{lin}.weight_g" in udf_sd):
            order += [("udf", lin, "b"), ("udf", lin, "g"), ("udf", lin, "v")]
        else:
            order += [("udf", lin, "w"), ("udf", lin, "b")]
    order += [("variance", "variance"), ("variance", "second_variance")]
    order += [("beta", "beta"), ("beta", "gamma"), ("beta", "zeta")]
    return order


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _convert_optimizer_state(opt_sd, params, udf_sd) -> Dict[str, Any]:
    """torch's Adam state as (mu, nu, count) trees shaped like `params`. A
    parameter torch never stepped has no entry: zero moments, count 0, the
    state a torch resume gives it."""
    mu = _map_tree(np.zeros_like, params)
    nu = _map_tree(np.zeros_like, params)
    count = _map_tree(lambda a: np.zeros((), np.float32), params)
    state = opt_sd.get("state", {})
    for idx, path in enumerate(_param_index_order(udf_sd)):
        entry = state.get(idx, state.get(str(idx)))
        if entry is None:
            continue
        node_p, node_mu, node_nu, node_c = params, mu, nu, count
        for p in path[:-1]:
            node_p, node_mu, node_nu, node_c = (node_p[p], node_mu[p],
                                                node_nu[p], node_c[p])
        leaf = path[-1]
        shape = node_p[leaf].shape
        node_mu[leaf] = np.asarray(entry["exp_avg"], np.float32).reshape(shape)
        node_nu[leaf] = np.asarray(entry["exp_avg_sq"],
                                   np.float32).reshape(shape)
        node_c[leaf] = np.asarray(entry["step"], np.float32).reshape(())
    return {"mu": mu, "nu": nu, "count": count}


def import_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference `.pth` into numpy params trees: {"params": {"udf",
    "variance", "beta"}, "iter_step": int, "opt": {"mu", "nu", "count"} or
    None when the file holds no optimizer}."""
    raw = load_raw(path)
    udf_sd = raw["udf_network_fine"]
    var_sd = raw["variance_network_fine"]
    beta_sd = raw["beta_network"]

    def scalar(a):
        return np.asarray(a, np.float32).reshape(1)

    params = {
        "udf": _convert_udf_state(udf_sd),
        "variance": {"variance": scalar(var_sd["variance"]),
                     "second_variance": scalar(var_sd["second_variance"])},
        "beta": {k: scalar(beta_sd[k]) for k in ("beta", "gamma", "zeta")},
    }
    opt = None
    if isinstance(raw.get("optimizer"), dict):
        opt = _convert_optimizer_state(raw["optimizer"], params, udf_sd)
    return {"params": params, "iter_step": int(raw.get("iter_step", 0)),
            "opt": opt}
