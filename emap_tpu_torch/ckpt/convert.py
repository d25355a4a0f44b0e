"""Carry weights and training state between the JAX package and the port.

The JAX package's params tree, as numpy arrays (what
`emap_tpu.ckpt.native.load_pytree` returns, or `jax.tree.map(np.asarray,
params)`), is {"udf": {"lin{l}": {"g", "v", "b"}}, "variance": {"variance",
"second_variance"}, "beta": {"beta", "gamma", "zeta"}}. The port keeps the
same keys and shapes, so converting is a checked tree map: numpy <-> float32
tensors on a device. A checkpoint written by either package's runner
(`checkpoint_payload`) loads in the other. The rendering net's params
(fields/rendering_net.py) cross over the same way
(`rendering_params_from_numpy`, and `params_to_numpy` back).
"""

from __future__ import annotations

import numpy as np
import torch

from emap_tpu_torch.fields.rendering_net import RenderingNetConfig
from emap_tpu_torch.fields.udf import UDFConfig
from emap_tpu_torch.train.optim import AdamState, tree_map
from emap_tpu_torch.train.state import TrainState, make_state

FLAG_KEYS = ("beta_trainable", "gamma_trainable", "zeta_trainable",
             "variance_trainable", "beta_gate_armed")


def check_params(params, ucfg: UDFConfig) -> None:
    """Raise ValueError unless `params` has the layout of `ucfg`'s net."""
    udf = params["udf"]
    for l, in_dim, out_dim in ucfg.layer_shapes():
        layer = udf.get(f"lin{l}")
        if layer is None:
            raise ValueError(f"params lack udf/lin{l}")
        w = layer["v"] if "v" in layer else layer["w"]
        if tuple(w.shape) != (out_dim, in_dim) or tuple(
                layer["b"].shape) != (out_dim,):
            raise ValueError(
                f"udf/lin{l} has weight {tuple(w.shape)}, bias "
                f"{tuple(layer['b'].shape)}; the conf's net wants "
                f"({out_dim}, {in_dim}), ({out_dim},)")
    extra = set(udf) - {f"lin{l}" for l, _, _ in ucfg.layer_shapes()}
    if extra:
        raise ValueError(f"params have layers the conf's net lacks: {extra}")
    for group, keys in (("variance", ("variance", "second_variance")),
                        ("beta", ("beta", "gamma", "zeta"))):
        if set(params[group]) != set(keys):
            raise ValueError(f"params/{group} must hold {keys}")


def _tensors(tree, device):
    """numpy (or array-like) leaves -> float32 tensors on `device`."""
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(device), tree)


def params_from_numpy(tree, ucfg: UDFConfig, device="cuda"):
    """The JAX package's params (numpy arrays) as the port's params."""
    out = _tensors(tree, device)
    check_params(out, ucfg)
    return out


def params_to_numpy(params):
    """The port's params as the JAX package's params tree (numpy)."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(np.float32),
                    params)


def checkpoint_payload(state: TrainState, best_loss: float) -> dict:
    """The runner's checkpoint tree, laid out as the JAX package's."""
    return {
        "params": params_to_numpy(state.params),
        "opt": {
            "mu": params_to_numpy(state.opt.mu),
            "nu": params_to_numpy(state.opt.nu),
            "count": params_to_numpy(state.opt.count),
        },
        "iter_step": np.asarray(state.step, np.int32),
        "flags": {k: np.asarray(bool(getattr(state, k))) for k in FLAG_KEYS},
        "best_loss": np.asarray(best_loss, np.float32),
    }


def rendering_params_from_numpy(tree, cfg: RenderingNetConfig,
                                device="cuda"):
    """The JAX package's rendering-net params ({"lin{l}": {"g", "v", "b"}}
    or {"w", "b"}, numpy) as the port's, checked against `cfg`'s dims
    (fields/rendering_net.py)."""
    out = _tensors(tree, device)
    dims = cfg.dims
    want = {f"lin{l}" for l in range(len(dims) - 1)}
    if set(out) != want:
        raise ValueError(f"rendering params hold {sorted(out)}; the conf's "
                         f"net has {sorted(want)}")
    for l in range(len(dims) - 1):
        layer = out[f"lin{l}"]
        keys = ("g", "v", "b") if cfg.weight_norm else ("w", "b")
        if set(layer) != set(keys):
            raise ValueError(f"rendering lin{l} must hold {keys}")
        w = layer["v"] if cfg.weight_norm else layer["w"]
        if tuple(w.shape) != (dims[l + 1], dims[l]):
            raise ValueError(f"rendering lin{l} has weight {tuple(w.shape)};"
                             f" the conf's net wants ({dims[l + 1]}, "
                             f"{dims[l]})")
    return out


def adam_from_numpy(opt: dict, device="cuda") -> AdamState:
    """An {"mu", "nu", "count"} tree of numpy leaves as the port's Adam
    state on `device`."""
    return AdamState(*(_tensors(opt[k], device)
                       for k in ("mu", "nu", "count")))


def state_from_payload(payload: dict, ucfg: UDFConfig, seed: int,
                       device="cuda") -> TrainState:
    """A TrainState from a checkpoint tree written by either package; the
    random generators restart from `seed`."""
    params = params_from_numpy(payload["params"], ucfg, device)
    opt = adam_from_numpy(payload["opt"], device)
    flags = {k: bool(payload["flags"][k]) for k in FLAG_KEYS}
    return make_state(params, seed, device, opt=opt,
                      step=int(payload["iter_step"]), flags=flags)
