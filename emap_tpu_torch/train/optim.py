"""Adam with per-leaf learning rates and dynamic trainability masks (port
of emap_tpu/train/optim.py).

Torch semantics: bias-corrected moments, eps outside the sqrt. A leaf whose
mask is 0 keeps its value, both moments and its step count, exactly like a
torch param with requires_grad=False. Masks are 0-d device tensors, so a
gate flipped on the device takes effect without a host sync. The update is
in place (parameters and moments are overwritten), which saves a copy of
the state per step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class AdamState(NamedTuple):
    mu: Any  # first moments, same tree as params
    nu: Any  # second moments
    count: Any  # per-leaf step counts (0-d float32)


def tree_map(fn, *trees):
    """Map over nested dicts of tensors (the params layout)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def adam_init(params) -> AdamState:
    return AdamState(
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params),
        count=tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                             device=p.device), params),
    )


@torch.no_grad()
def adam_update(params, grads, state: AdamState, lr_tree, mask_tree,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """In place: params, state.mu, state.nu and state.count. lr_tree holds
    0-d tensors or python floats, mask_tree 0-d tensors (or floats); a grad
    of None counts as zero. A float mask becomes a tensor here, a copy from
    the host: the training step passes float32 tensors on the params'
    device, which `as_tensor` returns as they are."""

    def leaf(p, g, m, v, c, lr, mask):
        if g is None:
            g = torch.zeros_like(p)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=p.device)
        on = mask > 0
        c_new = c + mask
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        denom_c = torch.clamp(c_new, min=1.0)
        m_hat = m_new / (1.0 - torch.pow(b1, denom_c))
        v_hat = v_new / (1.0 - torch.pow(b2, denom_c))
        p_new = p - lr * m_hat / (torch.sqrt(v_hat) + eps)
        p.copy_(torch.where(on, p_new, p))
        m.copy_(torch.where(on, m_new, m))
        v.copy_(torch.where(on, v_new, v))
        c.copy_(c_new)

    tree_map(leaf, params, grads, state.mu, state.nu, state.count, lr_tree,
             mask_tree)
