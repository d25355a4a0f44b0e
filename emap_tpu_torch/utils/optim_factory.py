"""Optimizer and learning-rate schedule factory on torch.optim (port of
emap_tpu/utils/optim_factory.py, which builds them on optax).

The pipeline builds its masked Adam itself (train/optim.py); these helpers
are the conf-driven factory the reference offers for experiments. A
schedule here is a function of the update count with the optax version's
values; `scheduled` hands it to a torch optimizer, so that update k uses
schedule(k) as optax's does.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], float]


def _steplr(base_lr: float, decay_step: int, decay_gamma: float) -> Schedule:
    """optax.exponential_decay(base_lr, decay_step, decay_gamma,
    staircase=True)."""
    if decay_gamma == 0:
        return lambda count: base_lr

    def schedule(count):
        if count <= 0:
            return base_lr
        return base_lr * decay_gamma ** math.floor(count / decay_step)

    return schedule


def _cosine(base_lr: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule(base_lr, decay_steps, alpha)."""
    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _poly(init: float, end: float, power: float, steps: int) -> Schedule:
    """optax.polynomial_schedule(init, end, power, steps)."""
    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end

    return schedule


def get_scheduler(scheduler_type: str, base_lr: float, num_steps: int, *,
                  decay_step: int = 0, decay_gamma: float = 0.1,
                  lr_min: float = 0.0, poly_exp: float = 0.9,
                  warmup_steps: int = 0,
                  warmup_multiplier: float = 1.0) -> Schedule:
    """Step, cosine and poly schedules with an optional gradual warm-up (the
    reference's GradualWarmupScheduler: a linear ramp from
    base_lr / multiplier to base_lr over warmup_steps): a function of the
    update count with the JAX package's values."""
    if scheduler_type == "steplr":
        main = _steplr(base_lr, max(decay_step, 1), decay_gamma)
    elif scheduler_type == "cosine":
        main = _cosine(base_lr, max(num_steps - warmup_steps, 1),
                       lr_min / base_lr if base_lr else 0.0)
    elif scheduler_type == "poly":
        main = _poly(base_lr, lr_min, poly_exp,
                     max(num_steps - warmup_steps, 1))
    else:
        raise ValueError(f"unknown scheduler {scheduler_type!r}")
    if warmup_steps <= 0:
        return main
    warmup = _poly(base_lr / max(warmup_multiplier, 1e-8), base_lr, 1,
                   warmup_steps)

    def schedule(count):
        return warmup(count) if count < warmup_steps else main(
            count - warmup_steps)

    return schedule


def get_optimizer(optimizer_type: str, params, learning_rate: float, *,
                  momentum: float = 0.9, weight_decay: float = 0.0,
                  eps: float = 1e-8) -> torch.optim.Optimizer:
    """sgd / adam / adamw / radam over `params` (the reference's "ranger"
    has no counterpart in either package; radam is the nearest of its
    family). weight_decay adds weight_decay * p to the gradient before the
    update, as the optax version chains add_decayed_weights in front,
    except for adamw, which decouples it."""
    if optimizer_type == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                               weight_decay=weight_decay)
    if optimizer_type == "adam":
        return torch.optim.Adam(params, lr=learning_rate, eps=eps,
                                weight_decay=weight_decay)
    if optimizer_type == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, eps=eps,
                                 weight_decay=weight_decay)
    if optimizer_type in ("radam", "ranger"):
        return torch.optim.RAdam(params, lr=learning_rate, eps=eps,
                                 weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {optimizer_type!r}")


def scheduled(optimizer: torch.optim.Optimizer,
              schedule: Schedule) -> torch.optim.lr_scheduler.LambdaLR:
    """Drive `optimizer`'s learning rate by `schedule`: call the returned
    scheduler's step() after each optimizer step, and update k runs at
    schedule(k), as optax runs a schedule."""
    for group in optimizer.param_groups:
        group["lr"] = 1.0
        group.pop("initial_lr", None)
    return torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)
