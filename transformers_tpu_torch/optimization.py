"""Learning-rate schedules, the optimizer factory and gradient clipping of the
port (``transformers_tpu/optimization.py``; reference
src/transformers/optimization.py: ``get_scheduler`` :960,
``TYPE_TO_SCHEDULER_FUNCTION`` :944).

Each schedule is a plain ``step -> lr`` function giving the values of the
JAX package's optax schedules: a linear warm-up over ``max(warmup, 1)``
steps, then the decay evaluated at ``step - warmup`` from step ``warmup`` on
(optax ``join_schedules``; with no warm-up the decay starts at step 0). The
Trainer writes ``schedule(step)`` into the optimizer's groups before each
step, as optax evaluates its schedule at the update count.

AdamW and SGD only; the JAX package's other optimizers raise here.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

ADAMW_NAMES = ("adamw", "adamw_torch", "adamw_torch_fused", "adamw_hf")


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: init to end over ``steps``, then end."""
    return lambda step: init + (end - init) * min(max(step, 0), steps) / steps


def _join(warmup: Callable, boundaries: list, *after: Callable) -> Callable[[int], float]:
    """optax ``join_schedules``: the last schedule whose boundary ``step`` has
    reached, evaluated at ``step - boundary``."""
    def schedule(step):
        value = warmup(step)
        for boundary, fn in zip(boundaries, after):
            if step >= boundary:
                value = fn(step - boundary)
        return value
    return schedule


def _warmup(base_lr: float, num_warmup_steps: int):
    return _linear(0.0, base_lr, max(num_warmup_steps, 1))


def get_linear_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps):
    decay = _linear(base_lr, 0.0, max(num_training_steps - num_warmup_steps, 1))
    return _join(_warmup(base_lr, num_warmup_steps), [num_warmup_steps], decay)


def get_cosine_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps,
                                    num_cycles: float = 0.5, min_lr_rate: float = 0.0):
    def decay(step):
        progress = step / max(1, num_training_steps - num_warmup_steps)
        factor = 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * min(progress, 1.0)))
        factor = factor * (1 - min_lr_rate) + min_lr_rate
        return base_lr * max(factor, 0.0)

    return _join(_warmup(base_lr, num_warmup_steps), [num_warmup_steps], decay)


def get_constant_schedule_with_warmup(base_lr, num_warmup_steps, *_, **__):
    return _join(_warmup(base_lr, num_warmup_steps), [num_warmup_steps], lambda step: base_lr)


def get_constant_schedule(base_lr, *_, **__):
    return lambda step: base_lr


def get_inverse_sqrt_schedule(base_lr, num_warmup_steps, *_, timescale=None, **__):
    timescale = timescale or max(num_warmup_steps, 1)

    def decay(step):
        return base_lr / math.sqrt((step + timescale) / timescale)

    return _join(_warmup(base_lr, num_warmup_steps), [num_warmup_steps], decay)


def get_polynomial_decay_schedule_with_warmup(base_lr, num_warmup_steps, num_training_steps,
                                              lr_end=1e-7, power=1.0):
    def decay(step):
        steps = max(1, num_training_steps - num_warmup_steps)
        remaining = max(1.0 - step / steps, 0.0)
        return (base_lr - lr_end) * remaining ** power + lr_end

    return _join(_warmup(base_lr, num_warmup_steps), [num_warmup_steps], decay)


def get_wsd_schedule(base_lr, num_warmup_steps, num_training_steps, num_decay_steps=None,
                     min_lr_ratio=0.0, **__):
    """warmup-stable-decay (reference optimization.py get_wsd_schedule)."""
    num_decay_steps = num_decay_steps or max(1, int(0.1 * num_training_steps))
    stable = num_training_steps - num_warmup_steps - num_decay_steps

    def decay(step):
        frac = min(step / num_decay_steps, 1.0)
        return base_lr * ((1 - frac) * (1 - min_lr_ratio) + min_lr_ratio)

    return _join(_warmup(base_lr, num_warmup_steps),
                 [num_warmup_steps, num_warmup_steps + max(stable, 0)],
                 lambda step: base_lr, decay)


TYPE_TO_SCHEDULER_FUNCTION = {
    "linear": get_linear_schedule_with_warmup,
    "cosine": get_cosine_schedule_with_warmup,
    "cosine_with_min_lr": get_cosine_schedule_with_warmup,
    "constant": get_constant_schedule,
    "constant_with_warmup": get_constant_schedule_with_warmup,
    "inverse_sqrt": get_inverse_sqrt_schedule,
    "polynomial": get_polynomial_decay_schedule_with_warmup,
    "warmup_stable_decay": get_wsd_schedule,
}


def get_scheduler(name: str, base_lr: float, num_warmup_steps: int = 0,
                  num_training_steps: Optional[int] = None, scheduler_specific_kwargs=None):
    """The ``step -> lr`` function of schedule ``name``."""
    name = str(name).replace("SchedulerType.", "").lower()
    if name not in TYPE_TO_SCHEDULER_FUNCTION:
        raise ValueError(f"Unknown scheduler {name!r}; known: {sorted(TYPE_TO_SCHEDULER_FUNCTION)}")
    fn = TYPE_TO_SCHEDULER_FUNCTION[name]
    return fn(base_lr, num_warmup_steps, num_training_steps, **(scheduler_specific_kwargs or {}))


def create_optimizer(name: str, params, *, learning_rate: float, weight_decay: float = 0.0,
                     adam_beta1: float = 0.9, adam_beta2: float = 0.999,
                     adam_epsilon: float = 1e-8) -> torch.optim.Optimizer:
    """AdamW (weight decay only on parameters of more than one dimension, as
    the JAX Trainer's ``no_decay_mask``) or SGD (no weight decay, as
    ``optax.sgd``) over ``params``. Clipping is ``clip_by_global_norm_``."""
    name = str(name).replace("OptimizerNames.", "").lower()
    params = [p for p in params if p.requires_grad]
    if name in ADAMW_NAMES:
        groups = [{"params": [p for p in params if p.ndim > 1], "weight_decay": weight_decay},
                  {"params": [p for p in params if p.ndim <= 1], "weight_decay": 0.0}]
        return torch.optim.AdamW(groups, lr=learning_rate, betas=(adam_beta1, adam_beta2),
                                 eps=adam_epsilon)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    raise ValueError(f"optimizer {name!r} is not ported; the port has {ADAMW_NAMES + ('sgd',)}")


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: Optional[float]) -> torch.Tensor:
    """The global L2 norm of ``grads`` (f32, on their device, not read back),
    and, when ``max_norm`` is set and the norm exceeds it, every gradient
    scaled in place by ``max_norm / norm`` (``optax.clip_by_global_norm``:
    no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    if max_norm and max_norm > 0:
        factor = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
        for g in grads:
            g.mul_(factor.to(g.dtype))
    return norm
