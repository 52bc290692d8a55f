"""LR schedules (port of ct_clip_tpu/train/optimizer.py; the JAX package's
optax optimizers become torch.optim in the trainers)."""
from __future__ import annotations

import math


def cosine_annealing_warmup_restarts(
        first_cycle_steps: int, cycle_mult: float = 1.0, max_lr: float = 0.1,
        min_lr: float = 0.001, warmup_steps: int = 0, gamma: float = 1.0):
    """CosineAnnealingWarmupRestarts as a step -> lr function
    (text_classifier/cosine_annealing_warmup.py:5-87), computed on the host
    with Python ints so the restart logic is exact."""

    def schedule(step):
        step = int(step)
        cycle, cycle_steps, cycle_start = 0, first_cycle_steps, 0
        while step >= cycle_start + cycle_steps:
            cycle_start += cycle_steps
            cycle += 1
            cycle_steps = int(round(cycle_steps * cycle_mult)) if cycle_mult != 1.0 \
                else first_cycle_steps
        in_cycle = step - cycle_start
        cur_max = max_lr * (gamma ** cycle)
        if in_cycle < warmup_steps:
            return (cur_max - min_lr) * in_cycle / max(warmup_steps, 1) + min_lr
        t = (in_cycle - warmup_steps) / max(cycle_steps - warmup_steps, 1)
        return min_lr + (cur_max - min_lr) * (1 + math.cos(math.pi * t)) / 2

    return schedule
