"""Optimizers and LR schedules (port of ct_clip_tpu/train/optimizer.py; the
JAX package's optax chains become torch.optim optimizers plus an explicit
global-norm clip).

  * `get_optimizer` (transformer_maskgit/optimizer.py:10-34): Adam when wd is
    0, else AdamW with decay only on parameters of ndim >= 2; betas (0.9,
    0.99), eps 1e-8, and optax's clip_by_global_norm ahead of it
    (`clip_by_global_norm_`);
  * `cosine_lr_schedule` (scripts/src/models/utils.py:19-32);
  * `cosine_annealing_warmup_restarts` (text_classifier/
    cosine_annealing_warmup.py:5-87).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch


class Optimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam|adamw(lr)) as a
    torch optimizer: `step(params)` clips the gradients in place, takes the
    optimizer step at the scheduled lr and returns the pre-clip global norm.
    A parameter without a gradient gets a zero one, as optax updates every
    leaf: its moments stay 0 and it does not move."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, wd: float = 0.0,
                 betas=(0.9, 0.99), eps: float = 1e-8,
                 max_grad_norm: Optional[float] = None,
                 schedule: Optional[Callable[[int], float]] = None):
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule if schedule is not None else (lambda step: lr)
        if wd == 0.0:
            self.opt = torch.optim.Adam(self.params, lr=lr, betas=betas, eps=eps)
        else:
            groups = [{"params": [p for p in self.params if p.dim() >= 2],
                       "weight_decay": wd},
                      {"params": [p for p in self.params if p.dim() < 2],
                       "weight_decay": 0.0}]
            self.opt = torch.optim.AdamW([g for g in groups if g["params"]], lr=lr,
                                         betas=betas, eps=eps)
        self.count = 0

    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = clip_by_global_norm_(grads, self.max_grad_norm)
        lr = float(self.schedule(self.count))
        for g in self.opt.param_groups:
            g["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self):
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, sd) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.count = int(sd["count"])


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in f32 (optax.global_norm)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm_(grads, max_norm: Optional[float]) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g / norm * max_norm only when
    norm > max_norm (torch's clip_grad_norm_ divides by norm + 1e-6 instead).
    Returns the norm before clipping; no host sync."""
    norm = global_norm(grads)
    if max_norm is not None:
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def get_optimizer(params, lr: float, wd: float = 0.0, betas=(0.9, 0.99),
                  eps: float = 1e-8, max_grad_norm: Optional[float] = None,
                  schedule=None) -> Optimizer:
    return Optimizer(params, lr, wd, betas, eps, max_grad_norm, schedule)


def cosine_lr_schedule(base_lr: float, warmup_length: int, steps: int):
    """scripts/src/models/utils.py:19-32: lr = base*(step+1)/warmup during
    warmup, then base * 0.5*(1+cos(pi*e/es)) with e = step-warmup."""

    def schedule(step):
        if step < warmup_length:
            return base_lr * (step + 1.0) / max(warmup_length, 1)
        e, es = step - warmup_length, max(steps - warmup_length, 1)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * e / es))

    return schedule


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
