"""The CT-CLIP pretraining step.

Port of ct_clip_tpu/train/train_step.py (`TrainState`, `make_train_step`):
the reference hot path of scripts/CTCLIPTrainer.py:233-263 (forward with
return_loss, backward, global-norm clip 0.5, Adam step).  Parameters are f32
and the towers compute in the model's dtype (bf16 in training, as the JAX
package replaces torch autocast).  The state is the model itself (its
parameters and the VQ codebook buffers, which the forward updates by EMA),
the optimizer and the step count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..config import TrainConfig
from ..models.ctclip import CTCLIP
from .optimizer import Optimizer, get_optimizer


@dataclass
class TrainState:
    model: CTCLIP
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: CTCLIP, cfg: TrainConfig) -> TrainState:
    """The model as it is (initialised or loaded) with a fresh optimizer."""
    opt = get_optimizer(model.parameters(), lr=cfg.lr, wd=cfg.wd,
                        max_grad_norm=cfg.max_grad_norm)
    return TrainState(model=model, optimizer=opt)


def make_train_step(cfg: TrainConfig) -> Callable:
    """step(state, batch, generator) -> metrics {loss, grad_norm,
    temperature} as 0-dim tensors on the model's device (no host sync).
    `batch` holds input_ids, attention_mask and video (volumes or patch
    rows); `generator` feeds the text tower's dropout."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad()
        loss = model(batch["input_ids"], batch["attention_mask"], batch["video"],
                     return_loss=True, train=True, generator=generator)
        loss.backward()
        grad_norm = opt.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "temperature": model.temperature.detach().clone()}

    return step
