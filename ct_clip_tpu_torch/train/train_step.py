"""The CT-CLIP pretraining step.

Port of ct_clip_tpu/train/train_step.py (`TrainState`, `make_train_step`):
the reference hot path of scripts/CTCLIPTrainer.py:233-263 (forward with
return_loss, backward, global-norm clip 0.5, Adam step).  Parameters are f32
and the towers compute in the model's dtype (bf16 in training, as the JAX
package replaces torch autocast).  The state is the model itself (its
parameters and the VQ codebook buffers, which the forward updates by EMA),
the optimizer and the step count.

The JAX step draws three random streams from its key: dropout, mlm =
fold_in(rng, 1) and ssl = fold_in(rng, 2) (train_step.py:53-60).  The port
draws them from three generators seeded from the step's seed
(`step_generators`): the dropout stream on the model's device, the MLM mask
and the augmentation draws, which are a few host values per step, on the
CPU, so a card step and a CPU step from the same seed mask and augment
alike.
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

    @property
    def device(self) -> torch.device:
        return self.model.temperature.device

    def state_dict(self) -> Dict:
        """What a checkpoint holds besides the step (train/checkpoint.py)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])


def create_train_state(model: CTCLIP, cfg: TrainConfig) -> TrainState:
    """The model as it is (initialised or loaded) with a fresh optimizer."""
    opt = get_optimizer(model.parameters(), lr=cfg.lr, wd=cfg.wd,
                        max_grad_norm=cfg.max_grad_norm)
    return TrainState(model=model, optimizer=opt)


def step_generators(seed: int, device) -> Dict[str, torch.Generator]:
    """The step's three random streams: "dropout" on `device`, "mlm" and
    "ssl" on the CPU, from the seeds 3 seed, 3 seed + 1 and 3 seed + 2 (the
    CPU generator reads a seed's low 32 bits, so the streams of nearby steps
    must differ there)."""
    seeds = [(3 * seed + i) % 2 ** 63 for i in range(3)]
    return {"dropout": torch.Generator(device=device).manual_seed(seeds[0]),
            "mlm": torch.Generator().manual_seed(seeds[1]),
            "ssl": torch.Generator().manual_seed(seeds[2])}


def make_train_step(cfg: TrainConfig) -> Callable:
    """step(state, batch, generators) -> metrics {loss, grad_norm,
    temperature} as 0-dim tensors on the model's device (no host sync).
    `batch` holds input_ids, attention_mask and video (volumes or patch
    rows); `generators` are the step's random streams (`step_generators`),
    needed when the text tower's dropout, MLM or visual SSL is on."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generators: Optional[Dict[str, torch.Generator]] = None
             ) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        gens = generators or {}
        model.train()
        opt.zero_grad()
        loss = model(batch["input_ids"], batch["attention_mask"], batch["video"],
                     return_loss=True, train=True, generator=gens.get("dropout"),
                     mlm_generator=gens.get("mlm"), ssl_generator=gens.get("ssl"))
        loss.backward()
        grad_norm = opt.step()
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "temperature": model.temperature.detach().clone()}

    return step
