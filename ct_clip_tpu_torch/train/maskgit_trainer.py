"""The MaskGIT transformer trainer, the generative stack's second stage.

Port of ct_clip_tpu/train/maskgit_trainer.py (transformer_maskgit/
train_transformer.py:93-352): the frozen CTViT turns volumes into code ids
(`encode_ids`), each `train_step` takes the masked-token cross entropy of
the MaskGit and one optimizer step, then, with a `TokenCritic`, the
critic's BCE on tokens resampled from the MaskGit's detached logits and the
critic's own optimizer step; AdamW with the decay mask and the global-norm
clip first, on the fixed-cycle cosine-annealing-warmup-restarts schedule;
`.pt` checkpoints every `save_model_every` steps through
train/checkpoint.py (the JAX package writes Orbax); `sample` decodes
sampled ids with the frozen CTViT.

Each step's draws come from a generator seeded with (seed, step) on the
MaskGit's device (`jax.random.fold_in(PRNGKey(seed), step)` in the JAX
package); `train_step(draws=...)` takes them as tensors instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..models.ctvit import CTViT
from ..models.maskgit import (MaskGit, TokenCritic, critic_train_loss, maskgit_train_loss,
                              sample_tokens)
from .checkpoint import CheckpointManager
from .optimizer import Optimizer, cawr_schedule, get_optimizer


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The draws of training step `step`: a generator on `device` seeded
    with (seed, step)."""
    return torch.Generator(device=device).manual_seed(seed * 2 ** 32 + step)


@dataclass
class MaskGitTrainState:
    """The MaskGit and its optimizer, the critic and its optimizer when on,
    and the step count."""
    maskgit: MaskGit
    optimizer: Optimizer
    critic: Optional[TokenCritic] = None
    critic_optimizer: Optional[Optimizer] = None
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.maskgit.to_logits.weight.device

    def state_dict(self) -> Dict:
        sd = {"maskgit": self.maskgit.state_dict(), "optimizer": self.optimizer.state_dict()}
        if self.critic is not None:
            sd.update(critic=self.critic.state_dict(),
                      critic_optimizer=self.critic_optimizer.state_dict())
        return sd

    def load_state_dict(self, sd: Dict) -> None:
        self.maskgit.load_state_dict(sd["maskgit"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.critic is not None:
            self.critic.load_state_dict(sd["critic"], strict=True)
            self.critic_optimizer.load_state_dict(sd["critic_optimizer"])


class MaskGitTrainer:
    """Trains a MaskGit (and optionally a TokenCritic), both initialised or
    loaded by the caller, on the code ids of a frozen CTViT."""

    def __init__(self, maskgit: MaskGit, ctvit: CTViT, critic: Optional[TokenCritic] = None,
                 *, lr: float = 3e-4, wd: float = 0.01, max_grad_norm: Optional[float] = 0.5,
                 cond_drop_prob: float = 0.25, steps_schedule: int = 18,
                 first_cycle_steps: int = 10000, warmup_steps: int = 500,
                 results_folder: str = "./results_maskgit", save_model_every: int = 2000,
                 seed: int = 42):
        self.ctvit = ctvit.eval().requires_grad_(False)
        self.cond_drop_prob, self.steps_schedule = cond_drop_prob, steps_schedule
        self.save_model_every, self.seed = save_model_every, seed
        self.schedule = cawr_schedule(first_cycle_steps, max_lr=lr, min_lr=lr * 1e-2,
                                      warmup_steps=warmup_steps)

        def opt(module):
            return get_optimizer(module.parameters(), lr=lr, wd=wd,
                                 max_grad_norm=max_grad_norm, schedule=self.schedule)

        self.state = MaskGitTrainState(maskgit, opt(maskgit), critic,
                                       None if critic is None else opt(critic))
        self.results = Path(results_folder)
        self.results.mkdir(parents=True, exist_ok=True)
        self.ckpt = CheckpointManager(str(self.results / "checkpoints"))

    @torch.no_grad()
    def encode_ids(self, video: torch.Tensor) -> torch.Tensor:
        """Frozen CTViT: (b, f, H, W, 1) volumes -> (b, t, h, w) code ids."""
        return self.ctvit(video, return_only_codebook_ids=True)

    def train_step(self, codebook_ids: torch.Tensor, grid: Tuple[int, int, int],
                   context: Optional[torch.Tensor] = None,
                   draws: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
                   ) -> Dict[str, float]:
        """One step on (b, t, h, w) or (b, N) code ids and an optional (b, m,
        t5_dim) text context.  `draws` {"maskgit": maskgit_train_loss's,
        "critic": critic_train_loss's} replaces the step generator's."""
        s = self.state
        gen = step_generator(self.seed, s.step, s.device)
        flat = codebook_ids.reshape(codebook_ids.shape[0], -1).to(s.device)
        s.optimizer.zero_grad()
        loss, (_, mask, logits) = maskgit_train_loss(
            s.maskgit, flat, grid, context=context, cond_drop_prob=self.cond_drop_prob,
            steps=self.steps_schedule, generator=gen,
            draws=None if draws is None else draws["maskgit"])
        loss.backward()
        s.optimizer.step()
        closs = torch.zeros((), device=s.device)
        if s.critic is not None:
            s.critic_optimizer.zero_grad()
            closs = critic_train_loss(s.critic, flat, logits.detach(), mask, grid,
                                      context=context, generator=gen,
                                      draws=None if draws is None else draws["critic"])
            closs.backward()
            s.critic_optimizer.step()
        s.step += 1
        if s.step % self.save_model_every == 0:
            self.ckpt.save(s.step, s)
        return {"loss": loss.item(), "critic_loss": closs.item(),
                "lr": float(self.schedule(s.step - 1))}

    @torch.no_grad()
    def sample(self, grid: Tuple[int, int, int], batch_size: int = 1,
               context: Optional[torch.Tensor] = None, steps: int = 18,
               cond_scale: float = 3.0, generator: Optional[torch.Generator] = None,
               draws=None) -> torch.Tensor:
        """Periodic evaluation sampling (train_transformer.py:306): sampled
        ids decoded by the frozen CTViT, (b, f, H, W, 1)."""
        s = self.state
        if generator is None:
            generator = torch.Generator(device=s.device).manual_seed(0)
        ids = sample_tokens(s.maskgit, grid, batch_size=batch_size, context=context,
                            steps=steps, cond_scale=cond_scale, critic=s.critic,
                            generator=generator, draws=draws)
        return self.ctvit.decode_from_codebook_indices(ids, grid)
