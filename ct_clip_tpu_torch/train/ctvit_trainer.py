"""The CTViT autoencoder trainer (VQGAN-style), first stage of the generative
stack.

Port of ct_clip_tpu/train/ctvit_trainer.py (transformer_maskgit/
ctvit_trainer.py:109-425): a generator step (reconstruction MSE + the VQ
commitment loss, plus `discr_weight` x the hinge generator loss when the
discriminator is on), `generator_steps` generator steps per discriminator
step, an EMA copy of the autoencoder's parameters updated every
`ema_update_every` steps, checkpoints every `save_model_every` steps
(`step_{n}.pt` through train/checkpoint.py, where the JAX package writes
Orbax) and reconstruction NIfTI dumps with the EMA weights every
`save_results_every` steps.  The reference's discriminator and VGG modules
are never constructed (SURVEY.md §2.2); as in the JAX package the
reconstruction objective is primary and `Discriminator3D`, a small 3D conv
patch discriminator with hinge losses, is optional.

The discriminator is a convolution stack in XLA in the JAX package, so here
it is `F.conv3d` (cuDNN on the card), in f32 as flax promotes its bf16 input
to its f32 parameters.  flax pads 'SAME': with kernel 4 and stride 2 that is
(1, 2) on an odd extent and (1, 1) on an even one, not torch's symmetric
padding, so the pads are explicit (`same_pads`).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.nifti import write_volume
from ..models.ctvit import CTViT, init_param_
from .checkpoint import CheckpointManager
from .optimizer import Optimizer, get_optimizer


def same_pads(extents, kernel: int, stride: int) -> List[int]:
    """flax/XLA 'SAME' padding of `extents` (d, h, w) as an F.pad list
    (w0, w1, h0, h1, d0, d1): out = ceil(n / stride), the total pad split
    with its smaller half first."""
    pads = []
    for n in reversed(extents):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return pads


class Discriminator3D(nn.Module):
    """`layers` Conv3d (kernel 4, stride 2, 'SAME') + leaky ReLU 0.1, widths
    base_dim doubling up to 256, then a 1x1x1 conv to one logit per
    position.  Takes and returns channels-last (b, f, H, W, c) tensors, as
    the JAX module does; module names are the JAX module's (conv_{i},
    to_logit)."""

    def __init__(self, base_dim: int = 16, layers: int = 4, channels: int = 1,
                 device=None):
        super().__init__()
        self.layers = layers
        dim_in, dim = channels, base_dim
        for i in range(layers):
            self.add_module(f"conv_{i}", nn.Conv3d(dim_in, dim, 4, stride=2, device=device))
            dim_in, dim = dim, min(dim * 2, 256)
        self.to_logit = nn.Conv3d(dim_in, 1, 1, device=device)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = video.float().permute(0, 4, 1, 2, 3)
        for i in range(self.layers):
            conv = getattr(self, f"conv_{i}")
            x = F.conv3d(F.pad(x, same_pads(x.shape[2:], 4, 2)), conv.weight, conv.bias,
                         stride=2)
            x = F.leaky_relu(x, 0.1)
        return self.to_logit(x).permute(0, 2, 3, 4, 1)


def hinge_discr_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """ctvit.py:88-89."""
    return (F.relu(1.0 + fake) + F.relu(1.0 - real)).mean()


def hinge_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    """ctvit.py:91-92."""
    return -fake.mean()


@torch.no_grad()
def ema_update(ema: Iterable[torch.Tensor], params: Iterable[torch.Tensor],
               decay: float = 0.995) -> None:
    """e = e * decay + p * (1 - decay), in place (ema_pytorch, ctvit_trainer.py:
    144-145, 355-356)."""
    ema, params = list(ema), [p.detach() for p in params]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)


@dataclass
class CTViTTrainState:
    """The autoencoder, its optimizer, the EMA copy of it (`ema_model`,
    whose parameters are the EMA), the discriminator and its optimizer when
    on, and the step count."""
    model: CTViT
    optimizer: Optimizer
    ema_model: CTViT
    discr: Optional[Discriminator3D] = None
    discr_optimizer: Optional[Optimizer] = None
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> Dict:
        sd = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
              "ema_model": self.ema_model.state_dict()}
        if self.discr is not None:
            sd.update(discr=self.discr.state_dict(),
                      discr_optimizer=self.discr_optimizer.state_dict())
        return sd

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.ema_model.load_state_dict(sd["ema_model"], strict=True)
        if self.discr is not None:
            self.discr.load_state_dict(sd["discr"], strict=True)
            self.discr_optimizer.load_state_dict(sd["discr_optimizer"])


class CTViTTrainer:
    """Trains a CTViT built with `with_decoder=True` (initialised or loaded
    by the caller) on batches of (b, f, H, W, 1) volumes on its device."""

    def __init__(self, model: CTViT, *, lr: float = 3e-4, wd: float = 0.0,
                 max_grad_norm: Optional[float] = 0.5, ema_decay: float = 0.995,
                 ema_update_every: int = 10, generator_steps: int = 3,
                 use_discr: bool = False, discr_weight: float = 0.1,
                 results_folder: str = "./results_ctvit", save_model_every: int = 2000,
                 save_results_every: int = 500, seed: int = 42):
        if not model.config.with_decoder:
            raise ValueError("CTViTTrainer needs CTViTConfig(with_decoder=True)")
        self.ema_decay, self.ema_update_every = ema_decay, ema_update_every
        self.generator_steps, self.discr_weight = generator_steps, discr_weight
        self.save_model_every, self.save_results_every = save_model_every, save_results_every
        opt = lambda params: get_optimizer(params, lr=lr, wd=wd,  # noqa: E731
                                           max_grad_norm=max_grad_norm)
        ema_model = copy.deepcopy(model).requires_grad_(False)
        discr = discr_opt = None
        if use_discr:
            dev = next(model.parameters()).device
            discr = Discriminator3D(channels=model.config.channels, device=dev)
            gen = torch.Generator(device=dev).manual_seed(seed + 1)
            for name, t in discr.named_parameters():
                init_param_(name, t, gen)
            discr_opt = opt(discr.parameters())
        self.state = CTViTTrainState(model, opt(model.parameters()), ema_model, discr,
                                     discr_opt)
        self.results = Path(results_folder)
        self.results.mkdir(parents=True, exist_ok=True)
        self.ckpt = CheckpointManager(str(self.results / "checkpoints"))

    def generator_loss(self, video: torch.Tensor):
        """(loss, reconstruction loss, commitment loss) of the autoencoder's
        training forward on `video` (gen_loss_fn, ctvit_trainer.py:101-111):
        the VQ in training mode (its codebook moves by EMA), the
        discriminator's hinge term when it is on (its weights take no
        gradient here)."""
        s = self.state
        recon, _, commit = s.model(video, train=True, return_recons=True)
        recon_loss = ((recon.float() - video.float()) ** 2).mean()
        loss = recon_loss + commit
        if s.discr is not None:
            s.discr.requires_grad_(False)
            try:
                loss = loss + self.discr_weight * hinge_gen_loss(s.discr(recon))
            finally:
                s.discr.requires_grad_(True)
        return loss, recon_loss, commit

    def _gen_step(self, video: torch.Tensor):
        s = self.state
        s.optimizer.zero_grad()
        loss, recon_loss, commit = self.generator_loss(video)
        loss.backward()
        s.optimizer.step()
        return loss.detach(), recon_loss.detach(), commit.detach()

    def _discr_step(self, video: torch.Tensor) -> torch.Tensor:
        """One discriminator update against the autoencoder's inference
        reconstruction (discr_loss_fn, ctvit_trainer.py:123-130)."""
        s = self.state
        with torch.no_grad():
            recon = s.model(video, return_recons=True)[0]
        s.discr_optimizer.zero_grad()
        loss = hinge_discr_loss(s.discr(recon), s.discr(video))
        loss.backward()
        s.discr_optimizer.step()
        return loss.detach()

    def train_step(self, video: torch.Tensor) -> Dict[str, float]:
        s = self.state
        for _ in range(self.generator_steps if s.discr is not None else 1):
            loss, recon_loss, commit = self._gen_step(video)
        logs = dict(loss=loss.item(), recon_loss=recon_loss.item(),
                    commit_loss=commit.item())
        if s.discr is not None:
            logs["discr_loss"] = self._discr_step(video).item()
        s.step += 1
        if s.step % self.ema_update_every == 0:
            ema_update(s.ema_model.parameters(), s.model.parameters(), self.ema_decay)
        if s.step % self.save_model_every == 0:
            self.ckpt.save(s.step, s)
        return logs

    def train(self, batches: Iterator[torch.Tensor], num_steps: int,
              log_fn: Optional[Callable] = None) -> CTViTTrainState:
        for video in batches:
            if self.state.step >= num_steps:
                break
            logs = self.train_step(video)
            if log_fn:
                log_fn(self.state.step, logs)
            if self.state.step % self.save_results_every == 0:
                self.dump_reconstruction(video)
        return self.state

    @torch.no_grad()
    def dump_reconstruction(self, video: torch.Tensor) -> Path:
        """The first volume's reconstruction with the EMA weights and the
        current codebook (ctvit_trainer.py:360-398), as
        `recon_step{n}.nii.gz`."""
        s = self.state
        s.ema_model.vq.load_state_dict(s.model.vq.state_dict())
        recon = s.ema_model(video[:1], return_recons=True)[0]
        path = self.results / f"recon_step{s.step}.nii.gz"
        write_volume(path, recon[0, ..., 0].float().cpu().numpy().transpose(1, 2, 0))
        return path


def group_by_frame_count(items, key: Callable, batch_size: int):
    """CustomBatchSampler (ctvit_trainer.py:58-105): batches of indices whose
    volumes share a frame-count bucket."""
    buckets: Dict[int, list] = {}
    for i, item in enumerate(items):
        buckets.setdefault(key(item), []).append(i)
    for _, idxs in sorted(buckets.items()):
        for j in range(0, len(idxs), batch_size):
            yield idxs[j: j + batch_size]


@torch.no_grad()
def reconstruct_dataset(model: CTViT, dataset, results_folder: str,
                        max_items: Optional[int] = None) -> List[str]:
    """CTVIT_inf (transformer_maskgit/ctvit_inference.py:273-308): every
    volume of `dataset` ((f, H, W) float arrays, e.g. data.generatect.
    VideoDataset) through encode -> VQ -> decode on the model's device, each
    reconstruction written as `recon_{i:05d}.nii.gz` in (H, W, f) order."""
    out = Path(results_folder)
    out.mkdir(parents=True, exist_ok=True)
    dev = next(model.parameters()).device
    written = []
    for i in range(len(dataset)):
        if max_items is not None and i >= max_items:
            break
        video = torch.from_numpy(np.asarray(dataset[i], np.float32))[None, ..., None]
        recon = model(video.to(dev), return_recons=True)[0]
        path = out / f"recon_{i:05d}.nii.gz"
        write_volume(path, recon[0, ..., 0].float().cpu().numpy().transpose(1, 2, 0))
        written.append(str(path))
    return written
