"""Visual self-supervision auxiliary losses: SimSiam and SimCLR over two
augmented views of the volume.

Port of ct_clip_tpu/models/visual_ssl.py (reference CT_CLIP/ct_clip/
visual_ssl.py).  The tap, the image-tower layer whose output the heads read,
is the `encode_fn` the caller passes (models/ctclip.py builds it from
`CTCLIPConfig.visual_ssl_tap`); `flatten_tap` turns a token tap into (b*n, d)
rows as the reference's NetWrapper does.

  * `augment_volume`: random H and W flips (one Bernoulli(0.5) each per
    call) and one intensity scale 1 + 0.1 u and shift 0.05 u' per call (u,
    u' uniform on [-1, 1)), the JAX package's 3D mapping of the reference's
    2D torchvision pipeline.  The draws are a (4,) tensor that a generator
    fills by default (`augment_draws`); a test hands the JAX package's draws
    in instead.  The arithmetic is f32, as JAX promotes the bf16 volume.
  * `_BatchNorm`: torch BatchNorm1d in training mode (batch statistics,
    biased variance, eps 1e-5), in f32, without running statistics: the SSL
    loss only runs in training.
  * `SimSiamMLP` (projector: Linear(no bias) -> BN -> ReLU twice, then
    Linear(no bias) -> BN(affine=False)) and `MLP` (predictor: Linear -> BN
    -> ReLU -> Linear), as the reference's nn.Sequential, so the state-dict
    keys are the reference's indices (`net.projector.0.weight`,
    `online_predictor.3.bias`, ...).
  * `simsiam_loss` (2 - 2 cos with stop-gradient targets, both directions,
    batch mean) and `nt_xent_loss` (SimCLR, 2N-way softmax with the self
    similarity masked).

The heads compute in f32: the JAX package's nn.Dense promotes the bf16 tap
to its f32 kernel.  Their products are plain `nn.Linear` (the JAX package
left them to XLA); TF32 stays off, as everywhere in the port.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norms import l2norm


def augment_draws(generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(4,) f32 on the CPU: flip H, flip W (1.0 or 0.0, each with
    probability 0.5), then u_scale and u_shift uniform on [-1, 1)."""
    u = torch.rand(4, generator=generator)
    return torch.cat([(u[:2] < 0.5).float(), 2.0 * u[2:] - 1.0])


def augment_volume(video: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """(b, f, H, W, c) -> the augmented view in f32: flips of H and W, then
    video * (1 + 0.1 u_scale) + 0.05 u_shift (`augment_draws`)."""
    flip_h, flip_w = (bool(v) for v in draws[:2].tolist())
    u = draws[2:].detach().to("cpu", torch.float32)
    scale, shift = 1.0 + 0.1 * u[0], 0.05 * u[1]
    if flip_h:
        video = video.flip(2)
    if flip_w:
        video = video.flip(3)
    out = video.to(torch.float32, copy=True)
    return out.mul_(scale.item()).add_(shift.item())


def flatten_tap(x: torch.Tensor) -> torch.Tensor:
    """NetWrapper's `rearrange(representation, '... d -> (...) d')`: token
    taps become (b*n, d) rows."""
    return x.reshape(-1, x.shape[-1])


class _BatchNorm(nn.Module):
    """BatchNorm1d in training mode with no running statistics, in f32."""

    def __init__(self, dim: int, affine: bool = True, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), None, None, self.weight, self.bias, training=True,
                            eps=self.eps)


class SimSiamMLP(nn.Sequential):
    """visual_ssl.py:123-137 (reference indices 0-7)."""

    def __init__(self, dim: int, projection_size: int = 256, hidden: int = 4096,
                 device=None):
        lin = lambda i, o: nn.Linear(i, o, bias=False, device=device)  # noqa: E731
        super().__init__(
            lin(dim, hidden), _BatchNorm(hidden, device=device), nn.ReLU(),
            lin(hidden, hidden), _BatchNorm(hidden, device=device), nn.ReLU(),
            lin(hidden, projection_size),
            _BatchNorm(projection_size, affine=False, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class MLP(nn.Sequential):
    """visual_ssl.py:113-121 (reference indices 0-3)."""

    def __init__(self, dim: int, projection_size: int = 256, hidden: int = 4096,
                 device=None):
        super().__init__(
            nn.Linear(dim, hidden, device=device), _BatchNorm(hidden, device=device),
            nn.ReLU(), nn.Linear(hidden, projection_size, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


def simsiam_loss(p1, z1, p2, z2) -> torch.Tensor:
    """2 - 2 cos(p, stop_grad(z)), both directions summed, batch mean
    (visual_ssl.py:104-108, :237-259)."""
    def d(p, z):
        return 2.0 - 2.0 * (l2norm(p) * l2norm(z.detach())).sum(dim=-1)
    return (d(p1, z2) + d(p2, z1)).mean()


def nt_xent_loss(z1, z2, temperature: float = 0.1) -> torch.Tensor:
    """SimCLR NT-Xent (visual_ssl.py:88-102): a 2N-way softmax over cosine
    similarities with the self similarity masked out."""
    z = l2norm(torch.cat([z1, z2]))
    n = z.shape[0]
    sim = (z @ z.t()) / temperature
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    half = torch.arange(n // 2, device=z.device)
    targets = torch.cat([half + n // 2, half])
    return F.cross_entropy(sim, targets)


class _NetWrapper(nn.Module):
    """Holds the projector under the reference's name (`net.projector`); the
    tower it wraps in the reference is the caller's `encode_fn` here."""

    def __init__(self, projector: nn.Module):
        super().__init__()
        self.projector = projector


class _TwoViews(nn.Module):
    def _embed_views(self, video, encode_fn: Callable, draws):
        """The projector's output of each augmented view, one view at a time
        (the first view's f32 copy is freed before the second is made)."""
        return [self.net.projector(flatten_tap(encode_fn(augment_volume(video, d))))
                for d in draws]

    @staticmethod
    def draws(generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(2, 4): one `augment_draws` per view."""
        return torch.stack([augment_draws(generator), augment_draws(generator)])


class SimSiam(_TwoViews):
    """visual_ssl.py:207-259: projector SimSiamMLP(dim, 256, 4096), predictor
    MLP(256, 256, 4096)."""

    def __init__(self, dim: int, projection_size: int = 256,
                 projection_hidden: int = 4096, device=None):
        super().__init__()
        self.net = _NetWrapper(SimSiamMLP(dim, projection_size, projection_hidden, device))
        self.online_predictor = MLP(projection_size, projection_size, projection_hidden,
                                    device)

    def forward(self, video: torch.Tensor, encode_fn: Callable,
                draws: torch.Tensor) -> torch.Tensor:
        z1, z2 = self._embed_views(video, encode_fn, draws)
        pred = self.online_predictor
        return simsiam_loss(pred(z1), z1, pred(z2), z2)


class SimCLR(_TwoViews):
    """visual_ssl.py:263-299: NetWrapper's SimSiamMLP projector with
    projection size 128, NT-Xent at temperature 0.1."""

    def __init__(self, dim: int, projection_size: int = 128,
                 projection_hidden: int = 4096, temperature: float = 0.1, device=None):
        super().__init__()
        self.temperature = temperature
        self.net = _NetWrapper(SimSiamMLP(dim, projection_size, projection_hidden, device))

    def forward(self, video: torch.Tensor, encode_fn: Callable,
                draws: torch.Tensor) -> torch.Tensor:
        z1, z2 = self._embed_views(video, encode_fn, draws)
        return nt_xent_loss(z1, z2, self.temperature)
