"""LayerNorm and l2norm as plain tensor functions (ct_clip_tpu/ops/norms.py).

Both compute in f32 and return the input dtype, as the JAX package does.
"""
from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Last-axis LayerNorm with two-pass f32 statistics."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize(t, dim) written as t / sqrt(max(sum t^2, eps^2)): the
    clamp sits before the sqrt, so the gradient stays finite at t == 0
    (exactly-zero rows occur for the -1-padded regions of a volume)."""
    sumsq = (t * t).sum(dim=dim, keepdim=True)
    return t / torch.sqrt(torch.clamp_min(sumsq, eps * eps))
