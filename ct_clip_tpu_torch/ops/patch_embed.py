"""Patch embedding: patchify -> LN(patch_dim) -> projection + bias -> LN(dim).

Port of ct_clip_tpu/ops/pallas/patchify.py::fused_patch_embed (K8) and its
plain twin `_xla_patch_embed`.  The reference chain is CTViT's to_patch_emb
(transformer_maskgit/ctvit.py:170-175): Rearrange to '(c pt p1 p2)' patch
rows, LayerNorm(4000), Linear(4000, 512), LayerNorm(512).

On a CUDA tensor the chain runs as three hand-written launches: the patch
gather fused with LN(4000) (csrc/layernorm.cu), the 4000x512 product with the
bias epilogue (csrc/gemm.cu) and LN(512).  The (tokens, 4000) normalised
patches pass through device memory between the first two.
"""
from __future__ import annotations

import torch

from . import kernels as K
from .norms import layer_norm


def patchify(video: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    """(b, F, H, W) -> (b, t*h*w, pt*p*p) patch rows in (pt, p1, p2) order."""
    b, F, H, W = video.shape
    t, h, w = F // pt, H // p, W // p
    x = video.reshape(b, t, pt, h, p, w, p).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(b, t * h * w, pt * p * p)


def patch_embed_plain(video, s1, b1, w, pbias, s2, b2, pt: int, p: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version.  `w` is the Linear weight (dim, patch_dim).
    Rounding points follow `_xla_patch_embed`: the product rounds to the
    video dtype before the bias add."""
    dtype = video.dtype
    x = layer_norm(patchify(video, pt, p), s1, b1, eps)
    y = x @ w.to(dtype).t()
    return layer_norm(y + pbias.to(dtype), s2, b2, eps)


def _patch_embed_cuda(video, s1, b1, w, pbias, s2, b2, pt, p, eps):
    b, F, H, W = video.shape
    n, pd, dim = (F // pt) * (H // p) * (W // p), pt * p * p, w.shape[0]
    bf = torch.bfloat16
    if w.shape[1] != pd:
        raise ValueError(f"patch weight {tuple(w.shape)} != (dim, {pd})")
    xn = torch.empty((b * n, pd), dtype=bf, device=video.device)
    K.patch_layernorm(video, pt, p, s1, b1, eps, xn)
    y = torch.empty((b * n, dim), dtype=bf, device=video.device)
    K.gemm(K.EPI_BIAS_ROUNDED, xn, w.to(bf).contiguous(), y,
           bias=pbias.to(bf).contiguous())
    out = torch.empty_like(y)
    K.layernorm(y, s2, b2, eps, out)
    K.count_launch("patch_embed")
    return out.view(b, n, dim)


def fused_patch_embed(video: torch.Tensor, s1, b1, w, pbias, s2, b2,
                      pt: int, p: int, eps: float = 1e-5) -> torch.Tensor:
    """(b, F, H, W) single-channel video -> (b, t*h*w, dim) tokens in the
    video's dtype.  A CPU tensor takes the plain version; a CUDA tensor
    must be bf16 and takes the kernels."""
    if video.device.type == "cpu":
        return patch_embed_plain(video, s1, b1, w, pbias, s2, b2, pt, p, eps)
    return _patch_embed_cuda(video.contiguous(), s1, b1, w, pbias, s2, b2,
                             pt, p, eps)
