"""Patch embedding: patchify -> LN(patch_dim) -> projection + bias -> LN(dim).

Port of three TPU kernels of ct_clip_tpu/ops/pallas/patchify.py and their
plain twins.  The reference chain is CTViT's to_patch_emb
(transformer_maskgit/ctvit.py:170-175): Rearrange to '(c pt p1 p2)' patch
rows, LayerNorm(4000), Linear(4000, 512), LayerNorm(512).

  * `fused_patch_embed` (K8) embeds a (b, F, H, W) volume.  On a CUDA tensor
    it runs as three hand-written launches: the patch gather fused with
    LN(4000) (csrc/layernorm.cu), the 4000x512 product with the bias epilogue
    (csrc/gemm.cu) and LN(512).
  * `rearrange_patches` (K6) moves a volume into patch rows, the last stage
    of the patch-row ingest (csrc/rearrange.cu).  It writes into a view the
    caller passes, such as one slot of the batch buffer.
  * `fused_row_embed` (K4) embeds patch rows: LN(4000) of the contiguous
    rows (csrc/layernorm.cu), then the same product and LN(512) as K8.

In both embeds the (tokens, 4000) normalised rows pass through device memory
between the LN and the product.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels as K
from .norms import layer_norm


def patchify(video: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    """(b, F, H, W) -> (b, t*h*w, pt*p*p) patch rows in (pt, p1, p2) order,
    as a strided view."""
    b, F, H, W = video.shape
    t, h, w = F // pt, H // p, W // p
    x = video.reshape(b, t, pt, h, p, w, p).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(b, t * h * w, pt * p * p)


def rearrange_plain(video: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    """Plain PyTorch version of K6: the patchify view made contiguous."""
    return patchify(video, pt, p).contiguous()


def rearrange_patches(video: torch.Tensor, pt: int, p: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, F, H, W) -> (b, t*h*w, pt*p*p) patch rows in (pt, p1, p2) order,
    written into `out` when one is given (its rows contiguous, as in
    `buf[slot:slot + 1]` of a (B, n, patch_dim) batch buffer) and returned.
    The values move untouched.  A CPU tensor takes the plain version; a CUDA
    tensor must be bf16 and takes the kernel."""
    b, F, H, W = video.shape
    if F % pt or H % p or W % p:
        raise ValueError(f"video {tuple(video.shape)} does not tile into "
                         f"{pt}x{p}x{p} patches")
    if video.device.type == "cpu":
        if out is None:
            return rearrange_plain(video, pt, p)
        if out.shape != (b, (F // pt) * (H // p) * (W // p), pt * p * p):
            raise ValueError(f"out {tuple(out.shape)} does not fit the rows")
        return out.copy_(patchify(video, pt, p))
    if out is None:
        out = torch.empty((b, (F // pt) * (H // p) * (W // p), pt * p * p),
                          dtype=video.dtype, device=video.device)
    K.rearrange_patches(video.contiguous(), pt, p, out)
    K.count_launch("rearrange_patches")
    return out


def row_embed_plain(rows: torch.Tensor, s1, b1, w, pbias, s2, b2,
                    eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K4 on (b, n, patch_dim) rows.  `w` is the
    Linear weight (dim, patch_dim).  Rounding points follow
    `row_embed_train` (patchify.py:578-597): the normalised rows and the
    product round to the rows' dtype before the bias add."""
    dtype = rows.dtype
    x = layer_norm(rows, s1, b1, eps)
    y = x @ w.to(dtype).t()
    return layer_norm(y + pbias.to(dtype), s2, b2, eps)


def patch_embed_plain(video, s1, b1, w, pbias, s2, b2, pt: int, p: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K8: the row embed of the patchify view, as
    `_xla_patch_embed` computes it."""
    return row_embed_plain(patchify(video, pt, p), s1, b1, w, pbias, s2, b2, eps)


def _embed_tail(xn, w, pbias, s2, b2, eps, b, n):
    """(b*n, patch_dim) normalised rows -> product + rounded bias -> LN(dim)."""
    dim, bf = w.shape[0], torch.bfloat16
    if w.shape[1] != xn.shape[1]:
        raise ValueError(f"patch weight {tuple(w.shape)} != (dim, {xn.shape[1]})")
    y = torch.empty((b * n, dim), dtype=bf, device=xn.device)
    K.gemm(K.EPI_BIAS_ROUNDED, xn, w.to(bf).contiguous(), y,
           bias=pbias.to(bf).contiguous())
    out = torch.empty_like(y)
    K.layernorm(y, s2, b2, eps, out)
    return out.view(b, n, dim)


def fused_patch_embed(video: torch.Tensor, s1, b1, w, pbias, s2, b2,
                      pt: int, p: int, eps: float = 1e-5) -> torch.Tensor:
    """(b, F, H, W) single-channel video -> (b, t*h*w, dim) tokens in the
    video's dtype.  A CPU tensor takes the plain version; a CUDA tensor
    must be bf16 and takes the kernels."""
    if video.device.type == "cpu":
        return patch_embed_plain(video, s1, b1, w, pbias, s2, b2, pt, p, eps)
    video = video.contiguous()
    b, F, H, W = video.shape
    n = (F // pt) * (H // p) * (W // p)
    xn = torch.empty((b * n, pt * p * p), dtype=torch.bfloat16, device=video.device)
    K.patch_layernorm(video, pt, p, s1, b1, eps, xn)
    out = _embed_tail(xn, w, pbias, s2, b2, eps, b, n)
    K.count_launch("patch_embed")
    return out


def fused_row_embed(rows: torch.Tensor, s1, b1, w, pbias, s2, b2,
                    eps: float = 1e-5) -> torch.Tensor:
    """(b, n, patch_dim) patch rows -> (b, n, dim) tokens in the rows'
    dtype: to_patch_emb minus the Rearrange.  A CPU tensor takes the plain
    version; a CUDA tensor must be bf16 and takes the kernels."""
    if rows.device.type == "cpu":
        return row_embed_plain(rows, s1, b1, w, pbias, s2, b2, eps)
    b, n, pd = rows.shape
    xn = torch.empty((b * n, pd), dtype=torch.bfloat16, device=rows.device)
    K.layernorm(rows.contiguous().view(b * n, pd), s1, b1, eps, xn)
    out = _embed_tail(xn, w, pbias, s2, b2, eps, b, n)
    K.count_launch("row_embed")
    return out
