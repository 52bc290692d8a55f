"""CTViT image tower, encoder path: patch embedding -> spatial transformer over
each 24x24 plane with a continuous position bias -> temporal transformer over
each 24-frame column -> cosine VQ.

Port of ct_clip_tpu/models/ctvit.py (`embed_patches` on the volume and the
patch-row paths, `encode` with the native grid temporal path,
`compute_spatial_bias`, the VQ and `return_encoded_tokens`).  Input is a
channels-last (b, frames, H, W, c) volume, or (b, t*h*w, patch_dim) patch
rows from the ingest (ops/resample.py::preprocess_rows_into), as in the JAX
package.  The temporal stage always runs in the native
(b, t, h*w, d) layout, which needs a cubic token grid (t == h == w, as at
full width); its PEG reproduces the reference's memory reinterpretation
(ctvit.py:299-303) with the rotated kernel.

With `train=True` (the pretraining step) the embedding is the plain autograd
composition LN -> projection -> LN (`row_embed_plain`, the JAX package's
`row_embed_train` and `_xla_patch_embed`: K4 and K8 have no backward on this
path), the CPB bias is computed with its gradient, the sublayers take their
kernels' backwards (K14, K9, K10, K11) and the VQ its training mode (exact
assignment, K15 EMA statistics).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import CTViTConfig
from ..ops.attention import ContinuousPositionBias, MaskgitTransformer
from ..ops.patch_embed import (fused_patch_embed, fused_row_embed, patchify,
                               row_embed_plain)
from ..ops.vq import CosineVQ


class CTViT(nn.Module):
    def __init__(self, config: CTViTConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        if cfg.channels != 1:
            raise ValueError("the port embeds single-channel volumes only")
        pd = cfg.patch_dim
        # indices reproduce the reference Sequential (0 = the Rearrange)
        self.to_patch_emb = nn.Sequential(
            nn.Identity(), nn.LayerNorm(pd, device=device),
            nn.Linear(pd, cfg.dim, device=device),
            nn.LayerNorm(cfg.dim, device=device))
        self.spatial_rel_pos_bias = ContinuousPositionBias(cfg.dim, cfg.heads,
                                                           device=device)
        kw = dict(dim=cfg.dim, dim_head=cfg.dim_head, heads=cfg.heads,
                  device=device)
        self.enc_spatial_transformer = MaskgitTransformer(
            depth=cfg.spatial_depth, **kw)
        self.enc_temporal_transformer = MaskgitTransformer(
            depth=cfg.temporal_depth, **kw)
        self.vq = CosineVQ(cfg.dim, cfg.codebook_size, decay=cfg.vq_decay,
                           device=device)

    def embed_patches(self, video: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(b, f, H, W, 1) volume (K8) or (b, t*h*w, patch_dim) patch rows
        (K4) -> (b, t, h, w, dim) in the compute dtype; train=True takes the
        differentiable plain composition instead."""
        cfg = self.config
        pt, p = cfg.temporal_patch_size, cfg.patch_size
        t, h = cfg.patch_t, cfg.patch_hw
        _, ln1, proj, ln2 = self.to_patch_emb
        weights = (ln1.weight, ln1.bias, proj.weight, proj.bias, ln2.weight,
                   ln2.bias)
        if video.dim() == 3:
            b, n, pd = video.shape
            if (n, pd) != (t * h * h, cfg.patch_dim):
                raise ValueError(f"patch rows {tuple(video.shape)} are not "
                                 f"(b, {t * h * h}, {cfg.patch_dim})")
            embed = row_embed_plain if train else fused_row_embed
            tokens = embed(video.to(self.dtype), *weights, ln1.eps)
            return tokens.reshape(b, t, h, h, cfg.dim)
        b, f, H, W, _ = video.shape
        vol = video[..., 0].to(self.dtype)
        if train:
            tokens = row_embed_plain(patchify(vol, pt, p), *weights, ln1.eps)
        else:
            tokens = fused_patch_embed(vol, *weights, pt, p, ln1.eps)
        return tokens.reshape(b, f // pt, H // p, W // p, cfg.dim)

    def compute_spatial_bias(self) -> torch.Tensor:
        """The (heads, h*w, h*w) f32 CPB table: a function of the weights
        only, so inference computes it once per weight load."""
        hw = self.config.patch_hw
        return self.spatial_rel_pos_bias(hw, hw)

    def encode(self, tokens: torch.Tensor,
               spatial_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, h, w, d = tokens.shape
        if not t == h == w:
            raise ValueError(f"the port's temporal stage needs a cubic token "
                             f"grid, got (t, h, w) = {(t, h, w)}")
        video_shape = (b, t, h, w)
        bias = spatial_bias if spatial_bias is not None \
            else self.spatial_rel_pos_bias(h, w)
        x = self.enc_spatial_transformer(tokens.reshape(b * t, h * w, d),
                                         video_shape, attn_bias=bias)
        x = self.enc_temporal_transformer(x.reshape(b, t, h * w, d),
                                          video_shape, grid_layout=True)
        return x.reshape(b, t, h, w, d)

    def forward(self, video: torch.Tensor,
                spatial_bias: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        """Encoded + quantized tokens (b, t, h, w, d), the production CLIP
        path (return_encoded_tokens=True).  `video` is a volume or patch
        rows (`embed_patches`).  train=True: the training embed and VQ mode
        (module docstring)."""
        cfg = self.config
        if video.dim() != 3 and video.shape[2:4] != (cfg.image_size,
                                                     cfg.image_size):
            raise ValueError(f"video {tuple(video.shape)} does not match "
                             f"image_size {cfg.image_size}")
        tokens = self.encode(self.embed_patches(video, train), spatial_bias)
        quantized, _ = self.vq(tokens, train=train)
        return quantized
