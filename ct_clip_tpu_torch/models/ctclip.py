"""CTCLIP dual tower for inference: BERT text latents and CTViT image latents.

Port of ct_clip_tpu/models/ctclip.py (`encode_text`, `encode_image`,
`temperature`), with the reference state-dict layout of
CT_CLIP/ct_clip/ct_clip.py:587-597:
  text:  BERT last-hidden CLS -> to_text_latent (768 -> 512) -> l2norm;
  image: encoded tokens (b, t, h, w, d) -> mean over t -> flatten
         (294,912 at full width) -> to_visual_latent -> l2norm.
The CLOOB `*_extra` projections exist for the checkpoint layout only.

Parameters are kept in f32 and cast to the compute dtype where used, as the
JAX package does.  `init_weights` draws a seeded random initialisation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CTCLIPConfig
from ..ops.norms import l2norm
from .bert import BertModel
from .ctvit import CTViT


class CTCLIP(nn.Module):
    def __init__(self, config: CTCLIPConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.text_transformer = BertModel(cfg.bert, dtype=dtype, device=device)
        self.visual_transformer = CTViT(cfg.ctvit, dtype=dtype, device=device)
        lin = lambda i: nn.Linear(i, cfg.dim_latent, bias=False, device=device)  # noqa: E731
        self.to_text_latent = lin(cfg.dim_text)
        self.to_visual_latent = lin(cfg.dim_image)
        self.to_text_latent_extra = lin(cfg.dim_text)
        self.to_visual_latent_extra = lin(cfg.dim_image)
        self.temperature = nn.Parameter(torch.tensor(float(cfg.temperature_init),
                                                     device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CTCLIP":
        """Seeded random weights: normal(0, 0.02) embeddings and BERT
        projections, lecun-normal for the rest, unit LN scales and QK
        scales, zero biases, an l2-normalised normal codebook."""
        for name, t in self.named_parameters():
            if t.numel() == 0:
                continue
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gamma", "q_scale", "k_scale") or (
                    leaf == "weight" and t.dim() == 1):
                t.fill_(1.0)
            elif leaf == "bias":
                t.zero_()
            elif name == "temperature":
                t.fill_(self.config.temperature_init)
            elif name.startswith("text_transformer."):
                t.normal_(0.0, 0.02, generator=generator)
            else:  # fan_in = all dims but the first (Linear and Conv3d)
                t.normal_(0.0, (t[0].numel()) ** -0.5, generator=generator)
        cb = self.visual_transformer.vq._codebook
        cb.embed.copy_(l2norm(torch.randn(cb.embed.shape, generator=generator,
                                          device=cb.embed.device)))
        cb.cluster_size.zero_()
        return self

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        enc = self.text_transformer(input_ids, attention_mask)
        cls = enc[:, 0]
        return l2norm(F.linear(cls, self.to_text_latent.weight.to(cls.dtype)))

    def encode_image(self, video: torch.Tensor,
                     spatial_bias: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(b, f, H, W, 1) volume or (b, t*h*w, patch_dim) patch rows ->
        (latents (b, dim_latent), tokens (b, t, h, w, d))."""
        enc = self.visual_transformer(video, spatial_bias=spatial_bias)
        flat = enc.mean(dim=1).reshape(enc.shape[0], -1)
        lat = F.linear(flat, self.to_visual_latent.weight.to(flat.dtype))
        return l2norm(lat), enc
