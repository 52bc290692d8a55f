"""CTCLIP dual tower: BERT text latents, CTViT image latents and the
contrastive pretraining loss.

Port of ct_clip_tpu/models/ctclip.py (`encode_text`, `encode_image`,
`__call__` with `return_loss`, `contrastive_loss`, `_weighted_total`), with
the reference state-dict layout of CT_CLIP/ct_clip/ct_clip.py:587-597:
  text:  BERT last-hidden CLS -> to_text_latent (768 -> 512) -> l2norm;
  image: encoded tokens (b, t, h, w, d) -> mean over t -> flatten
         (294,912 at full width) -> to_visual_latent -> l2norm;
  loss:  bidirectional InfoNCE with the learnable exp temperature, optional
         DCL, CLOOB extra projections and m x n multiview batches.
Negatives are not gathered across cards (one card).  MLM, visual SSL and
FILIP are not ported: asking for them raises NotImplementedError.

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

_NOT_PORTED = ("use_mlm", "use_visual_ssl", "use_all_token_embeds")


def contrastive_loss(text_latents: torch.Tensor, image_latents: torch.Tensor,
                     temp: torch.Tensor, *, decoupled: bool = False,
                     image_to_text_latents: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Bidirectional InfoNCE in the stable log-softmax form
    (ct_clip_tpu/models/ctclip.py:39-83).  text_latents / image_latents:
    (m, b, d) / (n, b, d) l2-normalised multiview stacks; returns (cl_loss,
    multiview_cl_losses (m*n - 1,))."""
    m, b, _ = text_latents.shape
    n = image_latents.shape[0]
    t2i = torch.einsum("mtd,nid->mnti", text_latents.float(), image_latents.float()) * temp
    if image_to_text_latents is not None:  # CLOOB extra projections
        tl_x, il_x = image_to_text_latents
        i2t = torch.einsum("mtd,nid->mnit", tl_x.float(), il_x.float()) * temp
    else:
        i2t = t2i.transpose(-1, -2)
    t2i, i2t = t2i.reshape(m * n, b, b), i2t.reshape(m * n, b, b)

    def one_direction(sim):
        pos = sim.diagonal(dim1=-2, dim2=-1)
        if decoupled:  # DCL: drop positives from the denominator
            eye = torch.eye(b, dtype=torch.bool, device=sim.device)
            sim = sim.masked_fill(eye, float("-inf"))
        return (torch.logsumexp(sim, dim=-1) - pos).mean(dim=-1)

    cl = 0.5 * (one_direction(t2i) + one_direction(i2t))
    return cl[0], cl[1:]


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

    def _check_ported(self) -> None:
        asked = [k for k in _NOT_PORTED if getattr(self.config, k)]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: MLM, visual SSL and FILIP are not ported to "
                "ct_clip_tpu_torch yet (ROADMAP.md, training queue)")

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                video: torch.Tensor, *, return_loss: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None,
                num_batch_texts: int = 1, num_batch_images: int = 1) -> torch.Tensor:
        """input_ids / attention_mask ((m*b), L); video ((n*b), f, H, W, 1)
        or ((n*b), t*h*w, patch_dim) patch rows.  return_loss=False: the
        pair scores (tl . il) * exp(temperature); True: the weighted
        contrastive loss (ct_clip_tpu/models/ctclip.py:256-350).  train=True
        runs the image tower's training mode; the text tower's dropout is
        active in training mode (`nn.Module.train()`) and draws from
        `generator`."""
        self._check_ported()
        cfg = self.config
        enc_text = self.text_transformer(input_ids, attention_mask, generator)
        enc_image = self.visual_transformer(video, train=train)
        image_embeds = enc_image.mean(dim=1).reshape(enc_image.shape[0], -1)
        text_embeds = enc_text[:, 0]
        proj = lambda x, layer: l2norm(F.linear(x, layer.weight.to(x.dtype)))  # noqa: E731
        text_latents = proj(text_embeds, self.to_text_latent)
        image_latents = proj(image_embeds, self.to_visual_latent)
        extra = None
        if cfg.extra_latent_projection:
            extra = (proj(text_embeds, self.to_text_latent_extra),
                     proj(image_embeds, self.to_visual_latent_extra))
        temp = self.temperature.exp()
        if not return_loss:
            return (text_latents * image_latents).sum(dim=-1) * temp
        m, n = num_batch_texts, num_batch_images
        views = lambda t, k: t.reshape(k, -1, cfg.dim_latent)  # noqa: E731
        cl_loss, multiview = contrastive_loss(
            views(text_latents, m), views(image_latents, n), temp,
            decoupled=cfg.decoupled_contrastive_learning,
            image_to_text_latents=None if extra is None else (views(extra[0], m),
                                                              views(extra[1], n)))
        return self._weighted_total(cl_loss, multiview, m, n)

    def _weighted_total(self, cl_loss, multiview, m: int, n: int) -> torch.Tensor:
        """The loss weighting of ct_clip.py:885-899 without the SSL terms
        (`_check_ported` refuses them)."""
        cfg = self.config
        is_multiview = m > 1 or n > 1
        multiview_weight = cfg.multiview_loss_weight if is_multiview else 0.0
        loss = cl_loss * (1.0 - multiview_weight)
        if is_multiview:
            loss = loss + multiview.mean() * multiview_weight
        return loss

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
