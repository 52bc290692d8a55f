"""CTCLIP dual tower: BERT text latents, CTViT image latents and the
contrastive pretraining loss with its auxiliary objectives.

Port of ct_clip_tpu/models/ctclip.py (`encode_text`, `encode_image`,
`__call__` with `return_loss`, `contrastive_loss`, `filip_loss`,
`_filip_path`, `_weighted_total`), with the reference state-dict layout of
CT_CLIP/ct_clip/ct_clip.py:587-597:
  text:  BERT last-hidden CLS -> to_text_latent (768 -> 512) -> l2norm;
  image: encoded tokens (b, t, h, w, d) -> mean over t -> flatten
         (294,912 at full width) -> to_visual_latent -> l2norm;
  loss:  bidirectional InfoNCE with the learnable exp temperature, optional
         DCL, CLOOB extra projections and m x n multiview batches;
  FILIP (`use_all_token_embeds`): the latent projections per token
         (`dim_image` must equal the CTViT width), `filip_loss`, and the
         (b, L, I) token scores when no loss is asked for;
  MLM (`use_mlm`, models/mlm.py) and visual SSL (`use_visual_ssl`,
         models/visual_ssl.py, SimSiam or SimCLR on the `visual_ssl_tap`
         layer of two augmented views), weighted into the loss as
         ct_clip.py:885-899 does.  The SSL tap embeds the raw volume with the
         inference embed (K8, whose backward is K16a) and does not run the
         VQ, so the codebook is not updated by the views.
Negatives are not gathered across cards (one card).

The three random streams of a training step (the JAX step's dropout, mlm
and ssl keys) are explicit generators: `generator` feeds the text tower's
dropout, `mlm_generator` the MLM draws and `ssl_generator` the augmentation
draws; `mlm_draws` / `ssl_draws` hand the draws in directly.

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
from .ctvit import CTViT, init_param_
from .mlm import MLM
from .visual_ssl import SimCLR, SimSiam

SSL_TYPES = {"simsiam": SimSiam, "simclr": SimCLR}
SSL_TAPS = ("temporal", "spatial", "pooled")


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


def filip_loss(text_tokens: torch.Tensor, image_tokens: torch.Tensor,
               text_mask: torch.Tensor, temp: torch.Tensor, *, decoupled: bool = False,
               extra_tokens: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """FILIP fine-grained contrastive loss (ct_clip_tpu/models/ctclip.py:86-143,
    the upstream x-clip semantics of ct_clip.py:829-843): per-token
    similarities; text -> image is the masked mean over text tokens of the
    max over image tokens, image -> text the mean over image tokens of the
    max over the (mask-filled) text tokens; then the InfoNCE of
    `contrastive_loss`.  text_tokens (m, b, L, d), image_tokens (n, b, I, d),
    text_mask (m, b, L); returns (cl_loss, multiview_cl_losses)."""
    m, b = text_tokens.shape[:2]
    n = image_tokens.shape[0]
    sim = torch.einsum("mxtd,nyid->mnxyti", text_tokens.float(), image_tokens.float()) * temp
    sim_i2t = sim
    if extra_tokens is not None:
        tl_x, il_x = extra_tokens
        sim_i2t = torch.einsum("mxtd,nyid->mnxyti", tl_x.float(), il_x.float()) * temp
    mask = text_mask.bool()[:, None, :, None, :]  # (m, 1, x, 1, t)
    t2i = (torch.where(mask, sim.amax(dim=-1), 0.0).sum(dim=-1)
           / mask.sum(dim=-1).float().clamp_min(1e-6))
    neg_big = torch.finfo(torch.float32).max
    i2t = torch.where(mask[..., None], sim_i2t, -neg_big).amax(dim=-2).mean(dim=-1)

    def one_direction(s):
        s = s.reshape(m * n, b, b)
        pos = s.diagonal(dim1=-2, dim2=-1)
        if decoupled:
            s = s.masked_fill(torch.eye(b, dtype=torch.bool, device=s.device), float("-inf"))
        return (torch.logsumexp(s, dim=-1) - pos).mean(dim=-1)

    cl = 0.5 * (one_direction(t2i) + one_direction(i2t))
    return cl[0], cl[1:]


def _latents(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """l2norm(x W^T) in x's dtype (the bias-free latent projections)."""
    return l2norm(F.linear(x, layer.weight.to(x.dtype)))


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
        if cfg.use_all_token_embeds and cfg.dim_image != cfg.ctvit.dim:
            raise ValueError(f"FILIP projects each image token: dim_image {cfg.dim_image} "
                             f"must equal the CTViT width {cfg.ctvit.dim}")
        # auxiliary objectives, sharing the towers (ct_clip.py:500-528)
        if cfg.use_mlm:
            self.mlm = MLM(cfg.dim_text, cfg.bert.vocab_size,
                           pad_token_id=cfg.bert.pad_token_id, device=device)
        if cfg.use_visual_ssl:
            if cfg.visual_ssl_type not in SSL_TYPES or cfg.visual_ssl_tap not in SSL_TAPS:
                raise ValueError(f"visual SSL {cfg.visual_ssl_type!r} on tap "
                                 f"{cfg.visual_ssl_tap!r}: expected one of "
                                 f"{sorted(SSL_TYPES)} on one of {SSL_TAPS}")
            self.visual_ssl = SSL_TYPES[cfg.visual_ssl_type](cfg.ctvit.dim, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CTCLIP":
        """Seeded random weights: normal(0, 0.02) embeddings and BERT
        projections, lecun-normal for the rest, unit LN scales and QK
        scales, zero biases, an l2-normalised normal codebook."""
        for name, t in self.named_parameters():
            if name == "temperature":
                t.fill_(self.config.temperature_init)
            elif name.startswith("text_transformer.") and t.dim() > 1:
                t.normal_(0.0, 0.02, generator=generator)
            else:
                init_param_(name, t, generator)
        cb = self.visual_transformer.vq._codebook
        cb.embed.copy_(l2norm(torch.randn(cb.embed.shape, generator=generator,
                                          device=cb.embed.device)))
        cb.cluster_size.zero_()
        return self

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                video: torch.Tensor, *, return_loss: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None,
                mlm_generator: Optional[torch.Generator] = None,
                ssl_generator: Optional[torch.Generator] = None,
                mlm_draws: Optional[torch.Tensor] = None,
                ssl_draws: Optional[torch.Tensor] = None,
                num_batch_texts: int = 1, num_batch_images: int = 1) -> torch.Tensor:
        """input_ids / attention_mask ((m*b), L); video ((n*b), f, H, W, 1)
        or ((n*b), t*h*w, patch_dim) patch rows (visual SSL needs volumes).
        return_loss=False: the pair scores (tl . il) * exp(temperature), or
        with FILIP the (b, L, I) token scores; True: the weighted loss
        (ct_clip_tpu/models/ctclip.py:256-400).  train=True runs the image
        tower's training mode; the text tower's dropout is active in
        training mode (`nn.Module.train()`) and draws from `generator`."""
        cfg = self.config
        enc_text = self.text_transformer(input_ids, attention_mask, generator)
        enc_image = self.visual_transformer(video, train=train)
        temp = self.temperature.exp()
        m, n = num_batch_texts, num_batch_images
        if cfg.use_all_token_embeds:
            scores = self._filip(enc_text, enc_image, attention_mask, temp, return_loss, m, n)
            if not return_loss:
                return scores
            cl_loss, multiview = scores
        else:
            image_embeds = enc_image.mean(dim=1).reshape(enc_image.shape[0], -1)
            text_embeds = enc_text[:, 0]
            text_latents = _latents(text_embeds, self.to_text_latent)
            image_latents = _latents(image_embeds, self.to_visual_latent)
            if not return_loss:
                return (text_latents * image_latents).sum(dim=-1) * temp
            extra = None
            if cfg.extra_latent_projection:
                extra = (_latents(text_embeds, self.to_text_latent_extra),
                         _latents(image_embeds, self.to_visual_latent_extra))
            views = lambda t, k: t.reshape(k, -1, cfg.dim_latent)  # noqa: E731
            cl_loss, multiview = contrastive_loss(
                views(text_latents, m), views(image_latents, n), temp,
                decoupled=cfg.decoupled_contrastive_learning,
                image_to_text_latents=None if extra is None else (views(extra[0], m),
                                                                  views(extra[1], n)))
        text_ssl = image_ssl = None
        if cfg.use_mlm:
            if mlm_draws is None:
                mlm_draws = self.mlm.draws(*input_ids.shape, generator=mlm_generator)
            text_ssl = self.mlm(input_ids, attention_mask,
                                lambda ids, mask: self.text_transformer(ids, mask, generator),
                                mlm_draws)
        if cfg.use_visual_ssl:
            if video.dim() != 5:
                raise ValueError("visual SSL needs the raw (b, f, H, W, 1) volumes (3D "
                                 "augmentations); feed volumes, not patch rows")
            if ssl_draws is None:
                ssl_draws = self.visual_ssl.draws(ssl_generator)
            image_ssl = self.visual_ssl(video, self._ssl_tap, ssl_draws)
        return self._weighted_total(cl_loss, multiview, m, n, text_ssl, image_ssl)

    def _weighted_total(self, cl_loss, multiview, m: int, n: int, text_ssl=None,
                        image_ssl=None) -> torch.Tensor:
        """The loss weighting of ct_clip.py:885-899: the contrastive loss
        weighted 1 - (text SSL + image SSL + multiview weights), then the
        MLM, visual-SSL and multiview terms, in that order."""
        cfg = self.config
        is_multiview = m > 1 or n > 1
        multiview_weight = cfg.multiview_loss_weight if is_multiview else 0.0
        cl_weight = 1.0 - (cfg.text_ssl_loss_weight * float(cfg.use_mlm)
                           + cfg.image_ssl_loss_weight * float(cfg.use_visual_ssl)
                           + multiview_weight)
        loss = cl_loss * cl_weight
        if text_ssl is not None:
            loss = loss + text_ssl * cfg.text_ssl_loss_weight
        if image_ssl is not None:
            loss = loss + image_ssl * cfg.image_ssl_loss_weight
        if is_multiview:
            loss = loss + multiview.mean() * multiview_weight
        return loss

    def _filip(self, enc_text, enc_image, attention_mask, temp, return_loss: bool,
               m: int, n: int):
        """FILIP (ct_clip_tpu/models/ctclip.py:352-400): per-token latents;
        the (b, L, I) scores, or (cl_loss, multiview) of `filip_loss`."""
        cfg = self.config
        text_tokens = enc_text[:, 1:] if cfg.text_has_cls_token else enc_text
        text_mask = attention_mask[:, 1:] if cfg.text_has_cls_token else attention_mask
        image_tokens = enc_image.reshape(enc_image.shape[0], -1, enc_image.shape[-1])
        if cfg.visual_has_cls_token:
            image_tokens = image_tokens[:, 1:]
        text_latents = _latents(text_tokens, self.to_text_latent)
        image_latents = _latents(image_tokens, self.to_visual_latent)
        if not return_loss:
            return torch.einsum("btd,bid->bti", text_latents.float(),
                                image_latents.float()) * temp
        extra = None
        if cfg.extra_latent_projection:
            extra = (_latents(text_tokens, self.to_text_latent_extra),
                     _latents(image_tokens, self.to_visual_latent_extra))
        resh = lambda t, k: t.reshape((k, -1) + tuple(t.shape[1:]))  # noqa: E731
        return filip_loss(resh(text_latents, m), resh(image_latents, n),
                          resh(text_mask, m), temp,
                          decoupled=cfg.decoupled_contrastive_learning,
                          extra_tokens=None if extra is None else (resh(extra[0], m),
                                                                   resh(extra[1], n)))

    def _ssl_tap(self, video: torch.Tensor) -> torch.Tensor:
        """The visual-SSL tap on one augmented view (ctclip.py:191-213): the
        inference embed (K8; K16a under grad) of the raw volume, then the
        spatial-transformer tokens (`spatial`), the temporal-transformer
        tokens before the VQ (`temporal`) or their mean over all tokens
        (`pooled`)."""
        vt = self.visual_transformer
        tokens = vt.embed_patches(video, train=False)
        b, t, h, w, d = tokens.shape
        if self.config.visual_ssl_tap == "spatial":
            return vt.enc_spatial_transformer(tokens.reshape(b * t, h * w, d), (b, t, h, w),
                                              attn_bias=vt.spatial_rel_pos_bias(h, w))
        x = vt.encode(tokens)
        if self.config.visual_ssl_tap == "pooled":
            return x.reshape(b, -1, d).mean(dim=1)
        return x

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
        enc = self.text_transformer(input_ids, attention_mask)
        return _latents(enc[:, 0], self.to_text_latent)

    def encode_image(self, video: torch.Tensor,
                     spatial_bias: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(b, f, H, W, 1) volume or (b, t*h*w, patch_dim) patch rows ->
        (latents (b, dim_latent), tokens (b, t, h, w, d))."""
        enc = self.visual_transformer(video, spatial_bias=spatial_bias)
        return _latents(enc.mean(dim=1).reshape(enc.shape[0], -1), self.to_visual_latent), enc
