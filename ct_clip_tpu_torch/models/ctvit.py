"""CTViT image tower: patch embedding -> spatial transformer over each h x w
plane with a continuous position bias -> temporal transformer over each
t-frame column -> cosine VQ, and with `with_decoder` the decoder mirror that
makes it the generative stack's autoencoder.

Port of ct_clip_tpu/models/ctvit.py (`embed_patches` on the volume and the
patch-row paths, `encode`, `decode`, `compute_spatial_bias`, the VQ with its
commitment loss, `return_encoded_tokens`, `return_recons` and
`decode_from_codebook_indices`).  Input is a channels-last (b, frames, H, W,
c) volume, or (b, t*h*w, patch_dim) patch rows from the ingest
(ops/resample.py::preprocess_rows_into), as in the JAX package.

The temporal stage (`_temporal`) runs in the native (b, t, h*w, d) layout
when the token grid is cubic (t == h == w, CT-CLIP's 24^3 at full width),
where its PEG reproduces the reference's memory reinterpretation
(ctvit.py:299-303) with the rotated kernel (K2 grid, K10 grid).  Any other
grid (GenerateCT's 20 x 8 x 8, CT-CLIP at 160 frames) is transposed to
(b*h*w, t, d) sequences, whose PEG sees the reinterpreted memory as it lies
(K2 seq, K10 seq), as ctvit.py:279-286 does.

The decoder mirrors the encoder (temporal stage, then the spatial stage with
its own CPB, then `to_pixels`, a Dense to patch_dim in JAX, so a plain
product here) and un-patchifies the pixel rows with K17 (`unpatchify`,
backward K6).  The reference's decoder is dead code (its modules are never
constructed, SURVEY.md §2.2), so its parameters carry the JAX package's
names, which mirror the encoder's: `dec_spatial_rel_pos_bias`,
`dec_temporal_transformer`, `dec_spatial_transformer`, `to_pixels`.

With `train=True` (the training steps) the embedding is the JAX package's
training composition: on patch rows `row_embed_train`, on a volume
`_xla_patch_embed`, i.e. K6 (`rearrange_patches`, whose backward is K17)
followed by the plain autograd LN -> projection -> LN (`row_embed_plain`);
the CPB bias is computed with its gradient, the sublayers take their
kernels' backwards (K14, K9, K10, K11) and the VQ its training mode (exact
assignment, K15 EMA statistics).  With `train=False` the embeds are K8 and
K4, differentiable through K16a and K16b: the visual-SSL tap embeds its
augmented views that way under grad, as the JAX package does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import CTViTConfig
from ..ops.attention import ContinuousPositionBias, MaskgitTransformer
from ..ops.norms import l2norm
from ..ops.patch_embed import (fused_patch_embed, fused_row_embed,
                               rearrange_patches, row_embed_plain, unpatchify)
from ..ops.vq import CosineVQ


@torch.no_grad()
def init_param_(name: str, t: torch.Tensor, generator: torch.Generator) -> None:
    """The port's seeded random initialisation of one parameter: unit LN,
    gamma and QK scales, zero biases, lecun-normal (fan_in = all dims but
    the first) for Linear and Conv3d weights."""
    if t.numel() == 0:
        return
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("gamma", "q_scale", "k_scale") or (leaf == "weight" and t.dim() == 1):
        t.fill_(1.0)
    elif leaf == "bias":
        t.zero_()
    else:
        t.normal_(0.0, (t[0].numel()) ** -0.5, generator=generator)


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
                           commitment_weight=cfg.vq_commitment_weight, device=device)
        if cfg.with_decoder:
            self.dec_spatial_rel_pos_bias = ContinuousPositionBias(cfg.dim, cfg.heads,
                                                                   device=device)
            self.dec_temporal_transformer = MaskgitTransformer(
                depth=cfg.temporal_depth, **kw)
            self.dec_spatial_transformer = MaskgitTransformer(
                depth=cfg.spatial_depth, **kw)
            self.to_pixels = nn.Linear(cfg.dim, pd, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CTViT":
        """Seeded random weights (`init_param_`) and an l2-normalised normal
        codebook."""
        for name, t in self.named_parameters():
            init_param_(name, t, generator)
        cb = self.vq._codebook
        cb.embed.copy_(l2norm(torch.randn(cb.embed.shape, generator=generator,
                                          device=cb.embed.device)))
        cb.cluster_size.zero_()
        return self

    def embed_patches(self, video: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(b, f, H, W, 1) volume (K8) or (b, t*h*w, patch_dim) patch rows
        (K4) -> (b, t, h, w, dim) in the compute dtype; train=True takes the
        training composition instead (module docstring)."""
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
            tokens = row_embed_plain(rearrange_patches(vol, pt, p), *weights, ln1.eps)
        else:
            tokens = fused_patch_embed(vol, *weights, pt, p, ln1.eps)
        return tokens.reshape(b, f // pt, H // p, W // p, cfg.dim)

    def compute_spatial_bias(self) -> torch.Tensor:
        """The (heads, h*w, h*w) f32 CPB table: a function of the weights
        only, so inference computes it once per weight load."""
        hw = self.config.patch_hw
        return self.spatial_rel_pos_bias(hw, hw)

    @staticmethod
    def _temporal(stage: MaskgitTransformer, x: torch.Tensor) -> torch.Tensor:
        """A temporal transformer over the t-columns of the (b, t, h, w, d)
        tokens: in the native grid layout when the grid is cubic, else on
        the (b*h*w, t, d) sequences (ctvit.py:235-286)."""
        b, t, h, w, d = x.shape
        video_shape = (b, t, h, w)
        if t == h == w:
            out = stage(x.reshape(b, t, h * w, d), video_shape, grid_layout=True)
            return out.reshape(b, t, h, w, d)
        seqs = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, d)
        return stage(seqs, video_shape).reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)

    def encode(self, tokens: torch.Tensor,
               spatial_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Spatial attention over each (h*w) plane, then temporal attention
        over each t column (ctvit.py:226-287)."""
        b, t, h, w, d = tokens.shape
        bias = spatial_bias if spatial_bias is not None \
            else self.spatial_rel_pos_bias(h, w)
        x = self.enc_spatial_transformer(tokens.reshape(b * t, h * w, d),
                                         (b, t, h, w), attn_bias=bias)
        return self._temporal(self.enc_temporal_transformer, x.reshape(b, t, h, w, d))

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """The encoder's mirror (ctvit.py:289-328): temporal stage, spatial
        stage, `to_pixels` -> the (b, f, H, W, 1) volume in the compute
        dtype."""
        cfg = self.config
        b, t, h, w, d = tokens.shape
        x = self._temporal(self.dec_temporal_transformer, tokens.to(self.dtype))
        x = self.dec_spatial_transformer(x.reshape(b * t, h * w, d), (b, t, h, w),
                                         attn_bias=self.dec_spatial_rel_pos_bias(h, w))
        # a Dense in the compute dtype: the product, then the bias add
        pix = x @ self.to_pixels.weight.to(x.dtype).t() + self.to_pixels.bias.to(x.dtype)
        pt, p = cfg.temporal_patch_size, cfg.patch_size
        video = unpatchify(pix.reshape(b, t * h * w, cfg.patch_dim), pt, p, t * pt,
                           h * p, w * p)
        return video[..., None]

    def decode_from_codebook_indices(self, ids: torch.Tensor,
                                     grid: Tuple[int, int, int]) -> torch.Tensor:
        """(b, N) or (b, t, h, w) code ids -> the decoded volume
        (ctvit.py:274-276)."""
        t, h, w = grid
        codes = self.vq.lookup(ids.reshape(ids.shape[0], -1))
        return self.decode(codes.reshape(ids.shape[0], t, h, w, -1))

    def forward(self, video: torch.Tensor,
                spatial_bias: Optional[torch.Tensor] = None,
                train: bool = False, return_recons: bool = False,
                return_only_codebook_ids: bool = False):
        """Encoded + quantized tokens (b, t, h, w, d), the production CLIP
        path (return_encoded_tokens=True); with return_only_codebook_ids the
        code ids (b, t, h, w) int32 (the frozen tokenizer of MaskGIT's
        training and priming); with return_recons (the autoencoder,
        `with_decoder` only) the tuple (reconstruction (b, f, H, W, 1), code
        ids (b, t, h, w), commitment loss).  `video` is a volume or patch
        rows (`embed_patches`).  train=True: the training embed and VQ mode
        (module docstring)."""
        cfg = self.config
        if video.dim() != 3 and video.shape[2:4] != (cfg.image_size,
                                                     cfg.image_size):
            raise ValueError(f"video {tuple(video.shape)} does not match "
                             f"image_size {cfg.image_size}")
        tokens = self.encode(self.embed_patches(video, train), spatial_bias)
        if return_only_codebook_ids:
            return self.vq(tokens, train=train)[1]
        if not return_recons:
            return self.vq(tokens, train=train)[0]
        if not cfg.with_decoder:
            raise ValueError("return_recons needs CTViTConfig(with_decoder=True)")
        quantized, ids, commit = self.vq(tokens, train=train, return_loss=True)
        return self.decode(quantized), ids, commit
