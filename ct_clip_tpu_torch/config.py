"""Typed configuration for the PyTorch port, without JAX.

The fields the ported slices use, with the names and reference defaults of
ct_clip_tpu/config.py.  The defaults are full CT-CLIP width: CTViT dim 512
over a 24x24x24 token grid (480x480x240 volume, 20x20x10 patches), CXR-BERT
12 x 768, 512-dim latents; the RadBERT-RoBERTa report classifier; and the
CT-CLIP pretraining loop (`TrainConfig`); the CTViT autoencoder's decoder
and commitment weight; MaskGIT's token transformer (`MaskGitConfig`).
The mesh settings are not ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# The 18 CT-RATE pathologies (reference: scripts/zero_shot.py:121).
PATHOLOGIES: Tuple[str, ...] = (
    "Medical material",
    "Arterial wall calcification",
    "Cardiomegaly",
    "Pericardial effusion",
    "Coronary artery wall calcification",
    "Hiatal hernia",
    "Lymphadenopathy",
    "Emphysema",
    "Atelectasis",
    "Lung nodule",
    "Lung opacity",
    "Pulmonary fibrotic sequela",
    "Pleural effusion",
    "Mosaic attenuation pattern",
    "Peribronchial thickening",
    "Consolidation",
    "Bronchiectasis",
    "Interlobular septal thickening",
)


class _Base:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CTViTConfig(_Base):
    """3D factorized ViT + VQ image tower (reference:
    transformer_maskgit/ctvit.py:118-188)."""

    dim: int = 512
    codebook_size: int = 8192
    image_size: int = 480
    patch_size: int = 20
    temporal_patch_size: int = 10
    spatial_depth: int = 4
    temporal_depth: int = 4
    dim_head: int = 32
    heads: int = 8
    channels: int = 1
    num_frames: int = 240
    vq_decay: float = 0.8  # codebook EMA decay in training
    vq_commitment_weight: float = 1.0  # weight of the autoencoder's commitment loss
    # the decoder mirror of the autoencoder (the reference's decoder is dead
    # code, ctvit.py:325-335; the JAX package builds a working mirror)
    with_decoder: bool = False

    @property
    def patch_hw(self) -> int:
        return self.image_size // self.patch_size  # 24

    @property
    def patch_t(self) -> int:
        return self.num_frames // self.temporal_patch_size  # 24

    @property
    def patch_dim(self) -> int:
        return self.channels * self.temporal_patch_size * self.patch_size ** 2


@dataclass(frozen=True)
class BertConfig(_Base):
    """HF-BertModel-compatible text tower (CXR-BERT specialized shape)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0


@dataclass(frozen=True)
class RadBertConfig(_Base):
    """RadBERT-RoBERTa-4m multilabel text classifier
    (reference: text_classifier/classifier.py:5-18)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 1
    num_labels: int = 18


@dataclass(frozen=True)
class CTCLIPConfig(_Base):
    """Dual-tower CLIP (reference: CT_CLIP/ct_clip/ct_clip.py:407-585)."""

    dim_text: int = 768
    dim_image: int = 294912  # 24*24*512 flattened post-temporal-pool grid
    dim_latent: int = 512
    use_all_token_embeds: bool = False  # FILIP fine-grained loss
    text_has_cls_token: bool = False  # drop token 0 in FILIP mode (ct_clip.py:421,754)
    visual_has_cls_token: bool = False  # (ct_clip.py:433,755)
    decoupled_contrastive_learning: bool = False  # DCL
    extra_latent_projection: bool = False  # CLOOB
    use_mlm: bool = False  # text SSL
    text_ssl_loss_weight: float = 0.05
    use_visual_ssl: bool = False  # image SSL
    visual_ssl_type: str = "simsiam"  # or "simclr" (ct_clip.py:516-528)
    # NetWrapper hidden-layer tap equivalent (ct_clip.py:444 + visual_ssl.py
    # :141-203): "temporal" = temporal-transformer token output (default),
    # "spatial" = spatial-transformer token output, "pooled" = the temporal-
    # mean pooled embedding.  Token taps flatten to (b*n, d) rows like the
    # reference's NetWrapper flatten.
    visual_ssl_tap: str = "temporal"
    image_ssl_loss_weight: float = 0.05
    multiview_loss_weight: float = 0.1
    temperature_init: float = 1.0
    ctvit: CTViTConfig = field(default_factory=CTViTConfig)
    bert: BertConfig = field(default_factory=BertConfig)


@dataclass(frozen=True)
class TrainConfig(_Base):
    """Pretraining loop (reference defaults: scripts/CTCLIPTrainer.py:128-131,
    scripts/run_train.py:52-55); ct_clip_tpu/config.py:210-236 without the
    mesh."""

    num_train_steps: int = 100001
    batch_size: int = 8
    lr: float = 1.25e-6
    wd: float = 0.0
    max_grad_norm: float = 0.5
    warmup_steps: int = 0  # reference runs constant LR
    save_results_every: int = 100
    save_model_every: int = 2000
    seed: int = 42
    compute_dtype: str = "bfloat16"  # autocast equivalent
    remat: bool = False

    @property
    def dtype(self):
        import torch

        return getattr(torch, self.compute_dtype)


@dataclass(frozen=True)
class MaskGitConfig(_Base):
    """Bidirectional token transformer over VQ ids, the generative stack's
    second stage (reference: transformer_maskgit/MaskGITTransformer.py:
    103-211; ct_clip_tpu/config.py:259-271)."""

    dim: int = 512
    depth: int = 6
    dim_head: int = 64
    heads: int = 8
    max_seq_len: int = 13824 + 1
    t5_dim: int = 768
    unconditional: bool = False
    steps: int = 18
    cond_scale: float = 5.0


@dataclass(frozen=True)
class PreprocessConfig(_Base):
    """Volume preprocessing (reference: scripts/data.py:92-162 train path,
    scripts/data_inference_nii.py:96-165 inference path)."""

    target_spacing: Tuple[float, float, float] = (1.5, 0.75, 0.75)  # (z, x, y) mm
    hu_min: float = -1000.0
    hu_max: float = 1000.0
    norm_scale: float = 1000.0
    target_shape: Tuple[int, int, int] = (240, 480, 480)  # (d, h, w)
    pad_value: float = -1.0
    # train clips HU after resample (data.py:122), infer clips before
    # (data_inference_nii.py:115)
    clip_before_resample: bool = False
