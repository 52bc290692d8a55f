"""ct_clip_tpu_torch: the PyTorch/CUDA port of ct_clip_tpu for NVIDIA Hopper.

The JAX package `ct_clip_tpu` is the reference; this package imports torch
and never jax.  What runs so far is the zero-shot path (NIfTI loading,
device preprocessing, the CTViT image tower, the BERT text tower and
18-pathology scoring), export of latents, the RadBERT report classifier
(training, inference, evaluation) and CT-CLIP contrastive pretraining, with
the TPU kernels on those paths ported as hand-written CUDA kernels (csrc/,
ops/kernels).
"""
from .config import (PATHOLOGIES, BertConfig, CTCLIPConfig, CTViTConfig,
                     PreprocessConfig, RadBertConfig, TrainConfig)

__all__ = ["PATHOLOGIES", "BertConfig", "CTCLIPConfig", "CTViTConfig",
           "PreprocessConfig", "RadBertConfig", "TrainConfig"]
