"""Text conditioning for the generative stack: texts -> (b, n, d) embeddings
with zeroed pad rows (the contract of transformer_maskgit/t5.py:88-104).

Port of ct_clip_tpu/models/t5.py: `t5_embedder` wraps the port's
`T5Encoder` (models/t5_encoder.py; `jax_t5_embedder` in the JAX package) and
`bert_text_embedder` the CXR-BERT tower, the air-gapped alternative.  The
JAX package's `t5_encode_text` and `load_t5_jax` load `google/t5-v1_1-base`
through `transformers` from the hub; that needs a download and is not
ported.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

T5_NAME = "google/t5-v1_1-base"
MAX_LENGTH = 256


def _embedder(encode: Callable, tokenizer, device, padding: str,
              max_length: int) -> Callable[[Sequence[str]], torch.Tensor]:
    @torch.no_grad()
    def embed(texts: Sequence[str]) -> torch.Tensor:
        enc = tokenizer(list(texts), padding=padding, truncation=True, max_length=max_length)
        ids = torch.as_tensor(enc["input_ids"], device=device).long()
        mask = torch.as_tensor(enc["attention_mask"], device=device).long()
        hidden = encode(ids, mask)
        return hidden * mask[..., None].to(hidden.dtype)

    return embed


def t5_embedder(model, tokenizer, max_length: int = MAX_LENGTH) -> Callable:
    """texts -> (b, n, d_model) from the port's T5Encoder (padded to the
    longest text, pad rows zeroed), on the model's device."""
    device = model.shared.weight.device
    return _embedder(model, tokenizer, device, "longest", max_length)


def bert_text_embedder(model, tokenizer, max_length: int = 512) -> Callable:
    """texts -> (b, max_length, hidden) last hidden states of the port's
    BertModel (padded to max_length, pad rows zeroed), on its device."""
    device = model.embeddings.word_embeddings.weight.device
    return _embedder(model, tokenizer, device, "max_length", max_length)
