"""HF-BertModel / RobertaModel-compatible encoders and the RadBERT classifier.

Port of ct_clip_tpu/models/bert.py: embeddings (RoBERTa position ids when
asked), post-LN layers with exact-erf GELU and eps from the config, additive
pad mask of f32 min, the tanh pooler, and hidden dropout on the embeddings
and after both dense outputs.  Module names reproduce the HF state-dict
layout (`embeddings.*`, `encoder.layer.{i}.attention.self.query`, ...,
`pooler.dense`), the layout ct_clip_tpu/convert/torch_to_jax.py reads; the
classifier adds `model.` and `fc1` (text_classifier/classifier.py).

Attention, as bert.py:82-105 picks it: in training with attention dropout
> 0, the port of K13 (`fused_attention_kbias_dropout`, a fresh Philox seed
per layer drawn from the caller's generator); otherwise the port of K7
(`fused_attention`, whose backward is K12), the pad mask a per-key bias.
Dropout is active only in training mode (`nn.Module.train()`), where it
needs an explicit `torch.Generator` on the input's device.  The dense layers
stay `nn.Linear`, as the JAX package left them to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BertConfig, RadBertConfig
from ..ops.attention import fused_attention, fused_attention_kbias_dropout
from ..ops.norms import layer_norm


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, scale by 1 / (1 - rate);
    `generator` None means inactive."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


class _Module(nn.Module):
    """Attribute holder for the HF names."""


class BertModel(nn.Module):
    """transformers.BertModel equivalent; `roberta_positions=True` with a
    RadBertConfig gives RobertaModel semantics."""

    def __init__(self, config: BertConfig | RadBertConfig,
                 dtype: torch.dtype = torch.float32, device=None,
                 roberta_positions: bool = False):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.roberta_positions = roberta_positions
        H = cfg.hidden_size
        lin = lambda i, o: nn.Linear(i, o, device=device)  # noqa: E731
        ln = lambda: nn.LayerNorm(H, eps=cfg.layer_norm_eps, device=device)  # noqa: E731

        self.embeddings = _Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, H, device=device)
        self.embeddings.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, H, device=device)
        self.embeddings.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, H, device=device)
        self.embeddings.LayerNorm = ln()

        self.encoder = _Module()
        self.encoder.layer = nn.ModuleList()
        for _ in range(cfg.num_hidden_layers):
            layer = _Module()
            layer.attention = _Module()
            layer.attention.self = _Module()
            for name in ("query", "key", "value"):
                setattr(layer.attention.self, name, lin(H, H))
            layer.attention.output = _Module()
            layer.attention.output.dense = lin(H, H)
            layer.attention.output.LayerNorm = ln()
            layer.intermediate = _Module()
            layer.intermediate.dense = lin(H, cfg.intermediate_size)
            layer.output = _Module()
            layer.output.dense = lin(cfg.intermediate_size, H)
            layer.output.LayerNorm = ln()
            self.encoder.layer.append(layer)

        self.pooler = _Module()
        self.pooler.dense = lin(H, H)

    def position_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        """arange(n), or RoBERTa's cumsum(ids != pad) * (ids != pad) + pad
        (create_position_ids_from_input_ids)."""
        if not self.roberta_positions:
            return torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        pad = self.config.pad_token_id
        mask = (input_ids != pad).long()
        return torch.cumsum(mask, dim=1) * mask + pad

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(b, n) ids and mask -> last hidden states (b, n, hidden).  In
        training mode the dropouts draw from `generator`."""
        cfg, dtype = self.config, self.dtype
        b, n = input_ids.shape
        h = cfg.num_attention_heads
        dh = cfg.hidden_size // h
        if not self.training:
            generator = None
        elif generator is None and (cfg.hidden_dropout or cfg.attention_dropout):
            raise ValueError("BertModel in training mode needs a dropout generator")
        emb = self.embeddings
        x = (emb.word_embeddings.weight.to(dtype)[input_ids]
             + emb.position_embeddings.weight.to(dtype)[self.position_ids(input_ids)]
             + emb.token_type_embeddings.weight.to(dtype)[0])
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias,
                       cfg.layer_norm_eps)
        x = _dropout(x, cfg.hidden_dropout, generator)
        key_bias = (1.0 - attention_mask.float()) * torch.finfo(torch.float32).min

        def heads(t):
            return t.view(b, n, h, dh).transpose(1, 2)

        for layer in self.encoder.layer:
            sa = layer.attention.self
            q, k, v = (heads(_linear(x, m)) for m in (sa.query, sa.key, sa.value))
            q = q * dh ** -0.5
            if generator is not None and cfg.attention_dropout > 0:
                seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device)
                ctx = fused_attention_kbias_dropout(q, k, v, key_bias, seed,
                                                    cfg.attention_dropout)
            else:
                ctx = fused_attention(q, k, v, key_bias=key_bias)
            ctx = ctx.transpose(1, 2).reshape(b, n, cfg.hidden_size)
            out = layer.attention.output
            attn = _dropout(_linear(ctx, out.dense), cfg.hidden_dropout, generator)
            x = layer_norm(x + attn, out.LayerNorm.weight, out.LayerNorm.bias,
                           cfg.layer_norm_eps)
            inter = F.gelu(_linear(x, layer.intermediate.dense))
            out = layer.output
            ff = _dropout(_linear(inter, out.dense), cfg.hidden_dropout, generator)
            x = layer_norm(x + ff, out.LayerNorm.weight, out.LayerNorm.bias,
                           cfg.layer_norm_eps)
        return x

    def pool(self, hidden: torch.Tensor) -> torch.Tensor:
        """tanh(dense(hidden[:, 0])), the HF pooler."""
        return torch.tanh(_linear(hidden[:, 0], self.pooler.dense))


class RadBertClassifier(nn.Module):
    """RoBERTa encoder + Linear(hidden -> num_labels) on the pooled output
    (text_classifier/classifier.py:5-18), in f32.  State-dict keys `model.*`
    and `fc1.*`, as convert/torch_to_jax.py::radbert_params_from_torch reads
    them."""

    def __init__(self, config: RadBertConfig, device=None):
        super().__init__()
        self.config = config
        self.model = BertModel(config, device=device, roberta_positions=True)
        self.fc1 = nn.Linear(config.hidden_size, config.num_labels, device=device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(b, n) ids and mask -> (b, num_labels) logits."""
        return self.fc1(self.model.pool(self.model(input_ids, attention_mask,
                                                   generator)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "RadBertClassifier":
        """Seeded random weights as HF initialises RoBERTa: normal(0, 0.02)
        embeddings and dense weights, zero biases, unit LayerNorm scales."""
        for name, t in self.named_parameters():
            if name.endswith("bias"):
                t.zero_()
            elif "LayerNorm" in name:
                t.fill_(1.0)
            else:
                t.normal_(0.0, 0.02, generator=generator)
        return self
