"""HF-BertModel-compatible text tower (CXR-BERT), inference.

Port of ct_clip_tpu/models/bert.py::BertModel: embeddings, post-LN layers
with exact-erf GELU and eps from the config, additive pad mask of f32 min.
Module names reproduce the HF state-dict layout (`embeddings.*`,
`encoder.layer.{i}.attention.self.query`, ..., `pooler.dense`), the layout
ct_clip_tpu/convert/torch_to_jax.py reads.  Attention runs through the port
of the TPU kernel ops/pallas/attention.py::fused_attention (K7) with the pad
mask as a per-key bias, key_bias = attn_bias[:, 0, 0, :] (bert.py:87-91).
The dense layers stay `nn.Linear`, as the JAX package left them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import BertConfig
from ..ops.attention import fused_attention
from ..ops.norms import layer_norm


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class _Module(nn.Module):
    """Attribute holder for the HF names."""


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
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

        self.pooler = _Module()  # kept for the checkpoint layout
        self.pooler.dense = lin(H, H)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """(b, n) ids and mask -> last hidden states (b, n, hidden)."""
        cfg, dtype = self.config, self.dtype
        b, n = input_ids.shape
        h = cfg.num_attention_heads
        dh = cfg.hidden_size // h
        emb = self.embeddings
        pos = torch.arange(n, device=input_ids.device)
        x = (emb.word_embeddings.weight.to(dtype)[input_ids]
             + emb.position_embeddings.weight.to(dtype)[pos][None]
             + emb.token_type_embeddings.weight.to(dtype)[0])
        x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias,
                       cfg.layer_norm_eps)
        key_bias = (1.0 - attention_mask.float()) * torch.finfo(torch.float32).min

        def heads(t):
            return t.view(b, n, h, dh).transpose(1, 2)

        for layer in self.encoder.layer:
            sa = layer.attention.self
            q, k, v = (heads(_linear(x, m)) for m in (sa.query, sa.key, sa.value))
            ctx = fused_attention(q * dh ** -0.5, k, v, key_bias=key_bias)
            ctx = ctx.transpose(1, 2).reshape(b, n, cfg.hidden_size)
            out = layer.attention.output
            x = layer_norm(x + _linear(ctx, out.dense), out.LayerNorm.weight,
                           out.LayerNorm.bias, cfg.layer_norm_eps)
            inter = F.gelu(_linear(x, layer.intermediate.dense))
            out = layer.output
            x = layer_norm(x + _linear(inter, out.dense), out.LayerNorm.weight,
                           out.LayerNorm.bias, cfg.layer_norm_eps)
        return x
