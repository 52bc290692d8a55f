"""T5 v1.1 encoder for MaskGIT's text conditioning.

Port of ct_clip_tpu/models/t5_encoder.py (the reference conditions on a
frozen HF `google/t5-v1_1-base` encoder, transformer_maskgit/t5.py:18-104):
  * RMS LayerNorm (no mean, no bias), f32 statistics;
  * the relative-position bucket bias (32 buckets, max distance 128,
    bidirectional), computed once per call from block 0's table and shared
    by every layer;
  * unscaled attention through `fused_attention(q, k, v, bias=pos_bias,
    key_bias=...)`: without a pad mask the (1, heads, n, n) f32 bias takes
    K7's dense-bias form on CUDA; with one, bias and key bias together take
    `attention_plain` on every device, as the JAX package takes XLA;
  * gated-GELU (tanh) feed-forward (v1.1) or ReLU (v1.0), plain products
    (XLA in the JAX package too).

Module names are those of HF's `T5EncoderModel` (`shared`,
`encoder.embed_tokens` tied to it, `encoder.block.{i}.layer.0.SelfAttention.
{q,k,v,o}`, `...relative_attention_bias` in block 0, `layer.{0,1}.layer_norm`,
`layer.1.DenseReluDense.{wi_0,wi_1,wo}`, `encoder.final_layer_norm`), so an
HF state dict loads with `load_state_dict`.  The repository holds no T5
weights: they are seeded (`init_weights`) until such files are at hand.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_attention
from .ctvit import init_param_


@dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 2048
    num_layers: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    gated_gelu: bool = True  # v1.1; False: v1.0's ReLU feed-forward


def t5_base_v1_1() -> T5EncoderConfig:
    """google/t5-v1_1-base (transformer_maskgit/t5.py:18)."""
    return T5EncoderConfig()


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 bucket of each offset (memory - query): half the
    buckets per sign, half of those exact small offsets, the rest
    log-spaced out to max_distance."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    rel_f = torch.clamp_min(rel.float(), 1.0)
    large = max_exact + (torch.log(rel_f / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.clamp_max(large, num_buckets - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class T5LayerNorm(nn.Module):
    """RMS norm: x * rsqrt(mean(x^2) + eps) * weight, statistics in f32."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().pow(2).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.weight.to(x.dtype)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool, device=None):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        for name in ("q", "k", "v"):
            setattr(self, name, nn.Linear(cfg.d_model, inner, bias=False, device=device))
        self.o = nn.Linear(inner, cfg.d_model, bias=False, device=device)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, device=device)

    def forward(self, x, pos_bias, key_bias):
        b, n, _ = x.shape

        def split(layer):  # head-major (b, h, n, d_kv); q is not scaled (T5)
            return layer(x).view(b, n, self.heads, self.d_kv).transpose(1, 2)

        out = fused_attention(split(self.q), split(self.k), split(self.v),
                              bias=pos_bias, key_bias=key_bias)
        return self.o(out.transpose(1, 2).reshape(b, n, -1))


class T5DenseFF(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, device=None):
        super().__init__()
        self.gated = cfg.gated_gelu
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, device=device)

    def forward(self, x):
        if self.gated:  # gelu_new(wi_0 x) * wi_1 x
            return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))
        return self.wo(F.relu(self.wi(x)))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool, device=None):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias, device)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, device=None):
        super().__init__()
        self.DenseReluDense = T5DenseFF(cfg, device)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)


class T5Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool, device=None):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_bias, device),
                                    T5LayerFF(cfg, device)])

    def forward(self, x, pos_bias, key_bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), pos_bias, key_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, embed_tokens: nn.Embedding, device=None):
        super().__init__()
        self.embed_tokens = embed_tokens
        self.block = nn.ModuleList(T5Block(cfg, i == 0, device)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_eps, device)


class T5Encoder(nn.Module):
    """(b, n) token ids and an optional (b, n) mask (1 attends) -> the final
    hidden states (b, n, d_model) in f32; pad rows are not zeroed here
    (`models/t5.py::t5_embedder` zeroes them)."""

    def __init__(self, cfg: T5EncoderConfig, device=None):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device)
        self.encoder = T5Stack(cfg, self.shared, device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "T5Encoder":
        """Seeded random weights (`init_param_`: unit norms, lecun-normal
        matrices and tables)."""
        for name, t in self.named_parameters():
            init_param_(name, t, generator)
        return self

    def position_bias(self, n: int) -> torch.Tensor:
        """The (1, heads, n, n) f32 relative-position bias, shared by every
        layer."""
        cfg = self.config
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        pos = torch.arange(n, device=table.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        return table.float()[buckets].permute(2, 0, 1)[None]

    def forward(self, ids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.shared.weight[ids.long()]
        pos_bias = self.position_bias(ids.shape[1])
        key_bias = None
        if mask is not None:
            key_bias = torch.where(mask.bool(), 0.0, -1e9).float()
        for block in self.encoder.block:
            x = block(x, pos_bias, key_bias)
        return self.encoder.final_layer_norm(x)
