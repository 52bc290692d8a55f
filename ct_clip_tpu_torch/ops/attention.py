"""Attention blocks of the CTViT encoder and the BERT attention core.

Ports of ct_clip_tpu/ops/attention.py:
  * `ContinuousPositionBias` (:147-186): MLP over the (2h-1)(2w-1) distinct
    log-distance offsets, then a gather to the (heads, N, N) bias.  Plain
    torch (the JAX package runs it in XLA), computed once per weight load;
  * `PEG` (:439-498), including `rotated=True`: the depthwise 3x3x3 conv with
    causal frame padding.  The JAX package runs it as an XLA grouped conv
    (ops/pallas/peg.py::lax_peg_conv), so here it is `F.conv3d(groups=c)`;
  * `QKNormAttention` and `MaskgitTransformer` (:501-583) for the encoder:
    PEG -> attention -> feed-forward per layer, residuals folded into the
    sublayer kernels, final gamma LayerNorm;
  * `fused_attention`, the port of ops/pallas/attention.py::fused_attention
    (K7): softmax(q k^T + bias + key_bias) v on (b, h, n, d).

Module and parameter names reproduce the reference torch state-dict layout
(transformer_maskgit: `layers.{i}.0` PEG, `.1` attention, `.3` FF).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import kernels as K
from .ffn import MaskgitFeedForward
from .norms import layer_norm
from .qknorm_attention import (fused_grid_qknorm_attention,
                               fused_spatial_qknorm_attention)


# ------------------------------------------------------------------ K7 port
def attention_plain(q, k, v, bias: Optional[torch.Tensor] = None,
                    key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `_xla_attention`: (b, h, n, d) q, k, v; bias
    broadcastable to (b, h, n, n); key_bias (b, n); f32 scores."""
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    if bias is not None:
        sim = sim + bias.float()
    if key_bias is not None:
        sim = sim + key_bias.float()[:, None, None, :]
    attn = sim.softmax(dim=-1)
    return torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)


def _attention_cuda(q, k, v, bias, key_bias):
    b, h, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("fused_attention: q, k, v shapes differ")
    if k.stride() != v.stride():
        k, v = k.contiguous(), v.contiguous()
    if bias is not None and key_bias is not None:
        raise ValueError("fused_attention: bias and key_bias are exclusive")
    out = torch.empty_like(q)
    if out.stride() != q.stride():  # q not dense: give both the same layout
        q = q.contiguous()
        out = torch.empty_like(q)
    mode, table = 0, None
    if key_bias is not None:
        mode, table = 2, key_bias.float().contiguous()
    elif bias is not None:
        if bias.dim() != 4 or bias.shape[0] != 1:
            raise ValueError("fused_attention: bias must be (1, 1|h, n, n)")
        mode, table = 1, bias[0].float().expand(h, n, n).contiguous()
    K.attention(q, k, v, out, sequences=b, inner=1, heads=h, n=n, d=d,
                q_strides=(q.stride(0), 0, q.stride(1), q.stride(2)),
                kv_strides=(k.stride(0), 0, k.stride(1), k.stride(2)),
                bias=table, bias_mode=mode, warps=8 if n >= 128 else 2)
    K.count_launch("fused_attention")
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T + bias + key_bias[:, None, None]) v on (b, h, n, d),
    any scaling already applied to q.  bias (1, 1|h, n, n) and key_bias
    (b, n) are mutually exclusive on the kernel path."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias, key_bias)
    return _attention_cuda(q, k, v, bias, key_bias)


# ----------------------------------------------------------------- encoder
class GammaLayerNorm(nn.Module):
    """Gamma-only LayerNorm with the reference's zero `beta` buffer
    (transformer_maskgit/attention.py:28-35)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device))
        self.register_buffer("beta", torch.zeros(dim, device=device))

    def forward(self, x):
        return layer_norm(x, self.gamma, None, 1e-5)


class ContinuousPositionBias(nn.Module):
    """SwinV2 continuous position bias, num_dims=2, layers=2, log distance
    (transformer_maskgit/attention.py:229-276).  The MLP runs over the
    distinct offsets only, in f32."""

    def __init__(self, dim: int, heads: int, device=None):
        super().__init__()
        self.net = nn.ModuleList([
            nn.Sequential(nn.Linear(2, dim, device=device), nn.LeakyReLU(0.1)),
            nn.Sequential(nn.Linear(dim, dim, device=device), nn.LeakyReLU(0.1)),
            nn.Linear(dim, heads, device=device)])

    @staticmethod
    def _tables(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
        offsets = [np.arange(-(d - 1), d) for d in (h, w)]
        uniq = np.stack(np.meshgrid(*offsets, indexing="ij"),
                        axis=-1).reshape(-1, 2).astype(np.float32)
        uniq = np.sign(uniq) * np.log(np.abs(uniq) + 1.0)
        pos = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                       axis=-1).reshape(-1, 2)
        rel = pos[:, None, :] - pos[None, :, :]
        idx = (rel[..., 0] + h - 1) * (2 * w - 1) + (rel[..., 1] + w - 1)
        return uniq, idx

    def forward(self, h: int, w: int) -> torch.Tensor:
        uniq, idx = self._tables(h, w)
        dev = self.net[0][0].weight.device
        x = torch.from_numpy(uniq).to(dev)
        for layer in self.net:
            x = layer(x.float())
        bias = x[torch.from_numpy(idx).to(dev)]       # (N, N, heads)
        return bias.permute(2, 0, 1).contiguous()     # (heads, N, N)


class PEG(nn.Module):
    """Depthwise 3x3x3 conv positional encoding with causal frame padding
    (transformer_maskgit/attention.py:56-84, peg_causal=True in CTViT), + x.

    rotated=True computes the reference's temporal-stage semantics on the
    native (b, t, h, w, c) grid: the reference reinterprets (b, h, w, t, c)
    memory as (b, t, h, w, c) (ctvit.py:299-303), which for a cubic grid is
    the same conv with the kernel's tap axes rotated (t, h, w) -> (h, w, t)
    and the causal pad moved to the h axis (ops/attention.py:457-496)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dsconv = nn.Conv3d(dim, dim, 3, groups=dim, device=device)

    def forward(self, x: torch.Tensor, rotated: bool = False) -> torch.Tensor:
        """x: (b, t, h, w, c) in the compute dtype."""
        w = self.dsconv.weight.to(x.dtype)          # (c, 1, kt, kh, kw)
        if rotated:
            if not x.shape[1] == x.shape[2] == x.shape[3]:
                raise ValueError("rotated PEG needs a cubic grid")
            w = w.permute(0, 1, 4, 2, 3)            # K_r[a, b, c] = K[b, c, a]
            pad = [1, 1, 2, 0, 1, 1]                # (w, h, t) pairs: causal h
        else:
            pad = [1, 1, 1, 1, 2, 0]                # causal frames
        xc = x.permute(0, 4, 1, 2, 3)               # (b, c, t, h, w)
        conv = F.conv3d(F.pad(xc, pad), w, groups=x.shape[-1])
        out = conv.permute(0, 2, 3, 4, 1) + x
        return out + self.dsconv.bias.to(x.dtype)


class QKNormAttention(nn.Module):
    """Self-attention with QK l2-norm and learned per-dim scales, fixed
    logit scale 8, no null key/values (transformer_maskgit/attention.py:
    88-181).  forward adds the residual."""

    def __init__(self, dim: int, dim_head: int, heads: int, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.scale = heads, dim_head, 8.0
        self.norm = GammaLayerNorm(dim, device=device)
        self.to_q = nn.Linear(dim, inner, bias=False, device=device)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, device=device)
        self.q_scale = nn.Parameter(torch.ones(dim_head, device=device))
        self.k_scale = nn.Parameter(torch.ones(dim_head, device=device))
        self.null_kv = nn.Parameter(torch.zeros(heads, 0, dim_head,
                                                device=device))
        self.to_out = nn.Linear(inner, dim, bias=False, device=device)

    def forward(self, x: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        args = (self.norm.gamma, self.to_q.weight, self.to_kv.weight,
                self.q_scale, self.k_scale, self.to_out.weight)
        if x.dim() == 4:  # native (b, t, h*w, d) grid: attend along t
            if attn_bias is not None:
                raise ValueError("the grid layout takes no attention bias")
            return fused_grid_qknorm_attention(x, *args, self.heads,
                                               self.dim_head, self.scale)
        return fused_spatial_qknorm_attention(x, *args, attn_bias, self.heads,
                                              self.dim_head, self.scale)


class TransformerLayer(nn.ModuleDict):
    """One reference layer: "0" PEG, "1" self-attention, "3" feed-forward
    (index 2, cross-attention, is absent in the CTViT encoder)."""

    def __init__(self, dim: int, dim_head: int, heads: int, device=None):
        super().__init__({"0": PEG(dim, device=device),
                          "1": QKNormAttention(dim, dim_head, heads,
                                               device=device),
                          "3": MaskgitFeedForward(dim, device=device)})


class MaskgitTransformer(nn.Module):
    """transformer_maskgit/attention.py:280-333 for the CTViT encoder:
    [PEG, self-attention, FF] x depth, all residual, then norm_out."""

    def __init__(self, dim: int, depth: int, dim_head: int, heads: int,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList(TransformerLayer(dim, dim_head, heads,
                                                     device=device)
                                    for _ in range(depth))
        self.norm_out = GammaLayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor, video_shape: Tuple[int, int, int, int],
                attn_bias: Optional[torch.Tensor] = None,
                grid_layout: bool = False) -> torch.Tensor:
        """x: (b*t, h*w, d) spatial sequences, or with grid_layout=True the
        native (b, t, h*w, d) grid of a cubic token grid."""
        if grid_layout:
            b, t, h, w = video_shape
            if not (t == h == w and x.shape[:3] == (b, t, h * w)):
                raise ValueError(f"grid layout needs a cubic (b, t, h*w, d) "
                                 f"grid, got {tuple(x.shape)}")
        d = x.shape[-1]
        for layer in self.layers:
            # PEG sees x.reshape(*video_shape, d): the true grid spatially,
            # the reference's reinterpreted grid temporally (rotated)
            grid = x.reshape(*video_shape, d)
            x = layer["0"](grid, rotated=grid_layout).reshape(x.shape)
            x = layer["1"](x, attn_bias)
            x = layer["3"](x)
        return self.norm_out(x)
