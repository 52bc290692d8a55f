"""The CTViT QK-norm attention sublayer, spatial (K1) and temporal-grid (K2).

Ports of ct_clip_tpu/ops/pallas/spatial_attention.py::
fused_spatial_qknorm_attention (K1, plain twin `_xla_spatial_qknorm`) and
ops/pallas/small_attention.py::fused_small_qknorm_attention_grid (K2, plain
twin `_xla_grid_qknorm`).  One sublayer (reference
transformer_maskgit/attention.py:88-181, self-attention, no null kv):

  * gamma LayerNorm; q from LN(x), k and v from the PRE-norm x
    (attention.py:139-143);
  * per-head l2norm, q times q_scale * 8, k times k_scale;
  * f32 scores, plus the (heads, n, n) CPB bias for the spatial stage;
  * softmax, times v, heads merged, output projection, + x.

Weights are in nn.Linear layout: wq (h*dh, dim), wkv (2*h*dh, dim) with k
first, wout (dim, h*dh).  The spatial form takes (b, n, dim) sequences; the
grid form takes the native (b, t, h*w, dim) token grid and attends along t.

On a CUDA tensor: LN (csrc/layernorm.cu), the q and kv products
(csrc/gemm.cu), the attention core (csrc/attention.cu, which reads the
t-columns of the grid in place through strides) and the output product with
the residual epilogue.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels as K
from .norms import l2norm, layer_norm


def qknorm_attention_plain(x, gamma, wq, wkv, q_scale, k_scale, wout,
                           bias: Optional[torch.Tensor], heads: int,
                           dim_head: int, scale: float = 8.0) -> torch.Tensor:
    """Plain PyTorch version on (..., n, dim) sequences."""
    dtype = x.dtype
    h, dh = heads, dim_head
    xn = layer_norm(x, gamma)
    q = (xn @ wq.to(dtype).t()).unflatten(-1, (h, dh))
    kv = x @ wkv.to(dtype).t()
    k = kv[..., : h * dh].unflatten(-1, (h, dh))
    v = kv[..., h * dh:].unflatten(-1, (h, dh))
    q = (l2norm(q.float()) * q_scale.float() * scale).to(dtype)
    k = (l2norm(k.float()) * k_scale.float()).to(dtype)
    sim = torch.einsum("...ihd,...jhd->...hij", q.float(), k.float())
    if bias is not None:
        sim = sim + bias.float()
    attn = sim.softmax(dim=-1).to(dtype)
    out = torch.einsum("...hij,...jhd->...ihd", attn, v).flatten(-2)
    return ((out @ wout.to(dtype).t()).float() + x.float()).to(dtype)


def grid_qknorm_attention_plain(x, gamma, wq, wkv, q_scale, k_scale, wout,
                                heads: int, dim_head: int,
                                scale: float = 8.0) -> torch.Tensor:
    """Plain version on the (b, t, S, dim) grid: attend along t."""
    out = qknorm_attention_plain(x.transpose(1, 2), gamma, wq, wkv, q_scale,
                                 k_scale, wout, None, heads, dim_head, scale)
    return out.transpose(1, 2).contiguous()


def _qknorm_attention_cuda(x, gamma, wq, wkv, q_scale, k_scale, wout, bias,
                           heads, dim_head, scale, grid: bool):
    bf = torch.bfloat16
    dim = x.shape[-1]
    hd = heads * dim_head
    if wq.shape != (hd, dim) or wkv.shape != (2 * hd, dim) \
            or wout.shape != (dim, hd):
        raise ValueError("attention weights do not fit dim/heads/dim_head")
    x2 = x.view(-1, dim)
    rows = x2.shape[0]
    xn = torch.empty_like(x2)
    K.layernorm(x2, gamma, None, 1e-5, xn)
    q = torch.empty((rows, hd), dtype=bf, device=x.device)
    K.gemm(K.EPI_STORE, xn, wq.to(bf).contiguous(), q)
    kv = torch.empty((rows, 2 * hd), dtype=bf, device=x.device)
    K.gemm(K.EPI_STORE, x2, wkv.to(bf).contiguous(), kv)
    merged = torch.empty_like(q)
    if grid:  # sequence (b, s) holds tokens x[b, :, s]
        b, n, S, _ = x.shape
        sequences, inner = b * S, S
        q_strides = (n * S * hd, hd, dim_head, S * hd)
        kv_strides = (n * S * 2 * hd, 2 * hd, dim_head, S * 2 * hd)
    else:
        b, n, _ = x.shape
        sequences, inner = b, 1
        q_strides = (n * hd, 0, dim_head, hd)
        kv_strides = (n * 2 * hd, 0, dim_head, 2 * hd)
    K.attention(q, kv, kv[:, hd:], merged, sequences=sequences, inner=inner,
                heads=heads, n=n, d=dim_head, q_strides=q_strides,
                kv_strides=kv_strides, q_scale=q_scale.float() * scale,
                k_scale=k_scale,
                bias=None if bias is None else bias.float().contiguous(),
                bias_mode=0 if bias is None else 1,
                warps=8 if n >= 128 else 2)
    out = torch.empty_like(x2)
    K.gemm(K.EPI_RESIDUAL, merged, wout.to(bf).contiguous(), out, residual=x2)
    return out.view(x.shape)


def fused_spatial_qknorm_attention(x, gamma, wq, wkv, q_scale, k_scale, wout,
                                   bias: Optional[torch.Tensor], heads: int,
                                   dim_head: int, scale: float = 8.0) -> torch.Tensor:
    """(b, n, dim) sequences; bias (heads, n, n) f32 or None.  Returns
    x + attention(x)."""
    if x.device.type == "cpu":
        return qknorm_attention_plain(x, gamma, wq, wkv, q_scale, k_scale,
                                      wout, bias, heads, dim_head, scale)
    out = _qknorm_attention_cuda(x.contiguous(), gamma, wq, wkv, q_scale,
                                 k_scale, wout, bias, heads, dim_head, scale,
                                 grid=False)
    K.count_launch("spatial_attention")
    return out


def fused_grid_qknorm_attention(x, gamma, wq, wkv, q_scale, k_scale, wout,
                                heads: int, dim_head: int,
                                scale: float = 8.0) -> torch.Tensor:
    """(b, t, S, dim) grid; each of the b*S columns is a t-token sequence.
    Returns x + attention(x)."""
    if x.device.type == "cpu":
        return grid_qknorm_attention_plain(x, gamma, wq, wkv, q_scale,
                                           k_scale, wout, heads, dim_head, scale)
    out = _qknorm_attention_cuda(x.contiguous(), gamma, wq, wkv, q_scale,
                                 k_scale, wout, None, heads, dim_head, scale,
                                 grid=True)
    K.count_launch("grid_attention")
    return out
