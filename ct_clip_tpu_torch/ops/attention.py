"""Attention blocks of the CTViT encoder and the BERT attention core.

Ports of ct_clip_tpu/ops/attention.py:
  * `ContinuousPositionBias` (:147-186): MLP over the (2h-1)(2w-1) distinct
    log-distance offsets, then a gather to the (heads, N, N) bias.  Plain
    torch (the JAX package runs it in XLA), computed once per weight load;
  * `PEG` (:439-498), including `rotated=True`: the depthwise 3x3x3 conv with
    causal frame padding.  The JAX package runs it as an XLA grouped conv
    (ops/pallas/peg.py::lax_peg_conv), so here it is `F.conv3d(groups=c)`.
    Its backward (`peg_conv`, an autograd.Function) ports peg.py::_peg_bwd:
    dx is the depthwise conv of dout with the flipped kernel and complemented
    pads (lax_peg_dx, a conv in JAX too), dW and db are the port of K14
    (_pallas_peg_bwd, csrc/peg_bwd.cu; plain version `peg_dw_plain`);
  * `QKNormAttention` and `MaskgitTransformer` (:501-583) for the encoder:
    PEG -> attention -> feed-forward per layer, residuals folded into the
    sublayer kernels, final gamma LayerNorm;
  * `fused_attention`, the port of ops/pallas/attention.py::fused_attention
    (K7): softmax(q k^T + bias + key_bias) v on (b, h, n, d), with its
    backward (K12, key-bias form) as an autograd.Function;
  * `fused_attention_kbias_dropout` (K13, forward and backward): the same
    with dropout on the probabilities from a Philox mask.

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


# ------------------------------------------------- K7, K12 and K13 ports
def attention_plain(q, k, v, bias: Optional[torch.Tensor] = None,
                    key_bias: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `_xla_attention`: (b, h, n, d) q, k, v; bias
    broadcastable to (b, h, n, n); key_bias (b, n); f32 scores.  `mask`
    (b, h, n, n), the scaled dropout mask, multiplies the probabilities
    (`_kernel_kbias_drop`)."""
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    if bias is not None:
        sim = sim + bias.float()
    if key_bias is not None:
        sim = sim + key_bias.float()[:, None, None, :]
    attn = sim.softmax(dim=-1)
    if mask is not None:
        attn = attn * mask
    return torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)


def attention_bwd_plain(q, k, v, dout, bias=None, key_bias=None, mask=None):
    """Plain PyTorch version of the K12/K13 backwards (`_bwd_kernel_kbias`,
    `_bwd_kernel_kbias_drop`): recompute the probabilities, then
    dS = P (M dO v^T - rowsum(P M dO v^T)).  Returns dq, dk, dv, dbias (summed
    to bias's shape) and dkey_bias (b, n) (summed over heads and query rows),
    the last two None without their bias."""
    f32 = [t.float() for t in (q, k, v, dout)]
    qf, kf, vf, gf = f32
    sim = torch.einsum("bhid,bhjd->bhij", qf, kf)
    if bias is not None:
        sim = sim + bias.float()
    if key_bias is not None:
        sim = sim + key_bias.float()[:, None, None, :]
    attn = sim.softmax(dim=-1)
    dattn = torch.einsum("bhid,bhjd->bhij", gf, vf)
    kept = attn
    if mask is not None:
        kept, dattn = attn * mask, dattn * mask
    row = (dattn * attn).sum(dim=-1, keepdim=True)
    ds = attn * (dattn - row)
    dq = torch.einsum("bhij,bhjd->bhid", ds, kf).to(q.dtype)
    dk = torch.einsum("bhij,bhid->bhjd", ds, qf).to(k.dtype)
    dv = torch.einsum("bhij,bhid->bhjd", kept, gf).to(v.dtype)
    dbias = dkb = None
    if bias is not None:
        dbias = ds.sum_to_size(bias.shape).to(bias.dtype)
    if key_bias is not None:
        dkb = ds.sum(dim=(1, 2)).to(key_bias.dtype)
    return dq, dk, dv, dbias, dkb


# The TPU draws dropout bits from its hardware generator; the port draws
# Philox4x32-10 (Salmon et al., SC'11) keyed on the seed, with the counter
# (batch row, head, query i, key j // 4), word j % 4 being element (i, j)'s,
# in csrc/attention_train.cu.  The functions below compute the same bits.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 `a` holding uint32 values,
    from 16-bit halves of m so that no int64 product overflows."""
    p_lo = a * (m & 0xFFFF)                       # < 2^48
    p_hi = a * (m >> 16)                          # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)            # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _U32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counters (int64 tensors of uint32 values, any
    broadcastable shapes) under the key (k0, k1): four uint32 words as int64
    tensors."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _seed_value(seed) -> int:
    return int(seed.reshape(-1)[0].item() if isinstance(seed, torch.Tensor) else seed)


def dropout_threshold(rate: float) -> int:
    """Keep iff bits >= this (`_drop_mask`, ops/pallas/attention.py:406)."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to f32, as the TPU kernel multiplies it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_mask(seed, b: int, h: int, n: int, rate: float,
                 device=None) -> torch.Tensor:
    """The (b, h, n, n) f32 dropout mask of K13: 1 / (1 - rate) where the
    Philox bits of (seed; batch row, head, i, j // 4) are >= the threshold,
    else 0.  Identical to the mask the CUDA kernels regenerate."""
    s = _seed_value(seed)
    i64 = dict(dtype=torch.int64, device=device)
    n4 = (n + 3) // 4
    words = philox4x32(torch.arange(b, **i64)[:, None, None, None],
                       torch.arange(h, **i64)[None, :, None, None],
                       torch.arange(n, **i64)[None, None, :, None],
                       torch.arange(n4, **i64)[None, None, None, :],
                       s & _U32, (s >> 32) & _U32)
    words = [w.expand(b, h, n, n4) for w in words]
    bits = torch.stack(words, dim=-1).reshape(b, h, n, 4 * n4)[..., :n]
    keep = bits >= dropout_threshold(rate)
    return keep.to(torch.float32) * dropout_keep_scale(rate)


def attention_dropout_plain(q, k, v, key_bias, seed, rate: float) -> torch.Tensor:
    """Plain PyTorch version of K13's forward (`_kernel_kbias_drop`)."""
    b, h, n, _ = q.shape
    return attention_plain(q, k, v, key_bias=key_bias,
                           mask=dropout_mask(seed, b, h, n, rate, q.device))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t with a contiguous last dim, as the kernels address rows."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch_train_fwd(q, k, v, key_bias, seed=None, rate=0.0):
    """Forward kernel (attention_train.cu, f32 or bf16): (out, lse)."""
    b, h, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: q, k, v shapes differ")
    q, k, v = map(_rows, (q, k, v))
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    thresh = dropout_threshold(rate) if rate > 0 else 0
    K.attention_train_fwd(
        q, k, v, out, lse,
        key_bias=None if key_bias is None else key_bias.float().contiguous(),
        seed=seed, thresh=thresh, keep_scale=dropout_keep_scale(rate) if thresh else 1.0)
    return out, lse


class _FusedAttention(torch.autograd.Function):
    """K7 forward, K12 backward.  On the CPU both are the plain versions; on
    CUDA (f32 or bf16) the key-tiled kernels of attention_train.cu, the
    backward reading the forward's row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_bias):
        if bias is not None and key_bias is not None:
            raise ValueError("fused_attention: bias and key_bias are exclusive")
        lse = None
        if q.device.type == "cpu":
            out = attention_plain(q, k, v, bias, key_bias)
        elif bias is not None:
            raise NotImplementedError("fused_attention: the kernels take a per-key bias "
                                      "only (the dense-bias backward, K12b, is not "
                                      "ported)")
        else:
            out, lse = _launch_train_fwd(q, k, v, key_bias)
            K.count_launch("fused_attention")
        ctx.save_for_backward(q, k, v, bias, key_bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, key_bias, out, lse = ctx.saved_tensors
        need_db, need_dkb = ctx.needs_input_grad[3:5]
        if q.device.type == "cpu":
            dq, dk, dv, db, dkb = attention_bwd_plain(q, k, v, dout, bias, key_bias)
            return dq, dk, dv, db if need_db else None, dkb if need_dkb else None
        dq, dk, dv, dkb = K.attention_train_bwd(
            *map(_rows, (q, k, v, out, dout.to(q.dtype))), lse,
            key_bias=None if key_bias is None else key_bias.float().contiguous(),
            want_dkey_bias=need_dkb)
        K.count_launch("attention_bwd")
        return dq, dk, dv, None, None if dkb is None else dkb.to(key_bias.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T + bias + key_bias[:, None, None]) v on (b, h, n, d),
    any scaling already applied to q.  bias (1, 1|h, n, n) and key_bias
    (b, n) are mutually exclusive; on CUDA only key_bias (or none) is taken.
    Differentiable: the backward is the port of K12 (key-bias or no bias,
    f32 or bf16, on CUDA)."""
    return _FusedAttention.apply(q, k, v, bias, key_bias)


def _seed_tensor(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(device=device, dtype=torch.int64)
    return torch.tensor([int(seed)], dtype=torch.int64, device=device)


class _FusedAttentionDropout(torch.autograd.Function):
    """K13 forward and backward: key-bias attention with dropout on the
    probabilities, the mask regenerated from the seed in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, rate):
        if q.device.type == "cpu":
            out, lse = attention_dropout_plain(q, k, v, key_bias, seed, rate), None
        else:
            seed = _seed_tensor(seed, q.device)
            out, lse = _launch_train_fwd(q, k, v, key_bias, seed, rate)
            K.count_launch("attention_dropout")
        ctx.rate, ctx.seed = rate, seed
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        rate, seed = ctx.rate, ctx.seed
        if q.device.type == "cpu":
            b, h, n, _ = q.shape
            dq, dk, dv, _, dkb = attention_bwd_plain(
                q, k, v, dout, key_bias=key_bias,
                mask=dropout_mask(seed, b, h, n, rate, q.device))
        else:
            thresh = dropout_threshold(rate)
            dq, dk, dv, dkb = K.attention_train_bwd(
                *map(_rows, (q, k, v, out, dout.to(q.dtype))), lse,
                key_bias=key_bias.float().contiguous(),
                want_dkey_bias=ctx.needs_input_grad[3], seed=seed,
                thresh=thresh, keep_scale=dropout_keep_scale(rate))
            K.count_launch("attention_dropout_bwd")
            if dkb is not None:
                dkb = dkb.to(key_bias.dtype)
        return dq, dk, dv, dkb if ctx.needs_input_grad[3] else None, None, None


def fused_attention_kbias_dropout(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, key_bias: torch.Tensor,
                                  seed, rate: float) -> torch.Tensor:
    """softmax(q k^T + key_bias) with dropout on the probabilities at `rate`
    in [0, 1), then @ v (ops/pallas/attention.py::
    fused_attention_kbias_dropout).  q, k, v: (b, h, n, d) f32, scaling
    applied to q; key_bias: (b, n); seed: an int or a (1,) integer tensor
    (on q's device it is read by the kernel without a host sync).  The mask
    is Philox bits of (seed; batch row, head, i, j // 4), the same on the
    CPU and the card and in forward and backward."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return _FusedAttentionDropout.apply(q, k, v, key_bias, seed, rate)


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


def _peg_geometry(weight: torch.Tensor, rotated: bool):
    """The conv weight as applied, (c, 1, kt, kh, kw), and the F.pad list
    (w0, w1, h0, h1, t0, t1): causal frames, or with rotated=True the
    kernel's tap axes rotated (t, h, w) -> (h, w, t) and the causal pad on
    h (ct_clip_tpu/ops/pallas/peg.py::_pads, causal_axis 1)."""
    if rotated:  # K_r[a, b, c] = K[b, c, a]
        return weight.permute(0, 1, 4, 2, 3), [1, 1, 2, 0, 1, 1]
    return weight, [1, 1, 1, 1, 2, 0]


def _depthwise(x: torch.Tensor, w: torch.Tensor, pad) -> torch.Tensor:
    """Depthwise conv of the channels-last (b, t, h, w, c) x, padded by the
    F.pad list `pad`; channels-last out."""
    xc = x.permute(0, 4, 1, 2, 3)
    return F.conv3d(F.pad(xc, pad), w, groups=x.shape[-1]).permute(0, 2, 3, 4, 1)


def peg_dw_plain(x: torch.Tensor, dout: torch.Tensor, pads) -> torch.Tensor:
    """Plain version of K14 (`_dw_kernel`): (28, c) f32, rows 0-26 the
    weight gradient of tap (kz * 3 + ky) * 3 + kx, row 27 the bias gradient,
    of a depthwise conv over x (b, t, h, w, c) with leading pads `pads`
    (t, h, w): 27 shifted multiply-reduce taps in f32."""
    b, t, h, w, c = x.shape
    (p0, p1, p2) = pads
    xp = F.pad(x.float(), (0, 0, p2, 2 - p2, p1, 2 - p1, p0, 2 - p0))
    g = dout.float()
    rows = []
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                rows.append((xp[:, kz:kz + t, ky:ky + h, kx:kx + w] * g).sum(dim=(0, 1, 2, 3)))
    rows.append(g.sum(dim=(0, 1, 2, 3)))
    return torch.stack(rows)


def peg_dw(x: torch.Tensor, dout: torch.Tensor, pads) -> torch.Tensor:
    """K14: the (28, c) weight and bias gradients of `peg_dw_plain`; a CPU
    tensor takes the plain version, a CUDA tensor must be bf16 and takes the
    kernel (csrc/peg_bwd.cu)."""
    if x.device.type == "cpu":
        return peg_dw_plain(x, dout, pads)
    out = K.peg_dw(x.contiguous(), dout.contiguous(), pads)
    K.count_launch("peg_bwd")
    return out


class _PEGConv(torch.autograd.Function):
    """x + depthwise conv(x) + bias; the weight and bias stay f32 here, so
    their gradients are not rounded to the compute dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, rotated):
        ctx.rotated = rotated
        ctx.save_for_backward(x, weight)
        w, pad = _peg_geometry(weight.to(x.dtype), rotated)
        return _depthwise(x, w, pad) + x + bias.to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, weight = ctx.saved_tensors
        c = x.shape[-1]
        w, pad = _peg_geometry(weight.to(x.dtype), ctx.rotated)
        dout = dout.to(x.dtype).contiguous()
        # dx: correlation with the flipped kernel, pads complemented, plus
        # the residual's identity term (peg.py::lax_peg_dx)
        dx = _depthwise(dout, w.flip(2, 3, 4), [2 - p for p in pad]) + dout
        dwb = peg_dw(x, dout, (pad[4], pad[2], pad[0]))
        dw = dwb[:27].t().reshape(c, 1, 3, 3, 3)
        if ctx.rotated:  # back from the rotated taps: dK[b, c, a] = dK_r[a, b, c]
            dw = dw.permute(0, 1, 3, 4, 2)
        return dx, dw.to(weight.dtype), dwb[27].to(weight.dtype), None


def peg_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             rotated: bool = False) -> torch.Tensor:
    """x + conv(x) + bias for the channels-last (b, t, h, w, c) x and the
    Conv3d weight (c, 1, 3, 3, 3) and bias (c,), causal frame pad (or the
    rotated form, `_peg_geometry`).  Differentiable: dW and db are the port
    of K14 on CUDA, its plain version on the CPU."""
    return _PEGConv.apply(x, weight, bias, rotated)


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
        if rotated and not x.shape[1] == x.shape[2] == x.shape[3]:
            raise ValueError("rotated PEG needs a cubic grid")
        return peg_conv(x, self.dsconv.weight, self.dsconv.bias, rotated)


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
