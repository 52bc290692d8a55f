"""Attention blocks of the CTViT encoder and the BERT attention core.

Ports of ct_clip_tpu/ops/attention.py:
  * `ContinuousPositionBias` (:147-186): MLP over the prod(2d-1) distinct
    log-distance offsets of a 2-D (CTViT) or 3-D (MaskGIT) grid, then a
    gather to the (heads, N, N) bias.  Plain torch (the JAX package runs it
    in XLA), computed once per weight load in inference;
  * `PEG` (:439-498), including `rotated=True`: the depthwise 3x3x3 conv with
    causal frame padding (or, for MaskGIT, a pad of 1 on every side).  The JAX package runs it as an XLA grouped conv
    (ops/pallas/peg.py::lax_peg_conv), so here it is `F.conv3d(groups=c)`.
    Its backward (`peg_conv`, an autograd.Function) ports peg.py::_peg_bwd:
    dx is the depthwise conv of dout with the flipped kernel and complemented
    pads (lax_peg_dx, a conv in JAX too), dW and db are the port of K14
    (_pallas_peg_bwd, csrc/peg_bwd.cu; plain version `peg_dw_plain`);
  * `QKNormAttention` and `MaskgitTransformer` (:224-384, :501-583) for the
    CTViT encoder and decoder and for MaskGIT: PEG -> attention -> (cross
    attention) -> feed-forward per layer, residuals folded into the
    sublayers, final gamma LayerNorm.  The CTViT's attention takes the
    spatial sublayer (K1, with the CPB bias), the temporal one on the native
    grid (K2 grid) or, for a non-cubic token grid, on (b*h*w, t, d)
    sequences (K2 seq, the small-sequence dispatch of ops/attention.py:
    276-293), where the sublayers fit; a mask, a context, null key/values or
    a sequence too long for them (MaskGIT's) take the generic path through
    `sdpa` (:189-221);
  * `fused_attention`, the port of ops/pallas/attention.py::fused_attention
    (K7): softmax(q k^T + bias + key_bias) v on (b, h, n, d), with its
    backward as an autograd.Function: K12a with a key bias, K12b with a
    dense (1, 1|h, n, n) bias (its gradient summed over the batch) or none.
    On CUDA `attention_route` picks the forward's and the backward's source:
    bf16 at d 64 runs both on the tensor cores (csrc/attention_tc.cu); f32
    at d 64 runs its backward, any bias form, on the tensor cores in 3xTF32
    (csrc/attention_tc32.cu) and its forward on the CUDA cores
    (csrc/attention_train.cu); other head dims run both on the CUDA cores.
    A dense bias together
    with a key bias is XLA in the JAX package (`_xla_attention`), so here it
    is `attention_plain` on every device, differentiated by autograd;
  * `fused_attention_kbias_dropout` (K13, forward and backward): the same
    with dropout on the probabilities from a Philox mask; on CUDA at d 64
    its backward (K13b) runs on attention_tc.cu in bf16, on
    attention_tc32.cu in f32, and its forward (K13a) on attention_tc.cu in
    bf16, on attention_train.cu in f32, each drawing the same mask; other
    head dims run both on attention_train.cu.

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
from .norms import l2norm, layer_norm
from .qknorm_attention import (fused_grid_qknorm_attention,
                               fused_small_qknorm_attention,
                               fused_spatial_qknorm_attention, sublayer_fits)


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
# in csrc/common.cuh.  The functions below compute the same bits.
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


dropout_threshold, dropout_keep_scale = K.dropout_threshold, K.dropout_keep_scale


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
    return t if t.stride()[-1] == 1 else t.contiguous()


def _launch_train_fwd(q, k, v, key_bias, seed=None, rate=0.0, bias=None,
                      for_backward: bool = False):
    """Forward kernel (attention_train.cu, f32 or bf16): (out, lse, out32);
    `bias` a contiguous (1|h, n, n) f32 dense bias or None.  With
    `for_backward` (attention_train.cu's backward follows) a bf16 forward
    also writes out32, out in f32, from which that backward's D_i = dO_i .
    O_i is summed in f32 as the TPU kernels sum P dP (ops/pallas/
    attention.py:191); else out32 is None.  attention_tc.cu's backward sums
    D_i from its own f32 P and dP and needs no out32."""
    b, h, n, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: q, k, v shapes differ")
    q, k, v = map(_rows, (q, k, v))
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    out32 = (torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
             if for_backward and q.dtype == torch.bfloat16 else None)
    thresh = dropout_threshold(rate) if rate > 0 else 0
    K.attention_train_fwd(
        q, k, v, out, lse, out32=out32,
        key_bias=None if key_bias is None else key_bias.float().contiguous(),
        bias=bias, seed=seed, thresh=thresh,
        keep_scale=dropout_keep_scale(rate) if thresh else 1.0)
    return out, lse, out32


TC, TC32, TRAIN = "attention_tc", "attention_tc32", "attention_train"
BIAS_FORMS = ("none", "key", "dense")


def attention_route(dtype: torch.dtype, head_dim: int, bias_form: str,
                    dropout: bool) -> Tuple[str, str]:
    """The CUDA sources (forward, backward) of a fused attention call: TC
    (attention_tc.cu, bf16 on the tensor cores), TC32 (attention_tc32.cu,
    f32 on the tensor cores in 3xTF32) or TRAIN (attention_train.cu, the
    CUDA cores).  `bias_form` is "none", "key" (a (b, n) per-key bias) or
    "dense" (a (1, 1|h, n, n) bias); `dropout` K13's (with a key bias).

    | call                                       | forward | backward |
    | bf16, d 64, any bias form, dropout or not  | TC      | TC       |
    | f32, d 64, any bias form, dropout or not   | TRAIN   | TC32     |
    | d != 64                                    | TRAIN   | TRAIN    |

    TC32 (K12a, K12b dense or with no bias, K13b) reads D_i = dO . O from
    the f32 forward's output, which K7 f32 and K13a f32 write in true f32 on
    the CUDA cores."""
    if bias_form not in BIAS_FORMS:
        raise ValueError(f"attention_route: bias form {bias_form!r} not in {BIAS_FORMS}")
    if head_dim != K.TC_HEAD_DIM:
        return TRAIN, TRAIN
    if dtype == torch.bfloat16:
        return TC, TC
    return TRAIN, TC32


def backward_counters(source: str, bias_form: str, dropout: bool) -> Tuple[str, ...]:
    """The launch counters a fused attention backward on `source` (TC,
    TC32 or TRAIN) adds one to: the tensor-core source's own
    (`attention_tc_bwd`, `attention_tc32_bwd`; none for TRAIN), then the
    function's, the same on every route: K13b `attention_dropout_bwd`, K12a
    `attention_bwd` (a key bias), K12b `attention_dense_bwd` (a dense bias
    or none)."""
    own = {TC: ("attention_tc_bwd",), TC32: ("attention_tc32_bwd",), TRAIN: ()}[source]
    if dropout:
        return own + ("attention_dropout_bwd",)
    return own + ("attention_bwd" if bias_form == "key" else "attention_dense_bwd",)


def _tc_operand(t: torch.Tensor) -> torch.Tensor:
    """t as attention_tc.cu / attention_tc32.cu address it, or a contiguous
    copy of it where a stride is not a multiple of 16 bytes or the base is
    off 16 bytes."""
    return t if K.tc_addressable(t) else t.contiguous()


def _launch_tc_fwd(q, k, v, key_bias, bias=None, seed=None, rate=0.0):
    """Forward kernel on the tensor cores (attention_tc.cu, bf16, d 64):
    (out, lse); `bias` a contiguous (1|h, n, n) f32 dense bias or None;
    `seed` and `rate` > 0 K13a's dropout.  `out` takes q's strides
    (empty_like of an addressable view), so merging the heads back is free."""
    q, k, v = map(_tc_operand, (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    K.attention_tc_fwd(q, k, v, out, lse,
                       key_bias=None if key_bias is None else key_bias.float().contiguous(),
                       bias=bias, seed=seed, rate=rate)
    return out, lse


def _dense_bias(bias: torch.Tensor) -> torch.Tensor:
    """The kernels' (1|h, n, n) f32 contiguous form of a (1, 1|h, n, n)
    dense bias, the one bias shape K7 dense and K12b take (batch 1:
    ops/pallas/attention.py::_plan); the binding checks the rest."""
    if bias.dim() != 4 or bias.shape[0] != 1:
        raise ValueError(f"fused_attention: the kernels take a (1, 1|h, n, n) bias, "
                         f"got {tuple(bias.shape)}")
    return bias[0].float().contiguous()


def _tc_bwd_operands(q, k, v, dout):
    """q, k, v and dout (cast to q's dtype) as attention_tc.cu's backward
    addresses them (`_tc_operand`)."""
    return tuple(map(_tc_operand, (q, k, v, dout.to(q.dtype))))


def _float_key_bias(key_bias):
    return None if key_bias is None else key_bias.float().contiguous()


class _FusedAttention(torch.autograd.Function):
    """K7 forward, K12 backward (K12a with a key bias, K12b with a dense bias
    or none).  On the CPU both are the plain versions; on CUDA the sources
    `attention_route` picks: attention_tc.cu (bf16, d 64, wgmma) for both;
    in f32 at d 64 the key-tiled forward of attention_train.cu and the
    3xTF32 backward of attention_tc32.cu (D_i from the forward's f32
    output), any bias form; else attention_train.cu for both.  Each
    backward reads the forward's row log-sum-exp (and, on
    attention_train.cu in bf16, its f32 output); a dense bias stays f32 in
    both dtypes.  The counters name the function (`fused_attention`,
    `attention_dense`, `attention_bwd` for K12a, `attention_dense_bwd` for
    K12b, dense or with no bias, on every route) and, on the tensor cores,
    the source (`attention_tc`, `attention_tc_bwd`, `attention_tc32_bwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, key_bias):
        lse = kbias = out32 = None
        ctx.route = None
        if q.device.type == "cpu":
            out = attention_plain(q, k, v, bias, key_bias)
        else:
            if bias is not None:
                kbias = _dense_bias(bias)
            form = "dense" if bias is not None else "none" if key_bias is None else "key"
            ctx.route = attention_route(q.dtype, q.shape[-1], form, False)
            ctx.counters = backward_counters(ctx.route[1], form, False)
            if ctx.route[0] == TC:
                out, lse = _launch_tc_fwd(q, k, v, key_bias, bias=kbias)
                K.count_launch("attention_tc")
            else:
                out, lse, out32 = _launch_train_fwd(
                    q, k, v, key_bias, bias=kbias,
                    for_backward=any(ctx.needs_input_grad) and ctx.route[1] == TRAIN)
            K.count_launch("fused_attention" if bias is None else "attention_dense")
        ctx.save_for_backward(q, k, v, bias, key_bias, out, lse, kbias, out32)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, key_bias, out, lse, kbias, out32 = ctx.saved_tensors
        need_db, need_dkb = ctx.needs_input_grad[3:5]
        if q.device.type == "cpu":
            dq, dk, dv, db, dkb = attention_bwd_plain(q, k, v, dout, bias, key_bias)
            return dq, dk, dv, db if need_db else None, dkb if need_dkb else None
        if ctx.route[1] == TC:
            dq, dk, dv, db, dkb = K.attention_tc_bwd(
                *_tc_bwd_operands(q, k, v, dout), lse, bias=kbias, want_dbias=need_db,
                key_bias=_float_key_bias(key_bias), want_dkey_bias=need_dkb)
        elif ctx.route[1] == TC32:
            dq, dk, dv, db, dkb = K.attention_tc32_bwd(
                *map(_tc_operand, (q, k, v, out, dout.to(q.dtype))), lse, bias=kbias,
                want_dbias=need_db, key_bias=_float_key_bias(key_bias), want_dkey_bias=need_dkb)
        else:
            dq, dk, dv, dkb, db = K.attention_train_bwd(
                *map(_rows, (q, k, v, out, dout.to(q.dtype))), lse, out32=out32,
                key_bias=_float_key_bias(key_bias), want_dkey_bias=need_dkb, bias=kbias,
                want_dbias=need_db)
        for name in ctx.counters:
            K.count_launch(name)
        return (dq, dk, dv, None if db is None else db.reshape(bias.shape).to(bias.dtype),
                None if dkb is None else dkb.to(key_bias.dtype))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    key_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T + bias + key_bias[:, None, None]) v on (b, h, n, d),
    any scaling already applied to q; bias (1, 1|h, n, n) (any shape
    broadcastable to (b, h, n, n) on the CPU),
    key_bias (b, n).  Differentiable: the backward is the port of K12a
    with a key bias or of K12b with a dense bias or none, whose dbias is
    summed over the batch (and the heads for a one-head bias); f32 or bf16
    on CUDA, the source picked by `attention_route`.  Both biases together
    take `attention_plain` and autograd on every device, as the JAX package
    takes XLA there (ops/pallas/attention.py:347-350)."""
    if bias is not None and key_bias is not None:
        return attention_plain(q, k, v, bias, key_bias)
    return _FusedAttention.apply(q, k, v, bias, key_bias)


# -f32 max, the masked-score fill of the JAX package (ops/attention.py:33)
NEG_INF = -3.4028234663852886e38


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
         causal: bool = False) -> torch.Tensor:
    """The shared softmax(q k^T + bias) v core of ct_clip_tpu/ops/attention.py
    ::_sdpa on (b, h, n, d), scaling applied to q.  Without a mask and with
    equal query and key lengths: `fused_attention` (K7 / K7 dense, K12a /
    K12b).  With a (b, j) key mask (True attends) or unequal lengths (cross
    attention): plain PyTorch on every device, f32 scores, masked scores set
    to -f32 max, f32 softmax, as the JAX package's XLA branch.  Causal
    attention (with ALiBi) belongs to the fallback towers, not ported."""
    if causal:
        raise NotImplementedError("sdpa: causal attention (the fallback towers) is not ported")
    if mask is None and q.shape[-2] == k.shape[-2]:
        return fused_attention(q, k, v, bias)
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    if bias is not None:
        sim = sim + bias.float()
    if mask is not None:
        sim = torch.where(mask[:, None, None, :], sim, NEG_INF)
    attn = sim.softmax(dim=-1).to(v.dtype)
    return torch.einsum("bhij,bhjd->bhid", attn, v)


def _seed_tensor(seed, device) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.reshape(1).to(device=device, dtype=torch.int64)
    return torch.tensor([int(seed)], dtype=torch.int64, device=device)


class _FusedAttentionDropout(torch.autograd.Function):
    """K13 forward and backward: key-bias attention with dropout on the
    probabilities, the mask regenerated from the seed in the backward.  On
    CUDA `attention_route` picks: in bf16 at d 64 attention_tc.cu for both
    (K13a, K13b; no f32 output kept); in f32 at d 64 attention_train.cu's
    forward and attention_tc32.cu's 3xTF32 backward (D_i from the forward's
    f32 output); else attention_train.cu for both, whose backward reads the
    forward's f32 output in bf16.  Counters: `attention_dropout`,
    `attention_dropout_bwd` and, on the tensor cores, `attention_tc`,
    `attention_tc_bwd` and `attention_tc32_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, seed, rate):
        ctx.route = None
        out32 = None
        if q.device.type == "cpu":
            out, lse = attention_dropout_plain(q, k, v, key_bias, seed, rate), None
        else:
            seed = _seed_tensor(seed, q.device)
            ctx.route = attention_route(q.dtype, q.shape[-1], "key", True)
            ctx.counters = backward_counters(ctx.route[1], "key", True)
            if ctx.route[0] == TC:
                out, lse = _launch_tc_fwd(q, k, v, key_bias, seed=seed, rate=rate)
                K.count_launch("attention_tc")
            else:
                out, lse, out32 = _launch_train_fwd(
                    q, k, v, key_bias, seed, rate,
                    for_backward=any(ctx.needs_input_grad) and ctx.route[1] == TRAIN)
            K.count_launch("attention_dropout")
        ctx.rate, ctx.seed = rate, seed
        ctx.save_for_backward(q, k, v, key_bias, out, lse, out32)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_bias, out, lse, out32 = ctx.saved_tensors
        rate, seed = ctx.rate, ctx.seed
        need_dkb = ctx.needs_input_grad[3]
        if q.device.type == "cpu":
            b, h, n, _ = q.shape
            dq, dk, dv, _, dkb = attention_bwd_plain(
                q, k, v, dout, key_bias=key_bias,
                mask=dropout_mask(seed, b, h, n, rate, q.device))
        elif ctx.route[1] == TC:
            dq, dk, dv, _, dkb = K.attention_tc_bwd(
                *_tc_bwd_operands(q, k, v, dout), lse, key_bias=_float_key_bias(key_bias),
                want_dkey_bias=need_dkb, seed=seed, rate=rate)
        elif ctx.route[1] == TC32:
            dq, dk, dv, _, dkb = K.attention_tc32_bwd(
                *map(_tc_operand, (q, k, v, out, dout.to(q.dtype))), lse,
                key_bias=_float_key_bias(key_bias), want_dkey_bias=need_dkb, seed=seed,
                rate=rate)
        else:
            dq, dk, dv, dkb, _ = K.attention_train_bwd(
                *map(_rows, (q, k, v, out, dout.to(q.dtype))), lse, out32=out32,
                key_bias=_float_key_bias(key_bias), want_dkey_bias=need_dkb, seed=seed,
                thresh=dropout_threshold(rate), keep_scale=dropout_keep_scale(rate))
        if ctx.route is not None:  # a kernel ran
            for name in ctx.counters:
                K.count_launch(name)
        if dkb is not None:
            dkb = dkb.to(key_bias.dtype)
        return dq, dk, dv, dkb if need_dkb else None, None, None


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


class LeakyReLU(nn.Module):
    """leaky ReLU as jax.nn.leaky_relu: where(x >= 0, x, slope x), so its
    derivative at 0 is 1 (torch's is the slope).  The CPB MLP meets exact
    zeros: the zero offset's input row at zero first-layer biases."""

    def __init__(self, slope: float = 0.1):
        super().__init__()
        self.slope = slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.slope)


class ContinuousPositionBias(nn.Module):
    """SwinV2 continuous position bias over a `num_dims`-D grid (2: the
    CTViT's planes; 3: MaskGIT's (t, h, w) token grid), layers=2, log
    distance, MLP width `dim` (transformer_maskgit/attention.py:229-276).
    The MLP runs over the distinct offsets only, in f32, then gathers to
    the (heads, N, N) bias; its gradient is autograd of the gather (the JAX
    package's `_cpb_expand` VJP sums the same terms in another order)."""

    def __init__(self, dim: int, heads: int, num_dims: int = 2, device=None):
        super().__init__()
        self.num_dims = num_dims
        self.net = nn.ModuleList([
            nn.Sequential(nn.Linear(num_dims, dim, device=device), LeakyReLU(0.1)),
            nn.Sequential(nn.Linear(dim, dim, device=device), LeakyReLU(0.1)),
            nn.Linear(dim, heads, device=device)])

    @staticmethod
    def _tables(*dims: int) -> Tuple[np.ndarray, np.ndarray]:
        """The signed-log distinct offsets (prod(2d - 1), nd) and the (N, N)
        index of each pair's offset (ops/attention.py::_cpb_index_map)."""
        offsets = [np.arange(-(d - 1), d) for d in dims]
        uniq = np.stack(np.meshgrid(*offsets, indexing="ij"),
                        axis=-1).reshape(-1, len(dims)).astype(np.float32)
        uniq = np.sign(uniq) * np.log(np.abs(uniq) + 1.0)
        pos = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"),
                       axis=-1).reshape(-1, len(dims))
        rel = pos[:, None, :] - pos[None, :, :]
        idx = np.zeros(rel.shape[:2], np.int64)
        for a, d in enumerate(dims):
            idx = idx * (2 * d - 1) + (rel[..., a] + d - 1)
        return uniq, idx

    def forward(self, *dims: int) -> torch.Tensor:
        if len(dims) != self.num_dims:
            raise ValueError(f"CPB over {self.num_dims} dims called with {dims}")
        uniq, idx = self._tables(*dims)
        dev = self.net[0][0].weight.device
        x = torch.from_numpy(uniq).to(dev)
        for layer in self.net:
            x = layer(x.float())
        bias = x[torch.from_numpy(idx).to(dev)]       # (N, N, heads)
        return bias.permute(2, 0, 1).contiguous()     # (heads, N, N)


def _peg_geometry(weight: torch.Tensor, rotated: bool, causal: bool = True):
    """The conv weight as applied, (c, 1, kt, kh, kw), and the F.pad list
    (w0, w1, h0, h1, t0, t1): causal frames, or with rotated=True the
    kernel's tap axes rotated (t, h, w) -> (h, w, t) and the causal pad on
    h (ct_clip_tpu/ops/pallas/peg.py::_pads, causal_axis 1); causal=False
    (MaskGIT) pads every axis by 1 on both sides."""
    w = weight.permute(0, 1, 4, 2, 3) if rotated else weight  # K_r[a, b, c] = K[b, c, a]
    if not causal:
        return w, [1, 1, 1, 1, 1, 1]
    return w, [1, 1, 2, 0, 1, 1] if rotated else [1, 1, 1, 1, 2, 0]


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
    tensor takes the plain version, a bf16 CUDA tensor the kernel
    (csrc/peg_bwd.cu).  An f32 CUDA tensor takes the plain version, counted
    as `peg_dw_plain`: the JAX package runs K14 in bf16 only and its f32
    PEG backward in XLA (peg.py:106, `kernels.ROUTES`)."""
    if x.device.type == "cpu":
        return peg_dw_plain(x, dout, pads)
    if K.route("peg_bwd", x.dtype) == K.PLAIN:
        K.count_launch("peg_dw_plain")
        return peg_dw_plain(x, dout, pads)
    out = K.peg_dw(x.contiguous(), dout.contiguous(), pads)
    K.count_launch("peg_bwd")
    return out


class _PEGConv(torch.autograd.Function):
    """x + depthwise conv(x) + bias; the weight and bias stay f32 here, so
    their gradients are not rounded to the compute dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, rotated, causal):
        ctx.rotated, ctx.causal = rotated, causal
        ctx.save_for_backward(x, weight)
        w, pad = _peg_geometry(weight.to(x.dtype), rotated, causal)
        return _depthwise(x, w, pad) + x + bias.to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, weight = ctx.saved_tensors
        c = x.shape[-1]
        w, pad = _peg_geometry(weight.to(x.dtype), ctx.rotated, ctx.causal)
        dout = dout.to(x.dtype).contiguous()
        # dx: correlation with the flipped kernel, pads complemented, plus
        # the residual's identity term (peg.py::lax_peg_dx)
        dx = _depthwise(dout, w.flip(2, 3, 4), [2 - p for p in pad]) + dout
        dwb = peg_dw(x, dout, (pad[4], pad[2], pad[0]))
        dw = dwb[:27].t().reshape(c, 1, 3, 3, 3)
        if ctx.rotated:  # back from the rotated taps: dK[b, c, a] = dK_r[a, b, c]
            dw = dw.permute(0, 1, 3, 4, 2)
        return dx, dw.to(weight.dtype), dwb[27].to(weight.dtype), None, None


def peg_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             rotated: bool = False, causal: bool = True) -> torch.Tensor:
    """x + conv(x) + bias for the channels-last (b, t, h, w, c) x and the
    Conv3d weight (c, 1, 3, 3, 3) and bias (c,), causal frame pad (or the
    rotated form, or with causal=False a pad of 1 on every side,
    `_peg_geometry`).  Differentiable: dW and db are the port of K14 on
    CUDA (leading pads (1, 1, 1) when not causal), its plain version on the
    CPU."""
    return _PEGConv.apply(x, weight, bias, rotated, causal)


class PEG(nn.Module):
    """Depthwise 3x3x3 conv positional encoding (transformer_maskgit/
    attention.py:56-84), + x: causal frame padding in the CTViT
    (peg_causal=True), a pad of 1 on every side in MaskGIT (causal=False).

    rotated=True computes the reference's temporal-stage semantics on the
    native (b, t, h, w, c) grid: the reference reinterprets (b, h, w, t, c)
    memory as (b, t, h, w, c) (ctvit.py:299-303), which for a cubic grid is
    the same conv with the kernel's tap axes rotated (t, h, w) -> (h, w, t)
    and the causal pad moved to the h axis (ops/attention.py:457-496)."""

    def __init__(self, dim: int, causal: bool = True, device=None):
        super().__init__()
        self.causal = causal
        self.dsconv = nn.Conv3d(dim, dim, 3, groups=dim, device=device)

    def forward(self, x: torch.Tensor, rotated: bool = False) -> torch.Tensor:
        """x: (b, t, h, w, c) in the compute dtype."""
        if rotated and not x.shape[1] == x.shape[2] == x.shape[3]:
            raise ValueError("rotated PEG needs a cubic grid")
        return peg_conv(x, self.dsconv.weight, self.dsconv.bias, rotated, self.causal)


class QKNormAttention(nn.Module):
    """Attention with QK l2-norm and learned per-dim scales, fixed logit
    scale 8 (transformer_maskgit/attention.py:88-181); forward adds the
    residual.

    A self-attention without a mask or null key/values runs as one of the
    fused sublayers where they take it (`sublayer_fits`): K2 grid on the
    native (b, t, h*w, d) grid of a cubic token grid, K1 with a (h, n, n)
    bias, K2 seq without one on sequences shorter than 128 (the JAX
    package's small-sequence gate).  Everything else (cross attention,
    masks, null key/values, MaskGIT's 1,280 tokens, whose whole k and v of
    one head do not fit one block's shared memory) takes the JAX package's
    generic path (ops/attention.py:344-384): q from LN(x), k and v from the
    PRE-norm x or, for cross attention, from the context (after
    `context_norm`, a gamma LayerNorm of width `dim_context`); `num_null_kv`
    learned null key/values (h, 2 n_null, dh), even rows keys and odd rows
    values, before the keys; the bias and the (b, j) key mask padded over
    them; then `sdpa` (K7 / K7 dense without a mask, plain PyTorch with
    one).  Both routes compute the same function."""

    def __init__(self, dim: int, dim_head: int, heads: int, dim_context: Optional[int] = None,
                 num_null_kv: int = 0, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.scale = heads, dim_head, 8.0
        self.num_null_kv = num_null_kv
        self.norm = GammaLayerNorm(dim, device=device)
        # cross attention (a `dim_context`) normalises its context (the
        # reference's norm_context=True); self-attention has no context_norm
        self.context_norm = (None if dim_context is None
                             else GammaLayerNorm(dim_context, device=device))
        self.to_q = nn.Linear(dim, inner, bias=False, device=device)
        self.to_kv = nn.Linear(dim if dim_context is None else dim_context, inner * 2,
                               bias=False, device=device)
        self.q_scale = nn.Parameter(torch.ones(dim_head, device=device))
        self.k_scale = nn.Parameter(torch.ones(dim_head, device=device))
        self.null_kv = nn.Parameter(torch.zeros(heads, 2 * num_null_kv, dim_head,
                                                device=device))
        self.to_out = nn.Linear(inner, dim, bias=False, device=device)

    def forward(self, x: torch.Tensor, attn_bias: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        args = (self.norm.gamma, self.to_q.weight, self.to_kv.weight,
                self.q_scale, self.k_scale, self.to_out.weight)
        if x.dim() == 4:  # native (b, t, h*w, d) grid: attend along t
            if attn_bias is not None or mask is not None or context is not None:
                raise ValueError("the grid layout takes no bias, mask or context")
            return fused_grid_qknorm_attention(x, *args, self.heads,
                                               self.dim_head, self.scale)
        n = x.shape[1]
        if (context is not None or mask is not None or self.num_null_kv
                or not sublayer_fits(n, self.dim_head, x.dtype)):
            return self._generic(x, attn_bias, mask, context)
        if attn_bias is not None:
            return fused_spatial_qknorm_attention(x, *args, attn_bias, self.heads,
                                                  self.dim_head, self.scale)
        if n < 128:  # (b*h*w, t, d) temporal sequences
            return fused_small_qknorm_attention(x, *args, self.heads,
                                                self.dim_head, self.scale)
        return self._generic(x, attn_bias, mask, context)

    def _generic(self, x, attn_bias, mask, context) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh, nn_ = self.heads, self.dim_head, self.num_null_kv
        dtype = x.dtype
        if context is not None and self.context_norm is not None:
            context = self.context_norm(context)
        kv_input = (context if context is not None else x).to(dtype)
        q = layer_norm(x, self.norm.gamma) @ self.to_q.weight.to(dtype).t()
        kv = kv_input @ self.to_kv.weight.to(dtype).t()
        k, v = kv.chunk(2, dim=-1)
        q, k, v = (t.unflatten(-1, (h, dh)).transpose(1, 2) for t in (q, k, v))
        if nn_:
            null = self.null_kv.to(dtype)
            k = torch.cat([null[None, :, 0::2].expand(b, h, nn_, dh), k], dim=-2)
            v = torch.cat([null[None, :, 1::2].expand(b, h, nn_, dh), v], dim=-2)
        q = (l2norm(q.float()) * self.q_scale.float()).to(dtype)
        k = (l2norm(k.float()) * self.k_scale.float()).to(dtype)
        if attn_bias is not None:  # padded over the null keys
            attn_bias = F.pad(attn_bias, (nn_, 0)) if nn_ else attn_bias
            if attn_bias.dim() == 3:
                attn_bias = attn_bias[None]
        if mask is not None:
            mask = F.pad(mask.bool(), (nn_, 0), value=True)
        out = sdpa(q * self.scale, k, v, bias=attn_bias, mask=mask)
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        return ((out @ self.to_out.weight.to(dtype).t()).float() + x.float()).to(dtype)


# null key/values of MaskGIT's cross attention (MaskGITTransformer.py, attn_num_null_kv)
CROSS_NULL_KV = 2


class TransformerLayer(nn.ModuleDict):
    """One reference layer: "0" PEG, "1" self-attention, "2" cross attention
    (MaskGIT with a text context only; absent in the CTViT), "3"
    feed-forward."""

    def __init__(self, dim: int, dim_head: int, heads: int, dim_context: Optional[int] = None,
                 has_cross_attn: bool = False, peg_causal: bool = True, device=None):
        layers = {"0": PEG(dim, causal=peg_causal, device=device),
                  "1": QKNormAttention(dim, dim_head, heads, device=device)}
        if has_cross_attn:
            layers["2"] = QKNormAttention(dim, dim_head, heads, dim_context=dim_context,
                                          num_null_kv=CROSS_NULL_KV, device=device)
        layers["3"] = MaskgitFeedForward(dim, device=device)
        super().__init__(layers)


class MaskgitTransformer(nn.Module):
    """transformer_maskgit/attention.py:280-333: [PEG, self-attention,
    cross attention?, FF] x depth, all residual, then norm_out.  The CTViT
    encoder and decoder use the default causal PEG; MaskGIT and the critic
    `peg_causal=False` and, conditioned on text, `has_cross_attn` with
    `dim_context` (2 null key/values)."""

    def __init__(self, dim: int, depth: int, dim_head: int, heads: int,
                 dim_context: Optional[int] = None, has_cross_attn: bool = False,
                 peg_causal: bool = True, device=None):
        super().__init__()
        self.has_cross_attn = has_cross_attn
        self.layers = nn.ModuleList(
            TransformerLayer(dim, dim_head, heads, dim_context, has_cross_attn,
                             peg_causal, device=device)
            for _ in range(depth))
        self.norm_out = GammaLayerNorm(dim, device=device)

    def forward(self, x: torch.Tensor, video_shape: Tuple[int, int, int, int],
                attn_bias: Optional[torch.Tensor] = None,
                grid_layout: bool = False, context: Optional[torch.Tensor] = None,
                self_attn_mask: Optional[torch.Tensor] = None,
                cross_attn_context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (b*t, h*w, d) spatial sequences (with the CPB `attn_bias`),
        (b*h*w, t, d) temporal sequences (no bias), with grid_layout=True
        the native (b, t, h*w, d) grid of a cubic token grid, or MaskGIT's
        (b, t*h*w, d) tokens with its 3-D CPB bias, an optional (b, N) self
        mask and the text `context` (b, m, dim_context) with its (b, m) mask
        (cross attention runs only when a context is given)."""
        if grid_layout:
            b, t, h, w = video_shape
            if not (t == h == w and x.shape[:3] == (b, t, h * w)):
                raise ValueError(f"grid layout needs a cubic (b, t, h*w, d) "
                                 f"grid, got {tuple(x.shape)}")
        d = x.shape[-1]
        for layer in self.layers:
            # PEG sees x.reshape(*video_shape, d): the true grid spatially;
            # temporally the reference's reinterpretation of (b, h, w, t, d)
            # memory as (b, t, h, w, d), which is that memory as it lies for
            # sequences and the rotated conv on the cubic grid
            grid = x.reshape(*video_shape, d)
            x = layer["0"](grid, rotated=grid_layout).reshape(x.shape)
            x = layer["1"](x, attn_bias, mask=self_attn_mask)
            if self.has_cross_attn and context is not None:
                x = layer["2"](x, mask=cross_attn_context_mask, context=context)
            x = layer["3"](x)
        return self.norm_out(x)
