"""The CTViT QK-norm attention sublayer: spatial (K1), temporal-grid (K2
grid) and temporal sequence-major (K2 seq).

Ports of ct_clip_tpu/ops/pallas/spatial_attention.py::
fused_spatial_qknorm_attention (K1, plain twin `_xla_spatial_qknorm`),
ops/pallas/small_attention.py::fused_small_qknorm_attention_grid (K2 grid,
plain twin `_xla_grid_qknorm`) and ::fused_small_qknorm_attention (K2 seq,
plain twin `_xla_small_qknorm`: the temporal stage of a non-cubic token
grid, whose t-columns the caller has transposed into (b*h*w, t, dim)
sequences).  One sublayer (reference
transformer_maskgit/attention.py:88-181, self-attention, no null kv):

  * gamma LayerNorm; q from LN(x), k and v from the PRE-norm x
    (attention.py:139-143);
  * per-head l2norm, q times q_scale * 8, k times k_scale;
  * f32 scores, plus the (heads, n, n) CPB bias for the spatial stage;
  * softmax, times v, heads merged, output projection, + x.

Weights are in nn.Linear layout: wq (h*dh, dim), wkv (2*h*dh, dim) with k
first, wout (dim, h*dh).  The spatial and sequence-major forms take (b, n,
dim) sequences (the same core, the spatial one with the CPB bias); the grid
form takes the native (b, t, h*w, dim) token grid and attends along t.

On a CUDA tensor: LN (csrc/layernorm.cu), the q and kv products
(csrc/gemm.cu), the attention core (csrc/attention.cu, which reads the
t-columns of the grid in place through strides) and the output product with
the residual epilogue.  In bf16, or in f32 (the f32 forms: weights, q, k, v
and scores in f32, true f32 products, as the TPU kernels run f32 operands
at "highest"), forward and backward (`kernels.ROUTES`).

The backwards are the ports of spatial_attention.py::_pallas_spatial_bwd
(K9) and small_attention.py::_pallas_small_qknorm_bwd with grid_layout=True
(K10 grid) and False (K10 seq).  Each saves only the sublayer's input and
recomputes: LN, the q and kv products, dO W_out (an NN product), the attention core's backward
(csrc/qknorm_attention_bwd.cu: the merged heads, dq and dk through the
l2norm, dv, and the sums of dq_scale, dk_scale and, spatially, of the
(heads, n, n) bias over all planes, in a fixed order), dxn = dq W_q and
dx_kv = dkv W_kv (NN), the LN backward with dx_kv and the identity term,
and the weight gradients dW_q, dW_kv, dW_out over all rows in f32 (TN
products).  In f32 every one of them is its f32 form and nothing is rounded
to bf16 (dO, the weights, dmerged, the merged heads, dq and dkv stay f32).
Their plain versions are autograd of the plain forwards.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels as K
from .autograd import vjp
from .norms import l2norm, layer_norm

# (sequence-group, head) blocks of the spatial backward: two per SM of the
# H100's 132, so each group's bias-gradient partial stays one block's own
TARGET_BLOCKS = 264
# sequence groups of the backwards without a bias (grid and sequence-major):
# bounds the scale gradients' partial rows that sum_splits adds
GRID_GROUPS = 1024
# the dynamic shared memory one H100 block may opt into (bytes)
SMEM_LIMIT = 227 * 1024


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


def sublayer_fits(n: int, dim_head: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the fused sublayers (K1 / K2 seq forward, K9 / K10 backward)
    take (sequence, head) pairs of n tokens of width dim_head in `dtype`.
    A bf16 block stages its pair's whole k and v (backward: q, k, v and
    dout) in shared memory, sized as the launches in csrc/attention.cu and
    csrc/qknorm_attention_bwd.cu size it; the JAX package gates its Pallas
    sublayers on their VMEM plans the same way.  f32 takes the same gate and
    its own forms' tiles and chunks as well (`kernels.attention_f32_smem`,
    `kernels.qk_attention_bwd_f32_smem`), which at small head widths take
    more than the bf16 forms (d 16: from n ~808 against ~1,071)."""
    d, warps = dim_head, (8 if n >= 128 else 2)
    if d % 2 or d > 64:
        return False
    fwd = _align16(2 * n * (2 * d + 2)) + 4 * warps * (d + n)
    bwd = _align16(8 * n * (d + 2)) + 4 * (2 * n + warps * (2 * n + 2 * d))
    if dtype == torch.float32:
        fwd = max(fwd, K.attention_f32_smem(n, d, warps))
        bwd = max(bwd, K.qk_attention_bwd_f32_smem(n, d, warps))
    return max(fwd, bwd) <= SMEM_LIMIT


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


def qknorm_attention_bwd_plain(x, gamma, wq, wkv, q_scale, k_scale, wout, bias,
                               dout, heads: int, dim_head: int, scale: float = 8.0):
    """Plain version of K9 on (b, n, dim) sequences: (dx, dgamma, dwq, dwkv,
    dq_scale, dk_scale, dwout, dbias), the VJP of `qknorm_attention_plain`
    at dout (dbias None without a bias)."""
    return vjp(lambda x_, g_, q_, kv_, qs_, ks_, o_, b_: qknorm_attention_plain(
        x_, g_, q_, kv_, qs_, ks_, o_, b_, heads, dim_head, scale),
        (x, gamma, wq, wkv, q_scale, k_scale, wout, bias), dout)


def grid_qknorm_attention_bwd_plain(x, gamma, wq, wkv, q_scale, k_scale, wout, dout,
                                    heads: int, dim_head: int, scale: float = 8.0):
    """Plain version of K10 on the (b, t, S, dim) grid: (dx, dgamma, dwq,
    dwkv, dq_scale, dk_scale, dwout)."""
    return vjp(lambda *a: grid_qknorm_attention_plain(*a, heads, dim_head, scale),
               (x, gamma, wq, wkv, q_scale, k_scale, wout), dout)


def _layout(x, hd: int, dim_head: int, grid: bool):
    """(sequences, inner, q_strides, kv_strides, n) of the attention core on
    the (rows, hd) q and (rows, 2 hd) kv products of x."""
    if grid:  # sequence (b, s) holds tokens x[b, :, s]
        b, n, S, _ = x.shape
        return (b * S, S, (n * S * hd, hd, dim_head, S * hd),
                (n * S * 2 * hd, 2 * hd, dim_head, S * 2 * hd), n)
    b, n, _ = x.shape
    return b, 1, (n * hd, 0, dim_head, hd), (n * 2 * hd, 0, dim_head, 2 * hd), n


def _project(x2, gamma, wq, wkv, hd: int):
    """LN(x) and the q = LN(x) wq^T, kv = x wkv^T products, in x's dtype."""
    cdt, rows = x2.dtype, x2.shape[0]
    xn = torch.empty_like(x2)
    K.layernorm(x2, gamma, None, 1e-5, xn)
    q = torch.empty((rows, hd), dtype=cdt, device=x2.device)
    K.gemm(K.EPI_STORE, xn, wq.to(cdt).contiguous(), q)
    kv = torch.empty((rows, 2 * hd), dtype=cdt, device=x2.device)
    K.gemm(K.EPI_STORE, x2, wkv.to(cdt).contiguous(), kv)
    return xn, q, kv


def _check_weights(x, wq, wkv, wout, hd: int) -> None:
    dim = x.shape[-1]
    if wq.shape != (hd, dim) or wkv.shape != (2 * hd, dim) \
            or wout.shape != (dim, hd):
        raise ValueError("attention weights do not fit dim/heads/dim_head")


def _qknorm_attention_cuda(x, gamma, wq, wkv, q_scale, k_scale, wout, bias,
                           heads, dim_head, scale, grid: bool):
    dim = x.shape[-1]
    hd = heads * dim_head
    _check_weights(x, wq, wkv, wout, hd)
    x2 = x.view(-1, dim)
    _, q, kv = _project(x2, gamma, wq, wkv, hd)
    merged = torch.empty_like(q)
    sequences, inner, q_strides, kv_strides, n = _layout(x, hd, dim_head, grid)
    K.attention(q, kv, kv[:, hd:], merged, sequences=sequences, inner=inner,
                heads=heads, n=n, d=dim_head, q_strides=q_strides,
                kv_strides=kv_strides, q_scale=q_scale.float() * scale,
                k_scale=k_scale,
                bias=None if bias is None else bias.float().contiguous(),
                warps=8 if n >= 128 else 2)
    out = torch.empty_like(x2)
    K.gemm(K.EPI_RESIDUAL, merged, wout.to(x.dtype).contiguous(), out, residual=x2)
    return out.view(x.shape)


def _qknorm_attention_bwd_cuda(x, gamma, wq, wkv, q_scale, k_scale, wout, bias,
                               dout, heads, dim_head, scale, grid: bool):
    cdt, f32 = x.dtype, torch.float32
    dim = x.shape[-1]
    hd = heads * dim_head
    x2 = x.view(-1, dim)
    rows = x2.shape[0]
    dout = dout.to(cdt).contiguous().view(rows, dim)
    wq_c, wkv_c, wout_c = (w.to(cdt).contiguous() for w in (wq, wkv, wout))
    xn, q, kv = _project(x2, gamma, wq, wkv, hd)
    dmerged = torch.empty((rows, hd), dtype=cdt, device=x.device)
    K.gemm_nn(dout, wout_c, dmerged)
    sequences, inner, q_strides, kv_strides, n = _layout(x, hd, dim_head, grid)
    groups = min(sequences, -(-TARGET_BLOCKS // heads) if bias is not None else GRID_GROUPS)
    merged, dq, dkv, dqs, dks, dbias = K.qk_attention_bwd(
        q, kv, dmerged, sequences=sequences, inner=inner, heads=heads, n=n,
        d=dim_head, q_strides=q_strides, kv_strides=kv_strides,
        q_scale=q_scale.float() * scale, k_scale=k_scale,
        bias=None if bias is None else bias.float().contiguous(),
        group=-(-sequences // groups), warps=8 if n >= 128 else 2)
    dxn = torch.empty((rows, dim), dtype=f32, device=x.device)
    K.gemm_nn(dq, wq_c, dxn)
    dx_kv = torch.empty_like(dxn)
    K.gemm_nn(dkv, wkv_c, dx_kv)
    dx, dgamma, _ = K.layernorm_bwd(x2, gamma, dxn, 1e-5, add=dx_kv, add2=dout)
    return (dx.view(x.shape), dgamma, K.gemm_tn(dq, xn), K.gemm_tn(dkv, x2),
            dqs * scale, dks, K.gemm_tn(dout, merged), dbias)


def _apply(x, gamma, wq, wkv, q_scale, k_scale, wout, bias, heads, dim_head, scale,
           form: str):
    """The sublayer on a CUDA tensor, by `kernels.ROUTES`: bf16 or f32."""
    if K.route(f"{form}_attention", x.dtype) != K.KERNEL:
        raise K.not_ported(f"{form}_attention", x.dtype)
    return _QKNormAttention.apply(x.contiguous(), gamma, wq, wkv, q_scale, k_scale, wout, bias,
                                  heads, dim_head, scale, form)


class _QKNormAttention(torch.autograd.Function):
    """K1 / K2 forward, K9 / K10 backward, on CUDA tensors; only x is saved.
    `form` is "spatial", "grid" or "seq", which names the launch counters."""

    @staticmethod
    def forward(ctx, x, gamma, wq, wkv, q_scale, k_scale, wout, bias, heads,
                dim_head, scale, form):
        grid = form == "grid"
        ctx.cfg = (heads, dim_head, scale, grid, form)
        ctx.save_for_backward(x, gamma, wq, wkv, q_scale, k_scale, wout, bias)
        out = _qknorm_attention_cuda(x, gamma, wq, wkv, q_scale, k_scale, wout, bias,
                                     heads, dim_head, scale, grid)
        K.count_launch(f"{form}_attention", x.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        heads, dim_head, scale, grid, form = ctx.cfg
        saved = ctx.saved_tensors
        if K.route(f"{form}_attention_bwd", saved[0].dtype) != K.KERNEL:
            raise K.not_ported(f"{form}_attention_bwd", saved[0].dtype)
        grads = _qknorm_attention_bwd_cuda(*saved, dout, heads, dim_head, scale, grid)
        K.count_launch(f"{form}_attention_bwd", saved[0].dtype)
        out = [grads[0]] + [None if g is None else g.to(t.dtype)
                            for g, t in zip(grads[1:], saved[1:])]
        return (*out, None, None, None, None)


def fused_spatial_qknorm_attention(x, gamma, wq, wkv, q_scale, k_scale, wout,
                                   bias: Optional[torch.Tensor], heads: int,
                                   dim_head: int, scale: float = 8.0) -> torch.Tensor:
    """(b, n, dim) sequences; bias (heads, n, n) f32 or None.  Returns
    x + attention(x).  Differentiable: on CUDA the backward is the port of
    K9."""
    if x.device.type == "cpu":
        return qknorm_attention_plain(x, gamma, wq, wkv, q_scale, k_scale,
                                      wout, bias, heads, dim_head, scale)
    return _apply(x, gamma, wq, wkv, q_scale, k_scale, wout, bias, heads, dim_head, scale,
                  "spatial")


def fused_small_qknorm_attention(x, gamma, wq, wkv, q_scale, k_scale, wout,
                                 heads: int, dim_head: int,
                                 scale: float = 8.0) -> torch.Tensor:
    """(b, n, dim) short sequences without a bias (the temporal stage of a
    non-cubic token grid, b = batch * h * w, n = t).  Returns x +
    attention(x).  Differentiable: on CUDA the backward is the port of
    K10's sequence-major form.  Plain versions: `qknorm_attention_plain`
    and `qknorm_attention_bwd_plain` with bias None."""
    if x.device.type == "cpu":
        return qknorm_attention_plain(x, gamma, wq, wkv, q_scale, k_scale, wout,
                                      None, heads, dim_head, scale)
    return _apply(x, gamma, wq, wkv, q_scale, k_scale, wout, None, heads, dim_head, scale,
                  "seq")


def fused_grid_qknorm_attention(x, gamma, wq, wkv, q_scale, k_scale, wout,
                                heads: int, dim_head: int,
                                scale: float = 8.0) -> torch.Tensor:
    """(b, t, S, dim) grid; each of the b*S columns is a t-token sequence.
    Returns x + attention(x).  Differentiable: on CUDA the backward is the
    port of K10's grid form."""
    if x.device.type == "cpu":
        return grid_qknorm_attention_plain(x, gamma, wq, wkv, q_scale,
                                           k_scale, wout, heads, dim_head, scale)
    return _apply(x, gamma, wq, wkv, q_scale, k_scale, wout, None, heads, dim_head, scale,
                  "grid")
