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

On a CUDA tensor the forward's core takes the route `kernels.qk_fwd_route`
gives: at head dim 32, K1's 576- and 64-token planes (n >= 32) the tensor
cores (csrc/qknorm_attention_tc.cu, bf16 `wgmma`, counted `qk_attention_tc`;
csrc/qknorm_attention_tc32.cu, f32 in 3xTF32, `qk_attention_tc32`), and K2's
16-31-token sequences csrc/qknorm_attention_short.cu (one CTA a sequence,
its token rows staged whole, the t-columns of the grid read in place through
strides; bf16 on mma.sync, f32 on the CUDA cores; counted
`qk_attention_short`); other shapes csrc/attention.cu (counted
`qk_attention_cuda_cores`).  In bf16: LN (csrc/layernorm.cu), the q and kv
products on csrc/ffn_tc.cu's NT store form and the output product, merged
wout^T + x, on its residual form (`wgmma`, each counted `qk_proj_tc`) where
`proj_route` says so, else on csrc/gemm.cu (`qk_proj_gemm`).  In f32, on the
tensor-core and short routes, the whole forward in 3xTF32 (nothing rounded
below f32, as the TPU kernels run f32 operands at "highest"): LN written as
TF32 hi and lo planes, x and the weights split, q and kv on
csrc/ffn_tc32.cu's plain-store product, the core writing merged split, out =
merged wout^T + x on ffn_tc32.cu's residual product (each product counted
`tc32_gemm`); on the CUDA-core route gemm.cu's FFMA tiles.  Forward and
backward in bf16 or f32 (`kernels.ROUTES`).

The backwards are the ports of spatial_attention.py::_pallas_spatial_bwd
(K9) and small_attention.py::_pallas_small_qknorm_bwd with grid_layout=True
(K10 grid) and False (K10 seq).  Each saves only the sublayer's input and
recomputes: LN, the q and kv products, dO W_out (an NN product), the attention core's backward
(the merged heads, dq and dk through the l2norm, dv, and the sums of
dq_scale, dk_scale and, spatially, of the (heads, n, n) bias over all
planes, in a fixed order: in bf16 at head dim 32 and n >= 32, K9's planes,
csrc/qknorm_attention_tc.cu on the tensor cores, counted
`qk_attention_tc_bwd` where kernels.qk_attention_bwd launches it; in f32
there csrc/qknorm_attention_tc32.cu in 3xTF32, counted
`qk_attention_tc32_bwd`; otherwise csrc/qknorm_attention_bwd.cu on the
CUDA cores, by `kernels.qk_bwd_tensor_cores`), dxn = dq W_q and
dx_kv = dkv W_kv (NN), the LN backward with dx_kv and the identity term,
and the weight gradients dW_q, dW_kv, dW_out over all rows in f32 (TN
products).  In f32 every one of them is its f32 form and nothing is rounded
to bf16 (dO, the weights, dmerged, the merged heads, dq and dkv stay f32);
on the routes `kernels.qk_bwd_route` gives the tensor cores (K9's planes) or
the short core (K10's 16-31-token sequences: csrc/qknorm_attention_short.cu's
f32 backward, counted `qk_attention_short_bwd_f32`) every product runs in
3xTF32 on csrc/ffn_tc32.cu (`_qknorm_attention_bwd_tc32`: the weight
gradients on its TN form over transposed TF32 planes).  In bf16 on the
short route (K10, `_qknorm_attention_bwd_short`) the backward follows
small_attention.py::_bwd_kernel's own rounding points: q, kv and dmerged
f32, the short core's bf16 form (true f32 inside, counted
`qk_attention_short_bwd`; plain version `qk_short_bwd_core_plain`), dq,
dkv and merged rounded once, every product on csrc/ffn_tc.cu's bf16
`wgmma` forms (plain version of the whole backward:
`small_qknorm_bwd_plain`); K9 bf16 keeps its core and rounding points, its
dmerged, NN and TN products on ffn_tc.cu too where `proj_route` gives
PROJ_WGMMA.  The training paths' plain versions on the CPU are autograd of
the plain forwards.
"""
from __future__ import annotations

import functools
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
    sublayers on their VMEM plans the same way.  Where
    `kernels.qk_bwd_tensor_cores` takes the tensor cores, their forward's
    tiles count too (`kernels.QK_TC_FWD_SMEM`, `QK_TC32_FWD_SMEM`).  f32
    takes the same gate and its own forms' tiles and chunks as well
    (`kernels.attention_f32_smem`, and for the backward the kernel
    `kernels.qk_bwd_tensor_cores` picks: `kernels.qk_attention_bwd_f32_smem`
    on the CUDA cores, which at small head widths takes more than the bf16
    forms (d 16: from n ~808 against ~1,071), or `kernels.QK_TC32_BWD_SMEM`
    for the 3xTF32 core)."""
    d, warps = dim_head, (8 if n >= 128 else 2)
    if d % 2 or d > 64:
        return False
    fwd = _align16(2 * n * (2 * d + 2)) + 4 * warps * (d + n)
    bwd = _align16(8 * n * (d + 2)) + 4 * (2 * n + warps * (2 * n + 2 * d))
    core = K.qk_bwd_tensor_cores(dtype, n, d)
    if core != K.QK_CUDA_CORES:
        fwd = max(fwd, K.QK_TC_FWD_SMEM if core == K.QK_WGMMA else K.QK_TC32_FWD_SMEM)
    if dtype == torch.float32:
        fwd = max(fwd, K.attention_f32_smem(n, d, warps))
        bwd = max(bwd, K.QK_TC32_BWD_SMEM if core == K.QK_TC32
                  else K.qk_attention_bwd_f32_smem(n, d, warps))
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


def qk_attention_core_plain(q, kv, heads: int, d: int, n: int, q_scale, k_scale,
                            bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of the attention core's forward (`kernels.qk_attention_fwd`)
    on sequence-major (S n, heads d) projections q and kv [k | v]: _kernel's
    arithmetic (spatial_attention.py:111-131) in f32 with its roundings to
    q's dtype (bf16: qn and kn, the unnormalised e = exp(S - rowmax) before e
    v, then e v divided by the f32 row sum of e, merged; f32: none).  q_scale
    includes the logit scale.  Returns merged (S n, heads d) in q's dtype."""
    dt, hd = q.dtype, heads * d
    S = q.shape[0] // n

    def split(t):  # (S n, heads d) -> (S, heads, n, d) f32
        return t.reshape(S, n, heads, d).transpose(1, 2).float()

    def normed(t, sc):
        r = torch.rsqrt(torch.clamp_min((t * t).sum(-1, keepdim=True), 1e-24))
        return (t * r * sc.float()).to(dt).float()

    qn, kn = normed(split(q), q_scale), normed(split(kv[:, :hd]), k_scale)
    s = qn @ kn.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    merged = (e.to(dt).float() @ split(kv[:, hd:])) / e.sum(-1, keepdim=True)
    return merged.transpose(1, 2).reshape(S * n, hd).to(dt)


def qk_attention_bwd_core_plain(q, kv, dout, heads: int, d: int, n: int, q_scale, k_scale,
                                bias: Optional[torch.Tensor]):
    """Plain version of the attention core's backward (`kernels.qk_attention_bwd`)
    on sequence-major (S n, heads d) projections q and kv [k | v] and dout,
    the gradient of the merged heads: _bwd_kernel's arithmetic
    (spatial_attention.py:166-211) in f32 with its roundings to q's dtype
    (bf16: qn and kn, P before the merged heads and dv, dS before dq and dk;
    f32: none).  q_scale includes the logit scale.  Returns (merged, dq,
    dkv, dq_scale before the logit scale, dk_scale, dbias or None): merged,
    dq and dkv in q's dtype, the sums over all sequences f32."""
    dt, hd = q.dtype, heads * d
    S = q.shape[0] // n

    def split(t):  # (S n, heads d) -> (S, heads, n, d) f32
        return t.reshape(S, n, heads, d).transpose(1, 2).float()

    def merge(t):  # (S, heads, n, d) -> (S n, heads d) in q's dtype
        return t.transpose(1, 2).reshape(S * n, hd).to(dt)

    def rnd(t):  # a tensor of q's dtype between two stages
        return t.to(dt).float()

    def l2norm_bwd(xhat, r, dn, sc):
        dh = dn * sc
        return r * (dh - xhat * (xhat * dh).sum(-1, keepdim=True))

    qf, kf, v, g = split(q), split(kv[:, :hd]), split(kv[:, hd:]), split(dout)
    qs, ks = q_scale.float(), k_scale.float()
    rq = torch.rsqrt(torch.clamp_min((qf * qf).sum(-1, keepdim=True), 1e-24))
    rk = torch.rsqrt(torch.clamp_min((kf * kf).sum(-1, keepdim=True), 1e-24))
    qhat, khat = qf * rq, kf * rk
    qn, kn = rnd(qhat * qs), rnd(khat * ks)
    s = qn @ kn.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    p = s.softmax(dim=-1)
    pb = rnd(p)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dsb = rnd(ds)
    dqn, dkn = dsb @ kn, dsb.transpose(-1, -2) @ qn
    dq = l2norm_bwd(qhat, rq, dqn, qs)
    dk = l2norm_bwd(khat, rk, dkn, ks)
    dv = pb.transpose(-1, -2) @ g
    return (merge(pb @ v), merge(dq), torch.cat([merge(dk), merge(dv)], dim=1),
            (dqn * qhat).sum((0, 1, 2)), (dkn * khat).sum((0, 1, 2)),
            None if bias is None else ds.sum(0))


def qk_short_bwd_core_plain(q, kv, dout, heads: int, d: int, n: int, q_scale, k_scale):
    """Plain version of the short backward core's bf16 form
    (`kernels.qk_attention_short_bwd(..., out_dtype=bf16)`, K10 bf16) on
    sequence-major (S n, heads d) f32 projections q, kv [k | v] and dout:
    `qk_attention_bwd_core_plain` in f32, nothing rounded inside, then
    merged, dq and dkv rounded to bf16 once (small_attention.py:353-354,
    :377).  Returns (merged, dq, dkv, dq_scale before the logit scale,
    dk_scale); the sums f32."""
    merged, dq, dkv, dqs, dks, _ = qk_attention_bwd_core_plain(
        q.float(), kv.float(), dout.float(), heads, d, n, q_scale, k_scale, None)
    bf = torch.bfloat16
    return merged.to(bf), dq.to(bf), dkv.to(bf), dqs, dks


def small_qknorm_bwd_plain(x, gamma, wq, wkv, q_scale, k_scale, wout, dout, heads: int,
                           dim_head: int, scale: float = 8.0, grid: bool = False):
    """Plain version of K10 bf16's backward at the TPU kernel's own rounding
    points (ct_clip_tpu/ops/pallas/small_attention.py::_bwd_kernel,
    :249-403), on the (b, t, S, dim) grid (grid=True) or on (b, n, dim)
    sequences, residual included: the LN recomputed in f32 and xn rounded to
    x's dtype (:269-276); q = xn wq^T and kv = x wkv^T kept f32 (:278-279);
    dmerged = f32(dO) wout (:301-303); the whole (n, n) core in f32
    (:304-350); dq, [dk | dv] rounded (:353-354); dxn = dq wq, dx_kv = dkv
    wkv in f32 (:355-358); the LN backward and dx = dx_ln + dx_kv + dO
    (:361-369); dWq = dq^T xn, dWkv = dkv^T x, dWout = dO^T merged with dO
    and merged rounded (:371-379); dgamma = sum dxn xhat (:380).  Every
    product takes its operands at those points exactly and sums in f32.
    The TPU runs these dots under mm_precision "default" (_call.py:64-84),
    which on its MXU may round the f32 operands of the f32 dots; interpret
    mode on the CPU cannot show that, and this version, like the kernel
    body as written and the port's card path, keeps them f32.  Returns (dx,
    dgamma, dwq, dwkv, dq_scale, dk_scale, dwout) in the port's layouts,
    dx in x's dtype, the rest f32."""
    dt, f32 = x.dtype, torch.float32
    dim = x.shape[-1]
    if grid:  # the t-columns as sequences
        xs, ds = x.transpose(1, 2), dout.transpose(1, 2)
    else:
        xs, ds = x, dout
    n = xs.shape[-2]
    x2, do2 = xs.reshape(-1, dim), ds.reshape(-1, dim)
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + 1e-5)
    xhat = xc * rstd
    gf = gamma.float()
    xn = (xhat * gf).to(dt)
    wq_f, wkv_f, wout_f = (w.to(dt).float() for w in (wq, wkv, wout))
    dof = do2.to(dt).float()
    q = xn.float() @ wq_f.t()
    kv = x2.float() @ wkv_f.t()
    dmerged = dof @ wout_f
    merged, dq, dkv, dqs, dks = qk_short_bwd_core_plain(
        q, kv, dmerged, heads, dim_head, n, q_scale.float() * scale, k_scale)
    dxn = dq.float() @ wq_f
    dx_kv = dkv.float() @ wkv_f
    dxhat = dxn * gf
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2) + dx_kv + dof).to(dt).view(xs.shape)
    if grid:
        dx = dx.transpose(1, 2).contiguous()
    return (dx, (dxn * xhat).sum(0), dq.float().t() @ xn.float(), dkv.float().t() @ x2.float(),
            dqs * scale, dks.to(f32), dof.t() @ merged.float())


def _layout(x, hd: int, dim_head: int, grid: bool):
    """(sequences, inner, q_strides, kv_strides, n) of the attention core on
    the (rows, hd) q and (rows, 2 hd) kv products of x."""
    if grid:  # sequence (b, s) holds tokens x[b, :, s]
        b, n, S, _ = x.shape
        return (b * S, S, (n * S * hd, hd, dim_head, S * hd),
                (n * S * 2 * hd, 2 * hd, dim_head, S * 2 * hd), n)
    b, n, _ = x.shape
    return b, 1, (n * hd, 0, dim_head, hd), (n * 2 * hd, 0, dim_head, 2 * hd), n


# the sources of the sublayer's bf16 projections (`proj_route`)
PROJ_WGMMA, PROJ_WMMA = "ffn_tc.cu", "gemm.cu"


def proj_route(dtype: torch.dtype, dim: int, hd: int) -> str:
    """The source of the sublayer's q, kv and output products in `_project`
    and `_out_product`: PROJ_WGMMA (bf16 where ffn_tc.cu's TMA copies take
    the rows: the model width and heads x dim_head multiples of 8, every
    model of the repo) or PROJ_WMMA, gemm.cu (bf16 at other widths; f32,
    whose forward on the tensor-core and short routes takes ffn_tc32.cu
    through `_qknorm_attention_tc32` instead)."""
    return PROJ_WGMMA if dtype == torch.bfloat16 and dim % 8 == 0 and hd % 8 == 0 else PROJ_WMMA


def _project(x2, gamma, wq, wkv, hd: int):
    """LN(x) and the q = LN(x) wq^T, kv = x wkv^T products, in x's dtype,
    on `proj_route`'s source."""
    cdt, rows = x2.dtype, x2.shape[0]
    xn = torch.empty_like(x2)
    K.layernorm(x2, gamma, None, 1e-5, xn)
    wq_c, wkv_c = wq.to(cdt).contiguous(), wkv.to(cdt).contiguous()
    if proj_route(cdt, x2.shape[1], hd) == PROJ_WGMMA:
        return xn, K.gemm_nt_tc(xn, wq_c), K.gemm_nt_tc(x2, wkv_c)
    q = torch.empty((rows, hd), dtype=cdt, device=x2.device)
    kv = torch.empty((rows, 2 * hd), dtype=cdt, device=x2.device)
    for a, w, out in ((xn, wq_c, q), (x2, wkv_c, kv)):
        K.gemm(K.EPI_STORE, a, w, out)
        K.count_launch("qk_proj_gemm")
    return xn, q, kv


def _out_product(merged, wout, x2):
    """merged wout^T + x in x's dtype, summed in f32 and rounded once, on
    `proj_route`'s source (ffn_tc.cu's residual form or gemm.cu's
    EPI_RESIDUAL)."""
    w = wout.to(x2.dtype).contiguous()
    if proj_route(x2.dtype, x2.shape[1], merged.shape[1]) == PROJ_WGMMA:
        return K.gemm_residual_tc(merged, w, x2)
    out = torch.empty_like(x2)
    K.gemm(K.EPI_RESIDUAL, merged, w, out, residual=x2)
    K.count_launch("qk_proj_gemm")
    return out


def _tc32_weights(wq, wkv, wout):
    """wq, wkv and wout in f32, split into TF32 hi and lo planes by one
    launch: ((hi, lo) of wq, of wkv, of wout)."""
    ws = [w.float() for w in (wq, wkv, wout)]
    hi, lo = K.tc32_split(torch.cat([w.reshape(-1) for w in ws]))
    out, at = [], 0
    for w in ws:
        out.append((hi[at:at + w.numel()].view(w.shape), lo[at:at + w.numel()].view(w.shape)))
        at += w.numel()
    return out


def _qknorm_attention_tc32(x2, gamma, wq, wkv, wout, layout, core=K.QK_TC32):
    """The f32 sublayer forward on (rows, dim) x2, all in 3xTF32: LN written
    as TF32 hi and lo planes, x split, q = LN(x) wq^T and kv = x wkv^T (the
    plain-store product), the core (`core`: QK_TC32, K1's on
    qknorm_attention_tc32.cu, or QK_SHORT, K2's on qknorm_attention_short.cu)
    writing merged split, merged wout^T + x (the residual product)."""
    (wq_h, wq_l), (wkv_h, wkv_l), (wo_h, wo_l) = _tc32_weights(wq, wkv, wout)
    xn_h, xn_l = K.layernorm_split(x2, gamma, None, 1e-5)
    x_h, x_l = K.tc32_split(x2)
    q = K.tc32_gemm(xn_h, xn_l, wq_h, wq_l)
    kv = K.tc32_gemm(x_h, x_l, wkv_h, wkv_l)
    attend = K.qk_attention_short if core == K.QK_SHORT else K.qk_attention_fwd
    m_h, m_l = attend(q, kv, **layout)
    return K.tc32_gemm(m_h, m_l, wo_h, wo_l, residual=x2)


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
    sequences, inner, q_strides, kv_strides, n = _layout(x, hd, dim_head, grid)
    layout = dict(sequences=sequences, inner=inner, heads=heads, n=n, d=dim_head,
                  q_strides=q_strides, kv_strides=kv_strides,
                  q_scale=q_scale.float() * scale, k_scale=k_scale,
                  bias=None if bias is None else bias.float().contiguous())
    core = K.qk_fwd_route(x.dtype, n, dim_head, heads, bias is not None)
    if x.dtype == torch.float32 and core != K.QK_CUDA_CORES:
        return _qknorm_attention_tc32(x2, gamma, wq, wkv, wout, layout, core).view(x.shape)
    _, q, kv = _project(x2, gamma, wq, wkv, hd)
    if core == K.QK_WGMMA:
        merged = K.qk_attention_fwd(q, kv, **layout)
    elif core == K.QK_SHORT:
        merged = K.qk_attention_short(q, kv, **layout)
    else:
        merged = torch.empty_like(q)
        K.attention(q, kv, kv[:, hd:], merged, **layout, warps=8 if n >= 128 else 2)
        K.count_launch("qk_attention_cuda_cores")
    return _out_product(merged, wout, x2).view(x.shape)


def _qknorm_attention_bwd_tc32(x, gamma, wq, wkv, q_scale, k_scale, wout, bias, dout, heads,
                               dim_head, scale, grid: bool, core: str, lib=None):
    """The f32 sublayer backward on the tensor-core routes, its products in
    3xTF32 on csrc/ffn_tc32.cu: the weights split once (wq and wkv row-major
    for the recompute, all three transposed for the NN products), LN(x), x
    and dO split (x, LN(x) and dO also as transposed planes, the rows in the
    core's column order), q and kv recomputed, dmerged = dO wout, the core
    (`core`: QK_SHORT, K10's short sequences on qknorm_attention_short.cu,
    which writes dq, dkv and the transposed planes itself; QK_TC32, K9's
    planes on qknorm_attention_tc32.cu, its f32 outputs then split by
    `kernels.tc32_split_t`), dxn = dq wq and dx_kv = dkv wkv, the LN
    backward, and dWq, dWkv, dWout on the TN form.  `lib`: a one-change
    copy of ffn_tc32.cu (the products) for the card checks."""
    dim = x.shape[-1]
    hd = heads * dim_head
    x2 = x.view(-1, dim)
    rows = x2.shape[0]
    dout = dout.float().contiguous().view(rows, dim)
    sequences, inner, q_strides, kv_strides, n = _layout(x, hd, dim_head, grid)
    seq = dict(seq=(n, inner), lib=lib)  # the transposed planes in the core's column order
    w_qkv = torch.cat([wq.float(), wkv.float()])
    wqkv_hi, wqkv_lo, wqkv_t_hi, wqkv_t_lo = K.tc32_split_t(w_qkv, rows=True, lib=lib)
    wo_t = K.tc32_split_t(wout.float().contiguous(), lib=lib)
    xn_hi, xn_lo = K.layernorm_split(x2, gamma, None, 1e-5)
    xn_t = K.tc32_split_t(xn_hi, xn_lo, **seq)
    x_hi, x_lo, *x_t = K.tc32_split_t(x2, rows=True, **seq)
    do_hi, do_lo, *do_t = K.tc32_split_t(dout, rows=True, **seq)

    def gemm(a_hi, a_lo, w_hi, w_lo):
        return K.tc32_gemm(a_hi, a_lo, w_hi, w_lo, lib=lib)
    q = gemm(xn_hi, xn_lo, wqkv_hi[:hd], wqkv_lo[:hd])
    kv = gemm(x_hi, x_lo, wqkv_hi[hd:], wqkv_lo[hd:])
    dmerged = gemm(do_hi, do_lo, *wo_t)
    layout = dict(sequences=sequences, inner=inner, heads=heads, n=n, d=dim_head,
                  q_strides=q_strides, kv_strides=kv_strides,
                  q_scale=q_scale.float() * scale, k_scale=k_scale)
    dbias = None
    if core == K.QK_SHORT:
        *planes, dqs, dks = K.qk_attention_short_bwd(q, kv, dmerged, **layout)
        dq, dkv = planes[0:2], planes[2:4]
        merged_t, dq_t, dkv_t = planes[4:6], planes[6:8], planes[8:10]
    else:
        merged, dq32, dkv32, dqs, dks, dbias = K.qk_attention_bwd(
            q, kv, dmerged, bias=None if bias is None else bias.float().contiguous(), **layout)
        merged_t = K.tc32_split_t(merged, **seq)
        dq_hi, dq_lo, *dq_t = K.tc32_split_t(dq32, rows=True, **seq)
        dkv_hi, dkv_lo, *dkv_t = K.tc32_split_t(dkv32, rows=True, **seq)
        dq, dkv = (dq_hi, dq_lo), (dkv_hi, dkv_lo)
    dxn = gemm(*dq, wqkv_t_hi[:, :hd], wqkv_t_lo[:, :hd])
    dx_kv = gemm(*dkv, wqkv_t_hi[:, hd:], wqkv_t_lo[:, hd:])
    dx, dgamma, _ = K.layernorm_bwd(x2, gamma, dxn, 1e-5, add=dx_kv, add2=dout)
    tn = functools.partial(K.tc32_gemm_tn, lib=lib)
    return (dx.view(x.shape), dgamma, tn(*dq_t, *xn_t), tn(*dkv_t, *x_t), dqs * scale, dks,
            tn(*do_t, *merged_t), dbias)


def _qknorm_attention_bwd_short(x, gamma, wq, wkv, q_scale, k_scale, wout, dout, heads,
                                dim_head, scale, grid: bool):
    """K10 bf16's backward on the short route, at small_attention.py::
    _bwd_kernel's rounding points (`small_qknorm_bwd_plain`): xn = bf16(LN(x))
    (layernorm.cu), q = xn wq^T and kv = x wkv^T kept f32 (ffn_tc.cu's NT
    form GEMM_NT_F32), dmerged = dO wout in f32 (the NN form), the short
    core's bf16 form (f32 inside; dq, dkv and merged rounded once), dxn = dq
    wq and dx_kv = dkv wkv in f32 (NN), the LN backward with dx_kv and dO,
    and dWq = dq^T xn, dWkv = dkv^T x, dWout = dO^T merged on the TN form,
    f32 over all rows: every product on ffn_tc.cu's bf16 `wgmma` forms."""
    dim = x.shape[-1]
    hd = heads * dim_head
    x2 = x.view(-1, dim)
    rows = x2.shape[0]
    dout = dout.to(x.dtype).contiguous().view(rows, dim)
    sequences, inner, q_strides, kv_strides, n = _layout(x, hd, dim_head, grid)
    wq_c, wkv_c, wout_c = (w.to(x.dtype).contiguous() for w in (wq, wkv, wout))
    xn = torch.empty_like(x2)
    K.layernorm(x2, gamma, None, 1e-5, xn)
    q = K.gemm_nt_tc(xn, wq_c, torch.float32)
    kv = K.gemm_nt_tc(x2, wkv_c, torch.float32)
    f32 = dict(dtype=torch.float32, device=x.device)
    dmerged = K.gemm_nn_tc(dout, wout_c, torch.empty((rows, hd), **f32))
    merged, dq, dkv, dqs, dks = K.qk_attention_short_bwd(
        q, kv, dmerged, sequences=sequences, inner=inner, heads=heads, n=n, d=dim_head,
        q_strides=q_strides, kv_strides=kv_strides, q_scale=q_scale.float() * scale,
        k_scale=k_scale, out_dtype=torch.bfloat16)
    dxn = K.gemm_nn_tc(dq, wq_c, torch.empty((rows, dim), **f32))
    dx_kv = K.gemm_nn_tc(dkv, wkv_c, torch.empty((rows, dim), **f32))
    dx, dgamma, _ = K.layernorm_bwd(x2, gamma, dxn, 1e-5, add=dx_kv, add2=dout)
    return (dx.view(x.shape), dgamma, K.gemm_tn_tc(dq, xn), K.gemm_tn_tc(dkv, x2),
            dqs * scale, dks, K.gemm_tn_tc(dout, merged), None)


def _qknorm_attention_bwd_cuda(x, gamma, wq, wkv, q_scale, k_scale, wout, bias,
                               dout, heads, dim_head, scale, grid: bool):
    cdt, f32 = x.dtype, torch.float32
    dim = x.shape[-1]
    hd = heads * dim_head
    sequences, inner, q_strides, kv_strides, n = _layout(x, hd, dim_head, grid)
    core = K.qk_bwd_route(cdt, n, dim_head, heads, bias is not None)
    tc = proj_route(cdt, dim, hd) == PROJ_WGMMA
    if cdt == f32 and core != K.QK_CUDA_CORES:
        return _qknorm_attention_bwd_tc32(x, gamma, wq, wkv, q_scale, k_scale, wout, bias, dout,
                                          heads, dim_head, scale, grid, core)
    if core == K.QK_SHORT and tc:
        return _qknorm_attention_bwd_short(x, gamma, wq, wkv, q_scale, k_scale, wout, dout,
                                           heads, dim_head, scale, grid)
    x2 = x.view(-1, dim)
    rows = x2.shape[0]
    dout = dout.to(cdt).contiguous().view(rows, dim)
    wq_c, wkv_c, wout_c = (w.to(cdt).contiguous() for w in (wq, wkv, wout))
    xn, q, kv = _project(x2, gamma, wq, wkv, hd)
    # bf16 products on ffn_tc.cu's `wgmma` forms where its TMA copies take the
    # rows (K9 bf16: dmerged rounded once, as gemm.cu rounds it), else gemm.cu
    nn = K.gemm_nn_tc if tc else K.gemm_nn
    tn = K.gemm_tn_tc if tc else K.gemm_tn
    dmerged = nn(dout, wout_c, torch.empty((rows, hd), dtype=cdt, device=x.device))
    groups = min(sequences, -(-TARGET_BLOCKS // heads) if bias is not None else GRID_GROUPS)
    merged, dq, dkv, dqs, dks, dbias = K.qk_attention_bwd(
        q, kv, dmerged, sequences=sequences, inner=inner, heads=heads, n=n,
        d=dim_head, q_strides=q_strides, kv_strides=kv_strides,
        q_scale=q_scale.float() * scale, k_scale=k_scale,
        bias=None if bias is None else bias.float().contiguous(),
        group=-(-sequences // groups), warps=8 if n >= 128 else 2)
    dxn = nn(dq, wq_c, torch.empty((rows, dim), dtype=f32, device=x.device))
    dx_kv = nn(dkv, wkv_c, torch.empty((rows, dim), dtype=f32, device=x.device))
    dx, dgamma, _ = K.layernorm_bwd(x2, gamma, dxn, 1e-5, add=dx_kv, add2=dout)
    return (dx.view(x.shape), dgamma, tn(dq, xn), tn(dkv, x2),
            dqs * scale, dks, tn(dout, merged), dbias)


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
