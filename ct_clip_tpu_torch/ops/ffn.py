"""LN -> GEGLU feed-forward -> + x, the MaskGIT transformer's FF sublayer.

Port of ct_clip_tpu/ops/mlp.py::MaskgitFeedForward and the TPU kernel
ct_clip_tpu/ops/pallas/ffn.py::fused_geglu_ff (K3), held against its plain
twin `_xla_ff` (exact-erf GELU).  Weights are in nn.Linear layout:
wi (2*inner, dim) with the value half first and the gate half second (torch
chunk order), wo (dim, inner).

The residual is always added (the transformer's `ff(x) + x`).  On a bf16
CUDA tensor (`fwd_route`): LN (csrc/layernorm.cu), then one product that
computes the value and gate tiles side by side and writes value *
gelu(gate), then act * wo^T + x, both on the tensor cores with `wgmma`
and TMA copies (csrc/ffn_tc.cu's GEGLU and residual forms) where the model
width suits TMA (a multiple of 8), else on csrc/gemm.cu's WMMA epilogues
(EPI_GEGLU, EPI_RESIDUAL), rounded at the same points.  On an f32 one
(the f32 form: the weights and every intermediate in f32, as the TPU
kernel's `dot_precision` takes "highest" for f32 operands) the same
steps in 3xTF32 on the tensor cores (csrc/ffn_tc32.cu): the LN written as
TF32 hi and lo planes, each product three TF32 products per f32 one, act
written split, x added in f32.  The inner width is padded from 1365 to a
multiple of 8 with zero weight rows so every product takes 16-byte loads;
the padded columns of the intermediate are exactly zero and meet zero
columns of wo.

The backward is the port of ffn.py::_pallas_ff_bwd (K11): it saves only the
sublayer's input and recomputes flash-style.  On a CUDA tensor: LN again,
one tile kernel that recomputes a and g and takes dact = do wo with the
GEGLU derivative (act, da, dg in the compute dtype), dxn = [da | dg] [wa;
wg] (NN product), the LN backward with the identity term
(csrc/layernorm.cu), and the weight gradients [dwa; dwg] = [da | dg]^T
LN(x) and dwo = do^T act over all rows in f32 (TN products): in bf16 the
tile and the three products on the tensor cores with `wgmma`
(csrc/ffn_tc.cu), in f32 the same in 3xTF32 on `wgmma` (csrc/ffn_tc32.cu,
`_geglu_ff_bwd_tc32`: the tile writes dcat and act as TF32 planes, the TN
products read transposed planes, as TF32 `wgmma` reads K-major operands
only).  The padding's gradient rows are dropped.  Its plain version is
autograd of the plain forward (`geglu_ff_bwd_plain`), the XLA twin's VJP in
the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import kernels as K
from .autograd import vjp
from .norms import layer_norm


def geglu_ff_plain(x, scale, bias, wi, wo, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version on (rows, dim) x."""
    dtype = x.dtype
    inner = wo.shape[1]
    xn = layer_norm(x, scale, bias, eps)
    hcat = xn @ wi.to(dtype).t()
    act = (hcat[:, :inner].float() * F.gelu(hcat[:, inner:].float())).to(dtype)
    return ((act @ wo.to(dtype).t()).float() + x.float()).to(dtype)


def geglu_ff_bwd_plain(x, scale, bias, wi, wo, dout, eps: float = 1e-5):
    """Plain version of the backward: (dx, dscale, dbias, dwi, dwo), the VJP
    of `geglu_ff_plain` at dout."""
    return vjp(lambda *a: geglu_ff_plain(*a, eps), (x, scale, bias, wi, wo), dout)


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.zeros((rows,) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    out[: w.shape[0]] = w
    return out


def _value_gate(wi, inner: int, padded: int, dtype) -> torch.Tensor:
    """(2 padded, dim) [wa; wg]: wi's value and gate halves in `dtype`, each
    padded to `padded` rows with zeros (ffn_tc.cu's operand)."""
    wic = wi.to(dtype)
    return torch.cat([_pad_rows(wic[:inner], padded), _pad_rows(wic[inner:], padded)])


def _inner(x, wi, wo):
    """(inner, padded inner) of the FF weights, checked against x."""
    dim, inner = x.shape[1], wo.shape[1]
    if wi.shape != (2 * inner, dim) or wo.shape[0] != dim:
        raise ValueError(f"FF weights {tuple(wi.shape)}, {tuple(wo.shape)} "
                         f"do not fit dim {dim}")
    return inner, -(-inner // 8) * 8


# the forward's routes on a CUDA tensor (`fwd_route`)
FF_WGMMA, FF_WMMA, FF_TC32 = "ffn_tc.cu", "gemm.cu", "ffn_tc32.cu"


def fwd_route(dtype: torch.dtype, dim: int) -> str:
    """The source of K3's products for a CUDA tensor of `dtype` and model
    width `dim`: FF_TC32 (f32, 3xTF32 on `wgmma`), FF_WGMMA (bf16 where
    ffn_tc.cu's TMA copies take the rows: the width a multiple of 8; the
    padded inner width always is) or FF_WMMA (bf16 at any other width,
    gemm.cu)."""
    if dtype == torch.float32:
        return FF_TC32
    return FF_WGMMA if dim % 8 == 0 else FF_WMMA


def _geglu_ff_gemm(x, scale, bias, wi, wo, eps):
    """K3 on csrc/gemm.cu: bf16 on WMMA (the f32 form, FFMA register tiles,
    is what `_geglu_ff_tc32` replaced on the f32 route); the bf16 route of
    widths TMA cannot take, and what `_geglu_ff_tc` replaced elsewhere."""
    rows, dim = x.shape
    inner, padded = _inner(x, wi, wo)
    cdt = x.dtype
    wcat = _value_gate(wi, inner, padded, cdt)
    wo_p = torch.zeros((dim, padded), dtype=cdt, device=x.device)
    wo_p[:, :inner] = wo
    xn = torch.empty_like(x)
    K.layernorm(x, scale, bias, eps, xn)
    act = torch.empty((rows, padded), dtype=cdt, device=x.device)
    K.gemm(K.EPI_GEGLU, xn, wcat[:padded], act, w2=wcat[padded:])
    out = torch.empty_like(x)
    K.gemm(K.EPI_RESIDUAL, act, wo_p, out, residual=x)
    return out


def _geglu_ff_tc(x, scale, bias, wi, wo, eps, lib=None):
    """The bf16 K3 on csrc/ffn_tc.cu: LN (layernorm.cu), then
    `kernels.ff_tc_fwd`, its GEGLU and residual products on `wgmma`.  `lib`:
    a one-change copy of ffn_tc.cu for the card checks."""
    dim = x.shape[1]
    inner, padded = _inner(x, wi, wo)
    if x.data_ptr() % 16:  # TMA reads rows from 16-byte boundaries: a stated copy
        x = x.clone()
    wo_p = torch.zeros((dim, padded), dtype=x.dtype, device=x.device)
    wo_p[:, :inner] = wo
    xn = torch.empty_like(x)
    K.layernorm(x, scale, bias, eps, xn)
    return K.ff_tc_fwd(x, xn, _value_gate(wi, inner, padded, x.dtype), wo_p, lib=lib)


def _tc32_weights(wi, wo, padded: int) -> torch.Tensor:
    """(3, padded * dim) f32: the value and gate halves of wi (padded, dim)
    and wo (dim, padded), the padding zero: `kernels.ff_tc32`'s operand."""
    dim, inner = wo.shape
    w = torch.zeros((3, padded * dim), dtype=torch.float32, device=wi.device)
    w[0].view(padded, dim)[:inner] = wi[:inner]
    w[1].view(padded, dim)[:inner] = wi[inner:]
    w[2].view(dim, padded)[:, :inner] = wo
    return w


def _geglu_ff_tc32(x, scale, bias, wi, wo, eps, lib=None):
    """The f32 K3 in 3xTF32 on csrc/ffn_tc32.cu: LN written split into TF32
    hi and lo planes (layernorm.cu), then `kernels.ff_tc32`.  `lib`: a
    one-change copy of ffn_tc32.cu for the card checks."""
    _, padded = _inner(x, wi, wo)
    xn_hi, xn_lo = K.layernorm_split(x, scale, bias, eps)
    return K.ff_tc32(x, xn_hi, xn_lo, _tc32_weights(wi, wo, padded), lib=lib)


def _geglu_ff_cuda(x, scale, bias, wi, wo, eps):
    route = fwd_route(x.dtype, x.shape[1])
    ff = {FF_TC32: _geglu_ff_tc32, FF_WGMMA: _geglu_ff_tc}.get(route, _geglu_ff_gemm)
    out = ff(x, scale, bias, wi, wo, eps)
    K.count_launch("geglu_ff", x.dtype)
    return out


def bwd_kernels(dtype: torch.dtype):
    """K11's tile, NN product and TN product for the compute dtype: bf16 on
    csrc/ffn_tc.cu (`wgmma`: ff_tc_tile, gemm_nn_tc, gemm_tn_tc), f32 in
    3xTF32 on csrc/ffn_tc32.cu (`wgmma`: ff_tc32_tile, tc32_gemm, whose
    operands are TF32 planes, tc32_gemm_tn, on transposed planes)."""
    if dtype == torch.bfloat16:
        return K.ff_tc_tile, K.gemm_nn_tc, K.gemm_tn_tc
    return K.ff_tc32_tile, K.tc32_gemm, K.tc32_gemm_tn


def _geglu_ff_bwd_products(x, scale, bias, wi, wo, dout, eps, tile, gemm_nn, gemm_tn):
    """K11 on one dtype's tile, NN and TN products over unsplit operands:
    bf16 `bwd_kernels`; in f32 csrc/gemm.cu's FFMA forms (K.ff_bwd_core,
    K.gemm_nn, K.gemm_tn), the path `_geglu_ff_bwd_tc32` replaced, which the
    card checks time beside it."""
    rows, dim = x.shape
    inner = wo.shape[1]
    padded = -(-inner // 8) * 8
    cdt = x.dtype
    wcat = _value_gate(wi, inner, padded, cdt)
    woT = _pad_rows(wo.to(cdt).t(), padded)
    dout = dout.to(cdt).contiguous()
    xn = torch.empty_like(x)
    K.layernorm(x, scale, bias, eps, xn)
    act, dcat = tile(xn, dout, wcat[:padded], wcat[padded:], woT)
    dxn = torch.empty((rows, dim), dtype=torch.float32, device=x.device)
    gemm_nn(dcat, wcat, dxn)
    dx, dscale, dbias = K.layernorm_bwd(x, scale, dxn, eps, add2=dout, want_dbias=True)
    dwcat = gemm_tn(dcat, xn)
    dwi = torch.cat([dwcat[:inner], dwcat[padded:padded + inner]])
    dwo = gemm_tn(dout, act)[:, :inner]
    return dx, dscale, dbias, dwi, dwo


def _geglu_ff_bwd_tc32(x, scale, bias, wi, wo, dout, eps, lib=None):
    """The f32 K11 in 3xTF32 on csrc/ffn_tc32.cu: the weights split once, [wa;
    wg] also transposed (the NN product's B) and wo as wo^T; LN(x) written
    split, xn^T and dout^T as transposed planes (`kernels.tc32_split_t`);
    the tile (dcat and its transpose, act^T); dxn = dcat [wa; wg]; the LN
    backward with the identity term; [dwa; dwg] = dcat^T xn and dwo = dout^T
    act on the TN form.  `lib`: a one-change copy of ffn_tc32.cu for the
    card checks."""
    inner, padded = _inner(x, wi, wo)
    tile, gemm_nn, gemm_tn = bwd_kernels(torch.float32)
    dout = dout.float().contiguous()
    wcat = _value_gate(wi, inner, padded, torch.float32)
    wo_p = torch.zeros((x.shape[1], padded), dtype=torch.float32, device=x.device)
    wo_p[:, :inner] = wo
    wc_hi, wc_lo, wc_t_hi, wc_t_lo = K.tc32_split_t(wcat, rows=True, lib=lib)
    wo_t = K.tc32_split_t(wo_p, lib=lib)
    xn_hi, xn_lo = K.layernorm_split(x, scale, bias, eps)
    xn_t = K.tc32_split_t(xn_hi, xn_lo, lib=lib)
    do_hi, do_lo, *do_t = K.tc32_split_t(dout, rows=True, lib=lib)
    dcat_hi, dcat_lo, *planes = tile(xn_hi, xn_lo, do_hi, do_lo, (wc_hi[:padded], wc_lo[:padded]),
                                     (wc_hi[padded:], wc_lo[padded:]), wo_t, lib=lib)
    dxn = gemm_nn(dcat_hi, dcat_lo, wc_t_hi, wc_t_lo, lib=lib)
    dx, dscale, dbias = K.layernorm_bwd(x, scale, dxn, eps, add2=dout, want_dbias=True)
    dwcat = gemm_tn(*planes[:2], *xn_t, lib=lib)
    dwi = torch.cat([dwcat[:inner], dwcat[padded:padded + inner]])
    dwo = gemm_tn(*do_t, *planes[2:], lib=lib)[:, :inner]
    return dx, dscale, dbias, dwi, dwo


def _geglu_ff_bwd_cuda(x, scale, bias, wi, wo, dout, eps):
    if x.dtype == torch.float32:
        grads = _geglu_ff_bwd_tc32(x, scale, bias, wi, wo, dout, eps)
    else:
        grads = _geglu_ff_bwd_products(x, scale, bias, wi, wo, dout, eps, *bwd_kernels(x.dtype))
    K.count_launch("geglu_ff_bwd", x.dtype)
    return grads


class _GegluFF(torch.autograd.Function):
    """K3 forward, K11 backward, on CUDA tensors; only x is saved."""

    @staticmethod
    def forward(ctx, x, scale, bias, wi, wo, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias, wi, wo)
        return _geglu_ff_cuda(x, scale, bias, wi, wo, eps)

    @staticmethod
    def backward(ctx, dout):
        x, scale, bias, wi, wo = ctx.saved_tensors
        dx, dscale, dbias, dwi, dwo = _geglu_ff_bwd_cuda(x, scale, bias, wi, wo, dout,
                                                         ctx.eps)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype), dwi.to(wi.dtype),
                dwo.to(wo.dtype), None)


def fused_geglu_ff(x: torch.Tensor, scale, bias, wi, wo,
                   eps: float = 1e-5) -> torch.Tensor:
    """x + geglu(LN(x) wi^T) wo^T for 2-D x (rows, dim).  Differentiable:
    on CUDA the backward is the port of K11.  A CUDA tensor must be bf16 or
    f32 (`kernels.ROUTES`)."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, scale, bias, wi, wo, eps)
    if K.route("geglu_ff", x.dtype) != K.KERNEL:
        raise K.not_ported("geglu_ff", x.dtype)
    return _GegluFF.apply(x.contiguous(), scale, bias, wi, wo, eps)


class MaskgitFeedForward(nn.Sequential):
    """transformer_maskgit/attention.py:44-52; the Sequential's indices
    reproduce the reference (0 LayerNorm, 1 Linear wi, 2 GEGLU, 3 Dropout,
    4 Linear wo), so state-dict keys line up.  Slots 2 and 3 hold no
    parameters; forward runs the fused op and adds the residual."""

    def __init__(self, dim: int, device=None):
        inner = int(4 * (2.0 / 3.0) * dim)  # reference mult=4
        super().__init__(
            nn.LayerNorm(dim, device=device),
            nn.Linear(dim, inner * 2, bias=False, device=device),
            nn.Identity(), nn.Identity(),
            nn.Linear(inner, dim, bias=False, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln, wi, wo = self[0], self[1], self[4]
        out = fused_geglu_ff(x.reshape(-1, x.shape[-1]), ln.weight, ln.bias,
                             wi.weight, wo.weight, ln.eps)
        return out.view(x.shape)
