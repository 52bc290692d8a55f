"""LN -> GEGLU feed-forward -> + x, the MaskGIT transformer's FF sublayer.

Port of ct_clip_tpu/ops/mlp.py::MaskgitFeedForward and the TPU kernel
ct_clip_tpu/ops/pallas/ffn.py::fused_geglu_ff (K3), held against its plain
twin `_xla_ff` (exact-erf GELU).  Weights are in nn.Linear layout:
wi (2*inner, dim) with the value half first and the gate half second (torch
chunk order), wo (dim, inner).

The residual is always added (the transformer's `ff(x) + x`).  On a CUDA
tensor (bf16, or f32: the f32 forms, which keep the weights and every
intermediate in f32 and take true f32 products, as the TPU kernel's
`dot_precision` does for f32 operands): LN (csrc/layernorm.cu), then one
product that computes the
value and gate tiles side by side and writes value * gelu(gate) (GEGLU
epilogue, csrc/gemm.cu), then act * wo^T + x (residual epilogue).  The
inner width is padded from 1365 to a multiple of 8 with zero weight rows so
every product takes 16-byte loads; the padded columns of the intermediate
are exactly zero and meet zero columns of wo.

The backward is the port of ffn.py::_pallas_ff_bwd (K11): it saves only the
sublayer's input and recomputes flash-style.  On a CUDA tensor: LN again,
one tile kernel that recomputes a and g and takes dact = do wo with the
GEGLU derivative (act, da, dg in the compute dtype), dxn = [da | dg] [wa;
wg] (NN product), the LN backward with the identity term
(csrc/layernorm.cu), and the weight gradients [dwa; dwg] = [da | dg]^T
LN(x) and dwo = do^T act over all rows in f32 (TN products): in bf16 the
tile and the three products on the tensor cores with `wgmma`
(csrc/ffn_tc.cu), in f32 csrc/gemm.cu's f32 forms (`bwd_kernels`).  The
padding's gradient rows are dropped.  Its plain version is autograd of the plain
forward (`geglu_ff_bwd_plain`), the XLA twin's VJP in the JAX package.
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


def _geglu_ff_cuda(x, scale, bias, wi, wo, eps):
    rows, dim = x.shape
    inner = wo.shape[1]
    padded = -(-inner // 8) * 8
    cdt = x.dtype  # the compute dtype: bf16, or f32 for the f32 forms
    if wi.shape != (2 * inner, dim) or wo.shape[0] != dim:
        raise ValueError(f"FF weights {tuple(wi.shape)}, {tuple(wo.shape)} "
                         f"do not fit dim {dim}")
    wic = wi.to(cdt)
    wa = _pad_rows(wic[:inner], padded)
    wg = _pad_rows(wic[inner:], padded)
    wo_p = torch.zeros((dim, padded), dtype=cdt, device=x.device)
    wo_p[:, :inner] = wo
    xn = torch.empty_like(x)
    K.layernorm(x, scale, bias, eps, xn)
    act = torch.empty((rows, padded), dtype=cdt, device=x.device)
    K.gemm(K.EPI_GEGLU, xn, wa, act, w2=wg)
    out = torch.empty_like(x)
    K.gemm(K.EPI_RESIDUAL, act, wo_p, out, residual=x)
    K.count_launch("geglu_ff", cdt)
    return out


def bwd_kernels(dtype: torch.dtype):
    """K11's tile, NN product and TN product for the compute dtype: bf16 on
    csrc/ffn_tc.cu (`wgmma`: ff_tc_tile, gemm_nn_tc, gemm_tn_tc), f32 on
    csrc/gemm.cu's f32 forms (ff_bwd_core, gemm_nn, gemm_tn)."""
    if dtype == torch.bfloat16:
        return K.ff_tc_tile, K.gemm_nn_tc, K.gemm_tn_tc
    return K.ff_bwd_core, K.gemm_nn, K.gemm_tn


def _geglu_ff_bwd_cuda(x, scale, bias, wi, wo, dout, eps):
    rows, dim = x.shape
    inner = wo.shape[1]
    padded = -(-inner // 8) * 8
    cdt = x.dtype
    wic = wi.to(cdt)
    wcat = torch.cat([_pad_rows(wic[:inner], padded), _pad_rows(wic[inner:], padded)])
    woT = _pad_rows(wo.to(cdt).t(), padded)
    dout = dout.to(cdt).contiguous()
    xn = torch.empty_like(x)
    K.layernorm(x, scale, bias, eps, xn)
    tile, gemm_nn, gemm_tn = bwd_kernels(cdt)
    act, dcat = tile(xn, dout, wcat[:padded], wcat[padded:], woT)
    dxn = torch.empty((rows, dim), dtype=torch.float32, device=x.device)
    gemm_nn(dcat, wcat, dxn)
    dx, dscale, dbias = K.layernorm_bwd(x, scale, dxn, eps, add2=dout, want_dbias=True)
    dwcat = gemm_tn(dcat, xn)
    dwi = torch.cat([dwcat[:inner], dwcat[padded:padded + inner]])
    dwo = gemm_tn(dout, act)[:, :inner]
    K.count_launch("geglu_ff_bwd", cdt)
    return dx, dscale, dbias, dwi, dwo


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
