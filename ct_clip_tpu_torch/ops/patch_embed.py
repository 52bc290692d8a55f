"""Patch embedding: patchify -> LN(patch_dim) -> projection + bias -> LN(dim).

Port of five TPU kernels of ct_clip_tpu/ops/pallas/patchify.py and their
plain twins.  The reference chain is CTViT's to_patch_emb
(transformer_maskgit/ctvit.py:170-175): Rearrange to '(c pt p1 p2)' patch
rows, LayerNorm(4000), Linear(4000, 512), LayerNorm(512).

  * `fused_patch_embed` (K8) embeds a (b, F, H, W) volume.  On a bf16 CUDA
    tensor it runs on csrc/embed_tc.cu (`kernels.embed_tc`): each patch
    row's mean and rstd in a pre-pass through the patch gather, then one
    `wgmma` kernel that gathers the raw rows' k blocks into shared memory,
    normalises them there and multiplies them by W, so the (tokens, 4000)
    normalised rows never reach device memory, LN(512) in its epilogue.  Its
    backward is K16a (`_pallas_patch_embed_bwd`), which saves only the
    volume and recomputes the normalised rows: the six weight gradients and,
    when the volume requires grad, d(volume) through K17.  Its three
    products run on csrc/ffn_tc.cu's `wgmma`, and without d(volume) the
    LN(4000) scale and bias gradients come out of the dxn product's
    epilogue, so dxn never reaches device memory (`_patch_embed_bwd_cuda`).
  * `rearrange_patches` (K6) moves a volume into patch rows
    (csrc/rearrange.cu): the last stage of the patch-row ingest, where it
    writes into a view the caller passes (one slot of the batch buffer), and
    the first stage of the volume training embed.  Its backward is K17
    (`_pallas_unrearrange`, `unrearrange_patches`), the move back, which
    the CTViT decoder also runs forward on its pixel rows (`unpatchify`,
    whose backward is K6).
  * `fused_row_embed` (K4) embeds patch rows: the same kernel with the
    rows' k blocks copied by TMA.  Its backward is K16b
    (`_pallas_row_embed_bwd`), with d(rows) when the rows require grad.

A width embed_tc.cu does not take (`kernels.embed_fits`; every config of
the repo fits) raises.  K16b's backward recomputes the normalised rows on
csrc/layernorm.cu and the product on csrc/gemm.cu (`_embed_tail_bwd`).  Each
backward's plain version is autograd of the plain forward, the JAX package's
XLA VJP; a CPU tensor takes it.

Dtypes on CUDA (`kernels.ROUTES`): K6 and K17 move bf16 or f32 (their f32
forms, as the TPU kernels move f32 blocks).  The JAX package runs K8, K4,
K16a and K16b in bf16 only and computes f32 embeds in XLA (patchify.py:440,
685, 700, 714), so an f32 embed on CUDA takes the plain version and its
autograd, counted as `patch_embed_plain` / `row_embed_plain`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernels as K
from .autograd import vjp
from .norms import layer_norm


def patchify(video: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    """(b, F, H, W) -> (b, t*h*w, pt*p*p) patch rows in (pt, p1, p2) order,
    as a strided view."""
    b, F, H, W = video.shape
    t, h, w = F // pt, H // p, W // p
    x = video.reshape(b, t, pt, h, p, w, p).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(b, t * h * w, pt * p * p)


def _check_tiling(shape, pt: int, p: int) -> None:
    _, F, H, W = shape
    if F % pt or H % p or W % p:
        raise ValueError(f"video {tuple(shape)} does not tile into {pt}x{p}x{p} patches")


def rearrange_plain(video: torch.Tensor, pt: int, p: int) -> torch.Tensor:
    """Plain PyTorch version of K6: the patchify view made contiguous."""
    return patchify(video, pt, p).contiguous()


def unrearrange_plain(rows: torch.Tensor, pt: int, p: int, F: int, H: int,
                      W: int) -> torch.Tensor:
    """Plain PyTorch version of K17: the inverse of the patchify view, made
    contiguous."""
    b = rows.shape[0]
    x = rows.reshape(b, F // pt, H // p, W // p, pt, p, p).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, F, H, W).contiguous()


def unrearrange_patches(rows: torch.Tensor, pt: int, p: int, F: int, H: int,
                        W: int) -> torch.Tensor:
    """(b, t*h*w, pt*p*p) patch rows -> the (b, F, H, W) volume they came
    from (K17, K6's VJP); the values move untouched.  A CPU tensor takes the
    plain version; a CUDA tensor (bf16 or f32) takes the kernel."""
    if rows.device.type == "cpu":
        _check_tiling((rows.shape[0], F, H, W), pt, p)
        return unrearrange_plain(rows, pt, p, F, H, W)
    out = rows.new_empty((rows.shape[0], F, H, W))
    K.unrearrange_patches(rows.contiguous(), pt, p, out)  # the tiling checked there
    K.count_launch("unrearrange_patches", rows.dtype)
    return out


def _rearrange_into(video, pt: int, p: int, out: Optional[torch.Tensor]) -> torch.Tensor:
    b, F, H, W = video.shape
    n = (F // pt) * (H // p) * (W // p)
    if video.device.type == "cpu":
        if out is None:
            return rearrange_plain(video, pt, p)
        if out.shape != (b, n, pt * p * p):
            raise ValueError(f"out {tuple(out.shape)} does not fit the rows")
        return out.copy_(patchify(video, pt, p))
    if out is None:
        out = torch.empty((b, n, pt * p * p), dtype=video.dtype, device=video.device)
    K.rearrange_patches(video.contiguous(), pt, p, out)
    K.count_launch("rearrange_patches", video.dtype)
    return out


class _Rearrange(torch.autograd.Function):
    """K6 forward, K17 backward; nothing is saved but the geometry."""

    @staticmethod
    def forward(ctx, video, pt, p):
        ctx.geom = (pt, p) + tuple(video.shape[1:])
        return _rearrange_into(video, pt, p, None)

    @staticmethod
    def backward(ctx, drows):
        return unrearrange_patches(drows, *ctx.geom), None, None


def rearrange_patches(video: torch.Tensor, pt: int, p: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, F, H, W) -> (b, t*h*w, pt*p*p) patch rows in (pt, p1, p2) order.
    The values move untouched.  A CPU tensor takes the plain version; a CUDA
    tensor (bf16 or f32) takes the kernel.  Differentiable (the backward
    is K17), except when written into `out` (its rows contiguous, as in
    `buf[slot:slot + 1]` of a (B, n, patch_dim) batch buffer), which the
    ingest does with data that needs no gradient."""
    _check_tiling(video.shape, pt, p)
    if out is None:
        return _Rearrange.apply(video, pt, p)
    if torch.is_grad_enabled() and video.requires_grad:
        raise ValueError("rearrange_patches: writing into `out` takes no gradient")
    return _rearrange_into(video, pt, p, out)


class _Unrearrange(torch.autograd.Function):
    """K17 forward, K6 backward; nothing is saved but the geometry."""

    @staticmethod
    def forward(ctx, rows, pt, p, F, H, W):
        ctx.geom = (pt, p)
        return unrearrange_patches(rows, pt, p, F, H, W)

    @staticmethod
    def backward(ctx, dvideo):
        return (_rearrange_into(dvideo.contiguous(), *ctx.geom, None),
                None, None, None, None, None)


def unpatchify(rows: torch.Tensor, pt: int, p: int, F: int, H: int,
               W: int) -> torch.Tensor:
    """`unrearrange_patches` as a differentiable function (the backward is
    K6): the CTViT decoder's pixel rows, (b, t*h*w, pt*p*p) in (pt, p1, p2)
    order, back onto the (b, F, H, W) volume (ctvit.py:322-328)."""
    return _Unrearrange.apply(rows, pt, p, F, H, W)


def row_embed_plain(rows: torch.Tensor, s1, b1, w, pbias, s2, b2,
                    eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K4 on (b, n, patch_dim) rows.  `w` is the
    Linear weight (dim, patch_dim).  Rounding points follow
    `row_embed_train` (patchify.py:578-597): the normalised rows and the
    product round to the rows' dtype before the bias add."""
    dtype = rows.dtype
    x = layer_norm(rows, s1, b1, eps)
    y = x @ w.to(dtype).t()
    return layer_norm(y + pbias.to(dtype), s2, b2, eps)


def patch_embed_plain(video, s1, b1, w, pbias, s2, b2, pt: int, p: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K8: the row embed of the patchify view, as
    `_xla_patch_embed` computes it."""
    return row_embed_plain(patchify(video, pt, p), s1, b1, w, pbias, s2, b2, eps)


def patch_embed_bwd_plain(video, s1, b1, w, pbias, s2, b2, dout, pt: int, p: int,
                          eps: float = 1e-5):
    """Plain version of K16a with d(video): (dvideo, ds1, db1, dw, dpbias,
    ds2, db2), the VJP of `patch_embed_plain` at dout."""
    return vjp(lambda *a: patch_embed_plain(*a, pt, p, eps),
               (video, s1, b1, w, pbias, s2, b2), dout)


def row_embed_bwd_plain(rows, s1, b1, w, pbias, s2, b2, dout, eps: float = 1e-5):
    """Plain version of K16b: (drows, ds1, db1, dw, dpbias, ds2, db2), the
    VJP of `row_embed_plain` at dout."""
    return vjp(lambda *a: row_embed_plain(*a, eps), (rows, s1, b1, w, pbias, s2, b2), dout)


def _embed_tail_bwd(xn, w, pbias, s2, dout, eps):
    """The backward of the embed's product, bias and LN(dim) from the
    normalised rows xn (R, pd), as _embed_bwd_kernel (patchify.py:285-306) computes it: the product and
    its rounded bias add again, the LN(dim) backward (dyb, ds2, db2 and dpb,
    the column sum of the f32 dyb), dW = dyb^T xn (split TN product) and
    dxn = dyb W (NN product), f32."""
    bf = torch.bfloat16
    R, pd = xn.shape
    dim = w.shape[0]
    wb = w.to(bf).contiguous()
    yb = torch.empty((R, dim), dtype=bf, device=xn.device)
    K.gemm(K.EPI_BIAS_ROUNDED, xn, wb, yb, bias=pbias.to(bf).contiguous())
    dyn = dout.reshape(R, dim).float().contiguous()
    dyb, ds2, db2, dpb = K.layernorm_bwd(yb, s2, dyn, eps, want_dbias=True, want_dxsum=True)
    del yb
    dw = K.gemm_tn(dyb, xn)
    dxn = torch.empty((R, pd), dtype=torch.float32, device=xn.device)
    K.gemm_nn(dyb, wb, dxn)
    return dxn, dw, dpb, ds2, db2


def _patch_embed_cuda(video, s1, b1, w, pbias, s2, b2, pt, p, eps):
    b, F, H, W = video.shape
    n = (F // pt) * (H // p) * (W // p)
    out = K.embed_tc(video, s1, b1, w, pbias, s2, b2, eps, geom=(pt, p)).view(b, n, -1)
    K.count_launch("patch_embed")
    return out


def _patch_embed_bwd_cuda(video, s1, b1, w, pbias, s2, b2, dout, pt, p, eps,
                          want_dvideo: bool):
    """K16a: (dvideo or None, ds1, db1, dw, dpbias, ds2, db2), as
    _embed_bwd_kernel (patchify.py:269-327) computes them, its products on
    csrc/ffn_tc.cu's `wgmma`: the patch LN again (with each row's mean and
    rstd), yb = xn W^T + b rounded as the TPU kernel rounds it (NT), the
    LN(dim) backward (dyb, ds2, db2 and dpb, the column sum of the f32 dyb),
    dW = dyb^T xn (TN).  Without d(volume), dxn = dyb W goes no further than
    the NN product's epilogue, which takes ds1 and db1 from it and xhat
    rebuilt from the volume (`kernels.ln_sums_tc`); with it, dxn is stored
    in f32 and the LN(patch_dim) backward through the patch gather and K17
    follow."""
    b, F, H, W = video.shape
    n, pd = (F // pt) * (H // p) * (W // p), pt * p * p
    R, dim, bf = b * n, w.shape[0], torch.bfloat16
    wb = w.to(bf).contiguous()
    xn = torch.empty((R, pd), dtype=bf, device=video.device)
    stats = None if want_dvideo else torch.empty((R, 2), dtype=torch.float32,
                                                 device=video.device)
    K.patch_layernorm(video, pt, p, s1, b1, eps, xn, stats=stats)
    yb = K.gemm_bias_tc(xn, wb, pbias.to(bf).contiguous())
    dyn = dout.reshape(R, dim).float().contiguous()
    dyb, ds2, db2, dpb = K.layernorm_bwd(yb, s2, dyn, eps, want_dbias=True, want_dxsum=True)
    del yb, dyn
    dw = K.gemm_tn_tc(dyb, xn)
    del xn
    dvideo = None
    if want_dvideo:
        dxn = torch.empty((R, pd), dtype=torch.float32, device=video.device)
        K.gemm_nn_tc(dyb, wb, dxn)
        dpatch, ds1, db1 = K.patch_layernorm_bwd(video, pt, p, s1, dxn, eps, want_dx=True)
        del dxn
        dvideo = unrearrange_patches(dpatch.view(b, n, pd), pt, p, F, H, W)
    else:
        ds1, db1 = K.ln_sums_tc(dyb, wb, video, pt, p, stats)
    K.count_launch("patch_embed_bwd")
    return dvideo, ds1, db1, dw, dpb, ds2, db2


def _row_embed_cuda(rows, s1, b1, w, pbias, s2, b2, eps):
    b, n, pd = rows.shape
    out = K.embed_tc(rows.view(b * n, pd), s1, b1, w, pbias, s2, b2, eps).view(b, n, -1)
    K.count_launch("row_embed")
    return out


def _row_embed_bwd_cuda(rows, s1, b1, w, pbias, s2, b2, dout, eps, want_drows: bool):
    """K16b: (drows or None, ds1, db1, dw, dpbias, ds2, db2)."""
    b, n, pd = rows.shape
    x = rows.view(b * n, pd)
    xn = torch.empty_like(x)
    K.layernorm(x, s1, b1, eps, xn)
    dxn, dw, dpb, ds2, db2 = _embed_tail_bwd(xn, w, pbias, s2, dout, eps)
    del xn
    drows, ds1, db1 = K.layernorm_bwd(x, s1, dxn, eps, want_dbias=True, want_dx=want_drows)
    K.count_launch("row_embed_bwd")
    return (None if drows is None else drows.view(b, n, pd)), ds1, db1, dw, dpb, ds2, db2


def _param_grads(grads, params):
    """Gradients in their parameters' dtypes."""
    return tuple(g.to(t.dtype) for g, t in zip(grads, params))


class _PatchEmbed(torch.autograd.Function):
    """K8 forward, K16a backward; only the volume is saved (the normalised
    rows are recomputed, as the TPU kernel recomputes them per block)."""

    @staticmethod
    def forward(ctx, video, s1, b1, w, pbias, s2, b2, pt, p, eps):
        ctx.args = (pt, p, eps)
        ctx.save_for_backward(video, s1, b1, w, pbias, s2, b2)
        if video.device.type == "cpu":
            return patch_embed_plain(video, s1, b1, w, pbias, s2, b2, pt, p, eps)
        return _patch_embed_cuda(video, s1, b1, w, pbias, s2, b2, pt, p, eps)

    @staticmethod
    def backward(ctx, dout):
        video, *params = ctx.saved_tensors
        want_dvideo = ctx.needs_input_grad[0]
        if video.device.type == "cpu":
            dvideo, *grads = patch_embed_bwd_plain(video, *params, dout, *ctx.args)
            dvideo = dvideo if want_dvideo else None
        else:
            dvideo, *grads = _patch_embed_bwd_cuda(video, *params, dout, *ctx.args,
                                                   want_dvideo)
        return (dvideo, *_param_grads(grads, params), None, None, None)


class _RowEmbed(torch.autograd.Function):
    """K4 forward, K16b backward; only the rows are saved."""

    @staticmethod
    def forward(ctx, rows, s1, b1, w, pbias, s2, b2, eps):
        ctx.eps = eps
        ctx.save_for_backward(rows, s1, b1, w, pbias, s2, b2)
        if rows.device.type == "cpu":
            return row_embed_plain(rows, s1, b1, w, pbias, s2, b2, eps)
        return _row_embed_cuda(rows, s1, b1, w, pbias, s2, b2, eps)

    @staticmethod
    def backward(ctx, dout):
        rows, *params = ctx.saved_tensors
        want_drows = ctx.needs_input_grad[0]
        if rows.device.type == "cpu":
            drows, *grads = row_embed_bwd_plain(rows, *params, dout, ctx.eps)
            drows = drows if want_drows else None
        else:
            drows, *grads = _row_embed_bwd_cuda(rows, *params, dout, ctx.eps, want_drows)
        return (drows, *_param_grads(grads, params), None)


def fused_patch_embed(video: torch.Tensor, s1, b1, w, pbias, s2, b2,
                      pt: int, p: int, eps: float = 1e-5) -> torch.Tensor:
    """(b, F, H, W) single-channel video -> (b, t*h*w, dim) tokens in the
    video's dtype.  A CPU tensor takes the plain versions; a bf16 CUDA tensor
    the kernels, an f32 one the plain versions (`kernels.ROUTES`).
    Differentiable in every argument (K16a)."""
    _check_tiling(video.shape, pt, p)
    if video.device.type == "cuda" and K.route("patch_embed", video.dtype) == K.PLAIN:
        K.count_launch("patch_embed_plain")
        return patch_embed_plain(video, s1, b1, w, pbias, s2, b2, pt, p, eps)
    return _PatchEmbed.apply(video.contiguous(), s1, b1, w, pbias, s2, b2, pt, p, eps)


def fused_row_embed(rows: torch.Tensor, s1, b1, w, pbias, s2, b2,
                    eps: float = 1e-5) -> torch.Tensor:
    """(b, n, patch_dim) patch rows -> (b, n, dim) tokens in the rows'
    dtype: to_patch_emb minus the Rearrange.  A CPU tensor takes the plain
    versions; a bf16 CUDA tensor the kernels, an f32 one the plain versions
    (`kernels.ROUTES`).  Differentiable in every argument (K16b)."""
    if rows.device.type == "cuda" and K.route("row_embed", rows.dtype) == K.PLAIN:
        K.count_launch("row_embed_plain")
        return row_embed_plain(rows, s1, b1, w, pbias, s2, b2, eps)
    return _RowEmbed.apply(rows.contiguous(), s1, b1, w, pbias, s2, b2, eps)
