"""Hand-written CUDA kernels of ct_clip_tpu_torch against their plain PyTorch
versions, on the card: the inference kernels in bf16, the training attention
kernels (K7 f32, K12, K13) in f32.

Needs an NVIDIA GPU and nvcc (the kernels compile on first use); skipped
elsewhere.  Run on the card with:

    python -m pytest tests/test_torch_port_kernels.py -q

Tolerances: kernel and plain version both round to bf16 at the same points
but sum in different orders, so an intermediate may land one bf16 ulp
(2^-8 relative) apart and carry that through the following stages.  Each
check allows a max abs error of 2e-2 x max|plain| unless stated.  The f32
kernels run the same products as their plain versions in another summation
order: 1e-4 x max|plain|.
"""
import pytest
import torch

from ct_clip_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
REL = 2e-2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.library()  # build once for the module
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _randn(shape, g, dev, scale=1.0, dtype=BF):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(got, ref, rel=REL):
    err = (got.float() - ref.float()).abs().max().item()
    bound = rel * ref.float().abs().max().item()
    assert err <= bound, f"max abs err {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("M,N,K_", [(100, 70, 40), (129, 64, 64), (64, 1365, 512)])
@pytest.mark.parametrize("epi", [K.EPI_STORE, K.EPI_RESIDUAL,
                                 K.EPI_BIAS_ROUNDED, K.EPI_GEGLU])
def test_gemm_epilogues(dev, M, N, K_, epi):
    g = _gen(dev)
    a, w, w2 = (_randn(s, g, dev) for s in ((M, K_), (N, K_), (N, K_)))
    r, bias = _randn((M, N), g, dev), _randn((N,), g, dev)
    out = torch.empty((M, N), dtype=BF, device=dev)
    K.gemm(epi, a, w, out, w2=w2 if epi == K.EPI_GEGLU else None,
           residual=r if epi == K.EPI_RESIDUAL else None,
           bias=bias if epi == K.EPI_BIAS_ROUNDED else None)
    acc = a.float() @ w.float().t()
    if epi == K.EPI_RESIDUAL:
        acc = acc + r.float()
    elif epi == K.EPI_BIAS_ROUNDED:
        acc = acc.to(BF).float() + bias.float()
    elif epi == K.EPI_GEGLU:
        acc = acc * torch.nn.functional.gelu(a.float() @ w2.float().t())
    torch.cuda.synchronize()
    # f32 reference of the same bf16 operands: only the final rounding and
    # the summation order differ
    _close(out, acc, rel=1e-2)


def test_gemm_argmax_matches_f32(dev):
    g = _gen(dev, 1)
    a, w = _randn((300, 64), g, dev), _randn((1000, 64), g, dev)
    ids = K.gemm_argmax(a, w)
    sim = a.float() @ w.float().t()
    best = sim.gather(1, ids.long()[:, None])[:, 0]
    torch.cuda.synchronize()
    # the chosen code is a maximum up to f32 summation order
    assert (best >= sim.max(dim=1).values - 1e-4).all()


def test_patch_embed(dev):
    from ct_clip_tpu_torch.ops.patch_embed import (fused_patch_embed,
                                                   patch_embed_plain)

    g = _gen(dev, 2)
    video = _randn((2, 20, 60, 40), g, dev)
    s1, b1 = 1 + _randn((4000,), g, dev, 0.1, torch.float32), _randn((4000,), g, dev, 0.1, torch.float32)
    w, pb = _randn((512, 4000), g, dev, 4000 ** -0.5, torch.float32), _randn((512,), g, dev, 0.1, torch.float32)
    s2, b2 = 1 + _randn((512,), g, dev, 0.1, torch.float32), _randn((512,), g, dev, 0.1, torch.float32)
    got = fused_patch_embed(video, s1, b1, w, pb, s2, b2, 10, 20)
    ref = patch_embed_plain(video, s1, b1, w, pb, s2, b2, 10, 20)
    torch.cuda.synchronize()
    assert got.shape == (2, 2 * 3 * 2, 512)
    _close(got, ref)


def test_geglu_ff(dev):
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff, geglu_ff_plain

    g = _gen(dev, 3)
    x = _randn((300, 512), g, dev)
    scale, bias = 1 + _randn((512,), g, dev, 0.1, torch.float32), _randn((512,), g, dev, 0.1, torch.float32)
    wi = _randn((2730, 512), g, dev, 512 ** -0.5, torch.float32)
    wo = _randn((512, 1365), g, dev, 1365 ** -0.5, torch.float32)
    got = fused_geglu_ff(x, scale, bias, wi, wo)
    ref = geglu_ff_plain(x, scale, bias, wi, wo)
    torch.cuda.synchronize()
    _close(got, ref)


def _attn_weights(g, dev, dim=512, heads=8, dh=32):
    hd = heads * dh
    f32 = torch.float32
    return (1 + _randn((dim,), g, dev, 0.1, f32),
            _randn((hd, dim), g, dev, dim ** -0.5, f32),
            _randn((2 * hd, dim), g, dev, dim ** -0.5, f32),
            1 + _randn((dh,), g, dev, 0.2, f32), 1 + _randn((dh,), g, dev, 0.2, f32),
            _randn((dim, hd), g, dev, hd ** -0.5, f32))


def test_spatial_qknorm_attention(dev):
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_spatial_qknorm_attention, qknorm_attention_plain)

    g = _gen(dev, 4)
    x = _randn((3, 576, 512), g, dev)
    w = _attn_weights(g, dev)
    bias = _randn((8, 576, 576), g, dev, 1.0, torch.float32)
    got = fused_spatial_qknorm_attention(x, *w, bias, 8, 32)
    ref = qknorm_attention_plain(x, *w, bias, 8, 32)
    torch.cuda.synchronize()
    _close(got, ref)


def test_grid_qknorm_attention(dev):
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, grid_qknorm_attention_plain)

    g = _gen(dev, 5)
    x = _randn((2, 24, 40, 512), g, dev)
    w = _attn_weights(g, dev)
    got = fused_grid_qknorm_attention(x, *w, 8, 32)
    ref = grid_qknorm_attention_plain(x, *w, 8, 32)
    torch.cuda.synchronize()
    _close(got, ref)


@pytest.mark.parametrize("mode", ["key_bias", "head_bias", "none"])
def test_fused_attention(dev, mode):
    from ct_clip_tpu_torch.ops.attention import attention_plain, fused_attention

    g = _gen(dev, 6)
    b, h, n, d = 3, 12, 512, 64
    # (b, n, h, d) projections viewed head-major, as BERT passes them
    q, k, v = (_randn((b, n, h, d), g, dev).transpose(1, 2) for _ in range(3))
    q = q * d ** -0.5
    bias = key_bias = None
    if mode == "key_bias":
        mask = torch.ones(b, n, device=dev)
        mask[:, 100:] = 0
        key_bias = (1 - mask) * torch.finfo(torch.float32).min
    elif mode == "head_bias":
        # the dense-bias form runs on the CPU only: its backward (K12b) is
        # not ported, and no caller passes one
        bias = _randn((1, h, n, n), g, dev, 1.0, torch.float32)
        with pytest.raises(NotImplementedError):
            fused_attention(q, k, v, bias)
        _close(fused_attention(q.cpu(), k.cpu(), v.cpu(), bias.cpu()),
               attention_plain(q, k, v, bias).cpu())
        return
    got = fused_attention(q, k, v, bias, key_bias)
    ref = attention_plain(q, k, v, bias, key_bias)
    torch.cuda.synchronize()
    _close(got, ref)


def test_vq_assign(dev):
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import vq_assign, vq_assign_plain

    g = _gen(dev, 7)
    x = _randn((2000, 512), g, dev)
    embed_n = l2norm(torch.randn((8192, 512), generator=g, device=dev))
    got = vq_assign(x, embed_n).long()
    ref = vq_assign_plain(x, embed_n).long()
    torch.cuda.synchronize()
    assert (got == ref).float().mean().item() >= 0.99
    # every disagreement is a near-tie within the bf16 margin (vq.py:17-22)
    sim = x.float() @ embed_n.to(BF).float().t()
    gap = (sim.gather(1, ref[:, None]) - sim.gather(1, got[:, None])).abs()[:, 0]
    scale = sim.abs().max(dim=1).values
    assert (gap <= 4e-3 * scale).all()


def test_launch_counters_count_only_kernel_paths(dev):
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff

    g = _gen(dev, 8)
    K.reset_launch_counts()
    x = _randn((64, 512), g, dev)
    w = (torch.ones(512, device=dev), torch.zeros(512, device=dev),
         _randn((2730, 512), g, dev, 0.05, torch.float32),
         _randn((512, 1365), g, dev, 0.05, torch.float32))
    fused_geglu_ff(x, *w)
    fused_geglu_ff(x.cpu().float(), *(t.cpu() for t in w))
    assert K.launch_counts()["geglu_ff"] == 1
    with pytest.raises(ValueError):
        fused_geglu_ff(x.float(), *w)  # a CUDA tensor must be bf16


@pytest.mark.parametrize("shape,pt,p", [((2, 20, 60, 40), 10, 20),  # 16-byte path
                                        ((1, 6, 15, 25), 2, 5)])   # 2-byte path
def test_rearrange_patches_bit_exact(dev, shape, pt, p):
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches, rearrange_plain

    video = _randn(shape, _gen(dev, 9), dev)
    got = rearrange_patches(video, pt, p)
    torch.cuda.synchronize()
    assert torch.equal(got, rearrange_plain(video, pt, p))
    # into one slot of a batch buffer, leaving the other slots alone
    buf = torch.full((3,) + tuple(got.shape[1:]), 7.0, dtype=BF, device=dev)
    rearrange_patches(video[:1], pt, p, out=buf[1:2])
    torch.cuda.synchronize()
    assert torch.equal(buf[1], got[0])
    assert (buf[0] == 7).all() and (buf[2] == 7).all()


def test_row_embed(dev):
    from ct_clip_tpu_torch.ops.patch_embed import fused_row_embed, row_embed_plain

    g = _gen(dev, 10)
    rows = _randn((2, 300, 4000), g, dev)
    f32 = torch.float32
    w = (1 + _randn((4000,), g, dev, 0.1, f32), _randn((4000,), g, dev, 0.1, f32),
         _randn((512, 4000), g, dev, 4000 ** -0.5, f32), _randn((512,), g, dev, 0.1, f32),
         1 + _randn((512,), g, dev, 0.1, f32), _randn((512,), g, dev, 0.1, f32))
    got = fused_row_embed(rows, *w)
    ref = row_embed_plain(rows, *w)
    torch.cuda.synchronize()
    assert got.shape == (2, 300, 512)
    _close(got, ref)


def test_row_route_counters_count_only_kernel_paths(dev):
    from ct_clip_tpu_torch.ops.patch_embed import fused_row_embed, rearrange_patches

    g = _gen(dev, 11)
    video = _randn((1, 4, 16, 16), g, dev)
    w = (torch.ones(128, device=dev), torch.zeros(128, device=dev),
         _randn((64, 128), g, dev, 0.1, torch.float32), torch.zeros(64, device=dev),
         torch.ones(64, device=dev), torch.zeros(64, device=dev))
    K.reset_launch_counts()
    rows = rearrange_patches(video, 2, 8)
    fused_row_embed(rows, *w)
    rows_cpu = rearrange_patches(video.cpu().float(), 2, 8)
    fused_row_embed(rows_cpu, *(t.cpu() for t in w))
    counts = K.launch_counts()
    assert counts["rearrange_patches"] == 1 and counts["row_embed"] == 1
    with pytest.raises(ValueError):
        rearrange_patches(video.float(), 2, 8)  # a CUDA tensor must be bf16
    with pytest.raises(ValueError):
        fused_row_embed(rows.float(), *w)


F32 = torch.float32


def _train_attn_inputs(dev, b, h, n, d, seed, masked=0.2):
    """(b, n, h, d) projections viewed head-major, as BERT passes them, a
    key bias masking ~20% of the keys with f32 min, and an output gradient."""
    g = _gen(dev, seed)
    q, k, v = (_randn((b, n, h, d), g, dev, dtype=F32).transpose(1, 2) for _ in range(3))
    q = q * d ** -0.5
    keep = torch.rand((b, n), generator=g, device=dev) >= masked
    keep[:, 0] = True
    key_bias = (~keep).float() * torch.finfo(F32).min
    do = _randn((b, h, n, d), g, dev, dtype=F32)
    return q, k, v, key_bias, do


def _grads(fn, q, k, v, key_bias, do):
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v, key_bias)]
    out = fn(*ins)
    return (out, *torch.autograd.grad(out, ins, do))


@pytest.mark.parametrize("b,h,n,d", [(2, 12, 512, 64), (3, 2, 200, 40)])
def test_k7_f32_and_k12_backward(dev, b, h, n, d):
    from ct_clip_tpu_torch.ops.attention import attention_plain, fused_attention

    args = _train_attn_inputs(dev, b, h, n, d, seed=12)
    got = _grads(lambda q, k, v, kb: fused_attention(q, k, v, key_bias=kb), *args)
    ref = _grads(lambda q, k, v, kb: attention_plain(q, k, v, key_bias=kb), *args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):  # out, dq, dk, dv, dkey_bias
        _close(g, r, rel=1e-4)


@pytest.mark.parametrize("b,h,n,d", [(2, 12, 512, 64), (3, 2, 200, 40)])
def test_k13_forward_and_backward_match_the_same_mask(dev, b, h, n, d):
    from ct_clip_tpu_torch.ops.attention import (attention_plain, dropout_mask,
                                                 fused_attention_kbias_dropout)

    args = _train_attn_inputs(dev, b, h, n, d, seed=13)
    seed = torch.tensor([987654321012], dtype=torch.int64, device=dev)
    mask = dropout_mask(seed, b, h, n, 0.1, dev)
    got = _grads(lambda q, k, v, kb: fused_attention_kbias_dropout(q, k, v, kb, seed, 0.1),
                 *args)
    ref = _grads(lambda q, k, v, kb: attention_plain(q, k, v, key_bias=kb, mask=mask),
                 *args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        _close(g, r, rel=1e-4)
    again = fused_attention_kbias_dropout(*args[:4], seed, 0.1)
    assert torch.equal(again, got[0])  # the same seed gives the same bits


def test_training_attention_counters_count_only_kernel_paths(dev):
    from ct_clip_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_kbias_dropout)

    q, k, v, kb, do = _train_attn_inputs(dev, 1, 2, 64, 64, seed=14)
    K.reset_launch_counts()
    for device in (dev, torch.device("cpu")):
        ins = [t.to(device).requires_grad_() for t in (q, k, v)]
        out = fused_attention(*ins, key_bias=kb.to(device))
        torch.autograd.grad(out, ins, do.to(device))
        out = fused_attention_kbias_dropout(*ins, kb.to(device), 5, 0.1)
        torch.autograd.grad(out, ins, do.to(device))
    with torch.no_grad():
        fused_attention(q, k, v, key_bias=kb)
    counts = K.launch_counts()
    assert (counts["fused_attention"], counts["attention_bwd"],
            counts["attention_dropout"], counts["attention_dropout_bwd"]) == (2, 1, 1, 1)
    with pytest.raises(ValueError):  # the f32 kernels hold d <= 64
        fused_attention(*(torch.zeros(1, 1, 8, 96, device=dev) for _ in range(3)))


# --------------------------------------- CT-CLIP training: K11, K9, K10, K14, K15, K5
# Backwards against autograd of the plain forwards, both in bf16: the plain
# chain rounds each gradient tensor to bf16 where the kernels keep f32 (the
# weight gradients, dxn) or round at the JAX kernels' points, so the two sit
# a few bf16 ulps apart: 3e-2 x max|plain| per output (BWD_REL).
BWD_REL = 3e-2


def _grads_close(got, ref, rel=BWD_REL):
    for i, (g, r) in enumerate(zip(got, ref)):
        assert (g is None) == (r is None), i
        if g is not None:
            assert g.shape == r.shape, (i, g.shape, r.shape)
            _close(g, r, rel)


@pytest.mark.parametrize("M,N,K_", [(300, 70, 40), (129, 512, 256), (64, 256, 1368)])
def test_gemm_nn_and_tn_layouts(dev, M, N, K_):
    g = _gen(dev, 3)
    dy, w = _randn((M, K_), g, dev), _randn((K_, N), g, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    K.gemm_nn(dy, w, out)
    _close(out, dy.float() @ w.float(), rel=1e-5)
    outb = torch.empty((M, N), dtype=BF, device=dev)
    _close(K.gemm_nn(dy, w, outb), dy.float() @ w.float())
    x = _randn((M, N), g, dev)
    _close(K.gemm_tn(dy, x), dy.float().t() @ x.float(), rel=1e-5)


def test_gemm_tn_splits_rows_in_a_fixed_order(dev):
    g = _gen(dev, 4)
    dy, x = _randn((3 * K.TN_ROWS + 77, 96), g, dev), _randn((3 * K.TN_ROWS + 77, 40), g, dev)
    a, b = K.gemm_tn(dy, x), K.gemm_tn(dy, x)
    _close(a, dy.float().t() @ x.float(), rel=1e-5)
    assert torch.equal(a, b)


def test_layernorm_backward(dev):
    from ct_clip_tpu_torch.ops.norms import layer_norm

    g = _gen(dev, 5)
    x = _randn((300, 512), g, dev)
    scale = 1 + 0.1 * torch.randn(512, generator=g, device=dev)
    bias = 0.1 * torch.randn(512, generator=g, device=dev)
    dxn = torch.randn((300, 512), generator=g, device=dev)
    add, add2 = torch.randn_like(dxn), _randn((300, 512), g, dev)
    xf, sf, bf_ = (t.detach().float().requires_grad_() for t in (x, scale, bias))
    want = torch.autograd.grad(layer_norm(xf, sf, bf_), (xf, sf, bf_), dxn)
    dx, ds, db = K.layernorm_bwd(x, scale, dxn, 1e-5, add=add, add2=add2, want_dbias=True)
    _close(dx, want[0] + add + add2.float())
    _close(ds, want[1], rel=1e-5)
    _close(db, want[2], rel=1e-5)


def test_geglu_ff_backward_k11(dev):
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff, geglu_ff_bwd_plain

    g = _gen(dev, 6)
    rows, dim, inner = 300, 64, 170
    x, do = _randn((rows, dim), g, dev), _randn((rows, dim), g, dev)
    w = (1 + 0.1 * torch.randn(dim, generator=g, device=dev),
         0.1 * torch.randn(dim, generator=g, device=dev),
         torch.randn((2 * inner, dim), generator=g, device=dev) * dim ** -0.5,
         torch.randn((dim, inner), generator=g, device=dev) * inner ** -0.5)
    leaves = [x.detach().requires_grad_()] + [t.detach().requires_grad_() for t in w]
    K.reset_launch_counts()
    got = torch.autograd.grad(fused_geglu_ff(*leaves), leaves, do)
    assert K.launch_counts()["geglu_ff_bwd"] == 1
    ref = geglu_ff_bwd_plain(x, *w, do)
    assert all(gr.dtype == t.dtype for gr, t in zip(got, leaves))
    _grads_close(got, ref)


def _qk_args(g, dev, dim=64, heads=2, dh=32):
    return (1 + 0.1 * torch.randn(dim, generator=g, device=dev),
            torch.randn((heads * dh, dim), generator=g, device=dev) * dim ** -0.5,
            torch.randn((2 * heads * dh, dim), generator=g, device=dev) * dim ** -0.5,
            1 + 0.2 * torch.randn(dh, generator=g, device=dev),
            1 + 0.2 * torch.randn(dh, generator=g, device=dev),
            torch.randn((dim, heads * dh), generator=g, device=dev) * (heads * dh) ** -0.5)


@pytest.mark.parametrize("b,n", [(3, 40), (5, 144)])
def test_spatial_attention_backward_k9(dev, b, n):
    from ct_clip_tpu_torch.ops.qknorm_attention import (fused_spatial_qknorm_attention,
                                                        qknorm_attention_bwd_plain)

    g = _gen(dev, 7)
    x, do = _randn((b, n, 64), g, dev), _randn((b, n, 64), g, dev)
    w = _qk_args(g, dev)
    bias = torch.randn((2, n, n), generator=g, device=dev)
    leaves = [t.detach().requires_grad_() for t in (x, *w, bias)]
    K.reset_launch_counts()
    got = torch.autograd.grad(fused_spatial_qknorm_attention(*leaves, 2, 32), leaves, do)
    assert K.launch_counts()["spatial_attention_bwd"] == 1
    ref = qknorm_attention_bwd_plain(x, *w, bias, do, 2, 32)
    _grads_close(got, ref)
    again = torch.autograd.grad(fused_spatial_qknorm_attention(*leaves, 2, 32), leaves, do)
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # fixed-order sums


def test_grid_attention_backward_k10(dev):
    from ct_clip_tpu_torch.ops.qknorm_attention import (fused_grid_qknorm_attention,
                                                        grid_qknorm_attention_bwd_plain)

    g = _gen(dev, 8)
    x, do = _randn((2, 6, 9, 64), g, dev), _randn((2, 6, 9, 64), g, dev)
    w = _qk_args(g, dev)
    leaves = [t.detach().requires_grad_() for t in (x, *w)]
    K.reset_launch_counts()
    got = torch.autograd.grad(fused_grid_qknorm_attention(*leaves, 2, 32), leaves, do)
    assert K.launch_counts()["grid_attention_bwd"] == 1
    _grads_close(got, grid_qknorm_attention_bwd_plain(x, *w, do, 2, 32))


@pytest.mark.parametrize("rotated", [False, True])
def test_peg_backward_k14(dev, rotated):
    from ct_clip_tpu_torch.ops.attention import _peg_geometry, peg_conv, peg_dw_plain

    g = _gen(dev, 9)
    x, do = _randn((2, 5, 5, 5, 128), g, dev), _randn((2, 5, 5, 5, 128), g, dev)
    weight = torch.randn((128, 1, 3, 3, 3), generator=g, device=dev) * 0.2
    bias = torch.randn(128, generator=g, device=dev) * 0.1
    leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
    K.reset_launch_counts()
    dx, dw, db = torch.autograd.grad(peg_conv(*leaves, rotated), leaves, do)
    assert K.launch_counts()["peg_bwd"] == 1
    _, pad = _peg_geometry(weight, rotated)
    want = peg_dw_plain(x, do, (pad[4], pad[2], pad[0]))
    got = dw.permute(0, 1, 4, 2, 3) if rotated else dw
    _close(got.reshape(128, 27).t(), want[:27], rel=1e-5)
    _close(db, want[27], rel=1e-5)
    cpu = [t.detach().cpu().requires_grad_() for t in (x, weight, bias)]
    ref = torch.autograd.grad(peg_conv(*cpu, rotated), cpu, do.cpu())
    _close(dx.cpu(), ref[0])


def test_vq_cluster_stats_k15_with_empty_codes(dev):
    from ct_clip_tpu_torch.ops.vq import cluster_stats, cluster_stats_plain

    g = _gen(dev, 10)
    x = _randn((5000, 512), g, dev)
    ids = torch.randint(0, 300, (5000,), generator=g, device=dev, dtype=torch.int32)
    K.reset_launch_counts()
    bins, esum = cluster_stats(x, ids, 1024)  # codes 300-1023 stay empty
    assert K.launch_counts()["vq_cluster_stats"] == 1
    rbins, resum = cluster_stats_plain(x, ids, 1024)
    assert torch.equal(bins, rbins) and (bins[300:] == 0).all()
    _close(esum, resum, rel=1e-5)
    assert (esum[300:] == 0).all()
    assert torch.equal(cluster_stats(x, ids, 1024)[1], esum)  # rows in row order


def test_vq_exact_assign_k5(dev):
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import vq_assign, vq_assign_plain

    g = _gen(dev, 11)
    x = _randn((4096, 512), g, dev)
    embed_n = l2norm(torch.randn((8192, 512), generator=g, device=dev))
    K.reset_launch_counts()
    got = vq_assign(x, embed_n, exact=True)
    assert K.launch_counts()["vq_assign_exact"] == 1
    ref = vq_assign_plain(x, embed_n, exact=True)
    assert (got == ref).float().mean().item() >= 0.999


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_bert_attention_bf16_training_k12_k13(dev, dropout):
    from ct_clip_tpu_torch.ops.attention import (attention_plain, dropout_mask,
                                                 fused_attention, fused_attention_kbias_dropout)

    q, k, v, kb, do = (t.to(BF) if t.dtype == torch.float32 and t.dim() == 4 else t
                       for t in _train_attn_inputs(dev, 2, 4, 100, 64, seed=15))
    seed = torch.tensor([9], dtype=torch.int64, device=dev)
    mask = dropout_mask(seed, 2, 4, 100, dropout, dev) if dropout else None
    if dropout:
        got = _grads(lambda q, k, v, b: fused_attention_kbias_dropout(q, k, v, b, seed,
                                                                      dropout), q, k, v, kb, do)
    else:
        got = _grads(lambda q, k, v, b: fused_attention(q, k, v, key_bias=b), q, k, v, kb, do)
    ref = _grads(lambda q, k, v, b: attention_plain(q, k, v, key_bias=b, mask=mask),
                 q, k, v, kb, do)
    _grads_close(got, ref)
