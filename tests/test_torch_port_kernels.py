"""Hand-written CUDA kernels of ct_clip_tpu_torch against their plain PyTorch
versions, on the card, in bf16.

Needs an NVIDIA GPU and nvcc (the kernels compile on first use); skipped
elsewhere.  Run on the card with:

    python -m pytest tests/test_torch_port_kernels.py -q

Tolerances: kernel and plain version both round to bf16 at the same points
but sum in different orders, so an intermediate may land one bf16 ulp
(2^-8 relative) apart and carry that through the following stages.  Each
check allows a max abs error of 2e-2 x max|plain| unless stated.
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
        bias = _randn((1, h, n, n), g, dev, 1.0, torch.float32)
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
