"""Hand-written CUDA kernels of ct_clip_tpu_torch against their plain PyTorch
versions, on the card: the inference kernels in bf16, the training attention
kernels (K7 f32, K12, K13) in f32, K7's dense-bias form and K12b in f32 and
bf16, the bf16 K7 / K12b / K12a / K13a / K13b of attention_tc.cu (wgmma) with
their routing (`-k "tc or dense"`), the f32 K7 (key bias, dense, no
bias), K13a, K12a, K12b (dense, no bias) and K13b of attention_tc32.cu
(3xTF32, `-k tc32`), K9's bf16 core on the tensor cores
(qknorm_attention_tc.cu, `-k qk_core`), K2's core on short sequences
(qknorm_attention_short.cu) and the sublayer's bf16 projections on
ffn_tc.cu (`-k "k2 or qk_projection"`) and its f32 core in 3xTF32
(qknorm_attention_tc32.cu, `-k "qk_core and f32"`), the f32 backwards'
3xTF32 forms on ffn_tc32.cu and K10's f32 core on qknorm_attention_short.cu
(`-k "tc32_split_t or gemm_tn or k11_f32_tc32 or short_bwd"`), K11 bf16 on `wgmma`
(ffn_tc.cu, `-k "k11 or ff_tc"`), with K17 f32's run copy (`-k k17`), K16a on
ffn_tc.cu (`-k k16a`), K3 f32 in 3xTF32 on ffn_tc32.cu (`-k "ff_f32"`), K3
bf16's GEGLU and residual forms on ffn_tc.cu and K5's inference assignment
on vq_tc.cu, bf16 and f32 rows (`-k "k3_wgmma or k5_wgmma"`), the PEG
stencil's forward and K14, bf16 and f32 (peg_stencil.cu, `-k peg`), K4 and
K8 bf16 on embed_tc.cu with a mean limit, its planted single-rounding copy
and misfit widths raising (`-k embed`).

Needs an NVIDIA GPU and nvcc (the kernels compile on first use); skipped
elsewhere.  Run on the card with:

    python -m pytest tests/test_torch_port_kernels.py -q

Tolerances: kernel and plain version both round to bf16 at the same points
but sum in different orders, so an intermediate may land one bf16 ulp
(2^-8 relative) apart and carry that through the following stages.  Each
check allows a max abs error of 2e-2 x max|plain| unless stated.  The f32
kernels run the same products as their plain versions in another summation
order: 1e-4 x max|plain|; the 3xTF32 forwards and backwards 1e-5 x
max|plain| against the plain version with TF32 off, which a plain-TF32 copy
of them must miss.
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


@pytest.mark.parametrize("b,n", [(64, 20), (72, 16)])
def test_seq_qknorm_attention_k2(dev, b, n):
    """K2's sequence-major form: short (b*h*w, t, dim) sequences without a
    bias, at GenerateCT's t = 20 and CT-CLIP's 160-frame t = 16."""
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_small_qknorm_attention, qknorm_attention_plain)

    g = _gen(dev, 5)
    x = _randn((b, n, 512), g, dev)
    w = _attn_weights(g, dev)
    K.reset_launch_counts()
    got = fused_small_qknorm_attention(x, *w, 8, 32)
    ref = qknorm_attention_plain(x, *w, None, 8, 32)
    torch.cuda.synchronize()
    assert K.launch_counts()["seq_attention"] == 1
    assert K.launch_counts()["spatial_attention"] == 0
    _close(got, ref)


@pytest.mark.parametrize("mode", ["key_bias", "head_bias", "none", "both"])
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
    elif mode == "head_bias":  # K7's dense-bias form (attention_train.cu), bf16
        bias = _randn((1, h, n, n), g, dev, 1.0, torch.float32)
    elif mode == "both":  # XLA in the JAX package: the plain version on the card
        bias = _randn((1, h, n, n), g, dev, 1.0, torch.float32)
        key_bias = torch.zeros(b, n, device=dev)
        key_bias[:, 300:] = torch.finfo(torch.float32).min
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


@pytest.mark.parametrize("rows", [300, 27648, 10001, 64])
def test_geglu_ff_k3_wgmma_forms(dev, rows):
    """K3 bf16 on ffn_tc.cu's GEGLU and residual forms (counted `ff_tc_fwd`)
    against the plain version at ragged and full row counts, bit-identical
    across runs; gemm.cu's path, which it replaced, lands as close."""
    from ct_clip_tpu_torch.ops.ffn import _geglu_ff_gemm, fused_geglu_ff, geglu_ff_plain

    g = _gen(dev, 31)
    x = _randn((rows, 512), g, dev)
    w = (1 + _randn((512,), g, dev, 0.1, F32), _randn((512,), g, dev, 0.1, F32),
         _randn((2730, 512), g, dev, 512 ** -0.5, F32), _randn((512, 1365), g, dev,
                                                              1365 ** -0.5, F32))
    K.reset_launch_counts()
    got = fused_geglu_ff(x, *w)
    assert K.launch_counts()["ff_tc_fwd"] == 1 and K.launch_counts()["geglu_ff"] == 1
    ref = geglu_ff_plain(x, *w)
    torch.cuda.synchronize()
    _close(got, ref)
    _close(_geglu_ff_gemm(x, *w, 1e-5), ref)
    assert torch.equal(fused_geglu_ff(x, *w), got)


def test_geglu_ff_k3_wgmma_narrow_widths(dev):
    """K3 bf16 at a width of 64 (ffn_tc.cu, inner 170 padded to 176) and at
    36, which TMA cannot take (gemm.cu), each against the plain version."""
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff, geglu_ff_plain

    g = _gen(dev, 32)
    for dim, tc in ((64, 1), (36, 0)):
        inner = int(4 * (2.0 / 3.0) * dim)
        x = _randn((500, dim), g, dev)
        w = (1 + _randn((dim,), g, dev, 0.1, F32), _randn((dim,), g, dev, 0.1, F32),
             _randn((2 * inner, dim), g, dev, dim ** -0.5, F32),
             _randn((dim, inner), g, dev, inner ** -0.5, F32))
        K.reset_launch_counts()
        got = fused_geglu_ff(x, *w)
        assert K.launch_counts()["ff_tc_fwd"] == tc
        _close(got, geglu_ff_plain(x, *w))


@pytest.mark.parametrize("rows,codes", [(2000, 8192), (10001, 8192), (300, 8000), (64, 100)])
def test_vq_assign_k5_wgmma_bf16(dev, rows, codes):
    """K5 bf16 on vq_tc.cu (counted `vq_assign_tc`) at ragged row and code
    counts: >= 99% of ids equal to the plain version's, the rest near-ties
    within the bf16 margin; equal run to run."""
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import vq_assign, vq_assign_plain

    g = _gen(dev, 33)
    x = _randn((rows, 512), g, dev)
    embed_n = l2norm(torch.randn((codes, 512), generator=g, device=dev))
    K.reset_launch_counts()
    got = vq_assign(x, embed_n).long()
    assert K.launch_counts()["vq_assign_tc"] == 1
    ref = vq_assign_plain(x, embed_n).long()
    assert got.max().item() < codes
    assert (got == ref).float().mean().item() >= 0.99
    sim = x.float() @ embed_n.to(BF).float().t()
    gap = (sim.gather(1, ref[:, None]) - sim.gather(1, got[:, None])).abs()[:, 0]
    assert (gap <= 4e-3 * sim.abs().max(dim=1).values).all()
    assert torch.equal(vq_assign(x, embed_n).long(), got)


@pytest.mark.parametrize("codes", [8192, 1000])
def test_vq_assign_k5_wgmma_exact_ties_take_the_lower_code(dev, codes):
    """On exactly tied similarities (integer rows and codes: every sum exact
    in f32) with planted duplicate codes, vq_tc.cu's ids equal
    torch.argmax's, the lower code winning each tie."""
    from ct_clip_tpu_torch.ops.vq import vq_assign

    g = _gen(dev, 34)
    x = torch.randint(-2, 3, (3000, 512), generator=g, device=dev).to(BF)
    c = torch.randint(-1, 2, (codes, 512), generator=g, device=dev).float()
    best = (x.float() @ c.t()).argmax(dim=-1)[::3]
    c[torch.randint(0, codes, best.shape, generator=g, device=dev)] = c[best]
    sim = x.float() @ c.t()
    assert ((sim == sim.max(dim=-1, keepdim=True).values).sum(dim=-1) > 1).sum() >= 100
    assert torch.equal(vq_assign(x, c), sim.argmax(dim=-1).to(torch.int32))


def test_vq_assign_k5_wgmma_f32_rows_pre_pass_is_the_plain_norm(dev):
    """vq_tc.cu's pre-pass writes each f32 row times `_lane_inv_norm`,
    rounded to bf16, bit for bit."""
    from ct_clip_tpu_torch.ops.vq import _lane_inv_norm

    g = _gen(dev, 35)
    for dim in (512, 128, 40):
        x = torch.randn((777, dim), generator=g, device=dev) * 3.0
        x[5] = 0.0
        out = torch.empty((777, dim), dtype=BF, device=dev)
        K._check(K.library().ct_vq_rows_bf16(K._ptr(x), 777, dim, K._ptr(out), None,
                                             K._stream()), "ct_vq_rows_bf16")
        torch.cuda.synchronize()
        assert torch.equal(out, (x * _lane_inv_norm(x)).to(BF))


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
    assert K.launch_counts()["geglu_ff"] == 1 and K.launch_counts()["geglu_ff_f32"] == 0
    fused_geglu_ff(x.float(), *w)  # the f32 form, counted beside the function
    assert K.launch_counts()["geglu_ff"] == 2 and K.launch_counts()["geglu_ff_f32"] == 1
    with pytest.raises(ValueError):
        fused_geglu_ff(x.half(), *w)  # a CUDA tensor must be bf16 or f32


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
    # f32: K6's f32 form; K4 takes its plain version (XLA in the JAX package)
    rows32 = rearrange_patches(video.float(), 2, 8)
    fused_row_embed(rows32, *w)
    counts = K.launch_counts()
    assert counts["rearrange_patches_f32"] == 1 and counts["row_embed"] == 1
    assert counts["row_embed_plain"] == 1
    with pytest.raises(ValueError):
        rearrange_patches(video.half(), 2, 8)  # a CUDA tensor must be bf16 or f32
    with pytest.raises(ValueError):
        fused_row_embed(rows.half(), *w)


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
    # at d 64 both f32 backwards (K12a, K13b) run on attention_tc32.cu
    assert (counts["fused_attention"], counts["attention_bwd"], counts["attention_tc32_bwd"],
            counts["attention_dropout"], counts["attention_dropout_bwd"]) == (2, 1, 2, 1, 1)
    with pytest.raises(ValueError):  # the f32 kernels hold d <= 64
        fused_attention(*(torch.zeros(1, 1, 8, 96, device=dev) for _ in range(3)))


# ------------------------------------------------- K7 dense and K12b
@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("bias_heads", [8, 1])
@pytest.mark.parametrize("n", [200, 1280])
def test_k7_dense_and_k12b(dev, dtype, bias_heads, n):
    """K7's dense-bias form and K12b (f32: attention_tc32.cu's 3xTF32
    forward and backward; bf16: attention_tc.cu) against
    their plain versions at d 64, 8 heads, a
    ragged n (200) and MaskGIT's 1,280, with a per-head and a one-head f32
    bias: the output, dq, dk, dv and dbias (summed over the batch, and over
    the heads for the one-head bias).  f32: 1e-4 of max|plain|; bf16: 2e-2
    forward, 3e-2 backward (dbias stays f32).  The rows of dS sum to zero in
    exact arithmetic; the kernels sum D_i = sum_j P_ij dP_ij in f32 (f32:
    dO_i . O_i from the 3xTF32 forward's f32 output; bf16: from the backward's own f32 P and
    dP), as the TPU kernel does, so dbias's row sums stay at f32 rounding:
    within 16x those of the plain version in f32 on the same inputs (from
    the bf16-rounded output they read thousands of times more).  dbias is
    bit-identical across runs (partials summed in a fixed order), and only
    kernel launches count."""
    from ct_clip_tpu_torch.ops.attention import (attention_bwd_plain, attention_plain,
                                                 fused_attention)

    b, h, d = (2, 8, 64) if n > 512 else (3, 8, 64)
    g = _gen(dev, 30)
    q, k, v, do = (_randn((b, n, h, d), g, dev, dtype=dtype).transpose(1, 2)
                   for _ in range(4))
    q = q * 0.125
    bias = _randn((1, bias_heads, n, n), g, dev, 1.0, F32)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    K.reset_launch_counts()
    out = fused_attention(*leaves[:3], bias=leaves[3])
    got = torch.autograd.grad(out, leaves, do)
    counts = K.launch_counts()
    assert (counts["attention_dense"], counts["attention_dense_bwd"],
            counts["fused_attention"], counts["attention_bwd"]) == (1, 1, 0, 0)
    ref_out = attention_plain(q, k, v, bias)
    ref = attention_bwd_plain(q, k, v, do, bias)[:4]
    torch.cuda.synchronize()
    f32 = dtype == F32
    _close(out, ref_out, rel=1e-4 if f32 else REL)
    for gr, r in zip(got, ref):
        _close(gr, r, rel=1e-4 if f32 else 3e-2)
    assert got[3].dtype == F32 and got[3].shape == bias.shape
    ref32 = attention_bwd_plain(*(t.float() for t in (q, k, v, do)), bias)[3]
    assert got[3].sum(-1).abs().max() <= 16 * ref32.sum(-1).abs().max()
    again = torch.autograd.grad(fused_attention(*leaves[:3], bias=leaves[3]), leaves, do)
    assert torch.equal(again[3], got[3])


def test_dense_bias_shapes_and_f32_maskgit_on_cuda(dev):
    """fused_attention takes (1, 1|h, n, n) dense biases on CUDA and raises
    on a per-batch one (XLA in the JAX package; no caller) and on one
    without its batch axis; an f32 MaskGit forward on CUDA runs, its
    feed-forward on K3's f32 form (counted), and a half one raises instead
    of falling back.  The MaskGit's 512 tokens of width 64 do not fit the
    fused sublayers, so its self-attention is K7 dense, as at full width."""
    from ct_clip_tpu_torch.config import MaskGitConfig
    from ct_clip_tpu_torch.models import MaskGit
    from ct_clip_tpu_torch.ops.attention import attention_plain, fused_attention

    g = _gen(dev, 31)
    q, k, v = (_randn((2, 4, 130, 32), g, dev, dtype=F32) for _ in range(3))
    for shape in ((1, 1, 130, 130), (1, 4, 130, 130)):
        bias = _randn(shape, g, dev, 1.0, F32)
        _close(fused_attention(q, k, v, bias), attention_plain(q, k, v, bias), rel=1e-4)
    for shape in ((2, 4, 130, 130), (4, 130, 130)):
        with pytest.raises(ValueError):
            fused_attention(q, k, v, _randn(shape, g, dev, 1.0, F32))
    cfg = MaskGitConfig(dim=128, depth=1, dim_head=64, heads=2, max_seq_len=512, t5_dim=32)
    model = MaskGit(cfg, num_tokens=32, device=dev).init_weights(_gen(dev, 32))
    ids = torch.randint(0, 33, (2, 512), generator=_gen(dev, 33), device=dev)
    K.reset_launch_counts()
    assert torch.isfinite(model(ids, (2, 16, 16))).all()
    counts = K.launch_counts()
    assert counts["geglu_ff_f32"] == 1 and counts["attention_dense"] == 1
    model.dtype = torch.float16
    with pytest.raises(ValueError, match="float16"):
        model(ids, (2, 16, 16))
    model.dtype = BF
    K.reset_launch_counts()
    assert torch.isfinite(model(ids, (2, 16, 16)).float()).all()
    assert K.launch_counts()["attention_dense"] == 1


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
    c = K.launch_counts()
    assert (c["geglu_ff_bwd"], c["ff_tc_tile"], c["ff_tc_gemm"]) == (1, 1, 3)
    ref = geglu_ff_bwd_plain(x, *w, do)
    assert all(gr.dtype == t.dtype for gr, t in zip(got, leaves))
    _grads_close(got, ref)


def _k11_case(dev, rows, dim=512, inner=1365, seed=6):
    g = _gen(dev, seed)
    x, do = _randn((rows, dim), g, dev), _randn((rows, dim), g, dev)
    w = (1 + 0.1 * torch.randn(dim, generator=g, device=dev),
         0.1 * torch.randn(dim, generator=g, device=dev),
         torch.randn((2 * inner, dim), generator=g, device=dev) * dim ** -0.5,
         torch.randn((dim, inner), generator=g, device=dev) * inner ** -0.5)
    return x, w, do


def test_geglu_ff_backward_k11_wgmma_full_width(dev, monkeypatch):
    """K11 bf16 at CT-CLIP's training rows (110,592 x 512, inner 1,365) on
    ffn_tc.cu (`wgmma`): every gradient within 3e-2 of max|plain| (the row's
    bf16 limit), bit-identical across runs, the tile and product counters
    rising at their launches; a copy of the tile without the g phi(g) term
    of dg (CT_FF_TC_NO_GPHI) must miss that limit."""
    import functools

    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff, geglu_ff_bwd_plain

    x, w, do = _k11_case(dev, 110592)
    leaves = [x.detach().requires_grad_()] + [t.detach().requires_grad_() for t in w]
    out = fused_geglu_ff(*leaves)
    K.reset_launch_counts()
    got = torch.autograd.grad(out, leaves, do, retain_graph=True)
    c = K.launch_counts()
    assert (c["geglu_ff_bwd"], c["ff_tc_tile"], c["ff_tc_gemm"]) == (1, 1, 3)
    ref = geglu_ff_bwd_plain(x, *w, do)
    _grads_close(got, ref)
    again = torch.autograd.grad(out, leaves, do, retain_graph=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    copy = K.copy_library("ffn_tc.cu", CT_FF_TC_NO_GPHI=1)
    monkeypatch.setattr(K, "ff_tc_tile", functools.partial(K.ff_tc_tile, lib=copy))
    planted = torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.synchronize()
    errs = [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
            for a, b in zip(planted, ref)]
    assert max(errs) > BWD_REL, errs


@pytest.mark.parametrize("split_rows", [8192, 256])
def test_ff_tc_products_against_matmul(dev, monkeypatch, split_rows):
    """ffn_tc.cu's products on ragged shapes against f32 matmuls of the same
    bf16 operands: NN (dxn = dcat w, K 2,736 in 43 k blocks) and TN (the
    weight gradients over 1,000 rows, in one split and in four of 256), each
    counted at its launch; exact bf16 products summed in f32 in another
    order: 1e-5 of max."""
    monkeypatch.setattr(K, "FF_TC_SPLIT_ROWS", split_rows)
    g = _gen(dev, 9)
    dcat, w = _randn((300, 2736), g, dev), _randn((2736, 136), g, dev)
    K.reset_launch_counts()
    out = K.gemm_nn_tc(dcat, w, torch.empty((300, 136), device=dev))
    _close(out, dcat.float() @ w.float(), rel=1e-5)
    dy, xr = _randn((1000, 2736), g, dev), _randn((1000, 520), g, dev)
    _close(K.gemm_tn_tc(dy, xr), dy.float().t() @ xr.float(), rel=1e-5)
    assert K.launch_counts()["ff_tc_gemm"] == 2 and K.launch_counts()["ff_tc_tile"] == 0


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
    counts = K.launch_counts()
    # n >= 32 at head dim 32: the core on the tensor cores (qknorm_attention_tc.cu)
    assert counts["spatial_attention_bwd"] == counts["qk_attention_tc_bwd"] == 1
    ref = qknorm_attention_bwd_plain(x, *w, bias, do, 2, 32)
    _grads_close(got, ref)
    again = torch.autograd.grad(fused_spatial_qknorm_attention(*leaves, 2, 32), leaves, do)
    assert all(torch.equal(a, c) for a, c in zip(got, again))  # fixed-order sums


def test_stream_is_the_current_stream(dev):
    """kernels._stream, which every launch passes, is PyTorch's current
    stream, on the default stream and inside a side stream's context, by the
    raw binding this build has."""
    assert hasattr(torch._C, "_cuda_getCurrentRawStream")
    assert K._stream() == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert K._stream() == side.cuda_stream != torch.cuda.default_stream().cuda_stream
    assert K._stream() == torch.cuda.current_stream().cuda_stream


def _qk_core_case(dev, S, n, bias, seed=11):
    """K9's core inputs on (S, n) planes, 8 heads of 32 (the sublayer's
    (S n, 256) q and dO, (S n, 512) kv), its layout, the CPB bias or None."""
    g = _gen(dev, seed)
    heads, d = 8, 32
    q, kv, dm = (_randn((S * n, w), g, dev) for w in (heads * d, 2 * heads * d, heads * d))
    qs = (1 + 0.2 * torch.randn(d, generator=g, device=dev)) * 8.0
    ks = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    b = torch.randn((heads, n, n), generator=g, device=dev) if bias else None
    layout = dict(sequences=S, inner=1, heads=heads, n=n, d=d,
                  q_strides=(n * heads * d, 0, d, heads * d),
                  q_scale=qs, k_scale=ks, bias=b,
                  kv_strides=(n * 2 * heads * d, 0, d, 2 * heads * d))
    return q, kv, dm, layout


def _dbias_row_sums(dbias):
    return dbias.sum(-1).abs().max().item()


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("S,n", [(4, 576), (12, 64), (6, 100)])
def test_qk_core_backward_k9_tensor_cores(dev, S, n, bias):
    """K9's core on qknorm_attention_tc.cu (wgmma) at CT-CLIP's 576-token
    planes, the autoencoder's 64 and a ragged 100, with the CPB bias and
    without, against the plain version at the TPU kernel's rounding points:
    merged, dq, dkv within 2e-2 of max|plain|, the sums over all planes
    (dq_scale, dk_scale, dbias) within 3e-2; dbias rows sum to zero within
    16x the plain f32 version's rounding (D_i from the f32 P); every output
    bit-identical across runs."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain as plain

    q, kv, dm, layout = _qk_core_case(dev, S, n, bias)
    assert K.qk_bwd_tensor_cores(q.dtype, n, 32) == K.QK_WGMMA
    got = K.qk_attention_bwd(q, kv, dm, **layout)
    args = (layout["heads"], 32, n, layout["q_scale"], layout["k_scale"], layout["bias"])
    ref = plain(q, kv, dm, *args)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, i
        _close(a, b, REL if i < 3 else BWD_REL)
    again = K.qk_attention_bwd(q, kv, dm, **layout)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    if bias:
        ref32 = plain(q.float(), kv.float(), dm.float(), *args)[5]
        assert _dbias_row_sums(got[5]) <= 16 * _dbias_row_sums(ref32)


def test_qk_core_backward_k9_planted_d_from_bf16_p_misses(dev):
    """A copy of the tensor-core core summing D_i from bf16(P)
    (CT_QK_TC_D_FROM_BF16_P) must leave dbias's rows off their zero sum,
    outside 16x the plain f32 version's rounding."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain as plain

    copy = K.copy_library("qknorm_attention_tc.cu", CT_QK_TC_D_FROM_BF16_P=1)
    q, kv, dm, layout = _qk_core_case(dev, 4, 576, True)
    got = K.qk_attention_bwd(q, kv, dm, lib=copy, **layout)
    ref32 = plain(q.float(), kv.float(), dm.float(), layout["heads"], 32, 576,
                  layout["q_scale"], layout["k_scale"], layout["bias"])[5]
    torch.cuda.synchronize()
    assert _dbias_row_sums(got[5]) > 16 * _dbias_row_sums(ref32)


def test_grid_attention_backward_k10(dev):
    from ct_clip_tpu_torch.ops.qknorm_attention import (fused_grid_qknorm_attention,
                                                        grid_qknorm_attention_bwd_plain)

    g = _gen(dev, 8)
    x, do = _randn((2, 6, 9, 64), g, dev), _randn((2, 6, 9, 64), g, dev)
    w = _qk_args(g, dev)
    leaves = [t.detach().requires_grad_() for t in (x, *w)]
    K.reset_launch_counts()
    got = torch.autograd.grad(fused_grid_qknorm_attention(*leaves, 2, 32), leaves, do)
    counts = K.launch_counts()
    assert counts["grid_attention_bwd"] == 1 and counts["qk_attention_tc_bwd"] == 0
    _grads_close(got, grid_qknorm_attention_bwd_plain(x, *w, do, 2, 32))


@pytest.mark.parametrize("n", [16, 20])
def test_seq_attention_backward_k10(dev, n):
    """K10's sequence-major form against autograd of the plain forward, and
    its fixed-order sums (two runs bit-identical)."""
    from ct_clip_tpu_torch.ops.qknorm_attention import (fused_small_qknorm_attention,
                                                        qknorm_attention_bwd_plain)

    g = _gen(dev, 8)
    x, do = _randn((96, n, 64), g, dev), _randn((96, n, 64), g, dev)
    w = _qk_args(g, dev)
    leaves = [t.detach().requires_grad_() for t in (x, *w)]
    K.reset_launch_counts()
    got = torch.autograd.grad(fused_small_qknorm_attention(*leaves, 2, 32), leaves, do)
    assert K.launch_counts()["seq_attention_bwd"] == 1
    assert K.launch_counts()["spatial_attention_bwd"] == 0
    _grads_close(got, qknorm_attention_bwd_plain(x, *w, None, do, 2, 32)[:7])
    again = torch.autograd.grad(fused_small_qknorm_attention(*leaves, 2, 32), leaves, do)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


# the PEG stencil (peg_stencil.cu): (rotated, causal) -> leading pads
# (2, 1, 1) frame-causal, (1, 2, 1) rotated, (1, 1, 1) non-causal; ragged
# grids (T, H or W of 1, 3, 5) and C of 8, 64 and 520 (a ragged channel slab)
PEG_GEOMETRIES = [(False, True), (True, True), (False, False)]
PEG_SHAPES = [(2, 5, 5, 5, 128), (1, 1, 3, 5, 8), (2, 3, 1, 3, 64), (1, 5, 3, 1, 520),
              (3, 4, 5, 6, 64)]
PEG_MEAN = 5e-4  # bf16 out / dx: mean|err| of mean|plain| (chip_smoke.PEG_MEAN_TOL)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("shape", PEG_SHAPES)
@pytest.mark.parametrize("rotated,causal", PEG_GEOMETRIES)
def test_peg_backward_k14(dev, rotated, causal, shape, dtype):
    """`peg_conv` forward and backward on the card (the stencil's forward form
    and K14 whole, one launch each) against the plain versions on the same
    card tensors: out and dx within 2e-2 of max and PEG_MEAN of mean in bf16,
    1e-5 in f32; dW and db within 1e-5 (bf16: exact products) or 1e-4 (f32);
    a second run equal bit for bit."""
    from ct_clip_tpu_torch.ops.attention import (_peg_leads, _peg_taps, peg_conv, peg_dw_plain,
                                                 peg_dx_plain, peg_fwd_plain)

    g = _gen(dev, 9)
    c = shape[-1]
    x, do = _randn(shape, g, dev, dtype=dtype), _randn(shape, g, dev, dtype=dtype)
    weight = torch.randn((c, 1, 3, 3, 3), generator=g, device=dev) * 0.2
    bias = torch.randn(c, generator=g, device=dev) * 0.1
    leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
    K.reset_launch_counts()
    out = peg_conv(*leaves, rotated, causal)
    dx, dw, db = torch.autograd.grad(out, leaves, do)
    counts = K.launch_counts()
    f32 = int(dtype == F32)
    assert (counts["peg_fwd"], counts["peg_bwd"], counts["peg_fwd_f32"],
            counts["peg_bwd_f32"]) == (1, 1, f32, f32)
    taps, pads = _peg_taps(weight, rotated, dtype), _peg_leads(rotated, causal)
    want = peg_dw_plain(x, do, pads)
    got = dw.permute(0, 1, 4, 2, 3) if rotated else dw  # the taps as applied
    for a, r in ((out, peg_fwd_plain(x, taps, bias, pads)), (dx, peg_dx_plain(do, taps, pads))):
        assert a.dtype == dtype and a.shape == r.shape
        _close(a, r, REL if dtype == BF else 1e-5)
        if dtype == BF:
            assert (a.float() - r.float()).abs().mean() <= PEG_MEAN * r.float().abs().mean()
    _close(got.reshape(c, 27).t(), want[:27], rel=1e-5 if dtype == BF else 1e-4)
    _close(db, want[27], rel=1e-5 if dtype == BF else 1e-4)
    again = torch.autograd.grad(peg_conv(*leaves, rotated, causal), leaves, do)
    assert all(torch.equal(a, b) for a, b in zip((dx, dw, db), again))


def test_peg_stencil_rejects_misfits(dev):
    """The stencil's wrappers raise on what the kernel does not take."""
    g = _gen(dev, 11)
    w, b = torch.randn((12, 1, 3, 3, 3), device=dev), torch.zeros(12, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):  # C of 12
        K.peg_fwd(_randn((1, 3, 3, 3, 12), g, dev), w, b, (2, 1, 1), False)
    x = _randn((1, 3, 3, 3, 16), g, dev)
    w16 = torch.randn((16, 1, 3, 3, 3), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        K.peg_bwd(x, x.transpose(1, 2), w16, (2, 1, 1), False)
    with pytest.raises(ValueError, match="pads"):
        K.peg_fwd(x, w16, torch.zeros(16, device=dev), (3, 1, 1), False)
    with pytest.raises(ValueError, match="float16"):
        K.peg_fwd(x.half(), w16, torch.zeros(16, device=dev), (2, 1, 1), False)


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
    """CXR-BERT's bf16 attention under grad at d 64: K7 and K12a on the
    tensor cores without dropout; K13a and K13b on the tensor cores with it.
    Out and every gradient against autograd of the plain version with the
    same mask."""
    from ct_clip_tpu_torch.ops.attention import (attention_plain, dropout_mask,
                                                 fused_attention, fused_attention_kbias_dropout)

    q, k, v, kb, do = (t.to(BF) if t.dtype == torch.float32 and t.dim() == 4 else t
                       for t in _train_attn_inputs(dev, 2, 4, 100, 64, seed=15))
    seed = torch.tensor([9], dtype=torch.int64, device=dev)
    mask = dropout_mask(seed, 2, 4, 100, dropout, dev) if dropout else None
    K.reset_launch_counts()
    if dropout:
        got = _grads(lambda q, k, v, b: fused_attention_kbias_dropout(q, k, v, b, seed,
                                                                      dropout), q, k, v, kb, do)
    else:
        got = _grads(lambda q, k, v, b: fused_attention(q, k, v, key_bias=b), q, k, v, kb, do)
    c = K.launch_counts()
    if dropout:
        assert (c["attention_dropout"], c["attention_dropout_bwd"], c["attention_tc"],
                c["attention_tc_bwd"]) == (1, 1, 1, 1)
    else:
        assert (c["fused_attention"], c["attention_bwd"], c["attention_tc"],
                c["attention_tc_bwd"]) == (1, 1, 1, 1)
    ref = _grads(lambda q, k, v, b: attention_plain(q, k, v, key_bias=b, mask=mask),
                 q, k, v, kb, do)
    _grads_close(got, ref)


def test_layernorm_backward_column_sum_of_dx(dev):
    from ct_clip_tpu_torch.ops.norms import layer_norm

    g = _gen(dev, 16)
    x = _randn((300, 512), g, dev)
    scale = 1 + 0.1 * torch.randn(512, generator=g, device=dev)
    dxn = torch.randn((300, 512), generator=g, device=dev)
    xf = x.detach().float().requires_grad_()
    want, = torch.autograd.grad(layer_norm(xf, scale), xf, dxn)
    dx, _, _, dxsum = K.layernorm_bwd(x, scale, dxn, 1e-5, want_dxsum=True)
    _close(dxsum, want.sum(0), rel=1e-4)
    none, _, _ = K.layernorm_bwd(x, scale, dxn, 1e-5, want_dx=False)
    assert none is None


@pytest.mark.parametrize("shape,pt,p", [((2, 20, 60, 40), 10, 20),  # 16-byte path
                                        ((2, 20, 32, 48), 10, 16),  # GenerateCT's patch
                                        ((1, 6, 15, 25), 2, 5)])   # 2-byte path
def test_unrearrange_patches_k17_bit_exact(dev, shape, pt, p):
    from ct_clip_tpu_torch.ops.patch_embed import (rearrange_patches, unpatchify,
                                                   unrearrange_patches, unrearrange_plain)

    g = _gen(dev, 17)
    video = _randn(shape, g, dev)
    rows = _randn(tuple(rearrange_patches(video, pt, p).shape), g, dev)
    K.reset_launch_counts()
    got = unrearrange_patches(rows, pt, p, *shape[1:])
    torch.cuda.synchronize()
    assert K.launch_counts()["unrearrange_patches"] == 1
    assert torch.equal(got, unrearrange_plain(rows, pt, p, *shape[1:]))
    assert torch.equal(unrearrange_patches(rearrange_patches(video, pt, p), pt, p, *shape[1:]),
                       video)
    v = video.detach().requires_grad_()
    dv, = torch.autograd.grad(rearrange_patches(v, pt, p), v, rows)  # K6's VJP is K17
    assert torch.equal(dv, got)
    r = rows.detach().requires_grad_()  # the decoder's unpatchify: K17, VJP K6
    dr, = torch.autograd.grad(unpatchify(r, pt, p, *shape[1:]), r, video)
    assert torch.equal(dr, rearrange_patches(video, pt, p))


@pytest.mark.parametrize("shape,pt,p", [((1, 200, 128, 128), 10, 16),   # the sampler's rows
                                        ((1, 240, 480, 480), 10, 20)])  # a training volume
def test_unrearrange_patches_f32_k17_runs_bit_exact(dev, shape, pt, p):
    """K17 f32 at its two main-path shapes (unrearrange_runs_kernel: 16-byte
    runs straight from the rows to the volume) equals the plain version bit
    for bit, and is K6's VJP."""
    from ct_clip_tpu_torch.ops.patch_embed import (rearrange_patches, unrearrange_patches,
                                                   unrearrange_plain)

    g = _gen(dev, 18)
    n, pd = (shape[1] // pt) * (shape[2] // p) * (shape[3] // p), pt * p * p
    rows = _randn((shape[0], n, pd), g, dev, dtype=F32)
    K.reset_launch_counts()
    got = unrearrange_patches(rows, pt, p, *shape[1:])
    torch.cuda.synchronize()
    assert K.launch_counts()["unrearrange_patches_f32"] == 1
    assert torch.equal(got, unrearrange_plain(rows, pt, p, *shape[1:]))
    v = torch.zeros(shape, device=dev, requires_grad=True)
    dv, = torch.autograd.grad(rearrange_patches(v, pt, p), v, rows)
    assert torch.equal(dv, got)


def _embed_weights(g, dev, pd=4000, dim=512):
    f32 = torch.float32
    return [1 + _randn((pd,), g, dev, 0.1, f32), _randn((pd,), g, dev, 0.1, f32),
            _randn((dim, pd), g, dev, pd ** -0.5, f32), _randn((dim,), g, dev, 0.1, f32),
            1 + _randn((dim,), g, dev, 0.1, f32), _randn((dim,), g, dev, 0.1, f32)]


@pytest.mark.parametrize("shape", [(2, 20, 60, 40), (3, 20, 220, 180)])
@pytest.mark.parametrize("input_grad", [False, True])
def test_patch_embed_backward_k16a(dev, input_grad, shape):
    """K16a's six weight gradients (f32) and, when the volume requires grad,
    d(volume) through K17, against autograd of the plain forward: its
    products on ffn_tc.cu (NT, TN, NN), the LN(4000) sums in the NN
    product's epilogue without d(volume), dxn stored with it; 24 and 594
    patch rows (ragged against the 128-row tiles)."""
    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed, patch_embed_bwd_plain

    g = _gen(dev, 18)
    video = _randn(shape, g, dev)
    w = _embed_weights(g, dev)
    do = _randn((shape[0], (shape[1] // 10) * (shape[2] // 20) * (shape[3] // 20), 512), g, dev)
    leaves = [video.detach().requires_grad_(input_grad)] + [t.detach().requires_grad_()
                                                            for t in w]
    K.reset_launch_counts()
    out = fused_patch_embed(*leaves, 10, 20)
    got = torch.autograd.grad(out, leaves if input_grad else leaves[1:], do)
    counts = K.launch_counts()
    assert counts["patch_embed_bwd"] == 1 and counts["unrearrange_patches"] == int(input_grad)
    assert counts["ff_tc_gemm"] == 3 and counts["ff_tc_ln_sums"] == int(not input_grad)
    assert all(gr.dtype == torch.float32 for gr in got[-6:])
    ref = patch_embed_bwd_plain(video, *w, do, 10, 20)
    _grads_close(got, ref if input_grad else ref[1:])
    again = torch.autograd.grad(fused_patch_embed(*leaves, 10, 20), leaves[1:], do)
    assert all(torch.equal(a, c) for a, c in zip(got[-6:], again))  # fixed-order sums


def test_k16a_ln_sums_copy_without_rstd_misses(dev):
    """A copy of ffn_tc.cu whose K16a epilogue drops rstd from xhat
    (CT_FF_TC_LN_NO_RSTD) puts ds1 outside the tolerance; db1 and the other
    gradients, which do not read xhat, stay within it."""
    import functools

    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed, patch_embed_bwd_plain

    g = _gen(dev, 20)
    video = _randn((2, 20, 60, 40), g, dev, 0.25)  # rstd ~4: dropping it shows
    w = _embed_weights(g, dev)
    do = _randn((2, 12, 512), g, dev)
    leaves = [t.detach().requires_grad_() for t in w]
    copy = functools.partial(K.ln_sums_tc,
                             lib=K.copy_library("ffn_tc.cu", CT_FF_TC_LN_NO_RSTD=1))
    real = K.ln_sums_tc
    K.ln_sums_tc = copy
    try:
        got = torch.autograd.grad(fused_patch_embed(video, *leaves, 10, 20), leaves, do)
    finally:
        K.ln_sums_tc = real
    ref = patch_embed_bwd_plain(video, *w, do, 10, 20)[1:]
    with pytest.raises(AssertionError):
        _close(got[0], ref[0])
    _grads_close(got[1:], ref[1:])


def test_row_embed_backward_k16b(dev):
    from ct_clip_tpu_torch.ops.patch_embed import fused_row_embed, row_embed_bwd_plain

    g = _gen(dev, 19)
    rows = _randn((2, 300, 4000), g, dev)
    w = _embed_weights(g, dev)
    do = _randn((2, 300, 512), g, dev)
    leaves = [t.detach().requires_grad_() for t in (rows, *w)]
    K.reset_launch_counts()
    got = torch.autograd.grad(fused_row_embed(*leaves), leaves, do)
    assert K.launch_counts()["row_embed_bwd"] == 1
    _grads_close(got, row_embed_bwd_plain(rows, *w, do))


@pytest.mark.parametrize("route", ["volume", "rows"])
def test_inference_embed_under_grad_reaches_every_weight(dev, route):
    """The embeds' gradient reaches all six to_patch_emb weights and the
    input on the card (K16a with K17, K16b), close to the training
    composition's (autograd of the plain chain)."""
    from ct_clip_tpu_torch.config import CTViTConfig
    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_plain

    cfg = CTViTConfig(image_size=60, num_frames=20, spatial_depth=1, temporal_depth=1)
    vt = CTViT(cfg, dtype=BF, device=dev)
    g = _gen(dev, 20)
    video = _randn((2, 20, 60, 60, 1), g, dev)
    x = video if route == "volume" else rearrange_plain(video[..., 0], 10, 20)
    do = _randn((2, 2, 3, 3, 512), g, dev)
    grads = []
    for train in (False, True):
        xi = x.detach().requires_grad_()
        vt.zero_grad()
        vt.embed_patches(xi, train=train).backward(do)
        grads.append([xi.grad] + [p.grad for p in vt.to_patch_emb.parameters()])
    assert all(t is not None and torch.isfinite(t.float()).all() and t.abs().max() > 0
               for t in grads[0])
    _grads_close(grads[0], grads[1])


# ------------------------------- bf16 K7 / K12b on the tensor cores (wgmma)
def _tc_inputs(dev, b, h, n, seed):
    """(b, n, h, 64) bf16 projections viewed head-major, as BERT and MaskGIT
    pass them, q scaled, an output gradient, and the generator."""
    g = _gen(dev, seed)
    q, k, v, do = (_randn((b, n, h, 64), g, dev).transpose(1, 2) for _ in range(4))
    return q * 0.125, k, v, do, g


@pytest.mark.parametrize("n", [1280, 1000])
@pytest.mark.parametrize("form", ["none", "key", "dense_one_head", "dense"])
def test_tc_attention_forward(dev, form, n):
    """attention_tc.cu's forward (bf16, d 64, no grad) against the plain
    version, 2e-2 of max|plain|, at MaskGIT's n and a ragged n: no bias; a
    key bias of f32-min pads (row 1 keeps 7 keys, so whole key tiles are
    padded; row 2 keeps none, a uniform softmax); a dense (1, 1|h, n, n) f32
    bias.  One launch of attention_tc, none of attention_train.cu."""
    from ct_clip_tpu_torch.ops.attention import attention_plain, fused_attention

    b, h = 3, 4
    q, k, v, _, g = _tc_inputs(dev, b, h, n, 40)
    bias = key_bias = None
    if form == "key":
        lengths = torch.tensor([n // 3, 7, 0], device=dev)
        key_bias = (torch.arange(n, device=dev)[None] >= lengths[:, None]).float() \
            * torch.finfo(F32).min
    elif form.startswith("dense"):
        bias = _randn((1, 1 if form == "dense_one_head" else h, n, n), g, dev, 1.0, F32)
    K.reset_launch_counts()
    with torch.no_grad():
        got = fused_attention(q, k, v, bias, key_bias)
    counts = K.launch_counts()
    assert counts["attention_tc"] == 1
    assert counts["attention_dense" if bias is not None else "fused_attention"] == 1
    ref = attention_plain(q, k, v, bias, key_bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, ref)


@pytest.mark.parametrize("n", [1280, 1000])
@pytest.mark.parametrize("form", ["none", "dense_one_head", "dense"])
def test_tc_attention_backward(dev, form, n):
    """attention_tc.cu's K12b (bf16, d 64) against the plain backward, 3e-2
    of max|plain| per output, with no bias (the TokenCritic) and a dense
    (1, 1|h, n, n) bias: dq, dk, dv, dbias.  dbias's rows sum to zero within
    16x the plain f32 version's rounding (D_i from the backward's own f32 P
    and dP); every gradient is bit-identical across two runs; the forward
    and backward each launch attention_tc once and K12a never."""
    from ct_clip_tpu_torch.ops.attention import (attention_bwd_plain, attention_plain,
                                                 fused_attention)

    b, h = 2, 4
    q, k, v, do, g = _tc_inputs(dev, b, h, n, 41)
    bias = None if form == "none" else \
        _randn((1, 1 if form == "dense_one_head" else h, n, n), g, dev, 1.0, F32)
    leaves = [t.detach().clone().requires_grad_()
              for t in (q, k, v) + (() if bias is None else (bias,))]

    def run():
        out = fused_attention(*leaves[:3], leaves[3] if bias is not None else None)
        return (out, *torch.autograd.grad(out, leaves, do))
    K.reset_launch_counts()
    got = run()
    counts = K.launch_counts()
    assert (counts["attention_tc"], counts["attention_tc_bwd"], counts["attention_dense_bwd"],
            counts["attention_bwd"]) == (1, 1, 1, 0)
    ref = (attention_plain(q, k, v, bias),
           *attention_bwd_plain(q, k, v, do, bias)[:3 if bias is None else 4])
    torch.cuda.synchronize()
    _close(got[0], ref[0])
    for gr, r in zip(got[1:], ref[1:]):
        assert gr.shape == r.shape
        _close(gr, r, rel=3e-2)
    again = run()
    assert all(torch.equal(x, y) for x, y in zip(again[1:], got[1:]))
    if bias is not None:
        assert got[4].dtype == F32
        ref32 = attention_bwd_plain(*(t.float() for t in (q, k, v, do)), bias)[3]
        assert got[4].sum(-1).abs().max() <= 16 * ref32.sum(-1).abs().max()


def test_tc_routing_counters(dev):
    """bf16 at d 64: a key-bias forward under grad and its backward (K7,
    K12a) run attention_tc.cu, with or without grad; so do a dropout forward
    (K13a) and its backward (K13b).
    d 32 in bf16 is routed by its shape to attention_train.cu, forward and
    backward, dropout or not."""
    from ct_clip_tpu_torch.ops.attention import (attention_plain, fused_attention,
                                                 fused_attention_kbias_dropout)

    q, k, v, kb, do = _train_attn_inputs(dev, 2, 4, 100, 64, seed=42)
    q, k, v, do = (t.to(BF) for t in (q, k, v, do))
    K.reset_launch_counts()
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(fused_attention(*ins, key_bias=kb), ins, do)
    counts = K.launch_counts()
    assert (counts["fused_attention"], counts["attention_tc"], counts["attention_bwd"],
            counts["attention_tc_bwd"]) == (1, 1, 1, 1)
    K.reset_launch_counts()
    torch.autograd.grad(fused_attention_kbias_dropout(*ins, kb, 5, 0.1), ins, do)
    counts = K.launch_counts()
    assert (counts["attention_dropout"], counts["attention_tc"], counts["attention_dropout_bwd"],
            counts["attention_tc_bwd"]) == (1, 1, 1, 1)
    with torch.no_grad():
        fused_attention(q, k, v, key_bias=kb)
    assert K.launch_counts()["attention_tc"] == 2  # the dropout forward and this one
    q32, k32, v32, do32 = (t[..., :32].contiguous() for t in (q, k, v, do))
    K.reset_launch_counts()
    with torch.no_grad():
        got = fused_attention(q32, k32, v32, key_bias=kb)
    counts = K.launch_counts()
    assert (counts["fused_attention"], counts["attention_tc"]) == (1, 0)
    _close(got, attention_plain(q32, k32, v32, key_bias=kb))
    ins32 = [t.detach().clone().requires_grad_() for t in (q32, k32, v32)]
    K.reset_launch_counts()
    torch.autograd.grad(fused_attention(*ins32, key_bias=kb), ins32, do32)
    torch.autograd.grad(fused_attention_kbias_dropout(*ins32, kb, 5, 0.1), ins32, do32)
    counts = K.launch_counts()
    assert (counts["attention_bwd"], counts["attention_dropout_bwd"], counts["attention_tc"],
            counts["attention_tc_bwd"]) == (1, 1, 0, 0)


@pytest.mark.parametrize("want_dkb", [True, False])
@pytest.mark.parametrize("n", [512, 200])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_tc_key_bias_backward_k12a_k13b(dev, rate, n, want_dkb):
    """attention_tc.cu's key-bias backward (bf16, d 64): K12a (rate 0) and
    K13b (rate 0.1), each after the tensor-core forward (K7, K13a), against
    autograd of the plain version with the explicit
    mask of the same seed, 3e-2 of max|plain| per output (dq, dk, dv and,
    when wanted, dkey_bias); the forward's output 2e-2.  Ragged pad lengths:
    row 1 keeps 7 keys, so whole key tiles are padded.  Every gradient is
    bit-identical across two runs.  With dropout, the plain version under
    another seed's mask must miss the tolerance: the backward draws the
    forward's bits, not any bits."""
    from ct_clip_tpu_torch.ops.attention import (attention_plain, dropout_mask,
                                                 fused_attention, fused_attention_kbias_dropout)

    b, h = 3, 4
    q, k, v, do, g = _tc_inputs(dev, b, h, n, 43)
    lengths = torch.tensor([n, 7, n // 3 + 5], device=dev)
    kb = (torch.arange(n, device=dev)[None] >= lengths[:, None]).float() * torch.finfo(F32).min
    seed = torch.tensor([20261017], dtype=torch.int64, device=dev)
    leaves = [t.detach().clone().requires_grad_(i < 3 or want_dkb)
              for i, t in enumerate((q, k, v, kb))]

    def run():
        if rate:
            out = fused_attention_kbias_dropout(*leaves, seed, rate)
        else:
            out = fused_attention(*leaves[:3], key_bias=leaves[3])
        return (out, *torch.autograd.grad(out, leaves[:4 if want_dkb else 3], do))
    K.reset_launch_counts()
    got = run()
    c = K.launch_counts()
    fn = "attention_dropout" if rate else "fused_attention"
    bwd = "attention_dropout_bwd" if rate else "attention_bwd"
    assert (c[fn], c[bwd], c["attention_tc"], c["attention_tc_bwd"]) == (1, 1, 1, 1)

    def plain(mask):
        ins = [t.detach().clone().requires_grad_(i < 3 or want_dkb)
               for i, t in enumerate((q, k, v, kb))]
        out = attention_plain(*ins[:3], key_bias=ins[3], mask=mask)
        return (out, *torch.autograd.grad(out, ins[:4 if want_dkb else 3], do))
    mask = dropout_mask(seed, b, h, n, rate, dev) if rate else None
    ref = plain(mask)
    torch.cuda.synchronize()
    _close(got[0], ref[0])
    for gr, r in zip(got[1:], ref[1:]):
        assert gr.shape == r.shape and gr.dtype == r.dtype
        assert torch.isfinite(gr.float()).all()
        _close(gr, r, rel=BWD_REL)
    again = run()
    assert all(torch.equal(x, y) for x, y in zip(again[1:], got[1:]))
    if rate:
        wrong = plain(dropout_mask(seed + 1, b, h, n, rate, dev))
        errs = [(gr.float() - r.float()).abs().max().item() / r.float().abs().max().item()
                for gr, r in zip(got[1:4], wrong[1:4])]
        assert max(errs) > BWD_REL, f"another seed's mask reads within tolerance: {errs}"


@pytest.mark.parametrize("n", [512, 500])
def test_tc_k13a_forward_draws_the_backward_mask(dev, n):
    """K13a in bf16 on attention_tc.cu (no grad) at CXR-BERT's (8, 12, n, 64)
    with pad key biases: within 2e-2 of max|plain| against the plain version
    with the same seed's mask, outside it with another seed's; bit-identical
    reruns; one launch of attention_tc and none of attention_train.cu."""
    from ct_clip_tpu_torch.ops.attention import (attention_dropout_plain,
                                                 fused_attention_kbias_dropout)

    q, k, v, kb, _ = _train_attn_inputs(dev, 8, 12, n, 64, seed=44)
    q, k, v = (t.to(BF) for t in (q, k, v))
    seed = torch.tensor([31337], dtype=torch.int64, device=dev)
    K.reset_launch_counts()
    with torch.no_grad():
        got = fused_attention_kbias_dropout(q, k, v, kb, seed, 0.1)
    c = K.launch_counts()
    assert (c["attention_dropout"], c["attention_tc"]) == (1, 1)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, attention_dropout_plain(q, k, v, kb, seed, 0.1))
    wrong = attention_dropout_plain(q, k, v, kb, seed + 1, 0.1)
    err = (got.float() - wrong.float()).abs().max().item()
    assert err > REL * wrong.float().abs().max().item()
    with torch.no_grad():
        assert torch.equal(fused_attention_kbias_dropout(q, k, v, kb, seed, 0.1), got)


TC32_REL = 1e-5


@pytest.mark.parametrize("n", [512, 200])
def test_tc32_k12a_f32_backward(dev, n):
    """K12a f32 on attention_tc32.cu (3xTF32): dq, dk, dv and dkey_bias
    within 1e-5 of max|plain| (TF32 off) at (4, 12, n, 64) with pad key
    biases, after the 3xTF32 forward; bit-identical reruns; a copy
    of the kernel built with CT_TC32_PASSES=1 (plain TF32) misses 1e-5."""
    import functools

    from ct_clip_tpu_torch.ops.attention import attention_plain, fused_attention

    args = _train_attn_inputs(dev, 4, 12, n, 64, seed=45)
    K.reset_launch_counts()
    got = _grads(lambda q, k, v, kb: fused_attention(q, k, v, key_bias=kb), *args)
    c = K.launch_counts()
    assert (c["fused_attention"], c["attention_bwd"], c["attention_tc32_bwd"],
            c["attention_tc"], c["attention_tc_bwd"]) == (1, 1, 1, 0, 0)
    ref = _grads(lambda q, k, v, kb: attention_plain(q, k, v, key_bias=kb), *args)
    torch.cuda.synchronize()
    _close(got[0], ref[0], rel=1e-4)  # K7 f32, attention_tc32.cu's forward
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.float32
        _close(g, r, rel=TC32_REL)
    again = _grads(lambda q, k, v, kb: fused_attention(q, k, v, key_bias=kb), *args)
    assert all(torch.equal(x, y) for x, y in zip(again[1:], got[1:]))
    copy = K.copy_library("attention_tc32.cu", CT_TC32_PASSES=1)
    tc32 = K.attention_tc32_bwd
    K.attention_tc32_bwd = functools.partial(tc32, lib=copy)
    try:
        tf32 = _grads(lambda q, k, v, kb: fused_attention(q, k, v, key_bias=kb), *args)
    finally:
        K.attention_tc32_bwd = tc32
    errs = [(g - r).abs().max().item() / r.abs().max().item()
            for g, r in zip(tf32[1:4], ref[1:4])]
    assert min(errs) > TC32_REL, f"plain TF32 reads within 1e-5: {errs}"


@pytest.mark.parametrize("n", [512, 200])
@pytest.mark.parametrize("form", ["dense", "dense_one_head", "none", "dropout"])
def test_tc32_k12b_k13b_f32_backward(dev, form, n):
    """The other f32 backwards of attention_tc32.cu (3xTF32) after its
    forward: K12b with a per-head or one-head dense bias (dbias
    summed over the batch, and the heads), K12b with no bias, K13b with a pad
    key bias and dropout 0.1 (the plain version takes the same seed's mask),
    at (3, 4, n, 64): dq, dk, dv and dbias / dkey_bias within 1e-5 of
    max|plain| (TF32 off); bit-identical reruns; one launch of
    attention_tc32_bwd beside the function's counter (K12b
    `attention_dense_bwd`, K13b `attention_dropout_bwd`); the plain-TF32
    copy of the kernel misses 1e-5 in dq, dk and dv."""
    import functools

    from ct_clip_tpu_torch.ops.attention import (attention_bwd_plain, dropout_mask,
                                                 fused_attention, fused_attention_kbias_dropout)

    b, h, rate = 3, 4, 0.1
    q, k, v, kb, do = _train_attn_inputs(dev, b, h, n, 64, seed=46)
    seed = torch.tensor([20261018], dtype=torch.int64, device=dev)
    heads = {"dense": h, "dense_one_head": 1}.get(form)
    bias = _randn((1, heads, n, n), _gen(dev, 47), dev, 1.0, F32) if heads else None
    extra = {"dropout": kb, "dense": bias, "dense_one_head": bias}.get(form)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    if extra is not None:
        leaves.append(extra.detach().clone().requires_grad_())

    def run():
        if form == "dropout":
            out = fused_attention_kbias_dropout(*leaves, seed, rate)
        else:
            out = fused_attention(*leaves[:3], bias=leaves[3] if heads else None)
        return torch.autograd.grad(out, leaves, do)
    K.reset_launch_counts()
    got = run()
    c = K.launch_counts()
    fn = "attention_dropout_bwd" if form == "dropout" else "attention_dense_bwd"
    assert (c[fn], c["attention_tc32_bwd"], c["attention_bwd"], c["attention_tc_bwd"]) \
        == (1, 1, 0, 0)
    if form == "dropout":
        ref = attention_bwd_plain(q, k, v, do, key_bias=kb,
                                  mask=dropout_mask(seed, b, h, n, rate, dev))
        ref = ref[:3] + (ref[4],)
    else:
        ref = attention_bwd_plain(q, k, v, do, bias)[:4 if heads else 3]
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == F32 and g.shape == r.shape
        _close(g, r, rel=TC32_REL)
    assert all(torch.equal(x, y) for x, y in zip(run(), got))
    tc32 = K.attention_tc32_bwd
    K.attention_tc32_bwd = functools.partial(
        tc32, lib=K.copy_library("attention_tc32.cu", CT_TC32_PASSES=1))
    try:
        tf32 = run()
    finally:
        K.attention_tc32_bwd = tc32
    errs = [(g - r).abs().max().item() / r.abs().max().item()
            for g, r in zip(tf32[:3], ref[:3])]
    assert min(errs) > TC32_REL, f"plain TF32 reads within 1e-5: {errs}"


@pytest.mark.parametrize("n", [512, 200])
@pytest.mark.parametrize("form", ["key", "dense", "dense_one_head", "none", "dropout"])
def test_tc32_k7_k13a_f32_forward(dev, form, n):
    """The f32 forwards of attention_tc32.cu (3xTF32): K7 with a pad key
    bias, a per-head or one-head dense bias, or none, and K13a with a pad
    key bias and dropout 0.1 (the plain version takes the same seed's mask),
    at (3, 4, n, 64) through the wrapper the model calls: the output within
    1e-5 of max|plain| (TF32 off) and the row log-sum-exp within 1e-5 of
    max|lse| of the plain scores' (as the kernel adds the bias); one launch
    of attention_tc32 beside the function's counter; bit-identical reruns;
    the plain-TF32 copy of the kernel misses 1e-5."""
    import functools

    from ct_clip_tpu_torch.ops.attention import (attention_plain, dropout_mask,
                                                 fused_attention, fused_attention_kbias_dropout)

    b, h, rate = 3, 4, 0.1
    q, k, v, kb, _ = _train_attn_inputs(dev, b, h, n, 64, seed=48)
    seed = torch.tensor([20261019], dtype=torch.int64, device=dev)
    heads = {"dense": h, "dense_one_head": 1}.get(form)
    bias = _randn((1, heads, n, n), _gen(dev, 49), dev, 1.0, F32) if heads else None
    key_bias = kb if form in ("key", "dropout") else None
    mask = dropout_mask(seed, b, h, n, rate, dev) if form == "dropout" else None

    def run():
        if form == "dropout":
            return fused_attention_kbias_dropout(q, k, v, kb, seed, rate)
        return fused_attention(q, k, v, bias, key_bias)
    K.reset_launch_counts()
    got = run()
    c = K.launch_counts()
    fn = {"dropout": "attention_dropout", "dense": "attention_dense",
          "dense_one_head": "attention_dense"}.get(form, "fused_attention")
    assert (c[fn], c["attention_tc32"], c["attention_tc"]) == (1, 1, 0)
    ref = attention_plain(q, k, v, bias, key_bias, mask=mask)
    torch.cuda.synchronize()
    assert got.dtype == F32 and got.shape == q.shape
    _close(got, ref, rel=TC32_REL)
    out, lse = torch.empty_like(q), torch.empty((b, h, n), device=dev)
    drop = dict(seed=seed, rate=rate) if form == "dropout" else {}
    K.attention_tc32_fwd(q, k, v, out, lse, key_bias=key_bias,
                         bias=None if bias is None else bias[0].contiguous(), **drop)
    s = q @ k.transpose(-1, -2)
    if bias is not None:
        s = s + bias
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    _close(lse, torch.logsumexp(s, dim=-1), rel=TC32_REL)
    assert torch.equal(out, got) and torch.equal(run(), got)
    fwd = K.attention_tc32_fwd
    K.attention_tc32_fwd = functools.partial(
        fwd, lib=K.copy_library("attention_tc32.cu", CT_TC32_PASSES=1))
    try:
        tf32 = run()
    finally:
        K.attention_tc32_fwd = fwd
    err = (tf32 - ref).abs().max().item() / ref.abs().max().item()
    assert err > TC32_REL, f"plain TF32 reads within 1e-5: {err}"


# ------------------------------------------------------------ the f32 forms
# K1, K2 (grid and sequence-major), K3, K11, K5 on f32 rows, K6 and K17 in
# f32 (`-k f32`): true f32 products on the CUDA cores against the plain
# versions in f32 with TF32 off, another summation order: forwards within
# 1e-5 x max|plain|, K11's weight gradients (sums over all rows) 1e-4.
F32_FWD = 1e-5
F32_WGRAD = 1e-4


@pytest.mark.parametrize("M,N,K_", [(100, 70, 40), (129, 64, 64), (64, 1365, 512),
                                    (77, 33, 13)])
@pytest.mark.parametrize("epi", [K.EPI_STORE, K.EPI_RESIDUAL,
                                 K.EPI_BIAS_ROUNDED, K.EPI_GEGLU])
def test_gemm_f32_epilogues(dev, M, N, K_, epi):
    g = _gen(dev, 40)
    a, w, w2 = (_randn(s, g, dev, dtype=F32) for s in ((M, K_), (N, K_), (N, K_)))
    r, bias = _randn((M, N), g, dev, dtype=F32), _randn((N,), g, dev, dtype=F32)
    out = torch.empty((M, N), dtype=F32, device=dev)
    K.gemm(epi, a, w, out, w2=w2 if epi == K.EPI_GEGLU else None,
           residual=r if epi == K.EPI_RESIDUAL else None,
           bias=bias if epi == K.EPI_BIAS_ROUNDED else None)
    acc = a.double() @ w.double().t()
    if epi == K.EPI_RESIDUAL:
        acc = acc + r.double()
    elif epi == K.EPI_BIAS_ROUNDED:  # no rounding in f32
        acc = acc + bias.double()
    elif epi == K.EPI_GEGLU:
        acc = acc * torch.nn.functional.gelu(a.double() @ w2.double().t())
    torch.cuda.synchronize()
    _close(out, acc, rel=F32_FWD)
    with pytest.raises(ValueError):  # every operand of one form
        K.gemm(epi, a, w.to(BF), out)


@pytest.mark.parametrize("M,N,K_", [(100, 70, 300), (64, 512, 5000), (33, 17, 9)])
def test_gemm_f32_nn_and_tn_layouts(dev, M, N, K_):
    g = _gen(dev, 41)
    dy, w = _randn((M, K_), g, dev, dtype=F32), _randn((K_, N), g, dev, dtype=F32)
    out = torch.empty((M, N), dtype=F32, device=dev)
    K.gemm_nn(dy, w, out)
    x = _randn((M, N), g, dev, dtype=F32)
    dw = K.gemm_tn(dy, x)
    torch.cuda.synchronize()
    _close(out, dy.double() @ w.double(), rel=F32_FWD)
    _close(dw, dy.double().t() @ x.double(), rel=F32_FWD)
    with pytest.raises(ValueError):  # f32 operands write f32
        K.gemm_nn(dy, w, out.to(BF))


def test_layernorm_f32_forward_and_backward(dev):
    from ct_clip_tpu_torch.ops.autograd import vjp
    from ct_clip_tpu_torch.ops.norms import layer_norm

    g = _gen(dev, 42)
    x = _randn((300, 512), g, dev, 3.0, F32) + 1.0
    scale, bias = 1 + _randn((512,), g, dev, 0.1, F32), _randn((512,), g, dev, 0.1, F32)
    out = torch.empty_like(x)
    K.layernorm(x, scale, bias, 1e-5, out)
    _close(out, layer_norm(x, scale, bias), rel=F32_FWD)
    dxn, add2 = _randn((300, 512), g, dev, dtype=F32), _randn((300, 512), g, dev, dtype=F32)
    dx, ds, db = K.layernorm_bwd(x, scale, dxn, 1e-5, add2=add2, want_dbias=True)
    rdx, rds, rdb = vjp(lambda a, s, b: layer_norm(a, s, b), (x, scale, bias), dxn)
    torch.cuda.synchronize()
    assert dx.dtype == F32
    _close(dx, rdx + add2, rel=F32_FWD)
    _close(ds, rds, rel=F32_WGRAD)
    _close(db, rdb, rel=F32_WGRAD)


def _ff_f32_inputs(dev, rows, seed):
    g = _gen(dev, seed)
    x = _randn((rows, 512), g, dev, dtype=F32)
    return (x, 1 + _randn((512,), g, dev, 0.1, F32), _randn((512,), g, dev, 0.1, F32),
            _randn((2730, 512), g, dev, 512 ** -0.5, F32),
            _randn((512, 1365), g, dev, 1365 ** -0.5, F32)), _randn((rows, 512), g, dev, dtype=F32)


@pytest.mark.parametrize("rows", [130, 300, 2048])
def test_geglu_ff_f32_k3_and_k11(dev, rows):
    """K3 f32 in 3xTF32 on ffn_tc32.cu (rows ragged against its 128-row
    tiles at 130 and 300) within F32_FWD of the plain version in true f32,
    bit-identical across runs, its plain-TF32 copy outside; K11 f32."""
    from ct_clip_tpu_torch.ops.ffn import (_geglu_ff_tc32, fused_geglu_ff, geglu_ff_bwd_plain,
                                           geglu_ff_plain)

    args, do = _ff_f32_inputs(dev, rows, 43)
    K.reset_launch_counts()
    out, ref_out = fused_geglu_ff(*args), geglu_ff_plain(*args)
    _close(out, ref_out, rel=F32_FWD)
    assert torch.equal(out, fused_geglu_ff(*args))
    leaves = [t.detach().clone().requires_grad_() for t in args]
    got = torch.autograd.grad(fused_geglu_ff(*leaves), leaves, do)
    ref = geglu_ff_bwd_plain(*args, do)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["geglu_ff_f32"] == 3 and counts["geglu_ff_tc32"] == 3
    assert counts["geglu_ff_bwd_f32"] == 1
    tf32 = _geglu_ff_tc32(*args, 1e-5, lib=K.copy_library("ffn_tc32.cu", CT_TC32_PASSES=1))
    with pytest.raises(AssertionError):
        _close(tf32, ref_out, rel=F32_FWD)
    _close(got[0], ref[0], rel=F32_FWD)  # dx
    for gr, r in zip(got[1:], ref[1:]):  # dscale, dbias, dwi, dwo
        assert gr.dtype == F32
        _close(gr, r, rel=F32_WGRAD)


def test_ff_bwd_core_f32_keeps_act_unrounded(dev):
    g = _gen(dev, 44)
    xn, dout = (_randn((130, 96), g, dev, dtype=F32) for _ in range(2))
    wa, wg, woT = (_randn((72, 96), g, dev, 0.1, F32) for _ in range(3))
    act, dcat = K.ff_bwd_core(xn, dout, wa, wg, woT)
    a, gt = xn.double() @ wa.double().t(), xn.double() @ wg.double().t()
    dact = dout.double() @ woT.double().t()
    gelu = torch.nn.functional.gelu(gt)
    torch.cuda.synchronize()
    assert act.dtype == dcat.dtype == F32
    _close(act, a * gelu, rel=F32_FWD)
    _close(dcat[:, :72], dact * gelu, rel=F32_FWD)


def test_spatial_qknorm_attention_f32_k1(dev):
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_spatial_qknorm_attention, qknorm_attention_plain)

    g = _gen(dev, 45)
    w = _attn_weights(g, dev)
    for b, n in ((2, 576), (6, 64), (3, 100)):
        x = _randn((b, n, 512), g, dev, dtype=F32)
        bias = _randn((8, n, n), g, dev, dtype=F32)
        K.reset_launch_counts()
        got = fused_spatial_qknorm_attention(x, *w, bias, 8, 32)
        ref = qknorm_attention_plain(x, *w, bias, 8, 32)
        torch.cuda.synchronize()
        assert K.launch_counts()["spatial_attention_f32"] == 1
        _close(got, ref, rel=F32_FWD)


def test_grid_and_seq_qknorm_attention_f32_k2(dev):
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_small_qknorm_attention,
        grid_qknorm_attention_plain, qknorm_attention_plain)

    g = _gen(dev, 46)
    w = _attn_weights(g, dev)
    xg = _randn((2, 24, 36, 512), g, dev, dtype=F32)
    _close(fused_grid_qknorm_attention(xg, *w, 8, 32),
           grid_qknorm_attention_plain(xg, *w, 8, 32), rel=F32_FWD)
    xs = _randn((40, 20, 512), g, dev, dtype=F32)
    K.reset_launch_counts()
    _close(fused_small_qknorm_attention(xs, *w, 8, 32),
           qknorm_attention_plain(xs, *w, None, 8, 32), rel=F32_FWD)
    assert K.launch_counts()["seq_attention_f32"] == 1


def test_qknorm_attention_f32_backward_raises(dev):
    """The f32 backward (K9 f32) runs on its kernel and is counted, f32 in and
    out: it no longer raises, and never falls back."""
    from ct_clip_tpu_torch.ops.qknorm_attention import fused_spatial_qknorm_attention

    g = _gen(dev, 47)
    w = [t.requires_grad_() for t in _attn_weights(g, dev)]
    x = _randn((2, 64, 512), g, dev, dtype=F32).requires_grad_()
    out = fused_spatial_qknorm_attention(x, *w, None, 8, 32)
    K.reset_launch_counts()
    out.sum().backward()
    torch.cuda.synchronize()
    c = K.launch_counts()
    assert c["spatial_attention_bwd"] == 1 and c["spatial_attention_bwd_f32"] == 1
    assert x.grad.dtype == F32 and all(t.grad.dtype == F32 for t in w)
    assert torch.isfinite(x.grad).all()


def _f32_bwd_close(got, ref):
    """dx within F32_FWD of max|plain|; the sums over all sequences (dgamma,
    the weight and scale gradients, dbias) within F32_WGRAD."""
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is not None:
            _close(a, b, rel=F32_FWD if i == 0 else F32_WGRAD)


def _qknorm_f32_grads(form, shape, seed):
    """(kernel gradients, plain gradients, a rerun of the kernel's) of the
    f32 sublayer `form` on x of `shape` + (512,), 8 heads of 32."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    dev = torch.device("cuda")
    g = _gen(dev, seed)
    w = _attn_weights(g, dev)
    x, do = _randn(shape + (512,), g, dev, dtype=F32), _randn(shape + (512,), g, dev, dtype=F32)
    n = shape[1]
    bias = _randn((8, n, n), g, dev, dtype=F32) if form == "spatial" else None
    fn = {"spatial": lambda *a: Q.fused_spatial_qknorm_attention(*a, 8, 32),
          "grid": lambda *a: Q.fused_grid_qknorm_attention(*a, 8, 32),
          "seq": lambda *a: Q.fused_small_qknorm_attention(*a, 8, 32)}[form]
    args = (x, *w) + ((bias,) if bias is not None else ())
    leaves = [t.detach().clone().requires_grad_() for t in args]
    got = torch.autograd.grad(fn(*leaves), leaves, do)
    if form == "grid":
        ref = Q.grid_qknorm_attention_bwd_plain(x, *w, do, 8, 32)
    else:
        ref = Q.qknorm_attention_bwd_plain(x, *w, bias, do, 8, 32)
        ref = ref if bias is not None else ref[:7]
    return got, ref, lambda: torch.autograd.grad(fn(*leaves), leaves, do)


@pytest.mark.parametrize("form,shape", [("spatial", (3, 100)), ("spatial", (2, 576)),
                                        ("spatial", (6, 64)), ("grid", (2, 24, 36)),
                                        ("seq", (40, 16)), ("seq", (40, 20))])
def test_qknorm_attention_f32_backward_k9_k10(dev, form, shape):
    """K9 f32 (with the CPB bias, n 100, 576 and the autoencoder's 64), K10
    grid f32 (t 24) and K10 seq f32 (t 16, 20) against autograd of the plain
    forward in true f32, counted on their f32 counters, and their
    fixed-order sums (two runs bit-identical)."""
    K.reset_launch_counts()
    got, ref, again = _qknorm_f32_grads(form, shape, 52)
    torch.cuda.synchronize()
    c = K.launch_counts()
    assert c[f"{form}_attention_bwd"] == 1 and c[f"{form}_attention_bwd_f32"] == 1
    # K9's planes (n >= 32) take the 3xTF32 core, K10's short sequences not
    assert c["qk_attention_tc32_bwd"] == int(form == "spatial")
    assert all(t.dtype == F32 for t in got)
    _f32_bwd_close(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again()))


def test_qknorm_attention_f32_backward_planted_p_rounding_misses(dev, monkeypatch):
    """A copy of the CUDA-core kernel with P rounded to bf16 before the
    merged heads' product (CT_QK_BWD_F32_ROUND_P), the core forced onto it
    (K9's f32 planes take qknorm_attention_tc32.cu), must miss the f32
    limits: dW_out reads the bf16 rounding."""
    import functools

    copy = K.copy_library("qknorm_attention_bwd.cu", CT_QK_BWD_F32_ROUND_P=1)
    monkeypatch.setattr(K, "qk_bwd_tensor_cores", lambda *a: K.QK_CUDA_CORES)
    monkeypatch.setattr(K, "qk_attention_bwd", functools.partial(K.qk_attention_bwd, lib=copy))
    got, ref, _ = _qknorm_f32_grads("spatial", (3, 100), 52)
    torch.cuda.synchronize()
    dwout_rel = ((got[6] - ref[6]).abs().max() / ref[6].abs().max()).item()
    assert dwout_rel > F32_WGRAD, dwout_rel


def _qk_core_f32(dev, S, n, bias):
    q, kv, dm, layout = _qk_core_case(dev, S, n, bias, seed=53)
    return q.float(), kv.float(), dm.float(), layout


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("S,n", [(4, 576), (12, 64), (6, 100)])
def test_qk_core_backward_k9_f32_tc32(dev, S, n, bias):
    """K9's f32 core on qknorm_attention_tc32.cu (3xTF32) at CT-CLIP's
    576-token planes, the autoencoder's 64 and a ragged 100, with the CPB
    bias and without, against the plain version in true f32 (TF32 off):
    merged, dq, dkv within 1e-5 of max|plain|, the sums over all planes
    within 1e-4; dbias rows sum to zero within 16x the plain version's
    rounding; every output bit-identical across runs; counted
    `qk_attention_tc32_bwd` at the launch."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain as plain

    q, kv, dm, layout = _qk_core_f32(dev, S, n, bias)
    assert K.qk_bwd_tensor_cores(q.dtype, n, 32) == K.QK_TC32
    K.reset_launch_counts()
    got = K.qk_attention_bwd(q, kv, dm, **layout)
    assert K.launch_counts()["qk_attention_tc32_bwd"] == 1
    ref = plain(q, kv, dm, layout["heads"], 32, n, layout["q_scale"], layout["k_scale"],
                layout["bias"])
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype == F32, i
        _close(a, b, TC32_REL if i < 3 else F32_WGRAD)
    again = K.qk_attention_bwd(q, kv, dm, **layout)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    if bias:
        assert _dbias_row_sums(got[5]) <= 16 * _dbias_row_sums(ref[5])


def test_qk_core_backward_k9_f32_plain_tf32_copy_misses(dev):
    """A copy of qknorm_attention_tc32.cu built with CT_TC32_PASSES=1 (hi hi
    alone, plain TF32) misses 1e-5 in merged, dq and dkv: the tolerance
    tells 3xTF32 from TF32."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain as plain

    copy = K.copy_library("qknorm_attention_tc32.cu", CT_TC32_PASSES=1)
    q, kv, dm, layout = _qk_core_f32(dev, 4, 576, True)
    got = K.qk_attention_bwd(q, kv, dm, lib=copy, **layout)
    ref = plain(q, kv, dm, layout["heads"], 32, 576, layout["q_scale"], layout["k_scale"],
                layout["bias"])
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() / b.abs().max().item() for a, b in zip(got[:3], ref[:3])]
    assert min(errs) > TC32_REL, errs


def test_vq_exact_assign_f32_rows_k5_and_stats_k15(dev):
    """K5 exact on f32 rows against the plain version of its own math (ids
    equal up to ties within 1e-5), K15 on f32 rows against its plain version
    (bins exact, sums within 1e-6 of max; the full-f32 sums must miss that
    limit), each counted;
    shapes the JAX package's plan refuses take the full-f32 plain versions,
    counted as such."""
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import (cluster_stats, cluster_stats_plain,
                                          cluster_stats_rows_plain, vq_assign,
                                          vq_assign_exact_rows_plain, vq_assign_exact_rows_sim)

    g = _gen(dev, 53)
    x = _randn((4096, 512), g, dev, dtype=F32)
    embed_n = l2norm(torch.randn((8192, 512), generator=g, device=dev))
    K.reset_launch_counts()
    got = vq_assign(x, embed_n, exact=True)
    bins, esum = cluster_stats(x, got, 8192)
    torch.cuda.synchronize()
    c = K.launch_counts()
    assert c["vq_assign_exact_f32"] == 1 and c["vq_cluster_stats_f32"] == 1
    ref = vq_assign_exact_rows_plain(x, embed_n)
    assert (got == ref).float().mean().item() >= 0.999
    sim = vq_assign_exact_rows_sim(x, embed_n)
    gap = (sim.gather(1, ref.long()[:, None]) - sim.gather(1, got.long()[:, None])).abs()[:, 0]
    assert (gap <= 1e-5 * sim.abs().max(dim=1).values).all()
    rbins, resum = cluster_stats_rows_plain(x, got, 8192)
    assert torch.equal(bins, rbins)
    top = resum.abs().max()
    assert ((esum - resum).abs() <= 1e-6 * top).all()
    full = cluster_stats_plain(x, got, 8192)[1]
    assert ((full - resum).abs() > 1e-6 * top).any()
    assert torch.equal(cluster_stats(x, got, 8192)[1], esum)
    K.reset_launch_counts()
    vq_assign(x[:100], embed_n, exact=True)
    cluster_stats(x[:100], got[:100], 8192)
    c = K.launch_counts()
    assert (c["vq_assign_plain"], c["vq_cluster_stats_plain"]) == (1, 1)
    assert (c["vq_assign_exact"], c["vq_cluster_stats"]) == (0, 0)


def test_vq_assign_f32_rows_k5(dev):
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import (CosineVQ, vq_assign, vq_assign_rows_lane_plain,
                                          vq_rows_lane_sim)

    g = _gen(dev, 48)
    x = _randn((2048, 512), g, dev, dtype=F32)
    embed_n = l2norm(torch.randn((8192, 512), generator=g, device=dev))
    K.reset_launch_counts()
    got = vq_assign(x, embed_n).long()
    ref = vq_assign_rows_lane_plain(x, embed_n).long()
    torch.cuda.synchronize()
    assert K.launch_counts()["vq_assign_f32"] == 1 and K.launch_counts()["vq_assign_tc"] == 1
    assert (got == ref).float().mean().item() >= 0.999
    # any disagreement is a tie of the kernel's own math (its bf16 rows are
    # the plain version's, bit for bit) up to f32 order
    sim = vq_rows_lane_sim(x, embed_n)
    gap = (sim.gather(1, ref[:, None]) - sim.gather(1, got[:, None])).abs()[:, 0]
    assert (gap <= 1e-5 * sim.abs().max(dim=1).values).all()
    # shapes the JAX package's plan refuses take the f32 XLA form's plain version
    K.reset_launch_counts()
    vq_assign(x[:100], embed_n)
    assert K.launch_counts()["vq_assign_f32"] == 0
    vq = CosineVQ(512, 8192, device=dev)
    K.reset_launch_counts()
    vq(x[None], train=True)  # exact mode (training) and K15, f32 forms
    c = K.launch_counts()
    assert c["vq_assign_exact_f32"] == 1 and c["vq_cluster_stats_f32"] == 1


@pytest.mark.parametrize("shape,pt,p", [((2, 20, 60, 40), 10, 20),  # 16-byte path
                                        ((1, 6, 15, 25), 2, 5)])   # 4-byte path
def test_rearrange_patches_f32_k6_k17_bit_exact(dev, shape, pt, p):
    from ct_clip_tpu_torch.ops.patch_embed import (rearrange_patches, rearrange_plain,
                                                   unrearrange_patches)

    video = _randn(shape, _gen(dev, 49), dev, dtype=F32)
    K.reset_launch_counts()
    got = rearrange_patches(video, pt, p)
    torch.cuda.synchronize()
    assert torch.equal(got, rearrange_plain(video, pt, p))
    buf = torch.full((3,) + tuple(got.shape[1:]), 7.0, dtype=F32, device=dev)
    rearrange_patches(video[:1], pt, p, out=buf[1:2])
    back = unrearrange_patches(got, pt, p, *shape[1:])
    torch.cuda.synchronize()
    assert torch.equal(buf[1], got[0]) and (buf[0] == 7).all() and (buf[2] == 7).all()
    assert torch.equal(back, video)
    counts = K.launch_counts()
    assert counts["rearrange_patches_f32"] == 2 and counts["unrearrange_patches_f32"] == 1


def test_f32_plain_routes_where_jax_takes_xla(dev):
    """K8 / K4 in f32 take their plain versions on CUDA (the JAX package
    gates them to bf16), each counted; the bf16 calls the kernels.  The f32
    PEG, XLA in JAX too, runs the stencil's f32 forms (`peg_fwd_f32`,
    `peg_bwd_f32`) and matches the plain versions."""
    from ct_clip_tpu_torch.ops.attention import (_peg_leads, _peg_taps, peg_conv, peg_dw_plain,
                                                 peg_dx_plain, peg_fwd_plain)
    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed, patch_embed_plain

    g = _gen(dev, 50)
    video = _randn((1, 20, 40, 40), g, dev, dtype=F32)
    w = (1 + _randn((4000,), g, dev, 0.1, F32), _randn((4000,), g, dev, 0.1, F32),
         _randn((64, 4000), g, dev, 4000 ** -0.5, F32), _randn((64,), g, dev, 0.1, F32),
         1 + _randn((64,), g, dev, 0.1, F32), _randn((64,), g, dev, 0.1, F32))
    K.reset_launch_counts()
    got = fused_patch_embed(video, *w, 10, 20)
    assert torch.equal(got, patch_embed_plain(video, *w, 10, 20))
    x = _randn((1, 4, 6, 8, 32), g, dev, dtype=F32).requires_grad_()
    wt = _randn((32, 1, 3, 3, 3), g, dev, 0.2, F32).requires_grad_()
    bt = _randn((32,), g, dev, 0.1, F32).requires_grad_()
    do = _randn((1, 4, 6, 8, 32), g, dev, dtype=F32)
    out = peg_conv(x, wt, bt)
    dx, dw, db = torch.autograd.grad(out, (x, wt, bt), do)
    ref = peg_dw_plain(x.detach(), do, (2, 1, 1))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["patch_embed_plain"] == 1 and counts["patch_embed"] == 0
    assert counts["peg_fwd_f32"] == 1 and counts["peg_bwd_f32"] == 1 and counts["peg_bwd"] == 1
    taps, pads = _peg_taps(wt.detach(), False, F32), _peg_leads(False, True)
    _close(out, peg_fwd_plain(x.detach(), taps, bt.detach(), pads), 1e-5)
    _close(dx, peg_dx_plain(do, taps, pads), 1e-5)
    _close(db, ref[27], 1e-4)
    _close(dw.reshape(32, 27), ref[:27].t(), 1e-4)


# ------------------------------------------------------ K1 on the tensor cores
@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("S,n", [(4, 576), (12, 64), (6, 100), (5, 40)])
def test_qk_core_forward_k1_tensor_cores(dev, dtype, S, n, bias):
    """K1's core alone (kernels.qk_attention_fwd) at CT-CLIP's 576-token
    planes, the autoencoder's 64 and ragged 100 and 40, with the CPB bias
    and without: bf16 on qknorm_attention_tc.cu within 2e-2 of max|plain|
    (the plain core at the TPU's rounding point), f32 (hi + lo) in 3xTF32 on
    qknorm_attention_tc32.cu within 1e-5; bit-identical across runs;
    counted `qk_attention_tc` / `qk_attention_tc32` at the launch."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    q, kv, _, layout = _qk_core_case(dev, S, n, bias, seed=71)
    q, kv = q.to(dtype), kv.to(dtype)
    K.reset_launch_counts()
    got = K.qk_attention_fwd(q, kv, **layout)
    counter = "qk_attention_tc" if dtype == BF else "qk_attention_tc32"
    assert K.launch_counts()[counter] == 1 and sum(K.launch_counts().values()) == 1
    again = K.qk_attention_fwd(q, kv, **layout)
    if dtype == F32:
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        got = got[0] + got[1]
    else:
        assert torch.equal(got, again)
    ref = qk_attention_core_plain(q, kv, 8, 32, n, layout["q_scale"], layout["k_scale"],
                                  layout["bias"])
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype == dtype
    _close(got, ref, REL if dtype == BF else TC32_REL)


def test_qk_core_forward_k1_f32_plain_tf32_copy_misses(dev):
    """A copy of qknorm_attention_tc32.cu built with CT_TC32_PASSES=1 (hi hi
    alone, plain TF32) misses 1e-5 in K1's merged heads."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    copy = K.copy_library("qknorm_attention_tc32.cu", CT_TC32_PASSES=1)
    q, kv, _, layout = _qk_core_case(dev, 4, 576, True, seed=72)
    q, kv = q.float(), kv.float()
    hi, lo = K.qk_attention_fwd(q, kv, lib=copy, **layout)
    ref = qk_attention_core_plain(q, kv, 8, 32, 576, layout["q_scale"], layout["k_scale"],
                                  layout["bias"])
    torch.cuda.synchronize()
    err = (hi + lo - ref).abs().max().item() / ref.abs().max().item()
    assert err > TC32_REL, err


@pytest.mark.parametrize("dtype", [BF, F32])
def test_spatial_qknorm_attention_k1_tensor_cores(dev, dtype):
    """The K1 sublayer at head dim 32 launches the tensor-core core (and in
    f32 its three products in 3xTF32 on ffn_tc32.cu): bf16 within 2e-2 of
    max|plain|, f32 within 1e-5; K2's 24- and 20-token sequences take
    qknorm_attention_short.cu (f32 again with the 3xTF32 products)."""
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_small_qknorm_attention,
        fused_spatial_qknorm_attention, grid_qknorm_attention_plain, qknorm_attention_plain)

    g = _gen(dev, 73)
    w = _attn_weights(g, dev)
    tc = "qk_attention_tc" if dtype == BF else "qk_attention_tc32"
    for b, n in ((2, 576), (6, 64), (3, 100)):
        x = _randn((b, n, 512), g, dev, dtype=dtype)
        bias = _randn((8, n, n), g, dev, dtype=F32)
        K.reset_launch_counts()
        got = fused_spatial_qknorm_attention(x, *w, bias, 8, 32)
        ref = qknorm_attention_plain(x, *w, bias, 8, 32)
        torch.cuda.synchronize()
        c = K.launch_counts()
        assert (c["spatial_attention"], c[tc], c["tc32_gemm"]) == (1, 1, 3 * (dtype == F32))
        _close(got, ref, REL if dtype == BF else TC32_REL)
    xg, xs = _randn((2, 24, 36, 512), g, dev, dtype=dtype), _randn((40, 20, 512), g, dev,
                                                                   dtype=dtype)
    K.reset_launch_counts()
    _close(fused_grid_qknorm_attention(xg, *w, 8, 32), grid_qknorm_attention_plain(xg, *w, 8, 32),
           REL if dtype == BF else F32_FWD)
    _close(fused_small_qknorm_attention(xs, *w, 8, 32),
           qknorm_attention_plain(xs, *w, None, 8, 32), REL if dtype == BF else F32_FWD)
    c = K.launch_counts()
    assert c[tc] == 0 and c["grid_attention"] == c["seq_attention"] == 1
    assert c["qk_attention_short"] == 2 and c["tc32_gemm"] == 6 * (dtype == F32)


# ------------------------------------------- K2's core on qknorm_attention_short.cu
def _k2_core_case(dev, dtype, grid, shape, seed=74):
    """K2's core inputs, 8 heads of 32: the (rows, 256) q and (rows, 512) kv
    of a (b, t, S) token grid read through its t-columns, or of (S, n)
    sequences; the layout the sublayer hands over."""
    g = _gen(dev, seed)
    heads, d = 8, 32
    hd = heads * d
    if grid:
        b, n, S = shape
        layout = dict(sequences=b * S, inner=S, q_strides=(n * S * hd, hd, d, S * hd),
                      kv_strides=(n * S * 2 * hd, 2 * hd, d, S * 2 * hd))
    else:
        S, n = shape
        layout = dict(sequences=S, inner=1, q_strides=(n * hd, 0, d, hd),
                      kv_strides=(n * 2 * hd, 0, d, 2 * hd))
    rows = layout["sequences"] * n
    q, kv = (_randn((rows, w), g, dev, dtype=dtype) for w in (hd, 2 * hd))
    layout.update(heads=heads, n=n, d=d, q_scale=(1 + 0.2 * torch.randn(d, generator=g,
                                                                         device=dev)) * 8.0,
                  k_scale=1 + 0.2 * torch.randn(d, generator=g, device=dev))
    return q, kv, layout


def _k2_core_plain(q, kv, layout, grid, shape, p_point=False):
    """qk_attention_core_plain on the sequence-major copy of q and kv, laid
    back out as q; with `p_point`, attention_plain on the same normalised
    heads instead (the normalised p rounded: attention.cu's rounding point)."""
    from ct_clip_tpu_torch.ops.attention import attention_plain
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    n, heads, d = layout["n"], 8, 32
    qs, ks = layout["q_scale"], layout["k_scale"]
    b, S = (shape[0], shape[2]) if grid else (1, layout["sequences"])

    def seqs(t):
        return t.view(b, n, S, -1).transpose(1, 2).reshape(b * S * n, -1) if grid else t
    qq, kk = seqs(q), seqs(kv)
    if p_point:
        def heads_of(t, sc=None):
            t = t.float().view(b * S, n, heads, d)
            return (t if sc is None else (l2norm(t) * sc).to(q.dtype)).transpose(1, 2)
        out = attention_plain(heads_of(qq, qs), heads_of(kk[:, :heads * d], ks),
                              heads_of(kk[:, heads * d:]).to(q.dtype))
        out = out.transpose(1, 2).reshape(b * S * n, -1)
    else:
        out = qk_attention_core_plain(qq, kk, heads, d, n, qs, ks, None)
    return out.view(b, S, n, -1).transpose(1, 2).reshape(b * n * S, -1) if grid else out


# K2's bf16 core: mean|err| against the plain core at the TPU's rounding
# points, as a share of mean|plain| (chip_smoke.py's K2_POINT_TOL)
K2_POINT = 2e-4


def _mean_rel(got, ref):
    return ((got.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()


K2_CORE_SHAPES = [(True, (2, 24, 36)), (True, (1, 16, 24)), (False, (40, 20)), (False, (33, 31)),
                  (False, (72, 16))]


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("grid,shape", K2_CORE_SHAPES)
def test_qk_core_forward_k2_short(dev, dtype, grid, shape):
    """K2's core alone (kernels.qk_attention_short) on a grid's t-columns
    read in place (t 24, 16) and on sequence-major sequences (n 20, 31, 16):
    bf16 within 2e-2 of max|plain| (the plain core at the TPU's rounding
    points) and its mean error within K2_POINT of mean|plain|, which the
    normalised p rounded (attention.cu's point) on the same heads misses;
    f32 (hi + lo) within 1e-5; bit-identical across runs; counted
    `qk_attention_short` at the launch."""
    q, kv, layout = _k2_core_case(dev, dtype, grid, shape)
    K.reset_launch_counts()
    got = K.qk_attention_short(q, kv, **layout)
    c = K.launch_counts()
    assert c["qk_attention_short"] == 1 and c["qk_attention_short_f32"] == int(dtype == F32)
    again = K.qk_attention_short(q, kv, **layout)
    if dtype == F32:
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        got = got[0] + got[1]
    else:
        assert torch.equal(got, again)
    ref = _k2_core_plain(q, kv, layout, grid, shape)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == q.shape and got.dtype == ref.dtype == dtype
    _close(got, ref, REL if dtype == BF else TC32_REL)
    if dtype == BF:
        assert _mean_rel(got, ref) <= K2_POINT
        assert _mean_rel(_k2_core_plain(q, kv, layout, grid, shape, p_point=True), ref) > K2_POINT


@pytest.mark.parametrize("dtype", [BF, F32])
def test_k2_sublayer_takes_the_short_core(dev, dtype):
    """K2 grid (t 24, 16) and seq (t 20, 16) at head dim 32: the short core
    once a call; bf16 with its three products on ffn_tc.cu (`qk_proj_tc`),
    f32 in 3xTF32 on ffn_tc32.cu (`tc32_gemm`); bf16 within 2e-2 of
    max|plain|, f32 within 1e-5; nothing on attention.cu."""
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_small_qknorm_attention, grid_qknorm_attention_plain,
        qknorm_attention_plain)

    g = _gen(dev, 75)
    w = _attn_weights(g, dev)
    tol = REL if dtype == BF else TC32_REL
    for shape in ((2, 24, 36, 512), (1, 16, 24, 512), (40, 20, 512), (72, 16, 512)):
        x = _randn(shape, g, dev, dtype=dtype)
        grid = len(shape) == 4
        K.reset_launch_counts()
        if grid:
            got, ref = (fused_grid_qknorm_attention(x, *w, 8, 32),
                        grid_qknorm_attention_plain(x, *w, 8, 32))
        else:
            got, ref = (fused_small_qknorm_attention(x, *w, 8, 32),
                        qknorm_attention_plain(x, *w, None, 8, 32))
        torch.cuda.synchronize()
        c = K.launch_counts()
        assert c["grid_attention" if grid else "seq_attention"] == 1
        assert c["qk_attention_short"] == 1 and c["qk_attention_cuda_cores"] == 0
        assert (c["qk_proj_tc"], c["tc32_gemm"]) == ((3, 0) if dtype == BF else (0, 3))
        _close(got, ref, tol)


def test_qk_projection_nt_forms(dev):
    """ffn_tc.cu's NT store form (q, kv) and residual form (the output
    product) at the sublayer's widths on ragged rows: within one bf16
    rounding of the f32 products."""
    g = _gen(dev, 76)
    rows = 1000
    x = _randn((rows, 512), g, dev)
    for n_out in (256, 512):
        w = _randn((n_out, 512), g, dev, 512 ** -0.5)
        ref = (x.float() @ w.float().t()).to(BF)
        _close(K.gemm_nt_tc(x, w), ref, 1e-2)
    merged, wo = _randn((rows, 256), g, dev), _randn((512, 256), g, dev, 256 ** -0.5)
    ref = (merged.float() @ wo.float().t() + x.float()).to(BF)
    _close(K.gemm_residual_tc(merged, wo, x), ref, 1e-2)


# ---- the f32 backwards in 3xTF32 (ffn_tc32.cu) and K10's short core
@pytest.mark.parametrize("rows,seq", [(130, (1, 1)), (1000, (1, 1)), (2 * 24 * 36, (24, 36))])
def test_tc32_split_t_planes_and_t_column_order(dev, rows, seq):
    """tc32_split_t: hi + lo is x exactly, row-major and transposed, the
    transposed columns in the t-column order of a (b, n, S) grid; with a
    second input (a split's lo plane) the same planes."""
    g = _gen(dev, 81)
    x = _randn((rows, 96), g, dev, dtype=F32)
    hi, lo, hi_t, lo_t = K.tc32_split_t(x, rows=True, seq=seq)
    n, S = seq
    c = torch.arange(rows, device=dev)
    order = ((c // n // S) * n + c % n) * S + c // n % S
    torch.cuda.synchronize()
    assert torch.equal(hi + lo, x) and torch.equal((hi_t + lo_t).t(), x[order])
    assert torch.equal((hi.view(torch.int32) & 0x1FFF), torch.zeros_like(hi, dtype=torch.int32))
    again = K.tc32_split_t(hi, lo, seq=seq)
    assert torch.equal(again[0], hi_t) and torch.equal(again[1], lo_t)


@pytest.mark.parametrize("rows,M,N", [(1000, 344, 96), (9000, 96, 176), (300, 64, 64)])
def test_tc32_gemm_tn_over_rows(dev, rows, M, N):
    """The TN form: A^T W over all rows in row splits added in order, within
    F32_FWD of the f64 product; its plain-TF32 copy misses."""
    g = _gen(dev, 82)
    a, w = _randn((rows, M), g, dev, dtype=F32), _randn((rows, N), g, dev, dtype=F32)
    ref = (a.double().t() @ w.double()).float()
    K.reset_launch_counts()
    got = K.tc32_gemm_tn(*K.tc32_split_t(a), *K.tc32_split_t(w))
    torch.cuda.synchronize()
    assert K.launch_counts()["tc32_gemm_tn"] == 1
    _close(got, ref, rel=F32_FWD)
    copy = K.copy_library("ffn_tc32.cu", CT_TC32_PASSES=1)
    tf32 = K.tc32_gemm_tn(*K.tc32_split_t(a, lib=copy), *K.tc32_split_t(w, lib=copy), lib=copy)
    with pytest.raises(AssertionError):
        _close(tf32, ref, rel=F32_FWD)


@pytest.mark.parametrize("rows", [130, 2048])
def test_k11_f32_tc32_tile_and_products(dev, rows):
    """K11 f32 launches the 3xTF32 tile, one NN and two TN products (counted
    ff_tc32_tile, tc32_gemm, tc32_gemm_tn); the plain-TF32 copy and the
    copy with act rounded to bf16 (CT_FF_TC32_ACT_BF16) each miss the f32
    limits (dwo reads act)."""
    from ct_clip_tpu_torch.ops.ffn import _geglu_ff_bwd_cuda, _geglu_ff_bwd_tc32, geglu_ff_bwd_plain

    args, do = _ff_f32_inputs(dev, rows, 83)
    K.reset_launch_counts()
    got = _geglu_ff_bwd_cuda(*args, do, 1e-5)
    ref = geglu_ff_bwd_plain(*args, do)
    torch.cuda.synchronize()
    c = K.launch_counts()
    assert (c["ff_tc32_tile"], c["tc32_gemm"], c["tc32_gemm_tn"]) == (1, 1, 2)
    _close(got[0], ref[0], rel=F32_FWD)
    for gr, r in zip(got[1:], ref[1:]):
        _close(gr, r, rel=F32_WGRAD)
    for define in ("CT_TC32_PASSES", "CT_FF_TC32_ACT_BF16"):
        copy = K.copy_library("ffn_tc32.cu", **{define: 1})
        bad = _geglu_ff_bwd_tc32(*args, do, 1e-5, lib=copy)
        rels = [((b - r).abs().max() / r.abs().max()).item() for b, r in zip(bad, ref)]
        assert rels[4] > F32_WGRAD, (define, rels)


@pytest.mark.parametrize("layout,B,n,S,heads", [("grid", 2, 24, 36, 8), ("seq", 40, 16, 1, 8),
                                                ("seq", 40, 20, 1, 6), ("seq", 9, 31, 1, 8)])
def test_qk_short_bwd_core_f32(dev, layout, B, n, S, heads):
    """K10's f32 core on qknorm_attention_short.cu (grid t-columns in place
    and sequences; six heads: a partial group of four) against the plain
    version of its math in f32: merged, dq, dkv (hi + lo of its planes)
    within F32_FWD, dq_scale and dk_scale within F32_WGRAD; two runs equal."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain

    g = _gen(dev, 84)
    d, hd, rows = 32, heads * 32, B * n * S
    q, kv, dm = (_randn((rows, wd), g, dev, dtype=F32) for wd in (hd, 2 * hd, hd))
    qs, ks = (1 + 0.2 * torch.randn(d, generator=g, device=dev)) * 8.0, \
        1 + 0.2 * torch.randn(d, generator=g, device=dev)
    layout = dict(sequences=B * S, inner=S, heads=heads, n=n, d=d,
                  q_strides=(n * S * hd, hd, d, S * hd),
                  kv_strides=(n * S * 2 * hd, 2 * hd, d, S * 2 * hd), q_scale=qs, k_scale=ks)
    c = torch.arange(rows, device=dev)
    order = ((c // n // S) * n + c % n) * S + c // n % S
    K.reset_launch_counts()
    out = K.qk_attention_short_bwd(q, kv, dm, **layout)
    ref = qk_attention_bwd_core_plain(q[order], kv[order], dm[order], heads, d, n, qs, ks, None)
    torch.cuda.synchronize()
    assert K.launch_counts()["qk_attention_short_bwd_f32"] == 1
    _close((out[4] + out[5]).t(), ref[0], rel=F32_FWD)
    _close((out[0] + out[1])[order], ref[1], rel=F32_FWD)
    _close((out[2] + out[3])[order], ref[2], rel=F32_FWD)
    _close((out[6] + out[7]).t(), ref[1], rel=F32_FWD)
    _close((out[8] + out[9]).t(), ref[2], rel=F32_FWD)
    _close(out[10], ref[3], rel=F32_WGRAD)
    _close(out[11], ref[4], rel=F32_WGRAD)
    again = K.qk_attention_short_bwd(q, kv, dm, **layout)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("D", [128, 384, 512, 640])
def test_layernorm_f32_rows_forms(dev, D):
    """The f32 LN split and backward on rows of 128-512 floats (the
    warp-a-row forms; 640 keeps the block-per-row kernels): the split's hi +
    lo within F32_FWD of the plain LN, hi a TF32 value; dx with both added
    terms within F32_FWD, the column sums (dscale, dbias, the f32 dx) within
    F32_WGRAD; two runs equal."""
    from ct_clip_tpu_torch.ops.autograd import vjp
    from ct_clip_tpu_torch.ops.norms import layer_norm

    g = _gen(dev, 85)
    x = _randn((1001, D), g, dev, 3.0, F32) + 1.0
    scale, bias = 1 + _randn((D,), g, dev, 0.1, F32), _randn((D,), g, dev, 0.1, F32)
    hi, lo = K.layernorm_split(x, scale, bias, 1e-5)
    torch.cuda.synchronize()
    _close(hi + lo, layer_norm(x, scale, bias), rel=F32_FWD)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    dxn, add, add2 = (_randn((1001, D), g, dev, dtype=F32) for _ in range(3))
    out = K.layernorm_bwd(x, scale, dxn, 1e-5, add=add, add2=add2, want_dbias=True,
                          want_dxsum=True)
    rdx, rds, rdb = vjp(lambda a, s, b: layer_norm(a, s, b), (x, scale, bias), dxn)
    torch.cuda.synchronize()
    ref_dx = rdx + add + add2
    _close(out[0], ref_dx, rel=F32_FWD)
    for got, ref in zip(out[1:], (rds, rdb, ref_dx.sum(0))):
        _close(got, ref, rel=F32_WGRAD)
    again = K.layernorm_bwd(x, scale, dxn, 1e-5, add=add, add2=add2, want_dbias=True,
                            want_dxsum=True)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def _mean_rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()


@pytest.mark.parametrize("layout,B,n,S,heads", [("grid", 2, 24, 36, 8), ("seq", 40, 16, 1, 8),
                                                ("seq", 40, 20, 1, 6), ("seq", 9, 31, 1, 8)])
def test_qk_short_bwd_core_bf16(dev, layout, B, n, S, heads):
    """K10 bf16's core (the short core's bf16 form) against the plain version
    at the TPU kernel's rounding points: merged, dq and dkv within REL of
    max|plain| and 2e-4 of mean|plain|, the scale sums within F32_WGRAD; the
    copy rounding P to bf16 misses the mean; two runs equal."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_short_bwd_core_plain

    g = _gen(dev, 86)
    d, hd, rows = 32, heads * 32, B * n * S
    q, kv, dm = (_randn((rows, wd), g, dev, dtype=F32) for wd in (hd, 2 * hd, hd))
    qs, ks = (1 + 0.2 * torch.randn(d, generator=g, device=dev)) * 8.0, \
        1 + 0.2 * torch.randn(d, generator=g, device=dev)
    layout = dict(sequences=B * S, inner=S, heads=heads, n=n, d=d,
                  q_strides=(n * S * hd, hd, d, S * hd),
                  kv_strides=(n * S * 2 * hd, 2 * hd, d, S * 2 * hd), q_scale=qs, k_scale=ks,
                  out_dtype=BF)
    c = torch.arange(rows, device=dev)
    order = ((c // n // S) * n + c % n) * S + c // n % S
    K.reset_launch_counts()
    out = K.qk_attention_short_bwd(q, kv, dm, **layout)
    ref = qk_short_bwd_core_plain(q[order], kv[order], dm[order], heads, d, n, qs, ks)
    torch.cuda.synchronize()
    assert K.launch_counts()["qk_attention_short_bwd"] == 1
    assert [t.dtype for t in out[:3]] == [BF] * 3
    for got, r in zip(out[:3], ref[:3]):
        _close(got[order], r)
        assert _mean_rel(got[order], r) <= 2e-4
    _close(out[3], ref[3], rel=F32_WGRAD)
    _close(out[4], ref[4], rel=F32_WGRAD)
    again = K.qk_attention_short_bwd(q, kv, dm, **layout)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    copy = K.copy_library("qknorm_attention_short.cu", CT_QK_SHORT_BWD_ROUND_P=1)
    bad = K.qk_attention_short_bwd(q, kv, dm, lib=copy, **layout)
    assert _mean_rel(bad[0][order], ref[0]) > 2e-4


@pytest.mark.parametrize("dtype,rows,dim,codes", [(BF, 10240, 512, 8192), (F32, 10240, 512, 8192),
                                                  (BF, 1001, 64, 1000), (F32, 777, 128, 500)])
def test_k5_exact_wgmma(dev, dtype, rows, dim, codes):
    """K5's exact assignment on vq_tc.cu (bf16 rows, and f32 rows after the
    splitting pre-pass, ragged rows and codes) against the plain version of
    its math: ids equal but for ties within 1e-5 of the row's largest
    |sim|; the pre-pass's xh and xl equal `_split_rows` with the lane norm
    bit for bit."""
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import (_lane_inv_norm, _split_rows, split_hi_lo,
                                          vq_exact_rows_lane_sim)

    g = _gen(dev, 87)
    x = torch.randn((rows, dim), generator=g, device=dev).to(dtype)
    embed_n = l2norm(torch.randn((codes, dim), generator=g, device=dev))
    hi, lo = split_hi_lo(embed_n)
    K.reset_launch_counts()
    got = K.vq_assign_exact_tc(x, hi, lo).long()
    if dtype == BF:
        sim = x.float() @ hi.float().t() + x.float() @ lo.float().t()
    else:
        sim = vq_exact_rows_lane_sim(x, embed_n)
        xh, xl = (torch.empty((rows, dim), dtype=BF, device=dev) for _ in range(2))
        K._check(K.library().ct_vq_rows_bf16(K._ptr(x), rows, dim, K._ptr(xh), K._ptr(xl),
                                             K._stream()), "ct_vq_rows_bf16")
        ph, pl = _split_rows(x, _lane_inv_norm)
        assert torch.equal(xh.float(), ph) and torch.equal(xl.float(), pl)
    torch.cuda.synchronize()
    assert K.launch_counts()["vq_assign_exact_tc"] == 1
    ref = sim.argmax(dim=-1)
    gap = (sim.gather(1, ref[:, None]) - sim.gather(1, got[:, None]))[:, 0].abs()
    assert (gap <= 1e-5 * sim.abs().max(dim=1).values).all()
    assert (got == ref).float().mean().item() >= 0.999


@pytest.mark.parametrize("D", [128, 512, 640])
def test_layernorm_bf16_rows_backward(dev, D):
    """The bf16 LN backward on rows of 128-512 (the warp-a-row form; 640
    keeps the block-per-row kernel): dx within REL of the plain f32 backward
    rounded once, the column sums within F32_WGRAD; two runs equal."""
    from ct_clip_tpu_torch.ops.autograd import vjp
    from ct_clip_tpu_torch.ops.norms import layer_norm

    g = _gen(dev, 88)
    x = _randn((1001, D), g, dev, 3.0) + 1.0
    scale = 1 + _randn((D,), g, dev, 0.1, F32)
    dxn, add = (_randn((1001, D), g, dev, dtype=F32) for _ in range(2))
    add2 = _randn((1001, D), g, dev)
    out = K.layernorm_bwd(x, scale, dxn, 1e-5, add=add, add2=add2, want_dbias=True,
                          want_dxsum=True)
    rdx, rds = vjp(lambda a, s: layer_norm(a, s, None), (x.float(), scale), dxn)
    torch.cuda.synchronize()
    ref_dx = rdx + add + add2.float()
    assert out[0].dtype == BF
    _close(out[0], ref_dx)
    for got, ref in zip(out[1:], (rds, dxn.sum(0), ref_dx.sum(0))):
        _close(got, ref, rel=F32_WGRAD)
    again = K.layernorm_bwd(x, scale, dxn, 1e-5, add=add, add2=add2, want_dbias=True,
                            want_dxsum=True)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


# K4 / K8 bf16 on embed_tc.cu: mean|err| <= EMBED_MEAN_TOL * mean|plain|.  The
# kernel rounds where the plain version does (xn, y, yb, out) and sums in
# another order, which flips a rounding in few elements; the single rounding
# of y + pbias (the planted copy) reads ~1.6e-3 there (CPU, 2,000 x 4,000 ->
# 512), within the max limit REL.
EMBED_MEAN_TOL = 2e-4
# kind, leading shape (rows: (b, n); volume: (b, F, H, W)), pt, p, dim: the
# zero-shot batch at full width, ragged row counts, the tiny configs' 1,024 -> 64
EMBED_CASES = [("rows", (2, 13824), 10, 20, 512), ("rows", (2, 300), 10, 20, 512),
               ("volume", (2, 240, 480, 480), 10, 20, 512), ("volume", (2, 20, 60, 40), 10, 20, 512),
               ("rows", (3, 37), 4, 16, 64), ("volume", (1, 12, 48, 48), 4, 16, 64)]


def _mean_rel(got, ref):
    return ((got.float() - ref.float()).abs().mean() / ref.float().abs().mean()).item()


def _embed_inputs(dev, kind, shape, pt, p, dim, seed=90):
    g = _gen(dev, seed)
    pd = pt * p * p
    x = _randn((*shape, pd) if kind == "rows" else shape, g, dev)
    if kind == "volume":
        x = (x.float().clamp(-3, 3) / 3).to(BF)
    w = (1 + _randn((pd,), g, dev, 0.1, F32), _randn((pd,), g, dev, 0.1, F32),
         _randn((dim, pd), g, dev, pd ** -0.5, F32), _randn((dim,), g, dev, 0.1, F32),
         1 + _randn((dim,), g, dev, 0.1, F32), _randn((dim,), g, dev, 0.1, F32))
    return x, w


def _embed_calls(kind, x, w, pt, p):
    from ct_clip_tpu_torch.ops.patch_embed import (fused_patch_embed, fused_row_embed,
                                                   patch_embed_plain, row_embed_plain)
    if kind == "rows":
        return (lambda: fused_row_embed(x, *w)), (lambda: row_embed_plain(x, *w)), \
            (lambda lib: K.embed_tc(x.view(-1, x.shape[-1]), *w, 1e-5, lib=lib))
    return (lambda: fused_patch_embed(x, *w, pt, p)), \
        (lambda: patch_embed_plain(x, *w, pt, p)), \
        (lambda lib: K.embed_tc(x, *w, 1e-5, geom=(pt, p), lib=lib))


@pytest.mark.parametrize("kind,shape,pt,p,dim", EMBED_CASES)
def test_embed_tc_k4_k8(dev, kind, shape, pt, p, dim):
    """K4 / K8 on embed_tc.cu against the plain version: REL of max and
    EMBED_MEAN_TOL of mean; one launch counted; a second run equal bit for
    bit."""
    x, w = _embed_inputs(dev, kind, shape, pt, p, dim)
    kern, plain, _ = _embed_calls(kind, x, w, pt, p)
    K.reset_launch_counts()
    got = kern()
    counts = K.launch_counts()
    ref = plain()
    torch.cuda.synchronize()
    assert counts["embed_tc"] == 1
    assert counts["row_embed" if kind == "rows" else "patch_embed"] == 1
    assert got.dtype == BF and got.shape == ref.shape
    _close(got, ref)
    assert _mean_rel(got, ref) <= EMBED_MEAN_TOL
    assert torch.equal(kern(), got)


@pytest.mark.parametrize("kind", ["rows", "volume"])
def test_embed_tc_one_rounding_copy_misses_the_mean(dev, kind):
    """The copy adding pbias to the f32 y before one rounding
    (CT_EMBED_TC_ONE_ROUNDING) must read outside EMBED_MEAN_TOL."""
    shape = (2, 300) if kind == "rows" else (2, 20, 60, 40)
    x, w = _embed_inputs(dev, kind, shape, 10, 20, 512, seed=91)
    _, plain, on_lib = _embed_calls(kind, x, w, 10, 20)
    got = on_lib(K.copy_library("embed_tc.cu", CT_EMBED_TC_ONE_ROUNDING=1))
    ref = plain().view(got.shape)
    torch.cuda.synchronize()
    assert _mean_rel(got, ref) > EMBED_MEAN_TOL


def test_embed_misfit_widths_raise(dev):
    """Widths embed_tc.cu does not take raise, with no launch counted: K8
    with p = 6 (its 8-byte gathers need p % 4 == 0), K4 with patch_dim 50
    (TMA rows need multiples of 8), through the embeds and `kernels.embed_tc`."""
    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed, fused_row_embed

    g = _gen(dev, 93)
    video = _randn((1, 4, 24, 24), g, dev)
    w6 = (1 + _randn((72,), g, dev, 0.1, F32), _randn((72,), g, dev, 0.1, F32),
          _randn((64, 72), g, dev, 0.1, F32), _randn((64,), g, dev, 0.1, F32),
          1 + _randn((64,), g, dev, 0.1, F32), _randn((64,), g, dev, 0.1, F32))
    rows = _randn((1, 30, 50), g, dev)
    w5 = (1 + _randn((50,), g, dev, 0.1, F32), _randn((50,), g, dev, 0.1, F32),
          _randn((64, 50), g, dev, 0.1, F32), *w6[3:])
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="embed_fits"):
        fused_patch_embed(video, *w6, 2, 6)
    with pytest.raises(ValueError, match="embed_fits"):
        fused_row_embed(rows, *w5)
    with pytest.raises(ValueError, match="embed_fits"):
        K.embed_tc(video, *w6, 1e-5, geom=(2, 6))
    with pytest.raises(ValueError, match="embed_fits"):
        K.embed_tc(rows.view(30, 50), *w5, 1e-5)
    counts = K.launch_counts()
    assert counts["embed_tc"] == counts["patch_embed"] == counts["row_embed"] == 0
