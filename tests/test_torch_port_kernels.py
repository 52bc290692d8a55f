"""Hand-written CUDA kernels of ct_clip_tpu_torch against their plain PyTorch
versions, on the card: the inference kernels in bf16, the training attention
kernels (K7 f32, K12, K13) in f32, K7's dense-bias form and K12b in f32 and
bf16, the bf16 K7 / K12b / K12a / K13a / K13b of attention_tc.cu (wgmma) with
their routing (`-k "tc or dense"`), the f32 K7 (key bias, dense, no
bias), K13a, K12a, K12b (dense, no bias) and K13b of attention_tc32.cu
(3xTF32, `-k tc32`), K9's bf16 core on the tensor cores
(qknorm_attention_tc.cu, `-k qk_core`) and its f32 core in 3xTF32
(qknorm_attention_tc32.cu, `-k "qk_core and f32"`), K11 bf16 on `wgmma`
(ffn_tc.cu, `-k "k11 or ff_tc"`), with K17 f32's run copy (`-k k17`).

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


@pytest.mark.parametrize("input_grad", [False, True])
def test_patch_embed_backward_k16a(dev, input_grad):
    """K16a's six weight gradients (f32) and, when the volume requires grad,
    d(volume) through K17, against autograd of the plain forward."""
    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed, patch_embed_bwd_plain

    g = _gen(dev, 18)
    video = _randn((2, 20, 60, 40), g, dev)
    w = _embed_weights(g, dev)
    do = _randn((2, 12, 512), g, dev)
    leaves = [video.detach().requires_grad_(input_grad)] + [t.detach().requires_grad_()
                                                            for t in w]
    K.reset_launch_counts()
    out = fused_patch_embed(*leaves, 10, 20)
    got = torch.autograd.grad(out, leaves if input_grad else leaves[1:], do)
    counts = K.launch_counts()
    assert counts["patch_embed_bwd"] == 1 and counts["unrearrange_patches"] == int(input_grad)
    assert all(gr.dtype == torch.float32 for gr in got[-6:])
    ref = patch_embed_bwd_plain(video, *w, do, 10, 20)
    _grads_close(got, ref if input_grad else ref[1:])
    again = torch.autograd.grad(fused_patch_embed(*leaves, 10, 20), leaves[1:], do)
    assert all(torch.equal(a, c) for a, c in zip(got[-6:], again))  # fixed-order sums


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


@pytest.mark.parametrize("rows", [300, 2048])
def test_geglu_ff_f32_k3_and_k11(dev, rows):
    from ct_clip_tpu_torch.ops.ffn import (fused_geglu_ff, geglu_ff_bwd_plain,
                                           geglu_ff_plain)

    args, do = _ff_f32_inputs(dev, rows, 43)
    K.reset_launch_counts()
    _close(fused_geglu_ff(*args), geglu_ff_plain(*args), rel=F32_FWD)
    leaves = [t.detach().clone().requires_grad_() for t in args]
    got = torch.autograd.grad(fused_geglu_ff(*leaves), leaves, do)
    ref = geglu_ff_bwd_plain(*args, do)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["geglu_ff_f32"] == 2 and counts["geglu_ff_bwd_f32"] == 1
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
    from ct_clip_tpu_torch.ops.vq import CosineVQ, vq_assign, vq_assign_rows_plain

    g = _gen(dev, 48)
    x = _randn((2048, 512), g, dev, dtype=F32)
    embed_n = l2norm(torch.randn((8192, 512), generator=g, device=dev))
    K.reset_launch_counts()
    got = vq_assign(x, embed_n).long()
    ref = vq_assign_rows_plain(x, embed_n).long()
    torch.cuda.synchronize()
    assert K.launch_counts()["vq_assign_f32"] == 1
    assert (got == ref).float().mean().item() >= 0.999
    # any disagreement is a tie of the kernel's own math up to f32 order
    xn = (x * torch.rsqrt((x * x).sum(-1, keepdim=True))).to(BF).float()
    sim = xn @ embed_n.to(BF).float().t()
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
    """K8 / K4 and K14 in f32 take their plain versions on CUDA (the JAX
    package gates them to bf16), each counted; the bf16 calls the kernels."""
    from ct_clip_tpu_torch.ops.attention import peg_conv, peg_dw_plain
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
    dw, db = torch.autograd.grad(peg_conv(x, wt, bt), (wt, bt), do)
    ref = peg_dw_plain(x.detach(), do, (2, 1, 1))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["patch_embed_plain"] == 1 and counts["patch_embed"] == 0
    assert counts["peg_dw_plain"] == 1 and counts["peg_bwd"] == 0
    assert torch.equal(db, ref[27])
    assert torch.equal(dw.reshape(32, 27), ref[:27].t())
