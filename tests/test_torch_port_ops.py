"""ct_clip_tpu_torch ops against the JAX package, per module that holds a
kernel, in f32 on the CPU.

On the CPU the port takes its plain versions and the JAX `fused_*` functions
take their XLA twins, so each test feeds the same numpy-seeded inputs to the
port and to the twin the TPU kernel is held against.  Tolerance: normwise
relative, max|port - jax| <= 1e-5 * max|jax| (f32 sums in different orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

RTOL = 1e-5


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"max abs err {err:.3e}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _weights(rng, dim, heads, dh):
    hd = heads * dh
    return dict(
        gamma=1 + 0.1 * rng.randn(dim), wq=rng.randn(dim, hd) / np.sqrt(dim),
        wkv=rng.randn(dim, 2 * hd) / np.sqrt(dim),
        q_scale=1 + 0.3 * rng.rand(dh), k_scale=1 + 0.3 * rng.rand(dh),
        wout=rng.randn(hd, dim) / np.sqrt(hd))


def _port_args(w):
    """JAX (in, out) kernels -> nn.Linear (out, in) weights."""
    return (_t(w["gamma"]), _t(w["wq"].T), _t(w["wkv"].T), _t(w["q_scale"]),
            _t(w["k_scale"]), _t(w["wout"].T))


def _jax_args(w):
    return tuple(jnp.asarray(w[k], jnp.float32)
                 for k in ("gamma", "wq", "wkv", "q_scale", "k_scale", "wout"))


def test_patch_embed_matches_xla_twin():
    from ct_clip_tpu.ops.pallas.patchify import _xla_patch_embed
    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed

    rng = np.random.RandomState(0)
    pt, p, dim = 2, 4, 24
    pd = pt * p * p
    video = rng.randn(2, 6, 12, 8).astype(np.float32)
    s1, b1 = 1 + 0.1 * rng.randn(pd), 0.1 * rng.randn(pd)
    wi, pb = rng.randn(pd, dim) / np.sqrt(pd), 0.1 * rng.randn(dim)
    s2, b2 = 1 + 0.1 * rng.randn(dim), 0.1 * rng.randn(dim)
    ref = _xla_patch_embed(jnp.asarray(video), *(jnp.asarray(a, jnp.float32) for a in
                                                 (s1, b1, wi, pb, s2, b2)),
                           pt, p, 1e-5, jnp.float32)
    got = fused_patch_embed(_t(video), _t(s1), _t(b1), _t(wi.T), _t(pb),
                            _t(s2), _t(b2), pt, p)
    _close(got, ref)


def test_geglu_ff_matches_xla_twin():
    from ct_clip_tpu.ops.pallas.ffn import _xla_ff
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff

    rng = np.random.RandomState(1)
    dim, inner = 32, 85  # int(4 * 2/3 * 32)
    x = rng.randn(40, dim).astype(np.float32)
    scale, bias = 1 + 0.1 * rng.randn(dim), 0.1 * rng.randn(dim)
    wi = rng.randn(dim, 2 * inner) / np.sqrt(dim)
    wo = rng.randn(inner, dim) / np.sqrt(inner)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = _xla_ff(f(x), f(scale), f(bias), f(wi[:, :inner]), f(wi[:, inner:]),
                  f(wo), 1e-5, True)
    got = fused_geglu_ff(_t(x), _t(scale), _t(bias), _t(wi.T), _t(wo.T))
    _close(got, ref)


def test_spatial_qknorm_attention_matches_xla_twin():
    from ct_clip_tpu.ops.pallas.spatial_attention import _xla_spatial_qknorm
    from ct_clip_tpu_torch.ops.qknorm_attention import \
        fused_spatial_qknorm_attention

    rng = np.random.RandomState(2)
    dim, heads, dh, n = 32, 2, 16, 36
    x = rng.randn(3, n, dim).astype(np.float32)
    w = _weights(rng, dim, heads, dh)
    bias = rng.randn(heads, n, n).astype(np.float32)
    ref = _xla_spatial_qknorm(jnp.asarray(x), *_jax_args(w), jnp.asarray(bias),
                              heads=heads, dim_head=dh, scale=8.0,
                              dtype=jnp.float32, residual=True)
    got = fused_spatial_qknorm_attention(_t(x), *_port_args(w), _t(bias),
                                         heads, dh, 8.0)
    _close(got, ref)


def test_grid_qknorm_attention_matches_xla_twin():
    from ct_clip_tpu.ops.pallas.small_attention import _xla_grid_qknorm
    from ct_clip_tpu_torch.ops.qknorm_attention import \
        fused_grid_qknorm_attention

    rng = np.random.RandomState(3)
    dim, heads, dh = 32, 2, 16
    x = rng.randn(2, 5, 9, dim).astype(np.float32)  # (b, t, S, d)
    w = _weights(rng, dim, heads, dh)
    ref = _xla_grid_qknorm(jnp.asarray(x), *_jax_args(w), heads=heads,
                           dim_head=dh, scale=8.0, dtype=jnp.float32,
                           residual=True)
    got = fused_grid_qknorm_attention(_t(x), *_port_args(w), heads, dh, 8.0)
    _close(got, ref)


@pytest.mark.parametrize("mode", ["key_bias", "head_bias", "none"])
def test_fused_attention_matches_xla_twin(mode):
    from ct_clip_tpu.ops.pallas.attention import _xla_attention
    from ct_clip_tpu_torch.ops.attention import fused_attention

    rng = np.random.RandomState(4)
    b, h, n, d = 3, 2, 20, 8
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(3))
    bias = key_bias = None
    if mode == "key_bias":
        mask = np.ones((b, n), np.float32)
        mask[1, 12:] = 0
        key_bias = (1 - mask) * np.finfo(np.float32).min
    elif mode == "head_bias":
        bias = rng.randn(1, h, n, n).astype(np.float32)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    p = lambda a: None if a is None else _t(a)  # noqa: E731
    ref = _xla_attention(j(q), j(k), j(v), j(bias), j(key_bias))
    got = fused_attention(_t(q), _t(k), _t(v), p(bias), p(key_bias))
    _close(got, ref)


def test_vq_ids_match_exact_cosine_vq():
    from ct_clip_tpu.ops.vq import CosineVQ as JaxVQ
    from ct_clip_tpu_torch.ops.vq import CosineVQ

    rng = np.random.RandomState(5)
    dim, codes = 16, 64
    embed = rng.randn(codes, dim).astype(np.float32)
    truth = rng.randint(0, codes, 300)
    # tokens near a scaled code: a clear top-1 margin, no near-ties
    x = (embed[truth] * (0.5 + rng.rand(300, 1))
         + 0.05 * rng.randn(300, dim)).astype(np.float32)
    jvq = JaxVQ(dim=dim, codebook_size=codes, exact_sim=True)
    state = {"vq": {"embed": jnp.asarray(embed),
                    "cluster_size": jnp.zeros(codes)}}
    jq, jids, _ = jvq.apply(state, jnp.asarray(x))

    vq = CosineVQ(dim, codes)
    vq._codebook.embed.copy_(_t(embed))
    with torch.no_grad():
        q, ids = vq(_t(x))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ids.numpy(), truth)
    _close(q, jq)


def test_preprocess_volume_matches_exact_f32_chain():
    from ct_clip_tpu.ops.resample import preprocess_volume as jax_pre
    from ct_clip_tpu_torch.config import PreprocessConfig
    from ct_clip_tpu_torch.ops.resample import preprocess_volume

    rng = np.random.RandomState(6)
    vol = rng.randint(-1200, 1500, (20, 40, 36)).astype(np.int16)  # (Z, Y, X)
    true = np.array([17, 33, 38], np.int32)  # semantic (z, x, y)
    spacing = np.array([3.0, 0.9, 0.9], np.float32)
    for clip_before in (False, True):
        ref = jax_pre(jnp.asarray(vol), jnp.asarray(spacing), jnp.float32(1.0),
                      jnp.float32(-24.0), true_sizes=jnp.asarray(true),
                      clip_before_resample=clip_before, target_shape=(24, 40, 48),
                      input_layout="zyx", compute_dtype=jnp.float32)
        cfg = PreprocessConfig(target_shape=(24, 40, 48),
                               clip_before_resample=clip_before)
        got = preprocess_volume(torch.from_numpy(vol), spacing, 1.0, -24.0,
                                true_sizes=true, input_layout="zyx", config=cfg)
        _close(got, ref)


# ------------------------------------------ training attention (K7, K12, K13)
def _kbias_args(b=2, h=2, n=128, d=16, seed=5):
    """f32 q, k, v, do and a key bias masking ~20% of the keys with -1e9, as
    tests/test_pallas_interpret.py sets up the key-bias kernels."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(3))
    kb = np.where(rng.rand(b, n) < 0.2, -1e9, 0.0).astype(np.float32)
    do = rng.randn(b, h, n, d).astype(np.float32)
    return q, k, v, kb, do


@pytest.fixture
def pallas_interpret():
    from ct_clip_tpu.ops.pallas import _call
    import jax

    _call.set_interpret(True)
    jax.clear_caches()  # plans are resolved at trace time
    yield
    _call.set_interpret(False)
    jax.clear_caches()


def test_k12_plain_backward_matches_pallas_kbias_bwd(pallas_interpret):
    """K12's plain backward against `_pallas_attention_bwd_kbias` run in
    interpret mode: dq, dk, dv and dkey_bias within 1e-4 relative (f32 sums
    in different orders, through a softmax)."""
    from ct_clip_tpu.ops.pallas.attention import _pallas_attention_bwd_kbias
    from ct_clip_tpu_torch.ops.attention import fused_attention

    q, k, v, kb, do = _kbias_args()
    ref = _pallas_attention_bwd_kbias(*(jnp.asarray(a) for a in (q, k, v, kb, do)))
    qt, kt, vt, kbt = (_t(a).requires_grad_() for a in (q, k, v, kb))
    got = torch.autograd.grad(fused_attention(qt, kt, vt, key_bias=kbt),
                              (qt, kt, vt, kbt), _t(do))
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-4)


def test_k7_f32_matches_xla_attention():
    """K7's f32 form (masked keys, n not a multiple of the kernel's tiles)
    against `_xla_attention` within 1e-5 relative."""
    from ct_clip_tpu.ops.pallas.attention import _xla_attention
    from ct_clip_tpu_torch.ops.attention import fused_attention

    q, k, v, kb, _ = _kbias_args(n=100, seed=6)
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                         jnp.asarray(kb))
    _close(fused_attention(_t(q), _t(k), _t(v), key_bias=_t(kb)), ref)


def test_k13_plain_is_attention_with_the_philox_mask():
    from ct_clip_tpu_torch.ops.attention import (attention_plain, dropout_mask,
                                                 fused_attention_kbias_dropout)

    q, k, v, kb, _ = _kbias_args(n=40, d=8, seed=7)
    mask = dropout_mask(11, 2, 2, 40, 0.1)
    got = fused_attention_kbias_dropout(_t(q), _t(k), _t(v), _t(kb), 11, 0.1)
    ref = attention_plain(_t(q), _t(k), _t(v), key_bias=_t(kb), mask=mask)
    assert torch.equal(got, ref)
    # the seed may be a (1,) integer tensor, as the model draws it
    same = fused_attention_kbias_dropout(_t(q), _t(k), _t(v), _t(kb),
                                         torch.tensor([11]), 0.1)
    assert torch.equal(same, got)
    assert set(mask.unique().tolist()) == {0.0, float(np.float32(1 / 0.9))}


def test_k13_backward_matches_autograd_of_the_explicit_mask():
    from ct_clip_tpu_torch.ops.attention import (attention_plain, dropout_mask,
                                                 fused_attention_kbias_dropout)

    q, k, v, kb, do = _kbias_args(n=48, d=8, seed=8)
    ins = [_t(a).requires_grad_() for a in (q, k, v, kb)]
    got = torch.autograd.grad(fused_attention_kbias_dropout(*ins, 3, 0.25), ins, _t(do))
    ref = torch.autograd.grad(attention_plain(*ins[:3], key_bias=ins[3],
                                              mask=dropout_mask(3, 2, 2, 48, 0.25)),
                              ins, _t(do))
    for g, r in zip(got, ref):
        _close(g, r.numpy())


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_k13_kept_share_within_4_sigma(rate):
    from ct_clip_tpu_torch.ops.attention import dropout_mask

    b, h, n = 2, 3, 64
    kept = (dropout_mask(1234, b, h, n, rate) > 0).double()
    count = kept.numel()
    sigma = np.sqrt(rate * (1 - rate) / count)
    assert abs(kept.mean().item() - (1 - rate)) < 4 * sigma
    # rows, heads and batch rows draw different bits
    assert not torch.equal(kept[0, 0], kept[0, 1])
    assert not torch.equal(kept[0, 0], kept[1, 0])


def test_k13_mean_over_seeds_approaches_jax_no_dropout():
    """tests/test_pallas.py::test_attention_dropout_xla_fallback_statistics
    with the port's mask: inverted dropout is unbiased, so the mean over 64
    seeds lies within the JAX test's bound of JAX's no-dropout output."""
    from ct_clip_tpu.ops.pallas.attention import _xla_attention
    from ct_clip_tpu_torch.ops.attention import fused_attention_kbias_dropout

    b, h, n, d = 2, 2, 32, 16
    rng = np.random.RandomState(31)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(3))
    kb = np.zeros((b, n), np.float32)
    outs = [fused_attention_kbias_dropout(_t(q), _t(k), _t(v), _t(kb), s, 0.5)
            for s in range(64)]
    mean = torch.stack(outs).mean(0).numpy()
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    None, jnp.asarray(kb)))
    assert np.mean(np.abs(mean - ref)) < 0.12


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Philox4x32-10 against the Random123 known-answer vectors."""
    from ct_clip_tpu_torch.ops.attention import philox4x32

    got = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in got) == want


# ----------------------------- tower backwards (K11, K9, K10, K14) and VQ (K5, K15)
def _grad_close(got, ref, rtol=1e-4):
    """Gradients: max|port - jax| <= rtol * max|jax| per tensor (f32 sums over
    all rows in different orders)."""
    _close(got, ref, rtol)


def test_k11_plain_backward_matches_pallas_ff_bwd(pallas_interpret):
    """K11's plain backward (autograd of the plain FF) against `_pallas_ff_bwd`
    in interpret mode, f32, residual=True: dx, dscale, dbias and the three
    weight gradients within 1e-4 relative (the kernel's erf is the
    Abramowitz-Stegun form, |err| 2e-6)."""
    from ct_clip_tpu.ops.pallas.ffn import _pallas_ff_bwd, _pick_m_bwd
    from ct_clip_tpu_torch.ops.ffn import geglu_ff_bwd_plain

    rng = np.random.RandomState(31)
    n, dim, inner = 256, 128, 85
    x, do = rng.randn(n, dim), rng.randn(n, dim)
    scale, bias = 1 + 0.2 * rng.randn(dim), 0.1 * rng.randn(dim)
    wia, wig = rng.randn(dim, inner) / np.sqrt(dim), rng.randn(dim, inner) / np.sqrt(dim)
    wo = rng.randn(inner, dim) / np.sqrt(inner)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    m = _pick_m_bwd(n, dim, inner, 4)
    dx, ds, db, dwa, dwg, dwo = _pallas_ff_bwd(f(x), f(scale), f(bias), f(wia), f(wig),
                                               f(wo), f(do), 1e-5, m, residual=True)
    got = geglu_ff_bwd_plain(_t(x), _t(scale), _t(bias),
                             _t(np.concatenate([wia, wig], axis=1).T), _t(wo.T), _t(do))
    for g, r in zip(got, (dx, ds, db, np.concatenate([dwa, dwg], axis=1).T, dwo.T)):
        _grad_close(g, r)


def _spatial_inputs(seed, b, n, dim, heads, dh, grid=False, S=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(*((b, n, S, dim) if grid else (b, n, dim)))
    w = _weights(rng, dim, heads, dh)
    return rng, x, w, rng.randn(*x.shape) * 0.1


def _attn_grads_close(got, ref):
    """(dx, dgamma, dwq, dwkv, dq_scale, dk_scale, dwout[, dbias]): the JAX
    (in, out) weight gradients are transposed to nn.Linear layout."""
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        _grad_close(g, r.T if i in (2, 3, 6) else r)


def test_k9_plain_backward_matches_pallas_spatial_bwd(pallas_interpret):
    """K9's plain backward against `_pallas_spatial_bwd` in interpret mode, f32,
    residual=True, with the (heads, n, n) bias gradient summed over the
    planes: every output within 1e-4 relative."""
    from ct_clip_tpu.ops.pallas.spatial_attention import _pallas_spatial_bwd
    from ct_clip_tpu_torch.ops.qknorm_attention import qknorm_attention_bwd_plain

    b, n, dim, heads, dh = 2, 128, 128, 4, 32
    rng, x, w, do = _spatial_inputs(41, b, n, dim, heads, dh)
    bias = rng.randn(heads, n, n)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = _pallas_spatial_bwd(f(x), *_jax_args(w), f(bias), f(do), heads=heads,
                              dim_head=dh, scale=8.0, dtype=jnp.float32, residual=True)
    got = qknorm_attention_bwd_plain(_t(x), *_port_args(w), _t(bias), _t(do), heads, dh)
    assert len(got) == len(ref) == 8
    _attn_grads_close(got, ref)


def test_k10_plain_backward_matches_pallas_grid_bwd(pallas_interpret):
    """K10's grid form: the plain backward on the native (b, t, S, dim) grid
    against `_pallas_small_qknorm_bwd(grid_layout=True)` in interpret mode,
    f32, residual=True: within 1e-4 relative."""
    from ct_clip_tpu.ops.pallas.small_attention import (_pallas_small_qknorm_bwd,
                                                        _plan_grid_bwd)
    from ct_clip_tpu_torch.ops.qknorm_attention import grid_qknorm_attention_bwd_plain

    b, n, S, dim, heads, dh = 2, 8, 16, 128, 8, 16
    _, x, w, do = _spatial_inputs(43, b, n, dim, heads, dh, grid=True, S=S)
    g = _plan_grid_bwd(b, n, S, dim, heads, dh)
    assert g is not None
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    ref = _pallas_small_qknorm_bwd(f(x), *_jax_args(w), f(do), g, heads=heads,
                                   dim_head=dh, scale=8.0, dtype=jnp.float32,
                                   residual=True, grid_layout=True)
    got = grid_qknorm_attention_bwd_plain(_t(x), *_port_args(w), _t(do), heads, dh)
    assert len(got) == len(ref) == 7
    _attn_grads_close(got, ref)


@pytest.mark.parametrize("rotated", [False, True])
def test_k14_peg_backward_matches_pallas_peg_bwd(pallas_interpret, rotated):
    """The PEG backward on the CPU (dx by the flipped-kernel conv, dW and db
    by K14's plain version) against `_pallas_peg_bwd` in interpret mode on
    bf16 activations, residual=True, both the frame-causal and the rotated
    (h-causal, causal_axis 1) forms.  dW and db sum exact bf16 products in
    f32: 1e-5 relative; dx is a bf16 conv output: 1e-2."""
    from ct_clip_tpu.ops.pallas.peg import _pallas_peg_bwd, _plan
    from ct_clip_tpu_torch.ops.attention import peg_conv

    rng = np.random.RandomState(23)
    shape, c = (1, 4, 8, 8, 128), 128
    x = jnp.asarray(rng.randn(*shape).astype(np.float32), jnp.bfloat16)
    weight = (rng.randn(c, 1, 3, 3, 3) * 0.2).astype(np.float32)  # Conv3d layout
    used = weight.transpose(0, 1, 4, 2, 3) if rotated else weight
    kernel = jnp.asarray(used.transpose(2, 3, 4, 1, 0))  # flax DHWIO
    do = jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.1, jnp.bfloat16)
    dx, dw, db = _pallas_peg_bwd(x, kernel, do, True, _plan(x.shape, x.dtype),
                                 residual=True, causal_axis=1 if rotated else 0)

    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    wt, bt = _t(weight).requires_grad_(), torch.zeros(c, requires_grad=True)
    xt.requires_grad_()
    out = peg_conv(xt, wt, bt, rotated)
    dot = torch.tensor(np.asarray(do.astype(jnp.float32))).to(torch.bfloat16)
    gx, gw, gb = torch.autograd.grad(out, (xt, wt, bt), dot)
    if rotated:  # the weight as applied
        gw = gw.permute(0, 1, 4, 2, 3)
    _close(gx.float(), np.asarray(dx.astype(jnp.float32)), 1e-2)
    _close(gw, np.asarray(dw).transpose(4, 3, 0, 1, 2))
    _close(gb, db)


def test_k5_exact_and_k15_plain_match_pallas_vq(pallas_interpret):
    """On bf16 rows: the exact assignment (x.c_hi + x.c_lo) against
    `pallas_assign(exact=True)`, ids equal; the cluster statistics against
    `pallas_cluster_stats`: bins equal, embed sums within 1e-4 relative (the
    TPU kernel sums the normalised rows as bf16 hi + lo parts, 2^-16)."""
    from ct_clip_tpu.ops.norms import l2norm as jl2norm
    from ct_clip_tpu.ops.pallas.vq import _plan, pallas_assign, pallas_cluster_stats
    from ct_clip_tpu_torch.ops.vq import cluster_stats, vq_assign

    rng = np.random.RandomState(13)
    n, dim, k = 512, 128, 128
    embed = rng.randn(k, dim).astype(np.float32)
    truth = rng.randint(0, k // 2, n)  # half the codes stay empty
    x = (embed[truth] + 0.1 * rng.randn(n, dim)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    embed_n = jl2norm(jnp.asarray(embed))
    m = _plan(n, dim, k)
    ids = pallas_assign(xb, embed_n, m, exact=True)
    bins, esum = pallas_cluster_stats(xb, ids, k, m)

    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got_ids = vq_assign(xt, _t(np.asarray(embed_n)), exact=True)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got_ids.numpy(), truth)
    got_bins, got_esum = cluster_stats(xt, got_ids, k)
    np.testing.assert_array_equal(got_bins.numpy(), np.asarray(bins))
    assert (got_bins.numpy() == 0).sum() >= k // 2
    _close(got_esum, esum, 1e-4)
