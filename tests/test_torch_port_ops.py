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
