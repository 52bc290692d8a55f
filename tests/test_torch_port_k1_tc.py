"""K1's bf16 attention core on the tensor cores (the forward pass of
csrc/qknorm_attention_tc.cu) emulated on the CPU, inside the port's bf16
sublayer, and held against the JAX package's bf16 K1 (`_pallas_spatial` in
interpret mode).

The kernel runs one sweep of an online softmax over 64-key tiles: S = qn
kn^T + bias in f32 (qn and kn rounded to bf16, their products exact and
summed in f32), the running max m and sum l in f32, e = exp(S - m) rounded
to bf16 as the A operand of e v (f32 sums), the output rescaled by exp(m_old
- m) before each tile's share, merged = bf16(O / l).  The TPU rounds exp(S -
rowmax) with the row's final max and divides by the f32 sum afterwards
(spatial_attention.py:125-130): the one sweep rounds the same exponentials
at another scale wherever a later tile raises a row's max.  Tolerances: the
sublayer within 2e-2 of max|JAX| (the port's bf16 K1 tolerance, as its plain
version); the merged heads within 1e-2 of max against the plain core at the
TPU's rounding point (`qk_attention_core_plain`: a bf16 ulp or two), and
equal to it where one tile holds every key.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

BF = torch.bfloat16
TOL = 2e-2
TILE = 64  # keys per tile of the forward's sweep
SHAPES = ((3, 40), (2, 64), (2, 96))  # (sequences, tokens): one ragged tile, one, two


def k1_core_bf16_emulated(q, kv, heads: int, n: int, qs, ks, bias):
    """merged (S n, heads 32) bf16 as qknorm_attention_tc.cu's forward pass
    computes it from bf16 projections q (S n, heads 32) and kv [k | v]."""
    d = 32
    hd, S = heads * d, q.shape[0] // n

    def split(t):
        return t.reshape(S, n, heads, d).transpose(1, 2).float()

    def normed(t, sc):
        r = torch.rsqrt(torch.clamp_min((t * t).sum(-1, keepdim=True), 1e-24))
        return (t * r * sc.float()).to(BF).float()

    qn, kn, v = normed(split(q), qs), normed(split(kv[:, :hd]), ks), split(kv[:, hd:])
    s = qn @ kn.transpose(-1, -2)
    if bias is not None:
        s = s + bias.float()
    m = torch.full(s.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + (d,))
    for j0 in range(0, n, TILE):
        x = s[..., j0:j0 + TILE]
        mn = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr, e = torch.exp(m - mn), torch.exp(x - mn)
        l = l * corr + e.sum(dim=-1, keepdim=True)
        o = o * corr + e.to(BF).float() @ v[..., j0:j0 + TILE, :]
        m = mn
    return (o / l).transpose(1, 2).reshape(S * n, hd).to(BF)


def k1_sublayer_bf16_emulated(x, gamma, wq, wkv, q_scale, k_scale, wout, bias, heads: int):
    """The bf16 sublayer as the card's route runs it: LN and the q, kv
    projections in bf16 (as `qknorm_attention_plain`), the core by
    `k1_core_bf16_emulated`, merged wout^T + x summed in f32 and rounded."""
    from ct_clip_tpu_torch.ops.norms import layer_norm

    b, n, dim = x.shape
    x2 = x.reshape(b * n, dim)
    q = layer_norm(x2, gamma) @ wq.to(BF).t()
    kv = x2 @ wkv.to(BF).t()
    merged = k1_core_bf16_emulated(q, kv, heads, n, q_scale.float() * 8.0, k_scale, bias)
    return ((merged @ wout.to(BF).t()).float() + x2.float()).to(BF).reshape(b, n, dim)


@pytest.fixture(scope="module")
def cases():
    """(the port's bf16 input and weights, the JAX package's bf16 K1 output)
    for each of SHAPES: dim 64, 2 heads of 32, a seeded (2, n, n) bias."""
    from ct_clip_tpu.ops.pallas import _call
    from ct_clip_tpu.ops.pallas.spatial_attention import _pallas_spatial

    dim, heads, dh = 64, 2, 32
    hd, out = heads * dh, []
    _call.set_interpret(True)
    jax.clear_caches()
    try:
        for i, (b, n) in enumerate(SHAPES):
            rng = np.random.RandomState(2091 + i)
            x = rng.randn(b, n, dim).astype(np.float32)
            w = [1 + 0.1 * rng.randn(dim), rng.randn(dim, hd) / np.sqrt(dim),
                 rng.randn(dim, 2 * hd) / np.sqrt(dim), 1 + 0.3 * rng.rand(dh),
                 1 + 0.3 * rng.rand(dh), rng.randn(hd, dim) / np.sqrt(hd),
                 rng.randn(heads, n, n)]
            w = [a.astype(np.float32) for a in w]
            xb = jnp.asarray(x, jnp.bfloat16)
            ref = _pallas_spatial(xb, *map(jnp.asarray, w), heads=heads, dim_head=dh,
                                  scale=8.0, dtype=jnp.bfloat16, residual=True)
            port = [torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF)] + [
                torch.from_numpy(np.ascontiguousarray(a))
                for a in (w[0], w[1].T, w[2].T, w[3], w[4], w[5].T, w[6])]
            out.append((port, np.asarray(ref.astype(jnp.float32)).astype(np.float64)))
    finally:
        _call.set_interpret(False)
        jax.clear_caches()
    return out


def _rel(got, ref):
    return np.abs(got.float().numpy().astype(np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=[f"{b}x{n}" for b, n in SHAPES])
def test_k1_bf16_online_form_against_jax(cases, shape):
    """The sublayer with the emulated one-sweep core lands within 2e-2 of
    max|JAX|, as the port's plain version (the card's reference) does."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qknorm_attention_plain

    port, ref = cases[shape]
    got = k1_sublayer_bf16_emulated(*port, 2)
    plain = qknorm_attention_plain(*port, 2, 32)
    assert got.dtype == BF and got.shape == plain.shape
    errs = _rel(got, ref), _rel(plain, ref)
    assert max(errs) <= TOL, f"online form {errs[0]:.3e}, plain {errs[1]:.3e} of max|JAX|"


@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=[f"{b}x{n}" for b, n in SHAPES])
def test_k1_bf16_online_rounding_against_the_tpu_point(cases, shape):
    """The emulated core's merged heads against the plain core at the TPU's
    rounding point on the same bf16 projections: equal where one tile holds
    every key (the running max is the row's max), within 1e-2 of max|merged|
    where a second tile can raise it."""
    from ct_clip_tpu_torch.ops.norms import layer_norm
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    (x, gamma, wq, wkv, qs, ks, _, bias), _ = cases[shape]
    b, n, dim = x.shape
    x2 = x.reshape(b * n, dim)
    q, kv = layer_norm(x2, gamma) @ wq.to(BF).t(), x2 @ wkv.to(BF).t()
    got = k1_core_bf16_emulated(q, kv, 2, n, qs * 8.0, ks, bias)
    ref = qk_attention_core_plain(q, kv, 2, 32, n, qs * 8.0, ks, bias)
    assert got.dtype == ref.dtype == BF and got.shape == ref.shape == q.shape
    if n <= TILE:
        assert torch.equal(got, ref)
    else:
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err <= 1e-2, f"{err:.3e} of max|merged|"
