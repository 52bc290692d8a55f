"""The arithmetic of csrc/attention_tc32.cu, the f32 attention backwards
on the tensor cores in 3xTF32, emulated on the CPU: K12a (a key bias),
K12b (a dense per-head or one-head bias, and no bias) and K13b (a key bias
and dropout).

The kernel splits each f32 operand x into hi = tf32(x) (cvt.rna.tf32.f32's
rounding: to nearest, ties away from zero, at 10 mantissa bits) and lo =
x - hi, which the tensor core reads as TF32 by dropping its low 13 bits, and
runs every product A B as hi hi + hi lo + lo hi with f32 sums; P, dP, dS,
the mask, the softmax and D_i = dO . O (from the forward's true-f32 output)
stay f32.  The emulation below runs the same products in torch and is held
against the JAX package's VJPs of `fused_attention` and
`fused_attention_kbias_dropout` (their XLA twins on the CPU, at
Precision.HIGHEST) within 1e-5 of max|JAX| per output, the card check's
tolerance; plain TF32 (hi hi alone) must miss it in dq, dk and dv.  JAX's CPU
dropout draws `bernoulli(fold_in(PRNGKey(0), seed), 1 - rate)`; the test
derives that mask from the same key and hands it to the emulation.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

TOL = 1e-5
SHAPE = (2, 2, 96, 64)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, kept in f32: half of the last kept bit added to the magnitude's
    bits, the 13 bits below it cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a TF32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b with TF32 operands and f32 sums: 3 passes hi hi + hi lo + lo hi
    (3xTF32), 1 pass hi hi alone (plain TF32).  A product of two TF32
    values is exact in f32."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = truncated(a - ah), truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def tc32_emulated(q, k, v, do, passes: int, key_bias=None, bias=None, mask=None):
    """dq, dk, dv and, with its bias, dbias (summed to the bias's shape) and
    dkey_bias, as attention_tc32.cu computes them: the forward's lse and
    output in f32 (K7 / K13a f32 on the CUDA cores), then S, dP and the three
    gradient products in `passes`-TF32; `mask` the scaled dropout mask
    (K13b: dS = P (dP M - D), dv from (P M)^T dO)."""
    def biased(s):
        if bias is not None:
            s = s + bias
        return s if key_bias is None else s + key_bias[:, None, None, :]
    s32 = biased(q @ k.transpose(-1, -2))
    lse = torch.logsumexp(s32, dim=-1, keepdim=True)
    p32 = torch.softmax(s32, dim=-1)
    out = (p32 if mask is None else p32 * mask) @ v
    d = (do * out).sum(dim=-1, keepdim=True)
    p = torch.exp(biased(mm_tf32(q, k.transpose(-1, -2), passes)) - lse)
    dp = mm_tf32(do, v.transpose(-1, -2), passes)
    pm = p if mask is None else p * mask
    ds = p * ((dp if mask is None else dp * mask) - d)
    grads = [mm_tf32(ds, k, passes), mm_tf32(ds.transpose(-1, -2), q, passes),
             mm_tf32(pm.transpose(-1, -2), do, passes)]
    if bias is not None:
        grads.append(ds.sum_to_size(bias.shape))
    if key_bias is not None:
        grads.append(ds.sum(dim=(1, 2)))
    return grads


def _inputs(seed: int):
    """Seeded f32 q (scaled), k, v, dO at SHAPE and a key bias of f32-min
    pads (batch row 1 keeps 37 of 96 keys)."""
    b, h, n, d = SHAPE
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(4))
    q *= d ** -0.5
    lengths = np.array([n, 37])
    kb = np.where(np.arange(n)[None] < lengths[:, None], 0.0,
                  np.finfo(np.float32).min).astype(np.float32)
    return q, k, v, do, kb


def _jax_vjp(fn, primals, do):
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(fn, *map(jnp.asarray, primals))
        return [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.fixture(scope="module")
def case():
    """The K12a inputs and the JAX package's K12a f32."""
    from ct_clip_tpu.ops.pallas.attention import fused_attention

    q, k, v, do, kb = _inputs(2026)
    ref = _jax_vjp(jax.jit(lambda *a: fused_attention(a[0], a[1], a[2], None, a[3])),
                   (q, k, v, kb), do)
    return [torch.from_numpy(a) for a in (q, k, v, kb, do)], ref


def _rel_errors(got, ref):
    return [np.abs(g.numpy().astype(np.float64) - r).max() / np.abs(r).max()
            for g, r in zip(got, ref)]


def test_tf32_rounds_to_nearest_ties_away_at_ten_bits():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4,
                      1 + ulp + ulp / 2, 3.0, -2.0 ** -20])
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 1 + 2 * ulp, 3.0, -2.0 ** -20])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi = tf32(y)
    lo = truncated(y - hi)
    assert torch.equal(tf32(hi), hi) and torch.equal(truncated(lo), lo)
    assert ((y - hi).abs() <= 2.0 ** -11 * y.abs()).all()
    assert ((y - hi - lo).abs() <= 2.0 ** -21 * y.abs()).all()


def test_3xtf32_k12a_backward_matches_jax_f32(case):
    """dq, dk, dv and dkey_bias of the 3xTF32 emulation within 1e-5 of
    max|JAX| each (the kernel's card tolerance)."""
    (q, k, v, kb, do), ref = case
    errs = _rel_errors(tc32_emulated(q, k, v, do, 3, key_bias=kb), ref)
    assert max(errs) <= TOL, f"3xTF32 rel errors {errs}"


def test_plain_tf32_k12a_backward_misses_the_tolerance(case):
    """hi hi alone (plain TF32, ~2^-11 relative per operand) misses 1e-5 in
    dq, dk and dv: the tolerance tells 3xTF32 from TF32."""
    (q, k, v, kb, do), ref = case
    errs = _rel_errors(tc32_emulated(q, k, v, do, 1, key_bias=kb), ref)
    assert min(errs[:3]) > TOL, f"plain TF32 rel errors {errs}"


# K12b: a dense (1, h, n, n) per-head bias (MaskGIT's CPB, T5), a (1, 1, n, n)
# one-head bias, and none (the TokenCritic); K13b: a key bias and dropout 0.1
# (RadBERT's default step, CT-CLIP's text tower in f32)
FORMS = ("dense", "dense_one_head", "none", "dropout")
RATE = 0.1


@pytest.fixture(scope="module")
def form_cases():
    """form -> (torch inputs of `tc32_emulated`, the JAX package's VJP of the
    same call), from seeded numpy inputs; the dropout form's scaled mask
    derived from the key JAX's CPU path draws with."""
    from ct_clip_tpu.ops.pallas.attention import (fused_attention,
                                                  fused_attention_kbias_dropout)

    b, h, n, _ = SHAPE
    out = {}
    for i, form in enumerate(FORMS):
        q, k, v, do, kb = _inputs(2027 + i)
        tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
        if form == "dropout":
            seed = np.array([20261017], np.int32)
            ref = _jax_vjp(lambda q_, k_, v_, kb_: fused_attention_kbias_dropout(
                q_, k_, v_, kb_, jnp.asarray(seed), RATE), (q, k, v, kb), do)
            key = jax.random.fold_in(jax.random.PRNGKey(0), seed[0])
            keep = np.asarray(jax.random.bernoulli(key, 1.0 - RATE, (b, h, n, n)))
            mask = torch.from_numpy(keep.astype(np.float32) / np.float32(1.0 - RATE))
            out[form] = (tq, tk, tv, tdo), dict(key_bias=torch.from_numpy(kb), mask=mask), ref
        elif form == "none":
            ref = _jax_vjp(jax.jit(lambda *a: fused_attention(*a)), (q, k, v), do)
            out[form] = (tq, tk, tv, tdo), {}, ref
        else:
            heads = h if form == "dense" else 1
            bias = np.random.RandomState(7 + i).randn(1, heads, n, n).astype(np.float32)
            ref = _jax_vjp(jax.jit(lambda *a: fused_attention(*a)), (q, k, v, bias), do)
            out[form] = (tq, tk, tv, tdo), dict(bias=torch.from_numpy(bias)), ref
    return out


@pytest.mark.parametrize("form", FORMS)
def test_3xtf32_backward_forms_match_jax_f32(form_cases, form):
    """dq, dk, dv and dbias (K12b) or dkey_bias (K13b) of the 3xTF32
    emulation within 1e-5 of max|JAX| each (the kernel's card tolerance)."""
    inputs, kw, ref = form_cases[form]
    got = tc32_emulated(*inputs, 3, **kw)
    assert len(got) == len(ref)
    errs = _rel_errors(got, ref)
    assert max(errs) <= TOL, f"{form}: 3xTF32 rel errors {errs}"


@pytest.mark.parametrize("form", FORMS)
def test_plain_tf32_backward_forms_miss_the_tolerance(form_cases, form):
    """hi hi alone misses 1e-5 in dq, dk and dv of every form."""
    inputs, kw, ref = form_cases[form]
    errs = _rel_errors(tc32_emulated(*inputs, 1, **kw), ref)
    assert min(errs[:3]) > TOL, f"{form}: plain TF32 rel errors {errs}"
