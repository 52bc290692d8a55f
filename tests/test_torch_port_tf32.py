"""The arithmetic of csrc/attention_tc32.cu, the f32 key-bias attention
backward (K12a) on the tensor cores in 3xTF32, emulated on the CPU.

The kernel splits each f32 operand x into hi = tf32(x) (cvt.rna.tf32.f32's
rounding: to nearest, ties away from zero, at 10 mantissa bits) and lo =
x - hi, which the tensor core reads as TF32 by dropping its low 13 bits, and
runs every product A B as hi hi + hi lo + lo hi with f32 sums; P, dP, dS,
the softmax and D_i = dO . O (from the forward's true-f32 output) stay f32.  The emulation below runs the same products in torch and
is held against the JAX package's K12a f32 (the VJP of `fused_attention`,
its XLA twin on the CPU, at Precision.HIGHEST) within 1e-5 of max|JAX| per
output, the card check's tolerance; plain TF32 (hi hi alone) must miss it.
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


def k12a_emulated(q, k, v, kb, do, passes: int):
    """dq, dk, dv, dkey_bias as attention_tc32.cu computes them: the
    forward's lse and output in f32 (K7 f32 on the CUDA cores), then S, dP
    and the three gradient products in `passes`-TF32."""
    s32 = q @ k.transpose(-1, -2) + kb[:, None, None, :]
    lse = torch.logsumexp(s32, dim=-1, keepdim=True)
    out = torch.softmax(s32, dim=-1) @ v
    d = (do * out).sum(dim=-1, keepdim=True)
    p = torch.exp(mm_tf32(q, k.transpose(-1, -2), passes) + kb[:, None, None, :] - lse)
    ds = p * (mm_tf32(do, v.transpose(-1, -2), passes) - d)
    dq = mm_tf32(ds, k, passes)
    dk = mm_tf32(ds.transpose(-1, -2), q, passes)
    dv = mm_tf32(p.transpose(-1, -2), do, passes)
    return dq, dk, dv, ds.sum(dim=(1, 2))


@pytest.fixture(scope="module")
def case():
    """Seeded f32 inputs at SHAPE, q scaled, a key bias of f32-min pads
    (batch row 1 keeps 37 of 96 keys), and the JAX package's K12a f32."""
    from ct_clip_tpu.ops.pallas.attention import fused_attention

    b, h, n, d = SHAPE
    rng = np.random.RandomState(2026)
    q, k, v, do = (rng.randn(b, h, n, d).astype(np.float32) for _ in range(4))
    q *= d ** -0.5
    lengths = np.array([n, 37])
    kb = np.where(np.arange(n)[None] < lengths[:, None], 0.0,
                  np.finfo(np.float32).min).astype(np.float32)

    @jax.jit
    def grads(q, k, v, kb, do):
        _, vjp = jax.vjp(lambda *a: fused_attention(a[0], a[1], a[2], None, a[3]),
                         q, k, v, kb)
        return vjp(do)
    with jax.default_matmul_precision("highest"):
        ref = [np.asarray(g) for g in grads(*map(jnp.asarray, (q, k, v, kb, do)))]
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
    inputs, ref = case
    errs = _rel_errors(k12a_emulated(*inputs, passes=3), ref)
    assert max(errs) <= TOL, f"3xTF32 rel errors {errs}"


def test_plain_tf32_k12a_backward_misses_the_tolerance(case):
    """hi hi alone (plain TF32, ~2^-11 relative per operand) misses 1e-5 in
    dq, dk and dv: the tolerance tells 3xTF32 from TF32."""
    inputs, ref = case
    errs = _rel_errors(k12a_emulated(*inputs, passes=1), ref)
    assert min(errs[:3]) > TOL, f"plain TF32 rel errors {errs}"
