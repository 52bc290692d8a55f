"""The arithmetic of csrc/attention_tc32.cu, f32 attention on the tensor
cores in 3xTF32, emulated on the CPU: the forwards K7 (a key bias, a dense
bias, none) and K13a (a key bias and dropout), and the backwards K12a (a key
bias), K12b (a dense per-head or one-head bias, and no bias) and K13b (a key
bias and dropout), the backward reading the emulated forward's output and
lse as on the card.

The kernel splits each f32 operand x into hi = tf32(x) (cvt.rna.tf32.f32's
rounding: to nearest, ties away from zero, at 10 mantissa bits) and lo =
x - hi, which the tensor core reads as TF32 by dropping its low 13 bits, and
runs every product A B as hi hi + hi lo + lo hi with f32 sums; the online
softmax, P, dP, dS, the mask and D_i = dO . O stay f32.  The emulation below
runs the same products in torch and is held against the JAX package's
`fused_attention` and `fused_attention_kbias_dropout` and their VJPs (their
XLA twins on the CPU, at Precision.HIGHEST) within 1e-5 of max|JAX| per
output, the card check's tolerance; plain TF32 (hi hi alone) must miss it.
JAX's CPU dropout draws `bernoulli(fold_in(PRNGKey(0), seed), 1 - rate)`;
the test derives that mask from the same key and hands it to the emulation.
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


TILE = 64  # keys per tile of the forward's sweep


def _biased(s, key_bias=None, bias=None):
    if bias is not None:
        s = s + bias
    return s if key_bias is None else s + key_bias[:, None, None, :]


def tc32_forward_emulated(q, k, v, passes: int, key_bias=None, bias=None, mask=None):
    """out and lse (b, h, n) as attention_tc32.cu's forward computes them: S
    = Q K^T in `passes`-TF32 plus the bias, an online softmax in f32 over
    64-key tiles (the running max's correction applied to the sum and to
    the output before each tile's share), each tile's (P M) V a product of
    its own added to the running output; out = O / l, lse = m + log l.
    `mask` the scaled dropout mask (K13a)."""
    s = _biased(mm_tf32(q, k.transpose(-1, -2), passes), key_bias, bias)
    m = torch.full(s.shape[:-1] + (1,), -float("inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + v.shape[-1:])
    for j0 in range(0, s.shape[-1], TILE):
        x = s[..., j0:j0 + TILE]
        mn = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - mn)
        p = torch.exp(x - mn)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pm = p if mask is None else p * mask[..., j0:j0 + TILE]
        o = o * corr + mm_tf32(pm, v[..., j0:j0 + TILE, :], passes)
        m = mn
    return o / l, (m + torch.log(l))[..., 0]


def tc32_emulated(q, k, v, do, passes: int, key_bias=None, bias=None, mask=None):
    """dq, dk, dv and, with its bias, dbias (summed to the bias's shape) and
    dkey_bias, as attention_tc32.cu computes them: the forward's lse and
    output from its 3xTF32 form (`tc32_forward_emulated`), then S, dP and
    the three gradient products in `passes`-TF32; `mask` the scaled dropout
    mask (K13b: dS = P (dP M - D), dv from (P M)^T dO)."""
    def biased(s):
        return _biased(s, key_bias, bias)
    out, lse = tc32_forward_emulated(q, k, v, 3, key_bias, bias, mask)
    lse = lse[..., None]
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


# The forwards: K7 with a key bias (RadBERT's inference), a dense per-head
# bias (MaskGIT's CPB, T5) and none (the TokenCritic), K13a with a key bias
# and dropout 0.1 (RadBERT's default step)
FWD_FORMS = ("key", "dense", "none", "dropout")


@pytest.fixture(scope="module")
def fwd_cases():
    """form -> (q, k, v, the emulation's keyword arguments, the JAX
    package's forward output, the row log-sum-exp of the f32 scores taken
    in f64), from seeded numpy inputs; the dropout form's scaled mask
    derived from the key JAX's CPU path draws with."""
    from ct_clip_tpu.ops.pallas.attention import (fused_attention,
                                                  fused_attention_kbias_dropout)

    b, h, n, _ = SHAPE
    out = {}
    for i, form in enumerate(FWD_FORMS):
        q, k, v, _, kb = _inputs(2041 + i)
        kw, args = {}, (q, k, v)
        with jax.default_matmul_precision("highest"):
            if form == "dropout":
                seed = np.array([20261019], np.int32)
                ref = fused_attention_kbias_dropout(*map(jnp.asarray, (q, k, v, kb)),
                                                    jnp.asarray(seed), RATE)
                key = jax.random.fold_in(jax.random.PRNGKey(0), seed[0])
                keep = np.asarray(jax.random.bernoulli(key, 1.0 - RATE, (b, h, n, n)))
                kw = dict(key_bias=torch.from_numpy(kb), mask=torch.from_numpy(
                    keep.astype(np.float32) / np.float32(1.0 - RATE)))
            elif form == "key":
                ref = jax.jit(lambda *a: fused_attention(a[0], a[1], a[2], None, a[3]))(
                    *map(jnp.asarray, (q, k, v, kb)))
                kw = dict(key_bias=torch.from_numpy(kb))
            else:
                if form == "dense":
                    bias = np.random.RandomState(11).randn(1, h, n, n).astype(np.float32)
                    args, kw = (q, k, v, bias), dict(bias=torch.from_numpy(bias))
                ref = jax.jit(lambda *a: fused_attention(*a))(*map(jnp.asarray, args))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        s64 = _biased(tq.double() @ tk.double().transpose(-1, -2),
                      *(None if kw.get(x) is None else kw[x].double()
                        for x in ("key_bias", "bias")))
        out[form] = (tq, tk, tv), kw, np.asarray(ref), torch.logsumexp(s64, dim=-1).numpy()
    return out


@pytest.mark.parametrize("form", FWD_FORMS)
def test_3xtf32_forward_forms_match_jax_f32(fwd_cases, form):
    """out of the 3xTF32 forward's emulation (online softmax over 64-key
    tiles) within 1e-5 of max|JAX|, the kernel's card tolerance, and its lse
    within 1e-5 of max|lse| of the f64 log-sum-exp of the same scores."""
    inputs, kw, ref, lse_ref = fwd_cases[form]
    out, lse = tc32_forward_emulated(*inputs, 3, **kw)
    err = _rel_errors([out], [ref])[0]
    lse_err = _rel_errors([lse], [lse_ref])[0]
    assert err <= TOL and lse_err <= TOL, f"{form}: out {err:.3e}, lse {lse_err:.3e}"


@pytest.mark.parametrize("form", FWD_FORMS)
def test_plain_tf32_forward_forms_miss_the_tolerance(fwd_cases, form):
    """hi hi alone (plain TF32) misses 1e-5 of max|JAX| in the output of
    every form: the tolerance tells the two forwards apart."""
    inputs, kw, ref, _ = fwd_cases[form]
    err = _rel_errors([tc32_forward_emulated(*inputs, 1, **kw)[0]], [ref])[0]
    assert err > TOL, f"{form}: plain TF32 reads {err:.3e}"


@pytest.mark.parametrize("heads", [SHAPE[1], 1])
def test_3xtf32_forward_output_keeps_dense_dbias_rows_at_f32_rounding(heads):
    """The chain the card runs for K7 dense / K12b f32: the emulated 3xTF32
    forward's output and lse feed the emulated backward, whose D_i = dO . O
    then comes from a 3xTF32 output.  dS rows sum to zero in exact
    arithmetic; the chain's dbias rows (summed over the batch) must stay
    within 16x those of the port's plain f32 version on the same inputs, the
    limit of the card check (chip_smoke.py::dense_attention_phase), as a
    true-f32 output kept them."""
    from ct_clip_tpu_torch.ops.attention import attention_bwd_plain

    q, k, v, do, _ = map(torch.from_numpy, _inputs(2051 + heads))
    bias = torch.from_numpy(np.random.RandomState(13).randn(
        1, heads, *SHAPE[2:3] * 2).astype(np.float32))
    dbias = tc32_emulated(q, k, v, do, 3, bias=bias)[3]
    plain = attention_bwd_plain(q, k, v, do, bias)[3]
    rows, plain_rows = (x.sum(-1).abs().max().item() for x in (dbias, plain))
    assert dbias.shape == bias.shape and rows <= 16 * plain_rows, (rows, plain_rows)


# ------------------------------------------------------------------ K9 f32
# csrc/qknorm_attention_tc32.cu: the QK-norm attention core's backward at
# head dim 32 in 3xTF32, emulated below and run inside the sublayer's
# backward (LN, projections, the l2norm and its scales, the CPB bias), held
# against the JAX package's K9 in f32 (`_pallas_spatial_bwd` in interpret
# mode, "highest" products) on a few sequences of 64 and 96 tokens.
K9_SHAPES = ((3, 64), (2, 96))  # (sequences, tokens): one tile; a ragged second


def k9_core_emulated(q, kv, dout, heads: int, n: int, qs, ks, bias, passes: int):
    """(merged, dq, dkv, dq_scale, dk_scale, dbias) of the attention core as
    qknorm_attention_tc32.cu computes them on (S n, heads 32) projections:
    qn = l2norm(q) qs, kn = l2norm(k) ks; S and dP in `passes`-TF32; the row
    pass's online lse and D_i = sum_j P dP over 64-key tiles; P = exp(S +
    bias - lse), dS = P (dP - D); merged = P v and dqn = dS kn over the key
    tiles, dv = P^T dO and dkn = dS^T qn over the query tiles, each tile's
    product a sum of its own added in f32; the l2norm backward; dbias the
    sum of dS over the sequences."""
    d = 32
    hd, S = heads * d, q.shape[0] // n

    def split(t):
        return t.reshape(S, n, heads, d).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(S * n, hd)

    def tiled(a, b):  # a @ b over the contraction in 64-token tiles, summed in f32
        out = 0
        for j0 in range(0, a.shape[-1], TILE):
            out = out + mm_tf32(a[..., j0:j0 + TILE], b[..., j0:j0 + TILE, :], passes)
        return out

    qf, kf, v, g = split(q), split(kv[:, :hd]), split(kv[:, hd:]), split(dout)
    rq = torch.rsqrt(torch.clamp_min((qf * qf).sum(-1, keepdim=True), 1e-24))
    rk = torch.rsqrt(torch.clamp_min((kf * kf).sum(-1, keepdim=True), 1e-24))
    qhat, khat = qf * rq, kf * rk
    qn, kn = qhat * qs, khat * ks
    s = mm_tf32(qn, kn.transpose(-1, -2), passes)
    if bias is not None:
        s = s + bias
    dp = mm_tf32(g, v.transpose(-1, -2), passes)
    m = torch.full(s.shape[:-1] + (1,), -float("inf"))
    l, D = torch.zeros_like(m), torch.zeros_like(m)
    for j0 in range(0, n, TILE):
        x = s[..., j0:j0 + TILE]
        mn = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr, p = torch.exp(m - mn), torch.exp(x - mn)
        l = l * corr + p.sum(-1, keepdim=True)
        D = D * corr + (p * dp[..., j0:j0 + TILE]).sum(-1, keepdim=True)
        m = mn
    p = torch.exp(s - (m + torch.log(l)))
    ds = p * (dp - D / l)
    dqn, dkn = tiled(ds, kn), tiled(ds.transpose(-1, -2), qn)

    def l2norm_bwd(xhat, r, dn, sc):
        dh = dn * sc
        return r * (dh - xhat * (xhat * dh).sum(-1, keepdim=True))
    dkv = torch.cat([merge(l2norm_bwd(khat, rk, dkn, ks)), merge(tiled(p.transpose(-1, -2), g))],
                    dim=1)
    return (merge(tiled(p, v)), merge(l2norm_bwd(qhat, rq, dqn, qs)), dkv,
            (dqn * qhat).sum((0, 1, 2)), (dkn * khat).sum((0, 1, 2)),
            None if bias is None else ds.sum(0))


class _K9Core(torch.autograd.Function):
    """The plain f32 core forward; its backward the emulated kernel."""

    @staticmethod
    def forward(ctx, q, kv, qs, ks, bias, heads, n, passes):
        ctx.save_for_backward(q, kv, qs, ks, bias)
        ctx.cfg = heads, n, passes
        return k9_core_emulated(q, kv, torch.zeros_like(q), heads, n, qs, ks, bias, 3)[0]

    @staticmethod
    def backward(ctx, dmerged):
        q, kv, qs, ks, bias = ctx.saved_tensors
        heads, n, passes = ctx.cfg
        _, dq, dkv, dqs, dks, dbias = k9_core_emulated(q, kv, dmerged, heads, n, qs, ks, bias,
                                                       passes)
        return dq, dkv, dqs, dks, dbias, None, None, None


def k9_sublayer_emulated(x, gamma, wq, wkv, q_scale, k_scale, wout, bias, heads, passes):
    """The spatial QK-norm sublayer as the port's f32 path runs it, its core
    through `_K9Core`: autograd of it is K9 f32 with the kernel's core."""
    from ct_clip_tpu_torch.ops.norms import layer_norm

    b, n, dim = x.shape
    xn = layer_norm(x, gamma)
    q, kv = (xn @ wq.t()).reshape(b * n, -1), (x @ wkv.t()).reshape(b * n, -1)
    merged = _K9Core.apply(q, kv, q_scale * 8.0, k_scale, bias, heads, n, passes)
    return merged.reshape(b, n, -1) @ wout.t() + x


@pytest.fixture(scope="module")
def k9_cases():
    """(the port's leaves, dO, the JAX package's K9 f32 gradients) for each
    of K9_SHAPES: dim 64, 2 heads of 32, the (2, n, n) bias."""
    from ct_clip_tpu.ops.pallas import _call
    from ct_clip_tpu.ops.pallas.spatial_attention import _pallas_spatial_bwd

    dim, heads, dh = 64, 2, 32
    hd, out = heads * dh, []
    _call.set_interpret(True)
    jax.clear_caches()
    try:
        for i, (b, n) in enumerate(K9_SHAPES):
            rng = np.random.RandomState(2061 + i)
            x, do = (rng.randn(b, n, dim).astype(np.float32) for _ in range(2))
            w = [1 + 0.1 * rng.randn(dim), rng.randn(dim, hd) / np.sqrt(dim),
                 rng.randn(dim, 2 * hd) / np.sqrt(dim), 1 + 0.3 * rng.rand(dh),
                 1 + 0.3 * rng.rand(dh), rng.randn(hd, dim) / np.sqrt(hd),
                 rng.randn(heads, n, n)]
            w = [a.astype(np.float32) for a in w]
            ref = _pallas_spatial_bwd(*map(jnp.asarray, [x] + w[:-1]), jnp.asarray(w[-1]),
                                      jnp.asarray(do), heads=heads, dim_head=dh, scale=8.0,
                                      dtype=jnp.float32, residual=True)
            ref = [np.asarray(r).T if j in (2, 3, 6) else np.asarray(r)
                   for j, r in enumerate(ref)]  # (in, out) kernels -> nn.Linear layout
            port = [x, w[0], w[1].T, w[2].T, w[3], w[4], w[5].T, w[6]]
            out.append(([torch.from_numpy(np.ascontiguousarray(a)) for a in port],
                        torch.from_numpy(do), ref))
    finally:
        _call.set_interpret(False)
        jax.clear_caches()
    return out


def _k9_errors(case, passes):
    leaves, do, ref = case
    leaves = [t.clone().requires_grad_() for t in leaves]
    got = torch.autograd.grad(k9_sublayer_emulated(*leaves, 2, passes), leaves, do)
    return _rel_errors([g.detach() for g in got], ref)


@pytest.mark.parametrize("shape", range(len(K9_SHAPES)), ids=[f"{b}x{n}" for b, n in K9_SHAPES])
def test_3xtf32_k9_core_backward_matches_jax_f32(k9_cases, shape):
    """dx, dgamma, dwq, dwkv, dq_scale, dk_scale, dwout and dbias (summed
    over the sequences) of K9 f32 with the emulated 3xTF32 core within 1e-5
    of max|JAX| each, the kernel's card tolerance for its direct outputs."""
    errs = _k9_errors(k9_cases[shape], 3)
    assert max(errs) <= TOL, f"3xTF32 K9 rel errors {errs}"


@pytest.mark.parametrize("shape", range(len(K9_SHAPES)), ids=[f"{b}x{n}" for b, n in K9_SHAPES])
def test_plain_tf32_k9_core_backward_misses_the_tolerance(k9_cases, shape):
    """The same with the core's products in plain TF32 (hi hi alone) misses
    1e-5 in dx: the tolerance tells the two apart."""
    errs = _k9_errors(k9_cases[shape], 1)
    assert errs[0] > TOL, f"plain TF32 K9 rel errors {errs}"
