"""K2, the temporal QK-norm attention sublayer on 16-31-token sequences, as
the card runs it since its core moved to csrc/qknorm_attention_short.cu:
the arithmetic held against the JAX package's K2 (`_pallas_small_qknorm` in
interpret mode), and its routes with the C library stubbed.

bf16: LN, q = bf16(LN(x) wq^T) and kv = bf16(x wkv^T) (ffn_tc.cu's NT store
form: f32 sums, one rounding), the core at the TPU kernel's rounding points
(`qk_attention_core_plain`: qn and kn rounded, e = exp(S - rowmax) rounded
before e v, the f32 sum of the unrounded e, merged rounded once), out =
bf16(f32(merged wout^T) + x) (the residual form).  The kernel's mma.sync
products sum in another order than the plain core's, a bf16 ulp apart at
most where a value lands on a rounding boundary.  Tolerance: 2e-2 of
max|JAX|, the port's bf16 K2 tolerance.

f32: every projection in 3xTF32 (ffn_tc32.cu: TF32 hi and lo planes, each
256-wide k range in its own accumulator), the core in true f32 on the CUDA
cores writing merged as TF32 hi and lo planes, which the residual product
reads as its A operand.  Tolerance: 1e-5 of max|JAX| (the card check's
TC32_REL_TOL); the chain with plain-TF32 products (hi hi alone) misses it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_port_tf32 import mm_tf32_ranges

from ct_clip_tpu_torch.ops import kernels as K

BF, F32 = torch.bfloat16, torch.float32
BF16_TOL, F32_TOL = 2e-2, 1e-5
HEADS, DH, DIM = 2, 32, 64
# (layout, batch, tokens, grid columns S, sequences per Pallas block g)
SHAPES = (("grid", 1, 24, 8, 8), ("grid", 1, 16, 8, 8), ("seq", 4, 24, None, 4),
          ("seq", 4, 16, None, 4))
IDS = [f"{form}_n{n}" for form, _, n, _, _ in SHAPES]


def _as_seqs(x, grid: bool):
    """(b, t, S, dim) grid -> (b S, t, dim) sequences; sequences as they are."""
    if not grid:
        return x
    b, n, S, dim = x.shape
    return x.transpose(1, 2).reshape(b * S, n, dim)


def _from_seqs(y, shape, grid: bool):
    if not grid:
        return y
    b, n, S, dim = shape
    return y.reshape(b, S, n, dim).transpose(1, 2)


def k2_bf16_emulated(x, gamma, wq, wkv, q_scale, k_scale, wout, grid: bool):
    """The bf16 sublayer as the card's short route computes it."""
    from ct_clip_tpu_torch.ops.norms import layer_norm
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    xs = _as_seqs(x, grid)
    S, n, dim = xs.shape
    x2 = xs.reshape(S * n, dim)
    q = (layer_norm(x2, gamma).float() @ wq.to(BF).float().t()).to(BF)
    kv = (x2.float() @ wkv.to(BF).float().t()).to(BF)
    merged = qk_attention_core_plain(q, kv, HEADS, DH, n, q_scale.float() * 8.0, k_scale, None)
    out = ((merged.float() @ wout.to(BF).float().t()) + x2.float()).to(BF)
    return _from_seqs(out.reshape(S, n, dim), x.shape, grid)


def k2_f32_emulated(x, gamma, wq, wkv, q_scale, k_scale, wout, grid: bool, passes: int):
    """The f32 sublayer as the card's short route computes it: the three
    projections in `passes`-TF32, the core in true f32."""
    from ct_clip_tpu_torch.ops.norms import layer_norm
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    xs = _as_seqs(x, grid)
    S, n, dim = xs.shape
    x2 = xs.reshape(S * n, dim)
    q = mm_tf32_ranges(layer_norm(x2, gamma), wq.t(), passes)
    kv = mm_tf32_ranges(x2, wkv.t(), passes)
    merged = qk_attention_core_plain(q, kv, HEADS, DH, n, q_scale * 8.0, k_scale, None)
    out = mm_tf32_ranges(merged, wout.t(), passes) + x2
    return _from_seqs(out.reshape(S, n, dim), x.shape, grid)


@pytest.fixture(scope="module")
def cases():
    """(dtype, shape index) -> (the port's input and weights, the JAX
    package's K2 output in that dtype), numpy-seeded."""
    from ct_clip_tpu.ops.pallas import _call
    from ct_clip_tpu.ops.pallas.small_attention import _pallas_small_qknorm

    hd, out = HEADS * DH, {}
    _call.set_interpret(True)
    jax.clear_caches()
    try:
        for i, (form, b, n, S, g) in enumerate(SHAPES):
            rng = np.random.RandomState(2001 + i)
            shape = (b, n, S, DIM) if form == "grid" else (b, n, DIM)
            x = rng.randn(*shape).astype(np.float32)
            w = [1 + 0.1 * rng.randn(DIM), rng.randn(DIM, hd) / np.sqrt(DIM),
                 rng.randn(DIM, 2 * hd) / np.sqrt(DIM), 1 + 0.3 * rng.rand(DH),
                 1 + 0.3 * rng.rand(DH), rng.randn(hd, DIM) / np.sqrt(hd)]
            w = [a.astype(np.float32) for a in w]
            port_w = [torch.from_numpy(np.ascontiguousarray(a))
                      for a in (w[0], w[1].T, w[2].T, w[3], w[4], w[5].T)]
            for dtype, jdt in ((BF, jnp.bfloat16), (F32, jnp.float32)):
                xj = jnp.asarray(x, jdt)
                ref = _pallas_small_qknorm(xj, *map(jnp.asarray, w), g, heads=HEADS,
                                           dim_head=DH, scale=8.0, dtype=jdt, residual=True,
                                           grid_layout=form == "grid")
                xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype)
                out[dtype, i] = ([xt] + port_w,
                                 np.asarray(ref.astype(jnp.float32)).astype(np.float64))
    finally:
        _call.set_interpret(False)
        jax.clear_caches()
    return out


def _rel(got, ref):
    return np.abs(got.float().numpy().astype(np.float64) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=IDS)
def test_k2_bf16_short_route_against_jax(cases, shape):
    """The bf16 sublayer with the short core's arithmetic lands within 2e-2
    of max|JAX|, as the port's plain version (the CPU route) does."""
    from ct_clip_tpu_torch.ops.qknorm_attention import (grid_qknorm_attention_plain,
                                                        qknorm_attention_plain)

    port, ref = cases[BF, shape]
    grid = SHAPES[shape][0] == "grid"
    got = k2_bf16_emulated(*port, grid)
    plain = (grid_qknorm_attention_plain(*port, HEADS, DH) if grid
             else qknorm_attention_plain(*port, None, HEADS, DH))
    assert got.dtype == BF and got.shape == plain.shape == port[0].shape
    errs = _rel(got, ref), _rel(plain, ref)
    assert max(errs) <= BF16_TOL, f"short route {errs[0]:.3e}, plain {errs[1]:.3e} of max|JAX|"


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "plain_tf32"])
@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=IDS)
def test_k2_f32_short_route_against_jax(cases, shape, passes):
    """The f32 sublayer with its projections in 3xTF32 and the core in true
    f32 lands within 1e-5 of max|JAX| (f32 at "highest"); with plain-TF32
    products it misses: the tolerance tells the two apart."""
    port, ref = cases[F32, shape]
    got = k2_f32_emulated(*port, SHAPES[shape][0] == "grid", passes)
    err = _rel(got, ref)
    if passes == 3:
        assert err <= F32_TOL, f"3xTF32 K2: {err:.3e} of max|JAX|"
    else:
        assert err > F32_TOL, f"plain TF32 K2 reads {err:.3e}, within the tolerance"


@pytest.mark.parametrize("n", [24, 16])
def test_k2_core_plain_rounds_where_the_tpu_kernel_does(n):
    """The plain core in bf16 is the TPU kernel's arithmetic: e = exp(S -
    rowmax) rounded before e v and divided by the f32 sum of the unrounded e
    (small_attention.py:136-144), not the XLA twin's rounded probabilities;
    the two differ, and the plain core equals the one written out here."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    g = torch.Generator().manual_seed(n)
    S, hd = 3, HEADS * DH
    q = torch.randn((S * n, hd), generator=g).to(BF)
    kv = torch.randn((S * n, 2 * hd), generator=g).to(BF)
    qs, ks = 8 * (1 + 0.2 * torch.randn(DH, generator=g)), 1 + 0.2 * torch.randn(DH, generator=g)
    got = qk_attention_core_plain(q, kv, HEADS, DH, n, qs, ks, None)

    def heads(t):
        return t.reshape(S, n, HEADS, DH).transpose(1, 2).float()

    def normed(t, sc):
        return (t * torch.rsqrt(torch.clamp_min((t * t).sum(-1, keepdim=True), 1e-24))
                * sc).to(BF).float()

    s = normed(heads(q), qs) @ normed(heads(kv[:, :hd]), ks).transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    v = heads(kv[:, hd:])
    want = ((e.to(BF).float() @ v) / e.sum(-1, keepdim=True)).to(BF)
    twin = ((e / e.sum(-1, keepdim=True)).to(BF).float() @ v).to(BF)
    flat = want.transpose(1, 2).reshape(S * n, hd)
    assert torch.equal(got, flat)
    assert not torch.equal(twin, want)


@pytest.mark.parametrize("n", [24, 16])
def test_k2_core_mean_error_limit_tells_the_rounding_points_apart(n):
    """The card's rounding-point check on K2's bf16 core (mean|err| within
    K2_POINT_TOL = 2e-4 of mean|plain|) separates the two points: the TPU's
    arithmetic summed in f64 instead of f32 (another summation order, as the
    kernel's) stays far inside it; the normalised p rounded (attention_plain
    on the same heads, attention.cu's point) misses it."""
    from ct_clip_tpu_torch.ops.attention import attention_plain
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_core_plain

    limit = 2e-4
    g = torch.Generator().manual_seed(100 + n)
    S, hd = 16, HEADS * DH
    q = torch.randn((S * n, hd), generator=g).to(BF)
    kv = torch.randn((S * n, 2 * hd), generator=g).to(BF)
    qs, ks = 8 * (1 + 0.2 * torch.randn(DH, generator=g)), 1 + 0.2 * torch.randn(DH, generator=g)
    ref = qk_attention_core_plain(q, kv, HEADS, DH, n, qs, ks, None).float()

    def heads(t):
        return t.reshape(S, n, HEADS, DH).transpose(1, 2).double()

    def normed(t, sc):
        return (t * torch.rsqrt(torch.clamp_min((t * t).sum(-1, keepdim=True), 1e-24))
                * sc.double()).to(BF)

    def rows(t):
        return t.transpose(1, 2).reshape(S * n, hd).to(BF).float()

    qn, kn, v = normed(heads(q), qs), normed(heads(kv[:, :hd]), ks), heads(kv[:, hd:])
    s = qn.double() @ kn.double().transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    f64 = rows((e.to(BF).double() @ v) / e.sum(-1, keepdim=True))
    p_point = rows(attention_plain(qn, kn, v.to(BF)))

    def mean_rel(t):
        return ((t - ref).abs().mean() / ref.abs().mean()).item()
    assert mean_rel(f64) <= limit / 10
    assert mean_rel(p_point) > 2 * limit


# ------------------------------------------------ routes, the C library stubbed
class _RecordingLibrary:
    """Any C entry, recording each call's name and arguments; `fail` returns
    a CUDA error."""

    def __init__(self, fail=None):
        self.calls, self.fail = [], fail

    def __getattr__(self, name):
        if name == "ct_error_string":
            return lambda err: b"planted"
        if not name.startswith("ct_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or int(name == self.fail)

    def names(self):
        return [n for n, _ in self.calls]


def _stub_card(monkeypatch, lib):
    monkeypatch.setattr(K, "library", lambda: lib)
    monkeypatch.setattr(K, "require", lambda *a, **k: None)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    monkeypatch.setattr(K, "sum_splits", lambda part: part.sum(0))
    K.reset_launch_counts()


def _weights(dim, heads, dh):
    hd = heads * dh
    return (torch.ones(dim), torch.zeros((hd, dim)), torch.zeros((2 * hd, dim)), torch.ones(dh),
            torch.ones(dh), torch.zeros((dim, hd)))


# (dtype, n, head dim, heads, bias) -> the forward core's route
@pytest.mark.parametrize("dtype,n,d,heads,bias,route", [
    (BF, 24, 32, 8, False, K.QK_SHORT),        # K2 grid: CT-CLIP's t 24
    (BF, 20, 32, 8, False, K.QK_SHORT),        # K2 seq: the autoencoder's t 20
    (BF, 16, 32, 8, False, K.QK_SHORT),        # K2 seq: 160 frames, t 16
    (BF, 31, 32, 8, False, K.QK_SHORT),
    (F32, 24, 32, 8, False, K.QK_SHORT),       # K2 grid f32
    (F32, 16, 32, 8, False, K.QK_SHORT),
    (BF, 15, 32, 8, False, K.QK_CUDA_CORES),   # below the route
    (BF, 24, 32, 8, True, K.QK_CUDA_CORES),    # a bias: the short core has none
    (BF, 24, 64, 8, False, K.QK_CUDA_CORES),   # another head dim
    (BF, 24, 16, 8, False, K.QK_CUDA_CORES),
    (F32, 31, 32, 40, False, K.QK_CUDA_CORES),  # one sequence's f32 rows outgrow a CTA
    (BF, 32, 32, 8, False, K.QK_WGMMA),        # K1's routes from 32 tokens on
    (F32, 576, 32, 8, True, K.QK_TC32),
    (torch.float16, 24, 32, 8, False, K.QK_CUDA_CORES),
])
def test_k2_forward_route_table(dtype, n, d, heads, bias, route):
    assert K.qk_fwd_route(dtype, n, d, heads, bias) == route
    # below 32 tokens the tensor-core gate answers the CUDA cores; the short
    # sequences' backward route is `qk_bwd_route`'s
    if n < K.QK_TC_MIN_TOKENS:
        assert K.qk_bwd_tensor_cores(dtype, n, d) == K.QK_CUDA_CORES


@pytest.mark.parametrize("dtype,shape,grid,short", [
    (BF, (2, 24, 9, 64), True, True),    # K2 grid, t 24
    (BF, (2, 16, 9, 64), True, True),    # K2 grid, t 16
    (BF, (5, 20, 64), False, True),      # K2 seq, t 20
    (F32, (2, 24, 9, 64), True, True),
    (F32, (5, 16, 64), False, True),
    (BF, (5, 12, 64), False, False),     # below 16 tokens: attention.cu
    (F32, (5, 12, 64), False, False),    # ... with gemm.cu's FFMA products
])
def test_k2_forward_launches_the_short_core_and_counts_it(monkeypatch, dtype, shape, grid,
                                                         short):
    """A K2 forward (`_apply`, the function counters too) at head dim 32 and
    16 <= n < 32 launches qknorm_attention_short.cu once, counted
    `qk_attention_short` (and its f32 counter); bf16 projections on
    ffn_tc.cu, f32 ones in 3xTF32; shorter sequences keep attention.cu,
    counted `qk_attention_cuda_cores` (f32 with gemm.cu's FFMA products)."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    x = torch.zeros(shape, dtype=dtype)
    out = Q._apply(x, *_weights(64, 2, 32), None, 2, 32, 8.0, "grid" if grid else "seq")
    assert out.shape == x.shape and out.dtype == dtype
    c, form = K.launch_counts(), "grid" if grid else "seq"
    assert c[f"{form}_attention"] == 1 and c[f"{form}_attention_f32"] == int(dtype == F32)
    entry = "ct_qk_attention_short_f32" if dtype == F32 else "ct_qk_attention_short"
    assert lib.names().count(entry) == int(short)
    assert c["qk_attention_short"] == int(short)
    assert c["qk_attention_short_f32"] == int(short and dtype == F32)
    assert c["qk_attention_cuda_cores"] == int(not short)
    assert c["qk_attention_tc"] == c["qk_attention_tc32"] == 0
    if not short:
        assert ("ct_attention_f32" if dtype == F32 else "ct_attention") in lib.names()
        assert c["qk_proj_gemm" if dtype == F32 else "qk_proj_tc"] == 3 and c["tc32_gemm"] == 0
    elif dtype == F32:
        assert c["tc32_gemm"] == 3 and c["qk_proj_tc"] == c["qk_proj_gemm"] == 0
    else:
        assert c["qk_proj_tc"] == 3 and c["tc32_gemm"] == c["qk_proj_gemm"] == 0
        assert lib.names() == ["ct_layernorm", "ct_ff_tc_gemm_nt", "ct_ff_tc_gemm_nt",
                               "ct_qk_attention_short", "ct_ff_tc_residual"]


@pytest.mark.parametrize("dtype,grid", [(BF, True), (BF, False), (F32, True), (F32, False)])
def test_k2_backward_keeps_the_cuda_core_kernel(monkeypatch, dtype, grid):
    """K10 takes the short backward core in both dtypes (counted on no
    tensor-core counter): bf16 its bf16 form (counted
    `qk_attention_short_bwd`) with the recompute of q and kv on ffn_tc.cu's
    f32-store NT form and every other product on ffn_tc.cu; f32 its f32
    form (`qk_attention_short_bwd_f32`) and its products in 3xTF32 on
    ffn_tc32.cu, the recompute of q and kv among them (counted
    `tc32_gemm`): nothing of qknorm_attention_bwd.cu or gemm.cu."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    shape = (2, 24, 9, 64) if grid else (5, 20, 64)
    x = torch.zeros(shape, dtype=dtype)
    grads = Q._qknorm_attention_bwd_cuda(x, *_weights(64, 2, 32), None, torch.zeros_like(x), 2,
                                         32, 8.0, grid)
    assert grads[0].shape == x.shape and grads[-1] is None
    names = lib.names()
    c = K.launch_counts()
    assert c["qk_attention_tc_bwd"] == c["qk_attention_tc32_bwd"] == c["qk_attention_short"] == 0
    if dtype == BF:
        assert names.count("ct_qk_attention_short_bwd") == 1
        assert not any(n in names for n in ("ct_qk_attention_bwd", "ct_gemm_layout", "ct_gemm"))
        assert not any("_tc_bwd" in n or "tc32" in n for n in names)
        assert names[1:3] == ["ct_ff_tc_gemm_nt_f32", "ct_ff_tc_gemm_nt_f32"]
        assert c["qk_proj_tc"] == 2 and c["qk_attention_short_bwd"] == 1
    else:
        assert names.count("ct_qk_attention_short_bwd_f32") == 1
        assert not any(n in names for n in ("ct_qk_attention_bwd_f32", "ct_gemm_f32",
                                            "ct_gemm_layout_f32"))
        assert names[6:8] == ["ct_tc32_gemm", "ct_tc32_gemm"] and c["qk_proj_gemm"] == 0
        assert c["qk_attention_short_bwd_f32"] == 1 and c["tc32_gemm"] == 5


def test_k2_other_head_dims_keep_attention_cu(monkeypatch):
    """Head dim 64 at n 24 (and a bias at head dim 32) keeps attention.cu,
    counted `qk_attention_cuda_cores`; the bf16 projections still take
    ffn_tc.cu."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    Q._apply(torch.zeros((3, 24, 128), dtype=BF), *_weights(128, 2, 64), None, 2, 64, 8.0, "seq")
    Q._apply(torch.zeros((3, 24, 64), dtype=BF), *_weights(64, 2, 32),
             torch.zeros((2, 24, 24)), 2, 32, 8.0, "spatial")
    c = K.launch_counts()
    assert lib.names().count("ct_attention") == 2 and c["qk_attention_cuda_cores"] == 2
    assert c["qk_attention_short"] == 0 and c["qk_proj_tc"] == 6


@pytest.mark.parametrize("dtype,dim,hd,route", [
    (BF, 512, 256, "ffn_tc.cu"),   # every model of the repo
    (BF, 64, 64, "ffn_tc.cu"),
    (BF, 36, 64, "gemm.cu"),       # rows TMA cannot take
    (BF, 64, 36, "gemm.cu"),
    (F32, 512, 256, "gemm.cu"),    # f32 outside the 3xTF32 forward: the backward's recompute
])
def test_qk_projection_route_table(dtype, dim, hd, route):
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    assert Q.proj_route(dtype, dim, hd) == route
    assert route in (Q.PROJ_WGMMA, Q.PROJ_WMMA)


def test_k2_projections_at_a_width_tma_cannot_take_keep_gemm_cu(monkeypatch):
    """A bf16 width of no multiple of 8 runs gemm.cu's products (counted
    `qk_proj_gemm`, three) around the short core."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    Q._apply(torch.zeros((3, 24, 36), dtype=BF), *_weights(36, 2, 32), None, 2, 32, 8.0, "seq")
    assert lib.names() == ["ct_layernorm", "ct_gemm", "ct_gemm", "ct_qk_attention_short",
                           "ct_gemm"]
    c = K.launch_counts()
    assert (c["qk_proj_gemm"], c["qk_proj_tc"], c["qk_attention_short"]) == (3, 0, 1)


def _short_call(monkeypatch, lib, dtype=BF, n=24, q_tok=None, bias=None, heads=2):
    _stub_card(monkeypatch, lib)
    d, S = 32, 3
    hd = heads * d
    q, kv = torch.zeros((S * n, hd), dtype=dtype), torch.zeros((S * n, 2 * hd), dtype=dtype)
    qt = q_tok or hd
    return K.qk_attention_short(q, kv, sequences=S, inner=1, heads=heads, n=n, d=d,
                                q_strides=(n * qt, 0, d, qt), kv_strides=(n * 2 * hd, 0, d, 2 * hd),
                                q_scale=torch.ones(d), k_scale=torch.ones(d), bias=bias)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_k2_short_wrapper_counts_the_launch_and_skips_a_failed_one(monkeypatch, dtype):
    """kernels.qk_attention_short launches its entry once and counts it
    there; a launch that reports a CUDA error raises, naming the entry, and
    adds no count.  f32 returns merged's hi and lo planes."""
    entry = "ct_qk_attention_short_f32" if dtype == F32 else "ct_qk_attention_short"
    lib = _RecordingLibrary()
    got = _short_call(monkeypatch, lib, dtype)
    assert lib.names() == [entry]
    assert K.launch_counts()["qk_attention_short"] == 1
    assert sum(K.launch_counts().values()) == 1 + int(dtype == F32)
    args = lib.calls[0][1]
    k = 4 if dtype == F32 else 3  # the eight strides follow the pointers
    assert args[k:k + 8] == (24 * 64, 0, 32, 64, 24 * 128, 0, 32, 128)
    assert args[k + 8:k + 13] == (1, 3, 2, 24, 32)  # inner, sequences, heads, n, d
    if dtype == F32:
        assert len(got) == 2 and all(t.shape == (72, 64) and t.dtype == F32 for t in got)
    else:
        assert got.shape == (72, 64) and got.dtype == BF
    failing = _RecordingLibrary(fail=entry)
    with pytest.raises(RuntimeError, match=entry):
        _short_call(monkeypatch, failing, dtype)
    assert K.launch_counts()["qk_attention_short"] == 0


@pytest.mark.parametrize("misfit", ["stride", "bias", "n_32", "n_15"])
def test_k2_short_wrapper_raises_on_a_misfit(monkeypatch, misfit):
    """Token strides of no multiple of 16 bytes, a bias, or a length the
    route does not take raise before any launch."""
    lib = _RecordingLibrary()
    kw = dict(stride=dict(q_tok=68), bias=dict(bias=torch.zeros((2, 24, 24))),
              n_32=dict(n=32), n_15=dict(n=15))[misfit]
    with pytest.raises(ValueError):
        _short_call(monkeypatch, lib, **kw)
    assert lib.calls == [] and K.launch_counts()["qk_attention_short"] == 0


def test_qk_projection_wrappers_launch_and_count(monkeypatch):
    """gemm_nt_tc (q, kv) and gemm_residual_tc (the output product) on
    ffn_tc.cu: M, N, K and the strides as passed, each counted `qk_proj_tc`;
    a misfit (f32, a width of no multiple of 8) raises before any launch."""
    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    rows, dim, hd = 72, 64, 64
    x, w = torch.zeros((rows, dim), dtype=BF), torch.zeros((2 * hd, dim), dtype=BF)
    assert K.gemm_nt_tc(x, w).shape == (rows, 2 * hd)
    merged, wo = torch.zeros((rows, hd), dtype=BF), torch.zeros((dim, hd), dtype=BF)
    assert K.gemm_residual_tc(merged, wo, x).shape == (rows, dim)
    assert lib.names() == ["ct_ff_tc_gemm_nt", "ct_ff_tc_residual"]
    assert lib.calls[0][1][4:7] == (rows, 2 * hd, dim)
    assert lib.calls[1][1][4:7] == (rows, dim, hd)
    assert K.launch_counts()["qk_proj_tc"] == 2
    for bad in (x.float(), torch.zeros((rows, 68), dtype=BF)[:, :60]):
        with pytest.raises(ValueError):
            K.gemm_nt_tc(bad, w[:, :bad.shape[1]])
    with pytest.raises(ValueError):
        K.gemm_residual_tc(merged, wo, x[:, :56])
    assert len(lib.calls) == 2


# `sublayer_fits` reads as before this route: the short core's rows fit a
# CTA at every shape the gate gives it, so no answer moves
@pytest.mark.parametrize("n,d,bf16,f32", [
    (16, 32, True, True), (20, 32, True, True), (24, 32, True, True), (31, 32, True, True),
    (24, 16, True, True), (24, 64, True, True), (32, 32, True, True), (576, 32, True, True),
    (576, 64, False, False), (808, 16, True, False), (900, 32, False, False),
    (1071, 16, True, False), (1072, 16, False, False),
])
def test_sublayer_fit_reads_as_before(n, d, bf16, f32):
    from ct_clip_tpu_torch.ops.qknorm_attention import sublayer_fits

    assert sublayer_fits(n, d, BF) == bf16 and sublayer_fits(n, d, F32) == f32
    if K.qk_fwd_route(F32, n, d, 8) == K.QK_SHORT:
        assert K.qk_short_smem(n, 8, F32) <= K.SMEM_LIMIT
