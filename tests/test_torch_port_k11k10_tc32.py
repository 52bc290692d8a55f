"""The f32 backwards of K11 (the GEGLU feed-forward) and K10 (the temporal
QK-norm attention sublayer, grid and sequence-major) as the card runs them
since their products moved to 3xTF32 on `wgmma` (csrc/ffn_tc32.cu) and
K10's core to qknorm_attention_short.cu's f32 backward: the arithmetic
emulated on the CPU and held against `jax.vjp` of the JAX package's
`fused_geglu_ff`, `fused_small_qknorm_attention_grid` and
`fused_small_qknorm_attention` in f32 ("highest" products), and the routes
with the C library stubbed.

The emulation runs every product as ffn_tc32.cu does (`mm_tf32_ranges`:
operands split into TF32 hi and lo planes, hi lo + lo hi + hi hi per k8
slice, each 256-wide k range in an accumulator of its own), the weight
gradients ("TN": dY^T X over all rows) in the row splits of
`kernels.tc32_tn_split`, each split's k ranges in order, the splits added
in order (sum_splits), with the rows in the order of the transposed planes
(a grid's rows in the order of its t-columns); K11's tile's GEGLU
derivative and K10's attention core in f32 (the core: the plain version of
its math, `qk_attention_bwd_core_plain`, nothing rounded), the LayerNorm
backward in f32.  Tolerances: dx within 1e-5 of max|JAX| (the card's
TC32_REL_TOL), the sums over all rows (dscale, dbias, dgamma, the weights'
and scales' gradients) within 1e-4; every product in plain TF32 (hi hi
alone) must miss.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_port_k2_short import _RecordingLibrary, _stub_card, _weights
from test_torch_port_tf32 import mm_tf32_ranges

from ct_clip_tpu_torch.ops import kernels as K

BF, F32 = torch.bfloat16, torch.float32
DX_TOL, SUM_TOL = 1e-5, 1e-4


def _vjp_highest(fn, primals, do):
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jax.jit(fn), *map(jnp.asarray, primals))
        return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got.detach().numpy().astype(np.float64) - ref).max() / np.abs(ref).max())


def mm_emulated(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as ffn_tc32.cu's products sum it in `passes`-TF32
    (`mm_tf32_ranges`); passes 0: exact f32 products (the plain version)."""
    return a @ b if passes == 0 else mm_tf32_ranges(a, b, passes)


def tn_emulated(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a^T b over the rows of a (R, M) and b (R, N) as ffn_tc32.cu's TN form
    sums them: the rows in splits of `kernels.tc32_tn_split`, each split's
    256-row k ranges in accumulators of their own, the splits added in
    order."""
    rows, M = a.shape
    chunk = K.tc32_tn_split(rows, -(-M // 128) * -(-b.shape[1] // 128))
    out = torch.zeros((M, b.shape[1]))
    for r0 in range(0, rows, chunk):
        out = out + mm_emulated(a[r0:r0 + chunk].t(), b[r0:r0 + chunk], passes)
    return out


def _ln_vjp(x, scale, bias, dxn, eps=1e-5):
    """dx, dscale, dbias of the row LayerNorm at cotangent dxn, in f32."""
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y = torch.nn.functional.layer_norm(leaves[0], (x.shape[1],), leaves[1], leaves[2], eps)
    return torch.autograd.grad(y, leaves, dxn)


# ------------------------------------------------------------------ K11 f32
def k11_tc32_emulated(x, scale, bias, wi, wo, dout, passes: int, eps: float = 1e-5):
    """(dx, dscale, dbias, dwi, dwo) as `ops/ffn.py::_geglu_ff_bwd_tc32`
    computes them: the inner width padded to a multiple of 8 with zero
    weight rows; the tile's a, g, dact in `passes`-TF32 and act, da, dg in
    f32 with the exact erf; dxn = [da | dg] [wa; wg] (the NN form, K = 2
    padded); [dwa; dwg] = dcat^T xn and dwo = dout^T act on the TN form."""
    rows, dim = x.shape
    inner = wo.shape[1]
    P = -(-inner // 8) * 8

    def pad(w):
        return torch.cat([w, torch.zeros((P - w.shape[0], dim))])
    wa, wg, wo_t = pad(wi[:inner]), pad(wi[inner:]), pad(wo.t())
    xn = torch.nn.functional.layer_norm(x, (dim,), scale, bias, eps)
    a = mm_tf32_ranges(xn, wa.t(), passes)
    g = mm_tf32_ranges(xn, wg.t(), passes)
    dact = mm_tf32_ranges(dout, wo_t.t(), passes)
    phi = 0.5 * (1.0 + torch.erf(g * 0.70710678118654752))
    gelu = g * phi
    pdf = torch.exp(-0.5 * g * g) * 0.3989422804014327
    act, dcat = a * gelu, torch.cat([dact * gelu, dact * a * (phi + g * pdf)], 1)
    dxn = mm_tf32_ranges(dcat, torch.cat([wa, wg]), passes)
    dx, dscale, dbias = _ln_vjp(x, scale, bias, dxn, eps)
    dwcat = tn_emulated(dcat, xn, passes)
    dwi = torch.cat([dwcat[:inner], dwcat[P:P + inner]])
    return dx + dout, dscale, dbias, dwi, tn_emulated(dout, act, passes)[:, :inner]


@pytest.fixture(scope="module")
def k11_case():
    """600 rows of width 128 (inner 341, padded 344), numpy-seeded, and
    `jax.vjp` of the JAX package's `fused_geglu_ff` (residual folded in) in
    f32: (port inputs, JAX gradients in the port's layouts)."""
    from ct_clip_tpu.ops.pallas.ffn import fused_geglu_ff

    rng = np.random.RandomState(2121)
    rows, dim = 600, 128
    inner = int(4 * (2.0 / 3.0) * dim)
    a = [rng.randn(rows, dim), 1 + 0.2 * rng.randn(dim), 0.1 * rng.randn(dim),
         rng.randn(dim, inner) / np.sqrt(dim), rng.randn(dim, inner) / np.sqrt(dim),
         rng.randn(inner, dim) / np.sqrt(inner)]
    a = [np.asarray(v, np.float32) for v in a]
    do = rng.randn(rows, dim).astype(np.float32)
    dx, ds, db, dwa, dwg, dwo = _vjp_highest(
        lambda *p: fused_geglu_ff(*p, 1e-5, True), a, do)
    t = [torch.from_numpy(v) for v in a]
    port = (t[0], t[1], t[2], torch.cat([t[3], t[4]], 1).t().contiguous(),
            t[5].t().contiguous(), torch.from_numpy(do))
    return port, (dx, ds, db, np.concatenate([dwa.T, dwg.T]), dwo.T)


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "plain_tf32"])
def test_k11_f32_tc32_backward_against_jax(k11_case, passes):
    """The tile, NN and TN forms in 3xTF32 land dx within 1e-5 of max|JAX|
    and the sums over all rows within 1e-4; in plain TF32 dx misses."""
    port, ref = k11_case
    errs = [_rel(g, r) for g, r in zip(k11_tc32_emulated(*port, passes), ref)]
    if passes == 3:
        assert errs[0] <= DX_TOL and max(errs[1:]) <= SUM_TOL, f"3xTF32 K11: {errs}"
    else:
        assert errs[0] > DX_TOL, f"plain TF32 K11 reads {errs}, within the tolerance"


# --------------------------------------------------------- K10 grid / seq f32
def _seq_order(rows: int, n: int, S: int) -> torch.Tensor:
    """The rows of the transposed planes in order: column c = (b S + s) n + t
    holds row (b n + t) S + s (ffn_tc32.cu's tc32_split_t_kernel, the short
    core's columns); S = 1 keeps the order."""
    c = torch.arange(rows)
    sq, t = c // n, c % n
    return ((sq // S) * n + t) * S + sq % S


def k10_tc32_emulated(x, gamma, wq, wkv, q_scale, k_scale, wout, dout, heads: int,
                      grid: bool, passes: int):
    """(dx, dgamma, dwq, dwkv, dq_scale, dk_scale, dwout) as
    `ops/qknorm_attention.py::_qknorm_attention_bwd_tc32` computes them on
    the short route: q, kv and dmerged = dO wout in `passes`-TF32, the core
    in true f32 on the sequences (`qk_attention_bwd_core_plain`), dxn = dq
    wq and dx_kv = dkv wkv (NN), the LN backward, and the three weight
    gradients on the TN form over the rows in the transposed planes' order
    (`passes` 0: every product exact f32)."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain

    dim, d = x.shape[-1], 32
    n, S = (x.shape[1], x.shape[2]) if grid else (x.shape[1], 1)
    x2, do2 = x.reshape(-1, dim), dout.reshape(-1, dim)
    rows = x2.shape[0]
    order = _seq_order(rows, n, S)
    xn = torch.nn.functional.layer_norm(x2, (dim,), gamma, None, 1e-5)
    q = mm_emulated(xn, wq.t(), passes)
    kv = mm_emulated(x2, wkv.t(), passes)
    dm = mm_emulated(do2, wout, passes)
    merged, dq_s, dkv_s, dqs, dks, _ = qk_attention_bwd_core_plain(
        q[order], kv[order], dm[order], heads, d, n, q_scale * 8.0, k_scale, None)
    dq, dkv = torch.empty_like(dq_s), torch.empty_like(dkv_s)
    dq[order], dkv[order] = dq_s, dkv_s
    dxn = mm_emulated(dq, wq, passes)
    dx_kv = mm_emulated(dkv, wkv, passes)
    dx, dgamma, _ = _ln_vjp(x2, gamma, torch.zeros(dim), dxn)
    return ((dx + dx_kv + do2).reshape(x.shape), dgamma, tn_emulated(dq_s, xn[order], passes),
            tn_emulated(dkv_s, x2[order], passes), dqs * 8.0, dks,
            tn_emulated(do2[order], merged, passes))


# (layout, shape): a grid of 16 t-columns of 24 tokens, 32 sequences of 16,
# 24 of 20: 384, 512 and 480 rows (two TN splits each)
K10_SHAPES = (("grid", (1, 24, 16, 64)), ("seq", (32, 16, 64)), ("seq", (24, 20, 64)))
K10_IDS = [f"{form}_n{shape[1]}" for form, shape in K10_SHAPES]


@pytest.fixture(scope="module")
def k10_cases():
    """For each of K10_SHAPES (width 64, 2 heads of 32): port inputs and
    `jax.vjp` of the JAX package's sublayer (`fused_small_qknorm_attention_grid`
    on the grid, `fused_small_qknorm_attention` on sequences) in f32 with the
    residual, its gradients in the port's layouts."""
    from ct_clip_tpu.ops.pallas.small_attention import (fused_small_qknorm_attention,
                                                        fused_small_qknorm_attention_grid)

    dim, heads, dh = 64, 2, 32
    hd, out = heads * dh, []
    for i, (form, shape) in enumerate(K10_SHAPES):
        rng = np.random.RandomState(2141 + i)
        x, do = (rng.randn(*shape).astype(np.float32) for _ in range(2))
        w = [1 + 0.1 * rng.randn(dim), rng.randn(dim, hd) / np.sqrt(dim),
             rng.randn(dim, 2 * hd) / np.sqrt(dim), 1 + 0.3 * rng.rand(dh),
             1 + 0.3 * rng.rand(dh), rng.randn(hd, dim) / np.sqrt(hd)]
        w = [np.asarray(a, np.float32) for a in w]
        fn = fused_small_qknorm_attention_grid if form == "grid" else \
            fused_small_qknorm_attention
        ref = _vjp_highest(lambda *p: fn(*p, heads, dh, 8.0, jnp.float32, True), [x] + w, do)
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
             (x, w[0], w[1].T, w[2].T, w[3], w[4], w[5].T, do)]
        out.append((t, [ref[0], ref[1], ref[2].T, ref[3].T, ref[4], ref[5], ref[6].T]))
    return out


@pytest.mark.parametrize("passes", [3, 1], ids=["3xtf32", "plain_tf32"])
@pytest.mark.parametrize("case", range(len(K10_SHAPES)), ids=K10_IDS)
def test_k10_f32_tc32_backward_against_jax(k10_cases, case, passes):
    """The f32 sublayer backward with its products in 3xTF32 and the core in
    true f32 lands dx within 1e-5 of max|JAX| and the sums within 1e-4; with
    plain-TF32 products dx misses."""
    port, ref = k10_cases[case]
    grid = K10_SHAPES[case][0] == "grid"
    errs = [_rel(g, r) for g, r in zip(k10_tc32_emulated(*port, 2, grid, passes), ref)]
    if passes == 3:
        assert errs[0] <= DX_TOL and max(errs[1:]) <= SUM_TOL, f"3xTF32 K10: {errs}"
    else:
        assert errs[0] > DX_TOL, f"plain TF32 K10 reads {errs}, within the tolerance"


@pytest.mark.parametrize("case", range(len(K10_SHAPES)), ids=K10_IDS)
def test_k10_f32_core_plain_against_jax(k10_cases, case):
    """The plain version of the short core's math in f32, inside the plain
    f32 sublayer (every product exact f32): within 1e-5 of max|JAX| for dx,
    1e-4 for the sums."""
    port, ref = k10_cases[case]
    grid = K10_SHAPES[case][0] == "grid"
    errs = [_rel(g, r) for g, r in zip(k10_tc32_emulated(*port, 2, grid, 0), ref)]
    assert errs[0] <= DX_TOL and max(errs[1:]) <= SUM_TOL, f"f32 K10: {errs}"


def test_seq_order_is_the_t_column_order():
    """Transposed column (b S + s) n + t holds token t of t-column s of grid
    row b: the column order of the short core's sequences (sequence b S +
    s), so the TN products' two operands pair the same rows."""
    b, n, S = 2, 3, 4
    rows = torch.arange(b * n * S).reshape(b, n, S)
    want = rows.transpose(1, 2).reshape(-1)  # (b, S, t)
    assert torch.equal(_seq_order(b * n * S, n, S), want)
    assert torch.equal(_seq_order(12, 3, 1), torch.arange(12))


# --------------------------------------------------------------- the routes
# (dtype, n, head dim, heads, bias) -> the backward core's route; the
# forward's route beside it, which this gate does not move
@pytest.mark.parametrize("dtype,n,d,heads,bias,bwd,fwd", [
    (F32, 24, 32, 8, False, K.QK_SHORT, K.QK_SHORT),       # K10 grid f32: t 24
    (F32, 20, 32, 8, False, K.QK_SHORT, K.QK_SHORT),       # K10 seq f32: the autoencoder's 20
    (F32, 16, 32, 8, False, K.QK_SHORT, K.QK_SHORT),       # K10 seq f32: 160 frames, t 16
    (F32, 31, 32, 8, False, K.QK_SHORT, K.QK_SHORT),
    (BF, 24, 32, 8, False, K.QK_SHORT, K.QK_SHORT),        # bf16 K10 takes the short core too
    (BF, 16, 32, 8, False, K.QK_SHORT, K.QK_SHORT),
    (F32, 15, 32, 8, False, K.QK_CUDA_CORES, K.QK_CUDA_CORES),  # below the route
    (F32, 24, 32, 8, True, K.QK_CUDA_CORES, K.QK_CUDA_CORES),   # a bias
    (F32, 24, 64, 8, False, K.QK_CUDA_CORES, K.QK_CUDA_CORES),  # another head dim
    (F32, 24, 32, 14, False, K.QK_SHORT, K.QK_SHORT),
    (F32, 31, 32, 16, False, K.QK_SHORT, K.QK_SHORT),      # a CTA takes four heads at a time
    (F32, 31, 32, 40, False, K.QK_SHORT, K.QK_CUDA_CORES),  # the forward's rows outgrow a CTA
    (F32, 576, 32, 8, True, K.QK_TC32, K.QK_TC32),         # K9 f32's planes
    (F32, 64, 32, 8, True, K.QK_TC32, K.QK_TC32),
    (BF, 576, 32, 8, True, K.QK_WGMMA, K.QK_WGMMA),        # K9 bf16's
    (torch.float16, 24, 32, 8, False, K.QK_CUDA_CORES, K.QK_CUDA_CORES),
])
def test_qk_backward_route_table(dtype, n, d, heads, bias, bwd, fwd):
    assert K.qk_bwd_route(dtype, n, d, heads, bias) == bwd
    assert K.qk_fwd_route(dtype, n, d, heads, bias) == fwd
    if bwd == K.QK_SHORT:
        assert K.qk_short_bwd_smem(n, heads) <= K.SMEM_LIMIT
    if n >= K.QK_TC_MIN_TOKENS:  # from 32 tokens the one gate of both directions
        assert bwd == K.qk_bwd_tensor_cores(dtype, n, d)


def test_short_backward_route_needs_its_rows_to_fit(monkeypatch):
    """The short backward core is taken only where a CTA's shared memory
    holds its rows; elsewhere the CUDA-core kernel keeps the shape."""
    assert K.qk_bwd_route(F32, 24, 32, 8) == K.QK_SHORT
    monkeypatch.setattr(K, "SMEM_LIMIT", K.qk_short_bwd_smem(24, 8) - 1)
    assert K.qk_bwd_route(F32, 24, 32, 8) == K.QK_CUDA_CORES
    assert K.qk_bwd_route(F32, 16, 32, 8) == K.QK_SHORT


def test_tc32_tn_split_rows():
    """TN splits: whole 256-row k ranges, at most 8,192 rows, enough CTAs."""
    for rows, tiles, chunk in ((110592, 88, 7936), (110592, 44, 7936), (10240, 88, 3584),
                               (10240, 44, 1792), (384, 1, 256), (300, 6, 256)):
        got = K.tc32_tn_split(rows, tiles)
        assert got == chunk and got % K.TC32_FLUSH_ROWS == 0
        splits = -(-rows // got)
        assert got <= K.TC32_TN_SPLIT_ROWS and splits * got >= rows > (splits - 1) * got


# ------------------------------------------------- launches, C library stubbed
def test_k11_f32_backward_launches_the_tc32_forms(monkeypatch):
    """K11 f32 launches the weight and operand splits, LN written split, the
    3xTF32 tile, one NN and two TN products and the LN backward, counted
    `ff_tc32_tile`, `tc32_gemm` and `tc32_gemm_tn` beside
    `geglu_ff_bwd(_f32)`: nothing of gemm.cu's FFMA forms."""
    from ct_clip_tpu_torch.ops import ffn

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    rows, dim, inner = 40, 64, 170
    x = torch.zeros((rows, dim))
    grads = ffn._geglu_ff_bwd_cuda(x, torch.ones(dim), torch.zeros(dim),
                                   torch.zeros((2 * inner, dim)), torch.zeros((dim, inner)),
                                   torch.zeros_like(x), 1e-5)
    assert [tuple(g.shape) for g in grads] == [(rows, dim), (dim,), (dim,), (2 * inner, dim),
                                               (dim, inner)]
    assert lib.names() == ["ct_tc32_split_t", "ct_tc32_split_t", "ct_layernorm_split_f32",
                           "ct_tc32_split_t", "ct_tc32_split_t", "ct_ff_tc32_tile",
                           "ct_tc32_gemm", "ct_layernorm_bwd_f32", "ct_tc32_gemm_tn",
                           "ct_tc32_gemm_tn"]
    tile = lib.calls[5][1]
    assert tile[12:15] == (rows, 176, dim) and tile[-2] == rows  # M, padded inner, K; ldt
    c = K.launch_counts()
    assert (c["ff_tc32_tile"], c["tc32_gemm"], c["tc32_gemm_tn"]) == (1, 1, 2)
    assert c["geglu_ff_bwd"] == c["geglu_ff_bwd_f32"] == 1
    assert c["ff_tc_tile"] == c["ff_tc_gemm"] == 0
    assert [tuple(a[6:9]) for n, a in lib.calls if n == "ct_tc32_gemm_tn"] == [
        (352, dim, rows), (dim, 176, rows)]  # [dwa; dwg], dwo; K = the rows


def test_k11_f32_misfits_and_refusals_raise(monkeypatch):
    """A width TMA cannot take raises before any launch; a launch the card
    refuses raises (no fallback)."""
    from ct_clip_tpu_torch.ops import ffn

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    with pytest.raises(ValueError):
        ffn._geglu_ff_bwd_cuda(torch.zeros((40, 66)), torch.ones(66), torch.zeros(66),
                               torch.zeros((2 * 170, 66)), torch.zeros((66, 170)),
                               torch.zeros((40, 66)), 1e-5)
    refusing = _RecordingLibrary(fail="ct_ff_tc32_tile")
    _stub_card(monkeypatch, refusing)
    with pytest.raises(RuntimeError, match="ct_ff_tc32_tile"):
        ffn._geglu_ff_bwd_cuda(torch.zeros((40, 64)), torch.ones(64), torch.zeros(64),
                               torch.zeros((2 * 170, 64)), torch.zeros((64, 170)),
                               torch.zeros((40, 64)), 1e-5)
    assert K.launch_counts()["ff_tc32_tile"] == 0


@pytest.mark.parametrize("shape,grid", [((2, 24, 9, 64), True), ((5, 20, 64), False),
                                        ((7, 16, 64), False)])
def test_k10_f32_backward_launches_the_short_core(monkeypatch, shape, grid):
    """K10 f32 (grid and seq) launches the short backward core once, counted
    `qk_attention_short_bwd_f32`, and every product in 3xTF32 (five
    plain-store, three TN), the transposed planes in the t-column order of
    the grid: nothing on qknorm_attention_bwd.cu or gemm.cu."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    x = torch.zeros(shape)
    grads = Q._qknorm_attention_bwd_cuda(x, *_weights(64, 2, 32), None, torch.zeros_like(x), 2,
                                         32, 8.0, grid)
    assert grads[0].shape == x.shape and grads[-1] is None
    assert [tuple(g.shape) for g in grads[1:7]] == [(64,), (64, 64), (128, 64), (32,), (32,),
                                                    (64, 64)]
    names = lib.names()
    assert names.count("ct_qk_attention_short_bwd_f32") == 1
    assert names.count("ct_tc32_gemm") == 5 and names.count("ct_tc32_gemm_tn") == 3
    assert not any(n in names for n in ("ct_qk_attention_bwd_f32", "ct_gemm_f32",
                                        "ct_gemm_layout_f32", "ct_qk_attention_tc32_bwd"))
    n, S = (shape[1], shape[2]) if grid else (shape[1], 1)
    rows = x.numel() // 64
    splits = [a for nm, a in lib.calls if nm == "ct_tc32_split_t"]
    # the weights (in order), then x, LN(x) and dO in the core's column order
    assert [a[5:7] for a in splits] == [(1, 1), (1, 1), (n, S), (n, S), (n, S)]
    core = dict(lib.calls)["ct_qk_attention_short_bwd_f32"]
    assert core[13] == -(-rows // 4) * 4 and core[22:27] == (S, rows // n, 2, n, 32)
    c = K.launch_counts()
    assert (c["qk_attention_short_bwd_f32"], c["tc32_gemm"], c["tc32_gemm_tn"]) == (1, 5, 3)
    assert c["qk_proj_gemm"] == c["qk_attention_tc32_bwd"] == 0


def test_k9_f32_backward_products_in_3xtf32(monkeypatch):
    """K9 f32 (a bias, n >= 32) keeps its 3xTF32 core and takes the same
    3xTF32 products, its f32 outputs split by tc32_split_t."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    x = torch.zeros((3, 64, 64))
    grads = Q._qknorm_attention_bwd_cuda(x, *_weights(64, 2, 32), torch.zeros((2, 64, 64)),
                                         torch.zeros_like(x), 2, 32, 8.0, False)
    assert grads[-1].shape == (2, 64, 64)
    names = lib.names()
    assert names.count("ct_qk_attention_tc32_bwd") == 1 and names.count("ct_tc32_split_t") == 8
    assert names.count("ct_tc32_gemm") == 5 and names.count("ct_tc32_gemm_tn") == 3
    assert "ct_gemm_f32" not in names and "ct_gemm_layout_f32" not in names
    c = K.launch_counts()
    assert (c["qk_attention_tc32_bwd"], c["tc32_gemm"], c["tc32_gemm_tn"]) == (1, 5, 3)


def test_short_backward_core_misfits_and_refusals_raise(monkeypatch):
    """The short backward core takes only its route's shapes; a refused
    launch raises."""
    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    heads, d = 2, 32
    hd = heads * d

    def call(n, dtype=F32, S=3):
        q, dout = torch.zeros((S * n, hd), dtype=dtype), torch.zeros((S * n, hd), dtype=dtype)
        kv = torch.zeros((S * n, 2 * hd), dtype=dtype)
        return K.qk_attention_short_bwd(q, kv, dout, sequences=S, inner=1, heads=heads, n=n,
                                        d=d, q_strides=(n * hd, 0, d, hd),
                                        kv_strides=(n * 2 * hd, 0, d, 2 * hd),
                                        q_scale=torch.ones(d), k_scale=torch.ones(d))
    out = call(24)
    assert len(out) == 12 and out[4].shape == (hd, 72) and out[8].shape == (2 * hd, 72)
    assert out[10].shape == out[11].shape == (d,)
    assert K.launch_counts()["qk_attention_short_bwd_f32"] == 1
    for bad in (dict(n=12), dict(n=32), dict(n=24, dtype=BF)):
        with pytest.raises(ValueError):
            call(**bad)
    _stub_card(monkeypatch, _RecordingLibrary(fail="ct_qk_attention_short_bwd_f32"))
    with pytest.raises(RuntimeError):
        call(24)
    assert K.launch_counts()["qk_attention_short_bwd_f32"] == 0
