"""K10 bf16 (the temporal QK-norm attention backward, grid and
sequence-major) on the short route and K5's exact assignment (bf16 and f32
rows) on vq_tc.cu, on the CPU: their plain versions against the JAX
package's Pallas kernels in interpret mode, and the routes and launches
with the C library stubbed.

K10 bf16 follows small_attention.py::_bwd_kernel's own rounding points
(`small_qknorm_bwd_plain`): q, kv and dmerged f32, the (n, n) core in f32,
dq, dkv and merged rounded once.  Against `_pallas_small_qknorm_bwd` in bf16
every gradient lands within K10_MAX_TOL of max|JAX| and, the check that
tells two sets of rounding points apart, within K10_MEAN_TOL of mean|JAX| on
average; the points the port took before (K9's: q, kv and dmerged rounded
to bf16, qn, kn, P and dS rounded inside the core) pass the max but miss
the mean.  K5 exact: ids equal to `pallas_assign(exact=True)`'s where the
best code leads by a clear margin, and the f32 rows' bf16 split equal to
the JAX kernel's bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_port_k2_short import _RecordingLibrary, _stub_card, _weights

from ct_clip_tpu_torch.ops import kernels as K

BF, F32 = torch.bfloat16, torch.float32
K10_MAX_TOL = 2e-2   # of max|JAX|, each gradient (bf16 outputs: a few ulps)
K10_MEAN_TOL = 5e-4  # of mean|JAX|, each gradient: the TPU's rounding points


@pytest.fixture(scope="module")
def pallas_interpret():
    from ct_clip_tpu.ops.pallas import _call

    _call.set_interpret(True)
    jax.clear_caches()  # plans are resolved at trace time
    yield
    _call.set_interpret(False)
    jax.clear_caches()


def _errors(got, ref):
    """(max |got - ref| / max |ref|, mean |got - ref| / mean |ref|)."""
    d = np.abs(got.detach().float().numpy().astype(np.float64) - ref)
    return d.max() / np.abs(ref).max(), d.mean() / np.abs(ref).mean()


# (layout, shape): a grid of 16 t-columns of 24 tokens, sequences of 16 and
# of 24 (the JAX kernel's plan takes n a multiple of 8); width 128, 4 heads
K10_SHAPES = (("grid", (1, 24, 16, 128)), ("seq", (32, 16, 128)), ("seq", (16, 24, 128)))
K10_IDS = [f"{form}_n{shape[1]}" for form, shape in K10_SHAPES]


@pytest.fixture(scope="module")
def k10_bf16_cases(pallas_interpret):
    """For each of K10_SHAPES: the port's bf16 inputs and the JAX package's
    `_pallas_small_qknorm_bwd` in bf16 (interpret mode, residual=True) on the
    same values, its gradients in the port's layouts."""
    from ct_clip_tpu.ops.pallas.small_attention import (_pallas_small_qknorm_bwd, _plan_bwd,
                                                        _plan_grid_bwd)

    dim, heads, dh = 128, 4, 32
    hd, out = heads * dh, []
    for i, (form, shape) in enumerate(K10_SHAPES):
        rng = np.random.RandomState(2251 + i)
        x, do = (jnp.asarray(rng.randn(*shape), jnp.bfloat16) for _ in range(2))
        w = [1 + 0.1 * rng.randn(dim), rng.randn(dim, hd) / np.sqrt(dim),
             rng.randn(dim, 2 * hd) / np.sqrt(dim), 1 + 0.3 * rng.rand(dh),
             1 + 0.3 * rng.rand(dh), rng.randn(hd, dim) / np.sqrt(hd)]
        w = [np.asarray(a, np.float32) for a in w]
        grid = form == "grid"
        g = (_plan_grid_bwd(*shape[:3], dim, heads, dh) if grid
             else _plan_bwd(*shape[:2], dim, heads, dh))
        assert g is not None
        ref = _pallas_small_qknorm_bwd(x, *map(jnp.asarray, w), do, g, heads=heads,
                                       dim_head=dh, scale=8.0, dtype=jnp.bfloat16,
                                       residual=True, grid_layout=grid)
        ref = [np.asarray(r, np.float64) for r in ref]
        bf = [torch.from_numpy(np.array(a, np.float32)).to(BF) for a in (x, do)]
        port = [bf[0]] + [torch.from_numpy(np.ascontiguousarray(a)) for a in
                          (w[0], w[1].T, w[2].T, w[3], w[4], w[5].T)] + [bf[1]]
        out.append((port, grid, [ref[0], ref[1], ref[2].T, ref[3].T, ref[4], ref[5],
                                 ref[6].T]))
    return out


def k9_points_bwd(x, gamma, wq, wkv, q_scale, k_scale, wout, dout, heads: int, dh: int,
                  scale: float, grid: bool):
    """K10 bf16's backward at the rounding points the port's CUDA path took
    before (K9's, `qk_attention_bwd_core_plain` in bf16): q, kv and dmerged
    rounded to bf16, qn, kn, P and dS rounded inside the core; the rest as
    `small_qknorm_bwd_plain`."""
    from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain

    dt, dim = x.dtype, x.shape[-1]
    xs, ds = (x.transpose(1, 2), dout.transpose(1, 2)) if grid else (x, dout)
    n = xs.shape[-2]
    x2, do2 = xs.reshape(-1, dim), ds.reshape(-1, dim)
    xf = x2.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + 1e-5)
    xhat = xc * rstd
    xn = (xhat * gamma).to(dt)
    wq_f, wkv_f, wout_f = (w.to(dt).float() for w in (wq, wkv, wout))
    q, kv = (xn.float() @ wq_f.t()).to(dt), (xf @ wkv_f.t()).to(dt)
    dm = (do2.float() @ wout_f).to(dt)
    merged, dq, dkv, dqs, dks, _ = qk_attention_bwd_core_plain(
        q, kv, dm, heads, dh, n, q_scale * scale, k_scale, None)
    dxn, dx_kv = dq.float() @ wq_f, dkv.float() @ wkv_f
    dxhat = dxn * gamma
    m1, m2 = dxhat.mean(dim=-1, keepdim=True), (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (dxhat - m1 - xhat * m2) + dx_kv + do2.float()).to(dt).view(xs.shape)
    if grid:
        dx = dx.transpose(1, 2)
    return (dx, (dxn * xhat).sum(0), dq.float().t() @ xn.float(), dkv.float().t() @ xf,
            dqs * scale, dks, do2.float().t() @ merged.float())


@pytest.mark.parametrize("case", range(len(K10_SHAPES)), ids=K10_IDS)
def test_k10_bf16_plain_backward_against_jax(k10_bf16_cases, case):
    """The plain K10 bf16 backward at `_bwd_kernel`'s points against the
    JAX kernel in bf16: dx, dgamma, dWq, dWkv, dq_scale, dk_scale and dWout
    each within K10_MAX_TOL of max|JAX| and K10_MEAN_TOL of mean|JAX|."""
    from ct_clip_tpu_torch.ops.qknorm_attention import small_qknorm_bwd_plain

    port, grid, ref = k10_bf16_cases[case]
    got = small_qknorm_bwd_plain(*port, 4, 32, 8.0, grid)
    assert got[0].dtype == BF and got[0].shape == port[0].shape
    errs = [_errors(g, r) for g, r in zip(got, ref)]
    assert all(mx <= K10_MAX_TOL and mean <= K10_MEAN_TOL for mx, mean in errs), errs


@pytest.mark.parametrize("case", range(len(K10_SHAPES)), ids=K10_IDS)
def test_k10_bf16_k9_points_miss_the_mean_tolerance(k10_bf16_cases, case):
    """K9's rounding points, which the port's bf16 K10 took before, pass the
    max tolerance but miss the mean one on every gradient: the check that
    shows the fault."""
    port, grid, ref = k10_bf16_cases[case]
    errs = [_errors(g, r) for g, r in zip(k9_points_bwd(*port, 4, 32, 8.0, grid), ref)]
    assert all(mx <= K10_MAX_TOL for mx, _ in errs), errs
    assert all(mean > K10_MEAN_TOL for _, mean in errs), errs


def test_k10_bf16_core_plain_rounds_only_its_outputs():
    """The plain version of the short core's bf16 form is the f32 core with
    merged, dq and dkv rounded to bf16 once; its scale sums are the f32
    core's."""
    from ct_clip_tpu_torch.ops.qknorm_attention import (qk_attention_bwd_core_plain,
                                                        qk_short_bwd_core_plain)

    g = torch.Generator().manual_seed(7)
    S, n, heads, d = 6, 20, 2, 32
    q, dout = (torch.randn((S * n, heads * d), generator=g) for _ in range(2))
    kv = torch.randn((S * n, 2 * heads * d), generator=g)
    qs, ks = 1 + torch.rand(d, generator=g), 1 + torch.rand(d, generator=g)
    got = qk_short_bwd_core_plain(q, kv, dout, heads, d, n, qs * 8.0, ks)
    want = qk_attention_bwd_core_plain(q, kv, dout, heads, d, n, qs * 8.0, ks, None)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == BF and torch.equal(a, b.to(BF))
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])


# --------------------------------------------------------------- the routes
@pytest.mark.parametrize("dtype,n,d,heads,bias,route", [
    (BF, 24, 32, 8, False, K.QK_SHORT),      # K10 grid bf16: CT-CLIP's t 24
    (BF, 20, 32, 8, False, K.QK_SHORT),      # K10 seq bf16: the autoencoder's 20
    (BF, 16, 32, 8, False, K.QK_SHORT),      # K10 seq bf16: 160 frames, t 16
    (BF, 31, 32, 16, False, K.QK_SHORT),
    (BF, 15, 32, 8, False, K.QK_CUDA_CORES),  # below the route
    (BF, 24, 32, 8, True, K.QK_CUDA_CORES),   # a bias
    (BF, 24, 64, 8, False, K.QK_CUDA_CORES),  # another head dim
    (BF, 576, 32, 8, True, K.QK_WGMMA),       # K9 bf16's planes
    (torch.float16, 24, 32, 8, False, K.QK_CUDA_CORES),
])
def test_k10_bf16_backward_route_table(dtype, n, d, heads, bias, route):
    assert K.qk_bwd_route(dtype, n, d, heads, bias) == route


def test_k10_bf16_short_route_needs_its_rows_to_fit(monkeypatch):
    """bf16 reads the same f32 rows as f32: the same shared-memory gate."""
    assert K.qk_bwd_route(BF, 24, 32, 8) == K.QK_SHORT
    monkeypatch.setattr(K, "SMEM_LIMIT", K.qk_short_bwd_smem(24, 8) - 1)
    assert K.qk_bwd_route(BF, 24, 32, 8) == K.QK_CUDA_CORES


@pytest.mark.parametrize("shape,grid", [((2, 24, 9, 64), True), ((5, 20, 64), False)],
                         ids=["grid", "seq"])
def test_k10_bf16_backward_launches_the_short_core(monkeypatch, shape, grid):
    """K10 bf16 launches the short core's bf16 form once (counted
    `qk_attention_short_bwd`) and every product on ffn_tc.cu: q and kv on
    the f32-store NT form, dmerged, dxn and dx_kv on the NN form (f32 out),
    the three weight gradients on the TN form; nothing of gemm.cu's
    gemm_layout or qknorm_attention_bwd.cu."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    x = torch.zeros(shape, dtype=BF)
    grads = Q._qknorm_attention_bwd_cuda(x, *_weights(64, 2, 32), None, torch.zeros_like(x), 2,
                                         32, 8.0, grid)
    assert grads[0].shape == x.shape and grads[0].dtype == BF and grads[-1] is None
    assert [tuple(g.shape) for g in grads[1:7]] == [(64,), (64, 64), (128, 64), (32,), (32,),
                                                    (64, 64)]
    names = lib.names()
    assert names == ["ct_layernorm", "ct_ff_tc_gemm_nt_f32", "ct_ff_tc_gemm_nt_f32",
                     "ct_ff_tc_gemm", "ct_qk_attention_short_bwd", "ct_ff_tc_gemm",
                     "ct_ff_tc_gemm", "ct_layernorm_bwd", "ct_ff_tc_gemm", "ct_ff_tc_gemm",
                     "ct_ff_tc_gemm"]
    layouts = [a[0] for nm, a in lib.calls if nm == "ct_ff_tc_gemm"]
    assert layouts == [0, 0, 0, 1, 1, 1]  # dmerged, dxn, dx_kv f32; the TN weight gradients
    n, S = (shape[1], shape[2]) if grid else (shape[1], 1)
    rows = x.numel() // 64
    core = dict(lib.calls)["ct_qk_attention_short_bwd"]
    assert core[14:19] == (S, rows // n, 2, n, 32)  # inner, sequences, heads, n, d
    c = K.launch_counts()
    assert (c["qk_attention_short_bwd"], c["qk_proj_tc"], c["ff_tc_gemm"]) == (1, 2, 6)
    assert c["qk_attention_short_bwd_f32"] == c["qk_proj_gemm"] == 0


def test_k9_bf16_backward_products_on_ffn_tc(monkeypatch):
    """K9 bf16 (a bias, n >= 32) keeps its tensor-core core and rounding
    points; its six products run on ffn_tc.cu: dmerged on the NN form
    storing bf16 (layout 2), dxn and dx_kv on the NN form, the weight
    gradients on the TN form; nothing on gemm.cu."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    x = torch.zeros((3, 64, 64), dtype=BF)
    grads = Q._qknorm_attention_bwd_cuda(x, *_weights(64, 2, 32), torch.zeros((2, 64, 64)),
                                         torch.zeros_like(x), 2, 32, 8.0, False)
    assert grads[-1].shape == (2, 64, 64)
    names = lib.names()
    assert names.count("ct_qk_attention_tc_bwd") == 1 and names.count("ct_ff_tc_gemm") == 6
    assert not any(n in names for n in ("ct_gemm_layout", "ct_gemm", "ct_qk_attention_bwd"))
    assert [a[0] for nm, a in lib.calls if nm == "ct_ff_tc_gemm"] == [2, 0, 0, 1, 1, 1]
    c = K.launch_counts()
    assert (c["qk_attention_tc_bwd"], c["ff_tc_gemm"], c["qk_proj_tc"]) == (1, 6, 2)


def test_k9_bf16_products_keep_gemm_cu_where_tma_refuses(monkeypatch):
    """At a width ffn_tc.cu's TMA copies refuse (36), K9 bf16's products
    stay on gemm.cu's gemm_layout and K10 bf16 keeps the CUDA-core path."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    for shape, bias in (((3, 64, 36), torch.zeros((2, 64, 64))), ((5, 20, 36), None)):
        lib = _RecordingLibrary()
        _stub_card(monkeypatch, lib)
        x = torch.zeros(shape, dtype=BF)
        Q._qknorm_attention_bwd_cuda(x, *_weights(36, 2, 32), bias, torch.zeros_like(x), 2, 32,
                                     8.0, False)
        names = lib.names()
        assert names.count("ct_gemm_layout") == 6 and "ct_ff_tc_gemm" not in names
        assert "ct_qk_attention_short_bwd" not in names


def _short_core_call(n, S=3, heads=2, d=32, out_dtype=BF, tok=None):
    hd = heads * d
    tok = tok or hd
    q, dout = torch.zeros((S * n, hd)), torch.zeros((S * n, hd))
    kv = torch.zeros((S * n, 2 * hd))
    return K.qk_attention_short_bwd(q, kv, dout, sequences=S, inner=1, heads=heads, n=n, d=d,
                                    q_strides=(n * tok, 0, d, tok),
                                    kv_strides=(n * 2 * hd, 0, d, 2 * hd),
                                    q_scale=torch.ones(d), k_scale=torch.ones(d),
                                    out_dtype=out_dtype)


def test_short_backward_core_bf16_form_misfits_and_refusals_raise(monkeypatch):
    """The bf16 form takes only its route's shapes and strides of multiples
    of 8 elements; it returns merged, dq and dkv in bf16 and the two scale
    sums; a refused launch raises and counts nothing."""
    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    out = _short_core_call(24)
    assert len(out) == 5 and [t.dtype for t in out[:3]] == [BF] * 3
    assert out[0].shape == out[1].shape == (72, 64) and out[2].shape == (72, 128)
    assert out[3].shape == out[4].shape == (32,)
    assert K.launch_counts()["qk_attention_short_bwd"] == 1
    for bad in (dict(n=12), dict(n=32), dict(n=24, d=64), dict(n=24, tok=68),
                dict(n=24, out_dtype=torch.float16)):
        with pytest.raises(ValueError):
            _short_core_call(**bad)
    _stub_card(monkeypatch, _RecordingLibrary(fail="ct_qk_attention_short_bwd"))
    with pytest.raises(RuntimeError):
        _short_core_call(24)
    assert K.launch_counts()["qk_attention_short_bwd"] == 0


# ----------------------------------------------------------------- K5 exact
@pytest.mark.parametrize("misfit", ["width", "wide", "stride", "codes", "misaligned"])
def test_vq_assign_exact_tc_misfits_raise(monkeypatch, misfit):
    """vq_tc.cu's exact form takes widths of multiples of 8 up to 512, rows
    and codes of multiples of 16 bytes on 16-byte boundaries and hi / lo
    parts of one shape; anything else raises before a launch."""
    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    rows, dim, codes = 256, 64, 512
    x = torch.zeros((rows, dim), dtype=BF)
    hi, lo = torch.zeros((codes, dim), dtype=BF), torch.zeros((codes, dim), dtype=BF)
    if misfit == "width":
        x, hi, lo = x[:, :60], hi[:, :60].contiguous(), lo[:, :60].contiguous()
    elif misfit == "wide":
        x, hi, lo = (torch.zeros((t.shape[0], 520), dtype=BF) for t in (x, hi, lo))
    elif misfit == "stride":
        x = torch.zeros((rows, dim + 4), dtype=BF)[:, :dim]
    elif misfit == "codes":
        lo = lo[: codes // 2]
    else:
        x = torch.zeros(rows * dim + 1)[1:].view(rows, dim)  # f32 rows 4 bytes off
    with pytest.raises(ValueError):
        K.vq_assign_exact_tc(x, hi, lo)
    assert lib.calls == [] and K.launch_counts()["vq_assign_exact_tc"] == 0


@pytest.mark.parametrize("dtype,fail", [(BF, "ct_vq_assign_exact_tc"), (F32, "ct_vq_rows_bf16"),
                                        (F32, "ct_vq_assign_exact_tc")])
def test_vq_assign_exact_tc_refusals_raise(monkeypatch, dtype, fail):
    """A launch that reports a CUDA error raises, naming its entry, and adds
    no count; nothing gives way to gemm.cu.  On f32 rows the pre-pass
    writes both parts (its lo pointer set), and the kernel reads xl."""
    lib = _RecordingLibrary(fail=fail)
    _stub_card(monkeypatch, lib)
    x = torch.zeros((256, 64), dtype=dtype)
    hi, lo = torch.zeros((512, 64), dtype=BF), torch.zeros((512, 64), dtype=BF)
    with pytest.raises(RuntimeError, match=fail):
        K.vq_assign_exact_tc(x, hi, lo)
    assert lib.names()[-1] == fail and not any("gemm_argmax" in n for n in lib.names())
    assert K.launch_counts()["vq_assign_exact_tc"] == 0
    if dtype == F32:
        assert lib.calls[0][1][4] is not None  # the pre-pass's lo output
    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    K.vq_assign_exact_tc(x, hi, lo)
    assert (lib.calls[-1][1][1] is None) == (dtype == BF)  # xl: f32 rows only
    assert K.launch_counts()["vq_assign_exact_tc"] == 1


def _clear_margin_rows(rng, rows, dim, codes):
    """Rows near one code each (a clear top-1 margin) and the normalised
    codebook, f32."""
    embed = rng.randn(codes, dim).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    pick = rng.randint(0, codes, rows)
    x = (embed[pick] * (1 + rng.rand(rows, 1)) + 0.05 * rng.randn(rows, dim)).astype(np.float32)
    return x, embed


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k5_exact_plain_versions_against_pallas_assign(pallas_interpret, dtype):
    """K5 exact's plain versions as the card checks vq_tc.cu against them
    (bf16 rows: `vq_assign_plain(exact=True)`; f32 rows:
    `vq_assign_exact_rows_lane_plain`, the kernel's own row split) against
    `pallas_assign(exact=True)` in interpret mode: ids equal, every row's
    best code leading by a clear margin."""
    from ct_clip_tpu.ops.pallas.vq import pallas_assign
    from ct_clip_tpu_torch.ops.vq import vq_assign_exact_rows_lane_plain, vq_assign_plain

    rng = np.random.RandomState(22)
    rows, dim, codes = 512, 128, 256
    x, embed = _clear_margin_rows(rng, rows, dim, codes)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = np.asarray(pallas_assign(xj, jnp.asarray(embed), 128, exact=True))
    xt = torch.from_numpy(np.array(xj, np.float32))
    sims = torch.nn.functional.normalize(xt, dim=1) @ torch.from_numpy(embed).t()
    top = sims.topk(2, dim=1).values
    assert bool(((top[:, 0] - top[:, 1]) > 1e-2).all())  # a clear margin on every row
    if dtype == "bf16":
        got = vq_assign_plain(xt.to(BF), torch.from_numpy(embed), exact=True)
    else:
        got = vq_assign_exact_rows_lane_plain(xt, torch.from_numpy(embed))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_k5_exact_f32_row_split_matches_the_jax_kernel():
    """The f32 rows' bf16 split (xh, xl = bf16(xn - xh)) as vq_tc.cu's
    pre-pass writes it (`_split_rows`) is the JAX kernel's (vq.py:84, :93)
    bit for bit on the same normalised rows; with the norm taken in
    `_lane_inv_norm`'s order it equals the JAX kernel's on every row whose
    inverse norm comes out the same (the rest differ in the norm's last
    bit: that order is the card kernel's)."""
    from ct_clip_tpu.ops.pallas.vq import _norm_rows
    from ct_clip_tpu_torch.ops.vq import _lane_inv_norm, _split_rows

    rng = np.random.RandomState(23)
    x = (3 * rng.randn(512, 128)).astype(np.float32)
    xn = _norm_rows(jnp.asarray(x))
    xh_j = xn.astype(jnp.bfloat16)
    xl_j = (xn - xh_j.astype(jnp.float32)).astype(jnp.bfloat16)
    xh_j, xl_j = (torch.from_numpy(np.array(t, np.float32)) for t in (xh_j, xl_j))
    xt = torch.from_numpy(x)
    sumsq = jnp.sum(jnp.asarray(x) ** 2, axis=-1, keepdims=True)
    rs = torch.from_numpy(np.array(jax.lax.rsqrt(jnp.maximum(sumsq, 1e-24)), np.float32))
    xh, xl = _split_rows(xt, lambda _: rs)
    assert torch.equal(xh, xh_j) and torch.equal(xl, xl_j)
    lane = _lane_inv_norm(xt)
    xh, xl = _split_rows(xt, _lane_inv_norm)
    same = (lane == rs)[:, 0]
    assert int(same.sum()) >= 64
    assert torch.equal(xh[same], xh_j[same]) and torch.equal(xl[same], xl_j[same])
