"""K15 (the VQ's EMA statistics) and K16b (the row-embed backward) as
csrc/vq_segstats.cu and K16a's forms compute them.

    python -m pytest tests/test_torch_port_k15k16b.py -q
    python -m pytest tests/test_torch_port_k15k16b.py -q --noconftest -m cuda   # on the card

On the CPU: K15's plain version in the segmented kernel's order of
additions (`cluster_stats_segments_plain`) against the JAX package's
`pallas_cluster_stats` in interpret mode and its XLA form
`_chunked_cluster_stats`, and against a loop written out code by code;
K16b's plain version at `_rows_bwd_kernel`'s rounding points
(`row_embed_bwd_points_plain`) against `_pallas_row_embed_bwd` in interpret
mode and against autograd of the plain forward, with and without d(rows);
the CUDA bodies with the C library stubbed.  On the card (marked `cuda`):
the kernels against the plain versions.  JAX is imported only by the CPU
cases' fixtures.

Tolerances.  K15: bins exact; sums SUM_REL of max|ref|.  The JAX kernel
adds each normalised row's bf16 hi + lo parts, which lie within 2^-17 of
the row (the f32 form adds them too; the bf16 form adds the f32 row), in
one-hot products in another order.  K16b: max|err| <= REL max|ref| (bf16
outputs and bf16 products, as chip_smoke.py's BWD_REL_TOL holds them on the
card) and mean|err| <= POINTS_MEAN of mean|ref| against the TPU kernel in
interpret mode.
"""
import ctypes

import numpy as np
import pytest
import torch

from ct_clip_tpu_torch.ops import kernels as K
from ct_clip_tpu_torch.ops import patch_embed as pe
from ct_clip_tpu_torch.ops import vq

BF = torch.bfloat16
SUM_REL = 1e-5
REL = 3e-2
POINTS_MEAN = 2e-3
CODES, DIM = 256, 128


def _jax():
    """JAX, for the CPU cases that compare against the JAX package, which
    also needs flax: where either is missing (the machine with the card)
    those cases skip."""
    pytest.importorskip("flax")
    return pytest.importorskip("jax")


def k15_case_ids(kind: str, rng):
    """(name, ids) of the K15 cases: uniform ids; one code holding every
    row (2,048 rows: 64 segments, two groups); a third of the codes used, the
    rest empty; 1,000 rows, a multiple of neither the segment nor the chunk,
    with a crowded code; SEG_ROWS - 1, SEG_ROWS and SEG_ROWS + 1 rows in one
    code."""
    s = vq.SEG_ROWS
    if kind == "uniform":
        return rng.randint(0, CODES, 512)
    if kind == "one_code":
        return np.full(2048, 7)
    if kind == "empty_codes":
        return rng.randint(0, CODES // 3, 512)
    if kind == "ragged":
        ids = rng.randint(0, CODES, 1000)
        ids[rng.permutation(1000)[:300]] = 5
        return ids
    crowd = {"seg_minus_1": s - 1, "seg": s, "seg_plus_1": s + 1}[kind]
    ids = rng.randint(0, CODES, 512)
    ids[ids == 3] = 4
    ids[rng.permutation(512)[:crowd]] = 3
    return ids


K15_KINDS = ["uniform", "one_code", "empty_codes", "ragged", "seg_minus_1", "seg",
             "seg_plus_1"]


@pytest.fixture(scope="module")
def k15_cases():
    """Per kind: the f32 rows, ids, and the JAX package's pallas_cluster_stats
    (interpret mode, on f32 and on bf16 rows) and _chunked_cluster_stats."""
    jax = _jax()
    import jax.numpy as jnp
    from ct_clip_tpu.ops.norms import l2norm
    from ct_clip_tpu.ops.pallas import _call
    from ct_clip_tpu.ops.pallas.vq import pallas_cluster_stats
    from ct_clip_tpu.ops.vq import _chunked_cluster_stats

    rng = np.random.RandomState(25)
    out = {}
    _call.set_interpret(True)
    jax.clear_caches()
    try:
        for kind in K15_KINDS:
            ids = k15_case_ids(kind, rng).astype(np.int32)
            n = ids.shape[0]
            x = rng.randn(n, DIM).astype(np.float32)
            xb = torch.from_numpy(x).to(BF)
            m = 200 if n % 256 else 256
            jx, jids = jnp.asarray(x), jnp.asarray(ids)
            f32 = pallas_cluster_stats(jx, jids, CODES, m)
            b16 = pallas_cluster_stats(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                                       jids, CODES, m)
            xla = _chunked_cluster_stats(l2norm(jx), jids, CODES)
            out[kind] = dict(x=torch.from_numpy(x), xb=xb, ids=torch.from_numpy(ids),
                             **{k: tuple(torch.from_numpy(np.array(t, np.float32)) for t in v)
                                for k, v in (("pallas_f32", f32), ("pallas_bf16", b16),
                                             ("xla", xla))})
    finally:
        _call.set_interpret(False)
        jax.clear_caches()
    return out


def _sum_err(got, ref):
    return ((got - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("kind", K15_KINDS)
@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_k15_segment_order_against_the_pallas_kernel(k15_cases, kind, rows):
    """cluster_stats_segments_plain on f32 and on bf16 rows against
    pallas_cluster_stats in interpret mode on the same rows: bins exact,
    sums within SUM_REL of max."""
    c = k15_cases[kind]
    x = c["x"] if rows == "f32" else c["xb"]
    bins, esum = vq.cluster_stats_segments_plain(x, c["ids"], CODES)
    rbins, resum = c[f"pallas_{rows}"]
    assert torch.equal(bins, rbins.flatten())
    assert _sum_err(esum, resum) <= SUM_REL


@pytest.mark.parametrize("kind", K15_KINDS)
def test_k15_segment_order_against_the_xla_form(k15_cases, kind):
    """The f32 form against the JAX package's f32 XLA form of the same
    statistics (_chunked_cluster_stats of l2norm(x)): SUM_REL of max; every
    empty code's sum is zero."""
    c = k15_cases[kind]
    bins, esum = vq.cluster_stats_segments_plain(c["x"], c["ids"], CODES)
    rbins, resum = c["xla"]
    assert torch.equal(bins, rbins)
    assert _sum_err(esum, resum) <= SUM_REL
    assert not esum[bins == 0].any()


def naive_segments(x, ids, codes, seg, group):
    """The segmented order written out code by code: each code's rows in
    row order, f32 sums of seg rows from zero, then of group partials, then
    of the groups' sums (f32 rows: the rows as the plain versions normalise
    and split them)."""
    xh, xl = vq._split_rows(x, vq._lane_inv_norm)
    xn = xh + xl
    out = torch.zeros((codes, x.shape[1]))
    for k in range(codes):
        rows = [xn[r] for r in range(x.shape[0]) if ids[r] == k]
        parts = []
        for s0 in range(0, max(len(rows), 1), seg):
            acc = torch.zeros(x.shape[1])
            for r in rows[s0:s0 + seg]:
                acc = acc + r
            parts.append(acc)
        if len(parts) == 1:
            out[k] = parts[0]
            continue
        sums = []
        for g0 in range(0, len(parts), group):
            acc = torch.zeros(x.shape[1])
            for p in parts[g0:g0 + group]:
                acc = acc + p
            sums.append(acc)
        if len(sums) == 1:
            out[k] = sums[0]
            continue
        acc = torch.zeros(x.shape[1])
        for p in sums:
            acc = acc + p
        out[k] = acc
    return out


@pytest.mark.parametrize("seg,group", [(4, 2), (8, 3), (vq.SEG_ROWS, vq.SEG_GROUP)])
def test_k15_f32_form_is_its_written_out_order_bit_for_bit(seg, group):
    """On f32 rows the segmented plain version is the kernel's arithmetic
    bit for bit (`_lane_inv_norm`'s norms, hi + lo, f32 adds in a fixed
    order): equal to the order written out code by code, with segments and
    groups small enough that codes take one, several and many groups."""
    g = torch.Generator().manual_seed(seg)
    ids = torch.randint(0, 6, (300,), generator=g)
    ids[:120] = 2  # 120 + rows in code 2: up to 30 segments
    x = torch.randn((300, 64), generator=g)
    bins, esum = vq.cluster_stats_segments_plain(x, ids, 7, seg=seg, group=group)
    assert torch.equal(bins, torch.bincount(ids, minlength=7).float())
    assert torch.equal(esum, naive_segments(x, ids, 7, seg, group))
    assert not esum[6].any()  # the empty code


def test_k15_segment_order_against_the_one_hot_order():
    """The segmented and the one-hot orders of cluster_stats_rows_plain (f32
    rows) and cluster_stats_plain (bf16 rows) agree within SUM_REL, and the
    segmented order is not the one-hot order bit for bit on a crowded code
    (the order is the kernel's own)."""
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, 64, (4096,), generator=g, dtype=torch.int32)
    ids[:2000] = 1
    x = torch.randn((4096, DIM), generator=g)
    for rows, plain in ((x, vq.cluster_stats_rows_plain), (x.to(BF), vq.cluster_stats_plain)):
        bins, esum = vq.cluster_stats_segments_plain(rows, ids, 64)
        rbins, resum = plain(rows, ids, 64)
        assert torch.equal(bins, rbins)
        assert _sum_err(esum, resum) <= SUM_REL
    assert not torch.equal(esum, resum)


class _Recorder:
    """Any C entry, recording each call's name and arguments (returns 0;
    `_words` entries return `words`); `fill` writes into a call's workspace."""

    def __init__(self, words=0, fill=None):
        self.calls, self.words, self.fill = [], words, fill

    def __getattr__(self, name):
        if not name.startswith("ct_"):
            raise AttributeError(name)

        def call(*a):
            self.calls.append((name, a))
            if name.endswith("_words"):
                return self.words
            if self.fill and name.startswith("ct_vq_seg_stats"):
                self.fill(a)
            return 0
        return call


def _stub(monkeypatch, lib):
    monkeypatch.setattr(K, "library", lambda: lib)
    monkeypatch.setattr(K, "require", lambda *a, **k: None)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    K.reset_launch_counts()
    return lib


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_k15_wrapper_one_workspace(monkeypatch, dtype):
    """K15's launch helper (CPU tensors, C library stubbed): one call of
    the workspace size, one of the segmented form (vq_stats.cu's entry
    none); bins and embed_sum f32 views of the one workspace at words 0 and
    ceil(codes / 4) * 4."""
    codes, dim = 10, 16

    def fill(a):  # bins[0] = 3, embed_sum[1, 2] = 5 through the raw pointer
        ws = ctypes.cast(a[5], ctypes.POINTER(ctypes.c_float))
        ws[0], ws[12 + dim + 2] = 3.0, 5.0
    lib = _stub(monkeypatch, _Recorder(words=12 + codes * dim + 100, fill=fill))
    x = torch.zeros((40, dim), dtype=dtype)
    bins, esum = K.vq_cluster_stats(x, torch.zeros(40, dtype=torch.int32), codes)
    entry = "ct_vq_seg_stats_f32" if dtype == torch.float32 else "ct_vq_seg_stats"
    assert [n for n, _ in lib.calls] == ["ct_vq_seg_stats_words", entry]
    assert lib.calls[0][1] == (40, dim, codes)
    assert bins.shape == (codes,) and esum.shape == (codes, dim)
    assert bins.dtype == esum.dtype == torch.float32
    assert bins[0] == 3.0 and esum[1, 2] == 5.0
    assert bins.untyped_storage().data_ptr() == esum.untyped_storage().data_ptr()


# ------------------------------------------------------------------ K16b
B_, N_, PD, D_ = 2, 64, 128, 128


@pytest.fixture(scope="module")
def k16b_case():
    """bf16 rows, weights and dout, with the JAX package's
    _pallas_row_embed_bwd in interpret mode (bf16 compute)."""
    jax = _jax()
    import jax.numpy as jnp
    from ct_clip_tpu.ops.pallas import _call
    from ct_clip_tpu.ops.pallas.patchify import _pallas_row_embed_bwd

    rng = np.random.RandomState(16)
    rows = torch.from_numpy((rng.rand(B_, N_, PD) * 2 - 1).astype(np.float32)).to(BF)
    w = dict(s1=1 + 0.1 * rng.randn(PD), b1=0.1 * rng.randn(PD),
             wi=rng.randn(PD, D_) / np.sqrt(PD), pb=0.1 * rng.randn(D_),
             s2=1 + 0.1 * rng.randn(D_), b2=0.1 * rng.randn(D_))
    do = torch.from_numpy(rng.randn(B_, N_, D_).astype(np.float32)).to(BF)
    jw = [jnp.asarray(w[k], jnp.float32) for k in ("s1", "b1", "wi", "pb", "s2", "b2")]
    jr = jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16)
    jdo = jnp.asarray(do.float().numpy()).astype(jnp.bfloat16)
    _call.set_interpret(True)
    jax.clear_caches()
    try:
        got = _pallas_row_embed_bwd(jr, *jw, jdo, 1e-5, jnp.bfloat16)
    finally:
        _call.set_interpret(False)
        jax.clear_caches()
    t = lambda a: torch.from_numpy(np.array(np.asarray(a, np.float32)))  # noqa: E731
    # the port's layout: w (dim, patch_dim), its gradient likewise
    order = lambda g: (t(g[0]), t(g[1]), t(g[2]), t(g[3]).t(), t(g[4]), t(g[5]),  # noqa: E731
                       t(g[6]))
    port_w = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in
                   (w["s1"], w["b1"], w["wi"].T, w["pb"], w["s2"], w["b2"]))
    return dict(rows=rows, do=do, w=port_w, pallas=order(got))


def _errors(got, ref):
    d = (got.float() - ref.float()).abs()
    return (d.max() / ref.float().abs().max()).item(), (d.mean() / ref.float().abs().mean()).item()


@pytest.mark.parametrize("drows", [True, False])
def test_k16b_points_plain_against_the_pallas_kernel(k16b_case, drows):
    """row_embed_bwd_points_plain against _pallas_row_embed_bwd in
    interpret mode, every output (d(rows) too, or the six weight gradients
    alone): REL of max and POINTS_MEAN of mean; d(rows) in bf16 like the
    rows."""
    c = k16b_case
    got = pe.row_embed_bwd_points_plain(c["rows"], *c["w"], c["do"])
    assert got[0].dtype == BF
    for i, (a, r) in enumerate(zip(got, c["pallas"])):
        if i == 0 and not drows:
            continue
        assert a.shape == r.shape
        mx, mean = _errors(a, r)
        assert mx <= REL and mean <= POINTS_MEAN, (i, mx, mean)


def test_k16b_points_plain_against_autograd_of_the_plain_forward(k16b_case):
    """Against row_embed_bwd_plain (autograd of the bf16 plain forward,
    rounding every gradient tensor to bf16), the reference chip_smoke.py
    holds the kernels to: REL of max for each of the seven."""
    c = k16b_case
    got = pe.row_embed_bwd_points_plain(c["rows"], *c["w"], c["do"])
    ref = pe.row_embed_bwd_plain(c["rows"], *c["w"], c["do"])
    for i, (a, r) in enumerate(zip(got, ref)):
        assert _errors(a, r)[0] <= REL, (i, _errors(a, r))


def test_k16b_ln_sums_from_the_rows_and_their_stats(k16b_case):
    """GEMM_LN_SUMS_ROWS' arithmetic: ds1 and db1 as the column sums of dxn
    times xhat rebuilt from the rows with their (mean, rstd), the
    statistics taken as embed_tc.cu takes them, within SUM_REL of the
    plain version's."""
    c = k16b_case
    x = c["rows"].reshape(-1, PD).float()
    mean = x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(dim=-1, keepdim=True) + 1e-5)
    _, ds1, db1, *_ = pe.row_embed_bwd_points_plain(c["rows"], *c["w"], c["do"])
    s1, b1, w, pbias, s2, _ = c["w"]
    # dxn of the plain version's points, reduced against xhat from the stats
    xn = ((x - mean) * rstd * s1 + b1).to(BF)
    yb = (xn.float() @ w.to(BF).float().t()).to(BF) + pbias.to(BF)
    y = yb.float()
    xh2 = (y - y.mean(-1, keepdim=True)) * torch.rsqrt(y.var(-1, unbiased=False,
                                                            keepdim=True) + 1e-5)
    d2 = c["do"].reshape(-1, D_).float() * s2
    dyb = torch.rsqrt(y.var(-1, unbiased=False, keepdim=True) + 1e-5) * (
        d2 - d2.mean(-1, keepdim=True) - xh2 * (d2 * xh2).mean(-1, keepdim=True))
    dxn = dyb.to(BF).float() @ w.to(BF).float()
    assert _sum_err((dxn * ((x - mean) * rstd)).sum(0), ds1) <= SUM_REL
    assert _sum_err(dxn.sum(0), db1) <= SUM_REL


@pytest.mark.parametrize("drows", [True, False])
def test_k16b_cuda_body_on_k16a_forms(monkeypatch, drows):
    """The bf16 CUDA body of K16b (CPU tensors, C library stubbed): the row
    LN with stats on embed_tc.cu, the NT recompute, the LN(dim) backward, the
    TN dW on ffn_tc.cu; without d(rows) the LN sums in the NN product's
    epilogue from the rows (ct_ff_tc_ln_sums_rows), with it dxn stored by the
    NN product and the LN(patch_dim) row backward, the row stats not
    written; no layernorm.cu forward LN and no gemm.cu product.  Counted row_embed_bwd, and ff_tc_ln_sums
    without d(rows)."""
    lib = _stub(monkeypatch, _Recorder())
    rows = torch.zeros((1, 8, 4000), dtype=BF)
    w = (torch.ones(4000), torch.zeros(4000), torch.zeros((512, 4000)), torch.zeros(512),
         torch.ones(512), torch.zeros(512))
    out = pe._row_embed_bwd_cuda(rows, *w, torch.zeros((1, 8, 512), dtype=BF), 1e-5, drows)
    names = [n for n, _ in lib.calls]
    assert names[:3] == ["ct_embed_ln_rows", "ct_ff_tc_gemm_bias", "ct_layernorm_bwd"]
    assert (lib.calls[0][1][9] is None) is drows  # the row stats only for the NN epilogue
    assert not {"ct_layernorm", "ct_gemm", "ct_gemm_layout"} & set(names)
    assert ("ct_ff_tc_ln_sums_rows" in names) is not drows
    gemms = [a[0] for n, a in lib.calls if n == "ct_ff_tc_gemm"]
    assert gemms == ([1, 0] if drows else [1])  # TN dW, then (with d(rows)) NN dxn in f32
    assert names.count("ct_layernorm_bwd") == (2 if drows else 1)
    assert (out[0] is None) is not drows
    if drows:
        assert out[0].shape == rows.shape
    c = K.launch_counts()
    assert c["row_embed_bwd"] == 1 and c["ff_tc_ln_sums"] == int(not drows)


# ------------------------------------------------------------ on the card
@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    K.library()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "one_code", "ragged", "seg_plus_1"])
@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_k15_kernel_against_the_segment_order(dev, kind, dtype):
    """vq_segstats.cu against cluster_stats_segments_plain on the card:
    bins exact; f32 rows bit for bit (the same arithmetic in the same
    order), bf16 rows within SUM_REL of max; a second run equal bit for
    bit."""
    ids = torch.from_numpy(k15_case_ids(kind, np.random.RandomState(7)).astype(np.int32))
    x = torch.randn((ids.shape[0], 512), generator=torch.Generator().manual_seed(2)).to(dtype)
    xd, idd = x.to(dev), ids.to(dev)
    bins, esum = K.vq_cluster_stats(xd, idd, 1024)
    rbins, resum = vq.cluster_stats_segments_plain(xd, idd, 1024)
    assert torch.equal(bins, rbins)
    if dtype == torch.float32:
        assert torch.equal(esum, resum)
    else:
        assert _sum_err(esum, resum) <= SUM_REL
    again = K.vq_cluster_stats(xd, idd, 1024)
    assert torch.equal(again[0], bins) and torch.equal(again[1], esum)


@pytest.mark.cuda
@pytest.mark.parametrize("drows", [True, False])
def test_k16b_kernels_against_the_points_plain(dev, drows):
    """K16b through autograd of fused_row_embed on the card at (2, 576,
    4,000) -> 512 against row_embed_bwd_points_plain: REL of max, every
    output; bit-identical across two runs."""
    g = torch.Generator(device=dev).manual_seed(16)
    rows = (torch.rand((2, 576, 4000), generator=g, device=dev) * 2 - 1).to(BF)
    w = [1 + 0.1 * torch.randn(4000, generator=g, device=dev),
         0.1 * torch.randn(4000, generator=g, device=dev),
         torch.randn((512, 4000), generator=g, device=dev) * 4000 ** -0.5,
         0.1 * torch.randn(512, generator=g, device=dev),
         1 + 0.1 * torch.randn(512, generator=g, device=dev),
         0.1 * torch.randn(512, generator=g, device=dev)]
    do = torch.randn((2, 576, 512), generator=g, device=dev).to(BF)
    leaves = [t.clone().requires_grad_() for t in ([rows] if drows else []) + w]
    out = pe.fused_row_embed(*(leaves if drows else [rows, *leaves]))
    got = torch.autograd.grad(out, leaves, do, retain_graph=True)
    again = torch.autograd.grad(out, leaves, do)
    ref = pe.row_embed_bwd_points_plain(rows, *w, do)[(0 if drows else 1):]
    for a, r, b in zip(got, ref, again):
        assert torch.equal(a, b)
        assert _errors(a, r)[0] <= REL
