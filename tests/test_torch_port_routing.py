"""The CUDA sources (forward, backward) each fused attention call takes
(ops/attention.py::attention_route), row by row of its table, and the stated
contiguous copy of a view the tensor-core kernels cannot address (bf16 and
f32).  Pure Python: no card."""
import pytest
import torch

from ct_clip_tpu_torch.ops import kernels as K
from ct_clip_tpu_torch.ops.attention import (TC, TC32, TRAIN, _tc_bwd_operands, _tc_operand,
                                             attention_route, backward_counters,
                                             forward_counters)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,form,dropout,route", [
    # bf16, d 64, no dropout, any bias form: forward and backward TC (the
    # backward sums D_i from its own f32 P, so a key bias needs no f32 output)
    (BF, 64, "none", False, (TC, TC)),
    (BF, 64, "key", False, (TC, TC)),
    (BF, 64, "dense", False, (TC, TC)),
    # bf16, d 64, key bias + dropout (K13): K13a and K13b both TC
    (BF, 64, "key", True, (TC, TC)),
    # f32 at d 64: every forward and backward on the tensor cores in 3xTF32
    # (K7 / K12b with no bias, the TokenCritic; K7 / K12a, RadBERT's
    # inference and its step with attention dropout 0; K7 dense / K12b
    # dense, MaskGIT and T5; K13a / K13b, RadBERT's default step), the
    # backward's D_i from the 3xTF32 forward's f32 output
    (F32, 64, "none", False, (TC32, TC32)),
    (F32, 64, "key", False, (TC32, TC32)),
    (F32, 64, "dense", False, (TC32, TC32)),
    (F32, 64, "key", True, (TC32, TC32)),
    # head dims other than 64
    (BF, 32, "none", False, (TRAIN, TRAIN)),
    (BF, 32, "key", False, (TRAIN, TRAIN)),
    (BF, 32, "dense", False, (TRAIN, TRAIN)),
    (BF, 16, "key", True, (TRAIN, TRAIN)),
    (BF, 128, "key", False, (TRAIN, TRAIN)),
    (BF, 128, "key", True, (TRAIN, TRAIN)),
    (F32, 32, "key", False, (TRAIN, TRAIN)),
    (F32, 128, "key", False, (TRAIN, TRAIN)),
    (F32, 32, "none", False, (TRAIN, TRAIN)),
    (F32, 16, "dense", False, (TRAIN, TRAIN)),
    (F32, 40, "key", True, (TRAIN, TRAIN)),
])
def test_attention_route_table(dtype, d, form, dropout, route):
    assert attention_route(dtype, d, form, dropout) == route


# The counters a backward adds one to (ops/attention.py::backward_counters):
# its tensor-core source's own, then the function's, which names the TPU
# kernel on every route: a backward with no bias of either kind is K12b
# (`attention_dense_bwd`), as is a dense one; a key bias is K12a
# (`attention_bwd`); a key bias with dropout K13b (`attention_dropout_bwd`).
@pytest.mark.parametrize("dtype,d,form,dropout,counters", [
    (BF, 64, "none", False, ("attention_tc_bwd", "attention_dense_bwd")),
    (BF, 64, "dense", False, ("attention_tc_bwd", "attention_dense_bwd")),
    (BF, 64, "key", False, ("attention_tc_bwd", "attention_bwd")),
    (BF, 64, "key", True, ("attention_tc_bwd", "attention_dropout_bwd")),
    (F32, 64, "none", False, ("attention_tc32_bwd", "attention_dense_bwd")),
    (F32, 64, "dense", False, ("attention_tc32_bwd", "attention_dense_bwd")),
    (F32, 64, "key", False, ("attention_tc32_bwd", "attention_bwd")),
    (F32, 64, "key", True, ("attention_tc32_bwd", "attention_dropout_bwd")),
    (F32, 32, "none", False, ("attention_dense_bwd",)),
    (F32, 32, "dense", False, ("attention_dense_bwd",)),
    (BF, 32, "none", False, ("attention_dense_bwd",)),
    (BF, 32, "key", False, ("attention_bwd",)),
    (F32, 40, "key", True, ("attention_dropout_bwd",)),
])
def test_backward_counters_name_the_kernel_on_every_route(dtype, d, form, dropout, counters):
    got = backward_counters(attention_route(dtype, d, form, dropout)[1], form, dropout)
    assert got == counters
    assert set(got) <= set(K.KERNELS)


# The counters a forward adds one to (ops/attention.py::forward_counters):
# its tensor-core source's own, then the function's: K13a
# `attention_dropout`, K7 dense `attention_dense`, K7 with a key bias or none
# `fused_attention`.
@pytest.mark.parametrize("dtype,d,form,dropout,counters", [
    (BF, 64, "none", False, ("attention_tc", "fused_attention")),
    (BF, 64, "key", False, ("attention_tc", "fused_attention")),
    (BF, 64, "dense", False, ("attention_tc", "attention_dense")),
    (BF, 64, "key", True, ("attention_tc", "attention_dropout")),
    (F32, 64, "none", False, ("attention_tc32", "fused_attention")),
    (F32, 64, "key", False, ("attention_tc32", "fused_attention")),
    (F32, 64, "dense", False, ("attention_tc32", "attention_dense")),
    (F32, 64, "key", True, ("attention_tc32", "attention_dropout")),
    (F32, 32, "dense", False, ("attention_dense",)),
    (BF, 32, "key", False, ("fused_attention",)),
    (F32, 40, "key", True, ("attention_dropout",)),
])
def test_forward_counters_name_the_kernel_on_every_route(dtype, d, form, dropout, counters):
    got = forward_counters(attention_route(dtype, d, form, dropout)[0], form, dropout)
    assert got == counters
    assert set(got) <= set(K.KERNELS)


def test_attention_route_rejects_unknown_bias_forms():
    with pytest.raises(ValueError, match="bias form"):
        attention_route(BF, 64, "both", False)


def test_tc_operand_copies_only_views_it_cannot_address():
    # BERT's and MaskGIT's head-major view of (b, n, h, d) projections
    x = torch.zeros((2, 10, 12, 64), dtype=BF).transpose(1, 2)
    assert K.tc_addressable(x) and _tc_operand(x) is x
    # a token stride of 65 elements is off the 16-byte chunks: a contiguous copy
    y = torch.zeros((2, 3, 10, 65), dtype=BF)[..., :64]
    assert not K.tc_addressable(y)
    z = _tc_operand(y)
    assert z.is_contiguous() and K.tc_addressable(z) and torch.equal(z, y)
    # f32 rows (attention_tc32.cu) need strides of 4 elements: 68 is one, 66 not
    f = torch.zeros((2, 3, 10, 68))[..., :64]
    assert K.tc_addressable(f) and _tc_operand(f) is f
    w = torch.zeros((2, 3, 10, 66))[..., :64]
    assert not K.tc_addressable(w) and K.tc_addressable(_tc_operand(w))


def test_tc_backward_operands_copy_only_views_it_cannot_address():
    """The key-bias and dropout backwards hand attention_tc.cu q, k, v as
    they are where it can address them, a contiguous copy where not, and the
    output gradient cast to q's dtype (autograd may pass an f32 one)."""
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn((2, 10, 4, 64), generator=g).to(BF).transpose(1, 2) for _ in range(2))
    v = torch.randn((2, 4, 10, 72), generator=g).to(BF)[..., 4:68]  # base off 16 bytes
    do = torch.randn((2, 4, 10, 64), generator=g)
    got = _tc_bwd_operands(q, k, v, do)
    assert got[0] is q and got[1] is k
    assert not K.tc_addressable(v) and got[2].is_contiguous() and torch.equal(got[2], v)
    assert got[3].dtype == BF and torch.equal(got[3], do.to(BF))
    assert all(K.tc_addressable(t) for t in got)


# What a CUDA tensor takes by dtype (kernels.ROUTES): the plain version where
# the JAX package's dispatch gates the Pallas kernel to bf16 and computes f32
# in XLA (patchify.py:440, 685, 700, 714), the kernel where the TPU kernel
# runs f32 too and for the PEG (peg.py:106 gates K14 to bf16, but the f32
# PEG, XLA in JAX, runs the same stencil here, forward and backward), and a
# ValueError for any other dtype.
KERNEL, PLAIN, RAISES = K.KERNEL, K.PLAIN, K.RAISES


@pytest.mark.parametrize("op,bf16,f32", [
    ("patch_embed", KERNEL, PLAIN),        # K8: `dtype == bfloat16` gate, patchify.py:440
    ("patch_embed_bwd", KERNEL, PLAIN),    # K16a: patchify.py:714
    ("row_embed", KERNEL, PLAIN),          # K4: patchify.py:685
    ("row_embed_bwd", KERNEL, PLAIN),      # K16b: patchify.py:700
    ("peg_bwd", KERNEL, KERNEL),           # K14: peg.py:106 (f32 XLA in JAX) -> the stencil
    ("peg_fwd", KERNEL, KERNEL),           # the PEG forward, XLA's conv in JAX -> the stencil
    ("geglu_ff", KERNEL, KERNEL),          # K3: dot_precision, f32 "highest"
    ("geglu_ff_bwd", KERNEL, KERNEL),      # K11
    ("spatial_attention", KERNEL, KERNEL),  # K1: mm_precision_for(f32) "highest"
    ("grid_attention", KERNEL, KERNEL),    # K2 grid
    ("seq_attention", KERNEL, KERNEL),     # K2 seq
    ("vq_assign", KERNEL, KERNEL),         # K5 on f32 rows, normalised then bf16
    ("rearrange_patches", KERNEL, KERNEL),  # K6: f32 blocks, no dtype gate
    ("unrearrange_patches", KERNEL, KERNEL),  # K17: f32 blocks
    ("spatial_attention_bwd", KERNEL, KERNEL),  # K9 f32: "highest", :323
    ("grid_attention_bwd", KERNEL, KERNEL),     # K10 grid f32: :487
    ("seq_attention_bwd", KERNEL, KERNEL),      # K10 seq f32
    ("vq_assign_exact", KERNEL, KERNEL),        # K5 exact on f32 rows, 3 bf16 passes
    ("vq_cluster_stats", KERNEL, KERNEL),       # K15 on f32 rows, hi + lo
])
def test_dtype_route_table(op, bf16, f32):
    assert K.route(op, BF) == bf16
    assert K.route(op, F32) == f32
    assert K.route(op, torch.float16) == RAISES
    # a plain route is counted where it runs
    if PLAIN in (bf16, f32):
        assert {"patch_embed": "patch_embed_plain", "patch_embed_bwd": "patch_embed_plain",
                "row_embed": "row_embed_plain", "row_embed_bwd": "row_embed_plain"}[op] \
            in K.KERNELS


def test_dtype_route_table_covers_every_kernel_counter():
    """Every kernel counter that has a dtype route is in the table, and each
    f32 kernel form has its own counter."""
    assert set(K.ROUTES) <= set(K.KERNELS)
    for op, routes in K.ROUTES.items():
        if routes[F32] == KERNEL and op not in ("vq_assign",):
            assert f"{op}_f32" in K.KERNELS
    assert "vq_assign_f32" in K.KERNELS


def test_unported_f32_forms_raise_naming_their_queue():
    """No f32 route raises any more; a dtype no kernel takes (float16) does,
    naming the dtypes the kernels take and the table that says so."""
    assert not [op for op, routes in K.ROUTES.items() if routes[F32] == RAISES]
    assert K.route("spatial_attention_bwd", torch.float16) == RAISES
    err = K.not_ported("spatial_attention_bwd", torch.float16)
    assert isinstance(err, ValueError) and "torch.float16" in str(err)
    assert "torch.float32" in str(err) and "kernels.ROUTES" in str(err)


# K5 and K15 on f32 rows also follow the JAX package's `_plan` (its kernel
# where the shape fits, its f32 XLA forms `_chunked_argmax_sim` /
# `_chunked_cluster_stats` elsewhere: ct_clip_tpu/ops/vq.py:118-141); bf16
# rows take the kernels at any shape.
@pytest.mark.parametrize("op", ["vq_assign", "vq_assign_exact", "vq_cluster_stats"])
@pytest.mark.parametrize("dtype,rows,dim,codes,route", [
    (F32, 110592, 512, 8192, KERNEL),  # CT-CLIP training, batch 8
    (F32, 10240, 512, 8192, KERNEL),   # the autoencoder, batch 8
    (F32, 512, 128, 256, KERNEL),
    (F32, 100, 128, 256, PLAIN),       # rows of no multiple of 128
    (F32, 512, 64, 128, PLAIN),        # dim of no multiple of 128
    (F32, 640, 128, 200, PLAIN),       # codes of no multiple of 128
    (F32, 4 * 288, 32, 64, PLAIN),     # the tiny CT-CLIP of the CPU tests
    (BF, 100, 128, 256, KERNEL),       # bf16 unchanged
    (BF, 4 * 288, 32, 64, KERNEL),
])
def test_vq_f32_routes_follow_the_plan(op, dtype, rows, dim, codes, route):
    from ct_clip_tpu_torch.ops.vq import vq_route

    assert vq_route(op, dtype, rows, dim, codes) == route
    assert vq_route(op, torch.float16, rows, dim, codes) == RAISES
    # the plain route is counted where it runs
    assert {"vq_assign": "vq_assign_plain", "vq_assign_exact": "vq_assign_plain",
            "vq_cluster_stats": "vq_cluster_stats_plain"}[op] in K.KERNELS


# the fused sublayers' fit per dtype: f32 also needs its own forms' shared
# memory, which at head width 16 runs out from n ~808 where bf16 fits to
# n ~1,071; at the shipped shapes both dtypes fit alike
@pytest.mark.parametrize("n,d,bf16,f32", [
    (576, 32, True, True),     # CT-CLIP's spatial planes
    (64, 64, True, True),      # the autoencoder's planes
    (20, 64, True, True),      # its temporal sequences
    (800, 16, True, True),
    (900, 16, True, False),
    (1071, 16, True, False),
    (1072, 16, False, False),
    (1280, 64, False, False),  # MaskGIT's tokens
])
def test_sublayer_fit_per_dtype(n, d, bf16, f32):
    from ct_clip_tpu_torch.ops.qknorm_attention import sublayer_fits

    assert sublayer_fits(n, d) == sublayer_fits(n, d, BF) == bf16
    assert sublayer_fits(n, d, F32) == f32


def test_f32_self_attention_beyond_the_f32_fit_takes_the_generic_path(monkeypatch):
    """An f32 self-attention with a bias at (n 900, d 16), where the bf16
    sublayer fits and the f32 backward's shared memory does not, takes the
    generic path (sdpa), never the fused sublayer."""
    from ct_clip_tpu_torch.ops import attention as A

    routes = []
    for name in ("fused_spatial_qknorm_attention", "sdpa"):
        monkeypatch.setattr(A, name, lambda *a, _f=getattr(A, name), _n=name, **kw:
                            routes.append(_n) or _f(*a, **kw))
    g = torch.Generator().manual_seed(3)
    mod = A.QKNormAttention(32, 16, 2)
    x = torch.randn((1, 900, 32), generator=g)
    out = mod(x, torch.randn((2, 900, 900), generator=g))
    assert routes == ["sdpa"] and out.shape == x.shape and out.dtype == F32


# The QK-norm attention core's backward on CUDA (kernels.qk_bwd_tensor_cores):
# bf16 at head dim 32 from 32 tokens on takes qknorm_attention_tc.cu (wgmma),
# with the CPB bias or without one (the kernel takes both, so the rule does
# not read the bias); K10's 16-24-token sequences and other head dims keep
# qknorm_attention_bwd.cu.  `tc`: the route is QK_WGMMA (f32 takes its own
# route, QK_TC32, in the table below).
@pytest.mark.parametrize("dtype,n,d,tc", [
    (BF, 576, 32, True),    # K9: CT-CLIP's planes (24 x 24), 24 and 16 frames
    (BF, 64, 32, True),     # K9: the autoencoder's 8 x 8 planes
    (BF, 100, 32, True),    # a ragged n in zero-filled 64-row tiles
    (BF, 32, 32, True),     # half a tile, the least it takes
    (BF, 31, 32, False),
    (BF, 24, 32, False),    # K10 grid: CT-CLIP's t 24
    (BF, 20, 32, False),    # K10 seq: GenerateCT's t 20
    (BF, 16, 32, False),    # K10 seq: 160 frames, t 16
    (BF, 9, 16, False),     # the tiny card-vs-CPU configs' 3 x 3 planes at width 16
    (BF, 576, 64, False),
    (BF, 576, 16, False),
    (F32, 576, 32, False),  # qk_attention_bwd_f32_kernel
    (F32, 64, 32, False),
    (torch.float16, 576, 32, False),
])
def test_qk_bwd_tensor_core_gate(dtype, n, d, tc):
    assert (K.qk_bwd_tensor_cores(dtype, n, d) == K.QK_WGMMA) is tc


# The whole route table: bf16 -> wgmma, f32 -> 3xTF32 (qknorm_attention_tc32.cu)
# on the same shapes (head dim 32, n >= 32), the CUDA cores elsewhere.
@pytest.mark.parametrize("dtype,n,d,route", [
    (BF, 576, 32, "wgmma"),
    (BF, 64, 32, "wgmma"),
    (F32, 576, 32, "tc32"),     # K9 f32: CT-CLIP's planes
    (F32, 64, 32, "tc32"),      # K9 f32: the autoencoder's planes
    (F32, 100, 32, "tc32"),     # a ragged n
    (F32, 32, 32, "tc32"),
    (F32, 31, 32, "cuda_cores"),
    (F32, 24, 32, "cuda_cores"),  # K10 grid f32
    (F32, 20, 32, "cuda_cores"),  # K10 seq f32
    (F32, 16, 32, "cuda_cores"),
    (F32, 576, 64, "cuda_cores"),
    (F32, 576, 16, "cuda_cores"),
    (BF, 24, 32, "cuda_cores"),
    (torch.float16, 576, 32, "cuda_cores"),
])
def test_qk_bwd_route_table(dtype, n, d, route):
    assert K.qk_bwd_tensor_cores(dtype, n, d) == route
    assert route in (K.QK_WGMMA, K.QK_TC32, K.QK_CUDA_CORES)


class _FakeQkLibrary:
    """The C entries of the QK-norm core's backward, recording each call and
    returning `rc` (0: launched; else a CUDA error)."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []
        for name in ("ct_qk_attention_tc_bwd", "ct_qk_attention_tc32_bwd",
                     "ct_qk_attention_bwd", "ct_qk_attention_bwd_f32",
                     "ct_qk_attention_tc_fwd", "ct_qk_attention_tc32_fwd"):
            setattr(self, name, lambda *a, name=name: self.calls.append(name) or self.rc)

    def ct_error_string(self, err):
        return b"planted"


def _qk_core_cpu_call(monkeypatch, lib, S, n, d, dtype, bias, q_strides=None):
    """kernels.qk_attention_bwd on CPU tensors with the C library `lib`: the
    device check, the stream and the in-order sums stubbed (no card here)."""
    monkeypatch.setattr(K, "library", lambda: lib)
    monkeypatch.setattr(K, "require", lambda *a, **k: None)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    monkeypatch.setattr(K, "sum_splits", lambda part: part.sum(0))
    heads = 2
    hd = heads * d
    q, dm = torch.zeros((S * n, hd), dtype=dtype), torch.zeros((S * n, hd), dtype=dtype)
    kv = torch.zeros((S * n, 2 * hd), dtype=dtype)
    K.reset_launch_counts()
    return K.qk_attention_bwd(
        q, kv, dm, sequences=S, inner=1, heads=heads, n=n, d=d,
        q_strides=q_strides or (n * hd, 0, d, hd), kv_strides=(n * 2 * hd, 0, d, 2 * hd),
        q_scale=torch.ones(d), k_scale=torch.ones(d),
        bias=torch.zeros((heads, n, n)) if bias else None)


# kernels.qk_attention_bwd counts `qk_attention_tc_bwd` where it launches
# qknorm_attention_tc.cu and `qk_attention_tc32_bwd` where it launches
# qknorm_attention_tc32.cu, and nowhere else: the count follows the C entry
# called, which follows the route (the C library is a recording stand-in).
@pytest.mark.parametrize("S,n,d,dtype,bias,tc", [
    (2, 576, 32, BF, True, True),     # K9 with the CPB bias
    (2, 576, 32, BF, False, True),    # K9 with no bias
    (3, 64, 32, BF, True, True),      # the autoencoder's planes
    (2, 576, 32, F32, True, False),   # K9 f32
    (2, 24, 32, BF, False, False),    # K10 grid's t-columns
    (4, 20, 32, BF, False, False),    # K10 seq
    (4, 16, 32, F32, False, False),
])
def test_qk_tensor_core_counter_counts_the_launch(monkeypatch, S, n, d, dtype, bias, tc):
    lib = _FakeQkLibrary()
    got = _qk_core_cpu_call(monkeypatch, lib, S, n, d, dtype, bias)
    route = K.qk_bwd_tensor_cores(dtype, n, d)
    assert (route == K.QK_WGMMA) is tc
    want = {K.QK_WGMMA: "ct_qk_attention_tc_bwd", K.QK_TC32: "ct_qk_attention_tc32_bwd"}.get(
        route, "ct_qk_attention_bwd_f32" if dtype == F32 else "ct_qk_attention_bwd")
    assert lib.calls == [want]
    assert K.launch_counts()["qk_attention_tc_bwd"] == int(tc)
    assert K.launch_counts()["qk_attention_tc32_bwd"] == int(route == K.QK_TC32)
    assert (got[5] is None) == (not bias)
    if bias:
        assert got[5].shape == (2, n, n)


def test_qk_tensor_core_counter_skips_a_failed_launch(monkeypatch):
    """A launch that reports a CUDA error raises and adds no count."""
    lib = _FakeQkLibrary(rc=1)
    with pytest.raises(RuntimeError, match="ct_qk_attention_tc_bwd"):
        _qk_core_cpu_call(monkeypatch, lib, 2, 576, 32, BF, True)
    assert lib.calls == ["ct_qk_attention_tc_bwd"]
    assert K.launch_counts()["qk_attention_tc_bwd"] == 0


@pytest.mark.parametrize("S,n,bias", [(2, 576, True), (2, 576, False), (3, 64, True),
                                      (2, 100, True)])
def test_qk_tc32_counter_counts_the_launch(monkeypatch, S, n, bias):
    """K9 f32 at head dim 32 launches qknorm_attention_tc32.cu, counted
    `qk_attention_tc32_bwd` there and nowhere else; a failed launch raises
    and adds no count."""
    lib = _FakeQkLibrary()
    got = _qk_core_cpu_call(monkeypatch, lib, S, n, 32, F32, bias)
    assert lib.calls == ["ct_qk_attention_tc32_bwd"]
    c = K.launch_counts()
    assert (c["qk_attention_tc32_bwd"], c["qk_attention_tc_bwd"]) == (1, 0)
    assert (got[5] is None) == (not bias) and got[1].dtype == F32
    failing = _FakeQkLibrary(rc=1)
    with pytest.raises(RuntimeError, match="ct_qk_attention_tc32_bwd"):
        _qk_core_cpu_call(monkeypatch, failing, S, n, 32, F32, bias)
    assert K.launch_counts()["qk_attention_tc32_bwd"] == 0


@pytest.mark.parametrize("dtype,q_tok", [(F32, 66), (BF, 68)])
def test_qk_tensor_core_layout_misfit_raises(monkeypatch, dtype, q_tok):
    """The tensor-core cores take 16-byte rows: token strides of multiples of
    4 f32 or 8 bf16 elements; another stride raises before any launch."""
    lib = _FakeQkLibrary()
    with pytest.raises(ValueError, match="strides of multiples of"):
        _qk_core_cpu_call(monkeypatch, lib, 2, 64, 32, dtype, True,
                          q_strides=(64 * q_tok, 0, 32, q_tok))
    assert lib.calls == []


def test_sublayer_fit_follows_the_backward_kernel(monkeypatch):
    """The f32 fit reads the shared memory of the backward kernel that runs:
    the 3xTF32 core's on K9's planes, the CUDA-core kernel's on K10's short
    sequences."""
    from ct_clip_tpu_torch.ops.qknorm_attention import sublayer_fits

    assert sublayer_fits(576, 32, F32) and sublayer_fits(24, 32, F32)
    monkeypatch.setattr(K, "qk_attention_bwd_f32_smem", lambda *a: 10 ** 9)
    assert sublayer_fits(576, 32, F32) and not sublayer_fits(24, 32, F32)
    assert sublayer_fits(576, 32, BF)
    monkeypatch.setattr(K, "QK_TC32_BWD_SMEM", 10 ** 9)
    assert not sublayer_fits(576, 32, F32) and sublayer_fits(576, 32, BF)


# The sublayer's forward by `kernels.qk_fwd_route`: at head dim 32 from 32
# tokens its core takes qknorm_attention_tc.cu (bf16) or
# qknorm_attention_tc32.cu (f32, with the projections in 3xTF32 on
# ffn_tc32.cu); K2's 16-31-token sequences (no bias) take
# qknorm_attention_short.cu, f32 again with the 3xTF32 projections; the bf16
# projections run on ffn_tc.cu's NT store and residual forms.  The C library
# is a recording stand-in; `names` are the entries one sublayer forward
# calls, in order.
_TC_BF16 = ["ct_layernorm", "ct_ff_tc_gemm_nt", "ct_ff_tc_gemm_nt", "ct_qk_attention_tc_fwd",
            "ct_ff_tc_residual"]
_TC_F32 = ["ct_tc32_split", "ct_layernorm_split_f32", "ct_tc32_split", "ct_tc32_gemm",
           "ct_tc32_gemm", "ct_qk_attention_tc32_fwd", "ct_ff_tc32_residual"]
_SHORT_BF16 = _TC_BF16[:3] + ["ct_qk_attention_short", "ct_ff_tc_residual"]
_SHORT_F32 = _TC_F32[:5] + ["ct_qk_attention_short_f32", "ct_ff_tc32_residual"]


@pytest.mark.parametrize("dtype,shape,grid,names", [
    (BF, (2, 576, 64), False, _TC_BF16),        # K1: CT-CLIP's planes
    (BF, (3, 64, 64), False, _TC_BF16),         # K1: the autoencoder's
    (BF, (2, 100, 64), False, _TC_BF16),        # a ragged n
    (F32, (2, 576, 64), False, _TC_F32),        # K1 f32
    (F32, (3, 64, 64), False, _TC_F32),
    (BF, (1, 24, 9, 64), True, _SHORT_BF16),    # K2 grid: t 24
    (BF, (4, 20, 64), False, _SHORT_BF16),      # K2 seq: t 20
    (F32, (4, 16, 64), False, _SHORT_F32),      # K2 seq f32: t 16
])
def test_k1_forward_takes_the_tensor_cores_where_the_gate_does(monkeypatch, dtype, shape,
                                                               grid, names):
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    dim, heads, dh = shape[-1], 2, 32
    hd = heads * dh
    n = shape[1]
    x = torch.zeros(shape, dtype=dtype)
    short = names in (_SHORT_BF16, _SHORT_F32)
    out = Q._qknorm_attention_cuda(
        x, torch.ones(dim), torch.zeros((hd, dim)), torch.zeros((2 * hd, dim)), torch.ones(dh),
        torch.ones(dh), torch.zeros((dim, hd)), None if short else torch.zeros((heads, n, n)),
        heads, dh, 8.0, grid)
    assert out.shape == x.shape and out.dtype == dtype
    assert lib.names() == names
    c = K.launch_counts()
    assert c["qk_attention_tc"] == int(names is _TC_BF16)
    assert c["qk_attention_tc32"] == int(names is _TC_F32)
    assert c["qk_attention_short"] == int(short)
    assert c["qk_attention_short_f32"] == int(names is _SHORT_F32)
    assert c["qk_attention_cuda_cores"] == c["qk_proj_gemm"] == 0
    assert c["tc32_gemm"] == 3 * int(dtype == F32)
    assert c["qk_proj_tc"] == 3 * int(dtype == BF)
    rows = x.numel() // dim
    if dtype == F32:
        assert lib.calls[0][1][3] == hd * dim * 4  # wq, wkv, wout split at once
        assert lib.calls[3][1][6:9] == (rows, hd, dim)  # q = LN(x) wq^T
        assert lib.calls[4][1][6:9] == (rows, 2 * hd, dim)  # kv = x wkv^T
        assert lib.calls[6][1][6:9] == (rows, dim, hd)  # merged wout^T + x
    else:
        assert lib.calls[1][1][4:7] == (rows, hd, dim)  # q = LN(x) wq^T
        assert lib.calls[2][1][4:7] == (rows, 2 * hd, dim)  # kv = x wkv^T
        assert lib.calls[4][1][4:7] == (rows, dim, hd)  # merged wout^T + x
    if short:  # the core reads the layout's strides: the grid's t-columns in place
        core = lib.calls[3 if dtype == BF else 5][1]
        strides = core[3:11] if dtype == BF else core[4:12]
        if grid:
            S = shape[2]
            assert strides == (n * S * hd, hd, dh, S * hd, n * S * 2 * hd, 2 * hd, dh, S * 2 * hd)
        else:
            assert strides == (n * hd, 0, dh, hd, n * 2 * hd, 0, dh, 2 * hd)


@pytest.mark.parametrize("dtype,entry,counter", [
    (BF, "ct_qk_attention_tc_fwd", "qk_attention_tc"),
    (F32, "ct_qk_attention_tc32_fwd", "qk_attention_tc32"),
])
def test_qk_forward_counter_counts_the_launch_and_skips_a_failed_one(monkeypatch, dtype, entry,
                                                                     counter):
    """kernels.qk_attention_fwd counts its source's counter where the C
    entry launched and nowhere else: a launch that reports a CUDA error
    raises and adds no count; a shape the gate sends to the CUDA cores
    raises before any launch."""
    heads, d = 2, 32
    hd = heads * d

    def call(lib, S, n):
        _stub_card(monkeypatch, lib)
        q, kv = torch.zeros((S * n, hd), dtype=dtype), torch.zeros((S * n, 2 * hd), dtype=dtype)
        return K.qk_attention_fwd(q, kv, sequences=S, inner=1, heads=heads, n=n, d=d,
                                  q_strides=(n * hd, 0, d, hd),
                                  kv_strides=(n * 2 * hd, 0, d, 2 * hd), q_scale=torch.ones(d),
                                  k_scale=torch.ones(d), bias=torch.zeros((heads, n, n)))
    lib = _FakeQkLibrary()
    got = call(lib, 2, 576)
    assert lib.calls == [entry] and K.launch_counts()[counter] == 1
    assert sum(K.launch_counts().values()) == 1
    if dtype == F32:  # merged as its TF32 hi and lo planes
        assert len(got) == 2 and all(t.shape == (2 * 576, hd) and t.dtype == F32 for t in got)
    else:
        assert got.shape == (2 * 576, hd) and got.dtype == BF
    failing = _FakeQkLibrary(rc=1)
    with pytest.raises(RuntimeError, match=entry):
        call(failing, 2, 576)
    assert failing.calls == [entry] and K.launch_counts()[counter] == 0
    idle = _FakeQkLibrary()
    with pytest.raises(ValueError, match="attention.cu"):
        call(idle, 4, 24)
    assert idle.calls == [] and K.launch_counts()[counter] == 0


def test_sublayer_fit_counts_the_tensor_core_forward(monkeypatch):
    """`sublayer_fits` accepts every shape the gate gives the tensor cores
    (head dim 32, n >= 32, bf16 and f32) and counts their forward's shared
    memory there, and only there."""
    from ct_clip_tpu_torch.ops.qknorm_attention import sublayer_fits

    for dtype in (BF, F32):
        for n in (32, 40, 64, 100, 576):
            assert K.qk_bwd_tensor_cores(dtype, n, 32) != K.QK_CUDA_CORES
            assert sublayer_fits(n, 32, dtype), (dtype, n)
    monkeypatch.setattr(K, "QK_TC_FWD_SMEM", 10 ** 9)
    assert not sublayer_fits(576, 32, BF) and sublayer_fits(576, 32, F32)
    assert sublayer_fits(24, 32, BF) and sublayer_fits(64, 64, BF)
    monkeypatch.setattr(K, "QK_TC32_FWD_SMEM", 10 ** 9)
    assert not sublayer_fits(576, 32, F32) and sublayer_fits(24, 32, F32)


# K11: bf16 takes ffn_tc.cu's `wgmma` tile and products, f32 ffn_tc32.cu's 3xTF32 forms
@pytest.mark.parametrize("dtype,names", [
    (BF, ("ff_tc_tile", "gemm_nn_tc", "gemm_tn_tc")),
    (F32, ("ff_tc32_tile", "tc32_gemm", "tc32_gemm_tn")),
])
def test_k11_backward_kernels_per_dtype(dtype, names):
    from ct_clip_tpu_torch.ops.ffn import bwd_kernels

    assert bwd_kernels(dtype) == tuple(getattr(K, name) for name in names)


class _FakeFfLibrary:
    """ffn_tc.cu's C entries, recording each call's arguments."""

    def __init__(self):
        self.calls = []
        for name in ("ct_ff_tc_tile", "ct_ff_tc_gemm"):
            setattr(self, name, lambda *a, name=name: self.calls.append((name, a)) or 0)


def _stub_card(monkeypatch, lib):
    monkeypatch.setattr(K, "library", lambda: lib)
    monkeypatch.setattr(K, "require", lambda *a, **k: None)
    monkeypatch.setattr(K, "_stream", lambda: 0)
    monkeypatch.setattr(K, "sum_splits", lambda part: part.sum(0))
    K.reset_launch_counts()


def test_k11_wgmma_wrappers_launch_and_count(monkeypatch):
    """The tile and the three products of a K11 call on ffn_tc.cu, each
    counted at its launch: the tile once, the products three times; the TN
    products split 110,592 rows into 14 splits of 7,936."""
    lib = _FakeFfLibrary()
    _stub_card(monkeypatch, lib)
    R, dim, N = 110592, 512, 1368
    xn, dout = torch.zeros((R, dim), dtype=BF), torch.zeros((R, dim), dtype=BF)
    w = torch.zeros((2 * N, dim), dtype=BF)
    act, dcat = K.ff_tc_tile(xn, dout, w[:N], w[N:], torch.zeros((N, dim), dtype=BF))
    assert act.shape == (R, N) and dcat.shape == (R, 2 * N)
    K.gemm_nn_tc(dcat, w, torch.zeros((R, dim)))
    assert K.gemm_tn_tc(dcat, xn).shape == (2 * N, dim)
    assert K.gemm_tn_tc(dout, act).shape == (dim, N)
    names = [c[0] for c in lib.calls]
    assert names == ["ct_ff_tc_tile"] + ["ct_ff_tc_gemm"] * 3
    nn, tn = lib.calls[1][1], lib.calls[2][1]
    assert nn[0] == 0 and nn[8] == 2752  # NN: one split over K 2,736 in 64-row k blocks
    assert tn[0] == 1 and tn[8] == 7936 and tn[7] == R  # TN: 14 splits of 7,936 rows
    c = K.launch_counts()
    assert (c["ff_tc_tile"], c["ff_tc_gemm"]) == (1, 3)


@pytest.mark.parametrize("rows,chunk", [(110592, 7936), (10240, 5120), (8192, 8192),
                                        (8193, 4160), (100, 128), (64, 64)])
def test_k11_weight_gradient_splits(rows, chunk):
    """The TN products' splits (kernels.ff_tc_split): the fewest of at most
    FF_TC_SPLIT_ROWS rows, each a multiple of 64, covering every row."""
    got = K.ff_tc_split(rows)
    splits = -(-rows // got)
    assert got == chunk and got % 64 == 0
    assert got <= max(K.FF_TC_SPLIT_ROWS, 64) and (splits - 1) * got < rows <= splits * got


@pytest.mark.parametrize("misfit", ["f32", "width", "stride", "offset"])
def test_k11_wgmma_wrappers_raise_on_a_misfit(monkeypatch, misfit):
    """ffn_tc.cu takes bf16 rows of multiples of 16 bytes on 16-byte
    boundaries (its TMA copies); anything else raises before a launch."""
    lib = _FakeFfLibrary()
    _stub_card(monkeypatch, lib)
    dy, x = torch.zeros((256, 64), dtype=BF), torch.zeros((256, 40), dtype=BF)
    if misfit == "f32":
        dy = dy.float()
    elif misfit == "width":
        x = x[:, :36]
    elif misfit == "stride":
        x = torch.zeros((256, 44), dtype=BF)[:, :40]
    else:  # a base 2 bytes past a 16-byte boundary
        x = torch.zeros(256 * 40 + 1, dtype=BF)[1:].view(256, 40)
    with pytest.raises(ValueError):
        K.gemm_tn_tc(dy, x)
    assert lib.calls == []


@pytest.mark.parametrize("S,n,groups", [
    (192, 576, 1),   # CT-CLIP at 240 frames: 648 CTAs in one group
    (128, 576, 1),   # 160 frames
    (160, 64, 40),   # the autoencoder: 50 groups of 4 would leave 10 empty
    (12, 64, 12),
    (1, 64, 1),
    (7, 100, 7),
])
def test_qk_tensor_core_dbias_groups_hold_sequences(S, n, groups):
    """The dbias pass's groups (kernels.qk_tc_dbias_groups), 8 heads: the
    kernel gives each ceil(S / groups) sequences, and each holds one or more."""
    assert K.qk_tc_dbias_groups(S, 8, n) == groups
    per = -(-S // groups)
    assert 1 <= groups <= S and (groups - 1) * per < S <= groups * per


@pytest.mark.parametrize("binding", [True, False])
def test_stream_reads_the_raw_binding_or_the_public_call(monkeypatch, binding):
    """kernels._stream: the current stream's address by PyTorch's private
    raw-stream binding of the current device where the build has it, else by
    torch.cuda.current_stream() (a PyTorch that renamed the binding still
    launches on the right stream)."""
    import types

    for name in ("_cuda_getCurrentRawStream", "_cuda_getDevice"):
        monkeypatch.delattr(torch._C, name, raising=False)
    if binding:
        monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 3, raising=False)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda dev: 0x1000 + dev, raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0x2000))
    assert K._stream() == (0x1003 if binding else 0x2000)


def test_rearrange_geometry_is_checked_once_and_raises_every_call():
    """rearrange.cu's wrappers check a geometry once (kernels.
    unrearrange_geometry / rearrange_geometry, cached): the C entry's
    arguments and whether it takes 16-byte accesses; a bad geometry raises on
    every call, and a CPU tensor never reaches them."""
    K.unrearrange_geometry.cache_clear()
    sampler = (torch.Size([1, 1280, 2560]), F32, 10, 16, torch.Size([1, 200, 128, 128]))
    want = ((1280 * 2560, 2560, 1, 200, 128, 128, 10, 16), 1)
    assert K.unrearrange_geometry(*sampler, True) == want
    assert K.unrearrange_geometry(*sampler, True) == want
    assert K.unrearrange_geometry.cache_info().hits == 1
    assert K.unrearrange_geometry(*sampler, False)[1] == 0  # a base off 16 bytes
    volume = (torch.Size([1, 13824, 4000]), BF, 10, 20, torch.Size([1, 240, 480, 480]), True)
    assert K.unrearrange_geometry(*volume) == ((13824 * 4000, 4000, 1, 240, 480, 480, 10, 20), 1)
    # bf16 takes 16-byte accesses in 8-element steps: p = 5 breaks them
    assert K.unrearrange_geometry(torch.Size([1, 45, 50]), BF, 2, 5,
                                  torch.Size([1, 6, 15, 25]), True)[1] == 0
    bad = [
        (torch.Size([1, 1280, 2561]), F32, 10, 16, torch.Size([1, 200, 128, 128]), True),
        (torch.Size([1, 1280, 2560]), F32, 10, 16, torch.Size([1, 200, 128, 120]), True),
        (torch.Size([1, 1280, 2560]), F32, 10, 16, torch.Size([200, 128, 128]), True),
        (torch.Size([2, 1280, 2560]), F32, 10, 16, torch.Size([1, 200, 128, 128]), True),
        (torch.Size([1, 1280, 2560]), F32, 0, 16, torch.Size([1, 200, 128, 128]), True),
    ]
    for args in bad:
        for _ in range(2):  # an error is not cached
            with pytest.raises(ValueError, match="unrearrange_patches"):
                K.unrearrange_geometry(*args)
    K.rearrange_geometry.cache_clear()
    slot = (torch.Size([1, 200, 128, 128]), F32, 10, 16, torch.Size([1, 1280, 2560]))
    assert K.rearrange_geometry(*slot, (3 * 1280 * 2560, 2560, 1), True) == \
        ((1, 200, 128, 128, 10, 16), (3 * 1280 * 2560, 2560), 1)
    for out_strides in ((1280 * 2560, 2560, 2), (1280 * 2560, 2000, 1)):
        for _ in range(2):
            with pytest.raises(ValueError, match="rearrange_patches"):
                K.rearrange_geometry(*slot, out_strides, True)
    rows, vol = torch.zeros((1, 8, 32)), torch.zeros((1, 4, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        K.unrearrange_patches(rows, 2, 4, vol)
    with pytest.raises(ValueError, match="CUDA"):
        K.rearrange_patches(vol, 2, 4, rows)


class _RecordingLibrary:
    """Any C entry, recording each call's name and arguments (returns 0)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ct_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0

    def names(self):
        return [n for n, _ in self.calls]


def _k16a_call(monkeypatch, want_dvideo):
    """K16a's CUDA body on CPU tensors with the C library stubbed: 8 patch
    rows of a (1, 20, 40, 40) volume, patches 10 x 20 x 20 (4,000 wide)."""
    from ct_clip_tpu_torch.ops import patch_embed as pe

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    monkeypatch.setattr(pe, "unrearrange_patches", lambda rows, *geom: rows)
    video = torch.zeros((1, 20, 40, 40), dtype=BF)
    dim, pd = 512, 4000
    params = (torch.ones(pd), torch.zeros(pd), torch.zeros((dim, pd)), torch.zeros(dim),
              torch.ones(dim), torch.zeros(dim))
    out = pe._patch_embed_bwd_cuda(video, *params, torch.zeros((1, 8, dim), dtype=BF), 10, 20,
                                   1e-5, want_dvideo)
    return lib, out


@pytest.mark.parametrize("want_dvideo", [False, True])
def test_k16a_runs_the_wgmma_products_and_keeps_dxn_out_of_memory(monkeypatch, want_dvideo):
    """K16a in bf16: the patch LN (with its stats when the volume needs no
    gradient), the NT recompute, the LN(512) backward, the TN dW on
    ffn_tc.cu, then either the NN product with the LN(4000) sums in its
    epilogue (no f32 dxn, no LN(4000) backward pass) or, with d(volume), the
    storing NN product and the LN(4000) backward through the gather; each
    counter counts its launch."""
    lib, out = _k16a_call(monkeypatch, want_dvideo)
    names = lib.names()
    tail = (["ct_ff_tc_gemm", "ct_patch_layernorm_bwd"] if want_dvideo
            else ["ct_ff_tc_ln_sums"])
    assert names == ["ct_patch_layernorm", "ct_ff_tc_gemm_bias", "ct_layernorm_bwd",
                     "ct_ff_tc_gemm"] + tail
    stats = lib.calls[0][1][-2]
    assert (stats is None) == want_dvideo  # the recompute's mean and rstd
    assert lib.calls[3][1][0] == 1  # the TN dW
    if want_dvideo:
        assert lib.calls[4][1][0] == 0  # the storing NN
    else:
        args = lib.calls[4][1]
        assert args[4:7] == (8, 4000, 512)  # M, N, K: dxn = dyb W
        assert args[8:14] == (1, 20, 40, 40, 10, 20)  # the volume's geometry
    dvideo, ds1, db1, dw, dpb, ds2, db2 = out
    assert (dvideo is None) != want_dvideo
    assert ds1.shape == db1.shape == (4000,) and dw.shape == (512, 4000)
    c = K.launch_counts()
    assert (c["patch_embed_bwd"], c["ff_tc_gemm"], c["ff_tc_ln_sums"]) == \
        (1, 3, 0 if want_dvideo else 1)


@pytest.mark.parametrize("rows,tiles,padded", [(110592, 864, 864), (13824, 108, 128),
                                               (8, 1, 32), (4097, 33, 64)])
def test_k16a_ln_sums_partials_plan(rows, tiles, padded):
    """One partial row per 128 rows, padded to whole first-level groups of
    kernels.LN_SUMS_GROUPS rows."""
    assert K.ln_sums_plan(rows) == (tiles, padded)
    assert padded % K.LN_SUMS_GROUPS == 0 and (tiles - 1) * 128 < rows <= tiles * 128


@pytest.mark.parametrize("misfit", ["p_odd", "w_odd", "p_not_4", "stats", "rows", "f32"])
def test_k16a_ln_sums_raise_on_a_misfit(monkeypatch, misfit):
    """The LN sums copy the volume 4 columns at a time (p and W multiples of
    4) and read one stats row per patch row; anything else raises before a
    launch."""
    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    pt, p, shape = 8, 4, (1, 8, 8, 8)  # 4 rows of 128 columns
    if misfit == "p_odd":
        pt, p, shape = 8, 3, (1, 8, 6, 6)
    elif misfit == "w_odd":
        pt, p, shape = 2, 8, (1, 2, 8, 9)
    elif misfit == "p_not_4":
        pt, p, shape = 2, 6, (1, 2, 6, 12)
    video = torch.zeros(shape, dtype=BF)
    rows = (shape[1] // pt) * (shape[2] // p) * (shape[3] // p)
    dy = torch.zeros((rows + (misfit == "rows"), 64), dtype=F32 if misfit == "f32" else BF)
    w = torch.zeros((64, pt * p * p), dtype=BF)
    stats = torch.zeros((rows, 3 if misfit == "stats" else 2))
    with pytest.raises(ValueError):
        K.ln_sums_tc(dy, w, video, pt, p, stats)
    assert lib.calls == []


@pytest.mark.parametrize("dtype", [F32, BF])
def test_k3_routes_f32_to_3xtf32_and_keeps_bf16(monkeypatch, dtype):
    """K3 on a CUDA tensor: f32 takes ffn_tc32.cu (the LN split into hi and
    lo, the weight split, the GEGLU product, the residual product; counted
    `geglu_ff_tc32`), bf16 at the model width takes layernorm.cu's LN and
    ffn_tc.cu's GEGLU and residual products (`wgmma`; counted `ff_tc_fwd`)."""
    from ct_clip_tpu_torch.ops.ffn import _geglu_ff_cuda

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    rows, dim, inner = 300, 512, 1365
    x = torch.zeros((rows, dim), dtype=dtype)
    out = _geglu_ff_cuda(x, torch.ones(dim), torch.zeros(dim), torch.zeros((2 * inner, dim)),
                         torch.zeros((dim, inner)), 1e-5)
    assert out.shape == x.shape and out.dtype == dtype
    c = K.launch_counts()
    if dtype == F32:
        assert lib.names() == ["ct_layernorm_split_f32", "ct_tc32_split", "ct_ff_tc32_geglu",
                               "ct_ff_tc32_residual"]
        assert lib.calls[1][1][3] == 3 * 1368 * dim  # the three weights, split at once
        assert lib.calls[2][1][8:11] == (rows, 1368, dim)  # M, N, K: [a | g] = xn [wa | wg]
        assert lib.calls[3][1][6:9] == (rows, dim, 1368)  # act wo^T + x
        assert (c["geglu_ff"], c["geglu_ff_f32"], c["geglu_ff_tc32"]) == (1, 1, 1)
    else:
        assert lib.names() == ["ct_layernorm", "ct_ff_tc_geglu", "ct_ff_tc_residual"]
        assert lib.calls[1][1][4:7] == (rows, 1368, dim)  # M, N, K: act = geglu(xn [wa; wg]^T)
        assert lib.calls[2][1][4:7] == (rows, dim, 1368)  # act wo^T + x
        assert (c["geglu_ff"], c["geglu_ff_f32"], c["geglu_ff_tc32"], c["ff_tc_fwd"]) == \
            (1, 0, 0, 1)


@pytest.mark.parametrize("dtype,dim,route", [
    (BF, 512, "ffn_tc.cu"),    # every model width of the repo: CT-CLIP, CTViT, MaskGIT
    (BF, 64, "ffn_tc.cu"),
    (BF, 8, "ffn_tc.cu"),
    (BF, 100, "gemm.cu"),      # rows of 200 bytes: no TMA copy takes them
    (BF, 36, "gemm.cu"),
    (F32, 512, "ffn_tc32.cu"),
    (F32, 100, "ffn_tc32.cu"),
])
def test_k3_forward_route_table(dtype, dim, route):
    """K3's products by dtype and model width (`ops/ffn.py::fwd_route`):
    bf16 on ffn_tc.cu where TMA takes the rows (a width of a multiple of 8;
    the padded inner width always is), gemm.cu's WMMA epilogues elsewhere;
    f32 in 3xTF32 on ffn_tc32.cu."""
    from ct_clip_tpu_torch.ops import ffn

    assert ffn.fwd_route(dtype, dim) == route
    assert route in (ffn.FF_WGMMA, ffn.FF_WMMA, ffn.FF_TC32)


def test_k3_bf16_width_tma_cannot_take_keeps_gemm_cu(monkeypatch):
    """A bf16 width of no multiple of 8 takes gemm.cu's LN and two WMMA
    products, counted `geglu_ff` but not `ff_tc_fwd`."""
    from ct_clip_tpu_torch.ops.ffn import _geglu_ff_cuda

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    rows, dim, inner = 40, 36, 96
    out = _geglu_ff_cuda(torch.zeros((rows, dim), dtype=BF), torch.ones(dim),
                         torch.zeros(dim), torch.zeros((2 * inner, dim)),
                         torch.zeros((dim, inner)), 1e-5)
    assert out.shape == (rows, dim) and out.dtype == BF
    assert lib.names() == ["ct_layernorm", "ct_gemm", "ct_gemm"]
    c = K.launch_counts()
    assert (c["geglu_ff"], c["ff_tc_fwd"]) == (1, 0)


class _FailingLibrary(_RecordingLibrary):
    """Records every call; the entry `fail` returns a CUDA error."""

    def __init__(self, fail):
        super().__init__()
        self.fail = fail

    def __getattr__(self, name):
        if name == "ct_error_string":
            return lambda err: b"planted"
        if not name.startswith("ct_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or int(name == self.fail)


@pytest.mark.parametrize("fail", [None, "ct_ff_tc_geglu", "ct_ff_tc_residual"])
def test_k3_ff_tc_fwd_counts_the_launches_and_skips_a_failed_one(monkeypatch, fail):
    """`kernels.ff_tc_fwd` launches the GEGLU then the residual product and
    counts `ff_tc_fwd` once, after both; a launch that reports an error
    raises, naming its entry, and nothing is counted."""
    lib = _FailingLibrary(fail)
    _stub_card(monkeypatch, lib)
    rows, dim, P = 300, 64, 176
    x = torch.zeros((rows, dim), dtype=BF)
    args = (x, torch.zeros_like(x), torch.zeros((2 * P, dim), dtype=BF),
            torch.zeros((dim, P), dtype=BF))
    if fail is None:
        assert K.ff_tc_fwd(*args).shape == (rows, dim)
        assert lib.names() == ["ct_ff_tc_geglu", "ct_ff_tc_residual"]
        assert K.launch_counts()["ff_tc_fwd"] == 1
        return
    with pytest.raises(RuntimeError, match=fail):
        K.ff_tc_fwd(*args)
    assert lib.names()[-1] == fail
    assert K.launch_counts()["ff_tc_fwd"] == 0


@pytest.mark.parametrize("misfit", ["width", "stride", "f32", "weights"])
def test_k3_ff_tc_fwd_raises_on_a_misfit(monkeypatch, misfit):
    """ffn_tc.cu's K3 forms take bf16 rows of multiples of 16 bytes on
    16-byte boundaries and the value and gate weights side by side; anything
    else raises before a launch, and nothing is counted."""
    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    rows, dim, P = 64, 64, 176
    x, wcat, wo = (torch.zeros((rows, dim), dtype=BF), torch.zeros((2 * P, dim), dtype=BF),
                   torch.zeros((dim, P), dtype=BF))
    if misfit == "width":
        x = torch.zeros((rows, 68), dtype=BF)[:, :60]
    elif misfit == "stride":
        x = torch.zeros((rows, 68), dtype=BF)[:, :64]
    elif misfit == "f32":
        x = x.float()
    else:
        wcat = wcat[:P]
    with pytest.raises(ValueError):
        K.ff_tc_fwd(x, torch.zeros_like(x), wcat, wo)
    assert lib.calls == [] and K.launch_counts()["ff_tc_fwd"] == 0


@pytest.mark.parametrize("dtype,dim,exact,names,tc", [
    (BF, 512, False, ["ct_vq_assign_tc"], 1),                     # K5 bf16: vq_tc.cu
    (F32, 512, False, ["ct_vq_rows_bf16", "ct_vq_assign_tc"], 1),  # f32 rows: pre-pass first
    (BF, 512, True, ["ct_vq_assign_exact_tc"], 1),                 # K5 exact: vq_tc.cu too
    (F32, 512, True, ["ct_vq_rows_bf16", "ct_vq_assign_exact_tc"], 1),
    (BF, 640, False, ["ct_gemm_argmax"], 0),                       # wider than the row tile
    (BF, 100, False, ["ct_gemm_argmax"], 0),                       # no TMA row
    (BF, 640, True, ["ct_gemm_argmax2"], 0),                       # ... exact: gemm.cu
    (F32, 100, True, ["ct_gemm_argmax2_rows"], 0),
])
def test_k5_routes_inference_to_vq_tc_and_keeps_exact(monkeypatch, dtype, dim, exact, names, tc):
    """K5 on a CUDA tensor: both modes on bf16 and on f32 rows take
    vq_tc.cu (counted `vq_assign_tc` beside `vq_assign`, the exact mode
    `vq_assign_exact_tc` beside `vq_assign_exact`) where the width fits
    (`kernels.vq_tc_fits`), gemm.cu elsewhere (gemm_argmax_kernel; the
    exact mode gemm_argmax2_kernel and gemm_argmax3_rows_kernel)."""
    from ct_clip_tpu_torch.ops import vq

    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    monkeypatch.setattr(vq, "vq_route", lambda *a: K.KERNEL)  # any shape: the kernels
    rows, codes = 384, 256
    ids = vq._vq_assign_cuda(torch.zeros((rows, dim), dtype=dtype), torch.zeros((codes, dim)),
                             exact)
    assert ids.shape == (rows,) and ids.dtype == torch.int32
    assert lib.names() == names
    c = K.launch_counts()
    op = "vq_assign_exact" if exact else "vq_assign"
    assert (c[f"{op}_tc"], c[op], c[f"{op}_f32"]) == (tc, 1, int(dtype == F32))
    assert c["vq_assign_exact_tc" if not exact else "vq_assign_tc"] == 0
    if tc:
        at = 6 if exact else 4  # M, N, K
        assert lib.calls[-1][1][at:at + 3] == (rows, codes, dim)


@pytest.mark.parametrize("dtype,fail", [(BF, "ct_vq_assign_tc"), (F32, "ct_vq_rows_bf16"),
                                        (F32, "ct_vq_assign_tc")])
def test_k5_vq_assign_tc_skips_a_failed_launch(monkeypatch, dtype, fail):
    """A launch of vq_tc.cu that reports a CUDA error raises, naming its
    entry, and adds no count; nothing gives way to gemm.cu."""
    lib = _FailingLibrary(fail)
    _stub_card(monkeypatch, lib)
    with pytest.raises(RuntimeError, match=fail):
        K.vq_assign_tc(torch.zeros((256, 64), dtype=dtype), torch.zeros((512, 64), dtype=BF))
    assert lib.names()[-1] == fail and "ct_gemm_argmax" not in lib.names()
    assert K.launch_counts()["vq_assign_tc"] == 0


@pytest.mark.parametrize("misfit", ["width", "stride", "bf16", "weights"])
def test_k3_tc32_wrapper_raises_on_a_misfit(monkeypatch, misfit):
    """ffn_tc32.cu takes f32 rows of multiples of 16 bytes on 16-byte
    boundaries and the three weights side by side; anything else raises
    before a launch, and nothing is counted."""
    lib = _RecordingLibrary()
    _stub_card(monkeypatch, lib)
    rows, dim, P = 64, 64, 136
    x = torch.zeros((rows, dim))
    w = torch.zeros((3, P * dim))
    if misfit == "width":
        x = torch.zeros((rows, 66))[:, :62]
    elif misfit == "stride":
        x = torch.zeros((rows, 66))[:, :64]
    elif misfit == "bf16":
        x = x.to(BF)
    else:
        w = torch.zeros((2, P * dim))
    with pytest.raises(ValueError):
        K.ff_tc32(x, x, x, w)
    assert lib.calls == [] and K.launch_counts()["geglu_ff_tc32"] == 0
