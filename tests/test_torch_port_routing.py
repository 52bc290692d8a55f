"""The CUDA sources (forward, backward) each fused attention call takes
(ops/attention.py::attention_route), row by row of its table, and the stated
contiguous copy of a view the tensor-core kernels cannot address (bf16 and
f32).  Pure Python: no card."""
import pytest
import torch

from ct_clip_tpu_torch.ops import kernels as K
from ct_clip_tpu_torch.ops.attention import (TC, TC32, TRAIN, _tc_bwd_operands, _tc_operand,
                                             attention_route, backward_counters)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,form,dropout,route", [
    # bf16, d 64, no dropout, any bias form: forward and backward TC (the
    # backward sums D_i from its own f32 P, so a key bias needs no f32 output)
    (BF, 64, "none", False, (TC, TC)),
    (BF, 64, "key", False, (TC, TC)),
    (BF, 64, "dense", False, (TC, TC)),
    # bf16, d 64, key bias + dropout (K13): K13a and K13b both TC
    (BF, 64, "key", True, (TC, TC)),
    # f32 at d 64: every backward on the tensor cores in 3xTF32 (K12b with
    # no bias, the TokenCritic; K12a, RadBERT with attention dropout 0; K12b
    # dense, MaskGIT and T5; K13b, RadBERT's default step), every forward on
    # the CUDA cores, whose true-f32 output gives TC32 its D_i
    (F32, 64, "none", False, (TRAIN, TC32)),
    (F32, 64, "key", False, (TRAIN, TC32)),
    (F32, 64, "dense", False, (TRAIN, TC32)),
    (F32, 64, "key", True, (TRAIN, TC32)),
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
# in XLA (patchify.py:440, 685, 700, 714; peg.py:106), the kernel where the
# TPU kernel runs f32 too, and a ValueError for any other dtype.
KERNEL, PLAIN, RAISES = K.KERNEL, K.PLAIN, K.RAISES


@pytest.mark.parametrize("op,bf16,f32", [
    ("patch_embed", KERNEL, PLAIN),        # K8: `dtype == bfloat16` gate, patchify.py:440
    ("patch_embed_bwd", KERNEL, PLAIN),    # K16a: patchify.py:714
    ("row_embed", KERNEL, PLAIN),          # K4: patchify.py:685
    ("row_embed_bwd", KERNEL, PLAIN),      # K16b: patchify.py:700
    ("peg_bwd", KERNEL, PLAIN),            # K14: peg.py:106, `dtype != bfloat16` -> XLA
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
                "row_embed": "row_embed_plain", "row_embed_bwd": "row_embed_plain",
                "peg_bwd": "peg_dw_plain"}[op] in K.KERNELS


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
