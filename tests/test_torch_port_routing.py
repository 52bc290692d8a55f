"""The CUDA sources (forward, backward) each fused attention call takes
(ops/attention.py::attention_route), row by row of its table, and the stated
contiguous copy of a view the tensor-core kernels cannot address (bf16 and
f32).  Pure Python: no card."""
import pytest
import torch

from ct_clip_tpu_torch.ops import kernels as K
from ct_clip_tpu_torch.ops.attention import (TC, TC32, TRAIN, _tc_bwd_operands, _tc_operand,
                                             attention_route)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,form,dropout,route", [
    # bf16, d 64, no dropout, any bias form: forward and backward TC (the
    # backward sums D_i from its own f32 P, so a key bias needs no f32 output)
    (BF, 64, "none", False, (TC, TC)),
    (BF, 64, "key", False, (TC, TC)),
    (BF, 64, "dense", False, (TC, TC)),
    # bf16, d 64, key bias + dropout (K13): K13a and K13b both TC
    (BF, 64, "key", True, (TC, TC)),
    # f32 at d 64: the key-bias backward (K12a, RadBERT with attention
    # dropout 0) on the tensor cores in 3xTF32, every forward and every
    # other backward on the CUDA cores
    (F32, 64, "none", False, (TRAIN, TRAIN)),
    (F32, 64, "key", False, (TRAIN, TC32)),
    (F32, 64, "dense", False, (TRAIN, TRAIN)),
    (F32, 64, "key", True, (TRAIN, TRAIN)),
    # head dims other than 64
    (BF, 32, "none", False, (TRAIN, TRAIN)),
    (BF, 32, "key", False, (TRAIN, TRAIN)),
    (BF, 32, "dense", False, (TRAIN, TRAIN)),
    (BF, 16, "key", True, (TRAIN, TRAIN)),
    (BF, 128, "key", False, (TRAIN, TRAIN)),
    (BF, 128, "key", True, (TRAIN, TRAIN)),
    (F32, 32, "key", False, (TRAIN, TRAIN)),
    (F32, 128, "key", False, (TRAIN, TRAIN)),
])
def test_attention_route_table(dtype, d, form, dropout, route):
    assert attention_route(dtype, d, form, dropout) == route


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
