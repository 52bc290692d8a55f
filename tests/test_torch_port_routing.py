"""The CUDA source each fused attention call takes (ops/attention.py::
attention_route), row by row of its table, and the stated contiguous copy
of a view the tensor-core kernels cannot address.  Pure Python: no card."""
import pytest
import torch

from ct_clip_tpu_torch.ops import kernels as K
from ct_clip_tpu_torch.ops.attention import TC, TRAIN, _tc_operand, attention_route

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,form,dropout,backward,route", [
    # bf16, d 64, no dropout, no bias or a dense bias: forward and backward TC
    (BF, 64, "none", False, False, TC),
    (BF, 64, "none", False, True, TC),
    (BF, 64, "dense", False, False, TC),
    (BF, 64, "dense", False, True, TC),
    # bf16, d 64, a key bias with no grad (zero-shot prompts, CXR-BERT eval)
    (BF, 64, "key", False, False, TC),
    # a key bias under grad: K12a reads the CUDA-core forward's f32 output
    (BF, 64, "key", False, True, TRAIN),
    # dropout (K13), f32 (RadBERT, T5), d != 64
    (BF, 64, "key", True, True, TRAIN),
    (BF, 64, "key", True, False, TRAIN),
    (F32, 64, "key", False, False, TRAIN),
    (F32, 64, "dense", False, True, TRAIN),
    (F32, 64, "none", False, True, TRAIN),
    (BF, 32, "none", False, False, TRAIN),
    (BF, 32, "dense", False, True, TRAIN),
    (BF, 128, "key", False, False, TRAIN),
])
def test_attention_route_table(dtype, d, form, dropout, backward, route):
    assert attention_route(dtype, d, form, dropout, backward) == route


def test_attention_route_rejects_unknown_bias_forms():
    with pytest.raises(ValueError, match="bias form"):
        attention_route(BF, 64, "both", False, False)


def test_tc_operand_copies_only_views_it_cannot_address():
    # BERT's and MaskGIT's head-major view of (b, n, h, d) projections
    x = torch.zeros((2, 10, 12, 64), dtype=BF).transpose(1, 2)
    assert K.tc_addressable(x) and _tc_operand(x) is x
    # a token stride of 65 elements is off the 16-byte chunks: a contiguous copy
    y = torch.zeros((2, 3, 10, 65), dtype=BF)[..., :64]
    assert not K.tc_addressable(y)
    z = _tc_operand(y)
    assert z.is_contiguous() and K.tc_addressable(z) and torch.equal(z, y)
