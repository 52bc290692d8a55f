"""The plain version of the QK-norm attention core's backward
(ops/qknorm_attention.py::qk_attention_bwd_core_plain), which the card checks
hold the tensor-core core (csrc/qknorm_attention_tc.cu) and the CUDA-core one
against.  In f32 it rounds nothing, so it must equal autograd of the core's
forward (l2norm, scales, scores + bias, softmax, P v) to f32 rounding; in
bf16 it rounds qn, kn, P and dS as the TPU kernel does and lands within bf16
rounding of the f32 result.  Pure PyTorch on the CPU, a few sequences."""
import pytest
import torch

from ct_clip_tpu_torch.ops.norms import l2norm
from ct_clip_tpu_torch.ops.qknorm_attention import qk_attention_bwd_core_plain

S, HEADS, D = 3, 2, 32


def _inputs(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    hd = HEADS * D
    q, kv, dout = (torch.randn(shape, generator=g) for shape in
                   ((S * n, hd), (S * n, 2 * hd), (S * n, hd)))
    qs = (1 + 0.2 * torch.randn(D, generator=g)) * 8.0
    ks = 1 + 0.2 * torch.randn(D, generator=g)
    bias = torch.randn((HEADS, n, n), generator=g)
    return q, kv, dout, qs, ks, bias


def _autograd(q, kv, dout, qs, ks, bias, n):
    hd = HEADS * D
    leaves = [t.clone().requires_grad_() for t in (q, kv, qs, ks, bias)]
    ql, kvl, qsl, ksl, bl = leaves
    qn = l2norm(ql.view(S, n, HEADS, D)) * qsl
    kn = l2norm(kvl[:, :hd].reshape(S, n, HEADS, D)) * ksl
    v = kvl[:, hd:].reshape(S, n, HEADS, D)
    p = (torch.einsum("sihd,sjhd->shij", qn, kn) + bl).softmax(dim=-1)
    merged = torch.einsum("shij,sjhd->sihd", p, v).reshape(S * n, hd)
    return (merged.detach(),) + torch.autograd.grad(merged, leaves, dout)


@pytest.mark.parametrize("n", [40, 64])
def test_core_plain_f32_equals_autograd(n):
    q, kv, dout, qs, ks, bias = _inputs(n)
    got = qk_attention_bwd_core_plain(q, kv, dout, HEADS, D, n, qs, ks, bias)
    ref = _autograd(q, kv, dout, qs, ks, bias, n)
    for i, (a, b) in enumerate(zip(got, ref)):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err < 1e-5, (i, err)  # f32 in another order
    assert qk_attention_bwd_core_plain(q, kv, dout, HEADS, D, n, qs, ks, None)[5] is None


def test_core_plain_bf16_rounds_within_bf16_of_f32():
    n = 40
    q, kv, dout, qs, ks, bias = _inputs(n, seed=1)
    bf = [t.to(torch.bfloat16) for t in (q, kv, dout)]
    got = qk_attention_bwd_core_plain(*bf, HEADS, D, n, qs, ks, bias)
    ref = qk_attention_bwd_core_plain(*(t.float() for t in bf), HEADS, D, n, qs, ks, bias)
    assert [t.dtype for t in got[:3]] == [torch.bfloat16] * 3
    assert all(t.dtype == torch.float32 for t in got[3:])
    for i, (a, b) in enumerate(zip(got, ref)):
        err = (a.float() - b).abs().max().item() / b.abs().max().item()
        # bf16 qn, kn, P and dS: a few bf16 ulps (2^-8) of max; yet not f32
        assert 1e-6 < err < 3e-2, (i, err)
