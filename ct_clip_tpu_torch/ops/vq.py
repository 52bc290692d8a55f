"""Cosine-similarity vector quantizer, inference mode.

Port of ct_clip_tpu/ops/vq.py::CosineVQ (train=False) and of the TPU kernel
ct_clip_tpu/ops/pallas/vq.py::pallas_assign (K5): ids = argmax_k sim(x, c_k)
against the l2-normalised codebook, quantized = codebook[ids] with the
straight-through form x + (q - x).  Two numeric modes, as in the JAX package:

  * bf16 input (the inference fast path, `raw_bf16` in vq.py:67-82): raw
    bf16 rows times the bf16-rounded normalised codebook, f32 sums, no row
    norm (argmax is invariant to the positive per-row scale).  Codes whose
    similarities tie within bf16 rounding (~4e-3 relative) may swap;
  * f32 input (the exact semantics the tests use): l2norm(x) times the f32
    normalised codebook.

On a CUDA tensor (bf16 only) the similarity product and the argmax over all
codes run in one hand-written kernel (csrc/gemm.cu, gemm_argmax_kernel); the
(tokens, codes) similarity matrix never reaches device memory.
"""
from __future__ import annotations

import torch
from torch import nn

from . import kernels as K
from .norms import l2norm


def vq_assign_plain(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (n, dim) rows, (codes, dim) normalised codebook
    -> (n,) int32 ids."""
    if x.dtype == torch.bfloat16:
        sim = x.float() @ embed_n.to(torch.bfloat16).float().t()
    else:
        sim = l2norm(x.float()) @ embed_n.float().t()
    return sim.argmax(dim=-1).to(torch.int32)


def vq_assign(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return vq_assign_plain(x, embed_n)
    ids = K.gemm_argmax(x.contiguous(), embed_n.to(torch.bfloat16).contiguous())
    K.count_launch("vq_assign")
    return ids


class Codebook(nn.Module):
    """The buffers of vector-quantize-pytorch's CosineSimCodebook, so the
    reference key layout `vq._codebook.{embed, cluster_size, initted}`
    loads as it is."""

    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self.register_buffer("embed", torch.zeros(codebook_size, dim, device=device))
        self.register_buffer("cluster_size", torch.zeros(codebook_size, device=device))
        self.register_buffer("initted", torch.ones(1, device=device))


class CosineVQ(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self._codebook = Codebook(dim, codebook_size, device=device)

    def forward(self, x: torch.Tensor):
        """x (..., dim) -> (quantized like x, ids (...) int32)."""
        embed = self._codebook.embed
        flat = x.reshape(-1, x.shape[-1])
        ids = vq_assign(flat, l2norm(embed.float()))
        quant = embed[ids.long()].to(x.dtype).view(x.shape)
        return x + (quant - x), ids.view(x.shape[:-1])
