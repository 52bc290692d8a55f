"""Cosine-similarity vector quantizer with its EMA codebook.

Port of ct_clip_tpu/ops/vq.py::CosineVQ and of the TPU kernels
ct_clip_tpu/ops/pallas/vq.py::pallas_assign (K5) and pallas_cluster_stats
(K15): ids = argmax_k sim(x, c_k) against the l2-normalised codebook,
quantized = codebook[ids] with the straight-through form.  In training
(`train=True`) the assignment takes the exact mode and the codebook moves by
EMA (decay 0.8) towards the mean of the l2-normalised rows assigned to each
code, a code with no rows keeping its entry (vq.py:134-152).  The inference
assignment has two numeric modes, as in the JAX package:

  * bf16 input (the inference fast path, `raw_bf16` in vq.py:67-82): raw
    bf16 rows times the bf16-rounded normalised codebook, f32 sums, no row
    norm (argmax is invariant to the positive per-row scale).  Codes whose
    similarities tie within bf16 rounding (~4e-3 relative) may swap;
  * f32 input (the exact semantics the tests use): l2norm(x) times the f32
    normalised codebook.

The exact mode on bf16 input (training, vq.py:67-82 with exact=True) splits
the normalised codebook into bf16 hi and lo parts and sums x.c_hi + x.c_lo
in f32; on f32 input both modes are the f32 form above.

On a CUDA tensor (bf16 only) the similarity product and the argmax over all
codes run in one hand-written kernel (csrc/gemm.cu, gemm_argmax_kernel, or
gemm_argmax2_kernel for the exact mode); the (tokens, codes) similarity
matrix never reaches device memory.  The EMA statistics (bins and the sums
of the normalised rows per code) are K15's port, csrc/vq_stats.cu, which
groups the rows by code and adds each code's rows in row order.
"""
from __future__ import annotations

import torch
from torch import nn

from . import kernels as K
from .norms import l2norm


def split_hi_lo(embed_n: torch.Tensor):
    """The bf16 hi and lo parts of the f32 codebook (pallas_assign :115-117)."""
    ebf = embed_n.float()
    hi = ebf.to(torch.bfloat16)
    return hi, (ebf - hi.float()).to(torch.bfloat16)


def vq_assign_plain(x: torch.Tensor, embed_n: torch.Tensor,
                    exact: bool = False) -> torch.Tensor:
    """Plain PyTorch version: (n, dim) rows, (codes, dim) normalised codebook
    -> (n,) int32 ids."""
    if x.dtype == torch.bfloat16:
        xf = x.float()
        if exact:
            hi, lo = split_hi_lo(embed_n)
            sim = xf @ hi.float().t() + xf @ lo.float().t()
        else:
            sim = xf @ embed_n.to(torch.bfloat16).float().t()
    else:
        sim = l2norm(x.float()) @ embed_n.float().t()
    return sim.argmax(dim=-1).to(torch.int32)


def vq_assign(x: torch.Tensor, embed_n: torch.Tensor, exact: bool = False) -> torch.Tensor:
    if x.device.type == "cpu":
        return vq_assign_plain(x, embed_n, exact)
    if exact:
        hi, lo = split_hi_lo(embed_n)
        ids = K.gemm_argmax(x.contiguous(), hi, lo)
        K.count_launch("vq_assign_exact")
        return ids
    ids = K.gemm_argmax(x.contiguous(), embed_n.to(torch.bfloat16).contiguous())
    K.count_launch("vq_assign")
    return ids


def cluster_stats_plain(x: torch.Tensor, ids: torch.Tensor, codes: int,
                        chunk: int = 16384):
    """Plain version of K15 (`_stats_kernel`): bins (codes,) and embed_sum
    (codes, dim) f32 as one-hot products over the l2-normalised rows, in row
    chunks."""
    bins = torch.zeros((codes,), dtype=torch.float32, device=x.device)
    esum = torch.zeros((codes, x.shape[1]), dtype=torch.float32, device=x.device)
    lanes = torch.arange(codes, device=x.device)
    for r in range(0, x.shape[0], chunk):
        onehot = (ids[r:r + chunk, None].long() == lanes).float()
        bins += onehot.sum(dim=0)
        esum += onehot.t() @ l2norm(x[r:r + chunk].float())
    return bins, esum


def cluster_stats(x: torch.Tensor, ids: torch.Tensor, codes: int):
    """bins and embed_sum of the rows x (n, dim) grouped by ids (n,)."""
    if x.device.type == "cpu":
        return cluster_stats_plain(x, ids, codes)
    out = K.vq_cluster_stats(x.contiguous(), ids.to(torch.int32).contiguous(), codes)
    K.count_launch("vq_cluster_stats")
    return out


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
    def __init__(self, dim: int, codebook_size: int, decay: float = 0.8,
                 device=None):
        super().__init__()
        self.decay = decay
        self._codebook = Codebook(dim, codebook_size, device=device)

    def forward(self, x: torch.Tensor, train: bool = False):
        """x (..., dim) -> (quantized like x, ids (...) int32).  train=True:
        exact assignment, the codebook's EMA update (in place, no gradient)
        and the straight-through output x + (q - x).detach()."""
        cb = self._codebook
        embed = cb.embed
        flat = x.reshape(-1, x.shape[-1]).detach()
        ids = vq_assign(flat, l2norm(embed.float()), exact=train)
        quant = embed[ids.long()].to(x.dtype).view(x.shape)
        if not train:
            return x + (quant - x), ids.view(x.shape[:-1])
        with torch.no_grad():
            bins, embed_sum = cluster_stats(flat, ids, embed.shape[0])
            empty = bins == 0
            normed = l2norm(embed_sum / torch.where(empty, 1.0, bins)[:, None])
            normed = torch.where(empty[:, None], embed, normed)
            embed.copy_(embed * self.decay + normed * (1.0 - self.decay))
            cb.cluster_size.copy_(cb.cluster_size * self.decay + bins * (1.0 - self.decay))
        return x + (quant - x).detach(), ids.view(x.shape[:-1])
