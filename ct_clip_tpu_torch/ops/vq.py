"""Cosine-similarity vector quantizer with its EMA codebook.

Port of ct_clip_tpu/ops/vq.py::CosineVQ and of the TPU kernels
ct_clip_tpu/ops/pallas/vq.py::pallas_assign (K5) and pallas_cluster_stats
(K15): ids = argmax_k sim(x, c_k) against the l2-normalised codebook,
quantized = codebook[ids] with the straight-through form.  In training
(`train=True`) the assignment takes the exact mode and the codebook moves by
EMA (decay 0.8) towards the mean of the l2-normalised rows assigned to each
code, a code with no rows keeping its entry (vq.py:134-152).  The
autoencoder also takes the commitment loss (`commitment_loss`).  The
inference assignment has two numeric modes, as in the JAX package:

  * bf16 input (the inference fast path, `raw_bf16` in vq.py:67-82): raw
    bf16 rows times the bf16-rounded normalised codebook, f32 sums, no row
    norm (argmax is invariant to the positive per-row scale).  Codes whose
    similarities tie within bf16 rounding (~4e-3 relative) may swap;
  * f32 input (the exact semantics the tests use): l2norm(x) times the f32
    normalised codebook.

The exact mode on bf16 input (training, vq.py:67-82 with exact=True) splits
the normalised codebook into bf16 hi and lo parts and sums x.c_hi + x.c_lo
in f32; on f32 input both modes are the f32 form above (the plain versions
on the CPU, as the JAX package's XLA form off the TPU).

On a CUDA tensor the similarity product and the argmax over all codes run
in one hand-written kernel; the (tokens, codes) similarity matrix never
reaches device memory.  Both modes take csrc/vq_tc.cu (`wgmma`, the argmax
on the accumulators in registers; the exact mode's two or three products
per k block into one accumulator, `kernels.vq_assign_exact_tc`) at widths
it fits (`kernels.vq_tc_fits`: multiples of 8 up to 512), csrc/gemm.cu
elsewhere (gemm_argmax_kernel; the exact mode gemm_argmax2_kernel and
gemm_argmax3_rows_kernel).  f32
rows in inference take the TPU kernel's math on f32 input (vq.py:83-93):
each row l2-normalised in f32 and rounded to bf16 (on vq_tc.cu by a
pre-pass whose row norm `_lane_inv_norm` repeats bit for bit:
`vq_assign_rows_lane_plain` is its plain version; on gemm.cu as the tile
loads, `vq_assign_rows_plain`), one bf16 pass against the bf16 codebook.
The exact mode on f32 rows (an f32 CTViT in training, vq.py:
83-95): the normalised row split into bf16 hi + lo parts xh + xl (on
vq_tc.cu by the pre-pass, in `_lane_inv_norm`'s order: `_split_rows(x,
_lane_inv_norm)`; on gemm.cu's gemm_argmax3_rows_kernel as it is loaded),
three bf16 products (xh.c_hi + xh.c_lo) + xl.c_hi summed in f32
(`vq_assign_exact_rows_plain`; `vq_assign_exact_rows_lane_plain`, the
plain version of vq_tc.cu's form, takes the pre-pass's rows).  The EMA
statistics (bins and the sums of the normalised rows per code) are K15's
port, csrc/vq_segstats.cu, which groups the rows by code, cuts each code's
rows into segments of SEG_ROWS that a warp each adds in row order, and adds
the segments' partials in a fixed order (`cluster_stats_segments_plain`);
on f32 rows each normalised row as its bf16 hi + lo parts
(`cluster_stats_rows_plain`, vq.py:149-157).  On f32 rows the JAX
package takes its kernels only where its `_plan` does and its f32 XLA
forms elsewhere (`_chunked_argmax_sim`, `_chunked_cluster_stats`,
ops/vq.py:118-141); so does the port (`vq_route`), whose full-f32 plain
versions stand in for the XLA forms, counted as `vq_assign_plain` and
`vq_cluster_stats_plain`.
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


def vq_assign_rows_plain(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    """Plain version of the f32-row form: (n, dim) f32 rows, each
    normalised as x rsqrt(max(sum x^2, 1e-24)) and rounded to bf16, against
    the bf16-rounded codebook, f32 sums (`_assign_kernel`, raw_bf16 False,
    exact False)."""
    x = x.float()
    xn = x * torch.rsqrt(torch.clamp_min((x * x).sum(dim=-1, keepdim=True), 1e-24))
    sim = xn.to(torch.bfloat16).float() @ embed_n.to(torch.bfloat16).float().t()
    return sim.argmax(dim=-1).to(torch.int32)


def vq_rows_lane_sim(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    """The similarities of K5 on f32 rows as csrc/vq_tc.cu takes them: each
    row times its inverse norm in the order of `_lane_inv_norm`, rounded to
    bf16 (the kernel's pre-pass, bit for bit), against the bf16-rounded
    codebook, f32 sums."""
    x = x.float()
    xh = (x * _lane_inv_norm(x)).to(torch.bfloat16).float()
    return xh @ embed_n.to(torch.bfloat16).float().t()


def vq_assign_rows_lane_plain(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 on f32 rows on csrc/vq_tc.cu: the argmax of
    `vq_rows_lane_sim` as (n,) int32.  Its bf16 rows are the kernel's, so
    ids differ only where two codes' f32 sums tie within their order."""
    return vq_rows_lane_sim(x, embed_n).argmax(dim=-1).to(torch.int32)


def _lane_inv_norm(x: torch.Tensor) -> torch.Tensor:
    """(rows, 1) inverse norms 1 / sqrt(max(sum x^2, 1e-24)) of f32 rows as
    csrc/vq_segstats.cu's f32 form and csrc/vq_tc.cu's pre-pass round them:
    lane l of a warp adds,
    one rounded square at a time, the elements of its 16-byte pieces l,
    l + 32, ...; the 32 lanes' sums meet in a xor butterfly (16, 8, 4, 2,
    1); then a rounded sqrt and a rounded division."""
    rows, dim = x.shape
    pieces = nn.functional.pad(x, (0, -dim % 128)).reshape(rows, -1, 32, 4)
    ss = torch.zeros((rows, 32), dtype=torch.float32, device=x.device)
    for u in range(pieces.shape[1]):
        for e in range(4):
            ss = ss + pieces[:, u, :, e] * pieces[:, u, :, e]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[:, lanes ^ o]
    return 1.0 / torch.sqrt(torch.clamp_min(ss[:, :1], 1e-24))


def _split_rows(x: torch.Tensor, inv_norm=None):
    """The f32 rows normalised as x rsqrt(max(sum x^2, 1e-24)) and split
    into their bf16 hi and lo parts, as f32 (vq.py:90-95, :149-151); the
    inverse norms by `inv_norm` where given."""
    x = x.float()
    inv = (torch.rsqrt(torch.clamp_min((x * x).sum(dim=-1, keepdim=True), 1e-24))
           if inv_norm is None else inv_norm(x))
    xn = x * inv
    xh = xn.to(torch.bfloat16).float()
    return xh, (xn - xh).to(torch.bfloat16).float()


def vq_assign_exact_rows_sim(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    """The similarities of the exact mode on f32 rows (`_assign_kernel`,
    exact, f32 input): (xh c_hi^T + xh c_lo^T) + xl c_hi^T, each product
    summed in f32."""
    xh, xl = _split_rows(x)
    hi, lo = (t.float() for t in split_hi_lo(embed_n))
    return (xh @ hi.t() + xh @ lo.t()) + xl @ hi.t()


def vq_assign_exact_rows_plain(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 exact on f32 rows: the argmax of
    `vq_assign_exact_rows_sim` as (n,) int32."""
    return vq_assign_exact_rows_sim(x, embed_n).argmax(dim=-1).to(torch.int32)


def vq_exact_rows_lane_sim(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    """The similarities of K5 exact on f32 rows as csrc/vq_tc.cu takes them:
    each row's xh and xl from the norm in `_lane_inv_norm`'s order (the
    kernel's pre-pass, bit for bit), then (xh c_hi^T + xh c_lo^T) + xl
    c_hi^T, each product summed in f32."""
    xh, xl = _split_rows(x, _lane_inv_norm)
    hi, lo = (t.float() for t in split_hi_lo(embed_n))
    return (xh @ hi.t() + xh @ lo.t()) + xl @ hi.t()


def vq_assign_exact_rows_lane_plain(x: torch.Tensor, embed_n: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 exact on f32 rows on csrc/vq_tc.cu: the argmax of
    `vq_exact_rows_lane_sim` as (n,) int32."""
    return vq_exact_rows_lane_sim(x, embed_n).argmax(dim=-1).to(torch.int32)


def rows_fit(rows: int, dim: int, codes: int) -> bool:
    """Whether the JAX package's assignment takes its Pallas kernel for
    these shapes (ct_clip_tpu/ops/pallas/vq.py::_plan: dim and codes
    multiples of 128, rows of a multiple of 128, 256 or 512 that fit its
    VMEM budget), where f32 rows get the kernel's bf16-rounded math; the
    others take its f32 XLA form."""
    if dim % 128 or codes % 128:
        return False
    budget = 48 * 1024 * 1024
    return any(rows % m == 0 and m * codes * 4 + codes * dim * 4 + 16 * m * dim <= budget
               for m in (512, 256, 128))


def vq_route(op: str, dtype: torch.dtype, rows: int, dim: int, codes: int) -> str:
    """What a CUDA tensor of `dtype` takes for `op` ("vq_assign",
    "vq_assign_exact" or "vq_cluster_stats") on (rows, dim) rows against
    `codes` codes: `kernels.ROUTES`, except that f32 rows of a shape the JAX
    package's `_plan` refuses (`rows_fit`) take the full-f32 plain version,
    as JAX takes its XLA forms there.  bf16 rows take the kernels at any
    shape."""
    r = K.route(op, dtype)
    if r == K.KERNEL and dtype == torch.float32 and not rows_fit(rows, dim, codes):
        return K.PLAIN
    return r


def vq_assign(x: torch.Tensor, embed_n: torch.Tensor, exact: bool = False) -> torch.Tensor:
    if x.device.type == "cpu":
        return vq_assign_plain(x, embed_n, exact)
    return _vq_assign_cuda(x, embed_n, exact)


def _vq_assign_cuda(x: torch.Tensor, embed_n: torch.Tensor, exact: bool) -> torch.Tensor:
    op = "vq_assign_exact" if exact else "vq_assign"
    r = vq_route(op, x.dtype, x.shape[0], x.shape[1], embed_n.shape[0])
    if r == K.RAISES:
        raise K.not_ported(op, x.dtype)
    if r == K.PLAIN:
        K.count_launch("vq_assign_plain")
        return vq_assign_plain(x, embed_n, exact)
    if K.vq_tc_fits(x.shape[1]):
        x = x.contiguous()
        if x.data_ptr() % 16:  # TMA reads rows from 16-byte boundaries: a stated copy
            x = x.clone()
        ids = (K.vq_assign_exact_tc(x, *split_hi_lo(embed_n)) if exact
               else K.vq_assign_tc(x, embed_n.to(torch.bfloat16).contiguous()))
    elif exact:
        hi, lo = split_hi_lo(embed_n)
        ids = K.gemm_argmax(x.contiguous(), hi, lo)
    else:
        ids = K.gemm_argmax(x.contiguous(), embed_n.to(torch.bfloat16).contiguous())
    K.count_launch(op, x.dtype)
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


def cluster_stats_rows_plain(x: torch.Tensor, ids: torch.Tensor, codes: int,
                             chunk: int = 16384):
    """Plain version of K15 on f32 rows: as `cluster_stats_plain`, each
    normalised row added as its bf16 hi + lo parts (`_stats_kernel`), the
    row norms taken as the CUDA form takes them (`_lane_inv_norm`)."""
    bins = torch.zeros((codes,), dtype=torch.float32, device=x.device)
    esum = torch.zeros((codes, x.shape[1]), dtype=torch.float32, device=x.device)
    lanes = torch.arange(codes, device=x.device)
    for r in range(0, x.shape[0], chunk):
        onehot = (ids[r:r + chunk, None].long() == lanes).float()
        bins += onehot.sum(dim=0)
        xh, xl = _split_rows(x[r:r + chunk], _lane_inv_norm)
        esum += onehot.t() @ (xh + xl)
    return bins, esum


SEG_ROWS, SEG_GROUP = 32, 32  # csrc/vq_segstats.cu's SEG and GROUP


def cluster_stats_segments_plain(x: torch.Tensor, ids: torch.Tensor, codes: int,
                                 seg: int = SEG_ROWS, group: int = SEG_GROUP):
    """Plain version of K15 in csrc/vq_segstats.cu's order of additions:
    each code's rows, in row order, cut into segments of `seg` rows; each
    segment's normalised rows added to a zero f32 sum in order (bf16 rows:
    x rsqrt(max(sum x^2, 1e-24)), each element multiplied and added with one
    rounding, as fmaf; f32 rows: each row's bf16 hi + lo parts, the norms in
    `_lane_inv_norm`'s order, bit for bit the kernel's); a code of one
    segment (an empty code's is zero) takes its sum, a longer one adds its
    segments' partials in order in groups of `group`, then the groups' sums
    in order.  bins (codes,) and embed_sum (codes, dim) f32."""
    rows, dim = x.shape
    dev = x.device
    if x.dtype == torch.float32:
        xh, xl = _split_rows(x, _lane_inv_norm)
        xn, inv = xh + xl, None
    else:
        xn = x.float()
        inv = torch.rsqrt(torch.clamp_min((xn * xn).sum(dim=-1, keepdim=True), 1e-24))
    ids = ids.long()
    bins = torch.bincount(ids, minlength=codes)
    start = torch.cumsum(bins, 0) - bins
    nseg = torch.clamp_min(-(-bins // seg), 1)
    seg0 = torch.cumsum(nseg, 0) - nseg
    order = torch.sort(ids, stable=True).indices  # each code's rows in row order
    pos = torch.arange(rows, device=dev) - start[ids[order]]
    which = seg0[ids[order]] + pos // seg
    part = torch.zeros((int(nseg.sum()), dim), dtype=torch.float32, device=dev)
    for t in range(seg):  # the t-th row of every segment that has one
        sel = pos % seg == t
        s, r = which[sel], order[sel]
        if inv is None:
            part[s] = part[s] + xn[r]
        else:  # fmaf: the exact product and sum, rounded once
            part[s] = (part[s].double() + xn[r].double() * inv[r].double()).float()
    esum = part[seg0]  # codes of one segment
    for k in torch.nonzero(nseg > 1).flatten().tolist():
        own = part[int(seg0[k]):int(seg0[k] + nseg[k])]
        sums = []
        for g0 in range(0, own.shape[0], group):
            acc = torch.zeros(dim, dtype=torch.float32, device=dev)
            for p in own[g0:g0 + group]:
                acc = acc + p
            sums.append(acc)
        acc = sums[0]
        if len(sums) > 1:
            acc = torch.zeros(dim, dtype=torch.float32, device=dev)
            for p in sums:
                acc = acc + p
        esum[k] = acc
    return bins.float(), esum


def cluster_stats(x: torch.Tensor, ids: torch.Tensor, codes: int):
    """bins and embed_sum of the rows x (n, dim) grouped by ids (n,)."""
    if x.device.type == "cpu":
        return cluster_stats_plain(x, ids, codes)
    r = vq_route("vq_cluster_stats", x.dtype, x.shape[0], x.shape[1], codes)
    if r == K.RAISES:
        raise K.not_ported("vq_cluster_stats", x.dtype)
    if r == K.PLAIN:
        K.count_launch("vq_cluster_stats_plain")
        return cluster_stats_plain(x, ids, codes)
    out = K.vq_cluster_stats(x.contiguous(), ids.to(torch.int32).contiguous(), codes)
    K.count_launch("vq_cluster_stats", x.dtype)
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


def commitment_loss(quant: torch.Tensor, x: torch.Tensor, weight: float) -> torch.Tensor:
    """mean((sg(q) - x)^2) * weight in f32 (vq.py:155-158): pulls the
    encoder's tokens x towards their codes q."""
    return ((quant.detach().float() - x.float()) ** 2).mean() * weight


class CosineVQ(nn.Module):
    def __init__(self, dim: int, codebook_size: int, decay: float = 0.8,
                 commitment_weight: float = 1.0, device=None):
        super().__init__()
        self.decay = decay
        self.commitment_weight = commitment_weight
        self._codebook = Codebook(dim, codebook_size, device=device)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The codes of `ids` (decode_from_codebook_indices, vq.py:161-166)."""
        return self._codebook.embed[ids.long()]

    def forward(self, x: torch.Tensor, train: bool = False, return_loss: bool = False):
        """x (..., dim) -> (quantized like x, ids (...) int32), and with
        return_loss the commitment loss third (the autoencoder's; CT-CLIP
        discards it).  train=True: exact assignment, the codebook's EMA
        update (in place, no gradient) and the straight-through output
        x + (q - x).detach(); the loss reads the codes from before the
        update, as the JAX module does."""
        cb = self._codebook
        embed = cb.embed
        flat = x.reshape(-1, x.shape[-1]).detach()
        ids = vq_assign(flat, l2norm(embed.float()), exact=train)
        quant = embed[ids.long()].to(x.dtype).view(x.shape)
        loss = (commitment_loss(quant, x, self.commitment_weight),) if return_loss else ()
        if not train:
            return (x + (quant - x), ids.view(x.shape[:-1])) + loss
        with torch.no_grad():
            bins, embed_sum = cluster_stats(flat, ids, embed.shape[0])
            empty = bins == 0
            normed = l2norm(embed_sum / torch.where(empty, 1.0, bins)[:, None])
            normed = torch.where(empty[:, None], embed, normed)
            embed.copy_(embed * self.decay + normed * (1.0 - self.decay))
            cb.cluster_size.copy_(cb.cluster_size * self.decay + bins * (1.0 - self.decay))
        return (x + (quant - x).detach(), ids.view(x.shape[:-1])) + loss
