#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ct_clip_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. build the hand-written kernels from ct_clip_tpu_torch/csrc (one nvcc
     per source, all at once);
  2. kernel phase: each ported TPU kernel's wrapper against its plain
     PyTorch version on the same inputs, at the shapes its main path gives
     it: the CT-CLIP inference kernels at full width, batch 2, in bf16 (K6
     as the ingest calls it: one volume into a slot of the batch buffer);
     the RadBERT training attention (K7 f32, K12 and K13, forward and
     backward) at (32, 12, 512, 64) in f32, checked at batch 8 (the plain
     K13 holds a (b, 12, 512, 512) mask) and timed at batch 32, plus K13's
     determinism, kept share and forward/backward mask identity.  For each:
     max abs / rel error against a stated tolerance (K6, a pure move, must be
     bit-exact), median times (CUDA events) of the kernel, the plain version
     and, where one PyTorch call computes the same function, that call, and
     the bound: the least time the card could take, from the call's bytes
     and products and the H100's published peaks (bf16 tensor cores for the
     bf16 kernels, f32 CUDA cores for the f32 ones);
  3. zero-shot phase: a 3-volume synthetic CT-RATE corpus (NIfTI + CSVs +
     a toy vocab) through `run_zero_shot` at full CT-CLIP width (seeded
     random weights), batch 2 with a tail batch, twice: on the patch-row
     route (the default on CUDA: K6 ingest, K4 embed) and on the volume
     route (K8 embed).  Checks the (3, 18) probabilities, that the two
     routes agree, the artifacts, and that each route's kernels' launch
     counters rose; times `score_batch` on both routes.  Then
     `export_latents` on one volume (the volume route) with its counters;
  4. RadBERT phase: 64 synthetic reports with the 18 label columns and a
     generated vocab of CXR-BERT's size (30,522 entries) through the CLI's
     `radbert-train` (full RadBERT width, f32, batch 32, max length 512, 2
     epochs, validation on a second CSV, --out .pt), then `radbert-infer`
     and `radbert-eval` on that .pt, each with its launch counters (K13
     forward and backward in training, K7 f32 in validation and inference);
     checks the loss and the (64, 18) probabilities and times the training
     step.  Then one step of a 2-layer full-width RadBERT with
     attention_dropout 0, which must run K12;
  5. reference checks on small inputs: a tiny CT-CLIP scores the same
     volumes on the card (kernels) and on the CPU (plain versions), both
     bf16, from volumes and from patch rows, and must agree; a tiny RadBERT
     with both dropouts 0 takes one training step from the same weights on
     the card and on the CPU, and the logits, loss, gradients and updated
     weights must agree;
  6. CT-CLIP pretraining: the training kernels against their plain versions
     at full width, batch 8 (K11, K9, K10, K14, K15, K5 exact, K13 in bf16
     at CXR-BERT's batch 8 x 512), then `cli train` on a synthetic corpus of
     20 volumes (16 kept by the 80% split) at full width, batch 8, 4 steps,
     with one mini evaluation on 2 validation volumes and one checkpoint;
     every training counter must rise.  The step time (CUDA events), peak
     memory and a profiled step's breakdown and idle share follow, then a
     tiny CT-CLIP training step on the card against the CPU (both bf16, each
     gradient held against the CPU's own bf16-vs-f32 distance), the same
     card step with planted kernel faults that must fail that comparison,
     and a save -> resume round trip on the card.

Prints the end-to-end numbers and the kernel table as one JSON line each,
then the card's name and power limit (nvidia-smi), then
{"ok": true, "device": {...}} as the last line.  Working files go to
build/chip_smoke/ and are removed at the end.
"""
from __future__ import annotations

import csv
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B = 2  # volumes per batch
# max abs err <= REL_TOL * max|plain|: kernel and plain version round to bf16
# at the same points but sum in other orders, so an intermediate may land
# one bf16 ulp (2^-8 relative) apart and carry that through later stages
REL_TOL = 2e-2
# the f32 kernels run the same products as their plain versions in f32, in
# another summation order
F32_REL_TOL = 1e-4
# the two zero-shot routes see the same bf16 values and differ only in the
# order LN(4000) sums them: P(present) agree far inside this
ROUTE_TOL = 0.05
# NVIDIA H100 SXM published peaks (dense): bf16 tensor cores, f32 CUDA
# cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

PALLAS = "ct_clip_tpu/ops/pallas/"
CSRC = "ct_clip_tpu_torch/csrc/"


def _kernel(name, replaces, source, sources, counter, path):
    return dict(name=name, replaces=PALLAS + replaces, source=source,
                sources=sources, counter=counter, path=path)


# table entry -> its TPU kernel (Pallas function file:line), main CUDA
# source, every CUDA file its wrapper launches from, its launch counter and
# the driven path whose count the table reports
ATTN_TRAIN = ["attention_train.cu"]
KERNELS = {
    "patch_embed": _kernel("fused_patch_embed", "patchify.py:341", "layernorm.cu",
                           ["layernorm.cu", "gemm.cu"], "patch_embed", "zero_shot_volume"),
    "spatial_attention": _kernel("fused_spatial_qknorm_attention",
                                 "spatial_attention.py:276", "attention.cu",
                                 ["layernorm.cu", "gemm.cu", "attention.cu"],
                                 "spatial_attention", "zero_shot_rows"),
    "grid_attention": _kernel("fused_small_qknorm_attention_grid",
                              "small_attention.py:196", "attention.cu",
                              ["layernorm.cu", "gemm.cu", "attention.cu"],
                              "grid_attention", "zero_shot_rows"),
    "geglu_ff": _kernel("fused_geglu_ff", "ffn.py:105", "gemm.cu",
                        ["layernorm.cu", "gemm.cu"], "geglu_ff", "zero_shot_rows"),
    "vq_assign": _kernel("pallas_assign", "vq.py:104", "gemm.cu", ["gemm.cu"],
                         "vq_assign", "zero_shot_rows"),
    "fused_attention": _kernel("fused_attention", "attention.py:129", "attention_train.cu",
                               ATTN_TRAIN, "fused_attention", "zero_shot_rows"),
    "rearrange_patches": _kernel("rearrange_patches", "patchify.py:105", "rearrange.cu",
                                 ["rearrange.cu"], "rearrange_patches", "zero_shot_rows"),
    "row_embed": _kernel("fused_row_embed", "patchify.py:609", "layernorm.cu",
                         ["layernorm.cu", "gemm.cu"], "row_embed", "zero_shot_rows"),
    "fused_attention_f32": _kernel("fused_attention (f32)", "attention.py:129",
                                   "attention_train.cu", ATTN_TRAIN, "fused_attention",
                                   "radbert_train"),
    "attention_bwd": _kernel("_pallas_attention_bwd_kbias", "attention.py:271",
                             "attention_train.cu", ATTN_TRAIN, "attention_bwd",
                             "radbert_dropout_off"),
    "attention_dropout": _kernel("_pallas_attention_kbias_drop_impl", "attention.py:474",
                                 "attention_train.cu", ATTN_TRAIN, "attention_dropout",
                                 "radbert_train"),
    "attention_dropout_bwd": _kernel("_pallas_attention_kbias_drop_bwd",
                                     "attention.py:499", "attention_train.cu", ATTN_TRAIN,
                                     "attention_dropout_bwd", "radbert_train"),
    "geglu_ff_bwd": _kernel("_pallas_ff_bwd", "ffn.py:238", "gemm.cu",
                            ["layernorm.cu", "gemm.cu"], "geglu_ff_bwd", "ctclip_train"),
    "spatial_attention_bwd": _kernel("_pallas_spatial_bwd", "spatial_attention.py:297",
                                     "qknorm_attention_bwd.cu",
                                     ["layernorm.cu", "gemm.cu", "qknorm_attention_bwd.cu"],
                                     "spatial_attention_bwd", "ctclip_train"),
    "grid_attention_bwd": _kernel("_pallas_small_qknorm_bwd (grid_layout)",
                                  "small_attention.py:437", "qknorm_attention_bwd.cu",
                                  ["layernorm.cu", "gemm.cu", "qknorm_attention_bwd.cu"],
                                  "grid_attention_bwd", "ctclip_train"),
    "peg_bwd": _kernel("_pallas_peg_bwd", "peg.py:181", "peg_bwd.cu",
                       ["peg_bwd.cu", "gemm.cu"], "peg_bwd", "ctclip_train"),
    "vq_cluster_stats": _kernel("pallas_cluster_stats", "vq.py:168", "vq_stats.cu",
                                ["vq_stats.cu"], "vq_cluster_stats", "ctclip_train"),
    "vq_assign_exact": _kernel("pallas_assign (exact)", "vq.py:104", "gemm.cu", ["gemm.cu"],
                               "vq_assign_exact", "ctclip_train"),
    "attention_dropout_bf16": _kernel("_pallas_attention_kbias_drop_impl (bf16)",
                                      "attention.py:474", "attention_train.cu", ATTN_TRAIN,
                                      "attention_dropout", "ctclip_train"),
    "attention_dropout_bwd_bf16": _kernel("_pallas_attention_kbias_drop_bwd (bf16)",
                                          "attention.py:499", "attention_train.cu",
                                          ATTN_TRAIN, "attention_dropout_bwd", "ctclip_train"),
}
# launch counters each driven path must raise
COMMON = ["spatial_attention", "grid_attention", "geglu_ff", "vq_assign",
          "fused_attention"]
PATHS = {
    "zero_shot_rows": COMMON + ["rearrange_patches", "row_embed"],
    "zero_shot_volume": COMMON + ["patch_embed"],
    "export_latents": COMMON + ["patch_embed"],
    "radbert_train": ["attention_dropout", "attention_dropout_bwd", "fused_attention"],
    "radbert_infer": ["fused_attention"],
    "radbert_eval": ["fused_attention"],
    "radbert_dropout_off": ["fused_attention", "attention_bwd"],
    # the training step and the mini evaluation (K6 ingest, K4 embed, K5)
    "ctclip_train": ["geglu_ff_bwd", "spatial_attention_bwd", "grid_attention_bwd",
                     "peg_bwd", "vq_cluster_stats", "vq_assign_exact", "geglu_ff",
                     "spatial_attention", "grid_attention", "attention_dropout",
                     "attention_dropout_bwd", "rearrange_patches", "row_embed",
                     "vq_assign", "fused_attention"],
}
# training backwards: autograd of the plain forward in bf16 rounds each
# gradient tensor to bf16 where the kernels keep f32 (weight gradients, dxn)
# or round at the JAX kernels' points, a few bf16 ulps apart
BWD_REL_TOL = 3e-2
# exact bf16 products summed in f32, in another order
SUM_REL_TOL = 1e-5
TRAIN_B = 8  # volumes per training batch
# RadBERT training attention: (batch, heads, tokens, head dim), f32
BERT_SHAPE = (32, 12, 512, 64)
CHECK_BATCH = 8
DROP_RATE = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of `reps` timed calls (CUDA events), after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------- phase 2
def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(read_bytes: int, flops: float, peak: float = PEAK_BF16_FLOPS):
    """(ms, "bytes" | "operations"): the least time the card could take for
    a call that reads its inputs once, writes its output once and runs
    `flops` operations at the published `peak` (bf16 tensor cores unless
    stated) and the published memory rate."""
    t_bytes, t_ops = read_bytes / PEAK_BYTES, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_cases(dev):
    """name -> dict(kern, plain, library (one PyTorch call computing the same
    function, or None), inputs (tensors the call reads), flops) at the
    full-width shapes of the zero-shot path with B volumes per batch."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import attention_plain, fused_attention
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff, geglu_ff_plain
    from ct_clip_tpu_torch.ops.patch_embed import (
        fused_patch_embed, fused_row_embed, patch_embed_plain, rearrange_patches,
        rearrange_plain, row_embed_plain)
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_spatial_qknorm_attention,
        grid_qknorm_attention_plain, qknorm_attention_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    dim, heads, dh, hd, n_tok, pd = 512, 8, 32, 256, 13824, 4000
    tokens = B * n_tok
    cases = {}

    video = (torch.rand((B, 240, 480, 480), generator=g, device=dev) * 2 - 1).to(bf)
    pe = (1 + rn(pd, scale=0.1), rn(pd, scale=0.1), rn(dim, pd, scale=pd ** -0.5),
          rn(dim, scale=0.1), 1 + rn(dim, scale=0.1), rn(dim, scale=0.1))
    cases["patch_embed"] = dict(
        kern=lambda: fused_patch_embed(video, *pe, 10, 20),
        plain=lambda: patch_embed_plain(video, *pe, 10, 20), library=None,
        inputs=(video, *pe), flops=2 * tokens * pd * dim)
    rows = rearrange_plain(video, 10, 20)
    # as the ingest calls it: one volume into the last slot of the batch buffer
    one, slot = video[-1:], torch.empty_like(rows)[-1:]
    cases["rearrange_patches"] = dict(
        kern=lambda: rearrange_patches(one, 10, 20, out=slot),
        plain=lambda: rearrange_plain(one, 10, 20),
        library=lambda: one.reshape(1, 24, 10, 24, 20, 24, 20)
        .permute(0, 1, 3, 5, 2, 4, 6).contiguous(),
        inputs=(one,), flops=0)
    cases["row_embed"] = dict(
        kern=lambda: fused_row_embed(rows, *pe),
        plain=lambda: row_embed_plain(rows, *pe), library=None,
        inputs=(rows, *pe), flops=2 * tokens * pd * dim)

    w_attn = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5),
              rn(2 * hd, dim, scale=dim ** -0.5), 1 + rn(dh, scale=0.2),
              1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    proj_flops = 2 * tokens * dim * (hd + 2 * hd + hd)
    xs = rn(B * 24, 576, dim, dtype=bf)
    cpb = rn(heads, 576, 576)
    cases["spatial_attention"] = dict(
        kern=lambda: fused_spatial_qknorm_attention(xs, *w_attn, cpb, heads, dh),
        plain=lambda: qknorm_attention_plain(xs, *w_attn, cpb, heads, dh),
        library=None, inputs=(xs, *w_attn, cpb),
        flops=proj_flops + 4 * (B * 24) * heads * 576 * 576 * dh)
    xg = rn(B, 24, 576, dim, dtype=bf)
    cases["grid_attention"] = dict(
        kern=lambda: fused_grid_qknorm_attention(xg, *w_attn, heads, dh),
        plain=lambda: grid_qknorm_attention_plain(xg, *w_attn, heads, dh),
        library=None, inputs=(xg, *w_attn),
        flops=proj_flops + 4 * (B * 576) * heads * 24 * 24 * dh)

    xf = rn(tokens, dim, dtype=bf)
    w_ff = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1),
            rn(2730, dim, scale=dim ** -0.5), rn(dim, 1365, scale=1365 ** -0.5))
    cases["geglu_ff"] = dict(
        kern=lambda: fused_geglu_ff(xf, *w_ff), plain=lambda: geglu_ff_plain(xf, *w_ff),
        library=None, inputs=(xf, *w_ff), flops=2 * tokens * dim * (2730 + 1365))

    # BERT: 36 prompts x 12 heads x 512 positions x 64, head-major views of
    # the (b, n, h, d) projections, prompt-length pad masks
    q, k, v = (rn(36, 512, 12, 64, dtype=bf).transpose(1, 2) for _ in range(3))
    q = q * 64 ** -0.5
    lengths = torch.randint(5, 16, (36,), generator=g, device=dev)
    mask = (torch.arange(512, device=dev)[None] < lengths[:, None]).float()
    key_bias = (1 - mask) * torch.finfo(torch.float32).min
    sdpa_mask = key_bias.to(bf)[:, None, None, :]  # additive, in q's dtype
    cases["fused_attention"] = dict(
        kern=lambda: fused_attention(q, k, v, key_bias=key_bias),
        plain=lambda: attention_plain(q, k, v, key_bias=key_bias),
        library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                       scale=1.0),
        inputs=(q, k, v, key_bias), flops=4 * 36 * 12 * 512 * 512 * 64)
    return cases


def vq_case(dev):
    import torch

    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import vq_assign, vq_assign_plain

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((B * 13824, 512), generator=g, device=dev).to(torch.bfloat16)
    embed_n = l2norm(torch.randn((8192, 512), generator=g, device=dev))
    return x, embed_n, (lambda: vq_assign(x, embed_n)), (lambda: vq_assign_plain(x, embed_n))


def timing(case, out) -> dict:
    """Median kernel, plain and library times, and the bound, of one case
    (`out`: the tensor or tensors the call writes)."""
    ms, plain_ms = cuda_ms(case["kern"]), cuda_ms(case["plain"])
    library_ms = cuda_ms(case["library"]) if case["library"] else None
    outs = out if isinstance(out, (tuple, list)) else (out,)
    peak = case.get("peak", PEAK_BF16_FLOPS)
    bound_ms, bound_by = bound(nbytes(*case["inputs"], *outs), case["flops"], peak)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                peak_tflops=peak / 1e12, library_ms=library_ms,
                bound_share=bound_ms / ms)


def kernel_phase(dev):
    import torch

    results = {}
    for name, case in kernel_cases(dev).items():
        got, ref = case["kern"](), case["plain"]()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: bad kernel output {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        # K6 moves values: it must equal its plain version bit for bit
        exact = name == "rearrange_patches"
        res = dict(max_abs_err=err, max_rel_err=rel,
                   tolerance="bit-exact" if exact else f"rel {REL_TOL}",
                   **timing(case, got))
        lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.3f} ms"
        log(f"kernel {name}: max_abs_err {err:.4e} max_rel_err {rel:.4e} "
            f"({res['tolerance']}) kernel {res['ms']:.3f} ms plain "
            f"{res['plain_ms']:.3f} ms library {lib} bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}, {100 * res['bound_share']:.1f}% of it reached)")
        if (exact and not torch.equal(got, ref)) or rel > REL_TOL:
            raise AssertionError(f"{name}: error {err:.3e} (rel {rel:.3e}) "
                                 f"outside {res['tolerance']}")
        results[name] = res
        del got, ref

    x, embed_n, kern, plain = vq_case(dev)
    got, ref = kern().long(), plain().long()
    sim = x.float() @ embed_n.to(torch.bfloat16).float().t()
    gap = (sim.gather(1, ref[:, None]) - sim.gather(1, got[:, None])).abs()[:, 0]
    agree = (got == ref).float().mean().item()
    # a disagreement must be a near-tie within the bf16 margin (vq.py:17-22)
    margin_ok = bool((gap <= 4e-3 * sim.abs().max(dim=1).values).all())
    res = timing(dict(kern=kern, plain=plain, library=None,
                      inputs=(x, embed_n), flops=2 * x.shape[0] * 512 * 8192), got.int())
    log(f"kernel vq_assign: id agreement {agree:.6f} max sim gap "
        f"{gap.max().item():.4e} kernel {res['ms']:.3f} ms plain {res['plain_ms']:.3f} ms "
        f"library none bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
        f"{100 * res['bound_share']:.1f}% of it reached)")
    if agree < 0.99 or not margin_ok:
        raise AssertionError(f"vq_assign: agreement {agree}, near-ties {margin_ok}")
    results["vq_assign"] = dict(max_abs_err=gap.max().item(), id_agreement=agree,
                                tolerance=">= 0.99 ids equal, rest near-ties", **res)
    del sim, x, embed_n
    torch.cuda.empty_cache()
    return results


# ------------------------------------------ phase 2, RadBERT training attention
def train_attention_inputs(dev, b: int, seed: int):
    """BERT's (b, n, h, d) f32 projections viewed head-major, q scaled, a
    per-key pad bias from report lengths in [64, 512], an output gradient."""
    import torch

    _, h, n, d = BERT_SHAPE
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, n, h, d), generator=g, device=dev).transpose(1, 2)
               for _ in range(3))
    lengths = torch.randint(64, n + 1, (b,), generator=g, device=dev)
    mask = (torch.arange(n, device=dev)[None] < lengths[:, None]).float()
    key_bias = (1 - mask) * torch.finfo(torch.float32).min
    do = torch.randn((b, h, n, d), generator=g, device=dev)
    return q * d ** -0.5, k, v, key_bias, do


def sdpa_backend(q, k, v, mask, dropout_p: float) -> str:
    """The backend F.scaled_dot_product_attention dispatches these inputs to."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, attn_mask=mask, dropout_p=dropout_p,
                                              is_causal=False, scale=1.0)).name


def train_attention_cases(dev, b: int):
    """K7 f32, K13 forward, K12 and K13 backward at (b, 12, 512, 64): each
    case's kernel call (through the wrapper the model calls; a backward is
    torch.autograd.grad of a kept forward), plain version, library call
    (F.scaled_dot_product_attention in f32 with the additive key mask, or
    autograd.grad of a kept SDPA output), the tensors it reads and its
    products, at the f32 CUDA-core peak."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_dropout_plain, attention_plain, dropout_mask,
        fused_attention, fused_attention_kbias_dropout)

    _, h, n, d = BERT_SHAPE
    q, k, v, kb, do = train_attention_inputs(dev, b, seed=20)
    seed = torch.tensor([20231016], dtype=torch.int64, device=dev)
    sdpa_mask = kb[:, None, None, :]
    product = 2 * b * h * n * n * d
    leaves = [t.detach().requires_grad_() for t in (q, k, v, kb)]
    out_k12 = fused_attention(*leaves[:3], key_bias=leaves[3])
    out_k13 = fused_attention_kbias_dropout(*leaves, seed, DROP_RATE)
    lib_in = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=sdpa_mask, scale=1.0)
    lib_drop = F.scaled_dot_product_attention(*lib_in, attn_mask=sdpa_mask,
                                              dropout_p=DROP_RATE, scale=1.0)
    lse = torch.empty((b, h, n), device=dev)  # the residual a backward reads

    def grad(out, ins):
        return torch.autograd.grad(out, ins, do, retain_graph=True)

    def plain_bwd(mask=None):
        return tuple(t for t in attention_bwd_plain(q, k, v, do, key_bias=kb, mask=mask)
                     if t is not None)

    f32 = dict(peak=PEAK_F32_FLOPS)
    return {
        "fused_attention_f32": dict(
            kern=lambda: fused_attention(q, k, v, key_bias=kb),
            plain=lambda: attention_plain(q, k, v, key_bias=kb),
            library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                           scale=1.0),
            backend=sdpa_backend(q, k, v, sdpa_mask, 0.0),
            inputs=(q, k, v, kb), flops=2 * product, **f32),
        "attention_dropout": dict(
            kern=lambda: fused_attention_kbias_dropout(q, k, v, kb, seed, DROP_RATE),
            plain=lambda: attention_dropout_plain(q, k, v, kb, seed, DROP_RATE),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, dropout_p=DROP_RATE, scale=1.0),
            backend=sdpa_backend(q, k, v, sdpa_mask, DROP_RATE),
            inputs=(q, k, v, kb, seed), flops=2 * product, **f32),
        "attention_bwd": dict(
            kern=lambda: grad(out_k12, leaves), plain=plain_bwd,
            library=lambda: grad(lib_out, lib_in),
            backend=sdpa_backend(q, k, v, sdpa_mask, 0.0),
            inputs=(q, k, v, kb, do, out_k12, lse), flops=5 * product, **f32),
        "attention_dropout_bwd": dict(
            kern=lambda: grad(out_k13, leaves),
            plain=lambda: plain_bwd(dropout_mask(seed, b, h, n, DROP_RATE, dev)),
            library=lambda: grad(lib_drop, lib_in),
            backend=sdpa_backend(q, k, v, sdpa_mask, DROP_RATE),
            inputs=(q, k, v, kb, seed, do, out_k13, lse), flops=5 * product, **f32),
    }


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def dropout_checks(dev) -> dict:
    """K13 at (CHECK_BATCH, 12, 512, 64): the same seed gives the same bits;
    the kept share of the forward's and of the backward's mask lies within
    4 sigma of 1 - rate (uniform probabilities, v = 1 and dO = 1 turn the
    output and dv into kept counts); and the backward's mask is the
    forward's: the output is linear in v, so the difference of two forwards
    along a direction must equal the VJP's dv along it."""
    import torch

    from ct_clip_tpu_torch.ops.attention import (dropout_keep_scale,
                                                 fused_attention_kbias_dropout)

    b, (_, h, n, d) = CHECK_BATCH, BERT_SHAPE
    q, k, v, kb, _ = train_attention_inputs(dev, b, seed=21)
    seed = torch.tensor([77], dtype=torch.int64, device=dev)

    def f(v_):
        return fused_attention_kbias_dropout(q, k, v_, kb, seed, DROP_RATE)

    same = torch.equal(f(v), f(v))
    zeros, ones = torch.zeros_like(q), torch.ones_like(q)
    free = torch.zeros_like(kb)
    scale = dropout_keep_scale(DROP_RATE)
    v1 = ones.clone().requires_grad_()
    out = fused_attention_kbias_dropout(zeros, zeros, v1, free, seed, DROP_RATE)
    dv, = torch.autograd.grad(out, v1, ones)
    share_fwd = out[..., 0].double().mean().item() / scale
    share_bwd = dv[..., 0].double().sum().item() / (scale * b * h * n)
    sigma = (DROP_RATE * (1 - DROP_RATE) / (b * h * n * n)) ** 0.5

    g = torch.Generator(device=dev).manual_seed(22)
    direction = torch.randn(v.shape, generator=g, device=dev) * 0.1
    vg = v.detach().clone().requires_grad_()
    dv, = torch.autograd.grad(f(vg), vg, ones)
    jvp_fwd = (f(v + direction).double() - f(v).double()).sum().item()
    jvp_vjp = (dv.double() * direction.double()).sum().item()
    identity_rel = abs(jvp_fwd - jvp_vjp) / max(abs(jvp_vjp), 1.0)
    res = dict(deterministic=same, kept_share_fwd=share_fwd, kept_share_bwd=share_bwd,
               kept_share_4sigma=4 * sigma, mask_identity_rel_err=identity_rel)
    log(f"kernel attention_dropout: same seed same output {same}; kept share "
        f"forward {share_fwd:.6f} backward {share_bwd:.6f} (1 - rate {1 - DROP_RATE}, "
        f"4 sigma {4 * sigma:.2e}); forward/backward mask identity rel err "
        f"{identity_rel:.2e} (tol {F32_REL_TOL})")
    if not same or identity_rel > F32_REL_TOL or any(
            abs(x - (1 - DROP_RATE)) > 4 * sigma for x in (share_fwd, share_bwd)):
        raise AssertionError(f"attention_dropout checks failed: {res}")
    return res


def train_attention_phase(dev) -> dict:
    """Check at batch CHECK_BATCH against the plain versions (relative to the
    largest plain value of each output), then time at the full batch."""
    import torch

    results = {}
    for name, case in train_attention_cases(dev, CHECK_BATCH).items():
        got, ref = _as_tuple(case["kern"]()), _as_tuple(case["plain"]())
        torch.cuda.synchronize()
        if len(got) != len(ref) or any(g.shape != r.shape or not torch.isfinite(g).all()
                                       for g, r in zip(got, ref)):
            raise AssertionError(f"{name}: bad kernel outputs")
        errs = [(g - r).abs().max().item() for g, r in zip(got, ref)]
        rels = [e / r.abs().max().item() for e, r in zip(errs, ref)]
        results[name] = dict(max_abs_err=max(errs), max_rel_err=max(rels),
                             tolerance=f"rel {F32_REL_TOL} per output", check_batch=CHECK_BATCH)
        if max(rels) > F32_REL_TOL:
            raise AssertionError(f"{name}: rel errors {rels} outside {F32_REL_TOL}")
        del got, ref
    results["attention_dropout"].update(dropout_checks(dev))
    torch.cuda.empty_cache()

    for name, case in train_attention_cases(dev, BERT_SHAPE[0]).items():
        res = results[name]
        res.update(timing(case, _as_tuple(case["kern"]())), library_backend=case["backend"],
                   shape=list(BERT_SHAPE))
        log(f"kernel {name}: max_abs_err {res['max_abs_err']:.4e} max_rel_err "
            f"{res['max_rel_err']:.4e} (rel {F32_REL_TOL}, batch {CHECK_BATCH}) at "
            f"{tuple(BERT_SHAPE)} f32: kernel {res['ms']:.3f} ms plain "
            f"{res['plain_ms']:.3f} ms library {res['library_ms']:.3f} ms (SDPA "
            f"{case['backend']}) bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
            f"f32 peak, {100 * res['bound_share']:.1f}% of it reached)")
    torch.cuda.empty_cache()
    return results


# ------------------------------------------- phase 2, CT-CLIP training kernels
def _rel_errors(got, ref):
    """(max abs err, max over outputs of abs err / max|plain|)."""
    errs, rels = [], []
    for g, r in zip(got, ref):
        if g is None and r is None:
            continue
        if g.shape != r.shape or not torch_finite(g):
            raise AssertionError(f"bad kernel output {tuple(g.shape)} vs {tuple(r.shape)}")
        e = (g.float() - r.float()).abs().max().item()
        errs.append(e)
        rels.append(e / max(r.float().abs().max().item(), 1e-30))
    return max(errs), max(rels)


def torch_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def train_kernel_cases(dev):
    """The CT-CLIP training kernels at full width, batch 8 (K13 at CXR-BERT's
    batch 8 x 512): each case's kernel call through the wrapper the model
    calls (a backward is torch.autograd.grad of a kept forward), its plain
    version, a library call where one computes the same function, the
    tensors it reads and writes, its products and its tolerance."""
    import torch
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_dropout_plain, dropout_mask,
        fused_attention_kbias_dropout, peg_dw, peg_dw_plain)
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff, geglu_ff_bwd_plain
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_spatial_qknorm_attention,
        grid_qknorm_attention_bwd_plain, qknorm_attention_bwd_plain)
    from ct_clip_tpu_torch.ops.vq import (cluster_stats, cluster_stats_plain, vq_assign,
                                          vq_assign_plain)

    g = torch.Generator(device=dev).manual_seed(30)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    dim, heads, dh, hd, n_tok, inner = 512, 8, 32, 256, 13824, 1365
    R = TRAIN_B * n_tok

    def grad_case(fn, leaves, do):
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)

    # K11
    x, do = rn(R, dim, dtype=bf), rn(R, dim, dtype=bf)
    w = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1), rn(2 * inner, dim, scale=dim ** -0.5),
         rn(dim, inner, scale=inner ** -0.5))
    leaves = [t.requires_grad_() for t in (x.clone(), *w)]
    yield "geglu_ff_bwd", dict(
        kern=grad_case(fused_geglu_ff, leaves, do),
        plain=lambda: geglu_ff_bwd_plain(x, *w, do), library=None,
        inputs=(x, do, *w), outputs=(x, *w), flops=2 * R * dim * 8 * inner,
        tol=BWD_REL_TOL)
    del x, do, w, leaves

    # K9, K10: the same weights; spatial planes with the CPB bias, the grid
    w_attn = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5),
              rn(2 * hd, dim, scale=dim ** -0.5), 1 + rn(dh, scale=0.2),
              1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    proj = 2 * R * dim * hd * 11
    xs, dos, cpb = rn(TRAIN_B * 24, 576, dim, dtype=bf), rn(TRAIN_B * 24, 576, dim, dtype=bf), \
        rn(heads, 576, 576)
    leaves = [t.clone().requires_grad_() for t in (xs, *w_attn, cpb)]
    yield "spatial_attention_bwd", dict(
        kern=grad_case(lambda *a: fused_spatial_qknorm_attention(*a, heads, dh), leaves, dos),
        plain=lambda: qknorm_attention_bwd_plain(xs, *w_attn, cpb, dos, heads, dh),
        library=None, inputs=(xs, dos, *w_attn, cpb), outputs=(xs, *w_attn, cpb),
        flops=proj + 12 * TRAIN_B * 24 * heads * 576 * 576 * dh, tol=BWD_REL_TOL)
    del xs, dos, cpb, leaves
    xg, dog = rn(TRAIN_B, 24, 576, dim, dtype=bf), rn(TRAIN_B, 24, 576, dim, dtype=bf)
    leaves = [t.clone().requires_grad_() for t in (xg, *w_attn)]
    yield "grid_attention_bwd", dict(
        kern=grad_case(lambda *a: fused_grid_qknorm_attention(*a, heads, dh), leaves, dog),
        plain=lambda: grid_qknorm_attention_bwd_plain(xg, *w_attn, dog, heads, dh),
        library=None, inputs=(xg, dog, *w_attn), outputs=(xg, *w_attn),
        flops=proj + 12 * TRAIN_B * 576 * heads * 24 * 24 * dh, tol=BWD_REL_TOL)
    del xg, dog, leaves, w_attn

    # K14 on the frame-causal PEG (leading pads t 2, h 1, w 1); the library
    # call is cuDNN's weight and bias gradient of the same padded conv
    xp, dop = rn(TRAIN_B, 24, 24, 24, dim, dtype=bf), rn(TRAIN_B, 24, 24, 24, dim, dtype=bf)
    weight = rn(dim, 1, 3, 3, 3, scale=0.2, dtype=bf)

    def cudnn_dw():
        xc = F.pad(xp.permute(0, 4, 1, 2, 3), [1, 1, 1, 1, 2, 0])
        return torch.ops.aten.convolution_backward(
            dop.permute(0, 4, 1, 2, 3), xc, weight, [dim], [1, 1, 1], [0, 0, 0],
            [1, 1, 1], False, [0, 0, 0], dim, [False, True, True])[1:]
    yield "peg_bwd", dict(
        kern=lambda: peg_dw(xp, dop, (2, 1, 1)), plain=lambda: peg_dw_plain(xp, dop, (2, 1, 1)),
        library=cudnn_dw, inputs=(xp, dop), outputs=(torch.empty(28, dim, device=dev),),
        flops=2 * 27 * xp.numel(), tol=SUM_REL_TOL)
    del xp, dop, weight

    # K15 on uniform random ids (13.5 rows per code); library: index_add_ of
    # the normalised rows and bincount
    xv = rn(R, dim, dtype=bf)
    ids = torch.randint(0, 8192, (R,), generator=g, device=dev, dtype=torch.int32)

    def lib_stats():
        esum = torch.zeros(8192, dim, device=dev).index_add_(0, ids.long(), l2norm(xv.float()))
        return torch.bincount(ids, minlength=8192), esum
    yield "vq_cluster_stats", dict(
        kern=lambda: cluster_stats(xv, ids, 8192), plain=lambda: cluster_stats_plain(xv, ids, 8192),
        library=lib_stats, inputs=(xv, ids),
        outputs=(torch.empty(8192, device=dev), torch.empty(8192, dim, device=dev)),
        flops=3 * R * dim, tol=SUM_REL_TOL)
    del ids

    # K5 exact: ids, checked as the inference K5 (agreement, near-ties)
    embed_n = l2norm(rn(8192, dim))
    yield "vq_assign_exact", dict(
        kern=lambda: vq_assign(xv, embed_n, exact=True),
        plain=lambda: vq_assign_plain(xv, embed_n, exact=True), library=None,
        inputs=(xv, embed_n), outputs=(torch.empty(R, dtype=torch.int32, device=dev),),
        flops=2 * 2 * R * dim * 8192, ids=True)
    del xv, embed_n

    # K13 in bf16 at CXR-BERT's training batch (8, 12, 512, 64)
    b, h, n, d = TRAIN_B, 12, 512, 64
    q, k, v = (rn(b, n, h, d, dtype=bf).transpose(1, 2) for _ in range(3))
    q = q * d ** -0.5
    lengths = torch.randint(64, n + 1, (b,), generator=g, device=dev)
    kb = (1 - (torch.arange(n, device=dev)[None] < lengths[:, None]).float()) \
        * torch.finfo(f32).min
    dob = rn(b, h, n, d, dtype=bf)
    seed = torch.tensor([20261016], dtype=torch.int64, device=dev)
    mask = dropout_mask(seed, b, h, n, DROP_RATE, dev)
    sdpa_mask = kb.to(bf)[:, None, None, :]
    product = 2 * b * h * n * n * d
    yield "attention_dropout_bf16", dict(
        kern=lambda: fused_attention_kbias_dropout(q, k, v, kb, seed, DROP_RATE),
        plain=lambda: attention_dropout_plain(q, k, v, kb, seed, DROP_RATE),
        library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask,
                                                       dropout_p=DROP_RATE, scale=1.0),
        inputs=(q, k, v, kb, seed), outputs=(q,), flops=2 * product, tol=BWD_REL_TOL)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, kb)]
    out = fused_attention_kbias_dropout(*leaves, seed, DROP_RATE)
    lib_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=sdpa_mask,
                                             dropout_p=DROP_RATE, scale=1.0)
    yield "attention_dropout_bwd_bf16", dict(
        kern=lambda: torch.autograd.grad(out, leaves, dob, retain_graph=True),
        plain=lambda: tuple(t for t in attention_bwd_plain(q, k, v, dob, key_bias=kb,
                                                           mask=mask) if t is not None),
        library=lambda: torch.autograd.grad(lib_out, lib_in, dob, retain_graph=True),
        inputs=(q, k, v, kb, seed, dob), outputs=(q, k, v, kb), flops=5 * product,
        tol=BWD_REL_TOL)


def train_kernel_phase(dev) -> dict:
    import torch

    results = {}
    for name, case in train_kernel_cases(dev):
        got, ref = _as_tuple(case["kern"]()), _as_tuple(case["plain"]())
        torch.cuda.synchronize()
        if case.get("ids"):
            x, embed_n = case["inputs"]
            from ct_clip_tpu_torch.ops.vq import split_hi_lo

            hi, lo = split_hi_lo(embed_n)
            sims = [x.float() @ hi.float().t() + x.float() @ lo.float().t()]
            gi, ri = got[0].long(), ref[0].long()
            gap = (sims[0].gather(1, ri[:, None]) - sims[0].gather(1, gi[:, None])).abs()[:, 0]
            agree = (gi == ri).float().mean().item()
            margin = sims[0].abs().max(dim=1).values
            ok = agree >= 0.999 and bool((gap <= 1e-5 * margin).all())
            res = dict(max_abs_err=gap.max().item(), max_rel_err=None, id_agreement=agree,
                       tolerance=">= 0.999 ids equal, the rest ties within 1e-5")
            del sims
        else:
            err, rel = _rel_errors(got, ref)
            ok = rel <= case["tol"]
            res = dict(max_abs_err=err, max_rel_err=rel, tolerance=f"rel {case['tol']}")
        if not ok:
            raise AssertionError(f"{name}: outside tolerance: {res}")
        del got, ref
        torch.cuda.empty_cache()
        res.update(timing(case, case["outputs"]), batch=TRAIN_B)
        lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.3f} ms"
        log(f"kernel {name}: max_abs_err {res['max_abs_err']:.4e} max_rel_err "
            f"{res['max_rel_err'] if res['max_rel_err'] is None else round(res['max_rel_err'], 6)} "
            f"({res['tolerance']}) batch {TRAIN_B}: kernel {res['ms']:.3f} ms plain "
            f"{res['plain_ms']:.3f} ms library {lib} bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}, {100 * res['bound_share']:.1f}% of it reached)")
        results[name] = res
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phase 3
def write_corpus(root: Path, shapes, spacing_xy: float, spacing_z: float):
    from ct_clip_tpu_torch.config import PATHOLOGIES
    from ct_clip_tpu_torch.data import write_volume
    from ct_clip_tpu_torch.data.tokenizer import WordPieceTokenizer
    from ct_clip_tpu_torch.inference import pathology_prompts

    rng = np.random.RandomState(0)
    names = []
    for i, shape in enumerate(shapes):
        name = f"valid_{i}_a_1.nii.gz"
        folder = root / "data" / f"valid_{i}" / f"valid_{i}_a"
        folder.mkdir(parents=True)
        vol = rng.randint(0, 2000, shape).astype(np.int16)  # (x, y, z) stored ints
        write_volume(folder / name, vol, (spacing_xy, spacing_xy, spacing_z))
        names.append(name)
    rows = {
        "reports.csv": (["VolumeName", "Findings_EN", "Impressions_EN"],
                        [{"VolumeName": n, "Findings_EN": "No acute findings.",
                          "Impressions_EN": ""} for n in names]),
        "meta.csv": (["VolumeName", "XYSpacing", "ZSpacing", "RescaleSlope",
                      "RescaleIntercept"],
                     [{"VolumeName": n, "XYSpacing": f"[{spacing_xy}, {spacing_xy}]",
                       "ZSpacing": str(spacing_z), "RescaleSlope": "1",
                       "RescaleIntercept": "-1024"} for n in names]),
        "labels.csv": (["VolumeName"] + list(PATHOLOGIES),
                       [dict(VolumeName=n, **{p: int(rng.rand() < 0.3)
                                              for p in PATHOLOGIES}) for n in names]),
    }
    for fname, (fields, data) in rows.items():
        with open(root / fname, "w", newline="") as f:
            w = csv.DictWriter(f, fields)
            w.writeheader()
            w.writerows(data)
    basic = WordPieceTokenizer({"[UNK]": 0})._basic_tokenize
    words = sorted({w for p in pathology_prompts() for w in basic(p)})
    (root / "vocab.txt").write_text(
        "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    return [str(root / x) for x in ("data", "reports.csv", "meta.csv", "labels.csv")]


def drive(name: str, fn):
    """Run one path with every launch counter set to 0 just before it, read
    the counters just after, and require that the path's kernels ran."""
    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    log(f"e2e {name}: {secs:.2f} s (host clock); launch counts {counts}")
    missing = [k for k in PATHS[name] if counts[k] < 1]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    return out, counts, secs


def check_predictions(name: str, out, results: Path):
    pred = out["predicted"]
    if pred.shape != (3, 18) or not np.isfinite(pred).all() \
            or pred.min() < 0 or pred.max() > 1:
        raise AssertionError(f"{name}: bad predictions {pred.shape} {pred}")
    for fname in ("predicted_weights.npz", "labels_weights.npz", "accessions.txt",
                  "aurocs.csv"):
        if not (results / fname).exists():
            raise AssertionError(f"{name}: missing artifact {fname}")


def end_to_end_phase(dev, work: Path, card: str):
    import torch

    from ct_clip_tpu_torch.config import CTCLIPConfig
    from ct_clip_tpu_torch.data import CTReportDatasetInfer, WordPieceTokenizer
    from ct_clip_tpu_torch.inference import (ZeroShotClassifier, export_latents,
                                             run_zero_shot)
    from ct_clip_tpu_torch.models import CTCLIP

    # 256 x 256 x 60 at 1.5 x 1.5 x 6 mm resamples to 240 x 512 x 512 and
    # crops to the 240 x 480 x 480 model grid
    paths = write_corpus(work, [(256, 256, 60)] * 3, 1.5, 6.0)
    tok = WordPieceTokenizer(str(work / "vocab.txt"))
    ds = CTReportDatasetInfer(*paths)
    t0 = time.perf_counter()
    model = CTCLIP(CTCLIPConfig(), dtype=torch.bfloat16, device=dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"e2e: full-width CT-CLIP built ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
        f"params) in {time.perf_counter() - t0:.1f} s")

    counts, outs = {}, {}
    for name, rows in (("zero_shot_rows", None), ("zero_shot_volume", False)):
        results = work / name
        outs[name], counts[name], secs = drive(name, lambda: run_zero_shot(
            model, tok, ds, str(results), batch_size=B, num_workers=2,
            patch_rows=rows))
        check_predictions(name, outs[name], results)
        log(f"e2e {name}: run_zero_shot scored 3 volumes = {3 / secs:.3f} volumes/s "
            f"(prompt encoding and NIfTI decode included) on {card}")
    # the rows route is the default on CUDA, and each route skips the other's embed
    if counts["zero_shot_rows"]["patch_embed"] or counts["zero_shot_volume"]["row_embed"] \
            or counts["zero_shot_volume"]["rearrange_patches"]:
        raise AssertionError("a zero-shot route ran the other route's embed")
    route_diff = float(np.abs(outs["zero_shot_rows"]["predicted"]
                              - outs["zero_shot_volume"]["predicted"]).max())
    log(f"e2e: P(present) rows route vs volume route max abs diff {route_diff:.4e} "
        f"(tol {ROUTE_TOL})")
    if route_diff > ROUTE_TOL:
        raise AssertionError(f"the zero-shot routes disagree: {route_diff}")

    # export-latents, the second serving entry point, on one volume
    one = write_corpus(work / "one", [(256, 256, 60)], 1.5, 6.0)
    lat, counts["export_latents"], _ = drive("export_latents", lambda: export_latents(
        model, tok, CTReportDatasetInfer(*one), str(work / "latents"), num_workers=1))
    vcfg = model.config.ctvit
    grid = (vcfg.patch_t, vcfg.patch_hw, vcfg.patch_hw, vcfg.dim)
    for kind, shape in (("image", grid), ("text", (model.config.dim_latent,))):
        files = sorted((work / "latents" / f"{kind}_latents").glob("*.npz"))
        arrs = [np.load(f)["arr"] for f in files]
        if len(arrs) != 1 or arrs[0].shape != shape or not np.isfinite(arrs[0]).all():
            raise AssertionError(f"export_latents: bad {kind} latents "
                                 f"{[a.shape for a in arrs]}")
    log(f"e2e export_latents: image {grid} and text ({model.config.dim_latent},) "
        "latents finite")

    # steady-state device time of one scored batch (embed + encode + scoring)
    clf = ZeroShotClassifier(model, tok)
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = {"zero_shot_rows": (B, vcfg.patch_t * vcfg.patch_hw ** 2, vcfg.patch_dim),
              "zero_shot_volume": (B, vcfg.num_frames, vcfg.image_size,
                                   vcfg.image_size, 1)}
    inputs = {name: torch.rand(shape, generator=g, device=dev) * 2 - 1
              for name, shape in shapes.items()}
    batch_ms = {}
    with torch.inference_mode():
        clf.prompt_latents()
        for name, x in inputs.items():
            x = x.to(torch.bfloat16)
            batch_ms[name] = cuda_ms(lambda: clf.score_batch(x), reps=5)
            log(f"e2e {name}: score_batch({B}) {batch_ms[name]:.2f} ms = "
                f"{B / batch_ms[name] * 1e3:.2f} volumes/s device-side on {card}")
            if name == "zero_shot_rows":
                profile = profile_step(lambda: clf.score_batch(x), CTCLIP_GROUPS,
                                       "zero-shot score_batch (rows)")
            del x
    return counts, route_diff, batch_ms, profile


# ---------------------------------------------------------------- phase 4
def report_words():
    """The words of the synthetic reports: the pathology names' words, a few
    report words and 1,000 generated terms."""
    from ct_clip_tpu_torch.config import PATHOLOGIES

    words = {w.lower() for p in PATHOLOGIES for w in p.split()}
    words |= {"no", "the", "is", "seen", "present", "not", "of", "with", "and", "mild",
              "lung", "right", "left", "lobe", "chest", "ct"}
    return sorted(words) + [f"term{i:04d}" for i in range(1000)]


def write_reports(path: Path, n: int, seed: int) -> str:
    """n synthetic reports of 20-600 words (some beyond the 512-token
    truncation) with random 0/1 labels in the 18 pathology columns."""
    from ct_clip_tpu_torch.config import PATHOLOGIES

    rng = np.random.RandomState(seed)
    words = report_words()
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, ["report"] + list(PATHOLOGIES))
        w.writeheader()
        for _ in range(n):
            text = " ".join(rng.choice(words, rng.randint(20, 600)))
            text = ". ".join(text[i:i + 80] for i in range(0, len(text), 80)) + "."
            w.writerow({"report": text, **{p: int(rng.rand() < 0.3) for p in PATHOLOGIES}})
    return str(path)


def write_vocab(path: Path, size: int = 30522) -> str:
    """A generated WordPiece vocab of CXR-BERT's size: the special tokens,
    the report words, '.', and filler entries."""
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "."] + report_words()
    words += [f"[unused{i}]" for i in range(size - len(words))]
    path.write_text("\n".join(words) + "\n")
    return str(path)


# kernel-name fragments of the groups a training step's device time is read in
STEP_GROUPS = (
    ("K13/K12 backward (attention_train.cu)", ("bwd_dq_kernel<", "bwd_dkv_kernel<",
                                               "rowdot_kernel<", "dkb_sum_kernel")),
    ("K13/K7 forward (attention_train.cu)", ("::fwd_kernel<",)),
    ("f32 matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas")),
    ("AdamW (multi-tensor)", ("multi_tensor", "foreach")),
)
STEP_OTHER = "other (LayerNorm, GELU, dropout, elementwise, embedding)"


def device_busy_ms(prof):
    """(busy, span) ms of a profile: the union of its device events' [start,
    end) intervals (kernels that overlap, as cuDNN's per-group convolutions
    do, count once), and first start to last end."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("profile: no device events recorded")
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + hi - lo, s
        hi = max(hi, e)
    busy += hi - lo
    return busy / 1e3, (max(e for _, e in spans) - spans[0][0]) / 1e3


def profile_step(step, groups_spec=STEP_GROUPS, label: str = "radbert") -> dict:
    """Device time of one step by kernel (torch.profiler over a synchronised
    step, after a warm-up), grouped by `groups_spec` (kernel-name fragments,
    first match wins: summed kernel times, which count overlapping kernels
    each), and the idle share of the step's host-clock time: 1 - the union
    of the device intervals over it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    summed = sum(ms for _, ms, _ in kernels)
    busy, span = device_busy_ms(prof)
    groups = {name: 0.0 for name, _ in groups_spec}
    groups[STEP_OTHER] = 0.0
    for key, ms, _ in kernels:
        low = key.lower()
        group = next((g for g, frags in groups_spec if any(f in low for f in frags)),
                     STEP_OTHER)
        groups[group] += ms
    idle = 1 - busy / wall_ms
    log(f"{label} step profile: device busy (union of intervals) {busy:.2f} ms of "
        f"{wall_ms:.2f} ms host clock, idle share {idle:.4f} (profiler on); first to last "
        f"device event {span:.2f} ms; kernel times summed {summed:.2f} ms; by group (summed) "
        + "; ".join(f"{g} {ms:.2f} ms" for g, ms in groups.items()))
    for key, ms, count in kernels[:12]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:110]}")
    return dict(busy_ms=busy, wall_ms=wall_ms, idle_share=idle, device_span_ms=span,
                summed_kernel_ms=summed, groups=groups,
                top=[dict(kernel=k[:160], ms=ms, count=c) for k, ms, c in kernels[:12]])


def radbert_phase(dev, work: Path, card: str) -> dict:
    """radbert-train / -infer / -eval through the CLI at full RadBERT width,
    the training step time, and the dropout-off step (K12)."""
    import torch

    from ct_clip_tpu_torch import cli
    from ct_clip_tpu_torch.config import PATHOLOGIES, RadBertConfig
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.models import RadBertClassifier
    from ct_clip_tpu_torch.train import ReportClassificationDataset, TextClassifierTrainer

    vocab = write_vocab(work / "radbert_vocab.txt")
    train_csv = write_reports(work / "reports_train.csv", 64, seed=0)
    valid_csv = write_reports(work / "reports_valid.csv", 64, seed=1)
    pt, inferred, report = (str(work / x) for x in ("radbert.pt", "inferred.csv",
                                                    "radbert_report.json"))
    base = ["--vocab", vocab, "--device", "cuda", "--seed", "0"]
    counts = {}
    result, counts["radbert_train"], train_s = drive("radbert_train", lambda: cli.main(
        base + ["radbert-train", "--reports", train_csv, "--reports-valid", valid_csv,
                "--batch-size", "32", "--epochs", "2", "--out", pt]))
    hist = result["history"]
    losses = [h[k] for h in hist for k in ("train_loss", "valid_loss")]
    log(f"radbert-train: 2 epochs x 2 steps of 32 reports at full width in {train_s:.2f} s "
        f"(host clock, model build, validation and the .pt included); history {hist}")
    if len(hist) != 2 or not np.isfinite(losses + [result["best_loss"]]).all():
        raise AssertionError(f"radbert-train: bad history {hist}")

    _, counts["radbert_infer"], _ = drive("radbert_infer", lambda: cli.main(
        base + ["radbert-infer", "--reports", valid_csv, "--head", pt, "--out", inferred]))
    rows = list(csv.DictReader(open(inferred)))
    if len(rows) != 64 or any(r[p] not in ("0", "1") for r in rows for p in PATHOLOGIES):
        raise AssertionError("radbert-infer: bad inferred CSV")
    probs, counts["radbert_eval"], _ = drive("radbert_eval", lambda: cli.main(
        base + ["radbert-eval", "--reports", valid_csv, "--head", pt, "--out", report]))
    rep = json.loads(Path(report).read_text())
    if probs.shape != (64, 18) or not np.isfinite(probs).all() or probs.min() < 0 \
            or probs.max() > 1 or PATHOLOGIES[0] not in rep:
        raise AssertionError(f"radbert-eval: bad probabilities {probs.shape} or report")
    log(f"radbert-infer / -eval: 64 reports, P in [{probs.min():.4f}, {probs.max():.4f}], "
        f"macro avg f1 {rep['macro avg']['f1-score']:.4f}")

    # steady-state training step (CUDA events), from the trained weights
    tok = WordPieceTokenizer(vocab)
    model = RadBertClassifier(RadBertConfig(vocab_size=tok.vocab_size), device=dev)
    cli.load_radbert_checkpoint(model, pt)
    trainer = TextClassifierTrainer(model, tok, batch_size=32)
    batch = next(ReportClassificationDataset(train_csv).batches(tok, 32, shuffle=False))
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = trainer.train_step(batch, 2e-5, i)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step = statistics.median(step_ms[1:])
    log(f"radbert step: batch 32 x 512 tokens, full width, f32: median {step:.2f} ms of "
        f"steps 2-5 {[round(t, 2) for t in step_ms]} = {32 / step * 1e3:.1f} reports/s; "
        f"peak memory {peak_gb:.2f} GB; loss {loss.item():.4f} on {card}")
    breakdown = profile_step(lambda: trainer.train_step(batch, 2e-5, 9))
    del model, trainer
    torch.cuda.empty_cache()

    # the same step with attention dropout off runs K7 and K12, not K13
    cfg = RadBertConfig(vocab_size=tok.vocab_size, num_hidden_layers=2,
                        attention_dropout=0.0)
    model = RadBertClassifier(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(1))
    trainer = TextClassifierTrainer(model, tok, batch_size=32)
    loss, counts["radbert_dropout_off"], _ = drive(
        "radbert_dropout_off", lambda: trainer.train_step(batch, 2e-5, 0))
    if not np.isfinite(loss.item()) or counts["radbert_dropout_off"]["attention_dropout"]:
        raise AssertionError("radbert dropout-off step: bad loss or K13 launched")
    del model, trainer
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms=step, step_ms_all=step_ms, peak_gb=peak_gb,
                history=hist, train_cli_s=train_s, step_breakdown=breakdown)


# ---------------------------------------------------------------- phase 5
def small_reference_phase(dev, work: Path):
    """Tiny CT-CLIP: card (kernels) vs CPU (plain versions), same weights,
    both bf16, from volumes (K8) and from patch rows (K6 on the card, K4).
    Both round to bf16 at the same points; they differ in summation order,
    so the P(present) agree to 0.05 (a pair softmax at temperature e of
    latents ~1% apart)."""
    import torch

    from ct_clip_tpu_torch.config import BertConfig, CTCLIPConfig, CTViTConfig
    from ct_clip_tpu_torch.inference import ZeroShotClassifier
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.ops.patch_embed import rearrange_patches

    cfg = CTCLIPConfig(
        dim_text=64, dim_image=9 * 64, dim_latent=32,
        ctvit=CTViTConfig(dim=64, codebook_size=128, image_size=48, patch_size=16,
                          temporal_patch_size=4, num_frames=12, spatial_depth=2,
                          temporal_depth=2, dim_head=16, heads=4),
        bert=BertConfig(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128))
    tok = WordPieceTokenizer(str(work / "vocab.txt"))
    cpu = CTCLIP(cfg, dtype=torch.bfloat16).eval()
    cpu.init_weights(torch.Generator().manual_seed(1))
    gpu = CTCLIP(cfg, dtype=torch.bfloat16, device=dev).eval()
    gpu.load_state_dict(cpu.state_dict())
    video = torch.rand((3, 12, 48, 48, 1), generator=torch.Generator().manual_seed(2))
    video = (video * 2 - 1).to(torch.bfloat16)
    ref_clf = ZeroShotClassifier(cpu, tok, max_text_len=64)
    gpu_clf = ZeroShotClassifier(gpu, tok, max_text_len=64)
    errs = {}
    for route in ("volume", "rows"):
        if route == "volume":
            ref = ref_clf.score_batch(video)
            got = gpu_clf.score_batch(video.to(dev)).cpu()
        else:
            ref = ref_clf.score_batch(rearrange_patches(video[..., 0], 4, 16))
            got = gpu_clf.score_batch(rearrange_patches(video[..., 0].to(dev), 4, 16)).cpu()
        err = errs[route] = (got - ref).abs().max().item()
        log(f"reference: tiny CT-CLIP P(present) from {route}, card vs CPU max abs "
            f"diff {err:.4e} (tol 0.05)")
        if got.shape != (3, 18) or not torch.isfinite(got).all() or err > 0.05:
            raise AssertionError(f"small-input reference ({route}) disagrees: {err}")
    return errs


def radbert_reference_phase(dev, work: Path) -> dict:
    """One training step of a tiny RadBERT (2 layers, width 128, 2 heads of
    64, both dropouts 0, batch 8 x 512 tokens) from the same weights on the
    card (K7 f32, K12) and on the CPU (plain versions), both f32.  They sum
    in other orders: logits and loss within 1e-5 relative, each parameter's
    gradient within 1e-4 of its largest entry, the updated weights within
    1e-5.  The key biases' gradient is zero in exact arithmetic (softmax is
    shift invariant), so both sides hold rounding noise there, which Adam
    turns into steps of up to lr: they are held to that bound."""
    import torch

    from ct_clip_tpu_torch.config import RadBertConfig
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.models import RadBertClassifier
    from ct_clip_tpu_torch.train import ReportClassificationDataset, TextClassifierTrainer

    tok = WordPieceTokenizer(str(work / "radbert_vocab.txt"))
    cfg = RadBertConfig(vocab_size=tok.vocab_size, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        hidden_dropout=0.0, attention_dropout=0.0)
    cpu = RadBertClassifier(cfg).init_weights(torch.Generator().manual_seed(5))
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    gpu = RadBertClassifier(cfg, device=dev)
    gpu.load_state_dict(start)
    batch = next(ReportClassificationDataset(str(work / "reports_valid.csv")).batches(
        tok, 8, shuffle=False))
    lr, out = 1e-3, {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        tr = TextClassifierTrainer(model, tok, lr=lr, batch_size=8)
        with torch.no_grad():
            ids, mask = (torch.from_numpy(batch[k]).to(tr.device)
                         for k in ("input_ids", "attention_mask"))
            logits = model.eval()(ids, mask).cpu()
        loss = tr.train_step(batch, lr).item()
        out[name] = dict(logits=logits, loss=loss,
                         grads={n: p.grad.cpu() for n, p in model.named_parameters()},
                         weights={k: v.cpu() for k, v in model.state_dict().items()})
    c, g = out["cpu"], out["gpu"]
    logit_rel = (g["logits"] - c["logits"]).abs().max().item() / c["logits"].abs().max().item()
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    grad_rel = weight_err = 0.0
    for n in c["grads"]:
        if n.endswith("attention.self.key.bias"):
            step = (g["weights"][n] - start[n]).abs().max().item()
            if step > 2 * lr:
                raise AssertionError(f"radbert reference: {n} moved {step}")
            continue
        ref = c["grads"][n].abs().max().item()
        if ref > 0:
            grad_rel = max(grad_rel, (g["grads"][n] - c["grads"][n]).abs().max().item() / ref)
        weight_err = max(weight_err, (g["weights"][n] - c["weights"][n]).abs().max().item())
    res = dict(logits_rel=logit_rel, loss_rel=loss_rel, grad_rel=grad_rel,
               weight_abs=weight_err)
    log(f"reference: tiny RadBERT step card vs CPU: logits rel {logit_rel:.2e}, loss rel "
        f"{loss_rel:.2e} (tol 1e-5), grads rel {grad_rel:.2e} (tol 1e-4), updated weights "
        f"abs {weight_err:.2e} (tol 1e-5)")
    if logit_rel > 1e-5 or loss_rel > 1e-5 or grad_rel > 1e-4 or weight_err > 1e-5:
        raise AssertionError(f"tiny RadBERT card vs CPU disagree: {res}")
    return res


# ---------------------------------------------------------------- phase 6
# kernel-name fragments of a CT-CLIP training step's groups (first match)
CTCLIP_GROUPS = (
    ("K11 GEGLU FF backward tile (ff_bwd_kernel)", ("ff_bwd_kernel",)),
    ("backward products NN/TN + split sums (gemm_layout_kernel, sum_splits)",
     ("gemm_layout_kernel", "sum_splits_kernel")),
    ("K9/K10 attention core backward (qk_attention_bwd_kernel)", ("qk_attention_bwd_kernel",)),
    ("LayerNorm backward (ln_bwd_kernel)", ("ln_bwd_kernel",)),
    ("K14 PEG dW/db (peg_dw_kernel)", ("peg_dw_kernel",)),
    ("K15 VQ statistics (vq_stats.cu)", ("rank_kernel", "scan_kernel", "place_kernel",
                                         "sum_kernel")),
    ("K5 exact assignment (gemm_argmax2_kernel)", ("gemm_argmax2",)),
    ("forward products K1-K3 (gemm_kernel) and LN (ln_kernel)", ("gemm_kernel<",
                                                                 "ln_kernel")),
    ("K1/K2 attention core forward (attention_kernel)", ("attention_kernel",)),
    ("K13 bf16 CXR-BERT attention (attention_train.cu)", ("fwd_kernel<", "bwd_dq_kernel",
                                                          "bwd_dkv_kernel", "rowdot_kernel",
                                                          "dkb_sum")),
    ("cuDNN depthwise conv (PEG forward and dx)", ("conv", "cudnn", "depthwise")),
    ("cuBLAS products (BERT, embed, latent projections)", ("gemm", "xmma", "cutlass",
                                                           "cublas", "sm90")),
    ("Adam (multi-tensor)", ("multi_tensor", "foreach")),
)


def write_train_corpus(work: Path):
    """20 training volumes (16 kept by the 80% split) with generated reports
    and 2 labelled validation volumes, 256 x 256 x 60 at 1.5 x 1.5 x 6 mm,
    which the ingest resamples and crops to 240 x 480 x 480."""
    train = write_corpus(work / "train", [(256, 256, 60)] * 20, 1.5, 6.0)
    rng = np.random.RandomState(4)
    words = report_words()
    rows = list(csv.DictReader(open(train[1])))
    for r in rows:
        r["Findings_EN"] = " ".join(rng.choice(words, rng.randint(20, 200))) + "."
    with open(train[1], "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    valid = write_corpus(work / "valid", [(256, 256, 60)] * 2, 1.5, 6.0)
    return train, valid, write_vocab(work / "ctclip_vocab.txt")


def ctclip_train_phase(dev, work: Path, card: str) -> dict:
    """`cli train` at full width, batch 8, 4 steps (mini evaluation and
    checkpoint at step 4), then the steady-state step time (CUDA events),
    peak memory and a profiled step."""
    import torch

    from ct_clip_tpu_torch import cli

    train, valid, vocab = write_train_corpus(work)
    results = work / "train_results"
    argv = ["--vocab", vocab, "--device", "cuda", "--seed", "0", "train",
            "--data-train", train[0], "--reports-train", train[1], "--meta-train", train[2],
            "--data-valid", valid[0], "--reports-valid", valid[1], "--meta-valid", valid[2],
            "--labels", valid[3], "--results", str(results), "--batch-size", str(TRAIN_B),
            "--steps", "4", "--workers", "4", "--save-results-every", "4",
            "--save-model-every", "4"]
    trainer, counts, secs = drive("ctclip_train", lambda: cli.main(argv))
    recs = [json.loads(x) for x in (results / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    evals = [r["mini_eval_mean_auc"] for r in recs if "mini_eval_mean_auc" in r]
    ckpts = sorted(p.name for p in (results / "checkpoints").iterdir())
    log(f"ctclip train: {len(trainer.train_ds)} volumes, 4 steps of {TRAIN_B} at full width "
        f"in {secs:.1f} s (host clock: build, ingest, mini evaluation and the checkpoint "
        f"included); losses {losses}; grad norms "
        f"{[round(r['grad_norm'], 4) for r in recs if 'loss' in r]}; mini-eval mean AUC "
        f"{evals}; checkpoints {ckpts}")
    if len(losses) != 4 or not np.isfinite(losses).all() or len(evals) != 1 \
            or ckpts != ["step_4.pt"] or not (results / "mini_eval_step4.csv").exists():
        raise AssertionError(f"ctclip train: losses {losses}, evals {evals}, ckpts {ckpts}")
    shutil.rmtree(results / "checkpoints")

    batch = next(trainer._batches())
    state, step = trainer.state, trainer.step_fn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, gen = [], torch.Generator(device=dev).manual_seed(5)
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch, gen)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms[1:])
    log(f"ctclip step: batch {TRAIN_B} x (13,824 tokens, 512 text tokens), full width, bf16: "
        f"median {med:.2f} ms of steps 2-4 {[round(t, 2) for t in step_ms]} = "
        f"{TRAIN_B / med * 1e3:.3f} volumes/s; peak memory {peak_gb:.2f} GB; loss "
        f"{m['loss'].item():.4f} on {card}")
    breakdown = profile_step(lambda: step(state, batch, gen), CTCLIP_GROUPS, "ctclip")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return dict(counts=counts, losses=losses, mini_eval_mean_auc=evals[0], cli_s=secs,
                step_ms=med, step_ms_all=step_ms, volumes_per_s=TRAIN_B / med * 1e3,
                peak_gb=peak_gb, step_breakdown=breakdown)


def tiny_ctclip_config():
    from ct_clip_tpu_torch.config import BertConfig, CTCLIPConfig, CTViTConfig

    return CTCLIPConfig(
        dim_text=64, dim_image=9 * 64, dim_latent=32,
        ctvit=CTViTConfig(dim=64, codebook_size=128, image_size=48, patch_size=16,
                          temporal_patch_size=4, num_frames=12, spatial_depth=2,
                          temporal_depth=2, dim_head=16, heads=4),
        bert=BertConfig(vocab_size=64, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128, hidden_dropout=0.0,
                        attention_dropout=0.0))


# the tiny CT-CLIP step, card against CPU (both bf16): limits.  Each
# gradient is held against the CPU's own bf16 rounding noise, its distance
# from the same step in f32; the readings of the kernels as built and of the
# planted faults (PERF.md) put TINY_GRAD_RATIO between them
TINY_LOSS_TOL = 2e-3
TINY_GRAD_RATIO = 1.15
TINY_ZERO_TOL = 1e-3  # x the largest gradient, parameters whose true gradient is zero
TINY_UPDATE_TOL = 1e-2  # x lr, entries whose gradient is >= 0.2 of its tensor's max
# parameters whose true gradient is zero (softmax shift invariance)
ZERO_GRAD = ("attention.self.key.bias", "spatial_rel_pos_bias.net.2.bias")


def tiny_ctclip_inputs():
    import torch

    g = torch.Generator().manual_seed(7)
    ids = torch.randint(5, 64, (4, 32), generator=g)
    mask = (torch.arange(32)[None] < torch.tensor([[32], [20], [9], [27]])).long()
    video = torch.rand((4, 12, 48, 48, 1), generator=g) * 2 - 1
    return ids * mask, mask, video


def tiny_ctclip_side(cfg, tcfg, start, inputs, device, dtype) -> dict:
    """From the state dict `start` on `device`, computing in `dtype`: the VQ
    ids, one forward/backward (the loss and every parameter's gradient),
    then one `make_train_step` from `start`."""
    import torch

    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.train import create_train_state, make_train_step

    ids, mask, video = (t.to(device) for t in inputs)
    batch = dict(input_ids=ids, attention_mask=mask, video=video)
    model = CTCLIP(cfg, dtype=dtype, device=device)
    model.load_state_dict(start)
    state = create_train_state(model, tcfg)
    with torch.no_grad():
        vt = model.visual_transformer
        codes = vt.vq(vt.encode(vt.embed_patches(video, train=True)), train=True)[1].cpu()
    model.load_state_dict(start)  # the VQ call moved the codebook
    model.train()
    model.zero_grad()
    loss = model(**batch, return_loss=True, train=True)
    loss.backward()
    grads = {n: p.grad.float().cpu().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.load_state_dict(start)
    m = make_train_step(tcfg)(state, batch)
    return dict(loss=loss.item(), grads=grads, codes=codes, state=state, batch=batch,
                metrics={k: v.item() for k, v in m.items()},
                sd={k: v.float().cpu() for k, v in model.state_dict().items()})


def compare_tiny_steps(c: dict, c32: dict, g: dict, start: dict, lr: float):
    """(readings, failures) of a card side `g` against the CPU side `c`,
    with the CPU's f32 side `c32` giving each gradient's bf16 noise."""
    def l2_rel(a, b):
        return (a - b).norm().item() / max(b.norm().item(), 1e-30)

    ratio, zero = {}, 0.0
    top = max(t.abs().max().item() for t in c["grads"].values())
    for n, ref in c["grads"].items():
        if n.endswith(ZERO_GRAD):
            zero = max(zero, g["grads"][n].abs().max().item() / top)
            continue
        noise = max(l2_rel(ref, c32["grads"][n]), 1e-3)
        ratio[n] = (l2_rel(g["grads"][n], ref) / noise, l2_rel(g["grads"][n], ref), noise)
    worst = sorted(ratio.items(), key=lambda kv: -kv[1][0])
    agree = (g["codes"] == c["codes"]).float().mean().item()
    key = "visual_transformer.vq._codebook."
    cs_err = (g["sd"][key + "cluster_size"] - c["sd"][key + "cluster_size"]).abs().max().item()
    cb_err = (g["sd"][key + "embed"] - c["sd"][key + "embed"]).abs().max().item()
    upd_err, upd_worst, upd_max = 0.0, "", 0.0
    for n, ref in c["grads"].items():
        if not ref.numel() or n.endswith(ZERO_GRAD):
            continue
        diff = ((g["sd"][n] - start[n].float()) - (c["sd"][n] - start[n].float())).abs()
        big = ref.abs() >= 2e-1 * ref.abs().max()
        if big.any() and diff[big].max().item() > upd_err:
            upd_err, upd_worst = diff[big].max().item(), n
        upd_max = max(upd_max, diff.max().item())
    res = dict(loss_rel=abs(g["loss"] - c["loss"]) / abs(c["loss"]),
               loss_rel_cpu_bf16_vs_f32=abs(c["loss"] - c32["loss"]) / abs(c32["loss"]),
               grad_ratio=worst[0][1][0], grad_worst=worst[0][0],
               grad_top=[[n, *r] for n, r in worst[:5]],
               grad_ratio_median=statistics.median(r[0] for r in ratio.values()),
               grad_l2_rel_max=max(r[1] for r in ratio.values()),
               zero_grads_over_top=zero, id_agreement=agree,
               cluster_size_abs=cs_err, codebook_abs=cb_err, update_err_over_lr=upd_err / lr,
               update_worst=upd_worst, update_max_over_lr=upd_max / lr)
    failures = [name for name, bad in (
        ("loss", res["loss_rel"] > TINY_LOSS_TOL),
        ("gradients", res["grad_ratio"] > TINY_GRAD_RATIO),
        ("zero gradients", zero > TINY_ZERO_TOL), ("VQ ids", agree < 1.0),
        ("cluster sizes", cs_err > 1e-6), ("codebook", cb_err > 1e-2),
        ("updates", upd_err > TINY_UPDATE_TOL * lr),
        ("update bound", upd_max > 2 * lr * (1 + 1e-6))) if bad]
    return res, failures


def _log_tiny(label: str, res: dict, failures) -> None:
    top = [(n, f"{r:.3f}", f"{d:.2e}", f"{e:.2e}") for n, r, d, e in res["grad_top"]]
    log(f"reference: tiny CT-CLIP step card vs CPU, {label}: loss rel {res['loss_rel']:.2e} "
        f"(tol {TINY_LOSS_TOL}; CPU bf16 vs f32 {res['loss_rel_cpu_bf16_vs_f32']:.2e}); "
        f"gradients, card-CPU L2 distance over the CPU's bf16-f32 L2 distance, largest "
        f"first (tensor, ratio, card-CPU, CPU bf16-f32): {top}, median "
        f"{res['grad_ratio_median']:.3f} (tol {TINY_GRAD_RATIO}); zero-gradient params "
        f"{res['zero_grads_over_top']:.2e} of the largest gradient (tol {TINY_ZERO_TOL}); "
        f"VQ ids equal {res['id_agreement']:.4f} (all); cluster sizes abs "
        f"{res['cluster_size_abs']:.2e} (tol 1e-6); codebook abs {res['codebook_abs']:.2e} "
        f"(tol 1e-2); update err {res['update_err_over_lr']:.2e} lr ({res['update_worst']}; "
        f"tol {TINY_UPDATE_TOL} lr), every update within {res['update_max_over_lr']:.2e} lr "
        f"(tol 2 lr); outside: {failures or 'none'}")


def planted_faults():
    """name -> (module, attribute, replacement): a kernel wrapper broken on
    purpose, which the tiny step's comparison must catch."""
    import importlib

    import torch

    from ct_clip_tpu_torch.ops import kernels as K

    qa = importlib.import_module("ct_clip_tpu_torch.ops.qknorm_attention")
    ffn = importlib.import_module("ct_clip_tpu_torch.ops.ffn")
    k9, k11, k15 = qa._qknorm_attention_bwd_cuda, ffn._geglu_ff_bwd_cuda, K.vq_cluster_stats

    def k9_no_dbias(*a, **kw):
        g = k9(*a, **kw)
        return g[:-1] + (None if g[-1] is None else torch.zeros_like(g[-1]),)

    def k11_dwo_high(*a, **kw):
        g = k11(*a, **kw)
        return g[:-1] + (g[-1] * 1.05,)

    def k15_drop_fullest(x, ids, codes):
        bins, esum = k15(x, ids, codes)
        c = int(bins.argmax())
        bins[c], esum[c] = 0.0, 0.0
        return bins, esum
    return {"K9 without the bias gradient": (qa, "_qknorm_attention_bwd_cuda", k9_no_dbias),
            "K11 with dW_out 5% high": (ffn, "_geglu_ff_bwd_cuda", k11_dwo_high),
            "K15 dropping its fullest code": (K, "vq_cluster_stats", k15_drop_fullest)}


def ctclip_train_reference_phase(dev, work: Path) -> dict:
    """One training step of a tiny CT-CLIP (both dropouts 0, batch 4) from
    the same weights on the card (kernels) and on the CPU (plain versions),
    both bf16 compute with f32 parameters, lr 1e-3, and on the CPU in f32.
    The two bf16 sides round at nearly the same points and sum in other
    orders (the kernels keep P, dxn and the weight gradients in f32 where
    the plain chain rounds them to bf16); at this random init every
    gradient of a bf16 step lies a few % from the f32 step's (LayerNorm,
    l2norm and the temperature's gradients are sums whose terms cancel).
    Held: the loss within TINY_LOSS_TOL relative; each gradient's L2
    distance card-CPU within TINY_GRAD_RATIO times the CPU's own bf16-f32
    distance; the two parameters whose true gradient is zero within
    TINY_ZERO_TOL of the largest gradient; every VQ id (the codebook starts
    at the CPU's own tokens, so each id is a clear top-1), the cluster sizes
    within 1e-6 and the codebook after the EMA within 1e-2; the update of
    each entry whose gradient is above 2e-1 of its tensor's largest within
    TINY_UPDATE_TOL lr (Adam's first step is lr g / (|g| + eps), so a
    gradient's relative difference reaches the step only through eps),
    every entry within 2 lr.  Then the same card step with each planted
    fault (`planted_faults`) must fall outside these limits.  Last, a save
    -> restore round trip on the card: the restored state and one more step
    from it equal the original's."""
    import contextlib

    import torch

    from ct_clip_tpu_torch.config import TrainConfig
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.train import CheckpointManager, create_train_state, make_train_step

    cfg, lr = tiny_ctclip_config(), 1e-3
    tcfg = TrainConfig(lr=lr)
    inputs = tiny_ctclip_inputs()
    bf, cpu_dev = torch.bfloat16, torch.device("cpu")
    cpu = CTCLIP(cfg, dtype=bf).init_weights(torch.Generator().manual_seed(8))
    with torch.no_grad():  # codes at the tokens: every id a clear top-1 on both sides
        vt = cpu.visual_transformer
        tokens = vt.encode(vt.embed_patches(inputs[2], train=True)).float().reshape(-1, 64)
        vt.vq._codebook.embed[: tokens.shape[0]] = tokens / tokens.norm(dim=-1, keepdim=True)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    c = tiny_ctclip_side(cfg, tcfg, start, inputs, cpu_dev, bf)
    c32 = tiny_ctclip_side(cfg, tcfg, start, inputs, cpu_dev, torch.float32)
    gp = tiny_ctclip_side(cfg, tcfg, start, inputs, dev, bf)
    res, failures = compare_tiny_steps(c, c32, gp, start, lr)
    _log_tiny("kernels as built", res, failures)
    if failures:
        raise AssertionError(f"tiny CT-CLIP training step: card and CPU disagree on "
                             f"{failures}: {res}")
    res.update(metrics_gpu=gp["metrics"], metrics_cpu=c["metrics"], faults={})
    for name, (module, attr, broken) in planted_faults().items():
        original = getattr(module, attr)
        with contextlib.ExitStack() as undo:
            setattr(module, attr, broken)
            undo.callback(setattr, module, attr, original)
            fres, ffail = compare_tiny_steps(
                c, c32, tiny_ctclip_side(cfg, tcfg, start, inputs, dev, bf), start, lr)
        _log_tiny(f"planted fault: {name}", fres, ffail)
        if not ffail:
            raise AssertionError(f"tiny CT-CLIP training step: planted fault '{name}' passes "
                                 f"the limits: {fres}")
        res["faults"][name] = dict(outside=ffail, **{k: fres[k] for k in (
            "grad_ratio", "grad_worst", "grad_top", "cluster_size_abs", "codebook_abs",
            "update_err_over_lr")})

    # save -> restore on the card, then one more step on both
    st = gp["state"]
    mgr = CheckpointManager(str(work / "tiny_ckpt"))
    mgr.save(1, st)
    other = CTCLIP(cfg, dtype=torch.bfloat16, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(9))
    restored = mgr.restore(create_train_state(other, tcfg))
    restored_step = restored.step
    same_state = all(torch.equal(v, restored.model.state_dict()[k])
                     for k, v in st.model.state_dict().items())
    step = make_train_step(tcfg)
    m1, m2 = step(st, gp["batch"]), step(restored, gp["batch"])
    resume_diff = max((v.float() - restored.model.state_dict()[k].float()).abs().max().item()
                      for k, v in st.model.state_dict().items() if v.numel())
    log(f"reference: save -> restore on the card: state equal {same_state}, step "
        f"{restored_step}; the next step's loss {m1['loss'].item():.6f} vs "
        f"{m2['loss'].item():.6f}, weights max diff after it {resume_diff:.2e} (tol 1e-6)")
    if not same_state or restored_step != 1 or resume_diff > 1e-6:
        raise AssertionError("tiny CT-CLIP save -> restore round trip differs")
    res.update(resume_state_equal=same_state, resume_next_step_max_diff=resume_diff)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from ct_clip_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    t0 = time.perf_counter()
    K.library()
    log(f"build: kernels compiled and loaded in {time.perf_counter() - t0:.1f} s "
        f"({K.library_path().name})")

    results = kernel_phase(dev)
    results.update(train_attention_phase(dev))
    results.update(train_kernel_phase(dev))
    work_root = ROOT / "build" / "chip_smoke"
    work_root.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=work_root))
    try:
        counts, route_diff, batch_ms, batch_profile = end_to_end_phase(dev, work, card)
        radbert = radbert_phase(dev, work, card)
        counts.update(radbert.pop("counts"))
        ref_errs = small_reference_phase(dev, work)
        radbert_ref = radbert_reference_phase(dev, work)
        ctclip = ctclip_train_phase(dev, work, card)
        counts["ctclip_train"] = ctclip.pop("counts")
        ctclip_ref = ctclip_train_reference_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    table = []
    for key, k in KERNELS.items():
        by_path = {path: c[k["counter"]] for path, c in counts.items()
                   if k["counter"] in PATHS[path]}
        table.append({"name": k["name"], "route": "cuda", "source": CSRC + k["source"],
                      "sources": [CSRC + f for f in k["sources"]], "replaces": k["replaces"],
                      "counter": k["counter"], "main_path": k["path"],
                      "launches": counts[k["path"]][k["counter"]],
                      "launches_by_path": by_path, **results[key]})
    print(json.dumps({"e2e": {"score_batch_ms": batch_ms, "batch": B,
                              "score_batch_profile_rows": batch_profile,
                              "route_max_abs_diff": route_diff,
                              "tiny_card_vs_cpu_max_abs_diff": ref_errs,
                              "radbert": radbert, "radbert_tiny_card_vs_cpu": radbert_ref,
                              "ctclip_train": ctclip,
                              "ctclip_train_tiny_card_vs_cpu": ctclip_ref}}),
          flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
