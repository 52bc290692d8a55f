#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ct_clip_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. build the hand-written kernels from ct_clip_tpu_torch/csrc (one nvcc
     per source, all at once);
  2. kernel phase: each ported TPU kernel's wrapper against its plain
     PyTorch version at the full-width CT-CLIP shapes, batch 2, in bf16
     (K6 as the ingest calls it: one volume into a slot of the batch
     buffer): max abs / rel error against a stated tolerance (K6, a pure
     move, must be bit-exact), median times (CUDA events) of the kernel, the plain
     version and, where one PyTorch call computes the same function, that
     call, and the bound: the least time the card could take, from the
     call's bytes and products and the H100's published peaks;
  3. end-to-end phase: a 3-volume synthetic CT-RATE corpus (NIfTI + CSVs +
     a toy vocab) through `run_zero_shot` at full CT-CLIP width (seeded
     random weights), batch 2 with a tail batch, twice: on the patch-row
     route (the default on CUDA: K6 ingest, K4 embed) and on the volume
     route (K8 embed).  Checks the (3, 18) probabilities, that the two
     routes agree, the artifacts, and that each route's kernels' launch
     counters rose; times `score_batch` on both routes.  Then
     `export_latents` on one volume (the volume route) with its counters;
  4. reference check on a small input: a tiny CT-CLIP scores the same
     volumes on the card (kernels) and on the CPU (plain versions), both
     bf16, from volumes and from patch rows, and must agree.

Prints the kernel table as one JSON line, then the card's name and power
limit (nvidia-smi), then {"ok": true, "device": {...}} as the last line.
Working files go to build/chip_smoke/ and are removed at the end.
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
# the two zero-shot routes see the same bf16 values and differ only in the
# order LN(4000) sums them: P(present) agree far inside this
ROUTE_TOL = 0.05
# NVIDIA H100 SXM published peaks (dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

PALLAS = "ct_clip_tpu/ops/pallas/"
CSRC = "ct_clip_tpu_torch/csrc/"
# counter name -> (TPU kernel, its Pallas function file:line, main CUDA
# source, every CUDA file the wrapper launches from)
KERNELS = {
    "patch_embed": ("fused_patch_embed", PALLAS + "patchify.py:341",
                    "layernorm.cu", ["layernorm.cu", "gemm.cu"]),
    "spatial_attention": ("fused_spatial_qknorm_attention",
                          PALLAS + "spatial_attention.py:276", "attention.cu",
                          ["layernorm.cu", "gemm.cu", "attention.cu"]),
    "grid_attention": ("fused_small_qknorm_attention_grid",
                       PALLAS + "small_attention.py:196", "attention.cu",
                       ["layernorm.cu", "gemm.cu", "attention.cu"]),
    "geglu_ff": ("fused_geglu_ff", PALLAS + "ffn.py:105", "gemm.cu",
                 ["layernorm.cu", "gemm.cu"]),
    "vq_assign": ("pallas_assign", PALLAS + "vq.py:104", "gemm.cu", ["gemm.cu"]),
    "fused_attention": ("fused_attention", PALLAS + "attention.py:129",
                        "attention.cu", ["attention.cu"]),
    "rearrange_patches": ("rearrange_patches", PALLAS + "patchify.py:105",
                          "rearrange.cu", ["rearrange.cu"]),
    "row_embed": ("fused_row_embed", PALLAS + "patchify.py:609", "layernorm.cu",
                  ["layernorm.cu", "gemm.cu"]),
}
# kernels each driven path must launch
COMMON = ["spatial_attention", "grid_attention", "geglu_ff", "vq_assign",
          "fused_attention"]
PATHS = {
    "zero_shot_rows": COMMON + ["rearrange_patches", "row_embed"],
    "zero_shot_volume": COMMON + ["patch_embed"],
    "export_latents": COMMON + ["patch_embed"],
}


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


def bound(read_bytes: int, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take for
    a call that reads its inputs once, writes its output once and runs
    `flops` bf16 tensor-core operations, at the published peaks."""
    t_bytes, t_ops = read_bytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
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
    """Median kernel, plain and library times, and the bound, of one case."""
    ms, plain_ms = cuda_ms(case["kern"]), cuda_ms(case["plain"])
    library_ms = cuda_ms(case["library"]) if case["library"] else None
    bound_ms, bound_by = bound(nbytes(*case["inputs"], out), case["flops"])
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, bound_share=bound_ms / ms)


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
            del x
    return counts, route_diff, batch_ms


# ---------------------------------------------------------------- phase 4
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
    work_root = ROOT / "build" / "chip_smoke"
    work_root.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=work_root))
    try:
        counts, route_diff, batch_ms = end_to_end_phase(dev, work, card)
        ref_errs = small_reference_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    table = []
    for name, (fn, replaces, source, sources) in KERNELS.items():
        # launches on the main path (the default rows route); K8 is off it
        # and reports the volume route's
        by_path = {path: c[name] for path, c in counts.items()}
        main = "zero_shot_rows" if name in PATHS["zero_shot_rows"] else "zero_shot_volume"
        table.append({"name": fn, "route": "cuda", "source": CSRC + source,
                      "sources": [CSRC + f for f in sources], "replaces": replaces,
                      "launches": by_path[main], "launches_by_path": by_path,
                      **results[name]})
    print(json.dumps({"e2e": {"score_batch_ms": batch_ms, "batch": B,
                              "route_max_abs_diff": route_diff,
                              "tiny_card_vs_cpu_max_abs_diff": ref_errs}}), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
