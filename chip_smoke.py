#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ct_clip_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):
  1. build the hand-written kernels from ct_clip_tpu_torch/csrc (nvcc);
  2. kernel phase: each ported TPU kernel's wrapper against its plain
     PyTorch version at the full-width CT-CLIP shapes, batch 2, in bf16:
     max abs / rel error against a stated tolerance and median times
     (CUDA events);
  3. end-to-end phase: a 3-volume synthetic CT-RATE corpus (NIfTI + CSVs +
     a toy vocab) through `run_zero_shot` at full CT-CLIP width (seeded
     random weights), batch 2 with a tail batch; checks the (3, 18)
     probabilities and that every kernel's launch counter rose;
  4. reference check on a small input: a tiny CT-CLIP scores the same
     volumes on the card (kernels) and on the CPU (plain versions), both
     bf16, and must agree.

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

# counter name -> (TPU kernel, its public function file:line, main CUDA source)
KERNELS = {
    "patch_embed": ("fused_patch_embed", "ct_clip_tpu/ops/pallas/patchify.py:433",
                    "ct_clip_tpu_torch/csrc/layernorm.cu"),
    "spatial_attention": ("fused_spatial_qknorm_attention",
                          "ct_clip_tpu/ops/pallas/spatial_attention.py:339",
                          "ct_clip_tpu_torch/csrc/attention.cu"),
    "grid_attention": ("fused_small_qknorm_attention_grid",
                       "ct_clip_tpu/ops/pallas/small_attention.py:606",
                       "ct_clip_tpu_torch/csrc/attention.cu"),
    "geglu_ff": ("fused_geglu_ff", "ct_clip_tpu/ops/pallas/ffn.py:125",
                 "ct_clip_tpu_torch/csrc/gemm.cu"),
    "vq_assign": ("pallas_assign", "ct_clip_tpu/ops/pallas/vq.py:104",
                  "ct_clip_tpu_torch/csrc/gemm.cu"),
    "fused_attention": ("fused_attention", "ct_clip_tpu/ops/pallas/attention.py:334",
                        "ct_clip_tpu_torch/csrc/attention.cu"),
}
SOURCES = {  # every CUDA file a kernel's wrapper launches from
    "patch_embed": ["layernorm.cu", "gemm.cu"],
    "spatial_attention": ["layernorm.cu", "gemm.cu", "attention.cu"],
    "grid_attention": ["layernorm.cu", "gemm.cu", "attention.cu"],
    "geglu_ff": ["layernorm.cu", "gemm.cu"],
    "vq_assign": ["gemm.cu"],
    "fused_attention": ["attention.cu"],
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
def kernel_cases(dev):
    """name -> (kernel call, plain call) at the full-width shapes of the
    zero-shot path with B volumes per batch."""
    import torch

    from ct_clip_tpu_torch.ops.attention import attention_plain, fused_attention
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff, geglu_ff_plain
    from ct_clip_tpu_torch.ops.patch_embed import (fused_patch_embed,
                                                   patch_embed_plain)
    from ct_clip_tpu_torch.ops.qknorm_attention import (
        fused_grid_qknorm_attention, fused_spatial_qknorm_attention,
        grid_qknorm_attention_plain, qknorm_attention_plain)

    g = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    dim, heads, dh, hd, n_tok = 512, 8, 32, 256, 13824
    cases = {}

    video = (torch.rand((B, 240, 480, 480), generator=g, device=dev) * 2 - 1).to(bf)
    pe = (1 + rn(4000, scale=0.1), rn(4000, scale=0.1), rn(512, 4000, scale=4000 ** -0.5),
          rn(512, scale=0.1), 1 + rn(512, scale=0.1), rn(512, scale=0.1))
    cases["patch_embed"] = (lambda: fused_patch_embed(video, *pe, 10, 20),
                            lambda: patch_embed_plain(video, *pe, 10, 20))

    w_attn = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5),
              rn(2 * hd, dim, scale=dim ** -0.5), 1 + rn(dh, scale=0.2),
              1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    xs = rn(B * 24, 576, dim, dtype=bf)
    cpb = rn(heads, 576, 576)
    cases["spatial_attention"] = (
        lambda: fused_spatial_qknorm_attention(xs, *w_attn, cpb, heads, dh),
        lambda: qknorm_attention_plain(xs, *w_attn, cpb, heads, dh))
    xg = rn(B, 24, 576, dim, dtype=bf)
    cases["grid_attention"] = (
        lambda: fused_grid_qknorm_attention(xg, *w_attn, heads, dh),
        lambda: grid_qknorm_attention_plain(xg, *w_attn, heads, dh))

    xf = rn(B * n_tok, dim, dtype=bf)
    w_ff = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1),
            rn(2730, dim, scale=dim ** -0.5), rn(dim, 1365, scale=1365 ** -0.5))
    cases["geglu_ff"] = (lambda: fused_geglu_ff(xf, *w_ff),
                         lambda: geglu_ff_plain(xf, *w_ff))

    # BERT: 36 prompts x 12 heads x 512 positions x 64, head-major views of
    # the (b, n, h, d) projections, prompt-length pad masks
    q, k, v = (rn(36, 512, 12, 64, dtype=bf).transpose(1, 2) for _ in range(3))
    q = q * 64 ** -0.5
    lengths = torch.randint(5, 16, (36,), generator=g, device=dev)
    mask = (torch.arange(512, device=dev)[None] < lengths[:, None]).float()
    key_bias = (1 - mask) * torch.finfo(torch.float32).min
    cases["fused_attention"] = (
        lambda: fused_attention(q, k, v, key_bias=key_bias),
        lambda: attention_plain(q, k, v, key_bias=key_bias))
    return cases


def vq_case(dev):
    import torch

    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import vq_assign, vq_assign_plain

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((B * 13824, 512), generator=g, device=dev).to(torch.bfloat16)
    embed_n = l2norm(torch.randn((8192, 512), generator=g, device=dev))
    return x, embed_n, (lambda: vq_assign(x, embed_n)), (lambda: vq_assign_plain(x, embed_n))


def kernel_phase(dev):
    import torch

    results = {}
    for name, (kern, plain) in kernel_cases(dev).items():
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: bad kernel output {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
        log(f"kernel {name}: max_abs_err {err:.4e} max_rel_err {rel:.4e} "
            f"(tol {REL_TOL:g}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        if rel > REL_TOL:
            raise AssertionError(f"{name}: rel err {rel:.3e} > {REL_TOL}")
        results[name] = dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                             plain_ms=plain_ms, tolerance=f"rel {REL_TOL}")
        del got, ref

    x, embed_n, kern, plain = vq_case(dev)
    got, ref = kern().long(), plain().long()
    sim = x.float() @ embed_n.to(torch.bfloat16).float().t()
    gap = (sim.gather(1, ref[:, None]) - sim.gather(1, got[:, None])).abs()[:, 0]
    agree = (got == ref).float().mean().item()
    # a disagreement must be a near-tie within the bf16 margin (vq.py:17-22)
    margin_ok = bool((gap <= 4e-3 * sim.abs().max(dim=1).values).all())
    ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    log(f"kernel vq_assign: id agreement {agree:.6f} max sim gap "
        f"{gap.max().item():.4e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    if agree < 0.99 or not margin_ok:
        raise AssertionError(f"vq_assign: agreement {agree}, near-ties {margin_ok}")
    results["vq_assign"] = dict(max_abs_err=gap.max().item(), id_agreement=agree,
                                ms=ms, plain_ms=plain_ms,
                                tolerance=">= 0.99 ids equal, rest near-ties")
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


def end_to_end_phase(dev, work: Path, card: str):
    import torch

    from ct_clip_tpu_torch.config import CTCLIPConfig
    from ct_clip_tpu_torch.data import CTReportDatasetInfer, WordPieceTokenizer
    from ct_clip_tpu_torch.inference import run_zero_shot
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.ops import kernels as K

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

    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_zero_shot(model, tok, ds, str(work / "results"), batch_size=B,
                        num_workers=2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = K.launch_counts()
    pred = out["predicted"]
    log(f"e2e: run_zero_shot scored {len(out['accessions'])} volumes in {secs:.2f} s "
        f"= {len(out['accessions']) / secs:.3f} volumes/s (first run, prompt "
        f"encoding and NIfTI decode included) on {card}")
    log(f"e2e: launch counts {counts}")
    if pred.shape != (3, 18) or not np.isfinite(pred).all() \
            or pred.min() < 0 or pred.max() > 1:
        raise AssertionError(f"bad predictions {pred.shape} {pred}")
    for name in ("predicted_weights.npz", "labels_weights.npz", "accessions.txt"):
        if not (work / "results" / name).exists():
            raise AssertionError(f"missing artifact {name}")
    missing = [k for k in KERNELS if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # steady-state device time of one scored batch (encode + scoring)
    from ct_clip_tpu_torch.inference import ZeroShotClassifier

    clf = ZeroShotClassifier(model, tok)
    videos = (torch.rand((B, 240, 480, 480, 1), device=dev) * 2 - 1).to(torch.bfloat16)
    with torch.inference_mode():
        batch_ms = cuda_ms(lambda: clf.score_batch(videos), reps=5)
    log(f"e2e: score_batch({B}) {batch_ms:.1f} ms = {B / batch_ms * 1e3:.2f} "
        f"volumes/s device-side on {card}")
    return counts, pred


# ---------------------------------------------------------------- phase 4
def small_reference_phase(dev, work: Path):
    """Tiny CT-CLIP: card (kernels) vs CPU (plain versions), same weights,
    both bf16.  Both round to bf16 at the same points; they differ in
    summation order, so the P(present) agree to 0.05 (a pair softmax at
    temperature e of latents ~1% apart)."""
    import torch

    from ct_clip_tpu_torch.config import BertConfig, CTCLIPConfig, CTViTConfig
    from ct_clip_tpu_torch.inference import ZeroShotClassifier
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.data import WordPieceTokenizer

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
    ref = ZeroShotClassifier(cpu, tok, max_text_len=64).score_batch(video)
    got = ZeroShotClassifier(gpu, tok, max_text_len=64).score_batch(video.to(dev)).cpu()
    err = (got - ref).abs().max().item()
    log(f"reference: tiny CT-CLIP P(present) card vs CPU max abs diff {err:.4e} (tol 0.05)")
    if got.shape != (3, 18) or not torch.isfinite(got).all() or err > 0.05:
        raise AssertionError(f"small-input reference disagrees: {err}")
    return err


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
        counts, _ = end_to_end_phase(dev, work, card)
        small_reference_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    table = []
    for name, (fn, replaces, source) in KERNELS.items():
        table.append({"name": f"{fn}", "route": "cuda", "source": source,
                      "sources": [f"ct_clip_tpu_torch/csrc/{s}" for s in SOURCES[name]],
                      "replaces": replaces, "launches": counts[name],
                      **results[name]})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
