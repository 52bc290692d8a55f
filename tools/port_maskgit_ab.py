#!/usr/bin/env python3
"""A step phase of chip_smoke.py from one checkout, printed as one JSON
line, so that two commits can be compared on one card in turns:

    git archive PARENT | tar -x -C build/parent   # and the change likewise
    for t in build/parent build/change build/change build/parent; do
        python tools/port_maskgit_ab.py $t [--phase maskgit | maskgit_f32 | radbert |
                                              ctclip | ctclip_f32 | ctclip_160 |
                                              ctvit_ae | ctvit_ae_f32 | zeroshot |
                                              zeroshot_f32 | ctclip_aux_a]
    done

Phases: `maskgit` (the default; `maskgit_phase`: MaskGitTrainer steps with
the TokenCritic at full width, sampling), `maskgit_f32` (`maskgit_f32_phase`,
the same in f32), `radbert` (`radbert_phase`: the CLI's radbert-train,
-infer and -eval at full width, then the f32 training step), `ctclip`
(`ctclip_train_phase`: `cli train` at batch 8, bf16, then the timed steps),
`ctclip_f32` (the same with `--no-bf16`: the f32 contrastive step),
`ctclip_160` (`ctclip_160_phase`: CT-CLIP at 160 frames), `ctvit_ae`
(`ctvit_ae_phase`: the autoencoder's generator steps at batch 8) and
`ctvit_ae_f32` (the same on an f32 CTViT), `zeroshot` (`score_batch` of a
bf16 CTCLIP at full width on a batch of 2, patch rows: 5 calls between CUDA
events, their median the "step", and a profiled call), `zeroshot_f32` (the
same for an f32 CTCLIP) and
`ctclip_aux_a` (the aux (a) step: `CTClipTrainer` with SimSiam on the
temporal tap and MLM at batch 8 on volumes, `timed_steps` without the CLI
run, the evaluation or the checkpoint).  Each
line: the tree, the phase, the median step (CUDA events: MaskGIT, CT-CLIP
and the autoencoder steps 2-4, RadBERT 2-5) and every step, the profiled
step's device busy time, host clock and idle share and its summed device ms
by kernel group; for `maskgit` sampling's seconds per volume and the primed
sample's seconds.  The steps are partly launch-bound, so compare only lines
from one call.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch


def zeroshot(cs, dev, dtype=torch.bfloat16) -> dict:
    """`score_batch` of CTCLIP(dtype=dtype) at full width on 2 volumes' patch
    rows (K6 route, seeded weights): 5 calls between CUDA events and a
    profiled call."""
    from ct_clip_tpu_torch.config import CTCLIPConfig
    from ct_clip_tpu_torch.data import WordPieceTokenizer
    from ct_clip_tpu_torch.inference import ZeroShotClassifier
    from ct_clip_tpu_torch.models import CTCLIP

    vocab = Path(tempfile.mkdtemp()) / "vocab.txt"
    cs.write_vocab(vocab)
    model = CTCLIP(CTCLIPConfig(), dtype=dtype, device=dev).eval()
    model.init_weights(torch.Generator(device=dev).manual_seed(0))
    clf = ZeroShotClassifier(model, WordPieceTokenizer(str(vocab)))
    v = model.config.ctvit
    x = torch.rand((cs.B, v.patch_t * v.patch_hw ** 2, v.patch_dim),
                   generator=torch.Generator(device=dev).manual_seed(3), device=dev) * 2 - 1
    with torch.inference_mode():
        clf.prompt_latents()
        times = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            clf.score_batch(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        bd = cs.profile_step(lambda: clf.score_batch(x), cs.CTCLIP_GROUPS,
                             f"zero-shot {str(dtype)[6:]}")
    return dict(step_ms=sorted(times[1:])[2], step_ms_all=times, step_breakdown=bd)


def ctclip_aux_a(cs, dev, work: Path, tree: str) -> dict:
    """The aux (a) step (visual SSL: SimSiam on the temporal tap, with MLM) at
    full width, batch cs.AUX_B, on the synthetic corpus: `timed_steps`."""
    from ct_clip_tpu_torch.config import CTCLIPConfig, TrainConfig
    from ct_clip_tpu_torch.data import CTReportDataset, WordPieceTokenizer
    from ct_clip_tpu_torch.models import CTCLIP
    from ct_clip_tpu_torch.train import CTClipTrainer

    train, _, vocab = cs.write_train_corpus(work)
    model = CTCLIP(CTCLIPConfig(use_visual_ssl=True, use_mlm=True), dtype=torch.bfloat16,
                   device=dev).init_weights(torch.Generator(device=dev).manual_seed(0))
    trainer = CTClipTrainer(
        model, WordPieceTokenizer(vocab), train_dataset=CTReportDataset(*train[:3]),
        valid_dataset=None,
        config=TrainConfig(batch_size=cs.AUX_B, save_results_every=10 ** 9,
                           save_model_every=10 ** 9),
        results_folder=str(work / "aux_a"), num_workers=4)
    batch = next(trainer._batches())
    return cs.timed_steps(trainer.step_fn, trainer.state, batch, tree, "ctclip_aux_ssl_mlm",
                          cs.AUX_B, cs.AUX_GROUPS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", help="the root of a checkout")
    ap.add_argument("--phase", choices=("maskgit", "maskgit_f32", "radbert", "ctclip",
                                        "ctclip_f32", "ctclip_160", "ctvit_ae", "ctvit_ae_f32",
                                        "zeroshot", "zeroshot_f32", "ctclip_aux_a"),
                    default="maskgit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_maskgit_ab.py needs a machine with an NVIDIA GPU", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from ct_clip_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.library()
    dev, work = torch.device("cuda", 0), Path(tempfile.mkdtemp())
    if args.phase in ("ctclip", "ctclip_f32"):
        r = cs.ctclip_train_phase(dev, work, str(tree), cs.write_train_corpus(work),
                                  "f32" if args.phase == "ctclip_f32" else "bf16")
    elif args.phase == "ctclip_160":
        r = cs.ctclip_160_phase(dev, work, str(tree), cs.write_train_corpus(work))
    elif args.phase == "ctvit_ae_f32":
        r = cs.ctvit_ae_phase(dev, work, str(tree), "f32")
    elif args.phase in ("zeroshot", "zeroshot_f32"):
        r = zeroshot(cs, dev, torch.float32 if args.phase == "zeroshot_f32" else torch.bfloat16)
    elif args.phase == "ctclip_aux_a":
        r = ctclip_aux_a(cs, dev, work, str(tree))
    else:
        r = getattr(cs, f"{args.phase}_phase")(dev, work, str(tree))
    bd = r["step_breakdown"]
    line = dict(tree=str(tree), phase=args.phase, step_ms=r["step_ms"],
                step_ms_all=r["step_ms_all"], busy_ms=bd["busy_ms"], wall_ms=bd["wall_ms"],
                idle_share=bd["idle_share"], groups_ms=bd["groups"])
    if args.phase == "maskgit":
        line.update(sample_s_per_volume=r["sample_s_per_volume"],
                    primed_sample_s=r["primed_sample_s"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
