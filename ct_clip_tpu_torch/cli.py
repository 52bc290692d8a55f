"""Command line of the PyTorch port.

  python -m ct_clip_tpu_torch.cli --vocab vocab.txt [--device cuda|cpu] \\
      zero-shot --data DIR --reports CSV --meta CSV --labels CSV \\
      [--ckpt CT-CLIP.pt] [--batch-size 4] [--results DIR]
  python -m ct_clip_tpu_torch.cli --vocab vocab.txt [--device cuda|cpu] \\
      export-latents --data DIR --reports CSV --meta CSV --labels CSV \\
      [--ckpt CT-CLIP.pt] [--results DIR]
  python -m ct_clip_tpu_torch.cli --vocab vocab.txt [--device cuda|cpu] \\
      radbert-train --reports CSV [--reports-valid CSV] [--lr 2e-5] \\
      [--batch-size 32] [--epochs 10] [--augment 0.0] [--scheduler cawr|rlop] \\
      [--out radbert.pt]
  python -m ct_clip_tpu_torch.cli --vocab vocab.txt [--device cuda|cpu] \\
      radbert-infer --reports CSV --head radbert.pt [--out inferred.csv]
  python -m ct_clip_tpu_torch.cli --vocab vocab.txt [--device cuda|cpu] \\
      radbert-eval --reports CSV --head radbert.pt [--out radbert_report.json]

Mirrors the `ct_clip_tpu.cli` commands of the same names.  Runs on the first
CUDA device (hand-written kernels) unless `--device cpu` asks for the CPU
(plain versions); without a CUDA device and without `--device cpu` it exits
with an error.  CT-CLIP runs in bf16 unless --no-bf16 (training too: f32
parameters, bf16 compute); RadBERT always in f32, as the JAX package runs it.
Without --ckpt the CT-CLIP weights are a seeded random initialisation;
`train` writes `metrics.jsonl`, `mini_eval_step{n}.csv` and
`checkpoints/step_{n}.pt` under --results and resumes from the latest
checkpoint there; `radbert-train` starts from seeded random weights and
writes a reference-layout (`model.*`, `fc1.*`) state dict, which
`radbert-infer` and `radbert-eval` read with a strict load.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

import torch

from . import config
from .config import CTCLIPConfig
from .models import CTCLIP

# Reference checkpoints carry HF's position-id buffer, which the port
# computes instead of storing.
_DERIVED_KEYS = ("text_transformer.embeddings.position_ids",)
# ... and HF RoBERTa state dicts its position- and token-type-id buffers.
_RADBERT_DERIVED = ("model.embeddings.position_ids", "model.embeddings.token_type_ids")


def load_reference_checkpoint(model: CTCLIP, path: str) -> None:
    """Load a reference-layout CT-CLIP .pt (plain state dict or the trainer's
    {'model': ...} package, with or without DataParallel's 'module.')."""
    sd: Dict = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and not any(k.startswith("text_transformer") for k in sd):
        sd = sd["model"]
    sd = {k.removeprefix("module."): v for k, v in sd.items()
          if k.removeprefix("module.") not in _DERIVED_KEYS}
    # vector-quantize-pytorch versions differ in a leading codebook-head axis
    # on the VQ buffers (ct_clip_tpu/convert/torch_to_jax.py reshapes too)
    own = model.state_dict()
    for k in [k for k in sd if ".vq._codebook." in k and k in own]:
        sd[k] = sd[k].reshape(own[k].shape)
    model.load_state_dict(sd, strict=True)


def build_model(bf16: bool, device: torch.device, ckpt=None,
                seed: int = 0) -> CTCLIP:
    """Full-width CT-CLIP on `device`, reference weights or seeded random."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    # f32 products stay true f32 (no TF32), as the JAX package's HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = CTCLIP(CTCLIPConfig(), dtype=dtype, device=device).eval()
    if ckpt:
        load_reference_checkpoint(model, ckpt)
    else:
        print("[warn] no --ckpt given; seeded random init", file=sys.stderr)
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model


def _setup(args):
    from .data import CTReportDatasetInfer, WordPieceTokenizer

    model = build_model(args.bf16, torch.device(args.device), args.ckpt, args.seed)
    ds = CTReportDatasetInfer(args.data, args.reports, args.meta, args.labels)
    return model, WordPieceTokenizer(args.vocab), ds


def cmd_zero_shot(args) -> None:
    from .inference import run_zero_shot

    model, tok, ds = _setup(args)
    out = run_zero_shot(model, tok, ds, args.results, batch_size=args.batch_size,
                        num_workers=args.workers)
    print(f"scored {len(out['accessions'])} volumes on {args.device} -> {args.results}")


def cmd_export_latents(args) -> None:
    from .inference import export_latents

    model, tok, ds = _setup(args)
    out = export_latents(model, tok, ds, args.results, num_workers=args.workers)
    print(f"exported latents of {len(out['image'])} volumes on {args.device} "
          f"-> {args.results}")


def cmd_train(args):
    """CT-CLIP contrastive pretraining (ct_clip_tpu/cli.py::cmd_train)."""
    from .data import CTReportDataset, CTReportDatasetInfer, WordPieceTokenizer
    from .train import CTClipTrainer

    model = build_model(args.bf16, torch.device(args.device), seed=args.seed)
    train_ds = CTReportDataset(args.data_train, args.reports_train, args.meta_train)
    valid_ds = None
    if args.data_valid:
        valid_ds = CTReportDatasetInfer(args.data_valid, args.reports_valid,
                                        args.meta_valid, args.labels)
    tcfg = config.TrainConfig(batch_size=args.batch_size, lr=args.lr,
                              num_train_steps=args.steps,
                              save_results_every=args.save_results_every,
                              save_model_every=args.save_model_every)
    trainer = CTClipTrainer(model, WordPieceTokenizer(args.vocab), train_dataset=train_ds,
                            valid_dataset=valid_ds, config=tcfg,
                            results_folder=args.results, num_workers=args.workers)
    if args.resume:
        trainer.load()
    state = trainer.train()
    print(f"trained to step {state.step} on {args.device} -> {args.results}")
    return trainer


def _radbert(args, device: torch.device):
    from .data import WordPieceTokenizer
    from .models import RadBertClassifier

    # f32 products stay true f32 (no TF32), as the JAX package's HIGHEST
    torch.backends.cuda.matmul.allow_tf32 = False
    tok = WordPieceTokenizer(args.vocab)
    model = RadBertClassifier(config.RadBertConfig(vocab_size=tok.vocab_size),
                              device=device)
    return model, tok


def load_radbert_checkpoint(model, path: str) -> None:
    """Strict load of a reference-layout RadBertClassifier state dict (as
    `radbert-train --out` writes it), with or without DataParallel's
    'module.', HF's derived id buffers dropped."""
    sd: Dict = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    model.load_state_dict({k: v for k, v in sd.items() if k not in _RADBERT_DERIVED},
                          strict=True)


def cmd_radbert_train(args) -> Dict:
    from .train import ReportClassificationDataset, TextClassifierTrainer

    device = torch.device(args.device)
    model, tok = _radbert(args, device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    trainer = TextClassifierTrainer(model, tok, lr=args.lr, batch_size=args.batch_size,
                                    scheduler=args.scheduler, seed=args.seed)
    train_ds = ReportClassificationDataset(args.reports, augment_prob=args.augment)
    valid_ds = (ReportClassificationDataset(args.reports_valid)
                if args.reports_valid else None)
    result = trainer.train(train_ds, valid_ds, epochs=args.epochs)
    if args.out:
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, args.out)
    print(f"best loss {result['best_loss']:.4f}")
    return result


def _radbert_from_ckpt(args):
    from .train import ReportClassificationDataset, TextClassifierTrainer

    model, tok = _radbert(args, torch.device(args.device))
    load_radbert_checkpoint(model, args.head)
    return TextClassifierTrainer(model, tok), ReportClassificationDataset(args.reports)


def cmd_radbert_infer(args) -> None:
    trainer, ds = _radbert_from_ckpt(args)
    trainer.infer_to_csv(ds, args.out)
    print(f"wrote inferred labels -> {args.out}")


def cmd_radbert_eval(args):
    from .train import multilabel_report

    trainer, ds = _radbert_from_ckpt(args)
    probs, labels = trainer.predict_dataset(ds)
    rep = multilabel_report(labels, probs)
    Path(args.out).write_text(json.dumps(rep["report"], indent=2))
    print(f"wrote classification report -> {args.out}")
    return probs


def _data_args(parser, results: str) -> None:
    for name in ("--data", "--reports", "--meta", "--labels"):
        parser.add_argument(name, required=True)
    parser.add_argument("--ckpt")
    parser.add_argument("--results", default=results)
    parser.add_argument("--workers", type=int, default=8)


def main(argv=None):
    p = argparse.ArgumentParser(prog="ct_clip_tpu_torch")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the first CUDA device (default) or the CPU")
    p.add_argument("--vocab", required=True, help="CXR-BERT vocab.txt path")
    p.add_argument("--seed", type=int, default=0,
                   help="random-init (and RadBERT dropout) seed")
    sub = p.add_subparsers(dest="cmd", required=True)
    z = sub.add_parser("zero-shot")
    _data_args(z, "inference_zeroshot")
    z.add_argument("--batch-size", type=int, default=4)
    z.set_defaults(fn=cmd_zero_shot)
    e = sub.add_parser("export-latents")
    _data_args(e, "latents")
    e.set_defaults(fn=cmd_export_latents)

    t = sub.add_parser("train")
    t.add_argument("--data-train", required=True)
    t.add_argument("--reports-train", required=True)
    t.add_argument("--meta-train", required=True)
    for name in ("--data-valid", "--reports-valid", "--meta-valid", "--labels"):
        t.add_argument(name)
    t.add_argument("--results", default="results")
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--lr", type=float, default=1.25e-6)
    t.add_argument("--steps", type=int, default=100001)
    t.add_argument("--workers", type=int, default=8)
    t.add_argument("--save-results-every", type=int, default=100)
    t.add_argument("--save-model-every", type=int, default=2000)
    t.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint under --results first")
    t.set_defaults(fn=cmd_train)

    r = sub.add_parser("radbert-train")
    r.add_argument("--reports", required=True)
    r.add_argument("--reports-valid")
    r.add_argument("--lr", type=float, default=2e-5)
    r.add_argument("--batch-size", type=int, default=32)
    r.add_argument("--epochs", type=int, default=10)
    r.add_argument("--augment", type=float, default=0.0)
    r.add_argument("--scheduler", choices=["cawr", "rlop"], default=None,
                   help="per-epoch LR schedule (text_classifier/train.py:126-140)")
    r.add_argument("--out", help=".pt path for the trained state dict")
    r.set_defaults(fn=cmd_radbert_train)
    ri = sub.add_parser("radbert-infer")
    ri.add_argument("--reports", required=True)
    ri.add_argument("--head", required=True, help="radbert-train --out .pt")
    ri.add_argument("--out", default="inferred.csv")
    ri.set_defaults(fn=cmd_radbert_infer)
    re_ = sub.add_parser("radbert-eval")
    re_.add_argument("--reports", required=True)
    re_.add_argument("--head", required=True, help="radbert-train --out .pt")
    re_.add_argument("--out", default="radbert_report.json")
    re_.set_defaults(fn=cmd_radbert_eval)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device is available; pass --device cpu to run on the CPU")
    return args.fn(args)


if __name__ == "__main__":
    main()
