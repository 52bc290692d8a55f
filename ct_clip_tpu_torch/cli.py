"""Command line of the PyTorch port.

  python -m ct_clip_tpu_torch.cli --vocab vocab.txt [--device cuda|cpu] \\
      zero-shot --data DIR --reports CSV --meta CSV --labels CSV \\
      [--ckpt CT-CLIP.pt] [--batch-size 4] [--results DIR]
  python -m ct_clip_tpu_torch.cli --vocab vocab.txt [--device cuda|cpu] \\
      export-latents --data DIR --reports CSV --meta CSV --labels CSV \\
      [--ckpt CT-CLIP.pt] [--results DIR]

Mirrors `ct_clip_tpu.cli zero-shot` and `export-latents`.  Runs on the first
CUDA device (bf16, hand-written kernels) unless `--device cpu` asks for the
CPU (plain versions); without a CUDA device and without `--device cpu` it
exits with an error.  Without --ckpt the weights are a seeded random
initialisation.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict

import torch

from .config import CTCLIPConfig
from .models import CTCLIP

# Reference checkpoints carry HF's position-id buffer, which the port
# computes instead of storing.
_DERIVED_KEYS = ("text_transformer.embeddings.position_ids",)


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


def _data_args(parser, results: str) -> None:
    for name in ("--data", "--reports", "--meta", "--labels"):
        parser.add_argument(name, required=True)
    parser.add_argument("--ckpt")
    parser.add_argument("--results", default=results)
    parser.add_argument("--workers", type=int, default=8)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="ct_clip_tpu_torch")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the first CUDA device (default) or the CPU")
    p.add_argument("--vocab", required=True, help="CXR-BERT vocab.txt path")
    p.add_argument("--seed", type=int, default=0, help="random-init seed")
    sub = p.add_subparsers(dest="cmd", required=True)
    z = sub.add_parser("zero-shot")
    _data_args(z, "inference_zeroshot")
    z.add_argument("--batch-size", type=int, default=4)
    z.set_defaults(fn=cmd_zero_shot)
    e = sub.add_parser("export-latents")
    _data_args(e, "latents")
    e.set_defaults(fn=cmd_export_latents)
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device is available; pass --device cpu to run on the CPU")
    args.fn(args)


if __name__ == "__main__":
    main()
