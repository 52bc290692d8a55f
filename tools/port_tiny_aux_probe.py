#!/usr/bin/env python3
"""Why the tiny aux CT-CLIP check of chip_smoke.py keeps its BERT at four
heads of 16: run that check (`tiny_aux_config`, card against CPU, with
`compare_tiny_steps`' limits) with the BERT at one head of 64, its K12a on
the tensor cores (attention_tc.cu) and again forced to the CUDA cores
(attention_train.cu), then at the four heads of 16 it keeps.

    PYTHONPATH=. python tools/port_tiny_aux_probe.py [--out FILE.json]

For each run: the failures, and for every tensor whose Adam step flips on a
large-gradient entry (|g| >= 0.2 of its max on the CPU in bf16) on the card
or on the CPU in f32, the flips on each side and, at the card's worst entry,
the gradient over its tensor's max on the CPU in bf16, on the card and on
the CPU in f32.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from ct_clip_tpu_torch.config import TrainConfig  # noqa: E402
from ct_clip_tpu_torch.models import CTCLIP  # noqa: E402
from ct_clip_tpu_torch.ops import attention as A  # noqa: E402
from ct_clip_tpu_torch.ops import kernels as K  # noqa: E402

LR = 1e-3


def sides(cfg):
    """(side(device, dtype), start state) of the tiny step, as tiny_step_check."""
    tcfg = TrainConfig(lr=LR)
    inputs = cs.tiny_ctclip_inputs()
    cpu = CTCLIP(cfg, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(8))
    cs.seed_codebook_at_tokens(cpu.visual_transformer, inputs[2])
    start = {k: v.clone() for k, v in cpu.state_dict().items()}
    return (lambda device, dtype: cs.tiny_ctclip_side(cfg, tcfg, start, inputs, device,
                                                      dtype)), start


def report(label, c, c32, g, start) -> dict:
    res, fail = cs.compare_tiny_steps(c, c32, g, start, LR, noise_aware_updates=True)
    out = dict(failures=fail, update_err_over_lr=res["update_err_over_lr"],
               update_worst=res["update_worst"], grad_ratio=res["grad_ratio"], flips={})
    print(f"== {label}: outside {fail or 'none'}; update err {res['update_err_over_lr']:.3f} lr "
          f"({res['update_worst']}); worst gradient ratio {res['grad_ratio']:.3f}", flush=True)
    for n, ref in c["grads"].items():
        if not ref.numel() or n.endswith(cs.ZERO_GRAD):
            continue
        big = ref.abs() >= 0.2 * ref.abs().max()
        card = (g["sd"][n] - c["sd"][n]).abs()[big]
        f32 = (c32["sd"][n] - c["sd"][n]).abs()[big]
        if card.max() <= LR and f32.max() <= LR:
            continue
        worst = torch.nonzero(big.flatten()).flatten()[card.argmax()]
        top = ref.abs().max()
        row = dict(big=int(big.sum()), card_flips=int((card > LR).sum()),
                   cpu_f32_flips=int((f32 > LR).sum()),
                   at_card_worst={side: (x["grads"][n].flatten()[worst] / top).item()
                                  for side, x in (("cpu_bf16", c), ("card", g),
                                                  ("cpu_f32", c32))})
        out["flips"][n] = row
        print(f"  {n}: {row}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    K.library()
    dev, bf, cpu = torch.device("cuda", 0), torch.bfloat16, torch.device("cpu")
    results = {"card": smi}
    aux = cs.tiny_aux_config()
    one = aux.replace(bert=aux.bert.replace(num_attention_heads=1))
    side, start = sides(one)
    c, c32 = side(cpu, bf), side(cpu, torch.float32)
    results["one head of 64, K12a on the tensor cores"] = report(
        "one head of 64, K12a on the tensor cores", c, c32, side(dev, bf), start)
    route, count = A.attention_route, K.count_launch
    A.attention_route = lambda *a: (A.TRAIN, A.TRAIN)
    # the side asserts its K12a launches on the tensor cores: count the forced ones there
    K.count_launch = lambda name: (count(name),
                                   name == "attention_bwd" and count("attention_tc_bwd"))
    try:
        results["one head of 64, K12a forced to the CUDA cores"] = report(
            "one head of 64, K12a forced to the CUDA cores", c, c32, side(dev, bf), start)
    finally:
        A.attention_route, K.count_launch = route, count
    side, start = sides(aux)
    results["four heads of 16 (tiny_aux_config)"] = report(
        "four heads of 16 (tiny_aux_config)", side(cpu, bf), side(cpu, torch.float32),
        side(dev, bf), start)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
