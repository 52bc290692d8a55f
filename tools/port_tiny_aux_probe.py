#!/usr/bin/env python3
"""Why the tiny aux CT-CLIP check of chip_smoke.py keeps its BERT at four
heads of 16: run that check (`tiny_aux_config`, card against CPU, with
`compare_tiny_steps`' limits) with the BERT at one head of 64, its K12a on
the tensor cores (attention_tc.cu) and again forced to the CUDA cores
(attention_train.cu), then at the four heads of 16 it keeps.

    PYTHONPATH=. python tools/port_tiny_aux_probe.py [--out FILE.json]
    PYTHONPATH=. python tools/port_tiny_aux_probe.py --embed [--seeds 8,1,2] [--out FILE.json]

For each run: the failures, and for every tensor whose Adam step flips on a
large-gradient entry (|g| >= 0.2 of its max on the CPU in bf16) on the card
or on the CPU in f32, the flips on each side and, at the card's worst entry,
the gradient over its tensor's max on the CPU in bf16, on the card and on
the CPU in f32.

`--embed`: the check at `tiny_aux_config` as built, for each init seed of
`--seeds` (chip_smoke.py's is 8), with three bf16 sides against the CPU's
bf16 and f32 steps: the card with its SSL views' K8 on embed_tc.cu, the card
with K8 on the three passes it replaced (`chip_smoke.embed_three_passes`:
layernorm.cu's patch LN, gemm.cu's product, LN(dim)), and the CPU with the
embed's sums in f64 at the same rounding points (a change of summation order
alone).  Each side's failures under `compare_tiny_steps` as built (update
signs against the f32 step on the entries large there, sizes against the
CPU's bf16 step) with its sign flips and, at each flip, the gradient over
its tensor's max on each side, its worst gradients and update sizes; and
under the earlier rule holding sign and size against the CPU's bf16 step
alone (`bf16_rule`); at the first seed each K8 call's output on
embed_tc.cu against the plain version on the card (max and mean error over
max and mean |plain|).
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


def sides(cfg, seed: int = 8):
    """(side(device, dtype), start state) of the tiny step, as tiny_step_check
    (whose init seed is 8)."""
    tcfg = TrainConfig(lr=LR)
    inputs = cs.tiny_ctclip_inputs()
    cpu = CTCLIP(cfg, dtype=torch.bfloat16).init_weights(torch.Generator().manual_seed(seed))
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


def bf16_rule(c, c32, g, start) -> dict:
    """The noise-aware check's earlier update rule, sign and size held
    against the CPU's bf16 step alone: on each entry whose
    gradient in the CPU's bf16 step is above 2e-1 of its tensor's largest,
    the update within TINY_UPDATE_TOL lr of that step's, or the tensor's
    largest error within TINY_GRAD_RATIO times the CPU bf16 step's own
    against the f32 step on the same entries."""
    worst, err_worst = "", 0.0
    for n, ref in c["grads"].items():
        if not ref.numel() or n.endswith(cs.ZERO_GRAD):
            continue
        big = ref.abs() >= 2e-1 * ref.abs().max()
        if not big.any():
            continue
        err = (g["sd"][n] - c["sd"][n]).abs()[big].max().item()
        own = (c["sd"][n] - c32["sd"][n]).abs()[big].max().item()
        if err > cs.TINY_UPDATE_TOL * LR and err > cs.TINY_GRAD_RATIO * own and err > err_worst:
            worst, err_worst = n, err
    return dict(failed=bool(worst), update_err_over_lr=err_worst / LR, worst=worst)


def at_worst(n, x, c, c32, g) -> dict:
    """Of tensor n's entries whose gradient in x is above 2e-1 of its max:
    how many updates of g and of the CPU's bf16 step lie more than lr from
    x's, and at the one where g's lies furthest, each side's gradient over
    its own tensor's max."""
    big = (x["grads"][n].abs() >= 2e-1 * x["grads"][n].abs().max()).flatten()
    d = (g["sd"][n] - x["sd"][n]).abs().flatten()
    own = (c["sd"][n] - x["sd"][n]).abs().flatten()
    i = torch.nonzero(big).flatten()[d[big].argmax()]
    out = dict(held=int(big.sum()), flips=int((d[big] > LR).sum()),
               cpu_bf16_flips=int((own[big] > LR).sum()))
    out.update({side: round((y["grads"][n].flatten()[i] / y["grads"][n].abs().max()).item(), 4)
                for side, y in (("cpu_bf16", c), ("this side", g), ("cpu_f32", c32))})
    return out


def summed_otherwise(video, s1, b1, w, pbias, s2, b2, pt, p, eps=1e-5):
    """patch_embed_plain with its sums in f64 (the rounding points kept): a
    bf16 side that differs from the CPU's only in summation order."""
    from ct_clip_tpu_torch.ops import patch_embed as pe
    from ct_clip_tpu_torch.ops.norms import layer_norm

    rows = pe.patchify(video, pt, p)
    x = rows.double()
    mean = x.mean(-1, keepdim=True)
    xc = x - mean
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xn = ((xc * rstd).float() * s1.float() + b1.float()).to(rows.dtype)
    y = (xn.double() @ w.to(rows.dtype).double().t()).to(rows.dtype)
    return layer_norm(y + pbias.to(rows.dtype), s2, b2, eps)


def embeds(dev, seeds, results: dict) -> None:
    """`--embed` (module doc)."""
    from ct_clip_tpu_torch.ops import patch_embed as pe

    bf, cpu = torch.bfloat16, torch.device("cpu")
    built, plain, calls = pe._patch_embed_cuda, pe.patch_embed_plain, []

    def recorded(video, *args):
        out = built(video, *args)
        ref = pe.patch_embed_plain(video, *args)
        d = (out.float() - ref.float()).abs()
        calls.append(dict(shape=list(video.shape),
                          max_rel=(d.max() / ref.float().abs().max()).item(),
                          mean_rel=(d.mean() / ref.float().abs().mean()).item()))
        return out

    def three_passes(video, s1, b1, w, pbias, s2, b2, pt, p, eps):
        return cs.embed_three_passes(video, (s1, b1, w, pbias, s2, b2), (pt, p), eps)
    witnesses = (("card, K8 on embed_tc.cu", dev, "_patch_embed_cuda", recorded),
                 ("card, K8 on the three passes it replaced", dev, "_patch_embed_cuda",
                  three_passes),
                 ("CPU, the embed's sums in f64", cpu, "patch_embed_plain", summed_otherwise))
    for seed in seeds:
        side, start = sides(cs.tiny_aux_config(), seed)
        c, c32 = side(cpu, bf), side(cpu, torch.float32)
        rows = {}
        for label, device, attr, fn in witnesses:
            setattr(pe, attr, fn)
            try:
                g = side(device, bf)
            finally:
                pe._patch_embed_cuda, pe.patch_embed_plain = built, plain
            res, fail = cs.compare_tiny_steps(c, c32, g, start, LR, noise_aware_updates=True)
            old = bf16_rule(c, c32, g, start)
            row = dict(failures=fail, update_err_over_lr=res["update_err_over_lr"],
                       update_worst=res["update_worst"], grad_ratio=res["grad_ratio"],
                       grad_top=[[n, round(r, 3)] for n, r, *_ in res["grad_top"][:3]],
                       within_cpu_bf16_noise=len(res["updates_within_cpu_bf16_noise"]),
                       sign_flips=res["update_sign_flips"],
                       sign_flips_within_cpu_bf16_noise=res[
                           "update_sign_flips_within_cpu_bf16_noise"],
                       bf16_rule=old)
            for n in row["sign_flips"]:
                row["sign_flips"][n].append(at_worst(n, c32, c, c32, g))
            if old["worst"]:
                row["bf16_rule"]["at_worst"] = at_worst(old["worst"], c, c, c32, g)
            rows[label] = row
            print(f"seed {seed}, {label}: outside {fail or 'none'}; update sizes "
                  f"{row['update_err_over_lr']:.3f} lr ({row['update_worst'] or '-'}); sign "
                  f"flips against f32 {row['sign_flips'] or 'none'}, within the CPU's noise "
                  f"{len(row['sign_flips_within_cpu_bf16_noise'])} tensors; gradients "
                  f"{row['grad_top']}; the rule against the CPU's bf16 step: "
                  f"{'fails' if old['failed'] else 'passes'} ({old['update_err_over_lr']:.3f} "
                  f"lr, {old['worst'] or '-'}) {old.get('at_worst', '')}", flush=True)
        if calls and "k8_calls_against_plain" not in results:
            results["k8_calls_against_plain"] = list(calls)
            print(f"  K8 calls against the plain version on the card: {calls}", flush=True)
        results[f"seed {seed}"] = rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--embed", action="store_true",
                    help="the check with K8 on embed_tc.cu and on the three passes it replaced")
    ap.add_argument("--seeds", default="8", help="--embed: comma-separated init seeds")
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
    if args.embed:
        embeds(dev, [int(x) for x in args.seeds.split(",")], results)
        if args.out:
            Path(args.out).write_text(json.dumps(results, indent=1))
        return 0
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
