#!/usr/bin/env python3
"""Why the tiny aux CT-CLIP check of chip_smoke.py keeps its BERT at four
heads of 16: run that check (`tiny_aux_config`, card against CPU, with
`compare_tiny_steps`' limits) with the BERT at one head of 64, its K12a on
the tensor cores (attention_tc.cu) and again forced to the CUDA cores
(attention_train.cu), then at the four heads of 16 it keeps.

    PYTHONPATH=. python tools/port_tiny_aux_probe.py [--seeds 8,1,2] [--out FILE.json]
    PYTHONPATH=. python tools/port_tiny_aux_probe.py --embed | --noise | --towers
                                                     [--seeds 8,1,2] [--out FILE.json]

Every verdict is `compare_tiny_steps`' as phase 7 takes it: the card against
the f32 step, the CPU's own noise pooled over the init seeds of `--seeds`
(`chip_smoke.pooled_cpu_noise`; phase 7 pools over 8 and
chip_smoke.AUX_NOISE_SEEDS).

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
alone).  Each side's failures under `compare_tiny_steps` as built with its
sign flips and, at each flip, the gradient over its tensor's max on each
side, its worst gradients and update sizes; and
under the earlier rule holding sign and size against the CPU's bf16 step
alone (`bf16_rule`); at the first seed each K8 call's output on
embed_tc.cu against the plain version on the card (max and mean error over
max and mean |plain|).

`--noise`: for each init seed of `--seeds`, the CPU's bf16 and f32 steps,
the card's bf16 step and the card's with each of
`chip_smoke.aux_planted_faults()` (the per-tensor numbers below for the
first, a kernel's; the others change only the optimizer step), the CPU's
bf16 update noise at that seed (the largest size error where the signs
agree, the flips per tensor: phase 7's update limits are their largest over
the seeds), and for every tensor the numbers the check's noise scale is
drawn from:
its entries, the L2 distances (relative to the CPU's bf16 gradient) of the
CPU's f32 gradient, the card's and the planted fault's, the RMS of the
CPU's bf16-f32 gradient difference, and on the entries whose f32 gradient
is >= 0.2 of its tensor's largest, each side's update sign flips against
the f32 step with the entry's |g32| over that RMS, and the largest update
size error against the CPU's bf16 step; the gradients of tensors of at most
16 entries (the temperature) on every side; then `compare_tiny_steps`' own
verdict for the card and for each fault: phase 7's check at each seed.

`--towers`: where the temperature's gradient picks up its bf16 noise.  The
temperature enters only the contrastive loss (FILIP here), whose inputs are
the two towers' outputs.  For each init seed, the text and image towers of
the step (training mode, the VQ's included) on the CPU in f32, on the CPU in
bf16 and on the card in bf16; then the contrastive loss's gradient of the
temperature on the CPU in f32 from every pairing of a text side with an
image side, and from the f32 and the card's towers with the latent
projections in bf16 on the CPU and on the card (the last the card's own
step); each relative to the all-f32 value, and each tower's
output as its L2 distance from f32.  With `--out`, all of it as JSON.
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
from ct_clip_tpu_torch.ops import attention as A  # noqa: E402
from ct_clip_tpu_torch.ops import kernels as K  # noqa: E402

LR = 1e-3


def sides(cfg, seed: int = 8):
    """(side(device, dtype), start state) of the tiny step, as tiny_step_check
    (whose init seed is 8)."""
    return cs.tiny_sides(cfg, TrainConfig(lr=LR), seed)


def pooled(cfg, seeds) -> dict:
    """The CPU's own noise of the tiny step of `cfg` pooled over the init
    seeds `seeds`, as chip_smoke.py's phase 7 pools it."""
    return cs.pooled_cpu_noise(cs.cpu_noise_sides(cfg, TrainConfig(lr=LR), seeds), LR)


def report(label, c, c32, g, start, noise) -> dict:
    res, fail = cs.compare_tiny_steps(c, c32, g, start, LR, pooled=noise)
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

    cpu_noise = pooled(cs.tiny_aux_config(), seeds)
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
            res, fail = cs.compare_tiny_steps(c, c32, g, start, LR, pooled=cpu_noise)
            old = bf16_rule(c, c32, g, start)
            row = dict(failures=fail, update_err_over_lr=res["update_err_over_lr"],
                       update_worst=res["update_worst"], grad_ratio=res["grad_ratio"],
                       grad_top=[[n, round(r, 3)] for n, r, *_ in res["grad_top"][:3]],
                       sign_flips=res["update_sign_flips"], bf16_rule=old)
            for n in row["sign_flips"]:
                row["sign_flips"][n] = [row["sign_flips"][n], at_worst(n, c32, c, c32, g)]
            if old["worst"]:
                row["bf16_rule"]["at_worst"] = at_worst(old["worst"], c, c, c32, g)
            rows[label] = row
            print(f"seed {seed}, {label}: outside {fail or 'none'}; update sizes "
                  f"{row['update_err_over_lr']:.3f} lr ({row['update_worst'] or '-'}); sign "
                  f"flips against f32 {row['sign_flips'] or 'none'}; gradients "
                  f"{row['grad_top']}; the rule against the CPU's bf16 step: "
                  f"{'fails' if old['failed'] else 'passes'} ({old['update_err_over_lr']:.3f} "
                  f"lr, {old['worst'] or '-'}) {old.get('at_worst', '')}", flush=True)
        if calls and "k8_calls_against_plain" not in results:
            results["k8_calls_against_plain"] = list(calls)
            print(f"  K8 calls against the plain version on the card: {calls}", flush=True)
        results[f"seed {seed}"] = rows


def noise(dev, seeds, results: dict) -> None:
    """`--noise` (module doc)."""
    bf, cpu = torch.bfloat16, torch.device("cpu")
    faults = cs.aux_planted_faults()
    cpu_noise = pooled(cs.tiny_aux_config(), seeds)
    results["pooled_cpu_noise"] = dict(flips=cpu_noise["flips"], grad=cpu_noise["grad"],
                                       size_over_lr=cpu_noise["size"] / LR,
                                       seeds=cpu_noise["seeds"])
    size_limit = max(cs.TINY_UPDATE_TOL * LR, cpu_noise["size"]) / LR
    print(f"pooled CPU noise: update size limit {size_limit:.4f} lr, sign flip limits "
          f"{cpu_noise['flips']}", flush=True)
    for seed in seeds:
        side, start = sides(cs.tiny_aux_config(), seed)
        c, c32, g = side(cpu, bf), side(cpu, torch.float32), side(dev, bf)
        broken = {}
        for name, (module, attr, fn, *_) in faults.items():
            with cs.replaced(module, attr, fn):
                broken[name] = side(dev, bf)
        gf = broken[next(iter(faults))]
        u = cs.update_noise(c, c32, start, LR)
        cpu_update = dict(size_over_lr=u["size"] / LR, size_worst=u["size_worst"],
                          flips=u["flips"])
        print(f"seed {seed}, CPU bf16 update noise: {json.dumps(cpu_update)}", flush=True)
        rows = {}
        for n, ref in c["grads"].items():
            if not ref.numel():
                continue
            true = c32["grads"][n]
            scale = max(ref.norm().item(), 1e-30)
            scale32 = max(true.norm().item(), 1e-30)
            rms = (ref - true).pow(2).mean().sqrt().item()
            big = true.abs() >= 2e-1 * true.abs().max()
            bigc = ref.abs() >= 2e-1 * ref.abs().max()
            step32 = (c32["sd"][n] - start[n].float())
            stepc = (c["sd"][n] - start[n].float())
            row = dict(numel=ref.numel(), l2_f32=(true - ref).norm().item() / scale,
                       rms_bf16_f32=rms, max_abs_f32=true.abs().max().item(), big=int(big.sum()),
                       zero_grad=n.endswith(cs.ZERO_GRAD))
            row["norm_f32"] = true.norm().item()
            row["update_norm_f32"] = step32.norm().item()
            for label, x in (("cpu_bf16", c), ("card", g), ("fault", gf)):
                # distances to the f32 gradient, over its norm; the update's, absolute
                row[f"l2_{label}_vs_f32"] = (x["grads"][n] - true).norm().item() / scale32
                row[f"update_l2_{label}_vs_f32"] = (x["sd"][n] - c32["sd"][n]).norm().item()
                row[f"update_l2_{label}_vs_bf16"] = (x["sd"][n] - c["sd"][n]).norm().item()
                if label != "cpu_bf16":
                    row[f"l2_{label}"] = (x["grads"][n] - ref).norm().item() / scale
                full = x["sd"][n] - start[n].float()
                step = full[big]
                flip = (step - step32[big]).abs() > LR
                row[f"flips_{label}"] = int(flip.sum())
                if flip.any():  # |g32| over the bf16-f32 RMS at each flipped entry
                    row[f"flip_z_{label}"] = sorted(
                        round(v, 3) for v in (true[big][flip].abs() / max(rms, 1e-30)).tolist())[:8]
                size = (step - stepc[big]).abs()
                row[f"size_err_over_lr_{label}"] = size.max().item() / LR if size.numel() else 0.0
                # sizes against the f32 step on its large entries where the signs agree,
                # and against the CPU's bf16 step on its large entries where they agree
                d32 = (full - step32).abs()[big]
                d32 = d32[d32 <= LR]
                row[f"size32_{label}"] = d32.max().item() / LR if d32.numel() else 0.0
                dc = (full - stepc).abs()[bigc]
                dc = dc[dc <= LR]
                row[f"sizec_{label}"] = dc.max().item() / LR if dc.numel() else 0.0
            if ref.numel() <= 16:
                row["grads"] = {label: x["grads"][n].flatten().tolist()
                                for label, x in (("cpu_bf16", c), ("cpu_f32", c32), ("card", g),
                                                 ("fault", gf))}
            rows[n] = row
        verdicts = {}
        for label, x in (("card", g), *broken.items()):
            res, fail = cs.compare_tiny_steps(c, c32, x, start, LR, pooled=cpu_noise)
            must = faults[label][3:] if label in faults else ()
            verdicts[label] = dict(failures=fail, must_fail=list(must),
                                   caught=label in faults and bool(fail)
                                   and set(must) <= set(fail),
                                   grad_ratio=res["grad_ratio"],
                                   grad_top=res["grad_top"][:3],
                                   update_err_over_lr=res["update_err_over_lr"],
                                   update_worst=res["update_worst"],
                                   update_size_limit_over_lr=res["update_size_limit_over_lr"],
                                   sign_flips=res["update_sign_flips"],
                                   sign_flips_over_limit=res["update_sign_flips_over"])
            print(f"seed {seed}, {label}: outside {fail or 'none'}; {json.dumps(verdicts[label])}",
                  flush=True)
        for n in ("temperature", "logit_scale"):
            if n in rows:
                print(f"seed {seed}, {n}: {json.dumps(rows[n])}", flush=True)
        results[f"seed {seed}"] = dict(tensors=rows, verdicts=verdicts,
                                       cpu_bf16_update_noise=cpu_update,
                                       loss={k: x["loss"] for k, x in (("cpu_bf16", c),
                                             ("cpu_f32", c32), ("card", g), ("fault", gf))})


def towers(dev, seeds, results: dict) -> None:
    """`--towers` (module doc)."""
    from ct_clip_tpu_torch.models import CTCLIP

    cfg, bf, f32, cpu = cs.tiny_aux_config(), torch.bfloat16, torch.float32, torch.device("cpu")
    cl_weight = 1.0 - (cfg.text_ssl_loss_weight * cfg.use_mlm
                       + cfg.image_ssl_loss_weight * cfg.use_visual_ssl)
    ids, mask, video = cs.tiny_ctclip_inputs()
    for seed in seeds:
        _, start = sides(cfg, seed)
        enc = {}
        for label, device, dtype in (("f32", cpu, f32), ("cpu_bf16", cpu, bf),
                                     ("card", dev, bf)):
            model = CTCLIP(cfg, dtype=dtype, device=device)
            model.load_state_dict(start)
            model.train()
            with torch.no_grad():
                et = model.text_transformer(ids.to(device), mask.to(device))
                ei = model.visual_transformer(video.to(device), train=True)
            enc[label] = (et.float().cpu(), ei.float().cpu())
        heads = {}
        for device, dtype in ((cpu, f32), (cpu, bf), (dev, bf)):
            heads[device.type, dtype] = CTCLIP(cfg, dtype=dtype, device=device)
            heads[device.type, dtype].load_state_dict(start)

        def temp_grad(et, ei, device=cpu, dtype=f32):
            # the contrastive loss's temperature gradient from these tower outputs: the
            # latent projections and l2norm in `dtype` on `device`, the similarities in f32
            m = heads[device.type, dtype]
            cl, _ = m._filip(et.to(device, dtype), ei.to(device, dtype), mask.to(device),
                             m.temperature.exp(), True, 1, 1)
            return torch.autograd.grad(cl * cl_weight, m.temperature)[0].item()
        row = {f"text {t}, image {i}": temp_grad(enc[t][0], enc[i][1])
               for t in enc for i in enc}
        for t in ("f32", "card"):
            row[f"text {t}, image {t}, latents in bf16 on the CPU"] = temp_grad(
                *enc[t], dtype=bf)
            row[f"text {t}, image {t}, latents in bf16 on the card"] = temp_grad(
                *enc[t], device=dev, dtype=bf)
        base = row["text f32, image f32"]
        rel = {k: round((v - base) / abs(base), 5) for k, v in row.items()}
        dist = {label: dict(text=((enc[label][0] - enc["f32"][0]).norm()
                                  / enc["f32"][0].norm()).item(),
                            image=((enc[label][1] - enc["f32"][1]).norm()
                                   / enc["f32"][1].norm()).item())
                for label in ("cpu_bf16", "card")}
        results[f"seed {seed}"] = dict(temperature_grad=row, rel_to_f32=rel,
                                       tower_l2_rel_to_f32=dist)
        print(f"seed {seed}: temperature gradient relative to all-f32 {json.dumps(rel)}; "
              f"tower outputs' L2 distance from f32 {json.dumps(dist)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--embed", action="store_true",
                    help="the check with K8 on embed_tc.cu and on the three passes it replaced")
    ap.add_argument("--noise", action="store_true",
                    help="each tensor's bf16 noise, the card's and the planted fault's distances")
    ap.add_argument("--towers", action="store_true",
                    help="the temperature's gradient from each side's text and image towers")
    ap.add_argument("--seeds", default="8,1,2,3,4,5",
                    help="comma-separated init seeds: those --embed and --noise run at, and "
                         "those every verdict pools the CPU's noise over")
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
    if args.embed or args.noise or args.towers:
        mode = noise if args.noise else towers if args.towers else embeds
        mode(dev, [int(x) for x in args.seeds.split(",")], results)
        if args.out:
            Path(args.out).write_text(json.dumps(results, indent=1))
        return 0
    seeds = [int(x) for x in args.seeds.split(",")]
    aux = cs.tiny_aux_config()
    one = aux.replace(bert=aux.bert.replace(num_attention_heads=1))
    side, start = sides(one)
    c, c32, one_noise = side(cpu, bf), side(cpu, torch.float32), pooled(one, seeds)
    results["one head of 64, K12a on the tensor cores"] = report(
        "one head of 64, K12a on the tensor cores", c, c32, side(dev, bf), start, one_noise)
    route, count = A.attention_route, K.count_launch
    A.attention_route = lambda *a: (A.TRAIN, A.TRAIN)
    # the side asserts its K12a launches on the tensor cores: count the forced ones there
    K.count_launch = lambda name: (count(name),
                                   name == "attention_bwd" and count("attention_tc_bwd"))
    try:
        results["one head of 64, K12a forced to the CUDA cores"] = report(
            "one head of 64, K12a forced to the CUDA cores", c, c32, side(dev, bf), start,
            one_noise)
    finally:
        A.attention_route, K.count_launch = route, count
    side, start = sides(aux)
    results["four heads of 16 (tiny_aux_config)"] = report(
        "four heads of 16 (tiny_aux_config)", side(cpu, bf), side(cpu, torch.float32),
        side(dev, bf), start, pooled(aux, seeds))
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
