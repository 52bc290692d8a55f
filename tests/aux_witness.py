#!/usr/bin/env python3
"""A third witness for chip_smoke.py's phase 7 (the tiny aux CT-CLIP step):
the gradient of the temperature at each init seed, from the JAX package in
bf16 beside the port's CPU sides, on the CPU.

    JAX_PLATFORMS=cpu python tests/aux_witness.py [--seeds 8,1,5]
        [--card NOISE.json] [--out FILE.json]

Phase 7 holds the card's bf16 step against the CPU's f32 step, its noise
scale the CPU's own bf16-f32 distance (`chip_smoke.pooled_cpu_noise`).  The
CPU's bf16 step rounds where the port's plain versions round, the card where
the TPU kernels round; this script asks where a step that rounds like the
TPU kernels lands.  For each init seed of `--seeds` it builds the start
state as phase 7 does (`chip_smoke.tiny_sides`), carries it into the JAX
package (`ct_clip_tpu.convert.torch_to_jax.ctclip_params_from_torch`) and
takes the gradient of the loss with respect to the temperature three ways:
f32, bf16 on the XLA twins of the Pallas kernels, and bf16 with every Pallas
kernel in interpret mode (the kernel bodies, their rounding points).  The
temperature enters only the contrastive loss, so the JAX model is built
without MLM and visual SSL and its gradient scaled by the contrastive
weight.  Beside them the port's CPU sides of the same step (bf16 and f32),
and with `--card` (the JSON of `tools/port_tiny_aux_probe.py --noise`) the
card's and that run's CPU sides.  Each value also as its signed distance
from the port's f32 value over that value (the card's and that run's CPU
bf16 also from that run's CPU f32: the start state is made on the CPU, in
bf16, and may differ between machines).  One jit per mode (~2-4 min each).

It imports the JAX package and the port, so it lives with the tests; it is
not a test (the compiles take minutes).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ("f32", "bf16_xla", "bf16_interpret")


def jax_config(p, cls_of):
    """The JAX package's config of the port's config `p` (same field
    names; nested configs likewise)."""
    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        kw[f.name] = jax_config(v, cls_of) if dataclasses.is_dataclass(v) else v
    cls = cls_of(type(p).__name__)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in kw.items() if k in names})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="8,1,2,3,4,5", help="comma-separated init seeds")
    ap.add_argument("--card", default=None,
                    help="tools/port_tiny_aux_probe.py --noise JSON: the card's values beside")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    import ct_clip_tpu as J
    from ct_clip_tpu.convert.torch_to_jax import ctclip_params_from_torch
    from ct_clip_tpu.models import CTCLIP
    from ct_clip_tpu.ops.pallas import _call
    from ct_clip_tpu_torch.config import TrainConfig

    pcfg = cs.tiny_aux_config()
    jcfg = jax_config(pcfg, lambda name: getattr(J, name)).replace(use_mlm=False,
                                                                    use_visual_ssl=False)
    cl_weight = 1.0 - (pcfg.text_ssl_loss_weight * pcfg.use_mlm
                       + pcfg.image_ssl_loss_weight * pcfg.use_visual_ssl)
    ids, mask, video = (jnp.asarray(t.numpy()) for t in cs.tiny_ctclip_inputs())
    cpu = torch.device("cpu")
    out = {s: {} for s in seeds}
    starts = {}
    for seed in seeds:
        side, start = cs.tiny_sides(pcfg, TrainConfig(lr=1e-3), seed)
        for label, dtype in (("port_cpu_f32", torch.float32), ("port_cpu_bf16", torch.bfloat16)):
            out[seed][label] = side(cpu, dtype)["grads"]["temperature"].item()
        starts[seed] = ctclip_params_from_torch(
            {k: v.float().numpy() for k, v in start.items()}, jcfg)
        print(f"seed {seed}: {out[seed]}", flush=True)
    try:
        for mode in MODES:
            _call.set_interpret(mode == "bf16_interpret")
            jax.clear_caches()
            model = CTCLIP(jcfg, dtype=jnp.float32 if mode == "f32" else jnp.bfloat16)

            def loss_fn(params, vq):
                loss, _ = model.apply({"params": params, "vq": vq}, ids, mask, video,
                                      return_loss=True, train=True, deterministic=True,
                                      mutable=["vq"])
                return loss
            grad = jax.jit(jax.grad(loss_fn))
            for seed in seeds:
                t0 = time.time()
                g = grad(starts[seed]["params"], starts[seed]["vq"])
                out[seed][f"jax_{mode}"] = float(g["temperature"]) * cl_weight
                print(f"seed {seed}, JAX {mode}: {out[seed][f'jax_{mode}']:.9g} "
                      f"({time.time() - t0:.0f} s)", flush=True)
    finally:
        _call.set_interpret(False)
    if args.card:
        card = json.loads(Path(args.card).read_text())
        for seed in seeds:
            grads = card[f"seed {seed}"]["tensors"]["temperature"]["grads"]
            for label in ("card", "cpu_bf16", "cpu_f32"):
                out[seed][f"card_run_{label}"] = grads[label][0]
    for seed in seeds:
        ref = out[seed]["port_cpu_f32"]
        rel = {k: round((v - ref) / abs(ref), 5) for k, v in out[seed].items()}
        if args.card:  # that run's start was made on its own machine's CPU
            ref = out[seed]["card_run_cpu_f32"]
            rel["card_run_vs_its_cpu_f32"] = {
                k: round((out[seed][f"card_run_{k}"] - ref) / abs(ref), 5)
                for k in ("card", "cpu_bf16")}
        out[seed] = dict(values=out[seed], rel_to_port_cpu_f32=rel)
        print(f"seed {seed}, relative to the port's CPU f32 value: {json.dumps(rel)}",
              flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
