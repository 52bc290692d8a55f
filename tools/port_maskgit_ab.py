#!/usr/bin/env python3
"""A step phase of chip_smoke.py from one checkout, printed as one JSON
line, so that two commits can be compared on one card in turns:

    git archive PARENT | tar -x -C build/parent   # and the change likewise
    for t in build/parent build/change build/change build/parent; do
        python tools/port_maskgit_ab.py $t [--phase maskgit | maskgit_f32 | radbert]
    done

Phases: `maskgit` (the default; `maskgit_phase`: MaskGitTrainer steps with
the TokenCritic at full width, sampling), `maskgit_f32` (`maskgit_f32_phase`,
the same in f32) and `radbert` (`radbert_phase`: the CLI's radbert-train,
-infer and -eval at full width, then the f32 training step).  Each line: the
tree, the phase, the median step (CUDA events: MaskGIT steps 2-4, RadBERT
2-5) and every step, the profiled step's device busy time, host clock and
idle share and its summed device ms by kernel group; for `maskgit`
sampling's seconds per volume and the primed sample's seconds.  The steps
are partly launch-bound, so compare only lines from one call.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", help="the root of a checkout")
    ap.add_argument("--phase", choices=("maskgit", "maskgit_f32", "radbert"), default="maskgit")
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
    r = getattr(cs, f"{args.phase}_phase")(torch.device("cuda", 0), Path(tempfile.mkdtemp()),
                                           str(tree))
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
