#!/usr/bin/env python3
"""The MaskGIT phase of chip_smoke.py (`maskgit_phase`: MaskGitTrainer steps
with the TokenCritic at full width, sampling) from one checkout, printed as
one JSON line, so that two commits can be compared on one card in turns:

    git archive PARENT | tar -x -C build/parent   # and the change likewise
    for t in build/parent build/change build/change build/parent; do
        python tools/port_maskgit_ab.py $t
    done

Each line: the tree, the median step of steps 2-4 and all three (CUDA
events), the profiled step's device busy time, host clock and idle share,
and sampling's seconds per volume and the primed sample's seconds.  The
step is launch-bound, so compare only lines from one call.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("usage: port_maskgit_ab.py TREE (on a machine with an NVIDIA GPU)",
              file=sys.stderr)
        return 1
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from ct_clip_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.library()
    r = cs.maskgit_phase(torch.device("cuda", 0), Path(tempfile.mkdtemp()), str(tree))
    bd = r["step_breakdown"]
    print(json.dumps(dict(tree=str(tree), step_ms=r["step_ms"], step_ms_all=r["step_ms_all"],
                          busy_ms=bd["busy_ms"], wall_ms=bd["wall_ms"],
                          idle_share=bd["idle_share"],
                          sample_s_per_volume=r["sample_s_per_volume"],
                          primed_sample_s=r["primed_sample_s"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
