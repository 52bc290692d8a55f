#!/usr/bin/env python3
"""The bf16 training kernels K11, K9, K10 grid, K15 and K5 exact from one
checkout, timed as chip_smoke.py times them, printed as one JSON line, so
that two commits can be compared on one card in turns:

    git archive PARENT | tar -x -C build/parent
    for t in build/parent . . build/parent; do python tools/port_bf16_ab.py $t; done
    python tools/port_bf16_ab.py --sass build/parent/build/ct_clip_tpu_torch/LIB.so \\
        build/ct_clip_tpu_torch/LIB.so [--replaced NAME,...]

Each timing line: the tree, then for K11 (the GEGLU FF backward), K9 (the
spatial sublayer's backward on (192, 576, 512) planes with the CPB bias),
K10 grid (the temporal sublayer's on the (8, 24, 576, 512) grid), K15 (the
VQ statistics) and K5 exact (the training assignment), all at the training
batch's 110,592 rows, the median ms of 10 calls of the wrapper (CUDA
events), from the tree's own chip_smoke.py cases.  With --sass, the two
libraries' machine code (cuobjdump -sass), each kernel's instructions with
addresses, encodings and symbol names dropped: how many of the first
library's kernels have an identical twin in the second, and which have none,
by name; with --replaced, the kernels a change replaces by design (a name
matches a kernel whose symbol holds it), and exit code 1 if any other
kernel lacks a twin.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


def sass_kernels(lib: str) -> dict:
    """kernel symbol -> its normalised instruction list."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def compare_sass(lib_a: str, lib_b: str, replaced=()) -> dict:
    """The first library's kernels without an identical twin in the second:
    `replaced`, those whose symbol holds one of the names a change replaces
    by design, and `unexpected`, the rest."""
    a, b = sass_kernels(lib_a), sass_kernels(lib_b)
    twins = {tuple(code): n for n, code in b.items()}
    missing = [n for n, code in a.items() if tuple(code) not in twins]
    by_design = [n for n in missing if any(r in n for r in replaced)]
    return dict(kernels_a=len(a), kernels_b=len(b), identical=len(a) - len(missing),
                without_twin=missing, replaced_names=list(replaced), replaced=by_design,
                unexpected=[n for n in missing if n not in by_design])


def main() -> int:
    if len(sys.argv) in (4, 6) and sys.argv[1] == "--sass":
        replaced = sys.argv[5].split(",") if len(sys.argv) == 6 and sys.argv[4] == "--replaced" \
            else ()
        report = compare_sass(sys.argv[2], sys.argv[3], replaced)
        print(json.dumps(report), flush=True)
        return 1 if report["unexpected"] else 0
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("usage: port_bf16_ab.py TREE | --sass LIB_A LIB_B [--replaced NAME,...] (on a "
              "machine with an NVIDIA GPU)", file=sys.stderr)
        return 1
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from ct_clip_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    K.library()
    res = {}
    names = dict(geglu_ff_bwd="K11", spatial_attention_bwd="K9", grid_attention_bwd="K10 grid",
                 grid_attention_bwd_short="K10 core", vq_cluster_stats="K15",
                 vq_assign_exact="K5 exact")
    for name, case in cs.train_kernel_cases(dev):  # K13 after them
        if name in names:
            res[names[name]] = cs.cuda_ms(case["kern"])
        del case
        torch.cuda.empty_cache()
        if name == "vq_assign_exact":
            break
    print(json.dumps(dict(tree=str(tree), library=K.library_path().name, ms=res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
