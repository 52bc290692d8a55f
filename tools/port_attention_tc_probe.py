#!/usr/bin/env python3
"""What holds the port's tensor-core attention (csrc/attention_tc.cu, bf16,
and csrc/attention_tc32.cu, f32 in 3xTF32) back: time each kernel as built
against copies with one change each, on one card, in turns, on the same
inputs.

    python tools/port_attention_tc_probe.py [--kernel attention] [--out FILE.json]
    python tools/port_attention_tc_probe.py --kernel k17 | k9 | k9_f32 | k11 | k16a | k3_f32
                                            | k1 | k1_f32 | k3 | k5 | k2 | k2_f32 | k11_f32
                                            | k10_f32 | k10 | k5_exact | k14 | k4 | k8
                                            | k15 | k16b
                                            [--tree DIR] [--copies]
    python tools/port_attention_tc_probe.py --kernel k9_copies | k9_f32_copies

`--kernel attention` (the default) times attention_tc.cu and
attention_tc32.cu as below; `k17` and `k9` time K17 f32 and K9's bf16 core
(further below) on the package of the checkout `--tree` (by default this
one), so that two commits can be compared on one card in turns:

    git archive PARENT | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python tools/port_attention_tc_probe.py --kernel k17 --tree $t
    done

Every result carries the card's name and power limit (nvidia-smi) and ends
as one JSON line; the timers are tools/port_timing.py's.

Copies of attention_tc.cu (each its own nvcc build under
build/attention_tc_probe/<copy>/, beside its own common.cuh, wgmma.cuh and
tc32.cuh):
  as_built     the sources unchanged;
  two_ctas     the forward at two CTAs per SM (launch bounds 2, not 3);
  exp2f        libm's exp2f in place of one ex2.approx;
  stages4      a ring of four stages, not two;
  no_loads     the producer copies nothing (stale tiles): the time without
               global loads;
  no_products  every wgmma left out (garbage results): the time without the
               tensor cores;
  no_philox    Philox4x32 with no rounds (the counter words as bits): the
               dropout forward's and backward's time without drawing the
               mask.
The last three compute garbage and only measure.  Shapes: the zero-shot
prompts' key-bias form (36, 12, 512, 64); MaskGIT's dense and no-bias forms
at (8, 8, 1280, 64), forward and backward; CXR-BERT's training shape (8, 12,
512, 64) with ragged pad lengths, the key-bias forward (K7) and backward
with dkey_bias (K12a), and the forward (K13a) and backward (K13b) with
dropout 0.1; all bf16.
Copies of attention_tc32.cu, each timed on its forward and its backward:
at RadBERT's (32, 12, 512, 64) with a pad key bias (K7 f32; the backward
with dkey_bias, K12a f32) and with dropout 0.1 (K13a f32, K13b f32), at
MaskGIT's (8, 8, 1280, 64) with the per-head dense bias (K7 dense f32; the
backward with dbias, K12b f32) and with no bias (the TokenCritic's), and at
T5's (8, 12, 256, 64) with its per-head dense bias:
  as_built     the source unchanged (3xTF32);
  hi_only      CT_TC32_PASSES 1: one TF32 product per f32 one (hi hi);
  no_products  every mma.sync left out (garbage results);
  no_loads     no tile copied to shared memory (stale tiles).
For each copy and shape: the median of 20 calls between CUDA events (the
binding called directly), the kernels' own device times from torch.profiler,
and, for the copy as built, the host time per call of the Python wrapper
(`fused_attention` or `fused_attention_kbias_dropout` for a forward,
`kernels.attention_tc_bwd` for the key-bias backwards,
`kernels.attention_tc32_bwd` for the f32 ones) against the events around one
call.

`--kernel k17`: K17 f32 (`ops/patch_embed.py::unrearrange_patches`,
csrc/rearrange.cu) at the sampler's (1, 1,280, 2,560) rows of a 200 x 128 x
128 volume (pt 10, p 16) and at one 240 x 480 x 480 training volume's (1,
13,824, 4,000) rows (pt 10, p 20), beside the library call, `.contiguous()`
of the inverse permutation, on the same rows: for each, events, the device
time of its kernels per call and the host time per call (the least of 20
rounds of 50 calls; again with each round queued behind a spin kernel, so
that the sampler's 6 us kernel does not leave each launch an idle queue).  Also the host time of the pieces every wrapper pays:
`torch.empty` of the volume, the current stream (`kernels._stream`).

`--kernel k9`: K9's bf16 attention core alone (`kernels.qk_attention_bwd`,
a CPB-like bias) on CT-CLIP's (192, 576) planes and the autoencoder's (160,
64), 8 heads of 32, and the whole sublayer backward (autograd of
`fused_spatial_qknorm_attention`) on (192, 576, 512) and (160, 64, 512):
events, device time per kernel (the core) and host time per call.  Where the
tree has `kernels.qk_bwd_tensor_cores`, each call again with the core on the
CUDA-core qk_attention_bwd_kernel it replaced ("cuda_cores").

`--kernel k9_f32`: the same in f32 (the core 3xTF32 on
qknorm_attention_tc32.cu where the tree has it; "cuda_cores" the
qk_attention_bwd_f32_kernel it replaced).

`--kernel k11`: K11 in bf16 (autograd of `fused_geglu_ff`) at CT-CLIP's
110,592 training rows x 512 (inner 1,365) and at MaskGIT's and the
autoencoder's 10,240: events, the device time of each kernel per call (the
tile, the three products, the LN backward, the split sums: kernel-only) and
the host time per call; with `--tree`, a parent's K11 the same way.

`--kernel k16a`: K16a (autograd of `fused_patch_embed` into its six
weights) at the aux steps' 8 volumes of 240 x 480 x 480 (110,592 rows x
4,000 -> 512): events, the device time of each kernel per call (the patch LN
recompute, the NT product, the LN(512) backward, the TN product and its
split sums, the NN product with the LN(4,000) sums and their sums:
kernel-only; the products also by form, ff_tc_gemm<TA, FORM>) and the host
time per call; beside it, where the tree's
chip_smoke.py has it, the path it replaced (`k16a_replaced`: gemm.cu's WMMA
products and the LN(4,000) backward over a stored f32 dxn), the same way.

`--kernel k3_f32`: K3 in f32 (`fused_geglu_ff`, no grad) at MaskGIT's 10,240
rows, zero-shot's 27,648 and the contrastive step's 110,592 (x 512, inner
1,365): events, the device time of each kernel per call and the host time
per call; beside it, where the tree has `ops/ffn.py::_geglu_ff_gemm`, the
path it replaced (gemm.cu's f32 FFMA gemm_kernel on the same f32 tensors).

`--kernel k1`: K1 in bf16 (`fused_spatial_qknorm_attention`, no grad) with
a CPB-like bias at zero-shot's (48, 576, 512) planes, the contrastive step's
(192, 576, 512) and the autoencoder's (160, 64, 512): events, the device
time of each kernel per call and the host time per call; where the tree has
`kernels.qk_bwd_tensor_cores`, again with the gate answering QK_CUDA_CORES
("cuda_cores": the core on attention.cu, the path the tensor cores
replaced), which splits that path's time between LN, the products and the
core.  Then, kernel-only, each piece of the tensor-core route on its own
(where the tree has `kernels.qk_attention_fwd`): LN, the q, kv and output
products (gemm.cu, and where the tree has them ffn_tc.cu's NT store and
residual forms, "_nt"), the core's pre-pass and forward pass.  `--kernel
k1_f32`: the same in f32, whose pieces are the LN split, the x and weight
splits, the q, kv (ffn_tc32.cu's plain-store form) and output (its
residual form) products in 3xTF32, the core's pre-pass and forward pass.

`--kernel k3`: K3 in bf16 (`fused_geglu_ff`, no grad) at MaskGIT's 10,240
rows, zero-shot's 27,648 and the contrastive step's 110,592 (x 512, inner
1,365): events, the device time of each kernel per call and the host time
per call; where the tree has `ops/ffn.py::_geglu_ff_tc`, the path it
replaced (`_geglu_ff_gemm`: gemm.cu's WMMA EPI_GEGLU and EPI_RESIDUAL) the
same way, and each piece of the new route alone, kernel-only: the LN
(layernorm.cu), the GEGLU product and the residual product (ffn_tc.cu).

`--kernel k5`: K5's inference assignment (`ops/vq.py::vq_assign`) at
zero-shot's 27,648 rows x 512 against 8,192 codes, on bf16 and on f32 rows:
events, the device time of each kernel per call and the host time per call;
where the tree has `kernels.vq_assign_tc`, the path it replaced
(`kernels.gemm_argmax`: gemm.cu's gemm_argmax_kernel) the same way, each
piece alone (the f32 rows' pre-pass, the assignment on bf16 rows), and the
L2-traffic variants in turns with the kernel as built: a copy of vq_tc.cu
with 192-row tiles (CT_VQ_TC_CWG=3: three consumer warpgroups, a third less
codebook read from L2, 144 CTAs) at events and kernel-only.

`--kernel k2`: K2 in bf16 (no grad) on zero-shot's (2, 24, 576, 512) grid,
the contrastive step's (8, 24, 576, 512) grid, and the sequence-major
(4,608, 16, 512) (CT-CLIP at 160 frames) and (512, 20, 512) (the
autoencoder): events, the device time of each kernel per call and the host
time per call; where the tree has `kernels.qk_fwd_route`, again on the path
it replaced (the route answering QK_CUDA_CORES and `proj_route` PROJ_WMMA:
attention.cu's core, gemm.cu's products), and each piece alone: the LN, the
q, kv and output products on ffn_tc.cu and on gemm.cu, the core on
qknorm_attention_short.cu and on attention.cu.  `--kernel k2_f32`: the same in f32 (the pieces: the
splits, the 3xTF32 products, the core and attention.cu's f32 core).

`--kernel k11_f32`: K11 in f32 (autograd of `fused_geglu_ff`) at 110,592
and 10,240 rows, and `--kernel k10_f32`: K10 f32 (grid, both sequence
shapes) and K9 f32 (both planes) through autograd of the sublayer; each
with the path it replaced timed beside it where the tree has that path
(`k11_f32`, `k10_f32` docstrings).

`--kernel k10`: K10 bf16 (grid, both sequence shapes) and K9 bf16 (both
planes, with a bias) through autograd of the sublayer: events, host time and
each kernel's device time per call; and the same with
`kernels.qk_bwd_route` answering QK_CUDA_CORES and ffn_tc.cu's NN / TN
products answered by gemm.cu's (`kernels.gemm_nn`, `gemm_tn`): the path the
short core's bf16 form and the products on `wgmma` replaced ("replaced"; a
parent tree takes it anyway).  `--kernel k5_exact`: K5's exact assignment
(`vq_assign(..., exact=True)`) on bf16 and on f32 rows at the contrastive
step's 110,592 and the autoencoder's 10,240 rows x 512 against 8,192
codes: events, host time and each kernel's device time (the f32 rows'
splitting pre-pass apart); beside it gemm.cu's gemm_argmax2_kernel /
gemm_argmax3_rows_kernel (`kernels.gemm_argmax` with the lo part), the path
vq_tc.cu's exact forms replaced.

`--kernel k14`: the PEG through `ops/attention.py::peg_conv` (its forward,
and autograd into x, the weight and the bias: K14) in bf16 and f32 at the
contrastive step's (8, 24, 24, 24, 512) (frame-causal and rotated), zero-
shot's (2, 24, 24, 24, 512) and the autoencoder's (8, 20, 8, 8, 512)
(frame-causal; MaskGIT's non-causal): events, host time, the device time of
each kernel per call and the kernels launched per call; on a tree before
the stencil that is cuDNN's grouped conv (forward, dx) beside
peg_bwd.cu's peg_dw_kernel (bf16; the plain dW in f32), after it
peg_stencil.cu.  Beside each, cuDNN's calls on the same tensors (the
library yardstick, which the port calls nowhere): the forward conv + x +
bias, and dx with the weight and bias gradients.

`--kernel k4` / `k8`: K4 (`fused_row_embed` on zero-shot's (2, 13,824,
4,000) patch rows) or K8 (`fused_patch_embed` on its (2, 240, 480, 480)
volumes, patches 10 x 20 x 20), -> 512, bf16, no grad: events, host time,
each kernel's device time and the launches per call; beside it the three
passes of the path both ran before embed_tc.cu (layernorm.cu's LN(4,000), plain or
through the patch gather; gemm.cu's WMMA product with the rounded bias;
layernorm.cu's LN(512)), together and each alone (kernel-only), and the
yardstick F.layer_norm -> F.linear -> F.layer_norm (cuBLAS; a note, not one
call).  With `--copies`, where the tree has `kernels.embed_tc`, also
embed_tc.cu as built and one-change copies of it (`EMBED_COPIES`), each
built alone.

`--kernel k15`: K15 (`ops/vq.py::cluster_stats`, the VQ's EMA statistics
over 8,192 codes) on bf16 and f32 rows of 512 at the contrastive step's
110,592 rows and the autoencoder's 10,240, under three id distributions:
uniform over the codes; the autoencoder's own (the ids its VQ assigns in
the third `CTViTTrainer` step of `chip_smoke.ae_config()` at init seed 0
on `chip_smoke.write_volumes`' batch, repeated to fill 110,592 rows, kept
in build/ for the later trees of a comparison); and half
the rows (at random positions) in one code, the rest uniform.  Events, host
time, each kernel's device time and the launches per call; where the tree
has `chip_smoke.vq_stats_twin`, vq_stats.cu's path (the one the segmented
kernel replaced) beside it; and the library call, `index_add_` of
the normalised rows with `bincount`.

`--kernel k16b`: K16b (autograd of `fused_row_embed` on the aux steps'
(8, 13,824, 4,000) bf16 patch rows -> 512) into the six weights, and again
into the rows too: events, host time, each kernel's device time (ffn_tc.cu's
forms apart) and the launches per call; where the tree has `chip_smoke.k16b_replaced`, the path
it replaced (layernorm.cu's LN(4,000), gemm.cu's WMMA recompute, TN and NN
products with dxn stored in f32, LN(512) and LN(4,000) backwards) beside it.

`--kernel k9_copies`: K9's core at (192, 576) on copies of
qknorm_attention_tc.cu with one change each, in turns, there and back, with
each kernel's device time: `as_built`; `stages3` (rings of three stages in
the row and column passes, not two); `no_loads` (no tile copied: stale
shared memory, the time without global loads); `no_products` (every wgmma
left out: the time without the tensor cores).  The last two compute garbage
and only measure.  `--kernel k9_f32_copies`: the same for the f32 core on
copies of qknorm_attention_tc32.cu: `as_built`; `hi_only` (CT_TC32_PASSES
1: one TF32 product per f32 one); `no_loads`; `no_products` (every mma.sync
left out).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path

import torch
from port_timing import event_ms, host_ms, kernel_ms, launches_per_call

ROOT = Path(__file__).resolve().parents[1]


def _tree() -> Path:
    """The checkout whose package is timed: `--tree DIR`, else this one."""
    if "--tree" in sys.argv[:-1]:
        return Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
    return ROOT


sys.path.insert(0, str(_tree()))

from ct_clip_tpu_torch.ops import kernels as K  # noqa: E402

CSRC = ROOT / "ct_clip_tpu_torch" / "csrc"
OUT = ROOT / "build" / "attention_tc_probe"
TC, TC32, COMMON, WGMMA = "attention_tc.cu", "attention_tc32.cu", "common.cuh", "wgmma.cuh"
TC32H = "tc32.cuh"  # the 3xTF32 split and products attention_tc32.cu includes
TMA = "tma.cuh"  # the tensor maps and rings of the TMA-fed kernels
# copy -> (source, old text, new text) substitutions
COPIES = {
    "as_built": [],
    "two_ctas": [(TC, "__launch_bounds__(NT, 3) attn_tc_forward",
                  "__launch_bounds__(NT, 2) attn_tc_forward")],
    "exp2f": [(WGMMA, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);")],
    "stages4": [(TC, "constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "no_loads": [(TC, "    cp16(dst + r * 128", "    if (t < -1) cp16(dst + r * 128"),
                 (WGMMA, "      cp16(dst + (r * ld + c) * 4",
                  "      if (i < -1) cp16(dst + (r * ld + c) * 4")],
    "no_products": [(WGMMA, '"wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D',
                     '"// " WG_D')],
    "no_philox": [(COMMON, "for (int r = 0; r < 10; ++r) {", "for (int r = 0; r < 0; ++r) {")],
}
COPIES32 = {
    "as_built": [],
    "hi_only": [(TC32H, "#define CT_TC32_PASSES 3", "#define CT_TC32_PASSES 1")],
    "no_products": [(TC32H, '"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "',
                     '"// {%0, %1, %2, %3}, "')],
    "no_loads": [(TC32, "    cp16(d + (r * LD + 4 * c) * 4,",
                  "    if (tok < -1) cp16(d + (r * LD + 4 * c) * 4,")],
}


def build_all(sets: dict) -> dict:
    """Compile every copy of every source at once (`sets`: source -> its
    copies); source -> copy name -> loaded library."""
    procs = {}
    for source, copies in sets.items():
        for name, subs in copies.items():
            texts = {src: (CSRC / src).read_text()
                     for src in (source, COMMON, WGMMA, TC32H, TMA)}
            for src, old, new in subs:
                if old not in texts[src]:
                    raise RuntimeError(f"{name}: {old!r} not in {src}")
                texts[src] = texts[src].replace(old, new)
            folder = OUT / Path(source).stem / name
            folder.mkdir(parents=True, exist_ok=True)
            for src, text in texts.items():
                (folder / src).write_text(text)
            procs[source, name] = subprocess.Popen(
                [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(folder / "copy.so"),
                 str(folder / source)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {source: {} for source in sets}
    for (source, name), proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{source} {name}: nvcc failed:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(OUT / Path(source).stem / name / "copy.so"))
        K._declare(lib)
        libs[source][name] = lib
    return libs


def inputs(dev, b, h, n, bias_heads, pads, g, dtype=torch.bfloat16):
    """q (scaled), k, v, dO (b, n, h, 64) in `dtype` viewed head-major, a
    dense bias or None, and a key bias of f32-min pads past lengths in
    `pads` (a (low, high) range) or None."""
    q, k, v, do = (torch.randn((b, n, h, 64), generator=g, device=dev).to(dtype)
                   .transpose(1, 2) for _ in range(4))
    bias = torch.randn((bias_heads, n, n), generator=g, device=dev) if bias_heads else None
    kb = None
    if pads:
        lengths = torch.randint(*pads, (b,), generator=g, device=dev)
        kb = (torch.arange(n, device=dev)[None] >= lengths[:, None]).float() \
            * torch.finfo(torch.float32).min
    return q * 0.125, k, v, do, bias, kb


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def forward(lib, q, k, v, bias, kb, seed, rate):
    """The forward, with dropout at `rate` > 0 from `seed` (K13a)."""
    b, h, n, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), device=q.device)
    thresh = K.dropout_threshold(rate) if rate else 0
    err = lib.ct_attn_tc_fwd(_p(q), _p(k), _p(v), _p(out), K._bhnd_strides(q, k, v, out),
                             _p(kb), _p(bias), 0 if bias is None else bias.shape[0], _p(lse),
                             _p(seed), thresh, K.dropout_keep_scale(rate) if thresh else 1.0,
                             b, h, n, K._stream())
    if err:
        raise RuntimeError(f"ct_attn_tc_fwd: CUDA error {err}")
    return out, lse


def backward(lib, q, k, v, do, bias, kb, lse, seed, rate):
    """The backward with dbias for a dense bias, dkey_bias for a key bias,
    and dropout at `rate` > 0 from `seed`."""
    b, h, n, d = q.shape
    dev = q.device
    dq, dk, dv = (torch.empty((b, h, n, d), dtype=q.dtype, device=dev) for _ in range(3))
    rowsum = torch.empty((b, h, n), device=dev)
    ds = None if bias is None else torch.empty((b, h, n, n), device=dev)
    dbias = None if bias is None else torch.empty_like(bias)
    dkb_head = None if kb is None else torch.empty((b, h, n), device=dev)
    dkb = None if kb is None else torch.empty((b, n), device=dev)
    thresh = K.dropout_threshold(rate) if rate else 0
    err = lib.ct_attn_tc_bwd(_p(q), _p(k), _p(v), _p(do), _p(dq), _p(dk), _p(dv),
                             K._bhnd_strides(q, k, v, do, dq, dk, dv), _p(kb), _p(bias),
                             0 if bias is None else bias.shape[0], _p(lse), _p(rowsum), _p(ds),
                             _p(dbias), _p(dkb_head), _p(dkb), _p(seed), thresh,
                             K.dropout_keep_scale(rate) if thresh else 1.0, b, h, n,
                             K._stream())
    if err:
        raise RuntimeError(f"ct_attn_tc_bwd: CUDA error {err}")


def wrapper_ms(call) -> dict:
    """The Python wrapper's host time per call and the events around one
    call."""
    with torch.no_grad():
        return dict(host_ms=host_ms(call), events_ms=event_ms(call))


def in_turns(libs: dict, calls: dict, prefix: str, label: str, results: dict) -> None:
    """Time each copy's calls (`calls`: "fwd" | "bwd" -> lib -> closure)
    between CUDA events in turns, there and back, keeping the faster of the
    two, and each copy's kernels (torch.profiler)."""
    times = {name: {w: [] for w in calls} for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        for w, make in calls.items():
            times[name][w].append(event_ms(make(libs[name])))
    for name, lib in libs.items():
        row = dict(kernel_ms={})
        for w, make in calls.items():
            row[w + "_ms"] = min(times[name][w])
            row["kernel_ms"].update(kernel_ms(make(lib), prefix))
        results[f"{label} / {name}"] = row
        print(f"{label} / {name}: "
              + ", ".join(f"{w} {row[w + '_ms']:.4f} ms" for w in calls)
              + " (events, binding); kernels " + ", ".join(
                  f"{k} {t:.4f}" for k, t in row["kernel_ms"].items()) + " ms", flush=True)


def forward32(lib, q, k, v, bias, kb, seed, rate):
    """attention_tc32.cu's f32 forward: K7 with a dense bias, a key bias or
    none; K13a with dropout at `rate` > 0 from `seed`."""
    b, h, n, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), device=q.device)
    thresh = K.dropout_threshold(rate) if rate else 0
    err = lib.ct_attn_tc32_fwd(_p(q), _p(k), _p(v), _p(out), K._bhnd_strides(q, k, v, out),
                               _p(kb), _p(bias), 0 if bias is None else bias.shape[0], _p(lse),
                               _p(seed), thresh, K.dropout_keep_scale(rate) if thresh else 1.0,
                               b, h, n, K._stream())
    if err:
        raise RuntimeError(f"ct_attn_tc32_fwd: CUDA error {err}")
    return out, lse


def backward32(lib, q, k, v, out, do, bias, kb, lse, seed, rate):
    """attention_tc32.cu's f32 backward: dbias for a dense bias (K12b),
    dkey_bias for a key bias (K12a; K13b with dropout at `rate` > 0 from
    `seed`), neither without a bias."""
    b, h, n, d = q.shape
    dev = q.device
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    rowsum = torch.empty((b, h, n), device=dev)
    ds = None if bias is None else torch.empty((b, h, n, n), device=dev)
    dbias = None if bias is None else torch.empty_like(bias)
    dkb_head = None if kb is None else torch.empty((b, h, n), device=dev)
    dkb = None if kb is None else torch.empty((b, n), device=dev)
    thresh = K.dropout_threshold(rate) if rate else 0
    err = lib.ct_attn_tc32_bwd(_p(q), _p(k), _p(v), _p(out), _p(do), _p(dq), _p(dk), _p(dv),
                               K._bhnd_strides(q, k, v, out, do, dq, dk, dv), _p(kb), _p(bias),
                               0 if bias is None else bias.shape[0], _p(lse), _p(rowsum), _p(ds),
                               _p(dbias), _p(dkb_head), _p(dkb), _p(seed), thresh,
                               K.dropout_keep_scale(rate) if thresh else 1.0, b, h, n,
                               K._stream())
    if err:
        raise RuntimeError(f"ct_attn_tc32_bwd: CUDA error {err}")


def attention(dev, results: dict) -> None:
    """attention_tc.cu's and attention_tc32.cu's copies and wrappers."""
    from ct_clip_tpu_torch.ops.attention import fused_attention, fused_attention_kbias_dropout

    built = build_all({TC: COPIES, TC32: COPIES32})
    libs = built[TC]
    g = torch.Generator(device=dev).manual_seed(0)
    seed = torch.tensor([20261017], dtype=torch.int64, device=dev)
    # label -> (b, h, n, dense bias heads, pad lengths, forward?, backward?, dropout)
    shapes = {"key_bias (36, 12, 512, 64)": (36, 12, 512, 0, (5, 16), True, False, 0.0),
              "dense (8, 8, 1280, 64)": (8, 8, 1280, 8, None, True, True, 0.0),
              "no bias (8, 8, 1280, 64)": (8, 8, 1280, 0, None, True, True, 0.0),
              "K12a key_bias (8, 12, 512, 64)": (8, 12, 512, 0, (64, 513), True, True, 0.0),
              "K13a dropout (8, 12, 512, 64)": (8, 12, 512, 0, (64, 513), True, False, 0.1),
              "K13b dropout (8, 12, 512, 64)": (8, 12, 512, 0, (64, 513), False, True, 0.1)}
    for label, (b, h, n, bh, pads, do_fwd, do_bwd, rate) in shapes.items():
        q, k, v, do, bias, kb = inputs(dev, b, h, n, bh, pads, g)
        lse = forward(libs["as_built"], q, k, v, bias, kb, seed, rate)[1]
        calls = {}
        if do_fwd:
            calls["fwd"] = lambda lib: lambda: forward(lib, q, k, v, bias, kb, seed, rate)
        if do_bwd:
            calls["bwd"] = lambda lib: lambda: backward(lib, q, k, v, do, bias, kb, lse, seed,
                                                        rate)
        in_turns(libs, calls, "attn_tc_", label, results)
        if kb is not None and do_bwd:  # the Python wrapper of the key-bias backward
            call = lambda: K.attention_tc_bwd(  # noqa: E731
                q, k, v, do, lse, key_bias=kb, want_dkey_bias=True, seed=seed, rate=rate)
            wrapper = "kernels.attention_tc_bwd"
        elif rate:
            call = lambda: fused_attention_kbias_dropout(q, k, v, kb, seed, rate)  # noqa: E731
            wrapper = "fused_attention_kbias_dropout"
        else:
            b4 = None if bias is None else bias[None]
            call = lambda: fused_attention(q, k, v, b4, kb)  # noqa: E731
            wrapper = "fused_attention"
        results[f"{label} / {wrapper}"] = row = wrapper_ms(call)
        print(f"{label} / {wrapper}: host {row['host_ms']:.4f} ms per call, events around one "
              f"call {row['events_ms']:.4f} ms", flush=True)

    # the f32 forwards and backwards on attention_tc32.cu, the backward's out
    # and lse from the forward as built
    shapes32 = {"K12a f32 key_bias (32, 12, 512, 64)": (32, 12, 512, 0, (64, 513), 0.0),
                "K13b f32 dropout (32, 12, 512, 64)": (32, 12, 512, 0, (64, 513), 0.1),
                "K12b f32 dense (8, 8, 1280, 64)": (8, 8, 1280, 8, None, 0.0),
                "K12b f32 no bias (8, 8, 1280, 64)": (8, 8, 1280, 0, None, 0.0),
                "K12b f32 dense T5 (8, 12, 256, 64)": (8, 12, 256, 12, None, 0.0)}
    for label, (b, h, n, bh, pads, rate) in shapes32.items():
        q, k, v, do, bias, kb = inputs(dev, b, h, n, bh, pads, g, torch.float32)
        out, lse = forward32(built[TC32]["as_built"], q, k, v, bias, kb, seed, rate)
        in_turns(built[TC32], {
            "fwd": lambda lib: lambda: forward32(lib, q, k, v, bias, kb, seed, rate),
            "bwd": lambda lib: lambda: backward32(lib, q, k, v, out, do, bias, kb, lse, seed,
                                                  rate)}, "tc32_", label, results)
        wrapper = "fused_attention_kbias_dropout" if rate else "fused_attention"
        results[f"{label} / {wrapper}"] = row = wrapper_ms(
            (lambda: fused_attention_kbias_dropout(q, k, v, kb, seed, rate)) if rate else
            (lambda: fused_attention(q, k, v, None if bias is None else bias[None], kb)))
        print(f"{label} / {wrapper}: host {row['host_ms']:.4f} ms per call, events around one "
              f"call {row['events_ms']:.4f} ms", flush=True)
        results[f"{label} / kernels.attention_tc32_bwd"] = row = wrapper_ms(
            lambda: K.attention_tc32_bwd(q, k, v, out, do, lse, bias=bias,
                                         want_dbias=bias is not None, key_bias=kb,
                                         want_dkey_bias=kb is not None,
                                         seed=seed if rate else None, rate=rate))
        print(f"{label} / kernels.attention_tc32_bwd: host {row['host_ms']:.4f} ms per call, "
              f"events around one call {row['events_ms']:.4f} ms", flush=True)
        del q, k, v, do, bias, kb, out, lse
        torch.cuda.empty_cache()


def measure(fn, rounds: int = 5) -> dict:
    """Events, host time per call (the least of `rounds` of 50 calls; also
    with the card held busy, `host_held_ms`) and each kernel's device time
    per call with their sum ("total")."""
    with torch.no_grad():
        res = dict(events_ms=event_ms(fn), host_ms=host_ms(fn, rounds=rounds),
                   host_held_ms=host_ms(fn, rounds=rounds, hold=True),
                   kernel_ms=kernel_ms(fn))
    res["kernel_ms"]["total"] = sum(res["kernel_ms"].values())
    return res


def k17(dev, g) -> dict:
    from ct_clip_tpu_torch.ops.patch_embed import unrearrange_patches

    out = {}
    for label, (F, H, W, pt, p) in (("sampler", (200, 128, 128, 10, 16)),
                                    ("volume", (240, 480, 480, 10, 20))):
        t, h, w = F // pt, H // p, W // p
        rows = torch.randn((1, t * h * w, pt * p * p), generator=g, device=dev)
        row = dict(wrapper=measure(lambda: unrearrange_patches(rows, pt, p, F, H, W), 20),
                   contiguous=measure(lambda: rows.reshape(1, t, h, w, pt, p, p)
                                      .permute(0, 1, 4, 2, 5, 3, 6).contiguous(), 20),
                   empty_host_ms=host_ms(lambda: torch.empty((1, F, H, W), device=dev),
                                         rounds=20),
                   stream_host_ms=host_ms(K._stream, rounds=20))
        print(f"K17 f32 {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del rows
    return out


class CudaCores:
    """The QK-norm core's gate answering QK_CUDA_CORES inside the block: K9's
    core on qk_attention_bwd_kernel, K1's on attention.cu (in f32 with
    gemm.cu's FFMA products), the paths the tensor cores replaced."""

    def __enter__(self):
        self.gate = K.qk_bwd_tensor_cores
        K.qk_bwd_tensor_cores = lambda *a: getattr(K, "QK_CUDA_CORES", False)

    def __exit__(self, *exc):
        K.qk_bwd_tensor_cores = self.gate


def qk_routes() -> dict:
    """route -> context: as built, and where the tree has the gate, with it
    answering QK_CUDA_CORES."""
    routes = {"as_built": nullcontext}
    if hasattr(K, "qk_bwd_tensor_cores"):
        routes["cuda_cores"] = CudaCores
    return routes


class Replaced:
    """K2's forward on the path qknorm_attention_short.cu and the `wgmma`
    products replaced, inside the block: `kernels.qk_fwd_route` answering
    QK_CUDA_CORES (attention.cu; in f32 gemm.cu's FFMA products) and
    `proj_route` answering PROJ_WMMA (gemm.cu's bf16 products)."""

    def __enter__(self):
        from ct_clip_tpu_torch.ops import qknorm_attention as Q

        self.saved = K.qk_fwd_route, Q.proj_route
        K.qk_fwd_route = lambda *a, **kw: K.QK_CUDA_CORES
        Q.proj_route = lambda *a: Q.PROJ_WMMA

    def __exit__(self, *exc):
        from ct_clip_tpu_torch.ops import qknorm_attention as Q

        K.qk_fwd_route, Q.proj_route = self.saved


def k9(dev, g, dtype=torch.bfloat16) -> dict:
    from ct_clip_tpu_torch.ops.qknorm_attention import fused_spatial_qknorm_attention

    routes = qk_routes()
    heads, d, dim = 8, 32, 512
    hd = heads * d
    out = {}
    for label, (S, n) in (("ctclip", (192, 576)), ("autoencoder", (160, 64))):
        bf = dtype
        q, kv, dm = (torch.randn((S * n, wd), generator=g, device=dev).to(bf)
                     for wd in (hd, 2 * hd, hd))
        qs = (1 + 0.2 * torch.randn(d, generator=g, device=dev)) * 8.0
        ks = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
        bias = torch.randn((heads, n, n), generator=g, device=dev)
        layout = dict(sequences=S, inner=1, heads=heads, n=n, d=d,
                      q_strides=(n * hd, 0, d, hd), kv_strides=(n * 2 * hd, 0, d, 2 * hd),
                      q_scale=qs, k_scale=ks, bias=bias, group=-(-S // min(S, 33)), warps=8)
        x, do = (torch.randn((S, n, dim), generator=g, device=dev).to(bf) for _ in range(2))
        w = (1 + 0.1 * torch.randn(dim, generator=g, device=dev),
             torch.randn((hd, dim), generator=g, device=dev) * dim ** -0.5,
             torch.randn((2 * hd, dim), generator=g, device=dev) * dim ** -0.5, qs / 8,
             ks, torch.randn((dim, hd), generator=g, device=dev) * hd ** -0.5)
        leaves = [t.clone().requires_grad_() for t in (x, *w, bias)]
        y = fused_spatial_qknorm_attention(*leaves, heads, d)
        for route, ctx in routes.items():
            with ctx():
                core = measure(lambda: K.qk_attention_bwd(q, kv, dm, **layout))
                with torch.enable_grad():
                    whole = event_ms(lambda: torch.autograd.grad(y, leaves, do,
                                                                 retain_graph=True), 10)
            row = dict(core=core, sublayer_bwd_events_ms=whole)
            print(f"K9 {str(dtype)[6:]} {label} {route}: {json.dumps(row)}", flush=True)
            out[f"{label}/{route}"] = row
        del q, kv, dm, x, do, leaves, y
        torch.cuda.empty_cache()
    return out


def k1(dev, g, dtype=torch.bfloat16) -> dict:
    """K1 at three shapes on both routes, and its pieces (module doc)."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    routes = qk_routes()
    heads, d, dim = 8, 32, 512
    hd, f32 = heads * d, dtype == torch.float32

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    w = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5), rn(2 * hd, dim, scale=dim ** -0.5),
         1 + rn(d, scale=0.2), 1 + rn(d, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    out = {}
    for label, (S, n) in (("zero_shot", (48, 576)), ("contrastive", (192, 576)),
                          ("autoencoder", (160, 64))):
        x, bias = rn(S, n, dim).to(dtype), rn(heads, n, n)
        for route, ctx in routes.items():
            with ctx():
                row = measure(lambda: Q.fused_spatial_qknorm_attention(x, *w, bias, heads, d))
            print(f"K1 {str(dtype)[6:]} {label} {route}: {json.dumps(row)}", flush=True)
            out[f"{label}/{route}"] = row
        if hasattr(K, "qk_attention_fwd"):
            out[f"{label}/pieces"] = k1_pieces(x, w, bias, heads, d, f32)
            print(f"K1 {str(dtype)[6:]} {label} pieces: {json.dumps(out[f'{label}/pieces'])}",
                  flush=True)
        del x, bias
        torch.cuda.empty_cache()
    return out


def k1_pieces(x, w, bias, heads, d, f32) -> dict:
    """Each launch of K1's tensor-core route on its own, on the inputs of the
    call: events and each kernel's device time per call."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    S, n, dim = x.shape
    hd, x2 = heads * d, x.view(-1, dim)
    gamma, wq, wkv, qs, ks, wout = w
    layout = dict(sequences=S, inner=1, heads=heads, n=n, d=d, q_strides=(n * hd, 0, d, hd),
                  kv_strides=(n * 2 * hd, 0, d, 2 * hd), q_scale=qs * 8.0, k_scale=ks,
                  bias=bias)
    if f32:
        ws = Q._tc32_weights(wq, wkv, wout)
        xn = K.layernorm_split(x2, gamma, None, 1e-5)
        xs = K.tc32_split(x2)
        q, kv = K.tc32_gemm(*xn, *ws[0]), K.tc32_gemm(*xs, *ws[1])
        merged = K.qk_attention_fwd(q, kv, **layout)
        calls = dict(weights_split=lambda: Q._tc32_weights(wq, wkv, wout),
                     ln_split=lambda: K.layernorm_split(x2, gamma, None, 1e-5),
                     x_split=lambda: K.tc32_split(x2),
                     q_product=lambda: K.tc32_gemm(*xn, *ws[0]),
                     kv_product=lambda: K.tc32_gemm(*xs, *ws[1]),
                     core=lambda: K.qk_attention_fwd(q, kv, **layout),
                     out_product=lambda: K.tc32_gemm(*merged, *ws[2], residual=x2))
    else:
        wq_c, wkv_c, wo_c = (t.to(x.dtype).contiguous() for t in (wq, wkv, wout))
        xn, q, kv = Q._project(x2, gamma, wq, wkv, hd)
        merged, res = K.qk_attention_fwd(q, kv, **layout), torch.empty_like(x2)
        calls = dict(ln=lambda: K.layernorm(x2, gamma, None, 1e-5, torch.empty_like(x2)),
                     q_product=lambda: K.gemm(K.EPI_STORE, xn, wq_c, torch.empty_like(q)),
                     kv_product=lambda: K.gemm(K.EPI_STORE, x2, wkv_c, torch.empty_like(kv)),
                     core=lambda: K.qk_attention_fwd(q, kv, **layout),
                     out_product=lambda: K.gemm(K.EPI_RESIDUAL, merged, wo_c, res, residual=x2))
        if hasattr(K, "gemm_nt_tc"):  # the products on ffn_tc.cu's NT forms
            calls.update(q_product_nt=lambda: K.gemm_nt_tc(xn, wq_c),
                         kv_product_nt=lambda: K.gemm_nt_tc(x2, wkv_c),
                         out_product_nt=lambda: K.gemm_residual_tc(merged, wo_c, x2))
    with torch.no_grad():
        return {name: dict(events_ms=event_ms(fn), kernel_ms=kernel_ms(fn))
                for name, fn in calls.items()}


def k2(dev, g, dtype=torch.bfloat16) -> dict:
    """K2 at four shapes on both routes, and its pieces (module doc)."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    heads, d, dim = 8, 32, 512
    hd = heads * d

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    w = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5), rn(2 * hd, dim, scale=dim ** -0.5),
         1 + rn(d, scale=0.2), 1 + rn(d, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    short = hasattr(K, "qk_fwd_route")
    out = {}
    for label, shape in (("zero_shot", (2, 24, 576)), ("contrastive", (8, 24, 576)),
                         ("clip160", (4608, 16)), ("generatect", (512, 20))):
        grid = len(shape) == 3
        x = rn(*shape, dim).to(dtype)
        fused = Q.fused_grid_qknorm_attention if grid else Q.fused_small_qknorm_attention
        row = {"as_built": measure(lambda: fused(x, *w, heads, d))}
        if short:
            with Replaced():
                row["replaced"] = measure(lambda: fused(x, *w, heads, d))
            row["pieces"] = k2_pieces(x, w, heads, d, grid)
        print(f"K2 {str(dtype)[6:]} {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del x
        torch.cuda.empty_cache()
    return out


def k2_pieces(x, w, heads, d, grid) -> dict:
    """Each launch of K2's new route on its own, with the pieces it
    replaced, on the inputs of the call: events and each kernel's device time
    per call."""
    from ct_clip_tpu_torch.ops import qknorm_attention as Q

    dim = x.shape[-1]
    hd, x2 = heads * d, x.view(-1, dim)
    gamma, wq, wkv, qs, ks, wout = w
    sequences, inner, q_strides, kv_strides, n = Q._layout(x, hd, d, grid)
    layout = dict(sequences=sequences, inner=inner, heads=heads, n=n, d=d, q_strides=q_strides,
                  kv_strides=kv_strides, q_scale=qs * 8.0, k_scale=ks)
    if x.dtype == torch.float32:
        ws = Q._tc32_weights(wq, wkv, wout)
        xn = K.layernorm_split(x2, gamma, None, 1e-5)
        xs = K.tc32_split(x2)
        q, kv = K.tc32_gemm(*xn, *ws[0]), K.tc32_gemm(*xs, *ws[1])
        merged = K.qk_attention_short(q, kv, **layout)
        calls = dict(weights_split=lambda: Q._tc32_weights(wq, wkv, wout),
                     ln_split=lambda: K.layernorm_split(x2, gamma, None, 1e-5),
                     x_split=lambda: K.tc32_split(x2),
                     q_product=lambda: K.tc32_gemm(*xn, *ws[0]),
                     kv_product=lambda: K.tc32_gemm(*xs, *ws[1]),
                     core=lambda: K.qk_attention_short(q, kv, **layout),
                     out_product=lambda: K.tc32_gemm(*merged, *ws[2], residual=x2))
    else:
        wq_c, wkv_c, wo_c = (t.to(x.dtype).contiguous() for t in (wq, wkv, wout))
        xn, q, kv = Q._project(x2, gamma, wq, wkv, hd)
        merged = K.qk_attention_short(q, kv, **layout)
        calls = dict(ln=lambda: K.layernorm(x2, gamma, None, 1e-5, torch.empty_like(x2)),
                     q_product=lambda: K.gemm_nt_tc(xn, wq_c),
                     kv_product=lambda: K.gemm_nt_tc(x2, wkv_c),
                     core=lambda: K.qk_attention_short(q, kv, **layout),
                     out_product=lambda: K.gemm_residual_tc(merged, wo_c, x2),
                     q_product_gemm_cu=lambda: K.gemm(K.EPI_STORE, xn, wq_c, torch.empty_like(q)),
                     kv_product_gemm_cu=lambda: K.gemm(K.EPI_STORE, x2, wkv_c,
                                                       torch.empty_like(kv)),
                     out_product_gemm_cu=lambda: K.gemm(K.EPI_RESIDUAL, merged, wo_c,
                                                        torch.empty_like(x2), residual=x2))
    calls["core_attention_cu"] = lambda: K.attention(q, kv, kv[:, hd:], torch.empty_like(q),
                                                     **layout, warps=2)
    with torch.no_grad():
        return {name: dict(events_ms=event_ms(fn), kernel_ms=kernel_ms(fn))
                for name, fn in calls.items()}


def k11(dev, g) -> dict:
    """K11 in bf16 (autograd of `fused_geglu_ff`) at CT-CLIP's training
    rows (110,592 x 512, inner 1,365) and at MaskGIT's and the autoencoder's
    10,240: events, the device time of each kernel per call (the tile, the
    products, the LN backward, the split sums) and the host time per call."""
    from ct_clip_tpu_torch.ops.ffn import fused_geglu_ff

    dim, inner, out = 512, 1365, {}
    for label, rows in (("ctclip", 110592), ("maskgit_autoencoder", 10240)):
        def rn(*shape, scale=1.0):
            return torch.randn(shape, generator=g, device=dev) * scale
        x, do = rn(rows, dim).to(torch.bfloat16), rn(rows, dim).to(torch.bfloat16)
        w = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1), rn(2 * inner, dim, scale=dim ** -0.5),
             rn(dim, inner, scale=inner ** -0.5))
        leaves = [t.clone().requires_grad_() for t in (x, *w)]
        y = fused_geglu_ff(*leaves)
        with torch.enable_grad():
            fn = lambda: torch.autograd.grad(y, leaves, do, retain_graph=True)  # noqa: E731
            row = dict(events_ms=event_ms(fn, 10), host_ms=host_ms(fn, reps=10, rounds=3),
                       kernel_ms=kernel_ms(fn))
        row["kernel_ms"]["total"] = sum(row["kernel_ms"].values())
        print(f"K11 bf16 {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del x, do, w, leaves, y
        torch.cuda.empty_cache()
    return out


def k11_f32(dev, g) -> dict:
    """K11 in f32 (autograd of `fused_geglu_ff`) at CT-CLIP's training rows
    (110,592 x 512, inner 1,365) and at MaskGIT's and the autoencoder's
    10,240: events, host time and each kernel's device time per call (the
    3xTF32 tile and TN forms of ffn_tc32.cu's ff_tc32_bwd_kernel apart);
    where the tree has it, the same again on the path it replaced
    (`ops/ffn.py::_geglu_ff_bwd_products` on gemm.cu's FFMA forms,
    "replaced")."""
    from ct_clip_tpu_torch.ops import ffn

    dim, inner, out = 512, 1365, {}
    for label, rows in (("ctclip", 110592), ("maskgit_autoencoder", 10240)):
        def rn(*shape, scale=1.0):
            return torch.randn(shape, generator=g, device=dev) * scale
        x, do = rn(rows, dim), rn(rows, dim)
        w = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1), rn(2 * inner, dim, scale=dim ** -0.5),
             rn(dim, inner, scale=inner ** -0.5))
        leaves = [t.clone().requires_grad_() for t in (x, *w)]
        y = ffn.fused_geglu_ff(*leaves)
        row = _timed(lambda: torch.autograd.grad(y, leaves, do, retain_graph=True),
                     "ff_tc32_bwd_kernel")
        if hasattr(ffn, "_geglu_ff_bwd_products"):
            row["replaced"] = _timed(lambda: ffn._geglu_ff_bwd_products(
                x, *w, do, 1e-5, K.ff_bwd_core, K.gemm_nn, K.gemm_tn))
        print(f"K11 f32 {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del x, do, w, leaves, y
        torch.cuda.empty_cache()
    return out


def k10_f32(dev, g) -> dict:
    """K10 f32 (autograd of the sublayer) on CT-CLIP's (8, 24, 576, 512)
    grid, the 160-frame (4,608, 16, 512) and the autoencoder's (512, 20,
    512) sequences, and K9 f32 on (192, 576, 512) and (160, 64, 512) planes
    with a bias, 8 heads of 32: events, host time and each kernel's device
    time per call (ffn_tc32.cu's forms apart); where the tree has
    `kernels.qk_bwd_route`, the same again with it answering QK_CUDA_CORES
    (gemm.cu's FFMA products around the core qk_bwd_tensor_cores picks:
    the path the 3xTF32 products and the short core replaced,
    "replaced")."""
    from ct_clip_tpu_torch.ops.qknorm_attention import (fused_grid_qknorm_attention,
                                                        fused_small_qknorm_attention,
                                                        fused_spatial_qknorm_attention)

    dim, heads, dh, hd, out = 512, 8, 32, 256, {}

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    w = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5), rn(2 * hd, dim, scale=dim ** -0.5),
         1 + rn(dh, scale=0.2), 1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    cases = (("grid_8x24x576", (8, 24, 576, dim), None),
             ("seq_4608x16", (4608, 16, dim), None), ("seq_512x20", (512, 20, dim), None),
             ("k9_192x576", (192, 576, dim), 576), ("k9_160x64", (160, 64, dim), 64))
    for label, shape, bias_n in cases:
        x, do = rn(*shape), rn(*shape)
        extra = [rn(heads, bias_n, bias_n)] if bias_n else []
        leaves = [t.clone().requires_grad_() for t in (x, *w, *extra)]
        if bias_n:
            y = fused_spatial_qknorm_attention(*leaves, heads, dh)
        elif len(shape) == 4:
            y = fused_grid_qknorm_attention(*leaves, heads, dh)
        else:
            y = fused_small_qknorm_attention(*leaves, heads, dh)
        fn = lambda: torch.autograd.grad(y, leaves, do, retain_graph=True)  # noqa: E731
        row = _timed(fn, "ff_tc32_bwd_kernel")
        if hasattr(K, "qk_bwd_route"):
            route = K.qk_bwd_route
            K.qk_bwd_route = lambda *a, **k: K.QK_CUDA_CORES
            try:
                row["replaced"] = _timed(fn)
            finally:
                K.qk_bwd_route = route
        print(f"K10/K9 f32 {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del x, do, extra, leaves, y
        torch.cuda.empty_cache()
    return out


def _timed(fn, forms: str = "") -> dict:
    """Events, host time per call and each kernel's device time with their
    sum, of `fn` (under grad where it takes one); with `forms`, also the
    device time of each template form of the kernels whose name holds it."""
    with torch.enable_grad():
        row = dict(events_ms=event_ms(fn, 10), host_ms=host_ms(fn, reps=10, rounds=3),
                   kernel_ms=kernel_ms(fn))
        if forms:
            row[f"{forms}_ms"] = kernel_ms(fn, forms)
    row["kernel_ms"]["total"] = sum(row["kernel_ms"].values())
    return row


def k16a(dev, g) -> dict:
    """K16a at the aux steps' batch, and the path it replaced (module doc)."""
    import chip_smoke as cs
    from ct_clip_tpu_torch.ops.patch_embed import fused_patch_embed

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    dim, pd, b = 512, 4000, 8
    video = (torch.rand((b, 240, 480, 480), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    pe = [1 + rn(pd, scale=0.1), rn(pd, scale=0.1), rn(dim, pd, scale=pd ** -0.5),
          rn(dim, scale=0.1), 1 + rn(dim, scale=0.1), rn(dim, scale=0.1)]
    do = rn(b, 13824, dim).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in pe]
    with torch.enable_grad():
        out = fused_patch_embed(video, *leaves, 10, 20)
    res = {"k16a": _timed(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                          "ff_tc_gemm")}
    print(f"K16a: {json.dumps(res['k16a'])}", flush=True)
    if hasattr(cs, "k16a_replaced"):
        res["replaced"] = _timed(lambda: cs.k16a_replaced(video, pe, do))
        print(f"K16a replaced: {json.dumps(res['replaced'])}", flush=True)
    return res


def k3_f32(dev, g) -> dict:
    """K3 f32 at three row counts, and the path it replaced (module doc)."""
    from ct_clip_tpu_torch.ops import ffn

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    dim, inner, out = 512, 1365, {}
    w = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1), rn(2 * inner, dim, scale=dim ** -0.5),
         rn(dim, inner, scale=inner ** -0.5))
    for label, rows in (("maskgit", 10240), ("zero_shot", 27648), ("contrastive", 110592)):
        x = rn(rows, dim)
        with torch.no_grad():
            row = {"k3_f32": _timed(lambda: ffn.fused_geglu_ff(x, *w))}
            if hasattr(ffn, "_geglu_ff_gemm"):
                row["replaced"] = _timed(lambda: ffn._geglu_ff_gemm(x, *w, 1e-5))
        print(f"K3 f32 {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del x
        torch.cuda.empty_cache()
    return out


def k3(dev, g) -> dict:
    """K3 bf16 at three row counts, the path it replaced and each piece of
    the new route alone (module doc)."""
    from ct_clip_tpu_torch.ops import ffn

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    dim, inner, out = 512, 1365, {}
    w = (1 + rn(dim, scale=0.1), rn(dim, scale=0.1), rn(2 * inner, dim, scale=dim ** -0.5),
         rn(dim, inner, scale=inner ** -0.5))
    for label, rows in (("maskgit", 10240), ("zero_shot", 27648), ("contrastive", 110592)):
        x = rn(rows, dim).to(torch.bfloat16)
        with torch.no_grad():
            row = {"k3": _timed(lambda: ffn.fused_geglu_ff(x, *w))}
            if hasattr(ffn, "_geglu_ff_tc"):
                row["replaced"] = _timed(lambda: ffn._geglu_ff_gemm(x, *w, 1e-5))
                P = -(-inner // 8) * 8
                wcat = torch.zeros((2 * P, dim), dtype=x.dtype, device=dev)
                wcat[:inner], wcat[P:P + inner] = w[2][:inner], w[2][inner:]
                wo = torch.zeros((dim, P), dtype=x.dtype, device=dev)
                wo[:, :inner] = w[3]
                xn, act = torch.empty_like(x), torch.empty((rows, P), dtype=x.dtype, device=dev)
                lib, st = K.library(), K._stream
                pieces = {
                    "layernorm": lambda: K.layernorm(x, w[0], w[1], 1e-5, xn),
                    "geglu_product": lambda: lib.ct_ff_tc_geglu(
                        K._ptr(xn), dim, K._ptr(wcat), dim, rows, P, dim, K._ptr(act), P, st()),
                    "residual_product": lambda: lib.ct_ff_tc_residual(
                        K._ptr(act), P, K._ptr(wo), P, rows, dim, P, K._ptr(x), dim,
                        K._ptr(xn), dim, st())}
                row["pieces_kernel_ms"] = {k: kernel_ms(f) for k, f in pieces.items()}
        print(f"K3 bf16 {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del x
        torch.cuda.empty_cache()
    return out


def k5(dev, g) -> dict:
    """K5's inference assignment on bf16 and f32 rows, the path it replaced,
    its pieces and the L2-traffic variants (module doc)."""
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import vq_assign

    rows, dim, codes, out = 27648, 512, 8192, {}
    embed_n = l2norm(torch.randn((codes, dim), generator=g, device=dev))
    cb = embed_n.to(torch.bfloat16).contiguous()
    copy = None
    if hasattr(K, "vq_assign_tc"):
        copy = K.copy_library("vq_tc.cu", CT_VQ_TC_CWG=3)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((rows, dim), generator=g, device=dev).to(dtype)
        label = str(dtype).split(".")[-1]
        row = {"k5": _timed(lambda: vq_assign(x, embed_n))}
        if copy is not None:
            row["replaced"] = _timed(lambda: K.gemm_argmax(x, cb))
            xb = x if dtype == torch.bfloat16 else torch.empty((rows, dim), dtype=torch.bfloat16,
                                                                device=dev)
            if dtype == torch.float32:  # a tree whose pre-pass takes a lo output passes null
                lo = (None,) if len(K._signatures()["ct_vq_rows_bf16"]) == 6 else ()
                row["pre_pass_kernel_ms"] = kernel_ms(lambda: K.library().ct_vq_rows_bf16(
                    K._ptr(x), rows, dim, K._ptr(xb), *lo, K._stream()))
            variants = {"as_built": None, "rows192": copy}
            times = {name: [] for name in variants}
            for name in list(variants) + list(variants)[::-1]:
                times[name].append(event_ms(lambda: K.vq_assign_tc(xb, cb, lib=variants[name])))
            row["assignment_alone"] = {
                name: dict(events_ms=min(times[name]),
                           kernel_ms=kernel_ms(lambda: K.vq_assign_tc(xb, cb, lib=lib)),
                           ids_equal=bool(torch.equal(K.vq_assign_tc(xb, cb, lib=lib),
                                                      K.vq_assign_tc(xb, cb))))
                for name, lib in variants.items()}
        print(f"K5 {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del x
        torch.cuda.empty_cache()
    return out


def _replaced_bf16(fn):
    """`fn` on the path K10 bf16's short core and K9 / K10's products on
    ffn_tc.cu replaced: kernels.qk_bwd_route answering QK_CUDA_CORES, the NN
    and TN products on gemm.cu."""
    def run():
        saved = {name: getattr(K, name) for name in ("qk_bwd_route", "gemm_nn_tc", "gemm_tn_tc")
                 if hasattr(K, name)}
        if "qk_bwd_route" in saved:
            K.qk_bwd_route = lambda *a, **k: K.QK_CUDA_CORES
        if "gemm_nn_tc" in saved:
            K.gemm_nn_tc, K.gemm_tn_tc = K.gemm_nn, K.gemm_tn
        try:
            return fn()
        finally:
            for name, value in saved.items():
                setattr(K, name, value)
    return run


def k10(dev, g) -> dict:
    """K10 bf16 and K9 bf16 through autograd of the sublayer, and the path
    they replaced (module doc)."""
    from ct_clip_tpu_torch.ops.qknorm_attention import (fused_grid_qknorm_attention,
                                                        fused_small_qknorm_attention,
                                                        fused_spatial_qknorm_attention)

    dim, heads, dh, hd, out, bf = 512, 8, 32, 256, {}, torch.bfloat16

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    w = (1 + rn(dim, scale=0.1), rn(hd, dim, scale=dim ** -0.5), rn(2 * hd, dim, scale=dim ** -0.5),
         1 + rn(dh, scale=0.2), 1 + rn(dh, scale=0.2), rn(dim, hd, scale=hd ** -0.5))
    cases = (("grid_8x24x576", (8, 24, 576, dim), None),
             ("seq_4608x16", (4608, 16, dim), None), ("seq_512x20", (512, 20, dim), None),
             ("k9_192x576", (192, 576, dim), 576), ("k9_160x64", (160, 64, dim), 64))
    for label, shape, bias_n in cases:
        x, do = rn(*shape).to(bf), rn(*shape).to(bf)
        extra = [rn(heads, bias_n, bias_n)] if bias_n else []
        leaves = [t.clone().requires_grad_() for t in (x, *w, *extra)]
        if bias_n:
            y = fused_spatial_qknorm_attention(*leaves, heads, dh)
        elif len(shape) == 4:
            y = fused_grid_qknorm_attention(*leaves, heads, dh)
        else:
            y = fused_small_qknorm_attention(*leaves, heads, dh)
        fn = lambda: torch.autograd.grad(y, leaves, do, retain_graph=True)  # noqa: E731
        row = _timed(fn, "ff_tc_gemm")
        row["replaced"] = _timed(_replaced_bf16(fn), "ff_tc_gemm")
        print(f"K10/K9 bf16 {label}: {json.dumps(row)}", flush=True)
        out[label] = row
        del x, do, extra, leaves, y
        torch.cuda.empty_cache()
    return out


def k5_exact(dev, g) -> dict:
    """K5's exact assignment on bf16 and f32 rows and the path it replaced
    (module doc)."""
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import split_hi_lo, vq_assign

    dim, codes, out = 512, 8192, {}
    embed_n = l2norm(torch.randn((codes, dim), generator=g, device=dev))
    hi, lo = split_hi_lo(embed_n)
    for rows in (110592, 10240):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((rows, dim), generator=g, device=dev).to(dtype)
            label = f"{str(dtype).split('.')[-1]}_{rows}"
            row = dict(k5_exact=_timed(lambda: vq_assign(x, embed_n, exact=True)),
                       replaced=_timed(lambda: K.gemm_argmax(x, hi, lo)))
            print(f"K5 exact {label}: {json.dumps(row)}", flush=True)
            out[label] = row
            del x
            torch.cuda.empty_cache()
    return out


def k14(dev, g) -> dict:
    """The PEG forward and K14 through `peg_conv`, and cuDNN's calls beside
    them (module doc)."""
    import importlib.util

    from ct_clip_tpu_torch.ops.attention import peg_conv

    # this checkout's chip_smoke.py (a parent tree's predates cuDNN's yardstick)
    spec = importlib.util.spec_from_file_location("chip_smoke_k14", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = {}
    cases = (("ctclip", (8, 24, 24, 24), False, True),
             ("ctclip_rotated", (8, 24, 24, 24), True, True),
             ("zero_shot", (2, 24, 24, 24), False, True),
             ("autoencoder", (8, 20, 8, 8), False, True), ("maskgit", (8, 20, 8, 8), False, False))
    for dtype in (torch.bfloat16, torch.float32):
        for label, dims, rotated, causal in cases:
            x, do = (torch.randn((*dims, 512), generator=g, device=dev).to(dtype)
                     for _ in range(2))
            weight = torch.randn((512, 1, 3, 3, 3), generator=g, device=dev) * 0.2
            bias = torch.randn(512, generator=g, device=dev) * 0.1
            leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]

            def fwd():
                with torch.no_grad():
                    return peg_conv(x, weight, bias, rotated, causal)
            y = peg_conv(*leaves, rotated, causal)
            bwd = lambda: torch.autograd.grad(y, leaves, do, retain_graph=True)  # noqa: E731
            lib_fwd, lib_bwd = cs.cudnn_peg(x, do, weight, bias, rotated, causal)
            row = {}
            for name, fn in (("forward", fwd), ("k14", bwd), ("cudnn_forward", lib_fwd),
                             ("cudnn_backward", lib_bwd)):
                row[name] = _timed(fn)
                row[name]["launches_per_call"] = launches_per_call(fn)
            key = f"{str(dtype).split('.')[-1]}_{label}"
            print(f"K14 / PEG forward {key}: {json.dumps(row)}", flush=True)
            out[key] = row
            del x, do, leaves, y
            torch.cuda.empty_cache()
    return out


def embed(dev, g, volume: bool) -> dict:
    """K4 (`fused_row_embed` on patch rows) or K8 (`fused_patch_embed` on the
    volume) at zero-shot's batch, and the three passes of the path it ran
    before embed_tc.cu (module doc)."""
    import torch.nn.functional as F

    from ct_clip_tpu_torch.ops import patch_embed as pe_mod

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    dim, pd, b, eps, bf = 512, 4000, 2, 1e-5, torch.bfloat16
    video = (torch.rand((b, 240, 480, 480), generator=g, device=dev) * 2 - 1).to(bf)
    pe = [1 + rn(pd, scale=0.1), rn(pd, scale=0.1), rn(dim, pd, scale=pd ** -0.5),
          rn(dim, scale=0.1), 1 + rn(dim, scale=0.1), rn(dim, scale=0.1)]
    s1, b1, w, pbias, s2, b2 = pe
    rows = pe_mod.rearrange_plain(video, 10, 20)
    x = rows.view(-1, pd)
    wb, pb = w.to(bf).contiguous(), pbias.to(bf).contiguous()
    xn, y, out = torch.empty_like(x), torch.empty((x.shape[0], dim), dtype=bf, device=dev), \
        torch.empty((x.shape[0], dim), dtype=bf, device=dev)
    if volume:
        call = lambda: pe_mod.fused_patch_embed(video, *pe, 10, 20)  # noqa: E731
        ln1 = lambda: K.patch_layernorm(video, 10, 20, s1, b1, eps, xn)  # noqa: E731
    else:
        call = lambda: pe_mod.fused_row_embed(rows, *pe)  # noqa: E731
        ln1 = lambda: K.layernorm(x, s1, b1, eps, xn)  # noqa: E731
    pieces = {"ln_patch_dim": ln1,
              "product": lambda: K.gemm(K.EPI_BIAS_ROUNDED, xn, wb, y, bias=pb),
              "ln_dim": lambda: K.layernorm(y, s2, b2, eps, out)}

    def replaced():
        for f in pieces.values():
            f()
    ys = [t.to(bf) for t in (s1, b1, s2, b2)]

    def yardstick():
        h = F.layer_norm(x, (pd,), ys[0], ys[1], eps)
        return F.layer_norm(F.linear(h, wb, pb), (dim,), ys[2], ys[3], eps)
    key = "k8" if volume else "k4"
    with torch.no_grad():
        row = {key: _timed(call)}
        row[key]["launches_per_call"] = launches_per_call(call)
        row["replaced"] = _timed(replaced)
        row["replaced_pieces_kernel_ms"] = {k: kernel_ms(f) for k, f in pieces.items()}
        row["yardstick"] = _timed(yardstick)
        if "--copies" in sys.argv and hasattr(K, "embed_tc"):  # one-change copies
            geom = (10, 20) if volume else None
            src = video if volume else x
            for label, lib in build_all({EMBED: EMBED_COPIES})[EMBED].items():
                row[f"copy_{label}"] = _timed(
                    lambda: K.embed_tc(src, *pe, eps, geom=geom, lib=lib))
    print(f"{key}: {json.dumps(row)}", flush=True)
    return row


K15_CODES, K15_DIM = 8192, 512


AE_ROWS = ROOT / "build" / "k15_ae_rows.pt"  # kept for the later runs of a comparison


def ae_vq_rows(dev):
    """(rows, ids) the autoencoder's VQ takes its statistics of in its third
    generator step: `chip_smoke.ae_config()` at init seed 0, bf16, on
    `chip_smoke.write_volumes`' batch of AE_B volumes (the last call of
    `ops/vq.py::cluster_stats` in three steps, recorded), saved to AE_ROWS
    by the first run and read from there by the later ones, so that every
    tree of a comparison takes the same ids."""
    import tempfile

    if AE_ROWS.exists():
        x, ids = torch.load(AE_ROWS)
        return x.to(dev), ids.to(dev)

    import chip_smoke as cs
    import numpy as np
    from ct_clip_tpu_torch.data.generatect import VideoDataset
    from ct_clip_tpu_torch.models import CTViT
    from ct_clip_tpu_torch.ops import vq as vq_mod
    from ct_clip_tpu_torch.train import CTViTTrainer

    cfg, seen = cs.ae_config(), []
    stats = vq_mod.cluster_stats

    def recorded(x, ids, codes):
        seen[:] = [(x.clone(), ids.to(torch.int32).clone())]
        return stats(x, ids, codes)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as work:
        ds = VideoDataset(str(cs.write_volumes(Path(work) / "v", cs.AE_B, (128, 128, 201), 6)),
                          num_frames=cs.AE_FRAMES, image_size=cfg.image_size)
        video = torch.from_numpy(np.stack([ds[i] for i in range(len(ds))]))[..., None].to(dev)
        model = CTViT(cfg, dtype=torch.bfloat16, device=dev).init_weights(
            torch.Generator(device=dev).manual_seed(0))
        trainer = CTViTTrainer(model, results_folder=str(Path(work) / "r"),
                               save_model_every=10 ** 9, save_results_every=10 ** 9)
        vq_mod.cluster_stats = recorded
        try:
            for _ in range(3):
                trainer.train_step(video)
        finally:
            vq_mod.cluster_stats = stats
    del trainer, model, video
    torch.cuda.empty_cache()
    torch.save([t.cpu() for t in seen[0]], AE_ROWS)
    return seen[0]


def k15_ids(dist: str, rows: int, g, dev, ae_ids=None):
    """(rows,) int32 ids over K15_CODES codes: "uniform"; "ae", the
    autoencoder's ids repeated to `rows`; "half", half the rows (at random
    positions) in code 0 and the rest uniform."""
    ids = torch.randint(0, K15_CODES, (rows,), generator=g, device=dev, dtype=torch.int32)
    if dist == "ae":
        ids = ae_ids.repeat(-(-rows // ae_ids.numel()))[:rows].contiguous()
    elif dist == "half":
        ids[torch.randperm(rows, generator=g, device=dev)[: rows // 2]] = 0
    return ids


def k15(dev, g) -> dict:
    """K15 at two row counts, two row dtypes and three id distributions, and
    the path it replaced (module doc)."""
    import chip_smoke as cs
    from ct_clip_tpu_torch.ops.norms import l2norm
    from ct_clip_tpu_torch.ops.vq import cluster_stats

    ae_x, ae_ids = ae_vq_rows(dev)
    out = {"ae_ids": dict(rows=ae_ids.numel(), codes_used=int(ae_ids.unique().numel()),
                          fullest=int(torch.bincount(ae_ids, minlength=K15_CODES).max()))}
    print(f"K15 autoencoder ids: {json.dumps(out['ae_ids'])}", flush=True)
    for rows in (110592, 10240):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((rows, K15_DIM), generator=g, device=dev).to(dtype)
            if rows == ae_x.shape[0]:
                x = ae_x.to(dtype)  # the autoencoder's own rows at its own size
            for dist in ("uniform", "ae", "half"):
                ids = k15_ids(dist, rows, g, dev, ae_ids)

                def library():
                    e = torch.zeros((K15_CODES, K15_DIM), device=dev)
                    e.index_add_(0, ids.long(), l2norm(x.float()))
                    return torch.bincount(ids, minlength=K15_CODES), e
                call = lambda: cluster_stats(x, ids, K15_CODES)  # noqa: E731
                row = dict(fullest=int(torch.bincount(ids, minlength=K15_CODES).max()),
                           k15=_timed(call), library=_timed(library))
                row["k15"]["launches_per_call"] = launches_per_call(call)
                if hasattr(cs, "vq_stats_twin"):
                    row["replaced"] = _timed(lambda: cs.vq_stats_twin(x, ids, K15_CODES))
                label = f"{str(dtype).split('.')[-1]}_{rows}_{dist}"
                print(f"K15 {label}: {json.dumps(row)}", flush=True)
                out[label] = row
            del x
            torch.cuda.empty_cache()
    return out


def k16b(dev, g) -> dict:
    """K16b at the aux steps' batch, without and with d(rows), and the path
    it replaced (module doc)."""
    import chip_smoke as cs
    from ct_clip_tpu_torch.ops.patch_embed import fused_row_embed

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    dim, pd, b, bf = 512, 4000, 8, torch.bfloat16
    rows = (torch.rand((b, 13824, pd), generator=g, device=dev) * 2 - 1).to(bf)
    pe = [1 + rn(pd, scale=0.1), rn(pd, scale=0.1), rn(dim, pd, scale=pd ** -0.5),
          rn(dim, scale=0.1), 1 + rn(dim, scale=0.1), rn(dim, scale=0.1)]
    do = rn(b, 13824, dim).to(bf)
    res = {}
    for label, with_rows in (("k16b", False), ("k16b_drows", True)):
        leaves = [t.clone().requires_grad_() for t in ([rows] if with_rows else []) + pe]
        with torch.enable_grad():
            out = fused_row_embed(*(leaves if with_rows else [rows, *leaves]))
        call = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
        res[label] = _timed(call, "ff_tc_gemm")
        res[label]["launches_per_call"] = launches_per_call(call)
        print(f"{label}: {json.dumps(res[label])}", flush=True)
        if hasattr(cs, "k16b_replaced"):
            key = f"{label}_replaced"
            res[key] = _timed(lambda: cs.k16b_replaced(rows, pe, do, with_rows))
            print(f"{key}: {json.dumps(res[key])}", flush=True)
        del out, leaves
        torch.cuda.empty_cache()
    return res


# one-change copies of embed_tc.cu that compute garbage and only measure: no
# normalise (the raw rows multiplied), no products (every wgmma left out),
# neither (the copies, barriers and handshakes alone); and s1, b1 read from
# global memory (__ldg) in place of the stage's slot
EMBED = "embed_tc.cu"
_NO_NORM = (EMBED, "      *p = v;", "      if (kb < 0) *p = v;")
_NO_MMA = (EMBED, "for (int kk = 0; kk < 4; ++kk) mma256(", "for (int kk = 0; kk < 0; ++kk) mma256(")
EMBED_COPIES = {
    "as_built": [],
    "no_normalise": [_NO_NORM],
    "no_products": [_NO_MMA],
    "copies_only": [_NO_NORM, _NO_MMA],
    "sb_from_global": [(
        EMBED,
        "    const float4 sl = sb[0], sh = sb[1], bl = sb[TC_TILE / 4], bh = sb[TC_TILE / 4 + 1];",
        "    const float4* g = reinterpret_cast<const float4*>(a.s1 + kb * TC_TILE + 8 * c);\n"
        "    const float4* h = reinterpret_cast<const float4*>(a.b1 + kb * TC_TILE + 8 * c);\n"
        "    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n"
        "    const float4 sl = in_k ? __ldg(g) : z, sh = in_k ? __ldg(g + 1) : z,\n"
        "                 bl = in_k ? __ldg(h) : z, bh = in_k ? __ldg(h + 1) : z;")],
}


QK_TC = "qknorm_attention_tc.cu"
QK_COPIES = {
    "as_built": [],
    "stages3": [(QK_TC, "constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "no_loads": [(QK_TC, "    cp16(dst + r * 128 + ((c ^ (r & 7)) << 4), src, ok ? 16 : 0);",
                  "    if (t < -1) cp16(dst + r * 128 + ((c ^ (r & 7)) << 4), src, ok ? 16 : 0);"),
                 (WGMMA, "      cp16(dst + (r * ld + c) * 4",
                  "      if (i < -1) cp16(dst + (r * ld + c) * 4"),
                 (WGMMA, "    cp4(dst + e * 4, v", "    if (t < -1) cp4(dst + e * 4, v")],
    "no_products": [(WGMMA, '"wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D',
                     '"// " WG_D')],
}


QK32 = "qknorm_attention_tc32.cu"
QK32_COPIES = {
    "as_built": [],
    "hi_only": [(TC32H, "#define CT_TC32_PASSES 3", "#define CT_TC32_PASSES 1")],
    "no_products": COPIES32["no_products"],
    "no_loads": [(QK32, "    cp16(dst + (r * LDF + 4 * c) * 4,",
                  "    if (t < -1) cp16(dst + (r * LDF + 4 * c) * 4,"),
                 *QK_COPIES["no_loads"][1:]],
}


def k9_copies(dev, g, source: str = QK_TC, copies=None, dtype=torch.bfloat16) -> dict:
    """K9's core at (192, 576) with the bias on each copy of `copies` of
    `source` (QK_COPIES of qknorm_attention_tc.cu in bf16, QK32_COPIES of
    qknorm_attention_tc32.cu in f32), in turns."""
    libs = build_all({source: copies or QK_COPIES})[source]
    heads, d, S, n = 8, 32, 192, 576
    hd = heads * d
    q, kv, dm = (torch.randn((S * n, wd), generator=g, device=dev).to(dtype)
                 for wd in (hd, 2 * hd, hd))
    layout = dict(sequences=S, inner=1, heads=heads, n=n, d=d, q_strides=(n * hd, 0, d, hd),
                  kv_strides=(n * 2 * hd, 0, d, 2 * hd), bias=torch.randn((heads, n, n),
                  generator=g, device=dev), q_scale=torch.full((d,), 8.0, device=dev),
                  k_scale=torch.ones(d, device=dev))
    times = {name: [] for name in libs}
    for name in list(libs) + list(libs)[::-1]:
        times[name].append(event_ms(lambda: K.qk_attention_bwd(q, kv, dm, lib=libs[name],
                                                                **layout)))
    out = {}
    for name, lib in libs.items():
        out[name] = dict(events_ms=min(times[name]),
                         kernel_ms=kernel_ms(lambda: K.qk_attention_bwd(q, kv, dm, lib=lib,
                                                                        **layout)))
        print(f"K9 core copy {name}: {json.dumps(out[name])}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="attention",
                    choices=("attention", "k17", "k9", "k9_f32", "k11", "k16a", "k3_f32",
                             "k9_copies", "k9_f32_copies", "k1", "k1_f32", "k3", "k5", "k2",
                             "k2_f32", "k11_f32", "k10_f32", "k10", "k5_exact", "k14", "k4",
                             "k8", "k15", "k16b"))
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose package is timed (k17, k9, k9_f32, k11, k16a, "
                         "k3_f32, k1, k1_f32, k3, k5, k2, k2_f32, k11_f32, k10_f32, k10, "
                         "k5_exact, k14, k4, k8, k15, k16b)")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    ap.add_argument("--copies", action="store_true",
                    help="k4, k8: also one-change copies of embed_tc.cu (EMBED_COPIES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {"card": smi, "kernel": args.kernel}
    if args.kernel == "attention":
        attention(dev, results)
    else:
        K.library()
        g = torch.Generator(device=dev).manual_seed(15)
        results.update(tree=str(_tree()), library=K.library_path().name)
        results[args.kernel] = dict(
            k17=k17, k9=k9, k9_f32=lambda dev, g: k9(dev, g, torch.float32), k11=k11,
            k16a=k16a, k3_f32=k3_f32, k1=k1, k1_f32=lambda dev, g: k1(dev, g, torch.float32),
            k3=k3, k5=k5, k2=k2, k2_f32=lambda dev, g: k2(dev, g, torch.float32),
            k11_f32=k11_f32, k10_f32=k10_f32, k10=k10, k5_exact=k5_exact, k14=k14,
            k4=lambda dev, g: embed(dev, g, False), k8=lambda dev, g: embed(dev, g, True),
            k15=k15, k16b=k16b,
            k9_copies=k9_copies,
            k9_f32_copies=lambda dev, g: k9_copies(dev, g, QK32, QK32_COPIES, torch.float32),
            )[args.kernel](dev, g)
    print(json.dumps(results), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
