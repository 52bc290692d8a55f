#!/usr/bin/env python3
"""What holds the port's tensor-core attention (csrc/attention_tc.cu, bf16,
and csrc/attention_tc32.cu, f32 in 3xTF32) back: time each kernel as built
against copies with one change each, on one card, in turns, on the same
inputs.

    python tools/port_attention_tc_probe.py [--kernel attention] [--out FILE.json]
    python tools/port_attention_tc_probe.py --kernel k17 | k9 | k9_f32 | k11 [--tree DIR]
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
from port_timing import event_ms, host_ms, kernel_ms

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
            texts = {src: (CSRC / src).read_text() for src in (source, COMMON, WGMMA, TC32H)}
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


def k9(dev, g, dtype=torch.bfloat16) -> dict:
    from ct_clip_tpu_torch.ops.qknorm_attention import fused_spatial_qknorm_attention

    class CudaCores:  # the core forced onto qk_attention_bwd_kernel
        def __enter__(self):
            self.gate = K.qk_bwd_tensor_cores
            K.qk_bwd_tensor_cores = lambda *a: getattr(K, "QK_CUDA_CORES", False)

        def __exit__(self, *exc):
            K.qk_bwd_tensor_cores = self.gate

    routes = {"as_built": nullcontext}
    if hasattr(K, "qk_bwd_tensor_cores"):
        routes["cuda_cores"] = CudaCores
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
                    choices=("attention", "k17", "k9", "k9_f32", "k11", "k9_copies",
                             "k9_f32_copies"))
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose package is timed (k17, k9, k9_f32, k11)")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
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
            k9_copies=k9_copies,
            k9_f32_copies=lambda dev, g: k9_copies(dev, g, QK32, QK32_COPIES, torch.float32),
            )[args.kernel](dev, g)
    print(json.dumps(results), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
