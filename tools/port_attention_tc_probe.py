#!/usr/bin/env python3
"""What holds the port's tensor-core attention (csrc/attention_tc.cu, bf16,
and csrc/attention_tc32.cu, f32 in 3xTF32) back: time each kernel as built
against copies with one change each, on one card, in turns, on the same
inputs.

    PYTHONPATH=. python tools/port_attention_tc_probe.py [--out FILE.json]

Copies of attention_tc.cu (each its own nvcc build under
build/attention_tc_probe/<copy>/, beside its own common.cuh):
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
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ct_clip_tpu_torch.ops import kernels as K  # noqa: E402
from ct_clip_tpu_torch.ops.attention import (fused_attention,  # noqa: E402
                                             fused_attention_kbias_dropout)

CSRC = ROOT / "ct_clip_tpu_torch" / "csrc"
OUT = ROOT / "build" / "attention_tc_probe"
TC, TC32, COMMON = "attention_tc.cu", "attention_tc32.cu", "common.cuh"
# copy -> (source, old text, new text) substitutions
COPIES = {
    "as_built": [],
    "two_ctas": [(TC, "__launch_bounds__(NT, 3) attn_tc_forward",
                  "__launch_bounds__(NT, 2) attn_tc_forward")],
    "exp2f": [(TC, 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);")],
    "stages4": [(TC, "constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "no_loads": [(TC, "    cp16(dst + r * 128", "    if (t < -1) cp16(dst + r * 128"),
                 (TC, "      cp16(dst + (r * ld + c) * 4",
                  "      if (i < -1) cp16(dst + (r * ld + c) * 4")],
    "no_products": [(TC, '"wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D',
                     '"// " WG_D')],
    "no_philox": [(COMMON, "for (int r = 0; r < 10; ++r) {", "for (int r = 0; r < 0; ++r) {")],
}
COPIES32 = {
    "as_built": [],
    "hi_only": [(TC32, "#define CT_TC32_PASSES 3", "#define CT_TC32_PASSES 1")],
    "no_products": [(TC32, '"mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "',
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
            texts = {src: (CSRC / src).read_text() for src in (source, COMMON)}
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


def event_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, prefix: str = "attn_tc_", reps: int = 10) -> dict:
    """Device time per launch of each kernel whose name holds `prefix`
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # the name past `prefix` up to its parameter list: "rows<(Form)1, false>"
    return {e.key.split(prefix)[1].rsplit("(", 1)[0].rstrip("("):
            e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and prefix in e.key}


def host_ms(call) -> dict:
    """The Python wrapper's host time per call (50 calls, no sync between)
    and the events around one call."""
    with torch.no_grad():
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            call()
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        return dict(host_ms=host, events_ms=event_ms(call))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    results = {"card": smi}
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
        results[f"{label} / {wrapper}"] = row = host_ms(call)
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
        results[f"{label} / {wrapper}"] = row = host_ms(
            (lambda: fused_attention_kbias_dropout(q, k, v, kb, seed, rate)) if rate else
            (lambda: fused_attention(q, k, v, None if bias is None else bias[None], kb)))
        print(f"{label} / {wrapper}: host {row['host_ms']:.4f} ms per call, events around one "
              f"call {row['events_ms']:.4f} ms", flush=True)
        results[f"{label} / kernels.attention_tc32_bwd"] = row = host_ms(
            lambda: K.attention_tc32_bwd(q, k, v, out, do, lse, bias=bias,
                                         want_dbias=bias is not None, key_bias=kb,
                                         want_dkey_bias=kb is not None,
                                         seed=seed if rate else None, rate=rate))
        print(f"{label} / kernels.attention_tc32_bwd: host {row['host_ms']:.4f} ms per call, "
              f"events around one call {row['events_ms']:.4f} ms", flush=True)
        del q, k, v, do, bias, kb, out, lse
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
