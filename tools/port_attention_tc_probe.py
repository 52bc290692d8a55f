#!/usr/bin/env python3
"""What holds the port's tensor-core attention (csrc/attention_tc.cu) back:
time the kernel as built against copies with one change each, on one card,
in turns, on the same inputs.

    PYTHONPATH=. python tools/port_attention_tc_probe.py [--out FILE.json]

Copies (each its own nvcc build under build/attention_tc_probe/):
  as_built     the source unchanged;
  two_ctas     the forward at two CTAs per SM (launch bounds 2, not 3);
  exp2f        libm's exp2f in place of one ex2.approx;
  stages4      a ring of four stages, not two;
  no_loads     the producer copies nothing (stale tiles): the time without
               global loads;
  no_products  every wgmma left out (garbage results): the time without the
               tensor cores.
The last two compute garbage and only measure.  Shapes: the zero-shot
prompts' key-bias form (36, 12, 512, 64) and MaskGIT's dense and no-bias
forms at (8, 8, 1280, 64), bf16, forward and (the latter two) backward.
For each copy and shape: the median of 20 calls between CUDA events (the
binding called directly), the kernels' own device times from torch.profiler,
and, for the copy as built, the host time per `fused_attention` call (the
Python wrapper) against the events around one call.
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
from ct_clip_tpu_torch.ops.attention import fused_attention  # noqa: E402

SRC = ROOT / "ct_clip_tpu_torch" / "csrc" / "attention_tc.cu"
OUT = ROOT / "build" / "attention_tc_probe"
COPIES = {
    "as_built": [],
    "two_ctas": [("__launch_bounds__(NT, 3) attn_tc_forward",
                  "__launch_bounds__(NT, 2) attn_tc_forward")],
    "exp2f": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = exp2f(x);")],
    "stages4": [("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "no_loads": [("    cp16(dst + r * 128", "    if (t < -1) cp16(dst + r * 128"),
                 ("      cp16(dst + (r * ld + c) * 4",
                  "      if (i < -1) cp16(dst + (r * ld + c) * 4")],
    "no_products": [('"wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D',
                     '"// " WG_D')],
}
FWD_ARGS = ("p", "p", "p", "p", "lp", "p", "p", "i", "p", "i", "i", "i", "p")
BWD_ARGS = ("p", "p", "p", "p", "p", "p", "p", "lp", "p", "i", "p", "p", "p", "p",
            "i", "i", "i", "p")


def build_all() -> dict:
    """Compile every copy at once; name -> loaded library."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, procs = SRC.read_text(), {}
    for name, subs in COPIES.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {SRC.name}")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-I", str(SRC.parent),
             "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "lp": ctypes.POINTER(ctypes.c_longlong)}
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{err[-4000:]}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.ct_attn_tc_fwd.argtypes = [types[t] for t in FWD_ARGS]
        lib.ct_attn_tc_bwd.argtypes = [types[t] for t in BWD_ARGS]
        libs[name] = lib
    return libs


def inputs(dev, b, h, n, bias_heads, key_bias, g):
    q, k, v, do = (torch.randn((b, n, h, 64), generator=g, device=dev).to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(4))
    bias = torch.randn((bias_heads, n, n), generator=g, device=dev) if bias_heads else None
    kb = None
    if key_bias:  # prompt-length pads
        lengths = torch.randint(5, 16, (b,), generator=g, device=dev)
        kb = (torch.arange(n, device=dev)[None] >= lengths[:, None]).float() \
            * torch.finfo(torch.float32).min
    return q * 0.125, k, v, do, bias, kb


def _p(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def forward(lib, q, k, v, bias, kb):
    b, h, n, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), device=q.device)
    err = lib.ct_attn_tc_fwd(_p(q), _p(k), _p(v), _p(out), K._bhnd_strides(q, k, v, out),
                             _p(kb), _p(bias), 0 if bias is None else bias.shape[0], _p(lse),
                             b, h, n, K._stream())
    if err:
        raise RuntimeError(f"ct_attn_tc_fwd: CUDA error {err}")
    return out, lse


def backward(lib, q, k, v, do, bias, lse):
    b, h, n, d = q.shape
    dq, dk, dv = (torch.empty((b, h, n, d), dtype=q.dtype, device=q.device) for _ in range(3))
    rowsum = torch.empty((b, h, n), device=q.device)
    ds = None if bias is None else torch.empty((b, h, n, n), device=q.device)
    dbias = None if bias is None else torch.empty_like(bias)
    err = lib.ct_attn_tc_bwd(_p(q), _p(k), _p(v), _p(do), _p(dq), _p(dk), _p(dv),
                             K._bhnd_strides(q, k, v, do, dq, dk, dv), _p(bias),
                             0 if bias is None else bias.shape[0], _p(lse), _p(rowsum), _p(ds),
                             _p(dbias), b, h, n, K._stream())
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


def kernel_ms(fn, reps: int = 10) -> dict:
    """Device time per launch of each attn_tc_ kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("attn_tc_")[1].split("(")[0]: e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "attn_tc_" in e.key}


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
    libs = build_all()
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = {"key_bias (36, 12, 512, 64)": (36, 12, 512, 0, True),
              "dense (8, 8, 1280, 64)": (8, 8, 1280, 8, False),
              "no bias (8, 8, 1280, 64)": (8, 8, 1280, 0, False)}
    results = {"card": smi}
    for label, shape in shapes.items():
        q, k, v, do, bias, kb = inputs(dev, *shape, g)
        lse = forward(libs["as_built"], q, k, v, bias, kb)[1]
        grad = kb is None

        def fwd(lib):
            return lambda: forward(lib, q, k, v, bias, kb)

        def bwd(lib):
            return lambda: backward(lib, q, k, v, do, bias, lse)
        times = {name: {"fwd": [], "bwd": []} for name in libs}
        for name in list(libs) + list(libs)[::-1]:  # in turns, there and back
            times[name]["fwd"].append(event_ms(fwd(libs[name])))
            if grad:
                times[name]["bwd"].append(event_ms(bwd(libs[name])))
        for name, lib in libs.items():
            row = dict(fwd_ms=min(times[name]["fwd"]), kernel_ms=kernel_ms(fwd(lib)))
            if grad:
                row.update(bwd_ms=min(times[name]["bwd"]))
                row["kernel_ms"].update(kernel_ms(bwd(lib)))
            results[f"{label} / {name}"] = row
            print(f"{label} / {name}: forward {row['fwd_ms']:.4f} ms"
                  + (f", backward {row['bwd_ms']:.4f} ms" if grad else "")
                  + " (events, binding); kernels " + ", ".join(
                      f"{k} {t:.4f}" for k, t in row["kernel_ms"].items()) + " ms", flush=True)
        b4 = None if bias is None else bias[None]
        with torch.no_grad():
            call = lambda: fused_attention(q, k, v, b4, kb)  # noqa: E731
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                call()
            host = (time.perf_counter() - t0) / 50 * 1e3
            torch.cuda.synchronize()
            around = event_ms(call)
        results[f"{label} / fused_attention"] = dict(host_ms=host, events_ms=around)
        print(f"{label} / fused_attention: host {host:.4f} ms per call, events around one "
              f"call {around:.4f} ms", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
