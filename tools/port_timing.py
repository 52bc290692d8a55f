"""Timers the port's probes share (tools/port_attention_tc_probe.py), so that
numbers from different kernels and commits are taken the same way:

    event_ms   the median of `reps` calls, each between two CUDA events;
    kernel_ms  the device time per call of each kernel a call launches
               (torch.profiler);
    host_ms    the host time per call: the least over `rounds` of `reps`
               calls (perf_counter, no sync between calls); with `hold`,
               each round queued behind a spin kernel, so that every call
               launches into a busy queue whatever its kernel's length;
    launches_per_call  the CUDA kernels a call launches (torch.profiler).
"""
from __future__ import annotations

import statistics
import time
from typing import Optional

import torch


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


def kernel_ms(fn, prefix: Optional[str] = None, reps: int = 10) -> dict:
    """Device time per call of each CUDA kernel `fn` launches.  With
    `prefix`, only the kernels whose name holds it, keyed by the name past it
    up to its parameter list ("rows<(Form)1, false>"); without, every kernel,
    keyed by its name cut at its template or parameter list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = e.key.replace("(anonymous namespace)::", "")
        if prefix is None:
            name = name.split("(")[0].split("<")[0].split(" ")[-1][:60]
        elif prefix in name:
            name = name.split(prefix)[1].rsplit("(", 1)[0].rstrip("(")
        else:
            continue
        out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
    return out


HOLD_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz: longer than 50 calls' host time


def host_ms(fn, reps: int = 50, rounds: int = 5, hold: bool = False) -> float:
    """Host time per call: the least over `rounds` of `reps` calls (the
    host clock of a shared machine drifts by a third within a run).  With
    `hold`, a spin kernel (`torch.cuda._sleep`) queued ahead of each round
    keeps the card busy, so that a kernel shorter than its own launch does
    not leave each call launching into an idle queue."""
    for _ in range(5):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e3)
    torch.cuda.synchronize()
    return best


def launches_per_call(fn, reps: int = 5) -> float:
    """CUDA kernels launched per call of `fn` (torch.profiler's device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / reps
