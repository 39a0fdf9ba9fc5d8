"""Timing and roofline helpers of the probe tools and chip_smoke.py.

On the card a time is CUDA events around many launches after a warm-up,
divided by their count (``cuda_ms``); the host returns before the device
finishes, so only the events see the device's time.  On the CPU the tools
take the host clock (``time_ms``), a time of PyTorch's CPU kernels and no
device metric.  The least time the card could take for a piece of work
(``bound``) is the larger of the bytes it must move (each input read
once, each output written once) over the memory rate and its operations
over the peak rate of their type, one H100 SXM's (NVIDIA's data sheet,
dense rates, at the full 700 W power limit).
"""
from __future__ import annotations

import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def power_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def where(device) -> str:
    """What a tool's times were taken on: the card and its power limit,
    or the CPU's host clock."""
    if device.type == "cuda":
        return f"{power_line()}, CUDA events"
    return "CPU, host clock (not a device time)"


def cuda_ms(fn, iters=20, warmup=3):
    """Device ms per call of ``fn``: events around ``iters`` calls after
    ``warmup`` calls and a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, iters=20, tries=3):
    """(device ms per call of ``fn``, {kernel name: device ms per call}),
    from the profiler's CUDA kernel records over ``iters`` calls after a
    warm-up call.  A profile counts only when it holds every call's
    records: each kernel's records a whole multiple of ``iters`` (a
    session can come back with none, or with some dropped, which would
    read as a shorter time); (None, {}) when ``tries`` profiles in a row
    fall short (the time is then not measured, never 0).  For a call so
    short that the wrapper's host cost sets the pace of back-to-back
    calls, :func:`cuda_ms` times that host cost and this the kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name, count = {}, {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                span = (e.time_range.end - e.time_range.start) / 1e3 / iters
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.split("(")[0].removeprefix("void ")
                by_name[name] = by_name.get(name, 0.0) + span
                count[name] = count.get(name, 0) + 1
        if by_name and all(c % iters == 0 for c in count.values()):
            return sum(by_name.values()), by_name
    return None, {}


def time_ms(fn, device, iters=20, warmup=3):
    """:func:`cuda_ms` on the card; on the CPU host ms per call."""
    if device.type == "cuda":
        return cuda_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def cost(moved, ops, peak, library=None):
    """What bounds a case: bytes it must move (each input read once, each
    output written once), operations of type ``peak``, and a thunk of one
    PyTorch call of the same function (a yardstick) or None."""
    return {"bytes": moved, "ops": ops, "peak": peak, "library": library}


def bound(c):
    """(least ms on the card, what bounds it) of a cost."""
    t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = c["ops"] / PEAK[c["peak"]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def utilization(flops, ms):
    """Share of the card's bf16 peak that ``flops`` in ``ms`` reach."""
    return flops / (ms * 1e-3) / PEAK["bf16"]


def device_rates(device, flops, ms, images):
    """The utilization and images per second of a timed call, or, for a
    host-clock time on the CPU, that they were not measured."""
    if device.type != "cuda":
        return "util not measured (CPU)"
    return (f"util {utilization(flops, ms) * 100:5.1f}% of bf16 peak   "
            f"{images / ms * 1e3:9.0f} img/s")
