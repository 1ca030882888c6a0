"""The traced run's reduction: torch.profiler's device events of the traced
steps to device-busy time, launch counts, kernel time by name and the
breakdown.

The arithmetic is a frozen copy of ``chip_smoke.py``'s ``profile_groups``,
``busy_us`` and ``profile_line`` (device-side events: kernels, copies and
sets; idle share = 1 - device busy / wall), with the busy time taken as
the union of the events' intervals, so that overlapping events count once.
One profiler session per process: on the card's machine a later session
in the same process has been seen to record no device work.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def profiled(device):
    """Profile the block: ``rec["device"]`` the device-side events, sorted
    by start, ``rec["host"]`` the host-side ones (None on a CPU run, which
    has no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import torch

    rec = {}
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        yield rec
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    events = list(prof.events())
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    rec["device"] = dev if device.type == "cuda" else None
    rec["host"] = [e for e in events if e.device_type == DeviceType.CPU]


def intervals(events):
    """The merged (start, end) microsecond intervals of ``events``."""
    out = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_us(events):
    """Microseconds in which at least one device event ran."""
    return sum(t - s for s, t in intervals(events))


def kernel_us(events, part):
    """The device durations (us) of the events whose name holds ``part``."""
    return [e.time_range.elapsed_us() for e in events if part in e.name]


def is_gemm(name):
    """A cuBLAS matrix-product kernel (the DCT's products)."""
    low = name.lower()
    return "gemm" in low or "xmma" in low


# a kernel's name in the breakdown: its first characters (PyTorch's
# template names run to a thousand)
NAME_CHARS = 120


def breakdown(device_events, host_events, top=10):
    """{"device_ops": the ``top`` device operations by total seconds,
    "idle_gaps": the ``top`` longest gaps between device events, each
    named by the innermost host operation running at its middle}."""
    totals = {}
    for e in device_events:
        totals[e.name] = totals.get(e.name, 0.0) + e.time_range.elapsed_us()
    ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    spans = intervals(device_events)
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1],
                    spans[i + 1][0]) for i in range(len(spans) - 1)),
                  reverse=True)[:top]
    host = sorted(host_events, key=lambda e: e.time_range.start)
    named = []
    for width, s, t in gaps:
        mid = 0.5 * (s + t)
        inner = [e for e in host
                 if e.time_range.start <= mid <= e.time_range.end]
        label = (min(inner, key=lambda e: e.time_range.elapsed_us()).name
                 if inner else "host Python between operations")
        named.append([label, width * 1e-6])
    return {"device_ops": [[n[:NAME_CHARS], us * 1e-6] for n, us in ops],
            "idle_gaps": named}
