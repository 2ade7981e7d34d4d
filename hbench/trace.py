"""Reading a ``torch.profiler`` trace: device busy time, time by kernel name,
and the idle gaps named by what the host was doing.

The arithmetic is a frozen copy of ``chip_smoke.py::trace`` (the device's
busy and idle share over a traced stretch, the operations that hold the
device longest), with two changes: busy time is the union of the device
intervals, so operations that overlap (a copy on a side stream beside a
kernel) count once, and every gap between device operations is named by
the innermost host operation running at its middle.
"""
from __future__ import annotations

from collections import defaultdict

TOP = 10
NAME_CHARS = 160


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host: list[tuple[float, float, str]], points: list[float]) -> list[str]:
    """For each point (ascending), the name of the latest-starting host
    operation that covers it ("host idle" where none does). ``host`` holds
    one thread's operations, which nest."""
    ops = sorted(host, key=lambda h: (h[0], -h[1]))
    names, stack, j = [], [], 0
    for p in points:
        while j < len(ops) and ops[j][0] <= p:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        names.append(stack[-1][2] if stack else "host idle")
    return names


def summarize(device: list[tuple[float, float, str]],
              host: list[tuple[float, float, str]], wall_s: float) -> dict:
    """``device``: (start_us, end_us, name) of every device operation;
    ``host``: (start_us, end_us, name) of the host thread that drives the
    device; ``wall_s``: the traced stretch's length. Returns ``busy_s``,
    ``window_s``, ``by_name`` {name: [seconds, count]}, and the ``TOP``
    ``device_ops`` and ``idle_gaps`` as [name, seconds] lists."""
    merged = _merge([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in merged) / 1e6
    by_name: dict = defaultdict(lambda: [0.0, 0])
    for s, e, name in device:
        by_name[name][0] += (e - s) / 1e6
        by_name[name][1] += 1
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    idle: dict = defaultdict(float)
    for (_, length), name in zip(mids, _innermost(host, [m for m, _ in mids])):
        idle[name] += length / 1e6

    def top(items):
        ranked = sorted(items, key=lambda kv: -kv[1])[:TOP]
        return [[name[:NAME_CHARS], sec] for name, sec in ranked]

    return {"busy_s": busy_s, "window_s": wall_s, "by_name": dict(by_name),
            "device_ops": top((n, v[0]) for n, v in by_name.items()),
            "idle_gaps": top(idle.items())}


def kernel_seconds(summary: dict, names: tuple[str, ...]) -> float:
    """Device seconds of the operations whose name holds one of ``names``."""
    return sum(sec for op, (sec, _) in summary["by_name"].items()
               if any(n in op for n in names))


def from_profiler(prof, wall_s: float) -> dict:
    """:func:`summarize` over a finished ``torch.profiler.profile``: its
    CUDA events, and the host operations of the thread that issued most."""
    import torch

    device, host_by_thread = [], defaultdict(list)
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((tr.start, tr.end, e.name))
        else:
            host_by_thread[e.thread].append((tr.start, tr.end, e.name))
    host = max(host_by_thread.values(), key=len) if host_by_thread else []
    return summarize(device, host, wall_s)
