"""Reduction of a ``torch.profiler`` run over a stretch of calls to what
the per-layer metric readers read: the device's events (kernels and
copies), the host's operations, the traced window, and the busy intervals
(the interval union of ``profile_stages.device_profile``)."""

from __future__ import annotations

from dataclasses import dataclass, field

WINDOW_SPAN = "benchmark.window"
CALL_SPAN = "benchmark.call"
SPANS = (WINDOW_SPAN, CALL_SPAN)


@dataclass
class Trace:
    """What one traced stretch gave.  Times are microseconds on the
    profiler's clock; ``device`` and ``host`` are (name, start, end)."""
    device: list
    host: list
    window: tuple
    calls: int
    syncs: int = 0
    work: list = field(default_factory=list)  # per call: {"inputs", "outputs"}
    nt: int = 0
    peaks: dict | None = None

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self):
        return [e for e in self.device if not is_copy(e[0]) and not is_memset(e[0])]

    def copies(self):
        return [e for e in self.device if is_copy(e[0]) and "DtoD" not in e[0]]


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def is_memset(name: str) -> bool:
    return name.startswith("Memset")


def union(intervals, lo: float, hi: float):
    """Sorted disjoint intervals covering ``intervals``, clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(trace: Trace) -> float:
    """Microseconds of the window in which a kernel or a copy ran."""
    return sum(e - s for s, e in union([(s, e) for _, s, e in trace.device], *trace.window))


def from_profiler(prof) -> tuple:
    """(device events, host events, window) of a finished profiler whose
    stretch ran inside one ``WINDOW_SPAN`` record_function."""
    import torch

    device, host, window = [], [], None
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # a record_function range is mirrored on the device's timeline
            # as a user annotation: it is no device work
            if not getattr(e, "is_user_annotation", False) and e.name not in SPANS:
                device.append((e.name, *rng))
        elif e.name == WINDOW_SPAN and window is None:
            window = rng
        else:
            host.append((e.name, *rng))
    return device, host, window


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the innermost host operation open at
    the gap's middle; seconds."""
    by = {}
    for name, s, e in trace.device:
        by[name] = by.get(name, 0.0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    busy = union([(s, e) for _, s, e in trace.device], *trace.window)
    edges = [trace.window[0]] + [x for iv in busy for x in iv] + [trace.window[1]]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        open_ = [h for h in trace.host if h[1] <= mid <= h[2] and h[0] != CALL_SPAN]
        name = max(open_, key=lambda h: h[1])[0] if open_ else "host (no operation)"
        named.append([name[:120], (e - s) / 1e6])
    return {"device_ops": [[name[:120], us / 1e6] for name, us in ops], "idle_gaps": named}
