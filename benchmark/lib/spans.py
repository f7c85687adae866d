"""The program's own spans in a traced stretch: the ``record_function``
ranges that ``pyaudiorestoration_tpu_torch.utils.timing.span`` opens while
a profiler runs, read from the trace's host events, and the host's CUDA
launch calls inside them.  Span names are written literally in the
readers; a trace of a program without spans gives them nothing."""

from __future__ import annotations

import bisect

from . import trace as tr

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def intervals(trace: tr.Trace, name: str) -> list:
    """Sorted disjoint (start, end) of the spans ``name``, clipped to the window."""
    return tr.union([(s, e) for n, s, e in trace.host if n == name], *trace.window)


def ms_per_call(run, name: str):
    """Summed host milliseconds of the spans ``name`` over the traced calls."""
    t = run.trace
    if t is None or not t.calls:
        return None
    spans = intervals(t, name)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / t.calls


def launches_per_call(run, name: str):
    """The host's CUDA launch calls that start inside a span ``name``, over
    the traced calls."""
    t = run.trace
    if t is None or not t.calls:
        return None
    spans = intervals(t, name)
    if not spans:
        return None
    starts = sorted(s for n, s, _ in t.host if n.startswith(LAUNCH_CALLS))
    inside = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
                 for s, e in spans)
    return inside / t.calls


def overlap_us(a: list, b: list) -> float:
    """Microseconds that two sorted disjoint interval lists share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
