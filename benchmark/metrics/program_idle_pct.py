"""``program_idle_pct``: the share of the traced window in which no kernel
and no copy ran on the device while a ``respeeder.call`` span of the
program was open, in percent.  The rest of ``device_idle_pct`` is idle
while the host was outside the program (the download's staging, the
harness)."""

from benchmark.lib import spans
from benchmark.lib import trace as tr


def read(run):
    t = run.trace
    if t is None or t.window_us <= 0:
        return None
    calls = spans.intervals(t, "respeeder.call")
    if not calls:
        return None
    busy = tr.union([(s, e) for _, s, e in t.device], *t.window)
    open_us = sum(e - s for s, e in calls)
    return 100.0 * (open_us - spans.overlap_us(calls, busy)) / t.window_us
