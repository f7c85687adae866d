"""``device_idle_pct``: the share of the traced window in which no kernel
and no copy ran on the device (the interval union of the profiler's
device events), in percent."""

from benchmark.lib import trace as tr


def read(run):
    t = run.trace
    if t is None or t.window_us <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - tr.busy_us(t) / t.window_us)
