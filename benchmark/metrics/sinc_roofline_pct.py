"""``sinc_roofline_pct``: the sinc stage's least time on the card over its
device time in the traced calls, in percent.

Device time: the kernels whose names hold one of ``KERNELS``.
Least time: the larger of the stage's operations at the float32 peak and
its bytes at the memory bandwidth (``benchmark/lib/work.py``), counted
from the reference plan's real outputs of the traced calls' takes, so the
count is the resample's own work whatever kernel does it.  The peaks are
the card's published ones at 700 W; the run prints the card's power limit
beside them."""

from benchmark.lib import work

KERNELS = ("sinc_banded_kernel",)


def read(run):
    t = run.trace
    if t is None or not t.work or t.peaks is None:
        return None
    device_us = sum(e - s for name, s, e in t.kernels() if any(k in name for k in KERNELS))
    if device_us <= 0:
        return None
    outputs = sum(w["outputs"] for w in t.work)
    inputs = sum(w["inputs"] for w in t.work)
    least = work.least_seconds(work.sinc_flops(outputs, t.nt),
                               work.sinc_bytes(inputs, outputs), t.peaks)
    return 100.0 * least / (device_us / 1e6)
