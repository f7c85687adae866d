"""``plan_ms_per_call``: host milliseconds inside the program's
``respeeder.plan`` spans (``_plan_from_speeds``: the clip, both split
cumsums and the segment advances), over the traced calls."""

from benchmark.lib import spans


def read(run):
    return spans.ms_per_call(run, "respeeder.plan")
