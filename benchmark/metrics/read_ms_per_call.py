"""``read_ms_per_call``: host milliseconds inside the program's
``respeeder.read`` spans (the codec's reads of the input file, with the
streamed tier's edge reflect and zero pad), over the traced calls."""

from benchmark.lib import spans


def read(run):
    return spans.ms_per_call(run, "respeeder.read")
