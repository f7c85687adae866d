"""``track_ms_per_call``: host milliseconds inside the program's
``respeeder.track`` spans (``track_speed_device``: the reflect pad, every
tracking chunk with its window and DFT uploads, the GEMM, the peak
refinement and the centring), over the traced calls."""

from benchmark.lib import spans


def read(run):
    return spans.ms_per_call(run, "respeeder.track")
