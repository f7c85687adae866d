"""``tile_ms_per_call``: host milliseconds inside the program's
``respeeder.tile`` spans (each pass-2 tile of the streamed tier: the
transpose, the uploads, K1, the compaction and the download), over the
traced calls."""

from benchmark.lib import spans


def read(run):
    return spans.ms_per_call(run, "respeeder.tile")
