"""``write_ms_per_call``: host milliseconds inside the program's
``respeeder.write`` spans (the output file written: the in-memory path's
``write_file``, the streamed tier's appends and its writer's close), over
the traced calls."""

from benchmark.lib import spans


def read(run):
    return spans.ms_per_call(run, "respeeder.write")
