"""``tiles_per_call``: pass-2 tiles of the program's streamed tier, over its
calls, read from the program's counters in this process
(``respeeder.tiles`` over ``respeeder.streamed``, both counted since the
process started: every call of a cell does the same work, so the ratio
over the warm and traced calls is a call's count)."""


def read(run):
    try:
        from pyaudiorestoration_tpu_torch.utils import timing
    except ImportError:
        return None
    counters = getattr(timing, "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("respeeder.streamed") or "respeeder.tiles" not in c:
        return None
    return c["respeeder.tiles"] / c["respeeder.streamed"]
