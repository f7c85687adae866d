"""``uploads_per_call``: host arrays the program handed to the device, over
its entry calls, read from the program's counters in this process
(``respeeder.uploads`` over ``respeeder.calls``, both counted since the
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
    if not c.get("respeeder.calls") or "respeeder.uploads" not in c:
        return None
    return c["respeeder.uploads"] / c["respeeder.calls"]
