"""``copy_ms_per_call``: device time of the host-to-device and
device-to-host copies (the profiler's ``Memcpy HtoD`` and ``DtoH``
events) in the traced calls, over those calls."""


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    copies = t.copies()
    if not copies:
        return None
    return sum(e - s for _, s, e in copies) / 1e3 / t.calls
