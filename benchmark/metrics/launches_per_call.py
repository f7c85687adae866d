"""``launches_per_call``: kernels that ran on the device in the traced
calls (the profiler's device events that are not copies or memsets), over
those calls."""


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    return len(t.kernels()) / t.calls
