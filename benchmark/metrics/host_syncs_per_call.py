"""``host_syncs_per_call``: host synchronizations in the traced calls, as
``torch.cuda.set_sync_debug_mode("warn")`` reports them (one warning each;
the output's download is one), over those calls."""


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    return t.syncs / t.calls
