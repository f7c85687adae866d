"""``x_realtime``: seconds of recorded audio in all calls of the window,
over the window's wall seconds (from the first call's hand-over to the
last call's output on the host)."""


def read(run):
    if not run.latencies:
        return None
    return run.audio_s / run.window_s
