"""Stage timers: ``log_duration`` for the port's ``resampling.run`` (the JAX
package's ``utils/timing.log_duration``) and ``Stages`` for the ``timings=``
dicts of the pipeline entries."""

from __future__ import annotations

import contextlib
import logging
import time

import torch


@contextlib.contextmanager
def log_duration(operation: str):
    """Log ``operation`` at INFO on entry and its wall time at DEBUG on exit."""
    logging.info(operation)
    start = time.perf_counter()
    yield
    logging.debug(f"{operation} took {time.perf_counter() - start:.2f} seconds")


class Stages:
    """Adds the wall seconds since the last mark (or since it was made) to
    ``timings[name + "_s"]``; with ``timings`` None a mark does nothing.  On
    a CUDA device a mark synchronizes first, so each stage holds its own
    device work; the synchronization is paid only when timing."""

    def __init__(self, timings, device=None):
        self.timings = timings
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.last = time.perf_counter()

    def mark(self, name: str):
        if self.timings is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        key = name + "_s"
        self.timings[key] = self.timings.get(key, 0.0) + now - self.last
        self.last = now
