"""Stage timers: ``log_duration``, ``timed_log`` and ``last_duration`` (the
JAX package's ``utils/timing.py``; ``log_duration`` times the port's
``resampling.run``) and ``Stages`` for the ``timings=`` dicts of the
pipeline entries."""

from __future__ import annotations

import contextlib
import logging
import time

import torch

_records: dict[str, float] = {}


@contextlib.contextmanager
def log_duration(operation: str):
    """Log ``operation`` at INFO on entry and its wall time at DEBUG on exit,
    and keep that time for :func:`last_duration`."""
    logging.info(operation)
    start = time.perf_counter()
    yield
    duration = time.perf_counter() - start
    _records[operation] = duration
    logging.debug(f"{operation} took {duration:.2f} seconds")


@contextlib.contextmanager
def timed_log(method_name: str):
    """Log ``method_name`` and its wall time at INFO on exit."""
    start = time.perf_counter()
    yield
    logging.info(f"{method_name} {time.perf_counter() - start:0.2f}s")


def last_duration(operation: str) -> float | None:
    """Most recent wall time recorded for a stage, in seconds."""
    return _records.get(operation)


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
