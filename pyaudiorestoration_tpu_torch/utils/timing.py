"""Stage timers: ``log_duration``, ``timed_log`` and ``last_duration`` (the
JAX package's ``utils/timing.py``; ``log_duration`` times the port's
``resampling.run``) and ``Stages`` for the ``timings=`` dicts of the
pipeline entries.

The program's spans and counters live here too.  :func:`span` names a
stretch of host work for ``torch.profiler``: while a profiler runs
(``utils.device.profile_trace``, the benchmark's traced runs, an
operator's own), it is a ``record_function`` range on the profiler's
clock, the clock of the device's kernels and copies; otherwise it costs
one flag check.  :func:`count` adds to a named integer, always on;
:func:`counters` reads them and :func:`reset_counters` zeroes them."""

from __future__ import annotations

import contextlib
import logging
import threading
import time

import torch

_records: dict[str, float] = {}
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()
_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a torch
    profiler runs, else a shared no-op context (a bare ``record_function``
    costs microseconds a call even with no profiler running)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter."""
    with _counts_lock:
        return dict(_counts)


def reset_counters(*names: str):
    """Set the counters ``names`` to 0, or every counter when none is named."""
    with _counts_lock:
        for name in names or list(_counts):
            _counts[name] = 0
