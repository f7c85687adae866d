"""Stage timer of the port's ``resampling.run`` (the JAX package's
``utils/timing.log_duration``)."""

from __future__ import annotations

import contextlib
import logging
import time


@contextlib.contextmanager
def log_duration(operation: str):
    """Log ``operation`` at INFO on entry and its wall time at DEBUG on exit."""
    logging.info(operation)
    start = time.perf_counter()
    yield
    logging.debug(f"{operation} took {time.perf_counter() - start:.2f} seconds")
