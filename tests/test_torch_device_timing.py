"""The port's ``utils/timing.py`` and ``utils/device.py`` helpers against
the JAX package's: ``log_duration``'s records and log lines, ``timed_log``'s
line and ``last_duration`` on the same fake clock; ``profile_trace`` writes
one Chrome trace (and nothing without a directory); ``device_kind`` reports
and ``best_device`` raises where torch sees no card."""

import itertools
import json
import logging
import time

import pytest
import torch

from pyaudiorestoration_tpu.utils import timing as tj
from pyaudiorestoration_tpu_torch.utils import device as dt
from pyaudiorestoration_tpu_torch.utils import timing as tt


def _run(timing, monkeypatch, caplog):
    """Two stages and a timed method on a clock that advances 0.25 s a read:
    (log records, the stages' last durations, an unknown stage's)."""
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: 0.25 * next(ticks))
    caplog.clear()
    with caplog.at_level(logging.DEBUG):
        with timing.log_duration("tracking"):
            time.perf_counter()  # the stage reads the clock once: 0.5 s
        with timing.log_duration("sinc"):
            pass
        with timing.timed_log("restore"):
            time.perf_counter()
    monkeypatch.undo()
    return ([(r.levelname, r.getMessage()) for r in caplog.records],
            timing.last_duration("tracking"), timing.last_duration("sinc"),
            timing.last_duration("never ran"))


def test_timing_matches_jax(monkeypatch, caplog):
    got = _run(tt, monkeypatch, caplog)
    want = _run(tj, monkeypatch, caplog)
    assert got == want
    assert got[0] == [("INFO", "tracking"), ("DEBUG", "tracking took 0.50 seconds"),
                      ("INFO", "sinc"), ("DEBUG", "sinc took 0.25 seconds"),
                      ("INFO", "restore 0.50s")]
    assert got[1:] == (0.5, 0.25, None)


def test_profile_trace_writes_one_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with dt.profile_trace(str(log_dir)):
        torch.ones(64).cumsum(0).sum()
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::cumsum" for e in events)


def test_profile_trace_without_a_directory_does_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with dt.profile_trace(None):
        torch.ones(4).sum()
    with dt.profile_trace(""):
        pass
    assert list(tmp_path.iterdir()) == []


def test_device_kind_reports_and_best_device_raises_without_a_card():
    """``device_kind`` says what torch sees; ``best_device`` is the card,
    and raises without one (JAX's falls back to the CPU; the port never
    does)."""
    assert dt.device_kind() == ("cuda" if torch.cuda.is_available() else "cpu")
    if torch.cuda.is_available():
        assert dt.best_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            dt.best_device()
