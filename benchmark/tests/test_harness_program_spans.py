"""The readers of the program's own spans and counters: each on a synthetic
trace whose host events hold the program's spans and the runtime's launch
calls, each silent on a trace or a program without them (the parent
commit's), and a traced tiny cell on the CPU that reports them."""

import time
from types import SimpleNamespace

import pytest
from conftest import BENCH

from benchmark.lib import harness
from benchmark.lib import trace as tr
from pyaudiorestoration_tpu_torch.utils import timing

SPAN_READERS = ("track_ms_per_call", "plan_ms_per_call", "track_launches_per_call",
                "plan_launches_per_call", "program_idle_pct")


def read(metric, run):
    return harness.load_module(BENCH, "metrics", metric).read(run)


def synthetic_trace(calls=2, program_spans=True):
    """``calls`` calls in a 10,000 us window, 5,000 us apart.  A call's
    program spans: upload 0-500, track 550-1000, plan 1000-1800, sinc
    1800-2000 inside ``respeeder.call`` 0-2400; launch calls: 3 in the
    track, 3 in the plan, 1 in the sinc, 1 after the program; the device
    busy 990 us of the program's 2,400 and with the download after it."""
    device, host = [], []
    for c in range(calls):
        t = 100 + c * 5000
        device += [("Memcpy HtoD (Pageable -> Device)", t + 10, t + 500),
                   ("gemm_fp32", t + 650, t + 800),
                   ("void at::native::elementwise_kernel<128, 4>", t + 1250, t + 1350),
                   ("void sinc_banded_kernel<(Window)1, (Grids)0>(Args, int)",
                    t + 1950, t + 2200),
                   ("Memcpy DtoH (Device -> Pageable)", t + 2500, t + 4500)]
        host += [(tr.CALL_SPAN, t, t + 4600), ("aten::copy_", t + 5, t + 500),
                 ("cudaLaunchKernel", t + 600, t + 610), ("cudaLaunchKernel", t + 700, t + 710),
                 ("cuLaunchKernel", t + 900, t + 905),
                 ("cudaLaunchKernelExC", t + 1100, t + 1110),
                 ("cudaLaunchKernel", t + 1200, t + 1210), ("cudaLaunchKernel", t + 1300, t + 1310),
                 ("cudaMemcpyAsync", t + 1400, t + 1420),
                 ("cudaLaunchKernel", t + 1900, t + 1910),
                 ("cudaLaunchKernel", t + 2450, t + 2460)]
        if program_spans:
            host += [("respeeder.call", t, t + 2400), ("respeeder.upload", t, t + 500),
                     ("respeeder.track", t + 550, t + 1000),
                     ("respeeder.plan", t + 1000, t + 1800),
                     ("respeeder.sinc", t + 1800, t + 2000)]
    return tr.Trace(device=device, host=host, window=(0, 10_000), calls=calls)


@pytest.mark.parametrize("metric,want", [
    ("track_ms_per_call", 0.45), ("plan_ms_per_call", 0.8),
    ("track_launches_per_call", 3.0), ("plan_launches_per_call", 3.0),
    # per call: 2,400 us open, 490 + 150 + 100 + 250 of it busy
    ("program_idle_pct", 100 * 2 * (2400 - 990) / 10_000)])
def test_span_reader_on_a_synthetic_trace(metric, want):
    assert read(metric, SimpleNamespace(trace=synthetic_trace())) == pytest.approx(want)


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_span_reader_silent_without_the_spans(metric):
    assert read(metric, SimpleNamespace(trace=synthetic_trace(program_spans=False))) is None
    assert read(metric, SimpleNamespace(trace=None)) is None


def test_uploads_per_call_reads_the_program_counters(monkeypatch):
    monkeypatch.setattr(timing, "_counts", {})
    run = SimpleNamespace(trace=None)
    assert read("uploads_per_call", run) is None  # no call yet
    timing.count("respeeder.calls", 4)
    timing.count("respeeder.uploads", 28)
    assert read("uploads_per_call", run) == 7.0
    monkeypatch.delattr(timing, "counters")  # a program without counters
    assert read("uploads_per_call", run) is None


@pytest.mark.parametrize("cell,uploads", [("tiny.t3", 3.0), ("tiny.b3", 9.0)])
def test_traced_tiny_cell_reports_the_program_metrics(tiny_bench, cell, uploads):
    """One tracking chunk a take: the take (or batch) and each take's window
    and DFT matrix, plus the batch's inverse limbs and lengths."""
    bench, spec = tiny_bench
    timing.reset_counters()
    result, checks, _ = harness.run_cell(cell, 2 ** 31 + 4242, 0.5, True,
                                         t0=time.perf_counter(), bench_dir=bench,
                                         device="cpu", spec=spec)
    assert result["correct"], checks
    m = result["metrics"]
    for metric in ("track_ms_per_call", "plan_ms_per_call", "program_idle_pct"):
        assert m[metric]["value"] > 0
    assert m["uploads_per_call"] == {"value": uploads, "unit": "uploads/call"}
