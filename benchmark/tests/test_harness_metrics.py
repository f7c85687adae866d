"""Each metric reader on a synthetic profiler event list and run record."""

from types import SimpleNamespace

import pytest
from conftest import BENCH

from benchmark.lib import harness, work
from benchmark.lib import trace as tr
from benchmark.lib.peaks import peaks_for

K1 = "void sinc_banded_kernel<(Window)1, (Grids)0>(Args, int)"
H100 = peaks_for("NVIDIA H100 80GB HBM3")


def read(metric, run):
    return harness.load_module(BENCH, "metrics", metric).read(run)


def synthetic_trace(calls=2, work_items=None):
    """Two calls in a 10,000 us window: per call an upload (500 us), two
    small kernels, K1 (1,000 us), a memset and a download (2,000 us)."""
    device = []
    for c in range(calls):
        t = 100 + c * 5000
        device += [("Memcpy HtoD (Pageable -> Device)", t, t + 500),
                   ("void at::native::elementwise_kernel<128, 4>", t + 600, t + 700),
                   ("gemm_fp32", t + 650, t + 900),  # overlaps the one before
                   (K1, t + 1000, t + 2000),
                   ("Memset (Device)", t + 2000, t + 2010),
                   ("Memcpy DtoD (Device -> Device)", t + 2100, t + 2200),
                   ("Memcpy DtoH (Device -> Pageable)", t + 2500, t + 4500)]
    host = [("aten::copy_", 4550, 5080), ("aten::matmul", 4600, 4700),
            (tr.CALL_SPAN, 100, 4600)]
    return tr.Trace(device=device, host=host, window=(0, 10_000), calls=calls, syncs=14,
                    work=work_items or [{"inputs": 1000, "outputs": 2000}] * calls, nt=50,
                    peaks=H100)


def test_launches_count_kernels_only():
    assert read("launches_per_call", SimpleNamespace(trace=synthetic_trace())) == 3


def test_syncs_per_call():
    assert read("host_syncs_per_call", SimpleNamespace(trace=synthetic_trace())) == 7


def test_copy_ms_counts_host_copies_not_device_copies():
    got = read("copy_ms_per_call", SimpleNamespace(trace=synthetic_trace()))
    assert got == pytest.approx(2.5)


def test_idle_is_the_union_of_device_intervals():
    # per call busy: 500 + (600..900) 300 + 1000 + 10 + 100 + 2000 = 3910 us
    got = read("device_idle_pct", SimpleNamespace(trace=synthetic_trace()))
    assert got == pytest.approx(100 * (1 - 2 * 3910 / 10_000))


def test_sinc_roofline_counts_the_stage_work():
    t = synthetic_trace(work_items=[{"inputs": 10_000_000, "outputs": 20_000_000}] * 2)
    flops = 2 * 20_000_000 * 2 * 50 * 2
    nbytes = 4 * 2 * (10_000_000 + 20_000_000)
    least = max(flops / 67e12, nbytes / 3.35e12)
    got = read("sinc_roofline_pct", SimpleNamespace(trace=t))
    assert got == pytest.approx(100 * least / 2e-3)
    assert 0 < got <= 100


def test_readers_return_nothing_without_their_source():
    empty = tr.Trace(device=[], host=[], window=(0, 1000), calls=1)
    for metric in ("sinc_roofline_pct", "copy_ms_per_call", "device_idle_pct"):
        assert read(metric, SimpleNamespace(trace=empty)) is None
    for metric in ("launches_per_call", "host_syncs_per_call", "sinc_roofline_pct"):
        assert read(metric, SimpleNamespace(trace=None)) is None


def test_end_to_end_readers():
    run = SimpleNamespace(latencies=[0.01 * (i + 1) for i in range(100)], audio_s=3000.0,
                          window_s=50.5, setup_s=12.25, trace=None)
    assert read("x_realtime", run) == pytest.approx(3000 / 50.5)
    assert read("setup_s", run) == 12.25


def test_breakdown_names_gaps_by_the_open_host_operation():
    b = tr.breakdown(synthetic_trace())
    assert b["device_ops"][0][0].startswith("Memcpy DtoH")
    assert b["device_ops"][0][1] == pytest.approx(4000e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(500e-6)]
    assert b["idle_gaps"][1] == ["host (no operation)", pytest.approx(400e-6)]


def test_work_count_on_a_small_plan():
    """A constant speed of 1 gives every segment ``hop`` outputs; the work
    is 2 nt multiply-adds an output, the bytes each sample once."""
    import torch

    from benchmark.reference.restore import plan

    hop, frames, nt = 64, 33, 8
    pl = plan(torch.ones(frames), hop, int(hop * 1.1), 16)
    outputs = int(pl["n"].sum())
    assert outputs == hop * (frames - 1)
    assert work.sinc_flops(outputs, nt) == outputs * 2 * nt * 2
    assert work.sinc_bytes(hop * frames, outputs) == 4 * (hop * frames + outputs)
    assert torch.allclose(pl["base"], torch.arange(frames - 1, dtype=torch.float64) * hop)
