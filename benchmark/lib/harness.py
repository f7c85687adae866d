"""One run of one cell: set-up, the measured window, the check of the
outputs against the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix, an entry or a
metric is found by name under ``benchmark/``:

    configs/<config>.json    the deployment's sizes and take recipe
    traffic/<traffic>.json   the entry, the pipeline, the take lengths, the
                             pool and calls
    entries/<entry>.py       ``prepare(params, dev, pool) -> call``, ``answers``
    pipelines/<name>.py      the traffic's ``"pipeline"``: ``make_pool``,
                             ``params``, ``reference``, ``judge`` over
                             ``NUMBERS``, ``work`` and ``control``
    metrics/<metric>.py      ``read(run) -> value or None``
    limits/<cell>.json       the limit of each number compared

A traffic file that names no pipeline takes ``pipelines/wow_flutter.py`` of
this benchmark: the wow/flutter takes as host arrays, judged as padded
grids against the fused entries' reference.  A pipeline that writes files
writes them under ``build/benchmark_files/<cell>/`` of the checkout, which
the run empties before its set-up and removes after its check.

The window is a closed loop: one call at a time, each starting when the
last one has handed back its output (in host memory, or in a file),
cycling through the pool.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import resource
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "pyaudiorestoration_tpu")
DEFAULT_PIPELINE = "wow_flutter"


class CellError(RuntimeError):
    """The cell cannot run: a file is missing or the card is not there."""


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"missing {path}")
    return json.loads(path.read_text())


def load_module(bench_dir: Path, kind: str, name: str):
    """The module ``<bench_dir>/<kind>/<name>.py``."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise CellError(f"missing {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench_dir: Path, spec: dict, name: str) -> SimpleNamespace:
    """The cell ``name`` of ``spec`` with its configuration, traffic,
    limits, entry and pipeline, each found by name."""
    cells = [w for w in spec["workloads"] if w["name"] == name]
    if not cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[0]
    cfg = load_json(bench_dir / "configs" / f"{cell['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{name}.json")
    entry = load_module(bench_dir, "entries", traffic["entry"])
    pipeline = (load_module(bench_dir, "pipelines", traffic["pipeline"]) if "pipeline" in traffic
                else load_module(BENCH_DIR, "pipelines", DEFAULT_PIPELINE))
    return SimpleNamespace(cell=cell, cfg=cfg, traffic=traffic, limits=limits, entry=entry,
                           pipeline=pipeline)


def files_dir(bench_dir: Path, name: str) -> Path:
    """The directory of the files that cell ``name``'s pipeline writes."""
    return bench_dir.parent / "build" / "benchmark_files" / name


def metrics_of(spec: dict, kind: str, name: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that cell ``name``
    reports."""
    return [m for m in spec[kind] if "workloads" not in m or name in m["workloads"]]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def host_load():
    """This process's (user CPU-s, system CPU-s, minor page faults,
    involuntary context switches), to tell a run that the host slowed
    from one that the device slowed."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime, ru.ru_minflt, ru.ru_nivcsw


def load_note(before, after, calls: int) -> str:
    """What this process did on the host over a window, from two
    :func:`host_load`, a call."""
    user, system, faults, switches = (b - a for a, b in zip(before, after))
    n = max(calls, 1)
    return (f"host a call: {1e3 * user / n:.1f} ms user + {1e3 * system / n:.1f} ms system "
            f"CPU, {faults / n:.0f} minor page faults, {switches / n:.2f} involuntary "
            f"switches ({calls} calls)")


def power_limit_w():
    """The card's power limit in watts from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()
        return float(out[0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def _traced_calls(call, pool, n_calls: int, keep, cuda: bool):
    """``n_calls`` calls under the profiler and the sync debug mode; returns
    (latencies, failures, trace pieces, items called)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as tr

    lat, failed, items = [], 0, []
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=activities) as prof:
            with record_function(tr.WINDOW_SPAN):
                if cuda:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    for i in range(n_calls):
                        item = i % len(pool)
                        t = time.perf_counter()
                        try:
                            with record_function(tr.CALL_SPAN):
                                out = call(pool[item])
                        except Exception as e:  # a failed call is counted, not fatal
                            failed += 1
                            log(f"call {i} failed: {e!r}")
                            continue
                        lat.append(time.perf_counter() - t)
                        items.append(item)
                        keep(i, item, out)
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode("default")
                sync()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    device, host, window = tr.from_profiler(prof)
    return lat, failed, (device, host, window, syncs), items


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t0: float,
             bench_dir: Path = BENCH_DIR, device: str = "cuda", spec: dict | None = None):
    """One run of cell ``name``; returns (result dict, compared numbers
    with their limits, the largest reading of every number of the
    pipeline's ``judge`` over the answers).  ``t0``: ``time.perf_counter()``
    at the process's start."""
    import torch

    from . import trace as tr
    from .peaks import peaks_for

    spec = spec or load_json(bench_dir.parent / "BENCHMARK.json")
    c = cell_files(bench_dir, spec, name)
    pipe = c.pipeline
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    files = files_dir(bench_dir, name)
    shutil.rmtree(files, ignore_errors=True)

    pool = pipe.make_pool(c.cfg, c.traffic, seed, dev, files)
    params = pipe.params(pool, c.cfg)
    call = c.entry.prepare(params, dev, pool)
    for i in range(c.traffic["warm_calls"]):
        call(pool[i % len(pool)])
    if cuda:  # the allocator keeps its blocks: no cudaMalloc in the window
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    log(f"{name}: set-up {setup_s:.3f} s (seed {seed}, f0 {params['f0']:.2f} Hz, "
        f"band {params['band']}, pool {len(pool)})")

    rng = random.Random(seed)
    kept, seen = {}, {}

    def keep(i, item, out):  # one answer of each pool item, drawn from the seed
        seen[item] = seen.get(item, 0) + 1
        if rng.randrange(seen[item]) == 0:
            kept[item] = out

    load0 = host_load()
    if trace:
        lat, failed, pieces, traced_items = _traced_calls(
            call, pool, c.traffic["trace_calls"], keep, cuda)
        window_s = (pieces[2][1] - pieces[2][0]) / 1e6
    else:
        lat, failed = [], 0
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds or i < len(pool):  # each item once
            item = i % len(pool)
            t = time.perf_counter()
            try:
                out = call(pool[item])
            except Exception as e:  # a failed call is counted, not fatal
                failed += 1
                log(f"call {i} failed: {e!r}")
            else:
                lat.append(time.perf_counter() - t)
                keep(i, item, out)
            i += 1
        window_s = time.perf_counter() - start
    attempted = len(lat) + failed
    load_msg = load_note(load0, host_load(), attempted)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the check: every kept answer against the plain reference of its take
    refs = {}

    def reference(item):
        if item not in refs:
            refs[item] = [pipe.reference(take, params, dev) for take in c.entry.takes(pool[item])]
        return refs[item]

    worst, diag = {}, []
    for item, out in sorted(kept.items()):
        answers = c.entry.answers(pool[item], out, params)
        for j, (ref, answer) in enumerate(zip(reference(item), answers)):
            verdict = pipe.judge(answer, ref)
            for k in pipe.NUMBERS:
                worst[k] = max(worst.get(k, 0.0), verdict[k])
            diag.append({"item": item, "take": j, **verdict})
    del kept
    shutil.rmtree(files, ignore_errors=True)
    for d in diag:
        log(f"{name}: answer {d}")
    q = statistics.quantiles(lat, n=10) if len(lat) > 1 else lat * 9
    log(f"{name}: {attempted} calls, window {window_s:.3f} s, latency p10/p50/p90 "
        f"{q[0] * 1e3:.2f}/{q[4] * 1e3:.2f}/{q[8] * 1e3:.2f} ms, device peak {peak} B, "
        f"host peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B")
    log(f"{name}: {load_msg}")
    checks = {k: {"value": worst.get(k, float("inf")), "limit": limit}
              for k, limit in c.limits.items()}
    correct = bool(failed == 0 and attempted > 0 and diag
                   and all(v["value"] <= v["limit"] for v in checks.values()))

    run = SimpleNamespace(latencies=lat, audio_s=len(lat) * pool[0]["audio_s"],
                          window_s=window_s, setup_s=setup_s, trace=None)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    limit_w = power_limit_w() if cuda else None
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1 if cuda else 0, "memory_peak_bytes": int(peak),
                   "power_limit_w": limit_w}
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        device_ev, host_ev, window, syncs = pieces
        work = []
        for item in traced_items:
            takes = [pipe.work(r) for r in reference(item)]
            work.append({k: sum(w[k] for w in takes) for k in ("inputs", "outputs")})
        run.trace = tr.Trace(device=device_ev, host=host_ev, window=window,
                             calls=len(lat), syncs=syncs, work=work, nt=params["nt"],
                             peaks=peaks_for(kind))
        metrics = _read(metrics_of(spec, "per_layer", name), run, bench_dir)
        device_info["busy_s"] = tr.busy_us(run.trace) / 1e6
        device_info["window_s"] = window_s
        result.update(metrics=metrics, device=device_info, breakdown=tr.breakdown(run.trace))
        log(f"{name}: power limit {limit_w} W; peaks {run.trace.peaks}")
    else:
        result.update(metrics=_read(metrics_of(spec, "end_to_end", name), run, bench_dir),
                      device=device_info)
    result["checks"] = checks
    return result, checks, worst


def _read(metrics: list, run, bench_dir: Path) -> dict:
    out = {}
    for m in metrics:
        value = load_module(bench_dir, "metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
