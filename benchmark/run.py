"""The benchmark of ``pyaudiorestoration_tpu_torch`` on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is looked up in
``BENCHMARK.json`` and everything it names is found by name under
``benchmark/`` (``benchmark/lib/harness.py``).  The run sets up (imports,
the card, the kernel build or load, the pool of takes from the seed, warm
calls), measures a closed loop of calls for ``--seconds`` (with
``--trace 1`` a short stretch of calls under ``torch.profiler`` instead),
checks the answers against the plain reference, and prints one JSON line
last on stdout: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (and ``breakdown`` when traced), then ``checks``, each number
compared beside its limit; the same numbers end stderr.

It exits 2 with no result where torch sees no CUDA card or fewer than the
cell asks for, and 1 where the cell cannot run or a module of JAX or of
the JAX package is loaded.  Build and kernel caches stay inside the
checkout, under ``build/``.  The process runs torch's host operations on
one thread (``OMP_NUM_THREADS=1``, ``torch.set_num_threads(1)``): the
load on the host is this one thread and the CUDA driver's, whatever the
machine has, and no pool of idle workers spins beside the calls.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.lib import harness

    try:
        spec = harness.load_json(ROOT / "BENCHMARK.json")
        chips = [w["chips"] for w in spec["workloads"] if w["name"] == args.workload]
        if not chips:
            raise harness.CellError(f"no workload {args.workload!r} in BENCHMARK.json")
        import torch

        torch.set_num_threads(1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips[0]:
            harness.log(f"needs {chips[0]} CUDA card(s); torch sees "
                        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        import pyaudiorestoration_tpu_torch  # noqa: F401  (the program must be there)

        result, checks, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                                             bool(args.trace), t0=T0, spec=spec)
    except (harness.CellError, ImportError, OSError) as e:
        harness.log(f"cannot run: {e}")
        return 1
    found = harness.forbidden_modules()
    if found:
        harness.log(f"modules loaded that the benchmark must not load: {found}")
        return 1
    print(json.dumps(result), flush=True)
    for key, c in checks.items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
