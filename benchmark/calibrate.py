"""Readings that the limits in ``benchmark/limits/`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seconds 3 --seeds 11 12 ...
        --control-seeds 11 12 13

For each of ``--seeds``, one run of the cell (set-up, a short window at the
cell's own load, the check) gives the program's readings of every number
the comparison gives: the lower reading is the largest of them.  For each
of ``--control-seeds``, each control of ``CONTROLS`` takes the program's
place: the cell's pipeline's plain reference computed with TF32 products
in the stages it names (its ``control``), judged against the reference in
float32 by the pipeline's comparison on each take of the pool's first
item: the upper reading is the smallest of them.  Prints one JSON line a
reading and a summary line last.  Runs on the card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# "tf32" is the control of the configurations' float32; "tf32_sinc" lowers
# the resample alone, the step that would tempt a faster sinc kernel
CONTROLS = {"tf32": ("track", "sinc"), "tf32_sinc": ("sinc",)}


def control_gaps(spec, name, seed, dev):
    """{control: the verdict of the pipeline's ``judge`` on each take of
    the first pool item}."""
    from benchmark.lib import harness

    c = harness.cell_files(harness.BENCH_DIR, spec, name)
    pipe = c.pipeline
    files = harness.files_dir(harness.BENCH_DIR, name)
    pool = pipe.make_pool(c.cfg, {**c.traffic, "pool": 1}, seed, dev, files)
    shutil.rmtree(files, ignore_errors=True)
    params = pipe.params(pool, c.cfg)
    gaps = {k: [] for k in CONTROLS}
    for take in c.entry.takes(pool[0]):
        ref = pipe.reference(take, params, dev)
        for k, stages in CONTROLS.items():
            gaps[k].append(pipe.judge(pipe.control(take, params, dev, stages), ref))
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import harness

    spec = harness.load_json(harness.BENCH_DIR.parent / "BENCHMARK.json")
    numbers = harness.cell_files(harness.BENCH_DIR, spec, args.workload).pipeline.NUMBERS
    dev = torch.device("cuda")
    program, control = [], {k: [] for k in CONTROLS}
    for seed in args.seeds:
        t = time.perf_counter()
        result, _, worst = harness.run_cell(args.workload, seed, args.seconds, False,
                                            t0=time.perf_counter(), spec=spec)
        program.append({k: worst[k] for k in numbers})
        print(json.dumps({"side": "program", "seed": seed, **program[-1],
                          "correct": result["correct"], "attempted": result["attempted"],
                          "s": time.perf_counter() - t}), flush=True)
    for seed in args.control_seeds:
        t = time.perf_counter()
        for k, verdicts in control_gaps(spec, args.workload, seed, dev).items():
            control[k].append({n: max(v[n] for v in verdicts) for n in numbers})
            print(json.dumps({"side": k, "seed": seed, **control[k][-1], "takes": verdicts,
                              "s": time.perf_counter() - t}), flush=True)
    summary = {"workload": args.workload, "total_s": time.perf_counter() - T0}
    for n in numbers:
        summary[n] = {"lower": max((r[n] for r in program), default=None),
                      "program": [r[n] for r in program]}
        for k, rows in control.items():
            summary[n][k] = min((r[n] for r in rows), default=None)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
