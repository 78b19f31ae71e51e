"""The readings that a cell's limits of `correct` are set from (PERF.md):
for each seed, one run of the cell with a short window, then the program's
numbers against the reference (the lower readings), the control's (the
reference computed in TF32, in the program's place) and each planted fault's
(the reference with the learning half's state left unchanged, with half of
each minibatch left out and the mean taken over the rest, with one env's
action altered where the policy makes it, with one env's reward and
observation altered where the env makes them, and with physics that returns
its state unchanged), all against the float32 reference.

    python benchmark/control.py --workload rodent-spa-wide --seeds 11 12 13 --seconds 5 --out FILE

Every seed runs in this one process, one after another; each prints a JSON
line and appends it to --out.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seed: int, seconds: float, device: str = "cuda", root: str = ROOT, overrides=None) -> dict:
    from benchmark import run

    result, _, notes = run.execute(root, workload, seed, seconds, False, device, time.perf_counter(), overrides,
                                   control=True)
    return {"workload": workload, "seed": seed, "correct": result["correct"], "device": result["device"],
            "metrics": result["metrics"], **result["readings"], "notes": notes}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    from benchmark.run import cache_dirs

    cache_dirs(ROOT)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in args.seeds:
        row = readings(args.workload, seed, args.seconds)
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
