"""One run of one benchmark cell of the PyTorch and CUDA port.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. It builds the cell's configuration and traffic
from BENCHMARK.json, trains through the port's CLI entry (`train.main`) on
one card from the seed, measures `--seconds` of whole training steps after
the warm-up, checks what the timed path produced against the plain
reference under benchmark/reference/, and prints one JSON line last on
standard output: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (one control step profiled during the
warm-up). It exits with another code than 0, printing no result, where no
card is present, and where jax, jaxlib, flax or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()  # the start of set-up

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "track_mjx_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own library builds into build/torch_kernels/ beside it)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton_cache")
    os.environ["USE_FLAX"] = "0"


def execute(root: str, workload: str, seed: int, seconds: float, trace_on: bool, device: str, t0: float,
            overrides=None, control: bool = False) -> tuple:
    """Runs the cell; returns (result dict, checks {name: (value, limit)},
    notes for standard error). With `control` the result also holds, under
    "readings", the numbers of the control and of the planted faults
    (benchmark/control.py)."""
    import torch

    from benchmark.harness import cell as cell_lib
    from benchmark.harness import check, layers
    from benchmark.harness.manifest import Manifest

    manifest = Manifest(root)
    w = manifest.workload(workload)
    plan = cell_lib.make_plan(manifest.config_file(w["config"]), manifest.traffic(w["traffic"]), overrides)
    limits = check.load_limits(root, workload)
    notes = [f"workload {workload}: {plan.config_name}, num_envs {plan.num_envs}, "
             f"{plan.env_steps_per_step} env steps a training step"]
    with cell_lib.workdir() as wd:
        driven = cell_lib.drive(plan, seed, seconds, trace_on, t0, device, wd)
        rec = driven["recorder"]
        checked = check.run(rec, driven["config"], driven["clips_path"], seed, device, control=control)
        numbers = checked["program"]
        driven["solve_shapes"], driven["flops"] = checked["shapes"], checked["flops"]
    failed = check.failed(numbers, limits)
    correct = not failed
    notes.append(f"window: {rec.window.steps} training steps in {rec.window.span:.6f} s; setup {rec.setup_s:.6f} s")
    notes.append("kernel launches: " + json.dumps(driven["launches"]))
    device_info = {
        "platform": "gpu" if device.startswith("cuda") else "cpu",
        "kind": torch.cuda.get_device_name() if device.startswith("cuda") else "cpu",
        "count": 1,
        "memory_peak_bytes": int(driven["memory_peak_bytes"]),
    }
    if trace_on:
        run = layers.context(rec, driven, plan)
        metrics = {}
        for m in manifest.per_layer(workload):
            value = manifest.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        prof = rec.profile or {}
        device_info["busy_s"] = prof.get("busy_s", 0.0)
        device_info["window_s"] = prof.get("window_s", 0.0)
        if prof.get("kernels"):
            notes.append(f"profiled control step: {prof['kernels']} launches, host {1e6 * prof['window_s'] / prof['kernels']:.3f} us "
                         f"per launch, device busy {1e3 * prof['busy_s']:.3f} ms of {1e3 * prof['window_s']:.3f} ms")
    else:
        values = {"train_sps": rec.window.rate(plan.env_steps_per_step), "setup_s": rec.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in manifest.end_to_end(workload)}
    notes.append("not compared: " + json.dumps({**checked["notes"], **{n: numbers[n] for n in check.NAMES
                                                                         if limits[n] is None}}))
    result = {"correct": bool(correct), "attempted": len(check.compared(limits)), "failed": len(failed), "metrics": metrics,
              "device": device_info}
    if trace_on and rec.profile:
        result["breakdown"] = {"device_ops": [[n[:96], s] for n, s in rec.profile["device_ops"]],
                               "idle_gaps": rec.profile["idle_gaps"]}
    if control:
        result["readings"] = {k: checked[k] for k in ("program", "control", "faults")}
    checks = {n: (numbers[n], limits[n]) for n in check.compared(limits)}
    result["checks"] = {n: {"value": v, "limit": l} for n, (v, l) in checks.items()}
    return result, checks, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = next(w["chips"] for w in json.load(f)["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    result, checks, notes = execute(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 4
    for line in notes:
        print(line, file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
