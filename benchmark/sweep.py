"""The sweep that sets a cell's env count: each configuration at a few env
counts, each point a set-up and two whole training steps, one process a
point, on one card.

    python benchmark/sweep.py --workload rodent-spa-wide --envs 16384 32768 65536 --out FILE

For each point it prints (and writes to --out as JSON lines) train_sps over
the two steps, the rollout's and the learning half's ms, the profiled
control step's launches and device idle share, the window's peak memory and
the set-up seconds. The rule (PERF.md): a cell runs at the smallest swept
count from which doubling the envs raises train_sps by less than a quarter.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def point(workload: str, envs: int, seed: int) -> dict:
    import torch

    from benchmark.harness import cell as cell_lib
    from benchmark.harness.manifest import Manifest
    from benchmark.run import cache_dirs

    cache_dirs(ROOT)
    manifest = Manifest(ROOT)
    w = manifest.workload(workload)
    cfg_file = manifest.config_file(w["config"])
    tc = cfg_file["config"]["train_setup"]["train_config"]
    overrides = {"train_setup.train_config.num_envs": envs,
                 "train_setup.train_config.batch_size": envs // int(tc["num_minibatches"])}
    plan = cell_lib.make_plan(cfg_file, manifest.traffic(w["traffic"]), overrides)
    with cell_lib.workdir() as wd:
        driven = cell_lib.drive(plan, seed, 1.0, True, T0, "cuda", wd)
    rec = driven["recorder"]
    prof = rec.profile or {}
    return {
        "workload": workload, "num_envs": envs,
        "train_sps": rec.window.rate(plan.env_steps_per_step), "window_steps": rec.window.steps,
        "window_s": rec.window.span, "setup_s": rec.setup_s, **rec.phase_ms(),
        "launches_per_control_step": prof.get("kernels"),
        "idle_pct": 100 * (1 - prof["busy_s"] / prof["window_s"]) if prof.get("window_s") else None,
        "control_step_ms": 1e3 * prof.get("window_s", 0.0), "device_busy_ms": 1e3 * prof.get("busy_s", 0.0),
        "peak_mem_gib_window": (rec.memory_peak_window or 0) / 2**30,
        "peak_mem_gib_run": driven["memory_peak_bytes"] / 2**30,
        "kernel_launches": driven["launches"], "card": torch.cuda.get_device_name(),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--envs", type=int, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 12345)
    ap.add_argument("--out", required=True)
    ap.add_argument("--point", action="store_true", help="run one point in this process")
    ap.add_argument("--timeout", type=int, default=900)
    args = ap.parse_args()
    if args.point:
        print(json.dumps(point(args.workload[0], args.envs[0], args.seed)), flush=True)
        return 0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for workload in args.workload:
        for envs in args.envs:
            cmd = [sys.executable, os.path.abspath(__file__), "--point", "--workload", workload, "--envs", str(envs),
                   "--seed", str(args.seed), "--out", args.out]
            t = time.perf_counter()
            try:
                p = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
                lines = p.stdout.strip().splitlines()
                row = json.loads(lines[-1]) if p.returncode == 0 and lines else {
                    "workload": workload, "num_envs": envs, "error": p.stderr[-1500:]}
            except subprocess.TimeoutExpired:
                row = {"workload": workload, "num_envs": envs, "error": f"timeout after {args.timeout} s"}
            row["process_s"] = time.perf_counter() - t
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
