"""The torch port's CUDA kernels of this tree against those of another
checkout (the parent), on one card, on the same inputs.

Usage (from the repository root, on a machine with a CUDA device and nvcc):

    python3 tools/compare_torch_kernels.py --parent DIR [--reps 20]
        [--rounds 2] [--out FILE]

DIR is a checkout of another commit (for example unpacked with `git
archive`). Both trees' csrc/ are built, each by its own ops/kernel_lib.py
(the parent's afresh into build/compare_parent/ of this tree, so that
ptxas reports its registers), and this tree's once more with
CG_SOLVE_STAMPS (phase stamps); all builds run at once. The inputs come
from this tree's port: 4096 contact-rich rodent states from chip_smoke.py's
generator (seed 0), 4096 drawn as tests/torch_parity.py's
contact_rich_states draws them (numpy seed 29), 4096 fly states and the
Newton path's matrices. Then, calling each library's C entry points
directly:

- cg_solve (K2): each build's error against the plain version per output
  (relative to max(1, max |plain|), as chip_smoke.py) and whether its
  outputs equal the parent's bit for bit, on both state sets; each build's
  and the float32 plain version's error against the plain version in
  float64 (how far each float32 solve is from the exact one); its time at
  iterations / ls_iterations 0/0, 1/0, 1/5 and 5/5 (the differences split
  an env's time into set-up, a CG iteration and the linesearch), and the
  cycles per env of each phase from the stamps build; registers,
  shared memory and resident CTAs per SM (this tree's from
  cg_solve_kernel_info; the parent's from its ptxas registers and shared
  memory by Hopper's occupancy limits), and the waves of 4096 envs;
- ell_cg_solve (K3), cholesky (K4a), cho_solve (K4b), solve_spd (K4c):
  whether this tree's outputs equal the parent's bit for bit, and both
  times.

Times are CUDA-event ms per launch over `--reps` launches, the builds taken
in turn, `--rounds` times (parent, this tree; then reversed). It
prints one JSON object as its last line and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import math
import os
import re
import shutil
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]  # chip_smoke.py, torch_parity.py

import chip_smoke  # noqa: E402
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk  # noqa: E402
from track_mjx_tpu_torch.ops import kernel_lib  # noqa: E402

OUTS = ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint", "qacc_eff")
CONFIGS = ((0, 0), (1, 0), (1, 5), (5, 5))  # (iterations, ls_iterations) of K2
# Hopper (sm_90) occupancy limits per SM: registers, their allocation unit
# per warp, threads, CTAs, shared memory a kernel may use and the part the
# system reserves per CTA.
SM_REGS, REG_UNIT, SM_THREADS, SM_CTAS, SM_SMEM, CTA_RESERVED = 65536, 256, 2048, 32, 233472, 1024
PARENT_THREADS = 256  # the first design's threads per CTA
# cg_solve.cu's phase stamps, in order (a CG iteration's summed over its
# iterations)
PHASES = (
    "load", "limit rows, qM", "jfr", "L = M, limit lists", "factor qM", "panel inverses",
    "smooth solve | J warm", "M dx, J smooth", "warm-start choice, force", "J^T: grad",
    "solve: mgrad", "it: M p, J p", "it: p M p, linesearch", "it: x, jar, force", "it: J^T",
    "it: solve", "it: beta, p", "J^T qfrc, M + hD, outputs", "Euler factor",
    "Euler inverses, solve",
)
STAMPS = len(PHASES)


def _load_kernel_lib(root: str, name: str):
    path = os.path.join(root, "track_mjx_tpu_torch", "ops", "kernel_lib.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas_registers(log: str, kernel: str) -> int:
    """Registers of the entry function whose name holds `kernel` (and not a
    longer name ending in it), from nvcc's -Xptxas -v output."""
    lines = log.splitlines()
    for k, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m and re.search(rf"\d{kernel}E", m.group(1)):
            for later in lines[k + 1 : k + 4]:
                r = re.search(r"Used (\d+) registers", later)
                if r:
                    return int(r.group(1))
    raise RuntimeError(f"no ptxas register count for {kernel}")


def ctas_per_sm(regs: int, threads: int, smem: int) -> int:
    warps = threads // 32
    by_regs = SM_REGS // (warps * math.ceil(regs * 32 / REG_UNIT) * REG_UNIT)
    return min(by_regs, SM_THREADS // threads, SM_CTAS, SM_SMEM // (smem + CTA_RESERVED))


def call_cg(lib, op: str, a: dict, its: int, ls: int) -> tk.CGOut:
    """One launch of `{op}_f32` from `lib` on the inputs `a` (cg_solve's
    keyword arguments, tk._ARG_NAMES order)."""
    args = [a[k] for k in tk._ARG_NAMES]
    bsz, n = a["qfrc_smooth"].shape
    nl, nc = a["lim1h"].shape[0], a["fq"].shape[1]
    e = a["aref"].shape[1]
    out = tk.CGOut(*(torch.empty(bsz, m, device="cuda") for m in (n, n, e, n, n)))
    err = getattr(lib, f"{op}_f32")(
        *[t.data_ptr() for t in args], out.qacc_smooth.data_ptr(), out.qacc.data_ptr(),
        out.qfrc_constraint.data_ptr(), out.qacc_eff.data_ptr(), out.efc_force.data_ptr(),
        bsz, n, nl, nc, its, ls, torch.cuda.current_stream().cuda_stream,
    )
    assert err == 0, f"{op}_f32 failed with cudaError {err}"
    return out


def call_linalg(lib, op: str, args: tuple) -> torch.Tensor:
    out = torch.empty_like(args[0] if op == "cholesky" else args[1])
    bsz, n = args[0].shape[0], args[0].shape[-1]
    err = getattr(lib, f"{op}_f32")(*[t.data_ptr() for t in args], out.data_ptr(), bsz, n,
                                     torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"{op}_f32 failed with cudaError {err}"
    return out


def timed(fns: dict, reps: int, rounds: int) -> dict:
    """CUDA-event ms per call of each fn, the fns taken in turn, forwards
    then backwards, `rounds` times; every reading is kept."""
    names = list(fns)
    ms = {k: [] for k in names}
    for r in range(rounds):
        for k in names if r % 2 == 0 else names[::-1]:
            ms[k].append(chip_smoke._time_ms(fns[k], reps))
    return ms


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("compare_torch_kernels.py needs a CUDA device")
    card = chip_smoke.card_name()
    print(card)

    # The parent's library is built into an empty directory of its own, so
    # that nvcc runs and ptxas reports its registers: a library found built
    # (in the parent's build/) would come with no report.
    parent_kl = _load_kernel_lib(os.path.abspath(args.parent), "parent_kernel_lib")
    parent_kl.BUILD_DIR = os.path.join(REPO, "build", "compare_parent")
    shutil.rmtree(parent_kl.BUILD_DIR, ignore_errors=True)
    jobs = {
        "parent": parent_kl.build_library,
        "change": kernel_lib.build_library,
        "stamps": lambda: kernel_lib.build_library(("CG_SOLVE_STAMPS=1",)),
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = {k: f.result() for k, f in {k: pool.submit(fn) for k, fn in jobs.items()}.items()}
    libs = {"parent": parent_kl.load_library(), "change": kernel_lib.open_library(built["change"][0])}
    stamps_lib = kernel_lib.open_library(built["stamps"][0])
    for k, (_, seconds, _) in built.items():
        print(f"built {k} in {seconds:.1f} s")

    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm

    tf.set_full_f32()
    phases = chip_smoke.Phases(card)
    n_envs = chip_smoke.N_ENVS
    plan, model = tm.put_model(tm.load_snapshot("rodent-full-clips"), device="cuda")
    its, ls = plan.iterations, plan.ls_iterations
    nl, nc = plan.nlimit, plan.ncon
    report = {"card": card, "k2": {}, "same_as_parent": {}, "ms": {}}

    # K2: occupancy
    smem_p = libs["parent"].cg_solve_smem_bytes(plan.nv, nl, nc)
    regs_p = _ptxas_registers(built["parent"][2], "cg_solve_kernel")
    occ = {"parent": dict(registers=regs_p, smem=smem_p, threads=PARENT_THREADS,
                          ctas=ctas_per_sm(regs_p, PARENT_THREADS, smem_p))}
    for k, lib in libs.items():
        if k == "parent":
            continue
        info = (ctypes.c_int * 4)()
        assert lib.cg_solve_kernel_info(plan.nv, nl, nc, info) == 0
        occ[k] = dict(registers=info[0], smem=info[1], ctas=info[2], threads=info[3],
                      ctas_by_limits=ctas_per_sm(info[0], info[3], info[1]))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k, o in occ.items():
        o["waves"] = math.ceil(n_envs / (o["ctas"] * sms))
        print(f"cg_solve {k}: {o['threads']} threads, {o['registers']} registers, {o['smem']} B shared, "
              f"{o['ctas']} CTAs per SM, {o['waves']} waves of {n_envs} envs on {sms} SMs ({card})")
    report["k2"]["occupancy"] = occ

    # K2: errors against plain (float32 and float64) and against the
    # parent, two state sets
    from torch_parity import contact_rich_states
    from track_mjx_tpu_torch.physics import solver as ts

    test_states = [torch.tensor(x, device="cuda") for x in contact_rich_states(
        plan.nq, plan.nv, plan.nu, model.qpos0.cpu().numpy(), n_envs, 29)]
    state_sets = {
        "chip_smoke": phases.rodent_states(plan, model),
        "test_seed29": phases.solver_inputs(plan, model, *test_states, ts.solve_inputs),
    }
    errors, to_f64 = {}, {}
    for what, a in state_sets.items():
        plain = tk.cg_solve_plain(**a, iterations=its, ls_iterations=ls)
        exact = tk.cg_solve_plain(**{k: v.double() for k, v in a.items()}, iterations=its, ls_iterations=ls)
        outs = {k: call_cg(lib, "cg_solve", a, its, ls) for k, lib in libs.items()}
        torch.cuda.synchronize()
        errors[what], to_f64[what] = {}, {}
        for k, out in outs.items():
            errs = {name: chip_smoke._rel(getattr(out, name), getattr(plain, name)) for name in OUTS}
            same = all(torch.equal(getattr(out, name), getattr(outs["parent"], name)) for name in OUTS)
            errors[what][k] = dict(errs, bitwise_parent=same)
            print(f"cg_solve {k} vs plain on {what} states ({its}/{ls}): "
                  + ", ".join(f"{name} {e:.3e}" for name, e in errs.items())
                  + f"; outputs bitwise the parent's: {same}")
        for k, out in {**outs, "plain_f32": plain}.items():
            to_f64[what][k] = {name: chip_smoke._rel(getattr(out, name).double(), getattr(exact, name))
                               for name in OUTS}
            print(f"cg_solve {k} vs plain in float64 on {what} states ({its}/{ls}): "
                  + ", ".join(f"{name} {e:.3e}" for name, e in to_f64[what][k].items()))
        del plain, exact, outs
    report["k2"]["errors"] = errors
    report["k2"]["errors_vs_float64"] = to_f64

    # K2: time by iterations / ls_iterations
    a = state_sets["chip_smoke"]
    times = {}
    for cfg in CONFIGS:
        fns = {k: (lambda lib=lib, cfg=cfg: call_cg(lib, "cg_solve", a, *cfg)) for k, lib in libs.items()}
        times[f"{cfg[0]}/{cfg[1]}"] = timed(fns, args.reps, args.rounds)
        print(f"cg_solve at B={n_envs}, {cfg[0]}/{cfg[1]}: " + "; ".join(
            f"{k} " + " ".join(f"{t:.4f}" for t in v) + " ms" for k, v in times[f"{cfg[0]}/{cfg[1]}"].items())
            + f" ({card})")
    report["k2"]["ms"] = times

    # K2: where an env's time goes, from the stamps build (the solo warp's
    # clock64 cycles per phase, summed over the CTAs, per env)
    stamps = (ctypes.c_ulonglong * STAMPS)()
    call_cg(stamps_lib, "cg_solve", a, its, ls)
    torch.cuda.synchronize()
    assert stamps_lib.cg_solve_stamps(stamps) == 0
    call_cg(stamps_lib, "cg_solve", a, its, ls)
    torch.cuda.synchronize()
    assert stamps_lib.cg_solve_stamps(stamps) == 0
    per_env = [s / n_envs for s in stamps]
    total = sum(per_env)
    report["k2"]["stamps_cycles_per_env"] = dict(zip(PHASES, per_env))
    print(f"cg_solve phases at B={n_envs}, {its}/{ls}, the solo warp's cycles per env (share): " + "; ".join(
        f"{name} {c:.0f} ({100 * c / total:.1f}%)" for name, c in zip(PHASES, per_env))
        + f"; total {total:.0f} ({card})")
    del state_sets, a

    # K3 and K4a-c: this tree's outputs against the parent's, and their times
    pair = {"parent": libs["parent"], "change": libs["change"]}
    fly_plan, fly_model = tm.put_model(tm.load_snapshot("fly-mc-intention"), device="cuda")
    fa = phases.fly_states(fly_plan, fly_model)
    cases = {"ell_cg_solve": lambda lib: call_cg(lib, "ell_cg_solve", fa, fly_plan.iterations,
                                                  fly_plan.ls_iterations)}
    snap = tm.load_snapshot("rodent-full-clips")
    snap.opt.solver = tm.SOLVER_NEWTON
    nplan, nmodel = tm.put_model(snap, device="cuda")
    m = phases.newton_matrices(nplan, nmodel)
    for op, mat in (("cholesky", (m["qM"],)), ("cho_solve", (m["qLD"], m["qfrc_smooth"])),
                    ("solve_spd", (m["H"], m["grad"])), ("solve_spd_euler", (m["M+hD"], m["euler_rhs"]))):
        cases[op] = lambda lib, op=op.replace("_euler", ""), mat=mat: call_linalg(lib, op, mat)
    for name, fn in cases.items():
        got = {k: fn(lib) for k, lib in pair.items()}
        torch.cuda.synchronize()
        got = {k: (tuple(v) if isinstance(v, tuple) else (v,)) for k, v in got.items()}
        same = all(torch.equal(x, y) for x, y in zip(got["parent"], got["change"]))
        report["same_as_parent"][name] = same
        report["ms"][name] = timed({k: (lambda lib=lib: fn(lib)) for k, lib in pair.items()},
                                   args.reps, args.rounds)
        print(f"{name}: outputs bitwise the parent's: {same}; ms " + "; ".join(
            f"{k} " + " ".join(f"{t:.4f}" for t in v) for k, v in report["ms"][name].items()) + f" ({card})")

    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
