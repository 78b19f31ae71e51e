"""The torch port's CUDA kernels of this tree against those of another
checkout (the parent), on one card, on the same inputs.

Usage (from the repository root, on a machine with a CUDA device and nvcc):

    python3 tools/compare_torch_kernels.py --parent DIR [--reps 20]
        [--rounds 2] [--out FILE]

DIR is a checkout of another commit (for example unpacked with `git
archive`). Both trees' csrc/ are built, each by its own ops/kernel_lib.py
(the parent's afresh into build/compare_parent/ of this tree, so that
ptxas reports its registers), this tree's once more with CG_SOLVE_STAMPS
(phase stamps); all builds run at once. The inputs come from this tree's
port: 4096 contact-rich rodent states from chip_smoke.py's generator (seed
0), 4096 drawn as tests/torch_parity.py's contact_rich_states draws them
(numpy seed 29), 4096 fly states from chip_smoke.py's generator (seed 0)
and 4096 more (seed 1), the solve inputs of the fly's main path (4096 flies
after one control step from rest, as chip_smoke.py drives them), and the
Newton path's matrices. Then, calling each library's C entry points
directly:

- cg_solve (K2): each build's error against the plain version per output
  (relative to max(1, max |plain|), as chip_smoke.py) and whether its
  outputs equal the parent's bit for bit, on both rodent state sets; each
  build's and the float32 plain version's error against the plain version
  in float64 (how far each float32 solve is from the exact one); its time
  at iterations / ls_iterations 0/0, 1/0, 1/5 and 5/5 (the differences
  split an env's time into set-up, a CG iteration and the linesearch), and
  the cycles per env of each phase from the stamps build; registers,
  shared memory and resident CTAs per SM (this tree's from
  cg_solve_kernel_info; the parent's from its ptxas registers and shared
  memory by Hopper's occupancy limits), and the waves of 4096 envs;
- ell_cg_solve (K3): whether this tree's outputs equal the parent's bit
  for bit on the three fly state sets, at the fly's 4/4 and at 1/0; its
  time at 0/0, 1/0, 1/4 and 4/4 on the first set and at 4/4 on the main
  path's; the stamps build's cycles per env of each phase on both; each
  build's registers (with ptxas's spills), shared memory, CTAs per SM and
  waves;
- cg_solve_dense and ell_cg_solve_dense (K2's and K3's dense-J modes):
  whether this tree's outputs equal the parent's bit for bit, with and
  without the Euler solve, at the path's iterations and at 1/0, on two
  state sets each (K2: 4096 rodents with mixed condims from chip_smoke.py's
  generator, 228 rows, and the default rodent's J of the chip_smoke set
  above, 187 rows; K3: 4096 flies with a condim-1 leg, seeds 0 and 1, 113
  rows); both times, with and without the Euler solve, by iterations /
  ls_iterations as above, and at one and at a full wave of CTAs (132 envs,
  and the build's CTAs per SM x 132); both builds' cycles per env of each
  phase (stamps builds of both trees); each build's registers (with
  ptxas's spills), shared memory, CTAs per SM and waves, and this tree's
  panels (rows per panel, panels per pass);
- the four fused modes (K2 and K3, compact and dense) with an armature per
  env, this tree's build alone: against their plain versions (K2 at its
  path's iterations within chip_smoke.KERNEL_REL, K3 at 1/0 within
  FLY_KERNEL_REL), how far the per-env armature moves qacc, and whether a
  launch whose every env's row is the shared armature equals the shared
  (stride 0) launch bit for bit;
- cho_solve (K4b): whether this tree's output equals the parent's bit for
  bit on the Newton path's qM factor, on a ragged batch of 4095 envs and
  with the factor's strict upper triangle NaN; both times; each build's
  occupancy;
- cholesky (K4a), solve_spd (K4c): whether this tree's outputs equal the
  parent's bit for bit, and both times.

Times are CUDA-event ms per launch over `--reps` launches, the builds taken
in turn, `--rounds` times (parent, this tree; then reversed). It prints one
JSON object as its last line and writes it to `--out`.
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
K3_CONFIGS = ((0, 0), (1, 0), (1, 4), (4, 4))  # of K3
# Hopper (sm_90) occupancy limits per SM: registers, their allocation unit
# per warp, threads, CTAs, shared memory a kernel may use and the part the
# system reserves per CTA.
SM_REGS, REG_UNIT, SM_THREADS, SM_CTAS, SM_SMEM, CTA_RESERVED = 65536, 256, 2048, 32, 233472, 1024
# Threads per CTA of K3's and K4b's first designs, for the occupancy of a
# parent built before their kernel_info entry points (from its ptxas report)
FIRST_DESIGN_THREADS = {"ell_cg_solve": 128, "cho_solve": 128}
# cg_solve.cu's phase stamps, in order (a CG iteration's summed over its
# iterations)
PHASES = (
    "load", "limit rows, qM", "jfr", "L = M, limit lists", "factor qM", "panel inverses",
    "smooth solve | J warm", "M dx, J smooth", "warm-start choice, force", "J^T: grad",
    "solve: mgrad", "it: M p, J p", "it: p M p, linesearch", "it: x, jar, force", "it: J^T",
    "it: solve", "it: beta, p", "J^T qfrc, M + hD, outputs", "Euler factor",
    "Euler inverses, solve",
)
# ell_cg_solve.cu's phase stamps, in order
K3_PHASES = (
    "load", "qM, limit rows", "jfr", "L = M, limit lists", "factor qM", "smooth solve | J warm",
    "M dx, J smooth", "warm-start choice, force", "J^T: grad", "solve: mgrad", "it: M p, J p",
    "it: first sums", "it: linesearch", "it: cost check", "it: x, jar, force, M dx", "it: J^T",
    "it: solve, beta, p", "J^T qfrc, M + hD, outputs", "Euler factor", "Euler solve",
)


def _load_kernel_lib(root: str, name: str):
    path = os.path.join(root, "track_mjx_tpu_torch", "ops", "kernel_lib.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(log: str, kernel: str, dense: bool = False) -> dict:
    """Registers, stack frame and spill bytes of the entry function whose
    name holds `kernel` (and not a longer name ending in it; of a template
    kernel, its instance with the template argument false, the compact
    mode, or with `dense` true), from nvcc's -Xptxas -v output."""
    lines = log.splitlines()
    instance = "ILb1EE" if dense else "(?:E|ILb0EE)"
    for k, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m and re.search(rf"\d{kernel}{instance}", m.group(1)):
            out = {}
            for later in lines[k + 1 : k + 5]:
                r = re.search(r"Used (\d+) registers", later)
                if r:
                    out["registers"] = int(r.group(1))
                f = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", later)
                if f:
                    out.update(stack=int(f.group(1)), spill_stores=int(f.group(2)), spill_loads=int(f.group(3)))
            if "registers" in out:
                return out
    raise RuntimeError(f"no ptxas register count for {kernel}")


def ctas_per_sm(regs: int, threads: int, smem: int) -> int:
    warps = threads // 32
    by_regs = SM_REGS // (warps * math.ceil(regs * 32 / REG_UNIT) * REG_UNIT)
    return min(by_regs, SM_THREADS // threads, SM_CTAS, SM_SMEM // (smem + CTA_RESERVED))


def _arm_stride(a: dict) -> int:
    """The armature's stride between envs: 0 shared (n,), n per env [B, n]."""
    return a["arm"].shape[-1] if a["arm"].dim() == 2 else 0


def call_cg(lib, op: str, a: dict, its: int, ls: int) -> tk.CGOut:
    """One launch of `{op}_f32` from `lib` on the inputs `a` (cg_solve's
    keyword arguments, tk._ARG_NAMES order)."""
    args = [a[k] for k in tk._ARG_NAMES]
    bsz, n = a["qfrc_smooth"].shape
    nl, nc = a["lim1h"].shape[0], a["fq"].shape[1]
    e = a["aref"].shape[1]
    out = tk.CGOut(*(torch.empty(bsz, m, device="cuda") for m in (n, n, e, n, n)))
    fn = getattr(lib, f"{op}_f32")
    # a build whose cg_solve_f32 takes with_euler (after ls_iterations) runs
    # with it, and one that takes arm_stride after it with the armature's
    extra = {28: (), 29: (1,), 30: (1, _arm_stride(a))}[len(fn.argtypes)]
    err = fn(
        *[t.data_ptr() for t in args], out.qacc_smooth.data_ptr(), out.qacc.data_ptr(),
        out.qfrc_constraint.data_ptr(), out.qacc_eff.data_ptr(), out.efc_force.data_ptr(),
        bsz, n, nl, nc, its, ls, *extra, torch.cuda.current_stream().cuda_stream,
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


def _kernel_occupancy(lib, built_log: str, op: str, dims: tuple, n_envs: int) -> dict:
    """The occupancy of `op` (cg_solve, ell_cg_solve, cho_solve; one env per
    CTA) at dims: from its `{op}_kernel_info` where the build has one
    (registers, shared memory, CTAs per SM, threads), else from ptxas's
    registers and `{op}_smem_bytes` with its first design's threads; ptxas's
    report beside it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    report = _ptxas(built_log, f"{op}_kernel")
    if hasattr(lib, f"{op}_kernel_info"):
        info = (ctypes.c_int * 4)()
        err = getattr(lib, f"{op}_kernel_info")(*dims, info)
        assert err == 0, f"{op}_kernel_info failed with cudaError {err}"
        out = dict(registers=info[0], smem=info[1], ctas=info[2], threads=info[3],
                   ctas_by_limits=ctas_per_sm(info[0], info[3], info[1]))
    else:
        smem = getattr(lib, f"{op}_smem_bytes")(*dims)
        threads = FIRST_DESIGN_THREADS[op]
        out = dict(registers=report["registers"], smem=smem, threads=threads,
                   ctas=ctas_per_sm(report["registers"], threads, smem))
    out["waves"] = math.ceil(n_envs / (out["ctas"] * sms))
    out["ptxas"] = report
    return out


def call_dense(lib, op: str, a: dict, its: int, ls: int, with_euler: bool = True) -> tk.CGOut:
    """One launch of `{op}_f32` (cg_solve_dense, ell_cg_solve_dense) from
    `lib` on the inputs `a` (the wrapper's keyword arguments, ns for
    ell_cg_solve_dense); without `with_euler`, qacc_eff is left unwritten."""
    names = tk._DENSE_ARG_NAMES if op == "cg_solve_dense" else tk._ELL_DENSE_ARG_NAMES
    bsz, n = a["qfrc_smooth"].shape
    e = a["J"].shape[1]
    dims = (n, e) if op == "cg_solve_dense" else (n, a["ns"], (e - a["ns"]) // 3)
    out = tk.CGOut(*(torch.empty(bsz, m, device="cuda") for m in (n, n, e, n, n)))
    fn = getattr(lib, f"{op}_f32")
    # a build whose entry point takes arm_stride after with_euler: the inputs,
    # 5 outputs, batch, dims, iterations, ls_iterations, with_euler, arm_stride
    # and the stream
    stride = (_arm_stride(a),) if len(fn.argtypes) == len(names) + 5 + 1 + len(dims) + 5 else ()
    err = fn(
        *[a[k].data_ptr() for k in names], out.qacc_smooth.data_ptr(), out.qacc.data_ptr(),
        out.qfrc_constraint.data_ptr(), out.qacc_eff.data_ptr() if with_euler else None, out.efc_force.data_ptr(),
        bsz, *dims, its, ls, int(with_euler), *stride, torch.cuda.current_stream().cuda_stream,
    )
    assert err == 0, f"{op}_f32 failed with cudaError {err}"
    return out


def _dense_occupancy(lib, built_log: str, op: str, dims: tuple, n_envs: int) -> dict:
    """The occupancy of the dense mode `op` at dims from its kernel_info,
    ptxas's report of its kernel (the kDense instance of the template kernel,
    or a kernel `{op}_kernel` of its own), and where the build has them its
    panels (rows per panel, panels per pass, J copied once)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    info = (ctypes.c_int * 4)()
    err = getattr(lib, f"{op}_kernel_info")(*dims, info)
    assert err == 0, f"{op}_kernel_info failed with cudaError {err}"
    out = dict(registers=info[0], smem=info[1], ctas=info[2], threads=info[3],
               ctas_by_limits=ctas_per_sm(info[0], info[3], info[1]))
    out["waves"] = math.ceil(n_envs / (out["ctas"] * sms))
    try:
        out["ptxas"] = _ptxas(built_log, op.replace("_dense", "_kernel"), dense=True)
    except RuntimeError:
        out["ptxas"] = _ptxas(built_log, f"{op}_kernel")
    if hasattr(lib, f"{op}_panels"):
        panels = (ctypes.c_int * 3)()
        fn = getattr(lib, f"{op}_panels")
        fn.argtypes = [ctypes.c_int] * len(dims) + [ctypes.c_void_p]
        assert fn(*dims, panels) == 0
        out["panels"] = dict(rows=panels[0], per_pass=panels[1], resident=bool(panels[2]))
    return out


def dense_modes(libs: dict, built: dict, stamps_libs: dict, args, card: str) -> dict:
    """Both dense modes of this tree against the parent's: occupancy,
    bitwise outputs, times (the module docstring). Its states come from a
    generator of their own (chip_smoke.py's, seed 0), so the other kernels'
    states are those of a run without this part."""
    from track_mjx_tpu_torch.physics import model as tm

    n_envs = chip_smoke.N_ENVS
    phases = chip_smoke.Phases(card)
    ts = phases.ts
    report = {}
    plan, model = tm.put_model(tm.load_snapshot("rodent-full-clips"), device="cuda")
    mplan, mmodel = tm.put_model(chip_smoke.mixed_condim(tm.load_snapshot("rodent-full-clips")), device="cuda")
    d, efc = phases.solver_inputs(mplan, mmodel, *phases.rodent_drop(mplan, mmodel),
                                  lambda p, m, d, e: (d, e))
    a = phases.rodent_states(plan, model)
    j = tk.build_j(a["fq"], a["sw"], a["ll"], a["mu"], a["dm"], a["lim1h"]).contiguous()
    fplan, fmodel = tm.put_model(chip_smoke.fly_condim1(tm.load_snapshot("fly-mc-intention")), device="cuda")
    seed1 = chip_smoke.Phases(card)
    seed1.gen.manual_seed(1)
    cases = {
        "cg_solve_dense": ((mplan.iterations, mplan.ls_iterations), {
            "mixed_condim": ts.dense_solve_inputs(mplan, mmodel, d, efc),
            "default_rodent": dict({k: a[k] for k in tk._DENSE_ARG_NAMES if k != "J"}, J=j),
        }),
        "ell_cg_solve_dense": ((fplan.iterations, fplan.ls_iterations), {
            "fly_condim1": phases.fly_states(fplan, fmodel, dense=True),
            "fly_condim1_seed1": seed1.fly_states(fplan, fmodel, dense=True),
        }),
    }
    del d, efc, a, j
    for op, ((its, ls), sets) in cases.items():
        first = next(iter(sets.values()))
        e = first["J"].shape[1]
        dims = (first["qfrc_smooth"].shape[1], e) if op == "cg_solve_dense" else (
            first["qfrc_smooth"].shape[1], first["ns"], (e - first["ns"]) // 3)
        occ = {k: _dense_occupancy(lib, built[k][2], op, dims, n_envs) for k, lib in libs.items()}
        for k, o in occ.items():
            _print_occ(op, k, o, n_envs, card)
        same = {}
        for what, s in sets.items():
            for cfg in ((its, ls), (1, 0)):
                for we in (True, False):
                    outs = {k: call_dense(lib, op, s, *cfg, with_euler=we) for k, lib in libs.items()}
                    torch.cuda.synchronize()
                    key = f"{what} {cfg[0]}/{cfg[1]}" + ("" if we else " without Euler")
                    names = OUTS if we else OUTS[:4]
                    out, ref = outs["change"], outs["parent"]
                    same[key] = all(torch.equal(getattr(out, name), getattr(ref, name)) for name in names)
                    print(f"{op} on {what} states ({key}), outputs bitwise the parent's: {same[key]}")
                    if not same[key]:
                        print("  " + "; ".join(
                            f"{name} {int((getattr(out, name) != getattr(ref, name)).any(1).sum())} envs, "
                            f"max rel {chip_smoke._rel(getattr(out, name), getattr(ref, name)):.2e}"
                            for name in names))
                    del outs, out, ref
        times = {}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        configs = [(cfg, True, n_envs) for cfg in (CONFIGS if op == "cg_solve_dense" else K3_CONFIGS)]
        configs += [((its, ls), False, n_envs)]
        configs += [((its, ls), True, b) for b in sorted({sms, *(o["ctas"] * sms for o in occ.values())})]
        for cfg, we, bsz in configs:
            key = f"{cfg[0]}/{cfg[1]}" + ("" if we else " without Euler") + ("" if bsz == n_envs else f" at B={bsz}")
            sub = {k: (v[:bsz].contiguous() if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == n_envs
                       else v) for k, v in first.items()}
            times[key] = timed({k: (lambda lib=lib, cfg=cfg, we=we, sub=sub: call_dense(lib, op, sub, *cfg, we))
                                for k, lib in libs.items()}, args.reps, args.rounds)
            print(f"{op} at B={bsz}, {key}: " + "; ".join(
                f"{k} " + " ".join(f"{t:.4f}" for t in v) + " ms" for k, v in times[key].items()) + f" ({card})")
        kernel = op.replace("_dense", "")
        stamps = {k: _stamps(getattr(lib, f"{kernel}_stamps"), lambda lib=lib: call_dense(lib, op, first, its, ls),
                             PHASES if kernel == "cg_solve" else K3_PHASES,
                             f"{op} ({k}) phases at B={n_envs}, {its}/{ls}", n_envs, card)
                  for k, lib in stamps_libs.items()}
        report[op] = {"occupancy": occ, "bitwise_parent": same, "ms": times, "stamps_cycles_per_env": stamps}
    del cases
    return report


def per_env_armature(lib, card: str) -> dict:
    """This tree's four fused solve modes with an armature per env against
    their plain versions on the same inputs (an armature [B, n]: the
    model's times U(1, 1.05) per env and dof, plus up to 5% of its largest
    entry; K2 at its path's iterations within chip_smoke.KERNEL_REL, K3 at
    1/0 within chip_smoke.FLY_KERNEL_REL), and each launch with every env's
    row the shared armature bitwise its launch with the shared (n,) one.
    Its states come from a generator of their own (chip_smoke.py's, seed 2)."""
    from track_mjx_tpu_torch.physics import model as tm

    phases = chip_smoke.Phases(card)
    phases.gen.manual_seed(2)
    ts = phases.ts
    rodent = tm.put_model(tm.load_snapshot("rodent-full-clips"), device="cuda")
    mixed = tm.put_model(chip_smoke.mixed_condim(tm.load_snapshot("rodent-full-clips")), device="cuda")
    fly = tm.put_model(tm.load_snapshot("fly-mc-intention"), device="cuda")
    fly1 = tm.put_model(chip_smoke.fly_condim1(tm.load_snapshot("fly-mc-intention")), device="cuda")
    cases = {
        "cg_solve": (rodent, lambda p, m: phases.rodent_states(*rodent), chip_smoke.KERNEL_REL, None),
        "cg_solve_dense": (mixed, lambda p, m: phases.solver_inputs(p, m, *phases.rodent_drop(p, m),
                                                                     ts.dense_solve_inputs), chip_smoke.KERNEL_REL,
                           None),
        "ell_cg_solve": (fly, lambda p, m: phases.fly_states(p, m), chip_smoke.FLY_KERNEL_REL, (1, 0)),
        "ell_cg_solve_dense": (fly1, lambda p, m: phases.fly_states(p, m, dense=True), chip_smoke.FLY_KERNEL_REL,
                               (1, 0)),
    }
    report = {}
    for op, ((plan, model), states, bars, steps) in cases.items():
        its, ls = steps or (plan.iterations, plan.ls_iterations)
        a = states(plan, model)
        bsz, n = a["qfrc_smooth"].shape
        arm = a["arm"]
        per_env = (arm * phases.uniform((bsz, n), 1.0, 1.05)
                   + phases.uniform((bsz, n), 0.0, 0.05) * float(arm.max())).contiguous()

        def launch(inputs):
            if op in ("cg_solve", "ell_cg_solve"):
                return call_cg(lib, op, inputs, its, ls)
            return call_dense(lib, op, inputs, its, ls)

        a_v = dict(a, arm=per_env)
        out = launch(a_v)
        plain = getattr(tk, f"{op}_plain")(**a_v, iterations=its, ls_iterations=ls, with_euler=True)
        shared, rows = launch(a), launch(dict(a, arm=arm.expand(bsz, n).contiguous()))
        torch.cuda.synchronize()
        errs = {name: chip_smoke._rel(getattr(out, name), getattr(plain, name)) for name in bars}
        moved = float(chip_smoke._per_env(out.qacc, shared.qacc).max())
        same = all(torch.equal(getattr(rows, name), getattr(shared, name)) for name in OUTS)
        report[op] = {"iterations": its, "ls_iterations": ls, "errors_vs_plain": errs,
                      "within_bars": all(e < bars[k] for k, e in errs.items()), "qacc_moved_max": moved,
                      "equal_rows_bitwise_shared": same}
        print(f"{op} with an armature per env at B={bsz}, {its}/{ls}, vs plain: "
              + ", ".join(f"{k} {e:.3e} (bar {bars[k]:.0e})" for k, e in errs.items())
              + f"; qacc moved by the per-env armature up to {moved:.3e} per env; every env's row the shared "
              f"armature bitwise the shared launch: {same} ({card})")
        del a, a_v, out, plain, shared, rows
    return report


def _print_occ(name: str, k: str, o: dict, n_envs: int, card: str) -> None:
    print(f"{name} {k}: {o['threads']} threads per CTA (one env), {o['registers']} registers"
          + (f" (ptxas: {o['ptxas']})" if "ptxas" in o else "")
          + f", {o['smem']} B shared, {o['ctas']} CTAs per SM, {o['waves']} waves of {n_envs} envs"
          + (f", J in panels {o['panels']}" if "panels" in o else "") + f" ({card})")


def main_path_fly_states(phases, plan, model) -> dict:
    """ell_cg_solve's inputs on the fly's main path: chip_smoke.py's start
    (4096 flies at rest, 1e-3 joint noise) after one control step of
    n_step(..., 10) under its controls, then the next substep's stages."""
    tf, tm, ts = phases.tf, phases.tm, phases.ts
    n_envs = chip_smoke.N_ENVS
    data = tm.make_data(plan, model, n_envs)
    qpos = data.qpos.clone()
    qpos[:, 7:] += phases.uniform((n_envs, plan.nq - 7), -0.001, 0.001)
    ctrl = chip_smoke.FLY_CTRL_SCALE * phases.uniform((n_envs, plan.nu), -1.0, 1.0)
    data = tf.n_step(plan, model, data.replace(qpos=qpos, ctrl=ctrl), chip_smoke.SUBSTEPS)
    return phases.solver_inputs(plan, model, data.qpos, data.qvel, ctrl, data.qacc_warmstart,
                                ts.ell_solve_inputs)


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
    # this tree's builds too, so that each reports its registers and spills
    shutil.rmtree(kernel_lib.BUILD_DIR, ignore_errors=True)
    jobs = {
        "parent": parent_kl.build_library,
        "change": kernel_lib.build_library,
        "stamps": lambda: kernel_lib.build_library(("CG_SOLVE_STAMPS=1",)),
        "parent_stamps": lambda: parent_kl.build_library(("CG_SOLVE_STAMPS=1",)),
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = {k: f.result() for k, f in {k: pool.submit(fn) for k, fn in jobs.items()}.items()}
    libs = {"parent": parent_kl.load_library(), "change": kernel_lib.open_library(built["change"][0])}
    stamps_lib = kernel_lib.open_library(built["stamps"][0])
    stamps_libs = {"parent": parent_kl.open_library(built["parent_stamps"][0]), "change": stamps_lib}
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
    report = {"card": card, "k2": {}, "k3": {}, "k4b": {}, "same_as_parent": {}, "ms": {}}

    # the dense modes of K2 and K3
    report["dense"] = dense_modes(libs, built, stamps_libs, args, card)
    for op, r in report["dense"].items():
        report["same_as_parent"][op] = all(r["bitwise_parent"].values())
        report["ms"][op] = r["ms"]

    # the four modes with an armature per env, this tree's build
    report["per_env_armature"] = per_env_armature(libs["change"], card)

    # K2: occupancy
    occ = {k: _kernel_occupancy(lib, built[k][2], "cg_solve", (plan.nv, nl, nc), n_envs)
           for k, lib in libs.items()}
    for k, o in occ.items():
        _print_occ("cg_solve", k, o, n_envs, card)
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
    report["k2"]["stamps_cycles_per_env"] = _stamps(
        stamps_lib.cg_solve_stamps, lambda: call_cg(stamps_lib, "cg_solve", a, its, ls), PHASES,
        f"cg_solve phases at B={n_envs}, {its}/{ls}", n_envs, card)
    del state_sets, a

    # K3: occupancy, outputs against the parent's on two fly state sets,
    # time by iterations / ls_iterations, phase stamps
    fly_plan, fly_model = tm.put_model(tm.load_snapshot("fly-mc-intention"), device="cuda")
    fits, fls = fly_plan.iterations, fly_plan.ls_iterations
    fn_, fnl, fnc = fly_plan.nv, fly_plan.nlimit, fly_plan.ncon
    occ = {k: _kernel_occupancy(lib, built[k][2], "ell_cg_solve", (fn_, fnl, fnc), n_envs)
           for k, lib in libs.items()}
    for k, o in occ.items():
        _print_occ("ell_cg_solve", k, o, n_envs, card)
    report["k3"]["occupancy"] = occ
    fa = phases.fly_states(fly_plan, fly_model)
    seed1 = chip_smoke.Phases(card)
    seed1.gen.manual_seed(1)
    fly_sets = {"chip_smoke": fa, "seed1": seed1.fly_states(fly_plan, fly_model),
                "main_path": main_path_fly_states(seed1, fly_plan, fly_model)}
    same = {}
    for what, fs in fly_sets.items():
        for cfg in ((fits, fls), (1, 0)):
            outs = {k: call_cg(lib, "ell_cg_solve", fs, *cfg) for k, lib in libs.items()}
            torch.cuda.synchronize()
            key = f"{what} {cfg[0]}/{cfg[1]}"
            out, ref = outs["change"], outs["parent"]
            same[key] = all(torch.equal(getattr(out, name), getattr(ref, name)) for name in OUTS)
            print(f"ell_cg_solve on {what} fly states ({cfg[0]}/{cfg[1]}), outputs bitwise the parent's: {same[key]}")
            if not same[key]:  # where they part: envs, largest difference
                print("  " + "; ".join(
                    f"{name} {int((getattr(out, name) != getattr(ref, name)).any(1).sum())} envs, "
                    f"max rel {chip_smoke._rel(getattr(out, name), getattr(ref, name)):.2e}" for name in OUTS))
            del outs, out, ref
    report["k3"]["bitwise_parent"] = same
    report["same_as_parent"]["ell_cg_solve"] = all(same.values())
    times = {}
    for cfg in K3_CONFIGS:
        fns = {k: (lambda lib=lib, cfg=cfg: call_cg(lib, "ell_cg_solve", fa, *cfg)) for k, lib in libs.items()}
        times[f"{cfg[0]}/{cfg[1]}"] = timed(fns, args.reps, args.rounds)
        print(f"ell_cg_solve at B={n_envs}, {cfg[0]}/{cfg[1]}: " + "; ".join(
            f"{k} " + " ".join(f"{t:.4f}" for t in v) + " ms" for k, v in times[f"{cfg[0]}/{cfg[1]}"].items())
            + f" ({card})")
    mp = fly_sets["main_path"]
    times[f"main path {fits}/{fls}"] = timed(
        {k: (lambda lib=lib: call_cg(lib, "ell_cg_solve", mp, fits, fls)) for k, lib in libs.items()},
        args.reps, args.rounds)
    print(f"ell_cg_solve at B={n_envs} on the main path's states, {fits}/{fls}: " + "; ".join(
        f"{k} " + " ".join(f"{t:.4f}" for t in v) + " ms" for k, v in times[f"main path {fits}/{fls}"].items())
        + f" ({card})")
    report["k3"]["ms"] = times
    report["ms"]["ell_cg_solve"] = times[f"{fits}/{fls}"]
    report["k3"]["stamps_cycles_per_env"] = {
        what: _stamps(stamps_lib.ell_cg_solve_stamps,
                      lambda fs=fs: call_cg(stamps_lib, "ell_cg_solve", fs, fits, fls), K3_PHASES,
                      f"ell_cg_solve phases at B={n_envs}, {fits}/{fls}, {what} states", n_envs, card)
        for what, fs in (("chip_smoke", fa), ("main_path", mp))}
    del fly_sets, fa, mp

    # K4a-c: this tree's outputs against the parent's, and their times;
    # K4b also its occupancy
    snap = tm.load_snapshot("rodent-full-clips")
    snap.opt.solver = tm.SOLVER_NEWTON
    nplan, nmodel = tm.put_model(snap, device="cuda")
    m = phases.newton_matrices(nplan, nmodel)
    occ = {k: _kernel_occupancy(lib, built[k][2], "cho_solve", (nplan.nv,), n_envs)
           for k, lib in libs.items()}
    for k, o in occ.items():
        _print_occ("cho_solve", k, o, n_envs, card)
    report["k4b"]["occupancy"] = occ
    nan_l = m["qLD"].masked_fill(torch.ones_like(m["qLD"][0], dtype=torch.bool).triu(1), float("nan"))
    cho_cases = {
        "qLD": (m["qLD"], m["qfrc_smooth"]),
        "qLD, ragged": (m["qLD"][: chip_smoke.RAGGED].contiguous(), m["qfrc_smooth"][: chip_smoke.RAGGED].contiguous()),
        "qLD, NaN upper": (nan_l, m["qfrc_smooth"]),
    }
    same = {}
    for what, cargs in cho_cases.items():
        got = {k: call_linalg(lib, "cho_solve", cargs) for k, lib in libs.items()}
        torch.cuda.synchronize()
        same[what] = torch.equal(got["change"], got["parent"])
        print(f"cho_solve on {what}: outputs bitwise the parent's: {same[what]}")
    report["k4b"]["bitwise_parent"] = same
    report["same_as_parent"]["cho_solve"] = all(same.values())
    report["ms"]["cho_solve"] = timed({k: (lambda lib=lib: call_linalg(lib, "cho_solve", cho_cases["qLD"]))
                                       for k, lib in libs.items()}, args.reps, args.rounds)
    print("cho_solve: ms " + "; ".join(f"{k} " + " ".join(f"{t:.4f}" for t in v)
                                       for k, v in report["ms"]["cho_solve"].items()) + f" ({card})")
    cases = {}
    for op, mat in (("cholesky", (m["qM"],)), ("solve_spd", (m["H"], m["grad"])),
                    ("solve_spd_euler", (m["M+hD"], m["euler_rhs"]))):
        cases[op] = lambda lib, op=op.replace("_euler", ""), mat=mat: call_linalg(lib, op, mat)
    for name, fn in cases.items():
        got = {k: fn(lib) for k, lib in libs.items()}
        torch.cuda.synchronize()
        same = torch.equal(got["parent"], got["change"])
        report["same_as_parent"][name] = same
        report["ms"][name] = timed({k: (lambda lib=lib: fn(lib)) for k, lib in libs.items()},
                                   args.reps, args.rounds)
        print(f"{name}: outputs bitwise the parent's: {same}; ms " + "; ".join(
            f"{k} " + " ".join(f"{t:.4f}" for t in v) for k, v in report["ms"][name].items()) + f" ({card})")

    line = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


def _stamps(read, run, phases: tuple, what: str, n_envs: int, card: str) -> dict:
    """The stamps build's cycles per env of each phase (the solo warp's
    clock64 cycles, summed over the CTAs, per env) over one launch: one
    launch first clears them."""
    stamps = (ctypes.c_ulonglong * len(phases))()
    for _ in range(2):
        run()
        torch.cuda.synchronize()
        assert read(stamps) == 0
    per_env = [s / n_envs for s in stamps]
    total = sum(per_env)
    print(f"{what}, the solo warp's cycles per env (share): " + "; ".join(
        f"{name} {c:.0f} ({100 * c / total:.1f}%)" for name, c in zip(phases, per_env))
        + f"; total {total:.0f} ({card})")
    return dict(zip(phases, per_env))


if __name__ == "__main__":
    main()
