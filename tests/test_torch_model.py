"""Port model packing against the JAX package: the compiled-model snapshot,
put_model on every plan and model field, the numpy converters, and the
port's import isolation from JAX and MuJoCo."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torch_parity import REPO, assert_plan_equal, load_export_tool
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu_torch.physics import model as tm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def export_tool():
    return load_export_tool()


@pytest.fixture(scope="module")
def live_walker(export_tool):
    return export_tool.workload_walker("rodent-full-clips")


@pytest.fixture(scope="module")
def live_model(live_walker):
    return live_walker._mj_model


def test_snapshot_equals_fresh_export(export_tool, live_walker):
    fresh = {**export_tool.snapshot_arrays(live_walker._mj_model), **export_tool.walker_arrays(live_walker)}
    with np.load(tm.SNAPSHOTS["rodent-full-clips"]) as z:
        assert sorted(z.files) == sorted(fresh)
        for name, arr in fresh.items():
            assert z[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(z[name], arr, err_msg=name)
    with open(os.path.splitext(tm.SNAPSHOTS["rodent-full-clips"])[0] + ".json") as f:
        assert json.load(f) == export_tool.config_sections("rodent-full-clips")


@pytest.mark.parametrize("walker_name, scale", [("rodent", 0.9), ("rodent", 0.8), ("fly", 1.0)])
def test_playback_snapshot_equals_fresh_export(export_tool, walker_name, scale):
    """The renderer's committed playback models (walker + ghost) are what
    tools/export_torch_model.py --playback writes now."""
    from track_mjx_tpu_torch.analysis import render

    assert (walker_name, scale) in export_tool.playbacks()
    fresh = export_tool.playback_arrays(walker_name, scale)
    with np.load(render.playback_path(walker_name, scale)) as z:
        assert sorted(z.files) == sorted(fresh)
        for name, arr in fresh.items():
            assert z[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(z[name], arr, err_msg=name)


def test_snapshot_walker_tables_equal_the_jax_rodent(live_walker):
    """The port's Rodent, built from the snapshot with no MuJoCo, holds the
    index tables that the JAX Rodent resolves by name."""
    from track_mjx_tpu_torch.envs.walker.rodent import Rodent

    walker = Rodent.from_snapshot(tm.load_snapshot("rodent-full-clips"))
    np.testing.assert_array_equal(walker.joint_idxs, np.asarray(live_walker._joint_idxs))
    np.testing.assert_array_equal(walker.body_idxs, np.asarray(live_walker._body_idxs))
    np.testing.assert_array_equal(walker.endeff_idxs, np.asarray(live_walker._endeff_idxs))
    assert walker.torso_idx == int(live_walker._torso_idx) == 3
    assert (len(walker.joint_idxs), len(walker.body_idxs), len(walker.endeff_idxs)) == (33, 18, 5)


@pytest.mark.parametrize("source", ["snapshot", "live"])
def test_put_model_matches_jax(live_model, source):
    jplan, jmodel = jm.put_model(live_model)
    m = tm.load_snapshot() if source == "snapshot" else live_model
    plan, model = tm.put_model(m, device="cpu")
    assert [f.name for f in dataclasses.fields(tm.PhysicsPlan)] == [
        f.name for f in dataclasses.fields(jm.PhysicsPlan)
    ]
    assert_plan_equal(plan, jplan)
    assert [f.name for f in dataclasses.fields(tm.Model)] == [
        f.name for f in dataclasses.fields(jm.Model)
    ]
    for f in dataclasses.fields(tm.Model):
        got = getattr(model, f.name)
        assert got.dtype == torch.float32, f.name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jmodel, f.name)), err_msg=f.name)
    # the slice's workload: rodent, CG 5/5, Euler, 30 condim-3 pyramids
    assert (plan.nq, plan.nv, plan.nu, plan.na, plan.ntendon, plan.nsensor) == (74, 73, 38, 38, 8, 4)
    assert (plan.ncon, plan.nlimit, plan.nefc) == (30, 67, 187)
    assert (plan.solver, plan.iterations, plan.ls_iterations, plan.integrator) == (1, 5, 5, 0)
    assert float(model.opt_timestep) == pytest.approx(0.002)


def test_numpy_converters_round_trip(live_model):
    jplan, jmodel = jm.put_model(live_model)
    plan, model = tm.put_model(tm.load_snapshot(), device="cpu")
    leaves = {f.name: np.asarray(getattr(jmodel, f.name)) for f in dataclasses.fields(jm.Model)}
    conv = tm.model_from_numpy(leaves, device="cpu")
    for f in dataclasses.fields(tm.Model):
        assert torch.equal(getattr(conv, f.name), getattr(model, f.name)), f.name

    jdata = jax.vmap(lambda _: jm.make_data(jplan, jmodel))(np.arange(3))
    data = tm.make_data(plan, model, 3)
    conv = tm.data_from_numpy(
        {f.name: np.asarray(getattr(jdata, f.name)) for f in dataclasses.fields(jm.Data)}, device="cpu"
    )
    assert [f.name for f in dataclasses.fields(tm.Data)] == [f.name for f in dataclasses.fields(jm.Data)]
    for f in dataclasses.fields(tm.Data):
        assert torch.equal(getattr(conv, f.name), getattr(data, f.name)), f.name


@pytest.mark.parametrize("entry", ["put_model", "model_from_numpy", "data_from_numpy"])
def test_default_device_is_the_card(entry):
    """An entry point called without a device targets the card; with no
    card it raises instead of running on the CPU."""
    call = {
        "put_model": lambda: tm.put_model(tm.load_snapshot())[1],
        "model_from_numpy": lambda: tm.model_from_numpy(
            {f.name: np.zeros(1) for f in dataclasses.fields(tm.Model)}
        ),
        "data_from_numpy": lambda: tm.data_from_numpy(
            {f.name: np.zeros(1) for f in dataclasses.fields(tm.Data)}
        ),
    }[entry]
    if torch.cuda.is_available():
        out = call()
        for f in dataclasses.fields(out):
            assert getattr(out, f.name).device.type == "cuda", f.name
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_port_imports_neither_jax_nor_mujoco():
    code = (
        "import sys\n"
        "import track_mjx_tpu_torch.physics.forward\n"
        "import track_mjx_tpu_torch.ops.cg_solver_kernel\n"
        "import track_mjx_tpu_torch.envs.wrappers, track_mjx_tpu_torch.envs.task.tracking\n"
        "import track_mjx_tpu_torch.envs.walker.rodent, track_mjx_tpu_torch.io.load\n"
        "import track_mjx_tpu_torch.io.synthetic, track_mjx_tpu_torch.agent.acting\n"
        "import track_mjx_tpu_torch.agent.ppo_factory, track_mjx_tpu_torch.agent.mlp_ppo.ppo_networks\n"
        "import track_mjx_tpu_torch.agent.network_masks, track_mjx_tpu_torch.testing\n"
        "import track_mjx_tpu_torch.train, track_mjx_tpu_torch.agent.preemption\n"
        "import track_mjx_tpu_torch.agent.wandb_logging, track_mjx_tpu_torch.utils.wandb_compat\n"
        "import track_mjx_tpu_torch.analysis.render, track_mjx_tpu_torch.analysis.software_render\n"
        "import track_mjx_tpu_torch.analysis.rollout, track_mjx_tpu_torch.analysis.utils\n"
        "import track_mjx_tpu_torch.physics.postconstraint, track_mjx_tpu_torch.envs.walker.stick\n"
        "import track_mjx_tpu_torch.parallel.mesh\n"
        "bad = [m for m in ('jax', 'flax', 'mujoco', 'yaml', 'h5py', 'track_mjx_tpu', 'matplotlib', 'sklearn',\n"
        "                   'imageio', 'IPython')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
