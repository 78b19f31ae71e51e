"""Domain randomization of every Model leaf: the port's
`DomainRandomizationVmapWrapper` against the JAX package's, on the CPU, and
the port's per-env leaves against its own shared ones.

The leaves come in seven groups (torch_parity.DR_GROUPS: kinematic,
inertial with the armature, joint and dof, geom and contact, actuator,
tendon and equality, opt_*); a case randomizes one group per env
(torch_parity.randomized_leaves, numpy from a seed) and leaves the others
equal. Each model's JAX reset and step are compiled once, every one of the
71 leaves given in_axes 0, and only the values change between cases (the
JAX package takes its plain per-env solve on the CPU). The port's reset from
the JAX reset's draws is held to the JAX reset (obs, the forward's smooth
forces and qacc_smooth, RESET_BARS), then one control step from the JAX
reset state:

- the toy walker's tracking env: obs and reward within DR_REL, qacc and
  efc_force (at the reset and after the step) within the solve's bars;
- the rodent's (rodent-full-clips): obs and reward per env within
  SELF_FACTOR times the JAX package's own response to a 1e-6 relative
  change of qvel, plus SELF_FLOOR (test_torch_rodent_env.py), its reset's
  qacc and efc_force within that file's reset bar;
- the fly's (fly-mc-intention, one substep a control step: FLY_B): obs,
  reward, qacc and efc_force, the median env's distance to the port's
  float64 step within VS_F64 times the JAX float32 step's, plus F64_FLOOR
  (test_torch_fly_env.py);
- the tendon-equality and frictionloss probes of tests/test_equality.py
  (physics only, one step): qpos, qvel, qacc and efc_force within the
  solve's bars.

The port alone: a model whose every leaf is expanded to [B] with equal
values steps as the shared model does; the qM assembly and the fused
solves' operands take a per-env armature with B >= nv (each env's own).
"""

import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import test_equality as te
import torch_parity
from torch_parity import (
    DR_GROUPS,
    SOLVE_REL,
    STAGE_REL,
    fed_reset,
    jax_reset_draws,
    per_env_rel,
    port_clip,
    port_reward_config,
    randomized_leaves,
    scalar_qpos_ids,
    state_to_torch,
)
from track_mjx_tpu.envs import wrappers as jwrappers
from track_mjx_tpu.envs.task.reward import RewardConfig
from track_mjx_tpu.envs.task.tracking import MultiClipTracking as JaxMultiClip
from track_mjx_tpu.io.synthetic import synthesize_clips
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.utils.config import load_config
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.envs.base import map_tensors
from track_mjx_tpu_torch.envs.task import tracking as tt
from track_mjx_tpu_torch.envs.walker.fly import Fly
from track_mjx_tpu_torch.envs.walker.rodent import Rodent
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver

torch.set_num_threads(1)
B = 4
# The fly steps one physics substep a control step here (its env_args'
# physics_steps_per_control_step 1, ten control steps a 500 Hz frame): over
# the config's ten substeps the elliptic linesearch's knife edge parts
# float32 runs by O(1e-3-1) on most envs (test_torch_fly_env.py), so the
# median env of a few, port against JAX, swings by 3x either way with no
# randomization at all (0.41x-2.67x over four seeds of 16 envs); over one
# substep it parts about one env in twenty, and the median env is roundoff.
FLY_B = 8
GROUPS = tuple(DR_GROUPS)
CLIP = dict(clip_length=60, random_init_range=5, traj_length=5)
# the toy's obs and reward (test_torch_trainer_options.py's DR_REL), its
# qacc and efc_force after the control step (the solve's bars, SOLVE_REL)
DR_REL = 1e-5
# the rodent's whole step (test_torch_rodent_env.py)
SELF_FACTOR = 10.0
SELF_FLOOR = 1e-4
# the fly's whole step against the port's float64 step (test_torch_fly_env.py)
VS_F64 = 3.0
F64_FLOOR = 1e-6
# The reset under the randomized model, the port's from the JAX reset's
# draws: obs (kinematics; test_torch_rodent_env.py's LAYER_REL), the smooth
# forces of the forward (STAGE_REL) and qacc_smooth (the solve's bar); the
# rodent's qacc and efc_force within test_torch_rodent_env.py's reset bar.
# The fly's solve is a knife edge (test_torch_fly_env.py), held after the
# step through obs and reward.
RESET_BARS = dict(obs=1e-5, qfrc_bias=STAGE_REL, qfrc_passive=STAGE_REL, qfrc_actuator=STAGE_REL,
                  qacc_smooth=SOLVE_REL["qacc_smooth"])
RODENT_RESET_SOLVED = dict(qacc=1e-3, efc_force=1e-3)
STEP_FIELDS = ("qacc", "efc_force")
PROBES = {"tendon": te.TENDON_XML, "friction": te.FRICTION_XML}


def _jax_leaves(jmodel) -> dict:
    return {f.name: np.asarray(getattr(jmodel, f.name)) for f in dataclasses.fields(tm.Model)}


def _jax_model_v(jmodel, leaves: dict, names, n: int = B):
    """The JAX Model with every leaf [n] + shape: `leaves` for `names`,
    the shared value tiled for the others."""
    return jmodel.replace(**{
        f.name: jnp.asarray(leaves[f.name]) if f.name in names
        else jnp.broadcast_to(getattr(jmodel, f.name), (n,) + getattr(jmodel, f.name).shape)
        for f in dataclasses.fields(tm.Model)
    })


def _port_randomizer(leaves: dict, names, dtype=torch.float32):
    def randomize(model):
        return dataclasses.replace(
            model, **{n: torch.as_tensor(leaves[n]).to(dtype) for n in names}
        ), tuple(names)

    return randomize


class _JaxEnvRun:
    """The JAX package's Episode -> DomainRandomization stack over `jenv`,
    reset and one step under a per-env model in one jit (every leaf in_axes
    0): run(model_v, keys, action, scale) -> (reset state, the state after a
    step from the reset state with qvel times `scale`)."""

    def __init__(self, jenv, n: int = B):
        self.jenv, self.base = jenv, jenv.model
        tiled = _jax_model_v(jenv.model, {}, (), n)
        in_axes = jax.tree.map(lambda _: 0, jenv.model)
        self.wrapped = jwrappers.DomainRandomizationVmapWrapper(
            jwrappers.EpisodeWrapper(jenv, episode_length=5, action_repeat=1), lambda m: (tiled, in_axes))

        def run(model_v, keys, action, scale):
            self.wrapped._model_v = model_v
            s0 = self.wrapped.reset(keys)
            s1 = s0.replace(pipeline_state=s0.pipeline_state.replace(qvel=s0.pipeline_state.qvel * scale))
            return s0, self.wrapped.step(s1, action)

        self.jit = jax.jit(run)

    def __call__(self, model_v, keys, action, scale=1.0):
        try:
            return self.jit(model_v, keys, action, np.float32(scale))
        finally:
            self.jenv.model = self.base  # the JAX wrapper leaves the traced model in the env


def _walker_case(jenv, tenv, group: str, seed: int, action_scale: float, n: int = B):
    """One case on a tracking env of n envs: the group's names, the per-env
    leaves, the reset keys and the JAX reset's draws, the actions and the
    port's wrapped env."""
    names = list(DR_GROUPS[group])
    leaves = randomized_leaves(_jax_leaves(jenv.model), names, n, seed, scalar_qpos_ids(tenv.plan))
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    draws = jax_reset_draws(jenv, keys, tenv._reset_noise_scale)
    action = (action_scale * np.random.RandomState(seed).uniform(-1, 1, (n, tenv.action_size))).astype(np.float32)
    twrapped = wrappers.DomainRandomizationVmapWrapper(
        wrappers.EpisodeWrapper(fed_reset(tenv, draws), episode_length=5, action_repeat=1),
        _port_randomizer(leaves, names))
    return names, leaves, keys, draws, action, twrapped


def _assert_reset(twrapped, jreset, what, solved=None):
    """The port's reset from the JAX reset's draws on the per-env model
    against the JAX reset (RESET_BARS): obs, the forward's smooth
    stages within STAGE_REL (qacc_smooth within the solve's bar); with
    `solved` its qacc and efc_force within that bar too."""
    got = twrapped.reset(None, jreset.obs.shape[0])
    bars = dict(RESET_BARS, **(solved or {}))
    for name, bar in bars.items():
        g = got.obs if name == "obs" else getattr(got.pipeline_state, name)
        w = jreset.obs if name == "obs" else getattr(jreset.pipeline_state, name)
        err = per_env_rel(g.reshape(g.shape[0], -1), np.asarray(w).reshape(g.shape[0], -1))
        assert (err < bar).all(), f"{what} reset {name}: {err} against {bar}"


# the whole control step's outputs held on the rodent and the fly, by the
# rules of test_torch_rodent_env.py and test_torch_fly_env.py (their qacc and
# efc_force after ten substeps part by O(1e-3-1) between two float32 runs:
# they are held at the reset's forward, and the toy's after the step)
STEP_OUTPUTS = ("obs", "reward")


def _fields(state, names=("obs", "reward") + STEP_FIELDS):
    ps = state.pipeline_state
    return {n: getattr(state, n) if n in ("obs", "reward") else getattr(ps, n) for n in names}


# ---------------------------------------------------------------------------
# fixtures: each model's JAX run compiled once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy():
    jenv, tenv = torch_parity.toy_envs()
    return jenv, tenv, _JaxEnvRun(jenv)


def _tracking_pair(config: str, walker, mocap_hz: int, n: int = B, **env_kw):
    """The JAX package's and the port's multi-clip tracking env of
    `config` (env_args updated by `env_kw`) on the same synthetic clips, and
    the JAX run of n envs."""
    cfg = load_config(config)
    env_args = dict(cfg.env_config.env_args, **env_kw)
    jwalker = torch_parity.load_export_tool().workload_walker(config)
    clips = synthesize_clips(jwalker._mj_model, n_clips=2, n_frames=CLIP["clip_length"], mocap_hz=mocap_hz)
    jenv = JaxMultiClip(clips, jwalker, RewardConfig(**dict(cfg.env_config.reward_weights)), **env_args, **CLIP)
    tenv = tt.MultiClipTracking(port_clip(clips), walker, port_reward_config(jenv._reward_config), **env_args,
                                **CLIP, device="cpu")
    return jenv, tenv, _JaxEnvRun(jenv, n)


@pytest.fixture(scope="module")
def rodent():
    tf.set_full_f32()
    return _tracking_pair("rodent-full-clips", Rodent.from_snapshot(tm.load_snapshot("rodent-full-clips")), 50)


@pytest.fixture(scope="module")
def fly():
    tf.set_full_f32()
    return _tracking_pair("fly-mc-intention", Fly.from_snapshot(), 500, FLY_B, physics_steps_per_control_step=1)


@pytest.fixture(scope="module")
def probes():
    """Per probe: the MuJoCo model, B states (test_equality's draws), the
    JAX step vmapped over a per-env model and the states, jitted once."""
    out = {}
    for name, xml in PROBES.items():
        m = mujoco.MjModel.from_xml_string(xml)
        cs = [te._c_state(xml, seed=s) for s in range(B)]
        qpos = np.array([d.qpos for _, d in cs], np.float32)
        qvel = np.array([d.qvel for _, d in cs], np.float32)
        jplan, jmodel = jm.put_model(m)

        def step(model, q, v, jplan=jplan):
            d = jm.make_data(jplan, model).replace(qpos=q, qvel=v)
            with jax.default_matmul_precision("highest"):
                return jf.step(jplan, model, d)

        out[name] = (m, jmodel, qpos, qvel, jax.jit(jax.vmap(step)))
    return out


# ---------------------------------------------------------------------------
# the port against the JAX package, by leaf group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", GROUPS)
def test_toy_group_matches_jax(toy, group):
    jenv, tenv, jrun = toy
    names, leaves, keys, _, action, twrapped = _walker_case(jenv, tenv, group, 11, 0.3)
    jreset, jnext = jrun(_jax_model_v(jenv.model, leaves, names), keys, action)
    _assert_reset(twrapped, jreset, f"toy {group}", {k: SOLVE_REL[k] for k in STEP_FIELDS})
    got = _fields(twrapped.step(state_to_torch(jreset), torch.as_tensor(action)))
    want = _fields(jnext)
    bars = dict(obs=DR_REL, reward=DR_REL, **{k: SOLVE_REL[k] for k in STEP_FIELDS})
    for name, bar in bars.items():
        err = per_env_rel(got[name].reshape(B, -1), np.asarray(want[name]).reshape(B, -1))
        assert (err < bar).all(), f"toy {group} {name}: {err} against {bar}"


@pytest.mark.parametrize("group", GROUPS)
def test_rodent_group_matches_jax(rodent, group):
    jenv, tenv, jrun = rodent
    names, leaves, keys, _, action, twrapped = _walker_case(jenv, tenv, group, 12, 0.005)
    model_v = _jax_model_v(jenv.model, leaves, names)
    jreset, jnext = jrun(model_v, keys, action)
    _, nudged = jrun(model_v, keys, action, 1 + 1e-6)
    _assert_reset(twrapped, jreset, f"rodent {group}", RODENT_RESET_SOLVED)
    got = _fields(twrapped.step(state_to_torch(jreset), torch.as_tensor(action)), STEP_OUTPUTS)
    want, moved = _fields(jnext, STEP_OUTPUTS), _fields(nudged, STEP_OUTPUTS)
    # the JAX step's own response, per env (test_torch_rodent_env.py)
    sensitivity = np.maximum.reduce([
        per_env_rel(np.asarray(moved[name]).reshape(B, -1), np.asarray(want[name]).reshape(B, -1)) for name in got])
    bar = SELF_FACTOR * sensitivity + SELF_FLOOR
    for name in got:
        err = per_env_rel(got[name].reshape(B, -1), np.asarray(want[name]).reshape(B, -1))
        assert (err < bar).all(), f"rodent {group} {name}: {err} against {bar}"
    assert (np.asarray(jnext.pipeline_state.contact_dist) < 0).any()  # contacts act


@pytest.mark.parametrize("group", GROUPS)
def test_fly_group_matches_jax(fly, group):
    jenv, tenv, jrun = fly
    names, leaves, keys, draws, action, twrapped = _walker_case(jenv, tenv, group, 13, 0.5, FLY_B)
    jreset, jnext = jrun(_jax_model_v(jenv.model, leaves, names, FLY_B), keys, action)
    _assert_reset(twrapped, jreset, f"fly {group}")
    start = state_to_torch(jreset)
    got = _fields(twrapped.step(start, torch.as_tensor(action)))
    pack32 = tenv._pack
    model32 = tenv.model
    try:
        tenv.model = tm.Model(**{f: getattr(model32, f).double() for f in tm.LEAF_RANK})
        tenv._pack = pack32.double()
        wrapped64 = wrappers.DomainRandomizationVmapWrapper(
            wrappers.EpisodeWrapper(fed_reset(tenv, draws), episode_length=5, action_repeat=1),
            _port_randomizer(leaves, names, torch.float64))
        ref = _fields(wrapped64.step(map_tensors(lambda t: t.double() if t.is_floating_point() else t, start),
                                     torch.as_tensor(action).double()))
    finally:
        tenv.model, tenv._pack = model32, pack32
    want = _fields(jnext)
    for name in got:
        r = ref[name].numpy().reshape(FLY_B, -1)
        port = np.median(per_env_rel(got[name].numpy().reshape(FLY_B, -1), r))
        jax_f32 = np.median(per_env_rel(np.asarray(want[name]).reshape(FLY_B, -1), r))
        assert port <= VS_F64 * jax_f32 + F64_FLOOR, f"fly {group} {name}: {port:.3e} against the JAX step's {jax_f32:.3e}"


@pytest.mark.parametrize("group", GROUPS)
def test_probe_group_matches_jax(probes, group):
    """The tendon-equality and frictionloss probes, physics only: one step
    of B states on per-env leaves."""
    names = DR_GROUPS[group]
    for probe, (m, jmodel, qpos, qvel, jstep) in probes.items():
        plan, model = tm.put_model(m, device="cpu")
        leaves = randomized_leaves(_jax_leaves(jmodel), names, B, 14, scalar_qpos_ids(plan))
        want = jstep(_jax_model_v(jmodel, leaves, names), qpos, qvel)
        model_v = _port_randomizer(leaves, names)(model)[0]
        got = tf.step(plan, model_v, tm.make_data(plan, model_v, B).replace(
            qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel)))
        for name in ("qacc", "efc_force", "qpos", "qvel"):
            bar = SOLVE_REL.get(name, SOLVE_REL["qacc"])
            err = per_env_rel(getattr(got, name), np.asarray(getattr(want, name)))
            assert (err < bar).all(), f"probe {probe} {group} {name}: {err} against {bar}"


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", ["toy", "rodent-full-clips"])
def test_every_leaf_expanded_equal_steps_as_shared(config):
    """Every leaf [B] with equal values (each stage's per-env form) against
    the shared model (its form as before): bitwise on the toy over two
    substeps; on the rodent over one substep within the solve's bars
    (SOLVE_REL["qacc"], efc_force SOLVE_REL["efc_force"]), since a per-env
    product sums in another order than the shared one (the subtree masses:
    a batch of matrix-vector products against one) and cond(M) carries
    that roundoff into the solve: measured qacc_smooth 4.3e-6, qvel 3.7e-6,
    efc_force 1.1e-6, qacc 5.0e-7."""
    tf.set_full_f32()
    if config == "toy":
        tenv = torch_parity.toy_envs()[1]
        plan, model = tenv.plan, tenv.model
    else:
        plan, model = tm.put_model(tm.load_snapshot(config), device="cpu")
    rng = np.random.RandomState(5)
    start = dict(qpos=model.qpos0.expand(B, -1).clone(),
                 qvel=torch.as_tensor(rng.uniform(-0.3, 0.3, (B, plan.nv)), dtype=torch.float32),
                 ctrl=torch.as_tensor(rng.uniform(-0.2, 0.2, (B, plan.nu)), dtype=torch.float32))
    start["qpos"][:, 2] -= 0.01  # in contact with the floor
    model_v = dataclasses.replace(model, **{
        f: getattr(model, f).expand((B,) + getattr(model, f).shape).clone() for f in tm.LEAF_RANK})
    substeps = 2 if config == "toy" else 1
    shared = tf.n_step(plan, model, tm.make_data(plan, model, B).replace(**start), substeps)
    per_env = tf.n_step(plan, model_v, tm.make_data(plan, model_v, B).replace(**start), substeps)
    assert (shared.contact_dist < 0).any(1).all()
    for name in ("qpos", "qvel", "qacc", "qacc_smooth", "efc_force", "sensordata", "act"):
        a, b = getattr(per_env, name), getattr(shared, name)
        if config == "toy":
            assert torch.equal(a, b), name
        else:
            bar = SOLVE_REL["efc_force" if name == "efc_force" else "qacc"]
            assert per_env_rel(a, b.numpy()).max() < bar, name


def test_assemble_qm_takes_an_armature_per_env():
    """B >= nv: each env's qM gets its own armature on the diagonal (a
    [B, n] armature through torch.diag gave the matrix's diagonal instead,
    spread over qM's rows)."""
    gen = torch.Generator().manual_seed(0)
    n, bsz = 5, 7
    buf, cdof = torch.randn(bsz, n, 6, generator=gen), torch.randn(bsz, n, 6, generator=gen)
    anc = torch.tril(torch.ones(n, n))
    arm = torch.rand(bsz, n, generator=gen)
    got = tk.assemble_qm(buf, cdof, anc, arm)
    for i in range(bsz):
        want = tk.assemble_qm(buf[i : i + 1], cdof[i : i + 1], anc, arm[i])[0]
        assert torch.equal(got[i], want), i
    added = got - tk.assemble_qm(buf, cdof, anc, torch.zeros(n))
    assert torch.allclose(torch.diagonal(added, dim1=-2, dim2=-1), arm, rtol=0, atol=1e-5)
    assert torch.equal(added - torch.diag_embed(torch.diagonal(added, dim1=-2, dim2=-1)), torch.zeros(bsz, n, n))


def test_solver_operands_take_an_armature_per_env():
    """solver._common_inputs with B >= nv: each env's tolerance scale adds
    its own armature's trace (arm.sum() added every env's), and the solve
    operands carry the [B, nv] armature."""
    tf.set_full_f32()
    tenv = torch_parity.toy_envs()[1]
    plan, model = tenv.plan, tenv.model
    bsz = plan.nv + 2
    arm = torch.rand(bsz, plan.nv, generator=torch.Generator().manual_seed(1))
    model_v = dataclasses.replace(model, dof_armature=arm)
    d = tm.make_data(plan, model_v, bsz).replace(
        qvel=torch.full((bsz, plan.nv), 0.1))
    d, efc = tf.fwd_position(plan, model_v, d)
    got = tsolver._common_inputs(plan, model_v, d, efc)
    trace = (d.crb_buf * d.cdof).sum((-2, -1))
    for i in range(bsz):
        one = dataclasses.replace(model, dof_armature=arm[i])
        want = tsolver._common_inputs(plan, one, d, efc)
        assert torch.equal(got["tolscale"][i], want["tolscale"][i]), i
        assert torch.equal(got["hd"][i], want["hd"][i]), i
        assert torch.equal(got["arm"][i], arm[i])
    assert torch.allclose(got["tolscale"], model.opt_tolerance * (trace + arm.sum(-1)))
