"""Shared helpers for the torch port's parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through the JAX package and
through the port; outputs are compared as numpy float64 arrays.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Tolerances, relative to max(1, max |reference|) like tests/test_cg_kernel_parity.py.
# Each stage is the same formula in both packages; only the order of f32 sums
# (torch vs XLA reductions, matmul vs multiply-reduce) differs.
STAGE_REL = 2e-5
# The solve amplifies roundoff by cond(M) ~ 6e5 and by the large D weights of
# the force rows; bars of tests/test_cg_kernel_parity.py (qacc_eff there:
# 5e-4, "measured 1.3e-4").
SOLVE_REL = {
    "qacc_smooth": 5e-5,
    "qacc": 1e-4,
    "efc_force": 1e-3,
    "qfrc_constraint": 1e-3,
    "qacc_eff": 5e-4,
}


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"shape {got.shape} != {want.shape}"
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max())) if want.size else 0.0


def assert_close(name: str, got, want, rel: float) -> float:
    """Asserts max |got - want| / max(1, max |want|) < rel; returns the error."""
    err = rel_err(got, want)
    assert err < rel, f"{name}: rel err {err:.3e} >= {rel:.1e}"
    return err


def load_export_tool():
    """tools/export_torch_model.py as a module (tools/ is not a package)."""
    path = os.path.join(REPO, "tools", "export_torch_model.py")
    spec = importlib.util.spec_from_file_location("export_torch_model", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def contact_rich_states(nq: int, nv: int, nu: int, qpos0, n_envs: int, seed: int):
    """Dropped and perturbed rodent states as tests/test_cg_kernel_parity.py
    makes them: (qpos, qvel, ctrl, warm) float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(qpos0, np.float64), (n_envs, 1))
    qpos[:, 2] -= rng.uniform(0.008, 0.016, n_envs)
    qpos[:, 7:] += rng.uniform(-0.08, 0.08, (n_envs, nq - 7))
    qvel = rng.uniform(-0.5, 0.5, (n_envs, nv))
    ctrl = rng.uniform(-0.5, 0.5, (n_envs, nu))
    warm = rng.uniform(-1.0, 1.0, (n_envs, nv))
    return tuple(np.asarray(a, np.float32) for a in (qpos, qvel, ctrl, warm))


def contact_rich_fly_states(m, n_envs: int, seed: int):
    """Fly states as tests/test_cg_kernel_parity.py makes them: legs dropped
    into the floor, joints perturbed, random qvel, ctrl and warmstart; the
    last two envs are static drops warm-started at MuJoCo C's qacc, which
    puts cone blocks in the static-friction (bottom) zone. (qpos, qvel,
    ctrl, warm) float32 numpy arrays; `m` is the live MjModel."""
    import mujoco

    rng = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0, (n_envs, 1))
    qpos[:, 2] -= rng.uniform(0.02, 0.12, n_envs)
    qpos[:, 7:] += rng.uniform(-0.10, 0.10, (n_envs, m.nq - 7))
    qvel = rng.uniform(-2.0, 2.0, (n_envs, m.nv))
    ctrl = rng.uniform(-0.3, 0.3, (n_envs, m.nu))
    warm = rng.uniform(-5.0, 5.0, (n_envs, m.nv))
    qpos[-2:] = m.qpos0
    qpos[-2:, 7:] += rng.uniform(-0.02, 0.02, (2, m.nq - 7))
    qpos[-2:, 2] -= [0.02, 0.04]
    qvel[-2:] = 0.0
    ctrl[-2:] = 0.0
    md = mujoco.MjData(m)
    for k in (-2, -1):
        md.qpos[:], md.qvel[:], md.ctrl[:] = qpos[k], qvel[k], ctrl[k]
        mujoco.mj_forward(m, md)
        warm[k] = md.qacc
    return tuple(np.asarray(a, np.float32) for a in (qpos, qvel, ctrl, warm))


def ell_objective_f64(qm, j, aref, d, mu, smooth, x, nl: int, fmin=None, fmax=None):
    """Per-env objective of the elliptic solve in float64: 0.5 dx M dx plus
    the scalar rows' and the cone blocks' costs, with dx = x - smooth.
    qm [B, n, n], j [B, e, n], aref and d [B, e], mu [B, nc] (mu_1 /
    sqrt(impratio)), smooth and x [B, n]; the first nl rows are scalar rows,
    unilateral, or bounded by fmin and fmax [e] where given (quadratic
    inside the force box, linear outside)."""
    qm, j, aref, d, mu, smooth, x = (
        np.asarray(t, np.float64) for t in (qm, j, aref, d, mu, smooth, x)
    )
    bsz = x.shape[0]
    dx = x - smooth
    jar = np.einsum("ben,bn->be", j, x) - aref
    jar_s, u = jar[:, :nl], jar[:, nl:].reshape(bsz, -1, 3)
    d_s, d_b = d[:, :nl], d[:, nl:].reshape(bsz, -1, 3)
    if fmin is None:
        cs = 0.5 * np.where(jar_s < 0, d_s * jar_s**2, 0.0).sum(1)
    else:
        lo, hi = (np.asarray(t, np.float64)[:nl] for t in (fmin, fmax))
        f_un = -d_s * jar_s
        f = np.clip(f_un, lo, hi)
        quad = (f_un > lo) & (f_un < hi)
        cs = np.where(quad, 0.5 * d_s * jar_s**2, -f * jar_s - 0.5 * f * f / np.maximum(d_s, 1e-12)).sum(1)
    p = -np.sqrt(d_b) * u
    t = np.sqrt(np.maximum(p[..., 1] ** 2 + p[..., 2] ** 2, 1e-24))
    bottom = mu * p[..., 0] >= t
    top = p[..., 0] <= -mu * t
    quad = 0.5 * (p * p).sum(-1)
    mid = quad - 0.5 * (t - mu * p[..., 0]) ** 2 / (1 + mu * mu)
    cb = np.where(bottom, quad, np.where(top, 0.0, mid)).sum(1)
    return 0.5 * np.einsum("bn,bnm,bm->b", dx, qm, dx) + cs + cb


def assert_plan_equal(a, b):
    """Every PhysicsPlan field of the port's plan `a` equals the JAX plan's."""
    import dataclasses

    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "pair_groups":
            assert len(x) == len(y)
            for gx, gy in zip(x, y):
                assert gx[:2] == gy[:2]
                np.testing.assert_array_equal(gx[2], gy[2])
                np.testing.assert_array_equal(gx[3], gy[3])
        elif f.name == "body_levels":
            assert len(x) == len(y)
            for lx, ly in zip(x, y):
                np.testing.assert_array_equal(lx, ly)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def rodent_full_clips_model():
    """The rodent MjModel compiled as the rodent-full-clips workload does."""
    return load_export_tool().workload_model("rodent-full-clips")


# ---------------------------------------------------------------------------
# env and agent layers: the JAX package's objects carried into the port
# ---------------------------------------------------------------------------

CLIP_FIELDS = (
    "position",
    "quaternion",
    "joints",
    "body_positions",
    "velocity",
    "angular_velocity",
    "joints_velocity",
    "body_quaternions",
)


def port_walker(jwalker, mj_model=None):
    """The port's walker with the JAX walker's index tables and model."""
    from track_mjx_tpu_torch.envs.walker.base import BaseWalker

    return BaseWalker(
        np.asarray(jwalker._joint_idxs),
        np.asarray(jwalker._body_idxs),
        np.asarray(jwalker._endeff_idxs),
        int(jwalker._torso_idx),
        mj_model=jwalker._mj_model if mj_model is None else mj_model,
        reproduce_joint_index_quirk=jwalker.reproduce_joint_index_quirk,
    )


def port_reward_config(jrc):
    """The port's RewardConfig with the JAX one's values."""
    import dataclasses

    from track_mjx_tpu_torch.envs.task.reward import RewardConfig

    vals = {f.name: getattr(jrc, f.name) for f in dataclasses.fields(RewardConfig)}
    vals["penalty_pos_distance_scale"] = np.asarray(vals["penalty_pos_distance_scale"]).tolist()
    return RewardConfig(**vals)


def port_clip(jclip):
    """The port's ReferenceClip (CPU) of a JAX ReferenceClip."""
    from track_mjx_tpu_torch.io.load import clip_from_numpy

    return clip_from_numpy({k: np.asarray(getattr(jclip, k)) for k in CLIP_FIELDS}, "cpu")


def jax_reset_draws(env, keys, noise_scale):
    """What the JAX MultiClipTracking.reset draws from each key of `keys`
    (start frame, clip index, qpos noise, qvel noise; tracking.py:567-579
    and :228-250, where rng1 is the start frame's key and serves both
    noises), as numpy arrays [B, ...]."""
    import jax

    nq, nv, n_clips = env.plan.nq, env.plan.nv, env._n_clips

    def draws(rng):
        _, start_rng, clip_rng = jax.random.split(rng, 3)
        start = jax.random.randint(start_rng, (), 0, 44)
        clip = jax.random.randint(clip_rng, (), 0, n_clips)
        _, rng1, _ = jax.random.split(rng, 3)
        lo, hi = -noise_scale, noise_scale
        return (
            start,
            clip,
            jax.random.uniform(rng1, (nq,), minval=lo, maxval=hi),
            jax.random.uniform(rng1, (nv,), minval=lo, maxval=hi),
        )

    return [np.asarray(x) for x in jax.vmap(draws)(keys)]


def jax_policy_noise(key, batch: int, latents: int, action_size: int):
    """The standard-normal draws of one stochastic step of the JAX
    package's intention policy under `key` (ppo_factory.py:109,
    intention.py:210 and :153): (latent noise, action noise)."""
    import jax

    key_sample, key_network = jax.random.split(key)
    _, sample_rng = jax.random.split(key_network)
    return (
        np.array(jax.random.normal(sample_rng, (batch, latents))),
        np.array(jax.random.normal(key_sample, (batch, action_size))),
    )


def to_torch(tree):
    """A JAX pytree of arrays (flax dataclasses, dicts) carried into the
    port on the CPU: jax arrays become tensors (float32, or int64 for
    integers), JAX SlimData, Data and ReferenceClip the port's."""
    import dataclasses

    import torch

    from track_mjx_tpu.io.load import ReferenceClip as JClip
    from track_mjx_tpu.physics import forward as jf
    from track_mjx_tpu.physics import model as jm
    from track_mjx_tpu_torch.io.load import clip_from_numpy
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm

    def leaf(x):
        a = np.array(x)
        if a.dtype.kind in "iu":
            return torch.as_tensor(a.astype(np.int64))
        return torch.as_tensor(a.astype(np.float32))

    if isinstance(tree, jf.SlimData):
        return tf.SlimData(**{f: leaf(getattr(tree, f)) for f in tf._CARRY_FIELDS})
    if isinstance(tree, jm.Data):
        return tm.data_from_numpy(
            {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(jm.Data)}, "cpu"
        )
    if isinstance(tree, JClip):
        return clip_from_numpy({k: np.asarray(getattr(tree, k)) for k in CLIP_FIELDS}, "cpu")
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (int, float)):
        return tree
    return leaf(tree)


def state_to_torch(jstate):
    """A batched JAX env State as the port's State (CPU)."""
    from track_mjx_tpu_torch.envs.base import State

    info = to_torch(dict(jstate.info))
    for k in ("reference_obs_size", "proprioceptive_obs_size"):
        if k in info:
            info[k] = int(np.asarray(jstate.info[k]).reshape(-1)[0])
    return State(
        pipeline_state=to_torch(jstate.pipeline_state),
        obs=to_torch(jstate.obs),
        reward=to_torch(jstate.reward),
        done=to_torch(jstate.done),
        metrics=to_torch(dict(jstate.metrics)),
        info=info,
    )


def per_env_rel(got, want) -> np.ndarray:
    """Per-env max |got - want| / max(1, max |want|) over all but the
    first axis."""
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    if want.shape[1] == 0:
        return np.zeros(len(want))
    return np.abs(got - want).max(1) / np.maximum(1.0, np.abs(want).max(1))


# flags whose value sits within this relative distance of their threshold
# may flip between two f32 computations of the same step
FLAG_MARGIN = 1e-4


def near_threshold(value, threshold) -> np.ndarray:
    value = np.asarray(value, np.float64)
    return np.abs(value - threshold) <= FLAG_MARGIN * max(abs(threshold), 1e-30)


FLAGS = {"too_far": "too_far_dist", "bad_pose": "bad_pose_dist", "bad_quat": "bad_quat_dist"}
FLAG_SOURCE = {"too_far": "summed_pos_distance", "bad_pose": "joint_distance", "bad_quat": "quat_distance"}


def assert_state_close(got, want, rel, what, reward_config=None, frame_rel=1e-6):
    """obs, reward, done, the 20 metrics and the step's info per env; flags
    equal except within FLAG_MARGIN of their threshold (returns how many
    envs that exempted). `rel` may be a number or a per-env array."""
    import dataclasses

    from track_mjx_tpu_torch.envs.task import tracking as tt

    rel = np.broadcast_to(np.asarray(rel, np.float64), (len(np.asarray(want.done)),))
    exempt = 0
    for name, g, w in (("obs", got.obs, want.obs), ("reward", got.reward, want.reward)):
        err = per_env_rel(g, np.asarray(w))
        assert (err < rel).all(), f"{what} {name}: {err} against {rel}"
    assert set(got.metrics) == set(want.metrics) == set(tt.METRIC_KEYS)
    flags = ("done", "too_far", "bad_pose", "bad_quat", "fall", "nan")
    for k in tt.METRIC_KEYS:
        w = np.asarray(want.metrics[k])
        g = got.metrics[k].numpy()
        if k in flags:
            keep = np.ones(len(w), bool)
            if k in FLAGS and reward_config is not None:
                near = near_threshold(want.metrics[FLAG_SOURCE[k]], getattr(reward_config, FLAGS[k]))
                keep &= ~near
                exempt += int(near.sum())
            np.testing.assert_array_equal(g[keep], w[keep], err_msg=f"{what} {k}")
        else:
            err = per_env_rel(g[:, None], w[:, None])
            assert (err < rel).all(), f"{what} {k}: {err} against {rel}"
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done), err_msg=f"{what} done")
    info_w = want.info
    for k in ("start_frame", "clip_idx", "buffer_index"):
        np.testing.assert_array_equal(got.info[k].numpy(), np.asarray(info_w[k]), err_msg=f"{what} {k}")
    for k in ("action_buffer", "prev_ctrl"):
        assert (per_env_rel(got.info[k], np.asarray(info_w[k])) < rel).all(), f"{what} {k}"
    for f in dataclasses.fields(got.info["reference_frame"]):
        if f.name in ("original_clip_idx", "body_quaternions"):
            continue  # not read after io: None and zeros in both packages
        g = getattr(got.info["reference_frame"], f.name)
        assert per_env_rel(g, np.asarray(getattr(info_w["reference_frame"], f.name))).max() < frame_rel, f.name
    return exempt


# ---------------------------------------------------------------------------
# the toy walker's tracking env in both packages
# ---------------------------------------------------------------------------


def toy_envs(noise: float = 1e-3, contact: bool = True, clip_length: int = 60):
    """`testing.make_toy_env(clip_length=..., contact=...)` and the port's
    MultiClipTracking on its clips, walker and reward config (CPU);
    `contact=False` is the toy walker without its contacts."""
    from track_mjx_tpu.testing import make_toy_env
    from track_mjx_tpu_torch.envs.task import tracking as tt
    from track_mjx_tpu_torch.physics import forward as tf

    tf.set_full_f32()
    jenv = make_toy_env(clip_length=clip_length, contact=contact)
    tenv = tt.MultiClipTracking(
        port_clip(jenv._reference_clips), port_walker(jenv.walker), port_reward_config(jenv._reward_config),
        physics_steps_per_control_step=jenv._n_frames, reset_noise_scale=noise, solver="cg", iterations=4,
        ls_iterations=4, mj_model_timestep=0.005, mocap_hz=50, clip_length=clip_length, random_init_range=10,
        traj_length=5, device="cpu",
    )
    return jenv, tenv


def fed_reset(env, draws):
    """`env` (the port's) resetting from given draws (the JAX reset's:
    start frame, clip, qpos noise, qvel noise) instead of a generator."""
    import torch

    from track_mjx_tpu_torch.envs.base import Wrapper

    class FedReset(Wrapper):
        def reset(self, rng, batch_size):
            start, clip, qn, vn = (torch.as_tensor(np.array(d)) for d in draws)
            return self.env.reset_from_clip(start.long(), qn, vn, clip_idx=clip.long())

    return FedReset(env)


# ---------------------------------------------------------------------------
# domain randomization: every Model leaf per env, by group
# ---------------------------------------------------------------------------

# The Model's 71 fields in the groups that the domain randomization tests
# randomize together (each group's leaves per env, the others equal)
DR_GROUPS = {
    "kinematic": ("body_pos", "body_quat", "jnt_pos", "jnt_axis", "qpos0", "body_ipos", "body_iquat", "geom_pos",
                  "geom_quat", "site_pos", "site_quat"),
    "inertial": ("body_mass", "body_inertia", "dof_armature", "body_subtreemass", "body_invweight0",
                 "dof_invweight0", "tendon_invweight0"),
    "joint_dof": ("jnt_range", "jnt_stiffness", "jnt_solref", "jnt_solimp", "jnt_margin", "qpos_spring", "dof_damping",
                  "dof_frictionloss", "dof_solref_fri", "dof_solimp_fri"),
    "geom_contact": ("geom_size", "geom_friction", "geom_solref", "geom_solimp", "geom_solmix", "geom_margin",
                     "geom_gap", "geom_priority"),
    "actuator": ("actuator_gear0", "actuator_len_mat", "actuator_len_const", "actuator_moment", "actuator_dynprm",
                 "actuator_gainprm", "actuator_biasprm", "actuator_ctrlrange", "actuator_forcerange",
                 "actuator_actrange", "actuator_ctrllimited", "actuator_forcelimited", "actuator_actlimited",
                 "actuator_acc0"),
    "tendon_equality": ("tendon_moment", "tendon_length_mat", "tendon_length0_const", "tendon_length0",
                        "tendon_frictionloss", "tendon_solref_fri", "tendon_solimp_fri", "tendon_stiffness",
                        "tendon_damping", "tendon_lengthspring", "eq_data", "eq_solref", "eq_solimp"),
    "opt": ("opt_timestep", "opt_gravity", "opt_tolerance", "opt_ls_tolerance", "opt_impratio", "opt_density",
            "opt_viscosity", "opt_wind"),
}


def randomized_leaves(shared: dict, names, n_envs: int, seed: int, scalar_qpos) -> dict:
    """Per-env numpy leaves [n_envs] + shape for `names` from the shared
    leaves `shared` (name -> array), drawn from `seed`: scales of U(0.9,
    1.1) and the like, in the manner of sim-to-real randomizers, each leaf
    kept valid (unit quaternions and joint axes, ordered ranges, solimp in
    (0, 1)). `scalar_qpos` are the qpos indices of hinge and slide joints,
    the only ones whose qpos0 and qpos_spring are jittered."""
    rng = np.random.RandomState(seed)

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, (n_envs,) + tuple(shape))

    def unit(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    out = {}
    for name in names:
        x = np.asarray(shared[name], np.float64)
        rows = x.shape[:1]
        tiled = np.broadcast_to(x, (n_envs,) + x.shape).copy()
        if name in ("body_quat", "body_iquat", "geom_quat", "site_quat"):
            v = tiled + np.concatenate([np.zeros((n_envs,) + rows + (1,)), u(-0.02, 0.02, rows + (3,))], -1)
            y = unit(v)
        elif name == "jnt_axis":
            y = unit(tiled + u(-0.02, 0.02, x.shape))
        elif name in ("body_pos", "body_ipos", "jnt_pos", "geom_pos", "site_pos"):
            y = tiled * u(0.98, 1.02, x.shape) + u(-1e-4, 1e-4, x.shape)
        elif name in ("qpos0", "qpos_spring"):
            y = tiled
            y[:, scalar_qpos] += u(-0.05, 0.05, (len(scalar_qpos),))
        elif name == "body_inertia":
            y = tiled * u(0.9, 1.1, rows + (1,))  # the three moments alike: the triangle inequality holds
        elif name == "dof_armature":
            y = tiled * u(1.0, 1.05, x.shape) + u(0.0, 0.05, x.shape) * max(float(x.max()), 1e-3)
        elif name in ("jnt_range", "actuator_ctrlrange", "actuator_forcerange", "actuator_actrange",
                      "tendon_lengthspring"):
            y = tiled * u(0.9, 1.1, rows + (1,))  # both ends alike: the range stays ordered
        elif name.endswith("solimp") or name.endswith("solimp_fri"):
            y = tiled.copy()
            y[..., :2] *= u(0.97, 1.0, rows + (1,))  # dmin <= dmax < 1
            y[..., 2] *= u(0.9, 1.1, rows)
        elif name in ("jnt_margin", "geom_margin"):
            y = tiled + u(0.0, 1e-4, x.shape)
        elif name == "geom_priority":
            y = tiled + (u(0, 1, x.shape) < 0.3)
        elif name in ("actuator_ctrllimited", "actuator_forcelimited", "actuator_actlimited"):
            y = np.where(u(0, 1, x.shape) < 0.3, 1.0 - tiled, tiled)
        elif name in ("actuator_len_mat", "actuator_moment", "actuator_gear0"):
            y = tiled * u(0.9, 1.1, rows + (1,) * (x.ndim - 1))
        elif name == "eq_data":
            y = tiled + u(-0.01, 0.01, x.shape)
        elif name == "opt_gravity":
            y = tiled * u(0.9, 1.1, ()) [..., None] + np.concatenate([u(-0.3, 0.3, (2,)), np.zeros((n_envs, 1))], -1)
        elif name == "opt_wind":
            y = tiled + u(-0.1, 0.1, x.shape)
        elif name == "opt_tolerance":
            y = tiled * 10.0 ** u(-1.0, 1.0, x.shape)
        else:  # positive scales: masses, damping, stiffness, frictionloss, solref, invweights, gains, ...
            y = tiled * u(0.9, 1.1, x.shape)
        out[name] = y.astype(np.float32)
    return out


def scalar_qpos_ids(plan) -> np.ndarray:
    """qpos indices of the plan's hinge and slide joints."""
    scalar = (plan.jnt_type == 2) | (plan.jnt_type == 3)
    return np.asarray(plan.jnt_qposadr[scalar], np.int64)
