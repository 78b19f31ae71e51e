"""Host-side model packing: compiled model -> (PhysicsPlan, Model) + Data.

Port of track_mjx_tpu/physics/model.py. The plan compile is the same host-side
numpy code; `Model` and `Data` are dataclasses of torch tensors instead of JAX
pytrees. `Data` leaves are batch-first, [B, ...]. A `Model` leaf has the
shape that `put_model` gives it (its rank is `LEAF_RANK`'s) and is shared by
every env, or it is per env: one more dimension, [B] + that shape, as the
domain randomization wrapper sets it (envs/wrappers.py). Any of the 71
leaves may be per env, each on its own. A stage reads a leaf through the
helpers below, which leave a shared leaf's arithmetic as it was:
`take(model, name, ids)` indexes its first own axis (`leaf[ids]`, per env
`leaf[:, ids]`), `env_view(model, name, ndim)` lines it up against a
batch-first tensor of `ndim` dims ending in its own shape (a per-env scalar
[B] becomes [B, 1] against [B, n]), and `mat_vec` / `vec_mat` apply a
matrix leaf to a batch of vectors (a per-env matrix by a batched product).
Quantities derived from per-env leaves carry the env axis first and are
indexed from the end (`x[..., ids]`).

`put_model` reads either a live `mujoco.MjModel` or a compiled-model
snapshot that `tools/export_torch_model.py` writes (`load_snapshot`; one per
workload config: rodent-full-clips, fly-mc-intention, rodent-sps-per-actor),
so the port runs where MuJoCo is not installed. MuJoCo enum values are plain int constants
here.

Tensors go to the CUDA device unless the caller names another one: a CPU run
passes `device="cpu"`, and a call that names no device on a machine without
a card raises.
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Any, Mapping

import numpy as np
import torch

# MuJoCo enum values (stable ABI).
JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE = 0, 1, 2, 3
GEOM_PLANE, GEOM_HFIELD, GEOM_SPHERE, GEOM_CAPSULE = 0, 1, 2, 3
GEOM_ELLIPSOID, GEOM_CYLINDER, GEOM_BOX, GEOM_MESH = 4, 5, 6, 7
TRN_JOINT, TRN_TENDON = 0, 3
DYN_NONE, DYN_INTEGRATOR, DYN_FILTER, DYN_FILTEREXACT = 0, 1, 2, 3
GAIN_FIXED, GAIN_AFFINE, GAIN_MUSCLE = 0, 1, 2
BIAS_NONE, BIAS_AFFINE, BIAS_MUSCLE = 0, 1, 2
SOLVER_PGS, SOLVER_CG, SOLVER_NEWTON = 0, 1, 2
INT_EULER, INT_RK4, INT_IMPLICIT, INT_IMPLICITFAST = 0, 1, 2, 3
CONE_PYRAMIDAL, CONE_ELLIPTIC = 0, 1
EQ_CONNECT, EQ_WELD, EQ_JOINT, EQ_TENDON = 0, 1, 2, 3
OBJ_BODY, OBJ_SITE = 1, 6
WRAP_JOINT = 1

# the benchmark's own copies of the configurations' compiled-model snapshots
_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "configs")
# workload config name -> compiled-model snapshot
SNAPSHOTS = {name: os.path.join(_ASSETS, name + ".npz") for name in ("rodent-sps-per-actor", "fly-mc-intention")}
WALKER_SNAPSHOTS = {}
PROBE_SNAPSHOTS = {}


def _device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device when there is no
    card, so that no caller runs on the CPU without asking for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True, eq=False)
class PhysicsPlan:
    """Static physics structure (host numpy and Python ints). Hash/eq by
    identity: one plan per model build, and per-plan device tables are cached
    on it by identity."""

    nq: int
    nv: int
    nu: int
    na: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    ntendon: int
    nsensor: int
    nsensordata: int
    ncon: int
    nefc: int
    ne: int
    nf: int
    nlimit: int
    ncon_ell: int
    eq_connect: tuple
    eq_weld: tuple
    eq_joint: tuple
    eq_tendon: tuple
    friction_dof_ids: np.ndarray
    friction_tendon_ids: np.ndarray
    body_parentid: np.ndarray
    body_rootid: np.ndarray
    body_jntadr: np.ndarray
    body_jntnum: np.ndarray
    body_dofadr: np.ndarray
    body_dofnum: np.ndarray
    body_geomadr: np.ndarray
    body_geomnum: np.ndarray
    body_levels: tuple
    jnt_type: np.ndarray
    jnt_qposadr: np.ndarray
    jnt_dofadr: np.ndarray
    jnt_bodyid: np.ndarray
    jnt_limited: np.ndarray
    limited_jnt_ids: np.ndarray
    dof_bodyid: np.ndarray
    dof_jntid: np.ndarray
    dof_parentid: np.ndarray
    ancestry_mask: np.ndarray
    geom_bodyid: np.ndarray
    geom_type: np.ndarray
    site_bodyid: np.ndarray
    pair_groups: tuple
    ncon_per_pair_type: dict
    condim: int
    contact_condim: np.ndarray
    actuator_trntype: np.ndarray
    actuator_dyntype: np.ndarray
    actuator_gaintype: np.ndarray
    actuator_biastype: np.ndarray
    sensor_type: np.ndarray
    sensor_objtype: np.ndarray
    sensor_objid: np.ndarray
    sensor_adr: np.ndarray
    sensor_dim: np.ndarray
    integrator: int
    solver: int
    cone: int
    iterations: int
    ls_iterations: int
    disableflags: int
    fluid_active: bool
    tendon_passive_active: bool

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass(frozen=True)
class Model:
    """Numeric model parameters, torch tensors on one device: each shared by
    every env, or per env with a leading env axis (module docstring)."""

    opt_timestep: torch.Tensor
    opt_gravity: torch.Tensor
    opt_tolerance: torch.Tensor
    opt_ls_tolerance: torch.Tensor
    opt_impratio: torch.Tensor
    opt_density: torch.Tensor
    opt_viscosity: torch.Tensor
    opt_wind: torch.Tensor
    qpos0: torch.Tensor
    qpos_spring: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    body_subtreemass: torch.Tensor
    body_invweight0: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_range: torch.Tensor
    jnt_stiffness: torch.Tensor
    jnt_solref: torch.Tensor
    jnt_solimp: torch.Tensor
    jnt_margin: torch.Tensor
    dof_damping: torch.Tensor
    dof_armature: torch.Tensor
    dof_invweight0: torch.Tensor
    dof_frictionloss: torch.Tensor
    dof_solref_fri: torch.Tensor
    dof_solimp_fri: torch.Tensor
    eq_data: torch.Tensor
    eq_solref: torch.Tensor
    eq_solimp: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_friction: torch.Tensor
    geom_solref: torch.Tensor
    geom_solimp: torch.Tensor
    geom_solmix: torch.Tensor
    geom_margin: torch.Tensor
    geom_gap: torch.Tensor
    geom_priority: torch.Tensor
    site_pos: torch.Tensor
    site_quat: torch.Tensor
    tendon_moment: torch.Tensor
    tendon_length_mat: torch.Tensor
    tendon_length0_const: torch.Tensor
    tendon_length0: torch.Tensor
    tendon_invweight0: torch.Tensor
    tendon_frictionloss: torch.Tensor
    tendon_solref_fri: torch.Tensor
    tendon_solimp_fri: torch.Tensor
    tendon_stiffness: torch.Tensor
    tendon_damping: torch.Tensor
    tendon_lengthspring: torch.Tensor
    actuator_gear0: torch.Tensor
    actuator_len_mat: torch.Tensor
    actuator_len_const: torch.Tensor
    actuator_moment: torch.Tensor
    actuator_dynprm: torch.Tensor
    actuator_gainprm: torch.Tensor
    actuator_biasprm: torch.Tensor
    actuator_ctrlrange: torch.Tensor
    actuator_forcerange: torch.Tensor
    actuator_actrange: torch.Tensor
    actuator_ctrllimited: torch.Tensor
    actuator_forcelimited: torch.Tensor
    actuator_actlimited: torch.Tensor
    actuator_acc0: torch.Tensor


# Each Model leaf's rank as put_model makes it, shared by every env; a leaf
# with one more dimension is per env, [B] + that shape
LEAF_RANK = {
    "opt_timestep": 0, "opt_gravity": 1, "opt_tolerance": 0, "opt_ls_tolerance": 0, "opt_impratio": 0,
    "opt_density": 0, "opt_viscosity": 0, "opt_wind": 1, "qpos0": 1, "qpos_spring": 1,
    "body_pos": 2, "body_quat": 2, "body_ipos": 2, "body_iquat": 2, "body_mass": 1, "body_inertia": 2,
    "body_subtreemass": 1, "body_invweight0": 2,
    "jnt_pos": 2, "jnt_axis": 2, "jnt_range": 2, "jnt_stiffness": 1, "jnt_solref": 2, "jnt_solimp": 2,
    "jnt_margin": 1,
    "dof_damping": 1, "dof_armature": 1, "dof_invweight0": 1, "dof_frictionloss": 1, "dof_solref_fri": 2,
    "dof_solimp_fri": 2,
    "eq_data": 2, "eq_solref": 2, "eq_solimp": 2,
    "geom_pos": 2, "geom_quat": 2, "geom_size": 2, "geom_friction": 2, "geom_solref": 2, "geom_solimp": 2,
    "geom_solmix": 1, "geom_margin": 1, "geom_gap": 1, "geom_priority": 1,
    "site_pos": 2, "site_quat": 2,
    "tendon_moment": 2, "tendon_length_mat": 2, "tendon_length0_const": 1, "tendon_length0": 1,
    "tendon_invweight0": 1, "tendon_frictionloss": 1, "tendon_solref_fri": 2, "tendon_solimp_fri": 2,
    "tendon_stiffness": 1, "tendon_damping": 1, "tendon_lengthspring": 2,
    "actuator_gear0": 1, "actuator_len_mat": 2, "actuator_len_const": 1, "actuator_moment": 2,
    "actuator_dynprm": 2, "actuator_gainprm": 2, "actuator_biasprm": 2, "actuator_ctrlrange": 2,
    "actuator_forcerange": 2, "actuator_actrange": 2, "actuator_ctrllimited": 1, "actuator_forcelimited": 1,
    "actuator_actlimited": 1, "actuator_acc0": 1,
}


def is_per_env(model: Model, name: str) -> bool:
    """True when leaf `name` carries a leading env axis (module docstring)."""
    return getattr(model, name).dim() > LEAF_RANK[name]


def take(model: Model, name: str, ids) -> torch.Tensor:
    """Leaf `name` at `ids` (an index tensor or an int) along its first own
    axis: `leaf[ids]` shared, `leaf[:, ids]` per env."""
    leaf = getattr(model, name)
    return leaf[:, ids] if leaf.dim() > LEAF_RANK[name] else leaf[ids]


def env_lined(x: torch.Tensor, per_env: bool, ndim: int) -> torch.Tensor:
    """`x` as it is, or, per env ([B] + its own shape), with ones between
    the env axis and its own shape to `ndim` dims: it then broadcasts
    against a batch-first tensor whose trailing dims are its own shape."""
    if not per_env:
        return x
    return x.reshape(x.shape[:1] + (1,) * (ndim - x.dim()) + x.shape[1:])


def env_view(model: Model, name: str, ndim: int) -> torch.Tensor:
    """Leaf `name` lined up against a batch-first tensor of `ndim` dims
    (`env_lined`): a per-env scalar [B] against [B, n] becomes [B, 1]."""
    return env_lined(getattr(model, name), is_per_env(model, name), ndim)


def mat_vec(model: Model, name: str, x: torch.Tensor) -> torch.Tensor:
    """Matrix leaf `name` [rows, cols] (or [B, rows, cols] per env) times a
    batch of vectors x [B, cols] -> [B, rows]."""
    mat = getattr(model, name)
    return (mat @ x[..., None])[..., 0] if mat.dim() > LEAF_RANK[name] else x @ mat.T


def vec_mat(x: torch.Tensor, model: Model, name: str) -> torch.Tensor:
    """A batch of vectors x [B, rows] times matrix leaf `name` [rows, cols]
    (or [B, rows, cols] per env) -> [B, cols]."""
    mat = getattr(model, name)
    return (x[:, None, :] @ mat)[:, 0] if mat.dim() > LEAF_RANK[name] else x @ mat


@dataclasses.dataclass(frozen=True)
class Data:
    """Batch-first dynamic state and derived stage outputs, [B, ...]."""

    time: torch.Tensor
    qpos: torch.Tensor
    qvel: torch.Tensor
    act: torch.Tensor
    ctrl: torch.Tensor
    qacc: torch.Tensor
    qacc_smooth: torch.Tensor
    qacc_warmstart: torch.Tensor
    xpos: torch.Tensor
    xquat: torch.Tensor
    xmat: torch.Tensor
    xipos: torch.Tensor
    ximat: torch.Tensor
    xanchor: torch.Tensor
    xaxis: torch.Tensor
    geom_xpos: torch.Tensor
    geom_xmat: torch.Tensor
    site_xpos: torch.Tensor
    site_xmat: torch.Tensor
    subtree_com: torch.Tensor
    cinert: torch.Tensor
    cdof: torch.Tensor
    cvel: torch.Tensor
    cdof_dot: torch.Tensor
    qM: torch.Tensor
    qLD: torch.Tensor
    crb_buf: torch.Tensor
    qfrc_bias: torch.Tensor
    qfrc_passive: torch.Tensor
    qfrc_spring: torch.Tensor
    qfrc_damper: torch.Tensor
    qfrc_actuator: torch.Tensor
    qfrc_smooth: torch.Tensor
    qfrc_constraint: torch.Tensor
    # (M + h diag(damping))^-1 (qfrc_smooth + qfrc_constraint), produced by
    # the fused CG solve on Euler plans; zeros otherwise
    qacc_eff: torch.Tensor
    act_dot: torch.Tensor
    actuator_length: torch.Tensor
    actuator_velocity: torch.Tensor
    actuator_force: torch.Tensor
    ten_length: torch.Tensor
    ten_velocity: torch.Tensor
    contact_dist: torch.Tensor
    contact_pos: torch.Tensor
    contact_frame: torch.Tensor
    efc_force: torch.Tensor
    sensordata: torch.Tensor

    def replace(self, **changes) -> "Data":
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# compiled-model snapshot
# ---------------------------------------------------------------------------


def load_snapshot(name: str = "rodent-full-clips") -> Any:
    """Loads the compiled-model snapshot of workload config `name` (a key of
    SNAPSHOTS, WALKER_SNAPSHOTS or PROBE_SNAPSHOTS; .npz written by
    tools/export_torch_model.py) as an object with
    MjModel's attribute names: `m.nv`, `m.body_parentid`, `m.opt.timestep`,
    ... Sizes and scalar options come back as Python numbers, array fields as
    numpy arrays. The walker's index tables are under `m.walker`
    (`joint_idxs`, `body_idxs`, `endeff_idxs`, `torso_idx`)."""
    paths = {**SNAPSHOTS, **WALKER_SNAPSHOTS, **PROBE_SNAPSHOTS}
    if name not in paths:
        raise ValueError(f"no snapshot for {name!r}; have {sorted(paths)}")
    return snapshot_from_file(paths[name])


def snapshot_from_file(path: str) -> Any:
    """A snapshot .npz as `load_snapshot` returns it; a key `group.field`
    becomes `snap.group.field` (`opt` and `walker` are always there)."""
    snap = types.SimpleNamespace(opt=types.SimpleNamespace(), walker=types.SimpleNamespace())
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            val = z[key]
            val = val.item() if val.ndim == 0 else val
            group, _, field = key.rpartition(".")
            if group and not hasattr(snap, group):
                setattr(snap, group, types.SimpleNamespace())
            setattr(getattr(snap, group) if group else snap, field, val)
    return snap


# ---------------------------------------------------------------------------
# plan compile (host numpy; mirrors the JAX package line for line)
# ---------------------------------------------------------------------------


def _body_levels(parentid: np.ndarray) -> tuple:
    depth = np.zeros(len(parentid), dtype=np.int64)
    for b in range(1, len(parentid)):
        depth[b] = depth[parentid[b]] + 1
    levels = []
    for d in range(1, int(depth.max()) + 1 if len(parentid) > 1 else 1):
        ids = np.nonzero(depth == d)[0]
        if len(ids):
            levels.append(ids)
    return tuple(levels)


def _ancestry_mask(dof_parentid: np.ndarray) -> np.ndarray:
    nv = len(dof_parentid)
    mask = np.zeros((nv, nv), dtype=bool)
    for i in range(nv):
        j = i
        while j >= 0:
            mask[i, j] = True
            j = int(dof_parentid[j])
    return mask


def _collision_pairs(m) -> tuple:
    """Static candidate geom pairs after contype/conaffinity, same-body/weld,
    parent-child and explicit-exclude filtering (mj_collision's broadphase
    filters)."""
    exclude = set()
    for e in range(m.nexclude):
        sig = int(m.exclude_signature[e])
        b1, b2 = sig >> 16, sig & 0xFFFF
        exclude.add((min(b1, b2), max(b1, b2)))
    pairs = []
    for i in range(m.ngeom):
        for j in range(i + 1, m.ngeom):
            b1, b2 = int(m.geom_bodyid[i]), int(m.geom_bodyid[j])
            w1, w2 = int(m.body_weldid[b1]), int(m.body_weldid[b2])
            if w1 == w2:
                continue
            pw1 = int(m.body_weldid[m.body_parentid[w1]])
            pw2 = int(m.body_weldid[m.body_parentid[w2]])
            if (w1 == pw2 or w2 == pw1) and not (w1 == 0 or w2 == 0):
                continue
            if not (
                (m.geom_contype[i] & m.geom_conaffinity[j])
                or (m.geom_contype[j] & m.geom_conaffinity[i])
            ):
                continue
            if (min(b1, b2), max(b1, b2)) in exclude:
                continue
            t1, t2 = int(m.geom_type[i]), int(m.geom_type[j])
            g1, g2 = i, j
            if t1 > t2:
                t1, t2, g1, g2 = t2, t1, g2, g1
            pairs.append((t1, t2, g1, g2))

    groups: dict = {}
    for t1, t2, g1, g2 in pairs:
        groups.setdefault((t1, t2), []).append((g1, g2))
    out = []
    for (t1, t2), gs in sorted(groups.items()):
        g1 = np.array([g[0] for g in gs], dtype=np.int64)
        g2 = np.array([g[1] for g in gs], dtype=np.int64)
        out.append((t1, t2, g1, g2))
    return tuple(out)


# contacts emitted per candidate pair by the narrowphase (collision.py)
_NCON_PER_TYPE = {
    (GEOM_PLANE, GEOM_SPHERE): 1,
    (GEOM_PLANE, GEOM_CAPSULE): 2,
    (GEOM_PLANE, GEOM_ELLIPSOID): 1,
    (GEOM_PLANE, GEOM_BOX): 4,
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_CAPSULE, GEOM_CAPSULE): 1,
}


def _fixed_tendon_matrices(m):
    """Constant (ntendon, nv) moment and (ntendon, nq) length matrices of
    fixed (joint-coupled) tendons."""
    nt = m.ntendon
    moment = np.zeros((nt, m.nv))
    length_mat = np.zeros((nt, m.nq))
    length_const = np.zeros((nt,))
    for t in range(nt):
        adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
        for w in range(adr, adr + num):
            if int(m.wrap_type[w]) != WRAP_JOINT:
                raise NotImplementedError("only fixed (joint) tendons supported")
            j = int(m.wrap_objid[w])
            coef = float(m.wrap_prm[w])
            if int(m.jnt_type[j]) not in (JNT_SLIDE, JNT_HINGE):
                raise NotImplementedError("fixed tendon on non-scalar joint")
            moment[t, int(m.jnt_dofadr[j])] += coef
            length_mat[t, int(m.jnt_qposadr[j])] += coef
    return moment, length_mat, length_const


def _transmission_matrices(m, tendon_moment, tendon_len_mat):
    """Constant actuator transmission: length = len_mat @ qpos + len_const,
    moment (nu, nv); actuators drive scalar joints or fixed tendons."""
    nu = m.nu
    len_mat = np.zeros((nu, m.nq))
    len_const = np.zeros((nu,))
    moment = np.zeros((nu, m.nv))
    gear0 = m.actuator_gear[:, 0].copy()
    for u in range(nu):
        trn = int(m.actuator_trntype[u])
        tid = int(m.actuator_trnid[u, 0])
        g = float(gear0[u])
        if trn == TRN_JOINT:
            if int(m.jnt_type[tid]) not in (JNT_SLIDE, JNT_HINGE):
                raise NotImplementedError("joint transmission on non-scalar joint")
            len_mat[u, int(m.jnt_qposadr[tid])] = g
            moment[u, int(m.jnt_dofadr[tid])] = g
        elif trn == TRN_TENDON:
            len_mat[u] = g * tendon_len_mat[tid]
            moment[u] = g * tendon_moment[tid]
        else:
            raise NotImplementedError(f"actuator trntype {trn}")
    return len_mat, len_const, moment, gear0


def put_model(m, device: torch.device | str = "cuda") -> tuple[PhysicsPlan, Model]:
    """Packs a compiled model (a `mujoco.MjModel` or a `load_snapshot`
    result) into (PhysicsPlan, Model) with float32 Model tensors on
    `device`."""
    device = _device(device)
    if m.nflex:
        raise NotImplementedError("flex not supported")
    eq_connect, eq_weld, eq_joint, eq_tendon = [], [], [], []
    for e in range(m.neq):
        if not m.eq_active0[e]:
            continue
        ty = int(m.eq_type[e])
        o1, o2 = int(m.eq_obj1id[e]), int(m.eq_obj2id[e])
        if ty in (EQ_CONNECT, EQ_WELD):
            objtype = int(m.eq_objtype[e])
            if objtype not in (OBJ_BODY, OBJ_SITE):
                raise NotImplementedError(
                    f"connect/weld equality objtype {objtype} not supported"
                )
            (eq_connect if ty == EQ_CONNECT else eq_weld).append(
                (e, o1, o2, objtype == OBJ_SITE)
            )
        elif ty == EQ_JOINT:
            if m.jnt_type[o1] not in (JNT_HINGE, JNT_SLIDE) or (
                o2 >= 0 and m.jnt_type[o2] not in (JNT_HINGE, JNT_SLIDE)
            ):
                raise NotImplementedError("joint equality on non-scalar joint")
            eq_joint.append((e, o1, o2))
        elif ty == EQ_TENDON:
            eq_tendon.append((e, o1, o2))
        else:
            raise NotImplementedError(f"equality type {ty} not supported")
    ne = 3 * len(eq_connect) + 6 * len(eq_weld) + len(eq_joint) + len(eq_tendon)
    friction_dof = np.nonzero(m.dof_frictionloss > 0)[0]
    friction_ten = (
        np.nonzero(m.tendon_frictionloss > 0)[0] if m.ntendon else np.zeros(0, np.int64)
    )
    nf = len(friction_dof) + len(friction_ten)
    condims = set(int(c) for c in m.geom_condim)
    if condims - {1, 3, 4, 6}:
        raise NotImplementedError(f"condim {condims} not supported (need 1, 3, 4, or 6)")
    if int(m.opt.cone) == CONE_ELLIPTIC and condims - {1, 3}:
        raise NotImplementedError("elliptic cone with condim > 3 not supported")
    if np.abs(m.geom_fluid).any():
        raise NotImplementedError("per-geom ellipsoid fluid model not supported")

    pair_groups = _collision_pairs(m)
    ncon = 0
    contact_condim = []
    for t1, t2, g1, g2 in pair_groups:
        if (t1, t2) not in _NCON_PER_TYPE:
            raise NotImplementedError(f"collision pair type {(t1, t2)}")
        ncon_per = _NCON_PER_TYPE[(t1, t2)]
        ncon += ncon_per * len(g1)
        cd = np.maximum(m.geom_condim[g1], m.geom_condim[g2])
        for _ in range(ncon_per):
            contact_condim.append(cd)
    contact_condim = (
        np.concatenate(contact_condim) if contact_condim else np.zeros(0, np.int64)
    )
    condim = int(contact_condim.max()) if ncon else 1

    limited_jnt = np.nonzero(
        (m.jnt_limited == 1) & ((m.jnt_type == JNT_HINGE) | (m.jnt_type == JNT_SLIDE))
    )[0]
    nlimit = len(limited_jnt)
    if int(m.opt.cone) == CONE_ELLIPTIC:
        rows_per_con = np.where(contact_condim == 1, 1, contact_condim)
    else:
        rows_per_con = np.where(contact_condim == 1, 1, 2 * (contact_condim - 1))
    nefc = ne + nf + nlimit + int(rows_per_con.sum())

    tendon_moment, tendon_len_mat, tendon_len_const = _fixed_tendon_matrices(m)
    act_len_mat, act_len_const, act_moment, gear0 = _transmission_matrices(
        m, tendon_moment, tendon_len_mat
    )

    plan = PhysicsPlan(
        nq=int(m.nq),
        nv=int(m.nv),
        nu=int(m.nu),
        na=int(m.na),
        nbody=int(m.nbody),
        njnt=int(m.njnt),
        ngeom=int(m.ngeom),
        nsite=int(m.nsite),
        ntendon=int(m.ntendon),
        nsensor=int(m.nsensor),
        nsensordata=int(m.nsensordata),
        ncon=ncon,
        nefc=nefc,
        ne=ne,
        nf=nf,
        nlimit=nlimit,
        eq_connect=tuple(eq_connect),
        eq_weld=tuple(eq_weld),
        eq_joint=tuple(eq_joint),
        eq_tendon=tuple(eq_tendon),
        friction_dof_ids=friction_dof,
        friction_tendon_ids=friction_ten,
        ncon_ell=(
            int((contact_condim >= 3).sum()) if int(m.opt.cone) == CONE_ELLIPTIC else 0
        ),
        body_parentid=m.body_parentid.copy(),
        body_rootid=m.body_rootid.copy(),
        body_jntadr=m.body_jntadr.copy(),
        body_jntnum=m.body_jntnum.copy(),
        body_dofadr=m.body_dofadr.copy(),
        body_dofnum=m.body_dofnum.copy(),
        body_geomadr=m.body_geomadr.copy(),
        body_geomnum=m.body_geomnum.copy(),
        body_levels=_body_levels(m.body_parentid),
        jnt_type=m.jnt_type.copy(),
        jnt_qposadr=m.jnt_qposadr.copy(),
        jnt_dofadr=m.jnt_dofadr.copy(),
        jnt_bodyid=m.jnt_bodyid.copy(),
        jnt_limited=m.jnt_limited.copy(),
        limited_jnt_ids=limited_jnt,
        dof_bodyid=m.dof_bodyid.copy(),
        dof_jntid=m.dof_jntid.copy(),
        dof_parentid=m.dof_parentid.copy(),
        ancestry_mask=_ancestry_mask(m.dof_parentid),
        geom_bodyid=m.geom_bodyid.copy(),
        geom_type=m.geom_type.copy(),
        site_bodyid=m.site_bodyid.copy(),
        pair_groups=pair_groups,
        ncon_per_pair_type=dict(_NCON_PER_TYPE),
        condim=condim,
        contact_condim=contact_condim,
        actuator_trntype=m.actuator_trntype.copy(),
        actuator_dyntype=m.actuator_dyntype.copy(),
        actuator_gaintype=m.actuator_gaintype.copy(),
        actuator_biastype=m.actuator_biastype.copy(),
        sensor_type=m.sensor_type.copy(),
        sensor_objtype=m.sensor_objtype.copy(),
        sensor_objid=m.sensor_objid.copy(),
        sensor_adr=m.sensor_adr.copy(),
        sensor_dim=m.sensor_dim.copy(),
        integrator=int(m.opt.integrator),
        solver=int(m.opt.solver),
        cone=int(m.opt.cone),
        iterations=int(m.opt.iterations),
        ls_iterations=int(m.opt.ls_iterations),
        disableflags=int(m.opt.disableflags),
        fluid_active=bool(
            m.opt.density > 0 or m.opt.viscosity > 0 or np.abs(m.opt.wind).any()
        ),
        tendon_passive_active=bool(
            m.ntendon
            and ((m.tendon_stiffness != 0).any() or (m.tendon_damping != 0).any())
        ),
    )

    def a(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    model = Model(
        opt_timestep=a(m.opt.timestep),
        opt_gravity=a(m.opt.gravity),
        opt_tolerance=a(m.opt.tolerance),
        opt_ls_tolerance=a(m.opt.ls_tolerance),
        opt_impratio=a(m.opt.impratio),
        opt_density=a(m.opt.density),
        opt_viscosity=a(m.opt.viscosity),
        opt_wind=a(m.opt.wind),
        qpos0=a(m.qpos0),
        qpos_spring=a(m.qpos_spring),
        body_pos=a(m.body_pos),
        body_quat=a(m.body_quat),
        body_ipos=a(m.body_ipos),
        body_iquat=a(m.body_iquat),
        body_mass=a(m.body_mass),
        body_inertia=a(m.body_inertia),
        body_subtreemass=a(m.body_subtreemass),
        body_invweight0=a(m.body_invweight0),
        jnt_pos=a(m.jnt_pos),
        jnt_axis=a(m.jnt_axis),
        jnt_range=a(m.jnt_range),
        jnt_stiffness=a(m.jnt_stiffness),
        jnt_solref=a(m.jnt_solref),
        jnt_solimp=a(m.jnt_solimp),
        jnt_margin=a(m.jnt_margin),
        dof_damping=a(m.dof_damping),
        dof_armature=a(m.dof_armature),
        dof_invweight0=a(m.dof_invweight0),
        dof_frictionloss=a(m.dof_frictionloss),
        dof_solref_fri=a(m.dof_solref),
        dof_solimp_fri=a(m.dof_solimp),
        eq_data=a(m.eq_data),
        eq_solref=a(m.eq_solref),
        eq_solimp=a(m.eq_solimp),
        geom_pos=a(m.geom_pos),
        geom_quat=a(m.geom_quat),
        geom_size=a(m.geom_size),
        geom_friction=a(m.geom_friction),
        geom_solref=a(m.geom_solref),
        geom_solimp=a(m.geom_solimp),
        geom_solmix=a(m.geom_solmix),
        geom_margin=a(m.geom_margin),
        geom_gap=a(m.geom_gap),
        geom_priority=a(m.geom_priority),
        site_pos=a(m.site_pos),
        site_quat=a(m.site_quat),
        tendon_moment=a(tendon_moment),
        tendon_length_mat=a(tendon_len_mat),
        tendon_length0_const=a(tendon_len_const),
        tendon_length0=a(m.tendon_length0),
        tendon_invweight0=a(m.tendon_invweight0),
        tendon_frictionloss=a(m.tendon_frictionloss),
        tendon_solref_fri=a(m.tendon_solref_fri),
        tendon_solimp_fri=a(m.tendon_solimp_fri),
        tendon_stiffness=a(m.tendon_stiffness),
        tendon_damping=a(m.tendon_damping),
        tendon_lengthspring=a(
            np.asarray(m.tendon_lengthspring).reshape(m.ntendon, 2)
            if m.ntendon
            else np.zeros((0, 2))
        ),
        actuator_gear0=a(gear0),
        actuator_len_mat=a(act_len_mat),
        actuator_len_const=a(act_len_const),
        actuator_moment=a(act_moment),
        actuator_dynprm=a(m.actuator_dynprm),
        actuator_gainprm=a(m.actuator_gainprm),
        actuator_biasprm=a(m.actuator_biasprm),
        actuator_ctrlrange=a(m.actuator_ctrlrange),
        actuator_forcerange=a(m.actuator_forcerange),
        actuator_actrange=a(m.actuator_actrange),
        actuator_ctrllimited=a(m.actuator_ctrllimited),
        actuator_forcelimited=a(m.actuator_forcelimited),
        actuator_actlimited=a(m.actuator_actlimited),
        actuator_acc0=a(m.actuator_acc0),
    )
    return plan, model


def make_data(plan: PhysicsPlan, model: Model, batch_size: int) -> Data:
    """Zero-initialized batch of `batch_size` envs at qpos0 (mj_makeData
    defaults), on the model's device: each env at its own qpos0 where qpos0
    is per env ([batch_size, nq])."""
    dtype, device = model.qpos0.dtype, model.qpos0.device
    b = batch_size

    def z(*shape):
        return torch.zeros((b,) + shape, dtype=dtype, device=device)

    def eye3(k):
        return torch.eye(3, dtype=dtype, device=device).expand(b, k, 3, 3).clone()

    nbody, nv = plan.nbody, plan.nv
    xquat = z(nbody, 4)
    xquat[..., 0] = 1.0
    return Data(
        time=z(),
        qpos=model.qpos0.expand(b, plan.nq).clone(),
        qvel=z(nv),
        act=z(plan.na),
        ctrl=z(plan.nu),
        qacc=z(nv),
        qacc_smooth=z(nv),
        qacc_warmstart=z(nv),
        xpos=z(nbody, 3),
        xquat=xquat,
        xmat=eye3(nbody),
        xipos=z(nbody, 3),
        ximat=eye3(nbody),
        xanchor=z(plan.njnt, 3),
        xaxis=z(plan.njnt, 3),
        geom_xpos=z(plan.ngeom, 3),
        geom_xmat=eye3(plan.ngeom),
        site_xpos=z(plan.nsite, 3),
        site_xmat=eye3(plan.nsite),
        subtree_com=z(nbody, 3),
        cinert=z(nbody, 10),
        cdof=z(nv, 6),
        cvel=z(nbody, 6),
        cdof_dot=z(nv, 6),
        qM=z(nv, nv),
        qLD=z(nv, nv),
        crb_buf=z(nv, 6),
        qfrc_bias=z(nv),
        qfrc_passive=z(nv),
        qfrc_spring=z(nv),
        qfrc_damper=z(nv),
        qfrc_actuator=z(nv),
        qfrc_smooth=z(nv),
        qfrc_constraint=z(nv),
        qacc_eff=z(nv),
        act_dot=z(plan.na),
        actuator_length=z(plan.nu),
        actuator_velocity=z(plan.nu),
        actuator_force=z(plan.nu),
        ten_length=z(plan.ntendon),
        ten_velocity=z(plan.ntendon),
        contact_dist=z(plan.ncon),
        contact_pos=z(plan.ncon, 3),
        contact_frame=eye3(plan.ncon),
        efc_force=z(plan.nefc),
        sensordata=z(plan.nsensordata),
    )


def _from_numpy(cls, leaves: Mapping[str, Any], device):
    device = _device(device)
    return cls(
        **{
            f.name: torch.as_tensor(np.array(leaves[f.name]), dtype=torch.float32, device=device)
            for f in dataclasses.fields(cls)
        }
    )


def model_from_numpy(leaves: Mapping[str, Any], device: torch.device | str = "cuda") -> Model:
    """float32 Model from a mapping of field name -> array (e.g. the JAX
    package's Model leaves converted with np.asarray)."""
    return _from_numpy(Model, leaves, device)


def data_from_numpy(leaves: Mapping[str, Any], device: torch.device | str = "cuda") -> Data:
    """Batch-first float32 Data from a mapping of field name -> [B, ...]
    array (e.g. the leaves of a vmapped JAX Data converted with np.asarray)."""
    return _from_numpy(Data, leaves, device)


def plan_cache(plan: PhysicsPlan, key, build):
    """A value derived from the plan, built once by `build()` and kept on the
    plan (plans compare by identity, one per model build)."""
    cache = plan.__dict__.setdefault("_cache", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


def static_tensor(plan: PhysicsPlan, key, like: torch.Tensor, build) -> torch.Tensor:
    """A tensor derived from the plan on `like`'s device, built once per
    (key, device, dtype), so the eager step does not copy index tables
    host-to-device on every call. `build()` returns a numpy array: integer
    arrays become int64 index tensors, float and bool arrays `like.dtype`."""

    def make():
        arr = np.asarray(build())
        if arr.dtype.kind in "iu":
            return torch.as_tensor(arr.astype(np.int64), device=like.device)
        return torch.as_tensor(arr.astype(np.float64), dtype=like.dtype, device=like.device)

    return plan_cache(plan, (key, str(like.device), like.dtype), make)
