"""Sensor evaluation: gyro, velocimeter, accelerometer, subtreelinvel.

Port of track_mjx_tpu/physics/sensors.py: the rodent's sensor set (a
head-mounted IMU triplet and a subtree linear velocity) and the fly's IMU
triplet. The accelerometer uses mj_rnePostConstraint's body-acceleration
chain. Other sensor types (the fly's touch and force sensors) stay zero, as
in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from track_mjx_tpu_torch.ops.quaternion import cross
from track_mjx_tpu_torch.physics.model import Data, Model, PhysicsPlan, static_tensor, take
from track_mjx_tpu_torch.physics.rne import body_acc

SENS_ACCELEROMETER = 1
SENS_VELOCIMETER = 2
SENS_GYRO = 3
SENS_SUBTREELINVEL = 36


def _subtree_bodies(plan: PhysicsPlan, root: int) -> np.ndarray:
    """Static body-id list of the subtree rooted at `root`."""
    out = [root]
    for b in range(root + 1, plan.nbody):
        p = b
        while p > root:
            p = int(plan.body_parentid[p])
        if p == root:
            out.append(b)
    return np.array(out, dtype=np.int64)


def _point_velocity(plan, data, bodyid: int, point):
    """(angular, linear) world velocity of `point` [B, ..., 3] on `bodyid`."""
    com = data.subtree_com[:, int(plan.body_rootid[bodyid])]
    cvel = data.cvel[:, bodyid]
    w, v = cvel[:, :3], cvel[:, 3:]
    return w, v + cross(w, point - com)


def _rot_t(rot, vec):
    """rot^T @ vec for [B, 3, 3] and [B, 3]."""
    return (rot * vec[:, :, None]).sum(1)


def sensor(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Evaluates all supported sensors into data.sensordata."""
    if plan.nsensor == 0:
        return data
    like = data.qpos
    sensordata = like.new_zeros((like.shape[0], plan.nsensordata))
    need_acc = bool((plan.sensor_type == SENS_ACCELEROMETER).any())
    cacc = body_acc(plan, model, data, qacc=data.qacc) if need_acc else None

    for i in range(plan.nsensor):
        stype = int(plan.sensor_type[i])
        objid = int(plan.sensor_objid[i])
        adr = int(plan.sensor_adr[i])
        if stype in (SENS_GYRO, SENS_VELOCIMETER, SENS_ACCELEROMETER):
            bodyid = int(plan.site_bodyid[objid])
            point = data.site_xpos[:, objid]
            rot = data.site_xmat[:, objid]
            w, v = _point_velocity(plan, data, bodyid, point)
            if stype == SENS_GYRO:
                out = _rot_t(rot, w)
            elif stype == SENS_VELOCIMETER:
                out = _rot_t(rot, v)
            else:
                com = data.subtree_com[:, int(plan.body_rootid[bodyid])]
                a = cacc[:, bodyid]
                a_lin = a[:, 3:] + cross(a[:, :3], point - com)
                a_lin = a_lin + cross(w, v)  # centripetal (mj_objectAcceleration)
                out = _rot_t(rot, a_lin)
            sensordata[:, adr : adr + 3] = out  # in place on the fresh zeros
        elif stype == SENS_SUBTREELINVEL:
            # subtree linear momentum / subtree mass (mj_subtreeVel)
            bodies_np = _subtree_bodies(plan, objid)
            bodies = static_tensor(plan, ("sensor", i), like, lambda: bodies_np)
            roots = static_tensor(
                plan, ("sensor", i, "root"), like, lambda: plan.body_rootid[bodies_np]
            )
            mass = take(model, "body_mass", bodies)
            cvel = data.cvel[:, bodies]
            w = cvel[..., :3]
            v = cvel[..., 3:] + cross(w, data.xipos[:, bodies] - data.subtree_com[:, roots])
            out = (mass[..., None] * v).sum(1) / torch.clamp(mass.sum(-1), min=1e-12)[..., None]
            sensordata[:, adr : adr + 3] = out
    return data.replace(sensordata=sensordata)
