"""Imitation reward library on a batch of envs.

Port of track_mjx_tpu/envs/task/reward.py. Every term is the JAX formula
with the env as the leading dimension: each function takes [B, ...] tensors
and returns [B] (or [B, ...] distances), and `compute_tracking_rewards`
returns the same 18-tuple as the JAX package, each entry [B].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from track_mjx_tpu_torch.envs.walker.base import BaseWalker
from track_mjx_tpu_torch.io.load import ReferenceClip


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Weights and scales for the imitation reward terms."""

    too_far_dist: float
    bad_pose_dist: float
    bad_quat_dist: float
    ctrl_cost_weight: float
    ctrl_diff_cost_weight: float
    energy_cost_weight: float
    pos_reward_weight: float
    quat_reward_weight: float
    joint_reward_weight: float
    angvel_reward_weight: float
    bodypos_reward_weight: float
    endeff_reward_weight: float
    healthy_z_range: Tuple[float, float]
    pos_reward_exp_scale: float
    quat_reward_exp_scale: float
    joint_reward_exp_scale: float
    angvel_reward_exp_scale: float
    bodypos_reward_exp_scale: float
    endeff_reward_exp_scale: float
    penalty_pos_distance_scale: Sequence[float]
    var_window_size: int = 50
    var_coeff: float = 5e-2
    jerk_coeff: float = 5e-4

    def __post_init__(self):
        scale = self.penalty_pos_distance_scale
        if isinstance(scale, torch.Tensor):
            scale = scale.tolist()
        object.__setattr__(self, "penalty_pos_distance_scale", tuple(float(s) for s in scale))
        object.__setattr__(self, "healthy_z_range", tuple(float(z) for z in self.healthy_z_range))


def bounded_quat_dist(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Quaternion distance limited to pi/2, [..., 1]. The inputs are
    normalized out of place (the JAX `/=` makes a new array; in torch it
    would write into the caller's qpos)."""
    source = source / torch.linalg.vector_norm(source, dim=-1, keepdim=True)
    target = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True)
    dist = 2 * (source * target).sum(-1) ** 2 - 1
    dist = torch.clamp(dist, max=1.0)
    return 0.5 * torch.arccos(dist)[..., None]


def _sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every dimension but the env's."""
    return x.flatten(1).sum(1)


def compute_pos_reward(pos_array, reference_clip_pos, weight, exp_scale):
    """Root-position tracking reward; also returns the raw distance."""
    pos_distance = pos_array - reference_clip_pos
    reward = weight * torch.exp(-exp_scale * _sum(pos_distance**2))
    return reward, pos_distance


def compute_quat_reward(quat_array, reference_clip_quat, weight, exp_scale):
    """Root-orientation tracking reward; also returns the distance."""
    quat_distance = _sum(bounded_quat_dist(quat_array, reference_clip_quat) ** 2)
    return weight * torch.exp(-exp_scale * quat_distance), quat_distance


def compute_joint_reward(joint_array, reference_clip_joint, weight, exp_scale):
    """Joint-angle tracking reward; also returns the distance."""
    joint_distance = _sum((joint_array - reference_clip_joint) ** 2)
    return weight * torch.exp(-exp_scale * joint_distance), joint_distance


def compute_angvel_reward(angvel_array, reference_clip_angvel, weight, exp_scale):
    """Root angular-velocity tracking reward."""
    return weight * torch.exp(-exp_scale * _sum((angvel_array - reference_clip_angvel) ** 2))


def compute_bodypos_reward(bodypos_array, reference_clip_bodypos, weight, exp_scale):
    """Body-position tracking reward."""
    return weight * torch.exp(-exp_scale * _sum((bodypos_array - reference_clip_bodypos) ** 2))


def compute_endeff_reward(endeff_array, reference_clip_endeff, weight, exp_scale):
    """End-effector tracking reward."""
    return weight * torch.exp(-exp_scale * _sum((endeff_array - reference_clip_endeff) ** 2))


def compute_ctrl_cost(action, weight):
    """Quadratic control cost."""
    return weight * _sum(torch.square(action))


def compute_ctrl_diff_cost(action, prev_action, weight):
    """Quadratic control-rate cost."""
    return weight * _sum(torch.square(prev_action - action))


def compute_energy_cost(qvel, qfrc_actuator, weight):
    """Mechanical-power cost, clamped at 50."""
    return weight * torch.clamp(_sum(torch.abs(qvel) * torch.abs(qfrc_actuator)), max=50.0)


def compute_health_penalty(torso_z, healthy_z_range):
    """1.0 where the torso leaves the healthy z-range, else 0.0."""
    min_z, max_z = healthy_z_range
    one, zero = torch.ones_like(torso_z), torch.zeros_like(torso_z)
    is_healthy = torch.where(torso_z < min_z, zero, one)
    is_healthy = torch.where(torso_z > max_z, zero, is_healthy)
    return 1.0 - is_healthy


def compute_penalty_terms(
    pos_distance,
    joint_distance,
    quat_distance,
    too_far_dist,
    bad_pose_dist,
    bad_quat_dist,
    penalty_pos_distance_scale,
):
    """too_far / bad_pose / bad_quat termination flags."""
    scale = pos_distance.new_tensor(penalty_pos_distance_scale)
    summed_pos_distance = _sum((pos_distance * scale) ** 2)
    too_far = (summed_pos_distance > too_far_dist).to(summed_pos_distance.dtype)
    bad_pose = (joint_distance > bad_pose_dist).to(joint_distance.dtype)
    bad_quat = (quat_distance > bad_quat_dist).to(quat_distance.dtype)
    return too_far, bad_pose, bad_quat, summed_pos_distance


def compute_action_variance_cost(info: Dict[str, Any], var_weight: float):
    """Windowed action-variance cost over the ring buffer [B, W, nu]."""
    buffer = info["action_buffer"]
    mean_act = buffer.mean(1, keepdim=True)
    var_act = ((buffer - mean_act) ** 2).mean(1)
    return var_weight * var_act.sum(1)


def compute_jerk_cost(info: Dict[str, Any], var_window_size: int, jerk_weight: float):
    """Second-difference (jerk) cost over the time-ordered ring buffer:
    circular second differences with the two windows that cross each env's
    write point masked out (time-ordered entry t lives at ring slot
    (buffer_index + t) % W), as the JAX package computes them."""
    buffer = info["action_buffer"]
    idx = info["buffer_index"]
    d2 = torch.roll(buffer, -2, dims=1) - 2 * torch.roll(buffer, -1, dims=1) + buffer
    slots = torch.arange(var_window_size, device=buffer.device)
    time_pos = (slots[None, :] - idx[:, None]) % var_window_size
    valid = time_pos < var_window_size - 2
    d2 = torch.where(valid[:, :, None], d2, torch.zeros_like(d2))
    return jerk_weight * (d2**2).sum((1, 2))


def compute_tracking_rewards(
    data,
    reference_frame: ReferenceClip,
    walker: BaseWalker,
    action: torch.Tensor,
    info: Dict[str, Any],
    reward_config: RewardConfig,
) -> Tuple[torch.Tensor, ...]:
    """The 18-output reward/penalty tuple, each [B]."""
    rc = reward_config
    pos_reward, pos_distance = compute_pos_reward(
        data.qpos[:, :3], reference_frame.position, rc.pos_reward_weight, rc.pos_reward_exp_scale
    )
    quat_reward, quat_distance = compute_quat_reward(
        data.qpos[:, 3:7], reference_frame.quaternion, rc.quat_reward_weight, rc.quat_reward_exp_scale
    )
    joint_reward, joint_distance = compute_joint_reward(
        data.qpos[:, 7:], reference_frame.joints, rc.joint_reward_weight, rc.joint_reward_exp_scale
    )
    angvel_reward = compute_angvel_reward(
        data.qvel[:, 3:6],
        reference_frame.angular_velocity,
        rc.angvel_reward_weight,
        rc.angvel_reward_exp_scale,
    )
    # xpos[1:] reproduces the reference's floor-body offset
    bodypos_reward = compute_bodypos_reward(
        walker.get_body_positions(data.xpos[:, 1:]),
        walker.get_body_positions(reference_frame.body_positions),
        rc.bodypos_reward_weight,
        rc.bodypos_reward_exp_scale,
    )
    endeff_reward = compute_endeff_reward(
        walker.get_end_effector_positions(data.xpos[:, 1:]),
        walker.get_end_effector_positions(reference_frame.body_positions),
        rc.endeff_reward_weight,
        rc.endeff_reward_exp_scale,
    )
    ctrl_cost = compute_ctrl_cost(action, rc.ctrl_cost_weight)
    ctrl_diff_cost = compute_ctrl_diff_cost(action, info["prev_ctrl"], rc.ctrl_diff_cost_weight)
    energy_cost = compute_energy_cost(
        data.qvel[:, 6:], data.qfrc_actuator[:, 6:], rc.energy_cost_weight
    )
    torso_z = walker.get_torso_position(data.xpos)[:, 2]
    fall = compute_health_penalty(torso_z, rc.healthy_z_range)
    too_far, bad_pose, bad_quat, summed_pos_distance = compute_penalty_terms(
        pos_distance,
        joint_distance,
        quat_distance,
        rc.too_far_dist,
        rc.bad_pose_dist,
        rc.bad_quat_dist,
        rc.penalty_pos_distance_scale,
    )
    action_variance_cost = compute_action_variance_cost(info, rc.var_coeff)
    jerk_cost = compute_jerk_cost(info, rc.var_window_size, rc.jerk_coeff)
    return (
        pos_reward,
        quat_reward,
        joint_reward,
        angvel_reward,
        bodypos_reward,
        endeff_reward,
        ctrl_cost,
        ctrl_diff_cost,
        energy_cost,
        too_far,
        bad_pose,
        bad_quat,
        fall,
        joint_distance,
        summed_pos_distance,
        quat_distance,
        action_variance_cost,
        jerk_cost,
    )
