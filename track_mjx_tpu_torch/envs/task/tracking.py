"""Single- and multi-clip motion-capture tracking environments, batched.

Port of track_mjx_tpu/envs/task/tracking.py. One env object steps a batch of
envs: the JAX package's per-env `reset`/`step` under `jax.vmap` become
functions of [B, ...] tensors, and physics runs through the port's
`forward.n_step` (on the card, the fused CG solve kernel).

- the constructor applies solver / iterations / ls_iterations / timestep
  from env_args to the compiled model before packing it;
- the clip fields a step reads are packed into one (rows, D) matrix, and a
  step reads its reference (the current frame and the observation window)
  with one row gather;
- reset is split: `reset_from_clip` takes the start frame, the clip index
  and both noises as tensors; `reset(generator, batch_size)` draws them
  (from a `parallel.mesh.Rows` in place of the generator: this rank's rows
  of the draws at the global batch size);
  The JAX package draws the qpos and the qvel noise from one key
  (`rng1`, reused); the port draws them one after the other from its
  generator, a different random stream (ROADMAP, standing divergences);
- the frame index is floor(time * mocap_hz + start_frame) in float32, with
  time summed substep by substep as the physics advances it;
- the NaN guard counts NaNs per env over every floating tensor of the
  step's Data, zeroes NaN (and clips inf) in reward and obs, and forces
  done where it found one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from track_mjx_tpu_torch.envs.base import Env, State, register_environment
from track_mjx_tpu_torch.envs.task.reward import RewardConfig, compute_tracking_rewards
from track_mjx_tpu_torch.envs.walker.base import BaseWalker
from track_mjx_tpu_torch.io.load import ReferenceClip
from track_mjx_tpu_torch.parallel import mesh
from track_mjx_tpu_torch.physics import forward as phys_forward
from track_mjx_tpu_torch.physics import model as phys_model

_SOLVER_IDS = {"cg": 1, "newton": 2}

# clip fields a step reads (reward, obs), packed into one row per frame
_PACK_FIELDS = (
    "position",
    "quaternion",
    "joints",
    "velocity",
    "angular_velocity",
    "joints_velocity",
    "body_positions",
)

# the 20 metrics of a state, in the JAX package's order
METRIC_KEYS = (
    "pos_reward",
    "quat_reward",
    "joint_reward",
    "angvel_reward",
    "bodypos_reward",
    "endeff_reward",
    "ctrl_cost",
    "ctrl_diff_cost",
    "energy_cost",
    "done",
    "too_far",
    "bad_pose",
    "bad_quat",
    "fall",
    "nan",
    "joint_distance",
    "summed_pos_distance",
    "quat_distance",
    "var_cost",
    "jerk_cost",
)


class SingleClipTracking(Env):
    """Tracking task for a continuous reference clip (frames, ...)."""

    def __init__(
        self,
        reference_clip: Optional[ReferenceClip],
        walker: BaseWalker,
        reward_config: RewardConfig,
        physics_steps_per_control_step: int,
        reset_noise_scale: float,
        solver: str,
        iterations: int,
        ls_iterations: int,
        mj_model_timestep: float,
        mocap_hz: int,
        clip_length: int,
        random_init_range: int,
        traj_length: int,
        device: torch.device | str = "cuda",
        **kwargs: Any,
    ):
        self.walker = walker
        mj_model = walker._mj_model
        if solver.lower() not in _SOLVER_IDS:
            raise ValueError(f"unsupported solver {solver}")
        mj_model.opt.solver = _SOLVER_IDS[solver.lower()]
        mj_model.opt.iterations = iterations
        mj_model.opt.ls_iterations = ls_iterations
        mj_model.opt.timestep = mj_model_timestep
        mj_model.opt.jacobian = 0  # dense

        self._mj_model = mj_model
        self.plan, self.model = phys_model.put_model(mj_model, device=device)
        self.device = self.model.qpos0.device
        self._n_frames = physics_steps_per_control_step
        self._steps_for_cur_frame = (
            1.0 / (mocap_hz * mj_model.opt.timestep)
        ) / physics_steps_per_control_step

        self._mocap_hz = mocap_hz
        self._reward_config = reward_config
        self._reference_clip = reference_clip
        self._ref_len = traj_length
        self._clip_length = clip_length
        self._random_init_range = random_init_range
        self._reset_noise_scale = reset_noise_scale

        # single-clip pack; MultiClipTracking builds its own over flat rows
        if reference_clip is not None and reference_clip.position.dim() == 2:
            self._clip_frames = reference_clip.position.shape[0]
            self._build_step_pack(reference_clip, n_leading=1)

    # ---- packed reference access ------------------------------------------
    def _build_step_pack(self, clip: ReferenceClip, n_leading: int) -> None:
        """Concatenates the step-read clip fields into one (rows, D) matrix
        on the env's device (rows = frames, or n_clips * frames)."""
        parts = []
        self._pack_slices = {}
        off = 0
        for name in _PACK_FIELDS:
            arr = getattr(clip, name).to(self.device, torch.float32)
            trailing = tuple(arr.shape[n_leading:])
            size = int(np.prod(trailing)) if trailing else 1
            parts.append(arr.reshape(-1, size))
            self._pack_slices[name] = (off, off + size, trailing)
            off += size
        self._pack = torch.cat(parts, dim=1).contiguous()
        self._body_quat_shape = tuple(clip.body_quaternions.shape[n_leading:])

    def _unpack(self, packed: torch.Tensor) -> ReferenceClip:
        """A ReferenceClip view of packed rows (..., D); body_quaternions
        are zeros (never read after io) and original_clip_idx None."""

        def field(name: str) -> torch.Tensor:
            s, e, shp = self._pack_slices[name]
            return packed[..., s:e].reshape(packed.shape[:-1] + shp)

        return ReferenceClip(
            position=field("position"),
            quaternion=field("quaternion"),
            joints=field("joints"),
            body_positions=field("body_positions"),
            velocity=field("velocity"),
            angular_velocity=field("angular_velocity"),
            joints_velocity=field("joints_velocity"),
            body_quaternions=packed.new_zeros(packed.shape[:-1] + self._body_quat_shape),
        )

    def _clip_row_base(self, info) -> torch.Tensor:
        """Row offset of each env's clip in the pack, [B] (0: single clip)."""
        return torch.zeros_like(info["start_frame"])

    # ---- sizes -----------------------------------------------------------
    @property
    def dt(self) -> float:
        """Seconds of one control step."""
        return float(self._mj_model.opt.timestep) * self._n_frames

    @property
    def action_size(self) -> int:
        return self.plan.nu

    @property
    def reference_obs_size(self) -> int:
        """Size of the reference half of an observation: the window's
        positions, quaternions, joint distances and body distances."""
        w = self.walker
        return self._ref_len * (3 + 4 + len(w.joint_idxs) + 3 * len(w.body_idxs))

    @property
    def proprioceptive_obs_size(self) -> int:
        """qpos[7:], qvel[6:], qfrc_actuator, torso height, the torso's z
        axis and the end effectors' egocentric positions."""
        p = self.plan
        return (p.nq - 7) + (p.nv - 6) + p.nv + 1 + 3 + 3 * len(self.walker.endeff_idxs)

    @property
    def observation_size(self) -> int:
        return self.reference_obs_size + self.proprioceptive_obs_size

    # ---- pipeline --------------------------------------------------------
    def pipeline_init(self, qpos: torch.Tensor, qvel: torch.Tensor) -> phys_model.Data:
        data = phys_model.make_data(self.plan, self.model, qpos.shape[0])
        data = data.replace(qpos=qpos, qvel=qvel)
        return phys_forward.forward(self.plan, self.model, data)

    def pipeline_step(self, data, ctrl: torch.Tensor) -> phys_model.Data:
        """One control step (n physics substeps) from a full Data or the
        SlimData that the auto-reset wrapper carries."""
        if isinstance(data, phys_forward.SlimData):
            data = phys_forward.expand_slim(self.plan, self.model, data)
        data = data.replace(ctrl=ctrl)
        return phys_forward.n_step(self.plan, self.model, data, self._n_frames)

    # ---- reset -----------------------------------------------------------
    def _uniform(self, rng: mesh.Key, shape) -> torch.Tensor:
        s = self._reset_noise_scale
        return -s + 2 * s * mesh.rand(rng, shape, self.device)

    def reset(self, rng: mesh.Key, batch_size: int) -> State:
        """Single-clip reset: a uniform start frame in the valid range, then
        the qpos and the qvel noise, drawn from `rng` in that order."""
        frame_range = max(self._clip_length - self._random_init_range - self._ref_len, 1)
        start_frame = mesh.randint(rng, 0, frame_range, (batch_size,), self.device)
        qpos_noise = self._uniform(rng, (batch_size, self.plan.nq))
        qvel_noise = self._uniform(rng, (batch_size, self.plan.nv))
        return self.reset_from_clip(start_frame, qpos_noise, qvel_noise)

    def reset_from_clip(
        self,
        start_frame: torch.Tensor,
        qpos_noise: torch.Tensor,
        qvel_noise: torch.Tensor,
        clip_idx: Optional[torch.Tensor] = None,
        noise: bool = True,
    ) -> State:
        """Resets each env to its clip's frame `start_frame` [B] plus
        `qpos_noise` [B, nq] (and qvel to `qvel_noise` [B, nv], or zero
        without `noise`)."""
        bsz = start_frame.shape[0]
        info: Dict[str, Any] = {"start_frame": start_frame.to(self.device, torch.int64)}
        if clip_idx is not None:
            info["clip_idx"] = clip_idx.to(self.device, torch.int64)
        info["prev_ctrl"] = torch.zeros((bsz, self.plan.nu), device=self.device)

        reference_frame = self._get_reference_frame_at(info, info["start_frame"])
        info["reference_frame"] = reference_frame
        new_qpos = torch.cat(
            (reference_frame.position, reference_frame.quaternion, reference_frame.joints), dim=1
        )
        qpos = new_qpos + qpos_noise
        qvel = qvel_noise if noise else torch.zeros_like(qvel_noise)
        data = self.pipeline_init(qpos, qvel)

        reference_obs, proprioceptive_obs = self._get_obs(data, info)
        info["reference_obs_size"] = reference_obs.shape[-1]
        info["proprioceptive_obs_size"] = proprioceptive_obs.shape[-1]
        obs = torch.cat([reference_obs, proprioceptive_obs], dim=1)

        zero = torch.zeros((bsz,), device=self.device)
        metrics = {k: zero for k in METRIC_KEYS}
        info["action_buffer"] = torch.zeros(
            (bsz, self._reward_config.var_window_size, self.plan.nu), device=self.device
        )
        info["buffer_index"] = torch.zeros((bsz,), dtype=torch.int64, device=self.device)
        return State(data, obs, zero, zero, metrics, info)

    # ---- step ------------------------------------------------------------
    def step(self, state: State, action: torch.Tensor) -> State:
        data = self.pipeline_step(state.pipeline_state, action)
        info = dict(state.info)

        reference_frame, ref_traj = self._get_step_reference(info, data)
        info["reference_frame"] = reference_frame
        info["prev_ctrl"] = action
        buffer, idx = info["action_buffer"], info["buffer_index"]
        slot = torch.arange(buffer.shape[1], device=buffer.device)[None, :] == idx[:, None]
        info["action_buffer"] = torch.where(slot[:, :, None], action[:, None, :], buffer)
        info["buffer_index"] = (idx + 1) % self._reward_config.var_window_size

        (
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
            var_cost,
            jerk_cost,
        ) = compute_tracking_rewards(
            data=data,
            reference_frame=reference_frame,
            walker=self.walker,
            action=action,
            info=info,
            reward_config=self._reward_config,
        )

        reference_obs, proprioceptive_obs = self._get_obs_from_traj(data, ref_traj)
        obs = torch.cat([reference_obs, proprioceptive_obs], dim=1)
        reward = (
            joint_reward
            + pos_reward
            + quat_reward
            + angvel_reward
            + bodypos_reward
            + endeff_reward
            - ctrl_cost
            - ctrl_diff_cost
            - energy_cost
            - var_cost
            - jerk_cost
        )
        done = torch.stack([fall, too_far, bad_pose, bad_quat]).amax(0)

        # NaN containment: count NaNs per env over every floating tensor of
        # the Data, and force done where there is one
        reward = torch.nan_to_num(reward)
        obs = torch.nan_to_num(obs)
        nan = self.nan_count(data) > 0
        nan = nan.to(reward.dtype)
        done = torch.maximum(nan, done)

        metrics = dict(state.metrics)
        metrics.update(
            pos_reward=pos_reward,
            quat_reward=quat_reward,
            joint_reward=joint_reward,
            angvel_reward=angvel_reward,
            bodypos_reward=bodypos_reward,
            endeff_reward=endeff_reward,
            ctrl_cost=-ctrl_cost,
            ctrl_diff_cost=-ctrl_diff_cost,
            energy_cost=-energy_cost,
            done=done,
            too_far=too_far,
            bad_pose=bad_pose,
            bad_quat=bad_quat,
            fall=fall,
            nan=nan,
            joint_distance=joint_distance,
            summed_pos_distance=summed_pos_distance,
            quat_distance=quat_distance,
            var_cost=-var_cost,
            jerk_cost=-jerk_cost,
        )
        return state.replace(
            pipeline_state=data, obs=obs, reward=reward, done=done, metrics=metrics, info=info
        )

    @staticmethod
    def nan_count(data) -> torch.Tensor:
        """NaNs per env, [B], over every floating tensor of `data`."""
        count = None
        for f in dataclasses.fields(data):
            t = getattr(data, f.name)
            if t.is_floating_point():
                n = torch.isnan(t).reshape(t.shape[0], -1).sum(1)
                count = n if count is None else count + n
        return count

    # ---- observations ----------------------------------------------------
    def _get_appendages_pos(self, data: phys_model.Data) -> torch.Tensor:
        """End-effector positions in the torso's egocentric frame."""
        torso = self.walker.torso_idx
        positions = data.xpos[:, self.walker.index("endeff", data.xpos.shape[1], data.xpos.device)]
        rel = positions - data.xpos[:, torso, None]
        return torch.matmul(rel, data.xmat[:, torso]).flatten(1)

    def _get_proprioception(self, data: phys_model.Data) -> torch.Tensor:
        """[qpos[7:], qvel[6:], qfrc_actuator, body_height, world_zaxis,
        appendage positions]."""
        torso = self.walker.torso_idx
        return torch.cat(
            [
                data.qpos[:, 7:],
                data.qvel[:, 6:],
                data.qfrc_actuator,
                data.xpos[:, torso, 2:3],
                data.xmat[:, torso].flatten(1)[:, 6:],
                self._get_appendages_pos(data),
            ],
            dim=1,
        )

    def _get_reference_frame_at(self, info, frame: torch.Tensor) -> ReferenceClip:
        """Each env's clip frame at index `frame` [B] (clamped)."""
        row = self._clip_row_base(info) + torch.clamp(frame, 0, self._clip_frames - 1)
        return self._unpack(self._pack[row])

    def _get_reference_trajectory(self, info, data) -> ReferenceClip:
        """The (traj_length,) observation window after the current frame,
        its start clamped into the clip."""
        start = torch.clamp(
            self._get_cur_frame(info, data) + 1, 0, self._clip_frames - self._ref_len
        )
        offs = torch.arange(self._ref_len, device=start.device)
        rows = self._clip_row_base(info)[:, None] + start[:, None] + offs
        return self._unpack(self._pack[rows])

    def _get_step_reference(self, info, data) -> tuple[ReferenceClip, ReferenceClip]:
        """(current reward frame, observation window) from one row gather:
        row 0 the clamped current frame, rows 1..L the clamped window."""
        cur = self._get_cur_frame(info, data)
        frame_row = torch.clamp(cur, 0, self._clip_frames - 1)
        start = torch.clamp(cur + 1, 0, self._clip_frames - self._ref_len)
        offs = torch.arange(self._ref_len, device=cur.device)
        rows = self._clip_row_base(info)[:, None] + torch.cat(
            [frame_row[:, None], start[:, None] + offs], dim=1
        )
        packed = self._pack[rows]
        return self._unpack(packed[:, 0]), self._unpack(packed[:, 1:])

    def _get_obs(self, data: phys_model.Data, info: Dict[str, Any]):
        """(reference_obs, proprioceptive_obs), each [B, ...]."""
        return self._get_obs_from_traj(data, self._get_reference_trajectory(info, data))

    def _get_obs_from_traj(self, data: phys_model.Data, ref_traj: ReferenceClip):
        """Obs assembly from an already-gathered window [B, L, ...]."""
        w = self.walker
        reference_obs = torch.cat(
            [
                w.compute_local_track_positions(ref_traj.position, data.qpos),
                w.compute_quat_distances(ref_traj.quaternion, data.qpos),
                w.compute_local_joint_distances(ref_traj.joints, data.qpos),
                w.compute_local_body_positions(ref_traj.body_positions, data.xpos[:, 1:], data.qpos),
            ],
            dim=1,
        )
        return reference_obs, self._get_proprioception(data)

    def _get_cur_frame(self, info, data) -> torch.Tensor:
        """floor(time * mocap_hz + start_frame) in float32, [B] int64."""
        return torch.floor(data.time * self._mocap_hz + info["start_frame"]).to(torch.int64)


class MultiClipTracking(SingleClipTracking):
    """Multi-clip variant: random clip and start frame on reset."""

    def __init__(
        self,
        reference_clip: Optional[ReferenceClip],
        walker: BaseWalker,
        reward_config: Optional[RewardConfig],
        physics_steps_per_control_step: int,
        reset_noise_scale: float,
        solver: str = "cg",
        iterations: int = 4,
        ls_iterations: int = 4,
        mj_model_timestep: float = 0.002,
        mocap_hz: int = 50,
        clip_length: int = 250,
        random_init_range: int = 50,
        traj_length: int = 5,
        device: torch.device | str = "cuda",
        **kwargs: Any,
    ):
        super().__init__(
            None,
            walker,
            reward_config,
            physics_steps_per_control_step,
            reset_noise_scale,
            solver,
            iterations,
            ls_iterations,
            mj_model_timestep,
            mocap_hz,
            clip_length,
            random_init_range,
            traj_length,
            device=device,
            **kwargs,
        )
        if reference_clip is not None:
            self._reference_clips = reference_clip
            self._n_clips = reference_clip.position.shape[0]
            self._clip_frames = reference_clip.position.shape[1]
            self._build_step_pack(reference_clip, n_leading=2)
        else:
            self._reference_clips = None
            self._n_clips = 0

    def reset(self, rng: mesh.Key, batch_size: int) -> State:
        """Multi-clip reset: start frame from the reference's hard-coded
        44-frame window, a uniform clip, then the qpos and the qvel noise,
        drawn from `rng` in that order."""
        start_frame = mesh.randint(rng, 0, 44, (batch_size,), self.device)
        clip_idx = mesh.randint(rng, 0, self._n_clips, (batch_size,), self.device)
        qpos_noise = self._uniform(rng, (batch_size, self.plan.nq))
        qvel_noise = self._uniform(rng, (batch_size, self.plan.nv))
        return self.reset_from_clip(start_frame, qpos_noise, qvel_noise, clip_idx=clip_idx)

    def _clip_row_base(self, info) -> torch.Tensor:
        return info["clip_idx"] * self._clip_frames


register_environment("rodent_single_clip", SingleClipTracking)
register_environment("rodent_multi_clip", MultiClipTracking)
register_environment("fly_multi_clip", MultiClipTracking)
