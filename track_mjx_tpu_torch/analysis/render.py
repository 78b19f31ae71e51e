"""Ghost-pair rollout videos from the port's own kinematics.

Port of track_mjx_tpu/analysis/render.py's rollout rendering
(`make_rollout_renderer`, `render_rollout`). The JAX package compiles the
playback model (the walker plus a translucent ghost at GHOST_OFFSET
(-0.2, 0, 0), tracking sites red) with MuJoCo and draws mjv_updateScene's
scene. The port reads that model from a snapshot,
`assets/<walker>_playback_<scale>.npz` (`tools/export_torch_model.py
--playback`), and draws without mujoco or matplotlib:

- the port's kinematics and subtree_com (physics/kinematics.py, com.py)
  run over the doubled qpos (the policy's, then the reference's) of all
  frames at once, as one batch on the renderer's device; the frames' poses
  come to the host once;
- the elements drawn are mjv_updateScene's with the JAX renderer's scene
  option: the geoms of groups 0-2 and the sites of groups 0-4 whose alpha
  is not 0, in the scene's sizes and rgba;
- the camera is the config's `render_camera_name`: a `trackcom` camera
  (mode 2: position subtree_com[cam_bodyid] + cam_poscom0, orientation
  cam_mat0), a fixed one (mode 0: on its body), or with no name MuJoCo's
  default free camera (lookat stat.center, distance 1.5 extent, the visual
  azimuth and elevation). Any other mode raises NotImplementedError.
  MuJoCo's scene camera looks along -z of the camera frame with y up; its
  near plane is vis.map.znear x stat.extent;
- analysis/software_render.py rasterizes each frame.

A frame whose camera is not finite (a trackcom camera on a walker that
blew up) is drawn from the last finite camera pose (empty where there was
none yet), so the ghost stays in view; an element whose pose is not finite
is not drawn.

The JAX module's two plotting helpers, `plot_pca_intention_video` (the PCA
path of a rollout's intentions, drawn by matplotlib, fitted by
scikit-learn, written by imageio) and `display_video` (a notebook's inline
HTML video: imageio, IPython), are the JAX functions with their lazy
imports; without one of their packages they raise an ImportError that names
it (the card's machine has none of matplotlib, scikit-learn, imageio and
IPython, so they run on a workstation, not on the card).
"""

from __future__ import annotations

import base64
import importlib
import logging
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from track_mjx_tpu_torch.analysis.software_render import Camera, SoftwareRenderer, scene_size
from track_mjx_tpu_torch.physics import com, kinematics
from track_mjx_tpu_torch.physics import model as phys_model

CAM_FIXED, CAM_TRACKCOM = 0, 2
CAM_MODES = {0: "fixed", 1: "track", 2: "trackcom", 3: "targetbody", 4: "targetbodycom"}
GEOMGROUP = (1, 1, 1, 0, 0, 0)  # mjvOption's default
SITEGROUP = (1, 1, 1, 1, 1, 0)  # the JAX make_rollout_renderer's scene option
_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def playback_path(walker_name: str, rescale_factor: float) -> str:
    return os.path.join(_ASSETS, f"{walker_name}_playback_{float(rescale_factor)!r}.npz")


def load_playback(walker_name: str, rescale_factor: float) -> Any:
    """The playback snapshot of a walker at a scale (`load_snapshot`'s
    form; the render fields under `snap.render`)."""
    path = playback_path(walker_name, rescale_factor)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no playback snapshot {path}: write it with python tools/export_torch_model.py --playback"
        )
    return phys_model.snapshot_from_file(path)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _visible(groups: np.ndarray, rgba: np.ndarray, shown) -> np.ndarray:
    groups = np.clip(np.asarray(groups), 0, len(shown) - 1)
    return np.nonzero(np.asarray(shown)[groups].astype(bool) & (np.asarray(rgba)[:, 3] > 0))[0]


class RolloutRenderer:
    """Draws frames of the playback model from doubled qposes [T, nq]."""

    def __init__(self, snap: Any, device: torch.device | str = "cuda", height: int = 512, width: int = 512):
        self.snap = snap
        self.plan, self.model = phys_model.put_model(snap, device=device)
        self.device = self.model.qpos0.device
        r = snap.render
        self.geoms = _visible(r.geom_group, r.geom_rgba, GEOMGROUP)
        self.sites = _visible(r.site_group, r.site_rgba, SITEGROUP)
        self.types = np.concatenate([r.geom_type[self.geoms], r.site_type[self.sites]])
        self.sizes = np.concatenate([
            scene_size(r.geom_type[self.geoms], r.geom_size[self.geoms]),
            scene_size(r.site_type[self.sites], r.site_size[self.sites]),
        ])
        self.rgba = np.concatenate([r.geom_rgba[self.geoms], r.site_rgba[self.sites]])
        self.cam_names = [str(n) for n in np.atleast_1d(r.cam_names)]
        self.rasterizer = SoftwareRenderer(height, width)

    def camera_id(self, camera) -> int:
        """A camera's index (-1: the default free camera) from its name or index."""
        if camera is None or camera == -1:
            return -1
        if isinstance(camera, str):
            if camera not in self.cam_names:
                raise ValueError(f"camera {camera!r} not found; have {self.cam_names}")
            return self.cam_names.index(camera)
        return int(camera)

    def poses(self, qpos: torch.Tensor, camera=None) -> Dict[str, np.ndarray]:
        """Per frame: the elements' positions [T, N, 3] and axes [T, N, 3, 3],
        and the camera's eye, forward and up [T, 3], fovy and znear."""
        r = self.snap.render
        cam = self.camera_id(camera)
        qpos = torch.as_tensor(qpos, dtype=torch.float32, device=self.device).reshape(-1, self.plan.nq)
        data = phys_model.make_data(self.plan, self.model, qpos.shape[0]).replace(qpos=qpos)
        data = kinematics.kinematics(self.plan, self.model, data)
        znear = float(r.vis_znear) * float(r.stat_extent)
        geoms = torch.as_tensor(self.geoms, device=self.device)
        sites = torch.as_tensor(self.sites, device=self.device)
        pos = torch.cat([data.geom_xpos[:, geoms], data.site_xpos[:, sites]], dim=1)
        mat = torch.cat([data.geom_xmat[:, geoms], data.site_xmat[:, sites]], dim=1)
        out = {"pos": pos.double().cpu().numpy(), "mat": mat.double().cpu().numpy(), "znear": znear}
        t = qpos.shape[0]
        if cam < 0:  # mjv_defaultFreeCamera
            az, el = np.deg2rad(float(r.vis_azimuth)), np.deg2rad(float(r.vis_elevation))
            fwd = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
            up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az), np.cos(el)])
            eye = np.asarray(r.stat_center, np.float64) - 1.5 * float(r.stat_extent) * fwd
            out.update(eye=np.tile(eye, (t, 1)), forward=np.tile(fwd, (t, 1)), up=np.tile(up, (t, 1)),
                       fovy=float(r.vis_fovy))
            return out
        mode, body = int(r.cam_mode[cam]), int(r.cam_bodyid[cam])
        if mode == CAM_TRACKCOM:
            data = com.com_pos(self.plan, self.model, data)
            eye = data.subtree_com[:, body].double().cpu().numpy() + r.cam_poscom0[cam]
            rot = np.broadcast_to(np.asarray(r.cam_mat0[cam], np.float64).reshape(3, 3), (t, 3, 3))
        elif mode == CAM_FIXED:
            xpos = data.xpos[:, body].double().cpu().numpy()
            xmat = data.xmat[:, body].double().cpu().numpy()
            eye = xpos + xmat @ np.asarray(r.cam_pos[cam], np.float64)
            rot = xmat @ _quat_to_mat(r.cam_quat[cam])
        else:
            raise NotImplementedError(
                f"camera {self.cam_names[cam]!r} has mode {CAM_MODES.get(mode, mode)!r}: the port draws fixed, "
                "trackcom and the default free camera"
            )
        out.update(eye=eye, forward=-rot[..., 2], up=rot[..., 1], fovy=float(r.cam_fovy[cam]))
        return out

    def render(self, qpos: torch.Tensor, camera=None) -> np.ndarray:
        """Frames uint8 [T, H, W, 3] of doubled qposes [T, nq]."""
        p = self.poses(qpos, camera)
        frames = np.empty((len(p["pos"]), self.rasterizer.height, self.rasterizer.width, 3), np.uint8)
        cam = None
        for k in range(len(frames)):
            pose = Camera(p["eye"][k], p["forward"][k], p["up"][k], p["fovy"], p["znear"])
            if all(np.isfinite(v).all() for v in (pose.eye, pose.forward, pose.up)):
                cam = pose
            if cam is None:
                frames[k] = 255
                continue
            frames[k] = self.rasterizer.render(cam, self.types, p["pos"][k], p["mat"][k], self.sizes, self.rgba)
        return frames


def make_rollout_renderer(
    cfg: Any, device: torch.device | str = "cuda", height: int = 512, width: int = 512
) -> RolloutRenderer:
    """The renderer of a config's walker and scale (512 x 512, as the JAX one)."""
    snap = load_playback(cfg["env_config"]["walker_name"], cfg["walker_config"]["rescale_factor"])
    return RolloutRenderer(snap, device=device, height=height, width=width)


def render_rollout(
    cfg: Any,
    rollout: Dict[str, Any],
    height: int = 480,
    width: int = 640,
    device: torch.device | str = "cuda",
) -> Tuple[List[np.ndarray], float]:
    """Frames of saved qposes (`rollout["qposes_rollout"]` beside
    `rollout["qposes_ref"]`, the ghost) and the video's fps: realtime,
    (1 / timestep) / physics_steps_per_control_step, or the config's
    `render_fps`."""
    qpos = np.concatenate([np.asarray(rollout["qposes_rollout"]), np.asarray(rollout["qposes_ref"])], axis=-1)
    renderer = make_rollout_renderer(cfg, device, height, width)
    fps: Optional[float] = cfg["env_config"].get("render_fps")
    if fps is None:
        fps = (1.0 / renderer.snap.opt.timestep) / cfg["env_config"]["env_args"]["physics_steps_per_control_step"]
    frames = renderer.render(torch.as_tensor(qpos, dtype=torch.float32), cfg["env_config"]["render_camera_name"])
    return list(frames), fps


def _require(module: str, package: str, what: str):
    """`import module`, or an ImportError naming the package `what` needs."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs {package}, which is not installed") from e


def _mp4_writable() -> bool:
    """True when imageio has an mp4 backend (ffmpeg) available."""
    try:
        import imageio_ffmpeg  # noqa: F401

        return True
    except ImportError:
        return False


def plot_pca_intention_video(
    intentions: np.ndarray,
    out_path: str,
    fps: int = 25,
    n_components: int = 2,
    trail: int = 50,
) -> str:
    """Writes a video of the PCA-projected intention trajectory [T,
    latents] progressing through time: the whole path faint, the last
    `trail` steps bold, the current point red (as the JAX function, with
    the reference's undefined `pca_embedded` fixed: the embedding is fitted
    once). An mp4 path becomes .gif where imageio has no ffmpeg. Returns the
    path written."""
    matplotlib = _require("matplotlib", "matplotlib", "plot_pca_intention_video")
    matplotlib.use("Agg")
    imageio = _require("imageio", "imageio", "plot_pca_intention_video")
    plt = _require("matplotlib.pyplot", "matplotlib", "plot_pca_intention_video")
    decomposition = _require("sklearn.decomposition", "scikit-learn", "plot_pca_intention_video")

    intentions = np.asarray(intentions)
    embedded = decomposition.PCA(n_components=n_components).fit_transform(intentions)

    if out_path.endswith(".mp4") and not _mp4_writable():
        out_path = out_path[:-4] + ".gif"
        logging.warning("no mp4 backend (ffmpeg); writing %s instead", out_path)

    frames = []
    fig, ax = plt.subplots(figsize=(5, 5))
    for t in range(len(embedded)):
        ax.clear()
        lo = max(0, t - trail)
        ax.plot(embedded[: t + 1, 0], embedded[: t + 1, 1], alpha=0.3, lw=0.5)
        ax.plot(embedded[lo : t + 1, 0], embedded[lo : t + 1, 1], lw=1.5)
        ax.scatter(embedded[t, 0], embedded[t, 1], c="r", s=20)
        ax.set_xlim(embedded[:, 0].min() - 0.5, embedded[:, 0].max() + 0.5)
        ax.set_ylim(embedded[:, 1].min() - 0.5, embedded[:, 1].max() + 0.5)
        ax.set_title(f"intention PCA (t={t})")
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
    plt.close(fig)
    imageio.mimsave(out_path, frames, fps=fps)
    return out_path


def display_video(frames: List[np.ndarray], fps: int = 30):
    """Frames as an inline HTML video for a notebook (an mp4, base64 in a
    <video> tag), or without IPython the base64 text itself, as the JAX
    function."""
    imageio = _require("imageio", "imageio", "display_video")
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
        path = f.name
    imageio.mimsave(path, frames, fps=fps)
    with open(path, "rb") as f:
        data = base64.b64encode(f.read()).decode()
    os.unlink(path)
    try:
        from IPython.display import HTML
    except ImportError:
        return data
    return HTML(f'<video controls autoplay loop src="data:video/mp4;base64,{data}"></video>')
