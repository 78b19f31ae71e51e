"""Exports a workload's compiled model as the snapshot the torch port loads.

Usage: python tools/export_torch_model.py [--config NAME] [--out FILE.npz]
       python tools/export_torch_model.py --xml FILE_OR_STRING --out FILE.npz
       python tools/export_torch_model.py --probes
       python tools/export_torch_model.py --playback
       python tools/export_torch_model.py --stick [--out FILE.npz]

--xml compiles a MuJoCo XML file (or an XML string) as it is and writes its
snapshot, put_model's fields only. --probes writes the equality and
frictionloss probes of tests/test_equality.py (connect, weld, joint, tendon,
friction) that way to track_mjx_tpu_torch/assets/probes/<name>.npz, a few
KB each, so that a machine without MuJoCo can step them (chip_smoke.py).

--playback writes the playback models that the port's renderer draws the
logging rollout's ghost videos from (track_mjx_tpu_torch/analysis/render.py):
for each workload's walker and scale (the rodent at 0.9 and 0.8, the fly at
1.0), the JAX package's `analysis.render.build_playback_model` (the walker
plus a translucent ghost at GHOST_OFFSET, tracking sites red) goes to
track_mjx_tpu_torch/assets/<walker>_playback_<scale>.npz: put_model's fields
(kinematics and subtree_com run on them) and, under `render.` keys, what
mjv_updateScene reads to draw: per geom its type, size, group and rgba (a
material's rgba where the geom keeps the default one, as the scene does),
per site the same, the cameras (mode, bodies, pos, quat, poscom0, pos0,
mat0, fovy and names), and the free camera's statistics and visual
settings.

--stick writes the stick insect (the JAX package's `Stick` walker,
stick/stick_fast.xml as it stands, at its scale, 1.0) to
track_mjx_tpu_torch/assets/stick.npz: put_model's fields, its joint and body
names in MuJoCo's order under `names.joint` and `names.body` (the port's
`Stick` resolves its config's names against them, as mj_name2id does) and
the scale under `stick.rescale_factor`. No workload config names the stick,
so no JSON goes beside it.

NAME is rodent-full-clips (the default), fly-mc-intention or
rodent-sps-per-actor (the rodent with position actuators at scale 0.8). The
walker is built exactly as envs/task/tracking.py builds it for that workload
(the Rodent or Fly walker with the config's walker_config, then opt.solver /
iterations / ls_iterations / timestep from env_args and a dense jacobian),
and the MjModel fields and `opt` scalars that `put_model` reads, and no
others, are written to track_mjx_tpu_torch/assets/<name>.npz (dashes become
underscores). The fields are found by running the JAX package's put_model on
a proxy that records every attribute it reads, so the snapshot follows
put_model if that changes. Beside them, under `walker.` keys, go the
walker's index tables (joint, body and end-effector ids and the torso's),
which the JAX walker resolves by name with MuJoCo. The whole workload config
(data_path, env_config, reference_config, network_config, train_setup,
logging_config, walker_config) goes to <name>.json beside the snapshot: the
port's `utils.config.load_config` reads it with the standard library, as the
JAX package reads its YAML. This tool needs mujoco and the JAX package; the
port that reads the snapshot needs neither.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("rodent-full-clips", "fly-mc-intention", "rodent-sps-per-actor")
PROBE_DIR = os.path.join(REPO, "track_mjx_tpu_torch", "assets", "probes")
# snapshot name -> the XML's name in tests/test_equality.py
PROBES = {
    "connect": "CONNECT_XML",
    "weld": "WELD_XML",
    "joint": "JOINT_XML",
    "tendon": "TENDON_XML",
    "friction": "FRICTION_XML",
}


def default_out(config: str) -> str:
    return os.path.join(
        REPO, "track_mjx_tpu_torch", "assets", config.replace("-", "_") + ".npz"
    )


class _Recorder:
    """Forwards attribute reads to a MjModel (or its opt struct) and records
    the names read."""

    def __init__(self, obj, prefix: str, names: set):
        self._obj, self._prefix, self._names = obj, prefix, names

    def __getattr__(self, name):
        val = getattr(self._obj, name)
        if name == "opt":
            return _Recorder(val, "opt.", self._names)
        self._names.add(self._prefix + name)
        return val


def workload_walker(config: str):
    """The JAX package's walker of `config`, its MjModel compiled as the
    tracking env compiles it."""
    if config not in CONFIGS:
        raise ValueError(f"unknown config {config!r}; choose from {CONFIGS}")
    sys.path.insert(0, REPO)
    from track_mjx_tpu.envs.task.tracking import _SOLVER_IDS
    from track_mjx_tpu.envs.walker.fly import Fly
    from track_mjx_tpu.envs.walker.rodent import Rodent
    from track_mjx_tpu.utils.config import load_config

    cfg = load_config(config)
    w = cfg.walker_config
    walker_cls = Fly if config == "fly-mc-intention" else Rodent
    walker = walker_cls(
        list(w.joint_names),
        list(w.body_names),
        list(w.end_eff_names),
        torque_actuators=w.torque_actuators,
        rescale_factor=w.rescale_factor,
    )
    args = cfg.env_config.env_args
    m = walker._mj_model
    m.opt.solver = _SOLVER_IDS[args.solver.lower()]
    m.opt.iterations = args.iterations
    m.opt.ls_iterations = args.ls_iterations
    m.opt.timestep = args.mj_model_timestep
    m.opt.jacobian = 0  # dense
    return walker


def workload_model(config: str):
    """The walker's MjModel as the `config` tracking env compiles it."""
    return workload_walker(config)._mj_model


def walker_arrays(walker) -> dict:
    """The walker's index tables under `walker.` keys."""
    return {
        "walker.joint_idxs": np.asarray(walker._joint_idxs, np.int64),
        "walker.body_idxs": np.asarray(walker._body_idxs, np.int64),
        "walker.endeff_idxs": np.asarray(walker._endeff_idxs, np.int64),
        "walker.torso_idx": np.asarray(walker._torso_idx, np.int64),
    }


def export_arrays(config: str) -> dict:
    """Everything the snapshot of `config` holds: put_model's fields and the
    walker's index tables."""
    walker = workload_walker(config)
    return {**snapshot_arrays(walker._mj_model), **walker_arrays(walker)}


def config_sections(config: str) -> dict:
    """The whole of workload config `config`, as plain JSON values."""
    from track_mjx_tpu.utils.config import load_config

    return load_config(config).to_dict()


def snapshot_arrays(m) -> dict:
    """{field: array} for every MjModel field and opt scalar put_model reads."""
    from track_mjx_tpu.physics import model as pm

    names: set = set()
    pm.put_model(_Recorder(m, "", names))
    out = {}
    for name in sorted(names):
        obj = m.opt if name.startswith("opt.") else m
        out[name] = np.array(getattr(obj, name.split(".")[-1]))
    return out


def playbacks() -> list:
    """(walker_name, rescale_factor) of every workload config, once each."""
    from track_mjx_tpu.utils.config import load_config

    out = []
    for config in CONFIGS:
        cfg = load_config(config)
        key = (cfg.env_config.walker_name, float(cfg.walker_config.rescale_factor))
        if key not in out:
            out.append(key)
    return out


def playback_out(walker_name: str, scale: float) -> str:
    return os.path.join(REPO, "track_mjx_tpu_torch", "assets", f"{walker_name}_playback_{scale!r}.npz")


_DEFAULT_RGBA = np.array([0.5, 0.5, 0.5, 1.0], np.float32)


def _scene_rgba(rgba, matid, mat_rgba):
    """The rgba mjv_updateScene draws: the material's where the element
    keeps the default rgba."""
    rgba = np.array(rgba, np.float32)
    for i, mid in enumerate(matid):
        if mid >= 0 and np.array_equal(rgba[i], _DEFAULT_RGBA):
            rgba[i] = mat_rgba[mid]
    return rgba


def render_arrays(m) -> dict:
    """The fields the port's renderer reads beside put_model's, `render.` keys."""
    out = {
        "render.geom_type": np.array(m.geom_type),
        "render.geom_size": np.array(m.geom_size),
        "render.geom_group": np.array(m.geom_group),
        "render.geom_rgba": _scene_rgba(m.geom_rgba, m.geom_matid, m.mat_rgba),
        "render.site_type": np.array(m.site_type),
        "render.site_size": np.array(m.site_size),
        "render.site_group": np.array(m.site_group),
        "render.site_rgba": _scene_rgba(m.site_rgba, m.site_matid, m.mat_rgba),
        "render.cam_names": np.array([m.camera(i).name for i in range(m.ncam)]),
        "render.stat_center": np.array(m.stat.center),
        "render.stat_extent": np.array(m.stat.extent),
        "render.vis_fovy": np.array(m.vis.global_.fovy),
        "render.vis_azimuth": np.array(m.vis.global_.azimuth),
        "render.vis_elevation": np.array(m.vis.global_.elevation),
        "render.vis_znear": np.array(m.vis.map.znear),
    }
    for name in ("cam_mode", "cam_bodyid", "cam_targetbodyid", "cam_pos", "cam_quat", "cam_poscom0", "cam_pos0",
                 "cam_mat0", "cam_fovy"):
        out["render." + name] = np.array(getattr(m, name))
    return out


def playback_model(walker_name: str, scale: float):
    """The JAX package's playback model (walker + ghost) of a walker and scale."""
    sys.path.insert(0, REPO)
    from track_mjx_tpu.analysis.render import build_playback_model

    return build_playback_model(walker_name, scale)


def playback_arrays(walker_name: str, scale: float) -> dict:
    m = playback_model(walker_name, scale)
    return {**snapshot_arrays(m), **render_arrays(m)}


def xml_model(xml: str):
    """The MjModel of an XML file, or of an XML string."""
    import mujoco

    if os.path.exists(xml):
        return mujoco.MjModel.from_xml_path(xml)
    return mujoco.MjModel.from_xml_string(xml)


def probe_xmls() -> dict:
    """{probe name: XML string} of tests/test_equality.py's probes."""
    import importlib.util

    sys.path.insert(0, REPO)
    path = os.path.join(REPO, "tests", "test_equality.py")
    spec = importlib.util.spec_from_file_location("test_equality", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {name: getattr(mod, attr) for name, attr in PROBES.items()}


def stick_arrays() -> dict:
    """The stick's snapshot: put_model's fields, its name tables and scale."""
    sys.path.insert(0, REPO)
    from track_mjx_tpu.envs.walker.stick import Stick

    rescale_factor = 1.0
    m = Stick([], [], [], rescale_factor=rescale_factor)._mj_model
    return {
        **snapshot_arrays(m),
        "names.joint": np.array([m.joint(i).name for i in range(m.njnt)]),
        "names.body": np.array([m.body(i).name for i in range(m.nbody)]),
        "stick.rescale_factor": np.array(float(rescale_factor)),
    }


def stick_out() -> str:
    return os.path.join(REPO, "track_mjx_tpu_torch", "assets", "stick.npz")


def write_snapshot(m, out: str) -> None:
    arrays = snapshot_arrays(m)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {len(arrays)} fields, {os.path.getsize(out)} bytes to {out}")


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=CONFIGS, default="rodent-full-clips")
    ap.add_argument("--xml", default=None, help="an XML file or string to snapshot as it is (needs --out)")
    ap.add_argument("--probes", action="store_true", help="snapshot tests/test_equality.py's probes")
    ap.add_argument("--out", default=None, help="default: the port's assets/<config>.npz")
    ap.add_argument("--playback", action="store_true", help="write the renderer's playback models")
    ap.add_argument("--stick", action="store_true", help="snapshot the stick walker with its name tables")
    args = ap.parse_args(argv[1:])
    if args.stick:
        out = args.out or stick_out()
        arrays = stick_arrays()
        np.savez_compressed(out, **arrays)
        print(f"wrote {len(arrays)} fields, {os.path.getsize(out)} bytes to {out}")
        return
    if args.playback:
        sys.path.insert(0, REPO)
        for walker_name, scale in playbacks():
            out = playback_out(walker_name, scale)
            arrays = playback_arrays(walker_name, scale)
            np.savez_compressed(out, **arrays)
            print(f"wrote {len(arrays)} fields, {os.path.getsize(out)} bytes to {out}")
        return
    if args.probes:
        sys.path.insert(0, REPO)
        for name, xml in probe_xmls().items():
            write_snapshot(xml_model(xml), os.path.join(PROBE_DIR, name + ".npz"))
        return
    if args.xml is not None:
        if args.out is None:
            ap.error("--xml needs --out")
        sys.path.insert(0, REPO)
        write_snapshot(xml_model(args.xml), args.out)
        return
    out = args.out or default_out(args.config)
    arrays = export_arrays(args.config)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {len(arrays)} fields, {os.path.getsize(out)} bytes to {out}")
    json_out = os.path.splitext(out)[0] + ".json"
    with open(json_out, "w") as f:
        json.dump(config_sections(args.config), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote the {args.config} config to {json_out}")


if __name__ == "__main__":
    main(sys.argv)
