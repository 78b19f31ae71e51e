"""The port's clip IO against the JAX package's: synthetic clips (numpy
draws equal, bodies from the port's float64 kinematics against MuJoCo C's),
the .npz round trip, select_clips, the train/test split, and the .h5
reader on a file the JAX package wrote. Also: the port's new modules
import with jax, flax, optax, mujoco, h5py and yaml blocked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import CLIP_FIELDS, REPO
from track_mjx_tpu.io import load as jload
from track_mjx_tpu.io.synthetic import synthesize_clips as jax_synthesize
from track_mjx_tpu.testing import ToyWalker
from track_mjx_tpu_torch.io import load as tload
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import model as tm

torch.set_num_threads(1)
# Body positions and quaternions: the port's kinematics runs in float64 on
# the float32 model parameters, MuJoCo C in float64 on its own; both are
# rounded to float32. Measured up to 3.7e-9 (toy) and 6.0e-8 (rodent).
BODY_ABS = 1e-5


@pytest.fixture(scope="module")
def rodent_walker():
    return torch_parity.load_export_tool().workload_walker("rodent-full-clips")


@pytest.mark.parametrize("name", ["toy", "rodent"])
def test_synthesize_clips_matches_jax(rodent_walker, name):
    if name == "toy":
        m_jax = m_port = ToyWalker()._mj_model
        kw = dict(n_clips=3, n_frames=40, mocap_hz=50, joint_amplitude=0.15, seed=4)
    else:  # the port reads the snapshot, no MuJoCo
        m_jax, m_port = rodent_walker._mj_model, tm.load_snapshot("rodent-full-clips")
        kw = dict(n_clips=2, n_frames=30, mocap_hz=50, seed=1)
    want = jax_synthesize(m_jax, **kw)
    got = synthesize_clips(m_port, device="cpu", **kw)
    for k in CLIP_FIELDS:
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, k
        if k in ("body_positions", "body_quaternions"):
            err = float(np.abs(a.numpy() - b).max())
            assert err < BODY_ABS, f"{k}: {err:.3e}"
        else:  # the same numpy draws and float64 arithmetic
            np.testing.assert_array_equal(a.numpy(), b, err_msg=k)
    assert np.abs(np.asarray(want.body_positions)).max() > 0.01


def _clips(n_clips=10, n_frames=6, seed=0):
    rng = np.random.RandomState(seed)
    shapes = {
        "position": (3,), "quaternion": (4,), "joints": (5,), "body_positions": (4, 3),
        "velocity": (3,), "angular_velocity": (3,), "joints_velocity": (5,), "body_quaternions": (4, 4),
    }
    return {k: rng.normal(size=(n_clips, n_frames) + s).astype(np.float32) for k, s in shapes.items()}


def test_npz_round_trip(tmp_path):
    clip = tload.select_clips(tload.clip_from_numpy(_clips(), device="cpu"), [1, 4, 7])
    path = tmp_path / "clips.npz"
    tload.save_npz(clip, path)
    back = tload.load_data(path, device="cpu")
    for k in CLIP_FIELDS + ("original_clip_idx",):
        assert torch.equal(getattr(back, k), getattr(clip, k)), k


@pytest.mark.parametrize("seed", [0, 3])
def test_split_and_select_match_jax(seed):
    arrays = _clips(n_clips=23)
    jclip = jload.ReferenceClip(**{k: np.asarray(v) for k, v in arrays.items()})
    tclip = tload.clip_from_numpy(arrays, device="cpu")
    jtrain, jtest = jload.generate_train_test_split(jclip, test_ratio=0.3, seed=seed)
    ttrain, ttest = tload.generate_train_test_split(tclip, test_ratio=0.3, seed=seed)
    for jpart, tpart in ((jtrain, ttrain), (jtest, ttest)):
        np.testing.assert_array_equal(tpart.original_clip_idx.numpy(), np.asarray(jpart.original_clip_idx))
        for k in CLIP_FIELDS:
            np.testing.assert_array_equal(getattr(tpart, k).numpy(), np.asarray(getattr(jpart, k)), err_msg=k)
    assert len(ttest.position) == int(23 * 0.3)
    idx = np.array([5, 0, 5, 22])
    jsel, tsel = jload.select_clips(jclip, idx), tload.select_clips(tclip, idx)
    np.testing.assert_array_equal(tsel.original_clip_idx.numpy(), np.asarray(jsel.original_clip_idx))
    np.testing.assert_array_equal(tsel.joints.numpy(), np.asarray(jsel.joints))


def test_h5_reader_reads_the_jax_writer(tmp_path):
    arrays = _clips(n_clips=4)
    path = tmp_path / "clips.h5"
    jload.save_reference_clip_data(jload.ReferenceClip(**arrays), path)
    got = tload.load_data(path, device="cpu")
    want = jload.load_data(path)
    for k in CLIP_FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k)
    # and the port's writer round-trips through the JAX reader
    tload.save_reference_clip_data(got, tmp_path / "again.h5")
    again = jload.load_reference_clip_data(tmp_path / "again.h5")
    np.testing.assert_array_equal(np.asarray(again.body_positions), arrays["body_positions"])


def test_port_imports_with_jax_h5py_and_yaml_blocked(tmp_path):
    """The env, io and agent modules (both pipelines) and chip_smoke.py
    import where none of jax, flax, optax, mujoco, h5py, yaml or the JAX
    package can be imported;
    .npz clips load there, and an .h5 read says what is missing."""
    tload.save_npz(tload.clip_from_numpy(_clips(n_clips=2), device="cpu"), tmp_path / "c.npz")
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'mujoco', 'h5py', 'yaml', 'track_mjx_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import chip_smoke\n"
        "import track_mjx_tpu_torch.envs.wrappers, track_mjx_tpu_torch.envs.task.tracking\n"
        "import track_mjx_tpu_torch.envs.walker.rodent, track_mjx_tpu_torch.io.synthetic\n"
        "import track_mjx_tpu_torch.agent.acting, track_mjx_tpu_torch.agent.mlp_ppo.ppo_networks\n"
        "import track_mjx_tpu_torch.agent.mlp_ppo.intention_network\n"
        "from track_mjx_tpu_torch.io import load\n"
        f"clip = load.load_data({str(tmp_path / 'c.npz')!r}, device='cpu')\n"
        "assert clip.joints.shape == (2, 6, 5)\n"
        "try:\n"
        f"    load.load_data({str(tmp_path / 'c.h5')!r}, device='cpu')\n"
        "except ImportError as e:\n"
        "    assert 'h5py' in str(e)\n"
        "else:\n"
        "    raise AssertionError('an .h5 read without h5py did not raise')\n"
        "import track_mjx_tpu_torch.train, track_mjx_tpu_torch.agent.mlp_ppo.ppo\n"
        "import track_mjx_tpu_torch.envs.walker.fly, track_mjx_tpu_torch.workload, track_mjx_tpu_torch.rollout\n"
        "import track_mjx_tpu_torch.agent.lstm_ppo.ppo, track_mjx_tpu_torch.agent.lstm_ppo.losses\n"
        "import track_mjx_tpu_torch.agent.lstm_ppo.acting, track_mjx_tpu_torch.agent.lstm_ppo.ppo_networks\n"
        "import track_mjx_tpu_torch.agent.lstm_ppo.intention_network, track_mjx_tpu_torch.agent.checkpointing\n"
        "from track_mjx_tpu_torch.utils.config import load_config\n"
        "assert load_config('rodent-full-clips').train_setup.train_config.unroll_length == 20\n"
        "import track_mjx_tpu_torch.agent.network_masks, track_mjx_tpu_torch.testing\n"
        "import track_mjx_tpu_torch.analysis.rollout, track_mjx_tpu_torch.analysis.utils\n"
        "import track_mjx_tpu_torch.physics.postconstraint, track_mjx_tpu_torch.envs.walker.stick\n"
        "assert load_config('rodent-sps-per-actor').train_setup.train_config.num_envs == 8192\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
