"""The torch port's example scripts (examples/torch/00-04) at a tiny size
on the CPU, 02-04 over the checkpoint of a tiny tools/long_run_torch.py run
with --ckpt-dir; and the examples and the learning-check tools import
where jax and the JAX package cannot be imported."""

import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from torch_parity import REPO
from track_mjx_tpu_torch.analysis import utils as h5utils

torch.set_num_threads(1)

EXAMPLES = ("00_smoke_test", "01_env_rollout", "02_rollout_from_checkpoint", "03_decoder_playground",
            "04_analyze_rollouts")
TOOLS = ("long_run_torch", "train_demo_torch")
# one training step of one control step; clips of 6 frames: episodes of one
# control step, an analysis rollout of 5
TINY_RUN = ["--device", "cpu", "--num-timesteps", "4", "--num-envs", "4", "--num-evals", "2", "--batch-size", "2",
            "--num-minibatches", "2", "--updates-per-batch", "1", "--n-clips", "2", "--clip-length", "6",
            "--random-init-range", "0", "--unroll-length", "1", "--num-eval-envs", "1"]


def load_script(path: str):
    spec = importlib.util.spec_from_file_location(f"_script_{os.path.basename(path)[:-3]}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example(name: str):
    return load_script(os.path.join(REPO, "examples", "torch", f"{name}.py"))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("long_run")
    ckpt = root / "ckpt"
    load_script(os.path.join(REPO, "tools", "long_run_torch.py")).main(
        [*TINY_RUN, "--out", str(root / "records.json"), "--ckpt-dir", str(ckpt)])
    return str(ckpt)


@pytest.fixture(scope="module")
def rollout_h5(checkpoint, tmp_path_factory):
    path = tmp_path_factory.mktemp("rollout") / "rollout.h5"
    example("02_rollout_from_checkpoint").main([checkpoint, "1", "--out", str(path), "--device", "cpu"])
    return str(path)


def test_smoke_test(capsys):
    example("00_smoke_test").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "env reset OK; obs size:" in out and "env step OK; reward:" in out
    assert "cg_solve launches (reset and one step): 0" in out


def test_env_rollout(capsys):
    example("01_env_rollout").main(["2", "1", "--device", "cpu", "--frames", "60"])
    out = capsys.readouterr().out
    for key in ("fall", "too_far", "bad_pose", "bad_quat", "nan"):
        assert f"  {key}: " in out
    assert "reference frame index now:" in out and "after 1 random steps x 2 envs:" in out


def test_rollout_from_checkpoint(rollout_h5):
    """The stored config rebuilds the run's env (clips of 6 frames), and the
    whole clip's rollout round-trips through HDF5."""
    data = h5utils.load_from_h5py(rollout_h5)
    assert data["qposes_rollout"].shape == (6, 74) and data["ctrl"].shape == (5, 38)
    assert data["activations"]["intention"].shape == (5, 60)
    assert set(data["rollout_metrics"]) >= {"pos_rewards", "too_fars"}


def test_decoder_playground(checkpoint, capsys):
    module = example("03_decoder_playground")
    module.main([checkpoint, "--steps", "1", "--device", "cpu"])
    module.main([checkpoint, "--steps", "1", "--intentions", "policy", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "1 random-intention steps" in out and "1 policy-intention steps" in out


def test_analyze_rollouts(rollout_h5, tmp_path, capsys):
    example("04_analyze_rollouts").main([rollout_h5, str(tmp_path / "pca.mp4")])
    out = capsys.readouterr().out
    assert "rewards: mean=" in out
    written = [p for p in os.listdir(tmp_path) if p.startswith("pca.")]
    assert written and os.path.getsize(tmp_path / written[0]) > 0


def test_scripts_import_without_jax():
    """The five examples and both tools import with jax and the JAX
    package blocked."""
    paths = [os.path.join(REPO, "examples", "torch", f"{n}.py") for n in EXAMPLES]
    paths += [os.path.join(REPO, "tools", f"{n}.py") for n in TOOLS]
    code = (
        "import importlib.util, sys\n"
        "for m in ('jax', 'flax', 'optax', 'track_mjx_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for i, path in enumerate({paths!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'script{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'track_mjx_tpu.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
