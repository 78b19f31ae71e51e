"""The port's learning-check tools against the JAX package's:
tools/long_run_torch.py and tools/train_demo_torch.py hand the port's
`ppo.train` the keyword values that tools/long_run.py and
tools/train_demo.py hand the JAX one (each trainer replaced by a recorder,
the envs built for real: no physics step runs), and a tiny long run on the
CPU writes its records with the JAX tool's keys through the plain
version of cg_solve."""

import functools
import importlib.util
import json
import math
import os
import sys

import pytest
import torch

from torch_parity import REPO
from track_mjx_tpu.agent.mlp_ppo import ppo as jax_ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo as torch_ppo
from track_mjx_tpu_torch.ops import cg_solver_kernel

torch.set_num_threads(1)

# the JAX tool's record keys (tools/long_run.py), then the port's own
JAX_KEYS = ("wall_s", "env_steps_k", "eval_reward", "eval_reward_std", "avg_episode_length", "training_sps",
            "eval_sps")
# what the port's tools pass beyond the JAX ones: where to run, and the
# hook that times each training step (tools/long_run_torch.py's step_sps)
PORT_ONLY = {"long_run": {"device", "batch_callback"}, "train_demo": {"device"}}
# a tiny long run on the CPU: 4 envs, 2 training steps of one unroll of one
# control step, episodes of one control step, full widths
TINY = ["--device", "cpu", "--num-timesteps", "8", "--num-envs", "4", "--num-evals", "2", "--batch-size", "2",
        "--num-minibatches", "2", "--updates-per-batch", "1", "--n-clips", "2", "--clip-length", "6",
        "--random-init-range", "0", "--unroll-length", "1", "--num-eval-envs", "1"]


def load_tool(name: str):
    """tools/<name>.py imported by path (the JAX ones import `bench` from
    the repository's root)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recording_train(calls: list):
    """A stand-in for ppo.train that records its keywords, reports one eval
    and returns as the trainer does."""

    def train(**kwargs):
        calls.append(kwargs)
        kwargs["progress_fn"](0, {"eval/episode_reward": 1.0, "training/sps": 1.0})
        return None, None, {}

    return train


def tool_calls(monkeypatch, tmp_path, name: str, jax_argv: list, port_argv: list) -> tuple:
    """The keywords each package's tool `name` passes its trainer."""
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_ppo, "train", recording_train(jax_calls))
    monkeypatch.setattr(torch_ppo, "train", recording_train(port_calls))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *jax_argv])
    load_tool(name).main()
    load_tool(f"{name}_torch").main(port_argv)
    (jax_kw,), (port_kw,) = jax_calls, port_calls
    return jax_kw, port_kw


def assert_same_call(jax_kw: dict, port_kw: dict, port_only: set) -> None:
    assert set(port_kw) - set(jax_kw) == port_only and set(jax_kw) <= set(port_kw)
    assert port_kw["device"] == "cpu"
    jax_factory, port_factory = jax_kw["network_factory"], port_kw["network_factory"]
    assert isinstance(port_factory, functools.partial)
    assert port_factory.func.__name__ == jax_factory.func.__name__ == "make_intention_ppo_networks"
    assert port_factory.keywords == jax_factory.keywords
    for key in sorted(set(jax_kw) - {"environment", "progress_fn", "network_factory"}):
        assert port_kw[key] == jax_kw[key] and type(port_kw[key]) is type(jax_kw[key]), key


@pytest.mark.parametrize("walker", ["rodent", "fly"])
def test_long_run_passes_the_jax_tools_keywords(monkeypatch, tmp_path, walker):
    """Every keyword of tools/long_run.py's call at its defaults (the
    episode length from each package's own env, the config's learning
    settings, the factory's widths, ckpt_mgr None and the same config_dict)
    is the port tool's, which adds only the device and its step timer."""
    jax_kw, port_kw = tool_calls(
        monkeypatch, tmp_path, "long_run",
        ["--walker", walker, "--out", str(tmp_path / "jax.json")],
        ["--walker", walker, "--out", str(tmp_path / "port.json"), "--device", "cpu"],
    )
    assert_same_call(jax_kw, port_kw, PORT_ONLY["long_run"])
    assert port_kw["episode_length"] == {"rodent": 195, "fly": 545}[walker]
    assert (port_kw["num_envs"], port_kw["batch_size"], port_kw["num_minibatches"],
            port_kw["num_updates_per_batch"], port_kw["unroll_length"]) == (4096, 1024, 16, 4, 20)
    records = json.loads((tmp_path / "port.json").read_text())
    assert set(records[0]) == {*JAX_KEYS, "kernel_launches"}


def test_train_demo_passes_the_jax_tools_keywords(monkeypatch, tmp_path):
    """tools/train_demo_torch.py's call at its defaults is
    tools/train_demo.py's, with the device added."""
    jax_kw, port_kw = tool_calls(monkeypatch, tmp_path, "train_demo", [], ["--device", "cpu"])
    assert_same_call(jax_kw, port_kw, PORT_ONLY["train_demo"])
    assert (port_kw["num_timesteps"], port_kw["num_envs"], port_kw["num_evals"]) == (4_000_000, 512, 6)


def test_tiny_long_run_on_the_cpu(monkeypatch, tmp_path):
    """A tiny long run on the CPU: one record per eval with the JAX tool's
    keys, every number finite, the file equal to what main returns, the
    second epoch's step timings there, no kernel launched and the solve
    through cg_solve's plain version."""
    plain = cg_solver_kernel.cg_solve_plain
    calls = [0]

    def counting(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(cg_solver_kernel, "cg_solve_plain", counting)
    out = tmp_path / "records.json"
    history = load_tool("long_run_torch").main([*TINY, "--out", str(out)])
    assert json.loads(out.read_text()) == history and len(history) == 2
    for i, rec in enumerate(history):
        assert set(rec) == {*JAX_KEYS, "kernel_launches", *(("step_sps",) if i else ())}
        numbers = [v for k, v in rec.items() if k in JAX_KEYS and v is not None] + rec.get("step_sps", [])
        assert all(math.isfinite(v) for v in numbers), rec
        assert not any(rec["kernel_launches"].values()), rec["kernel_launches"]
    assert history[0]["training_sps"] is None and history[1]["training_sps"] > 0
    assert len(history[1]["step_sps"]) == 1  # two training steps: one interval
    assert calls[0] > 0
