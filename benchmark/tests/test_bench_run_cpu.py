"""The harness end to end on the CPU at a tiny size (the look for a card
skipped: `run.execute` is called directly), its last line, the import
checks, and `correct` coming out false with the timed path broken
underneath: the learning half's state left unchanged, half of each
minibatch left out with the mean taken over the rest, an update that keeps
every leaf's norm but moves the wrong way, an action altered where it is
produced, an env output altered where it is produced, and physics that
returns its state unchanged."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import run
from benchmark.harness import tiny
from benchmark.tests.test_bench_manifest import ROOT

SEED = 2**33 + 11


def _execute(root, trace_on=False):
    result, checks, notes = run.execute(root, "tiny", SEED, 0.5, trace_on, "cpu", time.perf_counter())
    return result, checks


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(str(tmp_path / "root"))


def test_tiny_run_is_correct_and_well_formed(root):
    result, checks = _execute(root)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"train_sps", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    assert set(checks) == set(line["checks"])
    assert not run.forbidden_modules()


def test_tiny_traced_run(root):
    result, _ = _execute(root, trace_on=True)
    assert result["correct"] is True
    assert {"trainer.rollout_ms", "trainer.sgd_ms", "train.mfu_pct"} <= set(result["metrics"])
    assert "train_sps" not in result["metrics"]
    assert result["device"]["window_s"] > 0


def test_state_left_unchanged_is_not_correct(root, monkeypatch):
    import torch
    from track_mjx_tpu_torch.agent import gradients

    class Still(torch.optim.Adam):
        def step(self, closure=None):
            return None

    monkeypatch.setattr(gradients, "make_optimizer", lambda params, lr: Still(params, lr=lr))
    result, checks = _execute(root)
    assert result["correct"] is False
    assert checks["change_gap"][0] > checks["change_gap"][1]


def test_half_batch_is_not_correct(root, monkeypatch):
    from track_mjx_tpu_torch.agent.mlp_ppo import losses

    full = losses.compute_ppo_loss

    def half(normalizer_params, data, latent_noise, entropy_noise, step, **kw):
        n = data.observation.shape[0] // 2
        cut = type(data)(*(_rows(x, n) for x in data))
        return full(normalizer_params, cut, latent_noise, entropy_noise, step, **kw)

    monkeypatch.setattr(losses, "compute_ppo_loss", half)
    result, checks = _execute(root)
    assert result["correct"] is False
    assert checks["grad_gap"][0] > checks["grad_gap"][1] or checks["loss_gap"][0] > checks["loss_gap"][1]


def test_altered_action_is_not_correct(root, monkeypatch):
    from track_mjx_tpu_torch.agent import acting

    honest = acting.actor_step

    def altered(env, env_state, policy, key, extra_fields=()):
        def bad(obs, k):
            action, extras = policy(obs, k)
            action = action.clone()
            action[0, 0] += 0.5
            return action, extras
        return honest(env, env_state, bad, key, extra_fields=extra_fields)

    monkeypatch.setattr(acting, "actor_step", altered)
    result, checks = _execute(root)
    assert result["correct"] is False
    assert checks["action_gap"][0] > checks["action_gap"][1]


def test_update_keeping_the_norms_is_not_correct(root, monkeypatch):
    """Each step undone and taken the other way: every leaf's change has the
    reference's norm, so only the policy acting with the reference's own
    parameters shows it."""
    import torch
    from track_mjx_tpu_torch.agent import gradients

    class Backwards(torch.optim.Adam):
        def step(self, closure=None):
            before = [p.detach().clone() for g in self.param_groups for p in g["params"]]
            out = super().step(closure)
            with torch.no_grad():
                for p, b in zip((p for g in self.param_groups for p in g["params"]), before):
                    p.copy_(2 * b - p)
            return out

    monkeypatch.setattr(gradients, "make_optimizer", lambda params, lr: Backwards(params, lr=lr))
    result, checks = _execute(root)
    assert result["correct"] is False
    assert checks["action_gap"][0] > checks["action_gap"][1]


def test_altered_env_output_is_not_correct(root, monkeypatch):
    from track_mjx_tpu_torch.envs.task import tracking

    honest = tracking.SingleClipTracking.step

    def altered(self, state, action):
        out = honest(self, state, action)
        return out.replace(reward=out.reward + 0.5)

    monkeypatch.setattr(tracking.SingleClipTracking, "step", altered)
    result, checks = _execute(root)
    assert result["correct"] is False
    assert checks["reward_gap"][0] > checks["reward_gap"][1]


def test_physics_returning_its_state_is_not_correct(root, monkeypatch):
    from track_mjx_tpu_torch.physics import forward

    monkeypatch.setattr(forward, "step", lambda plan, model, data: data)
    result, checks = _execute(root)
    assert result["correct"] is False
    assert checks["substep_gap"][0] > checks["substep_gap"][1]
    assert checks["state_gap"][0] > checks["state_gap"][1]


def _rows(x, n):
    import torch

    if isinstance(x, torch.Tensor):
        return x[:n]
    if isinstance(x, dict):
        return {k: _rows(v, n) for k, v in x.items()}
    return x


def test_the_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload", "rodent-spa-wide",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark import run\nfrom benchmark.harness import tiny\n"
        "root = tiny.make_root(%r)\n"
        "run.execute(root, 'tiny', 5, 0.5, False, 'cpu', time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n" % (ROOT, str(tmp_path / "root"))
    )
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "track_mjx_tpu_torch" in top  # the program ran
    assert not top & {"jax", "jaxlib", "flax", "track_mjx_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    modules = []
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    text = fh.read()
                assert "import track_mjx_tpu" not in text and "from track_mjx_tpu" not in text, path
                rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                modules.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = "import sys; sys.path.insert(0, %r)\n" % ROOT + "".join(f"import {m}\n" for m in modules) + (
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not top & {"track_mjx_tpu_torch", "track_mjx_tpu", "jax", "jaxlib", "flax"}
