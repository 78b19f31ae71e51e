"""Data-parallel training over torch.distributed on the CPU: gloo ranks in
processes of their own, against one process.

Two ranks are spawned once for the module (a FileStore under tmp_path as
the rendezvous, so that test workers never race for a port) and run every
job in turn; the parent meanwhile computes the one-process references.

- Both trainers, 2 ranks x 4 envs against 1 process x 8 envs on the same
  seed, on the toy walker at the JAX package's dry-run shapes and bars
  (`__graft_entry__.dryrun_multichip`): parameters within 5e-4 on the
  contact-free walker, within 1e-2 on the walker with contacts at the
  2-step unroll; the ranks' parameters bit for bit.
- The mesh helpers: a rank's slice, the broadcast, the gather,
  `assert_is_replicated` raising on every rank when one rank is perturbed,
  draws at their global size.
- `running_statistics.update` over 2 ranks against one update over the
  concatenated batch.
- The learning half of 2 ranks, fed the JAX permutations and noises as
  tests/test_torch_trainer.py feeds them, against the JAX learning half at
  that file's tolerances.
- `train.main` with distributed=true on 2 ranks (the rodent at tiny
  widths): rank 0 alone writes the checkpoint and the run-state record,
  both ranks return the same parameters bit for bit; on the LSTM pipeline
  rank 0's checkpoints hold the whole batch's carry.
- The CLI's train/test split (`train.split_clips`) at train_subset_ratio
  0.8 over 40 clips, each rank's numpy stream seeded differently: every
  rank takes rank 0's clips; without a mesh the draw is the JAX CLI's.
- No fallback: distributed=true without a launcher's variables raises, so
  do a world size that does not divide num_envs, `max_devices_per_host`
  below the host's ranks and NCCL asked for two ranks on one device; the
  launcher's variables are read as torchrun's, else SLURM's.
"""

import dataclasses
import functools
import multiprocessing
import os
import sys
import traceback

import numpy as np
import pytest
import torch

from track_mjx_tpu_torch.agent import running_statistics, types
from track_mjx_tpu_torch.agent.lstm_ppo import ppo as lstm_ppo
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as lstm_nets
from track_mjx_tpu_torch.agent.mlp_ppo import losses, ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as mlp_nets
from track_mjx_tpu_torch.envs.base import map_tensors
from track_mjx_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)
WORLD = 2
ENVS = 4 * WORLD  # 4 envs a rank, as the dry run's 4 a device
TIMEOUT_S = 240  # the whole of the ranks' jobs, and each rank's wait at a collective
TINY_NET = dict(intention_latent_size=8, encoder_hidden_layer_sizes=(32,), decoder_hidden_layer_sizes=(32,),
                value_hidden_layer_sizes=(32,))
LSTM_WIDTHS = dict(hidden_state_size=16, hidden_layer_num=2)
# one training step per epoch of 2 unrolls of 4 steps in 2 minibatches, an
# initial eval and one after the epoch (the dry run's `common`)
COMMON = dict(num_timesteps=ENVS * 4 * 2, episode_length=8, ckpt_mgr=None, num_envs=ENVS, num_eval_envs=WORLD,
              seed=0, unroll_length=4, batch_size=ENVS, num_minibatches=2, num_updates_per_batch=1, num_evals=2,
              normalize_observations=True, device="cpu")
# the contact arm: one training step of one 2-step unroll (`common_short`)
SHORT = dict(COMMON, unroll_length=2, num_minibatches=1, num_timesteps=ENVS * 2, num_evals=1)
# arm -> (pipeline, walker, settings, bar on the parameters relative to
# max(1, |one process|)): the dry run's. The rollouts part by roundoff (the
# CPU's float32 matmuls are not bitwise across batch sizes: the policy's
# latent means at the first step differ by 7e-7 between 4 and 8 envs), the
# contacts amplify it about tenfold per env step, and Adam moves a
# parameter by about lr (1e-4) a step whatever its gradient's size, so a
# gradient element near zero that flips its sign parts two runs by up to
# 2 lr a step: 4e-4 after the 2 steps of the contact-free arms (measured
# 4.0e-4 MLP, 3.1e-5 LSTM)
ARMS = {
    "mlp": ("mlp", "smooth", COMMON, 5e-4),
    "mlp_contacts": ("mlp", "contact", SHORT, 1e-2),
    "lstm": ("lstm", "smooth", COMMON, 5e-4),
    "lstm_contacts": ("lstm", "contact", SHORT, 1e-2),
}
# train.main on the rodent at tiny widths: 2 envs a rank, 2 training steps
# of 2 unrolls of 2 steps, an initial eval and one after the epoch
CLI = [
    "device=cpu",
    "distributed=true",
    "reference_config.clip_length=20",
    "reference_config.random_init_range=10",
    "train_setup.train_subset_ratio=null",
    "train_setup.eval_every=16",
    "train_setup.reset_every=16",
    "train_setup.train_config.num_envs=4",
    "train_setup.train_config.num_timesteps=32",
    "train_setup.train_config.batch_size=4",
    "train_setup.train_config.num_eval_envs=2",
    "train_setup.train_config.num_minibatches=2",
    "train_setup.train_config.num_updates_per_batch=2",
    "train_setup.train_config.unroll_length=2",
    "network_config.encoder_layer_sizes=[16]",
    "network_config.decoder_layer_sizes=[16]",
    "network_config.critic_layer_sizes=[16]",
    "network_config.intention_size=4",
]
CLI_LSTM = ["train_setup.train_config.use_lstm=true", "network_config.hidden_state_size=8",
            "network_config.hidden_layer_num=2"]
LEARN_ENVS = 4  # the learning half's batch of tests/test_torch_trainer.py: 2 unrolls x 4 envs
# the split job: 40 clips, 0.8 of them for training, each rank's numpy
# global stream seeded SPLIT_SEED + rank
SPLIT_CLIPS, SPLIT_RATIO, SPLIT_SEED = 40, 0.8, 100


def _factory(pipeline):
    if pipeline == "mlp":
        return functools.partial(mlp_nets.make_intention_ppo_networks, **TINY_NET)
    return functools.partial(lstm_nets.make_intention_ppo_networks, **TINY_NET, **LSTM_WIDTHS)


def _train(pipeline, env, settings, mesh=None):
    """One arm's trainer; its (normalizer, policy state dict)."""
    if pipeline == "mlp":
        out = ppo.train(environment=env, network_factory=_factory("mlp"), mesh=mesh,
                        config_dict={"network_config": {}, "env_config": {"render_interval": 10}}, **settings)
    else:
        out = lstm_ppo.train(environment=env, network_factory=_factory("lstm"), mesh=mesh,
                             config_dict={"network_config": dict(LSTM_WIDTHS), "env_config": {"render_interval": 10}},
                             **settings)
    return out[1]


# ---------------------------------------------------------------------------
# the ranks' jobs (run in the spawned processes: torch and the port only)
# ---------------------------------------------------------------------------


def _job_trainers(mesh, spec):
    envs = spec["envs"]
    return {arm: _train(pipeline, envs[walker], settings, mesh) for arm, (pipeline, walker, settings, _) in ARMS.items()}


def _job_helpers(mesh, spec):
    out = {}
    x = torch.arange(2.0 * ENVS).reshape(ENVS, 2)
    out["slice"] = mesh_lib.shard_batch(x, mesh)
    out["env_slice"] = mesh_lib.env_slice(mesh, ENVS)
    (out["gathered"],) = mesh_lib.gather_batch([out["slice"] * 1], mesh)
    kept = [torch.full((3,), float(mesh.rank)), torch.full((2,), 10 + mesh.rank, dtype=torch.int64)]
    mesh_lib.replicate(kept, mesh)
    out["replicated"] = [k.clone() for k in kept]
    out["host"] = mesh_lib.unreplicate({"kept": kept[0], "steps": 3})
    mesh_lib.assert_is_replicated(kept + [torch.tensor([float("nan")])], mesh, debug="equal")
    if mesh.rank == 1:
        kept[0][1] += 1e-7
    try:
        mesh_lib.assert_is_replicated(kept, mesh, debug="one rank perturbed")
        out["perturbed"] = None
    except AssertionError as e:
        out["perturbed"] = str(e)
    g = torch.Generator().manual_seed(3)
    key = mesh_lib.rows(g, mesh, ENVS)
    out["draws"] = (mesh_lib.rand(key, (ENVS // WORLD, 3), "cpu"), mesh_lib.randint(key, 0, 9, (ENVS // WORLD,), "cpu"),
                    mesh_lib.randn(key, (ENVS // WORLD, 2), "cpu"))
    return out


def _job_normalizer(mesh, spec):
    batch = mesh_lib.shard_batch(torch.as_tensor(spec["observations"]), mesh)
    state = running_statistics.init_state(batch.shape[-1], "cpu")
    for _ in range(2):
        state = running_statistics.update(state, batch, group=mesh)
    return state


def _job_learning_half(mesh, spec):
    """The sharded Learner on this rank's rows of the batch (trajectory =
    unroll * LEARN_ENVS + env) with the JAX draws."""
    learn = spec["learning_half"]
    sizes = learn["sizes"]
    networks = mlp_nets.make_intention_ppo_networks(
        sizes["obs"], sizes["ref"], sizes["act"], preprocess_observations_fn=running_statistics.normalize,
        intention_latent_size=sizes["lat"], encoder_hidden_layer_sizes=(16, 16), decoder_hidden_layer_sizes=(16,),
        value_hidden_layer_sizes=(16, 16), generator=torch.Generator().manual_seed(0), device="cpu",
    )
    networks.policy_network.load_state_dict(learn["policy"])
    networks.value_network.load_state_dict(learn["value"])
    optimizer = torch.optim.Adam([*networks.policy_network.parameters(), *networks.value_network.parameters()],
                                 lr=learn["lr"], betas=(0.9, 0.999), eps=1e-8)
    state = ppo.TrainingState(networks, optimizer, learn["normalizer"], 0)
    loss_fn = functools.partial(losses.compute_ppo_loss, ppo_network=networks, reward_scaling=1.0,
                                kl_schedule=losses.create_ramp_schedule(**learn["schedule"]), **learn["kw"])
    learner = ppo.Learner(loss_fn, optimizer, learn["minibatches"], learn["passes"], mesh=mesh, num_envs=LEARN_ENVS)
    n = LEARN_ENVS // mesh.world_size
    rows = [u * LEARN_ENVS + mesh.rank * n + e for u in range(2) for e in range(n)]
    data = types.Transition(*(map_tensors(lambda x: x[rows], f) for f in learn["batch"]))
    metrics = learner(state, data, learn["it"], draws=learn["draws"])
    return {"policy": networks.policy_network.state_dict(), "value": networks.value_network.state_dict(),
            "normalizer": state.normalizer_params, "metrics": metrics}


def _job_cli(mesh, spec, extra=()):
    from track_mjx_tpu_torch import train
    from track_mjx_tpu_torch.agent import checkpointing, preemption
    from track_mjx_tpu_torch.utils.config import load_config

    writes = []
    save, record = checkpointing.CheckpointManager.save, preemption.RunStateStore.save

    def saving(self, step, *args, **kwargs):
        writes.append(("checkpoint", step))
        return save(self, step, *args, **kwargs)

    def recording(self, *args, **kwargs):
        writes.append(("record", os.path.basename(self.path)))
        return record(self, *args, **kwargs)

    checkpointing.CheckpointManager.save, preemption.RunStateStore.save = saving, recording
    try:
        _, (normalizer, policy) = train.main(load_config("rodent-full-clips", [*spec["cli"], *extra]), mesh=mesh,
                                             policy_params_fn=lambda **_: None)
    finally:
        checkpointing.CheckpointManager.save, preemption.RunStateStore.save = save, record
    return {"normalizer": normalizer, "policy": policy, "writes": writes}


def _job_cli_lstm(mesh, spec):
    """The LSTM pipeline through train.main: every rank takes part in
    gathering the carry that rank 0's checkpoints store."""
    return _job_cli(mesh, spec, [*CLI_LSTM, f"logging_config.model_path={spec['lstm_root']}"])


def _job_split(mesh, spec):
    """The clips train.split_clips selects (their original indices), under
    the mesh and with mesh=None, and generate_train_test_split's, each after
    seeding numpy's global stream with SPLIT_SEED + rank."""
    from track_mjx_tpu_torch import train
    from track_mjx_tpu_torch.io import load

    index = torch.arange(SPLIT_CLIPS, dtype=torch.float32)[:, None]
    clips = load.ReferenceClip(**{k: index.clone() for k in load.CLIP_KEYS})
    setup = {"train_subset_ratio": SPLIT_RATIO}
    out = {}
    for name, split in (("mesh", lambda: train.split_clips(clips, setup, mesh)),
                        ("no_mesh", lambda: train.split_clips(clips, setup, None)),
                        ("generate", lambda: load.generate_train_test_split(clips, test_ratio=1 - SPLIT_RATIO))):
        np.random.seed(SPLIT_SEED + mesh.rank)
        out[name] = tuple(c.original_clip_idx[:, 0].clone() for c in split())
    return out


JOBS = {"helpers": _job_helpers, "normalizer": _job_normalizer, "learning_half": _job_learning_half,
        "trainers": _job_trainers, "cli": _job_cli, "cli_lstm": _job_cli_lstm, "split": _job_split}


def _worker(rank: int, world: int, root: str) -> None:
    """Rank `rank` of `world`: joins the gloo group through the FileStore
    under `root`, runs every job on the spec there and saves the results
    (or the job's traceback) to root/rank<rank>.pt."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      SLURM_JOB_ID="test_torch_distributed")  # one job: the ranks' run-state records would share a name
    import datetime

    from track_mjx_tpu_torch.physics import forward as tf

    tf.set_full_f32()
    mesh = mesh_lib.init_from_env("cpu", init_method=f"file://{os.path.join(root, 'store')}",
                                  timeout=datetime.timedelta(seconds=TIMEOUT_S))
    spec = torch.load(os.path.join(root, "spec.pt"), weights_only=False)
    results = {}
    for name, job in JOBS.items():
        try:
            results[name] = job(mesh, spec)
        except Exception:  # noqa: BLE001 - the test reports it; the other rank may wait at a collective
            results[name] = RuntimeError(f"rank {rank}, job {name}:\n{traceback.format_exc()}")
            break
    torch.save(results, os.path.join(root, f"rank{rank}.pt"))
    mesh_lib.destroy(mesh)


# ---------------------------------------------------------------------------
# the parent: inputs, the spawned ranks, the one-process references
# ---------------------------------------------------------------------------


def _learning_half_inputs():
    """tests/test_torch_trainer.py's batch, JAX parameters, draws and JAX
    learning half; returns (the spec for the ranks, the JAX outputs)."""
    import jax
    import jax.numpy as jnp
    import optax
    import test_torch_trainer as ttt

    from track_mjx_tpu.agent import gradients as jgradients
    from track_mjx_tpu.agent import running_statistics as jrs
    from track_mjx_tpu.agent.mlp_ppo import losses as jlosses
    from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn

    net = jpn.make_intention_ppo_networks(
        ttt.OBS, ttt.REF, ttt.ACT, preprocess_observations_fn=jrs.normalize, intention_latent_size=ttt.LAT,
        encoder_hidden_layer_sizes=(16, 16), decoder_hidden_layer_sizes=(16,), value_hidden_layer_sizes=(16, 16),
    )
    optimizer = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(learning_rate=ttt.LR))
    loss_fn = functools.partial(jlosses.compute_ppo_loss, ppo_network=net, reward_scaling=1.0,
                                kl_schedule=jlosses.create_ramp_schedule(**ttt.SCHEDULE), **ttt.KW)
    update = jgradients.gradient_update_fn(loss_fn, optimizer, pmap_axis_name=None, has_aux=True)

    @jax.jit
    def learn(params, opt_state, normalizer, data, key_sgd, it):  # ppo.py's normalizer update and sgd_step scans
        normalizer = jrs.update(normalizer, data.observation)

        def minibatch_step(carry, mb):
            opt_state, params, key = carry
            key, key_loss = jax.random.split(key)
            (_, metrics), params, opt_state = update(params, normalizer, mb, key_loss, it, optimizer_state=opt_state)
            return (opt_state, params, key), metrics

        def sgd_step(carry, unused_t):
            opt_state, params, key = carry
            key, key_perm, key_grad = jax.random.split(key, 3)
            shuffled = jax.tree.map(
                lambda x: jnp.reshape(jax.random.permutation(key_perm, x), (ttt.M, -1) + x.shape[1:]), data)
            (opt_state, params, _), metrics = jax.lax.scan(minibatch_step, (opt_state, params, key_grad), shuffled)
            return (opt_state, params, key), metrics

        (opt_state, params, _), metrics = jax.lax.scan(sgd_step, (opt_state, params, key_sgd), (), length=ttt.U)
        return params, normalizer, metrics

    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    params = jlosses.PPONetworkParams(policy=net.policy_network.init(k1), value=net.value_network.init(k2))
    normalizer = jrs.init_state(jax.ShapeDtypeStruct((ttt.OBS,), jnp.float32))
    batch, key_sgd, it = ttt._batch(2), jax.random.PRNGKey(6), 1
    state = ttt._port_state(params, normalizer)
    spec = {
        "sizes": {"obs": ttt.OBS, "ref": ttt.REF, "act": ttt.ACT, "lat": ttt.LAT}, "lr": ttt.LR,
        "schedule": ttt.SCHEDULE, "kw": ttt.KW, "minibatches": ttt.M, "passes": ttt.U, "it": it,
        "policy": state.networks.policy_network.state_dict(), "value": state.networks.value_network.state_dict(),
        "normalizer": state.normalizer_params, "batch": tuple(ttt._torch_transition(batch)),
        "draws": ttt._jax_draws(key_sgd),
    }
    jparams, jnormalizer, jmetrics = learn(params, optimizer.init(params), normalizer, ttt._jax_transition(batch),
                                           key_sgd, jnp.float32(it))
    return spec, (state, jparams, jnormalizer, jmetrics)


@pytest.fixture(scope="module")
def toy():
    import torch_parity

    return {walker: torch_parity.toy_envs(contact=walker == "contact", clip_length=40)[1]
            for walker in ("smooth", "contact")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, toy):
    """Spawns the two ranks on the module's spec; yields a function that
    waits for them and returns each rank's results."""
    from track_mjx_tpu_torch.io import load
    from track_mjx_tpu_torch.io.synthetic import synthesize_clips
    from track_mjx_tpu_torch.physics import model as tm

    root = tmp_path_factory.mktemp("ranks")
    clips = synthesize_clips(tm.load_snapshot("rodent-full-clips"), n_clips=2, n_frames=20, mocap_hz=50, seed=0,
                             device="cpu")
    load.save_npz(clips, root / "clips.npz")
    learn_spec, learn_reference = _learning_half_inputs()
    spec = {
        "envs": toy,
        "observations": np.random.RandomState(5).randn(ENVS, 3, 6).astype(np.float32) * 3 + 1,
        "learning_half": learn_spec,
        "cli": [*CLI, f"data_path={root / 'clips.npz'}", f"logging_config.model_path={root / 'ckpts'}"],
        "lstm_root": str(root / "lstm"),
    }
    torch.save(spec, root / "spec.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(rank, WORLD, str(root))) for rank in range(WORLD)]
    for p in procs:
        p.start()
    done = {}

    def results():
        if not done:
            for p in procs:
                p.join(TIMEOUT_S)
            alive = [p.pid for p in procs if p.is_alive()]
            for p in procs:
                p.kill() if p.is_alive() else None
            assert not alive, f"ranks {alive} did not finish in {TIMEOUT_S} s"
            assert [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
            done.update(results=[torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)],
                        root=root, spec=spec, learn_reference=learn_reference)
        return done

    yield results
    for p in procs:
        if p.is_alive():
            p.kill()


def _ranks_job(ranks, name):
    results = ranks()["results"]
    for r in results:
        failed = [v for v in r.values() if isinstance(v, Exception)]
        if failed:
            raise failed[0]
    return [r[name] for r in results]


def _assert_bitwise(a, b, what):
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k} differs between the ranks"


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_ranks_train_as_one_process(ranks, toy, arm):
    """2 ranks x 4 envs against 1 process x 8 envs on the same seed: the
    dry run's check that only the reduction order differs."""
    pipeline, walker, settings, bar = ARMS[arm]
    normalizer, policy = _train(pipeline, toy[walker], settings)
    got = _ranks_job(ranks, "trainers")
    (n0, p0), (n1, p1) = got[0][arm], got[1][arm]
    _assert_bitwise(p0, p1, arm)
    for f in dataclasses.fields(normalizer):
        assert torch.equal(getattr(n0, f.name), getattr(n1, f.name)), f.name
    worst = 0.0
    leaves = [(k, p0[k], policy[k]) for k in policy]
    leaves += [(f.name, getattr(n0, f.name), getattr(normalizer, f.name)) for f in dataclasses.fields(normalizer)]
    for name, a, b in leaves:
        assert torch.isfinite(a).all(), name
        a, b = a.double(), b.double()
        err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        worst = max(worst, err)
        assert err < bar, f"{arm}: {name} differs from one process by {err:.2e} (bar {bar:g})"
    print(f"{arm}: 2 ranks against one process, worst {worst:.2e} (bar {bar:g})")


def test_mesh_helpers(ranks):
    got = _ranks_job(ranks, "helpers")
    x = torch.arange(2.0 * ENVS).reshape(ENVS, 2)
    g = torch.Generator().manual_seed(3)
    draws = (torch.rand((ENVS, 3), generator=g), torch.randint(0, 9, (ENVS,), generator=g),
             torch.randn((ENVS, 2), generator=g))
    for rank, out in enumerate(got):
        n = ENVS // WORLD
        assert out["env_slice"] == slice(rank * n, (rank + 1) * n)
        assert torch.equal(out["slice"], x[rank * n : (rank + 1) * n])
        assert torch.equal(out["gathered"], x)
        assert torch.equal(out["replicated"][0], torch.zeros(3)) and torch.equal(out["replicated"][1],
                                                                                 torch.full((2,), 10))
        assert out["perturbed"] is not None and "one rank perturbed" in out["perturbed"], out["perturbed"]
        assert out["host"]["steps"] == 3 and torch.equal(out["host"]["kept"], torch.zeros(3))
        for got_draw, want in zip(out["draws"], draws):  # each rank's rows of the draws of all 8 envs
            assert torch.equal(got_draw, want[rank * n : (rank + 1) * n])


def test_normalizer_update_over_ranks(ranks):
    obs = torch.as_tensor(ranks()["spec"]["observations"])
    want = running_statistics.init_state(obs.shape[-1], "cpu")
    for _ in range(2):
        want = running_statistics.update(want, obs)
    got = _ranks_job(ranks, "normalizer")
    for f in dataclasses.fields(want):
        a, b, w = (getattr(x, f.name) for x in (*got, want))
        assert torch.equal(a, b), f.name
        assert float((a - w).abs().max()) <= 1e-6 * max(1.0, float(w.abs().max())), f.name  # sums in another order


def test_learning_half_over_ranks_matches_jax(ranks):
    """The 2-rank learning half against the JAX one, at the tolerances of
    tests/test_torch_trainer.py (its `_compare`), and bitwise across the
    ranks."""
    import test_torch_trainer as ttt

    got = _ranks_job(ranks, "learning_half")
    state, jparams, jnormalizer, jmetrics = ranks()["learn_reference"]
    _assert_bitwise(got[0]["policy"], got[1]["policy"], "policy")
    _assert_bitwise(got[0]["value"], got[1]["value"], "value")
    state.networks.policy_network.load_state_dict(got[0]["policy"])
    state.networks.value_network.load_state_dict(got[0]["value"])
    state.normalizer_params = got[0]["normalizer"]
    assert len(got[0]["metrics"]) == ttt.U * ttt.M
    worst = ttt._compare(state, jparams, jnormalizer, got[0]["metrics"], jmetrics)
    print(f"2-rank learning half against JAX: parameters within {worst:.2e} lr")


def test_cli_distributed_writes_on_rank_zero(ranks):
    got = _ranks_job(ranks, "cli")
    root = ranks()["root"]
    assert [kind for kind, _ in got[1]["writes"]] == [], got[1]["writes"]
    assert [w for w in got[0]["writes"] if w[0] == "checkpoint"] == [("checkpoint", 0), ("checkpoint", 1)]
    records = [w for w in got[0]["writes"] if w[0] == "record"]  # the run's, then after each checkpoint
    assert len(records) == 3 and len(set(records)) == 1, records
    (run_dir,) = [p for p in (root / "ckpts").iterdir() if p.is_dir() and p.name != "wandb_local"]
    assert sorted(p.name for p in run_dir.iterdir() if p.is_dir()) == ["PPONetwork_0", "PPONetwork_1"]
    assert not list((root / "ckpts").glob("run_state_*.json")), "the record outlived the run"
    _assert_bitwise(got[0]["policy"], got[1]["policy"], "policy")
    for f in dataclasses.fields(got[0]["normalizer"]):
        assert torch.equal(getattr(got[0]["normalizer"], f.name), getattr(got[1]["normalizer"], f.name)), f.name
    for v in got[0]["policy"].values():
        assert torch.isfinite(v).all()


def test_cli_distributed_lstm_checkpoints_the_whole_carry(ranks):
    """Rank 0's LSTM checkpoints hold the carry of all 4 envs, gathered from
    both ranks (a rank that skipped the gather would leave rank 0 waiting)."""
    from track_mjx_tpu_torch.agent import checkpointing

    got = _ranks_job(ranks, "cli_lstm")
    assert got[1]["writes"] == [] and [w for w in got[0]["writes"] if w[0] == "checkpoint"] == [
        ("checkpoint", 0), ("checkpoint", 1)]
    (run_dir,) = [p for p in (ranks()["root"] / "lstm").iterdir() if p.is_dir() and p.name != "wandb_local"]
    carry = checkpointing.load_training_state(str(run_dir))["hidden_state"]
    assert [tuple(c.shape) for c in carry] == [(4, 2, 8)] * 2
    assert all(torch.isfinite(c).all() for c in carry) and any(c.abs().max() > 0 for c in carry)
    _assert_bitwise(got[0]["policy"], got[1]["policy"], "policy")


def test_ranks_split_the_clips_as_rank_zero(ranks):
    """Each rank's numpy stream differs, yet under a mesh every rank trains
    and evaluates on rank 0's clips; with mesh=None each rank's split is its
    own draw, generate_train_test_split's and the JAX CLI's (the numpy lines
    of track_mjx_tpu/io/load.py's generate_train_test_split)."""
    got = _ranks_job(ranks, "split")
    draws = []
    for rank, out in enumerate(got):
        np.random.seed(SPLIT_SEED + rank)
        indices = np.arange(SPLIT_CLIPS)
        test = np.random.choice(indices, size=int(SPLIT_CLIPS * (1 - SPLIT_RATIO)), replace=False)
        draw = (np.sort(indices[~np.isin(indices, test)]), np.sort(test))
        draws.append(draw)
        for name in ("no_mesh", "generate"):
            for part, want in zip(out[name], draw):
                assert np.array_equal(part.numpy(), want), (rank, name)
    assert not all(np.array_equal(a, b) for a, b in zip(*draws)), "the ranks drew alike: the test shows nothing"
    for rank, out in enumerate(got):
        for part, want in zip(out["mesh"], draws[0]):
            assert np.array_equal(part.numpy(), want), f"rank {rank} does not split the clips as rank 0"
    train, test = got[0]["mesh"]
    assert len(test) == 7 and sorted(train.tolist() + test.tolist()) == list(range(SPLIT_CLIPS))


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID",
                 "SLURM_NTASKS", "SLURM_LOCALID", "SLURM_NTASKS_PER_NODE", "SLURM_STEP_TASKS_PER_NODE",
                 "SLURM_TASKS_PER_NODE", "SLURM_STEP_NODELIST", "SLURM_JOB_ID", "SLURM_NODEID")


def test_cli_distributed_without_a_launcher_raises(monkeypatch, tmp_path):
    from track_mjx_tpu_torch import train
    from track_mjx_tpu_torch.utils.config import load_config

    for name in LAUNCHER_VARS:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        train.main(load_config("rodent-full-clips", ["device=cpu", "distributed=true",
                                                     f"logging_config.model_path={tmp_path}"]))
    assert not torch.distributed.is_initialized()
    assert not list(tmp_path.iterdir()), "a run started without its group"


@pytest.mark.parametrize(
    "environ, want",
    [
        pytest.param(dict(RANK="1", WORLD_SIZE="4", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2", MASTER_ADDR="h",
                          MASTER_PORT="29500", SLURM_PROCID="3", SLURM_NTASKS="8", SLURM_LOCALID="0"),
                     (1, 4, 1, 2, "h", "29500", "torchrun"), id="torchrun first"),
        pytest.param(dict(SLURM_PROCID="5", SLURM_NTASKS="8", SLURM_LOCALID="1", SLURM_STEP_TASKS_PER_NODE="4(x2)",
                          SLURM_NODEID="1", SLURM_STEP_NODELIST="gpu[007-008],x1", SLURM_JOB_ID="4097"),
                     (5, 8, 1, 4, "gpu007", str(4097 % 4096 + 61440), "slurm"), id="slurm"),
        pytest.param(dict(SLURM_PROCID="0", SLURM_NTASKS="2", SLURM_LOCALID="0", SLURM_NTASKS_PER_NODE="2",
                          MASTER_ADDR="m", MASTER_PORT="1234"), (0, 2, 0, 2, "m", "1234", "slurm"),
                     id="slurm with MASTER_ADDR"),
    ],
)
def test_launcher_variables(environ, want):
    assert tuple(mesh_lib.process_env(environ)) == want


@pytest.mark.parametrize(
    "environ, missing",
    [
        (dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0"), "LOCAL_WORLD_SIZE"),
        (dict(SLURM_PROCID="0", SLURM_NTASKS="2"), "SLURM_LOCALID"),
        (dict(SLURM_PROCID="0", SLURM_NTASKS="2", SLURM_LOCALID="0"), "SLURM_NTASKS_PER_NODE"),
        ({}, "SLURM_PROCID"),
    ],
)
def test_a_missing_launcher_variable_is_named(environ, missing):
    with pytest.raises(ValueError, match=missing):
        mesh_lib.process_env(environ)


def test_init_without_a_rendezvous_raises():
    environ = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mesh_lib.init_from_env("cpu", environ=environ)
    assert not torch.distributed.is_initialized()


def test_nccl_refuses_two_ranks_on_one_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    environ = dict(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT="1")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        mesh_lib.init_from_env("cuda", environ=environ)
    assert not torch.distributed.is_initialized()


def _fake_mesh(world_size, local_world_size):
    return mesh_lib.Mesh(None, 0, world_size, 0, local_world_size, torch.device("cpu"), "gloo")


@pytest.mark.parametrize("trainer", [ppo.train, lstm_ppo.train], ids=["mlp", "lstm"])
@pytest.mark.parametrize(
    "mesh, max_devices, match",
    [
        pytest.param((2, 2), 1, "--nproc_per_node", id="max_devices_per_host below the host's ranks"),
        pytest.param((3, 3), None, "world size", id="a world size that does not divide num_envs"),
    ],
)
def test_data_parallel_refusals(toy, trainer, mesh, max_devices, match):
    with pytest.raises(ValueError, match=match):
        trainer(environment=toy["smooth"], mesh=_fake_mesh(*mesh), max_devices_per_host=max_devices, **COMMON)


def test_one_process_takes_any_max_devices_per_host(toy):
    """Without a mesh a process drives one device: any bound of one or more
    devices (or none) trains; the JAX LSTM trainer ignored the argument."""
    _, policy = _train("mlp", toy["smooth"], dict(SHORT, max_devices_per_host=1))
    assert all(torch.isfinite(v).all() for v in policy.values())


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
