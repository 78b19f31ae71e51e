"""Data parallelism over torch.distributed, one process per device.

Port of track_mjx_tpu/parallel/mesh.py. The JAX trainers run one SPMD
program over a Mesh(("batch",)): the env batch sharded along "batch", the
parameters and the normalizer replicated, the collectives inserted by XLA.
Here each rank is a process that drives one device (`cuda:LOCAL_RANK`, or
the CPU) and holds `num_envs / world_size` consecutive envs of the batch;
the trainers call the collectives themselves:

- `init_from_env` sets up the process group from the launcher's variables:
  torchrun's RANK, WORLD_SIZE, LOCAL_RANK and LOCAL_WORLD_SIZE (with
  MASTER_ADDR and MASTER_PORT) first; where they are absent, SLURM's
  SLURM_PROCID, SLURM_NTASKS, SLURM_LOCALID and SLURM_NTASKS_PER_NODE (or
  SLURM_STEP_TASKS_PER_NODE), the address and port being the first host of
  SLURM_STEP_NODELIST and a port from SLURM_JOB_ID, as
  `jax.distributed.initialize` picks them, unless MASTER_ADDR and
  MASTER_PORT are set. A missing variable raises and names it. The backend
  is NCCL on the card and gloo on the CPU unless one is asked for. NCCL
  with more ranks on a host than it has devices raises (NCCL refuses two
  ranks on one device); gloo may share a device, with a warning.
- The collectives are `all_reduce` (a sum) and `broadcast` from rank 0, each
  over one flat buffer per dtype, never one per tensor: they are the two
  that gloo also takes on CUDA tensors. Each is timed on the host with the
  device synchronized around it (`Mesh.collective_s`, `.collective_calls`,
  `.collective_bytes`).
- `Rows` stands for a generator at the port's draw sites (`rand`, `randn`,
  `randint` here, `agent/distribution.standard_normal`): each draw is made
  at its global size and this rank keeps its rows, so that W ranks draw
  what one process of the whole batch draws (the env resets, the rollout's
  noise, the loss's noises of a minibatch's rows).
- `BatchShard` takes the loss's means and its advantage normalization over
  a minibatch whose rows are spread over the ranks.
- `shard_batch`, `replicate`, `assert_is_replicated`, `synchronize_hosts`
  and `unreplicate` are the JAX module's names, with `gather_batch` the
  inverse of `shard_batch`. Each takes the mesh; with None (one process)
  it does what one device needs, mostly nothing.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import time
from typing import Any, Callable, List, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from track_mjx_tpu_torch.envs.base import map_tensors

# a rank waits at its next collective while rank 0 evaluates, logs and
# writes checkpoints: at the reference clip of 250 frames an eval and its
# logging rollout take minutes, beyond NCCL's default of 10
DEFAULT_TIMEOUT = datetime.timedelta(hours=1)


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank of a data-parallel process group: its group, its place in
    the world and on its host, its device and backend, and the host time
    of the collectives it has run."""

    group: Any
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    device: torch.device
    backend: str
    collective_s: float = 0.0
    collective_calls: int = 0
    collective_bytes: int = 0


class ProcessEnv(NamedTuple):
    """A rank's place as its launcher describes it."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    master_addr: Optional[str]
    master_port: Optional[str]
    launcher: str  # "torchrun" or "slurm"


def _var(environ: Mapping[str, str], name: str, launcher: str) -> str:
    value = environ.get(name, "")
    if value == "":
        raise ValueError(f"distributed training under {launcher} needs the environment variable {name}, which is unset")
    return value


def _slurm_tasks_on_node(environ: Mapping[str, str]) -> int:
    """Tasks on this node: SLURM_NTASKS_PER_NODE, or this node's entry
    (SLURM_NODEID) of SLURM_STEP_TASKS_PER_NODE, e.g. "2(x3),1"."""
    if environ.get("SLURM_NTASKS_PER_NODE"):
        return int(environ["SLURM_NTASKS_PER_NODE"])
    for name in ("SLURM_STEP_TASKS_PER_NODE", "SLURM_TASKS_PER_NODE"):
        if environ.get(name):
            counts = []
            for part in environ[name].split(","):
                n, _, repeat = part.partition("(x")
                counts += [int(n)] * (int(repeat.rstrip(")")) if repeat else 1)
            return counts[int(environ.get("SLURM_NODEID", 0))]
    raise ValueError("distributed training under SLURM needs SLURM_NTASKS_PER_NODE or SLURM_STEP_TASKS_PER_NODE, "
                     "which are unset")


def _first_host(node_list: str) -> str:
    """The first host of a SLURM node list ("node[001-004,007],gpu2" ->
    "node001"), as jax's SLURM cluster parses it."""
    cut = next((i for i, ch in enumerate(node_list) if ch in ",["), len(node_list))
    if cut == len(node_list) or node_list[cut] == ",":
        return node_list[:cut]
    suffix = node_list[cut + 1 :]
    end = next((i for i, ch in enumerate(suffix) if ch in ",-]"), len(suffix))
    return node_list[:cut] + suffix[:end]


def process_env(environ: Optional[Mapping[str, str]] = None) -> ProcessEnv:
    """This rank's place from torchrun's variables, else SLURM's (module
    docstring); raises a ValueError that names a missing variable. The
    address and port may be None: they are needed only where no init method
    is given."""
    environ = os.environ if environ is None else environ
    if "RANK" in environ or "WORLD_SIZE" in environ:
        rank, world, local, local_world = (
            int(_var(environ, name, "torchrun")) for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
        )
        addr, port, launcher = environ.get("MASTER_ADDR") or None, environ.get("MASTER_PORT") or None, "torchrun"
    elif "SLURM_PROCID" in environ:
        rank, world, local = (int(_var(environ, name, "SLURM")) for name in ("SLURM_PROCID", "SLURM_NTASKS",
                                                                             "SLURM_LOCALID"))
        local_world = _slurm_tasks_on_node(environ)
        addr = environ.get("MASTER_ADDR") or None
        if addr is None and environ.get("SLURM_STEP_NODELIST"):
            addr = _first_host(environ["SLURM_STEP_NODELIST"])
        port = environ.get("MASTER_PORT") or None
        if port is None and environ.get("SLURM_JOB_ID"):
            port = str(int(environ["SLURM_JOB_ID"]) % 2**12 + (65535 - 2**12 + 1))  # jax's ephemeral range
        launcher = "slurm"
    else:
        raise ValueError(
            "distributed training needs a launcher's variables: RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, "
            "MASTER_ADDR and MASTER_PORT (torchrun), or SLURM_PROCID, SLURM_NTASKS and SLURM_LOCALID (SLURM); "
            "RANK and SLURM_PROCID are unset"
        )
    if not (0 <= rank < world and 0 <= local < local_world <= world):
        raise ValueError(f"rank {rank} of {world}, local rank {local} of {local_world}: not a place in the world")
    return ProcessEnv(rank, world, local, local_world, addr, port, launcher)


def init_from_env(
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
    environ: Optional[Mapping[str, str]] = None,
) -> Mesh:
    """Joins the process group that the launcher's variables describe and
    returns this rank's Mesh. `device` "cuda" puts the rank on
    cuda:LOCAL_RANK with NCCL, "cpu" on the CPU with gloo; `backend` asks
    for another one (gloo on the card: ranks on one host beyond its devices
    share them, cuda:LOCAL_RANK % device count). `init_method` (e.g.
    "file://...") replaces the tcp rendezvous at MASTER_ADDR:MASTER_PORT.
    Raises where a variable is missing, where NCCL would put two ranks on
    one device, and where the group's init fails: nothing falls back to
    one process."""
    penv = process_env(environ)
    device_type = torch.device(device).type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the NCCL backend needs CUDA devices: use gloo on the CPU")
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("distributed training on cuda, but torch sees no CUDA device")
        if penv.local_world_size > count:
            if backend == "nccl":
                raise ValueError(
                    f"NCCL with {penv.local_world_size} ranks on a host of {count} CUDA device(s): NCCL refuses two "
                    f"ranks on one device; launch at most {count} a host (torchrun --nproc_per_node) or ask for gloo"
                )
            logging.warning("%s: %d ranks share this host's %d CUDA device(s)", backend, penv.local_world_size, count)
        dev = torch.device("cuda", penv.local_rank % count)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device_type)
    if init_method is None:
        for name, value in (("MASTER_ADDR", penv.master_addr), ("MASTER_PORT", penv.master_port)):
            if value is None:
                raise ValueError(f"distributed training under {penv.launcher} needs the environment variable {name} "
                                 "(the rendezvous), which is unset")
        init_method = f"tcp://{penv.master_addr}:{penv.master_port}"
    dist.init_process_group(backend=backend, init_method=init_method, rank=penv.rank, world_size=penv.world_size,
                            timeout=timeout)
    logging.info("rank %d of %d (local %d of %d, %s) on %s over %s", penv.rank, penv.world_size, penv.local_rank,
                 penv.local_world_size, penv.launcher, dev, backend)
    return Mesh(dist.group.WORLD, penv.rank, penv.world_size, penv.local_rank, penv.local_world_size, dev, backend)


def destroy(mesh: Optional[Mesh]) -> None:
    """Leaves the process group (nothing without one)."""
    if mesh is not None:
        dist.destroy_process_group()


def is_main(mesh: Optional[Mesh]) -> bool:
    """Whether this process does rank 0's duties (evals, checkpoints, logs)."""
    return mesh is None or mesh.rank == 0


# ---------------------------------------------------------------------------
# collectives over flat buffers
# ---------------------------------------------------------------------------


def _timed(mesh: Mesh, nbytes: int, fn: Callable[[], Any]) -> None:
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize(mesh.device)
    mesh.collective_s += time.perf_counter() - t0
    mesh.collective_calls += 1
    mesh.collective_bytes += nbytes


def _flat_groups(tensors: Sequence[torch.Tensor], device: torch.device) -> List[Tuple[torch.Tensor, List[int]]]:
    """One flat buffer on `device` per dtype of `tensors` (in the order of
    their first appearance), with the indices of the tensors it holds."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return [
        (torch.cat([tensors[i].detach().reshape(-1).to(device) for i in idx]), idx) for idx in groups.values()
    ]


def _chunks(flat: torch.Tensor, idx: List[int], tensors: Sequence[torch.Tensor]):
    offset = 0
    for i in idx:
        n = tensors[i].numel()
        yield i, flat[offset : offset + n].view(tensors[i].shape)
        offset += n


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, one all_reduce per dtype; the sums
    are views of the reduced buffers on the mesh's device. Every rank gets
    the same bits. Without a mesh, the tensors themselves."""
    tensors = list(tensors)
    if mesh is None:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for flat, idx in _flat_groups(tensors, mesh.device):
        _timed(mesh, flat.numel() * flat.element_size(),
               lambda flat=flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group))
        for i, chunk in _chunks(flat, idx, tensors):
            out[i] = chunk
    return out


def _broadcast(groups: List[Tuple[torch.Tensor, List[int]]], mesh: Mesh) -> None:
    """Rank 0's flat buffers into every rank's, in place."""
    for flat, _ in groups:
        _timed(mesh, flat.numel() * flat.element_size(),
               lambda flat=flat: dist.broadcast(flat, src=0, group=mesh.group))


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Rank 0's values copied into every rank's `tensors`, in place (one
    broadcast per dtype). Without a mesh, nothing."""
    if mesh is None:
        return
    tensors = list(tensors)
    groups = _flat_groups(tensors, mesh.device)
    _broadcast(groups, mesh)
    for flat, idx in groups:
        for i, chunk in _chunks(flat, idx, tensors):
            tensors[i].copy_(chunk)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: the same bits, or both NaN."""
    if a.is_floating_point():
        ints = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
        return (a.view(ints) == b.view(ints)) | (torch.isnan(a) & torch.isnan(b))
    return a == b


def assert_is_replicated(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh], debug: Any = None) -> None:
    """Raises an AssertionError with `debug` on every rank unless every
    rank's `tensors` hold rank 0's bits (NaN equal to NaN): rank 0's are
    broadcast, each rank counts its differing elements, and the counts are
    summed. Nothing with one process."""
    if mesh is None or mesh.world_size == 1:
        return
    groups = _flat_groups(list(tensors), mesh.device)
    mine = [flat.clone() for flat, _ in groups]
    _broadcast(groups, mesh)
    differ = sum((~_same_bits(local, flat)).sum().to(torch.float32) for local, (flat, _) in zip(mine, groups))
    (total,) = all_reduce_sum([torch.as_tensor(differ, dtype=torch.float32, device=mesh.device)], mesh)
    if float(total) > 0:
        raise AssertionError(f"state is not replicated ({int(total)} elements differ from rank 0's): {debug}")


def synchronize_hosts(mesh: Optional[Mesh]) -> None:
    """A barrier across the ranks (an all_reduce of one element, then the
    device synchronized). Nothing with one process."""
    if mesh is None:
        return
    all_reduce_sum([torch.ones(1, device=mesh.device)], mesh)


def unreplicate(tree: Any) -> Any:
    """A host (CPU) copy of replicated state: every tensor of `tree`
    (tensors, dicts, tuples, lists, dataclasses) detached and copied."""
    return map_tensors(lambda x: x.detach().cpu().clone(), tree)


# ---------------------------------------------------------------------------
# the env batch across the ranks
# ---------------------------------------------------------------------------


def env_slice(mesh: Optional[Mesh], num_envs: int) -> slice:
    """This rank's envs of a batch of `num_envs`: consecutive, num_envs /
    world_size of them. Raises unless the world size divides num_envs."""
    if mesh is None:
        return slice(0, num_envs)
    if num_envs % mesh.world_size:
        raise ValueError(f"num_envs ({num_envs}) is no multiple of the world size ({mesh.world_size})")
    n = num_envs // mesh.world_size
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_batch(tree: Any, mesh: Optional[Mesh], dim: int = 0) -> Any:
    """This rank's slice along `dim` of every tensor of a global `tree`."""
    if mesh is None:
        return tree
    return map_tensors(
        lambda x: x.narrow(dim, env_slice(mesh, x.shape[dim]).start, x.shape[dim] // mesh.world_size), tree
    )


def gather_batch(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh], dim: int = 0) -> List[torch.Tensor]:
    """The inverse of `shard_batch`: every rank's slices along `dim` joined,
    on every rank (each rank's slice put in zeros, then summed over the
    ranks: exact)."""
    tensors = list(tensors)
    if mesh is None:
        return tensors
    full = []
    for t in tensors:
        shape = list(t.shape)
        shape[dim] *= mesh.world_size
        x = torch.zeros(shape, dtype=t.dtype, device=mesh.device)
        x.narrow(dim, mesh.rank * t.shape[dim], t.shape[dim]).copy_(t)
        full.append(x)
    return all_reduce_sum(full, mesh)


def trajectory_rows(
    mesh: Mesh, trajectories: torch.Tensor, num_envs: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Of global trajectory indices (trajectory = unroll * num_envs + env,
    the trainers' batch layout), those whose env this rank holds: (their
    rows in this rank's batch, unroll * envs_per_rank + local env; their
    positions in `trajectories`)."""
    n = num_envs // mesh.world_size
    env = trajectories % num_envs
    positions = torch.nonzero(env // n == mesh.rank).reshape(-1)
    mine = trajectories[positions]
    return (mine // num_envs) * n + (mine % num_envs) % n, positions


# ---------------------------------------------------------------------------
# draws at their global size
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's rows of the draws from `generator`: each draw is made at
    its global size, `total` along `dim`, and `index` (a slice, or a
    LongTensor of positions) picks this rank's rows. Passed where a
    generator goes (the env's reset, the policy, the loss), it draws the
    same numbers for each row as one process of the whole batch does."""

    generator: torch.Generator
    total: int
    index: Union[slice, torch.Tensor]
    dim: int = 0

    def take(self, shape: Sequence[int], draw: Callable[[Tuple[int, ...]], torch.Tensor]) -> torch.Tensor:
        """`draw(global shape)`'s rows of this rank, for a draw of `shape`."""
        shape = tuple(shape)
        if isinstance(self.index, slice):
            count = len(range(*self.index.indices(self.total)))
        else:
            count = self.index.shape[0]
        if shape[self.dim] != count:
            raise ValueError(f"a draw of {shape[self.dim]} rows along dim {self.dim} from Rows of {count}")
        full = draw(shape[: self.dim] + (self.total,) + shape[self.dim + 1 :])
        if isinstance(self.index, slice):
            return full[(slice(None),) * self.dim + (self.index,)]
        return full.index_select(self.dim, self.index.to(full.device))


def rows(generator: torch.Generator, mesh: Optional[Mesh], num_envs: int):
    """The stand-in for `generator` of a rank holding its env_slice of
    `num_envs` envs: Rows along dim 0, or the generator itself with one
    process (or one rank)."""
    if mesh is None or mesh.world_size == 1:
        return generator
    return Rows(generator, num_envs, env_slice(mesh, num_envs))


Key = Union[torch.Generator, Rows]


def rand(rng: Key, shape: Sequence[int], device) -> torch.Tensor:
    """torch.rand(shape) from a generator, or this rank's rows of it."""
    if isinstance(rng, Rows):
        return rng.take(shape, lambda s: torch.rand(s, generator=rng.generator, device=device))
    return torch.rand(tuple(shape), generator=rng, device=device)


def randn(rng: Key, shape: Sequence[int], device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """torch.randn(shape) from a generator, or this rank's rows of it."""
    if isinstance(rng, Rows):
        return rng.take(shape, lambda s: torch.randn(s, generator=rng.generator, device=device, dtype=dtype))
    return torch.randn(tuple(shape), generator=rng, device=device, dtype=dtype)


def randint(rng: Key, low: int, high: int, shape: Sequence[int], device) -> torch.Tensor:
    """torch.randint(low, high, shape) from a generator, or this rank's rows
    of it."""
    if isinstance(rng, Rows):
        return rng.take(shape, lambda s: torch.randint(low, high, s, generator=rng.generator, device=device))
    return torch.randint(low, high, tuple(shape), generator=rng, device=device)


# ---------------------------------------------------------------------------
# a minibatch spread over the ranks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows of a minibatch of `total` rows. The loss takes its
    means over the batch axis (1 of its time-major tensors) and its
    advantage normalization through it: each rank's share of a mean is its
    sum over the global count, so that the ranks' shares (and their
    gradients) sum to the mean over the whole minibatch. A rank with no
    rows contributes zeros and still takes part in the collectives."""

    mesh: Mesh
    total: int
    dim: int = 1

    def count(self, x: torch.Tensor) -> int:
        return math.prod(s for i, s in enumerate(x.shape) if i != self.dim) * self.total

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of the mean of `x` over the whole minibatch."""
        return x.sum() / self.count(x)

    def normalize(self, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
        """(x - mean) / (std + eps), mean and population std (ddof 0) over
        the whole minibatch: two all-reduced sums."""
        n = self.count(x)
        (total,) = all_reduce_sum([x.sum()], self.mesh)
        mean = total / n
        (squares,) = all_reduce_sum([torch.square(x - mean).sum()], self.mesh)
        return (x - mean) / (torch.sqrt(squares / n) + eps)
