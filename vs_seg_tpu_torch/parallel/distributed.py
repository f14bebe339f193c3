"""Multi-process data parallelism over torch.distributed: the counterpart of
vs_seg_tpu/parallel/distributed.py and of the batch half of
vs_seg_tpu/parallel/mesh.py.

JAX trains data-parallel from one process per host, each driving its local
devices through a (dcn, data) mesh. The port runs one process (a rank) per
GPU: a JAX process maps to a node and a JAX local device to a local rank.

  initialize       joins the process group from torchrun's environment
                   (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
                   GROUP_RANK, MASTER_ADDR, MASTER_PORT), with an explicit
                   timeout; outside torchrun it does nothing. The backend is
                   NCCL when every rank has a CUDA device of its own, gloo on
                   the CPU and when several ranks share one card (NCCL
                   refuses two ranks on one GPU; gloo reduces CUDA tensors
                   through the host). `--device cuda` puts rank r on
                   cuda:LOCAL_RANK; `--device cuda:i` pins every rank to
                   card i (several ranks on one card run the real
                   multi-rank code); `--device cpu` is the CPU.
  Ranks.rows       the rank's rows of a batch (batch_sharding /
                   make_global_batch): a node's batch is split evenly over
                   its local ranks; on one node a batch that does not
                   divide runs whole on every rank, replicated (JAX's
                   to_device_batch falls back to replication); across
                   nodes it raises ValueError, as JAX does.
  shard_files_for_process  the per-node strided split of the training
                   files, the tail wrapping round (JAX's, unchanged).
  batch_stats_group / replicated_batch  the group BatchNorm sums its train
                   statistics over (nn/layers.py:BatchNorm): every rank's
                   when the batch is sharded, none when it is replicated.
  all_reduce_sum   a differentiable sum over the ranks: its backward sums
                   the incoming gradients over the ranks.
  mean_over_ranks, floats_from_rank0, broadcast_from_rank0, rank_generator
                   the Trainer's other exchanges: the epoch loss, the
                   validation metric, a replicated step's gradients and
                   statistics, and each rank's dropout generator.
  launch           runs fn in N spawned processes on this host with
                   torchrun's environment and a local rendezvous; a rank
                   that fails ends every rank.

The gradient reduction itself is DistributedDataParallel's
(train/trainer.py); JAX's GSPMD inserts it from the sharding annotations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import multiprocessing
import os
import pickle
import queue
import socket
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vs_seg_tpu_torch.core.device import resolve_device

DEFAULT_TIMEOUT_S = 1800.0    # a collective's longest wait
EXIT_GRACE_S = 30.0           # launch's wait for a finished rank to exit


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place among the ranks, and its device and backend."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    node: int
    nnodes: int
    device: torch.device
    backend: str

    def rows(self, n: int) -> Tuple[slice, bool]:
        """(this rank's rows of a node batch of n, replicated)."""
        return local_rows(n, self.local_rank, self.local_world, self.nnodes)


def local_rows(n: int, local_rank: int, local_world: int, nnodes: int
               ) -> Tuple[slice, bool]:
    """The rows of a node batch of `n` that local rank `local_rank` of
    `local_world` runs, and whether the batch is replicated: an even split
    when local_world divides n; else, on one node, every row on every rank
    (replicated, vs_seg_tpu/train/trainer.py:to_device_batch's fallback);
    across nodes a ValueError (its multi-host check), since a rank with
    other rows than its share would leave the gradient reduction
    unbalanced."""
    if local_world <= 1:
        return slice(0, n), False
    if n % local_world == 0:
        k = n // local_world
        return slice(local_rank * k, (local_rank + 1) * k), False
    if nnodes > 1:
        raise ValueError(
            f"multi-node: the per-node batch {n} must be a multiple of the "
            f"local rank count {local_world} (pad or drop the final batch)")
    return slice(0, n), True


def shard_files_for_process(files: Sequence, node: int, nnodes: int) -> list:
    """The training files of node `node` of `nnodes`: a strided split, every
    node the same count (a node with an extra batch would wait in a
    collective the others never reach), the tail wrapping round to the
    start (vs_seg_tpu/parallel/distributed.py:shard_files_for_process)."""
    files = list(files)
    if not files or nnodes <= 1:
        return files
    per_node = -(-len(files) // nnodes)
    return [files[(node + nnodes * i) % len(files)] for i in range(per_node)]


def rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: `cuda` (no index) is cuda:local_rank, `cuda:i` is
    card i for every rank, `cpu` the CPU; a missing card is an error
    (core/device.py:resolve_device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def pick_backend(device, local_world: int) -> str:
    """nccl when every rank has a CUDA device of its own (`cuda` with no
    index, or one rank a node), else gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if dev.index is None or local_world == 1 else "gloo"


def initialize(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S
               ) -> Optional[Ranks]:
    """Join the process group that torchrun's environment describes and
    return this process's Ranks; None, doing nothing, outside torchrun (no
    RANK and WORLD_SIZE in the environment)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local_world:
        raise ValueError(f"WORLD_SIZE {world} is not a multiple of "
                         f"LOCAL_WORLD_SIZE {local_world}")
    node = int(os.environ.get("GROUP_RANK", rank // local_world))
    dev = rank_device(device, local_rank)
    backend = pick_backend(device, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    return Ranks(rank=rank, world=world, local_rank=local_rank,
                 local_world=local_world, node=node,
                 nnodes=world // local_world, device=dev,
                 backend=dist.get_backend())


def _world() -> int:
    """The ranks of this process's group (1 outside one)."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# --- BatchNorm's group -------------------------------------------------------

# Process-wide, not thread-local: the backward (and --remat's recompute of
# the forward inside it) runs on autograd's device threads.
_REPLICATED_LOCK = threading.Lock()
_replicated_depth = 0


@contextlib.contextmanager
def replicated_batch():
    """Within: every rank runs the whole batch, so BatchNorm keeps its
    statistics local (the global ones would count each row once per
    rank)."""
    global _replicated_depth
    with _REPLICATED_LOCK:
        _replicated_depth += 1
    try:
        yield
    finally:
        with _REPLICATED_LOCK:
            _replicated_depth -= 1


def batch_stats_group():
    """The group BatchNorm sums its train statistics over: the default one
    when this process is one of several ranks and the batch is sharded;
    None with one rank, outside a group or inside replicated_batch()."""
    if _replicated_depth or _world() <= 1:
        return None
    return dist.group.WORLD


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable: the
    gradient of a rank's `x` is the sum of every rank's gradient of the
    result (each rank's loss depends on every rank's x through it)."""
    return _AllReduceSum.apply(x, group)


def rank_generator(device, seed: int, epoch: int, rank: int
                   ) -> torch.Generator:
    """The dropout generator of `rank` for `epoch` of a sharded run: seeded
    from (seed, epoch, rank), so ranks draw different masks and a resumed
    run draws the masks of an uninterrupted one."""
    word = np.random.SeedSequence([seed, epoch, rank]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(word >> np.uint64(1)))


def mean_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """The mean of a scalar tensor over the ranks (the value itself outside
    a group of several)."""
    world = _world()
    if world == 1:
        return value
    value = value.detach().float().clone()
    dist.all_reduce(value)
    return value / world


def floats_from_rank0(values: Sequence[float], device) -> Tuple[float, ...]:
    """Rank 0's Python floats on every rank (as given outside a group of
    several)."""
    if _world() == 1:
        return tuple(values)
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.broadcast(t, 0)
    return tuple(t.tolist())


def broadcast_from_rank0(tensors: List[torch.Tensor]) -> None:
    """Overwrite `tensors` (one dtype) on every rank with rank 0's, in one
    broadcast."""
    if not tensors:
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.broadcast(flat, 0)
    for t, v in zip(tensors,
                    torch._utils._unflatten_dense_tensors(flat, tensors)):
        t.copy_(v)


# --- the local launcher --------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank: int, env: dict, args: tuple, results) -> None:
    os.environ.update(env)
    try:
        out = fn(*args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, pickle.dumps(out)))
    shutdown()


def _stop(procs, grace_s: float = 5.0) -> None:
    """Terminate, then kill, every process still alive."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(grace_s)
        if p.is_alive():
            p.kill()
            p.join(grace_s)


def launch(fn: Callable, nprocs: int, *args, nnodes: int = 1,
           timeout_s: Optional[float] = None) -> list:
    """fn(*args) in `nnodes * nprocs` processes spawned on this host, each
    with torchrun's environment for its rank (`nnodes` > 1 lays the ranks
    out as that many nodes of `nprocs`, all on this host) and a rendezvous
    on 127.0.0.1. `fn` is importable by name and calls initialize() itself.
    Returns the ranks' results in rank order. A rank that raises or dies
    ends every rank, and launch raises RuntimeError with its traceback;
    past `timeout_s` (None: no limit) every rank is ended and TimeoutError
    raised."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    world = nnodes * nprocs
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = {"RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank % nprocs),
               "LOCAL_WORLD_SIZE": str(nprocs),
               "GROUP_RANK": str(rank // nprocs),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
        procs.append(ctx.Process(target=_child,
                                 args=(fn, rank, env, args, results)))
    out = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=0.1)
            except queue.Empty:
                pass
            else:
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{payload}")
                out[rank] = pickle.loads(payload)
                continue
            for rank, p in enumerate(procs):
                if p.exitcode not in (None, 0) and rank not in out:
                    detail = ""
                    try:    # its traceback may still be on its way
                        r, ok, payload = results.get(timeout=2.0)
                        if not ok:
                            rank, detail = r, payload
                    except queue.Empty:
                        pass
                    raise RuntimeError(
                        f"rank {rank} of {world} exited with code "
                        f"{procs[rank].exitcode}:\n{detail}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout_s} s")
        for p in procs:
            p.join(EXIT_GRACE_S)
    finally:
        _stop(procs)
        results.close()
    return [out[r] for r in range(world)]
