"""The collectives between shards that run in one process: the counterpart
of what vs_seg_tpu's sharded.py, spatial.py and halo.py take from jax.lax
(all_gather(tiled=True), axis_index, ppermute's halo rows through
`exchange`, and psum's sum of the window shards' accumulators through
`reduce`) inside shard_map.

`run_spmd(fn, mesh, *args)` runs fn(*args) once per shard of the mesh
(parallel/mesh.py), each in a thread of its own, SPMD style: every thread
runs the ordinary module forward and reads its shard with `axis_index()`.
The threads persist across calls (shard k always runs on worker thread
k): PyTorch keeps some CUDA state per thread, cuDNN's execution plans
among them, which a fresh thread per call would rebuild for every window.
Each thread runs under torch.inference_mode() (thread-local, so entered in
the thread) with its shard's device current and, on CUDA, the stream that
was current on that device in the caller: shards that share a card share
its stream, so their launches (ru_unit's cooperative one among them) run
one after another, never two at once. The shard context (group, rank) is
thread-local.

The shards meet only at the collectives, which copy between the shards'
devices (`Tensor.to`: on CUDA the copy is ordered after the source's
stream and before the destination's). Each collective puts its operand in
the group's slot table and waits at one barrier, then reads the others'.
The table is double-buffered by the collective's sequence number: a shard
can run at most one collective ahead of another (it cannot pass that
collective's barrier alone), so it never overwrites a slot still to be
read. A shard may change an operand in place only after its next
collective. Every barrier wait has a timeout; an exception in one shard
aborts the barrier, so the others stop at their next wait, and run_spmd
raises the first shard's exception (or TimeoutError). `reduce` adds in
the fixed order shard 0 + 1 + ... on shard 0 alone: its result has the
bits psum's would, for N - 1 copies and adds where a psum on every shard
makes N (N - 1). `exchange` hands every shard all the shards' Python
values (ops/halo.py sends both halo directions through one).

`STATS` accumulates the host seconds spent in each collective (its barrier
wait included) and in the barrier waits alone, summed over the shards
(`reset_stats`).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Sequence, Tuple

import torch

DEFAULT_TIMEOUT = 600.0      # seconds a shard may wait at one barrier

_TLS = threading.local()
_RUN_LOCK = threading.Lock()     # one run_spmd at a time owns the workers
_WORKERS: list = []
_STATS_LOCK = threading.Lock()
STATS = {"barrier_s": 0.0, "exchange_s": 0.0, "all_gather_s": 0.0,
         "reduce_s": 0.0, "exchange": 0, "all_gather": 0, "reduce": 0}


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = type(STATS[k])(0)


def _add_stats(**kw) -> None:
    with _STATS_LOCK:
        for k, v in kw.items():
            STATS[k] += v


class Group:
    """The shards of one run_spmd call: their devices, a barrier, the
    double-buffered slot table the collectives exchange through and each
    shard's count of collectives."""

    def __init__(self, mesh: Sequence[torch.device], timeout: float):
        self.mesh = tuple(torch.device(d) for d in mesh)
        self.n = len(self.mesh)
        self.timeout = float(timeout)
        self.barrier = threading.Barrier(self.n)
        self.slots = ([None] * self.n, [None] * self.n)
        self.seq = [0] * self.n

    def wait(self) -> None:
        t = time.perf_counter()
        try:
            self.barrier.wait(self.timeout)
        finally:
            _add_stats(barrier_s=time.perf_counter() - t)

    def exchange(self, rank: int, value) -> list:
        """Every shard's `value`, in rank order."""
        slots = self.slots[self.seq[rank] & 1]
        self.seq[rank] += 1
        slots[rank] = value
        self.wait()
        return list(slots)


def _ctx() -> Tuple[Group, int]:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        raise RuntimeError("a collective was called outside run_spmd")
    return ctx


def in_spmd() -> bool:
    """True inside a shard of run_spmd."""
    return getattr(_TLS, "ctx", None) is not None


def axis_index() -> int:
    """This shard's rank, 0 .. axis_size() - 1."""
    return _ctx()[1]


def axis_size() -> int:
    """The number of shards."""
    return _ctx()[0].n


def exchange(value) -> list:
    """Every shard's `value` (any Python object), in rank order; tensors in
    it stay on their shard's device."""
    t = time.perf_counter()
    group, rank = _ctx()
    values = group.exchange(rank, value)
    _add_stats(exchange_s=time.perf_counter() - t, exchange=1)
    return values


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.lax.all_gather(tiled=True): the shards' x concatenated along
    `dim` in rank order, on this shard's device."""
    t = time.perf_counter()
    group, rank = _ctx()
    values = group.exchange(rank, x)
    out = torch.cat([v.to(x.device) for v in values], dim=dim)
    _add_stats(all_gather_s=time.perf_counter() - t, all_gather=1)
    return out


def reduce(x: torch.Tensor):
    """torch.distributed.reduce to shard 0: the sum of the shards' x on
    shard 0's device, added in rank order, returned on shard 0; None on
    the other shards, which go on after the barrier. Their x must stay
    unchanged until run_spmd returns (shard 0 reads it later)."""
    t = time.perf_counter()
    group, rank = _ctx()
    values = group.exchange(rank, x)
    out = None
    if rank == 0:
        out = x.clone()
        for v in values[1:]:
            out.add_(v.to(x.device))
    _add_stats(reduce_s=time.perf_counter() - t, reduce=1)
    return out


class _Worker:
    """A persistent daemon thread that runs the jobs put on its queue."""

    def __init__(self, k: int):
        self.jobs = queue.SimpleQueue()
        threading.Thread(target=self._loop, daemon=True,
                         name=f"spmd-shard-{k}").start()

    def _loop(self) -> None:
        while True:
            job, done = self.jobs.get()
            try:
                job()
            finally:
                done.set()


def run_spmd(fn, mesh: Sequence[torch.device], *args,
             timeout: float = DEFAULT_TIMEOUT) -> list:
    """fn(*args) once per shard of `mesh`, each in its own thread with its
    shard context; returns the per-shard results in rank order. Raises the
    first shard's exception, or TimeoutError when a shard waited longer
    than `timeout` seconds at a barrier."""
    if in_spmd():
        raise RuntimeError("run_spmd cannot be nested")
    group = Group(mesh, timeout)
    streams = {d: torch.cuda.current_stream(d) for d in set(group.mesh)
               if d.type == "cuda"}
    results = [None] * group.n
    errors = [None] * group.n

    def body(rank: int) -> None:
        dev = group.mesh[rank]
        _TLS.ctx = (group, rank)
        try:
            with contextlib.ExitStack() as stack:
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(streams[dev]))
                stack.enter_context(torch.inference_mode())
                results[rank] = fn(*args)
        except BaseException as e:      # noqa: B902 - re-raised by the caller
            errors[rank] = e
            group.barrier.abort()
        finally:
            _TLS.ctx = None

    with _RUN_LOCK:
        while len(_WORKERS) < group.n:
            _WORKERS.append(_Worker(len(_WORKERS)))
        done = [threading.Event() for _ in range(group.n)]
        for k in range(group.n):
            _WORKERS[k].jobs.put((lambda k=k: body(k), done[k]))
        for d in done:
            d.wait()
    broken = None
    for rank, e in enumerate(errors):
        if e is None:
            continue
        if not isinstance(e, threading.BrokenBarrierError):
            raise e
        broken = broken if broken is not None else rank
    if broken is not None:
        raise TimeoutError(f"shard {broken} of {group.n} waited more than "
                           f"{group.timeout} s at a barrier")
    return results
