"""Data parallelism on ``torch.distributed``: the port's
``stylish_tts_tpu/parallel/mesh.py``.

The JAX trainer runs one jitted step over a 1-D mesh of every local
device: the state replicated, each batch sharded ``P("data")``; XLA then
takes every reduction of the loss over the global batch and inserts the
gradient all-reduce. Here one process per card (``torchrun``) holds the
whole state and the rows ``[r*B/N, (r+1)*B/N)`` of each global batch
(``shard_rows``: what ``P("data")`` gives device r), and the collectives
are explicit:

* ``pmean_grads(modules)``: one flattened all-reduce (mean) of the
  modules' gradients, after every backward and before the nonfinite
  guard, one for one with the JAX ``ctx.pmean``. A step's generator and
  discriminator phases are separate backward passes over partly frozen
  modules, each followed by its own optimizer updates;
  ``DistributedDataParallel`` reduces in the backward hooks of one wrapped
  module per forward, which fits neither the two phases nor the frozen
  modules, so the port does not use it.
* ``global_sum``, ``global_mean``, ``global_count`` and ``gather_rows``:
  the losses' batch-wide statistics (the TPRLS median, sums and counts,
  spectral convergence's ratio of sums, batch means) over the global
  batch. ``global_sum`` and ``gather_rows`` are autograd functions whose
  backward all-reduces the incoming gradient, the adjoint of their
  forward (as ``torch.distributed.nn.functional.all_reduce``): every
  rank's local gradient is then N times its share, and one
  ``pmean_grads`` after the backward gives exactly the gradient of the
  global-batch loss.
* ``all_mean``: a log interval's metrics or a validation pass's, in one
  collective each.

Failure protocol. Every collective of a step is preceded by a one-flag
MIN all-reduce on a gloo group of the CPU (``agree``). A rank whose step
runs out of memory announces it there (``announce_failure``) instead of
going on, and every other rank's next ``agree`` raises
``PeerStepFailed``: all ranks skip the same batch. A collective's buffers
are allocated before its flag, so a failure never falls between a flag
and its data; a step ends with one more ``agree`` (the trainer's
``_step_or_skip``), so a failure late in a step is seen within it. Any other failure raises on its
own rank, and the others raise when the process group's timeout expires.

Without ``torchrun``'s environment and without explicit arguments no
process group is made: world size 1, and every function here is the
identity (no operation, not even a copy), so the one-card path is bitwise
what it was. A process group of world size 1 is the identity too.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

# collectives run: "data" (all-reduces of tensors on the device) and
# "host" (flags and host values on the CPU group)
COLLECTIVES = {"data": 0, "host": 0}


class PeerStepFailed(RuntimeError):
    """Another rank's step ran out of memory: this rank skips the batch too."""


@dataclass
class _World:
    rank: int
    size: int
    device: torch.device
    host_group: object  # gloo: the flags and host values


_world: Optional[_World] = None


def init_data_parallel(backend: Optional[str] = None, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None, device=None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; returns whether one was made.

    ``rank``, ``world_size`` and ``init_method`` default to ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``env://`` from ``MASTER_ADDR``
    and ``MASTER_PORT``); without ``WORLD_SIZE`` and without arguments there
    is no process group. ``device`` (default ``cuda:LOCAL_RANK``) picks the
    backend: NCCL on a card, gloo on the CPU; ``backend`` overrides it (two
    ranks on one card need gloo: NCCL refuses them). ``timeout_s`` bounds
    every collective, so that a rank that raises ends the others too.
    Where this process is in a group already, a call without arguments
    leaves it as it is (and returns False)."""
    global _world
    explicit = rank is not None or world_size is not None
    if _world is not None:
        if explicit:
            raise RuntimeError("the process group is already initialised")
        return False
    if not explicit and "WORLD_SIZE" not in os.environ:
        return False
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, timeout=timeout)
    host = (dist.group.WORLD if backend == "gloo"
            else dist.new_group(backend="gloo", timeout=timeout))
    _world = _World(rank, world_size, device, host)
    return True


def shutdown() -> None:
    """Leave the process group, where there is one."""
    global _world
    if _world is not None:
        dist.destroy_process_group()
        _world = None


def rank() -> int:
    return 0 if _world is None else _world.rank


def world_size() -> int:
    return 1 if _world is None else _world.size


def is_writer() -> bool:
    """Rank 0 writes the checkpoints, metrics, figures, samples and caches."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier(group=_world.host_group)


def shard_rows(idxs: Sequence) -> Sequence:
    """This rank's contiguous share ``[r*B/N, (r+1)*B/N)`` of a global
    batch (``P("data")``); B must divide by N."""
    n = world_size()
    if n == 1:
        return idxs
    if len(idxs) % n:
        raise ValueError(f"a global batch of {len(idxs)} rows does not divide over "
                         f"{n} ranks")
    k = len(idxs) // n
    return idxs[rank() * k:(rank() + 1) * k]


# ---------------------------------------------------------------- protocol


def _host_all_reduce(values: List[float], op) -> torch.Tensor:
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, op=op, group=_world.host_group)
    COLLECTIVES["host"] += 1
    return t


def agree() -> None:
    """Every rank's go-ahead; raises ``PeerStepFailed`` where another rank
    announced a failure."""
    if world_size() > 1 and _host_all_reduce([1.0], dist.ReduceOp.MIN)[0] < 1.0:
        raise PeerStepFailed("another rank's step ran out of memory")


def announce_failure() -> None:
    """This rank's step failed: the others' next ``agree`` raises."""
    if world_size() > 1:
        _host_all_reduce([0.0], dist.ReduceOp.MIN)



def check_same(name: str, value: float) -> None:
    """Raise unless ``value`` is the same on every rank."""
    if world_size() > 1:
        agree()
        t = _host_all_reduce([value, -value], dist.ReduceOp.MAX)
        if float(t[0]) != -float(t[1]):
            raise RuntimeError(f"{name} differs across ranks: {-float(t[1])} .. "
                               f"{float(t[0])}")


def gather_host(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (a CPU tensor, one shape on every rank) in rank
    order."""
    if world_size() == 1:
        return [t]
    agree()
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t.contiguous(), group=_world.host_group)
    COLLECTIVES["host"] += 1
    return out


# ---------------------------------------------------------------- tensors


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum the allocated buffer ``t`` over the ranks in place, after the
    flag."""
    agree()
    dist.all_reduce(t)
    COLLECTIVES["data"] += 1
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format))


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable: the backward
    all-reduces the gradient (see the module docstring)."""
    return x if world_size() == 1 else _GlobalSum.apply(x)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of a per-rank mean ``x`` (equal shares):
    the global batch's mean, differentiable."""
    return x if world_size() == 1 else global_sum(x) / world_size()


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A count (no gradient) summed over the ranks."""
    if world_size() == 1:
        return x
    with torch.no_grad():
        return _all_reduce(x.detach().clone(memory_format=torch.contiguous_format))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (the global
    batch's order), differentiable: each rank's rows are placed among zeros
    and summed (exact, one nonzero per element)."""
    n = world_size()
    if n == 1:
        return x
    parts = [x if i == rank() else torch.zeros_like(x) for i in range(n)]
    return global_sum(torch.cat(parts))


def all_mean(t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the ranks, no gradient: metrics."""
    if world_size() == 1:
        return t
    with torch.no_grad():
        return _all_reduce(t.detach().clone(memory_format=torch.contiguous_format)) / world_size()


def pmean_grads(modules: Iterable[torch.nn.Module]) -> None:
    """Average the modules' gradients over the ranks: one flattened
    all-reduce (float32 gradients); the counterpart of ``ctx.pmean``."""
    n = world_size()
    if n == 1:
        return
    grads = [p.grad for m in modules for p in m.parameters() if p.grad is not None]
    if not grads:
        return
    if len({g.dtype for g in grads}) != 1:
        raise TypeError("pmean_grads takes gradients of one dtype")
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
