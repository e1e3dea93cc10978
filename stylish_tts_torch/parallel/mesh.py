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

Axes (``parallel/sharding_rules.py``). ``init_axes(data, model)`` splits
the process group into a data axis and a model axis (global rank
``d * model + m``). The data-parallel functions above (``rank``,
``world_size``, ``shard_rows``, ``global_*``, ``gather_rows``,
``all_mean``, ``pmean_grads``) then run over this rank's data group only,
so that the losses and the steps keep their meaning; ``agree``,
``check_same`` and ``gather_host`` stay over the whole group, so that every
rank skips together, and ``is_writer`` is global rank 0. The model axis
has its own functions: ``model_rank``, ``model_size`` and the
differentiable Megatron pair ``copy_to_model`` (identity forward,
all-reduce backward) and ``reduce_from_model`` (all-reduce forward,
identity backward), with ``scatter_to_model`` (a slice whose backward
all-reduces the zero-padded gradient) and ``gather_from_model`` (the
zero-padded all-reduce whose backward takes the slice); ``pmean_grads``
then also gives every rank of a model group model rank 0's gradients of
the replicated parameters, which each rank computed in full (rounding
that differs between processes would otherwise let the copies drift).
Every tensor collective is an ``all_reduce``: gloo carries it on CUDA tensors, so
several ranks can share one card. Without axes, or at model size 1, the
model functions are the identity and the data ones what they were.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

# collectives run: "data" (all-reduces of tensors over the data axis),
# "model" (over the model axis) and "host" (flags and host values on the
# CPU group)
COLLECTIVES = {"data": 0, "model": 0, "host": 0}


class PeerStepFailed(RuntimeError):
    """Another rank's step ran out of memory: this rank skips the batch too."""


@dataclass
class _World:
    rank: int
    size: int
    device: torch.device
    host_group: object  # gloo: the flags and host values
    # the axes (``init_axes``); without them the data axis is the world
    data_rank: int = 0
    data_size: int = 0
    data_group: object = None  # None: the default group
    model_rank: int = 0
    model_size: int = 1
    model_group: object = None


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
    _world = _World(rank, world_size, device, host, data_rank=rank, data_size=world_size)
    return True


def init_axes(data: int, model: int) -> None:
    """Split the process group into ``data`` by ``model`` (global rank
    ``d * model + m``): one group per data row of ``model`` ranks and one
    per model column of ``data`` ranks, made on every rank in one order (a
    collective). A one-rank axis gets no group."""
    n = world_size_global()
    if data * model != n:
        raise ValueError(f"{data} x {model} axes need {data * model} ranks; the process "
                         f"group has {n}")
    if _world is None:
        return
    r = _world.rank
    d, m = divmod(r, model)
    data_group = model_group = None
    if model > 1:
        for col in range(model):
            g = dist.new_group([row * model + col for row in range(data)]) if data > 1 else None
            if col == m:
                data_group = g
        for row in range(data):
            g = dist.new_group([row * model + col for col in range(model)])
            if row == d:
                model_group = g
    _world.data_rank, _world.data_size, _world.data_group = d, data, data_group
    _world.model_rank, _world.model_size, _world.model_group = m, model, model_group


def shutdown() -> None:
    """Leave the process group, where there is one."""
    global _world
    if _world is not None:
        dist.destroy_process_group()
        _world = None


def rank() -> int:
    """This rank on the data axis (the global rank without axes)."""
    return 0 if _world is None else _world.data_rank


def world_size() -> int:
    """The data axis's size (the world's without axes)."""
    return 1 if _world is None else _world.data_size


def world_size_global() -> int:
    return 1 if _world is None else _world.size


def model_rank() -> int:
    return 0 if _world is None else _world.model_rank


def model_size() -> int:
    return 1 if _world is None else _world.model_size


def is_writer() -> bool:
    """Global rank 0 writes the checkpoints, metrics, figures, samples and
    caches."""
    return _world is None or _world.rank == 0


def barrier() -> None:
    if world_size_global() > 1:
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
    if world_size_global() > 1 and _host_all_reduce([1.0], dist.ReduceOp.MIN)[0] < 1.0:
        raise PeerStepFailed("another rank's step ran out of memory")


def announce_failure() -> None:
    """This rank's step failed: the others' next ``agree`` raises."""
    if world_size_global() > 1:
        _host_all_reduce([0.0], dist.ReduceOp.MIN)



def check_same(name: str, value: float) -> None:
    """Raise unless ``value`` is the same on every rank."""
    if world_size_global() > 1:
        agree()
        t = _host_all_reduce([value, -value], dist.ReduceOp.MAX)
        if float(t[0]) != -float(t[1]):
            raise RuntimeError(f"{name} differs across ranks: {-float(t[1])} .. "
                               f"{float(t[0])}")


def gather_host(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (a CPU tensor, one shape on every rank) in global
    rank order."""
    if world_size_global() == 1:
        return [t]
    agree()
    out = [torch.empty_like(t) for _ in range(world_size_global())]
    dist.all_gather(out, t.contiguous(), group=_world.host_group)
    COLLECTIVES["host"] += 1
    return out


# ---------------------------------------------------------------- tensors


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum the allocated buffer ``t`` over the data axis in place, after
    the flag."""
    agree()
    dist.all_reduce(t, group=_world.data_group)
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
    all-reduce (float32 gradients); the counterpart of ``ctx.pmean``. On a
    model axis the replicated parameters' gradients are then made model
    rank 0's on every rank of the group (``sync_replicated_grads``)."""
    modules = list(modules)
    n = world_size()
    if n > 1:
        grads = [p.grad for m in modules for p in m.parameters() if p.grad is not None]
        if grads:
            if len({g.dtype for g in grads}) != 1:
                raise TypeError("pmean_grads takes gradients of one dtype")
            flat = torch.cat([g.reshape(-1) for g in grads])
            _all_reduce(flat)
            flat /= n
            _unflatten(flat, grads)
    if model_size() > 1:
        sync_replicated_grads(modules)


def _unflatten(flat: torch.Tensor, grads: List[torch.Tensor]) -> None:
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def sync_replicated_grads(modules: Iterable[torch.nn.Module]) -> None:
    """Every rank of a model group computes the gradient of each replicated
    parameter in full; rounding that differs between processes (a
    nondeterministic kernel) would let their copies drift apart, so model
    rank 0's gradients are taken on every rank: one flattened all-reduce
    of them, zeros from the other ranks (exact)."""
    grads = []
    for m in modules:
        for sub in m.modules():
            sharded = getattr(sub, "tp_dim", None) is not None
            grads += [p.grad for name, p in sub.named_parameters(recurse=False)
                      if p.grad is not None and not (sharded and name == "weight")]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    if model_rank() != 0:
        flat.zero_()
    _unflatten(_model_all_reduce(flat), grads)


# ---------------------------------------------------------------- model axis


def _model_all_reduce(t: torch.Tensor, op=None) -> torch.Tensor:
    """Reduce ``t`` over the model axis (sum unless ``op``), after the flag;
    a half-precision tensor is summed in float32 (gloo's sums of bf16 are not
    to be relied on) and cast back. Returns the reduced tensor."""
    agree()
    buf = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
    buf = buf.contiguous()
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=_world.model_group)
    COLLECTIVES["model"] += 1
    return buf.to(t.dtype) if buf.dtype != t.dtype else buf


def _slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    k = x.shape[dim] // model_size()
    return x.narrow(dim, model_rank() * k, k)


def _padded(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` placed at this model rank's slice of zeros ``model_size()``
    times as long along ``dim``."""
    shape = list(x.shape)
    shape[dim] *= model_size()
    full = x.new_zeros(shape)
    _slice(full, dim).copy_(x)
    return full


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g.clone(memory_format=torch.contiguous_format))


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _model_all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _slice(x, dim).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(_padded(g, ctx.dim)), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _model_all_reduce(_padded(x, dim))

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim).clone(memory_format=torch.contiguous_format), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` (alike on every model rank) into a model-sharded computation:
    the identity, whose backward sums the ranks' partial gradients."""
    return x if model_size() == 1 else _CopyToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of their partial ``x`` (a row-sharded
    product), consumed alike on every rank: the backward is the identity."""
    return x if model_size() == 1 else _ReduceFromModel.apply(x)


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model ranks of ``x``, consumed by model-sharded
    computations (GRN's channel mean): forward and backward all-reduce."""
    return x if model_size() == 1 else copy_to_model(reduce_from_model(x))


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's contiguous slice of ``x`` (alike on every rank)
    along ``dim``; the backward all-reduces the zero-padded gradient, so the
    whole of ``x`` gets the full gradient on every rank."""
    if model_size() == 1:
        return x
    if x.shape[dim] % model_size():
        raise ValueError(f"a dim of {x.shape[dim]} does not divide over {model_size()} "
                         "model ranks")
    return _ScatterToModel.apply(x, dim % x.dim())


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` in rank order (a
    zero-padded all-reduce), consumed alike on every rank: the backward
    takes this rank's slice."""
    return x if model_size() == 1 else _GatherFromModel.apply(x, dim % x.dim())


def gather_model_tensor(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``gather_from_model`` without autograd: a sharded tensor's full value."""
    if model_size() == 1:
        return x
    with torch.no_grad():
        return _model_all_reduce(_padded(x.detach(), dim % x.dim()))


def model_all_min(t: torch.Tensor) -> torch.Tensor:
    """``t`` (no gradient) at its least over the model ranks."""
    if model_size() == 1:
        return t
    return _model_all_reduce(t.detach().clone(), dist.ReduceOp.MIN)
