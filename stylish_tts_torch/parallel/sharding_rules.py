"""2-D and hybrid meshes: the port's ``stylish_tts_tpu/parallel/sharding_rules.py``.

A ("data", "model") mesh, or a ("dcn", "data", "model") one, over the
ranks of a ``torch.distributed`` process group. Global rank
``r = (s * data + d) * model + m`` (the JAX ``np.reshape`` of the device
list): the batch's rows split over the joint data rank ``s * data + d``
(``P(DATA_AXIS)``, or ``P((DCN_AXIS, DATA_AXIS))`` on the hybrid mesh, whose
two data axes are one data group here), and the kernels that ``_RULES``
names split over the model axis, Megatron style:

* column rule (flax axis -1, torch dim 0: output features): each model rank
  holds a contiguous slice of the outputs and computes that slice;
* row rule (flax axis -2, torch dim 1: input features): each model rank
  holds the matching slice of the inputs, computes a partial product, and
  one ``reduce_from_model`` sums them; the bias is added once after it.

The rules table and ``spec_for_leaf`` are the JAX module's, over the JAX
``TrainState``'s own leaf paths (``params/<module>/params/<flax path>``,
from the weight bridge's ``flax_layout``). The discriminator rules are
anchored with ``^``, which no state path matches, so every discriminator
stays replicated in the step, as it does in JAX (``scripts/audit_sharding.py``
prepends the module's name, a view in which they would shard:
``spec_for_leaf(..., audit=True)``).

``shard_state`` is ``jax.device_put(state, state_shardings(state, mesh))``:
each sharded parameter becomes its shard (its AdamW moments, made after it,
are then the shard's own, as JAX's ``mu`` and ``nu``), and its module is
marked (``tp_dim``) so that its forward computes the Megatron way
(``models/common.py``). Everything else stays replicated. ``gather_state``
reads the full tensors back. ``parallel_2d_step`` and
``parallel_hybrid_step`` run a port step with the batch's rows split by the
joint data rank; the metrics come out the same on every rank.

Collectives are all ``all_reduce`` (``parallel/mesh.py``): gloo carries it
on CUDA tensors, which lets several ranks share one card (NCCL refuses
two ranks on one device).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..convert.from_jax import flax_layout, module_jax_shapes
from . import mesh as _mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"

# (path regex, feature axis to shard): -1 = output features, -2 = input.
# Rules come in megatron column/row pairs wherever an elementwise
# nonlinearity separates an expansion from a contraction, so the pair
# needs ONE all-reduce (on the contraction output) and no resharding
# in between.  Unpairable kernels (depthwise convs, norm-separated
# stacks like the text-encoder prenet) stay replicated — GroupNorm /
# LayerNorm over the full feature axis would force an all-gather per
# layer, costing more ICI than the FLOPs saved.
_RULES = [
    # ConvNeXt pointwise pair (generator trunks, duration predictor)
    (r"pwconv1/kernel$", -1),
    (r"pwconv2/kernel$", -2),
    # conv-FFN pair (text encoder, prosody encoder)
    (r"ffn_\d+/conv1/Conv_0/kernel$", -1),
    (r"ffn_\d+/conv2/Conv_0/kernel$", -2),
    # attention head/out pairs
    (r"attn_\d+/(q|k|v)/kernel$", -1),
    (r"attn_\d+/out/kernel$", -2),
    (r"attn/(to_q|to_kv)/kernel$", -1),
    (r"attn/to_out/kernel$", -2),
    (r"cross_attention/(q|k|v)/kernel$", -1),
    (r"cross_attention/out/kernel$", -2),
    # conformer feed-forward pairs
    (r"(ff1|ff2)/Dense_0/kernel$", -1),
    (r"(ff1|ff2)/Dense_1/kernel$", -2),
    # AdaIN decoder / generator residual conv pairs (leaky/snake between)
    (r"(encode|decode_\d+)/conv1/Conv_0/kernel$", -1),
    (r"(encode|decode_\d+)/conv2/Conv_0/kernel$", -2),
    (r"conv1_\d+/Conv_0/kernel$", -1),
    (r"conv2_\d+/Conv_0/kernel$", -2),
    # pitch/energy twin AdaIN heads
    (r"(f0|n)_\d+/conv1/Conv_0/kernel$", -1),
    (r"(f0|n)_\d+/conv2/Conv_0/kernel$", -2),
    # style-encoder ResBlk pair (leaky between; the depthwise 'down'
    # shards along the same column-sharded features)
    (r"res_\d+/conv1/kernel$", -1),
    (r"res_\d+/down/kernel$", -1),
    (r"res_\d+/conv2/kernel$", -2),
    # style-encoder head: post conv column, output Dense row (global
    # average pool between is feature-elementwise)
    (r"core/post/kernel$", -1),
    (r"core/out/kernel$", -2),
    # aligner FFN stack: alternate column/row (ReLU between is
    # elementwise); the final head contracts the row-sharded ffn_4
    (r"ffn_(0|2|4)/kernel$", -1),
    (r"ffn_(1|3)/kernel$", -2),
    (r"text_aligner.*/out/kernel$", -2),
    # discriminators (24% of acoustic forward FLOPs for the 3 MRDs
    # alone — scripts/audit_sharding.py): alternate column/row down the
    # conv stacks (leaky_relu between is elementwise). Per-layer 1-ch
    # score heads reading a column-sharded activation contract it
    # (row-sharded); heads on replicated activations stay replicated.
    (r"^mrd\d/params/conv_(0|2|4)/kernel$", -1),
    (r"^mrd\d/params/conv_(1|3)/kernel$", -2),
    (r"^mrd\d/params/out_(0|2|4)/kernel$", -2),
    (r"^(pitch_disc|dur_disc)/params/conv_(0|2|4)/Conv_0/kernel$", -1),
    (r"^(pitch_disc|dur_disc)/params/conv_(1|3)/Conv_0/kernel$", -2),
    (r"^(pitch_disc|dur_disc)/params/out_(0|2|4)/Conv_0/kernel$", -2),
    # waveform disc trunk: GroupNorm(1) after each conv reduces over
    # the sharded feature axis, but only its (B, T, 1) stats cross
    # ranks — far cheaper than the conv FLOPs saved
    (r"^disc/params/conv(0|2)/conv/Conv_0/kernel$", -1),
    (r"^disc/params/conv(1|3)/conv/Conv_0/kernel$", -2),
    (r"^disc/params/last0/kernel$", -1),
    (r"^disc/params/last1/kernel$", -2),
]

# the weight bridge's kinds whose torch layout leads with (out, in): flax
# axis -1 (out) is torch dim 0 and -2 (in) torch dim 1
_KERNEL_KINDS = ("conv", "conv2d", "dense")


def spec_for_leaf(path: str, shape: Sequence[int]) -> Optional[int]:
    """The flax feature axis (-1 or -2) that the model axis shards for the
    leaf at ``path`` (``/``-joined, the JAX ``TrainState``'s path) of flax
    ``shape``, or None (replicated): the first rule that matches decides;
    a leaf of fewer than 2 dims, or whose axis is odd, is replicated."""
    if len(shape) < 2:
        return None
    for pattern, axis in _RULES:
        if re.search(pattern, path):
            if shape[axis % len(shape)] % 2:
                return None
            return axis
    return None


def state_path(module_name: str, flax_path: str, audit: bool = False) -> str:
    """The JAX ``TrainState``'s path of a parameter leaf
    (``params/<module>/params/<flax path>``), or with ``audit`` the view of
    ``scripts/audit_sharding.py`` (``<module>/params/<flax path>``)."""
    inner = f"{module_name}/params/{flax_path}"
    return inner if audit else f"params/{inner}"


def torch_dim(axis: Optional[int]) -> Optional[int]:
    """The torch dim of a kernel's flax feature axis (see ``_KERNEL_KINDS``)."""
    return None if axis is None else {-1: 0, -2: 1}[axis]


def module_specs(name: str, module: nn.Module,
                 audit: bool = False) -> Dict[str, Optional[int]]:
    """``module``'s ``state_dict`` key -> the torch dim that the model axis
    shards (0 column, 1 row), or None; ``name`` is its registry name."""
    out = {}
    shapes = module_jax_shapes(module)
    for key, (path, kind) in flax_layout(module).items():
        axis = spec_for_leaf(state_path(name, path, audit), shapes[f"params/{path}"])
        if axis is not None and kind not in _KERNEL_KINDS:
            raise ValueError(f"{name}/{path}: a rule shards a {kind} leaf")
        out[key] = torch_dim(axis)
    return out


# ---------------------------------------------------------------- meshes


@dataclass(frozen=True)
class Mesh:
    """A mesh over the process group: its axis names and sizes (row-major,
    as the JAX device array)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def model(self) -> int:
        return self.shape[-1]

    @property
    def data(self) -> int:
        """The joint data size (``dcn * data`` on the hybrid mesh)."""
        n = 1
        for s in self.shape[:-1]:
            n *= s
        return n


def _make(axis_names, shape) -> Mesh:
    size = 1
    for s in shape:
        size *= s
    model = shape[-1]
    data = size // model
    world = _mesh.world_size_global()
    if world != size:
        raise ValueError(f"a mesh of {shape} needs {size} ranks; the process group has "
                         f"{world}")
    _mesh.init_axes(data, model)
    return Mesh(tuple(axis_names), tuple(shape))


def make_2d_mesh(data: int, model: int) -> Mesh:
    """The ("data", "model") mesh over the process group's ``data * model``
    ranks: rank ``d * model + m``; makes the axis groups (a collective:
    every rank calls it)."""
    return _make((DATA_AXIS, MODEL_AXIS), (data, model))


def make_hybrid_mesh(slices: int, data: int, model: int) -> Mesh:
    """The ("dcn", "data", "model") mesh: rank ``(s * data + d) * model +
    m``. The leading axis carries pure data parallelism, like "data", so
    the batch splits over (dcn, data) jointly and the gradient mean runs
    over both; "model" carries the tensor-parallel all-reduces. On one host
    the placement of the axes is the only difference from a 2-D mesh of
    ``slices * data`` by ``model``, as in JAX on a single slice."""
    return _make((DCN_AXIS, DATA_AXIS, MODEL_AXIS), (slices, data, model))


# ---------------------------------------------------------------- state


def _module_table(state) -> Dict[str, nn.Module]:
    """The state's modules by registry name (the aligner's is
    ``text_aligner``, as the JAX ``TrainState`` names it)."""
    if hasattr(state, "models"):
        return dict(state.models)
    return {"text_aligner": state.aligner}


def _optimizers(state) -> Iterable[torch.optim.Optimizer]:
    if hasattr(state, "optimizers"):
        return state.optimizers.values()
    return [state.optimizer]


def _owner(module: nn.Module, key: str) -> Tuple[nn.Module, str]:
    path, _, leaf = key.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def _shard(t: torch.Tensor, dim: int) -> torch.Tensor:
    m, n = _mesh.model_rank(), _mesh.model_size()
    if t.shape[dim] % n:
        raise ValueError(f"a dim of {t.shape[dim]} does not divide over {n} model ranks")
    k = t.shape[dim] // n
    return t.narrow(dim, m * k, k).clone(memory_format=torch.contiguous_format)


def shard_module(name: str, module: nn.Module, moments: Optional[dict] = None) -> int:
    """Shard ``module`` (registry name ``name``) in place by the rules: each
    kernel they name becomes this model rank's contiguous slice and its
    owner gets ``tp_dim``; ``moments`` (``id(param)`` -> AdamW state) are
    sliced alike. Returns the number of sharded kernels."""
    n = 0
    for key, dim in module_specs(name, module).items():
        if dim is None:
            continue
        owner, leaf = _owner(module, key)
        p = getattr(owner, leaf)
        p.data = _shard(p.data, dim)
        for k in ("exp_avg", "exp_avg_sq"):
            if k in (moments or {}).get(id(p), {}):
                moments[id(p)][k] = _shard(moments[id(p)][k], dim)
        owner.tp_dim = dim
        n += 1
    return n


def shard_state(state, mesh: Mesh):
    """Each parameter that the rules shard becomes this model rank's
    contiguous slice (in place; its owner gets ``tp_dim``), with any AdamW
    moments already there; returns ``state``. Model size 1 leaves the state
    as it is."""
    if mesh.model == 1:
        return state
    moments = {}
    for opt in _optimizers(state):
        for group in opt.param_groups:
            for p in group["params"]:
                moments[id(p)] = opt.state.get(p, {})
    for name, module in _module_table(state).items():
        shard_module(name, module, moments)
    return state


def sharded_parameters(state) -> Dict[str, Tuple[torch.Tensor, int]]:
    """``<module>/<state_dict key>`` -> (the local parameter, its torch dim)
    of every sharded parameter of ``state``."""
    out = {}
    for name, module in _module_table(state).items():
        for key, p in module.named_parameters():
            owner, leaf = _owner(module, key)
            dim = getattr(owner, "tp_dim", None)
            if dim is not None and leaf == "weight":
                out[f"{name}/{key}"] = (p, dim)
    return out


def gather_state(state) -> Dict[str, Dict[str, Dict[str, torch.Tensor]]]:
    """The full tensors of ``state`` (a collective over the model group):
    ``{"params" | "exp_avg" | "exp_avg_sq": {module: {key: tensor}}}``, each
    sharded one gathered from its shards (the moments where the optimizer
    has them)."""
    out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}}
    opt_state = {}
    for opt in _optimizers(state):
        opt_state.update({id(p): s for p, s in opt.state.items()})
    for name, module in _module_table(state).items():
        for k in out:
            out[k][name] = {}
        for key, p in module.named_parameters():
            owner, leaf = _owner(module, key)
            dim = getattr(owner, "tp_dim", None) if leaf == "weight" else None
            tensors = {"params": p.detach(),
                       **{k: opt_state[id(p)][k] for k in ("exp_avg", "exp_avg_sq")
                          if k in opt_state.get(id(p), {})}}
            for k, t in tensors.items():
                out[k][name][key] = (t.detach().clone() if dim is None
                                     else _mesh.gather_model_tensor(t.detach(), dim))
    return out


def gather_grads(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s gradients by ``state_dict`` key, the sharded ones
    gathered (a collective over the model group)."""
    out = {}
    for key, p in module.named_parameters():
        if p.grad is None:
            continue
        owner, leaf = _owner(module, key)
        dim = getattr(owner, "tp_dim", None) if leaf == "weight" else None
        g = p.grad.detach()
        out[key] = g.clone() if dim is None else _mesh.gather_model_tensor(g, dim)
    return out


# ---------------------------------------------------------------- steps


def _rows(batch, mesh: Mesh):
    """This rank's rows of a global batch: the joint data rank's share."""
    from ..trainer.steps import Batch

    b = batch.text.shape[0]
    if b % mesh.data:
        raise ValueError(f"a global batch of {b} rows does not divide over {mesh.data} "
                         f"data ranks")
    k = b // mesh.data
    i = _mesh.rank()  # the joint data rank
    return Batch(*(None if x is None else x[i * k:(i + 1) * k] for x in batch))


def parallel_2d_step(step_fn, state, mesh: Mesh):
    """``jit_2d_parallel_step``: (state, global batch) -> metrics, the step
    run on this rank's rows (``P(DATA_AXIS)``) with the state sharded by the
    rules (``shard_state`` first: the state is sharded here where it is not
    yet). Metrics are the same on every rank."""
    if mesh.axis_names != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"not a 2-D mesh: {mesh.axis_names}")
    return _parallel_step(step_fn, state, mesh)


def parallel_hybrid_step(step_fn, state, mesh: Mesh):
    """``jit_hybrid_parallel_step``: as ``parallel_2d_step``, the batch
    split over (dcn, data) jointly (``P((DCN_AXIS, DATA_AXIS))``)."""
    if mesh.axis_names != (DCN_AXIS, DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"not a hybrid mesh: {mesh.axis_names}")
    return _parallel_step(step_fn, state, mesh)


def _parallel_step(step_fn, state, mesh: Mesh):
    if mesh.model > 1 and not sharded_parameters(state):
        shard_state(state, mesh)

    def step(state_, batch):
        return step_fn(state_, _rows(batch, mesh))

    return step
