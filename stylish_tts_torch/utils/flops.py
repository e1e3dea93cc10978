"""Analytic matmul and convolution FLOP count: the port's
``stylish_tts_tpu/utils/flops.py``, the numerator of an MFU.

JAX walks the jaxpr of the function; the port runs the function once under
``torch.utils.flop_counter.FlopCounterMode``, which sees every aten
operation that runs, the backward included, and so the recompute of a
checkpointed (``generator.remat``) block too, counted as the executed work
it is. The JAX semantics are kept:

* only matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, attention)
  and convolutions (forward and backward) count; elementwise work,
  reductions and the rest do not, so an MFU from the count can only
  understate utilisation;
* a grouped convolution counts per group (the weight's input channels are
  per group; ``FlopCounterMode``'s rule is JAX's);
* a transposed convolution counts its real taps only: JAX writes it as an
  lhs-dilated convolution and counts K/stride taps per output position,
  where ``FlopCounterMode`` counts every tap of every input position, those
  that land in a cropped edge of the output too; ``_transposed_conv_flop``
  is JAX's rule;
* what JAX writes as ``lax.switch`` (the sampled MRD) is the mean over the
  branches: ``count_mean``, one run per branch with its index forced;
* an eager loop runs its real trip count, so the count is exact where
  JAX's ``while`` count is a lower bound; ``lower_bound`` stays in
  ``FlopCount`` for the same fields, False from ``count_fn``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

aten = torch.ops.aten


@dataclass
class FlopCount:
    matmul: float = 0.0
    conv: float = 0.0
    lower_bound: bool = False
    notes: list = field(default_factory=list)

    @property
    def total(self) -> float:
        return self.matmul + self.conv

    def scaled(self, k: float) -> "FlopCount":
        return FlopCount(self.matmul * k, self.conv * k, self.lower_bound, list(self.notes))

    def add(self, other: "FlopCount") -> None:
        self.matmul += other.matmul
        self.conv += other.conv
        self.lower_bound = self.lower_bound or other.lower_bound
        self.notes.extend(n for n in other.notes if n not in self.notes)


def _transposed_conv_flop(x_shape, w_shape, _bias, stride, _padding, _dilation,
                          transposed, _output_padding, groups, *args,
                          out_shape=None, **kwargs) -> int:
    """``aten.convolution``: a transposed convolution (weight (C_in,
    C_out/groups, *K)) at 2 |out| prod(K_i / s_i) C_in/groups, JAX's count of
    the lhs-dilated form; any other, ``FlopCounterMode``'s rule."""
    if not transposed:
        return conv_flop_count(x_shape, w_shape, out_shape, transposed=False)
    taps = math.prod(max(1.0, k / s) for k, s in zip(w_shape[2:], stride))
    return 2 * math.prod(out_shape) * taps * (w_shape[0] // groups)


_CUSTOM = {aten.convolution: _transposed_conv_flop,
           aten._convolution: _transposed_conv_flop}


def count_fn(fn: Callable, *args, **kwargs) -> FlopCount:
    """Run ``fn(*args, **kwargs)`` once (it does its work: a train step
    updates its state) and count its matmul and convolution FLOPs."""
    mode = FlopCounterMode(display=False, custom_mapping=_CUSTOM)
    with mode:
        fn(*args, **kwargs)
    acc = FlopCount()
    for op, flops in mode.get_flop_counts().get("Global", {}).items():
        if "conv" in str(op):
            acc.conv += flops
        else:
            acc.matmul += flops
    return acc


def count_mean(fns: Sequence[Callable], *args, **kwargs) -> FlopCount:
    """The mean count of the branches ``fns`` (JAX's ``lax.switch`` rule),
    each run once on the same arguments; noted where they differ by more
    than 20 %."""
    counts = [count_fn(f, *args, **kwargs) for f in fns]
    mean = FlopCount()
    for c in counts:
        mean.add(c)
    mean = mean.scaled(1.0 / len(counts))
    lo, hi = min(c.total for c in counts), max(c.total for c in counts)
    if len(counts) > 1 and hi > 0 and (hi - lo) / hi > 0.2:
        mean.notes.append(f"cond branches differ >20% ({lo:.3g}..{hi:.3g}); mean used")
    return mean
