"""Synthesis programs per bucket: one phase function at fixed shapes.

Counterpart of the JAX package's jitted programs per bucket
(``_duration_fns``, ``_acoustic_fns``, ``_fused_fns`` in
``stylish_tts_tpu/export/package.py``). There XLA compiles one program per
shape and launches it as one unit; on the card the counterpart is a CUDA
graph: the phase function is run once on a side stream (so that cuDNN,
cuBLAS and the port's cached DSP bases and duration tables exist before
capture), captured once with ``torch.cuda.graph``, and replayed as one
launch. A call copies the request into the program's static inputs,
replays, and returns clones of the outputs. On the CPU the same object
runs the function eagerly on its static inputs.

Nothing falls back: a capture or a replay that fails on the card raises.

**Sharing one memory pool.** Every program of an ``InferencePackage`` is
captured into one pool (``torch.cuda.graph_pool_handle()``), or the full
grid of programs would not fit beside each other. A shared pool is sound
in any order of replay because of two rules that this module keeps:

1. what a program reads at replay (its static inputs, and its source
   draws, made by the caller) is allocated outside the pool, before the
   capture, so that no other program's intermediates can overwrite it;
2. what a program returns is cloned (outside the pool) before any other
   program replays, since another program's intermediates may occupy
   the same addresses as this one's outputs.

Replays run one after another on the caller's stream; two programs of one
pool never run at once.

**Tracing** (``utils/trace.py``). A call is the span ``program.replay``.
No span opens inside the phase function: it would run at the capture
only.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..utils.trace import span

# eager runs on a side stream before the capture: the first call of a
# shape builds cuDNN's plans and the port's cached tensors (DFT bases,
# duration tables); no cuDNN autotuning is on, so one run settles it
WARMUP_RUNS = 1


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(x) for x in out)


class BucketProgram:
    """``fn(*inputs)`` at the shapes and dtypes of ``example_inputs``: a
    CUDA graph on the card (captured into ``pool``), the eager call on the
    CPU. ``fn`` must take tensors only and return a tensor or a tuple of
    tensors; everything else it reads (weights, source draws) must stay
    allocated while the program lives."""

    def __init__(self, fn: Callable, example_inputs: Sequence[torch.Tensor],
                 pool=None):
        self.fn = fn
        with torch.inference_mode():
            # the static inputs: allocated here, outside the capture's pool
            self.inputs = tuple(x.clone() for x in example_inputs)
        self.device = self.inputs[0].device
        self.graph = None
        self.outputs = None
        if self.device.type == "cuda":
            self._capture(pool)

    @torch.inference_mode()
    def _capture(self, pool) -> None:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.fn(*self.inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: CUDA calls of other threads (a loader's pinned
        # copies) do not invalidate this capture; this thread's still do
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            self.outputs = self.fn(*self.inputs)
        self.graph = graph

    @torch.inference_mode()
    def __call__(self, *args: torch.Tensor):
        if len(args) != len(self.inputs):
            raise TypeError(f"program takes {len(self.inputs)} inputs, got {len(args)}")
        for static, x in zip(self.inputs, args):
            if static.shape != x.shape:
                raise ValueError(f"program input of shape {tuple(static.shape)} given "
                                 f"{tuple(x.shape)}")
        with span("program.replay"):
            for static, x in zip(self.inputs, args):
                static.copy_(x)
            if self.graph is None:
                return self.fn(*self.inputs)
            self.graph.replay()
            return _clone(self.outputs)
