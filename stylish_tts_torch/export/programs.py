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

**Sharing one memory pool.** Every program of a ``BucketPackage`` is
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

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.trace import counter, span

# programs built, by phase: a build inside a run means no warmup covered it
BUILT = counter("programs.built", ("fused", "duration", "acoustic"))
# frames a line needs and frames its frame bucket's program computed (the
# two-phase families, whose host knows a line's frames before its program)
FRAMES = counter("speak.frames", ("real", "bucket"))

TEXT_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512)
FRAME_BUCKET_STEP = 100
SOURCE_SEED = 0  # of the generators that draw a program's source noise


def frame_bucket(total_frames: int) -> int:
    return max(
        ((total_frames + FRAME_BUCKET_STEP - 1) // FRAME_BUCKET_STEP)
        * FRAME_BUCKET_STEP,
        FRAME_BUCKET_STEP,
    )


def text_bucket(n: int) -> int:
    for b in TEXT_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"text too long for inference buckets: {n}")


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


class BucketPackage:
    """What the packages of every model family share: the device, the one
    graph pool, the programs per bucket (``_duration_fns[L]`` and
    ``_acoustic_fns[(L, F)]``, each mapping the batch size to its program;
    a family may keep further caches of its own phases), the line count of
    the ``speak.line`` spans and the ``speak.frames`` count.

    A family's class answers ``speak``'s two questions: ``load_voice`` and
    ``speak_line``."""

    # the counter of programs built, by phase, that ``_program`` adds to
    BUILT = BUILT
    # what ``speak`` reports at its end, "label: key n, ..." per counter
    SPEAK_COUNTERS = (("programs built while speaking", BUILT),)

    def __init__(self, device: str):
        self.device = resolve_device(device)
        self._duration_fns: Dict[int, Dict[int, BucketProgram]] = {}
        self._acoustic_fns: Dict[tuple, Dict[int, BucketProgram]] = {}
        self._pool = (torch.cuda.graph_pool_handle() if self.device.type == "cuda"
                      else None)
        self._lines = 0

    def load_voice(self, path: str):
        """The voice file at ``path``, as ``speak_line`` takes it."""
        raise NotImplementedError

    def speak_line(self, text: str, voice, speed: float = 1.0) -> np.ndarray:
        """A line of phoneme text in ``voice`` -> its waveform, float32."""
        raise NotImplementedError

    def _line(self):
        """The span ``speak.line`` of the next ``generate_speech`` call."""
        self._lines += 1
        return span("speak.line", self._lines)

    def _program(self, phase: str, cache: dict, key, batch: int, fn,
                 example_inputs) -> BucketProgram:
        """The cached program, built on a miss with static inputs cloned from
        ``example_inputs`` (a request's own tensors keep their strides, and
        with them the kernels the eager call on them would run)."""
        entry = cache.setdefault(key, {})
        if batch not in entry:
            entry[batch] = BucketProgram(fn, example_inputs, pool=self._pool)
            self.BUILT[phase] += 1
        return entry[batch]

    @staticmethod
    def _count_frames(real: int, bucket: int) -> None:
        FRAMES["real"] += real
        FRAMES["bucket"] += bucket

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.array(x), dtype=dtype, device=self.device)

    def _texts(self, token_lists):
        lens = np.asarray([t.shape[0] for t in token_lists], np.int32)
        L = text_bucket(int(lens.max()))
        texts = np.zeros((len(token_lists), L), np.int32)
        for i, t in enumerate(token_lists):
            texts[i, :t.shape[0]] = t
        return self._tensor(texts, torch.long), self._tensor(lens, torch.long)
