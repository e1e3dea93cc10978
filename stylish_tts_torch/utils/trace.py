"""Spans and counters of the port, on the profiler's clock.

A span is a stretch of the host's work: its name, its start and end
(``time.time_ns()``, the clock ``torch.profiler`` stamps its events on, so
that spans line up with the device operations of a trace), its id, the id
of the span that encloses it on the same thread, its unit (the step, line
or batch it belongs to; a span given none takes its parent's) and its
thread.

Spans record only while a ``torch.profiler`` session is active: the
benchmark's traced window, or ``train --profile``. With none active
``span`` reads one flag and returns a shared object that does nothing: no
generator, no ``record_function``, no NVTX range, nothing that reaches the
device. Recorded spans go into a bounded buffer in memory; when it is full
the oldest are dropped and counted (``DROPPED``). Nothing here writes to
disk; ``train --profile`` adds the spans to its Chrome trace
(``add_to_chrome_trace``).

Counters are named groups of integers in one registry (``COUNTERS``), each
a ``collections.Counter`` bumped with a plain add, always on: the loader's
batches by audio path (``loader.batches``), the CTC kernels' launches
(``ctc.launches``), the synthesis programs built per phase
(``programs.built``; F5-TTS's in ``programs.built.f5``), a two-phase
line's frames and its frame bucket's (``speak.frames``), F5-TTS's DiT
evaluations per guidance row (``speak.nfe``: ``cond``, ``uncond``), the
loudness step's calls by filter path (``loudness.path``: ``native`` or
``scipy``), the acoustic steps by whether their discriminators ran on
tuned cuDNN plans (``disc.conv_autotune``: ``on`` or ``off``).

Never open a span inside a phase function that a CUDA graph captures: it
would run at the capture only, never at a replay.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import Counter, deque
from typing import Dict, Iterable, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

# spans kept in memory: at 18 an acoustic step or 5 a line, ~3,600 steps or
# ~13,000 lines
CAPACITY = 1 << 16

COUNTERS: Dict[str, Counter] = {}


def counter(name: str, keys: Iterable[str] = ()) -> Counter:
    """The registry's counter ``name``, made on first use with ``keys`` at 0."""
    if name not in COUNTERS:
        COUNTERS[name] = Counter(dict.fromkeys(keys, 0))
    return COUNTERS[name]


DROPPED = counter("trace.dropped", ("spans",))


class Span(NamedTuple):
    name: str
    start: int  # time.time_ns()
    end: int
    id: int
    parent: Optional[int]  # the enclosing span's id on the same thread
    unit: Optional[int]  # step, line or batch number
    thread: int  # threading.get_ident()


_buffer: deque = deque(maxlen=CAPACITY)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """What ``span`` returns with no profiler session active."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "unit", "id", "parent", "start")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack = _stack()
        self.parent = None
        if stack:
            self.parent = stack[-1].id
            if self.unit is None:
                self.unit = stack[-1].unit
        self.id = next(_ids)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        done = Span(self.name, self.start, end, self.id, self.parent, self.unit,
                    threading.get_ident())
        with _lock:
            if len(_buffer) == _buffer.maxlen:
                DROPPED["spans"] += 1
            _buffer.append(done)
        return False


def span(name: str, unit: Optional[int] = None):
    """A context manager that records the span ``name`` while a
    ``torch.profiler`` session is active, and does nothing otherwise."""
    # torch.profiler sets this flag at every session's start, whatever its
    # activities, and clears it at the stop
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, unit)


def spans() -> List[Span]:
    """The recorded spans, oldest first."""
    with _lock:
        return list(_buffer)


def add_to_chrome_trace(path: str, lo: int, hi: int, dropped: int) -> None:
    """Add the spans that ended inside [lo, hi] (``time.time_ns()``) to the
    Chrome trace ``path`` that ``torch.profiler`` exported, on its time base
    (``baseTimeNanoseconds``), a track per thread named ``program spans``,
    with ``dropped``, the count of spans dropped over the session
    (``programSpansDropped``)."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events, threads = [], set()
    for s in spans():
        if not lo <= s.end <= hi:
            continue
        tid = f"program spans {s.thread}"
        threads.add(tid)
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": tid, "ts": (s.start - base) / 1e3,
                       "dur": (s.end - s.start) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "unit": s.unit}})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tid}} for tid in sorted(threads)]
    trace["traceEvents"] = trace.get("traceEvents", []) + events
    trace["programSpansDropped"] = dropped
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
