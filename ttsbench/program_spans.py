"""The program's own spans (``stylish_tts_torch/utils/trace.py``) in the
traced window of a run, for the per-layer readers that read them.

The program records spans only while a ``torch.profiler`` session is active,
as it is over the traced window. The module is imported inside the
function, as the traffic drivers import the program; a program without it
gives ``None``, and its readers report nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def spans(run) -> Optional[Dict[str, list]]:
    """The program's spans that overlap [run.lo, run.hi], cut to it, by
    name (each a ``trace.Span``: start and end in ns on the profiler's
    clock, id, parent, unit, thread, tag); ``None`` where there are none."""
    try:
        from stylish_tts_torch.utils import trace
    except ImportError:
        return None
    out: Dict[str, list] = {}
    for s in trace.spans():
        if s.end > run.lo and s.start < run.hi:
            out.setdefault(s.name, []).append(
                s._replace(start=max(s.start, run.lo), end=min(s.end, run.hi)))
    return out or None


def named(found: Dict[str, list], prefix: str) -> List[str]:
    """The span names that start with ``prefix``."""
    return [name for name in found if name.startswith(prefix)]


def total_ms(found: Dict[str, list], *names: str) -> float:
    """The summed length of the spans ``names``, in ms."""
    return sum(s.end - s.start for name in names for s in found.get(name, ())) / 1e6
