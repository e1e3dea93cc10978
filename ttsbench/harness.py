"""The benchmark's yardstick: the cell's files, the caches, the import
guard, the clock, the metric arithmetic and the reading of a device trace.

Nothing here imports the program (``stylish_tts_torch``); the traffic
drivers do, inside their functions.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stylish_tts_tpu")

from ttsbench.flops import PEAKS

PEAK_BF16_FLOPS = PEAKS["bf16_flops"]

# the compile caches: fixed directories inside the checkout, so that only
# the first run of a checkout builds
CACHE_ROOT = ROOT / "build" / "ttsbench"
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": CACHE_ROOT / "torch_extensions",
    "TRITON_CACHE_DIR": CACHE_ROOT / "triton",
}
NATIVE_BUILD_DIR = ROOT / "build" / "torch_native"


def set_cache_dirs() -> None:
    """Point every build cache the program may use at its fixed directory
    (before the program is imported), and keep libraries from loading JAX."""
    for key, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def configure_torch() -> None:
    """float32 products without TF32, as the program's trainer sets them
    and as the configurations state."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``stylish_tts_torch`` is not
    ``stylish_tts_tpu``, and ``jax_utils`` is not ``jax``."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (from ``/proc``)."""
    with open("/proc/self/stat", encoding="ascii") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime", encoding="ascii") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.strip().splitlines()[0].strip()


def log(msg: str) -> None:
    print(f"[ttsbench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------- the cell


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration
    (``ttsbench/configs/<config>.json``), traffic mix
    (``ttsbench/traffic/<traffic>.json``), limits
    (``ttsbench/checks/<cell>.json``), and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(
        name=name, chips=w["chips"],
        config=_json(root / config["file"]),
        traffic=_json(PKG / "traffic" / f"{w['traffic']}.json"),
        checks=_json(PKG / "checks" / f"{name}.json"),
        end_to_end=e2e, per_layer=layer)


def load_reader(metric: str):
    """The reader of per-layer metric ``metric``:
    ``ttsbench/layer_metrics/<metric>.py``'s ``read(run)``."""
    path = PKG / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"ttsbench_layer_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_kind(kind: str):
    """The traffic generator and driver of kind ``kind``:
    ``ttsbench/traffic/<kind>.py``."""
    return importlib.import_module(f"ttsbench.traffic.{kind}")


# ---------------------------------------------------------------- arithmetic


def rate(total: float, seconds: float) -> float:
    """Work over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return total / seconds


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of all ``values`` (linear between ranks, as
    numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = 0.95 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length covered by ``intervals`` (start, end), overlaps counted
    once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip_intervals(intervals, lo: float, hi: float):
    """``intervals`` cut to [lo, hi]."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(clip_intervals(intervals, lo, hi)):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


# ---------------------------------------------------------------- the run


@dataclass
class RunRecord:
    """What a per-layer reader reads: the traced window of one run."""

    units: int  # steps or lines completed in the traced window
    window_s: float  # the traced window, host clock
    device: List[Tuple[float, float, str]] = field(default_factory=list)  # ns
    launches: int = 0  # kernel and graph launches the host issued
    spans: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)  # host ns
    audio_s: float = 0.0
    flops: Optional[float] = None  # the reference's FLOPs of the window's work
    peak_bytes: Optional[int] = None  # max_memory_allocated over the window
    peak_flops: float = PEAK_BF16_FLOPS
    lo: int = 0  # the traced window on the profiler's clock, ns
    hi: int = 0

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for s, e, _ in self.device]) / 1e9

    def span_s(self, name: str) -> float:
        return sum(e - s for s, e in self.spans.get(name, ())) / 1e9


# ---------------------------------------------------------------- tracing

LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                "cuGraphLaunch")


class DeviceTrace:
    """``torch.profiler`` over the traced window (CUDA activity: device
    operations and the host's runtime calls), read as raw events."""

    def __init__(self):
        import torch

        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def record(self, units: int, lo: int, hi: int,
               spans: Dict[str, List[Tuple[int, int]]], **extra) -> RunRecord:
        """The traced window [lo, hi] (``time.time_ns()``, the profiler's
        clock) as a ``RunRecord``: device operations cut to the window, and
        the launches the host issued inside it."""
        from torch.autograd import DeviceType

        device, launches = [], 0
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            if end <= lo or start >= hi:
                continue
            if e.device_type() == DeviceType.CUDA:
                device.append((max(start, lo), min(end, hi), e.name()))
            elif e.name().startswith(LAUNCH_NAMES):
                launches += 1
        return RunRecord(units=units, window_s=(hi - lo) / 1e9, device=device,
                         launches=launches, spans=spans, lo=lo, hi=hi, **extra)


def breakdown(device, spans: Dict[str, List[Tuple[int, int]]], lo: int, hi: int) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the window, each named by the harness span that covers most
    of it."""
    by_name: Dict[str, float] = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps([(s, e) for s, e, _ in device], lo, hi),
                     key=lambda g: g[0] - g[1])[:10]

    def host_during(lo_, hi_):
        overlap = {name: sum(max(0, min(e, hi_) - max(s, lo_)) for s, e in ivs)
                   for name, ivs in spans.items()}
        name = max(overlap, key=overlap.get, default=None)
        return name if name and overlap[name] > 0 else "harness"

    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[host_during(s, e), (e - s) / 1e9] for s, e in longest]}
