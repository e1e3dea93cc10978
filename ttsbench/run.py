"""Run one cell of the benchmark once.

    python -m ttsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (corpus or lines, weights from the seed, the program's
state, warm-up), measures for ``--seconds`` (``--trace 1``: the cell's
traced window under the profiler instead), frees the program's state,
holds what the timed path produced against the plain reference, and
prints one JSON line as the last line of standard output. Needs as many
CUDA cards as the cell asks for; exits non-zero and prints no result
without them, or when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m ttsbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> None:
    print(f"ttsbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def guard_imports() -> None:
    from ttsbench.harness import forbidden_modules

    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}")


def measure(cell, seed: int, seconds: float, trace: bool, device: str, workdir) -> dict:
    """Set up, measure and check one run of ``cell``; returns the result
    line's object (without ``device``)."""
    from ttsbench import checks
    from ttsbench.harness import breakdown, load_kind, load_reader, log, process_age_s

    driver = load_kind(cell.traffic["kind"]).Driver(cell.config, cell.traffic, seed,
                                                    device, workdir)
    driver.setup()
    setup_s = process_age_s()
    log(f"setup_s {setup_s!r}")
    if trace:
        record = driver.traced_window(min(seconds, cell.traffic["trace_seconds"]))
    else:
        e2e = driver.window(seconds)
    log(driver.info())
    peak_bytes = _peak_bytes(device)
    guard_imports()
    driver.release()
    numbers, flops = driver.check(traced=trace)
    correct, table = checks.judge(numbers, cell.checks)
    failed = 0 if correct else getattr(driver, "checked", 1)
    out = {"correct": bool(correct), "attempted": driver.attempted, "failed": failed}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        record.flops = flops
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        out["metrics"] = metrics
        out["busy_s"] = record.busy_s
        out["window_s"] = record.window_s
        out["breakdown"] = breakdown(record.device, record.spans, record.lo, record.hi)
    else:
        e2e["setup_s"] = setup_s
        out["metrics"] = {name: {"value": e2e[name], "unit": units[name]}
                          for name in (m["name"] for m in cell.end_to_end)}
    out["memory_peak_bytes"] = peak_bytes
    out["checks"] = table
    return out


def _peak_bytes(device: str) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0


def main(argv=None) -> None:
    args = parse(argv)
    from ttsbench.harness import card_line, configure_torch, load_cell, log, set_cache_dirs

    set_cache_dirs()
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark runs on CUDA cards")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} visible")
    configure_torch()
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory(prefix="ttsbench-") as workdir:
        out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", workdir)
    guard_imports()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("window_s")
    checks_table = out.pop("checks")
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks_table
    sys.stdout.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
