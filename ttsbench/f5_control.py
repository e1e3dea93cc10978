"""The readings that the limits of an ``f5_lines`` cell are set between: the
program with its DiT one precision below the configuration's (bfloat16 for
float16), or the program as configured with a planted fault, against the
float32 reference, on the chunks a run of each seed compares (the sample
drawn from the whole pool). Not part of a benchmark run.

    python -m ttsbench.f5_control --workload f5.speak_book --seeds 11,12,13
    python -m ttsbench.f5_control --workload f5.speak_book --seeds 11 --fault no_key_mask

Prints one JSON line per seed, and the smallest and largest reading of
each number over the seeds last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import tempfile
from pathlib import Path


@contextlib.contextmanager
def no_key_mask():
    """The attention of the program's DiT attends to the bucket's padding
    keys too."""
    from stylish_tts_torch.models import f5

    saved = f5.Attention.forward

    def unmasked(self, x, rope, key_mask=None):
        return saved(self, x, rope)

    f5.Attention.forward = unmasked
    try:
        yield
    finally:
        f5.Attention.forward = saved


FAULTS = {"no_key_mask": no_key_mask}


def reading(cell, seed: int, device: str, workdir: Path, fault) -> dict:
    """The numbers of the program (as the cell's configuration says, or
    with ``fault``) on the chunks a run of ``seed`` compares."""
    from ttsbench.traffic.f5_lines import Driver, check_sample

    driver = Driver(cell.config, cell.traffic, seed, device, workdir)
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        driver.prepare()
        finished = range(len(driver.pool))
        for i in check_sample(cell.traffic, seed, finished, driver.frames):
            driver.outputs[i] = driver.serve(i)
        driver.attempted = len(driver.outputs)
        driver.release()
    numbers, _ = driver.check()
    return numbers


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m ttsbench.f5_control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None, choices=sorted(FAULTS))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ttsbench.harness import card_line, configure_torch, load_cell, set_cache_dirs

    set_cache_dirs()
    import torch

    configure_torch()
    cell = load_cell(args.workload)
    if not args.fault:
        model = {**cell.config["model"], "dit_dtype": "bfloat16"}
        cell.config = {**cell.config, "model": model}
    if args.device == "cuda":
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="ttsbench-control-") as d:
            numbers = reading(cell, seed, args.device, Path(d), args.fault)
        readings.append(numbers)
        print(json.dumps({"workload": cell.name, "seed": seed, "fault": args.fault,
                          "numbers": numbers}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    least = {k: min(r[k] for r in readings) for k in readings[0]}
    most = {k: max(r[k] for r in readings) for k in readings[0]}
    print(json.dumps({"workload": cell.name, "fault": args.fault, "least": least,
                      "most": most,
                      "finite": all(math.isfinite(v) for v in least.values())}), flush=True)


if __name__ == "__main__":
    main()
