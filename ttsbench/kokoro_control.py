"""The control readings of a ``kokoro_lines`` cell: the reference's bucket
path with TF32 on put in the program's place, against the float32
reference, on the lines a run of each seed compares. Not part of a
benchmark run.

    python -m ttsbench.kokoro_control --workload kokoro.speak_book --seeds 11,12,13

Prints one JSON line per seed, and the smallest and largest reading of
each number over the seeds last.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m ttsbench.kokoro_control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ttsbench.harness import card_line, configure_torch, load_cell, set_cache_dirs

    set_cache_dirs()
    import torch

    from ttsbench.traffic.kokoro_lines import control

    configure_torch()
    cell = load_cell(args.workload)
    if args.device == "cuda":
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control(cell, seed, args.device)
        readings.append(numbers)
        print(json.dumps({"workload": cell.name, "seed": seed, "numbers": numbers}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    least = {k: min(r[k] for r in readings) for k in readings[0]}
    most = {k: max(r[k] for r in readings) for k in readings[0]}
    print(json.dumps({"workload": cell.name, "least": least, "most": most,
                      "finite": all(math.isfinite(v) for v in least.values())}), flush=True)


if __name__ == "__main__":
    main()
