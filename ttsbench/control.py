"""The readings that the limits in ``ttsbench/checks/<cell>.json`` are set
between: the control and the planted faults, per seed. Not part of a
benchmark run.

    python -m ttsbench.control --workload <cell> --seeds 11,12,13 [--fault half_batch]

Without ``--fault``: the control, the reference put in the program's place
one precision below the configuration (training: TF32 on and the
generator phases at e4m3 inputs under bf16 autocast; synthesis: TF32 on),
against the float32 reference, on the rows or lines a run compares. For
synthesis also a sound float32 variant of the reference, read as the
numbers a legitimate change of float32 rounding gives
(``sound.style_ulp.``): every style input one float32 rounding step up.
``--fault half_batch`` (training): the program as configured, with every
step given the first half of its batch (the mean taken over the rest).
Prints one JSON line per seed, and the smallest and largest reading of each
number over the seeds last.
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
def half_batch():
    """Every training step of the program sees the first half of its batch."""
    from stylish_tts_torch.trainer import steps

    saved = {n: getattr(steps, n) for n in ("make_acoustic_step", "make_textual_step")}

    def halve(make):
        def factory(ctx):
            step = make(ctx)

            def halved(state, batch):
                half = batch.text.shape[0] // 2
                return step(state, steps.Batch(*(None if x is None else x[:half]
                                                 for x in batch)))
            return halved
        return factory

    for n, make in saved.items():
        setattr(steps, n, halve(make))
    try:
        yield
    finally:
        for n, make in saved.items():
            setattr(steps, n, make)


def control_train(cell, seed: int, device: str, workdir: Path) -> dict:
    from ttsbench import checks
    from ttsbench.reference import train as ref
    from ttsbench.traffic.train_stage import batch_order, write_corpus

    params = cell.traffic
    model = cell.config["model"]
    mc = ref.model_config(model)
    corpus = write_corpus(params, seed, workdir, mc.symbol.letters_ipa.replace("'", ""),
                          mc.hop_length)
    order = batch_order(params, seed)
    rows = [next(order) for _ in range(params["checked_steps"])]
    training = {k: params[k] for k in ("lr", "stage_steps", "state_seed")}
    args = (params["stage"], model, training, seed, cell.config["f0_bias_hz"], corpus, rows,
            device)
    exact = ref.run_steps(*args)
    lowered = ref.run_steps(*args, control=True)
    print(f"control, lowered/exact: {checks.explain(lowered, exact)}", file=sys.stderr,
          flush=True)
    return checks.training_numbers(lowered, exact)


def control_speak(cell, seed: int, device: str, workdir: Path) -> dict:
    import numpy as np

    from ttsbench import checks
    from ttsbench.reference import train as ref
    from ttsbench.reference.stts.text import TextCleaner
    from ttsbench.reference.synth import Synthesizer
    from ttsbench.traffic.speak_lines import make_pool, make_voices

    params = cell.traffic
    mc = ref.model_config(cell.config["model"])
    pool = make_pool(params, seed, mc.symbol.letters_ipa.replace("'", ""),
                     TextCleaner(mc.symbol))
    voices = make_voices(params, seed, mc.style_dim)
    rng = np.random.default_rng([seed, 15])
    sample = set(int(i) for i in rng.choice(len(pool), params["check_lines"], replace=False))
    sample.add(max(range(len(pool)), key=lambda i: pool[i]["tokens"].shape[0]))
    synth = Synthesizer(cell.config, device, seed)
    hop = mc.hop_length * mc.coarse_multiplier
    ulp = np.float32(1.0 + 2.0 ** -23)
    pairs = {"control": [], "sound.style_ulp": []}
    for i in sorted(sample):
        tokens, styles = pool[i]["tokens"], voices[pool[i]["voice"]]
        exact = synth.line(tokens, *styles)
        pairs["control"].append((synth.line(tokens, *styles, control=True), exact))
        nudged = [np.asarray(s, np.float32) * ulp for s in styles]
        pairs["sound.style_ulp"].append((synth.line(tokens, *nudged), exact))
    out = {}
    for kind, p in pairs.items():
        prefix = "" if kind == "control" else f"{kind}."
        out.update({prefix + k: v for k, v in
                    checks.line_numbers(p, hop, checks.mel_settings(mc)).items()})
    return out



def fault_run(cell, seed: int, device: str, workdir: Path, fault: str) -> dict:
    from ttsbench.harness import load_kind

    if fault != "half_batch":
        raise SystemExit(f"unknown fault {fault!r}")
    with half_batch():
        driver = load_kind(cell.traffic["kind"]).Driver(cell.config, cell.traffic, seed,
                                                        device, workdir)
        driver.setup()
        driver.attempted = 0
        driver.release()
    numbers, _ = driver.check()
    return numbers


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m ttsbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from ttsbench.harness import card_line, configure_torch, load_cell, set_cache_dirs

    set_cache_dirs()
    import torch

    configure_torch()

    cell = load_cell(args.workload)
    if args.device == "cuda":
        print(f"card: {card_line()}", file=sys.stderr, flush=True)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="ttsbench-control-") as d:
            if args.fault:
                numbers = fault_run(cell, seed, args.device, Path(d), args.fault)
            elif cell.traffic["kind"] == "train_stage":
                numbers = control_train(cell, seed, args.device, Path(d))
            else:
                numbers = control_speak(cell, seed, args.device, Path(d))
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
