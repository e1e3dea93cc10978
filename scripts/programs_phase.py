"""Run chip_smoke.py's phase 13 (synthesis programs per bucket) alone.

From the root of a checkout on a CUDA machine:
``python3 scripts/programs_phase.py``. Instead of the voices the whole
script trains, it writes one package of seeded random weights per
generator family at the full ``ModelConfig()`` (``write_speak_inputs``,
F0 bias 150 Hz), with the duration stats of the synthetic corpus of
``chip_smoke.py`` (p05 2.93, p50 4.38, p95 6.67 frames per token) in its
metadata, and runs ``programs_family`` on each (warmup, the 8 lines
against the eager calls, per-line ms, the traced 510-token call, RTF at
B = 1 and 8, a miss; no exported program), then the failing capture in a
child. Prints the card line and one JSON line of the results; writes
``chiprun_out/programs_phase.json``.
"""
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

STATS = {"frames_per_token_p05": 2.933333333333333,
         "frames_per_token_p50": 4.3782178217821786,
         "frames_per_token_p95": 6.666666666666667}


def main() -> int:
    torch = cs.require_card()
    from stylish_tts_torch.config import ModelConfig

    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card}
    with tempfile.TemporaryDirectory(prefix="programs_phase_") as tmp:
        for name in ("freegan", "ringformer"):
            mc = ModelConfig() if name == "freegan" else cs.ringformer_config()
            root = Path(tmp) / name
            root.mkdir()
            cs.write_speak_inputs(torch, root, mc)
            meta_path = root / "pkg" / "metadata.json"
            meta = json.loads(meta_path.read_text(encoding="utf-8"))
            meta["duration_stats"] = STATS
            meta_path.write_text(json.dumps(meta), encoding="utf-8")
            t0 = time.time()
            out[name] = cs.programs_family(torch, name, root / "pkg",
                                           root / "voicepack.safetensors", card)
            out[name]["family_s"] = time.time() - t0
            gc.collect()
            torch.cuda.empty_cache()
        out["capture_fails"] = cs.child(torch, "--capture-fails")
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "programs_phase.json").write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({k: (v["warmup"] if isinstance(v, dict) and "warmup" in v else v)
                      for k, v in out.items()}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
