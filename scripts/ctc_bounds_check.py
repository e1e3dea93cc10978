"""Run a CTC source's bounds-checked build over chip_smoke.py's checked cases.

From the root of a checkout on a CUDA machine:
``python3 scripts/ctc_bounds_check.py [SOURCE.cu] [B T C U]``.
SOURCE (default ``stylish_tts_torch/csrc/ctc.cu``) is built with
``-DCTC_BOUNDS_CHECK`` (a device assert on every shared-memory and global
index) and run as ``chip_smoke.ctc_checked`` runs it: the U = 512 case 20
times on each of its three seeds, then the ragged, B=32/T=400/U=120,
U = 512 and main-path cases against the plain version (the main path's
shape B T C U, default 69 440 179 160). A failed assert makes the process
exit non-zero with the assert's message on stderr; a clean run prints one
JSON line.
"""
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from stylish_tts_torch.ops import ctc_cuda  # noqa: E402

if len(sys.argv) > 1:
    ctc_cuda.SOURCE = Path(sys.argv[1]).resolve()
shape = tuple(map(int, sys.argv[2:6])) if len(sys.argv) > 5 else (69, 440, 179, 160)
torch = cs.require_card()
result = cs.ctc_checked(torch, shape)
print(json.dumps({"source": str(ctc_cuda.SOURCE), "u512_runs": result["u512_runs"],
                  "launches": result["launches"]}))
