"""The port imports nothing of JAX and nothing of the JAX package.

In a fresh interpreter with ``jax``, ``flax``, ``optax`` and
``stylish_tts_tpu`` blocked (``sys.modules[name] = None`` makes any
import of them raise), every module of ``stylish_tts_torch`` and
``chip_smoke`` must import.
No ``nvcc``, ``triton`` or card is needed: the kernel library is built
and loaded on the first CUDA call only.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "stylish_tts_tpu")
for name in BLOCKED:
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
import stylish_tts_torch
names = ["chip_smoke", "stylish_tts_torch"] + [
    m.name for m in pkgutil.walk_packages(
        stylish_tts_torch.__path__, "stylish_tts_torch.")
]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if sys.modules[m] is not None and m.split(".")[0] in BLOCKED
)
assert not leaked, leaked
from stylish_tts_torch.ops import ctc_cuda
assert not ctc_cuda._libs, "kernel library loaded at import time"
for name in ("stylish_tts_torch.parallel", "stylish_tts_torch.parallel.mesh",
             "stylish_tts_torch.utils.flops", "stylish_tts_torch.export.programs",
             "stylish_tts_torch.utils.trace"):
    assert name in names, name
from stylish_tts_torch import parallel
assert parallel.world_size() == 1, "a process group made at import time"
print("imported", len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("imported")[-1])
    assert n >= 78, proc.stdout
