"""ctypes binding for the native batched WAV loader (``stylish_io.cpp``).

Counterpart of ``stylish_tts_tpu/native/__init__.py``. The library is
compiled from this package's own source with ``g++`` on the first call
(never at import), once per source digest, into ``build/torch_native/``
of the checkout; no binary is shipped. ``data/loader.py`` takes the scipy
path where it cannot be built, and counts which path served each batch.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger("stylish_tts_torch")

SOURCE = Path(__file__).resolve().parent / "stylish_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()
_build_error: Optional[str] = None


def build(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """Compile ``stylish_io.cpp`` into ``build_dir`` (default ``BUILD_DIR``)
    unless this digest is there already, and load it."""
    build_dir = Path(build_dir or BUILD_DIR)
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    path = build_dir / f"libstylish_io_{digest}.so"
    with _lock:
        if path in _libs:
            return _libs[path]
        if not path.is_file():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("no C++ compiler (g++) for the native loader")
            build_dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.stylish_load_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.stylish_load_wav_batch.restype = None
        lib.stylish_wav_frames.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.stylish_wav_frames.restype = ctypes.c_int64
        _libs[path] = lib
        return lib


def available() -> bool:
    """Whether the default library builds and loads; a failure is logged
    once and remembered."""
    global _build_error
    if _build_error is not None:
        return False
    try:
        build()
    except (RuntimeError, OSError) as exc:
        _build_error = str(exc)
        logger.warning("native loader unavailable (%s); using scipy", exc)
        return False
    return True


def load_wav_batch(
    paths: List[str], target_sr: int, target_len: int,
    lib: Optional[ctypes.CDLL] = None,
) -> np.ndarray:
    """Load + resample + center-pad a batch -> (n, target_len) float32, on
    one thread per hardware thread (the C entry's ``n_threads`` = 0)."""
    lib = lib or build()
    n = len(paths)
    out = np.zeros((n, target_len), np.float32)
    statuses = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.stylish_load_wav_batch(
        c_paths, n, target_sr, target_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        0,
    )
    bad = [paths[i] for i in range(n) if statuses[i] < 0]
    if bad:
        raise IOError(f"native loader failed for: {bad}")
    return out


def wav_frames(path: str, target_sr: int, lib: Optional[ctypes.CDLL] = None) -> int:
    lib = lib or build()
    return int(lib.stylish_wav_frames(path.encode(), target_sr))
