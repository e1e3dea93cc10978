"""ctypes bindings for the port's native code, built with ``g++``.

``stylish_io.cpp``, the batched WAV loader (counterpart of
``stylish_tts_tpu/native/__init__.py``), is compiled on the first call
(never at import); ``data/loader.py`` takes the scipy path where it cannot
be built, and counts which path served each batch. ``loudness.cpp``, the
K-weighting filters of ``tts/loudness.py`` and their square, is compiled
when that module is imported, which takes the scipy path where it cannot be
built. Each library is compiled from this package's own source once per
digest, into ``build/torch_native/`` of the checkout; no binary is shipped.
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
from typing import Callable, Dict, List, Optional

import numpy as np

logger = logging.getLogger("stylish_tts_torch")

SOURCE = Path(__file__).resolve().parent / "stylish_io.cpp"
LOUDNESS_SOURCE = Path(__file__).resolve().parent / "loudness.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
# no fused multiply-add, no -ffast-math, no -march: scipy's bits
LOUDNESS_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-ffp-contract=off"]

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()
_build_error: Optional[str] = None


def _library(source: Path, flags: List[str], path: Path,
             bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Compile ``source`` with ``flags`` into ``path`` unless it is there
    already (through a temporary file and ``os.replace``, so that processes
    building at once each find a whole library), load it once and ``bind``
    its functions' types."""
    with _lock:
        if path in _libs:
            return _libs[path]
        if not path.is_file():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError(f"no C++ compiler (g++) for {source.name}")
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {source}:\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _libs[path] = lib
        return lib


def _bind_io(lib: ctypes.CDLL) -> None:
    lib.stylish_load_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.stylish_load_wav_batch.restype = None
    lib.stylish_wav_frames.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.stylish_wav_frames.restype = ctypes.c_int64


def build(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """Compile ``stylish_io.cpp`` into ``build_dir`` (default ``BUILD_DIR``)
    unless this digest is there already, and load it."""
    build_dir = Path(build_dir or BUILD_DIR)
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return _library(SOURCE, CXX_FLAGS, build_dir / f"libstylish_io_{digest}.so", _bind_io)


def _bind_loudness(lib: ctypes.CDLL) -> None:
    doubles = np.ctypeslib.ndpointer(np.float64, ndim=1, flags="C_CONTIGUOUS")
    lib.stylish_k_weighted_square.argtypes = [
        np.ctypeslib.ndpointer(np.float32, ndim=1, flags="C_CONTIGUOUS"),
        ctypes.c_int64, doubles, doubles,
    ]
    lib.stylish_k_weighted_square.restype = None


def build_loudness(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    """Compile ``loudness.cpp`` into ``build_dir`` (default ``BUILD_DIR``)
    unless this digest of its source and flags is there already, and load
    it."""
    build_dir = Path(build_dir or BUILD_DIR)
    key = LOUDNESS_SOURCE.read_bytes() + " ".join(LOUDNESS_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return _library(LOUDNESS_SOURCE, LOUDNESS_FLAGS,
                    build_dir / f"libstylish_loudness_{digest}.so", _bind_loudness)


def loudness_library() -> Optional[ctypes.CDLL]:
    """The loudness library, or None where it cannot be built or loaded
    (logged)."""
    try:
        return build_loudness()
    except (RuntimeError, OSError) as exc:
        logger.warning("native loudness filter unavailable (%s); using scipy", exc)
        return None


def k_weighted_square(audio: np.ndarray, coeffs: np.ndarray,
                      lib: ctypes.CDLL) -> np.ndarray:
    """The K-weighted ``audio`` (1-D float32) squared, float64. ``coeffs``:
    the shelf's b0, b1, b2, a1, a2, then the high-pass's (both a0 are 1)."""
    audio = np.ascontiguousarray(audio)
    out = np.empty(audio.shape[0], np.float64)
    lib.stylish_k_weighted_square(audio, audio.shape[0], coeffs, out)
    return out


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
