"""CTC loss with label priors through the hand-written CUDA kernels.

Counterpart of ``stylish_tts_tpu/ops/ctc_pallas.py``. The kernels live in
``stylish_tts_torch/csrc/ctc.cu`` (see the note there); they are built
with ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` on first use
and loaded with ctypes.

Dispatch is by the device of the tensor: a CPU tensor takes the plain
version (``ops/ctc.py``), a CUDA tensor launches the kernels or raises.
There is no fallback from one to the other.

``bounds_checked()`` switches the wrappers, for the calls inside it, to a
second build of the same source with ``-DCTC_BOUNDS_CHECK`` (a device
assert on every shared-memory and global index), in its own file; it is
built only there. A failed assert ends the process's CUDA context, so run
it in a process of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import torch

from ..utils.trace import counter
from . import ctc as plain

# Launch counts, one per kernel, bumped only where the kernel launches.
LAUNCHES = counter("ctc.launches", ("alpha_beta", "grad"))

# S = 2U+1 states (1025 at collate.MAX_TEXT = 512)
MAX_STATES = 1025
MAX_CLASSES = 1024

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ctc.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

CHECK_FLAGS = ["-DCTC_BOUNDS_CHECK"]

_libs = {}  # checked (bool) -> the loaded library
_lib_lock = threading.Lock()
_checked = False  # set inside bounds_checked()
BUILD_LOG = ""  # nvcc's output (ptxas registers / shared memory / spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CTC kernels need the CUDA toolkit")


def build(checked: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/ctc.cu`` (once per source digest) and load it;
    ``checked``: the bounds-checked variant, into a file of its own."""
    global BUILD_LOG
    with _lib_lock:
        if checked in _libs:
            return _libs[checked]
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        path = BUILD_DIR / f"libctc{'_checked' if checked else ''}_{digest}.so"
        if not path.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            flags = NVCC_FLAGS + (CHECK_FLAGS if checked else [])
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ctc_alpha_beta_fwd.argtypes = [
            p, p, p, p, i, i, i, i, i, i, p, p, p, p, p,
        ]
        lib.ctc_alpha_beta_fwd.restype = i
        lib.ctc_grad_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p, p]
        lib.ctc_grad_bwd.restype = i
        _libs[checked] = lib
        return lib


@contextmanager
def bounds_checked():
    """Inside, the wrappers launch the bounds-checked build's kernels."""
    global _checked
    _checked = True
    try:
        yield build(checked=True)
    finally:
        _checked = False


def _check_ints(b, device, input_lengths, labels, label_lengths):
    for name, x, shape in (
        ("input_lengths", input_lengths, (b,)),
        ("label_lengths", label_lengths, (b,)),
        ("labels", labels, (b, labels.shape[-1])),
    ):
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(
                f"{name} must be int32 of shape {shape}, got {x.dtype} "
                f"{tuple(x.shape)}"
            )
        if x.device != device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def _check_inputs(log_probs, input_lengths, labels, label_lengths, blank_id):
    if log_probs.device.type != "cuda":
        raise ValueError(f"CTC kernel needs a CUDA tensor, got {log_probs.device}")
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise ValueError(
            f"log_probs must be float32 (B, T, C), got {log_probs.dtype} "
            f"{tuple(log_probs.shape)}"
        )
    b, t, c = log_probs.shape
    _check_ints(b, log_probs.device, input_lengths, labels, label_lengths)
    if not log_probs.is_contiguous():
        raise ValueError("log_probs must be contiguous")
    s = 2 * labels.shape[1] + 1
    if s > MAX_STATES or c > MAX_CLASSES or b == 0 or t == 0:
        raise ValueError(
            f"CTC kernel supports 1 <= B, 1 <= T, S = 2U+1 <= {MAX_STATES} "
            f"and C <= {MAX_CLASSES}; got B={b}, T={t}, S={s}, C={c}"
        )
    if not 0 <= blank_id < c:
        raise ValueError(f"blank_id {blank_id} outside [0, {c})")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def ctc_alpha_beta(log_probs, input_lengths, labels, label_lengths, blank_id,
                   store: bool = True):
    """Forward kernel: (alpha, beta, offsets, ll).

    alpha and beta (B, T, S) float32 hold each state's value less the
    offset of its frame, offsets (B, 2, T) float64 (alpha's, then beta's),
    ll (B,) float64; only t < len and s < 2L+1 are written (see
    ``trellis``). ``store=False`` walks alpha alone and returns
    (None, None, None, ll)."""
    _check_inputs(log_probs, input_lengths, labels, label_lengths, blank_id)
    b, t, c = log_probs.shape
    u = labels.shape[1]
    s = 2 * u + 1
    lib = build(_checked)
    dev = log_probs.device
    ll = torch.empty((b,), dtype=torch.float64, device=dev)
    alpha = beta = offsets = None
    if store:
        alpha = torch.empty((b, t, s), dtype=torch.float32, device=dev)
        beta = torch.empty((b, t, s), dtype=torch.float32, device=dev)
        offsets = torch.empty((b, 2, t), dtype=torch.float64, device=dev)
    err = lib.ctc_alpha_beta_fwd(
        log_probs.data_ptr(), labels.data_ptr(), input_lengths.data_ptr(),
        label_lengths.data_ptr(), b, t, c, u, blank_id, 2 if store else 1,
        _ptr(alpha), _ptr(beta), _ptr(offsets), ll.data_ptr(), _stream(),
    )
    if err != 0:
        raise RuntimeError(f"ctc_alpha_beta_fwd launch failed: cudaError {err}")
    LAUNCHES["alpha_beta"] += 1
    return alpha, beta, offsets, ll


def trellis(alpha, beta, offsets, input_lengths, label_lengths):
    """alpha and beta (B, T, S) in float64 from the forward kernel's
    residuals and offsets, NaN where the kernel wrote nothing (t >= len or
    s >= 2L+1)."""
    b, t, s = alpha.shape
    live = ((torch.arange(t, device=alpha.device)[None, :, None]
             < input_lengths.long()[:, None, None])
            & (torch.arange(s, device=alpha.device)[None, None, :]
               < 2 * label_lengths.long()[:, None, None] + 1))
    nan = torch.full((), float("nan"), dtype=torch.float64, device=alpha.device)
    return tuple(
        torch.where(live, res.double() + offsets[:, i, :, None], nan)
        for i, res in enumerate((alpha, beta))
    )


def ctc_grad(alpha, beta, ll, input_lengths, labels, label_lengths, blank_id,
             num_classes, g):
    """Gradient kernel: d(-ll)/d log_probs * g, (B, T, C) float32, from the
    forward kernel's alpha, beta and ll (the offsets cancel in gamma's
    per-frame normalisation, see csrc/ctc.cu); zero on the rows whose ll is
    at NEG, which no alignment fits."""
    if alpha.device.type != "cuda":
        raise ValueError(f"CTC kernel needs a CUDA tensor, got {alpha.device}")
    b, t, s = alpha.shape
    u = labels.shape[1]
    _check_ints(b, alpha.device, input_lengths, labels, label_lengths)
    g = g.to(torch.float32).contiguous()
    if (s != 2 * u + 1 or tuple(beta.shape) != (b, t, s) or tuple(g.shape) != (b,)
            or tuple(ll.shape) != (b,) or ll.dtype != torch.float64
            or alpha.dtype != torch.float32 or beta.dtype != torch.float32
            or beta.device != alpha.device or g.device != alpha.device
            or ll.device != alpha.device
            or not (alpha.is_contiguous() and beta.is_contiguous()
                    and ll.is_contiguous())):
        raise ValueError("alpha / beta / ll / g do not match the labels")
    if not 0 <= blank_id < num_classes <= MAX_CLASSES:
        raise ValueError(f"blank_id {blank_id} / num_classes {num_classes}")
    lib = build(_checked)
    grad = torch.empty((b, t, num_classes), dtype=torch.float32, device=alpha.device)
    err = lib.ctc_grad_bwd(
        alpha.data_ptr(), beta.data_ptr(), labels.data_ptr(),
        input_lengths.data_ptr(), label_lengths.data_ptr(), ll.data_ptr(),
        g.data_ptr(), b, t, num_classes, u, blank_id, grad.data_ptr(), _stream(),
    )
    if err != 0:
        raise RuntimeError(f"ctc_grad_bwd launch failed: cudaError {err}")
    LAUNCHES["grad"] += 1
    return grad


class _CTCNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_probs, input_lengths, labels, label_lengths, blank_id):
        alpha, beta, _, ll = ctc_alpha_beta(
            log_probs, input_lengths, labels, label_lengths, blank_id
        )
        ctx.save_for_backward(input_lengths, labels, label_lengths, alpha, beta,
                              ll)
        ctx.blank_id = blank_id
        ctx.num_classes = log_probs.shape[-1]
        return (-ll).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        input_lengths, labels, label_lengths, alpha, beta, ll = ctx.saved_tensors
        grad = ctc_grad(
            alpha, beta, ll, input_lengths, labels, label_lengths,
            ctx.blank_id, ctx.num_classes, g,
        )
        return grad, None, None, None, None


def ctc_nll_cuda(log_probs, input_lengths, labels, label_lengths, blank_id):
    """Per-sequence CTC negative log-likelihood (B,): the kernels for a CUDA
    tensor, the plain version for a CPU tensor. Where no gradient is
    wanted, the forward kernel walks alpha alone and stores nothing."""
    if log_probs.device.type == "cpu":
        return plain.ctc_nll(
            log_probs, input_lengths, labels, label_lengths, blank_id
        )
    if not (torch.is_grad_enabled() and log_probs.requires_grad):
        ll = ctc_alpha_beta(
            log_probs, input_lengths, labels, label_lengths, blank_id,
            store=False,
        )[3]
        return (-ll).to(torch.float32)
    return _CTCNLL.apply(
        log_probs, input_lengths, labels, label_lengths, blank_id
    )


def ctc_loss_with_priors_cuda(
    log_probs: torch.Tensor,
    input_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int,
    log_priors: Optional[torch.Tensor] = None,
    prior_scale: float = 0.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Drop-in for ``ops.ctc.ctc_loss_with_priors`` (the prior shift and the
    reduction stay in PyTorch, as ``ctc_pallas.py`` keeps them in JAX)."""
    if log_priors is not None and prior_scale > 0.0:
        log_probs = log_probs - prior_scale * log_priors[None, None, :]
    loss = ctc_nll_cuda(
        log_probs, input_lengths, labels, label_lengths, blank_id
    )
    return plain.reduce_loss(loss, label_lengths, reduction)
