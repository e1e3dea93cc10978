"""The port's CTC (stylish_tts_torch/ops) against the JAX package's.

Same inputs (numpy, from a seed) go through JAX ``ops/ctc.py`` (scan,
autodiff), JAX ``ops/ctc_pallas.py`` (Pallas kernels in interpret mode,
custom VJP) and the port's plain PyTorch version. Tolerances: loss
rtol 1e-4, gradient w.r.t. the logits atol 1e-4 (float32 on both sides,
different summation orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylish_tts_tpu.ops import ctc as jctc
from stylish_tts_tpu.ops.ctc_pallas import ctc_loss_with_priors_pallas
from stylish_tts_torch.ops import ctc as tctc
from stylish_tts_torch.ops import ctc_cuda

LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-4


def _problem(b=3, t=24, c=10, u=5, seed=0, label_lengths=None,
             input_lengths=None):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c)).astype(np.float32)
    labels = rng.integers(0, c - 1, size=(b, u)).astype(np.int32)
    if label_lengths is None:
        label_lengths = [u, u - 1, u - 3]
    if input_lengths is None:
        input_lengths = [t, t - 5, t - 9]
    label_lengths = np.asarray(label_lengths, np.int32)
    input_lengths = np.asarray(input_lengths, np.int32)
    for i in range(b):
        labels[i, label_lengths[i]:] = 0
    priors = np.linspace(-3, -1, c).astype(np.float32)
    return logits, input_lengths, labels, label_lengths, c - 1, priors


def _jax_loss_and_grad(fn, logits, il, labels, ll, blank, priors, reduction):
    def loss_fn(z):
        return fn(
            jax.nn.log_softmax(z, axis=-1), jnp.asarray(il),
            jnp.asarray(labels), jnp.asarray(ll), blank_id=blank,
            log_priors=None if priors is None else jnp.asarray(priors),
            prior_scale=0.0 if priors is None else 0.3, reduction=reduction,
        )

    if reduction == "none":
        loss = loss_fn(jnp.asarray(logits))
        grad = jax.grad(lambda z: jnp.sum(loss_fn(z)))(jnp.asarray(logits))
    else:
        loss, grad = jax.value_and_grad(loss_fn)(jnp.asarray(logits))
    return np.asarray(loss), np.asarray(grad)


def _torch_loss_and_grad(fn, logits, il, labels, ll, blank, priors, reduction):
    z = torch.from_numpy(logits).requires_grad_(True)
    loss = fn(
        torch.log_softmax(z, -1), torch.from_numpy(il),
        torch.from_numpy(labels), torch.from_numpy(ll), blank,
        log_priors=None if priors is None else torch.from_numpy(priors),
        prior_scale=0.0 if priors is None else 0.3, reduction=reduction,
    )
    loss.sum().backward()
    return loss.detach().numpy(), z.grad.numpy()


@pytest.mark.parametrize("with_priors", [False, True])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_plain_matches_jax_scan(reduction, with_priors):
    logits, il, labels, ll, blank, priors = _problem(seed=1)
    priors = priors if with_priors else None
    j_loss, j_grad = _jax_loss_and_grad(
        jctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        reduction)
    t_loss, t_grad = _torch_loss_and_grad(
        tctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        reduction)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, atol=GRAD_ATOL)


@pytest.mark.parametrize("with_priors", [False, True])
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_plain_matches_jax_pallas_interpret(reduction, with_priors):
    """Against the Pallas kernels (interpret mode off-TPU) and their
    custom VJP, the function the CUDA kernels replace."""
    logits, il, labels, ll, blank, priors = _problem(seed=2)
    priors = priors if with_priors else None
    p_loss, p_grad = _jax_loss_and_grad(
        ctc_loss_with_priors_pallas, logits, il, labels, ll, blank, priors,
        reduction)
    t_loss, t_grad = _torch_loss_and_grad(
        tctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        reduction)
    np.testing.assert_allclose(t_loss, p_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, p_grad, atol=GRAD_ATOL)


def test_plain_ragged_edge_cases_match_jax_scan():
    """Label lengths 0 and 1, a repeated label, input_len < T."""
    logits, il, labels, ll, blank, priors = _problem(
        b=4, t=30, c=12, u=8, seed=3, label_lengths=[0, 1, 8, 6],
        input_lengths=[30, 17, 25, 20])
    labels[3, :6] = 4  # repeats need input_len >= 2L-1
    j_loss, j_grad = _jax_loss_and_grad(
        jctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        "none")
    t_loss, t_grad = _torch_loss_and_grad(
        tctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        "none")
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, atol=GRAD_ATOL)


def test_plain_matches_jax_scan_above_1024_states():
    """S = 2*513+1 = 1027 states, more than one CUDA block has threads."""
    logits, il, labels, ll, blank, priors = _problem(
        b=2, t=1060, c=12, u=513, seed=4, label_lengths=[513, 480],
        input_lengths=[1060, 1000])
    j_loss, j_grad = _jax_loss_and_grad(
        jctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        "none")
    t_loss, t_grad = _torch_loss_and_grad(
        tctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        "none")
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_grad, j_grad, atol=GRAD_ATOL)


def test_label_priors_match_jax():
    rng = np.random.default_rng(5)
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((3, 20, 11)).astype(np.float32)), -1).numpy()
    il = np.array([20, 13, 7], np.int32)
    j_lse, j_count = jctc.accumulate_label_priors(jnp.asarray(lp), jnp.asarray(il))
    t_lse, t_count = tctc.accumulate_label_priors(torch.from_numpy(lp),
                                                  torch.from_numpy(il))
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=1e-5)
    assert int(t_count) == int(j_count) == 40
    j_pri = jctc.update_log_priors(j_lse, jnp.float32(40.0))
    t_pri = tctc.update_log_priors(t_lse, torch.tensor(40.0))
    np.testing.assert_allclose(t_pri.numpy(), np.asarray(j_pri), rtol=1e-5)


@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_cuda_wrapper_cpu_path_is_the_plain_version(reduction):
    logits, il, labels, ll, blank, priors = _problem(seed=6)
    w_loss, w_grad = _torch_loss_and_grad(
        ctc_cuda.ctc_loss_with_priors_cuda, logits, il, labels, ll, blank,
        priors, reduction)
    p_loss, p_grad = _torch_loss_and_grad(
        tctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        reduction)
    np.testing.assert_array_equal(w_loss, p_loss)
    np.testing.assert_array_equal(w_grad, p_grad)


def test_kernel_entry_points_refuse_cpu_tensors():
    """The kernel wrappers never run a CPU tensor (no silent fallback)."""
    logits, il, labels, ll, blank, _ = _problem(seed=7)
    args = (torch.from_numpy(logits), torch.from_numpy(il),
            torch.from_numpy(labels), torch.from_numpy(ll), blank)
    before = dict(ctc_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctc_cuda.ctc_alpha(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctc_cuda._CTCNLL.apply(*args)
    assert ctc_cuda.LAUNCHES == before

