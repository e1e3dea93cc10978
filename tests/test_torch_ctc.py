"""The port's CTC (stylish_tts_torch/ops) against the JAX package's.

Same inputs (numpy, from a seed) go through JAX ``ops/ctc.py`` (scan,
autodiff), JAX ``ops/ctc_pallas.py`` (Pallas kernels in interpret mode,
custom VJP) and the port's plain PyTorch version. Tolerances: loss
rtol 1e-4, gradient w.r.t. the logits atol 1e-4 (float32 on both sides,
different summation orders). The plain versions of the two CUDA kernels
(``ctc_alphas_betas``, ``ctc_grad_from_alphas_betas``): alpha, beta and ll
against ``ctc_alphas_betas_pallas`` at rtol 1e-5, atol 1e-4 (float32 on
both sides, |alpha| up to ~5 T), and the composed gradient against
autograd of ``ctc_nll`` at atol 1e-5 in float64. Rows that no alignment
fits get a zero gradient in the port (the JAX scan and Pallas VJP each
give them a different one; ROADMAP Queue 3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylish_tts_tpu.ops import ctc as jctc
from stylish_tts_tpu.ops.ctc_pallas import (
    ctc_alphas_betas_pallas,
    ctc_loss_with_priors_pallas,
)
from stylish_tts_torch.ops import ctc as tctc
from stylish_tts_torch.ops import ctc_cuda

LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-4
TRELLIS_RTOL = 1e-5
TRELLIS_ATOL = 1e-4
COMPOSED_ATOL = 1e-5

# the trellis cases: label lengths 0 and 1, a repeated label, input_len < T;
# S = 2*513+1 = 1027 states, more than one CUDA block has threads; and rows
# that no alignment fits (a repeated label in 8 frames where it needs 11,
# 3 frames for 5 labels) beside one that fits
TRELLIS_CASES = {
    "ragged": dict(b=4, t=30, c=12, u=8, seed=3, label_lengths=[0, 1, 8, 6],
                   input_lengths=[30, 17, 25, 20]),
    "infeasible": dict(b=3, t=12, c=12, u=6, seed=5, label_lengths=[6, 5, 4],
                       input_lengths=[8, 3, 12]),
    "above_1024_states": dict(b=2, t=1060, c=12, u=513, seed=4,
                              label_lengths=[513, 480],
                              input_lengths=[1060, 1000]),
}


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


def _trellis_problem(name):
    logits, il, labels, ll, blank, _ = _problem(**TRELLIS_CASES[name])
    if name == "ragged":
        labels[3, :6] = 4  # repeats need input_len >= 2L-1
    if name == "infeasible":
        labels[0, :6] = 4
    lp = torch.log_softmax(torch.from_numpy(logits), -1).numpy()
    return lp, il, labels, ll, blank


@pytest.mark.parametrize("name", sorted(TRELLIS_CASES))
def test_alphas_betas_match_jax_pallas_interpret(name):
    """alpha, beta and ll of the port's plain forward against the Pallas
    kernels (interpret mode, (T, B, S) moved to (B, T, S)) on the live
    states: t < len, s < 2L+1, and reachable (above NEG / 10; unreachable
    ones must be so on both sides). beta of a row with label length 0 is
    held against the scan only (next test; ROADMAP Queue 3: there the
    Pallas final mask is 0 where the exact derivative needs log 2)."""
    lp, il, labels, ll, blank = _trellis_problem(name)
    j_a, j_b, j_ll, _ = ctc_alphas_betas_pallas(
        jnp.asarray(lp), jnp.asarray(il), jnp.asarray(labels),
        jnp.asarray(ll), blank)
    t_a, t_b, t_ll = tctc.ctc_alphas_betas(
        torch.from_numpy(lp), torch.from_numpy(il), torch.from_numpy(labels),
        torch.from_numpy(ll), blank)
    np.testing.assert_allclose(t_ll.numpy(), np.asarray(j_ll), rtol=TRELLIS_RTOL)
    b, t, s = t_a.shape
    live = ((np.arange(t)[None, :, None] < il[:, None, None])
            & (np.arange(s)[None, None, :] < 2 * ll[:, None, None] + 1))
    for ours, ref, rows in ((t_a, j_a, ll >= 0), (t_b, j_b, ll > 0)):
        ours = ours.numpy()
        ref = np.moveaxis(np.asarray(ref), 0, 1)
        mask = live & rows[:, None, None]
        reach = mask & (ref > tctc.NEG / 10)
        assert reach.sum() > 0.2 * mask.sum()
        np.testing.assert_allclose(ours[reach], ref[reach], rtol=TRELLIS_RTOL,
                                   atol=TRELLIS_ATOL)
        assert (ours[mask & ~reach] <= tctc.NEG / 10).all()


def test_label_length_zero_gradient_matches_jax_scan():
    """Rows with label length 0: the gradient composed from the plain
    alpha and beta against the scan's autodiff (ROADMAP Queue 3: the
    Pallas VJP gives half of it)."""
    lp, il, labels, ll, blank = _trellis_problem("ragged")
    g = np.array([0.7, 1.3, 0.9, 1.1], np.float32)
    row = ll == 0
    j_grad = jax.grad(lambda x: jnp.sum(jctc.ctc_loss_with_priors(
        x, jnp.asarray(il), jnp.asarray(labels), jnp.asarray(ll),
        blank_id=blank, reduction="none") * jnp.asarray(g)))(jnp.asarray(lp))
    lab = torch.from_numpy(labels)
    t_a, t_b, t_ll = tctc.ctc_alphas_betas(
        torch.from_numpy(lp), torch.from_numpy(il), lab, torch.from_numpy(ll),
        blank)
    t_grad = tctc.ctc_grad_from_alphas_betas(
        t_a, t_b, t_ll, lab, torch.from_numpy(il), blank, lp.shape[-1],
        torch.from_numpy(g))
    np.testing.assert_allclose(t_grad.numpy()[row], np.asarray(j_grad)[row],
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("name", sorted(TRELLIS_CASES))
def test_composed_gradient_matches_autograd_in_float64(name):
    """ctc_grad_from_alphas_betas on ctc_alphas_betas is the gradient of
    ctc_nll (label length 0 included, zero where no alignment fits), and
    -ll its loss."""
    lp, il, labels, ll, blank = _trellis_problem(name)
    g = torch.from_numpy(np.linspace(0.5, 1.5, lp.shape[0])).double()
    args = (torch.from_numpy(il), torch.from_numpy(labels), torch.from_numpy(ll),
            blank)
    x = torch.from_numpy(lp).double().requires_grad_(True)
    loss = tctc.ctc_nll(x, *args)
    (loss * g).sum().backward()
    t_a, t_b, t_ll = tctc.ctc_alphas_betas(x.detach(), *args)
    grad = tctc.ctc_grad_from_alphas_betas(
        t_a, t_b, t_ll, args[1], args[0], blank, lp.shape[-1], g)
    np.testing.assert_allclose((-t_ll).numpy(), loss.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), x.grad.numpy(), atol=COMPOSED_ATOL)
    stuck = ~tctc.feasible(t_ll)
    assert int(stuck.sum()) == (2 if name == "infeasible" else 0)
    assert not grad[stuck].any() and not x.grad[stuck].any()


def test_rows_no_alignment_fits_get_no_gradient():
    """The loss of such a row is -NEG, as in the JAX scan, and its
    gradient zero; the other rows' loss and gradient are the scan's."""
    logits, il, labels, ll, blank, priors = _problem(**TRELLIS_CASES["infeasible"])
    labels[0, :6] = 4
    j_loss, j_grad = _jax_loss_and_grad(
        jctc.ctc_loss_with_priors, logits, il, labels, ll, blank, priors,
        "none")
    t_loss, t_grad = _torch_loss_and_grad(
        ctc_cuda.ctc_loss_with_priors_cuda, logits, il, labels, ll, blank,
        priors, "none")
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    np.testing.assert_array_equal(t_loss[:2], np.float32(-tctc.NEG))
    assert not t_grad[:2].any()
    np.testing.assert_allclose(t_grad[2], j_grad[2], atol=GRAD_ATOL)


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
        ctc_cuda.ctc_alpha_beta(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctc_cuda.ctc_alpha_beta(*args, store=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctc_cuda._CTCNLL.apply(*args)
    s = 2 * labels.shape[1] + 1
    trellis = torch.zeros((logits.shape[0], logits.shape[1], s))
    ll = torch.zeros((logits.shape[0],), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctc_cuda.ctc_grad(trellis, trellis, ll, *args[1:], logits.shape[-1],
                          torch.ones(logits.shape[0]))
    assert ctc_cuda.LAUNCHES == before

