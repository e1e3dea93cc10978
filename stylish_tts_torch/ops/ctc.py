"""Batched CTC loss with label priors, and Viterbi forced alignment, in
plain PyTorch.

Counterpart of ``stylish_tts_tpu/ops/ctc.py`` and the spec that the CUDA
kernels of ``ops/ctc_cuda.py`` are held to. Label-prior CTC ("Less Peaky
CTC"): scaled log-priors are subtracted from the posteriors without
renormalizing, so the recursion is written out (``F.ctc_loss`` would
renormalize nothing but takes no priors and uses ``-inf``).

Trellis over the extended labels z = [blank, l1, blank, ..., lU, blank]
(S = 2U+1 states), in log space with ``NEG = -1e30`` (never ``-inf``) and
``+1e-30`` inside every log-sum-exp, alpha frozen past each input length:
  alpha[t, s] = emit[t, z_s] + LSE(alpha[t-1, s], alpha[t-1, s-1],
                                   [alpha[t-1, s-2] if allowed])
The gradient is autograd through the time loop. A row that no alignment
fits (too few frames for its labels and the blanks between repeats) has
ll at NEG; its loss is -NEG and its gradient zero, on every CTC path of
the port (the JAX reference's scan and Pallas VJP each give that row a
different, meaningless gradient).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30


def _extended_labels(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """(B, U) -> (B, 2U+1) extended label sequence with interleaved blanks."""
    b, u = labels.shape
    ext = torch.full((b, 2 * u + 1), blank_id, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _transition_masks(ext: torch.Tensor, blank_id: int) -> torch.Tensor:
    """Skip-transition allowed where z_s != blank and z_s != z_{s-2}."""
    skip_ok = torch.zeros(ext.shape, dtype=torch.bool, device=ext.device)
    skip_ok[:, 2:] = (ext[:, 2:] != blank_id) & (ext[:, 2:] != ext[:, :-2])
    return skip_ok


def _lse(*xs: torch.Tensor) -> torch.Tensor:
    stacked = torch.stack(xs, dim=0)
    m = torch.max(stacked, dim=0).values
    return m + torch.log(torch.sum(torch.exp(stacked - m[None]), dim=0) + 1e-30)


def ctc_loss_with_priors(
    log_probs: torch.Tensor,  # (B, T, C) log-softmax posteriors
    input_lengths: torch.Tensor,  # (B,)
    labels: torch.Tensor,  # (B, U) padded token ids
    label_lengths: torch.Tensor,  # (B,)
    blank_id: int,
    log_priors: Optional[torch.Tensor] = None,  # (C,)
    prior_scale: float = 0.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """Negative log-likelihood CTC loss, optionally prior-shifted."""
    log_probs = log_probs.to(torch.float32)
    if log_priors is not None and prior_scale > 0.0:
        log_probs = log_probs - prior_scale * log_priors[None, None, :]
    return reduce_loss(
        ctc_nll(log_probs, input_lengths, labels, label_lengths, blank_id),
        label_lengths, reduction,
    )


def reduce_loss(loss: torch.Tensor, label_lengths: torch.Tensor,
                reduction: str) -> torch.Tensor:
    if reduction == "mean":
        # torch/k2 "mean": divide by target length, then batch-average
        return torch.mean(loss / torch.clamp(label_lengths, min=1).to(loss.dtype))
    if reduction == "sum":
        return torch.sum(loss)
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def ctc_nll(log_probs, input_lengths, labels, label_lengths, blank_id):
    """Per-sequence CTC negative log-likelihood (B,) of (B, T, C) log-probs."""
    b, t_max, _ = log_probs.shape
    device = log_probs.device
    labels = labels.long()
    label_lengths = label_lengths.long()
    input_lengths = input_lengths.long()
    s_max = 2 * labels.shape[1] + 1
    ext = _extended_labels(labels, blank_id)
    skip_ok = _transition_masks(ext, blank_id)
    emits = torch.gather(
        log_probs, 2, ext[:, None, :].expand(b, t_max, s_max)
    )  # (B, T, S)

    neg = torch.full((b, s_max), NEG, dtype=log_probs.dtype, device=device)

    def shift(a, n):
        return F.pad(a, (n, 0), value=NEG)[:, :s_max]

    state_idx = torch.arange(s_max, device=device)[None, :]
    init = (state_idx == 0) | ((state_idx == 1) & (label_lengths[:, None] > 0))
    alpha = torch.where(init, emits[:, 0], neg)
    state_valid = state_idx < 2 * label_lengths[:, None] + 1

    for t in range(1, t_max):
        step1 = shift(alpha, 1)
        step2 = torch.where(skip_ok, shift(alpha, 2), neg)
        new = _lse(alpha, step1, step2) + emits[:, t]
        new = torch.where(state_valid, new, neg)
        # frames beyond each sequence's length keep alpha frozen
        active = (t < input_lengths)[:, None]
        alpha = torch.where(active, new, alpha)

    # final states: 2U (last blank) and 2U-1 (last label)
    last_blank = 2 * label_lengths
    last_label = torch.clamp(2 * label_lengths - 1, min=0)
    fb = torch.gather(alpha, 1, last_blank[:, None])[:, 0]
    fl = torch.gather(alpha, 1, last_label[:, None])[:, 0]
    ll = _lse(fb, fl)
    return -torch.where(feasible(ll), ll, ll.detach())


def feasible(ll: torch.Tensor) -> torch.Tensor:
    """The rows that some alignment fits: ll above NEG / 2."""
    return ll > NEG / 2


def ctc_alphas_betas(log_probs, input_lengths, labels, label_lengths, blank_id,
                     _lses=(_lse, _lse)):
    """The forward and reverse trellis: (alphas (B, T, S), betas (B, T, S),
    ll (B,)), the plain version of the CUDA forward kernel.

    The convention of ``ctc_alphas_betas_pallas`` in the (B, T, S) layout:
    alpha includes the emission at t and is frozen for t >= len; beta[t]
    excludes the emission at t, takes the skip s+2 -> s where the
    destination s+2 allows it, and is the final row for t >= len-1. The
    final row is log(number of final indices equal to s): 0 at 2L and
    2L-1, and log 2 at s = 0 when L = 0, where both final indices are 0
    (the exact derivative of ll; the Pallas final mask has 0 there).
    Summed over the states of one frame t < len, exp(alpha + beta) is
    exp(ll). ``_lses`` are the log-sum-exps of the alpha and of the beta
    recursion; ``scripts/ctc_gamma_error_sim.py`` swaps in perturbed ones."""
    lse_alpha, lse_beta = _lses
    b, t_max, _ = log_probs.shape
    device = log_probs.device
    labels = labels.long()
    label_lengths = label_lengths.long()
    input_lengths = input_lengths.long()
    s_max = 2 * labels.shape[1] + 1
    ext = _extended_labels(labels, blank_id)
    skip_ok = _transition_masks(ext, blank_id)
    emits = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t_max, s_max))
    neg = torch.full((b, s_max), NEG, dtype=log_probs.dtype, device=device)
    state_idx = torch.arange(s_max, device=device)[None, :]
    state_valid = state_idx < 2 * label_lengths[:, None] + 1

    init = (state_idx == 0) | ((state_idx == 1) & (label_lengths[:, None] > 0))
    alpha = torch.where(init, emits[:, 0], neg)
    alphas = [alpha]
    for t in range(1, t_max):
        step1 = F.pad(alpha, (1, 0), value=NEG)[:, :s_max]
        step2 = torch.where(skip_ok, F.pad(alpha, (2, 0), value=NEG)[:, :s_max], neg)
        new = torch.where(state_valid, lse_alpha(alpha, step1, step2) + emits[:, t],
                          neg)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
        alphas.append(alpha)

    last_blank = (2 * label_lengths)[:, None]
    last_label = torch.clamp(2 * label_lengths - 1, min=0)[:, None]
    n_final = ((state_idx == last_blank).to(log_probs.dtype)
               + (state_idx == last_label).to(log_probs.dtype))
    final = torch.where(n_final > 0, torch.log(n_final.clamp_min(1)), neg)
    skip_next = F.pad(skip_ok[:, 2:], (0, 2), value=False)
    beta = final
    betas = [beta]
    for t in range(t_max - 2, -1, -1):
        term = beta + emits[:, t + 1]
        step1 = F.pad(term[:, 1:], (0, 1), value=NEG)
        step2 = torch.where(skip_next, F.pad(term[:, 2:], (0, 2), value=NEG), neg)
        new = torch.where(state_valid, lse_beta(term, step1, step2), neg)
        beta = torch.where((t + 1 < input_lengths)[:, None], new, final)
        betas.append(beta)

    alphas = torch.stack(alphas, dim=1)
    betas = torch.stack(betas[::-1], dim=1)
    fb = torch.gather(alpha, 1, last_blank)[:, 0]
    fl = torch.gather(alpha, 1, last_label)[:, 0]
    return alphas, betas, _lse(fb, fl)


def ctc_grad_from_alphas_betas(alphas, betas, ll, labels, input_lengths,
                               blank_id, num_classes, g):
    """d(-ll)/d log_probs scaled by g (B,): gamma = exp(alpha + beta - N_t)
    on the frames t < len, summed into the classes of the extended labels;
    the plain version of the CUDA gradient kernel (B, T, C). As the kernel
    does, gamma is normalised per frame, N_t = LSE_s(alpha + beta), which
    is ll in exact arithmetic; rows that no alignment fits (``feasible``
    false) get zero, as ``ctc_nll``'s autograd does."""
    b, t_max, s_max = alphas.shape
    ext = _extended_labels(labels.long(), blank_id)
    x = alphas + betas
    gamma = torch.exp(x - torch.logsumexp(x, dim=-1, keepdim=True))
    live = ((torch.arange(t_max, device=alphas.device)[None, :]
             < input_lengths[:, None]) & feasible(ll)[:, None])
    gamma = torch.where(live[..., None], gamma, torch.zeros_like(gamma))
    occupancy = torch.zeros((b, t_max, num_classes), dtype=gamma.dtype,
                            device=gamma.device)
    occupancy.scatter_add_(2, ext[:, None, :].expand(b, t_max, s_max), gamma)
    return -g.to(gamma.dtype)[:, None, None] * occupancy


class ForcedAlignResult(NamedTuple):
    frame_tokens: torch.Tensor  # (B, T) int32 token index per frame (-1 past length)
    durations: torch.Tensor  # (B, U) int32 frames per token
    scores: torch.Tensor  # (B,) float32 mean per-frame log-prob of the best path
    onsets: torch.Tensor  # (B, T) bool: first frame of each token's label state


def ctc_forced_align(
    log_probs: torch.Tensor,  # (B, T, C)
    input_lengths: torch.Tensor,  # (B,)
    labels: torch.Tensor,  # (B, U)
    label_lengths: torch.Tensor,  # (B,)
    blank_id: int,
) -> ForcedAlignResult:
    """Viterbi best path through the CTC trellis, then a backtrace through
    int8 back-pointers (T-1, B, S).

    Blank frames go to the preceding token (a leading blank to the first),
    and ``onsets`` marks the first frame of each label state, from which
    ``dataprep/align.py`` ``k2_pad_attribution`` builds the pad durations.
    The choice among (stay, step1, step2) is the first maximum, written as
    comparisons, as ``jnp.argmax`` picks it. Everything is max-plus with
    elementwise adds, so the same ``log_probs`` give bit-identical integer
    outputs on every device. Neither loop reads a device value on the host.
    """
    log_probs = log_probs.to(torch.float32)
    b, t_max, _ = log_probs.shape
    device = log_probs.device
    labels = labels.long()
    label_lengths = label_lengths.long()
    input_lengths = input_lengths.long()
    u_max = labels.shape[1]
    s_max = 2 * u_max + 1
    ext = _extended_labels(labels, blank_id)
    skip_ok = _transition_masks(ext, blank_id)
    emits = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t_max, s_max))
    neg = torch.full((b, s_max), NEG, dtype=torch.float32, device=device)
    state_idx = torch.arange(s_max, device=device)[None, :]
    state_valid = state_idx < 2 * label_lengths[:, None] + 1
    init = (state_idx == 0) | ((state_idx == 1) & (label_lengths[:, None] > 0))
    alpha = torch.where(init, emits[:, 0], neg)

    one = torch.ones((), dtype=torch.int8, device=device)
    two = torch.full((), 2, dtype=torch.int8, device=device)
    zero = torch.zeros((), dtype=torch.int8, device=device)
    choices = torch.empty((max(t_max - 1, 0), b, s_max), dtype=torch.int8,
                          device=device)
    for t in range(1, t_max):
        step1 = F.pad(alpha, (1, 0), value=NEG)[:, :s_max]
        step2 = torch.where(skip_ok, F.pad(alpha, (2, 0), value=NEG)[:, :s_max], neg)
        best01 = torch.maximum(alpha, step1)
        choice = torch.where(step2 > best01, two, torch.where(step1 > alpha, one, zero))
        best = torch.where(state_valid, torch.maximum(best01, step2) + emits[:, t], neg)
        active = (t < input_lengths)[:, None]
        alpha = torch.where(active, best, alpha)
        choices[t - 1] = torch.where(active, choice, zero)

    last_blank = 2 * label_lengths
    last_label = torch.clamp(2 * label_lengths - 1, min=0)
    fb = torch.gather(alpha, 1, last_blank[:, None])[:, 0]
    fl = torch.gather(alpha, 1, last_label[:, None])[:, 0]
    state = torch.where(fb >= fl, last_blank, last_label)
    best_ll = torch.maximum(fb, fl)

    # backtrace: state(t-1) = state(t) - choice[t-1, state(t)]; choices
    # are 0 (stay) past each sequence's length, so the padded tail is a no-op
    states = torch.empty((t_max, b), dtype=torch.long, device=device)
    states[t_max - 1] = state
    for t in range(t_max - 1, 0, -1):
        state = state - torch.gather(choices[t - 1], 1, state[:, None])[:, 0].long()
        states[t - 1] = state
    states = states.transpose(0, 1)  # (B, T)

    # label state 2u+1 -> token u; blank state 2u -> token u-1, clipped
    tokens = torch.where(states % 2 == 1, states // 2, states // 2 - 1)
    tokens = torch.minimum(torch.clamp(tokens, min=0),
                           torch.clamp(label_lengths - 1, min=0)[:, None])
    frame_valid = (torch.arange(t_max, device=device)[None, :]
                   < input_lengths[:, None])
    frame_tokens = torch.where(frame_valid, tokens, torch.full_like(tokens, -1))
    durations = (frame_tokens[:, :, None]
                 == torch.arange(u_max, device=device)[None, None, :]).sum(dim=1)
    changed = torch.ones_like(frame_valid)
    changed[:, 1:] = states[:, 1:] != states[:, :-1]
    onsets = (states % 2 == 1) & changed & frame_valid
    scores = best_ll / torch.clamp(input_lengths, min=1).to(torch.float32)
    return ForcedAlignResult(frame_tokens.to(torch.int32), durations.to(torch.int32),
                             scores, onsets)


def accumulate_label_priors(
    log_probs: torch.Tensor, input_lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-batch prior statistics: (logsumexp over valid frames (C,), count)."""
    b, t, c = log_probs.shape
    valid = (torch.arange(t, device=log_probs.device)[None, :]
             < input_lengths[:, None])[..., None]
    masked = torch.where(valid, log_probs, torch.full_like(log_probs, NEG))
    flat = masked.reshape(b * t, c)
    m = torch.max(flat, dim=0).values
    lse = m + torch.log(torch.sum(torch.exp(flat - m[None]), dim=0) + 1e-30)
    count = torch.sum(input_lengths)
    return lse, count


def update_log_priors(
    log_priors_sum: torch.Tensor, num_samples: torch.Tensor, floor: float = -12.0
) -> torch.Tensor:
    """End-of-epoch prior update with the reference's -12 floor."""
    new = log_priors_sum - torch.log(num_samples + 1e-9)
    return torch.clamp(new, min=floor)
