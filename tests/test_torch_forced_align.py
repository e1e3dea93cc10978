"""The port's Viterbi forced alignment (``ops/ctc.py`` ``ctc_forced_align``)
and the k2 pad attribution (``dataprep/align.py`` ``k2_pad_attribution``)
against the JAX package's, on the same seeded inputs.

Tolerances: frame tokens, durations and onsets exactly equal (the
Viterbi is max-plus with elementwise adds on identical log-probs); scores
within 1e-6 absolute; the pad attribution exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylish_tts_tpu.dataprep.align import k2_pad_attribution as jax_k2
from stylish_tts_tpu.ops.ctc import ctc_forced_align as jax_forced_align
from stylish_tts_torch.dataprep.align import k2_pad_attribution
from stylish_tts_torch.ops.ctc import ctc_forced_align

SCORE_ATOL = 1e-6
# one XLA program per case compiles faster than op-by-op dispatch
JAX_FORCED_ALIGN = jax.jit(jax_forced_align, static_argnames="blank_id")
C = 12
BLANK = C - 1


def _log_probs(rng, b, t, scale=3.0):
    logits = scale * rng.standard_normal((b, t, C)).astype(np.float32)
    return np.asarray(torch.log_softmax(torch.from_numpy(logits), -1))


def _labels(rng, lengths, u, repeat_rows=()):
    labels = np.zeros((len(lengths), u), np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(0, BLANK, n)
        if i in repeat_rows:
            labels[i, :n] = 4
    return labels


def _case(name):
    """(log_probs, input_lengths, labels, label_lengths) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ragged":
        lab_len = [8, 5, 3, 7, 2]
        inp = [30, 22, 9, 30, 17]
        labels = _labels(rng, lab_len, 8)
    elif name == "label_length_1":
        lab_len = [1, 1, 1]
        inp = [12, 1, 5]
        labels = _labels(rng, lab_len, 1)
    elif name == "minimal_feasible_t":
        # T = L without repeats; T = L + repeats with them (a blank between)
        labels = np.array([[1, 2, 3, 4, 5, 6], [3, 3, 5, 5, 5, 2],
                           [7, 7, 7, 7, 0, 0]], np.int32)
        lab_len = [6, 6, 4]
        inp = [6, 9, 7]
    elif name == "repeated_labels":
        lab_len = [6, 4, 9, 3]
        inp = [25, 25, 25, 14]
        labels = _labels(rng, lab_len, 9, repeat_rows=(0, 2))
        labels[1, :4] = [2, 2, 3, 3]
    elif name == "infeasible_row":
        # a label repeated 6 times needs 11 frames; this row has 8
        lab_len = [6, 3]
        inp = [8, 20]
        labels = _labels(rng, lab_len, 6, repeat_rows=(0,))
    else:
        raise ValueError(name)
    b = len(lab_len)
    t = max(inp)
    return (_log_probs(rng, b, t), np.asarray(inp, np.int32), labels,
            np.asarray(lab_len, np.int32))


def _both(lp, inp, labels, lab_len):
    ref = JAX_FORCED_ALIGN(jnp.asarray(lp), jnp.asarray(inp), jnp.asarray(labels),
                           jnp.asarray(lab_len), blank_id=BLANK)
    ours = ctc_forced_align(torch.from_numpy(lp), torch.from_numpy(inp),
                            torch.from_numpy(labels), torch.from_numpy(lab_len),
                            blank_id=BLANK)
    return ref, ours


def _assert_same(ref, ours):
    for name in ("frame_tokens", "durations", "onsets"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(ours.scores.numpy(), np.asarray(ref.scores),
                               rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("name", ["ragged", "label_length_1", "minimal_feasible_t",
                                  "repeated_labels", "infeasible_row"])
def test_forced_align_matches_jax(name):
    ref, ours = _both(*_case(name))
    _assert_same(ref, ours)
    assert ours.frame_tokens.dtype == torch.int32
    assert ours.durations.dtype == torch.int32
    assert ours.onsets.dtype == torch.bool


def test_forced_align_k2_inner_tokens_match_jax():
    """The ``align --method k2`` variant: pads stripped from the labels,
    label lengths text_len - 2 (at least 1)."""
    rng = np.random.default_rng(5)
    text_len = np.array([10, 3, 7, 12], np.int32)
    text = np.zeros((4, 12), np.int32)
    for i, n in enumerate(text_len):
        text[i, 1:n - 1] = rng.integers(0, BLANK, n - 2)
    inner = np.concatenate([text[:, 1:], np.zeros_like(text[:, :1])], axis=1)
    inner_len = np.maximum(text_len - 2, 1)
    lp = _log_probs(rng, 4, 40)
    ref, ours = _both(lp, np.full((4,), 40, np.int32), inner, inner_len)
    _assert_same(ref, ours)


def test_durations_cover_the_valid_frames():
    lp, inp, labels, lab_len = _case("ragged")
    res = ctc_forced_align(torch.from_numpy(lp), torch.from_numpy(inp),
                           torch.from_numpy(labels), torch.from_numpy(lab_len), BLANK)
    np.testing.assert_array_equal(res.durations.sum(1).numpy(), inp)
    for k, n in enumerate(lab_len):
        # one onset per token, in order, on a feasible row
        assert int(res.onsets[k].sum()) == n
        tokens = res.frame_tokens[k, : inp[k]].numpy()
        assert (np.diff(tokens) >= 0).all() and tokens.max() == n - 1


def _attribution_cases():
    rng = np.random.default_rng(11)
    cases = []
    for total in (20, 37, 60):
        onsets = rng.random(total) < 0.2
        onsets[-5:] = False
        cases.append((onsets, rng.random(total) < 0.4, total))
    cases.append((np.zeros(30, bool), np.ones(30, bool), 30))  # no onset
    one = np.zeros(25, bool)
    one[7] = True
    cases.append((one, np.zeros(25, bool), 25))  # one onset, tail never silent
    last = np.zeros(18, bool)
    last[[2, 5, 17]] = True
    cases.append((last, np.ones(18, bool), 18))  # silence at the last onset
    trimmed = np.zeros(40, bool)
    trimmed[[3, 9, 30, 35]] = True
    cases.append((trimmed, rng.random(40) < 0.5, 32))  # total < len(onsets)
    return cases


@pytest.mark.parametrize("case", range(7))
def test_k2_pad_attribution_matches_jax(case):
    onsets, arg_blank, total = _attribution_cases()[case]
    ours = k2_pad_attribution(onsets, arg_blank, total)
    ref = jax_k2(onsets, arg_blank, total)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
