"""The duration stage's modules against the JAX package's, at the tiny
config: the duration predictor as the registry builds it, in ``eval()``
against JAX ``training=False`` (1e-4 x max |JAX|, as
tests/test_torch_text_predictors.py); its ``train()``-mode dropout
(``last_dropout`` drops whole channels: one draw per batch row and
channel, shared over time); the duration losses with ragged lengths and
non-uniform class weights, values and gradients (rtol 1e-6); and
``DurationProcessor``'s table lookups at the default and at non-default
``class_count`` / ``max_dur``, exactly.
"""

import jax
import numpy as np
import pytest
import torch

from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.models import build_model as jax_build_model
from stylish_tts_tpu.ops.duration import DurationProcessor as JaxDurationProcessor
from stylish_tts_torch import losses as L
from stylish_tts_torch.models import build_models
from stylish_tts_torch.models.duration_predictor import channel_dropout
from stylish_tts_torch.ops.duration import DurationProcessor
from test_torch_synth_common import (
    j, jax_params, port_config, randn, t, tiny_jax_config, to_port,
)

L_TEXT = 24
LENGTHS = np.array([L_TEXT, L_TEXT - 9], np.int32)


@pytest.fixture(scope="module")
def predictor():
    mc = tiny_jax_config()
    rng = np.random.default_rng(1)
    texts = rng.integers(1, mc.text_encoder.tokens, (2, L_TEXT)).astype(np.int32)
    texts[1, LENGTHS[1]:] = 0
    style = randn((2, mc.style_dim), 2)
    jmod = jax_build_model(mc)["duration_predictor"]
    args = (j(texts), j(LENGTHS), j(style))
    variables = jax_params(lambda k: jmod.init({"params": k}, *args), seed=3)
    ref = np.asarray(jax.jit(lambda v: jmod.apply(v, *args, training=False))(variables))
    port = to_port(build_models(port_config(mc))["duration_predictor"], variables)
    return mc, port, (t(texts).long(), t(LENGTHS).long(), t(style)), ref


def test_duration_predictor_eval_matches_jax(predictor):
    _mc, port, inputs, ref = predictor
    with torch.no_grad():
        ours = port(*inputs, generator=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_last_dropout_drops_whole_channels():
    p = 0.5
    x = torch.randn(6, 64, 50) + 3.0
    y = channel_dropout(x, p, True, torch.Generator().manual_seed(5))
    mask = y / x  # 0 or 1/(1-p)
    first = mask[:, :, :1]
    assert torch.allclose(mask, first.expand_as(mask), rtol=1e-6)  # constant along time
    kept = first != 0
    assert torch.allclose(first[kept], torch.full_like(first[kept], 1 / (1 - p)), rtol=1e-6)
    n = kept.numel()
    rate = float(kept.float().mean())
    assert abs(rate - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / n), rate
    assert kept.any(dim=1).all() and (~kept).any(dim=1).all()  # varies over channels
    assert torch.equal(channel_dropout(x, p, False, None), x)


def test_duration_predictor_train_mode(predictor):
    """Each block's output is dropped by whole channels; the same generator
    seed repeats the output, another seed changes it."""
    mc, port, inputs, _ref = predictor
    seen = []
    hook = port.duration_proj.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    port.train()
    try:
        with torch.no_grad():
            out = [port(*inputs, generator=torch.Generator().manual_seed(s))
                   for s in (7, 7, 8)]
    finally:
        hook.remove()
        port.eval()
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    prosody = seen[0][0, :, : LENGTHS[0]]  # (C, T) of the full-length row
    dropped = (prosody == 0).all(dim=1)
    assert 0 < int(dropped.sum()) < prosody.shape[0]  # whole channels, not all
    assert (prosody[~dropped] != 0).all()


def test_duration_losses_and_gradients_match_jax():
    rng = np.random.default_rng(11)
    b, n, classes = 3, 17, 16
    lengths = np.array([17, 9, 1], np.int32)
    pred = rng.normal(0.0, 2.0, (b, n, classes)).astype(np.float32)
    targets = rng.integers(0, classes, (b, n)).astype(np.int32)
    weights = np.sqrt(rng.uniform(0.1, 4.0, classes)).astype(np.float32)
    dur = rng.uniform(0.0, 12.0, (b, n)).astype(np.float32)
    target_dur = rng.integers(0, 12, (b, n)).astype(np.float32)

    def jax_total(logits, d, td):
        ce = JL.duration_ce_loss(logits, j(targets), j(lengths), j(weights))
        l1 = JL.masked_smooth_l1_per_sequence(d, td, j(lengths))
        return ce + 3.0 * l1, (ce, l1)

    (_, (ref_ce, ref_l1)), ref_grads = jax.value_and_grad(
        jax_total, argnums=(0, 1, 2), has_aux=True)(j(pred), j(dur), j(target_dur))
    logits, d, td = (t(a).requires_grad_(True) for a in (pred, dur, target_dur))
    ce = L.duration_ce_loss(logits, t(targets), t(lengths), t(weights))
    l1 = L.masked_smooth_l1_per_sequence(d, td, t(lengths))
    (ce + 3.0 * l1).backward()
    np.testing.assert_allclose(float(ce.detach()), float(ref_ce), rtol=1e-6)
    np.testing.assert_allclose(float(l1.detach()), float(ref_l1), rtol=1e-6)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(ref_grads[0]), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(ref_grads[1]), rtol=1e-6,
                               atol=1e-9)
    assert td.grad is None and not np.asarray(ref_grads[2]).any()  # stop-gradient
    assert not logits.grad[1, lengths[1]:].any() and not d.grad[2, 1:].any()  # masked


@pytest.mark.parametrize("class_count,max_dur", [(16, 50), (8, 30), (20, 80)])
def test_duration_processor_matches_jax(class_count, max_dur):
    ours = DurationProcessor(class_count, max_dur)
    ref = JaxDurationProcessor(class_count, max_dur)
    classes = np.arange(-2, 24, dtype=np.int32)
    np.testing.assert_array_equal(ours.class_to_dur_hard(t(classes)).numpy(),
                                  np.asarray(ref.class_to_dur_hard(j(classes))))
    durs = np.array([0, 1, 2, 7, 29, 30, 31, 50, 51, 79, 80, 81, 200], np.int32)
    np.testing.assert_array_equal(ours.dur_to_class(t(durs)).numpy(),
                                  np.asarray(ref.dur_to_class(j(durs))))
    fdurs = np.array([0.2, 1.7, 29.99, 50.5, 120.0], np.float32)
    np.testing.assert_array_equal(ours.dur_to_class(t(fdurs)).numpy(),
                                  np.asarray(ref.dur_to_class(j(fdurs))))
    rng = np.random.default_rng(class_count)
    alignment = (rng.uniform(0.0, 1.0, (2, 12, 300)) ** 6).astype(np.float32)
    alignment[0, 3] = 0.0  # a token of no frames
    np.testing.assert_array_equal(ours.align_to_class(t(alignment)).numpy(),
                                  np.asarray(ref.align_to_class(j(alignment))))
    assert ours.dur_to_class(t(durs)).dtype == torch.int32
