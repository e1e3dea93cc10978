"""The port's building blocks against the JAX package's.

Each block gets the same seeded weights (``jax_params``) through the
bridge and the same numpy inputs: x (B, T, C) with an offset
and a spread so that every norm matters, a style vector, and for the
conformer lengths shorter than T. Tolerance: rtol 1e-5 and atol 1e-5
elementwise (float32; the two sides sum convs and matmuls in another
order). The DurationProcessor is held at rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

from stylish_tts_tpu.models import common as jcommon
from stylish_tts_tpu.models import conformer as jconformer
from stylish_tts_tpu.models import convnext as jconvnext
from stylish_tts_tpu.ops.duration import DurationProcessor as JaxDurationProcessor
from stylish_tts_torch.models import common as tcommon
from stylish_tts_torch.models import conformer as tconformer
from stylish_tts_torch.models import convnext as tconvnext
from stylish_tts_torch.ops.duration import DurationProcessor
from test_torch_synth_common import bct, btc, jax_params, j, randn, t, to_port

B, T, C, S = 2, 24, 20, 16
RTOL = ATOL = 1e-5

# name -> (JAX module, port module, call signature)
BLOCKS = {
    "adaptive_layer_norm": (lambda: jcommon.AdaptiveLayerNorm(C),
                            lambda: tcommon.AdaptiveLayerNorm(C, S), "xs"),
    "adaptive_layer_norm_eps1e-6": (lambda: jcommon.AdaptiveLayerNorm(C, eps=1e-6),
                                    lambda: tcommon.AdaptiveLayerNorm(C, S, eps=1e-6),
                                    "xs"),
    "adaptive_instance_norm": (lambda: jcommon.AdaptiveInstanceNorm(C),
                               lambda: tcommon.AdaptiveInstanceNorm(C, S), "xs"),
    "layer_norm_channels": (lambda: jcommon.LayerNormChannels(),
                            lambda: tcommon.LayerNormChannels(C), "x"),
    "grn": (lambda: jcommon.GRN(C), lambda: tcommon.GRN(C), "x"),
    "decoder_block_shortcut": (lambda: jcommon.AdaptiveDecoderBlock(C, 12),
                               lambda: tcommon.AdaptiveDecoderBlock(C, 12, S), "xs"),
    "decoder_block": (lambda: jcommon.AdaptiveDecoderBlock(C, C, kernel_size=5),
                      lambda: tcommon.AdaptiveDecoderBlock(C, C, S, kernel_size=5), "xs"),
    "generator_block": (lambda: jcommon.AdaptiveGeneratorBlock(C, kernel_size=11),
                        lambda: tcommon.AdaptiveGeneratorBlock(C, S, kernel_size=11),
                        "xs"),
    "generator_convnext": (lambda: jconvnext.GeneratorConvNeXtBlock(C, 4 * C),
                           lambda: tconvnext.GeneratorConvNeXtBlock(C, 4 * C, S), "xs"),
    "adaptive_convnext": (lambda: jconvnext.AdaptiveConvNeXtBlock(C, 4 * C),
                          lambda: tconvnext.AdaptiveConvNeXtBlock(C, 4 * C, S), "xs"),
    "conformer": (lambda: jconformer.Conformer(dim=C, depth=1),
                  lambda: tconformer.Conformer(C, 1, S), "xs"),
    "conformer_lengths": (lambda: jconformer.Conformer(dim=C, depth=2),
                          lambda: tconformer.Conformer(C, 2, S), "xsl"),
    "conformer_affine": (lambda: jconformer.Conformer(dim=C, depth=1, norm_mode="affine"),
                         lambda: tconformer.Conformer(C, 1, S, norm_mode="affine"), "xs"),
}


def _inputs(seed):
    x = randn((B, T, C), seed, 2.0) + 0.5
    style = randn((B, S), seed + 1)
    lengths = np.array([T, T - 7], np.int32)
    return x, style, lengths


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    make_jax, make_port, sig = BLOCKS[name]
    x, style, lengths = _inputs(seed=len(name))
    jmod = make_jax()
    args = {"x": (j(x),), "xs": (j(x), j(style)),
            "xsl": (j(x), j(style), j(lengths))}[sig]
    variables = jax_params(lambda k: jmod.init({"params": k}, *args))
    ref = np.asarray(jmod.apply(variables, *args))

    port = to_port(make_port(), variables)
    targs = {"x": (bct(x),), "xs": (bct(x), t(style)),
             "xsl": (bct(x), t(style), t(lengths).long())}[sig]
    with torch.no_grad():
        ours = btc(port(*targs))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_snake_matches_jax():
    x = randn((B, T, C), 3, 3.0)
    alpha = np.abs(randn((1, 1, C), 4)) + 0.2
    ref = np.asarray(jcommon.snake(j(x), j(alpha)))
    ours = btc(tcommon.snake(bct(x), bct(alpha)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_prediction_to_duration_matches_jax():
    pred = randn((B, T, 16), 5, 3.0)
    lengths = np.array([T, T - 9], np.int32)
    ref = np.asarray(JaxDurationProcessor().prediction_to_duration(j(pred), j(lengths)))
    ours = DurationProcessor().prediction_to_duration(t(pred), t(lengths)).numpy()
    assert (ours[1, T - 9:] == 0).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("multiplier", [1, 2])
def test_duration_to_alignment_matches_jax(multiplier):
    """Padded text rows (duration 0) stay in the softmax over tokens, as
    in JAX; the frame count is a bucket larger than the total."""
    rng = np.random.default_rng(6)
    durations = rng.uniform(0.5, 9.0, (B, T)).astype(np.float32)
    durations[1, T - 9:] = 0.0
    frames = 100 * multiplier
    ref = np.asarray(JaxDurationProcessor().duration_to_alignment(
        j(durations), frames, multiplier=multiplier))
    ours = DurationProcessor().duration_to_alignment(
        t(durations), frames, multiplier=multiplier).numpy()
    assert ours.shape == (B, T, frames)
    np.testing.assert_allclose(ours.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
