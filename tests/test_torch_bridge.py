"""The weight bridge on the full-width trees of the three inference
modules.

The flax trees come from ``jax.eval_shape`` of the JAX ``init`` at the
default ``ModelConfig()`` (shapes only, no initialisation): 26.6M
parameters in 958 leaves. Every flax leaf must map to a port tensor of the
transposed shape, none may be left over on either side, and a round trip
flax -> port -> flax gives the same keys and shapes. A missing or an
extra leaf raises.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.models import build_model
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.convert.from_jax import (
    flax_layout, module_from_jax, module_to_jax_flat,
)
from stylish_tts_torch.models import INFERENCE_MODELS, build_inference_models

# (leaves, parameters) of each full-width tree
FULL_WIDTH = {
    "duration_predictor": (193, 4_555_920),
    "pitch_energy_predictor": (271, 9_150_786),
    "speech_predictor": (494, 12_887_796),
}


@pytest.fixture(scope="module")
def trees():
    mc = JaxModelConfig()
    models = build_model(mc)
    L, F = 12, 8
    texts, lengths = jnp.ones((1, L), jnp.int32), jnp.full((1,), L, jnp.int32)
    align = jnp.ones((1, L, F)) / L
    pitch, zeros = jnp.full((1, F), 100.0), jnp.zeros((1, F))
    style = jnp.zeros((1, mc.style_dim))
    inits = {
        "duration_predictor": lambda k: models["duration_predictor"].init(
            k, texts, lengths, style),
        "pitch_energy_predictor": lambda k: models["pitch_energy_predictor"].init(
            k, texts, lengths, align, style),
        "speech_predictor": lambda k: models["speech_predictor"].init(
            {"params": k}, texts, lengths, align, pitch, zeros, jnp.ones((1, F)),
            style, pitch, rng=k),
    }
    shapes = {name: jax.eval_shape(fn, jax.random.PRNGKey(0))
              for name, fn in inits.items()}
    return {name: {k: tuple(v.shape) for k, v in flatten_dict(s, sep="/").items()}
            for name, s in shapes.items()}, build_inference_models(ModelConfig())


@pytest.mark.parametrize("name", INFERENCE_MODELS)
def test_full_width_tree_maps_both_ways(trees, name):
    flax_shapes, models = trees
    want = flax_shapes[name]
    module = models[name]
    assert (len(want), sum(int(np.prod(s)) for s in want.values())) == FULL_WIDTH[name]

    zeros = {k: np.zeros(s, np.float32) for k, s in want.items()}
    sd = module_from_jax(module, zeros)
    assert set(sd) == set(module.state_dict())
    for key, tensor in module.state_dict().items():
        assert tuple(sd[key].shape) == tuple(tensor.shape), key
    assert sum(v.numel() for v in sd.values()) == FULL_WIDTH[name][1]

    back = module_to_jax_flat(module)
    assert {k: v.shape for k, v in back.items()} == want


def test_bridge_raises_on_a_leaf_left_over():
    mc = JaxModelConfig()
    mc.inter_dim, mc.style_dim = 8, 4
    module = build_inference_models(ModelConfig.model_validate(mc.model_dump()))[
        "duration_predictor"]
    flat = module_to_jax_flat(module)
    with pytest.raises(KeyError, match="unmapped"):
        module_from_jax(module, {**flat, "params/extra/kernel": np.zeros((2, 2))})
    flat.pop(next(iter(flat)))
    with pytest.raises(KeyError, match="missing"):
        module_from_jax(module, flat)


def test_values_cross_in_the_layout_rules():
    """One leaf of each kind: conv (K, Cin/g, Cout) -> (Cout, Cin/g, K),
    Dense (in, out) -> (out, in), per-channel (1, 1, C) -> (1, C, 1),
    LayerNorm scale -> weight, embedding -> weight."""
    module = build_inference_models(ModelConfig())["speech_predictor"]
    layout = flax_layout(module)
    by_path = {path: (key, kind) for key, (path, kind) in layout.items()}
    cases = {
        "generator/basegen/phase_convnext_0/dwconv/Conv_0/kernel": "conv",
        "generator/amp_conformer/block_0/attn/to_q/kernel": "dense",
        "generator/basegen/upblock_0/GRN_0/gamma": "channel",
        "generator/basegen/amp_prior_block/alpha1_2": "channel",
        "text_encoder/encoder/norm1_0/LayerNorm_0/scale": "same",
        "text_encoder/emb/embedding": "same",
        "generator/amp_conformer/block_0/conv/bn/norm/scale": "same",
        "decoder/encode/norm1/StyleFiLM_0/fc/kernel": "dense",
        "generator/amp_conformer/block_0/ff1/Dense_1/bias": "same",
    }
    sd = module.state_dict()
    base = module_to_jax_flat(module)
    for path, kind in cases.items():
        key, got_kind = by_path[path]
        assert got_kind == kind, path
        tensor = sd[key]
        value = np.arange(tensor.numel(), dtype=np.float32)
        if kind == "conv":
            flax = value.reshape(tuple(tensor.shape)[::-1])
            expect = flax.transpose(2, 1, 0)
        elif kind == "dense":
            flax = value.reshape(tuple(tensor.shape)[::-1])
            expect = flax.T
        elif kind == "channel":
            flax = value.reshape(1, 1, -1)
            expect = flax.reshape(1, -1, 1)
        else:
            flax = value.reshape(tuple(tensor.shape))
            expect = flax
        loaded = module_from_jax(module, {**base, f"params/{path}": flax})
        np.testing.assert_array_equal(loaded[key].numpy(), expect)
