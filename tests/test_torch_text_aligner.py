"""The port's TextAligner against the JAX package's, weights moved across
with ``convert/from_jax.py``. Tolerance: log-probs atol 1e-5 (float32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stylish_tts_tpu.models.text_aligner import TextAligner as JaxAligner
from stylish_tts_torch.convert.from_jax import (
    flatten,
    text_aligner_from_jax,
    text_aligner_to_jax_flat,
)
from stylish_tts_torch.models.text_aligner import TextAligner

ATOL = 1e-5


def _jax_params(mode, hidden=48, seed=0):
    model = JaxAligner(hidden_dim=hidden, dropout=0.0, norm_mode=mode)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 80)),
                        jnp.full((1,), 16, jnp.int32))
    params = jax.tree.map(np.asarray, params)
    if mode == "affine":
        # give the frozen per-channel scale/bias values that show a mix-up
        rng = np.random.default_rng(seed)
        inner = params["params"]
        for i in range(3):
            inner[f"tdnn_norm_{i}"]["scale"] = rng.uniform(
                0.5, 1.5, hidden).astype(np.float32)
            inner[f"tdnn_norm_{i}"]["bias"] = rng.normal(
                0, 0.2, hidden).astype(np.float32)
    return model, params


@pytest.mark.parametrize("mode", ["group", "affine"])
def test_forward_matches_jax(mode):
    model, params = _jax_params(mode)
    port = TextAligner(hidden_dim=48, dropout=0.0, norm_mode=mode)
    port.load_state_dict(text_aligner_from_jax(params))
    port.eval()

    rng = np.random.default_rng(1)
    mel = rng.standard_normal((3, 37, 80)).astype(np.float32)
    lengths = np.array([37, 30, 12], np.int32)
    ref = np.asarray(model.apply(params, jnp.asarray(mel), jnp.asarray(lengths)))
    with torch.no_grad():
        ours = port(torch.from_numpy(mel), torch.from_numpy(lengths)).numpy()
    assert ours.shape == (3, 37, 179)
    np.testing.assert_allclose(ours, ref, atol=ATOL)


@pytest.mark.parametrize("mode", ["group", "affine"])
def test_bridge_round_trip(mode):
    _, params = _jax_params(mode, seed=2)
    back = text_aligner_to_jax_flat(text_aligner_from_jax(params))
    flat = flatten(params)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


def test_dropout_draws_from_the_generator():
    port = TextAligner(hidden_dim=16, dropout=0.5)
    mel = torch.randn(2, 10, 80)
    lengths = torch.tensor([10, 10], dtype=torch.int32)
    port.train()
    a = port(mel, lengths, generator=torch.Generator().manual_seed(3))
    b = port(mel, lengths, generator=torch.Generator().manual_seed(3))
    c = port(mel, lengths, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    port.eval()
    torch.testing.assert_close(port(mel, lengths), port(mel, lengths))
