"""One textual step with a frozen ringformer speech predictor against the
JAX package's ``make_textual_step``, at the configuration, weights, batch
and tolerances of tests/test_torch_ringformer_step.py. The JAX step's
pitch/energy predictor and speech predictor run with ``training=False``
through the shim of tests/test_torch_textual_step.py (the JAX step
hard-codes ``training=True``); the port's take the ``parity_deterministic``
switch. The frozen ringformer stays bitwise, with no gradient formed.
"""

import torch

from stylish_tts_torch.convert.from_jax import module_from_jax
from test_torch_ringformer_step import check_step, start  # noqa: F401 (fixture)


def test_ringformer_textual_step_matches_jax(start):  # noqa: F811
    state, metrics = check_step("textual", start, ("pe_style_encoder",))
    assert "mag" not in metrics
    params, _prior = start
    for n in ("speech_predictor", "speech_style_encoder"):
        module = state.models[n]
        begin = module_from_jax(module, params[n])
        assert all(torch.equal(w, begin[k]) for k, w in module.state_dict().items()), n
        assert all(p.grad is None for p in module.parameters()), n
