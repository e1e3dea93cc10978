"""The port's WavLM (``models/slm.py``) against the JAX package's encoder.

The port's seeded random WavLM gives its ``state_dict`` (``transformers``'
key names) to the JAX ``convert_torch_wavlm``; both encode the same 0.5 s
of 16 kHz audio (numpy, seeded), the JAX side eagerly:

* the 13 hidden states: 1e-4 of each state's largest magnitude;
* ``resample_24k_to_16k``: 1e-6 absolute;
* ``wavlm_loss`` (24 kHz audio) rtol 1e-4, and its gradient with respect
  to the predicted audio (the target side detached, the weights frozen):
  1e-3 of the gradient's largest magnitude (the JAX side jitted);
* ``wavlm_loss_cached`` on ``wavlm_embed``'s states equals ``wavlm_loss``
  (rtol 1e-5).

The loader reads a local Hugging Face directory without ``transformers``
(``model.safetensors``; ``pytorch_model.bin`` with a ``wavlm.`` prefix and
the old ``weight_g``/``weight_v`` names), and without weights raises unless
``allow_random_fallback``. Where ``transformers`` imports, the port's keys
and shapes are those of a ``WavLMModel`` and its outputs those of a random
one (1e-2 of the mean magnitude: ``transformers`` uses epsilon 1e-5 where
the JAX module, and so the port, use 1e-6; the JAX package's own test holds
its encoder to the same bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.models import slm as jslm
from stylish_tts_torch.models import slm as pslm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_model():
    return pslm.random_wavlm(0).eval().requires_grad_(False)


@pytest.fixture(scope="module")
def jax_params(port_model):
    return jslm.convert_torch_wavlm(
        {k: v.numpy() for k, v in port_model.state_dict().items()})


def _audio(n, seed, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal((1, n))).astype(np.float32)


def test_hidden_states_match_jax(port_model, jax_params):
    audio = _audio(8000, 0)
    ref = jslm.WavLMEncoder().apply(jax_params, jnp.asarray(audio))
    with torch.no_grad():
        ours = port_model(torch.from_numpy(audio))
    assert len(ours) == len(ref) == 13
    for i, (a, b) in enumerate(zip(ours, ref)):
        b = np.asarray(b)
        assert a.shape == b.shape
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err < 1e-4, (i, err)


def test_resampler_matches_jax():
    audio = _audio(7203, 1, 0.3)
    ref = np.asarray(jslm.resample_24k_to_16k(jnp.asarray(audio)))
    ours = pslm.resample_24k_to_16k(torch.from_numpy(audio)).numpy()
    assert ours.shape == ref.shape == (1, 4802)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_wavlm_loss_and_gradient_match_jax(port_model, jax_params):
    target, pred = _audio(12000, 2), _audio(12000, 3)
    loss_j, grad_j = jax.jit(jax.value_and_grad(jslm.wavlm_loss, argnums=2))(
        jax_params, jnp.asarray(target), jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = pslm.wavlm_loss(port_model, torch.from_numpy(target), p)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4)
    grad_j = np.asarray(grad_j)
    assert np.abs(p.grad.numpy() - grad_j).max() < 1e-3 * np.abs(grad_j).max()
    assert all(q.grad is None for q in port_model.parameters())
    with torch.no_grad():
        gt = pslm.wavlm_embed(port_model, torch.from_numpy(target))
        cached = pslm.wavlm_loss_cached(port_model, gt, torch.from_numpy(pred))
    assert gt.shape[1] == 13 and gt.shape[-1] == 768
    np.testing.assert_allclose(float(cached), float(loss.detach()), rtol=1e-5)


def test_loader_reads_a_local_checkpoint_and_guards_the_fallback(port_model, tmp_path):
    from safetensors.torch import save_file

    sd = port_model.state_dict()
    st_dir = tmp_path / "st"
    st_dir.mkdir()
    save_file({k: v.contiguous() for k, v in sd.items()}, str(st_dir / "model.safetensors"))
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    old = {"wavlm." + k.replace("parametrizations.weight.original0", "weight_g")
           .replace("parametrizations.weight.original1", "weight_v"): v for k, v in sd.items()}
    torch.save(old, str(bin_dir / "pytorch_model.bin"))
    for d in (st_dir, bin_dir):
        m = pslm.load_wavlm(str(d), device="cpu")
        assert not m.training and not any(q.requires_grad for q in m.parameters())
        for k, v in m.state_dict().items():
            assert torch.equal(v, sd[k]), (d, k)
    missing = str(tmp_path / "nonexistent-model")
    with pytest.raises(RuntimeError, match="allow_random_fallback"):
        pslm.load_wavlm(missing, device="cpu")
    fallback = pslm.load_wavlm(missing, allow_random_fallback=True, device="cpu")
    for k, v in fallback.state_dict().items():
        assert torch.equal(v, sd[k]), k  # the seeded init


def test_keys_and_outputs_match_transformers(port_model):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.WavLMModel(transformers.WavLMConfig()).eval()
    hf_sd = hf.state_dict()
    ours = port_model.state_dict()
    assert {k: tuple(v.shape) for k, v in hf_sd.items()} == \
        {k: tuple(v.shape) for k, v in ours.items()}
    m = pslm.WavLMEncoder().eval()
    m.load_state_dict(hf_sd)
    audio = torch.from_numpy(_audio(8000, 4))
    with torch.no_grad():
        ref = hf(input_values=audio, output_hidden_states=True).hidden_states
        got = m(audio)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape
        assert (a - b).abs().max() / (b.abs().mean() + 1e-6) < 1e-2, i


def test_load_wavlm_defaults_to_cuda():
    """Called as the JAX loader is (no device), the port's asks for CUDA and
    raises where there is none, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pslm.load_wavlm("nonexistent-model", allow_random_fallback=True)
