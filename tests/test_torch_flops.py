"""The port's analytic FLOP count (``stylish_tts_torch/utils/flops.py``)
against the JAX package's ``count_fn``.

* Every golden case of tests/test_flops.py, written in PyTorch, counts
  exactly what the JAX count gives: a matmul, a batched einsum, a 2-D conv,
  a depthwise conv (per group), a transposed conv at its real taps (JAX's
  lhs-dilated form), a scan (its body times the length: a Python loop
  here), a switch (the mean over its branches: ``count_mean``), the
  gradient through a checkpointed block (its recompute counted). A while
  loop runs eagerly its real trip count, so the port's count is exact where
  JAX's is the body once, marked a lower bound: the port's equals JAX's
  body count times the trips.
* The acoustic G + D step at ``small_model_config()`` (B = 2, 40 frames,
  float32, the sampled MRD as the mean of the three ``forced_disc_index``
  runs) against JAX's count of ``make_acoustic_step`` (the ``lax.switch``
  mean), within 10 % (measured: the port +6.1 % in all, its convolutions
  +7.6 % and matmuls -11.9 %): the two steps run the same modules but
  write some of their work in other ops (framed-DFT STFTs and the iSTFT's
  overlap-add as convolutions or matmuls, their padding, the backward's
  transposes), so the total agrees more closely than its two parts.
  Sampling one MRD counts less than running all three.
"""

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stylish_tts_tpu.config import Config as JaxConfig
from stylish_tts_tpu.models import build_model as jax_build_model
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.state import create_train_state as jax_state
from stylish_tts_tpu.trainer.steps import Batch as JaxBatch
from stylish_tts_tpu.trainer.steps import StepContext as JaxContext
from stylish_tts_tpu.trainer.steps import make_acoustic_step as jax_acoustic_step
from stylish_tts_tpu.utils.flops import count_fn as jax_count
from stylish_tts_torch.models import build_models
from stylish_tts_torch.trainer.normalization import NormalizationStats
from stylish_tts_torch.trainer.state import create_stage_train_state
from stylish_tts_torch.trainer.steps import Batch, StepContext, make_acoustic_step
from stylish_tts_torch.utils.flops import count_fn, count_mean
from test_torch_synth_common import port_config
from test_train_steps import small_model_config

Z = jnp.zeros


def _scan(a, xs):
    out, _ = lax.scan(lambda c, x: (c @ x, None), a, xs)
    return out


def _torch_scan(a, xs):
    for x in xs:
        a = a @ x
    return a


GOLDEN = {
    "dot": ((lambda a, b: a @ b, Z((8, 64)), Z((64, 32))),
            (lambda a, b: a @ b, torch.zeros(8, 64), torch.zeros(64, 32))),
    "batched_dot": ((lambda a, b: jnp.einsum("bij,bjk->bik", a, b), Z((4, 8, 16)),
                     Z((4, 16, 32))),
                    (lambda a, b: torch.einsum("bij,bjk->bik", a, b), torch.zeros(4, 8, 16),
                     torch.zeros(4, 16, 32))),
    "conv": ((lambda x, k: lax.conv_general_dilated(x, k, (1, 1), "SAME"),
              Z((1, 3, 16, 16)), Z((8, 3, 3, 3))),
             (lambda x, k: F.conv2d(x, k, padding=1), torch.zeros(1, 3, 16, 16),
              torch.zeros(8, 3, 3, 3))),
    "grouped_conv": ((lambda x, k: lax.conv_general_dilated(x, k, (1,), "SAME",
                                                            feature_group_count=4),
                      Z((2, 4, 10)), Z((4, 1, 3))),
                     (lambda x, k: F.conv1d(x, k, padding=1, groups=4), torch.zeros(2, 4, 10),
                      torch.zeros(4, 1, 3))),
    # out (1, 3, 22) on both sides: 29 dilated samples less 8 taps plus 1;
    # the transposed conv's padding crops 7 of its 36 samples at each end
    "lhs_dilated_conv": ((lambda x, k: lax.conv_general_dilated(x, k, (1,), [(0, 0)],
                                                                lhs_dilation=(4,)),
                          Z((1, 2, 8)), Z((3, 2, 8))),
                         (lambda x, w: F.conv_transpose1d(x, w, stride=4, padding=7),
                          torch.zeros(1, 2, 8), torch.zeros(2, 3, 8))),
    "scan": ((_scan, Z((8, 8)), Z((5, 8, 8))),
             (_torch_scan, torch.zeros(8, 8), torch.zeros(5, 8, 8))),
}


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_case_counts_what_jax_counts(case):
    (jfn, *jargs), (tfn, *targs) = GOLDEN[case]
    ref, ours = jax_count(jfn, *jargs), count_fn(tfn, *targs)
    assert (ours.matmul, ours.conv) == (ref.matmul, ref.conv) and ours.total > 0
    assert not ours.lower_bound and not ref.lower_bound


def test_switch_is_the_mean_of_its_branches():
    def jsw(i, a):
        return lax.switch(i, [lambda a: (a @ a).sum(), lambda a: ((a @ a) @ a).sum(),
                              lambda a: a.sum()], a)

    ref = jax_count(jsw, jnp.int32(0), Z((8, 8)))
    ours = count_mean([lambda a: (a @ a).sum(), lambda a: ((a @ a) @ a).sum(),
                       lambda a: a.sum()], torch.zeros(8, 8))
    assert ours.matmul == ref.matmul == (1024 + 2048) / 3
    assert any("branches differ" in n for n in ours.notes)


def test_while_counts_its_real_trips_where_jax_gives_a_lower_bound():
    def jf(a):
        return lax.while_loop(lambda s: s[0] < 5, lambda s: (s[0] + 1, s[1] @ s[1]), (0, a))[1]

    def tf(a):
        i = 0
        while i < 5:
            a, i = a @ a, i + 1
        return a

    ref, ours = jax_count(jf, Z((8, 8))), count_fn(tf, torch.zeros(8, 8))
    assert ref.lower_bound and not ours.lower_bound
    assert ours.matmul == 5 * ref.matmul == 5 * 1024


def test_gradient_through_a_checkpoint_counts_the_recompute():
    def jg(w, x):
        h = jax.checkpoint(lambda w, x: jnp.tanh(w @ x))(w, x)
        return (h @ h).sum()

    def tg(w, x):
        h = torch.utils.checkpoint.checkpoint(lambda w, x: torch.tanh(w @ x), w, x,
                                              use_reentrant=False)
        return (h @ h).sum()

    w = torch.zeros(8, 8, requires_grad=True)
    fwd = count_fn(tg, w, torch.zeros(8, 8))
    bwd = count_fn(lambda w, x: tg(w, x).backward(), w, torch.zeros(8, 8))
    ref = jax_count(jax.grad(jg), Z((8, 8)), Z((8, 8)))
    assert bwd.matmul == ref.matmul > fwd.matmul == jax_count(jg, Z((8, 8)), Z((8, 8))).matmul


MC = small_model_config()
B, L, FRAMES = 2, 10, 40


def _batch():
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((B, FRAMES * MC.hop_length)) * 0.1).astype(np.float32)
    text = rng.integers(1, 170, (B, L)).astype(np.int32)
    durs = np.full((B, L), FRAMES // L, np.int32)
    return (audio, text, np.full((B,), L, np.int32), np.full((B, FRAMES), 120.0, np.float32),
            durs)


def _jax_count(sampled: bool):
    models = jax_build_model(MC)
    texts, lengths = jnp.ones((1, L), jnp.int32), jnp.full((1,), L, jnp.int32)
    align, curve = jnp.ones((1, L, FRAMES)) / L, jnp.full((1, FRAMES), 100.0)
    key = jax.random.PRNGKey(0)
    inits = {
        "speech_predictor": lambda: models["speech_predictor"].init(
            {"params": key}, texts, lengths, align, curve, curve, curve,
            jnp.zeros((1, MC.style_dim)), curve, rng=key),
        "speech_style_encoder": lambda: models["speech_style_encoder"].init(
            key, jnp.zeros((1, MC.style_encoder.n_mels, FRAMES))),
        "disc": lambda: models["disc"].init(key, jnp.zeros((1, FRAMES * MC.hop_length))),
        **{f"mrd{i}": lambda: models["mrd0"].init(key, jnp.zeros((1, 1, 64, 16)))
           for i in range(3)},
    }
    params = {n: jax.eval_shape(f) for n, f in inits.items()}
    state = jax.eval_shape(lambda p: jax_state(p, MC.text_encoder.tokens + 1), params)
    ctx = JaxContext(models, MC, JaxConfig().loss_weight.model_dump(), JaxNorm(),
                     stage_steps=100, base_lr=1e-4, sampled_mrd_only=sampled)
    return jax_count(jax_acoustic_step(ctx), state, JaxBatch(*map(jnp.asarray, _batch())))


def _port_count(sampled: bool):
    mc = port_config(MC)
    torch.manual_seed(0)
    state = create_stage_train_state(build_models(mc), "cpu", "acoustic")
    batch = Batch(*map(torch.from_numpy, _batch()))
    weights = JaxConfig().loss_weight.model_dump()
    steps = [make_acoustic_step(StepContext(mc, weights, NormalizationStats(), stage_steps=100,
                                            sampled_mrd_only=sampled, forced_disc_index=i))
             for i in range(3)]
    if not sampled:  # every MRD runs: no branch
        return count_fn(steps[0], state, batch)
    return count_mean(steps, state, batch)


def test_acoustic_step_count_is_jax_s_within_its_stated_tolerance():
    ref, ours = _jax_count(True), _port_count(True)
    assert not ours.lower_bound and ours.conv > 0 and ours.matmul > 0
    assert ours.total == pytest.approx(ref.total, rel=0.1), (ours, ref)
    assert ours.total < _port_count(False).total
