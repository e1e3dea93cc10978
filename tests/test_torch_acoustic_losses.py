"""The port's acoustic losses (``losses.py``) and the discriminator EMAs
(``trainer/optim.py``) against the JAX package's, on numpy inputs from a
seed. Tolerances: values rtol 1e-5, gradients 1e-5 of their largest
magnitude (float32 on both sides); the median and the EMA rules exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu import losses as JL
from stylish_tts_tpu.trainer import optim as JO
from stylish_tts_torch import losses as PL
from stylish_tts_torch.trainer import optim as PO

RTOL = 1e-5


def _r(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _grad_port(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    out.backward()
    # a detached (target) input has no gradient: zeros, as jax.grad gives
    return float(out.detach()), [np.zeros_like(a) if t.grad is None else t.grad.numpy()
                        for a, t in zip(arrays, ts)]


def _grad_jax(fn, *arrays):
    out, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    return float(out), [np.asarray(g) for g in grads]


def _scores(seed, heads=5):
    return ([_r((2, 40 + 7 * i), seed + i) for i in range(heads)],
            [_r((2, 40 + 7 * i), seed + 50 + i) + 0.3 for i in range(heads)])


LOSSES = {
    "spectral_convergence": (
        lambda t, p: PL.spectral_convergence_loss([t, t * 0.5], [p, p * 0.7]),
        lambda t, p: JL.spectral_convergence_loss([t, t * 0.5], [p, p * 0.7]),
        lambda: (np.abs(_r((2, 1, 16, 9), 1)), np.abs(_r((2, 1, 16, 9), 2)))),
    "multi_phase": (
        lambda p, t: PL.multi_phase_loss([p, p[:, :9]], [t, t[:, :9]]),
        lambda p, t: JL.multi_phase_loss([p, p[:, :9]], [t, t[:, :9]]),
        lambda: (_r((2, 17, 11), 3, 3.0), _r((2, 17, 11), 4, 3.0))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_spectral_losses_and_gradients_match_jax(name):
    port_fn, jax_fn, inputs = LOSSES[name]
    arrays = inputs()
    v_p, g_p = _grad_port(port_fn, *arrays)
    v_j, g_j = _grad_jax(jax_fn, *arrays)
    np.testing.assert_allclose(v_p, v_j, rtol=RTOL)
    # the target side carries no gradient on either side
    for a, b in zip(g_p, g_j):
        np.testing.assert_allclose(a, b, atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_median_is_the_lower_middle_of_an_even_sized_input():
    x = np.array([4.0, 1.0, 3.0, 2.0, 8.0, 6.0], np.float32)  # middles 3 and 4
    assert float(PL._median_lower(torch.from_numpy(x))) == 3.0
    assert float(JL._median_lower(jnp.asarray(x))) == 3.0
    y = _r((4, 10), 5)
    assert float(PL._median_lower(torch.from_numpy(y))) == float(JL._median_lower(jnp.asarray(y)))


@pytest.mark.parametrize("side", ["discriminator", "generator"])
def test_pair_losses_match_jax(side):
    real, fake = _scores(10)
    n = len(real)
    if side == "discriminator":
        def port_fn(*a):
            loss, raw = PL.discriminator_pair_loss(list(a[:n]), list(a[n:]))
            return loss + 0.5 * raw

        def jax_fn(*a):
            loss, raw = JL.discriminator_pair_loss(list(a[:n]), list(a[n:]))
            return loss + 0.5 * raw
    else:
        def port_fn(*a):
            return PL.generator_pair_loss(list(a[:n]), list(a[n:]))

        def jax_fn(*a):
            return JL.generator_pair_loss(list(a[:n]), list(a[n:]))
    v_p, g_p = _grad_port(port_fn, *real, *fake)
    v_j, g_j = _grad_jax(jax_fn, *real, *fake)
    np.testing.assert_allclose(v_p, v_j, rtol=RTOL)
    for a, b in zip(g_p, g_j):
        np.testing.assert_allclose(a, b, atol=1e-5 * max(np.abs(b).max(), 1e-30))
    # the raw LSGAN term alone
    if side == "discriminator":
        _, raw_p = PL.discriminator_pair_loss([torch.from_numpy(x) for x in real],
                                              [torch.from_numpy(x) for x in fake])
        _, raw_j = JL.discriminator_pair_loss([jnp.asarray(x) for x in real],
                                              [jnp.asarray(x) for x in fake])
        np.testing.assert_allclose(float(raw_p), float(raw_j), rtol=RTOL)


@pytest.mark.parametrize("sub_count", [5.0, 1.0])
def test_disc_lr_multiplier_at_each_band_edge(sub_count):
    ideal, band = 0.5 * sub_count, 0.05 * sub_count
    points = [ideal - 2 * band, ideal - band, ideal - band / 2, ideal, ideal + band / 3,
              ideal + band, ideal + 1.5 * band, np.nextafter(np.float32(ideal + band), 9)]
    for x in np.asarray(points, np.float32):
        p = float(PL.disc_lr_multiplier(torch.tensor(x), sub_count))
        j = float(JL.disc_lr_multiplier(jnp.asarray(x), sub_count))
        np.testing.assert_allclose(p, j, rtol=RTOL, err_msg=str(x))
        assert 0.01 - 1e-7 <= p <= 4.0 + 1e-6
    assert float(PL.disc_lr_multiplier(torch.tensor(ideal + 2 * band), sub_count)) == 4.0
    assert float(PL.disc_lr_multiplier(torch.tensor(ideal - 2 * band), sub_count)) == \
        pytest.approx(0.01)


def test_backwards_loss_and_reporting_total_match_jax():
    """Each term but generator/align_loss enters as w * L / (stop_grad(L) +
    1e-9): its gradient is w / L times dL; the +1e-9 keeps a zero term finite."""
    weights = {"mel": 5.0, "generator": 1.0, "slm": 0.2, "multi_phase": 1.0}
    vals = {"mel": 0.37, "multi_phase": 11.2, "generator": 6.5, "slm": 0.0}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in vals.items()}
    total = PL.backwards_loss(tp, weights)
    total.backward()
    gj = jax.grad(lambda d: JL.backwards_loss(d, weights))(
        {k: jnp.float32(v) for k, v in vals.items()})
    jt = JL.backwards_loss({k: jnp.float32(v) for k, v in vals.items()}, weights)
    np.testing.assert_allclose(float(total), float(jt), rtol=RTOL)
    for k in vals:
        np.testing.assert_allclose(float(tp[k].grad), float(gj[k]), rtol=RTOL, err_msg=k)
    assert float(tp["slm"].grad) == pytest.approx(0.2 / 1e-9, rel=1e-5)
    rp = PL.reporting_total({k: torch.tensor(v) for k, v in vals.items()}, weights)
    rj = JL.reporting_total({k: jnp.float32(v) for k, v in vals.items()}, weights)
    np.testing.assert_allclose(float(rp), float(rj), rtol=RTOL)


def test_disc_ema_rules_match_jax():
    assert PO.DISC_SUB_COUNT == JO.DISC_SUB_COUNT
    init_p, init_j = PO.init_disc_ema(), JO.init_disc_ema()
    assert {k: float(v) for k, v in init_p.items()} == {k: float(v) for k, v in init_j.items()}
    ema_p, ema_j = init_p["mrd0"], init_j["mrd0"]
    for raw in (3.1, 2.2, float("nan"), float("inf"), 2.9):
        ema_p = PO.update_disc_ema(ema_p, torch.tensor(raw))
        ema_j = JO.update_disc_ema(ema_j, jnp.float32(raw))
        assert float(ema_p) == float(ema_j), raw
