"""The CUDA CTC kernels (``stylish_tts_torch/ops/ctc_cuda.py``) on a card.

Every test here needs a CUDA card and ``nvcc`` and skips without one. The
file imports nothing of JAX, so it runs on a GPU machine that has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ctc_cuda.py -q

Tolerances: the kernels carry the trellis as float-float pairs and
normalise gamma per frame (see csrc/ctc.cu), so they are held against the
plain version evaluated in float64 on the same float32 inputs: loss rtol
1e-5, gradient atol 1e-5 (the shared atomics change the order of the
class sums); alpha and beta, rebuilt from the stored float32 residuals and
their offsets, rtol 1e-6 and atol 1e-4 on the reachable live states.

Label lengths 15, 16, 31, 32 (and 287, 288, 511, 512 where each thread
owns two states) put the final states 2L and 2L-1 across a warp boundary,
where a missing barrier between the trellis row's fill and its first step
would let one warp overwrite another's final row. Rows that no alignment
fits (a repeated label with too few frames) get a zero gradient.
"""

import numpy as np
import pytest
import torch

from stylish_tts_torch.ops import ctc as plain
from stylish_tts_torch.ops import ctc_cuda

PRIOR_SCALE = 0.3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the GPU machine")
    return torch.device("cuda")


def _case(dev, b, t, c, u, label_lengths, input_lengths, seed,
          repeat_rows=()):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, c)).astype(np.float32) * 2
    labels = rng.integers(0, c - 1, (b, u)).astype(np.int32)
    labels[list(repeat_rows)] = 5  # needs input_len >= 2L-1 to fit
    for i, n in enumerate(label_lengths):
        labels[i, n:] = 0
    priors = np.linspace(-8, -2, c).astype(np.float32)
    to = lambda x: torch.from_numpy(np.asarray(x)).to(dev)
    return (to(logits), to(np.asarray(input_lengths, np.int32)), to(labels),
            to(np.asarray(label_lengths, np.int32)), c - 1, to(priors))


MAIN_LABEL_LENGTHS = np.random.default_rng(11).integers(130, 161, 69).tolist()

# final states across a warp boundary, one state per thread (S = 65; the
# last row is a repeated label in 8 frames, which no alignment fits) and
# two (S = 1025)
WARP_EDGE_CASES = [
    (5, 40, 32, [15, 16, 31, 32, 6], [40, 40, 40, 40, 8], (4,)),
    (6, 1100, 512, [15, 16, 287, 288, 511, 512], [1100] * 6, ()),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,u,label_lengths,input_lengths,repeat_rows", [
    (4, 60, 20, [0, 1, 20, 9], [60, 41, 60, 30], ()),
    (2, 1100, 512, [512, 300], [1100, 900], ()),  # S = 1025
    (69, 440, 160, MAIN_LABEL_LENGTHS, [440] * 69, ()),  # the main path's shape
    *WARP_EDGE_CASES,
])
def test_kernels_match_plain_in_float64(dev, b, t, u, label_lengths,
                                        input_lengths, repeat_rows):
    logits, il, labels, ll, blank, priors = _case(
        dev, b, t, 179, u, label_lengths, input_lengths, seed=8,
        repeat_rows=repeat_rows)
    z = logits.clone().requires_grad_(True)
    k_loss = ctc_cuda.ctc_loss_with_priors_cuda(
        torch.log_softmax(z, -1), il, labels, ll, blank, log_priors=priors,
        prior_scale=PRIOR_SCALE, reduction="none")
    k_loss.sum().backward()
    z64 = logits.clone().requires_grad_(True)
    lp64 = torch.log_softmax(z64, -1).double() - PRIOR_SCALE * priors.double()
    p_loss = plain.ctc_nll(lp64, il, labels, ll, blank)
    p_loss.sum().backward()
    np.testing.assert_allclose(k_loss.detach().cpu().numpy(),
                               p_loss.detach().cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(z.grad.cpu().numpy(), z64.grad.cpu().numpy(),
                               atol=1e-5)
    for r in repeat_rows:
        assert not z.grad[r].any()


@pytest.mark.gpu
def test_each_launch_counts_once(dev):
    logits, il, labels, ll, blank, _ = _case(
        dev, 3, 30, 179, 8, [8, 5, 0], [30, 22, 9], seed=9)
    before = dict(ctc_cuda.LAUNCHES)
    z = logits.clone().requires_grad_(True)
    ctc_cuda.ctc_nll_cuda(torch.log_softmax(z, -1), il, labels, ll,
                          blank).sum().backward()
    torch.cuda.synchronize()
    assert ctc_cuda.LAUNCHES["alpha_beta"] == before["alpha_beta"] + 1
    assert ctc_cuda.LAUNCHES["grad"] == before["grad"] + 1


@pytest.mark.gpu
def test_no_grad_forward_walks_alpha_alone(dev):
    logits, il, labels, ll, blank, _ = _case(
        dev, 3, 30, 179, 8, [8, 5, 0], [30, 22, 9], seed=9)
    lp = torch.log_softmax(logits, -1)
    with_grad = ctc_cuda.ctc_nll_cuda(lp.clone().requires_grad_(True), il,
                                      labels, ll, blank)
    before = dict(ctc_cuda.LAUNCHES)
    with torch.no_grad():
        no_grad = ctc_cuda.ctc_nll_cuda(lp, il, labels, ll, blank)
    assert ctc_cuda.LAUNCHES == {**before, "alpha_beta": before["alpha_beta"] + 1}
    np.testing.assert_array_equal(no_grad.cpu().numpy(),
                                  with_grad.detach().cpu().numpy())
    _, _, _, ll_only = ctc_cuda.ctc_alpha_beta(lp, il, labels, ll, blank,
                                               store=False)
    assert torch.equal(-ll_only.float(), no_grad)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,u,label_lengths,input_lengths,repeat_rows", [
    (4, 60, 20, [0, 1, 20, 9], [60, 41, 60, 30], ()),
    *WARP_EDGE_CASES,
])
def test_alpha_beta_match_the_plain_trellis(dev, b, t, u, label_lengths,
                                            input_lengths, repeat_rows):
    logits, il, labels, ll, blank, _ = _case(
        dev, b, t, 179, u, label_lengths, input_lengths, seed=12,
        repeat_rows=repeat_rows)
    lp = torch.log_softmax(logits, -1)
    alpha, beta, offsets, k_ll = ctc_cuda.ctc_alpha_beta(lp, il, labels, ll,
                                                         blank)
    k_alpha, k_beta = ctc_cuda.trellis(alpha, beta, offsets, il, ll)
    p_alpha, p_beta, p_ll = plain.ctc_alphas_betas(lp.double(), il, labels, ll,
                                                   blank)
    np.testing.assert_allclose(k_ll.cpu().numpy(), p_ll.cpu().numpy(), rtol=1e-7)
    for ours, ref in ((k_alpha, p_alpha), (k_beta, p_beta)):
        live = ~torch.isnan(ours)
        reach = live & (ref > plain.NEG / 10)
        np.testing.assert_allclose(ours[reach].cpu().numpy(),
                                   ref[reach].cpu().numpy(), rtol=1e-6, atol=1e-4)
        assert (ours[live & ~reach] <= plain.NEG / 10).all()


@pytest.mark.gpu
def test_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    logits, il, labels, ll, blank, _ = _case(
        dev, 2, 20, 179, 4, [4, 2], [20, 15], seed=10)
    lp = torch.log_softmax(logits, -1)
    before = dict(ctc_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        ctc_cuda.ctc_nll_cuda(lp.double(), il, labels, ll, blank)
    with pytest.raises(ValueError, match="contiguous"):
        ctc_cuda.ctc_nll_cuda(lp.transpose(0, 1).contiguous().transpose(0, 1),
                              il, labels, ll, blank)
    with pytest.raises(ValueError, match="int32"):
        ctc_cuda.ctc_nll_cuda(lp, il.long(), labels, ll, blank)
    with pytest.raises(ValueError, match="contiguous on"):
        ctc_cuda.ctc_nll_cuda(lp, il.cpu(), labels, ll, blank)
    long_labels = torch.zeros((2, 513), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="S = 2U\\+1"):
        ctc_cuda.ctc_nll_cuda(lp, il, long_labels, ll, blank)
    with pytest.raises(ValueError, match="blank_id"):
        ctc_cuda.ctc_nll_cuda(lp, il, labels, ll, 179)
    assert ctc_cuda.LAUNCHES == before
