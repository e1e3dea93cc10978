#!/usr/bin/env python3
"""How rounding in the CTC trellis reaches gamma, simulated on the CPU.

The CUDA forward kernel (``stylish_tts_torch/csrc/ctc.cu``) evaluates the
bounded part of each log-sum-exp, log(e^{a-m} + e^{b-m} + e^{c-m}), with
the float32 MUFU approximations, which are a few ulp off. This script runs
the alpha and beta recursions of ``ops/ctc.py`` (``ctc_alphas_betas``) in
float64 with such errors injected (each exp off by a relative ``ULPS``
float32 ulps, each log by as many absolute ulps, uniformly at random; in a
second pass also leaning by half that, oppositely in alpha and beta), then
compares gamma against the exact float64 gamma in two forms:

- ``exp(alpha + beta - ll)``, as the Pallas glue ``_ctc_bwd`` forms it;
- ``exp(alpha + beta - N_t)`` with N_t = LSE_s(alpha + beta) per frame,
  equal to ll in exact arithmetic, as the CUDA gradient kernel forms it.

Run from the root of the repo (CPU only, a few minutes):

    python3 scripts/ctc_gamma_error_sim.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stylish_tts_torch.ops import ctc  # noqa: E402

ULP = 2.0 ** -23
ULPS = 2.0
SEED = 1


def noisy_lse(xs, bias, gen):
    """log-sum-exp of the stacked terms, the bounded part perturbed."""
    stacked = torch.stack(xs)
    m = stacked.max(0).values
    terms = torch.exp(stacked - m)
    noise = torch.rand(terms.shape, generator=gen, dtype=torch.float64) * 2 - 1
    terms = terms * (1 + (noise + bias) * ULPS * ULP)
    noise = torch.rand(m.shape, generator=gen, dtype=torch.float64) * 2 - 1
    return m + torch.log(terms.sum(0)) + (noise + bias) * ULPS * ULP


def main() -> int:
    for b, t, c, u, lo in ((4, 440, 179, 160, 130), (2, 1100, 179, 512, 400)):
        gen = torch.Generator().manual_seed(SEED)
        logits = torch.randn((b, t, c), generator=gen) * 2
        labels = torch.randint(0, c - 1, (b, u), generator=gen, dtype=torch.int32)
        lengths = torch.randint(lo, u + 1, (b,), generator=gen, dtype=torch.int32)
        for i in range(b):
            labels[i, lengths[i]:] = 0
        lp = torch.log_softmax(logits, -1).double()
        il = torch.full((b,), t, dtype=torch.int32)
        a0, b0, ll0 = ctc.ctc_alphas_betas(lp, il, labels, lengths, c - 1)
        gamma = torch.exp(a0 + b0 - ll0[:, None, None])
        for bias in (0.0, 0.5):
            # alpha's LSEs lean by +bias, beta's by -bias, one noise stream
            noise = torch.Generator().manual_seed(SEED)
            lses = (lambda *xs: noisy_lse(xs, bias, noise),
                    lambda *xs: noisy_lse(xs, -bias, noise))
            a, be, ll = ctc.ctc_alphas_betas(lp, il, labels, lengths, c - 1,
                                             _lses=lses)
            x = a + be
            vs_ll = (torch.exp(x - ll[:, None, None]) - gamma).abs().max()
            vs_nt = (torch.exp(x - torch.logsumexp(x, -1, keepdim=True))
                     - gamma).abs().max()
            print(f"B={b} T={t} U={u}, {ULPS} ulps, bias {bias}: gamma max "
                  f"abs err against ll {float(vs_ll):.2e}, against N_t "
                  f"{float(vs_nt):.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
