"""The numbers that decide ``correct``, and their limits.

Training: the program's first steps (through the window's own call and
loader) against the reference's on the same rows from the same weights:

* ``first_disc_real_gap``: the scores of each discriminator on the real
  batch in step 1's generator phase (its first call, from the same
  weights and the same audio; float32 in the program), as
  ||program - reference|| / ||reference|| over all its score heads, the
  largest over the discriminators;
* ``first_decoder_gap``: the speech predictor's decoder output in step 1
  (text encoder, style encoder and decoder, under the program's bf16
  autocast), the same relative gap;
* ``median_change_gap``: each leaf's change after the first steps, as the
  gap between the two sides' norms over the reference's norm of that leaf
  or of the median leaf, whichever is larger, read at the median leaf;
  leaves whose reference first gradient is under a thousandth of the
  median leaf's (moved by round-off alone under AdamW) are left out;
* ``first_loss_gap``: the largest relative gap of a loss term of step 1,
  the slm term left out (the program runs WavLM under bf16 autocast).

Synthesis, over a sample of finished lines (a length that differs by
more than one frame counts as infinite):

* ``wave_gap``: the largest |program - reference| over the reference's
  peak;
* ``mel_gap``: the mel spectral convergence of a line's normalised
  waveform against the reference's, sum |M_p - M_r| / sum M_r over the
  frames and mel bins of the mel magnitudes M, the largest over the
  lines.

A cell compares the numbers that ``ttsbench/checks/<cell>.json`` gives a
limit, with the readings that limit was set from; the others are logged
(``PERF.md`` gives each one's readings, and why it is or is not
compared). So are the worst
leaf's gap of the first gradient (as AdamW got it: its first moment over
1 - beta1) and of the change, and the later steps' losses: the losses'
kinks (the TPRLS clamp and median) make them jump with any change of
rounding, the reference's against itself included.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable

import numpy as np
import torch

CHANGE_EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm
NOT_COMPARED_TERMS = ("slm",)  # loss terms of step 1 that are logged only


def _leaves(models, names: Iterable[str]):
    for name in names:
        module = models[name]
        for pname, p in module.named_parameters():
            yield f"{name}.{pname}", p


class FirstCalls:
    """Forward hooks that keep, for each module of ``modules`` (name ->
    module), its output's tensors from its first call, as float32 on the
    host, until ``close``."""

    def __init__(self, modules: dict):
        self.outputs: Dict[str, list] = {}
        self._hooks = [m.register_forward_hook(self._hook(name))
                       for name, m in modules.items()]

    def _hook(self, name):
        def keep(module, args, output):
            if name not in self.outputs:
                self.outputs[name] = [t.detach().float().cpu() for t in _tensors(output)]
        return keep

    def close(self) -> Dict[str, list]:
        for h in self._hooks:
            h.remove()
        self._hooks = []
        return self.outputs


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def output_gap(prog: list, ref: list) -> float:
    """||program - reference|| / ||reference|| over all tensors of one
    module's output; infinite where the shapes differ or the program's
    output is not finite."""
    if prog is None or len(prog) != len(ref) or any(
            p.shape != r.shape for p, r in zip(prog, ref)):
        return math.inf
    p = torch.cat([t.reshape(-1) for t in prog]).double()
    r = torch.cat([t.reshape(-1) for t in ref]).double()
    if not torch.isfinite(p).all():
        return math.inf
    return float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r).clamp_min(1e-30))


def disc_modules(models, stage: str) -> dict:
    """The discriminators whose first call ``first_disc_real_gap`` reads."""
    names = {"acoustic": ("mrd0", "mrd1", "mrd2", "disc"), "textual": ("pitch_disc",)}[stage]
    return {name: models[name] for name in names}


def first_step_modules(models, stage: str) -> dict:
    """The modules whose first call in step 1 is kept (``FirstCalls``)."""
    return {**{f"disc_real.{k}": m for k, m in disc_modules(models, stage).items()},
            "decoder": models["speech_predictor"].decoder}


def leaf_snapshot(models, names) -> Dict[str, torch.Tensor]:
    """A copy of every parameter of the modules ``names``."""
    return {k: p.detach().clone() for k, p in _leaves(models, names)}


def first_grad_norms(state, names) -> Dict[str, float]:
    """Each leaf's gradient norm as AdamW got it at its first update
    (exp_avg / (1 - beta1)), for leaves with optimizer state."""
    out = {}
    for name in names:
        opt = state.optimizers[name]
        beta1 = opt.param_groups[0]["betas"][0]
        for pname, p in state.models[name].named_parameters():
            st = opt.state.get(p)
            if st and "exp_avg" in st:
                out[f"{name}.{pname}"] = float(torch.linalg.vector_norm(
                    st["exp_avg"].float())) / (1.0 - beta1)
    return out


def change_norms(state, names, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm((p.detach() - start[k]).float()))
            for k, p in _leaves(state.models, names)}


def loss_terms(metrics: dict) -> Dict[str, float]:
    return {k: v for k, v in metrics.items() if k != "lr" and not k.endswith("_lr_mult")}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    keys = [k for k in ref if keep is None or k in keep]
    if not keys:
        return {}
    median = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        p = prog.get(k)
        ok = p is not None and math.isfinite(p)
        out[k] = abs(p - ref[k]) / max(ref[k], median, 1e-30) if ok else math.inf
    return out


def _leaf_gap(prog, ref, keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def change_keep(ref: dict) -> set:
    """The leaves whose change is compared: all but those whose reference
    first gradient is under ``CHANGE_EXCLUDE_BELOW`` of the median leaf's."""
    grads = ref["grads"]
    median = statistics.median(grads.values())
    keep = {k for k, g in grads.items() if g >= CHANGE_EXCLUDE_BELOW * median}
    return keep | (set(ref["changes"]) - set(grads))  # no first update: kept


def explain(prog: dict, ref: dict, n: int = 4) -> str:
    """Step 1's loss terms and the worst leaves, for the run's log."""
    first = ", ".join(f"{k} {prog['losses'][0].get(k, math.nan):.6g}/{rv:.6g}"
                      for k, rv in loss_terms(ref["losses"][0]).items())
    parts = [f"step 1 {first}"]
    for name, p, r, keep in (("grad", prog["grads"], ref["grads"], None),
                             ("change", prog["changes"], ref["changes"], change_keep(ref))):
        gaps = leaf_gaps(p, r, keep)
        worst = sorted(gaps, key=gaps.get, reverse=True)[:n]
        parts.append(f"{name} " + ", ".join(
            f"{k} {p.get(k, math.nan):.4g}/{r[k]:.4g} ({gaps[k]:.3g})" for k in worst))
    return "; ".join(parts)


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the program's readings against the reference's (see
    the module's docstring)."""
    first = 0.0
    for k, rv in loss_terms(ref["losses"][0]).items():
        if k in NOT_COMPARED_TERMS:
            continue
        pv = prog["losses"][0].get(k) if prog["losses"] else None
        if pv is None or not math.isfinite(pv):
            first = math.inf
        else:
            first = max(first, abs(pv - rv) / max(abs(rv), 1e-12))
    changes = leaf_gaps(prog["changes"], ref["changes"], change_keep(ref))
    firsts = {k: output_gap(prog["first_calls"].get(k), v)
              for k, v in ref["first_calls"].items()}
    return {"first_disc_real_gap": max(v for k, v in firsts.items()
                                       if k.startswith("disc_real.")),
            "first_decoder_gap": firsts["decoder"],
            "median_change_gap": statistics.median(changes.values()),
            "first_loss_gap": first}


def logged_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers that are logged and not compared: step 1's slm term,
    every step's losses, the worst leaf's first gradient and change."""
    loss = 0.0
    for p, r in zip(prog["losses"], ref["losses"]):
        for k, rv in loss_terms(r).items():
            loss = max(loss, abs(p.get(k, math.inf) - rv) / max(abs(rv), 1e-12))
    first = {k: abs(prog["losses"][0].get(k, math.inf) - rv) / max(abs(rv), 1e-12)
             for k, rv in loss_terms(ref["losses"][0]).items() if k in NOT_COMPARED_TERMS}
    return {**{f"first_{k}_gap": v for k, v in first.items()},
            "loss_gap": loss, "grad_gap": _leaf_gap(prog["grads"], ref["grads"]),
            "change_gap": _leaf_gap(prog["changes"], ref["changes"], change_keep(ref))}


def _same_length(prog: np.ndarray, ref: np.ndarray, hop: int) -> bool:
    return abs(prog.shape[0] - ref.shape[0]) <= hop and bool(np.isfinite(prog).all())


def wave_gap(prog: np.ndarray, ref: np.ndarray, hop: int) -> float:
    """Largest |program - reference| over the reference's peak, on the
    common length; infinite where the lengths differ by more than a frame
    or the program's waveform is not finite."""
    if not _same_length(prog, ref, hop):
        return math.inf
    n = min(prog.shape[0], ref.shape[0])
    peak = float(np.abs(ref).max())
    return float(np.abs(prog[:n].astype(np.float64) - ref[:n]).max()) / max(peak, 1e-12)


def mel_settings(mc) -> dict:
    """The mel settings of a model configuration, for ``log_mel``."""
    return {k: getattr(mc, k) for k in ("n_fft", "hop_length", "win_length", "n_mels",
                                        "sample_rate")}


def mel_magnitude(audio: np.ndarray, mel: dict) -> np.ndarray:
    """The mel magnitude (n_mels, frames) of ``audio`` in float64: Hann
    frames of ``win_length`` centred in ``n_fft``, ``hop_length`` apart,
    each inside the waveform (no padding, whose reflection would interfere
    with the signal as its phase says),
    the square root of the power through the reference's HTK filterbank
    (``mel``: the configuration's mel settings)."""
    from ttsbench.reference.stts.dsp.mel import mel_filterbank

    n_fft, hop, win = mel["n_fft"], mel["hop_length"], mel["win_length"]
    x = audio.astype(np.float64)
    frames = 1 + (x.shape[0] - n_fft) // hop
    window = np.zeros(n_fft)
    lo = (n_fft - win) // 2
    window[lo:lo + win] = np.hanning(win + 1)[:-1]
    idx = np.arange(n_fft)[None, :] + hop * np.arange(frames)[:, None]
    power = np.abs(np.fft.rfft(x[idx] * window, axis=1)) ** 2
    fb = mel_filterbank(mel["n_mels"], n_fft, mel["sample_rate"]).astype(np.float64)
    return np.sqrt(power @ fb).T


def mel_gap(prog: np.ndarray, ref: np.ndarray, hop: int, mel: dict) -> float:
    """The mel spectral convergence sum |M_p - M_r| / sum M_r on the common
    length; infinite where the lengths differ by more than a frame or the
    program's waveform is not finite."""
    if not _same_length(prog, ref, hop):
        return math.inf
    n = min(prog.shape[0], ref.shape[0])
    m_ref = mel_magnitude(ref[:n], mel)
    diff = np.abs(mel_magnitude(prog[:n], mel) - m_ref)
    return float(diff.sum() / max(m_ref.sum(), 1e-30))


def line_numbers(pairs, hop: int, mel: dict) -> Dict[str, float]:
    """``wave_gap`` and ``mel_gap`` over the (program, reference) waveforms
    of the sampled lines."""
    return {"wave_gap": max(wave_gap(p, r, hop) for p, r in pairs),
            "mel_gap": max(mel_gap(p, r, hop, mel) for p, r in pairs)}


def judge(numbers: Dict[str, float], limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that
    ``limits`` names, each at or under its limit; the others are logged.
    Prints each beside its limit on standard error, the compared last."""
    table, ok = {}, True
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"limits for numbers the check does not compute: {missing}")
    for name, value in numbers.items():
        if name not in limits:
            print(f"logged {name} {value!r}", file=sys.stderr, flush=True)
            continue
        limit = limits[name]["limit"]
        table[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr,
              flush=True)
    return ok, table
