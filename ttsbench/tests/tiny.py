"""Tiny cells for the CPU tests: the real cell's files with a small model
and a small traffic mix, the same code path."""

from __future__ import annotations

import copy
import math

from ttsbench.harness import load_cell

SMALL_MODEL = {
    "inter_dim": 32, "style_dim": 16,
    "text_encoder": {"hidden_dim": 32, "filter_channels": 64, "heads": 2, "layers": 1},
    "decoder": {"hidden_dim": 32, "residual_dim": 16},
    "generator": {"input_dim": 32, "conformer_layers": 1, "conv_layers": 4,
                  "io_conv_kernel_size": 7, "depth": 1, "resblock_kernel_sizes": [3]},
    "pitch_energy_predictor": {"inter_dim": 32},
    "duration_predictor": {"n_layer": 1},
    "style_encoder": {"max_channels": 64},
}

TINY_TRAFFIC = {
    "train_stage": {"batch": 2, "clips": 4, "clip_seconds": [1.0, 1.05],
                    "phonemes": [10, 20], "max_warmup_steps": 12, "trace_seconds": 1},
    "speak_lines": {"pool": 6, "sentence_median_tokens": 12, "max_tokens": 40,
                    "chapter_sentences": 6, "voices": 2, "check_lines": 2, "strata": 2,
                    "trace_seconds": 1},
}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def tiny_cell(name: str):
    cell = load_cell(name)
    cell.config = _merge(cell.config, {"model": SMALL_MODEL})
    cell.traffic = _merge(cell.traffic, TINY_TRAFFIC[cell.traffic["kind"]])
    cell.checks = {k: {"limit": math.inf} for k in cell.checks}
    return cell
