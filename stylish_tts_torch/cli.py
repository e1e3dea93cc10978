"""Command-line interface of the port: ``python -m stylish_tts_torch.cli``
(training) and ``python -m stylish_tts_torch.cli_tts`` (synthesis).

Counterpart of ``stylish_tts_tpu/cli.py``; ported so far: ``train-align``
and ``speak``.
"""

from __future__ import annotations

import click
import numpy as np

from .config import Config, ModelConfig, load_config_yaml, load_model_config_yaml


@click.group()
def train_cli():
    """stylish-train (PyTorch port): training toolkit."""


@train_cli.command("train-align")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option("--device", default="cuda", show_default=True,
              help="torch device; 'cpu' runs the plain CTC instead of the kernels")
def train_align(config_path, model_config_path, out_dir, device):
    """Alignment (CTC) pretraining; saves alignment_model.safetensors."""
    from .trainer.loop import Trainer

    config = load_config_yaml(config_path) if config_path else Config()
    model_config = (
        load_model_config_yaml(model_config_path) if model_config_path
        else ModelConfig()
    )
    Trainer(config, model_config, out_dir, device=device).train("alignment")


@click.group()
def tts_cli():
    """stylish-tts (PyTorch port): synthesis from an inference package."""


@tts_cli.command("speak")
@click.option("--model", "package_dir", required=True, type=click.Path(exists=True))
@click.option("--voicepack", "voicepack_path", required=True,
              type=click.Path(exists=True))
@click.option("--text", "text_path", required=True, type=click.Path(exists=True),
              help="file of `phonemes` lines")
@click.option("--out", "out_path", required=True, type=click.Path())
@click.option("--speed", default=1.0, type=float)
@click.option("--device", default="cuda", show_default=True,
              help="torch device; 'cpu' to synthesise on the CPU")
def speak(package_dir, voicepack_path, text_path, out_path, speed, device):
    """Synthesize a document: one line per utterance, each normalised to
    -25 LUFS, concatenated."""
    from .data.wav import write_wav
    from .export.package import InferencePackage
    from .tts.loudness import normalize_loudness
    from .tts.voicepack import load_voicepack, lookup_dynamic_style, lookup_static_style

    pkg = InferencePackage(package_dir, device=device)
    pack = load_voicepack(voicepack_path)
    embed = None
    if pack["kind"] == "dynamic":
        from .textproc.embed import get_embedder

        embed = get_embedder()
    pieces = []
    with open(text_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tokens = pkg.tokenize(line)
            if embed is not None:
                styles = lookup_dynamic_style(pack, embed([line])[0])
            else:
                styles = lookup_static_style(pack, tokens.shape[0])
            audio = pkg.generate_speech(tokens, *styles, speed=speed)
            pieces.append(normalize_loudness(audio, pkg.mc.sample_rate))
    full = np.concatenate(pieces) if pieces else np.zeros(1, np.float32)
    write_wav(out_path, full, pkg.mc.sample_rate)
    click.echo(
        f"wrote {out_path}: {full.shape[0] / pkg.mc.sample_rate:.2f}s "
        f"({len(pieces)} utterances)"
    )


if __name__ == "__main__":
    train_cli()
