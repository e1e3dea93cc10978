"""Command-line interface of the port: ``python -m stylish_tts_torch.cli``.

Counterpart of ``stylish_tts_tpu/cli.py``; ported so far: ``train-align``.
"""

from __future__ import annotations

import click

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


if __name__ == "__main__":
    train_cli()
