"""Command-line interface of the port: ``python -m stylish_tts_torch.cli``
(training) and ``python -m stylish_tts_torch.cli_tts`` (synthesis).

Counterpart of ``stylish_tts_tpu/cli.py``; ported so far: ``pitch``
(YIN), ``train-align`` (with ``--checkpoint``), ``train --stage
acoustic|textual|duration`` (with ``--checkpoint`` and ``--reset-stage``),
``align``, ``align-textgrid`` and ``speak``. Every command runs on ``--device cuda``
unless told ``--device cpu``, and raises where CUDA is missing.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp

import click
import numpy as np

from .config import Config, ModelConfig, load_config_yaml, load_model_config_yaml


@click.group()
def train_cli():
    """stylish-train (PyTorch port): training toolkit."""


DEVICE_HELP = "torch device; 'cpu' runs on the CPU (the plain CTC instead of the kernels)"
RECORD_HELP = "keep every step's host metrics and wav paths on the returned Trainer"


@train_cli.command("train-align")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option("--checkpoint", default=None, type=click.Path(exists=True),
              help="checkpoint directory to resume from")
@click.option("--device", default="cuda", show_default=True, help=DEVICE_HELP)
@click.option("--record-steps", is_flag=True, hidden=True, help=RECORD_HELP)
def train_align(config_path, model_config_path, out_dir, checkpoint, device,
                record_steps):
    """Alignment (CTC) pretraining; saves alignment_model.safetensors.
    Returns the Trainer to callers that run the command in-process."""
    from .trainer.loop import Trainer

    config, model_config = _load_configs(config_path, model_config_path)
    trainer = Trainer(config, model_config, out_dir, device=device,
                      record_steps=record_steps)
    trainer.train("alignment", checkpoint=checkpoint)
    return trainer


@train_cli.command("train")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option("--stage", default="acoustic",
              type=click.Choice(["acoustic", "textual", "duration"]),
              help="stage to start at; the run goes on through the later ones")
@click.option("--checkpoint", default=None, type=click.Path(exists=True),
              help="checkpoint directory of any of these stages: the same stage "
                   "resumes, another one gives its weights to this stage")
@click.option("--reset-stage", is_flag=True, default=False,
              help="load the checkpoint's weights but restart the stage's counters")
@click.option("--device", default="cuda", show_default=True,
              help="torch device; 'cpu' runs on the CPU (float32)")
@click.option("--record-steps", is_flag=True, hidden=True, help=RECORD_HELP)
def train(config_path, model_config_path, out_dir, stage, checkpoint, reset_stage,
          device, record_steps):
    """Main training: acoustic, then textual, then duration, from the given
    stage on. The JAX ``--profile`` flag (a jax.profiler trace) has no
    counterpart. Returns the Trainer to callers that run the command
    in-process."""
    from .trainer.loop import Trainer

    config, model_config = _load_configs(config_path, model_config_path)
    trainer = Trainer(config, model_config, out_dir, device=device,
                      record_steps=record_steps)
    trainer.train(stage, checkpoint=checkpoint, reset_stage=reset_stage)
    return trainer


def _load_configs(config_path, model_config_path):
    config = load_config_yaml(config_path) if config_path else Config()
    model_config = (
        load_model_config_yaml(model_config_path) if model_config_path
        else ModelConfig()
    )
    return config, model_config


def _trained_aligner(trainer):
    """The aligner of ``alignment_model.safetensors`` (either package's),
    on the trainer's device, in eval mode."""
    from .models import build_text_aligner
    from .utils.params_io import load_text_aligner_safetensors

    path = trainer.data_path(trainer.config.dataset.alignment_model_path)
    if not osp.isfile(path):
        raise click.ClickException(
            f"No alignment model at {path}; run train-align first."
        )
    aligner = build_text_aligner(trainer.mc)
    load_text_aligner_safetensors(path, aligner)
    return aligner.to(trainer.device).eval()


@train_cli.command("align")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option(
    "--method",
    type=click.Choice(["k2", "torch"], case_sensitive=False),
    default="k2",
    help="Duration attribution: 'k2' gives leading/trailing silence to "
    "the pad tokens; 'torch' leaves blanks with the preceding token.",
)
@click.option("--device", default="cuda", show_default=True, help=DEVICE_HELP)
def align(config_path, model_config_path, out_dir, method, device):
    """Generate the forced-alignment cache for both splits."""
    from .dataprep.align import calculate_alignments, write_alignment_outputs
    from .trainer.loop import Trainer

    config, model_config = _load_configs(config_path, model_config_path)
    trainer = Trainer(config, model_config, out_dir, device=device)
    aligner = _trained_aligner(trainer)
    train_ds = trainer.build_dataset(config.dataset.train_data)
    val_ds = trainer.build_dataset(config.dataset.val_data)
    trainer.init_normalization(train_ds, out_dir)

    durations, confidences = {}, {}
    for split, ds in (("train", train_ds), ("val", val_ds)):
        durations[split], confidences[split] = calculate_alignments(
            ds, aligner, model_config, trainer.normalization,
            method=method.lower(),
        )
    write_alignment_outputs(
        out_dir, trainer.data_path(config.dataset.alignment_path),
        durations, confidences,
    )
    click.echo(
        f"wrote alignments for "
        f"{sum(len(v) for v in durations.values())} segments"
    )


@train_cli.command("align-textgrid")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option("--segment", required=True, help="wav filename from the train list")
@click.option("--device", default="cuda", show_default=True, help=DEVICE_HELP)
def align_textgrid(config_path, model_config_path, out_dir, segment, device):
    """Align one segment and write a Praat .TextGrid for inspection."""
    from .dataprep.align import calculate_alignments
    from .trainer.loop import Trainer

    config, model_config = _load_configs(config_path, model_config_path)
    trainer = Trainer(config, model_config, out_dir, device=device)
    aligner = _trained_aligner(trainer)
    ds = trainer.build_dataset(config.dataset.train_data)
    trainer.init_normalization(ds, out_dir)
    target = [s for s in ds.segments if s.wav_path == segment]
    if not target:
        raise click.ClickException(f"segment {segment} not in train list")
    # the one segment, re-indexed to its place in the shortened list
    ds.segments = [dataclasses.replace(target[0], index=0)]
    durations, confidences = calculate_alignments(
        ds, aligner, model_config, trainer.normalization,
    )
    durs = durations[segment][0]
    hop_s = model_config.hop_length / model_config.sample_rate
    phonemes = "$" + target[0].phonemes + "$"
    os.makedirs(out_dir, exist_ok=True)
    out_path = osp.join(out_dir, segment.replace(".wav", ".TextGrid"))
    _write_textgrid(out_path, phonemes, durs, hop_s)
    click.echo(f"wrote {out_path} (confidence {confidences[segment]:.3f})")


def _write_textgrid(path, phonemes, durations, hop_seconds):
    total = float(durations.sum()) * hop_seconds
    lines = [
        'File type = "ooTextFile"', 'Object class = "TextGrid"', "",
        "xmin = 0", f"xmax = {total:.6f}", "tiers? <exists>", "size = 1",
        "item []:", "    item [1]:", '        class = "IntervalTier"',
        '        name = "phones"', "        xmin = 0",
        f"        xmax = {total:.6f}",
        f"        intervals: size = {len(durations)}",
    ]
    t = 0.0
    for i, d in enumerate(durations):
        t2 = t + float(d) * hop_seconds
        ph = phonemes[i] if i < len(phonemes) else ""
        lines += [
            f"        intervals [{i + 1}]:",
            f"            xmin = {t:.6f}",
            f"            xmax = {t2:.6f}",
            f'            text = "{ph}"',
        ]
        t = t2
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


@train_cli.command("pitch")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option("--method", default="yin", type=click.Choice(["yin", "rmvpe"]),
              help="'yin' (batched DSP on the device); 'rmvpe' is not ported yet")
@click.option("--device", default="cuda", show_default=True, help=DEVICE_HELP)
def pitch(config_path, model_config_path, out_dir, method, device):
    """Generate the pitch cache (batched YIN) for both splits."""
    if method == "rmvpe":
        raise click.ClickException(
            "--method rmvpe is not ported yet; use --method yin"
        )
    from .data.caches import save_cache
    from .dataprep.pitch import extract_pitch_for_dataset
    from .trainer.loop import Trainer

    config, model_config = _load_configs(config_path, model_config_path)
    trainer = Trainer(config, model_config, out_dir, device=device)
    cache = {}
    for list_name in (config.dataset.train_data, config.dataset.val_data):
        ds = trainer.build_dataset(list_name)
        cache.update(extract_pitch_for_dataset(
            ds, model_config.hop_length, model_config.sample_rate,
            device=trainer.device,
        ))
    out_path = trainer.data_path(config.dataset.pitch_path)
    save_cache(out_path, cache)
    click.echo(f"wrote pitch for {len(cache)} segments to {out_path}")


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
