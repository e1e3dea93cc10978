"""Command-line interface of the port: ``python -m stylish_tts_torch.cli``
(training) and ``python -m stylish_tts_torch.cli_tts`` (synthesis).

Counterpart of ``stylish_tts_tpu/cli.py``; ported so far: ``pitch`` (YIN,
or RMVPE from a local ``--rmvpe-weights`` file), ``train-align`` (with
``--checkpoint``), ``train --stage acoustic|textual|duration`` (with
``--checkpoint`` and ``--reset-stage``), ``slm-cache``, ``align``,
``align-textgrid``, ``import-torch``, ``convert``, ``voicepack
[--dynamic]``, ``dataset-from-audiobook``, ``speak`` and ``prepare-book``.
Every command that computes runs on ``--device cuda`` unless told
``--device cpu``, and raises where CUDA is missing; ``import-torch``,
``convert``, ``dataset-from-audiobook`` and ``prepare-book`` are file and
text work on the CPU and take no device (``convert --exported-program``
traces its program on ``--device``, ``cuda`` unless told ``cpu``).

``train-align`` and ``train`` run data-parallel under ``torchrun
--standalone --nproc-per-node N -m stylish_tts_torch.cli ...``: one process
per card (``cuda:LOCAL_RANK``), each global batch split over the N ranks
(``parallel``). The JAX trainer takes every local device by itself; the
port needs this explicit launch (a departure kept on purpose). Without
``torchrun`` they run on the one device they are given.
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
    config, model_config = _load_configs(config_path, model_config_path)
    return _train(config, model_config, out_dir, device, record_steps, None,
                  "alignment", checkpoint=checkpoint)


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
@click.option("--profile", "profile_dir", default=None, type=click.Path(),
              help="trace the whole run with torch.profiler into this directory "
                   "(a Chrome trace per rank, trace_rank<R>.json)")
@click.option("--record-steps", is_flag=True, hidden=True, help=RECORD_HELP)
def train(config_path, model_config_path, out_dir, stage, checkpoint, reset_stage,
          device, profile_dir, record_steps):
    """Main training: acoustic, then textual, then duration, from the given
    stage on. ``--profile DIR`` wraps the whole run in ``torch.profiler`` (the
    JAX command's ``jax.profiler.trace``). Returns the Trainer to callers
    that run the command in-process."""
    config, model_config = _load_configs(config_path, model_config_path)
    return _train(config, model_config, out_dir, device, record_steps, profile_dir,
                  stage, checkpoint=checkpoint, reset_stage=reset_stage)


def _train(config, model_config, out_dir, device, record_steps, profile_dir, stage,
           **kwargs):
    """A Trainer's ``train(stage, **kwargs)`` on ``device``: in ``torchrun``'s
    process group where the command runs under it (this rank's card), under
    ``torch.profiler`` with ``profile_dir``; returns the Trainer."""
    from . import parallel
    from .trainer.loop import Trainer
    from .utils.device import resolve_device

    dev = resolve_device(device)
    joined = parallel.init_data_parallel(device=dev)
    try:
        trainer = Trainer(config, model_config, out_dir, device=dev,
                          record_steps=record_steps)
        if profile_dir is None:
            trainer.train(stage, **kwargs)
        else:
            _profiled(trainer, profile_dir, stage, **kwargs)
    finally:
        if joined:
            parallel.shutdown()
    return trainer


def _profiled(trainer, profile_dir, stage, **kwargs):
    """``trainer.train`` under ``torch.profiler`` (the host, and the card
    where the trainer runs on one), its Chrome trace written to
    ``profile_dir/trace_rank<R>.json`` with the program's spans
    (``utils/trace.py``) on tracks of their own."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from . import parallel
    from .utils.trace import DROPPED, add_to_chrome_trace

    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    dropped = DROPPED["spans"]
    with profile(activities=activities) as prof:
        lo = time.time_ns()
        trainer.train(stage, **kwargs)
        hi = time.time_ns()
    os.makedirs(profile_dir, exist_ok=True)
    path = osp.join(profile_dir, f"trace_rank{parallel.rank()}.json")
    prof.export_chrome_trace(path)
    add_to_chrome_trace(path, lo, hi, DROPPED["spans"] - dropped)


@train_cli.command("dataset-from-audiobook")
@click.option("--audio", "audio_paths", required=True, multiple=True,
              type=click.Path(exists=True),
              help="narration wav file(s) or directory, in reading order")
@click.option("--book", "book_path", required=True, type=click.Path(exists=True))
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option("--sample-rate", default=24000)
@click.option("--val-fraction", default=0.05)
def dataset_from_audiobook(audio_paths, book_path, out_dir, sample_rate, val_fraction):
    """Build an LJSpeech-style training dataset from audiobook narration:
    VAD-segment the audio, sentence-pack + phonemize the book text, pair
    in reading order. Text and file work on the CPU."""
    from .textproc.audiobook import prepare_dataset

    paths = []
    for p in audio_paths:
        if osp.isdir(p):
            paths.extend(osp.join(p, f) for f in sorted(os.listdir(p))
                         if f.lower().endswith(".wav"))
        else:
            paths.append(p)
    with open(book_path, encoding="utf-8") as f:
        book_text = f.read()
    os.makedirs(out_dir, exist_ok=True)
    n_train, n_val = prepare_dataset(paths, book_text, out_dir, sample_rate, val_fraction)
    click.echo(f"wrote {n_train} train / {n_val} val segments to {out_dir}")


def _load_configs(config_path, model_config_path, checkpoint=None):
    """The configs; a checkpoint's own ``model_config.json`` wins over the
    YAML, as in the JAX command."""
    config = load_config_yaml(config_path) if config_path else Config()
    ckpt_mc = checkpoint and osp.join(checkpoint, "model_config.json")
    if ckpt_mc and osp.isfile(ckpt_mc):
        with open(ckpt_mc, encoding="utf-8") as f:
            model_config = ModelConfig.model_validate_json(f.read())
    elif model_config_path:
        model_config = load_model_config_yaml(model_config_path)
    else:
        model_config = ModelConfig()
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
              help="'yin' (batched DSP on the device) or 'rmvpe' (the neural "
                   "estimator; needs --rmvpe-weights)")
@click.option("--rmvpe-weights", default=None, type=click.Path(exists=True),
              help="a local rmvpe.safetensors in the reference layout (nothing is "
                   "downloaded)")
@click.option("--device", default="cuda", show_default=True, help=DEVICE_HELP)
def pitch(config_path, model_config_path, out_dir, method, rmvpe_weights, device):
    """Generate the pitch cache (batched YIN or RMVPE) for both splits."""
    if method == "rmvpe" and rmvpe_weights is None:
        raise click.ClickException(
            "--method rmvpe needs --rmvpe-weights PATH, a local rmvpe.safetensors "
            "(the port downloads nothing)"
        )
    from .data.caches import save_cache
    from .dataprep.pitch import extract_pitch_for_dataset
    from .trainer.loop import Trainer

    config, model_config = _load_configs(config_path, model_config_path)
    trainer = Trainer(config, model_config, out_dir, device=device)
    extractor = None
    if method == "rmvpe":
        from .dataprep.rmvpe import RMVPEPitchExtractor

        extractor = RMVPEPitchExtractor(rmvpe_weights, model_config.sample_rate,
                                        model_config.hop_length, device=trainer.device)
    cache = {}
    for list_name in (config.dataset.train_data, config.dataset.val_data):
        ds = trainer.build_dataset(list_name)
        cache.update(extract_pitch_for_dataset(
            ds, model_config.hop_length, model_config.sample_rate,
            device=trainer.device, extractor=extractor,
        ))
    out_path = trainer.data_path(config.dataset.pitch_path)
    save_cache(out_path, cache)
    click.echo(f"wrote pitch for {len(cache)} segments to {out_path}")


@train_cli.command("slm-cache")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option("--device", default="cuda", show_default=True, help=DEVICE_HELP)
def slm_cache(config_path, model_config_path, out_dir, device):
    """Precompute the ground-truth WavLM embeddings of the slm loss for both
    splits into dataset.slm_path, with the weights' fingerprint; a run that
    starts at the acoustic stage reads them."""
    from .dataprep.slm_cache import compute_slm_cache, write_slm_cache
    from .models.slm import load_wavlm
    from .trainer.loop import Trainer

    config, model_config = _load_configs(config_path, model_config_path)
    trainer = Trainer(config, model_config, out_dir, device=device)
    model = load_wavlm(model_config.slm.model, model_config.slm.allow_random_fallback,
                       trainer.device)
    cache = {}
    for list_name in (config.dataset.train_data, config.dataset.val_data):
        cache.update(compute_slm_cache(trainer.build_dataset(list_name), model))
    out_path = trainer.data_path(config.dataset.slm_path)
    write_slm_cache(out_path, cache)
    click.echo(f"wrote slm embeddings for {len(cache) - 1} segments to {out_path}")


@train_cli.command("import-torch")
@click.option("--config", "config_path", type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--checkpoint", required=True, type=click.Path(exists=True),
              help="Reference accelerate save_state checkpoint directory")
@click.option("--out", "out_dir", required=True, type=click.Path())
def import_torch(config_path, model_config_path, checkpoint, out_dir):
    """Import a trained PyTorch reference checkpoint (accelerate
    save_state dir) into the port's checkpoint format: one checkpoint of
    stage ``duration`` whose ``state.pt`` holds the twelve modules with
    fresh optimizers, and the aligner beside it in the JAX flat layout
    (``alignment_model.safetensors``). BatchNorm is folded to frozen
    affine and weight/spectral norm into the kernels (see convert/), so
    `convert`, `voicepack` and `speak` work on it directly. File work on
    the CPU. Returns the checkpoint's path to callers that run the command
    in-process."""
    from .convert.checkpoint_import import import_torch_checkpoint, imported_models
    from .trainer.checkpoint import ALIGNER_FILE, Manifest, save_checkpoint
    from .trainer.normalization import NormalizationStats
    from .trainer.state import create_stage_train_state
    from .utils.params_io import save_text_aligner_safetensors

    config, model_config = _load_configs(config_path, model_config_path)
    params = import_torch_checkpoint(checkpoint, model_config)
    models = imported_models(params, model_config)
    aligner = models.pop("text_aligner")
    state = create_stage_train_state(models, "cpu", stage="duration")
    manifest = Manifest(stage="duration")  # a fully trained reference model
    os.makedirs(out_dir, exist_ok=True)
    path = save_checkpoint(out_dir, state, manifest, config, model_config,
                           NormalizationStats())
    save_text_aligner_safetensors(osp.join(path, ALIGNER_FILE), aligner)
    click.echo(f"imported torch checkpoint -> {path}")
    return path


@train_cli.command("convert")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--checkpoint", required=True, type=click.Path(exists=True),
              help="checkpoint directory of the acoustic, textual or duration stage")
@click.option("--out", "out_dir", required=True, type=click.Path())
@click.option("--exported-program", "exported_program", is_flag=True, default=False,
              help="also write the acoustic phase at (32, 100) as a torch.export "
                   "program, exported_program/acoustic_L32_F100.pt2 (the JAX "
                   "--stablehlo)")
@click.option("--device", default="cuda", show_default=True,
              help="torch device the exported program is traced on (and runs on); "
                   "read only with --exported-program")
def convert(config_path, model_config_path, checkpoint, out_dir, exported_program, device):
    """Package a checkpoint for inference: the six inference modules in the
    JAX layout, the model config, and the normalization, pitch and duration
    stats. File work on the CPU; ``--exported-program`` also traces the
    acoustic phase on ``--device`` and saves it."""
    from .data.caches import load_cache
    from .export.package import duration_stats_from_cache, export_checkpoint, pitch_log2_stats
    from .trainer.checkpoint import load_stage_models

    config, model_config = _load_configs(config_path, model_config_path, checkpoint)
    models, norm = load_stage_models(checkpoint, model_config, "cpu")
    pitch_path = osp.join(config.dataset.path, config.dataset.pitch_path)
    pitch_log2_mean, pitch_log2_std = pitch_log2_stats(
        load_cache(pitch_path) if osp.isfile(pitch_path) else None)
    align_path = osp.join(config.dataset.path, config.dataset.alignment_path)
    duration_stats = (duration_stats_from_cache(load_cache(align_path))
                      if osp.isfile(align_path) else None)
    export_checkpoint(models, model_config, norm, out_dir,
                      pitch_log2_mean=pitch_log2_mean, pitch_log2_std=pitch_log2_std,
                      duration_stats=duration_stats,
                      emit_exported_program=exported_program, device=device)
    click.echo(f"wrote inference package to {out_dir}")


@train_cli.command("voicepack")
@click.option("--config", "config_path", required=True, type=click.Path(exists=True))
@click.option("--model-config", "model_config_path", type=click.Path(exists=True))
@click.option("--checkpoint", required=True, type=click.Path(exists=True))
@click.option("--out", "out_path", required=True, type=click.Path())
@click.option("--dynamic", is_flag=True, default=False,
              help="per-segment styles + sentence-embedding kNN pack (the hashed "
                   "embedder)")
@click.option("--device", default="cuda", show_default=True, help=DEVICE_HELP)
def voicepack(config_path, model_config_path, checkpoint, out_path, dynamic, device):
    """Encode the train split's styles into a voicepack (static or dynamic).
    Returns the styles to callers that run the command in-process."""
    from .trainer.checkpoint import load_stage_models
    from .trainer.loop import Trainer
    from .tts.voicepack import (
        build_dynamic_pack, build_static_pack, encode_all_styles,
        save_dynamic_voicepack, save_static_voicepack,
    )

    config, model_config = _load_configs(config_path, model_config_path, checkpoint)
    trainer = Trainer(config, model_config, osp.dirname(out_path) or ".", device=device)
    models, norm = load_stage_models(checkpoint, model_config, trainer.device)
    ds = trainer.build_dataset(config.dataset.train_data)
    styles = encode_all_styles(ds, models, norm, model_config)
    if dynamic:
        from .textproc.embed import get_embedder

        # the texts in the styles' order (sorted time bins)
        bins, _ = ds.time_bins()
        texts = [ds.segments[i].text for _bin, idxs in sorted(bins.items()) for i in idxs]
        save_dynamic_voicepack(out_path, build_dynamic_pack(styles, texts, get_embedder()))
    else:
        save_static_voicepack(out_path, build_static_pack(styles))
    click.echo(f"wrote voicepack ({styles['lengths'].shape[0]} segments)")
    return styles


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
    -25 LUFS, concatenated. Each line runs the program of its buckets (a
    CUDA graph on the card), built at the first line that needs it and
    replayed from then on."""
    from .data.wav import write_wav
    from .export import open_package
    from .tts.loudness import normalize_loudness

    pkg = open_package(package_dir, device=device)
    before = [dict(c) for _, c in pkg.SPEAK_COUNTERS]
    voice = pkg.load_voice(voicepack_path)
    pieces = []
    with open(text_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            audio = pkg.speak_line(line, voice, speed)
            pieces.append(normalize_loudness(audio, pkg.mc.sample_rate))
    full = np.concatenate(pieces) if pieces else np.zeros(1, np.float32)
    write_wav(out_path, full, pkg.mc.sample_rate)
    click.echo(
        f"wrote {out_path}: {full.shape[0] / pkg.mc.sample_rate:.2f}s "
        f"({len(pieces)} utterances)"
    )
    click.echo("; ".join(f"{label}: " + ", ".join(f"{k} {c[k] - b[k]}" for k in c)
                         for (label, c), b in zip(pkg.SPEAK_COUNTERS, before)))


@tts_cli.command("prepare-book")
@click.option("--text", "text_path", required=True, type=click.Path(exists=True))
@click.option("--out", "out_path", required=True, type=click.Path())
@click.option("--phonemize", "do_phonemize", is_flag=True, default=False,
              help="emit IPA phonemes (espeak when available)")
def prepare_book(text_path, out_path, do_phonemize):
    """Split long-form text into synthesis-sized utterances, one per line,
    ready for ``speak``. The sentences are packed by character length, as
    the JAX command packs them. Text work on the CPU."""
    from .textproc.book import pack_utterances, split_chapters
    from .textproc.g2p import phonemize as g2p
    from .textproc.normalize import normalize_text

    with open(text_path, encoding="utf-8") as f:
        text = f.read()
    lines = []
    for chapter in split_chapters(text):
        sentences = [normalize_text(s) for s in chapter.sentences]
        for utt in pack_utterances(sentences):
            lines.append(g2p(utt) if do_phonemize else utt)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    click.echo(f"wrote {len(lines)} utterances to {out_path}")


if __name__ == "__main__":
    train_cli()
