"""Training orchestration: the alignment path of ``stylish_tts_tpu/trainer/loop.py``.

* dataset lists, duration bins and normalization stats computed once and
  persisted (``normalization.json``);
* static batch planning per duration bin with ``probe_batch_max`` from
  ``training_plan.alignment``;
* the epoch loop, which after each epoch also trains on the val split and
  then refreshes the CTC label priors;
* metrics at ``log_interval``;
* at the end, ``alignment_model.safetensors`` in the JAX package's flat
  layout, so its ``align`` command can load the port's aligner.

Runs eagerly on one device. Checkpoint/resume and alignment validation
are not ported yet.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import time
from typing import Dict, List

import numpy as np
import torch

from ..config import Config, ModelConfig
from ..data.collate import collate_batch
from ..data.dataset import FilePathDataset
from ..data.loader import PrefetchLoader
from ..data.sampler import BatchSizeTable, DynamicBatchSampler
from ..dsp.mel import MelSpectrogram
from ..models import build_text_aligner
from ..text import TextCleaner
from ..utils.device import resolve_device
from ..utils.params_io import save_text_aligner_safetensors
from .loss_log import MetricsWriter, broadcast
from .normalization import NormalizationStats, compute_stats_streaming
from .state import TrainState, create_train_state
from .steps import (
    StepContext,
    batch_to_device,
    finish_alignment_epoch,
    make_alignment_step,
)

logger = logging.getLogger("stylish_tts_torch")

PORTED_STAGES = ("alignment",)


def setup_stage_logging(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    logger.setLevel(logging.DEBUG)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    logger.addHandler(sh)
    fh = logging.FileHandler(osp.join(out_dir, "train.log"), encoding="utf-8")
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    )
    logger.addHandler(fh)


class Trainer:
    def __init__(self, config: Config, model_config: ModelConfig,
                 out_dir: str, *, device: str = "cuda", seed: int = 0):
        self.device = resolve_device(device)
        # the JAX step runs the aligner in fp32; cuDNN convs would
        # otherwise default to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.mc = model_config
        self.base_out_dir = out_dir
        self.seed = seed
        self.text_cleaner = TextCleaner(model_config.symbol)
        self.normalization = NormalizationStats()
        self.writer = None
        self.losses: List[float] = []  # align_loss of every step, in order

    # ---- data ------------------------------------------------------------

    def data_path(self, name: str) -> str:
        return osp.join(self.config.dataset.path, name)

    def build_dataset(self, list_name: str) -> FilePathDataset:
        with open(self.data_path(list_name), encoding="utf-8") as f:
            lines = f.readlines()
        # duration-class weights serve only the duration stage
        return FilePathDataset(
            data_list=lines,
            root_path=self.data_path(self.config.dataset.wav_path),
            text_cleaner=self.text_cleaner,
            sample_rate=self.mc.sample_rate,
            coarse_hop_length=self.mc.hop_length * self.mc.coarse_multiplier,
            pitch_path=self.data_path(self.config.dataset.pitch_path),
            alignment_path=self.data_path(self.config.dataset.alignment_path),
            time_bin_quantize=self.config.dataset.time_bin_quantize,
        )

    def init_normalization(self, dataset: FilePathDataset, out_dir: str):
        """Compute or load dataset-wide log-mel and F0 stats."""
        cache = osp.join(out_dir, "normalization.json")
        if osp.isfile(cache):
            self.normalization = NormalizationStats.load(cache)
            return
        to_mel = MelSpectrogram(
            n_mels=self.mc.n_mels, n_fft=self.mc.n_fft,
            win_length=self.mc.win_length, hop_length=self.mc.hop_length,
            sample_rate=self.mc.sample_rate,
        )

        def mel_iter():
            with torch.no_grad():
                for i in range(len(dataset)):
                    audio = dataset.load_segment(i)["audio"]
                    audio = torch.from_numpy(audio[None]).to(self.device)
                    yield to_mel(audio).cpu().numpy()  # raw mel power

        def pitch_iter():
            for i in range(len(dataset)):
                p = dataset.load_segment(i, load_audio=False)["pitch"]
                if p is not None:
                    yield p

        self.normalization = compute_stats_streaming(mel_iter(), pitch_iter())
        os.makedirs(out_dir, exist_ok=True)
        self.normalization.save(cache)
        logger.info(
            "normalization: mel_log_mean=%.3f mel_log_std=%.3f",
            self.normalization.mel_log_mean, self.normalization.mel_log_std,
        )

    # ---- training --------------------------------------------------------

    def train(self, stage: str) -> TrainState:
        if stage not in PORTED_STAGES:
            raise ValueError(
                f"stage {stage!r} is not ported yet (ported: {PORTED_STAGES})"
            )
        train_ds = self.build_dataset(self.config.dataset.train_data)
        val_ds = self.build_dataset(self.config.dataset.val_data)
        train_bins, _ = train_ds.time_bins()
        val_bins, _ = val_ds.time_bins()

        out_dir = osp.join(self.base_out_dir, stage)
        setup_stage_logging(out_dir)
        self.init_normalization(train_ds, self.base_out_dir)
        for name, model_dump in (("config.json", self.config),
                                 ("model_config.json", self.mc)):
            with open(osp.join(out_dir, name), "w", encoding="utf-8") as f:
                f.write(model_dump.model_dump_json(indent=2))

        torch.manual_seed(self.seed)  # parameter init
        state = create_train_state(
            build_text_aligner(self.mc), self.mc.text_encoder.tokens + 1,
            self.device, seed=self.seed,
        )
        n_params = sum(p.numel() for p in state.aligner.parameters())
        logger.info("text_aligner parameters: %s on %s", f"{n_params:,}",
                    self.device)

        self.writer = MetricsWriter(out_dir)
        try:
            state = self.run_alignment(
                state, train_ds, val_ds, train_bins, val_bins, out_dir
            )
        finally:
            self.writer.close()
        save_text_aligner_safetensors(
            self.data_path(self.config.dataset.alignment_model_path),
            state.aligner,
        )
        logger.info("saved alignment model")
        return state

    def run_alignment(self, state, train_ds, val_ds, train_bins, val_bins,
                      out_dir):
        cfg = self.config
        plan = cfg.training_plan.get_stage("alignment")
        table = BatchSizeTable(
            path=osp.join(out_dir, "alignment_batch_sizes.json"),
            probe_batch_max=plan.probe_batch_max,
        )
        table.plan(list(train_bins.keys()))
        # tiny datasets would otherwise yield zero full batches (drop_last)
        for b in list(table.sizes.keys()):
            table.sizes[b] = max(min(table.sizes[b], len(train_bins.get(b, []))), 1)
        table.save()

        sampler = DynamicBatchSampler(train_bins, table, seed=17)
        steps_per_epoch = len(sampler)
        stage_steps = max(plan.epochs * steps_per_epoch, 1)
        ctx = StepContext(
            self.mc, cfg.loss_weight.model_dump(), self.normalization,
            stage_steps=stage_steps, base_lr=plan.lr,
        )
        step_fn = make_alignment_step(ctx)

        window: List[Dict[str, object]] = []
        total_step = 0
        t_start = time.time()
        for epoch in range(1, plan.epochs + 1):
            sampler.set_epoch(epoch)
            loader = PrefetchLoader(
                train_ds, sampler, self.mc.hop_length, require_pitch=False,
                device_put=lambda b: batch_to_device(b, self.device),
                depth=max(cfg.training.data_workers // 2, 2),
            )
            for i, (_bin, batch, _paths) in enumerate(loader):
                window.append(step_fn(state, batch))
                total_step += 1
                if total_step % cfg.training.log_interval == 0:
                    self._log_window(window, ctx, total_step, epoch,
                                     plan.epochs, i + 1, steps_per_epoch)
            # also train on the val split (reference train.py:417-423)
            val_sampler = DynamicBatchSampler(
                val_bins, table, seed=29, drop_last=False,
            )
            for _bin, idxs in val_sampler:
                items = [val_ds.load_segment(j) for j in idxs]
                batch, _ = collate_batch(
                    items, hop_length=self.mc.hop_length, require_pitch=False,
                )
                window.append(step_fn(state, batch_to_device(batch, self.device)))
            state = finish_alignment_epoch(ctx, state)
        if window:
            self._log_window(window, ctx, total_step, plan.epochs, plan.epochs,
                             steps_per_epoch, steps_per_epoch)
        logger.info("stage alignment done: %d steps (%d train-split), %.1f s",
                    state.step, total_step, time.time() - t_start)
        return state

    def _log_window(self, window, ctx, total_step, epoch, epochs, i,
                    steps_per_epoch):
        """Move the window's device scalars to the host in one copy, log the
        average, and keep every align_loss."""
        losses = torch.stack([m["align_loss"] for m in window]).cpu().numpy()
        self.losses.extend(float(x) for x in losses)
        lr = window[-1]["lr"]
        window.clear()
        broadcast(
            {"align_loss": float(np.mean(losses))}, ctx.weights, self.writer, total_step,
            header=f"Epoch [{epoch}/{epochs}], Step [{i}/{steps_per_epoch}] ",
        )
        self.writer.add_scalar("train/lr", lr, total_step)
