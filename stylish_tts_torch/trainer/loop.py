"""Training orchestration: the port's ``stylish_tts_tpu/trainer/loop.py``.

* dataset lists, duration bins and normalization stats computed once and
  persisted (``normalization.json``);
* static batch planning per duration bin with the stage's
  ``training_plan.<stage>.probe_batch_max``;
* metrics at ``log_interval``; validation every ``val_interval``; a
  checkpoint every ``save_interval`` and at the end of each stage;
* resume from a checkpoint: the same stage fast-forwards the sampler by
  ``manifest.current_step``, another stage (or ``reset_stage``) starts
  fresh counters.

The alignment stage (``train-align``): after each epoch the loop also
trains on the val split and then refreshes the CTC label priors;
validation is the CTC loss without priors and the forced-align
confidence; at the end, ``alignment_model.safetensors`` in the JAX
package's flat layout, so its ``align`` command can load the port's
aligner.

The later stages (``train --stage acoustic|textual|duration``): one
``StageTrainState`` holds every module; each stage trains its own
(``STAGE_TRAIN_MODELS``) at its plan's lr (cosine over the stage), with
the frozen WavLM in the acoustic stage when ``loss_weight.slm`` > 0 (a
local checkpoint, or the seeded random init under
``model.slm.allow_random_fallback``; a run that starts at acoustic reads
the slm cache ``dataset.slm_path`` where it exists, after checking that its
WavLM fingerprint is that of the loaded weights) and the duration-class weights
sqrt(train split's inverse class frequencies) in the duration stage;
batches with pitch and alignments; metrics moved to the host once per
``log_interval``; validation with the eval samples' predicted audio written
as wav files. After acoustic the loop advances to textual, then duration
(``NEXT_STAGE``), as the JAX loop does: a new manifest, fresh AdamW
moments and step 0, the WavLM and the slm cache dropped.

The per-step host records (``losses``, ``step_metrics``, ``batches``) are
kept only with ``record_steps``; the JAX loop keeps none.

Memory guards of every train step (the JAX ``run_stage``'s): a step that
runs out of device memory (``classify_step_failure``) lowers its duration
bin's batch size for good (``BatchSizeTable.shrink``, x0.9, saved) and
skips the batch without counting a step; a prefetched batch larger than
the bin's current size is skipped without a second shrink; an OOM after the
step's first optimizer update began (``state.update_begun``) lowers the
bin, then raises: the state is partly updated, so the run resumes from its
last checkpoint. With ``STYLISH_DEBUG_NANSTEP=1`` every step's metrics
are synced, and the first nonfinite one dumps the batch to
``nan_batch_step{i}.npz`` in the stage directory and raises; without it
the metrics reach the host once per ``log_interval``
(``_metrics_to_host``).

Each stage directory gets ``git_state.txt`` (the commit and the diff of the
checkout, or the package version outside git) beside its copies of the two
configs, and each validation the eval samples' log-mel figures (ground
truth, prediction, signed difference) where TensorBoard and matplotlib are
present.

Data parallel (``parallel``; under ``torchrun``, one process per card):
the JAX trainer's 1-D mesh over every local device. Every rank's sampler
draws the same global batch and its loader loads the rank's rows; the
batch sizes are rounded to the world size N (``_plan_table``, a shrunk bin
too), the val split's training drops the batches that do not divide by N
and validation chunks by N, as the JAX loop does; the validation and
logged metrics are averaged over the ranks, one collective per pass or log
interval. Rank 0 alone writes the checkpoints, metrics, figures, eval wavs
(the eval samples of other ranks gathered to it), batch-size tables,
``git_state.txt``, the normalization cache and the aligner; the others wait
at a barrier where they must. An out-of-memory step is a collective
decision (``_step_or_skip``). At world size 1 the loop is the one-card loop
it was. A failing validation batch raises, and so does a failing figure:
the JAX loop logs and skips both.
"""

from __future__ import annotations

import hashlib
import logging
import os
import os.path as osp
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import parallel
from ..config import Config, ModelConfig
from ..data.collate import collate_batch
from ..data.dataset import FilePathDataset
from ..data.loader import PrefetchLoader
from ..data.sampler import BatchSizeTable, DynamicBatchSampler
from ..dataprep.slm_cache import check_fingerprint
from ..dsp.mel import MelSpectrogram
from ..models import build_models, build_text_aligner
from ..models.slm import load_wavlm, wavlm_loss
from ..ops.duration import DurationProcessor
from ..text import TextCleaner
from ..utils.device import resolve_device
from ..utils.params_io import save_text_aligner_safetensors
from .checkpoint import Manifest, load_checkpoint, save_checkpoint
from .loss_log import MetricsWriter, broadcast, combine_metrics
from .normalization import NormalizationStats, compute_stats_streaming
from .state import TrainState, create_stage_train_state, create_train_state
from .steps import (
    StepContext,
    batch_to_device,
    finish_alignment_epoch,
    make_acoustic_step,
    make_alignment_step,
    make_duration_step,
    make_textual_step,
)
from .validate import VALIDATORS, validate_alignment

logger = logging.getLogger("stylish_tts_torch")

STAGES = ("alignment", "acoustic", "textual", "duration")
NEXT_STAGE = {"acoustic": "textual", "textual": "duration"}


def classify_step_failure(exc) -> str:
    """Classify a train-step exception (or its message), as the JAX loop's
    classifier does.

    "oom"       - device memory exhausted: a ``torch.OutOfMemoryError``
                  (CUDA's "CUDA out of memory"), or a message with XLA's
                  ``RESOURCE_EXHAUSTED`` or ``OOM``; the loop lowers the bin;
    "transient" - a message of XLA's remote compile service; kept so that
                  the kinds match JAX's, but the port compiles nothing
                  remotely and retries nothing: the loop raises it;
    "fatal"     - anything else.
    """
    if isinstance(exc, torch.OutOfMemoryError):
        return "oom"
    msg = str(exc)
    if "RESOURCE_EXHAUSTED" in msg or "OOM" in msg:
        return "oom"
    if "remote_compile" in msg or "response body closed" in msg or "UNAVAILABLE" in msg:
        return "transient"
    return "fatal"


def _metrics_to_host(window) -> List[Dict[str, float]]:
    """A window of step metric dicts as host floats, every device scalar of
    the window moved in one copy: the loop's only host sync of metrics,
    once per ``log_interval`` (per step under ``STYLISH_DEBUG_NANSTEP``)."""
    tensor_keys = sorted(k for k, v in window[0].items() if torch.is_tensor(v))
    packed = parallel.all_mean(torch.stack([torch.stack([m[k].float() for k in tensor_keys])
                                            for m in window])).cpu().numpy()
    rows = []
    for m, row in zip(window, packed):
        host = {k: float(v) for k, v in m.items() if not torch.is_tensor(v)}
        host.update(zip(tensor_keys, map(float, row)))
        rows.append(host)
    return rows


def select_validation_samples(paths: List[str], count: int, force: List[str]) -> List[str]:
    """Deterministic selection by blake2b digest, forced samples first."""
    chosen = [p for p in force if p in paths]
    rest = sorted((p for p in paths if p not in chosen),
                  key=lambda p: hashlib.blake2b(p.encode()).hexdigest())
    return (chosen + rest)[:count]


def save_git_state(out_dir: str) -> None:
    """Snapshot the checkout's git commit and diff into the stage dir
    (reference utils.py:617-624 ``git_state.txt``); outside a git checkout,
    the package version. Rank 0 alone."""
    if not parallel.is_writer():
        return
    repo = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    try:
        commit = subprocess.run(
            ["git", "-C", repo, "rev-parse", "HEAD"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        diff = subprocess.run(
            ["git", "-C", repo, "diff"], capture_output=True, text=True,
        ).stdout
    except (OSError, subprocess.CalledProcessError):
        from .. import __version__

        commit, diff = f"version {__version__}", ""
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(out_dir, "git_state.txt"), "w", encoding="utf-8") as f:
        f.write(f"Git commit hash or version: {commit}\n\n{diff}")


def setup_stage_logging(out_dir: str) -> None:
    """INFO to the console and DEBUG to the stage's ``train.log``; on the
    ranks but 0, warnings to the console only."""
    os.makedirs(out_dir, exist_ok=True)
    logger.setLevel(logging.DEBUG)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO if parallel.is_writer() else logging.WARNING)
    logger.addHandler(sh)
    if not parallel.is_writer():
        return
    fh = logging.FileHandler(osp.join(out_dir, "train.log"), encoding="utf-8")
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    )
    logger.addHandler(fh)


class Trainer:
    def __init__(self, config: Config, model_config: ModelConfig,
                 out_dir: str, *, device: str = "cuda", seed: int = 0,
                 record_steps: bool = False):
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
        self.manifest = Manifest()
        self.writer = None
        self.duration_processor = DurationProcessor(
            model_config.duration_predictor.duration_classes,
            model_config.duration_predictor.max_duration)
        # with record_steps, in order over every stage run: the align_loss
        # of every alignment step, the host metrics of every later-stage
        # step and the wav paths of every step; None otherwise
        self.losses: Optional[List[float]] = [] if record_steps else None
        self.step_metrics: Optional[List[Dict[str, float]]] = [] if record_steps else None
        self.batches: Optional[List[List[str]]] = [] if record_steps else None
        # one entry per validation pass: stage, step, batch count, mean metrics
        self.validations: List[Dict[str, object]] = []
        # the last manifest of each stage run
        self.stage_manifests: Dict[str, Manifest] = {}

    # ---- data ------------------------------------------------------------

    def data_path(self, name: str) -> str:
        return osp.join(self.config.dataset.path, name)

    def build_dataset(self, list_name: str, with_slm: bool = False) -> FilePathDataset:
        """The dataset of ``list_name`` with the pitch and alignment caches,
        and the slm cache (``dataset.slm_path``, where the file exists) only
        ``with_slm``: it is large and only the acoustic step reads it."""
        with open(self.data_path(list_name), encoding="utf-8") as f:
            lines = f.readlines()
        return FilePathDataset(
            data_list=lines,
            root_path=self.data_path(self.config.dataset.wav_path),
            text_cleaner=self.text_cleaner,
            sample_rate=self.mc.sample_rate,
            coarse_hop_length=self.mc.hop_length * self.mc.coarse_multiplier,
            pitch_path=self.data_path(self.config.dataset.pitch_path),
            alignment_path=self.data_path(self.config.dataset.alignment_path),
            dur_to_class=lambda d: self.duration_processor.dur_to_class(
                torch.as_tensor(d)).numpy(),
            slm_path=self.data_path(self.config.dataset.slm_path) if with_slm else None,
            time_bin_quantize=self.config.dataset.time_bin_quantize,
        )

    def init_normalization(self, dataset: FilePathDataset, out_dir: str):
        """Compute or load dataset-wide log-mel and F0 stats."""
        cache = osp.join(out_dir, "normalization.json")
        if not parallel.is_writer():  # rank 0 computes and writes them
            parallel.barrier()
            self.normalization = NormalizationStats.load(cache)
            return
        if osp.isfile(cache):
            self.normalization = NormalizationStats.load(cache)
            parallel.barrier()
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
        parallel.barrier()
        logger.info(
            "normalization: mel_log_mean=%.3f mel_log_std=%.3f",
            self.normalization.mel_log_mean, self.normalization.mel_log_std,
        )

    # ---- training --------------------------------------------------------

    def train(self, stage: str, checkpoint: Optional[str] = None,
              reset_stage: bool = False):
        """Train ``stage`` from scratch or from ``checkpoint``, then each
        stage after it (acoustic -> textual -> duration); a checkpoint of
        the same stage resumes where it stopped unless ``reset_stage``.
        Returns the last stage's state (``TrainState`` or
        ``StageTrainState``)."""
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r} (stages: {STAGES})")
        # the run enters acoustic only when it starts there
        with_slm = stage == "acoustic" and self.config.loss_weight.slm > 0
        train_ds = self.build_dataset(self.config.dataset.train_data, with_slm)
        val_ds = self.build_dataset(self.config.dataset.val_data, with_slm)
        train_bins, _ = train_ds.time_bins()
        val_bins, _ = val_ds.time_bins()

        out_dir = self._open_stage(stage)
        self.init_normalization(train_ds, self.base_out_dir)
        torch.manual_seed(self.seed)  # parameter init
        if stage == "alignment":
            state = create_train_state(
                build_text_aligner(self.mc), self.mc.text_encoder.tokens + 1,
                self.device, seed=self.seed,
            )
            models = {"text_aligner": state.aligner}
        else:
            state = create_stage_train_state(build_models(self.mc), self.device, stage,
                                             seed=self.seed)
            models = state.models
        n_params = {k: f"{sum(p.numel() for p in m.parameters()):,}"
                    for k, m in models.items()}
        logger.info("parameters: %s on %s", n_params, self.device)

        skip_batches = 0
        self.manifest = Manifest(stage=stage)
        if checkpoint:
            state, manifest, self.normalization = load_checkpoint(checkpoint, state)
            if manifest.stage == stage and not reset_stage:
                self.manifest = manifest
                skip_batches = manifest.current_step
                logger.info("resuming %s at epoch %d step %d", stage,
                            manifest.current_epoch, manifest.current_total_step)
            else:
                state.step = 0

        while True:
            self.writer = MetricsWriter(out_dir)
            try:
                if stage == "alignment":
                    state = self.run_alignment(state, train_ds, val_ds, train_bins,
                                               val_bins, out_dir, skip_batches)
                else:
                    if stage == "acoustic" and self.config.loss_weight.slm > 0:
                        state.wavlm = load_wavlm(self.mc.slm.model,
                                                 self.mc.slm.allow_random_fallback,
                                                 self.device)
                        if train_ds.slm:
                            check_fingerprint(train_ds.slm, state.wavlm)
                    state = self.run_stage(stage, state, train_ds, val_ds, train_bins,
                                           val_bins, out_dir, skip_batches)
                    state.wavlm = None
            finally:
                self.writer.close()
            self.stage_manifests[stage] = self.manifest
            if stage == "alignment":
                if parallel.is_writer():
                    save_text_aligner_safetensors(
                        self.data_path(self.config.dataset.alignment_model_path),
                        state.aligner,
                    )
                    logger.info("saved alignment model")
                parallel.barrier()
                return state
            stage = NEXT_STAGE.get(stage)
            if stage is None:
                return state
            out_dir = self._open_stage(stage)
            logger.info("advancing to stage %s", stage)
            self.manifest = Manifest(stage=stage)
            skip_batches = 0
            # the later stages never read the slm cache
            train_ds.slm = {}
            val_ds.slm = {}
            state.begin_stage(stage)

    def _open_stage(self, stage: str) -> str:
        """The stage's directory, with its log file, ``git_state.txt`` and
        config copies."""
        out_dir = osp.join(self.base_out_dir, stage)
        setup_stage_logging(out_dir)
        save_git_state(out_dir)
        if parallel.is_writer():
            for name, model_dump in (("config.json", self.config),
                                     ("model_config.json", self.mc)):
                with open(osp.join(out_dir, name), "w", encoding="utf-8") as f:
                    f.write(model_dump.model_dump_json(indent=2))
        return out_dir

    def run_alignment(self, state, train_ds, val_ds, train_bins, val_bins,
                      out_dir, skip_batches=0):
        cfg = self.config
        plan = cfg.training_plan.get_stage("alignment")
        table = self._plan_table("alignment", train_bins, out_dir)

        sampler = DynamicBatchSampler(train_bins, table, seed=17)
        steps_per_epoch = len(sampler)
        self.manifest.steps_per_epoch = steps_per_epoch
        stage_steps = max(plan.epochs * steps_per_epoch, 1)
        ctx = StepContext(
            self.mc, cfg.loss_weight.model_dump(), self.normalization,
            stage_steps=stage_steps, base_lr=plan.lr,
        )
        step_fn = make_alignment_step(ctx)
        debug = os.environ.get("STYLISH_DEBUG_NANSTEP") == "1"

        window: List[Dict[str, object]] = []
        t_start = time.time()
        for epoch in range(self.manifest.current_epoch, plan.epochs + 1):
            self.manifest.current_epoch = epoch
            sampler.set_epoch(epoch)
            loader = PrefetchLoader(
                train_ds, sampler, self.mc.hop_length, require_pitch=False,
                device_put=lambda b: batch_to_device(b, self.device),
                depth=max(cfg.training.data_workers // 2, 2),
            )
            for i, (time_bin, batch, paths) in enumerate(loader):
                if skip_batches > 0:
                    skip_batches -= 1
                    continue
                metrics = self._step_or_skip(step_fn, state, batch, time_bin, table)
                if metrics is None:
                    del batch
                    self._release_after_oom(state)
                    continue
                if debug:
                    self._debug_nanstep(metrics, batch, paths, time_bin, i + 1, out_dir)
                window.append(metrics)
                if self.batches is not None:
                    self.batches.append(paths)
                self.manifest.current_step = i + 1
                self.manifest.current_total_step += 1
                total_step = self.manifest.current_total_step
                if total_step % cfg.training.log_interval == 0:
                    self._log_window(window, ctx, total_step, epoch,
                                     plan.epochs, i + 1, steps_per_epoch)
                if total_step % cfg.training.val_interval == 0:
                    self.validate(state, ctx, val_ds, val_bins, table)
                if total_step % cfg.training.save_interval == 0:
                    save_checkpoint(out_dir, state, self.manifest, cfg, self.mc,
                                    self.normalization)
            # also train on the val split (reference train.py:417-423), the
            # batches cut to a multiple of N, those below N dropped
            val_sampler = DynamicBatchSampler(
                val_bins, table, seed=29, drop_last=False,
            )
            n = parallel.world_size()
            for _bin, idxs in val_sampler:
                idxs = idxs[: len(idxs) // n * n] or idxs
                if len(idxs) % n:
                    continue
                items = [val_ds.load_segment(j) for j in parallel.shard_rows(idxs)]
                batch, paths = collate_batch(
                    items, hop_length=self.mc.hop_length, require_pitch=False,
                )
                window.append(step_fn(state, batch_to_device(batch, self.device)))
                if self.batches is not None:
                    self.batches.append(paths)
            state = finish_alignment_epoch(ctx, state)
            self.manifest.current_step = 1
        if window:
            self._log_window(window, ctx, self.manifest.current_total_step,
                             plan.epochs, plan.epochs, steps_per_epoch,
                             steps_per_epoch)
        logger.info("stage alignment done: %d steps (%d train-split), %.1f s",
                    state.step, self.manifest.current_total_step,
                    time.time() - t_start)
        save_checkpoint(out_dir, state, self.manifest, cfg, self.mc,
                        self.normalization)
        return state

    def _step_or_skip(self, step_fn, state, batch, time_bin: int,
                      table: BatchSizeTable) -> Optional[Dict[str, object]]:
        """``step_fn(state, batch)``'s metrics; None where the step ran out of
        device memory and the batch is skipped: the bin's batch size lowered
        for good (a stale prefetched batch larger than the bin's current size
        lowers nothing). An OOM after the step's first optimizer update began
        lowers the bin and raises. Data parallel, the ranks decide together
        (``parallel``'s protocol): the rank that runs out of memory announces
        it, the others' next collective raises ``PeerStepFailed``, and every
        rank skips the same global batch and lowers the same bin to a
        multiple of N (or raises, after the first update)."""
        state.update_begun = False
        try:
            metrics = step_fn(state, batch)
            parallel.agree()  # a failure late in a peer's step is seen in this one
            return metrics
        except Exception as exc:
            peer = isinstance(exc, parallel.PeerStepFailed)
            if not peer and classify_step_failure(exc) != "oom":
                raise
            if not peer:
                parallel.announce_failure()
            where = "another rank's step" if peer else "OOM"
            n = parallel.world_size()
            size, planned = int(batch.audio_gt.shape[0]) * n, table.get(time_bin)
            if size > planned:
                logger.warning("%s on stale prefetched batch (bin %d, size %d > planned "
                               "%d); skipping", where, time_bin, size, planned)
                new_size = planned
            else:
                new_size = table.shrink(time_bin, multiple=n)
                logger.warning("%s on bin %d at batch size %d; batch size lowered to %d",
                               where, time_bin, size, new_size)
            if state.update_begun:
                raise RuntimeError(
                    "OOM after the step's first optimizer update began: the training "
                    f"state is partly updated; bin {time_bin}'s batch size is durably "
                    f"lowered to {new_size}; resume from the last checkpoint.") from exc
        # the except block is left: its traceback, which held the step's
        # activations, is gone
        return None

    def _release_after_oom(self, state) -> None:
        """Drop every gradient and hand the allocator's free blocks back, so
        that the next batch does not meet the same full allocator."""
        opts = ([state.optimizer] if isinstance(state, TrainState)
                else state.optimizers.values())
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _debug_nanstep(self, metrics, batch, paths, time_bin: int, step: int,
                       out_dir: str) -> None:
        """``STYLISH_DEBUG_NANSTEP=1``: sync this step's metrics; on a
        nonfinite one, dump the batch (bf16 fields as float32), its paths and
        bin to ``nan_batch_step{step}.npz`` and raise."""
        host = _metrics_to_host([metrics])[0]
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            rank = f"_rank{parallel.rank()}" if parallel.world_size() > 1 else ""
            dump = osp.join(out_dir, f"nan_batch_step{step}{rank}.npz")
            fields = {f: getattr(batch, f) for f in batch._fields
                      if getattr(batch, f) is not None}
            np.savez(dump, paths=np.asarray(paths), time_bin=time_bin,
                     **{f: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
                        if torch.is_tensor(v) else np.asarray(v)
                        for f, v in fields.items()})
            logger.error("nonfinite metrics %s at step %d (bin %d, paths %s); batch "
                         "dumped to %s", bad, step, time_bin, paths, dump)
            raise RuntimeError(f"debug: nonfinite {bad}")
        logger.info("debug step %d bin %d ok: %s", step, time_bin,
                    {k: round(v, 3) for k, v in host.items()})

    def _plan_table(self, stage, train_bins, out_dir) -> BatchSizeTable:
        """The stage's batch size per bin, capped by the bin's population
        (tiny datasets would otherwise yield zero full batches) and rounded
        down to a multiple of the world size N, at least N (the JAX rule)."""
        plan = self.config.training_plan.get_stage(stage)
        table = BatchSizeTable(
            path=osp.join(out_dir, f"{stage}_batch_sizes.json"),
            probe_batch_max=plan.probe_batch_max,
        )
        table.plan(list(train_bins.keys()))
        n = parallel.world_size()
        for b in list(table.sizes.keys()):
            size = min(table.sizes[b], len(train_bins.get(b, [])) or 1)
            table.sizes[b] = max(size // n * n, n)
        table.save()
        return table

    # ---- acoustic, textual and duration stages -----------------------------

    def _make_step(self, stage: str, ctx: StepContext, train_ds: FilePathDataset):
        if stage == "acoustic":
            return make_acoustic_step(ctx)
        if stage == "textual":
            return make_textual_step(ctx)
        weights = torch.sqrt(torch.as_tensor(np.nan_to_num(train_ds.duration_weights)))
        return make_duration_step(ctx, weights.to(self.device))

    def run_stage(self, stage, state, train_ds, val_ds, train_bins, val_bins, out_dir,
                  skip_batches=0):
        cfg = self.config
        plan = cfg.training_plan.get_stage(stage)
        table = self._plan_table(stage, train_bins, out_dir)
        sampler = DynamicBatchSampler(train_bins, table, seed=17)
        steps_per_epoch = len(sampler)
        self.manifest.steps_per_epoch = steps_per_epoch
        stage_steps = max(plan.epochs * steps_per_epoch, 1)
        ctx = StepContext(
            self.mc, cfg.loss_weight.model_dump(), self.normalization,
            stage_steps=stage_steps, base_lr=plan.lr,
            slm_loss_fn=wavlm_loss if state.wavlm is not None else None,
            mixed_precision=(cfg.training.mixed_precision == "bf16"
                             and self.device.type == "cuda"),
            sampled_mrd_only=cfg.training.sampled_mrd_only,
        )
        step_fn = self._make_step(stage, ctx, train_ds)
        debug = os.environ.get("STYLISH_DEBUG_NANSTEP") == "1"

        window: List[Dict[str, object]] = []
        t_start = time.time()
        for epoch in range(self.manifest.current_epoch, plan.epochs + 1):
            self.manifest.current_epoch = epoch
            sampler.set_epoch(epoch)
            loader = PrefetchLoader(
                train_ds, sampler, self.mc.hop_length, require_pitch=True,
                device_put=lambda b: batch_to_device(b, self.device),
                depth=max(cfg.training.data_workers // 2, 2),
            )
            for i, (time_bin, batch, paths) in enumerate(loader):
                if skip_batches > 0:
                    skip_batches -= 1
                    continue
                metrics = self._step_or_skip(step_fn, state, batch, time_bin, table)
                if metrics is None:
                    del batch
                    self._release_after_oom(state)
                    continue
                if debug:
                    self._debug_nanstep(metrics, batch, paths, time_bin, i + 1, out_dir)
                window.append(metrics)
                if self.batches is not None:
                    self.batches.append(paths)
                self.manifest.current_step = i + 1
                self.manifest.current_total_step += 1
                total_step = self.manifest.current_total_step
                if total_step % cfg.training.log_interval == 0:
                    self._log_metrics(window, ctx, total_step,
                                      f"Epoch [{epoch}/{plan.epochs}], "
                                      f"Step [{i + 1}/{steps_per_epoch}] ")
                if total_step % cfg.training.val_interval == 0:
                    self.stage_validation(stage, state, ctx, val_ds, val_bins, table)
                if total_step % cfg.training.save_interval == 0:
                    save_checkpoint(out_dir, state, self.manifest, cfg, self.mc,
                                    self.normalization)
            self.manifest.current_step = 1
        if window:
            self._log_metrics(window, ctx, self.manifest.current_total_step,
                              f"Epoch [{plan.epochs}/{plan.epochs}] ")
        logger.info("stage %s done: %d steps, %.1f s", stage, state.step,
                    time.time() - t_start)
        save_checkpoint(out_dir, state, self.manifest, cfg, self.mc, self.normalization)
        return state

    def _log_metrics(self, window, ctx, total_step, header):
        """Move the window's device scalars to the host in one copy and log
        the means (every step's metrics kept with ``record_steps``)."""
        rows = _metrics_to_host(window)
        window.clear()
        if self.step_metrics is not None:
            self.step_metrics.extend(rows)
        avg = combine_metrics(rows)
        lr = avg.pop("lr", 0.0)
        broadcast(avg, ctx.weights, self.writer, total_step, header=header)
        self.writer.add_scalar("train/lr", lr, total_step)

    @staticmethod
    def _val_chunks(val_bins, table):
        """The validation batches (global segment indices): a bin's full
        planned batch whole where it divides by N, otherwise chunks of N, a
        ragged last chunk dropped (the JAX rule; at N = 1, a ragged bin
        re-chunked to B = 1)."""
        n = parallel.world_size()
        for time_bin, idxs in DynamicBatchSampler(
            val_bins, table, shuffle=False, drop_last=False,
        ):
            planned = table.get(time_bin)
            if len(idxs) == planned and planned % n == 0:
                yield idxs
            else:
                yield from (idxs[i:i + n] for i in range(0, len(idxs) - n + 1, n))

    def stage_validation(self, stage, state, ctx, val_ds, val_bins, table):
        """The stage's validator (``validate.VALIDATORS``) over the val split
        at the planned batch sizes (``_val_chunks``); the logged metrics are
        the means of the batch means, and the eval samples' predicted audio
        (gathered to rank 0 from the ranks that hold them) is written as wav
        files, their log-mel figures to TensorBoard. Updates
        ``manifest.best_loss``."""
        step = self.manifest.current_total_step
        sample_paths = set(select_validation_samples(
            [s.wav_path for s in val_ds.segments],
            self.config.validation.sample_count,
            self.config.validation.force_samples,
        ))
        metrics_acc = []
        for chunk in self._val_chunks(val_bins, table):
            items = [val_ds.load_segment(j) for j in parallel.shard_rows(chunk)]
            batch, _ = collate_batch(items, hop_length=self.mc.hop_length,
                                     require_pitch=True)
            batch = batch_to_device(batch, self.device)
            m, audio = VALIDATORS[stage](state, ctx, batch)
            metrics_acc.append(m)
            paths = [val_ds.segments[j].wav_path for j in chunk]
            if not sample_paths.intersection(paths):
                continue
            with torch.no_grad():
                audio, audio_gt = parallel.gather_rows(audio), parallel.gather_rows(batch.audio_gt)
            if not parallel.is_writer():
                continue
            for bi, p in enumerate(paths):
                if p in sample_paths:
                    self.writer.add_audio(f"eval/{p}", audio[bi].float().cpu().numpy(),
                                          step, self.mc.sample_rate)
                    self._emit_mel_figures(p, audio_gt[bi], audio[bi], step)
        if not metrics_acc:
            return {}
        avg = self._mean_of_batch_means(metrics_acc)
        total = broadcast(avg, ctx.weights, self.writer, step, prefix="eval",
                          header=f"Validation step {step}: ")
        if total < self.manifest.best_loss:
            self.manifest.best_loss = total
        self.validations.append({"stage": stage, "step": step,
                                 "batches": len(metrics_acc), **avg})
        return avg

    def _emit_mel_figures(self, path, audio_gt, audio, step):
        """Log-mel spectrograms of one eval sample's ground truth and
        prediction, and their signed difference (reference
        stage.py:250-401), under ``eval/<path>/mel_{gt,pred,diff}``."""
        from ..utils.plotting import plot_signed_difference_figure, plot_spectrogram_figure

        to_mel = MelSpectrogram(
            n_mels=self.mc.n_mels, n_fft=self.mc.n_fft, win_length=self.mc.win_length,
            hop_length=self.mc.hop_length, sample_rate=self.mc.sample_rate)
        with torch.no_grad():
            gt, pr = (np.log(1e-5 + to_mel(torch.as_tensor(a, device=audio.device)[None]
                                           .float()).cpu().numpy())[0]
                      for a in (audio_gt, audio))
        self.writer.add_figure(f"eval/{path}/mel_gt", plot_spectrogram_figure(gt, "GT"), step)
        self.writer.add_figure(f"eval/{path}/mel_pred", plot_spectrogram_figure(pr, "pred"),
                               step)
        self.writer.add_figure(f"eval/{path}/mel_diff",
                               plot_signed_difference_figure(gt, pr, "pred-GT"), step)

    @staticmethod
    def _mean_of_batch_means(metrics_acc) -> Dict[str, float]:
        """Per key, the mean of the batches' device scalars, averaged over
        the ranks (one collective, one host copy)."""
        keys = sorted(metrics_acc[0])
        packed = parallel.all_mean(torch.stack([torch.stack([m[k].float() for k in keys])
                                                for m in metrics_acc]))
        return combine_metrics(
            [dict(zip(keys, map(float, row))) for row in packed.cpu().numpy()])

    def _log_window(self, window, ctx, total_step, epoch, epochs, i,
                    steps_per_epoch):
        """Move the window's device scalars to the host in one copy, log the
        average, and keep every align_loss."""
        rows = _metrics_to_host(window)
        losses = [r["align_loss"] for r in rows]
        if self.losses is not None:
            self.losses.extend(losses)
        lr = rows[-1]["lr"]
        window.clear()
        broadcast(
            {"align_loss": float(np.mean(losses))}, ctx.weights, self.writer, total_step,
            header=f"Epoch [{epoch}/{epochs}], Step [{i}/{steps_per_epoch}] ",
        )
        self.writer.add_scalar("train/lr", lr, total_step)

    # ---- validation ------------------------------------------------------

    def validate(self, state, ctx, val_ds, val_bins, table) -> Dict[str, float]:
        """CTC loss and forced-align confidence over the val split, at the
        stage's planned batch sizes (``_val_chunks``). The logged metric is
        the mean of the batch means. Updates ``manifest.best_loss``."""
        metrics_acc = []
        for chunk in self._val_chunks(val_bins, table):
            items = [val_ds.load_segment(j) for j in parallel.shard_rows(chunk)]
            batch, _ = collate_batch(
                items, hop_length=self.mc.hop_length, require_pitch=False,
            )
            metrics_acc.append(validate_alignment(
                state, ctx, batch_to_device(batch, self.device)))
        if not metrics_acc:
            return {}
        avg = self._mean_of_batch_means(metrics_acc)
        step = self.manifest.current_total_step
        total = broadcast(avg, ctx.weights, self.writer, step, prefix="eval",
                          header=f"Validation step {step}: ")
        if total < self.manifest.best_loss:
            self.manifest.best_loss = total
        self.validations.append({"stage": "alignment", "step": step,
                                 "batches": len(metrics_acc), **avg})
        return avg
