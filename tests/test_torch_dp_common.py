"""Shared set-up of the data-parallel tests (``tests/test_torch_parallel.py``).

``Ranks`` (``run_ranks``) runs one case of this file as a script in N
processes, each
a rank of a gloo process group on a ``FileStore`` under the test's
``tmp_path`` (never a fixed port: the suite runs under ``-n 6``), or in one
process without a process group (``world=0``). The processes import torch
and the port only, never JAX; they write their results with
``torch.save`` and the test reads them back. Each run is joined under
``TIMEOUT_S`` and killed past it, so that a test fails rather than hangs.

The cases build everything from numpy seeds and files the test writes, so
that every rank and the one-process reference see the same weights and the
same global batches; each rank takes its rows with ``parallel.shard_rows``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
ALIGN_HIDDEN, ALIGN_BASE_LR, ALIGN_STAGE_STEPS = 48, 1e-4, 40
ACOUSTIC_STEPS, ACOUSTIC_FORCED = 2, 1
L_TEXT, F_FRAMES, HOP = 10, 40, 300


class Ranks:
    """``case`` running in ``world`` rank processes (0: one process, no
    process group), started at construction; ``results()`` joins them."""

    def __init__(self, case: str, world: int, tmp_path: Path, args: dict | None = None,
                 tag: str | None = None):
        self.case, self.world = case, world
        self.work = Path(tmp_path) / (tag or f"{case}_{world}")
        self.work.mkdir(parents=True, exist_ok=True)
        args_path = self.work / "args.json"
        args_path.write_text(json.dumps(args or {}), encoding="utf-8")
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}
        env.pop("WORLD_SIZE", None)
        self.procs, self.outs = [], []
        for rank in range(max(world, 1)):
            log = open(self.work / f"rank{rank}.log", "w", encoding="utf-8")
            out = self.work / f"rank{rank}.pt"
            self.procs.append((subprocess.Popen(
                [sys.executable, __file__, case, str(rank), str(world),
                 str(self.work / "store"), str(args_path), str(out)],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(self.work)), log))
            self.outs.append(out)

    def results(self) -> list:
        """Each rank's result; raises where a rank failed or outlived
        ``TIMEOUT_S`` (all are killed then)."""
        failed = []
        try:
            for rank, (proc, _) in enumerate(self.procs):
                if proc.wait(timeout=TIMEOUT_S) != 0:
                    failed.append(rank)
        except subprocess.TimeoutExpired:
            failed.append("timeout")
        finally:
            for proc, log in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        if failed:
            logs = "\n".join((self.work / f"rank{r}.log").read_text(encoding="utf-8")[-3000:]
                             for r in range(len(self.procs)))
            raise AssertionError(f"{self.case} at world {self.world}: ranks {failed} "
                                 f"failed\n{logs}")
        return [torch.load(o, weights_only=False) for o in self.outs]


def run_ranks(case: str, world: int, tmp_path: Path, args: dict | None = None,
              tag: str | None = None) -> list:
    """``Ranks(...).results()``."""
    return Ranks(case, world, tmp_path, args, tag).results()


# ---------------------------------------------------------------- batches


def align_batch(seed: int, b: int = 4, frames: int = 40, text_len: int = 16, hop: int = HOP):
    """A global alignment batch (audio, text, lengths, pitch, durations)."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames * hop) / 24000.0
    audio = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (b, 1)) * t)
             + 0.05 * rng.standard_normal((b, frames * hop))).astype(np.float32)
    text = rng.integers(1, 178, (b, text_len)).astype(np.int32)
    lengths = np.array([12, 9, 14, 7][:b], np.int32)
    for i in range(b):
        text[i, lengths[i]:] = 0
    return (audio, text, lengths, np.zeros((b, frames), np.float32),
            np.zeros((b, text_len), np.int32))


def acoustic_batch(seed: int, b: int = 4):
    """A global acoustic batch at ``small_model_config()``'s shapes."""
    rng = np.random.default_rng(seed)
    tt = np.arange(F_FRAMES * HOP) / 24000.0
    f0 = rng.uniform(100, 220, (b, 1))
    audio = 0.3 * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.standard_normal((b, F_FRAMES * HOP))
    text = rng.integers(1, 170, (b, L_TEXT))
    lengths = np.array([L_TEXT, L_TEXT - 3, L_TEXT - 1, L_TEXT - 5][:b])
    pitch = rng.uniform(90, 250, (b, F_FRAMES))
    pitch[:, 5:8] = 0.0
    durs = np.full((b, L_TEXT), F_FRAMES // L_TEXT)
    durs[:, 0] += F_FRAMES - durs.sum(1)
    return (audio.astype(np.float32), text.astype(np.int32), lengths.astype(np.int32),
            pitch.astype(np.float32), durs.astype(np.int32))


def acoustic_prior(b: int = 4) -> np.ndarray:
    return np.tanh(np.random.default_rng(5).standard_normal((b, F_FRAMES * HOP)) * 0.3
                   ).astype(np.float32)


def loss_inputs(seed: int = 3, b: int = 4) -> dict:
    """Score heads (real, fake) near the TPRLS scale and spectra (target,
    prediction) of a global batch, float32."""
    rng = np.random.default_rng(seed)
    heads = [(b, 1, 6, 5), (b, 1, 4, 7), (b, 40)]
    real = [(0.5 + 0.1 * rng.standard_normal(s)).astype(np.float32) for s in heads]
    fake = [(0.4 + 0.1 * rng.standard_normal(s)).astype(np.float32) for s in heads]
    spec_t = [np.abs(rng.standard_normal((b, n, 12))).astype(np.float32) for n in (20, 32)]
    spec_p = [(t + 0.2 * rng.standard_normal(t.shape)).astype(np.float32) for t in spec_t]
    return {"real": real, "fake": fake, "target": spec_t, "pred": spec_p}


# ---------------------------------------------------------------- cases


def _rows(arrays):
    from stylish_tts_torch import parallel

    idx = parallel.shard_rows(np.arange(arrays[0].shape[0]))
    return [None if a is None else a[idx] for a in arrays]


def case_align(args):
    """3 alignment steps, the epoch's prior update, 2 more (the JAX test's
    schedule) on the global batches of ``align_batch``."""
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.models.text_aligner import TextAligner
    from stylish_tts_torch.trainer import steps as tsteps
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.state import create_train_state

    aligner = TextAligner(hidden_dim=ALIGN_HIDDEN, dropout=0.0)
    aligner.load_state_dict(torch.load(args["init"], weights_only=True))
    ctx = tsteps.StepContext(ModelConfig(), {"align_loss": 1.0}, NormalizationStats(),
                             stage_steps=ALIGN_STAGE_STEPS, base_lr=ALIGN_BASE_LR)
    step = tsteps.make_alignment_step(ctx)
    state = create_train_state(aligner, 179, "cpu")
    losses = []
    for i in range(5):
        if i == 3:
            state = tsteps.finish_alignment_epoch(ctx, state)
        batch = tsteps.Batch(*(torch.from_numpy(x) for x in _rows(align_batch(10 + i))))
        losses.append(float(step(state, batch)["align_loss"]))
    return {"losses": losses, "params": aligner.state_dict(),
            **{k: getattr(state, k) for k in ("log_priors", "log_priors_sum", "prior_count")}}


def case_acoustic(args):
    """``ACOUSTIC_STEPS`` fp32 acoustic steps at the config of
    ``args["model_config"]`` with the parity switches, seeded weights."""
    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models import build_models
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.state import create_stage_train_state
    from stylish_tts_torch.trainer.steps import Batch, StepContext, make_acoustic_step

    mc = ModelConfig.model_validate_json(Path(args["model_config"]).read_text())
    # the native CPU convolution computes each row alone, so that a row's
    # scores are bitwise the same in a batch of 2 and of 4 (oneDNN's blocking
    # depends on the batch): the TPRLS median then picks the same element,
    # whose gradient is the sum of all the others'
    torch.backends.mkldnn.enabled = False
    torch.manual_seed(0)
    state = create_stage_train_state(build_models(mc), "cpu", "acoustic")
    prior = torch.from_numpy(_rows([acoustic_prior()])[0])
    ctx = StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                      stage_steps=50, base_lr=1e-4, parity_deterministic=True,
                      parity_prior=prior, forced_disc_index=ACOUSTIC_FORCED)
    step = make_acoustic_step(ctx)
    names = ("speech_predictor", "speech_style_encoder", f"mrd{ACOUSTIC_FORCED}", "disc")
    initial = {n: {k: v.clone() for k, v in state.models[n].state_dict().items()}
               for n in names}
    metrics, first = [], None
    for s in range(ACOUSTIC_STEPS):
        batch = Batch(*(torch.from_numpy(x) for x in _rows(acoustic_batch(s))))
        metrics.append({k: float(v) for k, v in step(state, batch).items()})
        if first is None:
            first = {n: {k: v.clone() for k, v in state.models[n].state_dict().items()}
                     for n in names}
    return {"metrics": metrics, "initial": initial, "first": first,
            "weights": {n: state.models[n].state_dict() for n in names}}


def case_losses(args):
    """The pair losses and spectral convergence on this rank's rows, with
    the gradients with respect to its inputs."""
    from stylish_tts_torch import losses as L

    raw = np.load(args["inputs"])
    ins = {k: [torch.from_numpy(a).requires_grad_(True)
               for a in _rows([raw[f"{k}{i}"] for i in range(int(raw[f"n_{k}"]))])]
           for k in ("real", "fake", "target", "pred")}
    out = {}
    for name, fn, wrt in (
            ("disc", lambda: L.discriminator_pair_loss(ins["real"], ins["fake"])[0],
             ("real", "fake")),
            ("disc_raw", lambda: L.discriminator_pair_loss(ins["real"], ins["fake"])[1],
             ("real", "fake")),
            ("gen", lambda: L.generator_pair_loss(ins["real"], ins["fake"]), ("real", "fake")),
            ("sc", lambda: L.spectral_convergence_loss(ins["target"], ins["pred"]), ("pred",))):
        value = fn()
        grads = torch.autograd.grad(value, [x for k in wrt for x in ins[k]])
        out[name] = {"value": float(value), "grads": [g.numpy() for g in grads]}
    return out


def case_train_align(args):
    """``train-align`` through the CLI in-process (``args["cli"]``), with an
    out-of-memory failure injected on rank ``args["oom_rank"]``'s first step
    (``args["oom_at"]``: "start", before the step; "ctc", inside it after the
    aligner's forward); records which rank wrote checkpoints."""
    from stylish_tts_torch import parallel
    from stylish_tts_torch.cli import train_cli
    from stylish_tts_torch.trainer import checkpoint as ckpt_mod
    from stylish_tts_torch.trainer import loop as loop_mod
    from stylish_tts_torch.trainer import steps as steps_mod

    writes = []
    real_write = ckpt_mod._write_checkpoint

    def write(path, *a, **k):
        writes.append(os.path.basename(path))
        return real_write(path, *a, **k)

    ckpt_mod._write_checkpoint = write
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    if args.get("oom_rank") == parallel.rank():
        calls = []
        if args["oom_at"] == "start":
            real_factory = loop_mod.make_alignment_step

            def make(ctx):
                real = real_factory(ctx)

                def step(state, batch):
                    calls.append(1)
                    if len(calls) == 1:
                        raise oom
                    return real(state, batch)
                return step

            loop_mod.make_alignment_step = make
        else:
            real_ctc = steps_mod.ctc_loss_with_priors_cuda

            def ctc(*a, **k):
                calls.append(1)
                if len(calls) == 1:
                    raise oom
                return real_ctc(*a, **k)

            steps_mod.ctc_loss_with_priors_cuda = ctc
    trainer = train_cli.main(args["cli"], standalone_mode=False)
    table = json.loads((Path(args["cli"][args["cli"].index("--out") + 1]) / "alignment"
                        / "alignment_batch_sizes.json").read_text())
    return {"losses": trainer.losses, "batches": trainer.batches, "writes": writes,
            "manifest": trainer.manifest.__dict__, "validations": trainer.validations,
            "table": table, "step": int(trainer.stage_manifests["alignment"].current_total_step)}


CASES = {"align": case_align, "acoustic": case_acoustic, "losses": case_losses,
         "train_align": case_train_align}


def main(argv) -> int:
    case, rank, world, store, args_path, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from stylish_tts_torch import parallel

    if world:
        parallel.init_data_parallel(backend="gloo", rank=rank, world_size=world,
                                    init_method=f"file://{store}", device="cpu",
                                    timeout_s=TIMEOUT_S / 2)
    try:
        if case not in CASES:  # the tensor-parallel cases
            from test_torch_tp_common import CASES as TP_CASES

            CASES.update(TP_CASES)
        result = CASES[case](json.loads(Path(args_path).read_text(encoding="utf-8")))
        torch.save(result, out)
    finally:
        parallel.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
