"""Shared set-up of the tensor-parallel tests (``tests/test_torch_sharding_rules.py``,
``tests/test_torch_tensor_parallel.py``): the cases that
``test_torch_dp_common.run_ranks`` runs in gloo rank processes.

* ``modules``: each shard-aware class at a small width, built from a seed
  under a holder whose attribute names make the JAX rules match, run in
  this rank unsharded and then sharded over the model axis; the output, the
  input's gradient and every parameter's gradient (the sharded ones
  gathered) of both, from one cotangent.
* ``align``, ``acoustic``, ``textual``, ``duration``: a port step on a mesh
  of ``args["mesh"]`` (``[data, model]`` or ``[slices, data, model]``; absent:
  one process), through ``parallel_2d_step`` / ``parallel_hybrid_step`` on
  the global batches of ``test_torch_dp_common``, with the state gathered
  after (``gather_state``), each sharded parameter's local size, and the
  collectives by axis.
"""

import copy
from pathlib import Path

import numpy as np
import torch
from torch import nn

from test_torch_dp_common import (
    ALIGN_BASE_LR,
    ALIGN_HIDDEN,
    ALIGN_STAGE_STEPS,
    acoustic_batch,
    acoustic_prior,
    align_batch,
)

ALIGN_STEPS = 4  # 2 steps, the epoch's prior update, 2 steps
PRIORS = ("log_priors", "log_priors_sum", "prior_count")


class Holder(nn.Module):
    """Modules under the attribute names the rules match; ``fn(holder, x,
    generator)`` is the forward."""

    def __init__(self, fn, **modules):
        super().__init__()
        self.fn = fn
        for k, m in modules.items():
            self.add_module(k, m)

    def forward(self, x, generator):
        return self.fn(self, x, generator)


def module_cases():
    """name -> (registry name that makes the rules match, holder attribute,
    factory, input shape, forward): small widths, dropout on where the class
    has it."""
    from stylish_tts_torch.models import common as C
    from stylish_tts_torch.models.conformer import ConformerAttention, ConformerFeedForward
    from stylish_tts_torch.models.convnext import AdaptiveConvNeXtBlock, GeneratorConvNeXtBlock
    from stylish_tts_torch.models.style_encoder import MelStyleEncoderCore, ResBlk2d
    from stylish_tts_torch.models.text_aligner import TextAligner
    from stylish_tts_torch.models.text_encoder import ConvFFN, RoPEMultiHeadAttention

    style = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 6)).astype(np.float32))
    mask = torch.ones(2, 1, 9)
    mask[1, :, 6:] = 0.0
    keep = mask[:, 0, :, None] * mask[:, 0, None, :]
    lengths = torch.tensor([9, 6])
    sp = "speech_predictor"
    return {
        "text_aligner": ("text_aligner", "text_aligner", lambda: TextAligner(
            n_mels=5, n_tokens=6, hidden_dim=8, dropout=0.2), (2, 9, 5),
            lambda h, x, g: h.text_aligner(x, lengths, generator=g)),
        "rope_attention_heads_divide": (
            sp, "attn_0", lambda: RoPEMultiHeadAttention(16, 4, 0.3), (2, 16, 9),
            lambda h, x, g: h.attn_0(x, x, keep, g)),
        "rope_attention_heads_do_not_divide": (
            sp, "attn_0", lambda: RoPEMultiHeadAttention(12, 3, 0.3), (2, 12, 9),
            lambda h, x, g: h.attn_0(x, x, keep, g)),
        "conv_ffn": (sp, "ffn_0", lambda: ConvFFN(8, 12, 3, 0.2), (2, 8, 9),
                     lambda h, x, g: h.ffn_0(x, mask, g)),
        "conformer_feed_forward": (sp, "ff1", lambda: ConformerFeedForward(8, 4, 0.2),
                                   (2, 8, 9), lambda h, x, g: h.ff1(x, g)),
        "conformer_attention_to_kv": (sp, "attn", lambda: ConformerAttention(8, 4, 4, 0.2),
                                      (2, 8, 9), lambda h, x, g: h.attn(x, None, g)),
        "conformer_attention_heads_do_not_divide": (
            sp, "attn", lambda: ConformerAttention(8, 3, 4, 0.0), (2, 8, 9),
            lambda h, x, g: h.attn(x, None, g)),
        "generator_convnext_grn": (sp, "block", lambda: GeneratorConvNeXtBlock(8, 16, 6),
                                   (2, 8, 9), lambda h, x, g: h.block(x, style, g)),
        "adaptive_convnext": (sp, "block", lambda: AdaptiveConvNeXtBlock(8, 16, 6, dropout=0.3),
                              (2, 8, 9), lambda h, x, g: h.block(x, style, g)),
        "adaptive_decoder_block_film": (
            sp, "encode", lambda: C.AdaptiveDecoderBlock(6, 8, 6, dropout=0.2), (2, 6, 9),
            lambda h, x, g: h.encode(x, style, g)),
        "adaptive_generator_block": (
            sp, "block", lambda: C.AdaptiveGeneratorBlock(8, 6, 3, (1, 3)), (2, 8, 9),
            lambda h, x, g: h.block(x, style)),
        "resblk2d_spectral_norm": (sp, "res_0", lambda: ResBlk2d(4, 8, "half"), (2, 4, 8, 10),
                                   lambda h, x, g: h.res_0(x)),
        "style_core_post_out": (sp, "core", lambda: MelStyleEncoderCore(4, 6, 8, True),
                                (2, 1, 40, 40), lambda h, x, g: h.core(x)),
    }


def _run_module(holder, x, seed):
    """Forward with dropout drawn from ``seed``, then a backward of a seeded
    cotangent: (output, input gradient, {name: gradient})."""
    x = x.clone().requires_grad_(True)
    g = torch.Generator().manual_seed(seed)
    y = holder(x, g)
    ct = torch.from_numpy(np.random.default_rng(seed).standard_normal(tuple(y.shape))
                          .astype(np.float32))
    (y * ct).sum().backward()
    return y.detach(), x.grad, {k: p.grad for k, p in holder.named_parameters()}


def case_modules(args):
    from stylish_tts_torch import parallel
    from stylish_tts_torch.parallel import sharding_rules as sr

    sr.make_2d_mesh(1, parallel.world_size_global())
    out = {}
    for name, (reg, attr, factory, shape, fn) in module_cases().items():
        torch.manual_seed(0)
        module = factory()
        for p in module.parameters():  # away from the zero / one inits
            with torch.no_grad():
                p.add_(0.1 * torch.randn(p.shape))
        holder = Holder(fn, **{attr: module})
        holder.train()
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
        ref = _run_module(copy.deepcopy(holder), x, seed=3)
        n = sr.shard_module(reg, holder)
        got = _run_module(holder, x, seed=3)
        grads = sr.gather_grads(holder)
        out[name] = {"sharded": n, "ref": ref,
                     "got": (got[0], got[1], {k: grads.get(k) for k in got[2]})}
    return out


# ---------------------------------------------------------------- steps


def _mesh(args):
    """(mesh, step wrapper); without ``args["mesh"]``, the data-parallel path
    (each rank its ``shard_rows``; one process without a group)."""
    from stylish_tts_torch import parallel
    from stylish_tts_torch.parallel import sharding_rules as sr

    shape = args.get("mesh")
    if not shape:
        def rows(step, state, mesh):
            def run(state_, batch):
                idx = parallel.shard_rows(np.arange(batch.text.shape[0]))
                return step(state_, type(batch)(*(None if x is None else x[idx]
                                                  for x in batch)))
            return run
        return None, rows
    if len(shape) == 2:
        return sr.make_2d_mesh(*shape), sr.parallel_2d_step
    return sr.make_hybrid_mesh(*shape), sr.parallel_hybrid_step


def _local_sizes(state):
    from stylish_tts_torch.parallel import sharding_rules as sr

    return {k: (p.numel(), dim) for k, (p, dim) in sr.sharded_parameters(state).items()}


def _finish(state, metrics, extra=None):
    from stylish_tts_torch import parallel
    from stylish_tts_torch.parallel import sharding_rules as sr

    return {"metrics": metrics, "state": sr.gather_state(state),
            "local": _local_sizes(state), "collectives": dict(parallel.COLLECTIVES),
            **(extra or {})}


def case_tp_align(args):
    """``ALIGN_STEPS`` alignment steps (the prior update halfway) on the
    global batches of ``align_batch``; with ``args["nan"]``, a NaN put into
    model rank 1's shard of ``ffn.0.weight``'s gradient at the first step."""
    from stylish_tts_torch import parallel
    from stylish_tts_torch.config import ModelConfig
    from stylish_tts_torch.models.text_aligner import TextAligner
    from stylish_tts_torch.trainer import optim
    from stylish_tts_torch.trainer import steps as tsteps
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.state import create_train_state

    mesh, wrap = _mesh(args)
    aligner = TextAligner(hidden_dim=ALIGN_HIDDEN, dropout=args.get("dropout", 0.0))
    aligner.load_state_dict(torch.load(args["init"], weights_only=True))
    ctx = tsteps.StepContext(ModelConfig(), {"align_loss": 1.0}, NormalizationStats(),
                             stage_steps=ALIGN_STAGE_STEPS, base_lr=ALIGN_BASE_LR)
    state = create_train_state(aligner, 179, "cpu")
    step = wrap(tsteps.make_alignment_step(ctx), state, mesh)
    if args.get("nan"):
        real = optim._finite_flag

        def flag(module):
            p = module.ffn[0].weight
            if p.grad is not None and parallel.model_rank() == 1 and state.step == 0:
                p.grad[0, 0] = float("nan")
            return real(module)

        optim._finite_flag = flag
    losses = []
    for i in range(ALIGN_STEPS):
        if i == ALIGN_STEPS // 2:
            state = tsteps.finish_alignment_epoch(ctx, state)
        batch = tsteps.Batch(*(torch.from_numpy(x) for x in align_batch(10 + i)))
        losses.append(float(step(state, batch)["align_loss"]))
    adam = state.optimizer.state[aligner.ffn[0].weight]
    return _finish(state, losses, {**{k: getattr(state, k) for k in PRIORS},
                                   "adam_steps": int(adam["step"])})


def _stage(args, stage):
    from stylish_tts_torch.config import Config, ModelConfig
    from stylish_tts_torch.models import build_models
    from stylish_tts_torch.models.models import STAGE_TRAIN_MODELS
    from stylish_tts_torch.trainer.normalization import NormalizationStats
    from stylish_tts_torch.trainer.state import create_stage_train_state
    from stylish_tts_torch.trainer import steps as S

    mc = ModelConfig.model_validate_json(Path(args["model_config"]).read_text())
    torch.backends.mkldnn.enabled = False  # each row alone, as test_torch_dp_common
    mesh, wrap = _mesh(args)
    torch.manual_seed(0)
    models = build_models(mc)
    if "init" in args:
        for name, sd in torch.load(args["init"], weights_only=True).items():
            models[name].load_state_dict(sd)
    state = create_stage_train_state(models, "cpu", stage)
    initial = {n: {k: v.detach().clone() for k, v in state.models[n].state_dict().items()}
               for n in STAGE_TRAIN_MODELS[stage]}
    prior = torch.from_numpy(acoustic_prior())
    deterministic = not args.get("dropout", False)
    ctx = S.StepContext(mc, Config().loss_weight.model_dump(), NormalizationStats(),
                        stage_steps=50, base_lr=1e-4, parity_deterministic=deterministic,
                        parity_prior=prior if deterministic else None, forced_disc_index=1)
    if stage == "acoustic":
        step = S.make_acoustic_step(ctx)
    elif stage == "textual":
        step = S.make_textual_step(ctx)
    else:
        weights = torch.ones(mc.duration_predictor.duration_classes)
        step = S.make_duration_step(ctx, weights)
    step = wrap(step, state, mesh)
    if deterministic:  # the injected excitation: this rank's rows
        ctx.parity_prior = prior[_row_slice(prior.shape[0])]
    metrics = []
    for s in range(args.get("steps", 1)):
        batch = S.Batch(*(torch.from_numpy(x) for x in acoustic_batch(s)))
        metrics.append({k: float(v) for k, v in step(state, batch).items()})
    return _finish(state, metrics, {"initial": initial})


def _row_slice(b):
    from stylish_tts_torch import parallel

    k = b // parallel.world_size()
    return slice(parallel.rank() * k, (parallel.rank() + 1) * k)


def case_tp_acoustic(args):
    return _stage(args, "acoustic")


def case_tp_textual(args):
    return _stage(args, "textual")


def case_tp_duration(args):
    return _stage(args, "duration")


CASES = {"modules": case_modules, "tp_align": case_tp_align, "tp_acoustic": case_tp_acoustic,
         "tp_textual": case_tp_textual, "tp_duration": case_tp_duration}
