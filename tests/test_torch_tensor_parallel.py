"""The four training steps on the port's 2-D and hybrid meshes
(``stylish_tts_torch/parallel/sharding_rules.py``) against one process and
against the JAX package's meshes, on the CPU.

Each case runs in gloo processes on a ``FileStore`` under the test's
``tmp_path`` (``test_torch_dp_common.run_ranks``; the cases are in
``tests/test_torch_tp_common.py``), joined under 120 s and killed past it.
Every rank and the one-process reference build the same weights from seeds
and files and see the same global batches (B = 4), each rank the rows of
its joint data rank.

* The alignment step (2 steps, the epoch's prior update, 2 steps) on a 2 x 2
  mesh and on a (2, 1, 2) hybrid mesh of 4 ranks against one process:
  losses rtol 1e-5, weights atol 1e-6, priors atol 1e-5 (the tolerances of
  tests/test_torch_parallel.py); and against JAX ``jit_2d_parallel_step``
  on ``make_2d_mesh(2, 2)`` and ``jit_hybrid_parallel_step`` on
  ``make_hybrid_mesh(2, 1, 2)`` over 4 of the CPU devices that
  ``conftest.py`` provides, at that file's JAX tolerances (losses rtol
  1e-4, weights atol 1e-5, priors atol 1e-5).
* One fp32 acoustic step at ``small_model_config()`` (the parity switches,
  MRD 1) on the 2 x 2 and the (2, 1, 2) meshes, one textual and one
  duration step on the 2 x 2 mesh, and one acoustic step of the ringformer
  generator (tests/test_torch_ringformer_step.py's config) on a 1 x 2 mesh,
  against one process: metrics rtol 1e-4,
  and each trained module's weights within 0.05 of its move (L2), as
  tests/test_torch_parallel.py holds the data-parallel acoustic step. The
  textual and duration steps are not run on the hybrid mesh: it adds no
  collective that the acoustic step does not run there.
* Dropout on at 1 x 2 (the aligner's, and the duration stage's text
  encoder, cross attention with its head-sliced mask, DropPath and channel
  dropout) against one process: the ranks of a model group draw what one
  process draws, each taking its slice.
* A NaN put into model rank 1's shard of a gradient makes every rank skip
  that update (AdamW's step count one short on both ranks).
* Model size 1 (a 2 x 1 mesh) is bitwise the data-parallel path without a
  mesh (each rank its ``shard_rows``).
* Sharded parameters and their AdamW moments are held as shards: each one's
  local numel is 1 / model of the full; ``gather_state`` after the steps is
  the one-process state within the tolerances above, on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.models.text_aligner import TextAligner as JaxAligner
from stylish_tts_tpu.parallel.sharding_rules import (
    jit_2d_parallel_step,
    jit_hybrid_parallel_step,
    make_2d_mesh,
    make_hybrid_mesh,
    state_shardings,
)
from stylish_tts_tpu.trainer import steps as jsteps
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.state import create_train_state as jax_state
from stylish_tts_torch.convert.from_jax import text_aligner_from_jax
from test_torch_dp_common import (
    ALIGN_BASE_LR,
    ALIGN_HIDDEN,
    ALIGN_STAGE_STEPS,
    Ranks,
    align_batch,
)
from test_torch_ringformer_step import ringformer_config
from test_torch_synth_common import port_config
from test_torch_tp_common import ALIGN_STEPS, PRIORS
from test_train_steps import small_model_config

MESH_2D, HYBRID = [2, 2], [2, 1, 2]
STAGE_MODULES = {
    "acoustic": ("speech_predictor", "speech_style_encoder"),
    "ringformer": ("speech_predictor", "speech_style_encoder"),
    "textual": ("pitch_energy_predictor", "pe_style_encoder"),
    "duration": ("duration_predictor", "duration_style_encoder"),
}


def _world(mesh):
    return int(np.prod(mesh)) if mesh else 0


@pytest.fixture(scope="module")
def align(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_align")
    params = JaxAligner(hidden_dim=ALIGN_HIDDEN, dropout=0.0).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)), jnp.full((1,), 16, jnp.int32))
    torch.save(text_aligner_from_jax(jax.tree.map(np.asarray, params)), tmp / "init.pt")
    init = str(tmp / "init.pt")
    runs = {
        "one": (None, {}), "2d": (MESH_2D, {}), "hybrid": (HYBRID, {}),
        "one_dropout": (None, {"dropout": 0.1}), "1x2_dropout": ([1, 2], {"dropout": 0.1}),
        "nan": ([1, 2], {"nan": True}),
        "2x1": ([2, 1], {}), "dp2": ("dp2", {}),
    }
    started = {}
    for tag, (mesh, extra) in runs.items():
        world = 2 if mesh == "dp2" else _world(mesh)
        args = {"init": init, **({"mesh": mesh} if mesh and mesh != "dp2" else {}), **extra}
        started[tag] = Ranks("tp_align", world, tmp, args, tag=tag)
    return params, {tag: r.results() for tag, r in started.items()}


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_stages")
    path, ring = tmp / "model_config.json", tmp / "ringformer.json"
    path.write_text(port_config(small_model_config()).model_dump_json())
    ring.write_text(port_config(ringformer_config()).model_dump_json())
    mc = {"model_config": str(path)}
    runs = {
        ("ringformer", "one"): (None, {"model_config": str(ring)}),
        ("ringformer", "1x2"): ([1, 2], {"model_config": str(ring)}),
        ("acoustic", "one"): (None, {}), ("acoustic", "2d"): (MESH_2D, {}),
        ("acoustic", "hybrid"): (HYBRID, {}),
        ("textual", "one"): (None, {}), ("textual", "2d"): (MESH_2D, {}),
        ("duration", "one"): (None, {}), ("duration", "2d"): (MESH_2D, {}),
        ("duration", "one_dropout"): (None, {"dropout": True}),
        ("duration", "1x2_dropout"): ([1, 2], {"dropout": True}),
    }
    started = {key: Ranks(f"tp_{key[0].replace('ringformer', 'acoustic')}", _world(mesh), tmp,
                          {**mc, **({"mesh": mesh} if mesh else {}), **extra},
                          tag=f"{key[0]}_{key[1]}")
               for key, (mesh, extra) in runs.items()}
    return {key: r.results() for key, r in started.items()}


def _assert_state_close(got, ref, atol, what):
    for name, sd in ref["params"].items():
        for k, v in sd.items():
            np.testing.assert_allclose(got["params"][name][k].numpy(), v.numpy(), atol=atol,
                                       err_msg=f"{what} {name}.{k}")


def _assert_ranks_alike(ranks):
    for other in ranks[1:]:
        assert other["metrics"] == ranks[0]["metrics"]
        for name, sd in ranks[0]["state"]["params"].items():
            for k, v in sd.items():
                assert torch.equal(other["state"]["params"][name][k], v), (name, k)


def _assert_shards(ranks, model):
    """Each sharded parameter (and its AdamW moments) is held as 1 / model
    of the full tensor."""
    local, state = ranks[0]["local"], ranks[0]["state"]
    assert local, "nothing is sharded"
    moments = 0
    for key, (numel, _) in local.items():
        name, _, k = key.partition("/")
        assert numel * model == state["params"][name][k].numel(), key
        for m in ("exp_avg", "exp_avg_sq"):  # a module the stage trains
            if k in state[m][name]:
                assert state[m][name][k].numel() == numel * model, (key, m)
                moments += 1
    assert moments


@pytest.mark.parametrize("mesh", ["2d", "hybrid"])
def test_alignment_on_the_mesh_matches_one_process(align, mesh):
    _, runs = align
    (one,), ranks = runs["one"], runs[mesh]
    _assert_ranks_alike(ranks)
    _assert_shards(ranks, 2)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], one["metrics"], rtol=1e-5)
        _assert_state_close(r["state"], one["state"], 1e-6, mesh)
        for k in PRIORS:
            np.testing.assert_allclose(r[k].numpy(), one[k].numpy(), atol=1e-5, err_msg=k)
        assert float(r["prior_count"]) == float(one["prior_count"]) > 0
    # the model axis ran: partial products summed over it
    assert ranks[0]["collectives"]["model"] > 0


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX alignment step on its 2-D and hybrid meshes over 4 CPU
    devices, from the same weights and batches (jitted once per mesh)."""
    params = JaxAligner(hidden_dim=ALIGN_HIDDEN, dropout=0.0).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)), jnp.full((1,), 16, jnp.int32))
    mc = JaxModelConfig()
    ctx = jsteps.StepContext(
        {"text_aligner": JaxAligner(hidden_dim=ALIGN_HIDDEN, dropout=0.0)}, mc,
        {"align_loss": 1.0}, JaxNorm(), stage_steps=ALIGN_STAGE_STEPS, base_lr=ALIGN_BASE_LR)
    fn = jsteps.make_alignment_step(ctx, use_pallas=False)
    devices = jax.devices()[:4]
    out = {}
    for name, mesh, wrap in (("2d", make_2d_mesh(2, 2, devices), jit_2d_parallel_step),
                             ("hybrid", make_hybrid_mesh(2, 1, 2, devices),
                              jit_hybrid_parallel_step)):
        state = jax_state({"text_aligner": params}, mc.text_encoder.tokens + 1)
        state = jax.device_put(state, state_shardings(state, mesh))
        step = wrap(fn, state, mesh)
        losses = []
        for i in range(ALIGN_STEPS):
            if i == ALIGN_STEPS // 2:
                state = jsteps.finish_alignment_epoch(ctx, state)
            state, m = step(state, jsteps.Batch(*map(jnp.asarray, align_batch(10 + i))))
            losses.append(float(m["align_loss"]))
        out[name] = (losses, state)
    return out


@pytest.mark.parametrize("mesh", ["2d", "hybrid"])
def test_alignment_on_the_mesh_matches_the_jax_mesh(align, jax_runs, mesh):
    _, runs = align
    losses, jstate = jax_runs[mesh]
    ref = text_aligner_from_jax(jax.tree.map(np.asarray, jstate.params["text_aligner"]))
    for r in runs[mesh]:
        np.testing.assert_allclose(r["metrics"], losses, rtol=1e-4)
        for k, v in ref.items():
            np.testing.assert_allclose(r["state"]["params"]["text_aligner"][k].numpy(),
                                       v.numpy(), atol=1e-5, err_msg=k)
        for k in PRIORS:
            np.testing.assert_allclose(r[k].numpy(), np.asarray(getattr(jstate, k)), atol=1e-5,
                                       err_msg=k)


def test_alignment_dropout_on_a_model_axis_matches_one_process(align):
    _, runs = align
    (one,), ranks = runs["one_dropout"], runs["1x2_dropout"]
    assert one["metrics"] != runs["one"][0]["metrics"]  # the dropout drew
    _assert_ranks_alike(ranks)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], one["metrics"], rtol=1e-5)
        _assert_state_close(r["state"], one["state"], 1e-6, "dropout")


def test_a_nan_in_one_shard_skips_the_update_on_every_rank(align):
    _, runs = align
    ranks = runs["nan"]
    assert [r["adam_steps"] for r in ranks] == [ALIGN_STEPS - 1] * 2
    assert runs["one"][0]["adam_steps"] == ALIGN_STEPS
    _assert_ranks_alike(ranks)
    assert all(np.isfinite(ranks[0]["metrics"]))


def test_model_size_one_is_bitwise_the_data_parallel_path(align):
    _, runs = align
    for mesh_rank, dp_rank in zip(runs["2x1"], runs["dp2"]):
        assert mesh_rank["metrics"] == dp_rank["metrics"]
        assert not mesh_rank["local"]
        for name, sd in dp_rank["state"]["params"].items():
            for k, v in sd.items():
                assert torch.equal(mesh_rank["state"]["params"][name][k], v), (name, k)
        for k in PRIORS:
            assert torch.equal(mesh_rank[k], dp_rank[k]), k
        assert mesh_rank["collectives"]["model"] == 0


def _l2(a, b, keys):
    return float(torch.linalg.vector_norm(torch.cat([(a[k] - b[k]).reshape(-1) for k in keys])))


@pytest.mark.parametrize("stage,mesh", [("acoustic", "2d"), ("acoustic", "hybrid"),
                                        ("textual", "2d"), ("duration", "2d"),
                                        ("ringformer", "1x2")])
def test_stage_step_on_the_mesh_matches_one_process(stages, stage, mesh):
    (one,), ranks = stages[(stage, "one")], stages[(stage, mesh)]
    _assert_shards(ranks, 2)
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in one["metrics"][0].items():
            assert r["metrics"][0][k] == pytest.approx(v, rel=1e-4), k
        for name in STAGE_MODULES[stage]:
            ref, got = one["state"]["params"][name], r["state"]["params"][name]
            keys = sorted(ref)
            move = _l2(ref, one["initial"][name], keys)
            assert _l2(got, ref, keys) <= 0.05 * move, name


def test_duration_dropout_on_a_model_axis_matches_one_process(stages):
    (one,), ranks = stages[("duration", "one_dropout")], stages[("duration", "1x2_dropout")]
    assert one["metrics"] != stages[("duration", "one")][0]["metrics"]  # the dropout drew
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in one["metrics"][0].items():
            assert r["metrics"][0][k] == pytest.approx(v, rel=1e-4), k
        for name in STAGE_MODULES["duration"]:
            ref, got = one["state"]["params"][name], r["state"]["params"][name]
            keys = sorted(ref)
            assert _l2(got, ref, keys) <= 0.05 * _l2(ref, one["initial"][name], keys), name
