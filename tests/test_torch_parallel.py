"""Data-parallel training on the port (``stylish_tts_torch/parallel``)
against one process and against the JAX package's data mesh, on the CPU.

Each multi-process case runs in 2 gloo ranks on a ``FileStore`` under the
test's ``tmp_path`` (``test_torch_dp_common.run_ranks``: never a fixed
port, joined under 120 s, killed past it). Every rank and the one-process
reference (no process group) build the same weights from seeds and files,
and see the same global batches, each rank its rows.

* The alignment step (3 steps, the epoch's prior update, 2 steps; B = 4,
  2 rows a rank): 2 ranks against 1 process on the whole batch, losses
  rtol 1e-5, weights atol 1e-6, priors atol 1e-5 (float32 sums in another
  order: the CTC mean and the label priors' log-sum-exp merge across
  ranks); and against JAX ``jit_data_parallel_step(make_alignment_step)``
  on a mesh of 2 of its CPU devices at tests/test_torch_align_step.py's
  tolerances (losses rtol 1e-4, weights atol 1e-5, priors atol 1e-5).
* The fp32 acoustic step at ``small_model_config()`` with the parity
  switches and a fixed MRD (B = 4, 2 steps): 2 ranks against 1 process,
  metrics rtol 1e-4 (measured: 1e-6), and each module's weights after the
  first step within 0.05 of its move (L2; measured: 0.016), the
  tolerance of tests/test_torch_acoustic_step.py: AdamW's first step moves
  an element by lr x sign(g), and the few elements whose gradient is at
  the float32 noise of its sum can take either sign. The native CPU
  convolution computes each row alone (oneDNN's blocking depends on the
  batch), so a row's scores are the same at B = 2 and 4: the TPRLS median
  then picks the same element, whose gradient is the sum of all the
  others' (with oneDNN the MRD's gradient moved by 23 % between the two
  runs from that alone). After the first step those sign flips reach the
  medians too, so later weights are not compared.
* ``discriminator_pair_loss``, ``generator_pair_loss`` and
  ``spectral_convergence_loss`` over 2 ranks against JAX's on the
  concatenated inputs (every global size is even with 2 equal shares, so
  the TPRLS lower median is the lower of the two middle values): values and
  gradients rtol 1e-5. A rank's local gradient is N times its share of the
  global loss's (the convention ``parallel.pmean_grads`` divides back), so
  the test halves it.
* An out-of-memory failure on one rank only (before its step, or inside it
  after the aligner's forward): both ranks skip the batch and lower the same
  bin (4 -> 3 by the 0.9 rule, rounded down to 2, a multiple of the world
  size), and their runs stay step for step alike.
* ``train-align`` at 2 ranks: rank 0 alone writes the checkpoints (with
  both ranks' generator states), a resumed 2-rank run equals the
  uninterrupted one bitwise (tests/test_torch_checkpoint.py's tolerance),
  and a 2-rank checkpoint resumed in one process re-derives the generators
  and logs that it did.
* A process group of world size 1 is bitwise the path without one (the
  alignment and the acoustic steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fixtures import make_micro_dataset
from stylish_tts_tpu import losses as jl
from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.models.text_aligner import TextAligner as JaxAligner
from stylish_tts_tpu.parallel.mesh import jit_data_parallel_step, make_mesh
from stylish_tts_tpu.trainer import steps as jsteps
from stylish_tts_tpu.trainer.normalization import NormalizationStats as JaxNorm
from stylish_tts_tpu.trainer.state import create_train_state as jax_state
from stylish_tts_torch.convert.from_jax import text_aligner_from_jax
from stylish_tts_torch.trainer.checkpoint import STATE_FILE, checkpoint_dir_name
from test_torch_dp_common import (
    ALIGN_BASE_LR,
    ALIGN_HIDDEN,
    ALIGN_STAGE_STEPS,
    Ranks,
    align_batch,
    loss_inputs,
    run_ranks,
)
from test_torch_synth_common import port_config
from test_train_steps import small_model_config

PRIORS = ("log_priors", "log_priors_sum", "prior_count")


@pytest.fixture(scope="module")
def align(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_align")
    params = JaxAligner(hidden_dim=ALIGN_HIDDEN, dropout=0.0).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)), jnp.full((1,), 16, jnp.int32))
    torch.save(text_aligner_from_jax(jax.tree.map(np.asarray, params)), tmp / "init.pt")
    runs = {w: Ranks("align", w, tmp, {"init": str(tmp / "init.pt")}) for w in (0, 1, 2)}
    return params, {w: r.results() for w, r in runs.items()}


def _assert_ranks_alike(results):
    """Every rank of a run ends with the same losses, weights and priors."""
    first = results[0]
    for other in results[1:]:
        assert other["losses"] == first["losses"]
        for k, v in first["params"].items():
            assert torch.equal(other["params"][k], v), k
        for k in PRIORS:
            assert torch.equal(other[k], first[k]), k


def test_alignment_two_ranks_match_one_process(align):
    _, runs = align
    _assert_ranks_alike(runs[2])
    one, two = runs[0][0], runs[2][0]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    for k, v in one["params"].items():
        np.testing.assert_allclose(two["params"][k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    for k in PRIORS:
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(), atol=1e-5, err_msg=k)
    assert float(two["prior_count"]) == float(one["prior_count"]) > 0


def test_alignment_two_ranks_match_the_jax_data_mesh(align):
    params, runs = align
    mc = JaxModelConfig()
    jctx = jsteps.StepContext(
        {"text_aligner": JaxAligner(hidden_dim=ALIGN_HIDDEN, dropout=0.0)}, mc,
        {"align_loss": 1.0}, JaxNorm(), stage_steps=ALIGN_STAGE_STEPS, base_lr=ALIGN_BASE_LR)
    mesh = make_mesh(jax.devices()[:2])
    jstep = jit_data_parallel_step(jsteps.make_alignment_step(jctx, use_pallas=False), mesh,
                                   donate_state=False)
    jstate = jax_state({"text_aligner": params}, mc.text_encoder.tokens + 1)
    losses = []
    for i in range(5):
        if i == 3:
            jstate = jsteps.finish_alignment_epoch(jctx, jstate)
        jstate, m = jstep(jstate, jsteps.Batch(*map(jnp.asarray, align_batch(10 + i))))
        losses.append(float(m["align_loss"]))
    two = runs[2][0]
    np.testing.assert_allclose(two["losses"], losses, rtol=1e-4)
    ref = text_aligner_from_jax(jax.tree.map(np.asarray, jstate.params["text_aligner"]))
    for k, v in ref.items():
        np.testing.assert_allclose(two["params"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    for k in PRIORS:
        np.testing.assert_allclose(two[k].numpy(), np.asarray(getattr(jstate, k)), atol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def acoustic(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_acoustic")
    path = tmp / "model_config.json"
    path.write_text(port_config(small_model_config()).model_dump_json())
    runs = {w: Ranks("acoustic", w, tmp, {"model_config": str(path)}) for w in (0, 1, 2)}
    return {w: r.results() for w, r in runs.items()}


def test_acoustic_two_ranks_match_one_process(acoustic):
    (one,), two = acoustic[0], acoustic[2]
    assert two[0]["metrics"] == two[1]["metrics"]
    for s, (m1, m2) in enumerate(zip(one["metrics"], two[0]["metrics"])):
        assert sorted(m1) == sorted(m2)
        for k in m1:
            assert m2[k] == pytest.approx(m1[k], rel=1e-4), (s, k)
    for name, sd in one["first"].items():
        for k in sd:
            assert torch.equal(two[0]["weights"][name][k], two[1]["weights"][name][k])

        def norm(a, b):
            return float(torch.linalg.vector_norm(torch.cat([(a[k] - b[k]).reshape(-1)
                                                             for k in a])))

        move = norm(sd, one["initial"][name])
        assert norm(two[0]["first"][name], sd) <= 0.05 * move, name


def test_world_size_one_group_is_bitwise_no_group(align, acoustic):
    _, runs = align
    (none,), (one,) = runs[0], runs[1]
    assert one["losses"] == none["losses"]
    for k, v in none["params"].items():
        assert torch.equal(one["params"][k], v), k
    for k in PRIORS:
        assert torch.equal(one[k], none[k]), k
    (none,), (one,) = acoustic[0], acoustic[1]
    assert one["metrics"] == none["metrics"]
    for name, sd in none["weights"].items():
        for k, v in sd.items():
            assert torch.equal(one["weights"][name][k], v), (name, k)


def test_losses_over_two_ranks_match_jax_on_the_whole_batch(tmp_path):
    ins = loss_inputs()
    flat = {f"{k}{i}": a for k, arrays in ins.items() for i, a in enumerate(arrays)}
    np.savez(tmp_path / "inputs.npz", **flat, **{f"n_{k}": len(v) for k, v in ins.items()})
    ranks = run_ranks("losses", 2, tmp_path, {"inputs": str(tmp_path / "inputs.npz")})
    j = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    refs = {
        "disc": (lambda r, f: jl.discriminator_pair_loss(r, f)[0], (j["real"], j["fake"])),
        "disc_raw": (lambda r, f: jl.discriminator_pair_loss(r, f)[1], (j["real"], j["fake"])),
        "gen": (jl.generator_pair_loss, (j["real"], j["fake"])),
        "sc": (lambda p: jl.spectral_convergence_loss(j["target"], p), (j["pred"],)),
    }
    for name, (fn, args) in refs.items():
        value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(*args)
        grads = [np.asarray(g) for group in grads for g in group]
        for r in ranks:
            assert r[name]["value"] == pytest.approx(float(value), rel=1e-5), name
        for i, g in enumerate(grads):
            ours = np.concatenate([r[name]["grads"][i] for r in ranks]) / 2
            np.testing.assert_allclose(ours, g, rtol=1e-5, atol=1e-9, err_msg=f"{name} {i}")
        if name == "gen":  # the TPRLS term moved the gradient: it is not at its cap
            lsgan = jax.grad(lambda f: sum(jnp.mean(jnp.square(1.0 - x)) for x in f))(j["fake"])
            assert any(not np.allclose(g, np.asarray(ls))
                       for g, ls in zip(grads[len(j["real"]):], lsgan))


# ---------------------------------------------------------------- train-align


N_TRAIN, PROBE = 8, 4  # one bin of 8 clips at B = 4: 2 rows a rank


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_corpus")
    return root, make_micro_dataset(str(root / "data"), n_train=N_TRAIN, n_val=2,
                                    with_caches=False, uniform_duration=True)


def _cli(root, data, out, epochs, *extra, **training):
    cfg = {"training": {"log_interval": 1, "data_workers": 2, **training},
           "training_plan": {"alignment": {"epochs": epochs, "probe_batch_max": PROBE,
                                           "lr": 1e-4}},
           "dataset": {"path": data}}
    path = root / f"{out}.yml"
    path.write_text(yaml.safe_dump(cfg), encoding="utf-8")
    return ["train-align", "--config", str(path), "--out", str(root / out), "--device", "cpu",
            "--record-steps", *extra]


OOM_AT = ("start", "ctc")


@pytest.fixture(scope="module")
def oom_runs(corpus):
    root, data = corpus
    runs = {at: Ranks("train_align", 2, root, tag=f"oom_{at}", args={
        "cli": _cli(root, data, f"oom_{at}", 2, val_interval=1000, save_interval=1000),
        "oom_rank": 1, "oom_at": at}) for at in OOM_AT}
    return {at: r.results() for at, r in runs.items()}


@pytest.mark.parametrize("oom_at", OOM_AT)
def test_oom_on_one_rank_skips_the_batch_on_both(oom_runs, oom_at):
    ranks = oom_runs[oom_at]
    # epoch 1: 2 batches of 4, the first skipped; epoch 2: 4 batches of 2 at
    # the lowered size; each epoch's val-split step besides
    assert ranks[0]["step"] == ranks[1]["step"] == 5
    assert ranks[0]["losses"] == ranks[1]["losses"] and len(ranks[0]["losses"]) == 7
    assert all(np.isfinite(ranks[0]["losses"]))
    (time_bin,) = ranks[0]["table"]
    assert ranks[0]["table"] == ranks[1]["table"] == {time_bin: 2}
    # the second epoch at the lowered size: 4 batches of 1 row a rank
    assert [len(b) for b in ranks[0]["batches"][-5:]] == [1, 1, 1, 1, 1]
    assert [len(b) for b in ranks[1]["batches"]] == [len(b) for b in ranks[0]["batches"]]


@pytest.fixture(scope="module")
def resume(corpus):
    root, data = corpus
    full = run_ranks("train_align", 2, root, tag="full", args={
        "cli": _cli(root, data, "full", 3, val_interval=2, save_interval=1)})
    stage = root / "full" / "alignment"
    ckpts = sorted(d.name for d in stage.iterdir() if d.name.startswith("checkpoint_"))
    resumed, other = (Ranks("train_align", world, root, tag=tag, args={
        "cli": _cli(root, data, tag, 3, "--checkpoint", str(stage / ckpts[0]),
                    val_interval=2, save_interval=1)})
        for world, tag in ((2, "resumed"), (0, "other_world")))
    return root, full, resumed.results(), other.results(), ckpts


def test_rank_zero_alone_writes_checkpoints(resume):
    root, full, _, _, ckpts = resume
    assert full[1]["writes"] == [] and len(full[0]["writes"]) >= 4 and len(ckpts) == 4
    saved = torch.load(root / "full" / "alignment" / ckpts[-1] / STATE_FILE, weights_only=True)
    gens = saved["rank_generators"]
    assert len(gens) == 2 and torch.equal(gens[0]["generator"], saved["generator"])
    assert not torch.equal(gens[0]["generator"], gens[1]["generator"])


def test_resumed_two_rank_run_equals_the_uninterrupted_one(resume):
    root, full, resumed, _, _ = resume
    for f, r in zip(full, resumed):
        n = len(r["losses"])
        assert 0 < n < len(f["losses"])
        assert r["losses"] == f["losses"][-n:]
        assert r["batches"] == f["batches"][-n:]
        assert r["validations"] == f["validations"][-len(r["validations"]):]
        assert r["manifest"] == f["manifest"]
    last = checkpoint_dir_name(3, full[0]["manifest"]["current_total_step"])
    saved = [torch.load(root / run / "alignment" / last / STATE_FILE, weights_only=True)
             for run in ("full", "resumed")]
    _assert_tree_equal(saved[0], saved[1])


def test_resume_at_another_world_size_rederives_the_generators(resume):
    root, full, _, (other,), _ = resume
    assert other["manifest"]["current_total_step"] == full[0]["manifest"]["current_total_step"]
    assert all(np.isfinite(other["losses"]))
    log = (root / "other_world" / "rank0.log").read_text(encoding="utf-8")
    assert "saved at world size 2, resumed at 1" in log and "re-derived" in log


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b
