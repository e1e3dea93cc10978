"""``import-torch``'s modules on the port against the JAX package, on a
seeded checkpoint in the reference's accelerate layout.

The input is ``convert/reference_layout.py``'s fixture (13 ``.bin`` files
with weight norm, spectral norm and BatchNorm sites), at the JAX import
test's widths (``_small_mc``, copied from tests/test_checkpoint_import.py,
whose own input needs the reference's source tree). Held:

* the four folds against the JAX functions on seeded arrays, bitwise;
* the fixture round trip: every plain site of each model imports back to
  the tree the fixture was inverted from, bitwise, and every
  reparametrized one moves;
* the JAX ``import_torch_checkpoint`` (which validates against its traced
  init tree) and the port's on the same directory: the same keys, every
  leaf bitwise;
* the imported modules' forwards, port against JAX ``apply`` on the
  imported tree, within 1e-4 of the output's peak: the speech predictor
  (one injected prior), the duration and pitch/energy predictors, the three
  style encoders (spectral norm off), the ``ContextFreeDiscriminator`` and
  the aligner (both with the frozen affine norm);
* the ringformer vocoder's converter (``convert_upsample_generator``) on the
  fixture's ``UpsampleGenerator`` layout, port against JAX bitwise, and
  ``UpsampleGenerator(faithful=True)``'s forward against JAX's on those
  weights (1e-4 of the peak);
* the error paths: a missing ``pytorch_model_5.bin``, a wrong shape (the
  diff's line), a ringformer config.
"""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.convert import checkpoint_import as jci
from stylish_tts_tpu.convert import folding as jfold
from stylish_tts_tpu.convert import torch_import as jti
from stylish_tts_tpu.models import build_model as jax_build_model
from stylish_tts_tpu.models.ringformer import UpsampleGenerator as JaxUpsampleGenerator
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.convert import checkpoint_import as ci
from stylish_tts_torch.convert import folding, torch_import
from stylish_tts_torch.convert.from_jax import flatten, module_from_jax, module_jax_shapes
from stylish_tts_torch.convert.reference_layout import (
    random_reference_upsample_generator,
    reference_state_dicts,
    write_accelerate_checkpoint,
)
from stylish_tts_torch.models.common import Norm1d
from stylish_tts_torch.models.ringformer import UpsampleGenerator
from stylish_tts_torch.models.style_encoder import SNConv2d
from test_torch_synth_common import HOP, randn

PEAK_RTOL = 1e-4
STYLE_ENCODERS = ("speech_style_encoder", "pe_style_encoder", "duration_style_encoder")


def _small_mc(mc):
    """The JAX import test's widths (tests/test_checkpoint_import.py:28-52)."""
    mc.inter_dim = 16
    mc.style_dim = 8
    mc.n_fft = 64
    mc.win_length = 64
    mc.text_encoder.tokens = 20
    mc.text_encoder.hidden_dim = 16
    mc.text_encoder.filter_channels = 32
    mc.text_encoder.heads = 2
    mc.text_encoder.layers = 1
    mc.text_encoder.dropout = 0.0
    mc.decoder.hidden_dim = 12
    mc.decoder.residual_dim = 6
    mc.generator.input_dim = 12
    mc.generator.io_conv_kernel_size = 3
    mc.generator.conformer_layers = 1
    mc.generator.conv_layers = 4
    mc.duration_predictor.n_layer = 2
    mc.duration_predictor.duration_classes = 5
    mc.pitch_energy_predictor.inter_dim = 16
    mc.style_encoder.max_channels = 32
    return mc


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """The fixture's directory, its state_dicts and trees, and both imports
    of it (the JAX one validated against its traced init tree)."""
    root = tmp_path_factory.mktemp("reference_ckpt")
    sds, trees = reference_state_dicts(_small_mc(ModelConfig()), seed=0)
    write_accelerate_checkpoint(str(root), sds)
    mc = _small_mc(ModelConfig())
    ours = ci.import_torch_checkpoint(str(root), mc)
    jmc = _small_mc(JaxModelConfig())
    theirs = jci.import_torch_checkpoint(str(root), jmc, validate=True)
    return {"root": root, "sds": sds, "trees": trees, "mc": mc, "jmc": jmc,
            "ours": ours, "theirs": theirs, "models": ci.imported_models(ours, mc),
            "jax_models": jax_build_model(jmc)}


# ------------------------------------------------------------------ folding


def _fold_inputs(rng):
    return {
        "weight_norm": (rng.uniform(0.5, 2.0, (6, 1, 1)), rng.standard_normal((6, 4, 3))),
        "spectral_norm": (rng.standard_normal((5, 3, 3, 3)), rng.standard_normal(5),
                          rng.standard_normal(27)),
        "batch_norm": (rng.standard_normal(7), rng.uniform(0.5, 2.0, 7),
                       rng.standard_normal(7), rng.standard_normal(7)),
        "batch_norm_no_affine": (rng.standard_normal(7), rng.uniform(0.5, 2.0, 7)),
    }


@pytest.mark.parametrize("fold", ["weight_norm", "spectral_norm", "batch_norm",
                                  "batch_norm_no_affine", "state_dict"])
def test_folds_equal_jax_bitwise(fold):
    args = [np.asarray(a, np.float32) for a in
            _fold_inputs(np.random.default_rng(3)).get(fold, ())]
    if fold == "state_dict":
        sd = reference_state_dicts(_small_mc(ModelConfig()), seed=5)[0]["speech_style_encoder"]
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}  # live tensors, as torch gives
        ours, theirs = folding.fold_state_dict(sd), jfold.fold_state_dict(sd)
        assert ours.keys() == theirs.keys()
        assert not any(k.endswith(("weight_orig", "weight_u", "weight_v")) for k in ours)
        pairs = [(ours[k], theirs[k]) for k in ours]
    else:
        name = "fold_batch_norm" if fold.startswith("batch_norm") else f"fold_{fold}"
        ours, theirs = getattr(folding, name)(*args), getattr(jfold, name)(*args)
        pairs = list(zip(ours, theirs)) if isinstance(ours, tuple) else [(ours, theirs)]
    for a, b in pairs:
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_fold_copies_a_live_tensor():
    """A folded weight shares no memory with the torch parameter it came from."""
    w = torch.ones(3, 2)
    out = folding.fold_state_dict({"a.weight": w})["a.weight"]
    w.add_(1.0)
    np.testing.assert_array_equal(out, np.ones((3, 2), np.float32))


# ------------------------------------------------------------- the fixture


def _reparametrized(name: str, path: str) -> bool:
    """Whether the fixture writes this flax leaf behind a reparametrization
    (its import is the fold, not the tree)."""
    if "/bn/" in path or "tdnn_norm_" in path or (name == "disc" and "/norm/" in path):
        return True  # BatchNorm running statistics
    if name in STYLE_ENCODERS and path.endswith("kernel") and path != "core/out/kernel":
        return True  # spectral norm on every conv
    return re.search(r"/conv[12]_\d/Conv_0/kernel$", path) is not None  # weight norm


@pytest.mark.parametrize("name", ci.REFERENCE_MODEL_ORDER)
def test_fixture_plain_sites_round_trip_bitwise(imported, name):
    tree = flatten(imported["trees"][name])
    folded = folding.fold_state_dict(imported["sds"][name])
    converted = flatten(ci.convert_model(name, folded, imported["mc"]))
    assert converted.keys() == tree.keys()
    moved = [k for k in tree if _reparametrized(name, k)]
    for k in tree:
        if k in moved:
            assert tree[k].shape == converted[k].shape
            assert not np.array_equal(tree[k], converted[k]), k
        else:
            np.testing.assert_array_equal(converted[k], tree[k], err_msg=k)
    expected_sites = {"text_aligner": 6, "speech_predictor": 14, "disc": 18,
                      "speech_style_encoder": 14, "duration_style_encoder": 14,
                      "pe_style_encoder": 15}
    assert len(moved) == expected_sites.get(name, 0)


@pytest.mark.parametrize("name", ci.REFERENCE_MODEL_ORDER)
def test_port_import_equals_jax_import_bitwise(imported, name):
    ours, theirs = flatten(imported["ours"][name]), flatten(imported["theirs"][name])
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        ref = np.asarray(theirs[k])
        assert v.dtype == ref.dtype == np.float32, k
        np.testing.assert_array_equal(v, ref, err_msg=k)


def test_import_sets_the_imported_variants(imported):
    mc, jmc = imported["mc"], imported["jmc"]
    assert mc.imported_weights and jmc.imported_weights
    assert mc.generator.norm_mode == jmc.generator.norm_mode == "affine"
    models = imported["models"]
    assert list(models) == ci.REFERENCE_MODEL_ORDER
    assert all(not m.training for m in models.values())
    for name in STYLE_ENCODERS:  # the pre-folded kernels, taken as they are
        convs = [m for m in models[name].modules() if isinstance(m, SNConv2d)]
        assert convs and not any(m.sn for m in convs), name
    for name, count in (("disc", 9), ("text_aligner", 3), ("speech_predictor", 1)):
        norms = [m for m in models[name].modules() if isinstance(m, Norm1d)]
        assert len(norms) == count and all(m.mode == "affine" for m in norms), name


# ------------------------------------------------------------------ forwards


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    peak = float(np.abs(ref).max())
    assert peak > 0
    err = float(np.abs(ours - ref).max())
    assert err <= PEAK_RTOL * peak, (err, peak)


B, L, F = 2, 9, 48


def _case(mc):
    rng = np.random.default_rng(11)
    texts = rng.integers(1, mc.text_encoder.tokens, (B, L)).astype(np.int32)
    lengths = np.array([L, L - 3], np.int32)
    align = np.zeros((B, L, F), np.float32)
    for b in range(B):
        for f in range(F):
            align[b, min(f * lengths[b] // F, lengths[b] - 1), f] = 1.0
    pitch = rng.uniform(90.0, 250.0, (B, F)).astype(np.float32)
    return {"texts": texts, "lengths": lengths, "align": align, "pitch": pitch,
            "energy": randn((B, F), 12), "voiced": (pitch > 100.0).astype(np.float32),
            "style": randn((B, mc.style_dim), 13), "style_mel": randn((B, 80, F), 14),
            "audio": randn((B, 3000), 15, 0.1), "mel": randn((B, F, 80), 16),
            "prior": np.tanh(randn((B, F * HOP), 17, 0.3))}


def _forward(name, model, x, port):
    """(port or JAX) forward of module ``name`` on case ``x``."""
    if port:
        a = {k: torch.from_numpy(v) for k, v in x.items()}
        a["texts"], a["lengths"] = a["texts"].long(), a["lengths"].long()
        call = model
    else:
        a = {k: jnp.asarray(v) for k, v in x.items()}

        def call(*args, **kw):
            return model[0].apply(model[1], *args, **kw)
    if name == "speech_predictor":
        extra = {} if port else {"rng": jax.random.PRNGKey(0)}
        return call(a["texts"], a["lengths"], a["align"], a["pitch"], a["energy"],
                    a["voiced"], a["style"], a["pitch"], prior=a["prior"], **extra).audio
    if name == "duration_predictor":
        return call(a["texts"], a["lengths"], a["style"])
    if name == "pitch_energy_predictor":
        return call(a["texts"], a["lengths"], a["align"], a["style"])
    if name == "pe_style_encoder":
        return call(a["style_mel"], a["pitch"], a["energy"])
    if name in STYLE_ENCODERS:
        return call(a["style_mel"])
    if name == "disc":
        return call(a["audio"])
    if name == "text_aligner":
        return call(a["mel"], a["lengths"] * 0 + F)
    raise KeyError(name)


def _outputs(y):
    return [np.asarray(v) for v in (y if isinstance(y, (list, tuple)) else [y])]


@pytest.mark.parametrize("name", ["speech_predictor", "duration_predictor",
                                  "pitch_energy_predictor", *STYLE_ENCODERS, "disc",
                                  "text_aligner"])
def test_imported_forward_matches_jax(imported, name):
    x = _case(imported["mc"])
    jmod, variables = imported["jax_models"][name], imported["theirs"][name]
    ref = _outputs(jax.jit(lambda v: _forward(name, (jmod, v), x, port=False))(variables))
    with torch.no_grad():
        ours = _outputs(_forward(name, imported["models"][name], x, port=True))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        _close(a, b)


# ------------------------------------------------------------ the ringformer

RATES, KERNELS = (4, 5), (8, 10)
UP_KW = dict(resblock_kernel_sizes=(3, 7, 11), upsample_rates=RATES,
             upsample_initial_channel=32, gen_istft_n_fft=60, gen_istft_hop_size=15,
             sample_rate=24000, conformer_depth=2, faithful=True,
             upsample_kernel_sizes=KERNELS)


def test_upsample_generator_import_matches_jax():
    """The reference ``UpsampleGenerator`` layout at the JAX parity test's
    widths (n_up 2, rates (4, 5), kernels (8, 10), 32 -> 8 channels):
    both converters bitwise, the tree of the JAX module's shapes, and the
    faithful forward within 1e-4 of the peak. As in that test, the prior's
    edge samples are zero: the reflect-padded first and last STFT frames
    are then all zero, with phase 0 on both sides."""
    port = UpsampleGenerator(32, 8, **UP_KW).eval()
    sd = folding.fold_state_dict(random_reference_upsample_generator(port, seed=2))
    assert any(k.startswith("conformers.0.layers.0.conv.net.4.running_") for k in sd)
    ours = torch_import.convert_upsample_generator(sd, n_up=len(RATES))
    theirs = jti.convert_upsample_generator(sd, n_up=len(RATES))
    o, t = flatten(ours), flatten(theirs)
    assert o.keys() == t.keys()
    for k in o:
        np.testing.assert_array_equal(o[k], t[k], err_msg=k)

    jmod = JaxUpsampleGenerator(style_dim=8, upsample_last_channel=8, **UP_KW)
    frames = 4
    prior_hop = int(np.prod(RATES)) * 15
    prior = (0.1 * randn((B, frames * prior_hop), 21)).astype(np.float32)
    prior[:, :60] = 0.0
    prior[:, -60:] = 0.0
    args = dict(mel=randn((B, frames, 32), 22), style=randn((B, 8), 23),
                pitch=np.full((B, frames), 220.0, np.float32),
                energy=randn((B, frames), 24), voiced=np.ones((B, frames), np.float32))
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, rng=k, prior=jnp.asarray(prior),
                                                **jargs), jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in flatten_dict(shapes, sep="/").items()}
    assert {f"params/{k}": v.shape for k, v in o.items()} == want == module_jax_shapes(port)

    ref = jax.jit(lambda v: jmod.apply(v, rng=None, prior=jnp.asarray(prior), **jargs).audio)(
        {"params": theirs})
    port.load_state_dict(module_from_jax(port, {"params": ours}))
    with torch.no_grad():
        got = port(mel=torch.from_numpy(args["mel"].transpose(0, 2, 1).copy()),
                   style=torch.from_numpy(args["style"]),
                   pitch=torch.from_numpy(args["pitch"]),
                   voiced=torch.from_numpy(args["voiced"]),
                   prior=torch.from_numpy(prior)).audio
    _close(got.numpy().reshape(B, -1), np.asarray(ref).reshape(B, -1))


# --------------------------------------------------------------- error paths


def test_a_missing_model_file_raises(imported, tmp_path):
    shutil.copytree(imported["root"], tmp_path / "ckpt")
    (tmp_path / "ckpt" / "pytorch_model_5.bin").unlink()
    with pytest.raises(FileNotFoundError, match="pytorch_model_5.bin missing"):
        ci.import_torch_checkpoint(str(tmp_path / "ckpt"), _small_mc(ModelConfig()))


def test_a_wrong_shape_raises_with_the_diff(imported, tmp_path):
    sds = {k: dict(v) for k, v in imported["sds"].items()}
    sds["dur_disc"]["out.0.weight"] = np.zeros((1, 63, 3), np.float32)
    write_accelerate_checkpoint(str(tmp_path), sds)
    with pytest.raises(ValueError, match="converted params mismatch") as err:
        ci.import_torch_checkpoint(str(tmp_path), _small_mc(ModelConfig()))
    assert "shape:   /dur_disc/params/out_0/Conv_0/kernel got (3, 63, 1) want" in str(err.value)


def test_a_ringformer_config_raises(imported):
    mc = _small_mc(ModelConfig())
    mc.generator.type = "ringformer"
    with pytest.raises(ValueError, match="ringformer.*FreeGAN MultiGenerator"):
        ci.import_torch_checkpoint(str(imported["root"]), mc)
    assert not mc.imported_weights
