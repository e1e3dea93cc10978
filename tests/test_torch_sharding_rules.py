"""The port's sharding rules (``stylish_tts_torch/parallel/sharding_rules.py``)
against the JAX package's, and each shard-aware class against its
unsharded self, on the CPU.

* Leaf by leaf, the port's layout is JAX ``state_shardings``': every port
  parameter (modules built on the ``meta`` device) gets the spec that JAX's
  ``spec_for_leaf`` gives its counterpart leaf of the ``TrainState`` (from
  ``jax.eval_shape``, nothing compiled), mapped by kind (flax axis -1 is
  torch dim 0, -2 is torch dim 1), and the Adam moments mirror it:
  294 leaves and 50,609,680 elements at ``ModelConfig()``, 148 at
  ``tests/test_2d_mesh.py``'s ``small_mc()``, and the ringformer
  generator's config alike.
* The discriminator rules are anchored, so the state view leaves the 46
  discriminator kernels that they name replicated, where the view of
  ``scripts/audit_sharding.py`` (the module's name prepended) shards 340
  leaves, 84.5 % of the parameters.
* Each shard-aware class at a small width in 2 gloo ranks (model 2; a
  ``test_torch_dp_common.run_ranks`` case of tests/test_torch_tp_common.py):
  the forward, the input's gradient and every parameter's gradient (the
  sharded ones gathered) against the unsharded module on the same input,
  dropout and cotangent, rtol 1e-5 and atol 1e-6 of the tensor's peak, of
  the module's largest parameter gradient for a parameter's (the partial
  sums add in another order, and a column conv's bias in front of an
  instance norm has a zero gradient up to rounding). Heads that
  divide and that do not, the conformer's fused ``to_kv``, GRN and the
  spectral-norm convs are among them.
"""

import re

import jax
import numpy as np
import pytest
import torch

from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_tpu.models import build_model
from stylish_tts_tpu.parallel.sharding_rules import MODEL_AXIS, _path_str
from stylish_tts_tpu.parallel.sharding_rules import spec_for_leaf as jax_spec_for_leaf
from stylish_tts_tpu.trainer.init import init_all_params
from stylish_tts_tpu.trainer.state import create_train_state
from stylish_tts_torch.convert.from_jax import flax_layout, module_jax_shapes
from stylish_tts_torch.models import build_models, build_text_aligner
from stylish_tts_torch.parallel.sharding_rules import module_specs, state_path, torch_dim
from test_2d_mesh import small_mc
from test_torch_dp_common import run_ranks
from test_torch_synth_common import port_config
from test_torch_tp_common import module_cases

DISCRIMINATORS = ("mrd0", "mrd1", "mrd2", "disc", "pitch_disc", "dur_disc")


def _ringformer_mc():
    mc = JaxModelConfig()
    mc.generator.type = "ringformer"
    return mc


CONFIGS = {"full": JaxModelConfig, "small_mc": small_mc, "ringformer": _ringformer_mc}


def _jax_specs(mc):
    """JAX path -> flax axis (or None) of every ``TrainState`` leaf."""
    models = build_model(mc)
    state = jax.eval_shape(lambda: create_train_state(
        init_all_params(models, mc, jax.random.PRNGKey(0)), mc.text_encoder.tokens + 1))
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        spec = tuple(jax_spec_for_leaf(path, leaf))
        axis = (spec.index(MODEL_AXIS) - len(leaf.shape)) if MODEL_AXIS in spec else None
        out[_path_str(path)] = (axis, leaf.shape)
    return out


def _port_modules(mc):
    with torch.device("meta"):
        modules = build_models(port_config(mc))
        modules["text_aligner"] = build_text_aligner(port_config(mc))
    return modules


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def layouts(request):
    mc = CONFIGS[request.param]()
    return request.param, _jax_specs(mc), _port_modules(mc)


def test_port_layout_equals_jax_state_shardings(layouts):
    config, jax_specs, modules = layouts
    params = {p: s for p, s in jax_specs.items() if p.startswith("params/")}
    seen, sharded, elements = set(), 0, 0
    for name, module in modules.items():
        specs = module_specs(name, module)
        for key, (flax_path, _) in flax_layout(module).items():
            path = state_path(name, flax_path)
            axis, _ = params[path]
            assert specs[key] == torch_dim(axis), (config, path)
            seen.add(path)
            if axis is not None:
                sharded += 1
                elements += module.get_parameter(key).numel()
    assert seen == set(params), sorted(set(params) ^ seen)[:5]
    # the Adam moments mirror their parameter
    moments = 0
    for path, (axis, _) in jax_specs.items():
        m = re.match(r"opt_state/([^/]+)/.*?/(mu|nu)/params/(.*)$", path)
        if m:
            assert axis == params[f"params/{m.group(1)}/params/{m.group(3)}"][0], path
            moments += axis is not None
    assert moments == 2 * sharded
    if config == "full":
        assert (sharded, elements) == (294, 50_609_680)
    elif config == "small_mc":
        assert sharded == 148


def test_discriminators_replicated_in_the_state_view_not_in_the_audit_view():
    modules = _port_modules(JaxModelConfig())
    kernels = audit_leaves = audit_elements = total = 0
    for name, module in modules.items():
        state = module_specs(name, module)
        audit = module_specs(name, module, audit=True)
        shapes = module_jax_shapes(module)
        for key, (flax_path, kind) in flax_layout(module).items():
            p = module.get_parameter(key)
            # the audit's own view through the JAX function
            spec = tuple(jax_spec_for_leaf(
                tuple(state_path(name, flax_path, audit=True).split("/")),
                jax.ShapeDtypeStruct(shapes[f"params/{flax_path}"], np.float32)))
            assert (audit[key] is not None) == (MODEL_AXIS in spec), (name, key)
            total += p.numel()
            if audit[key] is not None:
                audit_leaves += 1
                audit_elements += p.numel()
            if name in DISCRIMINATORS:
                assert state[key] is None, (name, key)
                kernels += audit[key] is not None
    assert kernels == 46  # the kernels that the anchored rules name
    assert audit_leaves == 340
    assert round(100 * audit_elements / total, 1) == 84.5


@pytest.fixture(scope="module")
def module_runs(tmp_path_factory):
    return run_ranks("modules", 2, tmp_path_factory.mktemp("tp_modules"))


@pytest.mark.parametrize("case", sorted(module_cases()))
def test_shard_aware_module_matches_the_unsharded_one(module_runs, case):
    for rank in module_runs:
        r = rank[case]
        assert r["sharded"] >= 2, case
        (y_ref, gx_ref, g_ref), (y, gx, g) = r["ref"], r["got"]
        _close(y, y_ref, f"{case} output")
        _close(gx, gx_ref, f"{case} input gradient")
        assert sorted(g) == sorted(g_ref)
        peak = max(float(v.abs().max()) for v in g_ref.values() if v is not None)
        for k, ref in g_ref.items():
            if ref is None:
                assert g[k] is None, k
                continue
            _close(g[k], ref, f"{case} {k}", peak)


def _close(got, ref, what, peak=None):
    peak = float(ref.abs().max()) if peak is None else peak
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6 * peak,
                               err_msg=what)
