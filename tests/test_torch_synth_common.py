"""Shared set-up of the synthesis parity tests (this file holds no test).

The JAX modules' variables take their tree and shapes from
``jax.eval_shape`` of the flax ``init`` (traced, never compiled: a jitted
init compiles every leaf's random draw, which costs more on the CPU than
the test itself) and their values from numpy, from a seed, by the leaf's
kind. Leaves that flax initialises to a constant (zero biases, GRN
gamma/beta, LayerNorm scales, snake alphas) are drawn around that
constant, so that no term drops out. The port gets them through the
weight bridge. Inputs are made with numpy from a seed and passed to both
sides as arrays. A whole model's JAX forward runs under ``jax.jit``: one
XLA program compiles in a fraction of the time of eager op-by-op dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stylish_tts_tpu.config import ModelConfig as JaxModelConfig
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.convert.from_jax import module_from_jax

HOP, SR = 300, 24000

# The suite runs in parallel worker processes on one machine's cores, and
# each worker imports every test file when it collects them, so this holds
# for the whole run. torch's intra-op pool (one thread per core in every
# process) would oversubscribe the cores several times over; at the tests'
# tiny shapes one thread is faster, and it leaves the cores to the others.
torch.set_num_threads(1)


def tiny_jax_config() -> JaxModelConfig:
    """A few layers at narrow widths; n_fft 128 narrows the generator
    (MultiGenerator's width is n_fft // 2, its head n_fft / 8 = 16)."""
    mc = JaxModelConfig()
    mc.inter_dim = 32
    mc.style_dim = 16
    mc.n_fft = 128
    mc.win_length = 128
    mc.text_encoder.hidden_dim = 32
    mc.text_encoder.filter_channels = 64
    mc.text_encoder.heads = 2
    mc.text_encoder.layers = 1
    mc.decoder.hidden_dim = 32
    mc.decoder.residual_dim = 16
    mc.generator.input_dim = 32
    mc.generator.conformer_layers = 1
    mc.generator.conv_layers = 4
    mc.generator.io_conv_kernel_size = 7
    mc.pitch_energy_predictor.inter_dim = 32
    mc.duration_predictor.n_layer = 1
    mc.style_encoder.max_channels = 64
    return mc


def port_config(jax_mc: JaxModelConfig) -> ModelConfig:
    return ModelConfig.model_validate(jax_mc.model_dump())


def jax_params(init_fn, seed: int = 0):
    """Variables shaped as ``init_fn(key)`` returns them, filled with seeded
    numpy values: kernels N(0, 1/fan_in) (fan_in: every axis but the last),
    embeddings N(0, 1/dim), scales and snake alphas 1 + N(0, 0.01), biases
    and GRN gamma/beta N(0, 0.01)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1000)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return noise / np.float32(np.sqrt(np.prod(leaf.shape[:-1])))
        if name == "embedding":
            return noise / np.float32(np.sqrt(leaf.shape[-1]))
        if name in ("scale", "snake") or name.startswith("alpha"):
            return 1.0 + 0.1 * noise
        if name in ("bias", "beta", "gamma"):
            return 0.1 * noise
        raise KeyError(f"no fill rule for the flax leaf {name!r}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(module_from_jax(module, variables))
    return module.eval()


def randn(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def j(x) -> jnp.ndarray:
    return jnp.asarray(np.asarray(x))


def btc(x: torch.Tensor) -> np.ndarray:
    """A port (B, C, T) output in the JAX (B, T, C) layout."""
    return x.detach().transpose(1, 2).numpy()


def bct(x: np.ndarray) -> torch.Tensor:
    """A JAX-layout (B, T, C) input in the port's (B, C, T) layout."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def f0_contour(frames: int, seed: int, unvoiced: bool = True) -> np.ndarray:
    """(2, frames) F0 of 80-400 Hz, with an unvoiced stretch (0 Hz) if asked."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(80.0, 400.0, (2, frames)).astype(np.float32)
    if unvoiced:
        f0[:, frames // 3: frames // 3 + 4] = 0.0
    return f0
