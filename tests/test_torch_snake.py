"""Port of the anti-aliased Snake (kernel K1's plain version, sin2, the
AntiAliasActivation module) against the JAX package: the fused Pallas
kernel in interpret mode and the unfused XLA path, on the CPU.

The CUDA kernel is held to its plain version on a GPU in
``tests/test_torch_cuda.py``."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.ops.pallas.polyops import sin2 as jax_sin2
from promptttspp_tpu.ops.pallas.snake import fused_antialias_snake
from promptttspp_tpu.vocoders import activations as jax_act
from promptttspp_tpu_torch.ops.kernels import snake as k1
from promptttspp_tpu_torch.ops.polyops import sin2
from promptttspp_tpu_torch.vocoders import activations as act

CSRC = Path(__file__).resolve().parents[1] / "promptttspp_tpu_torch/csrc"

# tolerance of tests/test_pallas_snake.py:34 (f32, different tap order)
TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    alpha = (rng.randn(shape[-1]) * 0.3).astype(np.float32)
    return x, alpha


def test_sin2_matches_jax():
    z = np.linspace(-40.0, 40.0, 10001).astype(np.float32)
    ours = sin2(torch.from_numpy(z)).numpy()
    ref = np.asarray(jax_sin2(jnp.asarray(z)))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    # float32 range reduction of |z| <= 40 costs ~3e-6 against float64
    np.testing.assert_allclose(ours, np.sin(z.astype(np.float64)) ** 2,
                               atol=1e-5)


@pytest.mark.parametrize("shape,tile", [
    ((1, 256, 8), 128),
    ((2, 100, 16), 64),
    ((1, 64, 8), 64),
    ((1, 700, 32), 256),
    ((1, 300, 64), 128),
    ((2, 513, 32), 256),
])
def test_plain_matches_fused_pallas(shape, tile):
    x, alpha = _inputs(shape)
    ref = np.asarray(fused_antialias_snake(jnp.asarray(x), jnp.asarray(alpha),
                                           tile=tile, interpret=True))
    out = k1.antialias_snake(torch.from_numpy(x), torch.from_numpy(alpha))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_constant_signal():
    # DC-preserving resamplers: a constant input gives snake(x) everywhere
    x = np.full((1, 128, 8), 0.7, np.float32)
    alpha = np.zeros((8,), np.float32)
    out = k1.antialias_snake(torch.from_numpy(x), torch.from_numpy(alpha))
    ref = np.asarray(fused_antialias_snake(jnp.asarray(x), jnp.asarray(alpha),
                                           tile=64, interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), 0.7 + np.sin(0.7) ** 2,
                               atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 97, 4), (2, 256, 32)])
def test_resamplers_and_module_match_unfused_jax(shape):
    x, alpha = _inputs(shape, seed=3)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(act.upsample2(xt).numpy(),
                               np.asarray(jax_act.upsample2(xj)), **TOL)
    np.testing.assert_allclose(act.downsample2(xt).numpy(),
                               np.asarray(jax_act.downsample2(xj)), **TOL)
    mod = act.AntiAliasActivation(shape[-1])
    with torch.no_grad():
        mod.act.alpha.copy_(torch.from_numpy(alpha))
        out = mod(xt).numpy()
    jmod = jax_act.AntiAliasActivation(shape[-1], use_pallas=False)
    ref = jmod.apply({"params": {"act": {"alpha": jnp.asarray(alpha)}}}, xj)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_header_taps_equal_kaiser_filter():
    src = (CSRC / "polyops.cuh").read_text()
    body = src[src.index("kFir[12] = {"):src.index("};", src.index("kFir"))]
    lits = re.findall(r"-?0x[0-9a-f.]+p-?\d+", body)
    taps = np.array([float.fromhex(s) for s in lits], np.float32)
    np.testing.assert_array_equal(taps, act.kaiser_sinc_filter1d(0.25, 0.3,
                                                                 12))


def test_cpu_tensor_runs_plain_version_without_counting():
    before = k1.antialias_snake.launches
    x, alpha = _inputs((1, 50, 8))
    k1.antialias_snake(torch.from_numpy(x), torch.from_numpy(alpha))
    assert k1.antialias_snake.launches == before
