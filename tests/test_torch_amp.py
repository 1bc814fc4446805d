"""Port of the AMPLayer (kernel K2's plain version and the AMPLayer module)
against the JAX package's fused Pallas AMPLayer in interpret mode and its
unfused XLA composition, on the CPU.

The CUDA kernel is held to its plain version on a GPU in
``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.ops.pallas.amp import fused_amp_layer
from promptttspp_tpu.vocoders.bigvgan import AMPLayer as JaxAMPLayer
from promptttspp_tpu_torch.ops.kernels import amp as k2
from promptttspp_tpu_torch.vocoders.bigvgan import AMPLayer

# tolerance of tests/test_pallas_amp.py:51 (f32)
TOL = dict(atol=5e-5, rtol=1e-3)


def _params(T, C, k, seed=0):
    """Inputs scaled as in tests/test_pallas_amp.py:40-47; conv weights in
    the JAX layout [k, C_in, C_out]."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return dict(x=f(1, T, C) * 0.3, a1=f(C) * 0.2, a2=f(C) * 0.2,
                w1=f(k, C, C) * 0.05, w2=f(k, C, C) * 0.05, b1=f(C) * 0.1,
                b2=f(C) * 0.1)


def _torch_w(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))


@pytest.mark.parametrize("T,C,k,dil,tile", [
    (400, 32, 3, 1, 128),
    (300, 64, 7, 3, 128),
    (97, 32, 3, 5, 64),
    (150, 256, 7, 3, 64),
])
def test_plain_matches_fused_pallas(T, C, k, dil, tile):
    p = _params(T, C, k)
    j = {n: jnp.asarray(v) for n, v in p.items()}
    ref = fused_amp_layer(j["x"], j["a1"], j["w1"], j["b1"], j["a2"],
                          j["w2"], j["b2"], dil, tile=tile, interpret=True)
    t = {n: torch.from_numpy(v) for n, v in p.items()}
    out = k2.amp_layer(t["x"], t["a1"], _torch_w(p["w1"]), t["b1"], t["a2"],
                       _torch_w(p["w2"]), t["b2"], dil)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("T,C,k,dil", [(120, 16, 11, 5), (64, 8, 3, 1)])
def test_module_matches_unfused_jax_module(T, C, k, dil):
    p = _params(T, C, k, seed=1)
    jparams = {
        "act1": {"act": {"alpha": p["a1"]}},
        "act2": {"act": {"alpha": p["a2"]}},
        "conv1": {"kernel": p["w1"], "bias": p["b1"]},
        "conv2": {"kernel": p["w2"], "bias": p["b2"]},
    }
    jax_layer = JaxAMPLayer(C, k, dil)
    assert jax.default_backend() == "cpu"  # the unfused XLA path
    ref = jax_layer.apply({"params": jparams}, jnp.asarray(p["x"]))
    layer = AMPLayer(C, k, dil)
    with torch.no_grad():
        layer.act1.act.alpha.copy_(torch.from_numpy(p["a1"]))
        layer.act2.act.alpha.copy_(torch.from_numpy(p["a2"]))
        layer.conv1.weight.copy_(_torch_w(p["w1"]))
        layer.conv1.bias.copy_(torch.from_numpy(p["b1"]))
        layer.conv2.weight.copy_(_torch_w(p["w2"]))
        layer.conv2.bias.copy_(torch.from_numpy(p["b2"]))
        out = layer(torch.from_numpy(p["x"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
