"""Port of the AMPLayer (kernel K2's plain version in float32 and in bf16,
and the AMPLayer module) and of the chained AMPBlock (kernel K3's plain
version) against the JAX package's fused Pallas kernels in interpret mode
and its unfused XLA composition, on the CPU.

The CUDA kernels are held to their plain versions on a GPU in
``tests/test_torch_cuda.py``; ``kernel_weight``'s refresh rules are checked
here, on CPU tensors."""

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
# tolerance of tests/test_pallas_amp.py:70 (mxu_bf16=True against f32)
BF16_TOL = dict(atol=3e-2, rtol=1e-2)


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


@pytest.mark.parametrize("T,C,k,dil,tile", [
    (300, 32, 7, 3, 128),   # tests/test_pallas_amp.py:59 (lane-packed)
    (120, 128, 11, 5, 64),  # one sample per row
    (100, 256, 3, 1, 64),   # C > 128
])
def test_plain_bf16_matches_fused_pallas_bf16(T, C, k, dil, tile):
    """K2-bf16's plain version (channel-mix operands rounded to bf16,
    float32 sums) against the Pallas kernel with ``mxu_bf16=True``, at the
    JAX package's own bf16 tolerance. The Pallas kernel also rounds AA's
    FIR operands to bf16 at C < 128; the port does not."""
    p = _params(T, C, k, seed=2)
    j = {n: jnp.asarray(v) for n, v in p.items()}
    ref = fused_amp_layer(j["x"], j["a1"], j["w1"], j["b1"], j["a2"],
                          j["w2"], j["b2"], dil, tile=tile, interpret=True,
                          mxu_bf16=True)
    t = {n: torch.from_numpy(v) for n, v in p.items()}
    args = (t["x"], t["a1"], _torch_w(p["w1"]), t["b1"], t["a2"],
            _torch_w(p["w2"]), t["b2"], dil)
    out = k2.amp_layer_plain(*args, bf16=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **BF16_TOL)
    # the rounding is really applied: not the float32 result
    assert not torch.equal(out, k2.amp_layer_plain(*args))


@pytest.mark.parametrize("T,C,k,dils,tile", [
    # tests/test_pallas_amp.py:74-79
    (400, 32, 3, (1, 3, 5), 128),
    (200, 64, 7, (1, 3, 5), 64),
    (300, 128, 3, (1, 3), 128),
    (150, 256, 3, (1, 3, 5), 64),
])
def test_block_plain_matches_fused_pallas_block(T, C, k, dils, tile):
    """K3's CPU path (the chain of plain AMPLayers) against the JAX package's
    chained kernel, which applies the edge rules between layers itself."""
    from promptttspp_tpu.ops.pallas.amp import fused_amp_block

    rng = np.random.RandomState(7)
    x = (rng.randn(1, T, C) * 0.3).astype(np.float32)
    layers = []
    for _ in dils:
        f = lambda *s, sc: (rng.randn(*s) * sc).astype(np.float32)
        layers.append((f(C, sc=0.2), f(k, C, C, sc=0.05), f(C, sc=0.1),
                       f(C, sc=0.2), f(k, C, C, sc=0.05), f(C, sc=0.1)))
    ref = fused_amp_block(jnp.asarray(x),
                          tuple(tuple(jnp.asarray(a) for a in p)
                                for p in layers), dils, tile=tile,
                          interpret=True)
    params = tuple((torch.from_numpy(a1), _torch_w(w1), torch.from_numpy(b1),
                    torch.from_numpy(a2), _torch_w(w2), torch.from_numpy(b2))
                   for a1, w1, b1, a2, w2, b2 in layers)
    launches = k2.amp_block.launches
    out = k2.amp_block(torch.from_numpy(x), params, dils)
    assert k2.amp_block.launches == launches  # the plain version on the CPU
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("update", ["no_grad_in_place", "load_state_dict",
                                    "new_data", "move"])
def test_kernel_weight_is_prepared_again_after_an_update(update):
    """The kernels' weight layout is kept on the weight and prepared again
    after each update that its version counter or storage shows."""
    layer = AMPLayer(8, 3, 1)
    w = layer.conv1.weight
    w_k = k2.kernel_weight(w)
    assert k2.kernel_weight(w) is w_k
    np.testing.assert_array_equal(w_k.numpy(),
                                  w.detach().permute(2, 1, 0).numpy())
    if update == "no_grad_in_place":
        with torch.no_grad():
            w.mul_(2.0)
    elif update == "load_state_dict":
        layer.load_state_dict({n: v + 1.0
                               for n, v in layer.state_dict().items()})
    elif update == "new_data":
        w.data = torch.randn_like(w)
    else:
        layer.to(torch.float64)
    w = layer.conv1.weight
    assert k2.kernel_weight(w) is not w_k
    np.testing.assert_array_equal(k2.kernel_weight(w).numpy(),
                                  w.detach().permute(2, 1, 0).numpy())


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


@pytest.mark.parametrize("conv_precision", ["default", "highest"])
def test_module_on_cpu_is_float32_for_both_precisions(conv_precision):
    """JAX on the CPU runs the unfused float32 layer whatever
    ``conv_precision`` says (``promptttspp_tpu/vocoders/bigvgan.py:140``);
    so does the port on a CPU tensor, and no kernel is counted."""
    T, C, k, dil = 90, 16, 7, 3
    p = _params(T, C, k, seed=3)
    jparams = {
        "act1": {"act": {"alpha": p["a1"]}},
        "act2": {"act": {"alpha": p["a2"]}},
        "conv1": {"kernel": p["w1"], "bias": p["b1"]},
        "conv2": {"kernel": p["w2"], "bias": p["b2"]},
    }
    ref = JaxAMPLayer(C, k, dil, conv_precision=conv_precision).apply(
        {"params": jparams}, jnp.asarray(p["x"]))
    layer = AMPLayer(C, k, dil, conv_precision=conv_precision)
    with torch.no_grad():
        layer.act1.act.alpha.copy_(torch.from_numpy(p["a1"]))
        layer.act2.act.alpha.copy_(torch.from_numpy(p["a2"]))
        layer.conv1.weight.copy_(_torch_w(p["w1"]))
        layer.conv1.bias.copy_(torch.from_numpy(p["b1"]))
        layer.conv2.weight.copy_(_torch_w(p["w2"]))
        layer.conv2.bias.copy_(torch.from_numpy(p["b2"]))
        before = (k2.amp_layer.launches, k2.amp_layer.launches_bf16)
        out = layer(torch.from_numpy(p["x"]))
        f32 = k2.amp_layer_plain(
            torch.from_numpy(p["x"]), layer.act1.act.alpha,
            layer.conv1.weight, layer.conv1.bias, layer.act2.act.alpha,
            layer.conv2.weight, layer.conv2.bias, dil)
    assert (k2.amp_layer.launches, k2.amp_layer.launches_bf16) == before
    np.testing.assert_array_equal(out.numpy(), f32.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tc_weight_layout(dtype):
    """K2's weight layout (both precisions): [tap][out][in], zero-padded to
    the tiling's rows and columns; bf16 rounded to nearest even, float32
    unrounded."""
    C, k = 12, 3
    w = torch.randn(C, C, k, generator=torch.Generator().manual_seed(0))
    w_k = k2.tc_weight(w, 32, 16, dtype)
    assert w_k.shape == (k, 32, 16) and w_k.dtype == dtype
    assert torch.equal(w_k[:, :C, :C], w.permute(2, 0, 1).to(dtype))
    assert not w_k[:, C:].any() and not w_k[:, :, C:].any()


def _tf32(bits, rna):
    """float32 bits -> TF32 (10 explicit mantissa bits): to nearest, ties
    away from zero (``cvt.rna.tf32.f32``), or truncated, as the tensor
    cores read an operand's low bits."""
    if rna:
        bits = bits + np.uint32(0x1000)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_product_keeps_float32_accuracy():
    """The float32 K2's product of two float32 values, emulated: each is
    split into big = cvt.rna to TF32 and small = v - big (exact), and the
    tensor cores take small truncated to TF32; big*big + big*small +
    small*big is within 1.5 * 2^-20 of the exact product, where one TF32
    pass (both rounded to nearest) strays by up to 2^-11 of it."""
    rng = np.random.RandomState(12)
    a, b = ((rng.randn(2, 1 << 16) * 10.0 ** rng.uniform(-4, 2, (2, 1 << 16))
             ).astype(np.float32))

    def split(v):
        big = _tf32(v.view(np.uint32), rna=True)
        small = v - big
        assert np.array_equal(big.astype(np.float64) + small, v)
        return big.astype(np.float64), _tf32(small.view(np.uint32),
                                             rna=False).astype(np.float64)

    (ab, as_), (bb, bs) = split(a), split(b)
    exact = a.astype(np.float64) * b
    rel = np.abs(ab * bb + ab * bs + as_ * bb - exact) / np.abs(exact)
    assert rel.max() < 1.5 * 2.0 ** -20
    one_pass = np.abs(ab * bb - exact) / np.abs(exact)
    assert one_pass.max() > 2.0 ** -12
