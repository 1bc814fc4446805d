"""Port of the AMPLayer (kernel K2's plain version in float32 and in bf16,
and the AMPLayer module) and of the chained AMPBlock (kernel K3's plain
version) against the JAX package's fused Pallas kernels in interpret mode
and its unfused XLA composition, on the CPU.

The CUDA kernels are held to their plain versions on a GPU in
``tests/test_torch_cuda.py``; the weight layouts' refresh rules are checked
here, on CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.ops.pallas.amp import fused_amp_layer
from promptttspp_tpu.vocoders.bigvgan import AMPLayer as JaxAMPLayer
from promptttspp_tpu_torch.ops.kernels import amp as k2
from promptttspp_tpu_torch.tools import k2_bits
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


# tests/test_pallas_amp.py:74-79
BLOCK_SHAPES = [
    (400, 32, 3, (1, 3, 5), 128),
    (200, 64, 7, (1, 3, 5), 64),
    (300, 128, 3, (1, 3), 128),
    (150, 256, 3, (1, 3, 5), 64),
]


@pytest.mark.parametrize("bf16,T,C,k,dils,tile", [
    *((False, *shape) for shape in BLOCK_SHAPES),
    *((True, *shape) for shape in BLOCK_SHAPES),
    # shapes JAX takes that K3 refused before it took every C, k and chain
    (False, 200, 16, 3, (1, 3, 5), 128),   # C = 16 (8 samples per row)
    (False, 300, 32, 7, (3,), 128),        # one layer
    (False, 150, 64, 3, (1, 3, 5, 7), 64),  # four layers
    (False, 250, 32, 5, (2, 4), 128),      # k = 5, dilations (2, 4)
])
def test_block_plain_matches_fused_pallas_block(bf16, T, C, k, dils, tile):
    """K3's CPU path (the chain of plain AMPLayers of its precision)
    against the JAX package's chained kernel, which applies the edge rules
    between layers itself. With ``bf16`` at the JAX package's bf16
    tolerance: against ``mxu_bf16=True`` at C >= 128, where the Pallas
    kernel rounds only the channel mix, as the port does; at C < 128 it
    also rounds AA's FIR operands to bf16 (the port does not), which alone
    takes its block 0.034 beyond its float32 block at C = 64, k = 7, so
    there the port is held against the float32 block, as
    tests/test_pallas_amp.py:70 holds the bf16 layer."""
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
                          interpret=True, mxu_bf16=bf16 and C >= 128)
    params = tuple((torch.from_numpy(a1), _torch_w(w1), torch.from_numpy(b1),
                    torch.from_numpy(a2), _torch_w(w2), torch.from_numpy(b2))
                   for a1, w1, b1, a2, w2, b2 in layers)
    launches = (k2.amp_block.launches, k2.amp_block.launches_bf16)
    out = k2.amp_block(torch.from_numpy(x), params, dils, bf16=bf16)
    # the plain version on the CPU
    assert (k2.amp_block.launches, k2.amp_block.launches_bf16) == launches
    torch.testing.assert_close(
        out, k2.amp_block_plain(torch.from_numpy(x), params, dils, bf16=bf16),
        atol=0, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               **(BF16_TOL if bf16 else TOL))
    if bf16:  # the rounding is really applied: not the float32 result
        assert not torch.equal(
            out, k2.amp_block_plain(torch.from_numpy(x), params, dils))


@pytest.mark.parametrize("update", ["no_grad_in_place", "load_state_dict",
                                    "new_data", "move"])
def test_kernel_weight_is_prepared_again_after_an_update(update):
    """The kernels' weight layouts (here K2-bf16's, which the CPU can
    make) are kept on the weight and prepared again after each update that
    its version counter or storage shows."""
    layer = AMPLayer(8, 3, 1)
    w = layer.conv1.weight
    layout = lambda v: k2.wgmma_weight(v.detach(), 16, 16)
    w_k = k2.kernel_weight_wgmma(w)
    assert k2.kernel_weight_wgmma(w) is w_k
    np.testing.assert_array_equal(w_k.float().numpy(),
                                  layout(w).float().numpy())
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
    assert k2.kernel_weight_wgmma(w) is not w_k
    np.testing.assert_array_equal(k2.kernel_weight_wgmma(w).float().numpy(),
                                  layout(w).float().numpy())


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


@pytest.mark.parametrize("conv_precision", ["default", "highest"])
@pytest.mark.parametrize("C", [1, 2, 3, 5])
def test_module_on_cpu_at_odd_and_small_channel_counts(conv_precision, C):
    """Every C that the JAX ``AMPLayer`` takes: on a CPU tensor the port
    runs the float32 plain version for both precisions, held to JAX's
    unfused layer, and no kernel is counted."""
    T, k, dil = 70, 7, 3
    p = _params(T, C, k, seed=C)
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
    assert (k2.amp_layer.launches, k2.amp_layer.launches_bf16) == before
    assert out.shape == (1, T, C)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [1, 2, 3, 12, 32, 64, 128, 256])
def test_kernel_weight_wgmma_layout(C, k):
    """K2-bf16's weight layout against its documented index formula:
    element (p, j, s, g, h, r, e) is W[j][p*N + 8g + r][16s + 8h + e], bf16
    rounded to nearest even; inverted back to w, it gives w with zeros in
    the padding. Prepared once and again after an in-place update."""
    w = torch.randn(C, C, k, generator=torch.Generator().manual_seed(C + k))
    plan = k2.wgmma_plan(C, k, 1)
    n, cp = plan["n"], plan["cp"]
    w_k = k2.kernel_weight_wgmma(w)
    assert k2.kernel_weight_wgmma(w) is w_k
    P = plan["passes"]
    assert w_k.dtype == torch.bfloat16
    assert w_k.shape == (P, k, cp // 16, n // 8, 2, 8, 8)
    assert w_k.numel() * 2 == plan["weight_bytes"]
    full = torch.zeros(k, P * n, cp, dtype=torch.bfloat16)
    idx = torch.meshgrid(*(torch.arange(s) for s in w_k.shape),
                         indexing="ij")
    p, j, s, g, h, r, e = idx
    full[j, p * n + 8 * g + r, 16 * s + 8 * h + e] = w_k[idx]
    assert torch.equal(full[:, :C, :C], w.permute(2, 0, 1).to(torch.bfloat16))
    assert not full[:, C:].any() and not full[:, :, C:].any()
    with torch.no_grad():
        w.mul_(2.0)
    assert k2.kernel_weight_wgmma(w) is not w_k


def _flagship_layer_shapes():
    """(C, k, d) of every launch of the flagship vocoder's AMPLayers."""
    from promptttspp_tpu_torch import flagship

    cfg = flagship.VOCODER
    out = set()
    for i in range(len(cfg["upsample_rates"])):
        C = cfg["upsample_initial_channel"] // 2 ** (i + 1)
        for k, dils in zip(cfg["resblock_kernel_sizes"],
                           cfg["resblock_dilations"]):
            out |= {(C, k, d) for d in dils} | {(C, k, 1)}
    return sorted(out)


@pytest.mark.parametrize("C,k,d", sorted(
    set(_flagship_layer_shapes())
    | {(C, k, d) for _, _, C, k, d in k2_bits.CASES}))
def test_wgmma_plan(C, k, d):
    """K2-bf16's plan at every flagship launch and every k2_bits case: a
    compiled configuration; shared memory within a block's 232,448 bytes;
    N a multiple of 8 that covers C in its passes; tile rows a multiple of
    64; the weights resident exactly where all of them fit beside two A
    buffers (one pass), else a ring of at least two chunks."""
    plan = k2.wgmma_plan(C, k, d)
    cfg = (plan["n"], plan["ks"], plan["nwg"], plan["mt"], plan["pw"])
    assert cfg in k2.WGMMA_CONFIGS
    assert plan["smem"] <= 232_448
    assert plan["n"] % 8 == 0 and plan["n"] * plan["passes"] >= C
    assert plan["n"] * (plan["passes"] - 1) < C
    assert plan["cp"] >= C and plan["cp"] % (16 * plan["ks"]) == 0
    assert plan["tt"] % 64 == 0 and plan["tt"] == 64 * plan["nwg"] * plan["mt"]
    hc = (k - 1) // 2 * d
    assert plan["na"] == plan["tt"] + 2 * hc
    a_bytes = (plan["na"] | 1) * plan["cp"] * 2
    weights = k * plan["cp"] * plan["n"] * plan["passes"] * 2
    fits = plan["passes"] == 1 and weights + 2 * a_bytes + 48 <= 232_448
    assert plan["resident"] == int(fits)
    if not fits:
        assert plan["nstage"] >= 2
    stages = weights if fits else plan["nstage"] * 16 * plan["ks"] \
        * plan["n"] * 2
    assert plan["smem"] == stages + plan["abufs"] * a_bytes \
        + 8 * (4 + 2 * plan["nstage"])
    assert [plan[f] for f in k2.WGMMA_PLAN_FIELDS]  # every field present
    for B, T in ((1, 1), (2, 1000), (1, 153600)):
        grid = k2.wgmma_grid(plan, B, T, 132)
        assert 1 <= grid <= min(132, B * -(-T // plan["tt"])
                                * plan["passes"])
