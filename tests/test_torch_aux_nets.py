"""The port's experimental nets against the JAX package on the CPU:
ConvNeXt1d, MRFNet, Unet1d and Glow against the reference's goldens (its
torch ``state_dict`` loaded by name, weight norm folded) and against their
jitted JAX twins on perturbed weights; CNF and ScoreSDE, which have no
golden, against their JAX twins around a tiny Unet1d with the time, the
start state and the noise injected.

Tolerances are ``tests/test_aux_nets.py``'s against the goldens, float32
summation order against JAX, and 5e-4 for a sampled output.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu_torch.compat.torch_ckpt import load_reference_state_dict
from tests.test_torch_acoustic import jit_apply
from tests.test_torch_esp import _t, _twins

GOLDENS = Path(__file__).parent / "goldens"
TOL = dict(atol=2e-5, rtol=1e-4)
UNET_TOL = dict(atol=5e-5, rtol=1e-3)  # test_unet_parity's bar
SAMPLE_TOL = dict(atol=5e-4, rtol=1e-3)


def _golden(name):
    data = dict(np.load(GOLDENS / f"{name}.npz"))
    return {k: torch.from_numpy(v) for k, v in data.items() if "." in k}, \
        data


def _btc(a):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))


def _inputs(B=2, T=13, C=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, T - 4:] = 0.0
    return x, mask


# ------------------------------------------------------------ goldens
def test_convnext_matches_golden():
    from promptttspp_tpu_torch.nn.convnext import ConvNeXt1d

    sd, d = _golden("convnext")
    net = load_reference_state_dict(ConvNeXt1d(16, 32, 2), sd).eval()
    with torch.no_grad():
        out = net(_btc(d["x"]), _t(d["mask"])[:, :, None])
    np.testing.assert_allclose(out.numpy(), d["out"].transpose(0, 2, 1),
                               **TOL)


def test_mrf_matches_golden():
    """MRF's weights carry weight norm; the reference's in_conv/out_conv,
    which its forward never runs, are left unread."""
    from promptttspp_tpu_torch.nn.mrf import MRFNet

    sd, d = _golden("mrf")
    net = load_reference_state_dict(MRFNet(16, 16, 16, (3, 7), (1, 3)), sd)
    with torch.no_grad():
        out = net.eval()(_btc(d["x"]), _t(d["mask"])[:, :, None],
                         g=_btc(d["g"]))
    np.testing.assert_allclose(out.numpy(), d["out"].transpose(0, 2, 1),
                               **TOL)


def test_unet_matches_golden():
    from promptttspp_tpu_torch.models.unet import Unet1d

    sd, d = _golden("unet")
    net = load_reference_state_dict(Unet1d(10, 14, 10, 16, (1, 2, 4)), sd)
    with torch.no_grad():
        out = net.eval()(_btc(d["x"]), _t(d["t"]), _btc(d["cond"]),
                         _t(d["mask"])[:, :, None])
    np.testing.assert_allclose(out.numpy(), d["out"].transpose(0, 2, 1),
                               **UNET_TOL)


def test_glow_matches_golden_and_inverts():
    from promptttspp_tpu_torch.models.glow import Glow

    sd, d = _golden("glow")
    gl = load_reference_state_dict(Glow(16, 24, 2, 2), sd).eval()
    z = _btc(d["z"])
    with torch.no_grad():
        zf, ld = gl(z)
        zr, _ = gl.reverse(zf)
    np.testing.assert_allclose(zf.numpy(), d["zf"].transpose(0, 2, 1), **TOL)
    np.testing.assert_allclose(float(ld), float(d["ld"]), atol=1e-3)
    np.testing.assert_allclose(zr.numpy(), z.numpy(), atol=1e-4)


# --------------------------------------------------------- JAX twins
def _apply(port, *args, **kw):
    with torch.no_grad():
        return port(*[_t(a) if isinstance(a, np.ndarray) else a
                      for a in args], **kw)


def test_convnext_matches_jax():
    from promptttspp_tpu.nn.convnext import ConvNeXt1d as J
    from promptttspp_tpu_torch.nn.convnext import ConvNeXt1d

    x, mask = _inputs()
    jnet = J(channels=16, h_channels=48, num_layers=3)
    variables, net = _twins(jnet, lambda: ConvNeXt1d(16, 48, 3), x, mask)
    ref = jit_apply(jnet, variables, None, x, mask)
    np.testing.assert_allclose(_apply(net, x, mask).numpy(), ref, **TOL)


@pytest.mark.parametrize("with_g", [False, True])
def test_mrf_matches_jax(with_g):
    from promptttspp_tpu.nn.mrf import MRFNet as J
    from promptttspp_tpu_torch.nn.mrf import MRFNet

    x, mask = _inputs()
    g = np.random.RandomState(1).randn(2, 1, 16).astype(np.float32) \
        if with_g else None
    jnet = J(in_channels=16, channels=16, out_channels=16,
             kernel_sizes=(3, 7, 11), dilations=(1, 3, 5))
    variables, net = _twins(
        jnet, lambda: MRFNet(16, 16, 16, (3, 7, 11), (1, 3, 5)), x, mask, g)
    ref = jit_apply(jnet, variables, None, x, mask, g=g)
    out = _apply(net, x, mask, g=None if g is None else _t(g))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _unet_pair(in_ch=6, enc=5, out_ch=6, dim=16, seed=0):
    from promptttspp_tpu.models.unet import Unet1d as J
    from promptttspp_tpu_torch.models.unet import Unet1d

    x, mask = _inputs(T=13, C=in_ch, seed=seed)
    cond = np.random.RandomState(seed + 1).randn(2, 13, enc).astype(
        np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    jnet = J(in_channels=in_ch, encoder_channels=enc, out_channels=out_ch,
             dim=dim, dim_mults=(1, 2, 4))
    variables, net = _twins(
        jnet, lambda: Unet1d(in_ch, enc, out_ch, dim, (1, 2, 4)), x, t, cond,
        mask, seed=seed)
    return jnet, variables, net, (x, t, cond, mask)


def test_unet_matches_jax_with_left_padding():
    """T = 13 is reflect-padded on the left to 16 and cut back, as in the
    reference; the time is a float in [0, 1] (CNF's and ScoreSDE's)."""
    jnet, variables, net, args = _unet_pair()
    ref = jit_apply(jnet, variables, None, *args)
    np.testing.assert_allclose(_apply(net, *args).numpy(), ref, **UNET_TOL)


def test_glow_matches_jax_and_inverts():
    from promptttspp_tpu.models.glow import Glow as J
    from promptttspp_tpu_torch.models.glow import Glow

    z = np.random.RandomState(0).randn(3, 1, 16).astype(np.float32)
    g = np.random.RandomState(1).randn(3, 1, 8).astype(np.float32)
    jgl = J(in_channels=16, channels=24, num_flows=3, n_blocks=2,
            gin_channels=8)
    variables, gl = _twins(jgl, lambda: Glow(16, 24, 3, 2, gin_channels=8),
                           z, g)
    zf_ref, ld_ref = jit_apply(jgl, variables, None, z, g=g)
    zf, ld = _apply(gl, z, g=_t(g))
    np.testing.assert_allclose(zf.numpy(), zf_ref, **TOL)
    np.testing.assert_allclose(float(ld), float(ld_ref), atol=1e-4)
    zr_ref, _ = jit_apply(jgl, variables, J.reverse, np.asarray(zf_ref),
                          g=g)
    with torch.no_grad():
        zr, ldr = gl.reverse(zf, g=_t(g))
    np.testing.assert_allclose(zr.numpy(), zr_ref, **TOL)
    np.testing.assert_allclose(zr.numpy(), z, atol=1e-4)
    np.testing.assert_allclose(float(ldr), -float(ld), atol=1e-4)


class TinyNet(torch.nn.Module):
    """The port's twin of ``tests/test_aux_nets.py``'s tiny flax net:
    Dense(32) on [x, cond, t], tanh, Dense(out)."""

    def __init__(self, in_dim, out):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(in_dim, 32)
        self.Dense_1 = torch.nn.Linear(32, out)

    def forward(self, x, t, cond, mask=None):
        h = torch.cat([x, cond, t[:, None, None].expand(*x.shape[:2], 1)],
                      dim=-1)
        return self.Dense_1(torch.tanh(self.Dense_0(h)))


def _jax_tiny_net(out):
    import flax.linen as nn

    class JaxTinyNet(nn.Module):
        out: int

        @nn.compact
        def __call__(self, x, t, cond, mask=None):
            h = jnp.concatenate(
                [x, cond, jnp.broadcast_to(t[:, None, None],
                                           x.shape[:2] + (1,))], axis=-1)
            h = nn.Dense(32)(h)
            h = nn.tanh(h)
            return nn.Dense(self.out)(h)

    return JaxTinyNet(out)


def _draws(seed=3):
    rng = np.random.RandomState(seed)
    x1 = rng.randn(2, 9, 6).astype(np.float32)
    cond = rng.randn(2, 9, 5).astype(np.float32)
    mask = np.ones((2, 9, 1), np.float32)
    mask[1, 6:] = 0.0
    t = np.asarray([0.25, 0.7], np.float32)
    x0 = rng.randn(2, 9, 6).astype(np.float32)
    return x1, cond, mask, t, x0


def _cnf_pair():
    from promptttspp_tpu.models.cnf import CNF as J
    from promptttspp_tpu_torch.models.cnf import CNF

    x1, cond, mask, t, x0 = _draws()
    jcnf = J(net=_jax_tiny_net(6), out_channels=6, cfg=2.0)
    variables, cnf = _twins(jcnf, lambda: CNF(TinyNet(12, 6), 6, cfg=2.0),
                            x1, cond, mask, t, x0)
    return jcnf, variables, cnf, (x1, cond, mask, t, x0)


def test_cnf_training_matches_jax():
    jcnf, variables, cnf, (x1, cond, mask, t, x0) = _cnf_pair()
    ut_ref, vt_ref = jit_apply(jcnf, variables, None, x1, cond, mask, t, x0)
    ut, vt = _apply(cnf, x1, cond, mask, t, x0)
    np.testing.assert_allclose(ut.numpy(), ut_ref, **TOL)
    np.testing.assert_allclose(vt.numpy(), vt_ref, **TOL)


@pytest.mark.parametrize("method,do_cfg", [("euler", False), ("rk4", True)])
def test_cnf_sampling_matches_jax(method, do_cfg):
    """Fixed steps from t = 1 to 1e-5 from an injected x0; guidance calls
    the net without the mask, on the condition and on zeros."""
    jcnf, variables, cnf, (_, cond, _, _, x0) = _cnf_pair()
    ref = jit_apply(jcnf, variables, type(jcnf).sample, cond, 10, method,
                    do_cfg, x0=x0)
    with torch.no_grad():
        out = cnf.sample(_t(cond), 10, method, do_cfg, x0=_t(x0))
    np.testing.assert_allclose(out.numpy(), ref, **SAMPLE_TOL)


def test_score_sde_loss_and_solve_match_jax():
    from promptttspp_tpu.models.score_sde import ScoreSDE as J
    from promptttspp_tpu_torch.models.score_sde import ScoreSDE

    x0, mu, mask, t, z = _draws(4)
    mu = mu[..., :1].repeat(6, axis=-1) + 0.1 * x0
    jsde = J(mel_dim=6, denoise_fn=_jax_tiny_net(6))
    variables, sde = _twins(
        jsde, lambda: ScoreSDE(6, TinyNet(13, 6)), x0, mu, mask, t, z,
        method=J.compute_loss)
    ref = jit_apply(jsde, variables, J.compute_loss, x0, mu, mask, t, z)
    with torch.no_grad():
        loss = sde.compute_loss(_t(x0), _t(mu), _t(mask), _t(t), _t(z))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-4)
    ref = jit_apply(jsde, variables, None, x0, mu, mask, 20)
    with torch.no_grad():
        out = sde(_t(x0), _t(mu), _t(mask), 20)
    np.testing.assert_allclose(out.numpy(), ref, **SAMPLE_TOL)


def test_time_grid_is_float64_linspace_in_float32():
    """The port's grid is numpy's float64 linspace rounded to float32;
    JAX's float32 ``linspace`` lands within one float32 step of it."""
    from promptttspp_tpu_torch.models.cnf import time_grid

    for n, stop in ((10, 1e-5), (50, 1e-5), (7, 0.3)):
        ours = time_grid(1.0, stop, n)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(
            ours, np.linspace(1.0, stop, n).astype(np.float32))
        np.testing.assert_allclose(ours, np.asarray(
            jnp.linspace(1.0, stop, n)), rtol=0, atol=6e-8)
