"""The port's nnsvs-style diffusion decoder with classifier-free guidance
against the JAX package on the CPU: the reference's golden (the training
forward, guided ancestral sampling and guided PLMS), and the jitted JAX
twins on perturbed weights across the denoiser's switches (FiLM or
concatenated conditioning, ``scaled_tanh``, ``pred_x0``, [a_min, a_max]
scaling, the null embedding in place of a dropped or zero ``g``), with the
step and the noise injected.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from promptttspp_tpu_torch.compat.torch_ckpt import load_reference_state_dict
from tests.test_torch_acoustic import jit_apply
from tests.test_torch_esp import _t, _twins

GOLDEN = Path(__file__).parent / "goldens" / "nnsvs_cfg.npz"
# tests/test_nnsvs_diffusion.py's bars
TOL = dict(atol=2e-5, rtol=1e-4)
MEL_TOL = dict(atol=5e-4, rtol=1e-3)

GOLDEN_NET = dict(in_dim=12, encoder_hidden_dim=24, residual_layers=3,
                  residual_channels=16, dilation_cycle_length=2,
                  gin_channels=8, g_proj_dim=16, g_dropout=0.0,
                  cond_norm=True)
GOLDEN_DIFF = dict(K_step=20, schedule_type="linear", norm_scale=6.0,
                   do_classifier_free_guidance=True, guidance_scale=2.0,
                   clip_denoised=True)


def _pair(net_kw, diff_kw, pndm=None):
    from promptttspp_tpu.models.nnsvs_diffusion import (
        DiffNetG as JNet, GaussianDiffusionCFG as JDiff)
    from promptttspp_tpu_torch.models.nnsvs_diffusion import (
        DiffNetG, GaussianDiffusionCFG)

    jdiff = JDiff(in_dim=24, out_dim=12, denoise_fn=JNet(**net_kw),
                  pndm_speedup=pndm, **diff_kw)
    port = GaussianDiffusionCFG(24, 12, DiffNetG(**net_kw),
                                pndm_speedup=pndm, **diff_kw)
    return jdiff, port


def _data(seed=0, gin=8):
    rng = np.random.RandomState(seed)
    cond = rng.randn(2, 9, 24).astype(np.float32)
    y = (3.0 * rng.randn(2, 9, 12)).astype(np.float32)
    g = rng.randn(2, 1, gin).astype(np.float32) if gin else None
    t = np.asarray([3, 17], np.int32)
    noise = rng.randn(2, 9, 12).astype(np.float32)
    x_T = rng.randn(2, 9, 12).astype(np.float32)
    return cond, y, g, t, noise, x_T


# ------------------------------------------------------------ golden
@pytest.mark.parametrize("pndm,key", [(None, "mel_anc"), (5, "mel_plms")])
def test_cfg_matches_golden(pndm, key):
    from promptttspp_tpu_torch.models.nnsvs_diffusion import (
        DiffNetG, GaussianDiffusionCFG)

    d = dict(np.load(GOLDEN))
    sd = {k: torch.from_numpy(v) for k, v in d.items() if "." in k}
    diff = load_reference_state_dict(GaussianDiffusionCFG(
        24, 12, DiffNetG(**GOLDEN_NET), pndm_speedup=pndm, **GOLDEN_DIFF),
        sd).eval()
    cond = _t(np.ascontiguousarray(d["cond"].transpose(0, 2, 1)))
    noise = _t(np.ascontiguousarray(d["noise"][:, 0].transpose(0, 2, 1)))
    with torch.no_grad():
        target, out = diff(cond, _t(d["y"]), g=_t(d["g"]), t=_t(d["t"]),
                           noise=noise)
        mel = diff.inference(cond, g=_t(d["g"]), x_T=_t(np.ascontiguousarray(
            d["x_T"][:, 0].transpose(0, 2, 1))), zero_noise=True)
    np.testing.assert_allclose(out.numpy(),
                               d["model_out"][:, 0].transpose(0, 2, 1), **TOL)
    np.testing.assert_array_equal(target.numpy(), noise.numpy())
    np.testing.assert_allclose(mel.numpy(), d[key], **MEL_TOL)


# --------------------------------------------------------- JAX twins
SWITCHES = {
    "film": (GOLDEN_NET, GOLDEN_DIFF),
    "concat_tanh": (dict(GOLDEN_NET, cond_norm=False, scaled_tanh=True),
                    dict(GOLDEN_DIFF, do_classifier_free_guidance=False)),
    "x0_minmax_no_g": (dict(GOLDEN_NET, gin_channels=0),
                       dict(K_step=20, objective="pred_x0", a_min=-8.0,
                            a_max=4.0, clip_denoised=False)),
}


@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_training_forward_matches_jax(case):
    net_kw, diff_kw = SWITCHES[case]
    jdiff, port = _pair(net_kw, diff_kw)
    cond, y, g, t, noise, _ = _data(gin=net_kw["gin_channels"])
    variables, port = _twins(jdiff, lambda: port, cond, y, g=g, t=t,
                             noise=noise)
    target_ref, out_ref = jit_apply(jdiff, variables, None, cond, y, g=g,
                                    t=t, noise=noise)
    with torch.no_grad():
        target, out = port(_t(cond), _t(y), g=None if g is None else _t(g),
                           t=_t(t), noise=_t(noise))
    np.testing.assert_allclose(target.numpy(), target_ref, **TOL)
    np.testing.assert_allclose(out.numpy(), out_ref, **TOL)


def test_dropped_and_zero_g_take_the_null_embedding():
    """Training with ``g_dropout`` 1 feeds the null embedding; at
    inference a zero ``g`` row (a guided batch's unconditional half) does,
    as in JAX."""
    net_kw = dict(GOLDEN_NET, g_dropout=1.0, cond_norm=False)
    jdiff, port = _pair(net_kw, GOLDEN_DIFF)
    cond, y, g, t, noise, _ = _data()
    variables, port = _twins(jdiff, lambda: port, cond, y, g=g, t=t,
                             noise=noise)
    _, ref = jit_apply(jdiff, variables, None, cond, y, g=g, t=t,
                       noise=noise, train=True)
    port.train()
    with torch.no_grad():
        _, out = port(_t(cond), _t(y), g=_t(g), t=_t(t), noise=_t(noise))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    port.eval()
    with torch.no_grad():
        _, null = port(_t(cond), _t(y), g=torch.zeros(2, 1, 8), t=_t(t),
                       noise=_t(noise))
    np.testing.assert_allclose(null.numpy(), ref, **TOL)


@pytest.mark.parametrize("pndm", [None, 5])
def test_guided_sampling_matches_jax(pndm):
    """Guided ancestral sampling (K = 20) and PLMS (interval 5), from the
    same x_T without noise."""
    from promptttspp_tpu.models.nnsvs_diffusion import GaussianDiffusionCFG

    jdiff, port = _pair(GOLDEN_NET, GOLDEN_DIFF, pndm)
    cond, y, g, t, noise, x_T = _data(1)
    variables, port = _twins(jdiff, lambda: port, cond, y, g=g, t=t,
                             noise=noise)
    ref = jit_apply(jdiff, variables, GaussianDiffusionCFG.inference, cond,
                    g=g, x_T=x_T, zero_noise=True)
    mel = port.inference(_t(cond), g=_t(g), x_T=_t(x_T), zero_noise=True)
    np.testing.assert_allclose(mel.numpy(), ref, **MEL_TOL)


def test_plms_calls_the_denoiser_as_jax_does():
    """PLMS at K = 20, interval 5: steps 15, 10, 5, 0, the first calling
    the denoiser twice; guidance doubles the batch in one call."""
    jdiff, port = _pair(GOLDEN_NET, GOLDEN_DIFF, 5)
    cond, _, g, _, _, x_T = _data()
    calls = []
    port.denoise_fn.register_forward_hook(
        lambda m, args, out: calls.append(tuple(args[1].tolist())))
    port.inference(_t(cond), g=_t(g), x_T=_t(x_T), zero_noise=True)
    assert calls == [(t,) * 4 for t in (15, 10, 10, 5, 0)]
