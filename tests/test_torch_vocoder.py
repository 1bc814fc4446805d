"""Port of the vocoder path against the JAX package and the reference's
goldens: BigVGAN and F0-aware BigVGAN (golden state dicts through the JAX
converter, then ``compat/from_jax.py``; random weights against the JAX
module), the NSF phase accumulation, the F0 lowpass filter and the masks,
on the CPU."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.compat.torch_ckpt import convert_tree
from promptttspp_tpu_torch.compat.from_jax import load_jax_variables

GOLDENS = Path(__file__).parent / "goldens"
# tolerance of tests/test_vocoder.py:57 for the same golden
TOL = dict(atol=5e-5, rtol=1e-3)
GOLDEN_KW = dict(in_channel=20, upsample_initial_channel=32,
                 upsample_rates=(6, 5, 4, 2),
                 upsample_kernel_sizes=(12, 10, 8, 4),
                 resblock_kernel_sizes=(3, 7),
                 resblock_dilations=((1, 3), (1, 3)))


def _golden(name, io_keys):
    data = dict(np.load(GOLDENS / f"{name}.npz"))
    sd = {k: v for k, v in data.items() if k not in io_keys}
    return sd, {k: data[k] for k in io_keys}


def _template(module, *args, **kw):
    """Parameter shapes of a JAX module without running its init."""
    return jax.eval_shape(lambda k: module.init(k, *args, **kw),
                          jax.random.PRNGKey(0))["params"]


def test_bigvgan_f0_matches_golden():
    from promptttspp_tpu.vocoders.bigvgan_f0 import F0AwareBigVGAN as JaxVoc
    from promptttspp_tpu_torch.vocoders.bigvgan_f0 import F0AwareBigVGAN

    sd, io = _golden("bigvgan_f0", {"mel", "f0", "wav"})
    mel = io["mel"].transpose(0, 2, 1)
    f0 = io["f0"].transpose(0, 2, 1)
    template = _template(JaxVoc(sampling_rate=24000, harmonic_num=3,
                                **GOLDEN_KW),
                         jnp.asarray(mel), jnp.asarray(f0),
                         deterministic=True)
    params = jax.device_get(convert_tree(template, sd))
    voc = F0AwareBigVGAN(sampling_rate=24000, harmonic_num=3, **GOLDEN_KW)
    load_jax_variables(voc, {"params": params})
    with torch.no_grad():
        wav = voc(torch.from_numpy(mel), torch.from_numpy(f0),
                  deterministic=True).numpy()
    ref = io["wav"].transpose(0, 2, 1)
    assert wav.shape == ref.shape
    np.testing.assert_allclose(wav, ref, **TOL)


def test_bigvgan_f0_matches_jax_module():
    """Random (perturbed) weights, voiced and unvoiced frames, against the
    JAX module's own output."""
    from promptttspp_tpu.vocoders.bigvgan_f0 import F0AwareBigVGAN as JaxVoc
    from promptttspp_tpu_torch.vocoders.bigvgan_f0 import F0AwareBigVGAN
    from tests.test_torch_acoustic import perturbed

    kw = dict(sampling_rate=24000, harmonic_num=2, in_channel=20,
              upsample_initial_channel=16, upsample_rates=(4, 2),
              upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5),
              resblock_dilations=((1, 2), (1, 3)))
    rng = np.random.RandomState(0)
    mel = rng.randn(2, 37, 20).astype(np.float32)
    f0 = np.where(rng.rand(2, 37, 1) > 0.3, 100 + 200 * rng.rand(2, 37, 1),
                  0.0).astype(np.float32)
    jvoc = JaxVoc(**kw)
    variables = perturbed(jax.jit(
        lambda k: jvoc.init(k, jnp.asarray(mel), jnp.asarray(f0),
                            deterministic=True))(jax.random.PRNGKey(1)))
    ref = jax.jit(lambda v, m, f: jvoc.apply(v, m, f, deterministic=True))(
        {"params": variables["params"]}, jnp.asarray(mel), jnp.asarray(f0))
    voc = F0AwareBigVGAN(**kw)
    load_jax_variables(voc, variables)
    with torch.no_grad():
        wav = voc(torch.from_numpy(mel), torch.from_numpy(f0),
                  deterministic=True).numpy()
    np.testing.assert_allclose(wav, np.asarray(ref), **TOL)


def test_bigvgan_matches_golden():
    from promptttspp_tpu.vocoders.bigvgan import BigVGAN as JaxBigVGAN
    from promptttspp_tpu_torch.vocoders.bigvgan import BigVGAN

    sd, io = _golden("bigvgan", {"mel", "wav"})
    mel = io["mel"].transpose(0, 2, 1)
    template = _template(JaxBigVGAN(**GOLDEN_KW), jnp.asarray(mel))
    params = jax.device_get(convert_tree(template, sd))
    voc = BigVGAN(**GOLDEN_KW)
    load_jax_variables(voc, {"params": params})
    with torch.no_grad():
        wav = voc(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(wav, io["wav"].transpose(0, 2, 1),
                               atol=2e-5, rtol=1e-4)


def test_sine_source_matches_jax_on_a_long_contour():
    """The bounded phase accumulation against the JAX two-level scan over
    a 6.4 s contour (640 frames x 240), voiced and unvoiced stretches."""
    from promptttspp_tpu.vocoders.nsf import SineGen as JaxSineGen
    from promptttspp_tpu_torch.vocoders.nsf import SineGen

    rng = np.random.RandomState(0)
    f0_frames = np.where(rng.rand(640) > 0.2, 80 + 300 * rng.rand(640), 0.0)
    f0 = np.repeat(f0_frames, 240).astype(np.float32)[None, :, None]
    ref, juv, _ = jax.jit(lambda f: JaxSineGen(24000, 8).apply(
        {}, f, deterministic=True))(jnp.asarray(f0))
    sines, uv, _ = SineGen(24000, 8)(torch.from_numpy(f0),
                                     deterministic=True)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
    # the compiled JAX scan itself is off the float64 phase by up to 7e-5
    # (measured) after 153,600 samples; the port stays within 2e-5 of it
    np.testing.assert_allclose(sines.numpy(), np.asarray(ref), atol=1e-4)
    phi = np.cumsum((f0[0, :, 0].astype(np.float64) / 24000) % 1.0) % 1.0
    exact = 0.1 * np.sin(2 * np.pi * phi[:, None] * np.arange(1, 10)) \
        * (f0[0] > 0)
    np.testing.assert_allclose(sines.numpy()[0], exact, atol=2e-5)


@pytest.mark.parametrize("T", [12, 19, 200, 640])
def test_lowpass_filter_matches_jax(T):
    from promptttspp_tpu.ops.filters import lowpass_filter as jax_lowpass
    from promptttspp_tpu_torch.ops.filters import lowpass_filter

    x = np.random.RandomState(T).randn(3, T).astype(np.float32) + 5.0
    ref = np.asarray(jax.jit(jax_lowpass)(jnp.asarray(x)))
    out = lowpass_filter(torch.from_numpy(x), fs=100, cutoff=20).numpy()
    # float64 impulse response against the float32 recurrence
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)
    if T <= 18:
        np.testing.assert_array_equal(out, x)  # too short: unchanged


def test_masks_match_jax():
    from promptttspp_tpu.ops import masks as jm
    from promptttspp_tpu_torch.ops import masks as tm

    rng = np.random.RandomState(0)
    dur = rng.randint(0, 5, (3, 7)).astype(np.int32)
    pmask = np.arange(7)[None, :] < np.array([7, 4, 1])[:, None]
    x = rng.randn(3, 7, 5).astype(np.float32)
    np.testing.assert_array_equal(
        tm.generate_path(torch.from_numpy(dur), torch.from_numpy(pmask),
                         20).numpy(),
        np.asarray(jm.generate_path(jnp.asarray(dur), jnp.asarray(pmask),
                                    20)))
    np.testing.assert_allclose(
        tm.expand_by_durations(torch.from_numpy(x), torch.from_numpy(dur),
                               torch.from_numpy(pmask), 20).numpy(),
        np.asarray(jm.expand_by_durations(jnp.asarray(x), jnp.asarray(dur),
                                          jnp.asarray(pmask), 20)),
        atol=1e-6)
    v = np.array([[0.0, 2.0, 0.5]], np.float32)
    np.testing.assert_allclose(tm.to_log_scale(torch.from_numpy(v)).numpy(),
                               np.asarray(jm.to_log_scale(jnp.asarray(v))),
                               atol=1e-7)


@pytest.mark.parametrize("k", [4, 6, 3])
def test_amp_layer_at_any_kernel_size_matches_jax(k):
    """The port's AMPLayer on the CPU against JAX's at even kernel sizes,
    where both convolutions pad as XLA's ``"SAME"`` (a total of
    (k-1)·d, the left half rounded down), and at an odd one; within 1e-5.
    """
    from promptttspp_tpu.vocoders.bigvgan import AMPLayer as JaxAMPLayer
    from promptttspp_tpu_torch.vocoders.bigvgan import AMPLayer
    from tests.test_torch_acoustic import perturbed

    x = np.random.RandomState(k).randn(1, 70, 8).astype(np.float32)
    jlayer = JaxAMPLayer(8, k, 3)
    variables = perturbed(jax.jit(jlayer.init)(jax.random.PRNGKey(k),
                                               jnp.asarray(x)))
    ref = np.asarray(jax.jit(jlayer.apply)(variables, jnp.asarray(x)))
    layer = AMPLayer(8, k, 3)
    load_jax_variables(layer, variables)
    with torch.no_grad():
        out = layer(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == x.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
