"""The decoder's options and the serving prewarm against the JAX package
on the CPU: PLMS (``pndm_speedup``), the cosine schedule, the a_min/a_max
normalisation, the step-embedding scale, bf16 decode storage
(``infer_io_dtype`` with ``Synthesizer(decode_param_dtype=...)``), one
``p_sample`` step, the speculative prewarm grid, and each decoder key of
the model config built through ``flagship.build_model``.

Each JAX ``GaussianDiffusion`` is initialised, its parameters perturbed
with seeded numpy noise (``tests/test_torch_acoustic.py::perturbed``), and
loaded into the port's twin through ``compat/from_jax.py``; both decode
the same numpy ``cond`` from the same ``x_T`` with zero noise.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu.infer import Synthesizer as JaxSynthesizer
from promptttspp_tpu.models import diffusion as jd
from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.infer import Synthesizer, _rounded_decoder
from promptttspp_tpu_torch.models.diffusion import (
    DiffNet, GaussianDiffusion, sinusoidal_pos_emb)
from tests.test_torch_acoustic import TOL, perturbed
from tests.test_torch_cuda import C, MEL, TINY_BERT, tiny_model_config
from tests.test_torch_infer import _assert_match_jax, _prompt_x_T
from tests.test_torch_synth import (MEAN, PROMPTS, SEQS, STD, UPSAMPLE,
                                    synths)  # noqa: F401 (fixture)

DN = dict(in_dim=MEL, encoder_hidden_dim=C, residual_layers=2,
          residual_channels=16, kernel_size=3, dilation_cycle_length=2)
B, T = 2, 24
# bf16 storage against the float32 chain: tests/test_decode_bf16.py's
# bounds (bf16 rounding, 2^-8 relative, accumulated over the chain), as
# fractions of the norm scale
BF16_MAX, BF16_MEAN = 0.15, 0.02


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, C).astype(np.float32),
            rng.randn(B, T, MEL).astype(np.float32))


def _init(jdec, seed=0):
    """Perturbed numpy variables of a JAX GaussianDiffusion."""
    cond, y = _inputs(seed + 10)
    variables = jax.jit(jdec.init)(
        {"params": jax.random.PRNGKey(seed),
         "diffusion": jax.random.PRNGKey(seed + 1)}, cond, y)
    return perturbed(jax.device_get(variables), seed)


def twins(K=20, scale=1.0, seed=0, **opts):
    """-> (JAX GaussianDiffusion, its variables, the port's twin on the
    CPU) at the tiny widths, with ``opts`` (norm_scale 6 by default)."""
    opts.setdefault("norm_scale", 6.0)
    jdec = jd.GaussianDiffusion(in_dim=C, out_dim=MEL, K_step=K,
                                denoise_fn=jd.DiffNet(**DN, scale=scale),
                                **opts)
    variables = _init(jdec, seed)
    port = GaussianDiffusion(DiffNet(**DN, scale=scale), out_dim=MEL,
                             K_step=K, **opts)
    load_jax_variables(port, variables)
    return jdec, variables, port.eval()


def jax_decode(jdec, params, cond, x_T):
    return np.asarray(jdec.apply(
        {"params": params}, jnp.asarray(cond), x_T=jnp.asarray(x_T),
        zero_noise=True, method=jd.GaussianDiffusion.inference))


def port_decode(port, cond, x_T):
    with torch.no_grad():
        return port.inference(torch.from_numpy(cond),
                              x_T=torch.from_numpy(x_T),
                              zero_noise=True).numpy()


def _check(jdec, variables, port, seed=1, tol=TOL):
    cond, x_T = _inputs(seed)
    out = port_decode(port, cond, x_T)
    np.testing.assert_allclose(
        out, jax_decode(jdec, variables["params"], cond, x_T), **tol)
    return out


def test_plms_matches_jax():
    """PLMS at ``pndm_speedup`` 5 with K=20: steps 15, 10, 5, 0, the first
    with its two denoiser calls, then orders 2, 3 and 4."""
    jdec, variables, port = twins(K=20, pndm_speedup=5)
    assert port.n_draws() == 1
    out = _check(jdec, variables, port)
    _, _, ancestral = twins(K=20)
    cond, x_T = _inputs(1)
    assert np.abs(out - port_decode(ancestral, cond, x_T)).max() > 1e-2


def test_cosine_schedule_matches_jax():
    """The cosine schedule's tables equal JAX's float32 tables, and the
    ancestral decode on them matches."""
    jdec, variables, port = twins(K=20, schedule_type="cosine")
    tables = jdec.apply({"params": variables["params"]}, method=lambda m: (
        m.alphas_cumprod, m.sqrt_recip_alphas_cumprod,
        m.sqrt_recipm1_alphas_cumprod, m.posterior_log_variance_clipped,
        m.posterior_mean_coef1, m.posterior_mean_coef2))
    for name, ref in zip(("alphas_cumprod", "sqrt_recip_alphas_cumprod",
                          "sqrt_recipm1_alphas_cumprod",
                          "posterior_log_variance_clipped",
                          "posterior_mean_coef1", "posterior_mean_coef2"),
                         tables):
        np.testing.assert_array_equal(
            np.asarray(getattr(port, name), np.float32), np.asarray(ref),
            err_msg=name)
    _, _, linear = twins(K=20)
    assert port.alphas_cumprod != linear.alphas_cumprod
    _check(jdec, variables, port)


def test_a_min_a_max_normalisation_matches_jax():
    """``norm_scale`` None maps the mel from [a_min, a_max] to [-1, 1]:
    ``_norm``, ``_denorm`` and the decode match JAX."""
    jdec, variables, port = twins(K=20, norm_scale=None, a_min=-5.0,
                                  a_max=3.0)
    mel = np.random.RandomState(2).randn(B, T, MEL).astype(np.float32) * 3
    for name in ("_norm", "_denorm"):
        ref = jdec.apply({"params": variables["params"]}, jnp.asarray(mel),
                         method=lambda m, x: getattr(m, name)(x))
        np.testing.assert_allclose(
            getattr(port, name)(torch.from_numpy(mel)).numpy(),
            np.asarray(ref), **TOL)
    out = _check(jdec, variables, port)
    assert out.min() >= -5.0 - 1e-5 and out.max() <= 3.0 + 1e-5


def test_step_embedding_scale_matches_jax():
    """DiffNet's ``scale`` multiplies the step before its sinusoidal
    embedding, as JAX's SinusoidalPosEmb does."""
    t = np.arange(20, dtype=np.int32)
    for scale in (1.0, 1000.0):
        ref = jd.SinusoidalPosEmb(16, scale).apply({}, jnp.asarray(t))
        out = sinusoidal_pos_emb(torch.from_numpy(t), 16, scale)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    jdec, variables, port = twins(K=20, scale=1000.0)
    assert port.denoise_fn.scale == 1000.0
    _check(jdec, variables, port)


@pytest.mark.parametrize("t", [19, 7, 0])
def test_p_sample_matches_jax(t):
    """One ancestral step with injected noise (none at t = 0)."""
    jdec, variables, port = twins(K=20)
    cond, x = _inputs(3)
    noise = np.random.RandomState(4).randn(B, T, MEL).astype(np.float32)
    ref = jdec.apply(
        {"params": variables["params"]}, jnp.asarray(x), jnp.asarray(cond),
        jnp.asarray(noise),
        method=lambda m, x, c, n: m.p_sample(x, jnp.full((B,), t), c, n))
    with torch.no_grad():
        projs = port.denoise_fn.precompute_cond(torch.from_numpy(cond))
        out = port.p_sample(torch.from_numpy(x), t, projs,
                            torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _cast_bf16(params):
    return jax.tree.map(lambda a: np.asarray(
        jnp.asarray(a).astype(jnp.bfloat16)), params)


@pytest.mark.parametrize("pndm", [None, 5])
@pytest.mark.parametrize("io,params", [(True, False), (False, True),
                                       (True, True)],
                         ids=["infer_io_dtype", "decode_param_dtype",
                              "both"])
def test_bf16_decode_storage_matches_jax(io, params, pndm):
    """``infer_io_dtype=bfloat16`` and the denoiser's parameters rounded to
    bf16 (``Synthesizer(decode_param_dtype=...)``'s rounding) against JAX's
    same knobs (tests/test_decode_bf16.py): the same bf16 roundings of the
    parameters, of cond and of its projections, computed as flax promotes
    (in bf16 when both are bf16), the rest in float32. Against JAX within
    the float32 tolerance, and against the float32 chain within
    tests/test_decode_bf16.py's bounds."""
    jdec, variables, port32 = twins(K=20, pndm_speedup=pndm)
    jbf, port = jdec, port32
    jparams = variables["params"]
    if io:
        jbf = jdec.clone(infer_io_dtype="bfloat16")
        port = port.clone(infer_io_dtype="bfloat16")
    if params:
        jparams = _cast_bf16(jparams)
        port = _rounded_decoder(port, "bfloat16")
        assert port.denoise_fn is not port32.denoise_fn
    cond, x_T = _inputs(1)
    out = port_decode(port, cond, x_T)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, jax_decode(jbf, jparams, cond, x_T),
                               **TOL)
    f32 = port_decode(port32, cond, x_T)
    dev = np.abs(out - f32)
    assert 0 < dev.max() < BF16_MAX * 6.0
    assert dev.mean() < BF16_MEAN * 6.0


def _decoder_twin(cfg):
    """The JAX GaussianDiffusion of a model config's ``decoder`` section,
    field for field."""
    dec = dict(cfg["decoder"])
    return jd.GaussianDiffusion(denoise_fn=jd.DiffNet(**dec.pop(
        "denoise_fn")), **dec)


@pytest.mark.parametrize("path,value", [
    (("decoder", "pndm_speedup"), 5),
    (("decoder", "schedule_type"), "cosine"),
    (("decoder", "infer_io_dtype"), "bfloat16"),
    (("decoder", "denoise_fn", "scale"), 1000.0),
    (("decoder", "norm_scale"), None),
    (("decoder", "a_min"), -4.0),
], ids=lambda v: ".".join(v) if isinstance(v, tuple) else repr(v))
def test_decoder_config_key_builds_and_matches_jax(path, value):
    """Each decoder key of the model config that the JAX GaussianDiffusion
    and DiffNet read, at another value than the flagship's, builds through
    ``flagship.build_model`` (where it was refused before the port had
    it), and the built decoder decodes as JAX's decoder of the same config
    section. The a_min case sets ``norm_scale: null`` too, where a_min and
    a_max act."""
    cfg = copy.deepcopy(tiny_model_config())
    section = cfg
    for key in path[:-1]:
        section = section[key]
    section[path[-1]] = value
    if path[-1] == "a_min":
        cfg["decoder"].update(norm_scale=None, a_max=4.0)
    port = flagship.build_model(cfg, "cpu", 0, TINY_BERT).decoder
    jdec = _decoder_twin(cfg)
    variables = _init(jdec)
    load_jax_variables(port, variables)
    got = {"pndm_speedup": port.pndm_speedup,
           "schedule_type": port.options["schedule_type"],
           "infer_io_dtype": port.io_dtype, "scale": port.denoise_fn.scale,
           "norm_scale": port.norm_scale, "a_min": port.a_min}[path[-1]]
    assert got == (torch.bfloat16 if value == "bfloat16" else value)
    _check(jdec, variables, port)


class _GridStub:
    """tests/test_infer.py::_GridStub's settings: the attributes that
    ``_speculative_grid`` reads."""

    phone_quantum, frame_quantum, max_frames_cap = 16, 128, 2048
    spec_duration_table = None
    spec_duration_std = None
    spec_frames_per_phone = 10.0
    spec_margin = 3.0
    spec_rate_margin = 0.2


@pytest.mark.parametrize("table", [False, True])
def test_speculative_grid_matches_jax(table):
    stub = _GridStub()
    if table:
        rng = np.random.RandomState(5)
        stub.spec_duration_table = np.r_[0.0, rng.uniform(3, 14, 70)]
        stub.spec_duration_std = np.r_[0.0, rng.uniform(0, 4, 70)]
    for max_phones in (1, 16, 64, 100, 256):
        ours = Synthesizer._speculative_grid(stub, max_phones)
        assert ours == JaxSynthesizer._speculative_grid(stub, max_phones)
        assert {p for p, _ in ours} == set(
            range(16, bucket_shape(max_phones, 16) + 1, 16))


@pytest.fixture(scope="module")
def port_kw(synths):  # noqa: F811
    _, psynth = synths
    return dict(model=psynth.model, vocoder=psynth.vocoder,
                tokenizer=psynth.tokenizer,
                mel_stats={"mean": MEAN, "std": STD}, frame_quantum=64,
                max_frames_cap=256, upsample=UPSAMPLE, device="cpu")


def test_prewarm_rows_match_the_jax_grid(port_kw):
    """``prewarm`` returns one row per (B, Tp, Tf, L) of JAX's grid
    (speculative and full) plus the streaming vocoder's row; a request
    after it equals the same request without it, bit for bit."""
    kw = dict(speculative=True, spec_frames_per_phone=8.0, chunk_frames=16,
              halo_frames=4, first_chunk_frames=8, **port_kw)
    fresh = Synthesizer(**kw).synthesize(SEQS, PROMPTS, seed=4)
    synth = Synthesizer(**kw)
    rows = synth.prewarm(batch_sizes=(1, 2), prompt_lens=(16,),
                         grid="speculative", max_phones=20, streaming=True)
    grid = JaxSynthesizer._speculative_grid(synth, 20)
    assert [(r["B"], r["Tp"], r["Tf"], r["L"]) for r in rows
            if "program" not in r] == [
        (b, p, f, 16) for b in (1, 2) for p, f in grid]
    assert [(r["B"], r["Tf"]) for r in rows if "program" in r] == [
        (1, 24), (2, 24)]
    assert all(r["seconds"] >= 0 for r in rows)
    after = synth.synthesize(SEQS, PROMPTS, seed=4)
    for a, b in zip(fresh[0] + fresh[1], after[0] + after[1]):
        np.testing.assert_array_equal(a, b)
    full = Synthesizer(**kw).prewarm(prompt_lens=(8,), grid="full",
                                     max_phones=16)
    assert {(r["Tp"], r["Tf"]) for r in full} == {
        (16, f) for f in (64, 128, 192, 256)}
    with pytest.raises(ValueError, match="grid"):
        synth.prewarm(grid="other")


def test_plms_synthesizer_matches_jax(synths):  # noqa: F811
    """A whole request with ``pndm_speedup`` 5 (K=10: steps 5 and 0)
    against the JAX ``Synthesizer`` with the same decoder option."""
    jsynth, psynth = synths
    jplms = JaxSynthesizer(
        jsynth.model.clone(decoder=jsynth.model.decoder.clone(
            pndm_speedup=5)), jsynth.variables, vocoder=jsynth.vocoder,
        vocoder_variables=jsynth.vocoder_variables,
        tokenizer=jsynth.tokenizer, mel_stats={"mean": MEAN, "std": STD},
        frame_quantum=64, max_frames_cap=512, upsample=UPSAMPLE)
    model = copy.deepcopy(psynth.model)
    model.decoder = model.decoder.clone(pndm_speedup=5)
    plms = Synthesizer(model, psynth.vocoder, tokenizer=psynth.tokenizer,
                       mel_stats={"mean": MEAN, "std": STD},
                       frame_quantum=64, max_frames_cap=512,
                       upsample=UPSAMPLE, device="cpu")
    x_T = _prompt_x_T(plms)
    kw = dict(use_max=True, noise_scale=0.0, seed=11)
    ref = jplms.synthesize(SEQS, PROMPTS, x_T=jnp.asarray(x_T), **kw)
    out = plms.synthesize(SEQS, PROMPTS, x_T=x_T, **kw)
    _assert_match_jax(out, ref)
    ancestral = psynth.synthesize(SEQS, PROMPTS, x_T=x_T, zero_noise=True,
                                  **kw)
    assert np.abs(out[1][0] - ancestral[1][0]).max() > 1e-2


def test_float32_math_restores_the_callers_flags():
    """The decode's and the training step's scope turns TF32 off for
    cuDNN's convolutions and recurrent layers (the style encoder's GRU) and
    for cuBLAS, and gives the caller's settings back after it."""
    from promptttspp_tpu_torch.models.diffusion import float32_math

    flags = (torch.backends.cudnn.conv, torch.backends.cudnn.rnn,
             torch.backends.cuda.matmul)
    saved = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "tf32"
    try:
        with float32_math():
            assert [f.fp32_precision for f in flags] == ["ieee"] * 3
        assert [f.fp32_precision for f in flags] == ["tf32"] * 3
    finally:
        for f, value in zip(flags, saved):
            f.fp32_precision = value
