"""Pipeline parallelism of the port (``parallel/pp.py``) on the CPU: the
GPipe timetable over the DiffNet held to JAX's ``denoise_pipelined``,
forward and gradients; JAX's refusals; the pipelined sampler and the
pipelined request of ``Synthesizer(decode_pipelined=True)`` against the
unpipelined ones.

The port's stages run on a ``Mesh`` of CPU devices in this process; the
ranks of a model group (training) are exercised in
``tests/test_torch_tp.py``.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from promptttspp_tpu_torch.compat.from_jax import jax_params_to_state_dict
from promptttspp_tpu_torch.models.diffusion import DiffNet
from promptttspp_tpu_torch.parallel.mesh import Mesh, make_mesh
from promptttspp_tpu_torch.parallel.pp import (
    StageDevices, check_pipeline, denoise_pipelined)

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_pp.py:44
CASES = [(2, 2, 8), (2, 4, 8), (4, 4, 16)]  # (stages, microbatches, layers)
B, T = 4, 24
LENS = [24, 17, 9, 24]


@functools.lru_cache(maxsize=None)
def _inputs(L):
    """tests/test_pp.py's DiffNet (its widths), its parameters and inputs
    drawn with numpy from a seed (the parameter tree's shapes from an
    abstract init): x, t, cond, a ragged frame mask and the output's
    cotangent w."""
    import jax

    from promptttspp_tpu.models.diffusion import DiffNet as JaxDiffNet

    net = JaxDiffNet(in_dim=10, encoder_hidden_dim=12, residual_layers=L,
                     residual_channels=16, kernel_size=3,
                     dilation_cycle_length=4)
    rng = np.random.RandomState(L)
    x = rng.randn(B, T, 10).astype(np.float32)
    cond = rng.randn(B, T, 12).astype(np.float32)
    t = (np.arange(B, dtype=np.int32) * 13) % 100
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), x, t,
                            cond)["params"]
    # each weight ~ N(0, 1 / fan-in), each bias ~ N(0, 0.1)
    params = jax.tree.map(
        lambda a: (rng.randn(*a.shape) / np.sqrt(
            np.prod(a.shape[:-1]) if len(a.shape) > 1 else 100.0)
                   ).astype(np.float32), shapes)
    mask = (np.arange(T)[None, :, None]
            < np.asarray(LENS)[:, None, None]).astype(np.float32)
    w = rng.randn(B, T, 10).astype(np.float32)
    return net, params, x, t, cond, mask, w


def _jax_case(S, M, L):
    """JAX's pipelined DiffNet on a (1, S) mesh, lowered: for the unmasked
    and the masked forward, the output and the gradients of sum(w * out)
    with respect to the parameters, x and cond -> (lowered program, its
    arguments)."""
    import jax
    import jax.numpy as jnp

    from promptttspp_tpu.parallel.mesh import make_mesh as jax_mesh
    from promptttspp_tpu.parallel.pp import denoise_pipelined as jax_pp

    net, params, x, t, cond, mask, w = _inputs(L)
    mesh = jax_mesh(data=1, model=S, devices=jax.devices()[:S])

    def case(p, x, c):
        out = []
        for m in (None, jnp.asarray(mask)):
            y, vjp = jax.vjp(lambda p, x, c, m=m: jax_pp(
                mesh, net, p, x, t, c, mask=m, n_microbatches=M), p, x, c)
            out.append((y, vjp(jnp.asarray(w))))
        return out

    return jax.jit(case).lower(params, x, cond), (params, x, cond)


@pytest.fixture(scope="module")
def jax_results():
    """Every case's JAX results: traced in turn, compiled in parallel
    threads (XLA's compiler releases the GIL)."""
    import jax

    lowered = {c: _jax_case(*c) for c in CASES}
    with ThreadPoolExecutor(len(CASES)) as pool:
        compiled = dict(zip(lowered, pool.map(
            lambda lw: lw[0].compile(), lowered.values())))
    return {c: [(np.asarray(y), g) for y, g in jax.device_get(
        compiled[c](*lowered[c][1]))] for c in CASES}


def _port_net(net, params, L):
    port = DiffNet(in_dim=10, encoder_hidden_dim=12, residual_layers=L,
                   residual_channels=16, kernel_size=3,
                   dilation_cycle_length=4)
    sd = jax_params_to_state_dict({"params": params})
    port.load_state_dict(sd)
    return port


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("S,M,L", CASES)
def test_pipelined_diffnet_matches_jax(jax_results, S, M, L, masked):
    """``denoise_pipelined`` over S CPU stages in M microbatches against
    JAX's on a (1, S) mesh, on the same carried weights: the output
    and the gradients of sum(w * out) with respect to every parameter, x
    and cond, within JAX's own bar of its pipelined against its plain
    DiffNet."""
    net, params, x, t, cond, mask, w = _inputs(L)
    ref_out, (g_params, g_x, g_cond) = jax_results[S, M, L][int(masked)]
    port = _port_net(net, params, L)
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(cond, requires_grad=True)
    out = denoise_pipelined(Mesh([["cpu"] * S]), port, xt,
                            torch.tensor(t), ct,
                            torch.tensor(mask) if masked else None,
                            n_microbatches=M)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **TOL)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **TOL)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(g_cond), **TOL)
    ref = jax_params_to_state_dict({"params": g_params})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("L,cycle,S,M,B_,msg", [
    (8, 4, 4, 4, 4, "multiple of the dilation cycle"),
    (20, 4, 2, 2, 4, "stage size 10 must be a multiple"),  # the flagship
    (8, 4, 3, 1, 4, "8 layers not divisible into 3 stages"),
    (8, 4, 2, 3, 4, "batch 4 not divisible into 3 microbatches"),
])
def test_pipeline_refusals_match_jax(L, cycle, S, M, B_, msg):
    """JAX's ValueErrors, with its messages: stages that break the
    dilation cycle (S = 2 at the flagship's 20 layers of cycle 4; its only
    S > 1 is 5), layers that do not split into the stages, a batch that
    does not split into the microbatches; raised by the port's check and
    by JAX's ``denoise_pipelined`` alike."""
    import jax

    from promptttspp_tpu.models.diffusion import DiffNet as JaxDiffNet
    from promptttspp_tpu.parallel.mesh import make_mesh as jax_mesh
    from promptttspp_tpu.parallel.pp import denoise_pipelined as jax_pp

    with pytest.raises(ValueError, match=msg):
        check_pipeline(L, cycle, S, M, B_)
    net = JaxDiffNet(in_dim=4, encoder_hidden_dim=4, residual_layers=L,
                     residual_channels=4, dilation_cycle_length=cycle)
    with pytest.raises(ValueError, match=msg):
        jax_pp(jax_mesh(data=1, model=S, devices=jax.devices()[:S]), net,
               {}, np.zeros((B_, 8, 4), np.float32), np.zeros(B_, np.int32),
               np.zeros((B_, 8, 4), np.float32), n_microbatches=M)
    port = DiffNet(4, 4, L, 4, 3, cycle)
    with pytest.raises(ValueError, match=msg):
        denoise_pipelined(Mesh([["cpu"] * S]), port, torch.zeros(B_, 8, 4),
                          torch.zeros(B_, dtype=torch.long),
                          torch.zeros(B_, 8, 4), n_microbatches=M)
    assert check_pipeline(20, 4, 5, 5, 10) is None  # the flagship's S = 5


def _tiny_pipelined_model():
    """The tiny model with a DiffNet of 4 blocks of dilation cycle 2."""
    from promptttspp_tpu_torch import flagship
    from tests.test_torch_cuda import TINY_BERT
    from tests.test_torch_tp import pp_model_config

    return flagship.build_model(pp_model_config(), "cpu", seed=3,
                                bert_config=TINY_BERT)


@pytest.mark.parametrize("plms", [False, True], ids=["ancestral", "plms"])
def test_pipelined_sampler_and_training_forward(plms):
    """The sampler with the pipeline over two CPU stages in 2 microbatches
    (ancestral and PLMS, the conditioner projections computed per stage,
    not hoisted) against the unpipelined one on the same draws, and the
    training forward's epsilon and its gradients."""
    model = _tiny_pipelined_model()
    model.decoder.denoise_fn.requires_grad_(True)
    dec = model.decoder.clone(pndm_speedup=2 if plms else None)
    piped = dec.clone(pipeline=StageDevices(["cpu", "cpu"]),
                      pipeline_microbatches=2)
    g = torch.Generator().manual_seed(0)
    cond = torch.randn(2, 16, 32, generator=g)
    x_T = torch.randn(2, 16, 20, generator=g)
    with torch.no_grad():
        ref = dec.inference(cond, x_T=x_T, zero_noise=False,
                            generator=torch.Generator().manual_seed(1))
        out = piped.inference(cond, x_T=x_T, zero_noise=False,
                              generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    y = torch.randn(2, 16, 20, generator=g)
    mask = (torch.arange(16)[None, :, None] < torch.tensor([16, 11])[
        :, None, None]).float()
    t = torch.tensor([3, 7])
    noise = torch.randn(2, 16, 20, generator=g)
    grads = []
    for d in (dec, piped):
        d.denoise_fn.zero_grad()
        c = cond.clone().requires_grad_()
        _, eps = d(c, y, mask, t=t, noise=noise)
        (eps * noise).sum().backward()
        grads.append((eps.detach(), c.grad, {
            n: p.grad.clone() for n, p in d.denoise_fn.named_parameters()}))
    for a, b in zip(grads[0][:2], grads[1][:2]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)
    for n, v in grads[0][2].items():
        np.testing.assert_allclose(grads[1][2][n].numpy(), v.numpy(),
                                   err_msg=n, **TOL)


def test_one_process_pipelined_training_trains_the_model():
    """Training through the pipeline in one process (the trainer's
    ``StageDevices([device])`` when ``train.mesh.pipeline_microbatches`` is
    set without a model group): a stage device named with its index, as
    "cuda:0" names the "cuda" the trainer asked for, is the DiffNet's own,
    so its blocks take the gradients (a replica took them, and the model's
    blocks got none); a stage on another device refuses a gradient."""
    model = _tiny_pipelined_model()
    diffnet = model.decoder.denoise_fn.requires_grad_(True)
    g = torch.Generator().manual_seed(0)
    x, cond = torch.randn(2, 16, 20, generator=g), torch.randn(
        2, 16, 32, generator=g)
    t = torch.tensor([3, 7])
    grads = []
    for pipeline in (None, StageDevices([torch.device("cpu", 0)])):
        diffnet.zero_grad()
        eps = diffnet(x, t, diffnet.precompute_cond(cond)) \
            if pipeline is None else denoise_pipelined(
                pipeline, diffnet, x, t, cond, n_microbatches=2)
        eps.square().sum().backward()
        grads.append({n: p.grad.clone()
                      for n, p in diffnet.named_parameters()})
    for n, v in grads[0].items():
        np.testing.assert_allclose(grads[1][n].numpy(), v.numpy(),
                                   err_msg=n, **TOL)
    with pytest.raises(ValueError, match="train over a model group"):
        denoise_pipelined(StageDevices(["meta"]), diffnet, x, t, cond)


def test_synthesizer_pipelined_decode_matches_plain():
    """``Synthesizer(decode_pipelined=True, pipeline_microbatches=2,
    mesh=Mesh([[cpu, cpu]]))``: a batch of two requests' mels within 1e-5
    of the unpipelined decode's and their wavs alike."""
    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.infer import Synthesizer
    from tests.test_torch_synth import (
        MEAN, PROMPTS, SEQS, STD, UPSAMPLE, VOC_KW, WordIdTokenizer)

    model = _tiny_pipelined_model()
    kw = dict(tokenizer=WordIdTokenizer(), device="cpu",
              mel_stats={"mean": MEAN, "std": STD}, frame_quantum=64,
              max_frames_cap=512, upsample=UPSAMPLE)
    vocoder = flagship.build_vocoder("cpu", 5, VOC_KW)
    piped = Synthesizer(model, vocoder, decode_pipelined=True,
                        pipeline_microbatches=2,
                        mesh=make_mesh(model=2, devices=["cpu", "cpu"]), **kw)
    plain = Synthesizer(model, vocoder, **kw)
    req = dict(prompts=PROMPTS, use_max=False, noise_scale=0.5, seed=3)
    wavs, mels = piped.synthesize(SEQS, **req)
    ref_wavs, ref_mels = plain.synthesize(SEQS, **req)
    assert len(mels) == len(SEQS) == 2
    for m, r in zip(mels, ref_mels):
        np.testing.assert_allclose(m, r, rtol=0, atol=1e-5 * STD)
    for w, r in zip(wavs, ref_wavs):
        np.testing.assert_allclose(w, r, rtol=0, atol=1e-4)
