"""The DiffNet's fused block path (``models/diffusion.py::DiffNet.fuses``,
``ops/kernels/diffnet.py``) on the CPU: the kernels' plain versions, run
through the path's orchestration, give ``ResidualBlock.forward``'s bits;
which calls take the path; the wrappers' refusals. The kernels themselves
are held to the same plain versions on the card (``tests/
test_torch_cuda.py``).

The path runs only on CUDA tensors; these tests patch ``DiffNet.fuses``
to judge a CPU tensor as it judges a CUDA one, so the path runs the
wrappers' plain versions.
"""

import contextlib
from unittest import mock

import pytest
import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.models import diffusion
from promptttspp_tpu_torch.models.diffusion import DiffNet
from promptttspp_tpu_torch.ops.kernels import diffnet as kernels
from promptttspp_tpu_torch.parallel.pp import StageDevices
from promptttspp_tpu_torch.parallel.tp import shard_module
from tests.test_torch_cuda import TINY_BERT, tiny_model_config


class _AsIfCuda:
    """What ``DiffNet.fuses`` reads of a CUDA tensor."""

    is_cuda = True


def _on_cpu():
    """``DiffNet.fuses`` judging every tensor as a CUDA one."""
    fuses = DiffNet.fuses
    return mock.patch.object(
        DiffNet, "fuses",
        lambda self, x, mask=None: fuses(self, _AsIfCuda(), mask))


@contextlib.contextmanager
def _fused_calls():
    """The blocks of each ``DiffNet._fused_blocks`` call, in a list."""
    calls = []
    fused_blocks = DiffNet._fused_blocks

    def counted(self, *args):
        calls.append(len(self.residual_layers))
        return fused_blocks(self, *args)

    with mock.patch.object(DiffNet, "_fused_blocks", counted):
        yield calls


@contextlib.contextmanager
def _kernels_refused():
    """The path's kernel entries raise when called."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached the fused block path")

    with mock.patch.object(kernels, "entry", refuse), \
            mock.patch.object(kernels, "gate", refuse), \
            mock.patch.object(kernels, "residual", refuse):
        yield


def _net(L=4, R=16, H=12, k=3, cycle=4, in_dim=10, seed=0):
    torch.manual_seed(seed)
    return DiffNet(in_dim=in_dim, encoder_hidden_dim=H, residual_layers=L,
                   residual_channels=R, kernel_size=k,
                   dilation_cycle_length=cycle).eval()


def _inputs(B, T, H=12, in_dim=10, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, T, in_dim, generator=g),
            torch.randint(0, 100, (B,), generator=g),
            torch.randn(B, T, H, generator=g))


@pytest.mark.parametrize("io_dtype", [None, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("B,T,k,cycle", [
    (2, 37, 3, 4), (1, 301, 3, 2), (3, 20, 4, 2), (16, 64, 3, 4)])
def test_fused_path_gives_the_plain_bits(B, T, k, cycle, io_dtype):
    """DiffNet.forward on the fused path (the wrappers' plain versions)
    equals the block-by-block forward bit for bit: odd and even kernel
    sizes, B = 1 and more, an odd T, float32 and bf16 conditioner
    projections; the path counts its blocks."""
    net = _net(k=k, cycle=cycle)
    x, steps, cond = _inputs(B, T)
    with torch.no_grad():
        projs = net.precompute_cond(cond, io_dtype)
        plain = net(x, steps, projs)
        with _on_cpu(), _fused_calls() as calls:
            fused = net(x, steps, projs)
            assert net.fuses(x)
        assert not net.fuses(x)  # a CPU tensor does not fuse
    assert calls == [4]
    torch.testing.assert_close(fused, plain, atol=0, rtol=0)


@pytest.mark.parametrize("B,T,d", [(2, 33, 1), (1, 50, 8), (3, 17, 4)])
def test_wrappers_chain_equals_the_block(B, T, d):
    """One ResidualBlock: its conv on the [B, R, T] input, ``gate``, the
    projection without its bias and ``residual`` give the block's (x,
    skip) bit for bit; ``entry`` gives relu and the step add."""
    R, H = 8, 6
    torch.manual_seed(2)
    block = diffusion.ResidualBlock(H, R, 3, d).eval()
    g = torch.Generator().manual_seed(3)
    h, cp = torch.randn(B, T, R, generator=g), torch.randn(B, T, 2 * R,
                                                           generator=g)
    t_emb = torch.randn(B, R, generator=g)
    with torch.no_grad():
        dp = block.diffusion_projection(t_emb)
        x, u = kernels.entry(h, dp)
        torch.testing.assert_close(x, torch.relu(h), atol=0, rtol=0)
        want_x, want_skip = block(x, cp, t_emb)
        conv = block.dilated_conv
        c = torch.nn.functional.conv1d(u, conv.weight, conv.bias, 1, d, d)
        z = kernels.gate(c, None, cp)
        proj = block.output_projection
        o = torch.matmul(z, proj.weight[:, :, 0].t())
        got_x, skip, nxt = kernels.residual(o, proj.bias, x, None, None)
    assert nxt is None
    torch.testing.assert_close(got_x, want_x, atol=0, rtol=0)
    torch.testing.assert_close(skip, want_skip, atol=0, rtol=0)


def _denoiser_calls(dec, run):
    """``run()``'s result and the calls of ``dec``'s DiffNet in it."""
    calls = []
    hook = dec.denoise_fn.register_forward_pre_hook(
        lambda mod, args: calls.append(1))
    try:
        return run(), len(calls)
    finally:
        hook.remove()


def test_decode_counts_every_block_fused():
    """A 10-step eager decode runs K x L blocks (``n_denoiser_calls`` x L,
    what a decode graph's ``decode.blocks_run`` counts), all through the
    fused path when its calls fuse, none otherwise; the mel is the same."""
    model = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    dec = model.decoder
    L = len(dec.denoise_fn.residual_layers)
    cond = torch.randn(1, 24, 32, generator=torch.Generator().manual_seed(4))
    outs, counts = [], []
    for ctx in (contextlib.nullcontext(), _on_cpu()):
        with ctx, _fused_calls() as fused, torch.inference_mode():
            out, n = _denoiser_calls(dec, lambda: dec.inference(
                cond, generator=torch.Generator().manual_seed(5)))
        outs.append(out)
        counts.append([n * L, sum(fused)])
    assert dec.n_denoiser_calls() * L == 10 * 2
    assert counts == [[10 * 2, 0], [10 * 2, 10 * 2]]
    torch.testing.assert_close(outs[1], outs[0], atol=0, rtol=0)


@pytest.mark.parametrize("speedup", [None, 2, 3, 10])
def test_denoiser_calls_per_decode(speedup):
    """``n_denoiser_calls`` is the DiffNet calls of one decode: ancestral
    and PLMS (its first step calls the denoiser twice)."""
    model = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    dec = model.decoder.clone(pndm_speedup=speedup)
    cond = torch.randn(1, 12, 32, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        _, n = _denoiser_calls(dec, lambda: dec.inference(
            cond, generator=torch.Generator().manual_seed(5)))
    assert n == dec.n_denoiser_calls() == {None: 10, 2: 6, 3: 4, 10: 2}[
        speedup]


def _model():
    """The tiny model with a DiffNet of 4 blocks of dilation cycle 2 (two
    pipeline stages of one cycle each)."""
    cfg = tiny_model_config()
    cfg["decoder"]["denoise_fn"].update(residual_layers=4,
                                        dilation_cycle_length=2)
    return flagship.build_model(cfg, "cpu", 0, TINY_BERT)


class _OneRank:
    """A model group of one rank whose collectives are the identity."""

    rank, world = 0, 1

    def copy(self, x):
        return x

    def reduce(self, x):
        return x

    def gather(self, x, dim=-1):
        return x


def _pipelined_decode(dec, cond):
    piped = dec.clone(pipeline=StageDevices(["cpu", "cpu"]),
                      pipeline_microbatches=1)
    return piped.inference(cond, generator=torch.Generator().manual_seed(6))


def _sharded_decode(dec, cond):
    model = _model()
    shard_module(model, _OneRank())
    assert not model.decoder.denoise_fn.fuses(cond)
    return model.decoder.inference(
        cond, generator=torch.Generator().manual_seed(6))


def _hooked_decode(dec, cond):
    """A decode with a forward hook on one block's output projection: the
    fused path would call its product without it."""
    seen = []
    proj = dec.denoise_fn.residual_layers[1].output_projection
    hook = proj.register_forward_hook(lambda *a: seen.append(1))
    try:
        assert not dec.denoise_fn.fuses(cond)
        out = dec.inference(cond, generator=torch.Generator().manual_seed(6))
    finally:
        hook.remove()
    assert len(seen) == dec.n_denoiser_calls()
    return out


def _grad_decode(dec, cond):
    with torch.enable_grad():
        return dec.inference(cond, generator=torch.Generator().manual_seed(6))


def _masked_forward(dec, cond):
    net = dec.denoise_fn
    x = torch.randn(2, cond.shape[1], 20)
    mask = torch.ones(2, cond.shape[1], 1)
    return net(x, torch.tensor([3, 4]), net.precompute_cond(cond), mask)


@pytest.mark.parametrize("call", [_grad_decode, _masked_forward,
                                  _pipelined_decode, _sharded_decode,
                                  _hooked_decode],
                         ids=["grad", "mask", "pipelined", "tp_sharded",
                              "hooked"])
def test_calls_that_keep_the_block_path(call):
    """A grad-enabled call, a masked (training) call, a pipelined decode
    (blocks per stage), a decode of TP-sharded blocks and one whose block
    has a hook never reach the fused path's kernels, even on a tensor that
    fuses; the same decode with grad off does (the control)."""
    dec = _model().decoder
    cond = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(7))
    with _on_cpu(), _kernels_refused(), torch.no_grad():
        out = call(dec, cond)
        with pytest.raises(AssertionError, match="fused block path"):
            dec.inference(cond, generator=torch.Generator().manual_seed(6))
    assert torch.isfinite(out).all()


def _block_by_block(net, x, steps, projs, mask):
    """DiffNet.forward as it was before the fused path: relu of the input
    projection, each block in turn, the skip sum from 0.0."""
    x = torch.relu(net.input_projection(x))
    t_emb = net.mlp(diffusion.sinusoidal_pos_emb(
        steps, net.residual_channels, net.scale))
    skip_sum = 0.0
    for block, cp in zip(net.residual_layers, projs):
        x, skip = block(x, cp, t_emb, mask)
        skip_sum = skip_sum + skip
    x = skip_sum / len(net.residual_layers) ** 0.5
    return net.output_projection(torch.relu(net.skip_projection(x)))


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_training_step_is_unchanged(masked):
    """With grad on (a training step), DiffNet.forward and its backward
    give the block-by-block forward's outputs and gradients bit for bit,
    on a tensor that would otherwise fuse."""
    def step(forward):
        net = _net(L=3, cycle=3, seed=8).train().requires_grad_(True)
        x, steps, cond = _inputs(2, 21, seed=9)
        cond.requires_grad_(True)
        mask = None
        if masked:
            mask = torch.ones(2, 21, 1)
            mask[1, 15:] = 0
        eps = forward(net, x, steps, net.precompute_cond(cond), mask)
        (eps * eps).sum().backward()
        return [eps.detach(), cond.grad] + [p.grad for p in net.parameters()]

    with _on_cpu():
        got = step(lambda net, *a: net(*a))
    for a, b in zip(got, step(_block_by_block)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("name,call", [
    ("gate", lambda: kernels.gate(torch.zeros(1, 8, 5), None,
                                  torch.zeros(1, 5, 8, dtype=torch.float16))),
    ("gate", lambda: kernels.gate(torch.zeros(1, 8, 5, dtype=torch.float64),
                                  None, torch.zeros(1, 5, 8))),
    ("entry", lambda: kernels.entry(torch.zeros(1, 5, 4, dtype=torch.float64),
                                    torch.zeros(1, 4))),
    ("residual", lambda: kernels.residual(
        torch.zeros(1, 5, 8, dtype=torch.bfloat16), torch.zeros(8),
        torch.zeros(1, 5, 4), None, None)),
])
def test_wrappers_refuse_other_dtypes(name, call):
    with pytest.raises(TypeError, match=name):
        call()
