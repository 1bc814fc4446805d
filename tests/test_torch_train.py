"""Training of the acoustic model in the port against its JAX twin, on the
CPU: ``WeightedBatchNorm``, ``Dropout``, ``mdn_loss``, the train-mode and
eval-mode losses, the gradients, the BERT freeze, the Noam rate and three
whole train steps (``train/state.py`` against ``make_train_step``).

The JAX twin is ``tests/test_train.py::tiny_model`` with every dropout rate
0 (its positional encodings' too), the port's the same widths
(``tests/test_torch_cuda.py::tiny_model_config``) with rates 0; both carry
the perturbed weights of ``tests/test_torch_acoustic.py::init_jax_twins``
through ``compat/from_jax.py``. JAX's random streams cannot be reproduced
in torch, so the diffusion steps and noise are given in the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.compat.from_jax import (
    jax_params_to_state_dict, load_jax_variables)
from promptttspp_tpu_torch.nn import layers
from promptttspp_tpu_torch.nn.mdn import mdn_loss
from promptttspp_tpu_torch.train.schedule import noam_schedule
from promptttspp_tpu_torch.train.state import TrainState, bert_trainable
from tests.test_torch_acoustic import init_jax_twins
from tests.test_torch_cuda import (
    OPT, TINY_BERT, ZERO_BERT, tiny_model_config, torch_batch, train_batch,
    zero_dropout_config)

LOSS_TOL = dict(atol=1e-4, rtol=1e-3)
LOSS_KEYS = ("loss", "dec", "dur", "cf0", "vuv", "style")


def zero_dropout_jax(model):
    """tests/test_train.py's tiny model (built with dropout=False) with the
    dropout of its two positional encodings at 0 too."""
    va = model.variance_adaptor
    return model.clone(
        encoder=model.encoder.clone(positional_dropout_rate=0.0),
        variance_adaptor=va.clone(
            frame_prior_network=va.frame_prior_network.clone(
                pos_enc_p_dropout=0.0)))


def port_model(variables):
    port = flagship.build_model(zero_dropout_config(), "cpu", 0, ZERO_BERT)
    return load_jax_variables(port, variables).train()


@pytest.fixture(scope="module")
def twins():
    model, variables, _ = init_jax_twins()
    return zero_dropout_jax(model), variables


def _filter(tree, mask):
    """The leaves of ``tree`` where ``mask`` holds, as a nested dict."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {k: _filter(v, mask[k]) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if v is not None and not (isinstance(v, dict) and not v)}
    return tree if bool(mask) else None


def _named(tree, collection="params"):
    return jax_params_to_state_dict({collection: jax.device_get(tree)})


# ------------------------------------------------------------- layers


@pytest.mark.parametrize("shape", [(3, 17, 6), (3, 9, 5, 4)],
                         ids=["1d", "2d"])
def test_weighted_batchnorm_matches_jax(shape):
    """Train mode with row weights (1, 0, 1): output and the updated
    running statistics; then eval mode on them."""
    from promptttspp_tpu.nn.layers import WeightedBatchNorm as JaxWBN

    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    C = shape[-1]
    params = {"scale": rng.rand(C).astype(np.float32) + 0.5,
              "bias": rng.randn(C).astype(np.float32)}
    stats = {"mean": rng.randn(C).astype(np.float32),
             "var": rng.rand(C).astype(np.float32) + 0.5}
    y, mut = JaxWBN().apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), use_running_average=False,
                            row_weight=jnp.asarray(w),
                            mutable=["batch_stats"])
    bn = layers.WeightedBatchNorm(C).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    cl = lambda a: np.moveaxis(a, 1, -1)  # noqa: E731 channel last
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    out = bn(xt, torch.from_numpy(w))
    np.testing.assert_allclose(cl(out.detach().numpy()), np.asarray(y),
                               atol=1e-6, rtol=1e-5)
    new = mut["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"],
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"],
                               atol=1e-6, rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    y_eval = JaxWBN().apply({"params": params, "batch_stats": new},
                            jnp.asarray(x), use_running_average=True)
    out = bn.eval()(xt)
    np.testing.assert_allclose(cl(out.detach().numpy()), np.asarray(y_eval),
                               atol=1e-6, rtol=1e-5)
    # every row counts when no weight is given, as with weights all 1
    bn.train()
    a = bn(xt)
    b = bn(xt, torch.ones(3))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_dropout_keeps_one_minus_p_and_scales():
    p, n = 0.3, 1_000_000
    drop = layers.Dropout(p).train()
    x = torch.ones(n)
    g = torch.Generator().manual_seed(0)
    drop.generator = g
    y = drop(x)
    kept = (y != 0).double().mean().item()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(kept - (1 - p)) < 3 * sigma
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / (1 - p), rtol=1e-6)
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)
    drop.generator = None
    with pytest.raises(RuntimeError, match="generator"):
        drop(x)
    assert drop.eval()(x) is x
    assert layers.Dropout(0.0).train()(x) is x
    assert torch.equal(layers.Dropout(1.0).train()(x), torch.zeros(n))


def test_dropout_generator_reaches_every_dropout():
    model = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    drops = [m for m in model.modules() if isinstance(m, layers.Dropout)]
    assert len(drops) >= 12 and {d.p for d in drops} >= {0.1, 0.2, 0.5}
    g = torch.Generator()
    with layers.dropout_generator(model, g):
        assert all(d.generator is g for d in drops)
    assert all(d.generator is None for d in drops)


@pytest.mark.parametrize("dim_wise", [True, False])
@pytest.mark.parametrize("reduce", [True, False])
def test_mdn_loss_matches_jax(dim_wise, reduce):
    from promptttspp_tpu.nn.mdn import mdn_loss as jax_mdn_loss

    rng = np.random.RandomState(1)
    B, T, G, D = 3, 7, 4, 5
    log_pi = rng.randn(*((B, T, G, D) if dim_wise else (B, T, G)))
    log_pi = log_pi - np.log(np.exp(log_pi).sum(2, keepdims=True))
    log_pi[0, 0] = -9.0  # below the clamp
    log_sigma = rng.randn(B, T, G, D) * 2
    mu = rng.randn(B, T, G, D)
    target = rng.randn(B, T, D) * 3  # some beyond mu +/- 5 sigma
    mask = (np.arange(T)[None] < np.array([7, 4, 1])[:, None])[:, :, None]
    args = [a.astype(np.float32) for a in (log_pi, log_sigma, mu, target)]
    for m in (None, mask):
        kw = dict(reduce=reduce)
        ref = jax_mdn_loss(*map(jnp.asarray, args), mask=None if m is None
                           else jnp.asarray(m), **kw)
        out = mdn_loss(*map(torch.from_numpy, args), mask=None if m is None
                       else torch.from_numpy(m), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


# ------------------------------------------------------- the model


@pytest.fixture(scope="module")
def jax_grads(twins):
    """JAX's train-mode losses, updated BatchNorm statistics and gradients
    of the tiny model on ``train_batch()``."""
    model, variables = twins
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}

    def loss_fn(params):
        out, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            batch, train=True, mutable=["batch_stats"])
        return out["loss"], (out, mut["batch_stats"])

    grads, (losses, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"])
    return (jax.device_get(losses), jax.device_get(stats),
            jax.device_get(grads))


@pytest.fixture(scope="module")
def port_grads(twins):
    _, variables = twins
    port = port_model(variables)
    trainable = bert_trainable(dict(port.named_parameters()))
    for name, p in port.named_parameters():
        p.requires_grad_(name in trainable)
    losses = port(torch_batch(train_batch()))
    losses["loss"].backward()
    return port, losses, trainable


def test_train_mode_losses_match_jax(jax_grads, port_grads):
    """Every loss term and the updated BatchNorm statistics, with a row of
    weight 0 in the batch."""
    ref, ref_stats, _ = jax_grads
    port, losses, _ = port_grads
    for k in LOSS_KEYS:
        np.testing.assert_allclose(losses[k].item(), float(ref[k]),
                                   err_msg=k, **LOSS_TOL)
    sd = port.state_dict()
    named = _named(ref_stats, "batch_stats")
    assert sum(k.endswith("running_var") for k in named) == 3
    for k, v in named.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=k)


def test_gradients_match_jax(twins, jax_grads, port_grads):
    """Each trainable parameter's gradient, mapped by name, within 1e-3 of
    the JAX tensor's largest entry (+1e-7)."""
    from promptttspp_tpu.train.state import bert_freeze_mask

    _, variables = twins
    _, _, grads = jax_grads
    port, _, trainable = port_grads
    mask = bert_freeze_mask(variables["params"])
    ref = _named(_filter(grads, mask))
    params = dict(port.named_parameters())
    assert set(ref) == set(trainable)
    for name, g in ref.items():
        g = g.numpy()
        got = params[name].grad
        assert got is not None, name
        tol = 1e-3 * np.abs(g).max() + 1e-7
        assert np.abs(got.numpy() - g).max() <= tol, name


def test_trainable_set_is_the_bert_freeze_mask(twins):
    from promptttspp_tpu.train.state import bert_freeze_mask

    _, variables = twins
    port = port_model(variables)
    mask = bert_freeze_mask(variables["params"])
    want = set(_named(_filter(variables["params"], mask)))
    assert set(bert_trainable(dict(port.named_parameters()))) == want
    frozen = set(dict(port.named_parameters())) - want
    assert frozen and all(n.startswith("prompt_encoder.bert.")
                          for n in frozen)
    assert any(".attention." in n for n in want
               if n.startswith("prompt_encoder.bert."))


def test_eval_mode_losses_match_the_golden():
    """The golden model of tests/test_model_parity.py (the reference's
    torch weights, a stub prompt encoder) in eval mode: every loss term
    against the reference's."""
    from pathlib import Path

    from promptttspp_tpu_torch.compat.torch_ckpt import (
        load_reference_state_dict)
    from promptttspp_tpu_torch.models.diffusion import (
        DiffNet, GaussianDiffusion)
    from promptttspp_tpu_torch.models.frame_prior import FramePriorNetwork
    from promptttspp_tpu_torch.models.phoneme_embedding import (
        PhonemeEmbedding)
    from promptttspp_tpu_torch.models.prompttts import PromptTTSMDNDurCFG
    from promptttspp_tpu_torch.models.style_encoder import StyleEncoder
    from promptttspp_tpu_torch.models.variance_adaptor import (
        MDNPredictor, Predictor, VarianceAdaptor)
    from promptttspp_tpu_torch.nn.conformer import ConformerEncoder
    from promptttspp_tpu_torch.nn.layers import Conv1d
    from promptttspp_tpu_torch.nn.mdn import MDNLayer
    from tests.test_model_parity import GOLDEN, IO_KEYS

    class StubPromptEncoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.proj = torch.nn.Linear(8, 48)

        def forward(self, feat, mask=None):
            return self.proj(feat)[:, None, :]

    C = 48
    model = PromptTTSMDNDurCFG(
        PhonemeEmbedding(90, C, do_scale=False),
        ConformerEncoder(C, C, 2, 96, 2, 0.0, 0.0, 0.0,
                         positionwise_layer_type="conv1d",
                         positionwise_conv_kernel_size=9, macaron_style=True,
                         pos_enc_layer_type="rel_pos",
                         selfattention_layer_type="rel_selfattn",
                         use_cnn_module=True, cnn_module_kernel=7,
                         rel_pos_type="new"),
        VarianceAdaptor(MDNPredictor(C, 1, 3, 2, 4, detach=True,
                                     disable_amp=True),
                        Predictor(C, 2, 5, 5), Conv1d(1, C, 1),
                        FramePriorNetwork(C, 3, 17)),
        StyleEncoder(20, 10, C, 4, 6, (4, 4, 8, 8, 16, 16), 3, 2, 1, C),
        StubPromptEncoder(),
        GaussianDiffusion(DiffNet(20, C, 4, 32, 3, 4), out_dim=20,
                          norm_scale=6.0, K_step=100),
        MDNLayer(C, C, 4, dim_wise=True), norm_style_emb=True,
        mdn_disable_amp=True).eval()
    data = dict(np.load(Path(GOLDEN)))
    load_reference_state_dict(model, {k: torch.from_numpy(v) for k, v in
                                      data.items() if k not in IO_KEYS})
    io = {k: data[k] for k in IO_KEYS}
    batch = torch_batch(dict(
        phoneme=io["phoneme"], duration=io["durs"], phone_lengths=io["plens"],
        mel=io["mel"].transpose(0, 2, 1).copy(),
        log_cf0=io["log_cf0"].transpose(0, 2, 1).copy(),
        vuv=io["vuv"].transpose(0, 2, 1).copy(), frame_lengths=io["flens"],
        prompt_ids=io["prompt_feat"], diffusion_t=io["t_fixed"],
        diffusion_noise=io["diff_noise"].transpose(0, 2, 1).copy()))
    batch["prompt_mask"] = None
    with torch.no_grad():
        losses = model(batch)
    for k in LOSS_KEYS:
        ref = io["loss" if k == "loss" else f"loss_{k}"]
        np.testing.assert_allclose(float(losses[k]), float(ref),
                                   err_msg=k, **LOSS_TOL)


def test_zero_weight_rows_change_nothing(twins):
    """A batch and the same batch with a row of weight 0 appended (other
    contents): equal losses, gradients and BatchNorm statistics."""
    _, variables = twins
    base = train_batch(weights=(1.0, 1.0, 1.0))
    noisy = train_batch(seed=5)
    padded = {k: np.concatenate([base[k], noisy[k][:1]]) for k in base}
    padded["batch_weight"] = np.array([1, 1, 1, 0], np.float32)
    runs = []
    for batch in (base, padded):
        port = port_model(variables).requires_grad_(True)
        losses = port(torch_batch(batch))
        losses["loss"].backward()
        runs.append((losses, port))
    (la, pa), (lb, pb) = runs
    for k in LOSS_KEYS:
        np.testing.assert_allclose(la[k].item(), lb[k].item(), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    ga = {n: p.grad for n, p in pa.named_parameters()}
    for n, p in pb.named_parameters():
        torch.testing.assert_close(p.grad, ga[n], atol=1e-6, rtol=1e-5,
                                   msg=n)
    sa = pa.state_dict()
    for k, v in pb.state_dict().items():
        torch.testing.assert_close(v, sa[k], atol=1e-6, rtol=1e-5, msg=k)


# ---------------------------------------------------------- the step


def test_noam_rates_match_optax():
    """Update n runs at JAX's schedule(n - 1): the first two updates share
    one rate."""
    from promptttspp_tpu.train.schedule import noam_schedule as jax_noam

    for lr, warm in ((1e-3, 10), (1e-3, 4000), (2e-4, 3)):
        ours, ref = noam_schedule(lr, warm), jax_noam(lr, warm)
        for n in range(5):
            np.testing.assert_allclose(ours(n), float(ref(jnp.int32(n))),
                                       rtol=1e-7)
        assert ours(0) == ours(1)


@pytest.fixture(scope="module")
def jax_step(twins):
    """JAX's initial train state of the twins and its jitted
    ``make_train_step`` (clip 1.0, AdamW, Noam, BERT freeze), compiled once
    for the module's [3, 12, 64] batches."""
    from promptttspp_tpu.train.state import (
        TrainState as JaxState, bert_freeze_mask, freeze_opt_state,
        make_optimizer, make_train_step)

    model, variables = twins
    mask = bert_freeze_mask(variables["params"])
    tx = make_optimizer(base_lr=OPT["lr"], warmup_steps=OPT["warmup_steps"],
                        betas=OPT["betas"], weight_decay=OPT["weight_decay"])
    jstate = freeze_opt_state(JaxState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None), tx, mask)
    return jstate, make_train_step(model, tx, donate=False, freeze_mask=mask)


def test_three_train_steps_match_jax(twins, jax_step):
    """``TrainState.train_step`` three times against ``make_train_step``
    (clip 1.0, AdamW, Noam, BERT freeze): the losses and grad_norm of each
    step, then every parameter and BatchNorm statistic."""
    _, variables = twins
    jstate, step = jax_step
    port = port_model(variables)
    state = TrainState(port, seed=0, **OPT)
    for i in range(3):
        batch = train_batch(seed=10 + i)
        jstate, ref = step(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        out = state.train_step(torch_batch(batch))
        for k in LOSS_KEYS + ("grad_norm",):
            np.testing.assert_allclose(float(out[k]), float(ref[k]),
                                       err_msg=f"step {i} {k}", **LOSS_TOL)
    assert state.step == 3
    sd = port.state_dict()
    named = {**_named(jstate.params),
             **_named(jstate.batch_stats, "batch_stats")}
    moved = 0.0
    init = _named(variables["params"])
    for k, v in named.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
        if k in init:
            moved = max(moved, float((v - init[k]).abs().max()))
    assert moved > 1e-4  # the updates are far larger than the tolerance


def test_step_on_a_padded_batch_matches_jax(twins, jax_step):
    """One update on a batch padded with a zero-weight row (2 real rows to
    3, ``parallel/mesh.py::pad_batch_to_multiple``, equal to JAX's
    padding) against JAX's step on the same padded batch: the losses,
    grad_norm, parameters and statistics at the three-step test's bars."""
    from promptttspp_tpu.parallel.mesh import (
        pad_batch_to_multiple as jax_pad)

    from promptttspp_tpu_torch.parallel.mesh import pad_batch_to_multiple

    _, variables = twins
    jstate, step = jax_step
    batch = train_batch(seed=31, B=2, weights=(1.0, 1.0))
    padded = pad_batch_to_multiple(dict(batch), 3)
    ref_padded = jax_pad(dict(batch), 3)
    assert sorted(padded) == sorted(ref_padded)
    for k, v in padded.items():
        np.testing.assert_array_equal(v, ref_padded[k], err_msg=k)
    jstate, ref = step(jstate, {k: jnp.asarray(v) for k, v in padded.items()},
                       jax.random.PRNGKey(0))
    port = port_model(variables)
    out = TrainState(port, seed=0, **OPT).train_step(torch_batch(padded))
    for k in LOSS_KEYS + ("grad_norm",):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), err_msg=k,
                                   **LOSS_TOL)
    sd = port.state_dict()
    for k, v in {**_named(jstate.params),
                 **_named(jstate.batch_stats, "batch_stats")}.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)
