"""The model with its remaining switches (``chip_smoke.py::variant_config``:
every switch the flagship sets away from JAX's default at JAX's default,
plus the energy branch) and the model with every switch at JAX's default
(the same without the energy branch) against their JAX twins on the CPU:
one train step (the losses, ``energy`` included, grad_norm, then every
parameter and BatchNorm statistic, at ``tests/test_torch_train.py``'s
bars), ``infer`` with the noise fixed and ``infer_frame_lengths``; and the
MDN heads' dtype under bf16 training, which ``mdn_disable_amp`` decides as
JAX's casts do.

The twins are ``tests/test_train.py::tiny_model`` with every dropout rate
0, switched as ``variant_config`` switches the port's tiny config. One set
of weights serves both models (the one without the energy branch drops its
two subtrees): the port's init of the variant, laid out in JAX's tree
(``jax.eval_shape``: no JAX init compiles) and perturbed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import variant_config
from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
from promptttspp_tpu_torch.train.schedule import noam_schedule
from promptttspp_tpu_torch.train.state import TrainState
from tests.test_torch_acoustic import (
    jax_variables_from, jit_apply, perturbed)
from tests.test_torch_cuda import (
    C, MEL, OPT, ZERO_BERT, torch_batch, train_batch, zero_dropout_config)
from tests.test_torch_train import LOSS_KEYS, LOSS_TOL, _named

MODELS = ("variant", "jax_defaults")


def jax_variant():
    """tests/test_train.py's tiny model switched as ``variant_config``."""
    import tests.test_train as tt
    from promptttspp_tpu.models.variance_adaptor import PitchEmb, Predictor
    from promptttspp_tpu.nn.conformer import ConformerEncoder
    from tests.test_torch_train import zero_dropout_jax

    model = zero_dropout_jax(tt.tiny_model(dropout=False))
    va = model.variance_adaptor
    return model.clone(
        norm_style_emb=False, mdn_disable_amp=False,
        phoneme_embedding=model.phoneme_embedding.clone(do_scale=True),
        encoder=ConformerEncoder(
            idim=C, attention_dim=C, attention_heads=2, linear_units=64,
            num_blocks=1, dropout_rate=0.0, positional_dropout_rate=0.0),
        style_mdn=model.style_mdn.clone(dim_wise=False),
        variance_adaptor=va.clone(
            duration_predictor=va.duration_predictor.clone(
                disable_amp=False),
            energy_predictor=Predictor(channels=C, out_channels=1,
                                       kernel_size=5, dropout=0.0,
                                       num_layers=2),
            energy_emb=PitchEmb(1, C, 1)))


def energy_batch(seed=0):
    """``train_batch`` with an energy target on the valid frames."""
    batch = train_batch(seed=seed)
    rng = np.random.RandomState(seed + 100)
    frame = np.arange(batch["mel"].shape[1])[None] \
        < batch["frame_lengths"][:, None]
    batch["energy"] = (rng.rand(*frame.shape, 1) * frame[..., None]) \
        .astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def twins():
    """-> {name: (JAX model, perturbed variables, port config)}."""
    model = jax_variant()
    rngs = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "dropout", "diffusion", "style"))}
    batch = {k: jnp.asarray(v) for k, v in energy_batch().items()}
    cfg = variant_config(zero_dropout_config())
    shapes = jax.eval_shape(functools.partial(model.init, train=True), rngs,
                            batch)
    variables = perturbed(jax_variables_from(shapes, flagship.build_model(
        cfg, "cpu", 7, ZERO_BERT).state_dict()), 7)
    # 2-4 frames per phone (tests/test_torch_acoustic.py::init_jax_twins)
    head = variables["params"]["variance_adaptor"]["duration_predictor"][
        "out_layer"]
    head["mu"]["kernel"] *= 0.3
    head["mu"]["bias"] += np.log(3.0)
    head["log_sigma"]["kernel"] *= 0.1
    head["log_sigma"]["bias"] -= 2.0
    plain = {"params": dict(variables["params"], variance_adaptor={
        n: t for n, t in variables["params"]["variance_adaptor"].items()
        if n not in ("energy_predictor", "energy_emb")}),
        "batch_stats": variables["batch_stats"]}
    plain_cfg = variant_config(zero_dropout_config())
    plain_cfg["variance_adaptor"].update(energy_predictor=None,
                                         energy_emb=None)
    return {"variant": (model, variables, cfg),
            "jax_defaults": (model.clone(variance_adaptor=(
                model.variance_adaptor.clone(energy_predictor=None,
                                             energy_emb=None))),
                plain, plain_cfg)}


def _port(cfg, variables):
    port = flagship.build_model(cfg, "cpu", 0, ZERO_BERT)
    return load_jax_variables(port, variables)


def test_variant_switches_away_from_the_flagship():
    """The variant builds every switch at JAX's default (its conformer
    has no macaron FFN, conv module or relative positions) and the energy
    branch; the flagship config is left as it was."""
    from promptttspp_tpu_torch.nn.attention import (
        MultiHeadedAttention, RelPositionMultiHeadedAttention)
    from promptttspp_tpu_torch.nn.conformer import PositionwiseFeedForward

    cfg = variant_config(flagship.MODEL)
    assert flagship.MODEL["norm_style_emb"] is True
    assert "energy_predictor" in cfg["variance_adaptor"]
    port = flagship.build_model(variant_config(zero_dropout_config()),
                                "cpu", 0, ZERO_BERT)
    layer = port.encoder.encoder.encoders[0]
    assert type(layer.self_attn) is MultiHeadedAttention
    assert not isinstance(layer.self_attn, RelPositionMultiHeadedAttention)
    assert isinstance(layer.feed_forward, PositionwiseFeedForward)
    assert not hasattr(layer, "conv_module")
    assert not hasattr(layer, "feed_forward_macaron")
    assert port.phoneme_emb.scale == C ** 0.5
    assert not port.norm_style_emb and not port.mdn_disable_amp
    assert port.variance_adaptor.energy_emb is not None
    assert not port.style_mdn.dim_wise


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax(twins, name):
    """One ``TrainState.train_step`` against ``make_train_step`` (clip 1.0,
    AdamW, Noam, BERT freeze) on a batch with an energy target: the
    losses (``energy`` only with the branch) and grad_norm, then every
    parameter and BatchNorm statistic."""
    from promptttspp_tpu.train.state import (
        TrainState as JaxState, bert_freeze_mask, freeze_opt_state,
        make_optimizer, make_train_step)

    model, variables, cfg = twins[name]
    mask = bert_freeze_mask(variables["params"])
    tx = make_optimizer(base_lr=OPT["lr"], warmup_steps=OPT["warmup_steps"],
                        betas=OPT["betas"], weight_decay=OPT["weight_decay"])
    jstate = freeze_opt_state(JaxState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None), tx, mask)
    step = make_train_step(model, tx, donate=False, freeze_mask=mask)
    batch = energy_batch(seed=10)
    jstate, ref = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    port = _port(cfg, variables).train()
    out = TrainState(port, seed=0, **OPT).train_step(torch_batch(batch))
    keys = LOSS_KEYS + ("grad_norm",)
    assert ("energy" in out) == ("energy" in ref) == (name == "variant")
    if name == "variant":
        keys += ("energy",)
    for k in keys:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), err_msg=k,
                                   **LOSS_TOL)
    sd = port.state_dict()
    named = {**_named(jstate.params),
             **_named(jstate.batch_stats, "batch_stats")}
    assert {k for k in sd if not k.endswith("num_batches_tracked")} \
        == {k for k in named if not k.endswith("num_batches_tracked")}
    # an attention's key bias gets no gradient but rounding's (the softmax
    # ignores a constant per query), which AdamW's first step normalizes
    # like any other: it is held to that step's largest move
    lr = noam_schedule(OPT["lr"], OPT["warmup_steps"])(0)
    for k, v in named.items():
        if not k.endswith("num_batches_tracked"):
            key_bias = k.endswith(("key.bias", "linear_k.bias"))
            np.testing.assert_allclose(
                sd[k].numpy(), v.numpy(), rtol=0, err_msg=k,
                atol=2 * lr * (1 + OPT["weight_decay"]) if key_bias
                else 1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_infer_matches_jax(twins, name):
    """``infer_frame_lengths`` and ``infer`` (x_T given, zero diffusion
    noise, most probable style, noise_scale 0) on the prompt branch, and
    ``infer_cond`` on the reference branch."""
    from tests.test_torch_acoustic import _inputs, _t

    model, variables, cfg = twins[name]
    port = _port(cfg, variables).eval()
    phoneme, plens, ids, mask = _inputs()
    kw = dict(prompt_ids=jnp.asarray(ids), prompt_mask=jnp.asarray(mask),
              use_max=True, noise_scale=0.0)
    args = (jnp.asarray(phoneme), jnp.asarray(plens))
    jflens = np.asarray(jit_apply(model, variables,
                                  type(model).infer_frame_lengths, *args,
                                  **kw))
    assert 16 <= jflens.min() and jflens.max() <= 64, jflens
    x_T = np.random.RandomState(8).randn(2, 64, MEL).astype(np.float32)
    ref = jit_apply(model, variables, type(model).infer, *args, 64,
                    x_T=jnp.asarray(x_T), zero_noise=True, return_f0=True,
                    **kw)
    ref_mel = np.random.RandomState(9).randn(2, 40, MEL).astype(np.float32)
    ref_lens = np.array([40, 31], np.int32)
    ref_cond = jit_apply(model, variables, type(model).infer_cond, *args, 64,
                         reference_mel=jnp.asarray(ref_mel),
                         ref_lengths=jnp.asarray(ref_lens))
    targs = (_t(phoneme), _t(plens))
    with torch.no_grad():
        flens = port.infer_frame_lengths(*targs, _t(ids), _t(mask))
        out = port.infer(*targs, 64, _t(ids), _t(mask), use_max=True,
                         noise_scale=0.0, x_T=_t(x_T), zero_noise=True)
        cond = port.infer_cond(*targs, 64, reference_mel=_t(ref_mel),
                               ref_lengths=_t(ref_lens))
    np.testing.assert_array_equal(flens.numpy(), jflens)
    # tests/test_torch_acoustic.py::TOL
    tol = dict(atol=1e-4, rtol=1e-4)
    for label, o, r in zip(("mel", "flens", "log_cf0", "vuv"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=label,
                                   **tol)
    for label, o, r in zip(("cond", "flens", "fmask"), cond, ref_cond):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=label,
                                   **tol)


@pytest.mark.parametrize("disable_amp", [True, False])
def test_mdn_heads_dtype_under_bf16_follows_jax(disable_amp):
    """Under bf16 training (bf16 parameters and activations) the style
    MDN and the duration head compute in float32 with ``mdn_disable_amp``
    and in bf16 without it, as JAX's casts make them."""
    from promptttspp_tpu.models.variance_adaptor import (
        MDNPredictor as JaxMDNPredictor)
    from promptttspp_tpu.nn.mdn import MDNLayer as JaxMDN
    from promptttspp_tpu_torch.train.state import bf16_shadow

    cfg = zero_dropout_config()
    cfg["mdn_disable_amp"] = disable_amp
    cfg["variance_adaptor"]["duration_predictor"]["disable_amp"] = \
        disable_amp
    port = bf16_shadow(flagship.build_model(cfg, "cpu", 0, ZERO_BERT))
    prompt = torch.randn(2, 1, C).to(torch.bfloat16)
    x = torch.randn(2, 5, C).to(torch.bfloat16)
    with torch.no_grad():
        style = port._style_mdn(prompt)
        dur = port.variance_adaptor.duration_predictor(x, torch.ones(
            2, 5, 1, dtype=torch.bfloat16))

    def bf16(tree):
        return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)

    jprompt = jnp.zeros((2, 1, C), jnp.bfloat16)
    # the dtypes only: traced, not run
    jmdn = JaxMDN(C, C, 2, dim_wise=True)
    p_in = jprompt.astype(jnp.float32) if disable_amp else jprompt
    jstyle = jax.eval_shape(lambda p: jmdn.apply(bf16(jmdn.init(
        jax.random.PRNGKey(0), p)), p_in), jprompt)
    jdur_mod = JaxMDNPredictor(C, 1, 3, 0.0, 1, 2, disable_amp=disable_amp)
    jx = jnp.zeros((2, 5, C), jnp.bfloat16)
    jmask = jnp.ones((2, 5, 1), jnp.bfloat16)
    jdur = jax.eval_shape(lambda x, m: jdur_mod.apply(bf16(jdur_mod.init(
        jax.random.PRNGKey(0), x, m)), x, m), jx, jmask)
    want = jnp.float32 if disable_amp else jnp.bfloat16
    assert jstyle[0].dtype == jdur[0].dtype == want
    expect = torch.float32 if disable_amp else torch.bfloat16
    assert all(t.dtype == expect for t in (*style, *dur))


def test_variant_round_trips_the_reference_checkpoint_format(twins):
    """The variant's new parameters (the energy branch, the plain
    attention's q/k/v/out, the Linear FFN, the one-GMM style head) keep
    their names through the reference's checkpoint format: written by
    ``to_reference_state_dict`` and read back by
    ``load_reference_state_dict`` into a fresh model, bit for bit."""
    from promptttspp_tpu_torch.compat.torch_ckpt import (
        load_reference_state_dict, to_reference_state_dict)

    _, variables, cfg = twins["variant"]
    port = _port(cfg, variables)
    fresh = flagship.build_model(cfg, "cpu", 1, ZERO_BERT)
    load_reference_state_dict(fresh, to_reference_state_dict(port))
    sd = fresh.state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert any(k.startswith("variance_adaptor.energy_predictor.") for k in sd)
    assert "encoder.encoder.encoders.0.feed_forward.w_1.weight" in sd
    assert sd["style_mdn.log_pi.weight"].shape[0] == 2  # G, not G x D
