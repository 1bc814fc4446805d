"""Port of the acoustic model (conformer, BERT prompt encoder, variance
adaptor, diffusion decoder, whole ``infer``) against its JAX twin.

The JAX twin is ``tests/test_train.py::tiny_model``; the port is built from
the same widths (``tests/test_torch_cuda.py::tiny_model_config``) and gets
the same weights through ``compat/from_jax.py``. Every parameter and
BatchNorm statistic is perturbed from its init with seeded numpy noise
first, so no bias, alpha or running statistic is a trivial zero or one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
from tests.test_torch_cuda import C, MEL, TINY_BERT, tiny_model_config

# float32 on both sides; sums in another order and depth-wise error growth
TOL = dict(atol=1e-4, rtol=1e-4)


def perturbed(variables, seed=0, scale=0.05):
    """Every leaf + seeded noise (variances kept positive)."""
    rng = np.random.RandomState(seed)

    def rec(node, stats):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: rec(v, stats) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        noise = rng.randn(*a.shape).astype(np.float32) * scale
        return np.abs(a + noise) if stats else a + noise

    return {"params": rec(variables["params"], False),
            "batch_stats": rec(variables.get("batch_stats", {}), True)}


def jax_variables_from(shapes, state_dict, root=()):
    """The flax variables of ``shapes`` (``jax.eval_shape`` of an init, at
    ``root`` in the model's tree) holding the port's ``state_dict``, each
    leaf in the layout ``compat/from_jax.py`` reads back: the inverse of
    ``jax_params_to_state_dict``, found by sending each leaf's flat
    indices through its ``_param``. Twins made so need no JAX init to
    compile."""
    from promptttspp_tpu_torch.compat.from_jax import _param, torch_module_key

    stats = {"mean": "running_mean", "var": "running_var"}

    def rec(node, path, is_stats):
        if hasattr(node, "items"):
            return {k: rec(v, path + (k,), is_stats) for k, v in node.items()}
        base = torch_module_key(root + path[:-1])
        index = np.arange(int(np.prod(node.shape))).reshape(node.shape)
        name, moved = (stats[path[-1]], index) if is_stats \
            else _param(path[-1], index)
        out = np.empty(index.size, np.float32)
        out[np.asarray(moved).ravel()] = \
            state_dict[f"{base}.{name}".lstrip(".")].numpy().ravel()
        return out.reshape(node.shape)

    return {"params": rec(shapes.get("params", {}), (), False),
            "batch_stats": rec(shapes.get("batch_stats", {}), (), True)}


def jit_apply(model, variables, method, *args, **kw):
    """``model.apply(variables, *args, method=method, **kw)`` under one
    jit (one compile instead of one per operation): the arrays among the
    arguments are traced, every other argument is fixed."""
    arrays = {i: a for i, a in enumerate(args) if hasattr(a, "shape")}
    kw_arrays = {k: v for k, v in kw.items() if hasattr(v, "shape")}

    def run(variables, arrays, kw_arrays):
        full = [arrays.get(i, a) for i, a in enumerate(args)]
        return model.apply(variables, *full, method=method,
                           **{**kw, **kw_arrays})

    return jax.jit(run)(variables, arrays, kw_arrays)


def init_jax_twins(seed=0, port_init=False):
    """-> (jax model, perturbed numpy variables, port model on the CPU).
    The weights are the JAX model's init, or with ``port_init`` the
    port's, laid out in JAX's tree (``jax_variables_from``: no JAX init
    compiles)."""
    import tests.test_train as tt
    from promptttspp_tpu.flagship import example_batch

    model = tt.tiny_model(dropout=False)
    batch = example_batch(B=2, Tp=8, Tf=48, L=8, mel_dim=MEL, seed=seed)
    batch["prompt_ids"] = np.random.RandomState(seed).randint(
        1, 60, batch["prompt_ids"].shape).astype(np.int32)
    rngs = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "dropout", "diffusion", "style"))}
    port = flagship.build_model(tiny_model_config(), "cpu", seed, TINY_BERT)
    if port_init:
        variables = jax_variables_from(jax.eval_shape(
            functools.partial(model.init, train=True), rngs, batch),
            port.state_dict())
    else:
        variables = jax.device_get(jax.jit(
            model.init, static_argnames=("train",))(rngs, batch, train=True))
    variables = perturbed(variables, seed)
    # a duration head that gives 2-4 frames per phone, varying by phone
    head = variables["params"]["variance_adaptor"]["duration_predictor"][
        "out_layer"]
    head["mu"]["kernel"] *= 0.3
    head["mu"]["bias"] += np.log(3.0)
    head["log_sigma"]["kernel"] *= 0.1
    head["log_sigma"]["bias"] -= 2.0
    load_jax_variables(port, variables)
    return model, variables, port


@pytest.fixture(scope="module")
def twins():
    return init_jax_twins()


def _inputs(seed=1, B=2, Tp=16, L=16):
    rng = np.random.RandomState(seed)
    phoneme = rng.randint(1, 90, (B, Tp)).astype(np.int32)
    plens = np.array([Tp, Tp - 5][:B], np.int32)
    for b in range(B):
        phoneme[b, plens[b]:] = 0
    ids = rng.randint(1, 60, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1:, L - 4:] = 0
    return phoneme, plens, ids, mask


def _t(a):
    return torch.as_tensor(np.asarray(a)).long() \
        if np.asarray(a).dtype.kind in "iu" else torch.as_tensor(np.asarray(a))


def test_state_dict_names_cover_the_port(twins):
    _, variables, port = twins
    from promptttspp_tpu_torch.compat.from_jax import (
        NOT_PORTED, jax_params_to_state_dict)

    assert NOT_PORTED == ()
    assert "reference_encoder" in variables["params"]
    sd = jax_params_to_state_dict(variables)
    assert any(k.startswith("reference_encoder.ref_enc.convs.1.running")
               for k in sd)
    assert set(sd) == set(port.state_dict())


def test_conformer_matches_jax(twins):
    model, variables, port = twins
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, C).astype(np.float32)
    lens = np.array([16, 9], np.int32)
    ref = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                      method=lambda m, x, l: m.encoder(x, l, train=False))
    with torch.no_grad():
        out = port.encoder(torch.from_numpy(x), _t(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bert_prompt_encoder_matches_jax(twins):
    model, variables, port = twins
    _, _, ids, mask = _inputs()
    ref = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                      method=lambda m, i, k: m.prompt_encoder(i, k,
                                                              train=False))
    with torch.no_grad():
        out = port.prompt_encoder(_t(ids), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_variance_adaptor_infer_matches_jax(twins):
    model, variables, port = twins
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, C).astype(np.float32)
    pmask = np.arange(16)[None, :] < np.array([16, 11])[:, None]
    ref = model.apply(
        variables, jnp.asarray(x), jnp.asarray(pmask),
        method=lambda m, x, p: m.variance_adaptor.infer(x, p, 128))
    with torch.no_grad():
        out = port.variance_adaptor.infer(torch.from_numpy(x),
                                          torch.from_numpy(pmask), 128)
    for name, o, r in zip(("x", "flens", "fmask", "log_cf0", "vuv", "raw"),
                          out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


def test_diffusion_decode_matches_jax(twins):
    model, variables, port = twins
    rng = np.random.RandomState(4)
    cond = rng.randn(2, 24, C).astype(np.float32)
    x_T = rng.randn(2, 24, MEL).astype(np.float32)
    ref = model.apply(
        variables, jnp.asarray(cond), jnp.asarray(x_T),
        method=lambda m, c, x: m.decoder.inference(c, x_T=x, zero_noise=True))
    with torch.no_grad():
        out = port.decoder.inference(torch.from_numpy(cond),
                                     x_T=torch.from_numpy(x_T),
                                     zero_noise=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_infer_and_frame_lengths_match_jax(twins):
    model, variables, port = twins
    phoneme, plens, ids, mask = _inputs()
    jflens = model.apply(
        variables, jnp.asarray(phoneme), jnp.asarray(plens),
        prompt_ids=jnp.asarray(ids), prompt_mask=jnp.asarray(mask),
        use_max=True, noise_scale=0.0,
        method=type(model).infer_frame_lengths)
    with torch.no_grad():
        flens = port.infer_frame_lengths(_t(phoneme), _t(plens), _t(ids),
                                         _t(mask))
    np.testing.assert_array_equal(flens.numpy(), np.asarray(jflens))

    max_frames = 64 * int(np.ceil(int(np.max(jflens)) / 64))
    x_T = np.random.RandomState(5).randn(2, max_frames, MEL).astype(
        np.float32)
    ref = model.apply(
        variables, jnp.asarray(phoneme), jnp.asarray(plens), max_frames,
        prompt_ids=jnp.asarray(ids), prompt_mask=jnp.asarray(mask),
        use_max=True, noise_scale=0.0, x_T=jnp.asarray(x_T), zero_noise=True,
        return_f0=True, return_raw_lengths=True, method=type(model).infer)
    with torch.no_grad():
        out = port.infer(_t(phoneme), _t(plens), max_frames, _t(ids),
                         _t(mask), use_max=True, noise_scale=0.0,
                         x_T=torch.from_numpy(x_T), zero_noise=True)
    assert len(out) == len(ref) == 5
    for name, o, r in zip(("mel", "flens", "log_cf0", "vuv", "raw"), out,
                          ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   atol=2e-4, rtol=1e-4)


def test_weight_converter_round_trip(twins):
    """JAX tree -> port state_dict -> the JAX package's own torch->flax
    converter gives back the same tree, leaf for leaf."""
    from promptttspp_tpu.compat.torch_ckpt import convert_tree
    from promptttspp_tpu.models.bert import bert_rename_map

    _, variables, port = twins
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    rename = {"phoneme_embedding.emb": "phoneme_emb.emb"}
    for f, t in bert_rename_map(TINY_BERT.num_hidden_layers).items():
        rename[f"prompt_encoder.bert.{f}"] = f"prompt_encoder.bert.model.{t}"
    for coll in ("params", "batch_stats"):
        tree = variables[coll]
        back = jax.device_get(convert_tree(tree, sd, coll, rename=rename))
        flat = jax.tree_util.tree_leaves_with_path(tree)
        back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat) == len(back_flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(back_flat[path]),
                                          np.asarray(leaf),
                                          err_msg=str(path))
