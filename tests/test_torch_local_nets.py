"""The port's local conformer (``g`` before every layer) and VITS-style
transformer (windowed relative attention) against the JAX package on the
CPU: the reference's goldens loaded by name, and the jitted JAX twins on
perturbed weights, the conformer also in train mode (its BatchNorm's
batch statistics and running averages) and the transformer at T within
and beyond the window.
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
TOL = dict(atol=2e-5, rtol=1e-4)  # tests/test_local_nets.py's bar


def _golden(name, prefix=""):
    data = dict(np.load(GOLDENS / f"{name}.npz"))
    sd = {k[len(prefix):]: torch.from_numpy(v) for k, v in data.items()
          if k.startswith(prefix) and "." in k}
    return sd, data


def _inputs(B=2, T=13, C=32, seed=0, g=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, C).astype(np.float32)
    mask = np.ones((B, T, 1), np.float32)
    mask[1, max(1, T - 4):] = 0.0
    gv = rng.randn(B, 1, C).astype(np.float32) if g else None
    return x, mask, gv


def test_local_conformer_matches_golden():
    """With and without g; the golden's BatchNorm statistics load as the
    running averages."""
    from promptttspp_tpu_torch.nn.conformer_local import Conformer

    sd, d = _golden("local_conformer")
    conf = load_reference_state_dict(Conformer(2, 32, 2, 7, 0.0), sd).eval()
    mask = _t(d["mask"])[:, :, None]
    g = _t(np.ascontiguousarray(d["g"].transpose(0, 2, 1)))
    with torch.no_grad():
        out = conf(_t(d["x"]), mask, g=g)
        out_nog = conf(_t(d["x"]), mask)
    np.testing.assert_allclose(out.numpy(), d["out"], **TOL)
    np.testing.assert_allclose(out_nog.numpy(), d["out_nog"], **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_local_conformer_matches_jax(train):
    """Eval: the running statistics. Train (dropout 0): the batch's
    statistics, and the running averages after the step."""
    from promptttspp_tpu.nn.conformer_local import Conformer as J
    from promptttspp_tpu_torch.compat.from_jax import (
        jax_params_to_state_dict)
    from promptttspp_tpu_torch.nn.conformer_local import Conformer

    x, mask, g = _inputs()
    jconf = J(num_layers=2, channels=32, num_head=4, kernel_size=5,
              dropout=0.0)
    variables, conf = _twins(jconf, lambda: Conformer(2, 32, 4, 5, 0.0),
                             x, mask, g)
    if not train:
        ref = jit_apply(jconf, variables, None, x, mask, g=g)
        with torch.no_grad():
            out = conf(_t(x), _t(mask), g=_t(g))
        np.testing.assert_allclose(out.numpy(), ref, **TOL)
        return
    ref, updates = jit_apply(jconf, variables, None, x, mask, g=g,
                             train=True, mutable=["batch_stats"])
    conf.train()
    with torch.no_grad():
        out = conf(_t(x), _t(mask), g=_t(g))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    want = jax_params_to_state_dict({"batch_stats": updates["batch_stats"]})
    got = conf.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL,
                                       err_msg=k)


@pytest.mark.parametrize("prefix,rel,key", [("rel.", True, "out"),
                                            ("abs.", False, "out_abs")])
def test_vits_transformer_matches_golden(prefix, rel, key):
    from promptttspp_tpu_torch.nn.transformer import Transformer

    sd, d = _golden("vits_transformer", prefix)
    net = load_reference_state_dict(
        Transformer(32, 2, 2, 3, 0.0, 4, 4 if rel else None, rel), sd)
    x = _t(np.ascontiguousarray(d["x"].transpose(0, 2, 1)))
    with torch.no_grad():
        out = net.eval()(x, _t(d["mask"])[:, :, None])
    np.testing.assert_allclose(out.numpy(), d[key].transpose(0, 2, 1),
                               **TOL)


@pytest.mark.parametrize("T", [3, 5, 13])
def test_relative_layout_helpers_match_jax(T):
    """The gathers between the relative [T, 2T-1] and absolute [T, T]
    layouts and the window's table, at T below, at and beyond the
    window's reach (w + 1 = 5)."""
    from promptttspp_tpu.nn import transformer as jt
    from promptttspp_tpu_torch.nn import transformer as pt

    rng = np.random.RandomState(T)
    rel = rng.randn(2, 3, T, 2 * T - 1).astype(np.float32)
    p = rng.randn(2, 3, T, T).astype(np.float32)
    emb = rng.randn(9, 4).astype(np.float32)
    np.testing.assert_array_equal(pt.rel_to_abs(_t(rel)).numpy(),
                                  np.asarray(jt._rel_to_abs(rel, T)))
    np.testing.assert_array_equal(pt.abs_to_rel(_t(p)).numpy(),
                                  np.asarray(jt._abs_to_rel(p, T)))
    np.testing.assert_array_equal(
        pt.window_to_full(_t(emb), T, 4).numpy(),
        np.asarray(jt._window_to_full(jnp.asarray(emb), T, 4)))


@pytest.mark.parametrize("T,rel,with_g", [(3, True, False),
                                          (13, True, True),
                                          (13, False, False)])
def test_vits_transformer_matches_jax(T, rel, with_g):
    from promptttspp_tpu.nn.transformer import Transformer as J
    from promptttspp_tpu_torch.nn.transformer import Transformer

    x, mask, g = _inputs(T=T, g=with_g)
    jnet = J(channels=32, num_head=2, num_layers=2, kernel_size=3,
             dropout=0.0, scale=4, window_size=4 if rel else None,
             use_rel=rel)
    variables, net = _twins(
        jnet, lambda: Transformer(32, 2, 2, 3, 0.0, 4,
                                  4 if rel else None, rel), x, mask, g)
    ref = jit_apply(jnet, variables, None, x, mask, g=g)
    with torch.no_grad():
        out = net(_t(x), _t(mask), g=None if g is None else _t(g))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
