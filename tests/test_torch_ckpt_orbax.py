"""A model trained by the JAX package, served by the port: JAX's
``create_train_state`` and ``save_checkpoint`` write an orbax checkpoint of
the tiny model of ``tests/test_train.py``, ``scripts/orbax_to_npz.py``
converts it, and the port's synthesize loader
(``bin/synthesize.py::load_checkpoint``) loads the ``.npz``; the loaded
model's frame lengths and decoder conditioning equal JAX's on the same
checkpoint, with every random draw switched off (``use_max``,
``noise_scale=0``) and every dropout rate 0."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.bin.synthesize import load_checkpoint
from promptttspp_tpu_torch.compat.torch_ckpt import torch_state_dict
from tests.test_torch_acoustic import MEL, _inputs, _t
from tests.test_torch_cuda import TINY_BERT, tiny_model_config

REPO = Path(__file__).resolve().parent.parent
# tests/test_torch_acoustic.py's tolerance for the same outputs
TOL = dict(atol=1e-4, rtol=1e-4)


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_npz", REPO / "scripts" / "orbax_to_npz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX model, its variables as saved, the converted .npz, the orbax
    directory)."""
    import tests.test_train as tt
    from promptttspp_tpu.flagship import example_batch
    from promptttspp_tpu.train.checkpoint import save_checkpoint
    from promptttspp_tpu.train.state import create_train_state

    model = tt.tiny_model(dropout=False)
    batch = example_batch(B=2, Tp=8, Tf=48, L=8, mel_dim=MEL, seed=0)
    batch["prompt_ids"] = np.random.RandomState(0).randint(
        1, 60, batch["prompt_ids"].shape).astype(np.int32)
    state = create_train_state(model, batch, jax.random.PRNGKey(3),
                               optax.adamw(1e-3))
    out = tmp_path_factory.mktemp("orbax")
    save_checkpoint(out / "ckpt" / "last", state, epoch=2, block=True)
    npz = out / "last.npz"
    _script().main([str(out / "ckpt" / "last"), str(npz)])
    variables = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})
    return model, variables, npz, out / "ckpt" / "last"


def test_npz_holds_params_and_batch_stats(trained):
    _, variables, npz, _ = trained
    with np.load(npz) as data:
        keys = set(data.files)
        first = sorted(keys)[0]
        assert data[first].dtype == np.float32
    assert all(k.split("/")[0] in ("params", "batch_stats") for k in keys)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(keys) == n_leaves
    assert any(k.startswith("batch_stats/") for k in keys)


def test_served_model_matches_jax(trained):
    model, variables, npz, _ = trained
    port = load_checkpoint(
        flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT), npz,
        "model")
    phoneme, plens, ids, mask = _inputs()
    kw = dict(prompt_ids=jnp.asarray(ids), prompt_mask=jnp.asarray(mask),
              use_max=True, noise_scale=0.0)
    jflens = np.asarray(model.apply(
        variables, jnp.asarray(phoneme), jnp.asarray(plens),
        method=type(model).infer_frame_lengths, **kw))
    max_frames = 64 * int(np.ceil(int(jflens.max()) / 64))
    ref = model.apply(variables, jnp.asarray(phoneme), jnp.asarray(plens),
                      max_frames, method=type(model).infer_cond, **kw)
    with torch.no_grad():
        flens = port.infer_frame_lengths(_t(phoneme), _t(plens), _t(ids),
                                         _t(mask))
        out = port.infer_cond(_t(phoneme), _t(plens), max_frames, _t(ids),
                              _t(mask), use_max=True, noise_scale=0.0)
    np.testing.assert_array_equal(flens.numpy(), jflens)
    for name, o, r in zip(("cond", "flens", "fmask", "log_cf0", "vuv",
                           "raw"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


def test_loaded_weights_equal_the_saved_ones(trained):
    """Every converted tensor equals the saved leaf, transposed as
    ``compat/from_jax.py`` lays it out; BatchNorm statistics included."""
    from promptttspp_tpu_torch.compat.from_jax import jax_params_to_state_dict

    _, variables, npz, _ = trained
    ref = jax_params_to_state_dict(variables)
    got = torch_state_dict(npz, "model")
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert torch.equal(got[k], v), k


def test_orbax_directory_is_refused_naming_the_script(trained):
    *_, ckpt_dir = trained
    with pytest.raises(ValueError, match="scripts/orbax_to_npz.py"):
        torch_state_dict(ckpt_dir, "model")
