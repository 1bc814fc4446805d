"""Package-level checks of the PyTorch port: it imports neither JAX nor the
JAX package, its flagship constants equal the YAML configs, its entry
points refuse a missing GPU, its host helpers equal their originals, and
its model builder refuses the decoder switches of the JAX model that it
does not implement."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu_torch import flagship

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "promptttspp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "promptttspp_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_modules_import_without_jax():
    """Import every port module (and chip_smoke.py) in a fresh interpreter;
    none of JAX or the JAX package may be loaded."""
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods] + ["chip_smoke"]
    # the serving and reference-audio modules of the second slice
    assert {f"promptttspp_tpu_torch.{m}" for m in (
        "vocoders.streaming", "models.style_encoder", "nn.gru", "ops.stft",
        "ops.mel")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


RECIPE_MODULES = [f"promptttspp_tpu_torch.{m}" for m in (
    "ops.f0", "ops.interp", "preprocess.pipeline", "preprocess.world_f0",
    "preprocess.textgrid", "preprocess.duration", "data.yaml_lite",
    "data_prep.audio_metrics", "data_prep.stats", "eval.metrics",
    "bin.preprocess", "bin.compute_mel", "bin.split_df", "bin.filter_eval",
    "bin.eval", "tools.synthetic_corpus")]


def test_recipe_modules_import_without_pandas_or_yaml():
    """The recipe's modules (preprocessing, F0, evaluation and their CLIs)
    import in a fresh interpreter without pandas or PyYAML, which the
    machine with the GPU lacks, and without JAX."""
    code = (
        "import importlib, sys\n"
        f"for m in {RECIPE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{('pandas', 'yaml') + FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


def _strip_targets(node):
    if isinstance(node, dict):
        return {k: _strip_targets(v) for k, v in node.items()
                if k != "_target_"}
    if isinstance(node, (list, tuple)):
        return [_strip_targets(v) for v in node]
    return node


def test_flagship_constants_equal_yaml():
    from promptttspp_tpu.config import compose
    from promptttspp_tpu.config.compose import load_yaml
    from promptttspp_tpu_torch import flagship

    model = compose(REPO / "conf", "train").model.to_dict()
    assert _strip_targets(model) == flagship.MODEL
    demo = compose(REPO / "conf", "demo").model.to_dict()
    assert _strip_targets(demo) == flagship.MODEL_DEMO
    assert flagship.MODEL_DEMO["encoder"]["rel_pos_type"] == "legacy"
    for name, written in (
            ("prompttts_mdn_v2_wo_erg_final", flagship.MODEL_YAML),
            ("prompttts_mdn_v2_wo_erg_final_demo", flagship.MODEL_DEMO_YAML)):
        raw = load_yaml(REPO / "conf" / "model" / f"{name}.yaml").to_dict()
        assert _strip_targets(raw) == written
    voc = compose(REPO / "conf", "synthesize",
                  overrides=["vocoder=bigvgan_f0"]).vocoder.to_dict()
    assert _strip_targets(voc) == flagship.VOCODER


def test_entry_points_refuse_missing_gpu():
    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.platform import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        flagship.build_vocoder()
    assert resolve_device("cpu").type == "cpu"


def test_host_helpers_equal_their_originals():
    from promptttspp_tpu.data.batching import bucket_shape as jax_bucket
    from promptttspp_tpu.models.bert import WordPieceTokenizer as JaxTok
    from promptttspp_tpu.text import eng as jax_eng
    from promptttspp_tpu_torch.data.batching import bucket_shape
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
    from promptttspp_tpu_torch.text import eng

    for n in (0, 1, 15, 16, 17, 640, 641, 2049):
        for q in (16, 128):
            assert bucket_shape(n, q) == jax_bucket(n, q)
    assert eng.symbols == jax_eng.symbols
    text = "HH AH0 L OW1 sp W ER1 L D"
    assert eng.text_to_sequence(text) == jax_eng.text_to_sequence(text)
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "deep", "calm", "voice",
         ",", "spea", "##king", "slow", "##ly", "."])}
    prompts = ["A deep, calm voice speaking slowly.", "Calm voicé!"]
    ours = WordPieceTokenizer(vocab).batch_encode(prompts)
    ref = JaxTok(vocab).batch_encode(prompts)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_build_model_at_reduced_depth():
    """``flagship.build_model`` accepts the flagship's options and rejects
    an unknown ``rel_pos_type`` as JAX's ConformerEncoder does."""
    import copy

    from promptttspp_tpu_torch import flagship
    from tests.test_torch_cuda import TINY_BERT, tiny_model_config

    model = flagship.bias_duration_head(
        flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT), 10.0)
    assert not model.training
    head = model.variance_adaptor.duration_predictor.out_layer
    assert torch.all(head.mu.weight == 0)
    bad = copy.deepcopy(tiny_model_config())
    bad["encoder"]["rel_pos_type"] = "relative"
    with pytest.raises(ValueError, match="Unknown rel_pos_type: relative"):
        flagship.build_model(bad, "cpu", 0, TINY_BERT)


# The decoder's config keys that _model_from_config reads; every other
# field of the JAX GaussianDiffusion / DiffNet must be refused at anything
# but JAX's default.
_READ = {"decoder": {"in_dim", "out_dim", "norm_scale", "K_step", "a_min",
                     "a_max", "denoise_fn", "schedule_type", "pndm_speedup",
                     "infer_io_dtype", "pipeline_microbatches",
                     "pipeline_batch_axis"},
         "denoise_fn": {"in_dim", "encoder_hidden_dim", "residual_layers",
                        "residual_channels", "kernel_size",
                        "dilation_cycle_length", "scale"}}


def _jax_fields(cls):
    import dataclasses

    return {f.name: f.default for f in dataclasses.fields(cls)
            if f.name not in ("parent", "name")}


def test_decoder_switches_cover_the_jax_fields():
    """Each field of the JAX GaussianDiffusion and DiffNet that the port does
    not read is pinned in ``flagship._FIXED`` at JAX's default, and
    SinusoidalPosEmb's ``scale`` (set from DiffNet's) has DiffNet's default;
    the flagship config passes the check."""
    from promptttspp_tpu.models import diffusion as jd
    from promptttspp_tpu_torch import flagship

    for cls, path, read in (
            (jd.GaussianDiffusion, ("decoder",), _READ["decoder"]),
            (jd.DiffNet, ("decoder", "denoise_fn"), _READ["denoise_fn"])):
        fields = _jax_fields(cls)
        assert read <= set(fields)
        assert flagship._FIXED.get(path, {}) == {
            k: v for k, v in fields.items() if k not in read}
    assert _jax_fields(jd.SinusoidalPosEmb)["scale"] == \
        _jax_fields(jd.DiffNet)["scale"]
    flagship._check_fixed(flagship.MODEL, flagship.BERT_BASE)


@pytest.mark.parametrize("path,value", [
    (("decoder", "pipeline_mesh"), "model"),
], ids=lambda v: ".".join(v) if isinstance(v, tuple) else repr(v))
def test_unported_decoder_switch_raises(path, value):
    """A decoder switch that a config cannot give the port (a pipeline
    mesh: the trainer or the Synthesizer sets the pipeline) raises at
    build, naming the key, where the port used to drop it."""
    import copy

    from promptttspp_tpu_torch import flagship
    from tests.test_torch_cuda import TINY_BERT, tiny_model_config

    cfg = copy.deepcopy(tiny_model_config())
    section = cfg
    for key in path[:-1]:
        section = section[key]
    section[path[-1]] = value
    with pytest.raises(ValueError, match=".".join(path)):
        flagship.build_model(cfg, "cpu", 0, TINY_BERT)


@pytest.mark.parametrize("key,value", [
    ("pipeline_microbatches", 4), ("pipeline_batch_axis", "data")])
def test_decoder_pipeline_switches_are_read(key, value):
    """The decoder's pipeline microbatches and batch axis, which JAX's
    GaussianDiffusion carries, are read into the port's sampler; without a
    pipeline (set by the trainer or the Synthesizer) they change no
    decode, as in JAX."""
    import copy

    from promptttspp_tpu_torch import flagship
    from tests.test_torch_cuda import TINY_BERT, tiny_model_config

    cfg = copy.deepcopy(tiny_model_config())
    cfg["decoder"][key] = value
    model = flagship.build_model(cfg, "cpu", 0, TINY_BERT)
    assert model.decoder.options[key] == value
    assert model.decoder.pipeline is None
    plain = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    cond = torch.randn(2, 16, cfg["decoder"]["in_dim"])
    x_T = torch.randn(2, 16, cfg["decoder"]["out_dim"])
    assert torch.equal(
        model.decoder.inference(cond, x_T=x_T, zero_noise=True),
        plain.decoder.inference(cond, x_T=x_T, zero_noise=True))


# The JAX module behind each section of flagship._FIXED
_JAX_CLASSES = {
    (): "promptttspp_tpu.models.prompttts.PromptTTSMDNDurCFG",
    ("phoneme_embedding",):
        "promptttspp_tpu.models.phoneme_embedding.PhonemeEmbedding",
    ("encoder",): "promptttspp_tpu.nn.conformer.ConformerEncoder",
    ("variance_adaptor",):
        "promptttspp_tpu.models.variance_adaptor.VarianceAdaptor",
    ("style_mdn",): "promptttspp_tpu.nn.mdn.MDNLayer",
    ("decoder",): "promptttspp_tpu.models.diffusion.GaussianDiffusion",
}


def _jax_class(path):
    import importlib

    module, _, name = _JAX_CLASSES[path].rpartition(".")
    return getattr(importlib.import_module(module), name)


def test_jax_defaults_are_the_jax_fields():
    """``flagship._JAX_DEFAULTS`` (what an absent fixed key means) equals
    the defaults of the JAX dataclass fields, so a changed JAX default
    fails here; the conformer's ``rel_pos_type`` defaults to None."""
    from promptttspp_tpu_torch import flagship

    assert set(flagship._JAX_DEFAULTS) == set(flagship._FIXED) \
        == set(_JAX_CLASSES)
    for path, fixed in flagship._FIXED.items():
        fields = _jax_fields(_jax_class(path))
        assert flagship._JAX_DEFAULTS[path] == {k: fields[k] for k in fixed}
    assert _jax_fields(_jax_class(("encoder",)))["rel_pos_type"] is None


_ABSENT_KEYS = [(path, key) for path, fixed in flagship._FIXED.items()
                for key in fixed] + [(("encoder",), "rel_pos_type")]


@pytest.fixture(scope="module")
def jax_twins():
    from tests.test_torch_acoustic import init_jax_twins

    return init_jax_twins(seed=5)


@pytest.mark.parametrize("path,key", _ABSENT_KEYS,
                         ids=[".".join(p + (k,)) for p, k in _ABSENT_KEYS])
def test_absent_fixed_key_raises_or_builds_the_jax_model(jax_twins, path,
                                                         key):
    """A config without one of the fixed switches: the port either raises,
    naming the key (and then JAX's default is a value the port does not
    implement), or builds the model JAX builds with its default, which
    gives JAX's frame lengths and decoder conditioning on the same weights
    (none of the keys reaches the decoder's arithmetic)."""
    import copy

    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
    from tests.test_torch_acoustic import _inputs, _t
    from tests.test_torch_cuda import TINY_BERT, tiny_model_config

    default = _jax_fields(_jax_class(path))[key]
    cfg = copy.deepcopy(tiny_model_config())
    section = cfg
    for k in path:
        section = section[k]
    section.pop(key, None)
    try:
        port = flagship.build_model(cfg, "cpu", 0, TINY_BERT)
    except ValueError as e:
        assert ".".join(path + (key,)) in str(e)
        assert default != flagship._FIXED[path][key]
        return
    model, variables, _ = jax_twins
    if path:
        sub = getattr(model, path[0]).clone(**{key: default})
        model = model.clone(**{path[0]: sub})
    else:
        model = model.clone(**{key: default})
    load_jax_variables(port, variables)
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
    # tests/test_torch_acoustic.py::TOL
    for name, o, r in zip(("cond", "flens", "fmask", "log_cf0", "vuv",
                           "raw"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   atol=1e-4, rtol=1e-4)
