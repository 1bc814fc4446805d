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


EXPERIMENTAL_MODULES = (
    "nn.convnext", "nn.mrf", "nn.conformer_local", "nn.transformer",
    "models.unet", "models.glow", "models.nnsvs_diffusion", "models.cnf",
    "models.score_sde")
DATA_PREP_MODULES = (
    "utils", "utils.host", "utils.progress", "data_prep.common",
    "data_prep.compute_utt_stats", "data_prep.add_style_prompt_tags",
    "data_prep.prepare_mfa", "data_prep.run_mfa", "data_prep.finalize_mfa")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_modules_import_without_jax():
    """Import every port module (and chip_smoke.py) in a fresh interpreter;
    none of JAX or the JAX package may be loaded."""
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods] + ["chip_smoke"]
    # the serving and reference-audio modules of the second slice, and
    # the experimental nets, host helpers and data-prep command lines
    assert {f"promptttspp_tpu_torch.{m}" for m in (
        "vocoders.streaming", "models.style_encoder", "nn.gru", "ops.stft",
        "ops.mel", *EXPERIMENTAL_MODULES, *DATA_PREP_MODULES)} <= set(mods)
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
    "bin.eval", "tools.synthetic_corpus", *DATA_PREP_MODULES)]


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


# The JAX module behind each section of flagship._JAX_DEFAULTS
_JAX_CLASSES = {
    (): "promptttspp_tpu.models.prompttts.PromptTTSMDNDurCFG",
    ("phoneme_embedding",):
        "promptttspp_tpu.models.phoneme_embedding.PhonemeEmbedding",
    ("encoder",): "promptttspp_tpu.nn.conformer.ConformerEncoder",
    ("variance_adaptor",):
        "promptttspp_tpu.models.variance_adaptor.VarianceAdaptor",
    ("variance_adaptor", "duration_predictor"):
        "promptttspp_tpu.models.variance_adaptor.MDNPredictor",
    ("variance_adaptor", "pitch_predictor"):
        "promptttspp_tpu.models.variance_adaptor.Predictor",
    ("variance_adaptor", "energy_predictor"):
        "promptttspp_tpu.models.variance_adaptor.Predictor",
    ("variance_adaptor", "frame_prior_network"):
        "promptttspp_tpu.models.frame_prior.FramePriorNetwork",
    ("style_mdn",): "promptttspp_tpu.nn.mdn.MDNLayer",
    ("reference_encoder",):
        "promptttspp_tpu.models.style_encoder.StyleEncoder",
    ("decoder",): "promptttspp_tpu.models.diffusion.GaussianDiffusion",
    ("decoder", "denoise_fn"): "promptttspp_tpu.models.diffusion.DiffNet",
}


def _jax_class(path):
    import importlib

    module, _, name = _JAX_CLASSES[path].rpartition(".")
    return getattr(importlib.import_module(module), name)


def test_jax_defaults_are_the_jax_fields():
    """``flagship._JAX_DEFAULTS`` (what ``build_model`` reads for an absent
    key) equals the defaults of the JAX dataclass fields, so a changed
    JAX default fails here; ``_FIXED`` pins only the decoder's pipeline
    mesh, at JAX's default."""
    from promptttspp_tpu_torch import flagship

    assert set(flagship._JAX_DEFAULTS) == set(_JAX_CLASSES)
    for path, defaults in flagship._JAX_DEFAULTS.items():
        fields = _jax_fields(_jax_class(path))
        assert defaults == {k: fields[k] for k in defaults}, path
    assert flagship._FIXED == {("decoder",): dict(pipeline_mesh=None)}
    assert _jax_fields(_jax_class(("encoder",)))["rel_pos_type"] is None


ABSENT = object()  # the config omits the key: JAX's default


def _c():
    from tests.test_torch_cuda import C

    return C


# Every switch of the model config the port used to refuse, at each value
# JAX builds (ABSENT: the key left out, JAX's dataclass default), as
# {section path: {key: value}}; "energy" adds JAX's energy branch with the
# pitch predictor's widths.
SWITCHES = {
    "norm_style_emb=false": {(): dict(norm_style_emb=False)},
    "mdn_disable_amp=false": {(): dict(mdn_disable_amp=False)},
    "style_mdn=absent": {(): dict(style_mdn=ABSENT)},
    "phoneme_embedding.do_scale=absent": {
        ("phoneme_embedding",): dict(do_scale=ABSENT)},
    "encoder.positionwise_layer_type=conv1d-linear": {
        ("encoder",): dict(positionwise_layer_type="conv1d-linear")},
    "encoder.scaled_abs_pos_selfattn": {
        ("encoder",): dict(pos_enc_layer_type="scaled_abs_pos",
                           selfattention_layer_type="selfattn")},
    "encoder.rel_pos_type=absent": {("encoder",): dict(rel_pos_type=ABSENT)},
    "encoder.macaron_style=false": {("encoder",): dict(macaron_style=False)},
    "encoder.use_cnn_module=false": {("encoder",): dict(use_cnn_module=False)},
    "encoder.normalize_before=false": {
        ("encoder",): dict(normalize_before=False)},
    "encoder.activation_type=relu": {
        ("encoder",): dict(activation_type="relu")},
    # JAX's ConformerEncoder defaults: Linear FFN, absolute positions,
    # plain attention, no macaron, no conv module
    "encoder.every_switch_absent": {("encoder",): dict(
        positionwise_layer_type=ABSENT, positionwise_conv_kernel_size=ABSENT,
        pos_enc_layer_type=ABSENT, selfattention_layer_type=ABSENT,
        macaron_style=ABSENT, use_cnn_module=ABSENT, cnn_module_kernel=ABSENT,
        rel_pos_type=ABSENT)},
    "encoder.idim!=attention_dim": {("phoneme_embedding",): dict(channels=24),
                                    ("encoder",): dict(idim=24)},
    "style_mdn.dim_wise=false": {("style_mdn",): dict(dim_wise=False)},
    "variance_adaptor.energy": {("variance_adaptor",): "energy"},
    "variance_adaptor.frame_prior_network=absent": {
        ("variance_adaptor",): dict(frame_prior_network=ABSENT)},
    "duration_predictor.dim_wise=false": {
        ("variance_adaptor", "duration_predictor"): dict(dim_wise=False)},
    "duration_predictor.disable_amp=absent": {
        ("variance_adaptor", "duration_predictor"): dict(disable_amp=ABSENT)},
}


def _apply_switch(cfg, spec):
    """The port's config with ``spec`` applied (ABSENT pops the key)."""
    from chip_smoke import energy_branch

    for path, values in spec.items():
        section = cfg
        for key in path:
            section = section[key]
        if values == "energy":
            values = energy_branch(section)
        for key, value in values.items():
            if value is ABSENT:
                section.pop(key, None)
            else:
                section[key] = value
    return cfg


def _jax_switched(model, variables, spec, port_sd, seed):
    """JAX's twin with ``spec`` applied (ABSENT: the field's default), each
    changed section in ``variables`` replaced by the port's init of it
    (``port_sd``, laid out in JAX's tree of the section: no JAX init
    compiles), perturbed; the other sections keep their weights."""
    import copy

    import jax
    import jax.numpy as jnp

    from promptttspp_tpu.models.variance_adaptor import PitchEmb, Predictor
    from tests.test_torch_acoustic import jax_variables_from, perturbed

    def resolve(cls, values):
        fields = _jax_fields(cls)
        return {k: fields[k] if v is ABSENT else v for k, v in values.items()}

    C = _c()
    variables = copy.deepcopy(variables)
    top, changed = {}, set()
    for path, values in spec.items():
        if not path:
            top.update(resolve(type(model), values))
            continue
        sub = getattr(model, path[0])
        if len(path) == 2:
            inner = getattr(sub, path[1])
            sub = sub.clone(**{path[1]: inner.clone(
                **resolve(type(inner), values))})
        elif values == "energy":  # the tiny pitch predictor's widths
            sub = sub.clone(
                energy_predictor=Predictor(channels=C, out_channels=1,
                                           kernel_size=5, dropout=0.0,
                                           num_layers=2),
                energy_emb=PitchEmb(1, C, 1))
        else:
            sub = sub.clone(**resolve(type(sub), values))
        top[path[0]] = sub
        changed.add(path[0])
    if top.get("style_mdn", "") is None:
        variables["params"].pop("style_mdn")
    model = model.clone(**top)
    rng = np.random.RandomState(seed)
    B, Tp, Tf = 2, 6, 12
    emb_c = model.encoder.idim
    example = {
        "phoneme_embedding": (jnp.asarray(rng.randint(1, 90, (B, Tp))),
                              jnp.ones((B, Tp, 1))),
        "encoder": (jnp.asarray(rng.randn(B, Tp, emb_c), jnp.float32),
                    jnp.array([Tp, Tp - 2])),
        "style_mdn": (jnp.asarray(rng.randn(B, 1, C), jnp.float32),),
        "variance_adaptor": (
            jnp.asarray(rng.randn(B, Tp, C), jnp.float32),
            jnp.ones((B, Tp), bool), jnp.ones((B, Tf), bool),
            jnp.full((B, Tp), 2, jnp.int32), jnp.zeros((B, Tf, 1)),
            jnp.zeros((B, Tf, 1)), jnp.zeros((B, Tf, 1))),
    }
    for name in sorted(changed):
        shapes = jax.eval_shape(getattr(model, name).init,
                                jax.random.PRNGKey(seed), *example[name])
        fresh = perturbed(jax_variables_from(shapes, port_sd, (name,)), seed)
        for coll in ("params", "batch_stats"):
            variables[coll].pop(name, None)
            if fresh.get(coll):
                variables[coll][name] = fresh[coll]
        if name == "variance_adaptor":
            # init_jax_twins' duration head: 2-4 frames per phone
            head = variables["params"][name]["duration_predictor"][
                "out_layer"]
            head["mu"]["kernel"] *= 0.3
            head["mu"]["bias"] += np.log(3.0)
            head["log_sigma"]["kernel"] *= 0.1
            head["log_sigma"]["bias"] -= 2.0
    return model, variables


@pytest.fixture(scope="module")
def jax_twins():
    from tests.test_torch_acoustic import init_jax_twins

    return init_jax_twins(seed=5, port_init=True)


@pytest.mark.parametrize("case", list(SWITCHES))
def test_switch_builds_the_jax_model(jax_twins, case):
    """A config with one of the model's switches flipped (or left out,
    meaning JAX's default) builds the model JAX builds from it: on the
    same weights (the switched sections re-initialized in JAX, loaded by
    name with none missing or left over), the frame lengths and the
    decoder's conditioning (the variance adaptor's output, frame mask,
    log-F0 and V/UV) equal JAX's."""
    import copy

    from promptttspp_tpu_torch import flagship
    from promptttspp_tpu_torch.compat.from_jax import load_jax_variables
    from tests.test_torch_acoustic import _inputs, _t
    from tests.test_torch_cuda import TINY_BERT, tiny_model_config

    spec = SWITCHES[case]
    seed = list(SWITCHES).index(case)
    cfg = _apply_switch(copy.deepcopy(tiny_model_config()), spec)
    port = flagship.build_model(cfg, "cpu", seed, TINY_BERT)
    model, variables = _jax_switched(*jax_twins[:2], spec, port.state_dict(),
                                     seed)
    load_jax_variables(port, variables)
    phoneme, plens, ids, mask = _inputs()
    kw = dict(prompt_ids=jnp.asarray(ids), prompt_mask=jnp.asarray(mask),
              use_max=True, noise_scale=0.0)
    jflens = np.asarray(model.apply(
        variables, jnp.asarray(phoneme), jnp.asarray(plens),
        method=type(model).infer_frame_lengths, **kw))
    assert 16 <= jflens.min() and jflens.max() <= 64, jflens
    ref = model.apply(variables, jnp.asarray(phoneme), jnp.asarray(plens),
                      64, method=type(model).infer_cond, **kw)
    with torch.no_grad():
        flens = port.infer_frame_lengths(_t(phoneme), _t(plens), _t(ids),
                                         _t(mask))
        out = port.infer_cond(_t(phoneme), _t(plens), 64, _t(ids),
                              _t(mask), use_max=True, noise_scale=0.0)
    np.testing.assert_array_equal(flens.numpy(), jflens)
    # tests/test_torch_acoustic.py::TOL
    for name, o, r in zip(("cond", "flens", "fmask", "log_cf0", "vuv",
                           "raw"), out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name,
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("path,key,value,match", [
    (("encoder",), "positionwise_layer_type", "conv2d",
     "positionwise_layer_type 'conv2d'"),
    (("encoder",), "pos_enc_layer_type", "rope", "pos_enc_layer_type 'rope'"),
    (("encoder",), "selfattention_layer_type", "lightconv",
     "selfattention_layer_type 'lightconv'"),
    (("encoder",), "return_mask", True, "encoder.return_mask"),
    (("encoder",), "selfattention_layer_type", "selfattn",
     "pos_enc_layer_type 'rel_pos' needs selfattention_layer_type"),
])
def test_switch_jax_rejects_raises(path, key, value, match):
    """A value JAX's model does not build or cannot run (an unknown layer
    type, a relative encoding without its attention, the encoder's
    (output, mask) pair) raises at build, naming the key."""
    import copy

    from promptttspp_tpu_torch import flagship
    from tests.test_torch_cuda import TINY_BERT, tiny_model_config

    cfg = _apply_switch(copy.deepcopy(tiny_model_config()),
                        {path: {key: value}})
    with pytest.raises(ValueError, match=match):
        flagship.build_model(cfg, "cpu", 0, TINY_BERT)
