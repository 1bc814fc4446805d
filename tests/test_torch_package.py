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

import numpy as np
import pytest
import torch

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
    from promptttspp_tpu_torch import flagship

    model = compose(REPO / "conf", "train").model.to_dict()
    assert _strip_targets(model) == flagship.MODEL
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
    an option the port does not have."""
    import copy

    from promptttspp_tpu_torch import flagship
    from tests.test_torch_cuda import TINY_BERT, tiny_model_config

    model = flagship.bias_duration_head(
        flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT), 10.0)
    assert not model.training
    head = model.variance_adaptor.duration_predictor.out_layer
    assert torch.all(head.mu.weight == 0)
    bad = copy.deepcopy(tiny_model_config())
    bad["encoder"]["rel_pos_type"] = "legacy"
    with pytest.raises(ValueError, match="rel_pos_type"):
        flagship.build_model(bad, "cpu", 0, TINY_BERT)


# The decoder's config keys that _model_from_config reads; every other
# field of the JAX GaussianDiffusion / DiffNet must be refused at anything
# but JAX's default.
_READ = {"decoder": {"in_dim", "out_dim", "norm_scale", "K_step", "a_min",
                     "a_max", "denoise_fn", "schedule_type", "pndm_speedup",
                     "infer_io_dtype"},
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
    (("decoder", "pipeline_microbatches"), 4),
    (("decoder", "pipeline_batch_axis"), "data"),
], ids=lambda v: ".".join(v) if isinstance(v, tuple) else repr(v))
def test_unported_decoder_switch_raises(path, value):
    """A decoder switch that the JAX model honours and the port does not
    implement (the pipelined decode) raises at build, naming the key, where
    the port used to drop it."""
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
