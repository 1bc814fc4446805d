"""Package-level checks of the PyTorch port: it imports neither JAX nor the
JAX package, its flagship constants equal the YAML configs, its entry
points refuse a missing GPU, and its host helpers equal their originals."""

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
