"""bf16 training in the port against JAX's ``make_train_step(bf16=True)``,
on the CPU, with the tiny twins of ``tests/test_torch_train.py`` (the same
weights, every dropout rate 0, the diffusion steps and noise given).

JAX casts every float parameter and every float leaf of the batch to
bfloat16 and lets its promotion rules decide the rest: most of the model
computes in float32 with bf16-rounded weights (the phoneme embedding's
float32 mask, the positional tables, the schedule constants and BERT's
``np.sqrt`` scale promote), while the reference encoder, BERT's attention
scores and the pitch embedding compute in bf16. The port must do the same.
Its losses must be nearer JAX's bf16 losses than JAX's own float32 losses
are, so a port that silently computed in float32 fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.train.state import TrainState
from promptttspp_tpu_torch.train.trainer import TTSTrainer
from tests.test_torch_cuda import (
    OPT, TINY_CLI_MODEL, torch_batch, train_batch)
from tests.test_torch_train import (  # noqa: F401 (twins: a fixture)
    LOSS_KEYS, _named, port_model, twins)

# the port's bf16 losses against JAX's: torch and XLA round the bf16
# regions (the reference encoder's GRU, BERT's attention) at other points
# (XLA keeps excess precision inside fusions); 4.4e-4 apart at the first
# update, against a 4.9e-3 gap between JAX's bf16 and float32 losses
BF16_LOSS_ATOL = 1.5e-3
# grad_norm, relative: 8e-4 apart at the first update (gap 3.5e-3)
BF16_GRAD_NORM_RTOL = 2e-3
# every parameter and BatchNorm statistic after 3 updates: 99% of the
# elements within 1e-4 (4.1e-5 measured; the median element moved 2.5e-4).
# The rest may part by up to two AdamW steps each way: an element whose
# gradient is near 0 in both runs gets updates of opposite signs, of up to
# about the rate each (bound: 3 x the sum of the three rates)
BF16_PARAM_Q99_ATOL = 1e-4


def _bf16_batch(batch):
    from promptttspp_tpu.train.state import _cast_floats

    return _cast_floats({k: jnp.asarray(v) for k, v in batch.items()},
                        jnp.bfloat16)


@pytest.fixture(scope="module")
def jax_bf16(twins):  # noqa: F811
    """JAX's three bf16 updates on train_batch(seed=10..12): each update's
    metrics and the final state."""
    from promptttspp_tpu.train.state import (
        TrainState as JaxState, bert_freeze_mask, freeze_opt_state,
        make_optimizer, make_train_step)

    model, variables = twins
    mask = bert_freeze_mask(variables["params"])
    tx = make_optimizer(base_lr=OPT["lr"], warmup_steps=OPT["warmup_steps"],
                        betas=OPT["betas"], weight_decay=OPT["weight_decay"])
    state = freeze_opt_state(JaxState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=None), tx, mask)
    step = make_train_step(model, tx, donate=False, bf16=True,
                           freeze_mask=mask)
    metrics = []
    for i in range(3):
        batch = {k: jnp.asarray(v) for k, v in train_batch(seed=10 + i)
                 .items()}
        state, m = step(state, batch, jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.fixture(scope="module")
def port_bf16(twins):  # noqa: F811
    _, variables = twins
    state = TrainState(port_model(variables), seed=0, bf16=True, **OPT)
    metrics = [{k: float(v) for k, v in state.train_step(
        torch_batch(train_batch(seed=10 + i))).items()} for i in range(3)]
    return metrics, state


def test_first_update_matches_jax_bf16_not_float32(twins, jax_bf16,
                                                   port_bf16):
    """Every loss of the first update within BF16_LOSS_ATOL of JAX's bf16
    one, and grad_norm within BF16_GRAD_NORM_RTOL; JAX's own float32 loss
    (the same weights and batch) lies further from its bf16 loss than
    that."""
    model, variables = twins
    batch = {k: jnp.asarray(v) for k, v in train_batch(seed=10).items()}
    f32 = jax.jit(lambda v, b: model.apply(
        v, b, train=True, mutable=["batch_stats"])[0])(variables, batch)
    ref, got = jax_bf16[0][0], port_bf16[0][0]
    gap = abs(ref["loss"] - float(f32["loss"]))
    assert gap > 3 * BF16_LOSS_ATOL, gap
    for k in LOSS_KEYS:
        assert abs(got[k] - ref[k]) <= BF16_LOSS_ATOL, (k, got[k], ref[k])
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=BF16_GRAD_NORM_RTOL)


def test_three_updates_match_jax_bf16(twins, jax_bf16, port_bf16):
    """Each update's losses and grad_norm, then every parameter and
    BatchNorm statistic after the third; the masters, the optimizer's
    moments and the statistics stay float32."""
    _, variables = twins
    (ref, jstate), (got, state) = jax_bf16, port_bf16
    for i in range(3):
        for k in LOSS_KEYS:
            assert abs(got[i][k] - ref[i][k]) <= BF16_LOSS_ATOL, (i, k)
        np.testing.assert_allclose(got[i]["grad_norm"],
                                   ref[i]["grad_norm"],
                                   rtol=BF16_GRAD_NORM_RTOL, err_msg=str(i))
    sd = state.model.state_dict()
    named = {**_named(jstate.params),
             **_named(jstate.batch_stats, "batch_stats")}
    init = _named(variables["params"])
    diffs, moves = [], []
    for k, v in named.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert sd[k].dtype == torch.float32, k
        diffs.append(np.abs(sd[k].numpy() - v.numpy()).ravel())
        if k in init:
            moves.append(np.abs((v - init[k]).numpy()).ravel())
    diffs = np.concatenate(diffs)
    assert np.quantile(diffs, 0.99) <= BF16_PARAM_Q99_ATOL
    assert diffs.max() <= 3 * sum(state.schedule(i) for i in range(3))
    assert np.median(np.concatenate(moves)) > 2 * BF16_PARAM_Q99_ATOL
    assert all(p.dtype == torch.bfloat16 for p in state.shadow.parameters())
    for group in state.optimizer.state.values():
        assert all(t.dtype == torch.float32 for t in group.values()
                   if t.is_floating_point())
    # the shadow's statistics are the masters' tensors
    shadow = dict(state.shadow.named_buffers())
    for k, b in state.model.named_buffers():
        assert shadow[k] is b, k


def test_submodule_output_dtypes_match_jax(twins):
    """The output dtypes of each top-level submodule in a bf16 forward:
    JAX's (flax ``capture_intermediates``) against the port's (forward
    hooks on its bf16 shadow)."""
    from promptttspp_tpu.train.state import _cast_floats

    model, variables = twins
    batch = train_batch()
    _, mut = jax.jit(lambda v, b: model.apply(
        v, b, train=True, mutable=["batch_stats", "intermediates"],
        capture_intermediates=True))(
        {"params": _cast_floats(variables["params"], jnp.bfloat16),
         "batch_stats": variables["batch_stats"]}, _bf16_batch(batch))
    want = {k: [str(x.dtype) for x in jax.tree.leaves(v["__call__"])]
            for k, v in mut["intermediates"].items() if k != "__call__"}
    state = TrainState(port_model(variables), seed=0, bf16=True, **OPT)
    got = {}

    def hook(name):
        def record(module, args, out):
            got[name] = [str(t.dtype).replace("torch.", "") for t in
                         torch.utils._pytree.tree_leaves(out)
                         if isinstance(t, torch.Tensor)]
        return record

    for name, m in state.shadow.named_children():
        m.register_forward_hook(hook(name))
    state.train_step(torch_batch(batch))
    got["phoneme_embedding"] = got.pop("phoneme_emb")
    # JAX's variance adaptor also returns its (absent) energy prediction
    assert set(got) == set(want)
    assert want["reference_encoder"] == ["bfloat16"]
    assert want["prompt_encoder"] == ["float32"]
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


def test_fp16_is_bf16_bit_for_bit(tmp_path):
    """``train.fp16=true`` is an alias of ``train.bf16=true``: the same
    update from the same seed."""
    outs = []
    for key in ("train.bf16=true", "train.fp16=true"):
        cfg = conf.compose("train", [f"output_dir={tmp_path}", "device=cpu",
                                     "train.seed=3", key, *TINY_CLI_MODEL])
        state = TTSTrainer(cfg).build_state()
        assert state.shadow is not None
        m = state.train_step(torch_batch(_cli_batch()))
        outs.append(({k: v.item() for k, v in m.items()},
                     state.model.state_dict()))
    assert outs[0][0] == outs[1][0]
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k


def _cli_batch():
    """train_batch() at the widths of TINY_CLI_MODEL (80 mels, prompt ids
    of a 30,522-word vocabulary)."""
    rng = np.random.RandomState(0)
    b = train_batch(seed=1)
    B, Tf = b["mel"].shape[:2]
    b["mel"] = rng.randn(B, Tf, 80).astype(np.float32)
    b["diffusion_noise"] = rng.randn(B, Tf, 80).astype(np.float32)
    return b
