"""Tensor parallelism of the port (``parallel/tp.py``) and the model axis of
training, on the CPU with gloo: the sharding held to JAX's
``param_partition_spec``, and four gloo ranks, spawned once, that train
TP=2 against one process and against JAX's TP step on a
``make_mesh(data=4, model=2)`` mesh, DP x TP (2 x 2), DP x PP (2 x 2) and
DP x PP with the model axis across the data shards
(``model_spans_processes``), each against one process; and
``bin/train.py`` with a model axis and pipeline microbatches (a second
spawn) and its whole checkpoint served by ``bin/synthesize.py`` with no
mesh. JAX's TP step compiles in a thread from the first test on, so the
train CLI's test runs before the four ranks'.

The ranks import torch, the port and test modules that import no JAX.
"""

import copy
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.bin import train as train_cli
from promptttspp_tpu_torch.parallel.distributed import (
    ModelGroup, process_groups)
from promptttspp_tpu_torch.parallel.tp import (
    gather_state_dict, local_state_dict, param_partition_spec, shard_module)
from promptttspp_tpu_torch.train.state import TrainState, step_generator
from tests.test_torch_cuda import (
    OPT, TINY_BERT, ZERO_BERT, tiny_model_config, torch_batch, train_batch,
    zero_dropout_config)
from tests.test_torch_ddp import global_batch

WORLD = 4
JOIN_S = 150
# parameters against the largest magnitude, losses relative: the bars of
# tests/test_torch_ddp.py (the sums only run in another order)
PARAM_RTOL, LOSS_RTOL = 1e-5, 1e-5
# the global norm sums every gradient's squares in another order than
# XLA's: the bar of the one-process step against JAX's (LOSS_TOL of
# tests/test_torch_train.py, which imports JAX and so is not imported here)
NORM_TOL = dict(atol=1e-4, rtol=1e-3)
MICRO = 2
# 2-row slabs of a 4-row global batch (ragged, padded), two updates
BATCHES = [(7, 4), (8, 3)]


class FakeGroup:
    """A ModelGroup's rank and world without a process group: enough to
    shard a module (no collective runs)."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world


def pp_model_config():
    """The tiny model with a DiffNet of 4 blocks of dilation cycle 2: two
    pipeline stages of one cycle each."""
    cfg = tiny_model_config()
    cfg["decoder"]["denoise_fn"].update(residual_layers=4,
                                        dilation_cycle_length=2)
    return cfg


# ------------------------------------------------------------ sharding
def _draw(path, shape, rng):
    """A value for the variable at ``path`` drawn with numpy: a kernel
    N(0, 1 / fan-in), a norm's scale 1 + N(0, 0.05), a running variance
    1 + |N(0, 0.05)|, anything else N(0, 0.05)."""
    name = path[-1]
    x = rng.randn(*shape).astype(np.float32)
    if name == "kernel":
        return x / np.float32(np.sqrt(np.prod(shape[:-1])))
    if name == "scale":
        return 1 + 0.05 * x
    if name == "var":
        return 1 + 0.05 * np.abs(x)
    return 0.05 * x


@pytest.fixture(scope="module")
def twins():
    """tests/test_torch_train.py's JAX twin (every dropout 0) with its
    variables drawn with numpy from a seed (the tree's shapes from an
    abstract init, which compiles nothing)."""
    import jax

    import tests.test_train as tt
    from promptttspp_tpu.flagship import example_batch
    from tests.test_torch_train import zero_dropout_jax

    model = zero_dropout_jax(tt.tiny_model(dropout=False))
    batch = example_batch(B=2, Tp=8, Tf=48, L=8, mel_dim=20, seed=0)
    rngs = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "dropout", "diffusion", "style"))}
    shapes = jax.eval_shape(lambda r, b: model.init(r, b, train=True),
                            rngs, batch)
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: _draw(tuple(str(getattr(k, "key", k)) for k in path),
                              a.shape, rng),
        {k: dict(v) for k, v in shapes.items()})
    return model, variables


@pytest.fixture(scope="module")
def jax_tp_step(twins):
    """JAX's TP step (``_jax_tp_step``), compiling and running in a thread
    from the module's first test on, while the tests before the spawned
    ranks' run."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_jax_tp_step, *twins)


def _jax_specs(variables):
    """JAX's ``param_partition_spec`` of the tiny twin's parameters, by the
    port's names: {name: the sharded axis in the torch layout}."""
    import jax

    from promptttspp_tpu.parallel.tp import param_partition_spec as jspec
    from promptttspp_tpu_torch.compat.from_jax import (
        _param, jax_params_to_state_dict, torch_module_key)

    out = {}

    def walk(tree, path=()):
        if hasattr(tree, "items"):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        spec = tuple(jspec(path, tree))
        axis = [i for i, a in enumerate(spec) if a == "model"]
        shape = np.shape(tree)
        marker = np.zeros(shape, np.int32)
        if axis:  # the index along the sharded axis, everywhere
            view = [1] * len(shape)
            view[axis[0]] = shape[axis[0]]
            marker = marker + np.arange(shape[axis[0]]).reshape(view)
        leaf, moved = _param(path[-1], marker)
        name = f"{torch_module_key(path[:-1])}.{leaf}".lstrip(".")
        # where the sharded axis lands after the torch transpose
        out[name] = None if not axis else [
            d for d in range(moved.ndim)
            if np.any(np.diff(moved, axis=d) != 0)][0]

    walk(jax.device_get(variables["params"]))
    return out, jax_params_to_state_dict(jax.device_get(variables))


def test_partition_specs_match_jax(twins, jax_tp_step):
    """The port's ``param_partition_spec`` names JAX's sharded parameters,
    on the same axis in the torch layout, and no others; the gated halves
    of ``dilated_conv`` and ``conditioner_projection`` are the documented
    difference (interleaved, not contiguous). ``shard_module`` then gives
    each rank the slices of the whole tensors carried over from JAX."""
    specs, full = _jax_specs(twins[1])
    port = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    port.load_state_dict(full)
    names = dict(port.named_parameters())
    assert set(names) == set(specs)
    for name, p in names.items():
        ours = param_partition_spec(name, p)
        assert (None if ours is None else ours.dim) == specs[name], name
        if ours is not None:
            gated = name.split(".")[-2] in ("dilated_conv",
                                            "conditioner_projection")
            assert (ours.interleave == 2) == gated, name
    for rank in range(2):
        model = copy.deepcopy(port)
        shard_module(model, FakeGroup(rank, 2))
        local = local_state_dict(model, full)
        sd = model.state_dict()
        for name, spec in model.tp_shards.items():
            assert torch.equal(sd[name], local[name]), name
            assert sd[name].shape[spec.dim] * 2 == full[name].shape[spec.dim]
        w = sd["decoder.denoise_fn.residual_layers.0.dilated_conv.weight"]
        R = w.shape[0]  # this rank's gate rows, then its filter rows
        whole = full["decoder.denoise_fn.residual_layers.0.dilated_conv."
                     "weight"]
        half = whole.shape[0] // 2
        assert torch.equal(w[:R // 2], whole[rank * R // 2:
                                             (rank + 1) * R // 2])
        assert torch.equal(w[R // 2:], whole[half + rank * R // 2:
                                             half + (rank + 1) * R // 2])
        assert model.encoder.encoder.encoders[0].self_attn.h == 1
        assert model.prompt_encoder.bert.model.encoder.layer[0].attention \
            .self.h == 1


@pytest.mark.parametrize("world,key", [
    (4, "model.encoder.attention_heads"),
    (3, "model.encoder.attention_heads")])
def test_heads_that_do_not_divide_raise(world, key):
    """A model axis that does not divide the conformer's 2 heads raises,
    naming the config key, before any parameter is cut."""
    model = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        shard_module(model, FakeGroup(0, world))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


class _CountedCopy(torch.autograd.Function):
    """``copy``'s identity, counting the backward all-reduces it stands
    for."""

    @staticmethod
    def forward(ctx, x, counts):
        ctx.counts = counts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.counts["copy"] += 1
        return grad, None


class CountingGroup(FakeGroup):
    """Rank 0 of 2 whose collectives only count (their values are not the
    group's): the all-reduces a TP step places, by kind."""

    def __init__(self):
        super().__init__(0, 2)
        self.counts = {"copy": 0, "reduce": 0, "gather": 0}

    def copy(self, x):
        return _CountedCopy.apply(x, self.counts)

    def reduce(self, x):
        self.counts["reduce"] += 1
        return x * 1

    def gather(self, x, dim=-1):
        self.counts["gather"] += 1
        return torch.cat([x, x], dim)


def test_one_collective_per_product_and_shared_input():
    """A TP step of the tiny model places one all-reduce after each row
    product (the conformer's linear_out and two w_2, BERT's two, the two
    DiffNet blocks' output_projection and mlp.2, the GST's linear_out: 9),
    one gather (adaptor.0), and one backward all-reduce per distinct input
    of the column products that needs a gradient: q, k and v of the
    conformer share one, as the GST's k and v do; the DiffNet's cond one
    for every block's conditioner projection; each dilated_conv and w_1
    its own; BERT's intermediate.dense (its frozen attention's input takes
    no gradient): 1 + 2 + 1 + 2 + 1 + 2 + 1 = 10."""
    model = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    group = CountingGroup()
    shard_module(model, group)
    TrainState(model, seed=0, **OPT)  # the BERT freeze
    model.train()
    losses = model(torch_batch(train_batch(seed=0)),
                   generator=step_generator(0, 0, torch.device("cpu")))
    losses["loss"].backward()
    assert group.counts == {"copy": 10, "reduce": 9, "gather": 1}


def test_variant_encoder_is_sharded_as_jax_shards_it():
    """The plain attention's q/k/v (column) and out (row) and the Linear
    FFN's w_1 (column) and w_2 (row) of the variant's conformer
    (``chip_smoke.py::variant_config``: JAX's ConformerEncoder defaults)
    are sharded on the axes JAX's ``param_partition_spec`` names, and
    nothing else under the encoder is; a TP step then places one
    all-reduce after each row product and one per distinct column input
    of the encoder block (q|k|v, w_1): two of each where the flagship's
    block, with its macaron FFN, places three."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import variant_config
    from promptttspp_tpu.nn.conformer import ConformerEncoder as JaxEnc

    cfg = variant_config(tiny_model_config())
    enc = cfg["encoder"]
    jenc = JaxEnc(idim=enc["idim"], attention_dim=enc["attention_dim"],
                  attention_heads=enc["attention_heads"],
                  linear_units=enc["linear_units"],
                  num_blocks=enc["num_blocks"])
    # the specs read names and shapes only
    params = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jenc.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 4, enc["idim"])), jnp.array([4])))[
        "params"]
    specs, _ = _jax_specs({"params": {"encoder": params}})
    model = flagship.build_model(cfg, "cpu", 0, TINY_BERT)
    names = {k: p for k, p in model.named_parameters()
             if k.startswith("encoder.")}
    assert set(names) == set(specs)
    sharded = set()
    for name, p in names.items():
        ours = param_partition_spec(name, p)
        assert (None if ours is None else ours.dim) == specs[name], name
        if ours is not None:
            sharded.add(name.split(".", 4)[-1])
    assert sharded == {f"{m}.{leaf}" for m in (
        "self_attn.linear_q", "self_attn.linear_k", "self_attn.linear_v",
        "feed_forward.w_1") for leaf in ("weight", "bias")} | {
        "self_attn.linear_out.weight", "feed_forward.w_2.weight"}
    group = CountingGroup()
    shard_module(model, group)
    layer = model.encoder.encoder.encoders[0]
    assert layer.self_attn.h == 1
    assert layer.feed_forward.w_1.weight.shape[0] * 2 == enc["linear_units"]
    assert layer.feed_forward.w_2.weight.shape[1] * 2 == enc["linear_units"]
    assert layer.feed_forward.dropout.shard[0] == -1
    TrainState(model, seed=0, **OPT)  # the BERT freeze
    model.train()
    batch = train_batch(seed=0)
    batch["energy"] = np.ones_like(batch["vuv"])
    losses = model(torch_batch(batch),
                   generator=step_generator(0, 0, torch.device("cpu")))
    losses["loss"].backward()
    # test_one_collective_per_product_and_shared_input's 10 and 9, less
    # the macaron FFN's w_1 and w_2
    assert group.counts == {"copy": 9, "reduce": 8, "gather": 1}


def test_unknown_sharded_layer_raises():
    """A product JAX's spec shards by its name, held by a module
    ``shard_module`` does not know, raises, naming it, before anything is
    cut: a model group never replicates what JAX shards."""
    from promptttspp_tpu_torch.nn.layers import Linear

    model = flagship.build_model(tiny_model_config(), "cpu", 0, TINY_BERT)
    model.probe = torch.nn.Module()
    model.probe.linear_q = Linear(4, 4)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=r"probe\.linear_q"):
        shard_module(model, FakeGroup(0, 2))
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


# ------------------------------------------------------- spawned ranks
def _slab(batch, data):
    if data is None:
        return batch
    return {k: v[data.rows(len(v) // data.world)] for k, v in batch.items()}


def run_updates(cfg=None, data=None, tp=None, pp=None, bert=TINY_BERT,
                batches=None, state_dict=None, n=2):
    """Updates of the tiny model (``cfg``, dropout on) on ``batches``
    (default: the first ``n`` of ``BATCHES``' global batches) with this
    rank's rows (``data``),
    sharded over ``tp`` or pipelined over ``pp`` (a ModelGroup) in
    ``MICRO`` microbatches -> (losses, the whole parameters and buffers
    after them)."""
    model = flagship.build_model(cfg or tiny_model_config(), "cpu", seed=0,
                                 bert_config=bert)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if pp is not None:
        model.decoder = model.decoder.clone(
            pipeline=pp, pipeline_microbatches=MICRO,
            pipeline_batch_axis="data")
    if tp is not None:
        shard_module(model, tp, skip=("decoder.denoise_fn",) if pp else ())
    state = TrainState(model, seed=0, data=data, model_group=tp or pp, **OPT)
    if batches is None:
        batches = [global_batch(s, b) for s, b in BATCHES[:n]]
    losses = [{k: float(v) for k, v in state.train_step(
        torch_batch(_slab(b, data))).items()} for b in batches]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd.update(gather_state_dict(model))
    return losses, sd


def twin_batch():
    """tests/test_torch_train.py's batch with its draws given, padded to 4
    rows for JAX's four data shards."""
    from promptttspp_tpu_torch.parallel.mesh import pad_batch_to_multiple

    return pad_batch_to_multiple(train_batch(seed=10), 4)


def _rank(rank: int, port: int, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        out = {}
        # TP=2 alone: ranks {0, 1} and {2, 3}, each pair one data shard
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        pair = ModelGroup(rank % 2, 2, pairs[rank // 2],
                          [rank // 2 * 2, rank // 2 * 2 + 1])
        twin = torch.load(Path(out_dir) / "twin.pt")
        out["twin"] = run_updates(zero_dropout_config(), tp=pair,
                                  bert=ZERO_BERT, batches=[twin_batch()],
                                  state_dict=twin)
        data, model = process_groups(2)
        out["dp_tp"] = run_updates(data=data, tp=model)
        out["dp_pp"] = run_updates(pp_model_config(), data=data, pp=model,
                                   n=1)
        data, model = process_groups(2, model_spans_processes=True)
        out["spans"] = (data.rank, model.rank)
        out["spans_pp"] = run_updates(pp_model_config(), data=data,
                                      pp=model, n=1)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _jax_tp_step(model, variables):
    """JAX's TP step on ``make_mesh(data=4, model=2)``: the twins' train
    state (BERT freeze, AdamW, Noam, clip) placed by ``shard_state``, one
    update on ``twin_batch``."""
    import jax
    import jax.numpy as jnp

    from promptttspp_tpu.parallel.mesh import make_mesh, shard_batch
    from promptttspp_tpu.parallel.tp import shard_state
    from promptttspp_tpu.train.state import (
        TrainState as JaxState, bert_freeze_mask, freeze_opt_state,
        make_optimizer, make_train_step)

    mask = bert_freeze_mask(variables["params"])
    tx = make_optimizer(base_lr=OPT["lr"], warmup_steps=OPT["warmup_steps"],
                        betas=OPT["betas"], weight_decay=OPT["weight_decay"])
    mesh = make_mesh(data=4, model=2, devices=jax.devices()[:8])
    with mesh:
        jstate = freeze_opt_state(JaxState(
            step=jnp.zeros((), jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"], opt_state=None), tx, mask)
        jstate = shard_state(jstate, mesh)
        step = make_train_step(model, tx, donate=False, freeze_mask=mask)
        jstate, metrics = step(jstate, shard_batch(
            {k: np.asarray(v) for k, v in twin_batch().items()}, mesh),
            jax.random.PRNGKey(0))
        return jax.device_get(jstate), {k: float(v)
                                        for k, v in metrics.items()}


def _close(got, ref, what):
    """losses within LOSS_RTOL, parameters and statistics within
    PARAM_RTOL of the largest magnitude; they moved well beyond it."""
    (losses, sd), (ref_losses, ref_sd) = got, ref
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        for k in b:
            assert np.isclose(a[k], b[k], rtol=LOSS_RTOL, atol=0), (
                what, i, k, a[k], b[k])
    diff = scale = 0.0
    for k, v in ref_sd.items():
        if not v.is_floating_point():
            assert torch.equal(sd[k], v), (what, k)
            continue
        assert sd[k].shape == v.shape, (what, k)
        diff = max(diff, float((sd[k] - v).abs().max()))
        scale = max(scale, float(v.abs().max()))
    assert diff <= PARAM_RTOL * scale, (what, diff, scale)


def test_train_cli_model_axis_and_serving(tmp_path, monkeypatch):
    """``bin/train.py`` with ``train.mesh.model=2`` and
    ``train.mesh.pipeline_microbatches=2`` on the CPU spawns two gloo
    ranks: the DiffNet pipelined over them in 2 microbatches, the rest
    sharded (TP). Its ``ckpt/last`` holds whole tensors, which resume cuts
    back to each rank's slices (parameters and AdamW moments), and
    ``bin/synthesize.py`` serves it without a mesh."""
    import os

    from scipy.io import wavfile

    from promptttspp_tpu_torch.bin import conf
    from promptttspp_tpu_torch.bin import synthesize as synth_cli
    from promptttspp_tpu_torch.compat.torch_ckpt import (
        BIGVGAN_WEIGHT_NORMED, to_reference_state_dict)
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        training_rows, write_corpus, write_training_corpus)
    from tests.test_torch_cuda import TINY_CLI_MODEL, TINY_CLI_VOCODER
    from tests.test_torch_train_data import candidates

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch threads
    root = tmp_path / "corpus"
    cands, spk = candidates(n_keys=8)
    rows = training_rows(14, cands, spk, phones=(4, 12),
                         frames_per_phone=(2, 6), valid_every=7, seed=2)
    write_corpus(root, [dict(spk_id=rows[0]["spk_id"], item_name="eval_0",
                             seq=rows[0]["seq"],
                             style_prompt_key=rows[0]["style_prompt_key"])],
                 cands, wav_seconds=0.5, mel_mean=-4.5, mel_std=2.1)
    write_training_corpus(root, rows, cands, spk, mel_mean=-4.5,
                          mel_std=2.1)
    vocoder = flagship.build_vocoder("cpu", seed=8, cfg=conf.compose(
        "synthesize", TINY_CLI_VOCODER)["vocoder"])
    torch.save({"generator": to_reference_state_dict(
        vocoder, BIGVGAN_WEIGHT_NORMED.match)}, root / "vocoder.ckpt")
    model_args = [*TINY_CLI_MODEL,
                  "model.decoder.denoise_fn.residual_layers=4",
                  "+model.decoder.denoise_fn.dilation_cycle_length=2"]
    out, cwd = tmp_path / "out", os.getcwd()
    argv = [f"path.root={root}", f"output_dir={out}", "device=cpu",
            f"hydra.run.dir={tmp_path / 'run'}", "train.num_epochs=1",
            "dataset.max_tokens=300", "train.lr_scheduler.warmup_steps=10",
            "+dataset.train.seed=1", "+train.input_pipeline=sync",
            "+train.mesh.model=2", "+train.mesh.pipeline_microbatches=2",
            "+train.tensorboard=false", *model_args]
    cfg = conf.compose("train", argv)
    assert train_cli._spawned_processes(cfg) == 2
    assert train_cli.main(argv) is None
    assert not list((out / "logs").glob("events.out.tfevents*"))
    log = (out / "logs/train.log").read_text()
    assert "rank 0 of 2, model axis 2, 2 pipeline microbatches" in log
    assert "rank 1" not in log and "epoch 1 valid:" in log
    loss_rows = (out / "logs/loss.csv").read_text().splitlines()
    assert len(loss_rows) == 2
    assert np.isfinite([float(v) for v in loss_rows[1].split(",")]).all()
    whole = flagship.build_model(cfg["model"], "cpu").state_dict()
    ckpt = torch.load(out / "ckpt/last", weights_only=True)
    for k, v in whole.items():
        assert ckpt["model"][k].shape == v.shape, k
    # resume re-slices the whole tensors and moments on each rank
    from promptttspp_tpu_torch.parallel.distributed import shard_of
    from promptttspp_tpu_torch.train import checkpoint as ckpt_lib

    for rank in range(2):
        model = flagship.build_model(cfg["model"], "cpu")
        shard_module(model, FakeGroup(rank, 2), skip=("decoder.denoise_fn",))
        state = TrainState(model)
        assert ckpt_lib.restore_checkpoint(out / "ckpt/last", state) == 1
        assert state.step == ckpt["step"] > 0
        sd = model.state_dict()
        for name, spec in model.tp_shards.items():
            part = shard_of(ckpt["model"][name], spec.dim, rank, 2,
                            spec.interleave)
            assert torch.equal(sd[name], part), name
            i = state.trainable.index(name) if name in state.trainable \
                else None
            if i is not None:
                moment = state.optimizer.state[state.params[i]]["exp_avg"]
                assert torch.equal(moment, shard_of(
                    ckpt["optimizer"]["state"][i]["exp_avg"], spec.dim,
                    rank, 2, spec.interleave)), name
    wavs = tmp_path / "wavs"
    try:
        synth_cli.main([
            f"path.root={root}", f"model_ckpt={out / 'ckpt/last'}",
            f"vocoder_ckpt={root / 'vocoder.ckpt'}", f"output_dir={wavs}",
            f"hydra.run.dir={tmp_path / 'synth'}", "num_eval_utts=1",
            "device=cpu", *model_args, *TINY_CLI_VOCODER])
    finally:
        os.chdir(cwd)
    files = sorted(wavs.rglob("*.wav"))
    assert files
    for p in files:
        sr, data = wavfile.read(p)
        assert sr == 24000 and len(data) > 0
        assert np.isfinite(data.astype(np.float64)).all()


def test_model_axis_ranks_equal_one_process_and_jax(twins, jax_tp_step,
                                                    tmp_path):
    """Four gloo ranks: TP=2 on JAX's carried weights with the draws fixed
    against one process and against JAX's step on ``make_mesh(data=4,
    model=2)``; DP x TP (dropout on, two updates), DP x PP and DP x PP
    across the data shards (``model_spans_processes``, whose fold puts
    global rank 1 at data 1, model 0) against one process. Every rank of a
    model group ends with the same whole parameters. JAX's step has been
    compiling in a thread since the module's first test."""
    from promptttspp_tpu_torch.compat.from_jax import (
        jax_params_to_state_dict)
    from tests.test_torch_train import _named

    _, variables = twins
    twin = jax_params_to_state_dict(variables)
    torch.save(twin, tmp_path / "twin.pt")
    ctx = mp.start_processes(_rank, args=(train_cli.free_port(),
                                          str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    ref = {"tp": run_updates(),
           "twin": run_updates(zero_dropout_config(), bert=ZERO_BERT,
                               batches=[twin_batch()], state_dict=twin),
           "pp": run_updates(pp_model_config(), n=1)}
    jstate, jmetrics = jax_tp_step.result()
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {JOIN_S} s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    assert [r["spans"] for r in ranks] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    for name, want in (("twin", "twin"), ("dp_tp", "tp"), ("dp_pp", "pp"),
                       ("spans_pp", "pp")):
        for r in ranks:
            assert r[name][0] == ranks[0][name][0], name
            for k, v in ranks[0][name][1].items():
                assert torch.equal(r[name][1][k], v), (name, k)
        _close(ranks[0][name], ref[want], name)
    # the TP=2 step against JAX's TP step on the same carried weights
    losses, sd = ranks[0]["twin"]
    for k in ("loss", "dec", "dur", "cf0", "vuv", "style"):
        assert np.isclose(losses[0][k], jmetrics[k], rtol=LOSS_RTOL,
                          atol=0), (k, losses[0][k], jmetrics[k])
    np.testing.assert_allclose(losses[0]["grad_norm"],
                               jmetrics["grad_norm"], **NORM_TOL)
    named = {**_named(jstate.params),
             **_named(jstate.batch_stats, "batch_stats")}
    scale = max(float(v.abs().max()) for v in named.values())
    diff = max(float((sd[k] - v).abs().max()) for k, v in named.items()
               if not k.endswith("num_batches_tracked"))
    assert diff <= PARAM_RTOL * scale, (diff, scale)
    moved = max(float((v - twin[k]).abs().max()) for k, v in named.items()
                if k in twin and v.is_floating_point())
    assert moved > 10 * PARAM_RTOL * scale
