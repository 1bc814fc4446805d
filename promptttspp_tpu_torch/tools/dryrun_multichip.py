"""A dry run of every parallelism axis of the port, in one call: the
counterpart of ``__graft_entry__.py::dryrun_multichip``.

    python3 -m promptttspp_tpu_torch.tools.dryrun_multichip \\
        [--ranks 4] [--model 2] [--device cuda|cpu]

It spawns ``--ranks`` training processes (NCCL, one per GPU, where there
are enough GPUs; else gloo, the ranks sharing the visible GPUs, or the
CPU), folded into ``ranks / model`` data shards of ``model`` ranks
(``parallel/distributed.py::process_groups``), and checks, at the
flagship's widths with JAX's reduced depth (one conformer block of 256
units, one BERT layer, a 2-block DiffNet; 4 blocks of cycle 2 and 64
channels for the pipeline):

- DP x TP: the full train step (AdamW, Noam, clip) with the model
  sharded over the model axis (``parallel/tp.py``); its losses equal the
  data-parallel step's on the same global batch;
- SP: in this process, the frame-sharded decode (``parallel/sp.py``)
  over the visible devices (one repeated when there is one) against the
  plain decode, deterministically;
- DP x PP: the train step with the DiffNet pipelined over the model axis
  (``parallel/pp.py``) against the unpipelined step.

It prints one line per check and exits non-zero when one fails.
``dryrun(...)`` runs it from Python and returns the numbers.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.parallel.distributed import process_groups
from promptttspp_tpu_torch.parallel.mesh import make_mesh
from promptttspp_tpu_torch.parallel.sp import decode_frames_sharded
from promptttspp_tpu_torch.parallel.tp import shard_module
from promptttspp_tpu_torch.train.state import TrainState

# the losses of two layouts of one step, relative: the same global step,
# its sums in another order
LOSS_RTOL = 1e-5
# the frame-sharded decode against the plain one (JAX's dry run bar)
SP_ATOL = 1e-4
MICROBATCHES = 2
OPT = dict(lr=1e-3, warmup_steps=1, betas=(0.9, 0.98), weight_decay=0.0)


def reduced_config(pipeline: bool = False) -> dict:
    """The flagship's model config at the depth of JAX's dry run; with
    ``pipeline``, JAX's pipelined variant (a DiffNet of 4 blocks of cycle 2
    and 64 channels)."""
    cfg = copy.deepcopy(flagship.MODEL)
    cfg["encoder"].update(num_blocks=1, linear_units=256)
    va = cfg["variance_adaptor"]
    va["frame_prior_network"]["n_layers"] = 1
    va["pitch_predictor"]["num_layers"] = 2
    cfg["prompt_encoder"]["bert_num_layers"] = 1
    dn = cfg["decoder"]["denoise_fn"]
    if pipeline:
        dn.update(residual_layers=4, dilation_cycle_length=2,
                  residual_channels=64)
    else:
        dn["residual_layers"] = 2
    return cfg


def example_batch(B: int, Tp: int = 16, Tf: int = 64, L: int = 16,
                  seed: int = 0) -> dict:
    """A numpy training batch of ``B`` rows at the flagship's mel width:
    ragged phones (1-4 frames each) and prompts."""
    rng = np.random.RandomState(seed)
    plens = rng.randint(Tp // 2, Tp + 1, B)
    duration = np.zeros((B, Tp), np.int64)
    for b in range(B):
        duration[b, :plens[b]] = rng.randint(1, Tf // Tp + 1, plens[b])
    flens = duration.sum(1)
    phoneme = rng.randint(1, 90, (B, Tp))
    phoneme[np.arange(Tp)[None] >= plens[:, None]] = 0
    frame = (np.arange(Tf)[None] < flens[:, None])[:, :, None]
    mask = (np.arange(L)[None] < rng.randint(L // 2, L + 1, B)[:, None])
    mel = flagship.MODEL["decoder"]["out_dim"]
    return dict(
        phoneme=phoneme, duration=duration, phone_lengths=plens,
        mel=(rng.randn(B, Tf, mel) * frame).astype(np.float32),
        log_cf0=(rng.randn(B, Tf, 1) * frame).astype(np.float32),
        vuv=((rng.rand(B, Tf, 1) > 0.3) * frame).astype(np.float32),
        frame_lengths=flens,
        prompt_ids=rng.randint(1, 1000, (B, L)) * mask,
        prompt_mask=mask.astype(np.int64),
        batch_weight=np.ones(B, np.float32))


def _step(cfg, batch, device, data, tp=None, pp=None) -> dict:
    """One update of the model of ``cfg`` (seed 0) on this rank's rows of
    ``batch`` -> its losses (the global step's)."""
    model = flagship.build_model(cfg, device, seed=0)
    if pp is not None:
        model.decoder = model.decoder.clone(
            pipeline=pp, pipeline_microbatches=MICROBATCHES,
            pipeline_batch_axis="data")
    if tp is not None:
        shard_module(model, tp)
    state = TrainState(model, seed=0, data=data, model_group=tp or pp,
                       **OPT)
    rows = data.rows(len(batch["phone_lengths"]) // data.world)
    out = state.train_step({k: torch.as_tensor(v[rows]).to(device)
                            for k, v in batch.items()})
    return {k: float(v) for k, v in out.items()}


def _rank(rank: int, world: int, model_axis: int, address: str,
          backend: str, device_type: str, out_dir: str):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    try:
        out = {}
        data, _ = process_groups(1)
        batch = example_batch(world * MICROBATCHES)
        out["dp"] = _step(reduced_config(), batch, device, data)
        data, model = process_groups(model_axis)
        out["dp_tp"] = _step(reduced_config(), batch, device, data, tp=model)
        out["unpipelined"] = _step(reduced_config(True), batch, device, data)
        out["dp_pp"] = _step(reduced_config(True), batch, device, data,
                             pp=model)
        out["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                           if device.type == "cuda" else None)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sp_check(device_type: str) -> dict:
    """The frame-sharded decode over the visible devices (a device
    repeated when there is one) against the plain decode."""
    if device_type == "cuda":
        n = torch.cuda.device_count()
        devices = ([torch.device("cuda", i) for i in range(n)] if n > 1
                   else [torch.device("cuda", 0)] * 2)
    else:
        devices = ["cpu", "cpu"]
    mesh = make_mesh(devices=devices)
    model = flagship.build_model(reduced_config(), devices[0], seed=0)
    g = torch.Generator(device=devices[0]).manual_seed(5)
    T = 16 * len(devices)
    cond = torch.randn((2, T, flagship.MODEL["decoder"]["in_dim"]),
                       generator=g, device=devices[0])
    x_T = torch.randn((2, T, flagship.MODEL["decoder"]["out_dim"]),
                      generator=g, device=devices[0])
    with torch.inference_mode():
        plain = model.decoder.inference(cond, x_T=x_T, zero_noise=True)
        sharded = decode_frames_sharded(mesh, model.decoder, cond, x_T=x_T,
                                        zero_noise=True)
    return dict(devices=[str(d) for d in devices], frames=T,
                max_abs_err=float((sharded - plain).abs().max()))


def dryrun(ranks: int = 4, model_axis: int = 2,
           device_type: str = "cuda") -> dict:
    """Run the three checks (module docstring) -> {"ok", "lines", ...}."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run's default device is cuda and no GPU "
                           "is visible; pass --device cpu")
    if ranks % model_axis:
        raise ValueError(f"--model {model_axis} does not divide --ranks "
                         f"{ranks}")
    n_gpus = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = "nccl" if device_type == "cuda" and n_gpus >= ranks \
        else "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank, args=(
            ranks, model_axis, f"localhost:{_free_port()}", backend,
            device_type, out_dir), nprocs=ranks, join=True,
            start_method="spawn")
        per_rank = [json.loads((Path(out_dir) / f"rank{r}.json")
                               .read_text()) for r in range(ranks)]
    train_s = time.perf_counter() - t0
    sp = _sp_check(device_type)
    r0 = per_rank[0]
    layout = (f"{ranks} {backend} ranks ({ranks // model_axis} data x "
              f"{model_axis} model) on {device_type}")

    def rel(a, b):
        return max(abs(a[k] - b[k]) / abs(b[k]) for k in b if k != "grad_norm")

    checks = [
        ("DP x TP", rel(r0["dp_tp"], r0["dp"]), LOSS_RTOL,
         f"loss {r0['dp_tp']['loss']:.6f} vs DP {r0['dp']['loss']:.6f}"),
        ("SP", sp["max_abs_err"], SP_ATOL,
         f"frame-sharded decode of {sp['frames']} frames over "
         f"{sp['devices']} vs plain"),
        ("DP x PP", rel(r0["dp_pp"], r0["unpipelined"]), LOSS_RTOL,
         f"loss {r0['dp_pp']['loss']:.6f} vs unpipelined "
         f"{r0['unpipelined']['loss']:.6f} ({MICROBATCHES} microbatches "
         f"over {model_axis} stages)"),
    ]
    lines, ok = [], True
    same = all(r[k] == r0[k] for r in per_rank
               for k in ("dp", "dp_tp", "unpipelined", "dp_pp"))
    ok &= same
    for name, err, bar, what in checks:
        good = bool(np.isfinite(err) and err <= bar)
        ok &= good
        where = "in this process" if name == "SP" else f"on {layout}"
        lines.append(f"dryrun_multichip: {name} {where}: {what}: "
                     f"{err:.3g} (bar {bar}) {'OK' if good else 'FAIL'}")
    lines.append(f"dryrun_multichip: every rank reports the same losses: "
                 f"{same}; train steps {train_s:.1f} s with the spawn; peak "
                 f"per rank "
                 + (f"{max(r['peak_gib'] for r in per_rank):.2f} GiB"
                    if r0["peak_gib"] is not None else "n/a (CPU)"))
    return dict(ok=ok, lines=lines, ranks=per_rank, sp=sp, backend=backend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    out = dryrun(args.ranks, args.model, args.device)
    print("\n".join(out["lines"]), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
