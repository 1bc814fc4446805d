"""Where a training update of the flagship spends its time on one GPU:

    python3 -m promptttspp_tpu_torch.tools.train_profile [--updates 12]
        [--max-tokens 10000] [--utts 480] [--sync] [--cudnn-benchmark]
        [--root DIR]

Writes a synthetic training corpus (``tools/synthetic_corpus.py``, the
repository's prompt candidates) under ``--root`` (default
``build/train_profile``, deleted at the end), builds the flagship and its
optimizer as ``bin/train.py`` does (``train`` config, seed 42) and runs
``--updates`` updates over the epoch-1 batches of ``dataset.max_tokens``.
Per update it times on the host the batch assembly (dataset items and
collate), the copy to the card and the call of ``train_step``, and on the
card the interval between the updates' starts (CUDA events, no
synchronization added); ``--sync`` synchronizes after each update, so the
host's and the device's times add up instead of overlapping;
``--cudnn-benchmark`` lets cuDNN time its algorithms for each new shape
(``torch.backends.cudnn.benchmark``; the port leaves it off). Then it
profiles 3 more updates (``torch.profiler``): the device-busy share, the
top kernels, and the host's CUDA runtime calls (allocations, frees,
copies, synchronizations) by count and time; and prints the caching
allocator's statistics (peak allocated and reserved, retries after a failed
``cudaMalloc``) and the largest allocations of one more update with the
operations that made them (``torch.cuda.memory._record_memory_history``).
With more updates than batches the epoch's batches come round again, so
the later updates meet shapes already seen. Settings of the allocator or of
cuDNN go in the environment (``PYTORCH_CUDA_ALLOC_CONF``,
``CUDNN_CONV_WSCAP_DBG``).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def _ms(a, b):
    return a.elapsed_time(b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--updates", type=int, default=12)
    ap.add_argument("--max-tokens", type=int, default=10000)
    ap.add_argument("--utts", type=int, default=480)
    ap.add_argument("--sync", action="store_true")
    ap.add_argument("--cudnn-benchmark", action="store_true")
    ap.add_argument("--root", default=str(REPO / "build" / "train_profile"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: needs a GPU", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from promptttspp_tpu_torch.bin import conf
    from promptttspp_tpu_torch.data.collate import PromptTTSCollator
    from promptttspp_tpu_torch.data.dataset import (
        AllWithSpkPromptNormDataset, read_prompt_candidate,
        read_spk_prompt_candidate)
    from promptttspp_tpu_torch.models.bert import WordPieceTokenizer
    from promptttspp_tpu_torch.tools.synthetic_corpus import (
        training_rows, write_training_corpus)
    from promptttspp_tpu_torch.train.trainer import TTSTrainer, to_device

    torch.backends.cudnn.benchmark = args.cudnn_benchmark
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    root = Path(args.root)
    shutil.rmtree(root, ignore_errors=True)
    meta = REPO / "metadata"
    cands = read_prompt_candidate(meta / "style_prompt_candidates.csv")
    spk = read_spk_prompt_candidate(meta / "speaker_prompt_candidates.csv")
    write_training_corpus(root, training_rows(
        args.utts, cands, spk, (20, 80), (3, 12), seed=5), cands, spk,
        seed=6)
    cfg = conf.compose("train", [f"path.root={root}",
                                 f"dataset.max_tokens={args.max_tokens}"])
    ds = AllWithSpkPromptNormDataset(**cfg["dataset"]["train"])
    collator = PromptTTSCollator(WordPieceTokenizer.from_vocab_file(
        cfg["path"]["bert_vocab_file"]))
    trainer = TTSTrainer(cfg)
    state = trainer.build_state()
    sampler = trainer.batches(ds, shuffle=True)
    sampler.set_epoch(1)
    batches = list(sampler)
    dev = state.device

    def run(idx):
        t0 = time.perf_counter()
        batch = collator([ds[i] for i in idx])
        t1 = time.perf_counter()
        tb = to_device(batch, dev)
        t2 = time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        out = state.train_step(tb)
        t3 = time.perf_counter()
        if args.sync:
            torch.cuda.synchronize()
        return ev, out, (t1 - t0, t2 - t1, t3 - t2), int(
            batch["frame_lengths"].sum()), batch["mel"].shape

    torch.cuda.reset_peak_memory_stats()
    rows = [run(batches[i % len(batches)]) for i in range(args.updates)]
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    evs = [r[0] for r in rows] + [end]
    print(f"[{gpu}] train_profile: flagship, max_tokens {args.max_tokens}, "
          f"{len(batches)} batches per epoch, sync after each update: "
          f"{args.sync}, cudnn.benchmark: {args.cudnn_benchmark}")
    for i, (ev, out, host, frames, shape) in enumerate(rows):
        print(f"  update {i}: {_ms(ev, evs[i + 1]):8.1f} ms between starts;"
              f" host: assembly {host[0] * 1e3:6.1f} ms, copy "
              f"{host[1] * 1e3:5.1f} ms, train_step call "
              f"{host[2] * 1e3:6.1f} ms; batch {list(shape)}, {frames} "
              f"frames, loss {out['loss'].item():.4f}")
    steady = [_ms(evs[i], evs[i + 1]) for i in range(3, len(rows))]
    host = np.asarray([r[2] for r in rows[3:]]) * 1e3
    print(f"[{gpu}] after 3 warm-up updates: median {np.median(steady):.1f}"
          f" ms per update; host medians: assembly "
          f"{np.median(host[:, 0]):.1f}, copy {np.median(host[:, 1]):.1f}, "
          f"train_step call {np.median(host[:, 2]):.1f} ms")
    st = torch.cuda.memory_stats()
    print(f"[{gpu}] allocator: peak allocated "
          f"{st['allocated_bytes.all.peak'] / 2**30:.2f} GiB, peak reserved "
          f"{st['reserved_bytes.all.peak'] / 2**30:.2f} GiB, cudaMalloc "
          f"{st['num_device_alloc']}, cudaFree {st['num_device_free']}, "
          f"retries after a failed cudaMalloc {st['num_alloc_retries']}, "
          f"OOMs {st['num_ooms']}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            run(batches[(args.updates + i) % len(batches)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    # kernels only: a user annotation's device time repeats its kernels'
    kern = sorted(((dev_us(e), e.count, e.key) for e in events
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    busy = sum(k[0] for k in kern) / 1e3
    print(f"[{gpu}] 3 profiled updates: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy:.1f} ms ({busy / (wall * 1e3):.1%}), "
          f"{sum(k[1] for k in kern)} kernels; top kernels:")
    for us, n, key in kern[:10]:
        print(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:100]}")
    api = sorted(((e.self_cpu_time_total, e.count, e.key) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith(("cuda", "cu"))), reverse=True)
    print(f"[{gpu}] host CUDA runtime calls in those updates (self CPU "
          "ms, count):")
    for us, n, key in api[:10]:
        print(f"  {us / 1e3:9.2f} ms {n:6d}x  {key}")
    ops = sorted(((e.self_cpu_time_total, e.count, e.key) for e in events
                  if e.device_type == DeviceType.CPU
                  and not e.key.startswith(("cuda", "cu"))), reverse=True)
    print(f"[{gpu}] top host operations by self CPU time:")
    for us, n, key in ops[:12]:
        print(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:100]}")

    torch.cuda.memory._record_memory_history(max_entries=200000)
    run(batches[(args.updates + 3) % len(batches)])
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    allocs = sorted((e for trace in snap["device_traces"] for e in trace
                     if e["action"] == "alloc"),
                    key=lambda e: -e["size"])
    print(f"[{gpu}] the largest allocations of one update (GiB, the "
          "innermost frames of the repository or torch that made them):")
    for e in allocs[:6]:
        frames = e.get("frames", [])
        where = [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                 for f in frames if "promptttspp" in f["filename"]
                 or "torch/nn" in f["filename"]][:3]
        # the backward pass runs on autograd's thread, without Python
        # frames: name the innermost ATen / cuDNN functions instead
        where = where or [f["name"][:60] for f in frames
                          if "cudnn" in f["name"]
                          or "convolution" in f["name"]][:2]
        print(f"  {e['size'] / 2**30:8.3f}  {' <- '.join(where)}")
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
