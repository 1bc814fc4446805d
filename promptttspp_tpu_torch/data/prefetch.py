"""The prefetching input pipeline: batches assembled and copied to the card
while the card runs earlier updates.

Counterpart of ``promptttspp_tpu/data/prefetch.py`` (``_collate_native``,
``prefetch_batches``). The sampler's entries are batches of indices or, under
data parallelism, ``parallel/distributed.py::host_batches``' (indices,
kwargs): this rank's rows, collated at the global batch's buckets and padded
with zero-weight rows (``entry_metas``, ``finish``). A producer
thread walks the batch sampler in order and calls the dataset's
``item_meta`` serially, so the prompts are drawn as the synchronous loop
draws them; a pool of ``num_workers`` threads assembles the batches (the
C++ feature loader, ``data/native_loader.py``, or the Python items and
collator) and stages their model keys on the device: pinned host tensors,
copied with ``non_blocking=True`` on a copy stream of their own, followed
by an event. A queue of ``prefetch_depth`` futures bounds how far ahead
the producer runs. Batches come out strictly in sampler order; the
consumer's stream waits on each batch's event before the batch is used,
and each copied tensor is recorded on that stream, so the caching
allocator does not hand its memory out while an update still reads it.

Threads, not processes: the loader's C++ pass runs outside the
interpreter lock. The Python path holds the lock while it collates, and
then competes with the thread that dispatches the update.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from promptttspp_tpu_torch.data import native_loader
from promptttspp_tpu_torch.data.batching import bucket_shape
from promptttspp_tpu_torch.data.collate import (
    FRAME_QUANTUM, PHONE_QUANTUM, encode_prompts, prompt_bucket)
from promptttspp_tpu_torch.parallel.mesh import pad_batch_to_rows


def host_tensors(batch: Dict, keys: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The ``keys`` of a collated batch as CPU tensors (integers as int64),
    sharing memory with the batch's float arrays."""
    out = {}
    for k in keys:
        if k in batch:
            a = np.asarray(batch[k])
            out[k] = torch.from_numpy(a.astype(np.int64)
                                      if a.dtype.kind in "iu" else a)
    return out


def entry_metas(dataset, entry, tokenizer=None) -> Tuple[List[Dict], Dict,
                                                        Dict]:
    """The serial part of a sampler entry's assembly -> (metas, collate
    kwargs, padding): the ``item_meta`` of its rows, drawn in order. An
    entry of ``host_batches`` draws every row of its global batch, so the
    prompt draws are one process's, keeps its own rows' and, where
    ``prompt_pad_to`` is None, pads the prompts to the global batch's
    bucket; ``padding`` holds its reserved keys for ``finish``."""
    idx, kwargs = entry if isinstance(entry, tuple) else (entry, {})
    kwargs = dict(kwargs)
    glob = kwargs.pop("_global", None)
    padding = dict(rows=kwargs.pop("_pad_rows_to", None),
                   zero_weight=kwargs.pop("_zero_weight", False))
    if glob is None:
        return [dataset.item_meta(i) for i in idx], kwargs, padding
    metas = {i: dataset.item_meta(i) for i in glob}
    if kwargs.get("prompt_pad_to", 0) is None and tokenizer is not None:
        kwargs["prompt_pad_to"] = prompt_bucket(
            tokenizer, [metas[i]["prompt"] for i in glob])
    return [metas[i] for i in idx], kwargs, padding


def finish(batch: Dict, padding: Dict) -> Dict:
    """``batch`` padded to the slab's rows with zero-weight rows, all of
    weight 0 for a slab that lies in the global batch's padding."""
    if padding["rows"] is not None:
        batch = pad_batch_to_rows(batch, padding["rows"])
    if padding["zero_weight"]:
        batch["batch_weight"] = np.zeros_like(batch["batch_weight"])
    return batch


def _collate_native(metas: List[Dict], collator, stats: Dict,
                    pin: bool = False, t_phones: Optional[int] = None,
                    t_frames: Optional[int] = None,
                    prompt_pad_to: Optional[int] = None) -> Dict:
    """The batch of ``metas`` (``item_meta`` dicts), as the collator makes
    it from the items: the C++ loader reads, normalizes and pads the mel,
    log-F0 and V/UV and computes the energy in one multithreaded pass
    (into pinned buffers with ``pin``); the phonemes, durations and prompts
    are assembled here. ``t_phones``, ``t_frames`` and ``prompt_pad_to``
    as the collator takes them."""
    B = len(metas)
    phon = [np.asarray([int(s) for s in m["seq"].split()], np.int32)
            for m in metas]
    durs = [np.asarray([int(d) for d in m["durations"].split()], np.int32)
            for m in metas]
    plens = np.asarray([len(p) for p in phon], np.int32)
    # the bucket of the longest mel as the files hold it (the collator's),
    # from the .npy headers
    shapes = [np.load(m["mel_path"], mmap_mode="r").shape for m in metas]
    n_mels = shapes[0][0]
    Tp = t_phones or bucket_shape(int(plens.max()), PHONE_QUANTUM)
    Tf = t_frames or bucket_shape(max(s[-1] for s in shapes), FRAME_QUANTUM)
    out = None
    if pin:
        out = {k: torch.empty(shape, pin_memory=True).numpy() for k, shape in
               (("mel", (B, Tf, n_mels)), ("log_cf0", (B, Tf, 1)),
                ("vuv", (B, Tf, 1)))}
    feats = native_loader.load_feature_batch(
        [m["mel_path"] for m in metas], [m["cf0_path"] for m in metas],
        [m["vuv_path"] for m in metas], t_frames=Tf,
        mel_mean=float(stats["mean"]), mel_std=float(stats["std"]),
        n_mels=n_mels, out=out)
    flens = feats["frame_lengths"]

    phoneme = np.zeros((B, Tp), np.int32)
    duration = np.zeros((B, Tp), np.int32)
    for i in range(B):
        if flens[i] < durs[i].sum():  # the dataset's off-by-one repair
            durs[i][-1] -= 1
        if flens[i] != durs[i].sum():
            m = metas[i]
            raise ValueError(f"{m['spk_id']}/{m['utt_id']}: {flens[i]} mel "
                             f"frames, durations sum to {durs[i].sum()}")
        phoneme[i, :plens[i]] = phon[i]
        duration[i, :plens[i]] = durs[i]

    batch = dict(
        phoneme=phoneme, duration=duration, phone_lengths=plens,
        mel=feats["mel"], log_cf0=feats["log_cf0"], vuv=feats["vuv"],
        energy=feats["energy"], frame_lengths=flens,
        batch_weight=np.ones((B,), np.float32),
        spk_ids=[m["spk_id"] for m in metas],
        utt_ids=[m["utt_id"] for m in metas],
        prompts=[m["prompt"] for m in metas],
    )
    if collator.tokenizer is not None:
        batch["prompt_ids"], batch["prompt_mask"] = encode_prompts(
            collator.tokenizer, batch["prompts"], prompt_pad_to)
    return batch


def _stage(batch: Dict, keys: Sequence[str], device: torch.device,
           stream) -> Tuple[Dict[str, torch.Tensor], Optional[object]]:
    """The ``keys`` of ``batch`` on ``device``: on a GPU copied from pinned
    memory on ``stream``, with the event that follows the copies."""
    tensors = host_tensors(batch, keys)
    if device.type != "cuda":
        return {k: t.to(device) for k, t in tensors.items()}, None
    tensors = {k: t if t.is_pinned() else t.pin_memory()
               for k, t in tensors.items()}
    with torch.cuda.stream(stream):
        staged = {k: t.to(device, non_blocking=True)
                  for k, t in tensors.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return staged, event


def prefetch_batches(
    dataset,
    sampler: Iterable[List[int]],
    collator,
    *,
    model_keys: Sequence[str],
    device="cpu",
    num_workers: int = 8,
    prefetch_depth: int = 3,
    use_native: Optional[bool] = None,
) -> Iterator[Tuple[Dict, Dict[str, torch.Tensor]]]:
    """Yield ``(host_batch, device_batch)`` in sampler order: the whole
    numpy batch (lengths, ids, prompts) and its ``model_keys`` as tensors
    on ``device``, ready for the current stream. The sampler's entries are
    index lists or ``host_batches``' (indices, kwargs), which need a
    dataset with ``item_meta``.

    ``use_native``: None takes the C++ loader where the dataset has the
    ``item_meta`` / ``load_item_features`` split and its mel ``stats``;
    the loader must then build (it raises otherwise). False assembles
    through the Python items and the collator."""
    device = torch.device(device)
    has_meta = hasattr(dataset, "item_meta") and hasattr(
        dataset, "load_item_features")
    native_ok = has_meta and getattr(dataset, "stats", None) is not None
    if use_native is None:
        use_native = native_ok
    elif use_native and not native_ok:
        raise ValueError("use_native=True needs a dataset with item_meta, "
                         "load_item_features and stats")
    if use_native:
        native_loader.library()  # a failed build raises here
    pin = device.type == "cuda"
    stream = torch.cuda.Stream(device) if pin else None

    def assemble_meta(metas, kwargs, padding):
        if use_native:
            batch = _collate_native(metas, collator, dataset.stats, pin,
                                    **kwargs)
        else:
            batch = collator([dataset.load_item_features(m) for m in metas],
                             **kwargs)
        batch = finish(batch, padding)
        return (batch, *_stage(batch, model_keys, device, stream))

    def assemble_items(items):
        batch = collator(items)
        return (batch, *_stage(batch, model_keys, device, stream))

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch_depth, 1))
    stop = threading.Event()
    pool = ThreadPoolExecutor(max_workers=max(num_workers, 1),
                              thread_name_prefix="prefetch")

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for entry in sampler:
                if stop.is_set():
                    return
                if has_meta:
                    # serial: the prompt draws of the synchronous loop
                    work = pool.submit(assemble_meta, *entry_metas(
                        dataset, entry, collator.tokenizer))
                else:
                    work = pool.submit(assemble_items,
                                       [dataset[i] for i in entry])
                if not put(work):
                    return
        except BaseException as e:  # raised again in the consumer
            put(e)
            return
        put(None)

    thread = threading.Thread(target=producer, daemon=True,
                              name="prefetch-producer")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            batch, staged, event = item.result()
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in staged.values():
                    t.record_stream(current)
            yield batch, staged
    finally:
        stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join()
        pool.shutdown(wait=True, cancel_futures=True)
