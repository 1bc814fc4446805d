"""The system under test for the serving cells: the port's
``infer.Synthesizer`` around the model and vocoder of the cell's
configuration, with weights the benchmark makes from the seed
(``weights.py``), and what the serving drivers share: the shapes a
traffic uses, their warm-up, and the outputs kept for the check.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from perfbench.harness import weights


class IdsTokenizer:
    """The tokenizer the ``Synthesizer`` is given: prompts arrive as token
    id lists (``traffic/requests.py``), padded with 0 to the longest."""

    pad_id = 0

    def batch_encode(self, prompts: Sequence[Sequence[int]]):
        L = max(len(p) for p in prompts)
        ids = np.zeros((len(prompts), L), np.int64)
        mask = np.zeros((len(prompts), L), np.int64)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
            mask[i, : len(p)] = 1
        return ids, mask


def set_float32(precision: str):
    """Process-wide precision of float32 convolutions, recurrent layers
    and matrix products: "ieee" (TF32 off) or "tf32"."""
    import torch

    for flags in (torch.backends.cudnn.conv, torch.backends.cudnn.rnn,
                  torch.backends.cuda.matmul):
        flags.fp32_precision = precision


def _ceil(n: int, q: int) -> int:
    return max(q, int(math.ceil(n / q)) * q)


def shape_key(cfg: Dict, reqs: Sequence[Dict]):
    """(batch, phone bucket, frame bucket, prompt bucket) that speculative
    dispatch gives ``reqs``: the phones and prompts padded to quanta of the
    ``Synthesizer`` and 16, the frames predicted at
    ``spec_frames_per_phone`` per phone of the longest."""
    s = cfg["synthesizer"]
    longest = max(len(r["phones"]) for r in reqs)
    frames = min(_ceil(int(math.ceil(longest * s["spec_frames_per_phone"])),
                       s["frame_quantum"]), s["max_frames_cap"])
    return (len(reqs), _ceil(longest, s["phone_quantum"]), frames,
            _ceil(max(len(r["prompt"]) for r in reqs), 16))


class Server:
    """The ``Synthesizer`` of ``run``'s configuration, on ``run.device``."""

    def __init__(self, run):
        from promptttspp_tpu_torch import flagship
        from promptttspp_tpu_torch.infer import Synthesizer

        cfg = self.cfg = run.config
        if run.device == "cuda":
            set_float32(cfg["precision"]["float32"])
        model = flagship.build_model(cfg["model"], run.device, seed=0)
        vocoder = flagship.build_vocoder(run.device, seed=1,
                                         cfg=cfg["vocoder"])
        self.fill(model, vocoder, run.seed)
        self.synth = Synthesizer(model, vocoder, mel_stats=cfg["mel_stats"],
                                 tokenizer=IdsTokenizer(), device=run.device,
                                 **cfg["synthesizer"])
        self.options = cfg["synthesize"]
        self.sample_rate = cfg["sample_rate"]
        self.upsample = cfg["synthesizer"]["upsample"]

    def fill(self, model, vocoder, seed: int):
        """The benchmark's weights of ``seed``, in place."""
        weights.fill(model, weights.sub_seed(seed, "model"),
                     self.cfg["pins"])
        weights.fill(vocoder, weights.sub_seed(seed, "vocoder"))

    def reseed(self, seed: int):
        """Refill the served model's weights from ``seed`` (the control
        tool reads many seeds through one set-up)."""
        self.fill(self.synth.model, self.synth.vocoder, seed)

    def dispatch(self, reqs: Sequence[Dict]):
        """Queue one batch (``synthesize_async``); -> its handle."""
        return self.synth.synthesize_async(
            [r["phones"] for r in reqs], prompts=[r["prompt"] for r in reqs],
            use_max=self.options["use_max"],
            noise_scale=self.options["noise_scale"], seed=reqs[0]["seed"],
            return_mels=True)

    def warm(self, batches: Sequence[Sequence[Dict]]):
        """Run one batch of every shape among ``batches`` to its end: the
        decode graph of each (batch, frame bucket) is captured, the
        kernels built and cuDNN's and cuBLAS's plans made."""
        seen = set()
        for reqs in batches:
            key = shape_key(self.cfg, reqs)
            if key not in seen:
                seen.add(key)
                self.dispatch(reqs).result()

    def counters(self) -> Dict[str, int]:
        return {"spec_requests": self.synth.spec_requests,
                "spec_mispredicts": self.synth.spec_mispredicts}

    def close(self):
        """Drop the program's state, so the reference finds the memory."""
        self.synth = None


def memory_peak(device: str) -> int:
    if device != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def pick(items: Sequence, n: int, seed: int, size) -> List[int]:
    """Indices of ``n`` of ``items`` for the check: the largest by
    ``size`` and ``n - 1`` others drawn from ``seed``."""
    if not items:
        return []
    first = int(np.argmax([size(x) for x in items]))
    rest = [i for i in range(len(items)) if i != first]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 9])
    rest = rng.permutation(rest)[: max(0, n - 1)].tolist()
    return [first] + sorted(rest)


def check(run, batches: Sequence[Sequence[Dict]], program: Sequence[Dict]):
    """Compare the program's outputs of ``batches`` (per batch {"mels",
    "wavs"}, or None where the answer never came) with the reference's,
    and record each gap against the cell's limit."""
    from perfbench.reference import judge, serve

    mix = run.config["precision"]["vocoder_mix"]
    if run.device != "cuda":
        # the port's vocoder runs its float32 plain layer on a CPU tensor
        mix = "float32"
    ref = serve.outputs(run.config, run.seed, batches, run.device,
                        float32=run.config["precision"]["float32"], mix=mix)
    gaps = judge.serve_gaps(program, ref)
    limits = run.cell["limits"]
    for name in ("frames", "mel", "wav"):
        run.compare(name, gaps[name], limits[name])
    run.values["checked_requests"] = sum(len(b) for b in batches)
