"""Serving requests and arrivals from a seed.

Every seed gets the same sizes and the same gaps, in another order, and
the orders differ only by where they start: the seed changes which
request comes when, not how much work a run offers nor how it bunches.

- The schedule, fixed by the mix (``schedule_seed``): ``n`` phone counts
  spread evenly over ``phones`` [lo, hi] (inclusive) and ``n`` prompt
  token counts over ``prompt_tokens`` [lo, hi] (inclusive of [CLS] and
  [SEP]), each laid out by ``interleave`` in ``strata`` strata (1: a
  shuffle; 8: every 8 requests hold one of each eighth of the sizes);
  in an open loop, ``n`` gaps drawn independently from the exponential
  distribution, the gaps of a Poisson process at ``rate`` per second,
  scaled so that the ``n`` arrivals fill the window.
- The run's seed rotates the schedule (one offset for all three, so each
  request keeps its gap) and draws the contents: phone ids uniform in
  [1, ``num_vocab``), 0 being the pad; prompt ids between [CLS] and [SEP]
  uniform in [``prompt_ids`` lo, hi), bert-base-uncased ids; each
  request's own seed, for its style and diffusion draws.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np

CLS, SEP = 101, 102


def _spread(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` integers spread evenly over [lo, hi], both ends included."""
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                  int(seed) >> 32, stream])


def interleave(values: np.ndarray, strata: int,
               rng: np.random.Generator) -> np.ndarray:
    """``values`` laid out in blocks holding one value of each of
    ``strata`` strata of their sorted order (the last blocks short where a
    stratum runs out)."""
    ordered = np.sort(values)
    parts = [rng.permutation(p) for p in np.array_split(ordered, strata)]
    out, taken = [], [0] * len(parts)
    while len(out) < len(ordered):
        for j in rng.permutation(len(parts)):
            if taken[j] < len(parts[j]):
                out.append(parts[j][taken[j]])
                taken[j] += 1
    return np.asarray(out)


def _offset(seed: int, n: int) -> int:
    return int(_rng(seed, 0).integers(n))


def serving_requests(params: Mapping, seed: int, n: int) -> List[Dict]:
    """``n`` requests: {"phones": [ids], "prompt": [ids], "seed": int}."""
    strata = int(params["strata"])
    base = int(params["schedule_seed"])
    off = _offset(seed, n)
    n_ph = np.roll(interleave(_spread(*params["phones"], n), strata,
                              _rng(base, 11)), off)
    n_tok = np.roll(interleave(_spread(*params["prompt_tokens"], n), strata,
                               _rng(base, 12)), off)
    rng = _rng(seed, 1)
    lo, hi = params.get("prompt_ids", (1000, 29000))
    vocab = int(params.get("num_vocab", 90))
    out = []
    for i in range(n):
        prompt = [CLS] + rng.integers(lo, hi, int(n_tok[i]) - 2).tolist() \
            + [SEP]
        out.append(dict(phones=rng.integers(1, vocab, int(n_ph[i])).tolist(),
                        prompt=prompt,
                        seed=int(rng.integers(0, 2**31 - 1))))
    return out


def poisson_gaps(params: Mapping, rate: float, n: int, seed: int,
                 seconds: float) -> np.ndarray:
    """The ``n`` inter-arrival gaps (seconds) of the schedule at ``rate``
    per second, rotated as ``serving_requests`` rotates its requests and
    scaled to sum to ``seconds``: the first request is due at the
    window's start, the last within it."""
    gaps = _rng(int(params["schedule_seed"]), 13).exponential(
        1.0 / float(rate), n)
    gaps = np.roll(gaps, _offset(seed, n))
    return gaps * (seconds / gaps.sum())
