"""Traffic is the same for a seed, differs across seeds, and gives every
seed the same sizes in another order."""

import numpy as np
import pytest

from perfbench.traffic import corpus, requests

PARAMS = dict(phones=[30, 100], prompt_tokens=[8, 48], strata=8,
              schedule_seed=0)
SHUFFLED = dict(PARAMS, strata=1)
BIG = 2**31 + 12345


def test_requests_repeat_for_a_seed():
    a = requests.serving_requests(PARAMS, BIG, 64)
    b = requests.serving_requests(PARAMS, BIG, 64)
    assert a == b


def test_requests_differ_across_seeds_with_the_same_sizes():
    a = requests.serving_requests(PARAMS, 1, 64)
    b = requests.serving_requests(PARAMS, 2, 64)
    assert a != b
    for key in ("phones", "prompt"):
        sa = sorted(len(r[key]) for r in a)
        sb = sorted(len(r[key]) for r in b)
        assert sa == sb
    assert min(len(r["phones"]) for r in a) == 30
    assert max(len(r["phones"]) for r in a) == 100
    assert all(r["prompt"][0] == 101 and r["prompt"][-1] == 102 for r in a)
    assert all(1 <= p < 90 for r in a for p in r["phones"])


def test_arrivals_same_gaps_in_another_order():
    a = requests.poisson_gaps(PARAMS, 4.0, 200, 1, 50.0)
    b = requests.poisson_gaps(PARAMS, 4.0, 200, 2, 50.0)
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(np.sort(a), np.sort(b))
    np.testing.assert_array_equal(
        a, requests.poisson_gaps(PARAMS, 4.0, 200, 1, 50.0))
    assert a.sum() == pytest.approx(50.0)
    # another schedule seed draws other gaps
    c = requests.poisson_gaps(dict(PARAMS, schedule_seed=1), 4.0, 200, 1,
                              50.0)
    assert not np.allclose(np.sort(a), np.sort(c))


def test_arrivals_are_poisson_with_bursts():
    # independent exponential gaps: a coefficient of variation near 1, and
    # runs of short gaps that evenly mixed gaps would not hold
    g = requests.poisson_gaps(PARAMS, 4.0, 2000, 7, 500.0)
    assert abs(g.std() / g.mean() - 1.0) < 0.1
    short = g < np.quantile(g, 0.25)
    run = longest = 0
    for s in short:
        run = run + 1 if s else 0
        longest = max(longest, run)
    assert longest >= 4
    # five arrivals within one mean gap happen, as they do under Poisson
    t = np.cumsum(g)
    assert np.min(t[5:] - t[:-5]) < g.mean()


@pytest.mark.parametrize("params", [PARAMS, SHUFFLED], ids=["strata8",
                                                           "shuffled"])
def test_schedule_is_a_rotation(params):
    a = requests.serving_requests(params, 1, 64)
    b = requests.serving_requests(params, 2, 64)
    la = [len(r["phones"]) for r in a]
    lb = [len(r["phones"]) for r in b]
    k = next(k for k in range(64) if np.roll(la, k).tolist() == lb)
    assert 0 <= k < 64
    ga = requests.poisson_gaps(params, 4.0, 64, 1, 16.0)
    gb = requests.poisson_gaps(params, 4.0, 64, 2, 16.0)
    np.testing.assert_allclose(np.roll(ga, k), gb)


def test_strata_mix_every_stretch():
    la = [len(r["phones"]) for r in requests.serving_requests(PARAMS, 1, 64)]
    # each block of 8 holds one of each eighth of the sorted lengths
    base = np.asarray(la)
    strata = np.searchsorted(np.sort(base)[::8][1:], base, side="right")
    first = np.roll(strata, -requests._offset(1, 64))
    for i in range(0, 64, 8):
        assert sorted(first[i:i + 8]) == list(range(8))


def test_one_stratum_is_a_shuffle():
    la = [len(r["phones"]) for r in
          requests.serving_requests(SHUFFLED, 1, 64)]
    assert sorted(la) == requests._spread(30, 100, 64).tolist()
    assert la != sorted(la)


def test_training_rows_same_lengths_in_another_order():
    cands, spk = corpus.candidates()
    a = corpus.training_rows(200, cands, spk, (13, 125), (6, 10), seed=BIG)
    b = corpus.training_rows(200, cands, spk, (13, 125), (6, 10), seed=3)
    assert a == corpus.training_rows(200, cands, spk, (13, 125), (6, 10),
                                     seed=BIG)
    assert a != b
    frames = lambda rows: sorted(sum(r["durations"]) for r in rows)  # noqa
    assert frames(a) == frames(b)
    assert 100 <= frames(a)[0] and frames(a)[-1] <= 1000
    assert all(len(r["seq"]) == len(r["durations"]) for r in a)


def test_corpus_files(tmp_path):
    cands, spk = corpus.candidates()
    rows = corpus.training_rows(6, cands, spk, (13, 20), (6, 10), seed=4)
    root = corpus.write_training_corpus(tmp_path / "c", rows, cands, spk,
                                        seed=4)
    p = corpus.paths(root)
    lines = open(p["file_path"]).read().splitlines()
    assert len(lines) == 7
    r = rows[0]
    mel = np.load(f"{p['mel_dir']}/{r['spk_id']}/{r['item_name']}.npy")
    assert mel.shape == (80, sum(r["durations"]))


@pytest.mark.parametrize("n", [1, 7, 64])
def test_spread_covers_the_range(n):
    s = requests._spread(30, 100, n)
    assert s.min() == 30 and (n == 1 or s.max() <= 100)
