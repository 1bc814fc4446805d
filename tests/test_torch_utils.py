"""The port's host helpers (``utils/``) against the JAX package's on the
same inputs."""

import random

import numpy as np
import pytest
import torch

from promptttspp_tpu import utils as jutils
from promptttspp_tpu_torch import utils


@pytest.mark.parametrize("max_len", [None, 7])
def test_pad_list_matches_jax(max_len):
    rng = np.random.RandomState(0)
    xs = [rng.randn(n, 3).astype(np.float32) for n in (2, 5, 4)]
    out = utils.pad_list(xs, -1.0, max_len)
    ref = jutils.pad_list(xs, -1.0, max_len)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def test_repeat_by_durations_matches_jax():
    rng = np.random.RandomState(1)
    xs = [rng.randn(n, 2) for n in (3, 2)]
    ds = [np.array([2, 0, 3]), np.array([[1], [4]])]
    for max_len in (None, 9):
        np.testing.assert_array_equal(
            utils.repeat_by_durations(xs, ds, -2.0, max_len),
            jutils.repeat_by_durations(xs, ds, -2.0, max_len))


@pytest.mark.parametrize("maxlen", [None, 6])
def test_pad_masks_match_jax(maxlen):
    lengths = [2, 5, 3]
    np.testing.assert_array_equal(utils.make_pad_mask(lengths, maxlen),
                                  jutils.make_pad_mask(lengths, maxlen))
    np.testing.assert_array_equal(utils.make_non_pad_mask(lengths, maxlen),
                                  jutils.make_non_pad_mask(lengths, maxlen))


def test_progress_map_keeps_the_order():
    out = utils.progress_map(lambda x: x * x, range(23), n_jobs=4)
    assert out == jutils.progress_map(lambda x: x * x, range(23), n_jobs=4)
    assert out == [x * x for x in range(23)]


def test_seed_everything_seeds_python_numpy_and_torch():
    draws = []
    for _ in range(2):
        utils.seed_everything(5)
        draws.append((random.random(), np.random.rand(), torch.rand(2)))
    assert draws[0][:2] == draws[1][:2]
    assert torch.equal(draws[0][2], draws[1][2])
    jutils.seed_everything(5)
    assert (random.random(), np.random.rand()) == draws[0][:2]
