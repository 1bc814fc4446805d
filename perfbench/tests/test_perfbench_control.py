"""The control, on the card: the reference put in the program's place and
computed one precision below the configuration's (TF32 for its float32,
fp8 e4m3 for the vocoder's bf16 mix) comes out not correct against the
cells' limits, where the program's own run comes out correct; at a size a
test run holds (the cells' widths and paths, fewer and shorter requests,
a smaller corpus). ``perfbench/control.py`` makes the same readings at
the cells' own sizes.

    python3 -m pytest perfbench/tests/test_perfbench_control.py -m cuda
"""

import copy

import pytest

from perfbench import control
from perfbench.harness import cell as cells

pytestmark = pytest.mark.cuda


def _readings(fn, spec, device):
    lines = []
    fn(spec, [2**31 + 101], [2**31 + 101], 4.0, device, lines.append)
    return {line["kind"]: line["gaps"] for line in lines}


def _over(gaps, limits):
    return [k for k, v in gaps.items() if v > limits[k]]


@pytest.mark.parametrize("name,params", [
    ("serve_offline_b16", dict(batch=4, pool_batches=2, check_batches=1,
                               phones=[30, 60])),
    ("serve_online_b1", dict(rate_per_s=2.0, check_requests=2,
                             phones=[30, 60]))])
def test_serving_control_fails(cuda, name, params):
    spec = copy.deepcopy(cells.load(name))
    spec["cell"]["params"].update(params)
    got = _readings(control.serve_readings, spec, cuda)
    limits = spec["cell"]["limits"]
    assert not _over(got["program"], limits), got
    assert _over(got["control"], limits), got


def test_training_control_fails(cuda, tmpdir_env):
    spec = copy.deepcopy(cells.load("train_b10k"))
    spec["cell"]["params"].update(utterances=120)
    got = _readings(control.train_readings, spec, cuda)
    limits = spec["cell"]["limits"]
    assert not _over(got["program"], limits), got
    assert _over(got["control"], limits), got
    assert _over(got["fault_half_batch"], limits), got
